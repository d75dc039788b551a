// POSIX shared-memory segments for the object store (runtime/object_store.py).
//
// A store puts large arrays into named shm segments; any process on the
// same host maps them by name, so a payload crosses processes without
// being pickled through a pipe.  Python owns naming, the tree structure
// and the lifecycle; this layer only creates, maps and unlinks.  Every
// entry sets a thread-local errno on failure (rla_shm_errno reads it).
//
// Build (runtime/object_store.py does it at first use):
//   g++ -O3 -std=c++17 -shared -fPIC -pthread -o <lib>.so shm_store.cc -lrt

#include <cerrno>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {
thread_local int g_errno = 0;
}

extern "C" {

int rla_shm_errno() { return g_errno; }

// Create a segment of nbytes, its pages reserved, and return a writable
// mapping (NULL on error).  An existing name fails with EEXIST rather
// than being reused.
void* rla_shm_create(const char* name, long nbytes) {
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) {
    g_errno = errno;
    return nullptr;
  }
  if (ftruncate(fd, nbytes) != 0) {
    g_errno = errno;
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  // reserve the pages now: a full /dev/shm then fails here with ENOSPC
  // instead of a SIGBUS on the first write past what it can hold
  int rc = posix_fallocate(fd, 0, nbytes);
  if (rc != 0) {
    g_errno = rc;
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  // MAP_POPULATE maps every page in this one call; faulting them in one
  // by one on first touch costs twice the time where a trap is dear, as
  // under gVisor (scripts/torch_shm_sweep.py)
  void* p = mmap(nullptr, nbytes, PROT_READ | PROT_WRITE,
                 MAP_SHARED | MAP_POPULATE, fd, 0);
  close(fd);  // the mapping keeps the segment alive
  if (p == MAP_FAILED) {
    g_errno = errno;
    shm_unlink(name);
    return nullptr;
  }
  return p;
}

// Map an existing segment read-only; its size goes to *size_out.
void* rla_shm_open_ro(const char* name, long* size_out) {
  int fd = shm_open(name, O_RDONLY, 0);
  if (fd < 0) {
    g_errno = errno;
    return nullptr;
  }
  struct stat st;
  if (fstat(fd, &st) != 0) {
    g_errno = errno;
    close(fd);
    return nullptr;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED | MAP_POPULATE,
                 fd, 0);
  close(fd);
  if (p == MAP_FAILED) {
    g_errno = errno;
    return nullptr;
  }
  *size_out = static_cast<long>(st.st_size);
  return p;
}

int rla_shm_unmap(void* ptr, long nbytes) {
  if (munmap(ptr, nbytes) != 0) {
    g_errno = errno;
    return -1;
  }
  return 0;
}

int rla_shm_unlink(const char* name) {
  if (shm_unlink(name) != 0) {
    g_errno = errno;
    return -1;
  }
  return 0;
}

}  // extern "C"
