// Native data engine: multi-threaded row gather with batch prefetch.
//
// The batch engine of the port's DataLoader (data/loader.py, use_native):
// batch assembly runs here, off the GIL, on producer threads, overlapped
// with the step running on the device.
//
// Division of labor: *Python* owns sampling -- the epoch's row-index order
// comes from data/loader.py's ShardedSampler (a rank's strided shard under
// several ranks), so shuffling, rank slicing and pad-by-wrap are bitwise
// the pure-Python path's.  *This engine* owns the expensive part: gathering
// rows from the caller's numpy buffers into `depth` preallocated batch
// slots on producer threads (slot b % depth serves batch b, which makes the
// claim protocol deadlock-free by construction), with a single in-order
// consumer copying slots out.
//
// Threading contract: any number of internal producers; exactly ONE consumer
// at a time, and start_epoch is called by that consumer.
//
// Pure C++17 + pthreads; surfaced to Python over a C ABI via ctypes.
// Build (native/__init__.py does it at first use):
//   g++ -O3 -std=c++17 -shared -fPIC -pthread -o <lib>.so data_engine.cc

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::vector<std::vector<uint8_t>> bufs;  // one buffer per dataset array
  long rows = 0;
  long batch_idx = -1;  // -1 = free
  bool ready = false;
};

struct Engine {
  // dataset description (borrowed pointers; Python keeps arrays alive)
  std::vector<const uint8_t*> arrays;
  std::vector<long> row_bytes;
  long num_rows = 0;
  long batch_size = 0;
  bool drop_last = true;
  int depth = 4;

  // epoch state (guarded by mu)
  std::vector<long> indices;  // row ids for the active epoch, in yield order
  long num_batches = 0;
  long next_produce = 0;  // next batch id to claim
  long next_consume = 0;
  uint64_t generation = 0;  // bumped by start_epoch; stale fills discard
  int active_fills = 0;     // producers currently gathering outside mu
  bool epoch_active = false;
  bool stop = false;

  std::vector<Slot> slots;
  std::mutex mu;
  std::condition_variable cv_ready;  // consumer waits for in-order slot
  std::condition_variable cv_work;   // producers wait for claimable batch
  std::condition_variable cv_idle;   // start_epoch waits for active_fills==0
  std::vector<std::thread> threads;
};

void producer_loop(Engine* e) {
  for (;;) {
    long b = -1;
    uint64_t gen = 0;
    {
      std::unique_lock<std::mutex> lk(e->mu);
      e->cv_work.wait(lk, [&] {
        if (e->stop) return true;
        if (!e->epoch_active || e->next_produce >= e->num_batches)
          return false;
        // slot b % depth must be free before batch b can be claimed;
        // it frees when batch b - depth is consumed, so order is preserved
        // and no slot is ever contended by two producers.
        return e->slots[e->next_produce % e->depth].batch_idx == -1;
      });
      if (e->stop) return;
      b = e->next_produce++;
      gen = e->generation;
      Slot& s = e->slots[b % e->depth];
      s.batch_idx = b;  // claimed, not ready
      s.ready = false;
      e->active_fills++;
    }

    // gather outside the lock -- the hot path
    Slot& s = e->slots[b % e->depth];
    long start = b * e->batch_size;
    long rows = std::min(e->batch_size, (long)e->indices.size() - start);
    for (size_t a = 0; a < e->arrays.size(); ++a) {
      const uint8_t* src = e->arrays[a];
      const long rb = e->row_bytes[a];
      uint8_t* dst = s.bufs[a].data();
      for (long r = 0; r < rows; ++r)
        std::memcpy(dst + r * rb, src + e->indices[start + r] * rb, rb);
    }

    {
      std::lock_guard<std::mutex> lk(e->mu);
      e->active_fills--;
      if (e->generation == gen) {
        s.rows = rows;
        s.ready = true;
        e->cv_ready.notify_one();
      }  // else: stale epoch; start_epoch already reset the slot table
      if (e->active_fills == 0) e->cv_idle.notify_all();
    }
  }
}

}  // namespace

extern "C" {

Engine* rla_engine_create(int num_arrays, const void** array_ptrs,
                          const long* row_bytes, long num_rows,
                          long batch_size, int drop_last, int num_threads,
                          int prefetch_depth) {
  Engine* e = new Engine();
  for (int a = 0; a < num_arrays; ++a) {
    e->arrays.push_back((const uint8_t*)array_ptrs[a]);
    e->row_bytes.push_back(row_bytes[a]);
  }
  e->num_rows = num_rows;
  e->batch_size = batch_size;
  e->drop_last = drop_last != 0;
  e->depth = prefetch_depth > 0 ? prefetch_depth : 4;
  e->slots.resize(e->depth);
  for (auto& s : e->slots) {
    s.bufs.resize(num_arrays);
    for (int a = 0; a < num_arrays; ++a)
      s.bufs[a].resize((size_t)batch_size * row_bytes[a]);
  }
  int nt = num_threads > 0 ? num_threads : 2;
  for (int t = 0; t < nt; ++t)
    e->threads.emplace_back(producer_loop, e);
  return e;
}

// Begin an epoch over `n` row indices (sampler-provided, already shuffled /
// rank-sliced).  Returns 0 on success, -1 on an out-of-range index.
int rla_engine_start_epoch(Engine* e, const long* idx, long n) {
  for (long i = 0; i < n; ++i)
    if (idx[i] < 0 || idx[i] >= e->num_rows) return -1;
  std::unique_lock<std::mutex> lk(e->mu);
  e->generation++;
  e->epoch_active = false;
  e->cv_idle.wait(lk, [&] { return e->active_fills == 0; });
  for (auto& s : e->slots) {
    s.batch_idx = -1;
    s.ready = false;
    s.rows = 0;
  }
  e->indices.assign(idx, idx + n);
  e->num_batches = n / e->batch_size;
  if (!e->drop_last && n % e->batch_size) e->num_batches++;
  e->next_produce = 0;
  e->next_consume = 0;
  e->epoch_active = true;
  e->cv_work.notify_all();
  return 0;
}

// Copies the next in-order batch into caller buffers (each sized
// batch_size * row_bytes[a]).  Returns the row count, or 0 at epoch end.
// Single-consumer: only one thread may call this (and start_epoch).
long rla_engine_next_batch(Engine* e, void** out_ptrs) {
  Slot* s;
  long rows;
  {
    std::unique_lock<std::mutex> lk(e->mu);
    if (!e->epoch_active || e->next_consume >= e->num_batches) return 0;
    long b = e->next_consume;
    s = &e->slots[b % e->depth];
    e->cv_ready.wait(lk, [&] { return s->ready && s->batch_idx == b; });
    rows = s->rows;
  }
  // copy out without the lock: producers cannot touch slot b % depth until
  // batch b is marked free below, and the single consumer is right here.
  for (size_t a = 0; a < e->arrays.size(); ++a)
    std::memcpy(out_ptrs[a], s->bufs[a].data(),
                (size_t)rows * e->row_bytes[a]);
  {
    std::lock_guard<std::mutex> lk(e->mu);
    s->batch_idx = -1;
    s->ready = false;
    e->next_consume++;
    if (e->next_consume >= e->num_batches) e->epoch_active = false;
    e->cv_work.notify_all();
  }
  return rows;
}

long rla_engine_num_batches(Engine* e) {
  std::lock_guard<std::mutex> lk(e->mu);
  return e->num_batches;
}

void rla_engine_destroy(Engine* e) {
  {
    std::lock_guard<std::mutex> lk(e->mu);
    e->stop = true;
    e->cv_work.notify_all();
  }
  for (auto& t : e->threads) t.join();
  delete e;
}

}  // extern "C"
