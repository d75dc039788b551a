"""Host C++ for the port, built with ``g++`` at first use and bound with
ctypes.

- ``shm_store.cc`` holds the object store's POSIX shared-memory segments
  (``rla_shm_create`` / ``_open_ro`` / ``_unmap`` / ``_unlink`` /
  ``_errno``): :func:`lib`.
- ``data_engine.cc`` is the DataLoader's threaded batch engine
  (``rla_engine_create`` / ``_start_epoch`` / ``_next_batch`` /
  ``_num_batches`` / ``_destroy``): :func:`engine_lib` and
  :class:`DataEngine`.

Each source compiles on its own, the first time a process needs it, into
``build/torch_native/<stem>-<digest>.so`` at the repository root (the
digest covers the source and the flags, so an edit rebuilds; the build
writes a temporary file and renames it, so processes building at once
all leave a valid library), and loads with its argument and result types
declared.  Nothing is built on import.  A failed build raises
:class:`NativeBuildError`; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
SRC = _DIR / "shm_store.cc"
ENGINE_SRC = _DIR / "data_engine.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
# shm_open / shm_unlink live in librt before glibc 2.34 (a stub after)
LINK_FLAGS = ["-lrt"] if sys.platform.startswith("linux") else []


class NativeBuildError(RuntimeError):
    """g++ is missing, refused the source, or the library did not load."""


_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}
# the g++ runs this process made (a library found on disk takes none) and
# their wall seconds
_compiles = 0
_compile_seconds = 0.0


def _digest(src: Path) -> str:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(src: Path = SRC) -> Path:
    return BUILD_DIR / f"{src.stem}-{_digest(src)}.so"


def compile_stats() -> tuple:
    """(g++ runs, their wall seconds) in this process."""
    return _compiles, _compile_seconds


def _compile(src: Path, out: Path) -> None:
    global _compiles, _compile_seconds
    t0 = time.perf_counter()
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise NativeBuildError(f"no C++ compiler (g++) to build {src.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src),
                           *LINK_FLAGS], capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"g++ failed on {src.name}: {proc.stderr[-2000:]}")
    os.replace(tmp, out)  # atomic: concurrent builds all leave a valid file
    _compiles += 1
    _compile_seconds += time.perf_counter() - t0


def _declare_shm(lib: ctypes.CDLL) -> None:
    P, L, S = ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p
    lib.rla_shm_create.restype = P
    lib.rla_shm_create.argtypes = [S, L]
    lib.rla_shm_open_ro.restype = P
    lib.rla_shm_open_ro.argtypes = [S, ctypes.POINTER(L)]
    lib.rla_shm_unmap.restype = ctypes.c_int
    lib.rla_shm_unmap.argtypes = [P, L]
    lib.rla_shm_unlink.restype = ctypes.c_int
    lib.rla_shm_unlink.argtypes = [S]
    lib.rla_shm_errno.restype = ctypes.c_int
    lib.rla_shm_errno.argtypes = []


def _declare_engine(lib: ctypes.CDLL) -> None:
    P, L = ctypes.c_void_p, ctypes.c_long
    lib.rla_engine_create.restype = P
    lib.rla_engine_create.argtypes = [
        ctypes.c_int, ctypes.POINTER(P), ctypes.POINTER(L), L, L,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.rla_engine_start_epoch.restype = ctypes.c_int
    lib.rla_engine_start_epoch.argtypes = [P, ctypes.POINTER(L), L]
    lib.rla_engine_next_batch.restype = L
    lib.rla_engine_next_batch.argtypes = [P, ctypes.POINTER(P)]
    lib.rla_engine_num_batches.restype = L
    lib.rla_engine_num_batches.argtypes = [P]
    lib.rla_engine_destroy.restype = None
    lib.rla_engine_destroy.argtypes = [P]


def _load(src: Path, declare) -> ctypes.CDLL:
    """The loaded library of ``src``, built first if it has none yet;
    raises :class:`NativeBuildError` when it cannot be had."""
    with _lock:
        loaded = _libs.get(src)
        if loaded is not None:
            return loaded
        out = library_path(src)
        fresh = not out.exists()
        if fresh:
            _compile(src, out)
        try:
            loaded = ctypes.CDLL(str(out))
        except OSError as e:
            if fresh:
                raise NativeBuildError(f"cannot load {out}: {e}") from e
            # a library built elsewhere (another libc): build it here
            _compile(src, out)
            try:
                loaded = ctypes.CDLL(str(out))
            except OSError as e2:
                raise NativeBuildError(f"cannot load {out}: {e2}") from e2
        declare(loaded)
        _libs[src] = loaded
        return loaded


def lib() -> ctypes.CDLL:
    """The shm library (``shm_store.cc``)."""
    return _load(SRC, _declare_shm)


def engine_lib() -> ctypes.CDLL:
    """The batch engine's library (``data_engine.cc``)."""
    return _load(ENGINE_SRC, _declare_engine)


def engine_compatible_arrays(arrays) -> bool:
    """Only flat-memory numeric / bool rows may be memcpy'd; object
    arrays hold PyObject pointers that must be refcounted."""
    return bool(arrays) and all(
        isinstance(a, np.ndarray) and not a.dtype.hasobject for a in arrays)


class DataEngine:
    """ctypes handle on the C++ batcher; yields tuples of numpy batches
    (one array alone when the dataset has one).

    The index order comes from the caller (``iter_indices``: the loader's
    ``ShardedSampler``, this rank's shard under several ranks), so the
    batches are bitwise the Python loader's: shuffling, rank slicing and
    pad-by-wrap included.  Single consumer: iterate from one thread at a
    time, one epoch at a time.
    """

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int,
                 drop_last: bool = True, num_threads: Optional[int] = None,
                 prefetch: int = 4):
        if not engine_compatible_arrays(arrays):
            raise TypeError("DataEngine needs numeric numpy arrays "
                            "(object dtypes cannot be memcpy'd)")
        self._lib = engine_lib()
        # contiguous copies kept alive for the engine's borrowed pointers
        self.arrays = [np.ascontiguousarray(a) for a in arrays]
        if any(len(a) != len(self.arrays[0]) for a in self.arrays):
            raise ValueError("DataEngine needs arrays of equal length")
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        n = len(self.arrays)
        ptrs = (ctypes.c_void_p * n)(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in self.arrays])
        row_bytes = (ctypes.c_long * n)(
            *[int(np.prod(a.shape[1:], dtype=np.int64)) * a.itemsize
              for a in self.arrays])
        if num_threads is None:
            num_threads = min(8, max(2, (os.cpu_count() or 4) // 2))
        self._handle = self._lib.rla_engine_create(
            n, ptrs, row_bytes, len(self.arrays[0]), self.batch_size,
            int(drop_last), int(num_threads), int(prefetch))

    def iter_indices(self, indices: np.ndarray
                     ) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield collated batches over an explicit row-index order."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        rc = self._lib.rla_engine_start_epoch(
            self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            len(idx))
        if rc != 0:
            raise IndexError("sampler produced out-of-range row index")
        while True:
            # a fresh allocation per batch: callers may hold references
            # across iterations (as the Python collate's); the gather
            # already happened on the engine's threads
            out = [np.empty((self.batch_size,) + a.shape[1:], dtype=a.dtype)
                   for a in self.arrays]
            ptrs = (ctypes.c_void_p * len(out))(
                *[a.ctypes.data_as(ctypes.c_void_p).value for a in out])
            rows = self._lib.rla_engine_next_batch(self._handle, ptrs)
            if rows == 0:
                return
            batch = tuple(a if rows == self.batch_size else a[:rows]
                          for a in out)
            yield batch if len(batch) > 1 else batch[0]

    def num_batches(self) -> int:
        """Batches of the epoch started last."""
        return int(self._lib.rla_engine_num_batches(self._handle))

    def close(self) -> None:
        h, self._handle = self._handle, None
        if h:
            self._lib.rla_engine_destroy(h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
