"""Host C++ for the port, built with ``g++`` at first use and bound with
ctypes.

``shm_store.cc`` holds the object store's POSIX shared-memory segments
(``rla_shm_create`` / ``_open_ro`` / ``_unmap`` / ``_unlink`` /
``_errno``).  :func:`lib` compiles it, the first time a process needs
it, into ``build/torch_native/shm_store-<digest>.so`` at the repository
root (the digest covers the source and the flags, so an edit rebuilds),
and loads it with its argument and result types declared.  Nothing is
built on import.  A failed build raises :class:`NativeBuildError`; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "shm_store.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
# shm_open / shm_unlink live in librt before glibc 2.34 (a stub after)
LINK_FLAGS = ["-lrt"] if sys.platform.startswith("linux") else []


class NativeBuildError(RuntimeError):
    """g++ is missing, refused the source, or the library did not load."""


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _digest() -> str:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"{SRC.stem}-{_digest()}.so"


def _compile(out: Path) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise NativeBuildError(f"no C++ compiler (g++) to build {SRC.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC),
                           *LINK_FLAGS], capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"g++ failed on {SRC.name}: {proc.stderr[-2000:]}")
    os.replace(tmp, out)  # atomic: concurrent builds all leave a valid file


def _declare(lib: ctypes.CDLL) -> None:
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


def lib() -> ctypes.CDLL:
    """The loaded shm library, built first if this source has no library
    yet; raises :class:`NativeBuildError` when it cannot be had."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            fresh = not out.exists()
            if fresh:
                _compile(out)
            try:
                loaded = ctypes.CDLL(str(out))
            except OSError as e:
                if fresh:
                    raise NativeBuildError(f"cannot load {out}: {e}") from e
                # a library built elsewhere (another libc): build it here
                _compile(out)
                try:
                    loaded = ctypes.CDLL(str(out))
                except OSError as e2:
                    raise NativeBuildError(
                        f"cannot load {out}: {e2}") from e2
            _declare(loaded)
            _lib = loaded
        return _lib
