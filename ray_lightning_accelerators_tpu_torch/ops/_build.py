"""Kernel build: compile ``csrc/*.cu`` for Hopper and load them with ctypes.

At the first CUDA use, every source under ``csrc/`` is compiled by its
own ``nvcc`` process, all started together, into a shared library with a
plain C interface under ``build/torch_kernels/`` at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <stem>-<digest>.so <stem>.cu

The file name carries a digest of the sources and flags, so an edited
source rebuilds and an unchanged one loads from disk.  ``-Xptxas -v``
reports each kernel's registers, shared memory and spills; the report is
kept beside the library (``<stem>-<digest>.log``, see :func:`build_logs`).

Binding is by ``ctypes``: pointers and the stream are ``c_void_p``
(Python ints from ``Tensor.data_ptr()`` and :func:`stream_of`), sizes
``c_int``.  Every C
entry returns ``cudaGetLastError()`` after its launch and
:func:`check` raises :class:`KernelLaunchError` on a non-zero code: a
launch the driver refuses never runs, and a later synchronise would not
report it.  Only sources in the repository go into the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes shared with csrc/common.cuh (enum RlaDtype)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argtypes (every entry returns an int CUDA error code)
SIGNATURES = {
    "rla_rms_norm": [_P, _P, _P, _I, _I, _F, _I, _I, _P],
    "rla_layer_norm": [_P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
    "rla_int8_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "rla_int8_matmul_nt": [_P, _P, _P, _I, _I, _I, _I, _P],
    "rla_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                            _I, _P],
    "rla_flash_bwd_dq": [_P] * 7 + [_I] * 4 + [_F, _I, _I, _I, _P],
    "rla_flash_bwd_dkv": [_P] * 8 + [_I] * 4 + [_F, _I, _I, _I, _P],
    "rla_flash_bwd_fused": [_P] * 9 + [_I] * 4 + [_F, _I, _I, _I, _P],
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelBuildError(
        "nvcc not found on PATH or under CUDA_HOME; the port's CUDA kernels "
        "are built from csrc/ at first use and need the CUDA toolkit")


def _digest(src: Path, headers: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [*headers, src]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Build (or reuse) and load every library; returns stem -> CDLL.
    Thread-safe; the first caller builds, later callers get the cache."""
    with _lock:
        if _libs:
            return _libs
        srcs = sorted(CSRC.glob("*.cu"))
        headers = sorted(CSRC.glob("*.cuh"))
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for src in srcs:
            out = BUILD_DIR / f"{src.stem}-{_digest(src, headers)}.so"
            log = out.with_suffix(".log")
            if out.exists() and log.exists():
                jobs.append((src, out, log, None, None))
                continue
            tmp = out.parent / f"{out.name}.tmp{os.getpid()}"
            proc = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((src, out, log, tmp, proc))
        failures = []
        for src, out, log, tmp, proc in jobs:
            if proc is None:
                continue
            text = proc.communicate()[0]
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {src.name} "
                                f"(rc {proc.returncode}):\n{text}")
                continue
            os.replace(tmp, out)
            log.write_text(text)
        if failures:
            raise KernelBuildError("\n".join(failures))
        libs = {}
        for src, out, log, _tmp, _proc in jobs:
            lib = ctypes.CDLL(str(out))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name, None)
                if fn is not None:
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            lib.rla_error_string.argtypes = [ctypes.c_int]
            lib.rla_error_string.restype = ctypes.c_char_p
            libs[src.stem] = lib
            _logs[src.stem] = log.read_text()
        _libs.update(libs)
        return _libs


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``.  Once built, a
    lookup takes no lock: ``_libs`` is filled once, in one update."""
    lib = _libs.get(stem)
    return lib if lib is not None else build_all()[stem]


def library_path(stem: str) -> str:
    """The file of the loaded library built from ``csrc/<stem>.cu``."""
    return library(stem)._name


def build_logs() -> Dict[str, str]:
    """stem -> nvcc's ``-Xptxas -v`` report for that library."""
    build_all()
    return dict(_logs)


def check(err: int, what: str, stem: str) -> None:
    if err != 0:
        msg = library(stem).rla_error_string(err).decode()
        raise KernelLaunchError(f"{what}: CUDA error {err} ({msg})")


def _raw_stream_reader(c_module):
    """A function from a device index to the raw handle of PyTorch's
    current stream there: ``_cuda_getCurrentRawStream`` (as
    ``torch._inductor`` reads it, without building a ``torch.cuda.Stream``)
    where c_module has it, else the public ``torch.cuda.current_stream``
    (a CPU-only build of torch lacks the first)."""
    raw = getattr(c_module, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw
    return lambda index: torch.cuda.current_stream(index).cuda_stream


_current_raw_stream = _raw_stream_reader(torch._C)


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on t's device."""
    return _current_raw_stream(t.get_device())


def dtype_code(t: torch.Tensor, what: str) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: the CUDA kernel takes float32, bfloat16 "
                        f"or float16 activations, got {t.dtype}")
    return code


def check_operands(what: str, *tensors: torch.Tensor) -> None:
    """Every operand on one CUDA device and contiguous, or a typed error:
    the kernels compute their own offsets from dense row-major layouts."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: operands on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the CUDA kernel needs contiguous "
                             f"operands, got strides {t.stride()} for shape "
                             f"{tuple(t.shape)}")
