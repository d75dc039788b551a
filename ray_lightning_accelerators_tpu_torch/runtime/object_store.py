"""Shared-memory object store: put/get large trees across host processes.

Port of the JAX package's ``runtime/object_store.py`` (the ``ray.put`` /
``ray.get`` analog).  Array leaves of ``threshold`` bytes (64 KiB) and
more go into POSIX shm segments (``native/shm_store.cc``) that any
process on the same host maps by name; smaller leaves stay inline in the
pickled structure.  An :class:`ObjectRef` is a small picklable handle
(segment names plus the pickled structure), so it crosses a process
boundary through any channel; the receiver resolves it with :func:`get`.

The store flattens its own trees: dicts, lists and tuples nest; numpy
arrays and CPU ``torch.Tensor`` leaves (stored as numpy) are the arrays;
anything else rides the pickle inline.  The structure is pickled with
the standard library's ``pickle``.

The creating store owns its segments and unlinks them on ``delete``,
``shutdown`` or interpreter exit.  A process killed before its exit
leaves its segments behind; :func:`unlink_segments_of` sweeps them by
the creator's pid, which every segment name carries.
"""

from __future__ import annotations

import atexit
import ctypes
import errno
import os
import pickle
import secrets
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import native

DEFAULT_THRESHOLD = 64 * 1024  # leaves smaller than this stay inline
# where POSIX shm names appear as files (Linux)
SHM_DIR = "/dev/shm"


class _Placeholder:
    """Stand-in for a shm-backed leaf inside the pickled structure."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __reduce__(self):
        return (_Placeholder, (self.index,))


def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` on every leaf; dicts, lists and tuples are rebuilt around
    the results in order."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _as_array(leaf: Any) -> Optional[np.ndarray]:
    """The numpy array a leaf stores as, or None for a non-array leaf."""
    if isinstance(leaf, np.ndarray):
        return leaf
    if isinstance(leaf, torch.Tensor):
        if leaf.device.type != "cpu":
            raise TypeError(
                f"object store leaves must be host data; got a tensor on "
                f"{leaf.device} (move it with .cpu() first)")
        if leaf.dtype == torch.bfloat16:
            raise TypeError(
                "numpy has no bfloat16: store the raw 16-bit words "
                "(tensor.view(torch.int16)) and view them back on get")
        return leaf.detach().numpy()
    return None


@dataclass(frozen=True)
class ObjectRef:
    """Picklable handle on a stored object (the ``ray.ObjectRef``
    analog)."""

    object_id: str
    # per shm leaf: (segment name, dtype string, shape)
    segments: Tuple[Tuple[str, str, Tuple[int, ...]], ...]
    payload: bytes = field(repr=False)  # pickled tree with placeholders

    def total_shm_bytes(self) -> int:
        return sum(int(np.dtype(d).itemsize) * int(np.prod(s, dtype=np.int64))
                   for _, d, s in self.segments)


class ObjectStoreError(RuntimeError):
    """A segment could not be created or opened (``errno`` holds why)."""

    def __init__(self, msg: str, err: int = 0):
        super().__init__(msg)
        self.errno = err


def _error(action: str, name: str) -> ObjectStoreError:
    err = native.lib().rla_shm_errno()
    if err == errno.ENOENT:
        return ObjectStoreError(
            f"{action} {name!r}: segment does not exist (already deleted, "
            "or put on a different host: shm is per host)", err)
    return ObjectStoreError(f"{action} {name!r}: {os.strerror(err)}", err)


class ObjectStore:
    """Put/get trees; large array leaves ride shared memory."""

    def __init__(self, threshold: int = DEFAULT_THRESHOLD):
        self.threshold = threshold
        self._lock = threading.Lock()
        self._owned: Dict[str, List[str]] = {}  # object_id -> segment names
        self._owned_bytes: Dict[str, int] = {}  # object_id -> shm bytes
        # zero-copy mappings by object_id, so release(ref) unmaps exactly
        # one object's views
        self._mappings: Dict[str, List[Tuple[int, int]]] = {}
        self._prefix = f"/rlat-{os.getpid()}-{secrets.token_hex(4)}"
        self._counter = 0
        atexit.register(self.shutdown)

    def total_shm_bytes(self) -> int:
        """Live shm bytes this store owns (placed and not yet deleted)."""
        with self._lock:
            return sum(self._owned_bytes.values())

    # ------------------------------------------------------------------ #
    def put(self, obj: Any) -> ObjectRef:
        """Store a tree: one copy per large leaf, into its segment."""
        with self._lock:
            self._counter += 1
            object_id = f"{self._prefix}-{self._counter}"
        segments: List[Tuple[str, str, Tuple[int, ...]]] = []
        lib = None

        def place(leaf: Any) -> Any:
            nonlocal lib
            arr = _as_array(leaf)
            if arr is None or arr.dtype.hasobject \
                    or arr.nbytes < self.threshold:
                return leaf if arr is None else arr
            if lib is None:
                lib = native.lib()
            arr = np.ascontiguousarray(arr)
            name = f"{object_id}-{len(segments)}"
            ptr = lib.rla_shm_create(name.encode(), arr.nbytes)
            if not ptr:
                raise _error("create", name)
            segments.append((name, arr.dtype.str, tuple(arr.shape)))
            try:
                dst = np.frombuffer(
                    (ctypes.c_char * arr.nbytes).from_address(ptr),
                    dtype=arr.dtype).reshape(arr.shape)
                np.copyto(dst, arr)
                del dst
            finally:
                lib.rla_shm_unmap(ptr, arr.nbytes)
            return _Placeholder(len(segments) - 1)

        try:
            payload = pickle.dumps(_tree_map(place, obj),
                                   protocol=pickle.HIGHEST_PROTOCOL)
        except BaseException:
            for name, _, _ in segments:  # leak no segment on a failed put
                lib.rla_shm_unlink(name.encode())
            raise
        ref = ObjectRef(object_id, tuple(segments), payload)
        with self._lock:
            self._owned[object_id] = [s[0] for s in segments]
            self._owned_bytes[object_id] = ref.total_shm_bytes()
        return ref

    # ------------------------------------------------------------------ #
    def get(self, ref: ObjectRef, copy: bool = True) -> Any:
        """Materialize a stored object.  ``copy=True`` returns independent
        arrays; ``copy=False`` read-only views into the mapped segments,
        valid until :meth:`release` of this ref or :meth:`shutdown`."""
        arrays: List[np.ndarray] = []
        lib = native.lib() if ref.segments else None
        for name, dtype_str, shape in ref.segments:
            size_out = ctypes.c_long()
            ptr = lib.rla_shm_open_ro(name.encode(), ctypes.byref(size_out))
            if not ptr:
                raise _error("open", name)
            nbytes = size_out.value
            view = np.frombuffer(
                (ctypes.c_char * nbytes).from_address(ptr),
                dtype=np.dtype(dtype_str)).reshape(shape)
            view.flags.writeable = False
            if copy:
                arrays.append(view.copy())
                del view
                lib.rla_shm_unmap(ptr, nbytes)
            else:
                with self._lock:
                    self._mappings.setdefault(
                        ref.object_id, []).append((ptr, nbytes))
                arrays.append(view)
        return _tree_map(
            lambda l: arrays[l.index] if isinstance(l, _Placeholder) else l,
            pickle.loads(ref.payload))

    # ------------------------------------------------------------------ #
    def release(self, ref: ObjectRef) -> None:
        """Unmap the views a ``get(copy=False)`` of this ref retained; the
        caller holds none of them any more."""
        with self._lock:
            mappings = self._mappings.pop(ref.object_id, [])
        if mappings:
            lib = native.lib()
            for ptr, nbytes in mappings:
                lib.rla_shm_unmap(ptr, nbytes)

    def delete(self, ref: ObjectRef) -> None:
        """Unlink the ref's segments (a later ``get`` raises ENOENT)."""
        with self._lock:
            names = self._owned.pop(ref.object_id, None)
            self._owned_bytes.pop(ref.object_id, None)
        names = names if names is not None else [s[0] for s in ref.segments]
        if names:
            lib = native.lib()
            for name in names:
                lib.rla_shm_unlink(name.encode())

    def shutdown(self) -> None:
        """Unmap every retained view and unlink every owned segment."""
        with self._lock:
            owned = [n for names in self._owned.values() for n in names]
            self._owned.clear()
            self._owned_bytes.clear()
            mappings, self._mappings = self._mappings, {}
        if not owned and not mappings:
            return  # nothing to do, and nothing to build for it
        lib = native.lib()
        for per_obj in mappings.values():
            for ptr, nbytes in per_obj:
                lib.rla_shm_unmap(ptr, nbytes)
        for name in owned:
            lib.rla_shm_unlink(name.encode())

    def __enter__(self) -> "ObjectStore":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


def segments_of(pid: int) -> List[str]:
    """The live segments a store in process ``pid`` created (their
    names start ``/rlat-{pid}-``); empty where the host lists no shm
    directory."""
    prefix = f"rlat-{int(pid)}-"
    try:
        return sorted("/" + n for n in os.listdir(SHM_DIR)
                      if n.startswith(prefix))
    except OSError:
        return []


def unlink_segments_of(pid: int) -> int:
    """Unlink every segment of a process that ended without its store's
    shutdown (killed, or ended by ``os._exit``); returns how many.  Only
    for a dead process: a live one still owns its segments."""
    names = segments_of(pid)
    if not names:
        return 0
    lib = native.lib()
    return sum(lib.rla_shm_unlink(name.encode()) == 0 for name in names)


# the process-global store: refs from other processes resolve through it
_GLOBAL: Optional[ObjectStore] = None
_GLOBAL_LOCK = threading.Lock()


def global_store() -> ObjectStore:
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = ObjectStore()
        return _GLOBAL


def resolve(value: Any) -> Any:
    """Dereference ``value`` if it is an :class:`ObjectRef`."""
    if isinstance(value, ObjectRef):
        return global_store().get(value)
    return value


def put(obj: Any) -> ObjectRef:
    """``ray.put`` analog on the process-global store."""
    return global_store().put(obj)


def get(ref: ObjectRef, copy: bool = True) -> Any:
    """``ray.get`` analog on the process-global store."""
    return global_store().get(ref, copy=copy)


def global_shm_bytes() -> int:
    """Live shm bytes owned by this process's global store (0 when none
    was ever built: reading must not instantiate one)."""
    with _GLOBAL_LOCK:
        store = _GLOBAL
    return store.total_shm_bytes() if store is not None else 0
