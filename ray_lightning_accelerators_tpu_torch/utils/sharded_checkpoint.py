"""Sharded and async checkpoints: every rank writes what it owns.

Port of the JAX package's ``utils/sharded_checkpoint.py``, with the
port's own on-disk format (it does not read the JAX package's orbax
checkpoints, nor they its).  The pickle format (``utils/checkpoint.py``)
gathers the whole state on rank 0; here:

- **save**: each rank writes the state tensors it owns as one plain
  ``torch.save`` file, ``<path>/state/rank<r>.pt``, and rank 0 writes
  ``<path>/state/manifest.json`` (format 2): every leaf's global shape,
  dtype, layout and, for each part, its file and the rectangle it covers
  (its start and length on every dim).  A layout is None (whole),
  ``PER_REPLICA`` (one row per batch shard) or the ``(axis, dim)`` pairs
  that split the leaf, model axes first (``"tensor"``, ``"expert"``,
  ``"pipeline"``), then ``"batch"`` (the batch axes' split, fsdp or
  ZeRO-1, inside the model part), so a part is the rank's slice of its
  model part.  A rank writes a part only when it is the first of the
  ranks that hold it (coordinate 0 on every axis that does not split the
  leaf): rank 0 the whole leaves, the batch shards' leads their rows.
  Files are written to a temporary name and renamed.  Format 1 (one
  split dim and ``r * n`` offsets along it) still restores.
- **meta.json last**: rank 0 writes the non-tensor half (epoch, step,
  hyperparameters, callback states, counters) only after every rank's
  file is committed, with the SHA-256 and size of each file under
  ``state/`` (``_tree_digests``), via a temporary file and a rename: a
  ``meta.json`` marks a complete checkpoint, and ``verify_checkpoint``
  recomputes the digests, so a torn or truncated save is found before a
  restore walks into it.
- **restore**: ``restore_sharded`` assembles each leaf's global tensor
  from the parts, or, given the layouts of another world, cuts this
  rank's part out of it: a checkpoint written by N ranks restores onto
  any world whose layouts divide the global shapes.
- **async** (``sharded-async``): the tensors are copied to the host
  first, then a background thread writes them; rank 0's thread waits for
  every rank's file before it writes ``meta.json``.
  ``wait_until_finished`` joins this process's threads, and an atexit
  hook does it at interpreter exit.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..parallel import mesh as mesh_lib
from ..parallel.plan import PER_REPLICA

STATE_DIR = "state"
META_FILE = "meta.json"
MANIFEST_FILE = "manifest.json"
INTEGRITY_KEY = "integrity"

# how long rank 0's async finalize waits for the other ranks' files
FINALIZE_TIMEOUT_S = 600.0

_finalize_threads: List[threading.Thread] = []
_atexit_registered = False
# verdicts primed by this process's saves: abspath -> (meta mtime, bytes)
_verify_cache: Dict[str, tuple] = {}

Entry = Tuple[str, torch.Tensor, Any]   # (name, local tensor, layout)


def _register_exit_fence() -> None:
    global _atexit_registered
    if not _atexit_registered:
        import atexit
        atexit.register(wait_until_finished)
        _atexit_registered = True


def wait_until_finished() -> None:
    """Fence this process's in-flight async saves (its file and, on rank
    0, the ``meta.json`` finalize)."""
    while _finalize_threads:
        _finalize_threads.pop().join()


def is_sharded_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, META_FILE))


def rank_file(rank: int) -> str:
    return f"rank{rank:05d}.pt"


def entries_of(tree: Any, prefix: str = "") -> List[Entry]:
    """A nested dict of tensors as replicated entries named by path."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree)
                for e in entries_of(tree[k], f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), torch.as_tensor(tree), None)]


BATCH = "batch"
FORMAT = 2


class _Place:
    """Where rank ``rank`` sits in a world of ``shape`` (the mesh's axis
    sizes; ``order``, a hybrid mesh's rank at each position): its
    coordinate and the size of each axis, ``"batch"`` being the batch
    axes (data x fsdp) taken together."""

    def __init__(self, shape: Dict[str, int], rank: int,
                 order: Optional[Sequence[int]] = None):
        self.sizes = {a: int(shape.get(a, 1)) for a in mesh_lib.AXIS_ORDER}
        mesh = mesh_lib.Mesh(self.sizes,
                             order=tuple(order) if order else None)
        self.coords = mesh.coords_of(rank)
        self.sizes[BATCH] = mesh_lib.data_parallel_size(mesh)
        self.coords[BATCH] = (
            self.coords[mesh_lib.DATA_AXIS]
            * self.sizes[mesh_lib.FSDP_AXIS]
            + self.coords[mesh_lib.FSDP_AXIS])

    def owns(self, layout: Any) -> bool:
        """True on the first of the ranks holding this part: coordinate 0
        on every axis that does not split the leaf."""
        split = set()
        for a, _ in _pairs(layout):
            split.update(mesh_lib.BATCH_AXES if a == BATCH else (a,))
        return all(c == 0 for a, c in self.coords.items()
                   if a != BATCH and a not in split)

    def rectangle(self, layout: Any, shape: Sequence[int]
                  ) -> Tuple[List[int], List[int]]:
        """(start, length) on every dim of the global ``shape`` of this
        rank's part: each pair narrows its dim to the coordinate's share
        of what the pairs before it left."""
        start, length = [0] * len(shape), list(shape)
        for a, d in _pairs(layout):
            length[d] //= self.sizes[a]
            start[d] += self.coords[a] * length[d]
        return start, length


def _pairs(layout: Any) -> Tuple[Tuple[str, int], ...]:
    """A layout's ``(axis, dim)`` pairs: a per-rank buffer is split on a
    leading dim over the batch axes."""
    if layout is None:
        return ()
    if layout == PER_REPLICA:
        return ((BATCH, 0),)
    return tuple((a, int(d)) for a, d in layout)


def global_shape(local: torch.Tensor, layout: Any,
                 sizes: Dict[str, int]) -> List[int]:
    """The whole leaf's shape from one rank's part (``sizes``: each
    axis's, and the batch axes' as ``"batch"``)."""
    shape = list(local.shape)
    if layout == PER_REPLICA:
        return [sizes[BATCH]] + shape
    for a, d in _pairs(layout):
        shape[d] *= sizes[a]
    return shape


def _world_shape(world: int, shape: Optional[Dict[str, int]]
                 ) -> Dict[str, int]:
    """The mesh of a save: a world without one is ``world`` batch
    shards."""
    return dict(shape) if shape is not None else {
        mesh_lib.DATA_AXIS: world}


def build_manifest(entries: Sequence[Entry], world: int,
                   shape: Optional[Dict[str, int]] = None,
                   order: Optional[Sequence[int]] = None
                   ) -> Dict[str, Any]:
    """Global shapes and the rectangle of each part, with the file that
    holds it (identical on every rank: the layouts and local shapes
    are)."""
    shape = _world_shape(world, shape)
    places = [_Place(shape, r, order) for r in range(world)]
    leaves = {}
    for name, t, layout in entries:
        full = global_shape(t, layout, places[0].sizes)
        parts = []
        for r, place in enumerate(places):
            if not place.owns(layout):
                continue
            start, length = place.rectangle(layout, full)
            parts.append({"file": rank_file(r), "start": start,
                          "length": length})
        leaves[name] = {
            "shape": full, "dtype": str(t.dtype).replace("torch.", ""),
            "layout": (layout if layout in (None, PER_REPLICA)
                       else [list(p) for p in _pairs(layout)]),
            "parts": parts}
    return {"format": FORMAT, "world": world, "mesh": shape,
            "leaves": leaves}


def _host_copy(entries: Sequence[Entry], place: _Place
               ) -> Dict[str, torch.Tensor]:
    """This rank's owned tensors, copied to host memory (contiguous, own
    storage: a view must not drag its base into the file)."""
    return {name: t.detach().to("cpu", copy=True).contiguous()
            for name, t, layout in entries if place.owns(layout)}


def _atomic_write(path: str, write: Callable[[str], None]) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _write_json(path: str, obj: Any) -> None:
    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(obj, f, default=str)
    _atomic_write(path, write)


def _tree_digests(path: str) -> Dict[str, Dict[str, Any]]:
    """SHA-256 and size of each file under ``<path>/state/``."""
    state_dir = os.path.join(path, STATE_DIR)
    files: Dict[str, Dict[str, Any]] = {}
    for root, _dirs, names in os.walk(state_dir):
        for name in sorted(names):
            if ".tmp" in name:
                continue
            fp = os.path.join(root, name)
            rel = os.path.relpath(fp, state_dir)
            h = hashlib.sha256()
            try:
                with open(fp, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 20), b""):
                        h.update(chunk)
                files[rel] = {"sha256": h.hexdigest(),
                              "bytes": os.path.getsize(fp)}
            except OSError:
                continue
    return files


def _write_meta(path: str, metadata: Dict[str, Any]) -> None:
    """meta.json last, with the integrity record."""
    meta = dict(metadata)
    meta[INTEGRITY_KEY] = {"algo": "sha256", "files": _tree_digests(path)}
    meta_path = os.path.join(path, META_FILE)
    _write_json(meta_path, meta)
    try:
        total = sum(r["bytes"] for r in meta[INTEGRITY_KEY]["files"].values())
        _verify_cache[path] = (os.path.getmtime(meta_path), total)
    except OSError:
        pass


def _wait_for_files(path: str, names: Sequence[str],
                    timeout_s: float) -> bool:
    state_dir = os.path.join(path, STATE_DIR)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if all(os.path.exists(os.path.join(state_dir, n)) for n in names):
            return True
        time.sleep(0.01)
    return False


def save_sharded(path: str, state: Any, metadata: Dict[str, Any],
                 async_save: bool = False, rank: int = 0, world: int = 1,
                 barrier: Optional[Callable[[], None]] = None,
                 shape: Optional[Dict[str, int]] = None,
                 order: Optional[Sequence[int]] = None) -> None:
    """Write ``state`` under ``path``: a list of ``(name, local tensor,
    layout)`` entries (every rank of the world calls this with its own),
    or a nested dict of tensors (replicated leaves).  ``shape``: the
    mesh's axis sizes (None: ``world`` batch shards) and ``order`` its
    rank at each position (a hybrid mesh); ``rank`` is the rank in the
    world.  ``barrier`` (the process group's, in a world of
    ranks) orders the sync save: every rank's file before rank 0's
    ``meta.json``."""
    wait_until_finished()     # one save in flight at a time
    path = os.path.abspath(path)
    entries = state if isinstance(state, list) else entries_of(state)
    state_dir = os.path.join(path, STATE_DIR)
    if rank == 0 and os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)   # an older save's files
    if barrier is not None:
        barrier()
    os.makedirs(state_dir, exist_ok=True)
    tensors = _host_copy(entries, _Place(_world_shape(world, shape), rank,
                                         order))
    manifest = (build_manifest(entries, world, shape, order) if rank == 0
                else None)
    files = sorted({p["file"] for leaf in (manifest or {}).get(
        "leaves", {}).values() for p in leaf["parts"]})

    def write_rank_file():
        if tensors or rank == 0:    # a rank that owns no part writes none
            _atomic_write(os.path.join(state_dir, rank_file(rank)),
                          lambda tmp: torch.save(tensors, tmp))

    if rank == 0:
        _write_json(os.path.join(state_dir, MANIFEST_FILE), manifest)
    if not async_save:
        write_rank_file()
        if barrier is not None:
            barrier()
        if rank == 0:
            _write_meta(path, metadata)
        if barrier is not None:
            barrier()
        return
    _register_exit_fence()
    meta_snapshot = dict(metadata)

    def finalize():
        write_rank_file()
        if rank != 0:
            return
        if not _wait_for_files(path, files, FINALIZE_TIMEOUT_S):
            return   # a rank never committed: no meta.json, not complete
        if os.path.isdir(state_dir):
            _write_meta(path, meta_snapshot)

    t = threading.Thread(target=finalize, daemon=True)
    _finalize_threads.append(t)
    t.start()


def read_metadata(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, META_FILE)) as f:
        return json.load(f)


def read_manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, STATE_DIR, MANIFEST_FILE)) as f:
        return json.load(f)


def _tree_total_bytes(path: str) -> int:
    total = 0
    for root, _dirs, names in os.walk(os.path.join(path, STATE_DIR)):
        for name in names:
            try:
                total += os.path.getsize(os.path.join(root, name))
            except OSError:
                continue
    return total


def verify_checkpoint(path: str, use_cache: bool = False) -> Tuple[bool, str]:
    """``(ok, reason)`` of a sharded checkpoint: the structure (state dir,
    readable ``meta.json``) and every file's digest against the record.
    ``use_cache`` accepts this process's own save of the unmodified
    checkpoint without re-hashing.  Never raises."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return False, "not a directory"
    meta_path = os.path.join(path, META_FILE)
    if not os.path.exists(meta_path):
        return False, "meta.json missing (torn or in-flight save)"
    if use_cache:
        cached = _verify_cache.get(path)
        try:
            mtime = os.path.getmtime(meta_path)
        except OSError:
            mtime = None
        if cached is not None and mtime == cached[0] \
                and cached[1] == _tree_total_bytes(path):
            return True, "ok"
    try:
        meta = read_metadata(path)
    except (ValueError, OSError) as e:
        return False, f"meta.json unreadable: {e}"
    if not os.path.isdir(os.path.join(path, STATE_DIR)):
        return False, "state tree missing"
    integ = meta.get(INTEGRITY_KEY)
    if not isinstance(integ, dict) or "files" not in integ:
        return True, "ok (no integrity record; pre-digest checkpoint)"
    actual = _tree_digests(path)
    for rel, rec in integ["files"].items():
        got = actual.get(rel)
        if got is None:
            return False, f"shard file missing: {rel}"
        if rec.get("bytes") is not None and got["bytes"] != rec["bytes"]:
            return False, (f"shard file truncated/resized: {rel} "
                           f"({got['bytes']} != {rec['bytes']} bytes)")
        if got["sha256"] != rec.get("sha256"):
            return False, f"shard file digest mismatch: {rel}"
    return True, "ok"


def restore_sharded(path: str, layouts: Optional[Dict[str, Any]] = None,
                    rank: int = 0, world: int = 1
                    ) -> Dict[str, torch.Tensor]:
    """The saved tensors by name, each the leaf's global tensor; with
    ``layouts`` (name -> layout for the restoring world of ``world``
    ranks), this rank's part: its slice of a split leaf, its row of a
    per-rank buffer saved by as many ranks (a buffer from another world
    comes back whole, for the caller to reset)."""
    wait_until_finished()
    path = os.path.abspath(path)
    manifest = read_manifest(path)
    state_dir = os.path.join(path, STATE_DIR)
    files: Dict[str, Dict[str, torch.Tensor]] = {}

    def load(name: str) -> Dict[str, torch.Tensor]:
        if name not in files:
            files[name] = torch.load(os.path.join(state_dir, name),
                                     map_location="cpu", weights_only=True)
        return files[name]

    out = {}
    for name, leaf in manifest["leaves"].items():
        layout = leaf["layout"]
        parts = [load(p["file"])[name] for p in leaf["parts"]]
        if manifest.get("format", 1) >= 2:
            full = _assemble(parts, leaf)
        elif layout is None:
            full = parts[0]
        elif layout == PER_REPLICA:
            full = torch.stack(parts)
        else:
            full = torch.cat(parts, dim=layout)
        if list(full.shape) != list(leaf["shape"]):
            raise ValueError(f"checkpoint {path}: leaf {name} assembles to "
                             f"{list(full.shape)}, manifest says "
                             f"{leaf['shape']}")
        target = (layouts or {}).get(name)
        if layouts is not None and target is not None:
            full = local_part(full, target, rank, world)
        out[name] = full
    return out


def _assemble(parts: Sequence[torch.Tensor], leaf: Dict[str, Any]
              ) -> torch.Tensor:
    """A format-2 leaf from its parts: each copied into its rectangle."""
    if len(parts) == 1 and list(parts[0].shape) == list(leaf["shape"]):
        return parts[0]
    full = torch.empty(leaf["shape"], dtype=parts[0].dtype)
    covered = 0
    for part, rec in zip(parts, leaf["parts"]):
        index = tuple(slice(s, s + n) for s, n in zip(rec["start"],
                                                      rec["length"]))
        full[index] = part.reshape(rec["length"])
        covered += part.numel()
    if covered != full.numel():
        raise ValueError(f"leaf parts cover {covered} of "
                         f"{full.numel()} elements")
    return full


def restore_params(path: str, device="cpu") -> Dict[str, Any]:
    """The checkpoint's parameter tree (the ``params/`` leaves, whole) as
    tensors on ``device``."""
    tree: Dict[str, Any] = {}
    for name, t in restore_sharded(path).items():
        if not name.startswith("params/"):
            continue
        *parents, leaf = name.split("/")[1:]
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = t.to(device)
    return tree


def local_part(full: torch.Tensor, layout: Any, rank: int,
               world: int) -> torch.Tensor:
    """Rank ``rank``'s part of a global tensor under ``layout`` (a
    per-rank buffer of another world is returned whole)."""
    if layout is None:
        return full
    if layout == PER_REPLICA:
        return full[rank] if full.shape[0] == world else full
    n = full.shape[layout] // world
    return full.narrow(layout, rank * n, n)


def remove_checkpoint(path: str) -> None:
    """Delete a checkpoint, a pickle file or a sharded directory."""
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
    elif os.path.exists(path):
        os.unlink(path)
