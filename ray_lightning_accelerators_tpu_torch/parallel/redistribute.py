"""Wave packing for bounded transfers, and the live state's redistribution
between two worlds of ranks.

Port of the JAX package's ``parallel/redistribute.py``.  ``wave_schedule``
also paces the KV handoff's copies through the object store.

In the JAX package a layout is a ``NamedSharding`` over the devices of one
process and ``jax.device_put`` moves a leaf between two of them.  In the
port a leaf lives in parts on the ranks of a ``torch.distributed`` world,
and a layout is the plan's part rectangles (``parallel/plan.py``, the
format-2 sharded checkpoint): the ``(axis, dim)`` pairs that split the
leaf (``"batch"`` for the batch axes taken together: ZeRO-1's dim-0 slice,
the FSDP split) over a mesh of axis sizes, or None where every rank holds
it whole.

- ``leaf_moved_bytes`` / ``resharding_bytes``: the analytic count, in the
  bytes whose owner rank changes: for every rank of the new world, the
  part of its new rectangle its old one did not already hold (a rank new
  to the world holds nothing).  For the same layouts this is the JAX
  functions' count over devices.
- ``redistribute_tree``: the move, a collective over the current process
  group (the old world on a shrink, the new one on a grow).  Leaves go in
  ``wave_schedule`` waves under ``max_bytes``; in a wave, each distinct
  old part is broadcast once from the first rank holding it, and every
  rank keeps only the overlap with its new rectangle, so no rank ever
  holds a whole copy of the tree, nor a leaf whole unless its new part is
  the whole leaf.  ``donate`` drops each source part once its wave has
  landed.  Only broadcasts are used: gloo on the card's torch has no send
  or receive for CUDA tensors, and several ranks sharing one card need
  gloo.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

DEFAULT_WAVE_BYTES = 256 << 20

__all__ = ["DEFAULT_WAVE_BYTES", "Leaf", "leaf_moved_bytes",
           "resharding_bytes", "redistribute_tree", "wave_schedule"]

Rect = Tuple[List[int], List[int]]


def wave_schedule(sizes: Sequence[int],
                  max_bytes: int = DEFAULT_WAVE_BYTES) -> List[List[int]]:
    """Greedy, order-preserving wave packing: indices grouped so each
    group's summed bytes stay under ``max_bytes`` (an oversized item
    gets a wave of its own)."""
    waves: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, sz in enumerate(sizes):
        if cur and cur_bytes + sz > max_bytes:
            waves.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += sz
    if cur:
        waves.append(cur)
    return waves


@dataclass
class Leaf:
    """One leaf of the tree to move: its name, whole shape and item size,
    and its layout before (``old``) and after (``new``).  ``tensor``
    False marks a host scalar (a step, a count, the generator's key): it
    is counted here and carried by the caller."""

    name: str
    shape: Tuple[int, ...]
    itemsize: int
    old: Any = None
    new: Any = None
    tensor: bool = True

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.itemsize


def _world(mesh_shape: Dict[str, int]) -> int:
    return math.prod(int(v) for v in mesh_shape.values())


def _rect(layout: Any, mesh_shape: Dict[str, int], rank: int,
          shape: Sequence[int]) -> Rect:
    from ..utils.sharded_checkpoint import _Place
    return _Place(mesh_shape, rank).rectangle(layout, list(shape))


def _overlap(a: Rect, b: Rect) -> Optional[Rect]:
    """The intersection of two rectangles, or None."""
    start, length = [], []
    for a0, al, b0, bl in zip(a[0], a[1], b[0], b[1]):
        lo, hi = max(a0, b0), min(a0 + al, b0 + bl)
        if hi <= lo:
            return None
        start.append(lo)
        length.append(hi - lo)
    return start, length


def _volume(rect: Optional[Rect]) -> int:
    return 0 if rect is None else math.prod(rect[1])


def leaf_moved_bytes(leaf: Leaf, old_shape: Optional[Dict[str, int]],
                     new_shape: Dict[str, int]) -> int:
    """Bytes of ``leaf`` that must reach a rank that did not hold them:
    for every rank of the new world (axis sizes ``new_shape``), the part
    of its new rectangle outside its old one.  A leaf with no old world
    (``old_shape`` None: a host value) counts in full."""
    if old_shape is None:
        return leaf.nbytes
    if leaf.old == leaf.new and dict(old_shape) == dict(new_shape):
        return 0
    n_old = _world(old_shape)
    moved = 0
    for r in range(_world(new_shape)):
        need = _rect(leaf.new, new_shape, r, leaf.shape)
        have = (_volume(_overlap(_rect(leaf.old, old_shape, r, leaf.shape),
                                 need)) if r < n_old else 0)
        moved += (math.prod(need[1]) - have) * leaf.itemsize
    return moved


def resharding_bytes(leaves: Sequence[Leaf],
                     old_shape: Optional[Dict[str, int]],
                     new_shape: Dict[str, int]) -> int:
    """The analytic redistribution byte count of a whole tree."""
    return sum(leaf_moved_bytes(x, old_shape, new_shape) for x in leaves)


def _local(rect: Rect, within: Rect) -> Tuple[Tuple[int, int], ...]:
    """``rect`` as (start, length) per dim inside the tensor holding
    ``within``."""
    return tuple((s - w, n) for s, n, w in zip(rect[0], rect[1], within[0]))


def _narrow(t, spans):
    for d, (s, n) in enumerate(spans):
        t = t.narrow(d, s, n)
    return t


def redistribute_tree(leaves: Sequence[Leaf], parts: Dict[str, Any],
                      old_shape: Dict[str, int], new_shape: Dict[str, int],
                      *, rank: int, device: Any, dtypes: Dict[str, Any],
                      out: Optional[Dict[str, Any]] = None,
                      max_bytes: int = DEFAULT_WAVE_BYTES,
                      donate: bool = False, group: Any = None
                      ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Move the tensor leaves from their old parts to their new ones, a
    collective over ``group`` (default: the world), whose rank ``r`` is
    rank ``r`` of both layouts' worlds.

    ``parts``: this rank's old part of each leaf by name (empty on a rank
    new to the world); ``dtypes``: each leaf's dtype.  ``out``: where to
    write this rank's new parts (tensors of the new parts' shapes), else
    they are allocated.  Returns ``(new_parts, stats)``: this rank's new
    part of each leaf (none on a rank past the new world) and JAX's keys,
    ``bytes_moved``, ``bytes_total``, ``leaves``, ``waves``,
    ``max_wave_bytes`` and ``seconds``."""
    import torch
    import torch.distributed as dist

    t0 = time.monotonic()
    n_old, n_new = _world(old_shape), _world(new_shape)
    out = out if out is not None else {}
    new_parts: Dict[str, Any] = {}
    waves = wave_schedule([x.nbytes for x in leaves], max_bytes=max_bytes)
    for wave in waves:
        for i in wave:
            leaf = leaves[i]
            if not leaf.tensor:
                continue
            mine_old = (_rect(leaf.old, old_shape, rank, leaf.shape)
                        if rank < n_old else None)
            mine_new = (_rect(leaf.new, new_shape, rank, leaf.shape)
                        if rank < n_new else None)
            dst = None
            if mine_new is not None:
                dst = out.get(leaf.name)
                if dst is None:
                    dst = torch.empty(mine_new[1], dtype=dtypes[leaf.name],
                                      device=device)
                new_parts[leaf.name] = dst
            # each rank's need: covered by its own old part?
            local = (mine_new is not None and mine_old is not None
                     and _volume(_overlap(mine_old, mine_new))
                     == math.prod(mine_new[1]))
            needs = [r for r in range(n_new) if r >= n_old or _volume(
                _overlap(_rect(leaf.old, old_shape, r, leaf.shape),
                         _rect(leaf.new, new_shape, r, leaf.shape)))
                < math.prod(_rect(leaf.new, new_shape, r, leaf.shape)[1])]
            if local:
                dst.copy_(_narrow(parts[leaf.name],
                                  _local(mine_new, mine_old)))
            if not needs:
                continue
            # every distinct old part, once, from the first rank holding
            # it; each rank keeps its overlap
            owners: Dict[Tuple, int] = {}
            for r in range(n_old):
                rect = _rect(leaf.old, old_shape, r, leaf.shape)
                owners.setdefault((tuple(rect[0]), tuple(rect[1])), r)
            for (start, length), src in owners.items():
                rect = (list(start), list(length))
                if rank == src:
                    buf = parts[leaf.name].contiguous()
                else:
                    buf = torch.empty(length, dtype=dtypes[leaf.name],
                                      device=device)
                dist.broadcast(buf, src=src, group=group)
                if rank in needs and not local:
                    ov = _overlap(rect, mine_new)
                    if ov is not None:
                        _narrow(dst, _local(ov, mine_new)).copy_(
                            _narrow(buf, _local(ov, rect)))
                del buf
        if str(device).startswith("cuda"):
            torch.cuda.current_stream(device).synchronize()
        if donate:
            for i in wave:
                parts.pop(leaves[i].name, None)
    stats = {
        "bytes_moved": resharding_bytes(leaves, old_shape, new_shape),
        "bytes_total": sum(x.nbytes for x in leaves),
        "leaves": len(leaves),
        "waves": len(waves),
        "max_wave_bytes": int(max_bytes),
        "seconds": time.monotonic() - t0,
    }
    return new_parts, stats
