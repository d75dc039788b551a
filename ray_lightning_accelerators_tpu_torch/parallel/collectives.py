"""The gradient exchange of data parallelism: exact, compressed, sharded.

Port of the JAX package's ``parallel/collectives.py``.  There the
exchange runs inside the compiled step, in ``shard_map`` bodies over the
batch axes; here each rank holds its own local tensors and
``GradExchange`` calls the ``torch.distributed`` collectives of the
ranks' process group itself, counting each call and timing it (CUDA
events on the card, read once by ``times_ms``; the host clock on the
CPU, where gloo returns when the collective is done).

- **Exact mean** (``GradExchange.mean``): one flattened f32 bucket of
  the gradients and the step's scalar metrics, one ``all_reduce``, one
  division by the world size.
- **Compressed exchange** (``grad_compression="int8" | "bf16"``): per
  leaf, block-int8 (one f32 scale per ``block`` elements, ``maxabs /
  127``, round half to even) or bf16 on the wire, in two phases
  (``exchange_leaf``: ``all_to_all`` of the quantized blocks, each rank
  dequantizes and sums the range it owns, re-quantizes it, then
  ``all_gather``), with the quantization error of each rank's send kept
  as an error-feedback residual and added to its next gradient.  Leaves
  below ``min_compress_size`` take the exact mean.
- **FSDP** (params split over the fsdp axis's ranks on one dim each,
  the same slice on every rank of a pure-data axis): the compute view is
  an all-gather of the owned slices over the fsdp group
  (``gather_params``: f32 and exact, or bf16 on the wire under
  compression), and the gradient mean lands in each slice's owner:
  exactly by ``reduce_scatter_mean``, or quantized by
  ``exchange_rs_leaf`` (one ``all_to_all`` into the owner, a residual of
  the owned chunk only), each then summed over the data group in f32.
- **The scan gather** (``gather_mode="scan"``, the compressed-FSDP
  regime over a module's layer stacks): ``build_scan_param_gather``
  gathers only the other sharded leaves up front and gives the model a
  per-layer hook (``current_layer_gather`` inside
  ``layer_gather_scope``) that all-gathers one layer's bf16 slices at
  the top of that layer, its backward reduce-scattering the layer's bf16
  gradient into the owner; ``build_scan_local_grads`` finishes those
  gradients, so only the other leaves ride the quantized exchange.
- **ZeRO-1**: the exact mean as above, each rank updates the dim-0 slice
  of each divisible leaf, and ``gather_zero1`` all-gathers the slices.
- ``wire_bytes_per_step``: the JAX package's analytic bytes on the wire,
  exposed and hidden.
- The model axes' differentiable collectives (Megatron's *f* and *g*,
  ``mean_identity_grad``, ``ppermute``, ``all_to_all``, ``gather_dim``),
  each call counted and timed in ``MODEL_COMMS``; see their section.

Gloo runs every one of these collectives on CUDA tensors too (ranks
sharing a card, where NCCL refuses two ranks).  Division by the world
size and by 127 is by a tensor, so the card divides as the CPU does (a
CUDA tensor divided by a Python scalar is multiplied by its
reciprocal).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as mesh_lib
from ..core.optim import tree_like

COMPRESSION_MODES = (None, "int8", "bf16")

# how the compute view of fsdp-sharded params is assembled: "tree"
# all-gathers the whole tree before the forward; "scan" gathers the
# scanned layer stacks a layer at a time, inside the layer loop
GATHER_MODES = ("tree", "scan")

# one f32 scale per this many int8 elements
DEFAULT_BLOCK = 256

# leaves below this element count take the exact f32 mean
DEFAULT_MIN_COMPRESS_SIZE = 2048

# the dtype of the compressed regime's param all-gather
PARAM_GATHER_DTYPE = torch.bfloat16

_KINDS = ("all_reduce", "reduce_scatter", "all_gather", "all_to_all")


def world_and_rank():
    """(world size, rank) of this process's group; (1, 0) outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    """Gradient-exchange policy for one trainer run."""

    mode: Optional[str] = None          # None | "int8" | "bf16"
    block: int = DEFAULT_BLOCK
    min_compress_size: int = DEFAULT_MIN_COMPRESS_SIZE

    def __post_init__(self):
        if self.mode not in COMPRESSION_MODES:
            raise ValueError(
                f"grad_compression must be one of {COMPRESSION_MODES}, "
                f"got {self.mode!r}")
        if self.block < 1:
            raise ValueError(f"block must be >= 1, got {self.block}")


def validate_mesh_for_compression(mesh: mesh_lib.Mesh) -> None:
    """The compressed exchange replaces the data-parallel mean only: any
    model-parallel axis > 1 is a configuration error."""
    bad = {a: s for a, s in mesh.shape.items()
           if a not in mesh_lib.BATCH_AXES and s > 1}
    if bad:
        raise ValueError(
            f"grad_compression requires a pure data-parallel mesh; "
            f"model-parallel axes {bad} are > 1.  Quantized allreduce "
            f"exchanges replicated-param gradients over {mesh_lib.BATCH_AXES} "
            f"only — drop the compression flag or the model-parallel axes.")


def _numel(shape) -> int:
    return int(np.prod(tuple(shape), dtype=np.int64))


def _is_float(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    return np.issubdtype(np.dtype(dtype), np.floating)


def compressible(leaf: Any, cfg: ExchangeConfig) -> bool:
    """Does this gradient leaf ride the compressed path (a float leaf of
    ``min_compress_size`` elements or more) or the exact mean?"""
    if cfg.mode is None or not hasattr(leaf, "shape"):
        return False
    dtype = getattr(leaf, "dtype", None)
    if dtype is None or not _is_float(dtype):
        return False
    return _numel(leaf.shape) >= cfg.min_compress_size


# --------------------------------------------------------------------- #
# Block quantization                                                     #
# --------------------------------------------------------------------- #
def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true division on every device (a tensor divisor)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def quantize_blocks(v: torch.Tensor, block: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat vector -> (int8 ``[nb, block]``, f32 scales ``[nb]``).
    ``v.numel()`` must be a multiple of ``block`` (pad first).  Scales
    are per-block ``maxabs / 127``; an all-zero block gets scale 1."""
    blocks = v.to(torch.float32).reshape(-1, block)
    maxabs = blocks.abs().amax(dim=1)
    scale = torch.where(maxabs > 0, _div(maxabs, 127.0),
                        torch.ones_like(maxabs))
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_blocks``: flat f32 ``[nb * block]``."""
    return (q.to(torch.float32) * scale[:, None]).reshape(-1)


def _pad_to(v: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    n = v.numel()
    pad = (-n) % multiple
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    return v, n


# --------------------------------------------------------------------- #
# Layouts under compression                                              #
# --------------------------------------------------------------------- #
class TensorShardedParamsError(ValueError):
    """``grad_compression`` composes with replicated and fsdp-sharded
    params only."""


def fsdp_shard_dim(layout: Any) -> Optional[int]:
    """The one param dim split over the ranks, or None (replicated):
    from a plan's per-axis layout, or the exchange's own form (that
    dim)."""
    if layout is None:
        return None
    if isinstance(layout, tuple) and all(
            isinstance(p, tuple) and p[0] in mesh_lib.BATCH_AXES
            for p in layout) and len(layout) == 1:
        return layout[0][1]
    if isinstance(layout, bool) or not isinstance(layout, int):
        raise TensorShardedParamsError(
            f"grad_compression supports replicated or fsdp-sharded params "
            f"only; found the layout {layout!r}")
    return layout


def _fsdp_chunk_elems(shape, dim: int, nf: int,
                      cfg: ExchangeConfig) -> Tuple[int, int]:
    """(chunk, chunk_pad) elements of one owner's flat slice of a leaf
    split on ``dim`` over ``nf`` ranks; int8 pads each chunk to a whole
    number of blocks, so no block spans two owners."""
    if shape[dim] % nf:
        raise TensorShardedParamsError(
            f"param dim {dim} of shape {tuple(shape)} is sharded over "
            f"the fsdp axis but its size {shape[dim]} is not divisible "
            f"by fsdp={nf}; the compressed reduce-scatter needs "
            f"equal-size owner chunks — pad the dim, drop its fsdp "
            f"sharding, or drop grad_compression")
    chunk = _numel(shape) // nf
    if cfg.mode == "int8":
        return chunk, chunk + ((-chunk) % cfg.block)
    return chunk, chunk


def _leaf_regime(leaf: Any, layout: Any, cfg: ExchangeConfig) -> str:
    """``rs`` (sharded + compressible: quantized reduce-scatter into the
    owner), ``allreduce`` (replicated + compressible: the two-phase
    exchange) or ``exact`` (the f32 mean, sliced when sharded)."""
    dim = fsdp_shard_dim(layout)
    if dim is not None and compressible(leaf, cfg):
        return "rs"
    if compressible(leaf, cfg):
        return "allreduce"
    return "exact"


def _zeros(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.float32, device=like.device)


def residual_zeros(params: Any, cfg: ExchangeConfig) -> Any:
    """This rank's error-feedback residuals under plain data parallelism:
    ``[leaf.size]`` f32 per compressible leaf, a ``[1]`` placeholder
    otherwise (one row of the JAX package's ``[n, ...]`` stack)."""
    def one(p):
        return _zeros(_numel(p.shape) if compressible(p, cfg) else 1, p)
    return _map(one, params)


def fsdp_residual_zeros(params: Any, layouts: Any, cfg: ExchangeConfig,
                        nf: int, scanned: Tuple[str, ...] = ()) -> Any:
    """This rank's residuals under compressed FSDP: the owned chunk
    (``chunk_pad``) of each reduce-scattered leaf, the whole leaf for a
    compressible replicated one, ``[1]`` otherwise.  ``params`` are the
    full-shape leaves (or anything with their ``shape`` and ``dtype``).
    ``scanned`` (``gather_mode="scan"``): the leaves of these top-level
    subtrees never ride the quantized exchange (the in-loop gather's
    backward reduce-scatters them exactly), so each gets the ``[1]``
    placeholder."""
    def one(p, layout):
        regime = _leaf_regime(p, layout, cfg)
        if regime == "rs":
            _, chunk_pad = _fsdp_chunk_elems(p.shape, fsdp_shard_dim(layout),
                                             nf, cfg)
            return _zeros(chunk_pad, p)
        return _zeros(_numel(p.shape) if regime == "allreduce" else 1, p)
    if not scanned:
        return _map2(one, params, layouts)
    return {k: (_map(lambda p: _zeros(1, p), sub) if k in scanned
                else _map2(one, sub, layouts[k]))
            for k, sub in params.items()}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _map2(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def _flat(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


# --------------------------------------------------------------------- #
# The exchange between the ranks                                         #
# --------------------------------------------------------------------- #
def _new_api(new: str, old: str):
    return getattr(dist, new, None) or getattr(dist, old)


# the two ways an owned leaf is split over the batch axes: FSDP's slices
# of the params (and their moments), and the batch group's (ZeRO-1's
# slices, the per-rank rows of the residuals)
FSDP_SPLIT, BATCH_SPLIT = "fsdp", "batch"


class Split(NamedTuple):
    """One split over the batch axes: the axis a checkpoint part or a
    norm's group records it under, its group, its ranks and this rank's
    index among them."""
    axis: str
    group: Any
    n: int
    index: int


def split_axis(shape: Dict[str, int], kind: str) -> str:
    """The axis ``kind``'s split is recorded under on a mesh of
    ``shape``: FSDP's is the fsdp axis on a mesh that also has a
    pure-data axis (whose ranks hold the same slice, as the JAX
    package's layout), anything else the batch axes."""
    if (kind == FSDP_SPLIT and shape.get(mesh_lib.DATA_AXIS, 1) > 1
            and shape.get(mesh_lib.FSDP_AXIS, 1) > 1):
        return mesh_lib.FSDP_AXIS
    return mesh_lib.BATCH_GROUP


class GradExchange:
    """The collectives of one rank's fit, counted and timed by kind
    (``all_reduce``, ``reduce_scatter``, ``all_gather``, ``all_to_all``);
    ``all_reduces`` / ``bucket_numel`` count the exact-mean buckets, and
    ``layer_counts`` the scan gather's per-layer ``all_gather`` and
    ``reduce_scatter``.

    The batch group (``group``, ``world`` ranks, this one ``rank``) holds
    other rows.  FSDP splits a leaf over the fsdp axis only
    (``fsdp_group``: ``nf`` ranks, this one ``frank``), so the ranks of a
    pure-data axis (``data_group``, None without one) hold the same slice
    and fold their sums over it; without an fsdp axis (ZeRO-1, a world
    without a mesh) the batch group is the split's.  ``split(kind)``
    gives either split whole."""

    def __init__(self, device: torch.device,
                 mesh: Optional[mesh_lib.RankMesh] = None):
        self.device = torch.device(device)
        if mesh is not None:
            # the batch axes' group: the ranks that hold other rows
            self.world, self.rank = mesh.batch_size, mesh.batch_rank
            self.group = mesh.group("batch")
        else:
            self.world, self.rank = world_and_rank()
            self.group = None
        self._shape = dict(mesh.shape) if mesh is not None else {}
        self.nf, self.frank = self.world, self.rank
        self.fsdp_group, self.data_group = self.group, None
        if mesh is not None and mesh.size(mesh_lib.FSDP_AXIS) > 1:
            self.nf = mesh.size(mesh_lib.FSDP_AXIS)
            self.frank = mesh.coord(mesh_lib.FSDP_AXIS)
            self.fsdp_group = mesh.group(mesh_lib.FSDP_AXIS)
            if mesh.size(mesh_lib.DATA_AXIS) > 1:
                self.data_group = mesh.group(mesh_lib.DATA_AXIS)
        # None outside a process group (or in a batch group of one
        # rank): one rank, whose collectives copy
        self.backend = (dist.get_backend(self.group) if self.world > 1
                        else None)
        self.all_reduces = 0
        self.bucket_numel = 0
        self.compressed_exchanges = 0
        self.counts: Dict[str, int] = {k: 0 for k in _KINDS}
        self._events: Dict[str, list] = {k: [] for k in _KINDS}
        self._ms: Dict[str, List[float]] = {k: [] for k in _KINDS}
        # named stretches of a step (the whole exchange, the compute
        # view's gather), timed as the collectives are
        self._span_events: Dict[str, list] = {}
        self._span_ms: Dict[str, List[float]] = {}
        self.layer_counts: Dict[str, int] = {"all_gather": 0,
                                             "reduce_scatter": 0}

    def split(self, kind: str) -> Split:
        """The split of ``kind`` (``FSDP_SPLIT`` or ``BATCH_SPLIT``)."""
        if kind == FSDP_SPLIT:
            return Split(split_axis(self._shape, kind), self.fsdp_group,
                         self.nf, self.frank)
        return Split(mesh_lib.BATCH_GROUP, self.group, self.world,
                     self.rank)

    @contextlib.contextmanager
    def span(self, name: str):
        """Time the block (the collectives and the arithmetic around
        them) as one stretch named ``name``."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._span_events.setdefault(name, []).append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._span_ms.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)

    # ---- primitives ------------------------------------------------- #
    def _call(self, kind: str, fn, *tensors: torch.Tensor,
              group: Any = None) -> None:
        """Run one collective over ``group`` (the batch group by
        default), timed (a copy in a world of one rank with no group)."""
        cuda = self.device.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        if self.backend is None:
            if kind != "all_reduce":
                tensors[0].copy_(tensors[1].reshape(tensors[0].shape))
        else:
            fn(*tensors, group=self.group if group is None else group)
        if cuda:
            end.record()
            self._events[kind].append((start, end))
        else:
            self._ms[kind].append((time.perf_counter() - t0) * 1e3)
        self.counts[kind] += 1

    def all_reduce(self, t: torch.Tensor, group: Any = None) -> None:
        self._call("all_reduce", dist.all_reduce, t, group=group)

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor,
                   group: Any = None) -> None:
        self._call("all_gather", _new_api("all_gather_single",
                                          "all_gather_into_tensor"),
                   out, inp, group=group)

    def reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor,
                       group: Any = None) -> None:
        self._call("reduce_scatter", _new_api("reduce_scatter_single",
                                              "reduce_scatter_tensor"),
                   out, inp, group=group)

    def all_to_all(self, out: torch.Tensor, inp: torch.Tensor,
                   group: Any = None) -> None:
        self._call("all_to_all", dist.all_to_all_single, out, inp,
                   group=group)

    def layer_all_gather(self, out: torch.Tensor, inp: torch.Tensor,
                         async_op: bool = False):
        """The scan gather's per-layer all-gather over the fsdp group
        (counted in ``layer_counts``); its work handle when
        ``async_op``."""
        self.layer_counts["all_gather"] += 1
        return _new_api("all_gather_single", "all_gather_into_tensor")(
            out, inp, group=self.fsdp_group, async_op=async_op)

    def layer_reduce_scatter(self, out: torch.Tensor,
                             inp: torch.Tensor) -> None:
        """The per-layer gather's backward: a sum over the fsdp group
        into this rank's slice (counted in ``layer_counts``)."""
        self.layer_counts["reduce_scatter"] += 1
        _new_api("reduce_scatter_single", "reduce_scatter_tensor")(
            out, inp, group=self.fsdp_group)

    def fold_data(self, t: torch.Tensor) -> None:
        """Sum ``t`` (f32, in place) over the pure-data axis, where there
        is one: the replicas of an fsdp slice."""
        if self.data_group is not None:
            self.all_reduce(t, group=self.data_group)

    # ---- the exact mean --------------------------------------------- #
    def mean(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor's mean over the ranks, in its own dtype and shape
        (views into the reduced bucket where the dtype is f32)."""
        bucket = torch.cat([t.detach().reshape(-1).to(torch.float32)
                            for t in tensors])
        self.all_reduce(bucket)
        bucket.div_(self.world)
        self.all_reduces += 1
        self.bucket_numel = bucket.numel()
        out, offset = [], 0
        for t in tensors:
            n = t.numel()
            out.append(bucket[offset:offset + n].view(t.shape).to(t.dtype))
            offset += n
        return out

    def reduce_scatter_mean(self, grads: Sequence[Tuple[torch.Tensor, int]]
                            ) -> List[torch.Tensor]:
        """Each ``(grad, dim)``'s f32 mean over the ranks, as this rank's
        slice of ``dim``: one bucketed ``reduce_scatter`` over the fsdp
        group (then the data group's sum)."""
        n = self.nf
        parts = [g.detach().to(torch.float32).movedim(d, 0).reshape(n, -1)
                 for g, d in grads]
        bucket = torch.cat(parts, dim=1)
        out = bucket.new_empty(bucket.shape[1])
        self.reduce_scatter(out, bucket.reshape(-1), group=self.fsdp_group)
        self.fold_data(out)
        out = _div(out, self.world)
        shards, offset = [], 0
        for (g, d), part in zip(grads, parts):
            k = part.shape[1]
            moved = g.movedim(d, 0).shape
            shard = out[offset:offset + k].reshape(
                (moved[0] // n,) + tuple(moved[1:]))
            shards.append(shard.movedim(0, d).contiguous())
            offset += k
        return shards

    # ---- the compute view and ZeRO-1's gather ------------------------ #
    def gather_params(self, shards: Sequence[Tuple[torch.Tensor, int]],
                      wire_dtype: Optional[torch.dtype] = None,
                      kind: str = FSDP_SPLIT) -> List[torch.Tensor]:
        """The whole leaves of ``(slice, dim)`` pairs, in the slices'
        dtype: one bucketed ``all_gather`` per wire dtype (``wire_dtype``
        for float slices when given, e.g. bf16; other slices cross in
        their own dtype), over the group of the ``kind`` split."""
        _, group, n, _ = self.split(kind)
        wires = [wire_dtype if wire_dtype is not None
                 and s.dtype.is_floating_point else s.dtype
                 for s, _ in shards]
        fulls: List[Optional[torch.Tensor]] = [None] * len(shards)
        for wire in dict.fromkeys(wires):
            idx = [i for i, w in enumerate(wires) if w == wire]
            pieces = [shards[i][0].detach().to(wire)
                      .movedim(shards[i][1], 0).reshape(-1) for i in idx]
            flat = torch.cat(pieces)
            out = flat.new_empty(n * flat.numel())
            self.all_gather(out, flat, group=group)
            out = out.view(n, -1)
            offset = 0
            for i, p in zip(idx, pieces):
                s, d = shards[i]
                k = p.numel()
                moved = s.movedim(d, 0).shape
                full = out[:, offset:offset + k].reshape(
                    (n * moved[0],) + tuple(moved[1:]))
                fulls[i] = full.movedim(0, d).to(s.dtype).contiguous()
                offset += k
        return fulls

    def gather_zero1(self, fulls: Sequence[torch.Tensor],
                     owned: Sequence[torch.Tensor]) -> None:
        """ZeRO-1: each full leaf rebuilt in place from every rank's
        updated dim-0 slice (one bucketed ``all_gather``)."""
        flat = torch.cat([o.detach().reshape(-1) for o in owned])
        out = flat.new_empty(self.world * flat.numel())
        self.all_gather(out, flat)
        out = out.view(self.world, -1)
        offset = 0
        with torch.no_grad():
            for p, o in zip(fulls, owned):
                k = o.numel()
                p.copy_(out[:, offset:offset + k].reshape(p.shape))
                offset += k

    def sum_scalar(self, t: torch.Tensor) -> torch.Tensor:
        """A scalar summed over the ranks (the norms over shards)."""
        t = t.detach().reshape(1).to(torch.float32).clone()
        self.all_reduce(t)
        return t[0]

    # ---- the compressed exchange ------------------------------------ #
    def exchange_leaf(self, g: torch.Tensor, r: torch.Tensor,
                      cfg: ExchangeConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One replicated leaf: (local grad, local residual) -> (mean over
        the ranks, new residual).  A leaf below the threshold takes the
        exact mean and keeps its residual."""
        n = self.world
        if not compressible(g, cfg):
            (out,) = self.mean([g])
            return out, r
        self.compressed_exchanges += 1
        shape, dtype = g.shape, g.dtype
        v = g.detach().to(torch.float32).reshape(-1) + r.reshape(-1)
        if cfg.mode == "bf16":
            v_pad, true_n = _pad_to(v, n)
            c = v_pad.to(torch.bfloat16)
            local_dq = c.to(torch.float32)
            peers = torch.empty_like(c)
            self.all_to_all(peers, c)
            own = _div(peers.to(torch.float32).reshape(n, -1).sum(0), n)
            gathered = torch.empty_like(c)
            self.all_gather(gathered, own.to(torch.bfloat16))
            mean = gathered.to(torch.float32)
        else:
            block = cfg.block
            v_pad, true_n = _pad_to(v, n * block)
            q, s = quantize_blocks(v_pad, block)
            local_dq = dequantize_blocks(q, s)
            nb = q.shape[0]
            pq, ps = torch.empty_like(q), torch.empty_like(s)
            self.all_to_all(pq, q)
            self.all_to_all(ps, s)
            own = _div((pq.to(torch.float32).reshape(n, nb // n, block)
                        * ps.reshape(n, nb // n, 1)).sum(0), n)
            q2, s2 = quantize_blocks(own.reshape(-1), block)
            aq, as_ = torch.empty_like(q), torch.empty_like(s)
            self.all_gather(aq, q2)
            self.all_gather(as_, s2)
            mean = dequantize_blocks(aq, as_)
        new_r = (v_pad - local_dq)[:true_n]
        out = mean[:true_n].reshape(shape).to(dtype)
        return out, new_r.reshape(r.shape)

    def exchange_rs_leaf(self, g: torch.Tensor, r: torch.Tensor, dim: int,
                         cfg: ExchangeConfig
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One fsdp-sharded compressible leaf: (local grad, the owned
        chunk's residual) -> (this rank's slice of the mean, new
        residual).  The residual is added to the owned chunk only and the
        quantized chunks go to their owners in one ``all_to_all`` over
        the fsdp group; the owner's f32 sum is then folded over the data
        group."""
        self.compressed_exchanges += 1
        n, nf = self.world, self.nf
        own = self.frank
        shape, dtype = g.shape, g.dtype
        shard_len = shape[dim] // nf
        m = g.detach().to(torch.float32).movedim(dim, 0)
        rest = tuple(m.shape[1:])
        chunk, chunk_pad = _fsdp_chunk_elems(shape, dim, nf, cfg)
        m = m.reshape(nf, chunk)
        m = (torch.nn.functional.pad(m, (0, chunk_pad - chunk))
             if chunk_pad != chunk else m.clone())
        m[own] += r
        own_m = m[own].clone()
        if cfg.mode == "bf16":
            c = m.to(torch.bfloat16)
            own_dq = c[own].to(torch.float32)
            recv = torch.empty_like(c)
            self.all_to_all(recv, c, group=self.fsdp_group)
            summed = recv.to(torch.float32).reshape(nf, chunk_pad).sum(0)
        else:
            bpc = chunk_pad // cfg.block
            q, s = quantize_blocks(m.reshape(-1), cfg.block)
            own_dq = dequantize_blocks(q.reshape(nf, bpc, cfg.block)[own],
                                       s.reshape(nf, bpc)[own])
            pq, ps = torch.empty_like(q), torch.empty_like(s)
            self.all_to_all(pq, q, group=self.fsdp_group)
            self.all_to_all(ps, s, group=self.fsdp_group)
            summed = dequantize_blocks(pq, ps).reshape(nf, chunk_pad).sum(0)
        new_r = own_m - own_dq
        self.fold_data(summed)
        red = _div(summed, n)
        out = red[:chunk].reshape((shard_len,) + rest)
        return out.movedim(0, dim).to(dtype).contiguous(), new_r

    # ---- the record ------------------------------------------------- #
    def times_ms(self, kind: str = "all_reduce") -> List[float]:
        """Each collective's time of ``kind`` (or each stretch's of that
        span name), in call order."""
        pending = [e for ev in (*self._events.values(),
                                *self._span_events.values()) for e in ev]
        if pending:
            for _, end in pending:
                end.synchronize()
            for k, ev in self._events.items():
                self._ms[k] += [s.elapsed_time(e) for s, e in ev]
                self._events[k] = []
            for k, ev in self._span_events.items():
                self._span_ms.setdefault(k, []).extend(
                    s.elapsed_time(e) for s, e in ev)
                self._span_events[k] = []
        if kind in self._ms:
            return list(self._ms[kind])
        return list(self._span_ms.get(kind, []))

    def stats(self) -> dict:
        ms = {k: self.times_ms(k) for k in _KINDS}
        return {"all_reduces": self.all_reduces,
                "bucket_numel": self.bucket_numel,
                "all_reduce_ms": ms["all_reduce"],
                "collectives": dict(self.counts),
                "collective_ms": ms,
                "span_ms": {k: list(v) for k, v in self._span_ms.items()},
                "compressed_exchanges": self.compressed_exchanges,
                "layer_collectives": dict(self.layer_counts)}


def sum_across_ranks(values: List[float], device: torch.device,
                     group: Any = None) -> List[float]:
    """Host floats summed over the ranks of ``group`` (the world by
    default; f64: the evaluation loops' weighted sums, once per pass)."""
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, group=group)
    return t.tolist()


def any_across_ranks(flag: bool, device: torch.device) -> bool:
    """True on every rank when any rank's ``flag`` is True."""
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


# --------------------------------------------------------------------- #
# The model axes' differentiable collectives                            #
# --------------------------------------------------------------------- #
# Inside the forward of a model-parallel step, over one axis's group of a
# ``RankMesh`` (a group of None, one rank, makes each an identity):
# - ``copy_to_model`` (Megatron's *f*): identity forward, all-reduce of
#   the gradient backward -- the input of a column-split product;
# - ``reduce_from_model`` (*g*): all-reduce forward, identity backward --
#   partial sums every rank then uses alike (a row-split product, the
#   vocab-parallel embedding and loss);
# - ``mean_identity_grad``: the mean over a group forward, the gradient
#   passed on scaled by ``scale`` backward (the MoE fractions);
# - ``ppermute``: each rank's tensor to its neighbour along the axis,
#   the gradient back the other way (ring attention);
# - ``all_to_all``: split one dim over the group, gather another (Ulysses);
# - ``gather_dim``: all-gather along a dim, reduce-scatter backward (the
#   MoE's sequence gather);
# - ``gather_whole``: all-gather along a dim, this rank's part of the
#   gradient backward (ViT's layer stack under the pipeline axis, which
#   every stage runs whole);
# and, without gradients, ``all_reduce_value`` (max / min / sum) and
# ``all_gather_dim``.  Each call is counted and timed in ``MODEL_COMMS``
# by its kind, as ``GradExchange`` times its own.

class CommRecord:
    """Counts and times of this process's model-axis collectives by kind
    (CUDA events on the card, read once by ``stats``; the host clock on
    the CPU).  ``ppermute_via`` names how the ring's ppermute ran:
    ``"p2p"`` (send / receive) or ``"all_gather"`` (gloo over CUDA
    tensors, which has no point-to-point path)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.counts: Dict[str, int] = {}
        self._events: Dict[str, list] = {}
        self._ms: Dict[str, List[float]] = {}
        self.ppermute_via: Optional[str] = None

    @contextlib.contextmanager
    def timed(self, kind: str, device: torch.device):
        self.counts[kind] = self.counts.get(kind, 0) + 1
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._events.setdefault(kind, []).append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._ms.setdefault(kind, []).append(
                (time.perf_counter() - t0) * 1e3)

    def stats(self) -> dict:
        for kind, ev in self._events.items():
            for _, end in ev:
                end.synchronize()
            self._ms.setdefault(kind, []).extend(
                s.elapsed_time(e) for s, e in ev)
        self._events = {}
        return {"counts": dict(self.counts),
                "ms": {k: list(v) for k, v in self._ms.items()},
                "ppermute_via": self.ppermute_via}


MODEL_COMMS = CommRecord()


def _group_size(group: Any) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _groups(groups: Any) -> List[Any]:
    """One group or a list of them, without the groups of one rank."""
    if not isinstance(groups, (list, tuple)):
        groups = [groups]
    return [g for g in groups if g is not None]


def _all_reduce(t: torch.Tensor, groups: Any, kind: str,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over each group in turn, on a contiguous copy."""
    out = t.contiguous().clone()
    for g in _groups(groups):
        with MODEL_COMMS.timed(kind, out.device):
            dist.all_reduce(out, op=op, group=g)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.groups, "f_all_reduce"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce(x, groups, "g_all_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanIdentityGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.scale = scale
        out = _all_reduce(x, group, "mean_all_reduce")
        return out / torch.full((), float(_group_size(group)),
                                dtype=out.dtype, device=out.device)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.scale == 1.0 else g * ctx.scale), None, None


def copy_to_model(x: torch.Tensor, groups: Any) -> torch.Tensor:
    """*f*: identity forward, the gradient all-reduced over ``groups``."""
    return x if not _groups(groups) else _CopyToModel.apply(x, groups)


def reduce_from_model(x: torch.Tensor, groups: Any) -> torch.Tensor:
    """*g*: summed over ``groups`` forward, identity backward."""
    return x if not _groups(groups) else _ReduceFromModel.apply(x, groups)


def mean_identity_grad(x: torch.Tensor, group: Any,
                       scale: float = 1.0) -> torch.Tensor:
    """The mean over ``group`` forward; backward, the gradient times
    ``scale`` (1: the gradient of a value every rank uses alike and whose
    per-rank gradients the trainer then averages over the group)."""
    if group is None and scale == 1.0:
        return x
    return _MeanIdentityGrad.apply(x, group, scale)


def all_reduce_value(t: torch.Tensor, group: Any, op: str = "sum"
                     ) -> torch.Tensor:
    """``t`` reduced over ``group`` (``"sum"``, ``"max"``, ``"min"``),
    outside autograd."""
    if group is None:
        return t.detach()
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}
    return _all_reduce(t.detach(), group, f"{op}_all_reduce", op=ops[op])


def _gather_stack(x: torch.Tensor, group: Any, kind: str) -> torch.Tensor:
    """``[n, *x.shape]``: every rank's ``x``, in group-rank order."""
    n = _group_size(group)
    out = x.new_empty(n * x.numel())
    with MODEL_COMMS.timed(kind, x.device):
        _new_api("all_gather_single", "all_gather_into_tensor")(
            out, x.contiguous().reshape(-1), group=group)
    return out.view((n,) + tuple(x.shape))


def all_gather_dim(x: torch.Tensor, dim: int, group: Any,
                   kind: str = "all_gather") -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group-rank order
    (outside autograd)."""
    if group is None:
        return x.detach()
    return torch.cat(list(_gather_stack(x.detach(), group, kind).unbind(0)),
                     dim=dim)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(list(_gather_stack(x, group, "all_gather")
                              .unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        n = _group_size(ctx.group)
        parts = torch.stack(g.chunk(n, dim=ctx.dim)).contiguous()
        out = parts.new_empty(parts[0].numel())
        with MODEL_COMMS.timed("reduce_scatter", g.device):
            _new_api("reduce_scatter_single", "reduce_scatter_tensor")(
                out, parts.reshape(-1), group=ctx.group)
        return out.view(parts.shape[1:]), None, None


def gather_dim(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """All-gather along ``dim`` over ``group``; the backward sums each
    rank's gradient of the whole and hands every rank its own part."""
    return x if group is None else _GatherDim.apply(x, dim, group)


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n = dim, _group_size(group)
        ctx.index = dist.get_rank(group)
        return torch.cat(list(_gather_stack(x, group, "all_gather")
                              .unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.index].contiguous(), \
            None, None


def gather_whole(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """All-gather along ``dim`` over ``group`` for a forward that every
    rank of the group runs whole on the same inputs: each rank's gradient
    of the whole is then the whole gradient, and the backward takes this
    rank's part of it, with no communication (``gather_dim``'s
    reduce-scatter would count it once per rank)."""
    return x if group is None else _GatherWhole.apply(x, dim, group)


def _ppermute_via(group: Any, device: torch.device) -> str:
    """Gloo has no point-to-point path for CUDA tensors (ranks sharing a
    card): there the permutation is an all-gather and a select."""
    if dist.get_backend(group) == "gloo" and device.type == "cuda":
        return "all_gather"
    return "p2p"


def _permute(x: torch.Tensor, group: Any, members: Sequence[int],
             shift: int) -> torch.Tensor:
    """Rank i's ``x`` to rank ``(i + shift) % n`` of the group; returns
    what rank ``(i - shift) % n`` sent."""
    n = len(members)
    i = members.index(dist.get_rank())
    x = x.contiguous()
    via = _ppermute_via(group, x.device)
    MODEL_COMMS.ppermute_via = via
    if via == "all_gather":
        return _gather_stack(x, group, "ppermute")[(i - shift) % n]
    out = torch.empty_like(x)
    with MODEL_COMMS.timed("ppermute", x.device):
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, members[(i + shift) % n], group),
            dist.P2POp(dist.irecv, out, members[(i - shift) % n], group)])
        for r in reqs:
            r.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, members):
        ctx.group, ctx.members = group, members
        return _permute(x, group, members, 1)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, ctx.members, -1), None, None


def ppermute(x: torch.Tensor, group: Any, members: Sequence[int]
             ) -> torch.Tensor:
    """``x`` to the next rank along the axis (``(i + 1) % n``); the
    gradient goes back to the previous one."""
    return x if group is None else _PPermute.apply(x, group, list(members))


def _all_to_all(x: torch.Tensor, group: Any, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = _group_size(group)
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    with MODEL_COMMS.timed("all_to_all", x.device):
        dist.all_to_all_single(recv, send, group=group)
    return torch.cat(list(recv.unbind(0)), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, group: Any, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: ``x`` split in n parts
    along ``split_dim``, part j to rank j, the parts received
    concatenated along ``concat_dim`` in group-rank order."""
    if group is None:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)


# --------------------------------------------------------------------- #
# The scan gather: a layer at a time, inside the layer loop              #
# --------------------------------------------------------------------- #
# The tree gather assembles the whole bf16 compute view before the
# forward, and the whole of it stays live through the backward.  The scan
# gather (the JAX package's ``build_scan_param_gather``) leaves a module's
# declared layer stacks (``scanned_param_subtrees``, the GPT's
# ``params["layers"]``) as this rank's slices; the model applies the hook
# of ``current_layer_gather`` to each layer's slice at the top of that
# layer, which all-gathers the layer's bf16 slices over the fsdp group,
# and the hook's backward reduce-scatters the layer's bf16 gradient into
# its owner: the gradient sum over fsdp comes out of autograd, a layer at
# a time.  XLA overlaps layer k+1's gather with layer k's compute by its
# own scheduling; here the model passes the next layer's slice as
# ``prefetch`` and its gather runs asynchronously while layer k computes.
# Inside a checkpointed (remat) layer the gather is synchronous: the
# recompute re-gathers the layer in the backward, in the same order on
# every rank, and no prefetch crosses a checkpoint region.

# the hooks of the train step being run (None outside it: eval, predict,
# decode, the engine and the pipeline paths see plain params)
_LAYER_GATHER_HOOKS: contextvars.ContextVar = contextvars.ContextVar(
    "rla_layer_gather_hooks", default=None)


@contextlib.contextmanager
def layer_gather_scope(hooks: Dict[str, Any]):
    token = _LAYER_GATHER_HOOKS.set(hooks)
    try:
        yield
    finally:
        _LAYER_GATHER_HOOKS.reset(token)


def current_layer_gather(key: str):
    """The per-layer gather hook of one scanned subtree (None outside a
    scan-gather train step)."""
    hooks = _LAYER_GATHER_HOOKS.get()
    return None if hooks is None else hooks.get(key)


def _split_scanned(tree: Dict[str, Any], scanned: Tuple[str, ...]):
    """(scanned subtrees, rest) of a top-level dict param tree."""
    sc = {k: v for k, v in tree.items() if k in scanned}
    rest = {k: v for k, v in tree.items() if k not in scanned}
    return sc, rest


def validate_scan_gather(param_shardings: Any,
                         scanned: Tuple[str, ...]) -> None:
    """Typed refusal of layouts the per-layer gather cannot handle: a
    scanned (stacked) leaf split on dim 0, the layer dim itself (each
    rank would hold some of the layers, not a slice of each)."""
    if not isinstance(param_shardings, dict):
        raise TensorShardedParamsError(
            "gather_mode='scan' needs a dict param tree with the scanned "
            f"stacks as top-level keys; got {type(param_shardings).__name__}")
    missing = [k for k in scanned if k not in param_shardings]
    if missing:
        raise TensorShardedParamsError(
            f"gather_mode='scan': scanned subtree keys {missing} are not "
            f"top-level param keys {sorted(param_shardings)}")
    for k in scanned:
        for s in _flat(param_shardings[k]):
            if fsdp_shard_dim(s) == 0:
                raise TensorShardedParamsError(
                    f"gather_mode='scan': a leaf of scanned subtree {k!r} "
                    f"is fsdp-sharded on dim 0 (the stacked layer dim); "
                    f"the layer scan needs every device to hold ALL "
                    f"layers of its shard — shard a non-layer dim or use "
                    f"gather_mode='tree'")


def _wire(dtype: torch.dtype) -> torch.dtype:
    return PARAM_GATHER_DTYPE if dtype.is_floating_point else dtype


class LayerGather:
    """``hooks[key]`` of ``build_scan_param_gather``: called on one
    layer's slice of a scanned subtree (a tree of this rank's slices),
    returns the layer whole.  Each split leaf (``dims``: its dim within
    the layer, None for a replicated one) crosses as bf16 in one bucketed
    ``all_gather`` over the fsdp group and comes back in its own dtype;
    the backward reduce-scatters the layer's bf16 gradient (a sum) into
    the owner.  ``prefetch``: the next layer's slice, whose gather starts
    now (asynchronously) and is taken up by the next call."""

    def __init__(self, exchange: "GradExchange", dims: Sequence[Any]):
        self.exchange = exchange
        self.idx = [i for i, d in enumerate(dims) if d is not None]
        self.dims = [dims[i] for i in self.idx]
        self._pending = None

    def __call__(self, layer_slice: Any, prefetch: Any = None) -> Any:
        flat = _flat(layer_slice)
        if not self.idx:
            return layer_slice
        owned = [flat[i] for i in self.idx]
        pending, self._pending = self._pending, None
        if pending is not None and pending[0] is not owned[0]:
            self._finish(pending[1])    # a prefetch nobody took up
            pending = None
        fulls = _LayerGatherFn.apply(
            self, None if pending is None else pending[1], *owned)
        if prefetch is not None:
            nxt = [_flat(prefetch)[i] for i in self.idx]
            self._pending = (nxt[0], self._start(nxt, async_op=True))
        out = list(flat)
        for i, f in zip(self.idx, fulls):
            out[i] = f
        return tree_like(layer_slice, out)

    def _buckets(self, dtypes: Sequence[torch.dtype]) -> List[List[int]]:
        wires = [_wire(d) for d in dtypes]
        return [[j for j, w in enumerate(wires) if w == wire]
                for wire in dict.fromkeys(wires)]

    @staticmethod
    def _moved(shape: Sequence[int], d: int) -> List[int]:
        """``shape`` with dim ``d`` moved to the front."""
        moved = list(shape)
        moved.insert(0, moved.pop(d))
        return moved

    def _start(self, owned: Sequence[torch.Tensor], async_op: bool):
        """The bucketed all-gathers of the owned slices: per wire dtype
        (positions, input, output, work)."""
        ex, nf = self.exchange, self.exchange.nf
        out = []
        for pos in self._buckets([o.dtype for o in owned]):
            n = sum(owned[j].numel() for j in pos)
            flat = owned[pos[0]].new_empty(n, dtype=_wire(owned[pos[0]].dtype))
            full = flat.new_empty(nf * n)
            offset = 0
            for j in pos:
                o = owned[j].detach().movedim(self.dims[j], 0)
                flat[offset:offset + o.numel()].view(o.shape).copy_(o)
                offset += o.numel()
            work = ex.layer_all_gather(full, flat, async_op=async_op)
            out.append((pos, flat, full, work))
        return out

    def _finish(self, started) -> None:
        for _, _, _, work in started:
            if work is not None:
                work.wait()

    def _unpack(self, started, meta) -> List[torch.Tensor]:
        """The whole leaves, in their dtypes, from the gathers of slices
        of ``meta`` (dtype, shape)."""
        nf = self.exchange.nf
        self._finish(started)
        fulls: List[Optional[torch.Tensor]] = [None] * len(meta)
        for pos, _, full, _ in started:
            full = full.view(nf, -1)
            offset = 0
            for j in pos:
                dtype, shape = meta[j]
                d = self.dims[j]
                moved = self._moved(shape, d)
                k = _numel(moved)
                whole = list(shape)
                whole[d] *= nf
                fulls[j] = torch.empty(whole, dtype=dtype, device=full.device)
                fulls[j].movedim(d, 0).view([nf] + moved).copy_(
                    full[:, offset:offset + k].view([nf] + moved))
                offset += k
        return fulls

    def _scatter(self, grads, meta) -> List[Optional[torch.Tensor]]:
        """Each whole leaf's gradient summed over the fsdp group into this
        rank's slice (``meta``: the slices' dtype and shape), bf16 on the
        wire: one bucketed reduce-scatter."""
        ex, nf = self.exchange, self.exchange.nf
        out: List[Optional[torch.Tensor]] = [None] * len(meta)
        for pos in self._buckets([d for d, _ in meta]):
            pos = [j for j in pos if meta[j][0].is_floating_point]
            if not pos:
                continue
            n = sum(_numel(meta[j][1]) for j in pos)
            bucket = grads[pos[0]].new_empty(
                (nf, n), dtype=_wire(meta[pos[0]][0]))
            red = bucket.new_empty(n)
            offset = 0
            for j in pos:
                moved = self._moved(meta[j][1], self.dims[j])
                k = _numel(moved)
                bucket[:, offset:offset + k].view([nf] + moved).copy_(
                    grads[j].movedim(self.dims[j], 0).reshape([nf] + moved))
                offset += k
            ex.layer_reduce_scatter(red, bucket.reshape(-1))
            offset = 0
            for j in pos:
                dtype, shape = meta[j]
                moved = self._moved(shape, self.dims[j])
                k = _numel(moved)
                out[j] = torch.empty(shape, dtype=dtype, device=red.device)
                out[j].movedim(self.dims[j], 0).copy_(
                    red[offset:offset + k].view(moved))
                offset += k
        return out


class _LayerGatherFn(torch.autograd.Function):
    """One layer's gather (``LayerGather``): the owned slices in, the
    whole leaves out; ``started``, a prefetched gather to take up."""

    @staticmethod
    def forward(ctx, hook, started, *owned):
        ctx.hook = hook
        ctx.meta = [(o.dtype, tuple(o.shape)) for o in owned]
        if started is None:
            started = hook._start(owned, async_op=False)
        return tuple(hook._unpack(started, ctx.meta))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(ctx.hook._scatter(grads, ctx.meta))


def build_scan_param_gather(exchange: "GradExchange", layouts: Any,
                            scanned: Tuple[str, ...]):
    """The scan-mode compute view (JAX ``build_scan_param_gather``):
    ``(prelude, hooks)`` over the fsdp group of ``exchange`` (a
    ``GradExchange`` of the rank mesh, which counts the hooks' calls in
    ``layer_counts``).

    ``prelude(params)`` bf16-all-gathers only the sharded leaves outside
    the scanned subtrees, as the tree gather does (each a new leaf that
    requires grad), and passes the scanned subtrees through as they are,
    this rank's slices.  ``hooks[key]`` is the ``LayerGather`` of one
    layer of subtree ``key``: its leaves' split dims less the stacked
    layer dim."""
    validate_scan_gather(layouts, scanned)
    sc_l, rest_l = _split_scanned(layouts, scanned)
    rest_dims = [fsdp_shard_dim(x) for x in _flat(rest_l)]

    def prelude(params: Dict[str, Any]) -> Dict[str, Any]:
        sc, rest = _split_scanned(params, scanned)
        flat = _flat(rest)
        idx = [i for i, d in enumerate(rest_dims) if d is not None]
        out = list(flat)
        if idx:
            with exchange.span("param_gather"):
                fulls = exchange.gather_params(
                    [(flat[i].detach(), rest_dims[i]) for i in idx],
                    wire_dtype=PARAM_GATHER_DTYPE)
            for i, f in zip(idx, fulls):
                out[i] = f.requires_grad_(True)
        view = tree_like(rest, out) if rest else {}
        view.update(sc)
        return view

    hooks = {}
    for key in scanned:
        dims = [fsdp_shard_dim(x) for x in _flat(sc_l[key])]
        hooks[key] = LayerGather(exchange, [None if d is None else d - 1
                                            for d in dims])
    return prelude, hooks


def build_scan_local_grads(exchange: "GradExchange", layouts: Any,
                           scanned: Tuple[str, ...]):
    """The scan step's finish of this rank's gradients (JAX
    ``build_scan_local_grads``), ``finish(grads) -> grads`` over the
    leaves in ``_flat`` order, each leaf by its kind (``finish.kinds``):

    - ``scan_rs`` (a split leaf of a scanned subtree): the hook's
      backward already summed it over the fsdp group into this rank's
      slice; the data group's replicas are folded in f32 and the sum
      divided by the batch world: the mean, in the param's layout;
    - ``scan_repl`` (a replicated leaf of a scanned subtree, the stacked
      norm scales): the exact f32 mean over the batch group;
    - ``rest``: returned as it is, for the quantized exchange."""
    kinds = tuple(("scan_rs" if fsdp_shard_dim(x) is not None
                   else "scan_repl") if k in scanned else "rest"
                  for k in sorted(layouts) for x in _flat(layouts[k]))

    def bucket(grads, idx, reduce):
        flat = torch.cat([grads[i].detach().to(torch.float32).reshape(-1)
                          for i in idx])
        reduce(flat)
        flat = _div(flat, exchange.world)
        out, offset = [], 0
        for i in idx:
            k = grads[i].numel()
            out.append(flat[offset:offset + k].view(grads[i].shape))
            offset += k
        return out

    def finish(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        out = list(grads)
        rs = [i for i, k in enumerate(kinds) if k == "scan_rs"]
        repl = [i for i, k in enumerate(kinds) if k == "scan_repl"]
        if rs:
            for i, g in zip(rs, bucket(grads, rs, exchange.fold_data)):
                out[i] = g.to(grads[i].dtype)
        if repl:
            for i, g in zip(repl, bucket(grads, repl, exchange.all_reduce)):
                out[i] = g
        return out

    finish.kinds = kinds
    return finish


# --------------------------------------------------------------------- #
# Wire accounting                                                        #
# --------------------------------------------------------------------- #
def wire_bytes_per_step(params: Any, n: int, cfg: ExchangeConfig,
                        param_shardings: Any = None,
                        gather_mode: str = "tree",
                        scanned: Tuple[str, ...] = (),
                        mesh: Optional[mesh_lib.Mesh] = None
                        ) -> Dict[str, Any]:
    """Analytic bytes on the wire a device moves for one gradient
    exchange (the JAX package's report, key for key).  A ring all-reduce
    in f32 moves ``2 (N-1)/N * 4`` bytes an element; the two-phase
    compressed exchange ``2 (N-1)/N`` of its payload (int8: 1 byte an
    element plus ``4 / block``; bf16: 2); sub-threshold leaves pay the
    f32 rate.  ``param_shardings`` (a layout tree) puts a sharded leaf in
    the FSDP regime: a quantized reduce-scatter of its gradient over the
    fsdp axis (``(nf-1)/nf`` of the payload), an f32 all-reduce of the
    1/nf reduced slice over the pure-data axis, and a bf16 all-gather of
    the updated param.  The layouts carry no mesh: ``nf`` is ``mesh``'s
    fsdp axis (all ``n`` ranks without one).

    ``gather_mode="scan"`` with ``scanned``: the leaves of the scanned
    subtrees move a layer at a time inside the layer loop (a bf16
    all-gather forward, the bf16 reduce-scatter of its backward), priced
    as ``hidden_bytes_per_step``; their data-axis all-reduce runs after
    the backward and stays exposed, as everything else does
    (``exposed_bytes_per_step``; the two sum to
    ``exchange_bytes_per_step``)."""
    if gather_mode not in GATHER_MODES:
        raise ValueError(f"gather_mode must be one of {GATHER_MODES}, "
                         f"got {gather_mode!r}")
    factor = 0.0 if n <= 1 else 2.0 * (n - 1) / n
    flat = _flat(params)
    in_scan = [False] * len(flat)
    if gather_mode == "scan" and scanned and isinstance(params, dict):
        in_scan = [k in scanned for k in sorted(params)
                   for _ in _flat(params[k])]
    sharded = param_shardings is not None
    if sharded:
        flat_sh = _flat(param_shardings)
        nf = (mesh_lib.mesh_axis_size(mesh, mesh_lib.FSDP_AXIS)
              if mesh is not None else n)
        nd = max(1, n // max(nf, 1))
    else:
        flat_sh = [None] * len(flat)
        nf = nd = 1
    rs_factor = 0.0 if nf <= 1 else (nf - 1) / nf
    data_factor = 0.0 if nd <= 1 else 2.0 * (nd - 1) / nd
    base_total = comp_base = 0.0
    exch_total = comp_exch = 0.0
    rs_bytes = ag_bytes = hidden = 0.0
    n_comp = n_fp32 = n_rs = 0
    for leaf, sh, sc in zip(flat, flat_sh, in_scan):
        size = _numel(leaf.shape)
        fp32 = factor * 4.0 * size
        base_total += fp32
        regime = ("allreduce" if not sharded
                  else _leaf_regime(leaf, sh, cfg))
        if regime == "rs" and sc:
            # exact bf16 both ways, inside the layer loop; the data
            # axis's f32 all-reduce of the 1/nf slice after the backward
            n_rs += 1
            data_psum = data_factor * 4.0 * (size / nf)
            rs = rs_factor * 2.0 * size + data_psum
            ag = rs_factor * 2.0 * size
            rs_bytes += rs
            ag_bytes += ag
            exch_total += rs + ag
            hidden += rs + ag - data_psum
            comp_base += fp32
            comp_exch += rs + ag
        elif regime == "rs":
            n_rs += 1
            _, chunk_pad = _fsdp_chunk_elems(leaf.shape, fsdp_shard_dim(sh),
                                             nf, cfg)
            payload = (chunk_pad * nf * 2.0 if cfg.mode == "bf16" else
                       chunk_pad * nf * 1.0 + (chunk_pad * nf //
                                               cfg.block) * 4.0)
            rs = rs_factor * payload + data_factor * 4.0 * (size / nf)
            ag = rs_factor * 2.0 * size
            rs_bytes += rs
            ag_bytes += ag
            exch_total += rs + ag
            comp_base += fp32
            comp_exch += rs + ag
        elif regime == "allreduce" and compressible(leaf, cfg):
            n_comp += 1
            if cfg.mode == "int8":
                padded = size + ((-size) % (max(n, 1) * cfg.block))
                payload = padded * 1.0 + (padded // cfg.block) * 4.0
            else:
                payload = size * 2.0
            b = factor * payload
            exch_total += b
            comp_base += fp32
            comp_exch += b
        else:
            n_fp32 += 1
            exch_total += fp32
    ratio = base_total / exch_total if exch_total else 1.0
    comp_ratio = comp_base / comp_exch if comp_exch else 1.0
    report = {
        "mode": cfg.mode, "block": cfg.block, "devices": n,
        "regime": ("reduce_scatter_all_gather" if n_rs
                   else "allreduce"),
        "gather_mode": gather_mode if n_rs else None,
        "baseline_fp32_bytes_per_step": int(base_total),
        "exchange_bytes_per_step": int(exch_total),
        # from the two truncated fields, so exposed + hidden == exchange
        "exposed_bytes_per_step": int(exch_total) - int(hidden),
        "hidden_bytes_per_step": int(hidden),
        "compression_ratio": round(ratio, 3),
        "compressed_ratio": round(comp_ratio, 3),
        "compressed_leaves": n_comp + n_rs, "fp32_leaves": n_fp32,
    }
    if n_rs:
        report.update({
            "fsdp": nf, "reduce_scattered_leaves": n_rs,
            "grad_reduce_scatter_bytes_per_step": int(rs_bytes),
            "param_allgather_bytes_per_step": int(ag_bytes),
        })
    return report
