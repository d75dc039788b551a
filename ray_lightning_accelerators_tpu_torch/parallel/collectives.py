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
- **FSDP** (params split over the ranks on one dim each): the compute
  view is an all-gather of the owned slices (``gather_params``: f32 and
  exact, or bf16 on the wire under compression), and the gradient mean
  lands in each slice's owner: exactly by ``reduce_scatter_mean``, or
  quantized by ``exchange_rs_leaf`` (one ``all_to_all`` into the owner,
  a residual of the owned chunk only).
- **ZeRO-1**: the exact mean as above, each rank updates the dim-0 slice
  of each divisible leaf, and ``gather_zero1`` all-gathers the slices.
- ``wire_bytes_per_step``: the JAX package's analytic bytes on the wire.
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
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as mesh_lib

COMPRESSION_MODES = (None, "int8", "bf16")

# how the compute view of fsdp-sharded params is assembled: "tree"
# all-gathers the whole tree before the forward; "scan" (per layer,
# inside the layer loop) is refused as a later slice of the port
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
                        nf: int) -> Any:
    """This rank's residuals under compressed FSDP: the owned chunk
    (``chunk_pad``) of each reduce-scattered leaf, the whole leaf for a
    compressible replicated one, ``[1]`` otherwise.  ``params`` are the
    full-shape leaves (or anything with their ``shape`` and ``dtype``)."""
    def one(p, layout):
        regime = _leaf_regime(p, layout, cfg)
        if regime == "rs":
            _, chunk_pad = _fsdp_chunk_elems(p.shape, fsdp_shard_dim(layout),
                                             nf, cfg)
            return _zeros(chunk_pad, p)
        return _zeros(_numel(p.shape) if regime == "allreduce" else 1, p)
    return _map2(one, params, layouts)


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


class GradExchange:
    """The collectives of one rank's fit, counted and timed by kind
    (``all_reduce``, ``reduce_scatter``, ``all_gather``, ``all_to_all``);
    ``all_reduces`` / ``bucket_numel`` count the exact-mean buckets."""

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
    def _call(self, kind: str, fn, *tensors: torch.Tensor) -> None:
        """Run one collective, timed (a copy in a world of one rank with
        no group)."""
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
            fn(*tensors, group=self.group)
        if cuda:
            end.record()
            self._events[kind].append((start, end))
        else:
            self._ms[kind].append((time.perf_counter() - t0) * 1e3)
        self.counts[kind] += 1

    def all_reduce(self, t: torch.Tensor) -> None:
        self._call("all_reduce", dist.all_reduce, t)

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor) -> None:
        self._call("all_gather", _new_api("all_gather_single",
                                          "all_gather_into_tensor"),
                   out, inp)

    def reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor) -> None:
        self._call("reduce_scatter", _new_api("reduce_scatter_single",
                                              "reduce_scatter_tensor"),
                   out, inp)

    def all_to_all(self, out: torch.Tensor, inp: torch.Tensor) -> None:
        self._call("all_to_all", dist.all_to_all_single, out, inp)

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
        slice of ``dim``: one bucketed ``reduce_scatter``."""
        n = self.world
        parts = [g.detach().to(torch.float32).movedim(d, 0).reshape(n, -1)
                 for g, d in grads]
        bucket = torch.cat(parts, dim=1)
        out = bucket.new_empty(bucket.shape[1])
        self.reduce_scatter(out, bucket.reshape(-1))
        out = _div(out, n)
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
                      wire_dtype: Optional[torch.dtype] = None
                      ) -> List[torch.Tensor]:
        """The whole leaves of ``(slice, dim)`` pairs, in the slices'
        dtype: one bucketed ``all_gather`` per wire dtype (``wire_dtype``
        for float slices when given, e.g. bf16; other slices cross in
        their own dtype)."""
        n = self.world
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
            self.all_gather(out, flat)
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
        quantized chunks go to their owners in one ``all_to_all``."""
        self.compressed_exchanges += 1
        n = nf = self.world
        own = self.rank
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
            self.all_to_all(recv, c)
            summed = recv.to(torch.float32).reshape(nf, chunk_pad).sum(0)
        else:
            bpc = chunk_pad // cfg.block
            q, s = quantize_blocks(m.reshape(-1), cfg.block)
            own_dq = dequantize_blocks(q.reshape(nf, bpc, cfg.block)[own],
                                       s.reshape(nf, bpc)[own])
            pq, ps = torch.empty_like(q), torch.empty_like(s)
            self.all_to_all(pq, q)
            self.all_to_all(ps, s)
            summed = dequantize_blocks(pq, ps).reshape(nf, chunk_pad).sum(0)
        new_r = own_m - own_dq
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
                "compressed_exchanges": self.compressed_exchanges}


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
# Wire accounting                                                        #
# --------------------------------------------------------------------- #
def wire_bytes_per_step(params: Any, n: int, cfg: ExchangeConfig,
                        param_shardings: Any = None) -> Dict[str, Any]:
    """Analytic bytes on the wire a device moves for one gradient
    exchange (the JAX package's report, key for key, for its tree
    gather).  A ring all-reduce in f32 moves ``2 (N-1)/N * 4`` bytes an
    element; the two-phase compressed exchange ``2 (N-1)/N`` of its
    payload (int8: 1 byte an element plus ``4 / block``; bf16: 2);
    sub-threshold leaves pay the f32 rate.  ``param_shardings`` (a
    layout tree) puts a sharded leaf in the FSDP regime: a quantized
    reduce-scatter of its gradient over the ranks and a bf16 all-gather
    of the updated param."""
    factor = 0.0 if n <= 1 else 2.0 * (n - 1) / n
    flat = _flat(params)
    sharded = param_shardings is not None
    flat_sh = _flat(param_shardings) if sharded else [None] * len(flat)
    # every rank is on the fsdp axis in this slice (no pure-data axis)
    nf = n if sharded else 1
    rs_factor = 0.0 if nf <= 1 else (nf - 1) / nf
    base_total = comp_base = 0.0
    exch_total = comp_exch = 0.0
    rs_bytes = ag_bytes = 0.0
    n_comp = n_fp32 = n_rs = 0
    for leaf, sh in zip(flat, flat_sh):
        size = _numel(leaf.shape)
        fp32 = factor * 4.0 * size
        base_total += fp32
        regime = ("allreduce" if not sharded
                  else _leaf_regime(leaf, sh, cfg))
        if regime == "rs":
            n_rs += 1
            _, chunk_pad = _fsdp_chunk_elems(leaf.shape, fsdp_shard_dim(sh),
                                             nf, cfg)
            payload = (chunk_pad * nf * 2.0 if cfg.mode == "bf16" else
                       chunk_pad * nf * 1.0 + (chunk_pad * nf //
                                               cfg.block) * 4.0)
            rs = rs_factor * payload
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
        "gather_mode": "tree" if n_rs else None,
        "baseline_fp32_bytes_per_step": int(base_total),
        "exchange_bytes_per_step": int(exch_total),
        "exposed_bytes_per_step": int(exch_total),
        "hidden_bytes_per_step": 0,
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
