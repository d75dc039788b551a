"""GPT decoder LM: training, generation and serving.

Port of the JAX package's ``models/transformer.py``.  Training: ``forward``
(the layer loop, dropout from a ``torch.Generator``), ``_lm_loss`` with the
streaming fused LM-head loss (``ops/losses.py``) or the materialised
logits, ``training_step`` / ``validation_step`` / ``predict_step`` and
``configure_optimizers`` (AdamW, weight decay 0.01).  Inference:
``TransformerConfig``, parameter init, the three rope functions,
weight-only int8 quantization with the kernel-aware decode projections;
the whole-prompt forward ``_block`` / ``_prefill`` (with the
sliding-window rolling cache); the dense KV-cache decode
(``_decode_attn_block`` in its ring, linear-chunk and per-row modes,
``_decode_chunk``, ``_decode_token``, ``decode_cache_alloc``,
``cache_join``, ``decode_step_rows``); ``generate`` (greedy, temperature,
top-k, top-p, repetition penalty) and ``generate_beam``; and the
block-paged decode (``paged_cache_alloc`` / ``_paged_attn_block`` /
``decode_step_rows_paged`` / ``decode_chunk_paged``, and the KV
handoff's ``paged_blocks_gather`` / ``paged_blocks_scatter``).

Parameters are plain dicts of tensors with the JAX leaf names and einsum
layouts: ``embed [V,d]``; ``layers.attn.wq/wk/wv [L,d,h,hd]``,
``wo [L,h,hd,d]``; ``layers.mlp.wi [L,d,f]``, ``wo [L,f,d]`` (with
``num_experts > 1`` the mixture-of-experts subtree ``router [L,d,E]``,
``wi [L,E,d,f]``, ``wo [L,E,f,d]``, ``ops/moe.py``); ``ln1``,
``ln2`` ``[L,d]``; ``ln_f [d]``.  Quantized leaves are
``{"q8": int8, "scale": f32}`` dicts of the same shapes.  Weights are
cast to ``compute_dtype`` where they are used, as in the JAX package.

The RMSNorms go through the CUDA kernel of ``ops/norms.py``, every
whole-prompt attention through the flash-attention kernel of
``ops/attention.py``, and every q8 projection of a decode step through
``ops/quant.py``'s kernels.  As in the JAX package, the prefill
dequantizes q8 leaves and multiplies densely, and the cached attention's
einsums and the bf16-weight projections are plain PyTorch (plain XLA
there).  Decode caches are written in place where the JAX package
returns updated copies; an out-of-range cache write raises instead of
clamping.

In training the parameters are f32 leaf tensors with ``requires_grad``;
``_wt`` casts them to the compute dtype where they are used, so the
gradients land on the f32 masters, and RMSNorm and flash attention run
their kernels forward and backward (``ops/``).  ``cfg.remat`` checkpoints
each layer (``torch.utils.checkpoint``, the policies of ``_remat_policy``),
and ``int8_matmul`` (set by ``Trainer(int8_matmul=True)``) runs the dense
MLP's two products through the int8 kernel of ``ops/quant.py`` with
straight-through gradients (``_Int8SteMatmul``).

Over the model axes (``GPT(mesh=)``, or the ``RankMesh`` the trainer
hands a rank as ``module.mesh``) the training forward computes the JAX
package's function on this rank's parameter slices (``parallel/``):
- tensor: Megatron's column / row splits -- the normalised input of each
  projection passes *f* (its gradient all-reduced over the tensor
  group), q / k / v and the MLP's ``wi`` hold this rank's heads and
  ``d_ff`` columns, and the partial outputs of attention ``wo`` and the
  MLP ``wo`` are summed by *g*; the embedding is vocab-parallel (the
  out-of-range ids masked, the local rows gathered, *g*), and the loss
  is ``ops.losses.vocab_parallel_cross_entropy`` on vocab-split logits;
- sequence: the rank takes its contiguous chunk of every row, RoPE
  positions are global, attention is ring or Ulysses
  (``cfg.context_parallel``), the next-token targets cross the chunk
  boundaries (every rank loaded the whole row) and the loss is the mean
  over all ``B (L-1)`` targets, its sum and count summed over the
  sequence group;
- expert: ``ops.moe.moe_mlp(mesh=)``;
- pipeline: the rank's ``L / S`` layers are one stage of
  ``parallel.pipeline.pipeline_apply`` (GPipe, ``cfg.pipeline_microbatches``
  microbatches); every stage computes the loss from the broadcast
  output, the final norm and the head taking their gradient on the last
  stage only, so the trainer's sum over the stages gives each shared
  leaf its one gradient.  MoE layers and dropout are refused there, as
  in the JAX package.
Under ``int8_matmul`` with a tensor axis the MLP's ``wo`` (its
contraction split) quantizes with the whole weight's scales: the column
maxima are taken over the tensor group.
As in the JAX package the streaming loss runs only without a tensor,
sequence or pipeline axis (``_use_fused_loss``), and generation decodes
replicated: the decode paths ignore the mesh and take whole
parameters.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ..core.module import DeviceLike, TorchModule
from ..core.optim import AdamW
from ..ops import quant
from ..ops.attention import flash_attention
from ..ops.losses import (fused_linear_cross_entropy,
                          vocab_parallel_cross_entropy)
from ..ops.moe import init_moe_params, moe_logical_axes, moe_mlp
from ..ops.norms import rms_norm
from ..parallel import collectives as coll
from ..parallel import mesh as mesh_lib
from ..parallel import pipeline as pipeline_lib
from ..parallel.ring_attention import ring_attention, seq_chunk
from ..parallel.ulysses import ulysses_attention


@dataclasses.dataclass
class TransformerConfig:
    """Field-for-field the JAX package's config, so a config serialized
    there (``dataclasses.asdict``) rebuilds here."""

    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    d_ff: int = 2048
    n_layers: int = 8
    max_seq_len: int = 2048
    dropout: float = 0.0
    causal: bool = True
    remat: bool = False
    remat_policy: str = "nothing"
    pipeline_microbatches: int = 4
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    num_experts: int = 1
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    fused_loss: bool = True
    loss_chunk_rows: int = 1024
    label_smoothing: float = 0.0
    z_loss: float = 0.0
    context_parallel: str = "ring"
    n_kv_heads: Optional[int] = None
    sliding_window: Optional[int] = None
    flash_block_q: Optional[int] = None
    flash_block_k: Optional[int] = None

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        kv = self.n_kv_heads if self.n_kv_heads is not None else self.n_heads
        assert self.n_heads % kv == 0, \
            f"n_heads ({self.n_heads}) must be divisible by n_kv_heads ({kv})"
        return kv


def _rope_freqs(d: int, theta: float, device) -> torch.Tensor:
    return theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                   device=device) / d)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    """Rotate INTERLEAVED even/odd pairs (x[..., 0::2], x[..., 1::2]), as
    the JAX package does; a bf16 x times the f32 angles computes in f32
    and is cast back at the end."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.stack([rx1, rx2], dim=-1).reshape(x.shape).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Rotary embeddings.  x: [b, h, s, d], positions: [s]."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[:, None].float() * freqs[None, :]          # [s,d/2]
    return _rotate(x, torch.cos(angles), torch.sin(angles))


def _rope_rows(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embeddings with per-row positions.  x: [b, h, 1, d],
    positions: [b] (the continuous-batching decode step)."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[:, None].float() * freqs[None, :]          # [b,d/2]
    return _rotate(x, torch.cos(angles)[:, None, None, :],
                   torch.sin(angles)[:, None, None, :])


def _rope_grid(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embeddings with a per-row, per-query position grid.
    x: [b, h, n, d], positions: [b, n] (the paged decode paths).  The
    three rope functions do the same arithmetic element for element, so a
    query at position p gets the same rotation on every path."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs[None, None, :]  # [b,n,d/2]
    return _rotate(x, torch.cos(angles)[:, None, :, :],
                   torch.sin(angles)[:, None, :, :])


def _div127(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127`` rounded once, on every device: a CUDA tensor divided
    by a Python scalar is multiplied by the scalar's reciprocal instead,
    which can move the scale by an ulp and an int8 weight by one step."""
    return amax / torch.full_like(amax, 127.0)


def _channel_quant(w: torch.Tensor, group: Any = None):
    """Per-out-channel symmetric int8 of a [K, N] weight: (q8 int8, scale
    [N] f32, dq [K, N] f32), the scale convention of
    ``GPT.quantize_weights`` and ``ops.quant.int8_matmul``.  ``group``:
    the ranks that hold the other rows of K (a contraction the tensor
    axis splits, the MLP's ``wo``): the column maxima are their maxima
    over the group, so every rank quantizes with the whole weight's
    scales, as the JAX package's GSPMD takes the max across the split."""
    wf = w.float()
    amax = coll.all_reduce_value(torch.amax(torch.abs(wf), dim=0), group,
                                 "max")
    scale = torch.where(amax > 0, _div127(amax), torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127)
    return q.to(torch.int8), scale, q * scale[None, :]


class _Int8SteMatmul(torch.autograd.Function):
    """Training-forward ``x2d [M, K] @ int8(w [K, N])`` with
    straight-through gradients (the JAX package's ``_int8_ste_matmul``).

    The forward quantizes the f32 master per output channel and launches
    K5 (``ops.quant.int8_matmul``; its plain version on the CPU) at any
    M.  The JAX package routes rows above its kernel's 1024 through the
    int8-rounded XLA product instead, the same values.  The backward is
    the straight-through estimator in plain f32 products, as there:
    ``gx = g @ dq^T``, ``gw = x^T @ g``, with ``dq`` kept in w's dtype
    (the round is a zero-gradient staircase; without the estimator the
    weights would never train).  ``group`` (a row-split ``w``, K over
    the tensor axis): the scales are the whole weight's
    (``_channel_quant``), K5 runs on this rank's rows, and the caller's
    *g* sums the partial products."""

    @staticmethod
    def forward(ctx, x2d: torch.Tensor, w: torch.Tensor,
                group: Any = None) -> torch.Tensor:
        q8, scale, dq = _channel_quant(w.detach(), group)
        ctx.save_for_backward(x2d, dq.to(w.dtype))
        return quant.int8_matmul(x2d, q8, scale).to(x2d.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x2d, dq = ctx.saved_tensors
        gx = (g.float() @ dq.float().T).to(x2d.dtype)
        gw = x2d.float().T @ g.float()
        return gx, gw.to(dq.dtype), None


def _dots_policy(batched: bool):
    """A selective-checkpoint policy that keeps the matrix products'
    outputs and recomputes everything else.  ``torch.einsum`` issues a
    product without batch dims as a ``bmm`` over a batch of 1, so the
    no-batch-dims policy keeps ``mm``, ``addmm`` and such ``bmm``s and
    recomputes the batched ones (MoE's dispatch, expert and combine
    products).  The port's kernels launch through ctypes, unseen by the
    policy; only the ``torch.empty`` of their outputs is an op here, and
    recomputing it makes the recompute launch the kernel again (K2 runs
    twice a layer under these policies)."""
    aten = torch.ops.aten
    unbatched = (aten.mm.default, aten.addmm.default)

    def policy(ctx, op, *args, **kwargs):
        if op in unbatched or (op == aten.bmm.default and (
                batched or args[0].shape[0] == 1)):
            return ckpt.CheckpointPolicy.MUST_SAVE
        return ckpt.CheckpointPolicy.MUST_RECOMPUTE

    return functools.partial(ckpt.create_selective_checkpoint_contexts,
                             policy)


def _remat_policy(name: str):
    """Map ``remat_policy`` to how a layer runs: ``None`` (no
    recomputation: ``everything``), or the ``context_fn`` of a
    non-reentrant checkpoint (``nothing``: a plain checkpoint; ``dots``
    and ``dots_with_no_batch_dims``: ``_dots_policy``)."""
    policies = {"nothing": ckpt.noop_context_fn,
                "dots": _dots_policy(batched=True),
                "dots_with_no_batch_dims": _dots_policy(batched=False),
                "everything": None}
    if name not in policies:
        raise ValueError(f"unknown remat_policy {name!r}; choose from "
                         f"{sorted(policies)}")
    return policies[name]


Params = Dict[str, Any]


class GPT(TorchModule):
    """Decoder-only LM.  Batch format: ``dict(input_ids=[B,S])`` or a bare
    ``[B,S]`` array; loss = next-token cross entropy.  ``device`` None =
    the CUDA device; ``compute_dtype`` as in the JAX package (float32 by
    default; the trainer sets it from its precision, the serve deployment
    uses bfloat16).  ``lr``: a float or a schedule ``step -> lr``
    (``utils.schedules``), also exposed as ``lr_schedule``."""

    # the layer stack runs as one stage of ``pipeline_apply`` per rank
    runs_pipeline_schedule = True

    def __init__(self, config: Union[TransformerConfig, dict, None] = None,
                 device: DeviceLike = None,
                 compute_dtype: torch.dtype = torch.float32,
                 mesh: Any = None,
                 lr: Union[float, Callable[[int], float], str] = 3e-4,
                 **cfg_overrides):
        super().__init__(device=device, compute_dtype=compute_dtype)
        if config is None:
            config = TransformerConfig(**cfg_overrides)
        elif isinstance(config, dict):
            # load_from_checkpoint rebuilds from the asdict()'d config
            config = TransformerConfig(**config)
        self.cfg = config
        # a RankMesh (parallel/mesh.py) for the model axes' training
        # forward; None or a mesh of size-1 axes runs on whole params
        self.mesh = mesh
        self.lr = self.coerce_checkpoint_lr(lr, 3e-4, "GPT")
        if callable(self.lr):
            self.lr_schedule = self.lr
        # a schedule is not serializable: record its repr
        self.save_hyperparameters(
            config=dataclasses.asdict(config),
            lr=repr(self.lr) if callable(self.lr) else self.lr)

    # ------------------------------------------------------------------ #
    # Parameters                                                         #
    # ------------------------------------------------------------------ #
    def init_params(self, seed: int = 0) -> Params:
        """Random f32 weights in the JAX init's shapes and scales, drawn
        from a ``torch.Generator`` seeded with ``seed`` on the model's
        device.  The numbers differ from ``jax.random``'s for the same
        seed: parity tests carry JAX weights over with
        ``utils.weights.params_from_jax`` instead."""
        cfg = self.cfg
        d, h, hd, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
        kv, L = cfg.kv_heads, cfg.n_layers
        dev = self.device
        g = torch.Generator(device=dev).manual_seed(int(seed))

        def dense(shape, fan_in):
            return (torch.randn(shape, generator=g, device=dev,
                                dtype=torch.float32) * (fan_in ** -0.5))

        if cfg.num_experts > 1:
            per_layer = [init_moe_params(g, d, f, cfg.num_experts)
                         for _ in range(L)]
            mlp = {k: torch.stack([p[k] for p in per_layer])
                   for k in per_layer[0]}
        else:
            mlp = {"wi": dense((L, d, f), d), "wo": dense((L, f, d), f)}
        params = {
            "embed": dense((cfg.vocab_size, d), d) * d ** 0.5 * 0.02,
            "layers": {
                "attn": {
                    "wq": dense((L, d, h, hd), d),
                    "wk": dense((L, d, kv, hd), d),
                    "wv": dense((L, d, kv, hd), d),
                    "wo": dense((L, h, hd, d), d),
                },
                "mlp": mlp,
                "ln1": torch.ones((L, d), device=dev),
                "ln2": torch.ones((L, d), device=dev),
            },
            "ln_f": torch.ones((d,), device=dev),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = dense((d, cfg.vocab_size), d)
        return params

    def scanned_param_subtrees(self) -> Tuple[str, ...]:
        """The layer stack, as the JAX GPT declares it: the key the
        overlap-aware FSDP gather (``Trainer(gather_mode="scan")``) would
        keep fsdp-sharded and gather a layer at a time."""
        return ("layers",)

    def param_logical_axes(self) -> Dict[str, Any]:
        """Logical axis names per leaf (the JAX package's), from which the
        accelerator lays the params out (``parallel/sharding.py``: the
        ``embed`` dim, d_model, over the fsdp axis; heads, ``d_ff`` and
        the vocabulary over the tensor axis; the experts over the expert
        axis)."""
        if self.cfg.num_experts > 1:
            mlp_axes = {name: ("layers",) + ax
                        for name, ax in moe_logical_axes().items()}
        else:
            mlp_axes = {
                "wi": ("layers", "embed", "mlp"),
                "wo": ("layers", "mlp", "embed"),
            }
        axes = {
            "embed": ("vocab", "embed"),
            "layers": {
                "attn": {
                    "wq": ("layers", "embed", "heads", "kv"),
                    "wk": ("layers", "embed", "heads", "kv"),
                    "wv": ("layers", "embed", "heads", "kv"),
                    "wo": ("layers", "heads", "kv", "embed"),
                },
                "mlp": mlp_axes,
                "ln1": ("layers", None),
                "ln2": ("layers", None),
            },
            "ln_f": (None,),
        }
        if not self.cfg.tie_embeddings:
            axes["unembed"] = ("embed", "vocab")
        return axes

    # ------------------------------------------------------------------ #
    # Weight-only int8 quantization (inference)                          #
    # ------------------------------------------------------------------ #
    @staticmethod
    def quantize_weights(params: Params) -> Params:
        """A params tree where matmul weights become
        ``{"q8": int8, "scale": f32}`` with per-out-channel symmetric
        scales -- bit-identical to the JAX package's ``quantize_weights``.

        Leaves under ``layers`` are layer-stacked ``[L, ...]``: their
        scales keep the layer axis and reduce over axes ``1..ndim-2``
        (``wq``'s scale is ``[L,1,1,hd]``), and only ndim >= 3 leaves
        quantize (the ``[L,d]`` norm scales stay dense).  Top-level
        embed/unembed quantize at ndim >= 2 (the tied embedding's scale
        is ``[1,d]``, along the contraction dim of the unembedding)."""
        def quant_leaf(arr: torch.Tensor, keep_first: bool):
            min_ndim = 3 if keep_first else 2
            if arr.ndim < min_ndim or not arr.is_floating_point():
                return arr
            axes = tuple(range(1 if keep_first else 0, arr.ndim - 1))
            af = arr.float()
            amax = torch.amax(torch.abs(af), dim=axes, keepdim=True)
            scale = torch.where(amax > 0, _div127(amax),
                                torch.ones_like(amax))
            q = torch.clamp(torch.round(af / scale), -127, 127
                            ).to(torch.int8)
            return {"q8": q, "scale": scale.float()}

        def tree_map(node):
            if isinstance(node, dict):
                return {k: tree_map(v) for k, v in node.items()}
            return quant_leaf(node, True)

        out = dict(params)
        out["layers"] = tree_map(params["layers"])
        out["embed"] = quant_leaf(params["embed"], False)
        if "unembed" in params:
            out["unembed"] = quant_leaf(params["unembed"], False)
        return out

    @staticmethod
    def _is_q8(w) -> bool:
        return isinstance(w, dict) and "q8" in w

    def _wt(self, w, dt: torch.dtype) -> torch.Tensor:
        """Weight fetch: dequantize an int8 leaf or cast a dense one."""
        if self._is_q8(w):
            return (w["q8"].float() * w["scale"]).to(dt)
        return w.to(dt)

    # ------------------------------------------------------------------ #
    # Layers                                                             #
    # ------------------------------------------------------------------ #
    @staticmethod
    def unstack_layers(params: Params) -> Params:
        """The same params with ``layers`` split into a list of per-layer
        dicts (views, no copy).  The decode functions accept either form;
        the serve engine unstacks once so a step does not re-slice every
        leaf of every layer."""
        layers = params["layers"]
        if isinstance(layers, list):
            return params
        n = _leading_dim(layers)

        def split(node) -> list:
            # unbind: one backward node stacks every layer's gradient
            if isinstance(node, dict):
                parts = {k: split(v) for k, v in node.items()}
                return [{k: p[i] for k, p in parts.items()}
                        for i in range(n)]
            return list(torch.unbind(node, 0))

        return {**params, "layers": split(layers)}

    def _layer_list(self, params: Params) -> List[Params]:
        return self.unstack_layers(params)["layers"]

    def _embed_lookup(self, params: Params, tokens: torch.Tensor,
                      mesh: Any = None) -> torch.Tensor:
        """Token ids -> embedding rows [*, d].  Rows are gathered before
        the cast: casting the whole [V, d] table to take a handful of rows
        would stream it every step, and a cast commutes with a gather.
        Over a tensor axis the table holds this rank's vocabulary slice:
        ids outside it are masked, the local rows gathered and the ranks'
        rows summed (*g*) -- the rows of the JAX package's one-hot
        product."""
        dt = self.compute_dtype
        w = params["embed"]
        q8 = self._is_q8(w)
        tp = _group(mesh, mesh_lib.TENSOR_AXIS)
        if tp is not None:
            vl = (w["q8"] if q8 else w).shape[0]
            local = tokens - mesh.coord(mesh_lib.TENSOR_AXIS) * vl
            mine = (local >= 0) & (local < vl)
            tokens = torch.where(mine, local, 0)
        if q8:
            # gather the int8 rows first, dequantize only those
            rows = (w["q8"][tokens].float() * w["scale"].reshape(-1)).to(dt)
        else:
            rows = w[tokens].to(dt)
        if tp is not None:
            rows = coll.reduce_from_model(
                torch.where(mine[..., None], rows, 0.0).to(dt), tp)
        return rows

    def _rms_norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        # CUDA kernel on the card, plain version on the CPU (ops/norms.py)
        return rms_norm(x, scale)

    # -- int8 kernel dispatch (decode matmuls) ------------------------- #
    def _q8_mm(self, rows: torch.Tensor, q8_2d: torch.Tensor,
               scale_vec: Optional[torch.Tensor],
               dt: torch.dtype) -> torch.Tensor:
        """``rows [M,K] @ q8_2d [K,N]`` with per-out-column ``scale_vec``,
        or (``scale_vec=None``) ``rows [M,K] @ q8_2d[N,K]^T`` scale-free.
        Rows are cast to the compute dtype; the kernels return that dtype.
        Every shape goes to the kernel: there is no declined-shape path."""
        rows = rows.to(dt).contiguous()
        if scale_vec is None:
            return quant.int8_matmul_nt(rows, q8_2d)
        return quant.int8_matmul(rows, q8_2d, scale_vec)

    def _qkv_proj_decode(self, x, w, dt):
        """[b,n,d] @ w[d,h,k] -> [b,h,n,k], q8-kernel aware."""
        if self._is_q8(w):
            q8 = w["q8"]
            d, hh, kk = q8.shape
            b, n, _ = x.shape
            sv = w["scale"].expand(1, hh, kk).reshape(-1)
            out = self._q8_mm(x.reshape(b * n, d), q8.reshape(d, hh * kk),
                              sv, dt)
            return out.reshape(b, n, hh, kk).transpose(1, 2)
        return torch.einsum("bsd,dhk->bhsk", x, self._wt(w, dt))

    def _attn_out_proj_decode(self, attn, w, dt):
        """[b,h,n,k] @ w[h,k,d] -> [b,n,d], q8-kernel aware."""
        if self._is_q8(w):
            q8 = w["q8"]
            hh, kk, d = q8.shape
            b, _, n, _ = attn.shape
            rows = attn.transpose(1, 2).reshape(b * n, hh * kk)
            out = self._q8_mm(rows, q8.reshape(hh * kk, d),
                              w["scale"].reshape(-1), dt)
            return out.reshape(b, n, d)
        return torch.einsum("bhsk,hkd->bsd", attn, self._wt(w, dt))

    def _mlp_proj_decode(self, x, w, dt):
        """[b,n,din] @ w[din,dout] -> [b,n,dout], q8-kernel aware."""
        if self._is_q8(w):
            q8 = w["q8"]
            b, n, _ = x.shape
            out = self._q8_mm(x.reshape(b * n, q8.shape[0]), q8,
                              w["scale"].reshape(-1), dt)
            return out.reshape(b, n, q8.shape[1])
        return torch.einsum("bsd,df->bsf", x, self._wt(w, dt))

    def _unembed_matmul(self, h2: torch.Tensor, params: Params,
                        dt: torch.dtype) -> torch.Tensor:
        """[M,d] @ unembed [d,V] -> [M,V] f32, q8-kernel aware.

        Tied embeddings store q8 as [V,d] with scales along d (the
        contraction dim), so the scales fold into the activation and the
        transposed-weight kernel runs scale-free."""
        if self.cfg.tie_embeddings and self._is_q8(params["embed"]):
            sv = params["embed"]["scale"].reshape(-1)       # [d]
            xs = h2.float() * sv
            return self._q8_mm(xs, params["embed"]["q8"], None, dt).float()
        if not self.cfg.tie_embeddings and self._is_q8(params.get("unembed")):
            return self._q8_mm(h2, params["unembed"]["q8"],
                               params["unembed"]["scale"].reshape(-1),
                               dt).float()
        return (h2.to(dt) @ self._unembed_w(params, dt)).float()

    def _unembed_w(self, params: Params, dt: torch.dtype) -> torch.Tensor:
        """Dequant-aware unembedding matrix [d, V]."""
        if self.cfg.tie_embeddings:
            return self._wt(params["embed"], dt).T
        return self._wt(params["unembed"], dt)

    def _dequant_q8_leaves(self, tree: Any, dt: torch.dtype) -> Any:
        """Dequantize only the int8 leaves of a subtree; dense leaves pass
        through untouched."""
        if self._is_q8(tree):
            return self._wt(tree, dt)
        if isinstance(tree, dict):
            return {k: self._dequant_q8_leaves(v, dt)
                    for k, v in tree.items()}
        return tree

    # ------------------------------------------------------------------ #
    # Whole-prompt forward (prefill)                                     #
    # ------------------------------------------------------------------ #
    def _sequence_attention(self, q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mesh: Any) -> torch.Tensor:
        """Attention over a sequence axis: ring or Ulysses
        (``cfg.context_parallel``) on this rank's chunk."""
        if self.cfg.sliding_window is not None:
            raise NotImplementedError(
                "sliding_window with a sharded sequence axis is not "
                "supported; use ring/ulysses full attention or an "
                "unsharded sequence")
        if self.cfg.context_parallel == "ulysses":
            return ulysses_attention(q, k, v, mesh, causal=self.cfg.causal,
                                     block_k=self.cfg.flash_block_k)
        return ring_attention(q, k, v, mesh, causal=self.cfg.causal)

    def _attention(self, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
        # the CUDA flash-attention kernel on the card, its plain version
        # on the CPU (ops/attention.py)
        return flash_attention(q, k, v, self.cfg.causal,
                               block_q=self.cfg.flash_block_q,
                               block_k=self.cfg.flash_block_k,
                               window=self.cfg.sliding_window)

    def _dropout(self, x: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
        p = self.cfg.dropout
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < 1.0 - p
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)

    def _mlp_train_matmul(self, x: torch.Tensor, w: Any,
                          dt: torch.dtype, split_k: Any = None
                          ) -> torch.Tensor:
        """The dense MLP's ``[b,s,din] @ w[din,dout]``.  With
        ``int8_matmul`` (the Trainer flag) and a floating weight, the
        forward runs the int8 kernel K5 with straight-through gradients
        to the f32 master (``_Int8SteMatmul``; ``split_k``: the group
        that splits ``din``, whose ranks share the scales); otherwise a
        plain einsum."""
        if (not self.int8_matmul or self._is_q8(w)
                or not w.is_floating_point()):
            return torch.einsum("bsd,df->bsf", x, self._wt(w, dt))
        b, s, din = x.shape
        out = _Int8SteMatmul.apply(x.reshape(b * s, din).to(dt), w, split_k)
        return out.reshape(b, s, w.shape[1])

    def _mlp(self, x: torch.Tensor, mlp: Params, dt: torch.dtype,
             train: bool, mesh: Any = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The feed-forward half of a layer: ``(y, aux)``.  With
        ``num_experts > 1`` the mixture-of-experts MLP over the chunk
        (q8 leaves dequantized to ``dt`` first; the router then widens to
        f32 inside ``moe_mlp``, as in the JAX package); otherwise the
        dense GELU MLP (``train``: through ``_mlp_train_matmul``, else
        through the decode projections, q8-kernel aware) and aux 0.  Over
        a tensor axis ``wi`` / ``wo`` hold this rank's ``d_ff`` slice:
        *f* before, *g* after."""
        cfg = self.cfg
        if cfg.num_experts > 1:
            return moe_mlp(x, self._dequant_q8_leaves(mlp, dt),
                           top_k=cfg.moe_top_k,
                           capacity_factor=cfg.moe_capacity_factor,
                           compute_dtype=dt, mesh=mesh)
        aux = torch.zeros((), device=x.device)
        tp = _group(mesh, mesh_lib.TENSOR_AXIS)
        if train:
            m = self._dequant_q8_leaves(mlp, dt)
            proj = self._mlp_train_matmul
            # wo's contraction (d_ff) is split over the tensor axis
            proj_out = functools.partial(proj, split_k=tp)
        else:
            m, proj = mlp, self._mlp_proj_decode
            proj_out = proj
        # jax.nn.gelu defaults to the tanh approximation
        up = F.gelu(proj(coll.copy_to_model(x, tp), m["wi"], dt),
                    approximate="tanh")
        return coll.reduce_from_model(proj_out(up, m["wo"], dt), tp), aux

    def _block(self, h: torch.Tensor, layer_params: Params,
               positions: torch.Tensor, return_kv: bool = False,
               dropout_rng: Optional[torch.Generator] = None,
               mesh: Any = None):
        """One layer over whole sequences.  h: [b, s, d]; positions: [s].
        q8 leaves are dequantized and multiplied densely, as in the JAX
        package's ``_block``.  ``dropout_rng`` (train mode, dropout > 0)
        drops the attention and MLP branches.  Returns (h, aux), or (h,
        aux, k, v) with k/v [b, kv_heads, s, head_dim] as the cache stores
        them; aux is the layer's MoE load-balance loss (0 when dense).
        ``mesh``: the model axes of the training forward (this rank's
        heads, its chunk of the sequence)."""
        cfg = self.cfg
        dt = self.compute_dtype
        a = layer_params["attn"]
        tp = _group(mesh, mesh_lib.TENSOR_AXIS)
        x = coll.copy_to_model(self._rms_norm(h, layer_params["ln1"]), tp)
        q = torch.einsum("bsd,dhk->bhsk", x, self._wt(a["wq"], dt))
        k = torch.einsum("bsd,dhk->bhsk", x, self._wt(a["wk"], dt))
        v = torch.einsum("bsd,dhk->bhsk", x, self._wt(a["wv"], dt))
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        groups = cfg.n_heads // cfg.kv_heads
        if groups > 1:  # GQA: each kv head serves its group of query heads
            kr = k.repeat_interleave(groups, dim=1)
            vr = v.repeat_interleave(groups, dim=1)
        else:
            kr, vr = k, v
        if mesh_lib.mesh_axis_size(mesh, mesh_lib.SEQUENCE_AXIS) > 1:
            attn = self._sequence_attention(q, kr, vr, mesh)
        else:
            attn = self._attention(q, kr, vr)
        attn_out = coll.reduce_from_model(
            torch.einsum("bhsk,hkd->bsd", attn, self._wt(a["wo"], dt)), tp)
        drop = dropout_rng is not None and cfg.dropout > 0
        if drop:
            attn_out = self._dropout(attn_out, dropout_rng)
        h = h + attn_out
        x = self._rms_norm(h, layer_params["ln2"])
        y, aux = self._mlp(x, layer_params["mlp"], dt, train=True,
                           mesh=mesh)
        if drop:
            y = self._dropout(y, dropout_rng)
        h = h + y
        if return_kv:
            return h, aux, k, v
        return h, aux

    def _layer(self, h: torch.Tensor, layer_params: Params,
               positions: torch.Tensor,
               dropout_rng: Optional[torch.Generator], mesh: Any = None):
        """``_block`` for the training forward: (h, aux).  Under
        ``cfg.remat`` the layer runs in a non-reentrant checkpoint with
        ``_remat_policy``'s context, so its activations are recomputed in
        the backward.  Dropout draws from an explicit generator, which
        the checkpoint's RNG stash does not cover: the layer draws from a
        copy made from the generator's state before the layer, the
        recompute from another copy of that state, so both see the same
        masks, and the generator then moves on as if the layer had drawn
        from it directly."""
        context_fn = (_remat_policy(self.cfg.remat_policy)
                      if self.cfg.remat else None)
        if context_fn is None:      # no remat, or "everything" saved
            return self._block(h, layer_params, positions,
                               dropout_rng=dropout_rng, mesh=mesh)
        before = None if dropout_rng is None else dropout_rng.get_state()
        drawn = []

        def run(h_in):
            g = None
            if before is not None:
                g = torch.Generator(device=dropout_rng.device)
                g.set_state(before)
                drawn.append(g)
            return self._block(h_in, layer_params, positions, dropout_rng=g,
                               mesh=mesh)

        out = ckpt.checkpoint(run, h, use_reentrant=False,
                              context_fn=context_fn)
        if drawn:
            dropout_rng.set_state(drawn[0].get_state())
        return out

    def _prefill(self, params: Params, tokens: Any, cache_len: int,
                 last_index: Any = None):
        """Run the prompt once; returns (last-position hidden [B, d],
        cache dict with k/v [L, B, kv_heads, cache_len, head_dim]).

        ``cache_len < prompt_len`` (the sliding-window rolling cache)
        keeps only the last ``cache_len`` positions, each at its ring slot
        ``p % cache_len``.  ``last_index`` ([B] or a scalar): return the
        hidden state at that position instead of the final one (the serve
        engine right-pads prompts into buckets; pad positions write k/v
        past the prompt, which decode rewrites before any mask exposes
        them)."""
        cfg = self.cfg
        dev = self.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        b, s0 = tokens.shape
        layers = self._layer_list(params)
        h = self._embed_lookup(params, tokens)
        pos = torch.arange(s0, device=dev)
        shape = (len(layers), b, cfg.kv_heads, cache_len, cfg.head_dim)
        cache = {"k": torch.zeros(shape, dtype=self.compute_dtype,
                                  device=dev),
                 "v": torch.zeros(shape, dtype=self.compute_dtype,
                                  device=dev)}
        slots = (torch.arange(s0 - cache_len, s0, device=dev) % cache_len
                 if s0 > cache_len else None)
        for i, lp in enumerate(layers):
            h, _, k, v = self._block(h, lp, pos, return_kv=True)
            for name, kv in (("k", k), ("v", v)):
                if slots is None:
                    cache[name][i, :, :, :s0] = kv
                else:
                    cache[name][i][:, :, slots] = kv[:, :, -cache_len:]
        h = self._rms_norm(h, params["ln_f"])
        if last_index is None:
            return h[:, -1], cache
        idx = torch.as_tensor(last_index, device=dev).long()
        return h[torch.arange(b, device=dev), idx], cache

    # ------------------------------------------------------------------ #
    # Training forward and steps                                         #
    # ------------------------------------------------------------------ #
    @staticmethod
    def _tokens(batch: Any) -> Any:
        tokens = batch["input_ids"] if isinstance(batch, dict) else batch
        if isinstance(tokens, (tuple, list)):
            tokens = tokens[0]
        return tokens

    def forward(self, params: Params, batch: Any, return_aux: bool = False,
                return_hidden: bool = False,
                dropout_rng: Optional[torch.Generator] = None):
        """Whole-sequence forward.  Returns f32 logits [B, S, V] (with
        ``return_aux``: (logits, aux)), or (hidden [B, S, d], aux) with
        ``return_hidden``; aux is the sum over layers of the MoE
        load-balance loss (0 for a dense model).  ``dropout_rng``: this
        step's generator, enabling dropout (train mode); None makes the
        forward deterministic."""
        if dropout_rng is not None and self.cfg.dropout <= 0:
            dropout_rng = None
        dt = self.compute_dtype
        mesh = self.mesh
        tokens = torch.as_tensor(self._tokens(batch),
                                 device=self.device).long()
        pos = torch.arange(tokens.shape[1], device=self.device)
        if mesh_lib.mesh_axis_size(mesh, mesh_lib.SEQUENCE_AXIS) > 1:
            # this rank's chunk of every row, at its global positions
            tokens, pos = seq_chunk(tokens, mesh, 1), seq_chunk(pos, mesh, 0)
        h = self._embed_lookup(params, tokens, mesh)
        aux = torch.zeros((), device=self.device)
        stages = mesh_lib.mesh_axis_size(mesh, mesh_lib.PIPELINE_AXIS)
        if stages > 1:
            h = self._pipelined_layers(params, h, pos, dropout_rng, mesh)
            if (mesh.coord(mesh_lib.PIPELINE_AXIS) != stages - 1
                    and torch.is_grad_enabled()):
                # every stage computes the loss from the broadcast output;
                # the final norm and the head take their gradient on the
                # last stage only, and the trainer sums the stages' parts
                # of each leaf the stages share
                params = {k: (_detach(v) if k in ("ln_f", "embed",
                                                  "unembed") else v)
                          for k, v in params.items()}
        else:
            for lp in self._layer_list(params):
                h, layer_aux = self._layer(h, lp, pos, dropout_rng, mesh)
                aux = aux + layer_aux
        h = self._rms_norm(h, params["ln_f"])
        if return_hidden:
            return h, aux
        h = coll.copy_to_model(h, _group(mesh, mesh_lib.TENSOR_AXIS))
        logits = torch.einsum("bsd,dv->bsv", h,
                              self._unembed_w(params, dt)).float()
        return (logits, aux) if return_aux else logits

    def _pipelined_layers(self, params: Params, h: torch.Tensor,
                          pos: torch.Tensor,
                          dropout_rng: Optional[torch.Generator],
                          mesh: Any) -> torch.Tensor:
        """The layer stack over the pipeline axis (the JAX GPT's
        ``pipeline_apply`` branch): this rank's ``L / S`` layers are one
        stage of ``parallel.pipeline.pipeline_apply`` with
        ``cfg.pipeline_microbatches`` microbatches, each layer through
        ``_layer`` (so remat applies inside the stage).  MoE layers and
        dropout are refused with the JAX package's texts."""
        cfg = self.cfg
        if cfg.num_experts > 1:
            raise NotImplementedError(pipeline_lib.MOE_REFUSAL)
        if dropout_rng is not None:
            raise NotImplementedError(pipeline_lib.DROPOUT_REFUSAL)
        pipeline_lib.check_layers(
            cfg.n_layers, mesh_lib.mesh_axis_size(mesh,
                                                  mesh_lib.PIPELINE_AXIS))

        def stage(layers: List[Params], h_mb: torch.Tensor) -> torch.Tensor:
            for lp in layers:
                h_mb, _ = self._layer(h_mb, lp, pos, None, mesh)
            return h_mb

        return pipeline_lib.pipeline_apply(stage, self._layer_list(params),
                                           h, mesh, cfg.pipeline_microbatches)

    def _use_fused_loss(self) -> bool:
        """The streaming LM-head loss: the config decides, and, as in the
        JAX package, a sequence, tensor or pipeline axis > 1 takes the
        materialised (vocab-parallel) logits instead."""
        if not self.cfg.fused_loss:
            return False
        return all(mesh_lib.mesh_axis_size(self.mesh, ax) == 1
                   for ax in (mesh_lib.SEQUENCE_AXIS, mesh_lib.TENSOR_AXIS,
                              mesh_lib.PIPELINE_AXIS))

    def _lm_loss(self, params: Params, batch: Any,
                 rng: Optional[torch.Generator] = None):
        """(mean next-token loss, accuracy, aux) over the batch."""
        cfg = self.cfg
        tokens = torch.as_tensor(self._tokens(batch),
                                 device=self.device).long()
        if self._use_fused_loss():
            h, aux = self.forward(params, tokens, return_hidden=True,
                                  dropout_rng=rng)
            rows = h[:, :-1].reshape(-1, h.shape[-1])
            targets = tokens[:, 1:].reshape(-1)
            loss, acc = fused_linear_cross_entropy(
                rows, self._unembed_w(params, self.compute_dtype), targets,
                cfg.loss_chunk_rows, mesh=self.mesh,
                label_smoothing=cfg.label_smoothing, z_loss=cfg.z_loss)
            return loss, acc, aux
        logits, aux = self.forward(params, tokens, return_aux=True,
                                   dropout_rng=rng)
        if any(mesh_lib.mesh_axis_size(self.mesh, a) > 1 for a in (
                mesh_lib.SEQUENCE_AXIS, mesh_lib.TENSOR_AXIS)):
            return self._vocab_parallel_loss(logits, tokens) + (aux,)
        logits, targets = logits[:, :-1], tokens[:, 1:]
        eps, zl = cfg.label_smoothing, cfg.z_loss
        lse = torch.logsumexp(logits, dim=-1)
        tgt_logit = logits.gather(-1, targets[..., None])[..., 0]
        loss = lse - (1.0 - eps) * tgt_logit
        if eps:
            loss = loss - (eps / logits.shape[-1]) * logits.sum(-1)
        if zl:
            loss = loss + zl * lse * lse
        acc = (logits.argmax(-1) == targets).float().mean()
        return loss.mean(), acc, aux

    def _vocab_parallel_loss(self, logits: torch.Tensor,
                             tokens: torch.Tensor):
        """(mean loss, accuracy) of this rank's logits ``[B, L/S, V/T]``
        (its chunk of the sequence, its slice of the vocabulary) against
        the next tokens of the whole rows: the last global position has
        no target, and the sums and counts are summed over the sequence
        group, so every rank holds the mean over all ``B (L-1)``
        targets."""
        mesh = self.mesh
        b = tokens.shape[0]
        nxt = torch.cat([tokens[:, 1:], tokens.new_full((b, 1), -1)], 1)
        if mesh_lib.mesh_axis_size(mesh, mesh_lib.SEQUENCE_AXIS) > 1:
            nxt = seq_chunk(nxt, mesh, 1)
        ls, cs, n = vocab_parallel_cross_entropy(
            logits.reshape(-1, logits.shape[-1]), nxt.reshape(-1), mesh,
            label_smoothing=self.cfg.label_smoothing,
            z_loss=self.cfg.z_loss)
        sp = _group(mesh, mesh_lib.SEQUENCE_AXIS)
        ls = coll.reduce_from_model(ls, sp)
        cs = coll.all_reduce_value(cs, sp)
        n = coll.all_reduce_value(n, sp).clamp(min=1.0)
        return ls / n, cs / n

    def training_step(self, params: Params, batch: Any,
                      rng: Optional[torch.Generator] = None):
        loss, acc, aux = self._lm_loss(params, batch, rng=rng)
        metrics = {"loss": loss, "accuracy": acc}
        if self.cfg.num_experts > 1:
            metrics["moe_aux_loss"] = aux
            loss = loss + self.cfg.moe_aux_weight * aux
        return loss, metrics

    def validation_step(self, params: Params, batch: Any):
        loss, acc, _ = self._lm_loss(params, batch)
        return {"val_loss": loss, "val_accuracy": acc,
                "val_perplexity": torch.exp(loss)}

    def predict_step(self, params: Params, batch: Any):
        """The logits ``[B, S, V]``; over a tensor or sequence axis the
        ranks' slices are gathered into the whole."""
        logits = self.forward(params, batch)
        mesh = self.mesh
        logits = coll.all_gather_dim(logits, -1,
                                     _group(mesh, mesh_lib.TENSOR_AXIS))
        return coll.all_gather_dim(logits, 1,
                                   _group(mesh, mesh_lib.SEQUENCE_AXIS))

    def configure_optimizers(self) -> AdamW:
        return AdamW(self.lr, weight_decay=0.01)

    # ------------------------------------------------------------------ #
    # Cached decode: the pieces every decode path shares                 #
    # ------------------------------------------------------------------ #
    def _decode_qkv(self, h: torch.Tensor, lp: Params):
        """ln1 and the q/k/v projections of a decode chunk, q8-kernel
        aware: h [B, n, d] -> q [B, H, n, D], k and v [B, kv_heads, n, D]."""
        dt = self.compute_dtype
        a = lp["attn"]
        x = self._rms_norm(h, lp["ln1"])
        return (self._qkv_proj_decode(x, a["wq"], dt),
                self._qkv_proj_decode(x, a["wk"], dt),
                self._qkv_proj_decode(x, a["wv"], dt))

    def _cached_attention(self, q: torch.Tensor, kc: torch.Tensor,
                          vc: torch.Tensor,
                          keep: torch.Tensor) -> torch.Tensor:
        """Grouped-query attention of q [B, H, n, D] over a cache view
        kc/vc [B, kv_heads, W, D] in f32, positions where ``keep``
        (broadcast to [B, kv_heads, groups, n, W]) is False set to -1e30.
        The query heads of one kv head are a reshape, not a repeat."""
        cfg = self.cfg
        b, _, n, hd = q.shape
        kvh = kc.shape[1]
        qg = q.float().reshape(b, kvh, cfg.n_heads // kvh, n, hd)
        s = torch.einsum("bkgqd,bktd->bkgqt", qg, kc.float()) * hd ** -0.5
        p = torch.softmax(s.masked_fill(~keep, -1e30), dim=-1)
        attn = torch.einsum("bkgqt,bktd->bkgqd", p, vc.float())
        return attn.reshape(b, cfg.n_heads, n, hd).to(self.compute_dtype)

    def _decode_out_mlp(self, h: torch.Tensor, attn: torch.Tensor,
                        lp: Params) -> torch.Tensor:
        """Output projection, residual, ln2 and the MLP of a decode
        chunk, q8-kernel aware (a MoE layer routes the chunk's tokens on
        the chunk's own capacity)."""
        dt = self.compute_dtype
        h = h + self._attn_out_proj_decode(attn, lp["attn"]["wo"], dt)
        x = self._rms_norm(h, lp["ln2"])
        y, _ = self._mlp(x, lp["mlp"], dt, train=False)
        return h + y

    # ------------------------------------------------------------------ #
    # Dense KV-cache decode                                              #
    # ------------------------------------------------------------------ #
    # The cache is [L, B, kv_heads, W, D].  Where the JAX package returns
    # an updated copy (dynamic_update_slice, which clamps an out-of-range
    # start), the port writes each layer's view in place and raises on an
    # out-of-range write.

    def _decode_attn_block(self, h: torch.Tensor, lp: Params,
                           ck: torch.Tensor, cv: torch.Tensor, pos0: int,
                           ring: bool,
                           row_positions: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """One layer, n cached-decode tokens at positions pos0..pos0+n-1.
        h: [B, n, d]; ck/cv: [B, kv_heads, W, D], written in place.

        ``ring=True`` (single token, n == 1): the cache is a ring over
        slots ``p % W`` with wrap-around validity (W == the full length is
        the plain linear cache).  ``ring=False``: linear slots, causal
        within the chunk and over the prefix (speculative chunk scoring).
        ``row_positions`` ([B], n == 1, ring False): every row decodes at
        its own position into linear slots (the continuous-batching
        step)."""
        cfg = self.cfg
        n = h.shape[1]
        W = ck.shape[2]
        q, k, v = self._decode_qkv(h, lp)
        if row_positions is not None:
            q = _rope_rows(q, row_positions, cfg.rope_theta)
            k = _rope_rows(k, row_positions, cfg.rope_theta)
            # per-row slot write: row b's k/v land at its own position
            rows_b = torch.arange(h.shape[0], device=h.device)
            ck[rows_b, :, row_positions] = k[:, :, 0].to(ck.dtype)
            cv[rows_b, :, row_positions] = v[:, :, 0].to(cv.dtype)
            rows = row_positions[:, None, None, None, None]
        else:
            positions = pos0 + torch.arange(n, device=h.device)
            q = _rope(q, positions, cfg.rope_theta)
            k = _rope(k, positions, cfg.rope_theta)
            slot = pos0 % W if ring else pos0
            if slot < 0 or slot + n > W:
                raise IndexError(
                    f"decode cache write at slots [{slot}, {slot + n}) "
                    f"outside the cache's {W} slots")
            ck[:, :, slot:slot + n] = k.to(ck.dtype)
            cv[:, :, slot:slot + n] = v.to(cv.dtype)
            rows = positions[None, None, None, :, None]
        t = torch.arange(W, device=h.device)[None, None, None, None, :]
        if ring:
            # once a row's position >= W every slot holds a position in
            # (pos - W, pos], exactly the attention span; before that only
            # slots <= pos are written
            keep = (t <= rows) | (rows >= W)
        else:
            keep = t <= rows
        attn = self._cached_attention(q, ck, cv, keep)
        return self._decode_out_mlp(h, attn, lp)

    def _decode_layers(self, params: Params, cache: Dict[str, torch.Tensor],
                       h: torch.Tensor, pos0: int, ring: bool,
                       row_positions: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        for i, lp in enumerate(self._layer_list(params)):
            h = self._decode_attn_block(h, lp, cache["k"][i], cache["v"][i],
                                        pos0, ring, row_positions)
        return self._rms_norm(h, params["ln_f"])

    def _decode_chunk(self, params: Params, cache: Dict[str, torch.Tensor],
                      tokens: Any, pos0: int):
        """Score a chunk of n tokens ([B, n], fed at positions
        pos0..pos0+n-1) against the linear cache in one pass.  Returns
        (logits [B, n, V] f32, cache updated in place); logits[:, i]
        predicts position pos0 + i + 1."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        h = self._decode_layers(params, cache,
                                self._embed_lookup(params, tokens),
                                int(pos0), ring=False)
        b, n, d = h.shape
        logits = self._unembed_matmul(h.reshape(b * n, d), params,
                                      self.compute_dtype)
        return logits.reshape(b, n, -1), cache

    def _decode_token(self, params: Params, cache: Dict[str, torch.Tensor],
                      token: Any, pos: int):
        """Full-depth single-token step.  token: [B].  Returns (logits
        [B, V] f32, cache updated in place)."""
        token = torch.as_tensor(token, device=self.device).long()
        h = self._decode_layers(params, cache,
                                self._embed_lookup(params, token)[:, None],
                                int(pos), ring=True)
        return self._unembed_matmul(h[:, 0], params,
                                    self.compute_dtype), cache

    def decode_cache_alloc(self, batch: int,
                           total_len: int) -> Dict[str, torch.Tensor]:
        """Zeroed multi-slot KV cache [L, batch, kv_heads, total_len,
        head_dim] in the compute dtype (the dense serve engine's slots)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, cfg.kv_heads, total_len,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.compute_dtype,
                                 device=self.device),
                "v": torch.zeros(shape, dtype=self.compute_dtype,
                                 device=self.device)}

    @staticmethod
    def cache_join(cache: Dict[str, torch.Tensor],
                   row_cache: Dict[str, torch.Tensor],
                   slot: int) -> Dict[str, torch.Tensor]:
        """Write a single-request cache [L, 1, H, P, D] into row ``slot``
        of a multi-slot cache [L, B, H, W, D] (P <= W), in place.  Stale
        entries past P in that row stay: linear decode rewrites slot p at
        position p before the causal mask exposes it."""
        slot = int(slot)
        big, row = cache["k"], row_cache["k"]
        if row.shape[1] != 1 or row.shape[3] > big.shape[3] \
                or not 0 <= slot < big.shape[1]:
            raise IndexError(
                f"cache_join: row cache {tuple(row.shape)} does not fit "
                f"slot {slot} of a cache {tuple(big.shape)}")
        P = row.shape[3]
        for name in ("k", "v"):
            cache[name][:, slot:slot + 1, :, :P] = \
                row_cache[name].to(cache[name].dtype)
        return cache

    def decode_step_rows(self, params: Params,
                         cache: Dict[str, torch.Tensor], tokens: Any,
                         positions: Any):
        """Full-depth single-token step for every cache row at once, each
        at its own position (the continuous-batching primitive).  tokens,
        positions: [B].  Linear slots only.  Rows the caller considers
        inactive may feed any token at any in-range position: the next
        join rewrites their slot before it is attended.  Returns (logits
        [B, V] f32, cache updated in place)."""
        positions = torch.as_tensor(positions)
        W = cache["k"].shape[3]
        if positions.device.type == "cpu" and positions.numel() and (
                int(positions.min()) < 0 or int(positions.max()) >= W):
            raise IndexError(f"decode_step_rows: positions "
                             f"{positions.tolist()} outside the cache's "
                             f"{W} slots")
        positions = positions.to(self.device).long()
        tokens = torch.as_tensor(tokens, device=self.device).long()
        h = self._decode_layers(params, cache,
                                self._embed_lookup(params, tokens)[:, None],
                                0, ring=False, row_positions=positions)
        return self._unembed_matmul(h[:, 0], params,
                                    self.compute_dtype), cache

    # ------------------------------------------------------------------ #
    # Generation                                                         #
    # ------------------------------------------------------------------ #
    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float, top_k: int,
                top_p: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """Next tokens [B] from logits [B, V]: argmax at temperature 0,
        else a draw from the tempered, top-k- and nucleus-filtered
        distribution (filtered logits set to -1e30, the JAX package's
        formula; the draw uses ``generator``, not jax.random)."""
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        logits = logits / temperature
        if top_k:
            kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
            logits = logits.masked_fill(logits < kth, -1e30)
        if top_p < 1.0:
            # a token survives if the probability mass before it is below
            # top_p; the head token always survives (top_p = 0 is greedy)
            sorted_logits = torch.sort(logits, dim=-1,
                                       descending=True).values
            probs = torch.softmax(sorted_logits, dim=-1)
            cum = torch.cumsum(probs, dim=-1) - probs
            cutoff_idx = torch.clamp((cum < top_p).sum(-1) - 1, min=0)
            cutoff = torch.gather(sorted_logits, 1, cutoff_idx[:, None])
            logits = logits.masked_fill(logits < cutoff, -1e30)
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    def _check_budget(self, s0: int, max_new_tokens: int) -> int:
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = s0 + max_new_tokens
        if total > self.cfg.max_seq_len:
            raise ValueError(f"prompt + new tokens ({total}) exceeds "
                             f"max_seq_len ({self.cfg.max_seq_len})")
        return total

    def _cache_len(self, total: int) -> int:
        window = self.cfg.sliding_window
        return total if window is None else min(total, window)

    @torch.no_grad()
    def generate(self, params: Params, prompt: Any, max_new_tokens: int,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, repetition_penalty: float = 1.0,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """Greedy (temperature 0) or sampled decode.  prompt: [B, S0].
        Returns [B, S0 + max_new_tokens] int32 on the model's device.

        ``repetition_penalty > 1`` divides the logits of every token
        already in the sequence (prompt included) by the penalty when
        positive and multiplies them when negative (the CTRL rule).
        ``generator``: a ``torch.Generator`` on the model's device for
        sampling (None: one seeded with 0)."""
        prompt = torch.as_tensor(prompt, device=self.device).long()
        if prompt.ndim != 2:
            raise ValueError(f"prompt must be [batch, prompt_len], got "
                             f"{tuple(prompt.shape)}")
        b, s0 = prompt.shape
        total = self._check_budget(s0, max_new_tokens)
        if generator is None and temperature != 0.0:
            generator = torch.Generator(device=self.device).manual_seed(0)
        params = self.unstack_layers(params)
        dt = self.compute_dtype
        h_last, cache = self._prefill(params, prompt, self._cache_len(total))
        seen = None
        if repetition_penalty != 1.0:
            # presence mask of the tokens seen so far
            seen = torch.zeros((b, self.cfg.vocab_size), dtype=torch.bool,
                               device=self.device)
            seen.scatter_(1, prompt, True)

        def next_token(logits: torch.Tensor) -> torch.Tensor:
            if seen is not None:
                scaled = torch.where(logits > 0, logits / repetition_penalty,
                                     logits * repetition_penalty)
                logits = torch.where(seen, scaled, logits)
            tok = self._sample(logits, temperature, top_k, top_p, generator)
            if seen is not None:
                seen.scatter_(1, tok[:, None], True)
            return tok

        tok = next_token(self._unembed_matmul(h_last, params, dt))
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits, cache = self._decode_token(params, cache, tok, s0 + i)
            tok = next_token(logits)
            out.append(tok)
        return torch.cat([prompt, torch.stack(out, dim=1)],
                         dim=1).to(torch.int32)

    @torch.no_grad()
    def generate_beam(self, params: Params, prompt: Any, max_new_tokens: int,
                      beam_size: int = 4) -> torch.Tensor:
        """Beam-search decode.  prompt: [1, S0]; returns the sequence
        [1, S0 + max_new_tokens] (int32) with the highest total
        log-probability.  Every beam decodes the full length (no EOS), so
        no length normalization applies.  Beams ride the batch dimension
        of the cache, re-gathered by surviving parents every step."""
        prompt = torch.as_tensor(prompt, device=self.device).long()
        if prompt.ndim != 2 or prompt.shape[0] != 1:
            raise ValueError("beam search expects batch size 1")
        s0 = prompt.shape[1]
        total = self._check_budget(s0, max_new_tokens)
        params = self.unstack_layers(params)
        dt = self.compute_dtype
        h_last, cache = self._prefill(params, prompt, self._cache_len(total))
        logp0 = torch.log_softmax(self._unembed_matmul(h_last, params, dt),
                                  dim=-1)
        # seed beams from the top first tokens (-1e30 beams pad a beam
        # wider than the vocabulary; they can never win)
        k0 = min(beam_size, logp0.shape[-1])
        scores, tok0 = torch.topk(logp0[0], k0)
        if k0 < beam_size:
            scores = torch.cat([scores, scores.new_full(
                (beam_size - k0,), -1e30)])
            tok0 = torch.cat([tok0, tok0.new_zeros(beam_size - k0)])
        cache = {name: c.expand(c.shape[0], beam_size, *c.shape[2:]).clone()
                 for name, c in cache.items()}
        toks, parents_hist, toks_hist = tok0, [], []
        for i in range(max_new_tokens - 1):
            logits, cache = self._decode_token(params, cache, toks, s0 + i)
            logp = torch.log_softmax(logits, dim=-1)        # [beam, V]
            totals = scores[:, None] + logp
            scores, flat_idx = torch.topk(totals.reshape(-1), beam_size)
            parents = torch.div(flat_idx, logp.shape[1],
                                rounding_mode="floor")
            toks = flat_idx % logp.shape[1]
            cache = {name: c[:, parents] for name, c in cache.items()}
            parents_hist.append(parents)
            toks_hist.append(toks)
        # backtrack the best beam through the parent pointers
        beam = int(torch.argmax(scores))
        seq = []
        for parents, step_toks in zip(reversed(parents_hist),
                                      reversed(toks_hist)):
            seq.append(int(step_toks[beam]))
            beam = int(parents[beam])
        seq.append(int(tok0[beam]))
        new = torch.tensor(seq[::-1], device=self.device)[None]
        return torch.cat([prompt, new], dim=1).to(torch.int32)

    # ------------------------------------------------------------------ #
    # Block-paged decode (the serve engine's paged KV cache)             #
    # ------------------------------------------------------------------ #
    # The pool is a fixed set of [L, n_blocks, kv_heads, block_len, D] KV
    # blocks plus a per-row int32 block table mapping logical position p
    # to physical block table[p // block_len], offset p % block_len.
    # Where the JAX package donates the pool to its jitted programs, the
    # port writes the new k/v into the pool IN PLACE (the layer slices
    # are views): one pool's worth of device memory, no per-step copy.

    def paged_cache_alloc(self, n_blocks: int,
                          block_len: int) -> Dict[str, torch.Tensor]:
        """Zeroed block pool [L, n_blocks, kv_heads, block_len, head_dim]
        in the compute dtype (block 0 is the engine's garbage block:
        inactive decode rows scatter there; it is never table-mapped)."""
        cfg = self.cfg
        shape = (cfg.n_layers, n_blocks, cfg.kv_heads, block_len,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.compute_dtype,
                                 device=self.device),
                "v": torch.zeros(shape, dtype=self.compute_dtype,
                                 device=self.device)}

    @staticmethod
    def paged_blocks_gather(pool: Dict[str, torch.Tensor], blocks: Any
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Read physical ``blocks`` ([W] ids) out of a paged pool: ``(k,
        v)``, each a copy [L, W, kv_heads, block_len, head_dim] (the KV
        handoff's export).  Callers pad ``blocks`` to a fixed wave width
        with the garbage block 0."""
        ids = torch.as_tensor(blocks, device=pool["k"].device).long()
        return pool["k"][:, ids], pool["v"][:, ids]

    @staticmethod
    def paged_blocks_scatter(pool: Dict[str, torch.Tensor], blocks: Any,
                             k: torch.Tensor, v: torch.Tensor
                             ) -> Dict[str, torch.Tensor]:
        """Write block payloads ``k`` / ``v`` ([L, W, H, block_len, D])
        into physical ``blocks`` ([W] ids) of a paged pool, in place, cast
        to the pool's dtype (the KV handoff's import: the same bytes under
        new ids).  Pad entries target the garbage block 0, where
        last-write-wins garbage is harmless.  Returns the pool."""
        ids = torch.as_tensor(blocks, device=pool["k"].device).long()
        for name, payload in (("k", k), ("v", v)):
            pool[name][:, ids] = payload.to(device=pool[name].device,
                                            dtype=pool[name].dtype)
        return pool

    def _paged_attn_block(self, h, lp, pk, pv, tables, positions):
        """One layer over the block-paged pool.  h: [B, n, d]; pk/pv:
        [n_blocks, H, block_len, D] (one layer's pool, written in place);
        tables: [B, M] physical block ids; positions: [B, n] query
        positions.  Each query's k/v is scattered to its table-mapped
        slot first, then every row gathers its table's blocks into a
        [H, M*block_len, D] view and attends with mask t <= position.
        Unmapped table entries (sentinel 0) only cover positions t >
        position, which the mask closes; the garbage block's values are
        finite, so masked lanes stay exactly zero."""
        cfg = self.cfg
        b = h.shape[0]
        bl = pk.shape[2]
        q, k, v = self._decode_qkv(h, lp)                # q [B, H, n, D]
        q = _rope_grid(q, positions, cfg.rope_theta)
        k = _rope_grid(k, positions, cfg.rope_theta)
        # per-query scatter: query (b, i) writes its k/v at physical block
        # tables[b, pos // bl], offset pos % bl.  The two index tensors sit
        # around a slice, so (as in numpy and JAX) their broadcast dims
        # lead: the target is [B, n, H, D].  Inactive rows all target the
        # garbage block 0, where last-write-wins garbage is harmless.
        phys = torch.gather(tables, 1, torch.div(positions, bl,
                                                 rounding_mode="floor"))
        off = positions % bl                             # [B, n]
        pk[phys, :, off, :] = k.transpose(1, 2).to(pk.dtype)
        pv[phys, :, off, :] = v.transpose(1, 2).to(pv.dtype)
        kvh = pk.shape[1]
        W = tables.shape[1] * bl
        kb = pk[tables].permute(0, 2, 1, 3, 4).reshape(b, kvh, W, -1)
        vb = pv[tables].permute(0, 2, 1, 3, 4).reshape(b, kvh, W, -1)
        t = torch.arange(W, device=h.device)[None, None, None, None, :]
        attn = self._cached_attention(q, kb, vb,
                                      t <= positions[:, None, None, :, None])
        return self._decode_out_mlp(h, attn, lp)

    def decode_step_rows_paged(self, params: Params,
                               pool: Dict[str, torch.Tensor],
                               tables: Any, tokens: Any, positions: Any):
        """One full-depth single-token step for every row at once, each
        row reading/writing the pool via its own table row.  tables:
        [B, M] block ids; tokens / positions: [B].  Rows the caller
        considers inactive must carry an all-zero table (the garbage
        block) and any in-range position.  Returns (logits [B, V] f32,
        pool) -- the same pool object, updated in place."""
        dt = self.compute_dtype
        dev = self.device
        positions = torch.as_tensor(positions, device=dev).long()
        tables = torch.as_tensor(tables, device=dev).long()
        tokens = torch.as_tensor(tokens, device=dev).long()
        h = self._embed_lookup(params, tokens)[:, None]   # [B, 1, d]
        for i, lp in enumerate(self._layer_list(params)):
            h = self._paged_attn_block(h, lp, pool["k"][i], pool["v"][i],
                                       tables, positions[:, None])
        h = self._rms_norm(h, params["ln_f"])
        logits = self._unembed_matmul(h[:, 0], params, dt)
        return logits, pool

    def decode_chunk_paged(self, params: Params,
                           pool: Dict[str, torch.Tensor], table: Any,
                           tokens: Any, pos0: int,
                           last_index: Optional[int] = None):
        """Single-row chunk prefill through the paged pool: n tokens
        ([1, n]) fed at positions pos0..pos0+n-1, attending to whatever
        the row's ``table`` ([M]) already maps plus causally to
        themselves; their k/v land in the table-mapped blocks.  With
        ``last_index`` the logits of that chunk position ([1, V]),
        otherwise of every position ([1, n, V]).  Returns (logits, pool),
        the pool updated in place."""
        dt = self.compute_dtype
        dev = self.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        n = tokens.shape[1]
        pos = (int(pos0) + torch.arange(n, device=dev))[None]   # [1, n]
        table = torch.as_tensor(table, device=dev).long()
        h = self._embed_lookup(params, tokens)
        for i, lp in enumerate(self._layer_list(params)):
            h = self._paged_attn_block(h, lp, pool["k"][i], pool["v"][i],
                                       table[None], pos)
        h = self._rms_norm(h, params["ln_f"])
        if last_index is None:
            b, nn, d = h.shape
            logits = self._unembed_matmul(h.reshape(b * nn, d), params,
                                          dt).reshape(b, nn, -1)
            return logits, pool
        logits = self._unembed_matmul(h[:, int(last_index)], params, dt)
        return logits, pool


def _detach(tree: Any) -> Any:
    """A leaf or a dict of leaves (an int8 weight), detached."""
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()


def _group(mesh: Any, axis: str) -> Any:
    """The process group of ``axis`` on a ``RankMesh``, None without one
    (or when the axis holds this rank alone)."""
    return None if mesh is None or not hasattr(mesh, "group") \
        else mesh.group(axis)


def _leading_dim(node: Any) -> int:
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return int(node.shape[0])
