"""GPT decoder LM: the serving half, over the block-paged KV pool.

Port of the JAX package's ``models/transformer.py`` for the
paged serve path: ``TransformerConfig``, parameter init, ``_rope_grid``,
weight-only int8 quantization with the kernel-aware decode projections,
and ``paged_cache_alloc`` / ``_paged_attn_block`` /
``decode_step_rows_paged`` / ``decode_chunk_paged``.

Parameters are plain dicts of tensors with the JAX leaf names and einsum
layouts: ``embed [V,d]``; ``layers.attn.wq/wk/wv [L,d,h,hd]``,
``wo [L,h,hd,d]``; ``layers.mlp.wi [L,d,f]``, ``wo [L,f,d]``; ``ln1``,
``ln2`` ``[L,d]``; ``ln_f [d]``.  Quantized leaves are
``{"q8": int8, "scale": f32}`` dicts of the same shapes.  Weights are
cast to ``compute_dtype`` where they are used, as in the JAX package.

The RMSNorms go through the CUDA kernel of ``ops/norms.py`` and every q8
projection through ``ops/quant.py``'s kernels; the paged attention's
gather and einsums and the bf16-weight projections are plain PyTorch, as
they were plain XLA in the JAX package.

Later slices: ``generate()``/``_prefill`` and the dense decode cache
(with flash attention), mixture-of-experts, sliding-window attention and
device meshes raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import torch
import torch.nn.functional as F

from ..core.module import DeviceLike, TorchModule, not_ported
from ..ops import quant
from ..ops.norms import rms_norm


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


def _rope_grid(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embeddings with a per-row, per-query position grid.
    x: [b, h, n, d], positions: [b, n].  Rotates INTERLEAVED even/odd
    pairs (x[..., 0::2], x[..., 1::2]), as the JAX package does, with the
    angles in f32."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions[..., None].float() * freqs[None, None, :]  # [b,n,d/2]
    cos = torch.cos(angles)[:, None, :, :]                        # [b,1,n,d/2]
    sin = torch.sin(angles)[:, None, :, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.stack([rx1, rx2], dim=-1).reshape(x.shape).to(x.dtype)



Params = Dict[str, Any]


class GPT(TorchModule):
    """Decoder-only LM, serving half.  ``device`` None = the CUDA device;
    ``compute_dtype`` as in the JAX package (float32 by default; the
    serve deployment uses bfloat16)."""

    def __init__(self, config: Union[TransformerConfig, dict, None] = None,
                 device: DeviceLike = None,
                 compute_dtype: torch.dtype = torch.float32,
                 mesh: Any = None, **cfg_overrides):
        super().__init__(device=device, compute_dtype=compute_dtype)
        if config is None:
            config = TransformerConfig(**cfg_overrides)
        elif isinstance(config, dict):
            config = TransformerConfig(**config)
        if config.num_experts > 1:
            raise not_ported("num_experts > 1 (mixture-of-experts)",
                             "other-models")
        if config.sliding_window is not None:
            raise not_ported("sliding_window attention", "generation")
        if mesh is not None:
            raise not_ported("a device mesh", "multi-GPU")
        self.cfg = config

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

        params = {
            "embed": dense((cfg.vocab_size, d), d) * d ** 0.5 * 0.02,
            "layers": {
                "attn": {
                    "wq": dense((L, d, h, hd), d),
                    "wk": dense((L, d, kv, hd), d),
                    "wv": dense((L, d, kv, hd), d),
                    "wo": dense((L, h, hd, d), d),
                },
                "mlp": {
                    "wi": dense((L, d, f), d),
                    "wo": dense((L, f, d), f),
                },
                "ln1": torch.ones((L, d), device=dev),
                "ln2": torch.ones((L, d), device=dev),
            },
            "ln_f": torch.ones((d,), device=dev),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = dense((d, cfg.vocab_size), d)
        return params

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
            scale = torch.where(amax > 0, amax / 127.0,
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

        def take(node, i):
            if isinstance(node, dict):
                return {k: take(v, i) for k, v in node.items()}
            return node[i]

        n = _leading_dim(layers)
        return {**params, "layers": [take(layers, i) for i in range(n)]}

    def _layer_list(self, params: Params) -> List[Params]:
        return self.unstack_layers(params)["layers"]

    def _embed_lookup(self, params: Params,
                      tokens: torch.Tensor) -> torch.Tensor:
        """Token ids -> embedding rows [*, d] (the JAX package's branch
        without a tensor-parallel axis).  Rows are gathered before the
        cast: casting the whole [V, d] table to take a handful of rows
        would stream it every step, and a cast commutes with a gather."""
        dt = self.compute_dtype
        w = params["embed"]
        if self._is_q8(w):
            # gather the int8 rows first, dequantize only those
            rows = w["q8"][tokens].float()
            return (rows * w["scale"].reshape(-1)).to(dt)
        return w[tokens].to(dt)

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
        dt = self.compute_dtype
        a = lp["attn"]
        b, n, _ = h.shape
        bl = pk.shape[2]
        x = self._rms_norm(h, lp["ln1"])
        q = self._qkv_proj_decode(x, a["wq"], dt)        # [B, H, n, D]
        k = self._qkv_proj_decode(x, a["wk"], dt)
        v = self._qkv_proj_decode(x, a["wv"], dt)
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
        # GQA: the query heads of one kv head are a reshape, not a repeat
        groups = cfg.n_heads // kvh
        qg = q.float().reshape(b, kvh, groups, n, cfg.head_dim)
        s = torch.einsum("bkgqd,bktd->bkgqt", qg, kb.float()
                         ) * cfg.head_dim ** -0.5
        t = torch.arange(W, device=h.device)[None, None, None, None, :]
        rows = positions[:, None, None, :, None]
        s = s.masked_fill(t > rows, -1e30)
        p = torch.softmax(s, dim=-1)
        attn = torch.einsum("bkgqt,bktd->bkgqd", p, vb.float())
        attn = attn.reshape(b, cfg.n_heads, n, cfg.head_dim).to(dt)
        h = h + self._attn_out_proj_decode(attn, a["wo"], dt)
        x = self._rms_norm(h, lp["ln2"])
        m = lp["mlp"]
        # jax.nn.gelu defaults to the tanh approximation
        up = F.gelu(self._mlp_proj_decode(x, m["wi"], dt), approximate="tanh")
        y = self._mlp_proj_decode(up, m["wo"], dt)
        return h + y

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

    # ------------------------------------------------------------------ #
    # Later slices                                                       #
    # ------------------------------------------------------------------ #
    def generate(self, *args, **kwargs):
        raise not_ported("generate() (dense KV cache, flash attention)",
                         "generation")

    def _prefill(self, *args, **kwargs):
        raise not_ported("_prefill (flash attention)", "generation")

    def decode_cache_alloc(self, *args, **kwargs):
        raise not_ported("the dense decode cache", "generation")

    def decode_step_rows(self, *args, **kwargs):
        raise not_ported("decode_step_rows over the dense cache", "generation")


def _leading_dim(node: Any) -> int:
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return int(node.shape[0])
