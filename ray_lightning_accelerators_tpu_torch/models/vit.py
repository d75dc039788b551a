"""Vision Transformer: the attention-based vision model family.

Port of the JAX package's ``models/vit.py``: images are cut into
``patch_size`` squares in row-major patch order (one matmul in place of
a strided conv stem), plus a learned position embedding, pre-norm blocks
with RMSNorm and non-causal attention, a final RMSNorm, mean pooling (no
CLS token) and a linear head.  Parameters keep the JAX leaf names and
layouts: per-layer leaves are stacked ``[n_layers, ...]`` (``wq``,
``wk``, ``wv`` ``[L, d, h, hd]``, ``wo`` ``[L, h, hd, d]``, ``mlp.wi``
``[L, d, f]``, ``mlp.wo`` ``[L, f, d]``, ``ln1``/``ln2`` ``[L, d]``), and
a Python loop over the layers takes the place of ``lax.scan``.

The RMSNorms run the CUDA kernel K1 and the attention the flash kernels
(K2 forward; the backward K4 while the 64 patches fit one 512-key block,
else K3a + K3b) on the card, their plain versions on the CPU
(``ops/``).  ``jax.nn.gelu`` defaults to the tanh approximation, and so
does this port.  ``remat`` checkpoints each block with the default policy
(save nothing, recompute in the backward), as ``jax.checkpoint(block)``
there.  Over a tensor axis (``module.mesh``, a ``RankMesh`` the trainer
hands each rank) the heads and the MLP's ``d_ff`` are split as the JAX
package's rules split them (``heads``, ``mlp`` -> tensor): the normalised
input of each projection passes *f*, the partial outputs of attention
``wo`` and the MLP ``wo`` are summed by *g* (``parallel/collectives.py``),
and every other leaf is replicated.  ViT runs no pipeline schedule: over
a pipeline axis the layer stack is stored split over the stages (the
``layers`` rule) and gathered whole before the layer loop
(``gather_whole``: each stage keeps its slice of the gradient), and
every stage runs the whole forward on the same rows, as XLA runs the
JAX package's ``scan`` over the sharded stack.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.module import DeviceLike, TorchModule
from ..core.optim import AdamW
from ..ops.attention import flash_attention
from ..ops.norms import rms_norm
from ..parallel import collectives as coll
from ..parallel import mesh as mesh_lib
from .mnist import softmax_xent_acc
from .transformer import GPT

Params = Dict[str, Any]


@dataclasses.dataclass
class ViTConfig:
    """Field-for-field the JAX package's config."""

    image_size: int = 32
    patch_size: int = 4
    channels: int = 3
    d_model: int = 256
    n_heads: int = 4
    d_ff: int = 1024
    n_layers: int = 6
    n_classes: int = 10
    remat: bool = False

    @property
    def n_patches(self) -> int:
        assert self.image_size % self.patch_size == 0
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class ViT(TorchModule):
    """Images [B, H, W, C] (NHWC) -> class logits [B, n_classes].
    ``device`` None = the CUDA device; ``lr`` a float or a schedule."""

    def __init__(self, config: Union[ViTConfig, dict, None] = None,
                 lr: Union[float, Callable[[int], float], str] = 1e-3,
                 device: DeviceLike = None,
                 compute_dtype: torch.dtype = torch.float32,
                 **cfg_overrides):
        super().__init__(device=device, compute_dtype=compute_dtype)
        if config is None:
            config = ViTConfig(**cfg_overrides)
        elif isinstance(config, dict):
            # hparams round-trip: load_from_checkpoint calls cls(**hparams)
            config = ViTConfig(**config)
        self.cfg = config
        self.lr = self.coerce_checkpoint_lr(lr, 1e-3, "ViT")
        if callable(self.lr):
            self.lr_schedule = self.lr
        self.save_hyperparameters(
            config=dataclasses.asdict(config),
            lr=repr(self.lr) if callable(self.lr) else self.lr)

    # ------------------------------------------------------------------ #
    def init_params(self, seed: int = 0) -> Params:
        """Random f32 weights in the JAX init's shapes and scales, from a
        ``torch.Generator`` (other numbers than ``jax.random``'s; parity
        tests carry JAX weights over with
        ``utils.weights.params_from_jax``)."""
        cfg = self.cfg
        d, h, hd, f, L = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                          cfg.n_layers)
        dev = self.device
        g = torch.Generator(device=dev).manual_seed(int(seed))

        def dense(shape, fan_in):
            return torch.randn(shape, generator=g, device=dev) * fan_in ** -0.5

        return {
            "patch_embed": dense((cfg.patch_dim, d), cfg.patch_dim),
            "pos_embed": torch.randn((cfg.n_patches, d), generator=g,
                                     device=dev) * 0.02,
            "layers": {
                "attn": {"wq": dense((L, d, h, hd), d),
                         "wk": dense((L, d, h, hd), d),
                         "wv": dense((L, d, h, hd), d),
                         "wo": dense((L, h, hd, d), d)},
                "mlp": {"wi": dense((L, d, f), d),
                        "wo": dense((L, f, d), f)},
                "ln1": torch.ones((L, d), device=dev),
                "ln2": torch.ones((L, d), device=dev),
            },
            "ln_f": torch.ones((d,), device=dev),
            "head": dense((d, cfg.n_classes), d),
        }

    def param_logical_axes(self) -> Dict[str, Any]:
        """Logical axis names per leaf (the JAX package's)."""
        return {
            "patch_embed": (None, "embed"),
            "pos_embed": (None, "embed"),
            "layers": {
                "attn": {
                    "wq": ("layers", "embed", "heads", "kv"),
                    "wk": ("layers", "embed", "heads", "kv"),
                    "wv": ("layers", "embed", "heads", "kv"),
                    "wo": ("layers", "heads", "kv", "embed"),
                },
                "mlp": {"wi": ("layers", "embed", "mlp"),
                        "wo": ("layers", "mlp", "embed")},
                "ln1": ("layers", None),
                "ln2": ("layers", None),
            },
            "ln_f": (None,),
            "head": ("embed", None),
        }

    # ------------------------------------------------------------------ #
    def _patchify(self, x: torch.Tensor) -> torch.Tensor:
        """[B,H,W,C] -> [B, n_patches, patch_dim] (row-major patch order,
        each patch's pixels row-major with channels last)."""
        p = self.cfg.patch_size
        b, hh, ww, c = x.shape
        x = x.reshape(b, hh // p, p, ww // p, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, (hh // p) * (ww // p), p * p * c)

    def _block(self, h: torch.Tensor, lp: Params) -> torch.Tensor:
        dt = self.compute_dtype
        a = lp["attn"]
        tp = (None if self.mesh is None
              else self.mesh.group(mesh_lib.TENSOR_AXIS))
        x = coll.copy_to_model(rms_norm(h, lp["ln1"]), tp)
        q = torch.einsum("bsd,dhk->bhsk", x, a["wq"].to(dt))
        k = torch.einsum("bsd,dhk->bhsk", x, a["wk"].to(dt))
        v = torch.einsum("bsd,dhk->bhsk", x, a["wv"].to(dt))
        attn = flash_attention(q, k, v, causal=False)
        h = h + coll.reduce_from_model(
            torch.einsum("bhsk,hkd->bsd", attn, a["wo"].to(dt)), tp)
        x = coll.copy_to_model(rms_norm(h, lp["ln2"]), tp)
        m = lp["mlp"]
        # jax.nn.gelu defaults to the tanh approximation
        up = F.gelu(torch.einsum("bsd,df->bsf", x, m["wi"].to(dt)),
                    approximate="tanh")
        return h + coll.reduce_from_model(
            torch.einsum("bsf,fd->bsd", up, m["wo"].to(dt)), tp)

    def forward(self, params: Params, batch: Any) -> torch.Tensor:
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        dt = self.compute_dtype
        x = torch.as_tensor(x, device=self.device)
        h = self._patchify(x.to(dt)) @ params["patch_embed"].to(dt)
        h = h + params["pos_embed"].to(dt)[None]
        layers = params["layers"]
        pp = (None if self.mesh is None
              else self.mesh.group(mesh_lib.PIPELINE_AXIS))
        if pp is not None:
            # the stack is stored split over the pipeline group; every
            # stage runs every layer on the same rows
            layers = _tree_map(lambda t: coll.gather_whole(t, 0, pp),
                               layers)
        for lp in GPT.unstack_layers({"layers": layers})["layers"]:
            if self.cfg.remat:
                h = checkpoint(self._block, h, lp, use_reentrant=False)
            else:
                h = self._block(h, lp)
        h = rms_norm(h, params["ln_f"])
        pooled = torch.mean(h, dim=1)
        return (pooled @ params["head"].to(dt)).float()

    # ------------------------------------------------------------------ #
    def _loss_acc(self, params: Params, batch: Any):
        x, y = batch
        return softmax_xent_acc(self.forward(params, x),
                                torch.as_tensor(y, device=self.device))

    def training_step(self, params: Params, batch: Any,
                      generator: Optional[torch.Generator] = None):
        loss, acc = self._loss_acc(params, batch)
        return loss, {"loss": loss, "accuracy": acc}

    def validation_step(self, params: Params, batch: Any):
        loss, acc = self._loss_acc(params, batch)
        return {"val_loss": loss, "val_accuracy": acc}

    def predict_step(self, params: Params, batch: Any):
        x = batch[0] if isinstance(batch, (tuple, list)) else batch
        return torch.argmax(self.forward(params, x), -1)

    def configure_optimizers(self) -> AdamW:
        return AdamW(self.lr, weight_decay=0.05)

