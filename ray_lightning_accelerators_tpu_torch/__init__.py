"""PyTorch and CUDA port of the JAX package beside it, for NVIDIA
Hopper (H100).

The JAX package beside it is the reference.  This package imports
``torch`` and never ``jax``, nor anything of the JAX package.  Ported so
far: single-card GPT training (``Trainer.fit`` with the streaming LM-head
loss, AdamW, checkpoints and callbacks), the GPT model's inference half
(``models.transformer.GPT``: ``generate``, ``generate_beam``, the dense
and paged decode caches), speculative decoding (``models.speculative``)
and the serve engine in its paged and dense modes
(``serve.ServeEngine``), with hand-written CUDA kernels for RMSNorm, flash
attention forward and backward and the int8 weight-only matrix products
(``ops/``, sources in ``csrc/``).  Entry points run on the CUDA device
unless the caller passes ``device="cpu"``.
"""

from .core.callbacks import Callback, EarlyStopping, ModelCheckpoint
from .core.trainer import Trainer
from .data.loader import DataLoader

__all__ = ["Callback", "DataLoader", "EarlyStopping", "ModelCheckpoint",
           "Trainer"]
__version__ = "0.1.0"
