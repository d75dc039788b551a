"""PyTorch and CUDA port of the JAX package beside it, for NVIDIA
Hopper (H100).

The JAX package beside it is the reference.  This package imports
``torch`` and never ``jax``, nor anything of the JAX package.  The slice
ported so far is the paged serve engine over the GPT model
(``serve.ServeEngine``, ``models.transformer.GPT``) with hand-written
CUDA kernels for RMSNorm and the int8 weight-only matrix products
(``ops/``, sources in ``csrc/``).  Entry points run on the CUDA device
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
