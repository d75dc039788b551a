"""TorchModule: the model container's device and compute-dtype policy.

Port of the part of the JAX package's ``core/module.py``
(``TpuModule``) that the GPT serving path needs: ``compute_dtype``, the
dtype activations are carried in and weights are cast to where they are
used (float32 by default, as there; the serve deployment uses bfloat16),
and an explicit device.  The trainer-facing hooks come with the training
slice.

Entry points run on the card: ``device=None`` means CUDA, and without a
CUDA device that is an error, not a quiet move to the CPU.  Tests pass
``device="cpu"`` and get the kernels' plain versions.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA device; a CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the GPU by "
            "default; pass device='cpu' to run its plain PyTorch versions "
            "on the CPU")
    return dev


def not_ported(what: str, slice_name: str) -> NotImplementedError:
    """The error a later slice's feature raises in this one."""
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the {slice_name} slice of "
        "the PyTorch port (this slice serves the paged engine)")


class TorchModule:
    """Base class for the port's models: device + compute dtype."""

    def __init__(self, device: DeviceLike = None,
                 compute_dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
