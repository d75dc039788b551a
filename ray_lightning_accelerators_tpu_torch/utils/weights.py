"""Carry the JAX package's parameter trees into the port.

``params_from_jax`` turns a GPT parameter tree of the JAX package, given
as numpy arrays (``jax.device_get`` of ``GPT.init_params`` or of
``GPT.quantize_weights``), into the port's tensors with the same leaf
names and layouts, so both packages compute with identical weights.  The
port itself never imports JAX; a caller holding JAX arrays converts them
with ``np.asarray`` (or ``jax.device_get``) first.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..core.module import DeviceLike, resolve_device


def _tensor(arr: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: no torch numpy path
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_jax(tree: Any, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device`` (None = the CUDA device).

    ``dtype`` casts the floating DENSE leaves (the storage type of a bf16
    deployment); quantized ``{"q8", "scale"}`` leaves keep their int8
    weights and f32 scales exactly as ``quantize_weights`` made them."""
    dev = resolve_device(device)

    def conv(node: Any, in_q8: bool) -> Any:
        if isinstance(node, dict):
            q8 = "q8" in node
            return {k: conv(v, q8) for k, v in node.items()}
        t = _tensor(node, dev)
        if dtype is not None and not in_q8 and t.is_floating_point():
            t = t.to(dtype)
        return t

    return conv(tree, False)
