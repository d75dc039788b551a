"""Weights between ``torch.nn.Module`` state dicts and the port's
parameter trees.

The port's own copy of the JAX package's ``utils/torch_interop.py``.
There the tree holds numpy arrays; here it is the port's tree of
tensors (nested dicts, the JAX leaf names), so a mapped entry stays a
tensor and no numpy round trip is needed, bf16 included.  The two
conventions that differ are handled explicitly, as there:

- **Linear layout**: ``torch.nn.Linear.weight`` is ``[out, in]``; the
  port's products take ``[in, out]``, so the mapping names a
  ``transpose``;
- **dtypes**: a mapped entry is cast to its template leaf's dtype and
  put on its device.

The mapping is explicit (tree path -> state_dict key, with an optional
transform): matching names loosely is how weight imports go quietly
wrong.  ``from_torch`` / ``to_torch`` convert single tensors to numpy and
back for callers that hold numpy trees (the JAX package's, or a
checkpoint's).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Tuple, Union

import numpy as np
import torch

Transform = Callable[[torch.Tensor], torch.Tensor]
MapEntry = Union[str, Tuple[str, Transform]]


def from_torch(tensor: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host.  bf16 has no numpy dtype:
    it becomes ``ml_dtypes.bfloat16`` where that package is installed,
    else a ``TypeError``."""
    t = tensor.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            raise TypeError("a bfloat16 tensor needs the ml_dtypes package "
                            "to become a numpy array") from None
        # view() needs a contiguous tensor (a transposed state_dict entry
        # is not); the other dtypes' .numpy() handles strides itself
        return t.contiguous().view(torch.uint16).numpy().view(
            ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(array: Any) -> torch.Tensor:
    """A numpy array (bf16 included, by its dtype's name) as a CPU tensor
    of its own memory."""
    a = np.asarray(array)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def transpose(t: torch.Tensor) -> torch.Tensor:
    """The Linear-layout transform ([out, in] -> [in, out]), contiguous."""
    return t.permute(*reversed(range(t.ndim))).contiguous()


def state_dict_to_tree(state_dict) -> Dict[str, torch.Tensor]:
    """A whole state_dict as a flat ``{key: tensor}`` dict of detached
    copies."""
    return {k: v.detach().clone() for k, v in state_dict.items()}


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _set_path(tree: Dict, path: str, value) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node[k]
    node[keys[-1]] = value


def import_state_dict(template_params: Dict, state_dict,
                      mapping: Dict[str, MapEntry],
                      strict: bool = True) -> Dict:
    """A parameter tree built from a torch ``state_dict``.

    ``mapping``: tree path (``"dense_0/kernel"``) -> state_dict key, or
    ``(key, transform)``, e.g. ``("net.0.weight", transpose)`` for a
    Linear kernel.  Every mapped tensor is shape-checked against the
    template and takes its leaf's dtype and device; with ``strict`` every
    template leaf must be mapped.  Unmapped leaves keep the template's
    tensors."""
    flat = _flatten(template_params)
    missing = sorted(set(flat) - set(mapping))
    if strict and missing:
        raise ValueError(f"unmapped template leaves: {missing}")
    extra = sorted(set(mapping) - set(flat))
    if extra:
        raise ValueError(f"mapping paths not in template: {extra}")

    out = copy.deepcopy({k: v for k, v in template_params.items()})
    for path, entry in mapping.items():
        key, tf = entry if isinstance(entry, tuple) else (entry, None)
        if key not in state_dict:
            raise KeyError(f"{key!r} not in state_dict (for {path!r})")
        t = state_dict[key].detach()
        if tf is not None:
            t = tf(t)
        want = flat[path]
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(
                f"{path!r}: state_dict {key!r} has shape "
                f"{tuple(t.shape)}, template wants {tuple(want.shape)} "
                f"(missing a transpose?)")
        _set_path(out, path, t.to(device=want.device, dtype=want.dtype,
                                  copy=True))
    return out


def linear_mapping(tree_path: str, torch_prefix: str) -> Dict[str, MapEntry]:
    """Mapping entries for one torch ``nn.Linear`` -> {kernel, bias}."""
    return {
        f"{tree_path}/kernel": (f"{torch_prefix}.weight", transpose),
        f"{tree_path}/bias": f"{torch_prefix}.bias",
    }


def export_state_dict(params: Dict,
                      mapping: Dict[str, MapEntry]) -> Dict[str, Any]:
    """Inverse of ``import_state_dict``: a parameter tree -> a torch
    state_dict (the same mapping; transforms are re-applied, so an
    involution like ``transpose`` round-trips)."""
    flat = _flatten(params)
    out = {}
    for path, entry in mapping.items():
        key, tf = entry if isinstance(entry, tuple) else (entry, None)
        t = flat[path].detach()
        if tf is not None:
            t = tf(t)
        out[key] = t.clone()
    return out
