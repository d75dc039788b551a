"""Checkpoint IO: atomic single-file checkpoints of the full trainer state.

Port of the JAX package's ``utils/checkpoint.py`` for its pickle format.
The port writes its own payload: every tensor is copied to the host as a
numpy array (the parameter tree with the JAX leaf names, the AdamW
moments or the SGD momentum trace and the parameter EMA in the
optimizer's leaf order), so a checkpoint loads without a card.  It does
not read the JAX package's checkpoints.  Writes are atomic (temporary
file plus rename), so a crashed writer never leaves a torn checkpoint.
The sharded formats are ``utils/sharded_checkpoint.py``; the listing,
verification and removal here take both.
"""

from __future__ import annotations

import glob
import os
import pickle
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .logging import log

FORMAT_VERSION = 1


def _to_host(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _to_device(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(device)
    return tree


def atomic_save(payload: Dict[str, Any], filepath: str) -> None:
    """Pickle ``payload`` to ``filepath`` atomically."""
    directory = os.path.dirname(os.path.abspath(filepath))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, filepath)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def build_checkpoint(state, epoch: int, global_step: int,
                     hparams: Optional[Dict[str, Any]] = None,
                     callbacks: Optional[Dict[str, Any]] = None,
                     extra: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """The payload: counters, hyperparameters, callback states and (for a
    ``core.state.TrainState``) step, params, optimizer state and the base
    generator's seed, all as host values."""
    payload = {
        "format_version": FORMAT_VERSION,
        "epoch": int(epoch),
        "global_step": int(global_step),
        "hparams": dict(hparams or {}),
        "callbacks": dict(callbacks or {}),
    }
    if state is not None:
        payload["state"] = {"step": int(state.step),
                            "params": _to_host(state.params),
                            "opt_state": _to_host(state.opt.state),
                            "rng_seed": int(state.rng.initial_seed())}
        for field in ("residual", "grad_accum", "guard_ema"):
            # the compressed exchange's per-rank buffers ([n, ...] stacks)
            # and the numeric guardian's vector
            if getattr(state, field, None) is not None:
                payload["state"][field] = _to_host(getattr(state, field))
    if extra:
        payload.update(extra)
    return payload


def read_checkpoint(filepath: str) -> Dict[str, Any]:
    """Unpickle a checkpoint this package wrote (pickle runs code: read
    only files of your own runs)."""
    with open(filepath, "rb") as f:
        return pickle.load(f)


def restore_params(payload: Dict[str, Any], device=None) -> Any:
    """The checkpoint's parameter tree as tensors on ``device``."""
    return _to_device(payload["state"]["params"], device or "cpu")


def verify_checkpoint(filepath: str,
                      use_cache: bool = False) -> Tuple[bool, str]:
    """``(ok, reason)``: a sharded directory runs its digest pass (with
    ``use_cache``, a directory this process saved and nothing changed
    since is accepted without re-hashing); a file must unpickle end to
    end (a truncated pickle raises mid-load).  Never raises."""
    from . import sharded_checkpoint as sharded_lib
    if os.path.isdir(filepath):
        return sharded_lib.verify_checkpoint(filepath, use_cache=use_cache)
    if not os.path.isfile(filepath):
        return False, "missing"
    try:
        read_checkpoint(filepath)
    except Exception as e:  # torn write, disk corruption, wrong file
        return False, f"unreadable pickle: {type(e).__name__}: {e}"
    return True, "ok"


def list_checkpoints(directory: str, pattern: str = "*.ckpt") -> List[str]:
    """Every checkpoint under ``directory`` (recursive: pickle files and
    sharded directories marked complete by their meta.json), newest
    first."""
    from . import sharded_checkpoint as sharded_lib
    found = glob.glob(os.path.join(glob.escape(directory), "**", pattern),
                      recursive=True)
    found = [c for c in found if os.path.isfile(c)]
    found += [os.path.dirname(m) for m in glob.glob(
        os.path.join(glob.escape(directory), "**", sharded_lib.META_FILE),
        recursive=True)]
    return sorted(found, key=os.path.getmtime, reverse=True)


def latest_checkpoint(directory: str, pattern: str = "*.ckpt",
                      verify: bool = True) -> Optional[str]:
    """The newest checkpoint under ``directory`` that verifies (a torn
    newest one is skipped with a warning), or None."""
    for cand in list_checkpoints(directory, pattern):
        if not verify:
            return cand
        ok, why = verify_checkpoint(cand)
        if ok:
            return cand
        log.warning("skipping unverified checkpoint %s: %s", cand, why)
    return None


def remove_checkpoint(path: str) -> None:
    """Delete a checkpoint file (or a directory of one)."""
    from . import sharded_checkpoint as sharded_lib
    sharded_lib.remove_checkpoint(path)


def prune_checkpoints(directory: str, keep_last_k: int,
                      protect=(), pattern: str = "*.ckpt") -> List[str]:
    """Keep the newest ``keep_last_k`` checkpoints under ``directory`` and
    delete the rest, except ``protect`` paths and, when none of the kept
    ones verifies, the newest older one that does (the resume anchor).
    Returns the removed paths."""
    if keep_last_k is None or keep_last_k < 1:
        return []
    candidates = list_checkpoints(directory, pattern)
    protected = {os.path.abspath(p) for p in protect if p}
    doomed = [p for p in candidates[keep_last_k:]
              if os.path.abspath(p) not in protected]
    if not doomed:
        return []
    keep = set(candidates[:keep_last_k])
    # this process's own unchanged saves pass without a re-hash; only
    # checkpoints of unknown provenance pay the digest pass
    if not any(verify_checkpoint(p, use_cache=True)[0] for p in keep):
        for p in candidates[keep_last_k:]:
            if verify_checkpoint(p, use_cache=True)[0]:
                keep.add(p)
                log.warning("checkpoint retention: no checkpoint in the "
                            "keep_last_k=%d window verifies; keeping older "
                            "verified %s as the resume anchor",
                            keep_last_k, p)
                break
    removed = []
    for p in doomed:
        if p not in keep:
            remove_checkpoint(p)
            removed.append(p)
    return removed
