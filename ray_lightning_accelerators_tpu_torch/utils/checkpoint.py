"""Checkpoint IO: atomic single-file checkpoints of the full trainer state.

Port of the JAX package's ``utils/checkpoint.py`` for its pickle format.
The port writes its own payload: every tensor is copied to the host as a
numpy array (the parameter tree with the JAX leaf names, the AdamW
moments or the SGD momentum trace and the parameter EMA in the
optimizer's leaf order), so a checkpoint loads without a card.  It does
not read the JAX package's checkpoints, and the sharded formats come
with the multi-GPU slice.  Writes are atomic (temporary file
plus rename), so a crashed writer never leaves a torn checkpoint.
"""

from __future__ import annotations

import glob
import os
import pickle
import shutil
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
    if extra:
        payload.update(extra)
    return payload


def read_checkpoint(filepath: str) -> Dict[str, Any]:
    """Unpickle a checkpoint this package wrote (pickle runs code: read
    only files of your own runs)."""
    with open(filepath, "rb") as f:
        return pickle.load(f)


def _copy_into(dst: Any, src: Any, what: str) -> None:
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"checkpoint {what}: keys {sorted(src)} do not "
                             f"match {sorted(dst)}")
        for k in dst:
            _copy_into(dst[k], src[k], f"{what}.{k}")
    elif isinstance(dst, list):
        if len(dst) != len(src):
            raise ValueError(f"checkpoint {what}: {len(src)} entries, "
                             f"expected {len(dst)}")
        for i, (d, s) in enumerate(zip(dst, src)):
            _copy_into(d, s, f"{what}[{i}]")
    else:
        if tuple(dst.shape) != tuple(np.shape(src)):
            raise ValueError(f"checkpoint {what}: shape {np.shape(src)}, "
                             f"expected {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(torch.from_numpy(np.asarray(src)))


def restore_state(payload: Dict[str, Any], state):
    """Copy a checkpoint's state into a ``TrainState`` of the same model
    (in place: the parameter leaves stay the optimizer's); returns it."""
    saved = payload["state"]
    _copy_into(state.params, saved["params"], "params")
    opt_state, saved_opt = state.opt.state, saved["opt_state"]
    key = state.opt.tx.state_key      # "adam" or "sgd"
    if key not in saved_opt:
        raise ValueError(f"checkpoint opt_state holds {sorted(saved_opt)}, "
                         f"not the {key!r} state this optimizer needs")
    for name, value in opt_state[key].items():
        if name == "count":
            opt_state[key]["count"] = int(saved_opt[key]["count"])
        else:                         # moments / momentum trace
            _copy_into(value, saved_opt[key][name], name)
    if "ema" in opt_state:
        # saved without an EMA: the shadow starts at the restored params
        _copy_into(opt_state["ema"], saved_opt.get("ema", _to_host(
            state.opt.params)), "ema")
    if "acc" in opt_state:
        if "acc" in saved_opt:
            _copy_into(opt_state["acc"], saved_opt["acc"], "acc")
            opt_state["mini_step"] = int(saved_opt["mini_step"])
        else:  # saved without accumulation: an empty window
            for acc in opt_state["acc"]:
                acc.zero_()
            opt_state["mini_step"] = 0
    state.step = int(saved["step"])
    state.rng.manual_seed(int(saved["rng_seed"]))
    return state


def restore_params(payload: Dict[str, Any], device=None) -> Any:
    """The checkpoint's parameter tree as tensors on ``device``."""
    return _to_device(payload["state"]["params"], device or "cpu")


def verify_checkpoint(filepath: str) -> Tuple[bool, str]:
    """``(ok, reason)``: the file must unpickle end to end (a truncated
    pickle raises mid-load).  Never raises."""
    if not os.path.isfile(filepath):
        return False, "missing"
    try:
        read_checkpoint(filepath)
    except Exception as e:  # torn write, disk corruption, wrong file
        return False, f"unreadable pickle: {type(e).__name__}: {e}"
    return True, "ok"


def list_checkpoints(directory: str, pattern: str = "*.ckpt") -> List[str]:
    """Every checkpoint file under ``directory`` (recursive), newest first."""
    found = glob.glob(os.path.join(glob.escape(directory), "**", pattern),
                      recursive=True)
    return sorted((c for c in found if os.path.isfile(c)),
                  key=os.path.getmtime, reverse=True)


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
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    elif os.path.exists(path):
        os.unlink(path)


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
    if not any(verify_checkpoint(p)[0] for p in keep):
        for p in candidates[keep_last_k:]:
            if verify_checkpoint(p)[0]:
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
