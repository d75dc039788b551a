"""Cross-stage transport: the mailbox of ObjectRefs, the wire format of
activations, and the slot barrier.

Port of the JAX package's ``parallel/mpmd/handoff.py``.  The payloads
(activations, activation-grads, lane gradients) live in
``runtime/object_store.py`` shm segments, one host copy each; what moves
between stage processes here is the small picklable
:class:`~..runtime.object_store.ObjectRef`, through a filesystem
mailbox: one file per (step, kind, edge, microbatch, lane, fsdp rank),
written atomically (tmp + ``os.replace``) so a reader never sees a torn
handle.

The store holds host data only, and numpy has no bfloat16, so every send
goes through :func:`to_wire` (a tensor on the card comes to the host; a
bfloat16 tensor travels as its ``int16`` words beside a dtype tag) and
every receive through :func:`from_wire` (back onto the stage's device).
A receive always copies: on the CPU the stage never holds a view into a
mapped segment (read-only, and valid only until ``release``), so its
inputs may be written and may become autograd leaves.

:func:`timed_call` is the deliberate slot barrier: on the card it
synchronises the device after the slot's work and before it stops the
clock, so a slot's time is its device time, not its launch time.
"""

from __future__ import annotations

import json
import os
import pickle
import time
import warnings
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ...analysis import knobs
from ...runtime.object_store import ObjectRef

#: activations flow down this kind, activation-grads flow back up, and
#: the lane-peer gradient exchange (stage groups wider than one worker)
#: uses a third kind so the edge namespace never collides.
KIND_ACT = "act"
KIND_GRAD = "grad"
KIND_LANE_GRAD = "lgrad"

DEFAULT_TIMEOUT_S = 60.0
_POLL_S = 0.002

# the key of a wire leaf that carries a dtype numpy lacks
_WIRE_DTYPE = "__rla_wire_dtype__"


class PipelineHandoffTimeout(RuntimeError):
    """A stage waited past its deadline for a neighbor's handoff.

    Carries a machine-readable diagnosis embedded in the message, so it
    survives the actor pipe as ``(type, message)`` and the driver can
    still name the *other* stage as the suspect: a timeout is evidence
    about the sender, not the waiter.
    """

    _MARKER = "| handoff="

    def __init__(self, message: str,
                 diagnosis: Optional[dict] = None):
        super().__init__(message)
        self.diagnosis = diagnosis or {}

    @classmethod
    def for_wait(cls, *, stage: int, kind: str, src: int, microbatch: int,
                 lane: int, step: int,
                 timeout_s: float) -> "PipelineHandoffTimeout":
        diagnosis = {"stage": stage, "kind": kind, "src": src,
                     "microbatch": microbatch, "lane": lane, "step": step,
                     "timeout_s": timeout_s}
        return cls(
            f"stage {stage} timed out after {timeout_s:.1f}s waiting for "
            f"{kind} of microbatch {microbatch} (lane {lane}) from stage "
            f"{src} at step {step} {cls._MARKER}{json.dumps(diagnosis)}",
            diagnosis)

    @classmethod
    def from_message(cls, message: str) -> "PipelineHandoffTimeout":
        """Rebuild driver-side from the worker's message, diagnosis
        intact."""
        diagnosis: Optional[dict] = None
        if cls._MARKER in message:
            try:
                diagnosis = json.loads(
                    message.rsplit(cls._MARKER, 1)[1].strip())
            except (ValueError, IndexError):
                diagnosis = None
        return cls(message, diagnosis)


class Mailbox:
    """Atomic single-file-per-handoff ref exchange under one directory.

    All stage processes of one PipelineRunner share ``root``.  File
    names carry the full edge identity::

        s{step:06d}.{kind}.{src}to{dst}.mb{mb}.l{lane}.f{fsdp_rank}.ref

    so a late reader can never match a stale step's handoff, and an
    ``ls`` of the mailbox is the in-flight edge set.  ``fsdp_rank`` is
    the member's place in its stage's fsdp group: member j of a stage
    trades its rows only with member j of the next.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, step: int, kind: str, src: int, dst: int,
              microbatch: int, lane: int, fsdp_rank: int) -> str:
        return os.path.join(
            self.root, f"s{step:06d}.{kind}.{src}to{dst}.mb{microbatch}"
                       f".l{lane}.f{fsdp_rank}.ref")

    def send(self, ref: ObjectRef, *, step: int, kind: str, src: int,
             dst: int, microbatch: int, lane: int = 0,
             fsdp_rank: int = 0) -> None:
        path = self._path(step, kind, src, dst, microbatch, lane, fsdp_rank)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(ref, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def recv(self, *, step: int, kind: str, src: int, dst: int,
             microbatch: int, lane: int = 0, fsdp_rank: int = 0,
             timeout_s: Optional[float] = None) -> ObjectRef:
        """Block until the handoff file lands; typed timeout past the
        deadline (default from ``RLA_TPU_PIPELINE_HANDOFF_TIMEOUT_S``)."""
        if timeout_s is None:
            timeout_s = knobs.get_float("RLA_TPU_PIPELINE_HANDOFF_TIMEOUT_S",
                                        DEFAULT_TIMEOUT_S)
        path = self._path(step, kind, src, dst, microbatch, lane, fsdp_rank)
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                with open(path, "rb") as f:
                    return pickle.load(f)
            except FileNotFoundError:
                pass
            except (EOFError, pickle.UnpicklingError):
                pass  # a crashed writer's .tmp never matches this path
            if time.monotonic() >= deadline:
                raise PipelineHandoffTimeout.for_wait(
                    stage=dst, kind=kind, src=src, microbatch=microbatch,
                    lane=lane, step=step, timeout_s=timeout_s)
            time.sleep(_POLL_S)

    def clear(self) -> int:
        """Drop every pending handoff (the replay boundary: stale refs
        from the failed attempt must not satisfy the re-run's recvs)."""
        dropped = 0
        try:
            entries = os.listdir(self.root)
        except FileNotFoundError:
            return 0
        for entry in entries:
            if entry.endswith(".ref") or ".ref.tmp." in entry:
                try:
                    os.unlink(os.path.join(self.root, entry))
                    dropped += 1
                except FileNotFoundError:
                    pass
        return dropped


# --------------------------------------------------------------------- #
# The wire format of the object store                                    #
# --------------------------------------------------------------------- #
def _tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    if isinstance(tree, dict):
        if _WIRE_DTYPE in tree:
            return fn(tree)
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def to_wire(tree: Any) -> Any:
    """A tree the object store takes: every tensor detached on the host;
    a bfloat16 tensor as ``{tag: "bfloat16", "words": <int16 tensor>}``
    (the same bits).  Other leaves pass as they are."""
    def leaf(x: Any) -> Any:
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return {_WIRE_DTYPE: "bfloat16",
                    "words": x.contiguous().view(torch.int16).cpu()}
        return x.cpu()
    return _tree_map(leaf, tree)


def from_wire(tree: Any, device: Any) -> Any:
    """The inverse of :func:`to_wire`: every array leaf (numpy, or a
    tensor) as a tensor on ``device`` that owns its memory, in the dtype
    it was sent in (a tagged leaf viewed back as its own)."""
    device = torch.device(device)

    def tensor(a: Any) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device, copy=True)
        if device.type == "cpu":
            return torch.from_numpy(np.array(a))
        with warnings.catch_warnings():
            # a read-only shm view: .to() below copies it to the card
            warnings.simplefilter("ignore", UserWarning)
            return torch.from_numpy(np.asarray(a)).to(device)

    def leaf(x: Any) -> Any:
        if isinstance(x, dict):       # a tagged leaf
            return tensor(x["words"]).view(getattr(torch, x[_WIRE_DTYPE]))
        if isinstance(x, (np.ndarray, torch.Tensor)):
            return tensor(x)
        return x
    return _tree_map(leaf, tree)


# --------------------------------------------------------------------- #
# Slot barrier and host conversion                                       #
# --------------------------------------------------------------------- #
def timed_call(fn: Callable[..., Any], *args: Any,
               device: Any = None) -> Tuple[Any, float]:
    """Run one compute slot to completion and price it: ``(result,
    seconds)``.  On a CUDA ``device`` the device is synchronised before
    the clock stops, so the seconds are the slot's device time."""
    t0 = time.perf_counter()
    out = fn(*args)
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def host_scalars(tree: Any) -> Any:
    """Tensors and numbers of a tree as Python floats (None stays None):
    the step summary that crosses the actor pipe."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: host_scalars(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_scalars(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return float(tree.detach().float().cpu())
    return float(tree)


def split_microbatches(batch: Any, num_microbatches: int) -> List[Any]:
    """Split every leaf of a batch (numpy arrays, CPU tensors) along dim
    0 into M equal microbatches, as ``np.split`` does (an indivisible
    size raises).  Tensors stay tensors (views); other leaves become
    numpy arrays."""
    m_total = num_microbatches

    def split(tree: Any) -> List[Any]:
        if isinstance(tree, dict):
            per = {k: split(v) for k, v in tree.items()}
            return [{k: p[m] for k, p in per.items()} for m in range(m_total)]
        if isinstance(tree, (list, tuple)):
            per_leaf = [split(v) for v in tree]
            return [type(tree)(p[m] for p in per_leaf)
                    for m in range(m_total)]
        if isinstance(tree, torch.Tensor):
            if tree.shape[0] % m_total:
                raise ValueError("array split does not result in an equal "
                                 "division")
            return list(torch.split(tree, tree.shape[0] // m_total, dim=0))
        return np.split(np.asarray(tree), m_total, axis=0)

    return split(batch)
