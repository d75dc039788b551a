"""Deterministic fault injection for the worker runtime and the step.

Port of the JAX package's ``testing/chaos.py``.  Faults are declared in
``RLA_TPU_CHAOS`` and honoured by every ``Worker`` process in its
dispatch loop (``runtime/actors.py``) and by the trainer's step, with no
timing races and no patching of runtime internals.

Syntax (comma-separated faults)::

    RLA_TPU_CHAOS=crash@rank1:step3,hang@rank0,slow@all:2.5
    RLA_TPU_CHAOS=hang@stage1:step2:once
    RLA_TPU_CHAOS=nanloss@rank0:step3,badbatch@step5

``kind@target[:qualifier...]`` where

- kind: ``crash`` (``os._exit`` with code 43), ``hang`` (freeze the
  heartbeat, then sleep for ever: the watchdog's stale-beat path),
  ``slow`` (delay the dispatch by the given seconds), ``preempt``
  (SIGTERM to the worker itself: with ``RLA_TPU_PREEMPT_GRACE_S`` in its
  env the handler turns it into a drain, without it the worker dies),
  ``lost`` (``os._exit`` with code 44 and a marker under
  ``RLA_TPU_CHAOS_NS``: every respawn of that rank dies at boot, the
  host that never comes back), ``rejoin`` (the lost host comes back on
  its Nth respawn: ``rejoin@rank1:step3`` counts boots while rank 1's
  marker exists and clears it on the third; ``ElasticRunner(
  resize_in_memory=True)`` grows the pool back through ``revive``), and
  the numeric kinds below;
- target: ``rankN`` or ``all`` (the worker layer); ``stageN`` (every
  member of MPMD stage group N, by its ``RLA_TPU_PIPELINE_STAGE``);
  ``replicaN`` (the serve tier's replica layer, counted in serve chunks
  with ``chunkK``; parsed and validated here, armed by the serve tiers
  when they are ported);
- qualifiers: ``stepN``: the Nth dispatch of the worker process's life
  (1-based; crash, hang, preempt and lost default to the first, slow to
  every one); a float: the delay of ``slow``; ``once``: at most once
  across process restarts, claimed through a token file in the
  ``RLA_TPU_CHAOS_NS`` directory.

Faults fire before the dispatched function runs and count every
dispatch, the runtime's own included (a world's rendezvous is dispatch
1 of each rank).  A malformed spec raises ``ValueError`` naming the
token; in a worker it fails the first dispatch's future.

The numeric layer (the guardian's test surface), honoured by the
trainer's step (``core/trainer.py``), steps being the 1-based global
optimizer step:

- ``nanloss`` makes the step's loss metric NaN;
- ``gradspike`` scales the gradients by 1e4 (under the compressed
  exchange only the named rank's local gradients);
- ``badbatch`` poisons the host batch feeding step K with a NaN (no
  rank: the batch is global; ``badbatch@stepK``);
- ``bitflip`` flips one exponent bit of one element of the first
  gradient leaf (the named rank's, under the compressed exchange).

A numeric fault is claimed once a fit (``claim_numeric``) through the
namespace, so the retried fit after a rewind runs the window clean
(without a namespace every fit arms it again).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ..analysis import knobs

CHAOS_ENV = "RLA_TPU_CHAOS"
CHAOS_NS_ENV = "RLA_TPU_CHAOS_NS"
STAGE_ENV = "RLA_TPU_PIPELINE_STAGE"
CHAOS_EXIT_CODE = 43
LOST_EXIT_CODE = 44
_KINDS = ("crash", "hang", "slow", "preempt", "lost", "rejoin",
          "nanloss", "gradspike", "badbatch", "bitflip")
# the replica layer's kinds: a replica is a whole process, so preempt
# and lost stay worker kinds
_REPLICA_KINDS = ("crash", "hang", "slow")
_NUMERIC_KINDS = ("nanloss", "gradspike", "badbatch", "bitflip")

LAYER_WORKER = "worker"
LAYER_REPLICA = "replica"
LAYER_NUMERIC = "numeric"


def _lost_markers(rank: int, ns_dir: Optional[str]) -> List[str]:
    """``rank``'s "host gone" marker files under the namespace."""
    if not ns_dir or not os.path.isdir(ns_dir):
        return []
    suffix = f"-r{rank}.lost"
    return [os.path.join(ns_dir, name) for name in sorted(os.listdir(ns_dir))
            if name.endswith(suffix)]


def clear_lost(rank: int, ns_dir: Optional[str] = None) -> List[str]:
    """Remove ``rank``'s "host gone" markers, so its next respawn boots
    (a host coming back); ``ns_dir`` defaults to ``RLA_TPU_CHAOS_NS``.
    Returns the removed paths."""
    ns_dir = ns_dir or knobs.get_raw(CHAOS_NS_ENV) or None
    removed = []
    for path in _lost_markers(rank, ns_dir):
        try:
            os.remove(path)
            removed.append(path)
        except OSError:
            pass
    return removed


@dataclass(frozen=True)
class ChaosFault:
    kind: str
    rank: Optional[int]  # None = all ranks
    step: Optional[int]  # None = every dispatch (slow) / the first
    delay_s: Optional[float] = None  # slow only
    once: bool = False
    # the seam that honours it: "worker" (the dispatch loop; step =
    # dispatch), "replica" (serve chunks), "numeric" (the train step)
    layer: str = LAYER_WORKER
    # 'stageN': every member of that MPMD stage group
    stage: Optional[int] = None

    def matches(self, rank: int, step: int) -> bool:
        if self.rank is not None and self.rank != rank:
            return False
        if self.step is not None:
            return step == self.step
        return True if self.kind == "slow" else step == 1

    def token(self, rank: int) -> str:
        """The per-rank claim key of ``once`` (layer-prefixed for the
        replica and numeric layers)."""
        prefix = "replica" if self.layer == LAYER_REPLICA else "rank"
        if self.stage is not None:
            tgt = f"stage{self.stage}"
        elif self.rank is None:
            tgt = "all"
        else:
            tgt = f"{prefix}{self.rank}"
        step = "any" if self.step is None else f"step{self.step}"
        tok = f"{self.kind}-{tgt}-{step}-r{rank}"
        return tok if self.layer == LAYER_WORKER else f"{self.layer}-{tok}"


def parse_chaos(spec: str) -> List[ChaosFault]:
    """Parse an ``RLA_TPU_CHAOS`` spec; ``ValueError`` naming the token
    on any malformed fault."""
    faults: List[ChaosFault] = []
    for part in (p.strip() for p in spec.split(",")):
        if not part:
            continue
        kind, at, target_q = part.partition("@")
        if not at or kind not in _KINDS:
            raise ValueError(
                f"chaos fault {part!r}: expected kind@target with kind in "
                f"{_KINDS}")
        bits = target_q.split(":")
        target = bits[0]
        layer = LAYER_NUMERIC if kind in _NUMERIC_KINDS else LAYER_WORKER
        stage: Optional[int] = None
        if kind == "badbatch" and target.startswith("step") \
                and target[4:].isdigit():
            # badbatch@stepK: the poisoned batch is global, no rank
            if bits[1:]:
                raise ValueError(
                    f"chaos fault {part!r}: badbatch@stepK takes no "
                    "qualifiers")
            if int(target[4:]) < 1:
                raise ValueError(
                    f"chaos fault {part!r}: steps are 1-based")
            faults.append(ChaosFault("badbatch", None, int(target[4:]),
                                     layer=LAYER_NUMERIC))
            continue
        if target == "all":
            rank = None
        elif target.startswith("stage") and target[5:].isdigit():
            rank = None
            stage = int(target[5:])
        elif target.startswith("rank") and target[4:].isdigit():
            rank = int(target[4:])
        elif target.startswith("replica") and target[7:].isdigit():
            rank = int(target[7:])
            layer = LAYER_REPLICA
            if kind not in _REPLICA_KINDS:
                raise ValueError(
                    f"chaos fault {part!r}: replica-layer faults support "
                    f"{_REPLICA_KINDS} only (preempt/lost are whole-"
                    "process kinds — target the worker with 'rankN')")
        else:
            raise ValueError(
                f"chaos fault {part!r}: target must be 'rankN', "
                f"'replicaN', 'stageN' or 'all', got {target!r}")
        step: Optional[int] = None
        delay: Optional[float] = None
        once = False
        for q in bits[1:]:
            if q == "once":
                once = True
            elif q.startswith("step") and q[4:].isdigit():
                if layer == LAYER_REPLICA:
                    raise ValueError(
                        f"chaos fault {part!r}: replica faults count "
                        "serve CHUNKS — use 'chunkN', not 'stepN'")
                step = int(q[4:])
                if step < 1:
                    raise ValueError(
                        f"chaos fault {part!r}: steps are 1-based")
            elif q.startswith("chunk") and q[5:].isdigit():
                if layer != LAYER_REPLICA:
                    raise ValueError(
                        f"chaos fault {part!r}: 'chunkN' only applies to "
                        "replica-layer targets ('replicaN')")
                step = int(q[5:])
                if step < 1:
                    raise ValueError(
                        f"chaos fault {part!r}: chunks are 1-based")
            else:
                try:
                    delay = float(q)
                except ValueError:
                    raise ValueError(
                        f"chaos fault {part!r}: unknown qualifier {q!r} "
                        "(expected 'stepN'/'chunkN', 'once', or a float "
                        "delay)") from None
        if kind == "slow" and delay is None:
            raise ValueError(
                f"chaos fault {part!r}: 'slow' needs a float delay "
                "qualifier (e.g. slow@all:2.5)")
        if kind != "slow" and delay is not None:
            raise ValueError(
                f"chaos fault {part!r}: only 'slow' takes a delay")
        if kind == "badbatch" and rank is not None:
            raise ValueError(
                f"chaos fault {part!r}: badbatch is rank-less (the "
                "poisoned batch reaches every replica) — use "
                "'badbatch@stepK' or 'badbatch@all:stepK'")
        if kind in _NUMERIC_KINDS and stage is not None:
            raise ValueError(
                f"chaos fault {part!r}: numeric faults target 'rankN' "
                "or 'all' (the SPMD step builders), not a pipeline "
                "stage group")
        faults.append(ChaosFault(kind, rank, step, delay, once,
                                 layer=layer, stage=stage))
    return faults


class ChaosInjector:
    """The worker side: one per worker process, consulted at every
    dispatch.  ``freeze_heartbeat`` stops the worker's beat thread, so a
    ``hang`` looks like a frozen process to the watchdog.  ``layer``
    picks the faults this injector honours; ``stage`` is the process's
    ``RLA_TPU_PIPELINE_STAGE``: a ``stageN`` fault arms only in its own
    stage group."""

    def __init__(self, faults: List[ChaosFault], rank: int,
                 freeze_heartbeat: Optional[Callable[[], None]] = None,
                 ns_dir: Optional[str] = None,
                 layer: str = LAYER_WORKER,
                 stage: Optional[int] = None):
        self.layer = layer
        self.faults = [f for f in faults if f.layer == layer
                       and (f.stage is None or f.stage == stage)]
        self.rank = rank
        self.freeze_heartbeat = freeze_heartbeat
        self.ns_dir = ns_dir
        self._step = 0
        if any(f.once or f.kind in ("lost", "rejoin")
               for f in self.faults) and not ns_dir:
            raise ValueError(
                f"chaos 'once', 'lost' and 'rejoin' faults need "
                f"{CHAOS_NS_ENV} set to a directory (the cross-restart "
                "claim store)")
        # rejoin: count boots while this rank's lost markers exist and
        # clear them at the Kth, before the death check below reads them
        for f in self.faults:
            if f.kind != "rejoin" or (f.rank is not None
                                      and f.rank != rank):
                continue
            if not _lost_markers(rank, self.ns_dir):
                continue
            boots_path = os.path.join(self.ns_dir,
                                      f.token(rank) + ".boots")
            with open(boots_path, "ab") as fh:
                fh.write(b".")
            if os.path.getsize(boots_path) >= (f.step or 1):
                clear_lost(rank, self.ns_dir)
        # a rank whose 'lost' fault fired is a gone host: every respawn
        # dies at boot, before any dispatch
        for f in self.faults:
            if (f.kind == "lost"
                    and (f.rank is None or f.rank == rank)
                    and os.path.exists(self._lost_marker(f))):
                os._exit(LOST_EXIT_CODE)

    @classmethod
    def from_env(cls, rank: int,
                 freeze_heartbeat: Optional[Callable[[], None]] = None,
                 layer: str = LAYER_WORKER) -> Optional["ChaosInjector"]:
        spec = knobs.get_str(CHAOS_ENV, "")
        if not spec:
            return None
        inj = cls(parse_chaos(spec), rank, freeze_heartbeat,
                  knobs.get_raw(CHAOS_NS_ENV) or None, layer=layer,
                  stage=knobs.get_int(STAGE_ENV, None))
        return inj if inj.faults else None

    def _lost_marker(self, fault: ChaosFault) -> str:
        return os.path.join(self.ns_dir, fault.token(self.rank) + ".lost")

    def _claim_once(self, fault: ChaosFault) -> bool:
        """Claim a once-fault across processes and restarts: the first
        to create the token file fires, every later process skips."""
        os.makedirs(self.ns_dir, exist_ok=True)
        path = os.path.join(self.ns_dir, fault.token(self.rank))
        try:
            os.close(os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            return True
        except FileExistsError:
            return False

    def on_dispatch(self) -> None:
        """Called by the dispatch loop before the shipped call runs."""
        self._step += 1
        for fault in self.faults:
            if fault.kind == "rejoin":
                continue  # a boot-time kind: its stepN counts respawns
            if not fault.matches(self.rank, self._step):
                continue
            if fault.once and not self._claim_once(fault):
                continue
            if fault.kind == "slow":
                time.sleep(fault.delay_s)
            elif fault.kind == "crash":
                os._exit(CHAOS_EXIT_CODE)
            elif fault.kind == "preempt":
                import signal
                os.kill(os.getpid(), signal.SIGTERM)
            elif fault.kind == "lost":
                # the marker first, so every respawn dies at boot
                os.makedirs(self.ns_dir, exist_ok=True)
                try:
                    os.close(os.open(self._lost_marker(fault),
                                     os.O_CREAT | os.O_WRONLY))
                except OSError:
                    pass
                os._exit(LOST_EXIT_CODE)
            elif fault.kind == "hang":
                if self.freeze_heartbeat is not None:
                    self.freeze_heartbeat()
                while True:  # wedged until the watchdog reaps it
                    time.sleep(3600)


# --------------------------------------------------------------------- #
# Numeric layer (the guardian's faults, core/trainer.py's step)          #
# --------------------------------------------------------------------- #
def numeric_faults() -> tuple:
    """The numeric faults of the ambient ``RLA_TPU_CHAOS`` (an empty
    tuple when unset)."""
    spec = knobs.get_str(CHAOS_ENV, "")
    if not spec:
        return ()
    return tuple(f for f in parse_chaos(spec)
                 if f.layer == LAYER_NUMERIC)


def claim_numeric(fault: ChaosFault, rank: int = 0) -> bool:
    """Claim a numeric fault for this fit.  With a namespace the claim
    is an atomic token across processes and restarts, so the fit retried
    after a rewind runs clean; without one every fit arms it."""
    ns_dir = knobs.get_raw(CHAOS_NS_ENV) or None
    if not ns_dir:
        return True
    os.makedirs(ns_dir, exist_ok=True)
    path = os.path.join(ns_dir, "numeric-" + fault.token(rank))
    try:
        os.close(os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        return True
    except FileExistsError:
        return False


def poison_batch(batch):
    """``badbatch``'s poison: NaN into the first element of every float
    leaf (copies: the loader's arrays stay clean); integer leaves pass
    through."""
    import numpy as np
    import torch

    def rec(x):
        if isinstance(x, dict):
            return {k: rec(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(rec(v) for v in x)
        if isinstance(x, list):
            return [rec(v) for v in x]
        if isinstance(x, torch.Tensor):
            if x.is_floating_point() and x.numel():
                x = x.clone()
                x.view(-1)[0] = float("nan")
            return x
        arr = np.asarray(x)
        if arr.dtype.kind == "f" and arr.size:
            arr = np.array(arr, copy=True)
            arr.reshape(-1)[0] = np.nan
            return arr
        return x

    return rec(batch)


def apply_numeric(fault: ChaosFault, step: int, metrics: Dict[str, Any],
                  grads: List[Any], rank: Optional[int] = None) -> None:
    """Apply one numeric fault in the eager step, in place (the port's
    ``apply_traced_numeric``).  ``step`` is the 0-based step about to
    complete (the fault's ``stepN`` is 1-based); ``grads`` the step's
    gradient list; ``rank`` this rank's replica index when the grads are
    its local ones (the compressed exchange: a ranked gradspike or
    bitflip then hits only that replica), None when they are the global
    mean.  Nothing happens off the fault's step."""
    import torch

    if step != (fault.step or 1) - 1:
        return
    if fault.kind == "nanloss":
        loss = metrics.get("train_loss")
        if loss is not None:
            metrics["train_loss"] = torch.full_like(
                torch.as_tensor(loss), float("nan"))
        return
    if not grads or fault.kind not in ("gradspike", "bitflip"):
        return  # badbatch is a host fault
    if rank is not None and fault.rank is not None and fault.rank != rank:
        return
    if rank is not None and fault.rank is None and fault.kind == "bitflip" \
            and rank != 0:
        return  # an unranked flip hits replica 0's row, as in JAX
    with torch.no_grad():
        if fault.kind == "gradspike":
            for i, g in enumerate(grads):
                grads[i] = (g.float() * 1e4).to(g.dtype)
            return
        # one exponent bit (1 << 27: +16 on the biased exponent, x 2**16,
        # surviving a bf16 round trip) of the first leaf's first element
        g = grads[0]
        bits = g.detach().float().reshape(-1).clone().view(torch.int32)
        bits[0] = bits[0] ^ (1 << 27)
        grads[0] = bits.view(torch.float32).reshape(g.shape).to(g.dtype)
