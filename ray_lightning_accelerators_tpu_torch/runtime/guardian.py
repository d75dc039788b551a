"""Numeric anomaly guardian: in-step detection, blame, quarantine.

Port of the JAX package's ``runtime/guardian.py``.  A NaN loss, an
exploding gradient norm or a corrupted activation is invisible to the
process-level fault handling; this module catches it in three layers:

- **Detection (on the device, no extra syncs)**: every guarded train
  step folds its health into a small f32 vector, ``TrainState.guard_ema``
  (``GUARD_WIDTH`` wide), with ``update()``: finiteness of the loss and
  of the global gradient norm, a gradient-norm spike against an EMA
  envelope, the update / parameter norm ratio, and, where every rank's
  local gradients are at hand (the compressed exchange), a per-rank
  badness vector whose divergence names a suspect rank.  The packed row
  rides the metrics (``metrics["guard"]``) and is read with the readback
  the trainer does anyway; ``update`` is elementwise tensor work on
  scalars: no ``.item()``, no host sync.
- **Blame (host, cold path)**: on a trip ``Guardian.check`` classifies
  before anyone acts.  Per-rank divergence: a nondeterministic hardware
  fault (suspected SDC) with the rank named; non-finite values in the
  recorded batch, or a plain replay (no compressed exchange, no int8
  matmuls) that reproduces: poisoned data; a trip that reproduces only
  through the compressed exchange: exchange-induced; nothing
  reproduces: suspected SDC.  Over a world of ranks each rank holds only
  its rows, so the two pieces of data evidence are OR-ed over the ranks
  (the ``any_fn`` the trainer passes) before the verdict, and every rank
  reaches the same one.  The verdict is a typed ``NumericAnomaly`` with
  the step, the batch and the blame.
- **Quarantine**: a data-blamed (epoch, batch) window goes into an
  atomic JSON ledger under ``<root>/guardian/``; a later fit on the same
  root skips it (``skip_set``), and ``ModelCheckpoint`` keeps the rewind
  anchor while it is pinned (``protected_paths``).

The serve engine raises ``NumericAnomaly`` into a request whose decode
logits came back non-finite, and an MPMD pipeline stage raises it naming
itself (``stage=``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..analysis import knobs
from ..telemetry import recorder as telemetry
from ..utils.logging import log

# --------------------------------------------------------------------- #
# Guard vector layout                                                    #
# --------------------------------------------------------------------- #
I_EMA = 0           # EMA of the global grad norm (healthy steps only)
I_COUNT = 1         # healthy steps folded into the EMA (warmup gate)
I_TRIPPED = 2       # sticky 0/1: any flag fired since the last reset
I_TRIP_STEP = 3     # 0-based TrainState.step of the FIRST trip (-1)
I_FLAG_LOSS = 4     # first-trip flag: loss non-finite
I_FLAG_GRAD = 5     # first-trip flag: global grad norm non-finite
I_FLAG_SPIKE = 6    # first-trip flag: grad norm > spike_factor * EMA
I_FLAG_UPDATE = 7   # first-trip flag: update/param norm ratio too large
I_SUSPECT = 8       # first-trip suspect replica index, -1 = no single rank
I_NBAD = 9          # first-trip count of bad replicas (0 = no rank info)
GUARD_WIDTH = 10

# metrics["guard"] = cat(guard_ema, [grad_norm, update_ratio]): the two
# live diagnostics ride along for the postmortem
METRIC_WIDTH = GUARD_WIDTH + 2

BLAME_DATA = "data"          # poisoned batch: quarantine the window
BLAME_EXCHANGE = "exchange"  # compressed-exchange overflow: rewind only
BLAME_SDC = "sdc"            # nondeterministic / rank-divergent
BLAME_UNKNOWN = "unknown"


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Guardian tuning; ``Trainer(guard="auto")`` builds it from the
    guard knobs (``from_env``) and turns the guardian off when
    ``RLA_TPU_GUARD`` is false."""

    spike_factor: float = 10.0     # trip when gnorm > factor * EMA
    spike_floor: float = 1e-3      # gnorm below this never counts as a
    #   spike: a converged model's EMA decays toward 0 and the relative
    #   check would otherwise trip on numerically-zero jitter
    ema_decay: float = 0.9         # grad-norm EMA decay (healthy steps)
    warmup_steps: int = 20         # healthy steps before spike/update arm
    update_ratio_max: float = 0.5  # trip when |dparams|/|params| exceeds
    max_rewinds: int = 2           # rewind budget

    @classmethod
    def from_env(cls) -> Optional["GuardConfig"]:
        if not knobs.get_bool("RLA_TPU_GUARD", True):
            return None
        return cls(
            spike_factor=knobs.get_float("RLA_TPU_GUARD_SPIKE_FACTOR", 10.0),
            spike_floor=knobs.get_float("RLA_TPU_GUARD_SPIKE_FLOOR", 1e-3),
            ema_decay=knobs.get_float("RLA_TPU_GUARD_EMA_DECAY", 0.9),
            warmup_steps=knobs.get_int("RLA_TPU_GUARD_WARMUP_STEPS", 20),
            update_ratio_max=knobs.get_float(
                "RLA_TPU_GUARD_UPDATE_RATIO_MAX", 0.5),
            max_rewinds=knobs.get_int("RLA_TPU_GUARD_MAX_REWINDS", 2),
        )


# --------------------------------------------------------------------- #
# Device half: runs inside the train step                                #
# --------------------------------------------------------------------- #
def fresh_state(device: Any = "cpu") -> torch.Tensor:
    """A new guard vector (f32 ``[GUARD_WIDTH]`` on ``device``)."""
    g = torch.zeros((GUARD_WIDTH,), dtype=torch.float32, device=device)
    g[I_TRIP_STEP] = -1.0
    g[I_SUSPECT] = -1.0
    return g


def local_stats(grads: List[torch.Tensor]) -> torch.Tensor:
    """``[sum of the finite squares, 1 if every element is finite]`` of
    one replica's local gradients (f32, on their device): what each rank
    contributes to ``replica_bad``."""
    dev = grads[0].device
    sq = torch.zeros((), dtype=torch.float32, device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    for g in grads:
        flat = g.detach().reshape(-1).to(torch.float32)
        ok = torch.isfinite(flat)
        sq = sq + torch.where(ok, flat * flat, 0.0).sum()
        finite = finite & ok.all()
    return torch.stack([sq, finite.to(torch.float32)])


def replica_bad(stats: torch.Tensor, spike_factor: float) -> torch.Tensor:
    """Per-replica badness from ``[n, 2]`` replica statistics
    (``local_stats`` of each): non-finite local gradients, or a local norm
    past ``spike_factor`` times the replica median.  Returns f32 ``[n]``;
    divergence (some but not all bad) is the SDC signature: a poisoned
    global batch trips every replica at once."""
    norms = torch.sqrt(stats[:, 0])
    finite = stats[:, 1] > 0
    # the mean of the two middle values for an even count, as jnp.median
    med = torch.quantile(norms, 0.5)
    bad = (~finite) | (norms > spike_factor * (med + 1e-12))
    return bad.to(torch.float32)


def per_replica_bad(stacked_local: Any, spike_factor: float
                    ) -> Optional[torch.Tensor]:
    """``replica_bad`` of a replica-stacked local-gradient tree
    (``[n_replicas, ...]`` leaves, nested dicts / lists of tensors)."""
    leaves = list(_tree_leaves(stacked_local))
    if not leaves:
        return None
    n = leaves[0].shape[0]
    stats = torch.stack([local_stats([leaf[i] for leaf in leaves])
                         for i in range(n)])
    return replica_bad(stats, spike_factor)


def update(cfg: GuardConfig, guard: torch.Tensor, step: Any, loss: Any,
           gnorm: Any, ratio: Any, rank_bad: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One guard-state transition.  Returns ``(new_guard, guard_metric)``:
    the carried f32 ``[GUARD_WIDTH]`` vector and the f32
    ``[METRIC_WIDTH]`` row packed into ``metrics["guard"]``.  Elementwise
    work on scalars on ``guard``'s device: no collectives, no host reads
    (a python number becomes a fill there, never a copy from the host,
    which would sync a card)."""
    dev = guard.device

    def f32(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=torch.float32)
        return torch.full((), float(x), dtype=torch.float32, device=dev)

    with torch.no_grad():
        x = torch.stack([f32(loss), f32(gnorm), f32(ratio)])
        gnorm, ratio = x[1], x[2]
        bad = ~torch.isfinite(x)                 # loss, gnorm, ratio
        ema, count, tripped = guard[:I_TRIP_STEP].unbind()
        warm = count >= cfg.warmup_steps
        # gnorm past both the floor and factor x the EMA envelope
        f_spike = warm & ~bad[1] & (gnorm > torch.clamp_min(
            cfg.spike_factor * (ema + 1e-12), cfg.spike_floor))
        f_update = warm & (bad[2] | (ratio > cfg.update_ratio_max))
        flags = torch.stack([bad[0], bad[1], f_spike, f_update])
        unhealthy = flags.any()

        if rank_bad is not None:
            rank_bad = f32(rank_bad)
            n_bad = rank_bad.sum()
            lone = (n_bad > 0) & (n_bad < rank_bad.shape[0])
            suspect = torch.where(lone, torch.argmax(rank_bad).to(
                torch.float32), -1.0)
            tail = torch.stack([suspect, n_bad])
        else:
            tail = torch.full((2,), -1.0, dtype=torch.float32, device=dev)
            tail[1] = 0.0                        # no suspect, no rank info

        healthy = ~unhealthy
        new_ema = torch.where(healthy,
                              torch.where(count > 0,
                                          cfg.ema_decay * ema
                                          + (1.0 - cfg.ema_decay) * gnorm,
                                          gnorm),
                              ema)
        # the FIRST trip freezes the postmortem fields (I_TRIP_STEP ..
        # I_NBAD); later steps keep the sticky bit but never overwrite the
        # evidence
        first = unhealthy & (tripped == 0.0)
        evidence = torch.cat([f32(step)[None], flags.to(torch.float32),
                              tail])
        unhealthy = unhealthy.to(torch.float32)
        new_g = torch.cat([
            torch.stack([new_ema, count + (1.0 - unhealthy),
                         torch.maximum(tripped, unhealthy)]),
            torch.where(first, evidence, guard[I_TRIP_STEP:]),
        ])
        metric = torch.cat([new_g, x[1:]])
    return new_g, metric


# --------------------------------------------------------------------- #
# Typed anomaly                                                          #
# --------------------------------------------------------------------- #
class NumericAnomaly(RuntimeError):
    """A guarded step tripped (or a serve decode produced non-finite
    logits, or a pipeline stage's loss or norm is not finite).  Carries
    the blame verdict so retry layers can branch, with the structured
    postmortem embedded in the message after ``_MARKER``."""

    _MARKER = "| anomaly="

    def __init__(self, message: str, step: Optional[int] = None,
                 blame: str = BLAME_UNKNOWN,
                 suspect_rank: Optional[int] = None,
                 epoch: Optional[int] = None,
                 batch_idx: Optional[int] = None,
                 stage: Optional[int] = None,
                 diagnosis: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.step = step
        self.blame = blame
        self.suspect_rank = suspect_rank
        self.epoch = epoch
        self.batch_idx = batch_idx
        self.stage = stage
        self.diagnosis = dict(diagnosis or {})

    @classmethod
    def for_trip(cls, step: int, blame: str,
                 flags: Optional[Dict[str, Any]] = None,
                 suspect_rank: Optional[int] = None,
                 epoch: Optional[int] = None,
                 batch_idx: Optional[int] = None,
                 stage: Optional[int] = None,
                 detail: str = "") -> "NumericAnomaly":
        diagnosis: Dict[str, Any] = {
            "step": step, "blame": blame, "flags": dict(flags or {}),
        }
        if suspect_rank is not None:
            diagnosis["suspect_rank"] = suspect_rank
        if epoch is not None:
            diagnosis["epoch"] = epoch
        if batch_idx is not None:
            diagnosis["batch_idx"] = batch_idx
        if stage is not None:
            diagnosis["stage"] = stage
        where = f"stage {stage} " if stage is not None else ""
        msg = (f"numeric anomaly at {where}step {step} (blame={blame})"
               f"{': ' + detail if detail else ''} "
               f"{cls._MARKER}"
               f"{json.dumps(diagnosis, sort_keys=True, default=str)}")
        return cls(msg, step=step, blame=blame, suspect_rank=suspect_rank,
                   epoch=epoch, batch_idx=batch_idx, stage=stage,
                   diagnosis=diagnosis)

    @classmethod
    def from_message(cls, message: str) -> "NumericAnomaly":
        """Rebuild from a message that crossed a process boundary as text,
        recovering the embedded postmortem (tolerant of truncation)."""
        diagnosis: Dict[str, Any] = {}
        i = message.find(cls._MARKER)
        if i >= 0:
            try:
                diagnosis = json.loads(message[i + len(cls._MARKER):])
            except ValueError:
                pass
        return cls(message,
                   step=diagnosis.get("step"),
                   blame=diagnosis.get("blame", BLAME_UNKNOWN),
                   suspect_rank=diagnosis.get("suspect_rank"),
                   epoch=diagnosis.get("epoch"),
                   batch_idx=diagnosis.get("batch_idx"),
                   stage=diagnosis.get("stage"),
                   diagnosis=diagnosis)


# --------------------------------------------------------------------- #
# Quarantine ledger (atomic JSON under <root>/guardian/)                 #
# --------------------------------------------------------------------- #
def _quarantine_path(root_dir: str) -> str:
    return os.path.join(root_dir, "guardian", "quarantine.json")


def load_quarantine(root_dir: str) -> Dict[str, Any]:
    path = _quarantine_path(root_dir)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
        if isinstance(doc, dict) and isinstance(doc.get("entries"), list):
            return doc
    except (OSError, ValueError):
        pass
    return {"entries": [], "anchor": None}


def _write_quarantine(root_dir: str, doc: Dict[str, Any]) -> None:
    path = _quarantine_path(root_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=".quarantine-", suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, sort_keys=True, indent=1)
        os.replace(tmp, path)  # atomic: a crashed writer never tears it
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def add_quarantine(root_dir: str, epoch: int, batch_idx: int, step: int,
                   anchor: Optional[str] = None) -> Dict[str, Any]:
    """Append one blamed (epoch, batch_idx) window and pin the rewind
    anchor (the checkpoint pruning must keep alive while the quarantine
    is active)."""
    doc = load_quarantine(root_dir)
    entry = {"epoch": int(epoch), "batch_idx": int(batch_idx),
             "step": int(step)}
    if entry not in doc["entries"]:
        doc["entries"].append(entry)
    if anchor:
        doc["anchor"] = anchor
    _write_quarantine(root_dir, doc)
    return doc


def release_anchor(root_dir: str) -> None:
    """Drop the prune protection once a fit ran clean past the
    quarantined window.  The skip entries stay (the data is still bad);
    only the pin goes."""
    doc = load_quarantine(root_dir)
    if doc.get("anchor"):
        doc["anchor"] = None
        _write_quarantine(root_dir, doc)


def skip_set(root_dir: str, epoch: int) -> Set[int]:
    """Batch indices quarantined for ``epoch``: a pure function of the
    ledger, so every rank and every restart computes the same set."""
    return {int(e["batch_idx"]) for e in load_quarantine(root_dir)["entries"]
            if int(e["epoch"]) == int(epoch)}


def protected_paths(dirpath: str) -> List[str]:
    """Checkpoint paths pruning must keep: the active rewind anchor, if
    a quarantine ledger lives at ``dirpath`` or one directory up (the
    checkpoint dir is usually ``<root>/`` itself or
    ``<root>/checkpoints``)."""
    out: List[str] = []
    for root in (dirpath, os.path.dirname(os.path.abspath(dirpath))):
        anchor = load_quarantine(root).get("anchor")
        if anchor:
            out.append(anchor)
    return out


# --------------------------------------------------------------------- #
# Host half: trip handling, blame, quarantine                            #
# --------------------------------------------------------------------- #
def _no_ranks(flag: bool) -> bool:
    return flag


class Guardian:
    """The trainer's companion to the guard vector.  Remembers the last
    few batches (``note_step``), and on a tripped guard row classifies
    blame, writes the quarantine ledger (``writer`` only: rank 0 of a
    world), emits the flight-recorder events, and raises the typed
    ``NumericAnomaly``."""

    RING = 8  # batches of lookback; trips surface within one readback

    def __init__(self, cfg: GuardConfig, root_dir: str, writer: bool = True):
        self.cfg = cfg
        self.root_dir = root_dir
        self.writer = writer
        self._ring: deque = deque(maxlen=self.RING)

    # -- bookkeeping ---------------------------------------------------- #
    def note_step(self, step: int, epoch: int, batch_idx: int,
                  kind: str, payload: Any) -> None:
        """Record what the step about to run at ``step`` consumes.
        References only: no device work, no copies."""
        self._ring.append((int(step), int(epoch), int(batch_idx), kind,
                           payload))

    def _lookup(self, step: int):
        for rec in reversed(self._ring):
            if rec[0] == step:
                return rec
        return None

    def skip_set(self, epoch: int) -> Set[int]:
        return skip_set(self.root_dir, epoch)

    def has_quarantine(self) -> bool:
        return bool(load_quarantine(self.root_dir)["entries"])

    def release_anchor(self) -> None:
        if self.writer:
            release_anchor(self.root_dir)

    # -- blame ---------------------------------------------------------- #
    @staticmethod
    def _batch_nonfinite(payload: Any) -> bool:
        try:
            for leaf in _tree_leaves(payload):
                if isinstance(leaf, torch.Tensor):
                    if leaf.is_floating_point() and \
                            not bool(torch.isfinite(leaf).all()):
                        return True
                    continue
                arr = np.asarray(leaf)
                if arr.dtype.kind == "f" and not np.all(np.isfinite(arr)):
                    return True
        except Exception:
            return False
        return False

    def classify(self, flags: Dict[str, Any], suspect_rank: int,
                 n_bad: int, entry: Optional[Tuple],
                 replay: Optional[Callable[[Any], Dict[str, bool]]],
                 compression_active: bool,
                 any_fn: Callable[[bool], bool] = _no_ranks
                 ) -> Tuple[str, Optional[int]]:
        """The blame cascade.  Cheap evidence first, the replay last:

        1. rank divergence (some but not all replicas bad): SDC, named;
        2. non-finite floats in the recorded batch: data;
        3. a plain replay (compression and int8 off) reproduces: data;
        4. reproducible only through the compressed exchange: exchange;
        5. nothing reproduces: nondeterministic, suspected SDC.

        ``any_fn`` ORs one rank's evidence over the world (every rank
        calls it at the same points: the cascade is the same on each)."""
        if n_bad > 0 and suspect_rank >= 0:
            return BLAME_SDC, suspect_rank
        payload = entry[4] if entry is not None else None
        kind = entry[3] if entry is not None else None
        usable = kind == "host" and payload is not None
        if any_fn(usable and self._batch_nonfinite(payload)):
            return BLAME_DATA, None
        if replay is not None and usable:
            try:
                plain = replay(payload)
            except Exception as e:  # replay must never mask the trip
                log.warning("guardian: blame replay failed (%r)", e)
                plain = None
            if any_fn(plain is None):
                return BLAME_UNKNOWN, None
            if any_fn(bool(plain.get("loss_nonfinite")
                           or plain.get("grad_nonfinite"))):
                return BLAME_DATA, None
            if compression_active and (flags.get("grad_nonfinite") or
                                       flags.get("spike")):
                return BLAME_EXCHANGE, None
            return BLAME_SDC, None
        return BLAME_UNKNOWN, None

    # -- trip ----------------------------------------------------------- #
    def check(self, guard_host: Any, *,
              replay: Optional[Callable[[Any], Dict[str, bool]]] = None,
              compression_active: bool = False,
              any_fn: Callable[[bool], bool] = _no_ranks) -> None:
        """Inspect one host guard row (``metrics["guard"]`` after a
        readback).  No-op while healthy; on a sticky trip: blame ->
        quarantine (data blame) -> telemetry -> raise
        ``NumericAnomaly``."""
        if guard_host is None:
            return
        g = np.asarray(guard_host, np.float32).reshape(-1)
        if g.shape[0] < GUARD_WIDTH or g[I_TRIPPED] == 0.0:
            return
        step = int(g[I_TRIP_STEP])
        flags = {
            "loss_nonfinite": bool(g[I_FLAG_LOSS]),
            "grad_nonfinite": bool(g[I_FLAG_GRAD]),
            "spike": bool(g[I_FLAG_SPIKE]),
            "update_ratio": bool(g[I_FLAG_UPDATE]),
        }
        if g.shape[0] >= METRIC_WIDTH:
            flags["grad_norm"] = float(g[GUARD_WIDTH])
            flags["update_ratio_value"] = float(g[GUARD_WIDTH + 1])
        suspect = int(g[I_SUSPECT])
        n_bad = int(g[I_NBAD])
        entry = self._lookup(step)
        epoch = entry[1] if entry is not None else None
        batch_idx = entry[2] if entry is not None else None
        blame, named = self.classify(flags, suspect, n_bad, entry, replay,
                                     compression_active, any_fn=any_fn)
        telemetry.emit("anomaly_trip", step=step, blame=blame,
                       suspect_rank=named, epoch=epoch,
                       batch_idx=batch_idx, **{
                           k: v for k, v in flags.items()
                           if isinstance(v, bool)})
        if blame == BLAME_DATA and epoch is not None and \
                batch_idx is not None:
            anchor = self._rewind_anchor()
            if self.writer:
                add_quarantine(self.root_dir, epoch, batch_idx, step,
                               anchor=anchor)
            telemetry.emit("quarantine", epoch=epoch, batch_idx=batch_idx,
                           step=step, anchor=anchor)
        raise NumericAnomaly.for_trip(
            step, blame, flags=flags, suspect_rank=named, epoch=epoch,
            batch_idx=batch_idx,
            detail=", ".join(k for k, v in flags.items()
                             if isinstance(v, bool) and v) or "tripped")

    def _rewind_anchor(self) -> Optional[str]:
        """The newest verified checkpoint at trip time (the digest walk of
        ``latest_checkpoint`` skips a torn newest file, so the anchor is
        always restorable)."""
        from ..utils import checkpoint as ckpt_lib
        try:
            return ckpt_lib.latest_checkpoint(self.root_dir)
        except Exception:
            return None


def _tree_leaves(payload: Any):
    """The leaves of a batch (dicts / tuples / lists of arrays or
    tensors)."""
    if isinstance(payload, dict):
        for v in payload.values():
            yield from _tree_leaves(v)
    elif isinstance(payload, (list, tuple)):
        for v in payload:
            yield from _tree_leaves(v)
    elif payload is not None and not isinstance(payload, (str, bytes)):
        yield payload
