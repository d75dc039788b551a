"""Cross-rank collective sanitizer: record every collective call, diff
the sequences across ranks, turn the silent SPMD deadlock into a typed
one-look postmortem.

Port of the JAX package's ``testing/spmd_sanitizer.py``.  The worst
SPMD failure is a hang: one rank issues a collective the others never
join (a rank-divergent branch, two subsystems disagreeing about an
exchange order) and every healthy rank blocks inside it until the
watchdog reaps the world, with a diagnosis that says "stopped making
progress" and nothing about why.  The lint's rules
(``analysis/rules/spmd_collectives.py``, ``rank_divergence.py``) close
the holes that show in the source; this module is the runtime net under
what they cannot see.

Opt-in through the ``RLA_TPU_SPMD_SANITIZER`` knob:

- **Interception.**  ``install()`` wraps the ``torch.distributed`` entry
  points the port calls (``all_reduce``, ``all_gather*``,
  ``reduce_scatter*``, ``all_to_all*``, ``broadcast``, ``barrier``,
  ``send`` / ``recv`` / ``isend`` / ``irecv`` and
  ``batch_isend_irecv``).  JAX's collectives run Python only at trace
  time, so there one record is made per trace; PyTorch is eager, so
  here every call makes one: ``(op, axes, shape, dtype, site)``, the
  axes being the mesh axes of the call's process group as
  ``parallel/mesh.py`` made it (``group_axes``), the site the first
  frame above the port's pass-through collective wrappers.  Each
  record goes into a bounded ring (``RLA_TPU_SPMD_SEQ_EVENTS``) and is
  mirrored into the flight recorder as ``spmd_collective``.
  ``P2POp`` is replaced by a subclass that unwraps the wrapped
  ``isend`` / ``irecv`` (torch checks the op by identity), and
  ``batch_isend_irecv`` records each of its ops.
- **Spill.**  Every record re-snapshots ``rank{N}.collectives.json``
  under ``RLA_TPU_TELEMETRY_DIR`` (atomic tmp + rename) **before** the
  wrapped call enters the collective: a rank that blocks in call *k*
  leaves call *k* on disk, which is the whole point.  Worker processes
  install at boot (``runtime/actors._worker_main``) when the knob is in
  their env overlay.  The spill costs time on every call while the
  sanitizer is on (``chip_smoke.py`` phase 21a measures it).
- **The checker.**  ``check_collective_sequences(dir)`` gathers every
  rank's spill, aligns on the absolute call index and raises a typed,
  wire-registered :class:`CollectiveMismatch` whose diagnosis holds the
  first divergent entry of each rank.  The Trainer's fan-out
  (``_run_in_world``) and ``ElasticRunner`` run it: a wedge whose cause
  is a divergent collective surfaces as ``CollectiveMismatch`` naming
  the call, not as a generic ``WorkerWedged``.

The snapshot format (``{rank, pid, n, capacity, events}``) is the JAX
package's, so both packages' ``diff_sequences`` give the same diagnosis
on the same snapshots.  Nothing here imports torch until ``install()``.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Tuple

from ..analysis import knobs
from ..telemetry import recorder as telemetry

SANITIZER_ENV = "RLA_TPU_SPMD_SANITIZER"
SEQ_EVENTS_ENV = "RLA_TPU_SPMD_SEQ_EVENTS"
DEFAULT_SEQ_EVENTS = 512

# the torch.distributed entry points wrapped while the sanitizer is
# installed: op -> (index of the operand, index of the group) among the
# positional arguments (None: the op takes no such argument)
COLLECTIVE_OPS: Dict[str, Tuple[Optional[int], Optional[int]]] = {
    "all_reduce": (0, 2),
    "broadcast": (0, 2),
    "all_gather": (1, 2),
    "all_gather_into_tensor": (1, 2),
    "all_gather_single": (1, 2),
    "reduce_scatter": (1, 3),
    "reduce_scatter_tensor": (1, 3),
    "reduce_scatter_single": (1, 3),
    "all_to_all": (1, 2),
    "all_to_all_single": (1, 4),
    "barrier": (None, 0),
    "send": (0, 2),
    "recv": (0, 2),
    "isend": (0, 2),
    "irecv": (0, 2),
}

# the port's pass-through collective wrappers: a record's site is the
# first frame above these (their own lines say nothing about the call)
_PASS_THROUGH = frozenset(
    ("parallel/collectives.py", name) for name in
    ("_call", "all_reduce", "all_gather", "reduce_scatter", "all_to_all",
     "_all_reduce", "_all_to_all", "_permute", "_gather_stack"))

_SPILL_SUFFIX = ".collectives.json"


class CollectiveMismatch(RuntimeError):
    """Ranks issued divergent collective sequences: the program that
    hangs (or silently corrupts) instead of raising.  The diagnosis
    carries the first divergent entry of each rank -- op, axes, shape,
    dtype and call site -- so the postmortem names the exact call.

    Wire-registered (``runtime/wire.py``): a worker- or driver-side
    raise crosses the actor pipe and the agent relay typed, with the
    diagnosis embedded in the message after ``| collectives=`` and
    recovered by :meth:`from_message`.
    """

    _MARKER = "| collectives="

    def __init__(self, message: str,
                 diagnosis: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.diagnosis = dict(diagnosis or {})

    @classmethod
    def from_divergence(cls, diagnosis: Dict[str, Any]
                        ) -> "CollectiveMismatch":
        diagnosis = dict(diagnosis)
        idx = diagnosis.get("first_divergence")
        per_rank = diagnosis.get("per_rank") or {}
        bits = []
        for rank in sorted(per_rank):
            e = per_rank[rank]
            if e is None:
                bits.append(f"rank {rank}: <no call #{idx}>")
            else:
                bits.append(
                    f"rank {rank}: {e.get('op')}(axes={e.get('axes')}, "
                    f"shape={e.get('shape')}, dtype={e.get('dtype')}) "
                    f"at {e.get('site')}")
        msg = (f"cross-rank collective sequences diverge at call "
               f"#{idx}: " + "; ".join(bits) + " "
               + cls._MARKER
               + json.dumps(diagnosis, sort_keys=True, default=str))
        return cls(msg, diagnosis=diagnosis)

    @classmethod
    def from_message(cls, message: str) -> "CollectiveMismatch":
        """Rebuild from a wire-crossing (name, message, tb) payload,
        recovering the embedded diagnosis."""
        diagnosis: Dict[str, Any] = {}
        i = message.find(cls._MARKER)
        if i >= 0:
            try:
                diagnosis = json.loads(message[i + len(cls._MARKER):])
            except ValueError:
                pass
        return cls(message, diagnosis=diagnosis)


# --------------------------------------------------------------------- #
# Recording                                                              #
# --------------------------------------------------------------------- #
def _norm_axes(axis_name: Any) -> List[str]:
    if axis_name is None:
        return []
    if isinstance(axis_name, (tuple, list)):
        return [str(a) for a in axis_name]
    return [str(axis_name)]


def _shape_dtype(x: Any) -> Tuple[Optional[List[int]], Optional[str]]:
    """Shape and dtype of the first tensor in ``x`` (a tensor or a list
    of them); metadata reads, which never sync a device."""
    leaves = x if isinstance(x, (list, tuple)) else [x]
    for leaf in leaves:
        shape = getattr(leaf, "shape", None)
        if shape is not None:
            dtype = getattr(leaf, "dtype", None)
            return ([int(s) for s in shape],
                    str(dtype).replace("torch.", "")
                    if dtype is not None else None)
    return None, None


def _site_of(frame) -> str:
    path = frame.f_code.co_filename
    parts = path.replace(os.sep, "/").split("/")
    tail = "/".join(parts[-3:]) if len(parts) > 3 else "/".join(parts)
    return f"{tail}:{frame.f_lineno}"


def _call_site(depth: int = 2) -> Optional[str]:
    """``path:lineno`` of the frame that called the collective, above
    the port's pass-through wrappers, trimmed to a package-relative tail
    so sites compare across processes."""
    try:
        frame = sys._getframe(depth)
    except ValueError:
        return None
    while frame is not None:
        path = frame.f_code.co_filename.replace(os.sep, "/")
        key = ("/".join(path.split("/")[-2:]), frame.f_code.co_name)
        if key not in _PASS_THROUGH or frame.f_back is None:
            return _site_of(frame)
        frame = frame.f_back
    return None


class SpmdSanitizer:
    """One process's bounded collective-call sequence.

    Entries carry a monotonically increasing absolute index ``i`` so
    sequences stay alignable across ranks after the ring drops old
    heads.  Thread-safe; every record re-spills (the contract is that
    a rank blocked in a call has that call on disk).  ``record_s`` sums
    the seconds spent recording, spills included: what the sanitizer
    costs the calls it watches."""

    def __init__(self, capacity: int = DEFAULT_SEQ_EVENTS,
                 rank: Optional[int] = None,
                 spill_path: Optional[str] = None):
        self.capacity = max(1, int(capacity))
        self.rank = rank
        self.spill_path = spill_path
        self._ring: deque = deque(maxlen=self.capacity)
        self._n = 0
        self._lock = threading.Lock()
        self._spill_warned = False
        self.record_s = 0.0

    def record(self, op: str, axis_name: Any, x: Any = None,
               site: Optional[str] = None) -> None:
        t0 = time.perf_counter()
        axes = _norm_axes(axis_name)
        shape, dtype = _shape_dtype(x)
        with self._lock:
            entry = {"i": self._n, "op": op, "axes": axes,
                     "shape": shape, "dtype": dtype, "site": site}
            self._ring.append(entry)
            self._n += 1
        # the unified timeline's view (the bounded flight-recorder
        # ring); the sanitizer's own spill stays the diff channel
        telemetry.emit("spmd_collective", op=op, axes=",".join(axes),
                       site=site)
        self.spill()
        with self._lock:
            self.record_s += time.perf_counter() - t0

    def sequence(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._ring]

    def snapshot(self) -> Dict[str, Any]:
        return {"rank": self.rank, "pid": os.getpid(),
                "n": self._n, "capacity": self.capacity,
                "events": self.sequence()}

    def spill(self) -> Optional[str]:
        """Atomic snapshot to ``spill_path``; never raises.  The tmp
        name is pid- and thread-keyed, so two threads recording at once
        each write their own tmp and the replace publishes a whole
        snapshot, never a torn one."""
        path = self.spill_path
        if path is None:
            return None
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(self.snapshot(), f)
            os.replace(tmp, path)
            return path
        except Exception as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            if not self._spill_warned:
                self._spill_warned = True
                telemetry.log.warning(
                    "spmd sanitizer spill to %s failed: %s", path, e)
            return None


# --------------------------------------------------------------------- #
# Installation (torch.distributed patching) + process singleton          #
# --------------------------------------------------------------------- #
_active: Optional[SpmdSanitizer] = None
_originals: Dict[str, Any] = {}
_install_lock = threading.Lock()


def _group_axes(group: Any) -> List[str]:
    from ..parallel import mesh as mesh_lib
    return list(mesh_lib.group_axes(group))


def _make_wrapper(op: str, orig, sanitizer: SpmdSanitizer):
    operand_idx, group_idx = COLLECTIVE_OPS[op]

    @functools.wraps(orig)
    def wrapper(*args, **kwargs):
        try:
            if "group" in kwargs:
                group = kwargs["group"]
            elif group_idx is not None and len(args) > group_idx:
                group = args[group_idx]
            else:
                group = None
            x = (args[operand_idx] if operand_idx is not None
                 and len(args) > operand_idx else None)
            sanitizer.record(op, _group_axes(group), x, site=_call_site())
        except Exception:
            pass  # the sanitizer observes; it must never fail a call
        return orig(*args, **kwargs)

    wrapper._rla_spmd_wrapped = True
    return wrapper


def _make_batch_wrapper(orig, sanitizer: SpmdSanitizer):
    @functools.wraps(orig)
    def wrapper(p2p_op_list, *args, **kwargs):
        try:
            site = _call_site()
            for p in p2p_op_list:
                name = getattr(p.op, "__name__", "p2p")
                sanitizer.record(name, _group_axes(p.group), p.tensor,
                                 site=site)
        except Exception:
            pass
        return orig(p2p_op_list, *args, **kwargs)

    wrapper._rla_spmd_wrapped = True
    return wrapper


def _unwrapping_p2pop(base):
    """``P2POp`` that stores the original ``isend`` / ``irecv`` when
    handed a wrapper: torch checks the op by identity."""

    def _unwrap(op):
        return getattr(op, "__wrapped__", op) \
            if getattr(op, "_rla_spmd_wrapped", False) else op

    class P2POp(base):
        def __new__(cls, op, *args, **kwargs):
            return base.__new__(cls, _unwrap(op), *args, **kwargs)

        def __init__(self, op, *args, **kwargs):
            super().__init__(_unwrap(op), *args, **kwargs)

    P2POp._rla_spmd_wrapped = True
    P2POp.__qualname__ = base.__qualname__
    return P2POp


def enabled(env: Optional[Mapping[str, str]] = None) -> bool:
    return knobs.get_bool(SANITIZER_ENV, False, env=env)


def spill_path_for(rank: Optional[int],
                   env: Optional[Mapping[str, str]] = None
                   ) -> Optional[str]:
    tdir = knobs.get_str(telemetry.DIR_ENV, None, env=env)
    if not tdir:
        return None
    label = "driver" if rank is None else f"rank{int(rank)}"
    return os.path.join(tdir, label + _SPILL_SUFFIX)


def get_sanitizer() -> Optional[SpmdSanitizer]:
    return _active


def install(sanitizer: Optional[SpmdSanitizer] = None,
            rank: Optional[int] = None,
            env: Optional[Mapping[str, str]] = None) -> SpmdSanitizer:
    """Wrap the ``torch.distributed`` collective entry points with
    recording wrappers.  Idempotent per process (a second install
    rebinds the ring, not the patches)."""
    global _active
    import torch.distributed as dist

    with _install_lock:
        if sanitizer is None:
            sanitizer = SpmdSanitizer(
                capacity=knobs.get_int(SEQ_EVENTS_ENV, DEFAULT_SEQ_EVENTS,
                                       env=env),
                rank=rank, spill_path=spill_path_for(rank, env=env))
        # overwrite a stale spill of an earlier process generation of
        # this rank at once (a restarted worker installs again at boot):
        # an attempt is never diffed against a dead generation's sequence
        sanitizer.spill()
        names = list(COLLECTIVE_OPS) + ["batch_isend_irecv", "P2POp"]
        for op in names:
            current = _originals.get(op, getattr(dist, op, None))
            if current is None:
                continue
            _originals.setdefault(op, current)
            if op == "P2POp":
                wrapped = _unwrapping_p2pop(current)
            elif op == "batch_isend_irecv":
                wrapped = _make_batch_wrapper(current, sanitizer)
            else:
                wrapped = _make_wrapper(op, current, sanitizer)
            setattr(dist, op, wrapped)
        _active = sanitizer
    return sanitizer


def uninstall() -> None:
    """Restore the original ``torch.distributed`` entry points."""
    global _active
    with _install_lock:
        if _originals:
            import torch.distributed as dist
            for op, orig in _originals.items():
                setattr(dist, op, orig)
            _originals.clear()
        _active = None


def maybe_install_from_env(rank: Optional[int] = None,
                           env: Optional[Mapping[str, str]] = None
                           ) -> Optional[SpmdSanitizer]:
    """Worker-boot hook (``runtime/actors._worker_main``): install when
    the knob is set in the per-worker overlay or the process env."""
    if not enabled(env):
        return None
    return install(rank=rank, env=env)


# --------------------------------------------------------------------- #
# Driver-side checker                                                    #
# --------------------------------------------------------------------- #
def clear_spills(tdir: Optional[str] = None,
                 env: Optional[Mapping[str, str]] = None) -> None:
    """Remove every ``*.collectives.json`` under the telemetry dir: the
    driver calls this at run entry, so a smaller world (or a rerun in
    the same dir) is never diffed against stale rank files.  Workers
    spill again at boot and on every record."""
    tdir = tdir or knobs.get_str(telemetry.DIR_ENV, None, env=env)
    if not tdir or not os.path.isdir(tdir):
        return
    for fn in os.listdir(tdir):
        if fn.endswith(_SPILL_SUFFIX):
            try:
                os.unlink(os.path.join(tdir, fn))
            except OSError:
                pass


def gather_sequences(tdir: Optional[str] = None
                     ) -> Dict[str, Dict[str, Any]]:
    """label ('driver' / 'rank0' / ...) -> spilled sequence snapshot for
    every ``*.collectives.json`` under the telemetry dir."""
    tdir = tdir or knobs.get_str(telemetry.DIR_ENV, None)
    out: Dict[str, Dict[str, Any]] = {}
    if not tdir or not os.path.isdir(tdir):
        return out
    for fn in sorted(os.listdir(tdir)):
        if not fn.endswith(_SPILL_SUFFIX):
            continue
        try:
            with open(os.path.join(tdir, fn)) as f:
                snap = json.load(f)
        except (OSError, ValueError):
            continue  # a file torn mid-crash is an expected state
        if isinstance(snap, dict):
            out[fn[:-len(_SPILL_SUFFIX)]] = snap
    return out


def _entry_key(e: Dict[str, Any]) -> Tuple:
    return (e.get("op"), tuple(e.get("axes") or ()),
            tuple(e.get("shape") or ()) if e.get("shape") is not None
            else None,
            e.get("dtype"), e.get("site"))


def diff_sequences(snapshots: Mapping[str, Dict[str, Any]]
                   ) -> Optional[Dict[str, Any]]:
    """The divergence diagnosis across >= 2 rank sequences, or None when
    every rank issued the same collective stream.

    Sequences align on the absolute call index ``i`` (rings may have
    dropped old heads on busy ranks); comparison starts at the highest
    retained start index and runs to the longest sequence -- a rank
    whose stream ends early (it never issued call #k the others did) is
    a divergence too, reported with ``None`` as its entry."""
    ranks = {label: snap for label, snap in snapshots.items()
             if label != "driver"}
    if len(ranks) < 2:
        return None
    by_rank: Dict[str, Dict[int, Dict[str, Any]]] = {}
    starts, ends = [], []
    for label, snap in ranks.items():
        events = snap.get("events") or []
        by_rank[label] = {int(e["i"]): e for e in events}
        starts.append(min(by_rank[label]) if by_rank[label] else 0)
        ends.append(snap.get("n", len(events)))
    lo, hi = max(starts), max(ends)
    for i in range(lo, hi):
        entries = {label: by_rank[label].get(i) for label in by_rank}
        keys = {None if e is None else _entry_key(e)
                for e in entries.values()}
        if len(keys) > 1:
            return {
                "first_divergence": i,
                "per_rank": entries,
                "lengths": {label: snap.get("n")
                            for label, snap in ranks.items()},
                "ring_dropped": lo > 0,
            }
    return None


def check_collective_sequences(tdir: Optional[str] = None,
                               raise_on_mismatch: bool = True
                               ) -> Optional[CollectiveMismatch]:
    """Gather and diff the rank sequences under the telemetry dir; raise
    (or return, with ``raise_on_mismatch=False``) the typed
    :class:`CollectiveMismatch`.  None when the sequences agree."""
    diagnosis = diff_sequences(gather_sequences(tdir))
    if diagnosis is None:
        return None
    exc = CollectiveMismatch.from_divergence(diagnosis)
    if raise_on_mismatch:
        raise exc
    return exc


def check_world_collectives(raise_on_mismatch: bool = True,
                            env: Optional[Mapping[str, str]] = None
                            ) -> Optional[CollectiveMismatch]:
    """The driver seam (the Trainer's fan-out, elastic attempts): a
    no-op unless the sanitizer knob is on and a telemetry dir is set --
    unconfigured runs pay nothing, not even a directory listing."""
    if not enabled(env):
        return None
    tdir = knobs.get_str(telemetry.DIR_ENV, None, env=env)
    if not tdir:
        return None
    return check_collective_sequences(
        tdir, raise_on_mismatch=raise_on_mismatch)


def reset_world_collectives(env: Optional[Mapping[str, str]] = None
                            ) -> None:
    """Run-entry counterpart of :func:`check_world_collectives` (same
    gating): clear stale rank spills so this run's diff only sees
    sequences its own workers issued."""
    if not enabled(env):
        return
    clear_spills(env=env)
