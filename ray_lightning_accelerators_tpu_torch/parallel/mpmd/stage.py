"""StageRunner: one pipeline stage as its own process.

Worker side of the MPMD pipeline; port of the JAX package's
``parallel/mpmd/stage.py``.  Each stage group member builds one
``StageRunner`` at its init dispatch and then runs its deterministic
tick program (``schedule.stage_program``) once per optimizer step.  The
cross-stage edges are object-store refs through the ``handoff.Mailbox``.

The slots, in PyTorch:

- **forward** (a non-last stage): ``pipeline_stage_forward`` under
  ``torch.no_grad()``; only the stage's input is kept for the backward;
- **backward** (a non-last stage): the stage forward is recomputed under
  autograd and ``torch.autograd.grad(y, params + [x], gy)`` gives the
  parameter gradients (added into the accumulator in program order) and
  the input's gradient for the stage before.  Stage 0's input is the raw
  microbatch (possibly integer tokens): no gradient is taken for it;
- **last stage**: its loss and gradients are fused into the backward
  slot (the forward slot only takes the loss batch);
- **apply**: ``grads = acc * (1 / (lanes * m_lane))``, their global
  norm, one step of the module's optimizer (``core/optim.py``) over the
  stage's leaves, the accumulator zeroed.  With lanes (data-parallel
  replicas of the pipeline) the accumulators are summed in lane-index
  order first, so every lane applies the identical update.

Activations cross as ``handoff.to_wire`` trees (bfloat16 as its int16
words) and come back with ``handoff.from_wire`` onto the stage's device.
On the card every member of one machine's pipeline uses its one card.
The port has no tracing compiler: the ``compiles`` a step reports is the
kernel builds of this process (``ops/_build.py``; 0 on the CPU), which
must not move after the first step.

**FSDP inside a stage** (``fsdp = F > 1``).  The JAX stage places its
params over a local mesh of F devices inside its one worker; here a
stage lane is a group of F worker processes over their own
``torch.distributed`` group (``mpmd_stage_init`` joins it), as
PyTorch's own FSDP does it:

- member j owns the ``fsdp_leaf_spec`` slice j of each leaf (leaves under
  ``FSDP_MIN_LEAF_SIZE``, or with no divisible dim, stay whole on every
  member) and the optimizer moments of that slice only;
- the forward runs on the compute view, the whole leaves all-gathered
  from the owned slices (``GradExchange.gather_params``) after each
  apply, so every slot of a step sees the same params;
- each microbatch's rows are split contiguously over the group: member j
  takes part j of stage 0's input and of the last stage's loss batch,
  and trades activations and their cotangents with member j of the
  neighbouring stages only;
- at apply the accumulated gradient is reduce-scattered as the group's
  mean into the owners (``reduce_scatter_mean``; the whole leaves'
  gradients averaged), the lanes then sum the owned slices with the
  peers of the same fsdp rank, the global norm sums the owned slices'
  squares over the group, and the optimizer steps the owned slices;
- the last stage's loss and metrics are the group's mean, which is the
  mean over the whole microbatch because the members' rows are equal;
- ``mpmd_stage_state`` (a collective of the group) gathers the whole
  params and moments, so a checkpoint has the layout of ``fsdp=1``.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, List, Optional

import torch

from ...core.module import resolve_device
from ...core.optim import global_norm, tree_leaves, tree_like
from ...ops import _build
from .. import mesh as mesh_lib
from .. import plan as plan_lib
from ..collectives import GradExchange
from ...runtime import object_store
from ...runtime.object_store import ObjectRef
from ...telemetry import recorder
from ...utils.checkpoint import _to_device, _to_host
from . import handoff
from .handoff import KIND_ACT, KIND_GRAD, KIND_LANE_GRAD, Mailbox
from .schedule import (OP_BWD, OP_FWD, OP_RECV_ACT, OP_RECV_GRAD,
                       OP_SEND_ACT, OP_SEND_GRAD, program_fingerprint,
                       stage_program)

# the one StageRunner of this worker process (built by mpmd_stage_init;
# the dispatch functions below ship by reference and find it here)
_RUNNER: Optional["StageRunner"] = None


def current_step() -> Optional[int]:
    """The optimizer step this process's stage is running (None outside
    a step): for a module's stage hook that must know it."""
    return None if _RUNNER is None else _RUNNER.step


def fsdp_dims(leaves: List[torch.Tensor], fsdp: int) -> List[Optional[int]]:
    """The dim of each leaf split over a stage's fsdp group of ``fsdp``
    members (``plan.fsdp_leaf_spec``, as the JAX stage places its
    params), None for a leaf every member holds whole."""
    mesh = mesh_lib.Mesh({mesh_lib.FSDP_AXIS: fsdp})
    dims = []
    for t in leaves:
        d = plan_lib.fsdp_leaf_spec(mesh, t)
        dims.append(None if d is plan_lib.FSDP_FALLBACK else d)
    return dims


def _part(t: torch.Tensor, dim: Optional[int], j: int, n: int
          ) -> torch.Tensor:
    """Member j's contiguous slice of ``dim`` (the whole without one)."""
    if dim is None:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, j * size, size).clone()


class StageRunner:
    """One stage group member: its parameters, optimizer and tick loop."""

    def __init__(self, module: Any, *, stage: int, num_stages: int,
                 lane: int = 0, num_lanes: int = 1,
                 schedule: str = "1f1b", microbatches_per_lane: int = 1,
                 mailbox_root: str, fsdp: int = 1, fsdp_rank: int = 0,
                 stage_params: Any, opt_state: Any = None,
                 device: Any = None):
        if num_stages < 2:
            raise ValueError("StageRunner needs num_stages >= 2 — a "
                             "1-stage pipeline is the plain Trainer path")
        self.device = resolve_device(device)
        # the members share the host's cores
        torch.set_num_threads(max(1, min(2, (os.cpu_count() or 1)
                                         // (num_stages * num_lanes
                                             * fsdp))))
        self.module = module
        self.fsdp = fsdp
        self.fsdp_rank = fsdp_rank
        self.stage = stage
        self.num_stages = num_stages
        self.lane = lane
        self.num_lanes = num_lanes
        self.schedule = schedule
        self.m_lane = microbatches_per_lane
        self.is_first = stage == 0
        self.is_last = stage == num_stages - 1
        self.step: Optional[int] = None
        self.program = stage_program(schedule, stage, num_stages,
                                     microbatches_per_lane)
        self.mailbox = Mailbox(mailbox_root)
        self._store = object_store.global_store()
        self._sent_refs: List[ObjectRef] = []
        self._recv_refs: List[ObjectRef] = []

        tree = _to_device(stage_params, self.device)
        whole = tree_leaves(tree)
        self._tree = tree
        # each leaf's fsdp dim; the group's collectives (the default
        # process group of this worker, its F members)
        self._dims = (fsdp_dims(whole, fsdp) if fsdp > 1
                      else [None] * len(whole))
        self._ex = GradExchange(self.device) if fsdp > 1 else None
        # the masters the optimizer steps (this member's slices), and the
        # compute view the forward differentiates (the whole leaves)
        self._owned = [_part(t.detach(), d, fsdp_rank, fsdp)
                       for t, d in zip(whole, self._dims)]
        if self._ex is None:
            # without fsdp the masters are themselves the view
            self._leaves = [t.requires_grad_(True) for t in self._owned]
            self.params = tree_like(tree, self._leaves)
        else:
            self._set_view(whole)
        self._tx = module.configure_optimizers()
        self.opt_state = (
            self._tx.init(self._owned) if opt_state is None
            else self._map_moments(
                _to_device(opt_state, self.device),
                lambda v: [_part(t, d, fsdp_rank, fsdp)
                           for t, d in zip(v, self._dims)]))
        self._acc = [torch.zeros_like(t, dtype=torch.float32)
                     for t in self._leaves]
        self._inv_m = 1.0 / (num_lanes * microbatches_per_lane)
        # the group's collective seconds of the current step
        self._coll_s = 0.0

    # ---- the fsdp layout -------------------------------------------- #
    def _set_view(self, whole: List[torch.Tensor]) -> None:
        """The compute view under fsdp: ``whole`` as autograd leaves."""
        self._leaves = [t.detach().clone().requires_grad_(True)
                        for t in whole]
        self.params = tree_like(self._tree, self._leaves)

    def _split(self) -> List[int]:
        return [i for i, d in enumerate(self._dims) if d is not None]

    def _gather(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Whole leaves from this member's slices (a collective)."""
        out = list(parts)
        idx = self._split()
        if idx:
            fulls = self._ex.gather_params(
                [(parts[i].detach(), self._dims[i]) for i in idx])
            for i, f in zip(idx, fulls):
                out[i] = f
        return out

    def _map_moments(self, state: Dict[str, Any], fn) -> Dict[str, Any]:
        """``state`` with ``fn`` applied to each of its per-leaf lists
        (the moments, the momentum trace); the counters as they are."""
        return {k: (fn(v) if isinstance(v, list)
                    and len(v) == len(self._dims) else v)
                for k, v in state.items()}

    def whole_opt_state(self) -> Dict[str, Any]:
        """The optimizer state with each per-leaf list gathered whole (a
        collective of the group under fsdp)."""
        if self._ex is None:
            return self.opt_state
        return self._map_moments(self.opt_state, self._gather)

    def _rows(self, tree: Any) -> Any:
        """This member's contiguous rows of a microbatch (all of them
        without fsdp)."""
        if self.fsdp == 1:
            return tree
        return handoff.split_microbatches(tree, self.fsdp)[self.fsdp_rank]

    def _group_mean(self, acc: List[torch.Tensor]) -> List[torch.Tensor]:
        """The accumulated gradients as the group's mean: each split
        leaf's reduce-scattered into its owner's slice, the whole leaves'
        all-reduced."""
        out = list(acc)
        idx = self._split()
        rep = [i for i, d in enumerate(self._dims) if d is None]
        if idx:
            for i, g in zip(idx, self._ex.reduce_scatter_mean(
                    [(acc[i], self._dims[i]) for i in idx])):
                out[i] = g
        if rep:
            for i, g in zip(rep, self._ex.mean([acc[i] for i in rep])):
                out[i] = g
        return out

    def _norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The stage's global gradient norm: the owned slices' squares
        summed over the group, the whole leaves' counted once."""
        if self._ex is None:
            return global_norm(grads)
        sq = sum((g.float() * g.float()).sum()
                 for g, d in zip(grads, self._dims)
                 if d is not None or self.fsdp_rank == 0)
        return torch.sqrt(self._ex.sum_scalar(sq))

    # ------------------------------------------------------------------ #
    def _forward(self, x: Any) -> Any:
        return self.module.pipeline_stage_forward(
            self.params, x, self.stage, self.num_stages)

    def _fwd(self, x: Any) -> Any:
        with torch.no_grad():
            return self._forward(x)

    def _input_leaf(self, x: Any) -> Any:
        """The stage input as an autograd leaf (a floating tensor of a
        stage after the first); None when no gradient is taken for it."""
        if self.is_first or not isinstance(x, torch.Tensor) \
                or not x.is_floating_point():
            return None
        return x.detach().requires_grad_(True)

    def _accumulate(self, grads) -> None:
        for a, g in zip(self._acc, grads):
            a.add_(g.float())

    def _bwd(self, x: Any, gy: Any) -> Any:
        """Recompute the forward under autograd; accumulate the parameter
        gradients; return the input's gradient (None for stage 0)."""
        xin = self._input_leaf(x)
        with torch.enable_grad():
            y = self._forward(x if xin is None else xin)
            wrt = self._leaves + ([] if xin is None else [xin])
            grads = torch.autograd.grad(y, wrt, gy)
        self._accumulate(grads[:len(self._leaves)])
        return None if xin is None else grads[-1]

    def _last(self, x: Any, batch: Any):
        """The last stage's fused forward, loss and backward: (loss,
        metrics, input gradient)."""
        xin = self._input_leaf(x)
        with torch.enable_grad():
            y = self._forward(x if xin is None else xin)
            out = self.module.pipeline_loss(y, batch)
            loss, metrics = out if isinstance(out, tuple) else (out, {})
            wrt = self._leaves + ([] if xin is None else [xin])
            grads = torch.autograd.grad(loss, wrt)
        self._accumulate(grads[:len(self._leaves)])
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in (metrics or {}).items()}
        return (loss.detach(), metrics,
                None if xin is None else grads[-1])

    def _apply(self, acc: List[torch.Tensor]) -> torch.Tensor:
        grads = [a * self._inv_m for a in acc]
        gnorm = self._norm(grads)
        self._tx.apply(self._owned, grads, self.opt_state)
        for a in self._acc:
            a.zero_()
        return gnorm

    def _timed_collective(self, fn, *args) -> Any:
        out, dt = handoff.timed_call(fn, *args, device=self.device)
        self._coll_s += dt
        return out

    # ------------------------------------------------------------------ #
    def _member(self, stage: int, lane: int) -> int:
        """Global member index: the lane-grad edge namespace (the peers
        of one fsdp rank)."""
        return (stage * self.num_lanes + lane) * self.fsdp + self.fsdp_rank

    def release_step_resources(self) -> None:
        """Drop the previous step's transport state: the segments this
        member published (consumed: the driver barriers every step) and
        its mappings of its neighbors' segments."""
        for ref in self._sent_refs:
            self._store.delete(ref)
        self._sent_refs = []
        for ref in self._recv_refs:
            self._store.release(ref)
        self._recv_refs = []

    def _get(self, ref: ObjectRef) -> Any:
        self._recv_refs.append(ref)
        return handoff.from_wire(self._store.get(ref, copy=False),
                                 self.device)

    def _put(self, tree: Any) -> ObjectRef:
        ref = self._store.put(handoff.to_wire(tree))
        self._sent_refs.append(ref)
        return ref

    def run_step(self, step: int,
                 input_refs: Optional[List[ObjectRef]]) -> Dict[str, Any]:
        """Run this stage's tick program for one optimizer step."""
        self.release_step_resources()
        self.step = step
        self._coll_s = 0.0
        t_start = time.perf_counter()
        edge = {"lane": self.lane, "fsdp_rank": self.fsdp_rank}
        mb = self.mailbox
        dev = self.device
        xs: Dict[int, Any] = {}       # microbatch -> forward input
        ys: Dict[int, Any] = {}       # microbatch -> activation out
        gys: Dict[int, Any] = {}      # microbatch -> grad from downstream
        gxs: Dict[int, Any] = {}      # microbatch -> grad for upstream
        batches: Dict[int, Any] = {}  # last stage: loss batches
        loss_sum = None
        metrics_sum = None
        gnorm = None
        busy_s = 0.0
        ticks: List[Any] = []

        def gmb(m: int) -> int:
            return self.lane * self.m_lane + m

        for op, m in self.program:
            t0 = time.perf_counter()
            if op == OP_RECV_ACT:
                ref = mb.recv(step=step, kind=KIND_ACT, src=self.stage - 1,
                              dst=self.stage, microbatch=gmb(m), **edge)
                xs[m] = self._get(ref)
                dt = time.perf_counter() - t0
            elif op == OP_FWD:
                if self.is_first:
                    xs[m] = self._rows(self._get(input_refs[m]))
                if self.is_last:
                    # the loss batch rides the same driver refs as stage
                    # 0's input; the compute is fused into the OP_BWD slot
                    batches[m] = self._rows(self._get(input_refs[m]))
                    dt = time.perf_counter() - t0
                else:
                    ys[m], dt = handoff.timed_call(self._fwd, xs[m],
                                                   device=dev)
                    busy_s += dt
            elif op == OP_SEND_ACT:
                ref = self._put(ys.pop(m))
                mb.send(ref, step=step, kind=KIND_ACT, src=self.stage,
                        dst=self.stage + 1, microbatch=gmb(m), **edge)
                dt = time.perf_counter() - t0
            elif op == OP_RECV_GRAD:
                ref = mb.recv(step=step, kind=KIND_GRAD,
                              src=self.stage + 1, dst=self.stage,
                              microbatch=gmb(m), **edge)
                gys[m] = self._get(ref)
                dt = time.perf_counter() - t0
            elif op == OP_BWD:
                if self.is_last:
                    out, dt = handoff.timed_call(
                        self._last, xs.pop(m), batches.pop(m), device=dev)
                    loss, metrics, gx = out
                    loss_sum = loss if loss_sum is None else loss_sum + loss
                    if metrics_sum is None:
                        metrics_sum = metrics
                    else:
                        metrics_sum = {k: metrics_sum[k] + v
                                       for k, v in metrics.items()}
                else:
                    gx, dt = handoff.timed_call(
                        self._bwd, xs.pop(m), gys.pop(m), device=dev)
                busy_s += dt
                gxs[m] = gx
            elif op == OP_SEND_GRAD:
                ref = self._put(gxs.pop(m))
                mb.send(ref, step=step, kind=KIND_GRAD, src=self.stage,
                        dst=self.stage - 1, microbatch=gmb(m), **edge)
                dt = time.perf_counter() - t0
            else:  # OP_OPT
                acc = self._acc
                if self._ex is not None:
                    acc = self._timed_collective(self._group_mean, acc)
                if self.num_lanes > 1:
                    acc = self._lane_grad_exchange(step, acc)
                gnorm, dt = handoff.timed_call(self._apply, acc, device=dev)
                busy_s += dt
                if self._ex is not None:
                    # the next step's compute view
                    self._set_view(self._timed_collective(
                        self._gather, self._owned))
            ticks.append((op, m, dt))
            recorder.emit("pipeline_tick", step=step, stage=self.stage,
                          lane=self.lane, op=op, microbatch=m, dt_s=dt)
        wall_s = time.perf_counter() - t_start
        self.step = None
        if loss_sum is not None:
            loss_sum = loss_sum / self.m_lane
        if metrics_sum is not None:
            metrics_sum = {k: v / self.m_lane for k, v in metrics_sum.items()}
        if self._ex is not None and loss_sum is not None:
            # the group's mean: the whole microbatches' (equal rows)
            names = sorted(metrics_sum or {})
            means = self._timed_collective(self._ex.mean, [loss_sum] + [
                torch.as_tensor(metrics_sum[k], device=dev) for k in names])
            loss_sum = means[0]
            metrics_sum = dict(zip(names, means[1:]))
        return {"loss": loss_sum, "metrics": metrics_sum, "gnorm": gnorm,
                "busy_s": busy_s, "wall_s": wall_s, "ticks": ticks,
                "collective_s": self._coll_s}

    # ------------------------------------------------------------------ #
    def _lane_grad_exchange(self, step: int,
                            acc: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sum the gradient accumulators across the stage group's lanes
        in lane-index order, so every lane reduces in the same order and
        applies an identical update (under fsdp, the owned slices of the
        members of this fsdp rank)."""
        me = self._member(self.stage, self.lane)
        ref = self._put(acc)
        for peer in range(self.num_lanes):
            if peer == self.lane:
                continue
            # receiver-keyed, so each peer polls its own file
            self.mailbox.send(ref, step=step, kind=KIND_LANE_GRAD,
                              src=me, dst=self._member(self.stage, peer),
                              microbatch=0, lane=peer,
                              fsdp_rank=self.fsdp_rank)
        parts: Dict[int, List[torch.Tensor]] = {self.lane: acc}
        for peer in range(self.num_lanes):
            if peer == self.lane:
                continue
            pref = self.mailbox.recv(
                step=step, kind=KIND_LANE_GRAD,
                src=self._member(self.stage, peer), dst=me,
                microbatch=0, lane=self.lane, fsdp_rank=self.fsdp_rank)
            parts[peer] = self._get(pref)
        total = parts[0]
        for peer in range(1, self.num_lanes):
            total = [a + b for a, b in zip(total, parts[peer])]
        return total


# --------------------------------------------------------------------- #
# Dispatch surface (shipped to the workers by reference)                 #
# --------------------------------------------------------------------- #
def mpmd_stage_init(stage_params: Any, opt_state: Any,
                    spec: Dict[str, Any]) -> Dict[str, Any]:
    """Build this process's StageRunner.  ``stage_params`` / ``opt_state``
    arrive as top-level ObjectRefs, resolved by the actor layer (the
    whole stage's, on every member).  Under fsdp the member first joins
    its group's process group (``spec["fsdp_address"]``, a rendezvous
    bounded by ``spec["fsdp_timeout_s"]``, which also bounds every
    collective of the group)."""
    global _RUNNER
    fsdp = spec.get("fsdp", 1)
    if fsdp > 1:
        import torch.distributed as dist

        from ...runtime import bootstrap
        if dist.is_initialized():
            dist.destroy_process_group()
        bootstrap.initialize_worker(
            spec["fsdp_address"], fsdp, spec["fsdp_rank"], spec["device"],
            spec["fsdp_backend"], timeout_s=spec["fsdp_timeout_s"])
    _RUNNER = StageRunner(
        spec["module"], stage=spec["stage"],
        num_stages=spec["num_stages"], lane=spec["lane"],
        num_lanes=spec["num_lanes"], schedule=spec["schedule"],
        microbatches_per_lane=spec["microbatches_per_lane"],
        mailbox_root=spec["mailbox_root"], fsdp=fsdp,
        fsdp_rank=spec.get("fsdp_rank", 0),
        stage_params=stage_params, opt_state=opt_state,
        device=spec["device"])
    return {"stage": _RUNNER.stage, "lane": _RUNNER.lane,
            "fsdp_rank": _RUNNER.fsdp_rank,
            "owned_param_bytes": sum(t.numel() * t.element_size()
                                     for t in _RUNNER._owned),
            "owned_shapes": [list(t.shape) for t in _RUNNER._owned],
            "fingerprint": program_fingerprint(_RUNNER.program),
            "slots": len(_RUNNER.program),
            "compiles": _build.build_count()}


def mpmd_stage_step(step: int,
                    input_refs: Optional[List[ObjectRef]]
                    ) -> Dict[str, Any]:
    """One optimizer step of this member's tick program; the summary
    crosses the pipe as host scalars.  A non-finite stage loss or
    gradient norm raises a typed ``NumericAnomaly`` naming this stage."""
    out = _RUNNER.run_step(step, input_refs)
    host = handoff.host_scalars(
        {"loss": out["loss"], "metrics": out["metrics"],
         "gnorm": out["gnorm"]})
    # the step's ticks on disk now, for the run report
    recorder.get_recorder().spill()
    loss_h = host.get("loss")
    gnorm_h = host.get("gnorm")
    flags = {
        "loss_nonfinite": bool(loss_h is not None
                               and not math.isfinite(loss_h)),
        "grad_nonfinite": bool(gnorm_h is not None
                               and not math.isfinite(gnorm_h)),
    }
    if flags["loss_nonfinite"] or flags["grad_nonfinite"]:
        from ...runtime.guardian import BLAME_UNKNOWN, NumericAnomaly
        raise NumericAnomaly.for_trip(
            step=step, blame=BLAME_UNKNOWN, flags=flags,
            stage=_RUNNER.stage,
            detail=f"loss={loss_h} grad_norm={gnorm_h}")
    return {"stage": _RUNNER.stage, "lane": _RUNNER.lane,
            "fsdp_rank": _RUNNER.fsdp_rank, "step": step,
            "loss": host["loss"], "metrics": host["metrics"],
            "grad_norm": gnorm_h,
            "busy_s": out["busy_s"], "wall_s": out["wall_s"],
            "collective_s": out["collective_s"],
            "ticks": out["ticks"],
            "compiles": _build.build_count()}


def mpmd_stage_state() -> Dict[str, Any]:
    """This member's checkpointable state, as host arrays: the whole
    stage's params and moments (under fsdp a collective of the group,
    every member gathering them)."""
    return {"stage": _RUNNER.stage, "lane": _RUNNER.lane,
            "params": _to_host(_RUNNER.params),
            "opt_state": _to_host(_RUNNER.whole_opt_state())}
