"""Admission control and backpressure for the serve engine.

Port of the JAX package's ``serve/batcher.py`` for the serve
engine.  The failure surface is typed: ``QueueFull`` / ``PoolExhausted``
(shed load, retry later), ``RequestRejected`` (can never be served),
``ServeCancelled`` (the engine is going away).  The queue is bounded and
stores requests in a ``TrampolineQueue``, whose draining shutdown cancels
every still-queued request typed.  A flow-control lane in front of it
takes requests the pool could not place yet, FIFO order kept.

Paged admission judges a request against the BLOCK POOL: rejected only
when its worst-case block demand exceeds the per-slot table or the whole
pool, backpressured when the admitted set's demand would overcommit the
pool.  Dense admission (no ``block_len``) judges prompt + max_new_tokens
against the dense cache's per-slot length.

Lanes: a ``speculative`` request reserves ``spec_headroom`` more
positions; an export request (the prefill half of a KV handoff)
reserves its prompt bucket and one new token; an import request (the
decode half) bypasses the depth cap but not the pool check.  With an SLO
policy the absolute deadline is stamped once at admission, and a
deadline carried across a handoff is kept.

The replica tier (``serve/replicas.py``) re-admits a request whose
replica died or wedged through ``requeue``: it enters the same lane at
the head of the queue, bypasses the depth cap (it was admitted once),
counts its requeues and carries a retry backoff (``not_before``) that
holds the lane, so a retry keeps its place in front of newer
admissions.  ``BrownoutShed`` is the tier's typed early shed.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, List, Optional, Tuple

import numpy as np

from ..runtime.queue import TrampolineQueue
from ..telemetry.recorder import mint_trace_id


class QueueFull(RuntimeError):
    """Admission queue at capacity — backpressure.  Retryable: the caller
    sheds load (the HTTP 429 analog)."""

    def __init__(self, depth: int, limit: int):
        super().__init__(
            f"serve queue full: {depth} queued >= depth cap {limit}; "
            "retry after responses drain")
        self.depth = depth
        self.limit = limit


class PoolExhausted(QueueFull):
    """Block-pool backpressure: admitting this request would overcommit
    the paged KV pool.  Retryable after responses drain; distinct from
    ``RequestRejected``, which means the request could NEVER fit."""

    def __init__(self, needed: int, outstanding: int, total: int,
                 overcommit: float):
        RuntimeError.__init__(
            self,
            f"serve block pool exhausted: request needs {needed} KV "
            f"blocks but {outstanding} are already committed to admitted "
            f"requests against a pool of {total} blocks "
            f"(overcommit {overcommit:g}); retry after responses drain")
        self.needed = needed
        self.outstanding = outstanding
        self.total = total


class BrownoutShed(QueueFull):
    """Typed brownout: the replica tier is saturated -- the queue is past
    the controller's shed watermark and no scale-up headroom remains --
    so the request is shed before the queue grows to its hard cap
    (serve/controller.py).  A ``QueueFull``: the client sheds load and
    retries after responses drain."""

    def __init__(self, depth: int, watermark: int, limit: int):
        RuntimeError.__init__(
            self,
            f"serve tier brownout: {depth} queued >= shed watermark "
            f"{watermark} (hard cap {limit}) with no scale-up headroom; "
            "retry after load drains")
        self.depth = depth
        self.watermark = watermark
        self.limit = limit


class RequestRejected(ValueError):
    """The request can never be served by this engine.  Not retryable
    as-is: the client must change the request."""


class ServeCancelled(RuntimeError):
    """The engine shut down with the request still queued or in flight.
    The request was NOT served; re-submission to a live engine is safe."""


def blocks_for_request(prompt_len: int, max_new_tokens: int,
                       block_len: int, headroom: int = 0) -> int:
    """Worst-case KV blocks a request pins: enough to cover the
    right-padded prompt bucket and the decode feeds up to position
    ``prompt_len + max_new_tokens - 2`` (the final token is sampled,
    never fed); ``headroom`` extends the top position."""
    top = max(prompt_len + max_new_tokens - 1 + headroom,
              -(-prompt_len // block_len) * block_len)
    return -(-top // block_len)


def chain_prefix_keys(prompt: Any, block_len: int,
                      limit: Optional[int] = None) -> List[str]:
    """Chain-hashed keys for every FULL block of ``prompt``: key ``j``
    commits to tokens ``[0, (j+1)*block_len)``, so equal keys imply equal
    prefixes.  Byte-for-byte the JAX package's keys (blake2b-128 over the
    int32 token bytes)."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    n_full = int(prompt.size) // block_len
    if limit is not None:
        n_full = min(n_full, limit)
    h = hashlib.blake2b(digest_size=16)
    keys: List[str] = []
    for j in range(n_full):
        h.update(prompt[j * block_len:(j + 1) * block_len].tobytes())
        keys.append(h.hexdigest())
    return keys


@dataclasses.dataclass
class ServeRequest:
    """One admitted generation request."""

    request_id: int
    prompt: np.ndarray          # [prompt_len] int32
    max_new_tokens: int
    t_submit: float             # monotonic, stamped at admission
    requeues: int = 0           # infra-failure re-admissions so far
    # retry backoff: a requeued request is not dispatchable before this
    # monotonic instant, and the requeue lane holds its head until then
    not_before: float = 0.0
    trace_id: Optional[str] = None
    # worst-case KV blocks this request pins, stamped at admission so
    # engine placement and admission accounting can never disagree
    blocks_reserved: int = 0
    # absolute SLO deadline (monotonic), stamped once at admission or
    # carried across a KV handoff; the engine sheds an expired request
    # typed before prefill
    deadline: Optional[float] = None
    # speculative-lane hint: an idle engine with a draft model serves the
    # request through greedy speculative decode, a busy one in a slot
    speculative: bool = False
    # KV handoff: an export request runs prefill only and resolves with
    # a handoff descriptor; an import request carries such a descriptor
    # and starts life mid-decode
    export_handoff: bool = False
    import_handoff: Optional[Any] = None


class ServeResponse:
    """Caller-side handle for a submitted request.

    ``result(timeout)`` blocks for the full token sequence (prompt +
    generated, [total] int32 numpy) or raises the typed failure.
    ``ttft_s`` is filled when the first token is produced.  Completion is
    exactly-once: the first ``_complete``/``_fail`` wins."""

    def __init__(self, request: ServeRequest):
        self.request = request
        self.ttft_s: Optional[float] = None
        self._fut: Future = Future()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        return self._fut.result(timeout)

    def done(self) -> bool:
        return self._fut.done()

    def exception(self, timeout: Optional[float] = None):
        return self._fut.exception(timeout)

    # -- engine side ---------------------------------------------------- #
    def _complete(self, tokens: np.ndarray) -> bool:
        if self._fut.done():
            return False
        self._fut.set_result(tokens)
        return True

    def _fail(self, exc: BaseException) -> bool:
        if self._fut.done():
            return False
        self._fut.set_exception(exc)
        return True


class AdmissionController:
    """Bounded, typed admission in front of an engine.

    ``queue_depth``: cap on requests queued but not yet decoding.
    ``max_total_len``: the dense engine's per-request budget (prompt +
    max_new_tokens must fit its decode cache).  ``max_new_tokens_cap``:
    optional per-request generation cap.

    Paged mode (``block_len`` set): ``pool_blocks`` /
    ``max_blocks_per_slot`` are the pool's budgets; ``pool_overcommit``
    scales the admitted set's worst-case demand allowed against the pool;
    ``hard_total_cap`` is the model's ``max_seq_len``;
    ``spec_headroom``: the extra positions a speculative request drafts
    past its budget.  ``slo_policy``: a ``serve.slo.SloPolicy`` whose
    ``deadline_s`` stamps each request's deadline."""

    def __init__(self, queue_depth: int = 64,
                 max_total_len: Optional[int] = None,
                 max_new_tokens_cap: Optional[int] = None,
                 block_len: Optional[int] = None,
                 pool_blocks: Optional[int] = None,
                 max_blocks_per_slot: Optional[int] = None,
                 spec_headroom: int = 0,
                 pool_overcommit: float = 1.0,
                 hard_total_cap: Optional[int] = None,
                 slo_policy: Any = None):
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if block_len is not None and (pool_blocks is None
                                      or max_blocks_per_slot is None):
            raise ValueError("paged admission needs block_len, "
                             "pool_blocks AND max_blocks_per_slot")
        self.queue_depth = queue_depth
        self.max_total_len = max_total_len
        self.max_new_tokens_cap = max_new_tokens_cap
        self.block_len = block_len
        self.pool_blocks = pool_blocks
        self.max_blocks_per_slot = max_blocks_per_slot
        self.spec_headroom = spec_headroom
        self.pool_overcommit = pool_overcommit
        self.hard_total_cap = hard_total_cap
        self.slo_policy = slo_policy
        self._q = TrampolineQueue()
        # the lane in front of the queue: flow-control put-backs
        # (push_front) and the tier's requeues
        self._requeue: deque = deque()
        self._cond = threading.Condition()
        self._depth = 0
        self._outstanding_blocks = 0
        self._closed = False
        self._ids = itertools.count()

    # ------------------------------------------------------------------ #
    @property
    def depth(self) -> int:
        return self._depth

    @property
    def closed(self) -> bool:
        return self._closed

    def submit(self, prompt: Any, max_new_tokens: int,
               speculative: bool = False, *,
               export_handoff: bool = False,
               import_handoff: Optional[Any] = None,
               t_submit: Optional[float] = None,
               deadline: Optional[float] = None,
               trace_id: Optional[str] = None) -> ServeResponse:
        """Admit a request or raise typed: ``RequestRejected`` (can never
        be served), ``QueueFull``/``PoolExhausted`` (backpressure),
        ``ServeCancelled`` (shut down).  ``export_handoff`` reserves the
        prompt bucket and one new token, never decode growth this engine
        will not run; ``import_handoff`` bypasses the depth cap (the
        request was admitted once already) but not the pool check.
        ``t_submit``/``deadline``/``trace_id`` carry the original stamps
        across a handoff."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise RequestRejected("empty prompt")
        if max_new_tokens < 1:
            raise RequestRejected(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if self.max_new_tokens_cap is not None \
                and max_new_tokens > self.max_new_tokens_cap:
            raise RequestRejected(
                f"max_new_tokens {max_new_tokens} exceeds the engine cap "
                f"{self.max_new_tokens_cap}")
        needed = 0
        if self.block_len is not None:
            if self.hard_total_cap is not None \
                    and prompt.size + max_new_tokens > self.hard_total_cap:
                raise RequestRejected(
                    f"prompt ({prompt.size}) + max_new_tokens "
                    f"({max_new_tokens}) exceeds the model's max_seq_len "
                    f"{self.hard_total_cap} (block rounding cannot grant "
                    "positions the model was never shaped for)")
            needed = blocks_for_request(
                int(prompt.size),
                1 if export_handoff else int(max_new_tokens),
                self.block_len, self.spec_headroom if speculative else 0)
            if needed > self.max_blocks_per_slot \
                    or needed > self.pool_blocks:
                raise RequestRejected(
                    f"prompt ({prompt.size}) + max_new_tokens "
                    f"({max_new_tokens}) needs {needed} KV blocks of "
                    f"{self.block_len} tokens, exceeding the per-slot "
                    f"block-table budget ({self.max_blocks_per_slot} "
                    f"blocks = {self.max_blocks_per_slot * self.block_len}"
                    f" tokens) or the whole pool ({self.pool_blocks} "
                    "blocks)")
        elif self.max_total_len is not None \
                and prompt.size + max_new_tokens > self.max_total_len:
            raise RequestRejected(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the decode budget "
                f"{self.max_total_len}")
        with self._cond:
            if self._closed:
                raise ServeCancelled("serve queue is shut down")
            if self._depth >= self.queue_depth and import_handoff is None:
                raise QueueFull(self._depth, self.queue_depth)
            if self.block_len is not None and \
                    self._outstanding_blocks + needed > \
                    self.pool_overcommit * self.pool_blocks:
                raise PoolExhausted(needed, self._outstanding_blocks,
                                    self.pool_blocks, self.pool_overcommit)
            req = ServeRequest(
                next(self._ids), prompt, int(max_new_tokens),
                time.monotonic() if t_submit is None else float(t_submit),
                trace_id=(trace_id if trace_id is not None
                          else mint_trace_id()),
                blocks_reserved=needed, speculative=bool(speculative),
                export_handoff=bool(export_handoff),
                import_handoff=import_handoff)
            if deadline is not None:
                req.deadline = float(deadline)
            elif self.slo_policy is not None \
                    and self.slo_policy.deadline_s is not None:
                req.deadline = req.t_submit + self.slo_policy.deadline_s
            self._outstanding_blocks += needed
            resp = ServeResponse(req)
            self._q.put((req, resp))
            self._depth += 1
            self._cond.notify_all()
        return resp

    def release_blocks(self, req: ServeRequest) -> None:
        """Return a finished/failed request's block reservation to the
        admission budget (exactly once per admitted request; a no-op for
        dense admission)."""
        if req.blocks_reserved <= 0:
            return
        with self._cond:
            self._outstanding_blocks = max(
                0, self._outstanding_blocks - req.blocks_reserved)
            req.blocks_reserved = 0
            self._cond.notify_all()

    def push_front(self, item: Tuple[ServeRequest, ServeResponse]) -> None:
        """Head-of-line put-back for flow control (the pool cannot place
        the popped request right now).  Unlike ``requeue`` this is not an
        infra failure: no requeue count, FIFO order preserved."""
        with self._cond:
            if self._closed:
                item[1]._fail(ServeCancelled(
                    f"request {item[0].request_id} cancelled: engine "
                    "shut down while it awaited pool capacity"))
                return
            self._requeue.appendleft(item)
            self._depth += 1
            self._cond.notify_all()

    def requeue(self, req: ServeRequest, resp: ServeResponse,
                delay_s: float = 0.0) -> bool:
        """Head-of-line re-admission after an infra failure (the replica
        died or wedged mid-chunk).  Bypasses the depth cap.  ``delay_s``
        stamps a retry backoff (``not_before``) that holds the lane, so
        the retry keeps its place while it backs off.  Returns False (and
        fails the response typed) once admission is closed."""
        with self._cond:
            if not self._closed:
                req.requeues += 1
                req.not_before = (time.monotonic() + delay_s
                                  if delay_s > 0 else 0.0)
                self._requeue.append((req, resp))
                self._depth += 1
                self._cond.notify_all()
                return True
        resp._fail(ServeCancelled(
            f"request {req.request_id} cancelled: engine shut down while "
            "it awaited re-dispatch"))
        return False

    def pop(self) -> Optional[Tuple[ServeRequest, ServeResponse]]:
        """Next request or None.  The requeue lane drains first, and a
        lane head still inside its retry backoff holds the lane (None):
        a later admission never overtakes a retry."""
        with self._cond:
            if self._requeue:
                if self._requeue[0][0].not_before > time.monotonic():
                    return None
                self._depth -= 1
                return self._requeue.popleft()
            item = self._q.get_nowait()
            if item is not None:
                self._depth -= 1
            return item

    def wait_for_work(self, timeout: float) -> bool:
        """Block up to ``timeout`` for queued work (or closure)."""
        with self._cond:
            if self._depth == 0 and not self._closed:
                self._cond.wait(timeout)
            return self._depth > 0

    def kick(self) -> None:
        """Wake anything blocked in ``wait_for_work``."""
        with self._cond:
            self._cond.notify_all()

    def shutdown(self) -> int:
        """Idempotent: close admission and cancel everything still queued
        with ``ServeCancelled``.  Returns the number cancelled."""
        with self._cond:
            self._closed = True
            drained: List[Tuple[ServeRequest, ServeResponse]] = \
                list(self._q.shutdown())
            drained.extend(self._requeue)
            self._requeue.clear()
            self._depth = 0
            self._outstanding_blocks = 0
            self._cond.notify_all()
        n = 0
        for req, resp in drained:
            if resp._fail(ServeCancelled(
                    f"request {req.request_id} cancelled: engine shut "
                    "down with it still queued")):
                n += 1
        return n
