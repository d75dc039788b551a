"""Continuous-batching serve engine over a paged or a dense KV cache.

Port of the ``ServeEngine`` of the JAX package's ``serve/engine.py``.
By default (``paged=True``) the engine owns a fixed pool of
``[L, n_blocks, H, block_len, D]`` KV blocks plus a per-slot block table,
and runs two kinds of device work:

- **chunk prefill**: the un-shared suffix of a prompt, right-padded to a
  block multiple, through ``GPT.decode_chunk_paged``, writing its k/v into
  the request's table-mapped blocks and returning the first greedy token;
- **step**: one ``GPT.decode_step_rows_paged`` over ALL slots at per-row
  positions, greedy argmax per row, with a per-row all-finite guard.

Joining, retiring and growing a sequence are host-side table writes.
Prompts are hashed block-wise (a chain hash, so a key commits to the
whole prefix) and full blocks found in the allocator's LRU prefix index
are mapped into the new request's table with a refcount instead of being
prefilled again.  Prompts longer than ``RLA_TPU_SERVE_CHUNK_BLOCKS``
blocks stream in through chunked prefill, interleaved with decode steps.

**Speculative lane**: with a draft model, an idle engine serves a
``submit(..., speculative=True)`` request through greedy speculative
decode: the target's paged prefill, the draft's fixed-length dense
``_prefill`` (flash attention), then rounds in which the draft proposes
``spec_k`` tokens (``models.speculative.build_draft_proposer``) and the
target scores ``[last, d_1 .. d_{k-1}]`` in one ``decode_chunk_paged``
pass into the request's pre-reserved blocks.  Rejected positions are
rewritten before the causal mask exposes them.  A busy engine serves the
same request in a normal slot, with the same tokens.

**KV handoff** (disaggregated prefill/decode): ``submit_handoff`` runs a
prompt's prefill only and resolves with a descriptor whose waves of KV
blocks (``parallel.redistribute.wave_schedule``) sit in the object store
(``runtime.object_store``); ``submit_import`` on another engine
allocates its own blocks, scatters the waves into them (the block-id
remap) and decodes from there.  The source blocks stay pinned until
``release_handoff``.

**SLO**: with an ``SloPolicy`` (``slo="env"`` reads the SLO knobs),
admission stamps each request's deadline, an expired request is shed
typed (``DeadlineExceeded``) before prefill, and TTFT, deadline and
token-cadence observations feed the tracker's burn rate.
``perf_timeline``: any object with ``observe(phase, seconds)``, fed
``"prefill"`` and ``"decode"`` phase times.

**Exactness contract**: greedy only; masked positions contribute
exactly-zero softmax terms, shared prefix blocks and handed-off blocks
hold the same k/v a fresh prefill would write, so the tokens equal those
of the JAX package's engine on the same weights (CPU tests hold the two
to it).

``paged=False`` is the dense engine: a ``[L, max_slots, H,
max_total_len, D]`` cache, prompts right-padded to ``prompt_block``
multiples and prefilled whole through ``GPT._prefill`` (flash
attention), the row joined into its slot with ``GPT.cache_join``, and
one ``GPT.decode_step_rows`` per step.  It has no prefix reuse, chunked
prefill, speculative lane or KV handoff, as in the JAX package.

PyTorch runs eagerly, so there are no compiled programs to memoize; the
cache is updated in place where the JAX engine donates it.  The engine
thread is a daemon and ``stop()`` joins it.  The flight recorder gets the
JAX engine's events with their fields, each request's under its own
trace id: ``serve_admit``, ``serve_prefill_start`` (a streamed prompt),
``serve_prefill``, ``serve_kv_export`` / ``serve_kv_import`` /
``serve_kv_release``, ``serve_decode_step`` (one a step),
``anomaly_trip`` and ``serve_respond``.  With ``RLA_TPU_METRICS_PORT``
set, ``start()`` puts the engine on the process's live plane as
``engine<N>`` (its ``ServeMetrics`` on ``/metrics``, its SLO burn rate
on ``/statusz``) and ``stop()`` takes it off.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analysis import knobs
from ..models.speculative import build_draft_proposer
from ..parallel.redistribute import wave_schedule
from ..runtime import object_store
from ..runtime.guardian import NumericAnomaly
from ..telemetry import recorder
from .batcher import (AdmissionController, PoolExhausted, QueueFull,
                      RequestRejected, ServeCancelled, ServeRequest,
                      ServeResponse, blocks_for_request, chain_prefix_keys)
from .metrics import ServeMetrics
from .slo import SloPolicy, SloTracker

log = logging.getLogger("rla_tpu_torch")

# the live plane's labels of the engines of one process (telemetry/live.py)
_ENGINE_SEQ = itertools.count()


class BlockAllocator:
    """Host-side bookkeeping for the paged pool's physical blocks: a free
    list, per-block refcounts, and an LRU prefix index mapping chain-hash
    keys of FULL prompt blocks to the physical block holding their k/v.

    A freshly allocated block starts at refcount 1; a prefix hit retains
    (+1) the shared block for the new sharer.  ``release`` drops a
    reference; an unreferenced block returns to the free list UNLESS it
    is registered in the prefix index, where it stays resident as
    reusable cache until LRU eviction reclaims it.  Block 0 is the
    reserved garbage block and is never handed out.  One lock: the engine
    loop allocates and releases, the metrics gauge reads from others."""

    def __init__(self, n_blocks: int, block_len: int):
        if n_blocks < 2:
            raise ValueError("the pool needs >= 2 blocks (block 0 is "
                             "the reserved garbage block)")
        if block_len < 1:
            raise ValueError("block_len must be >= 1")
        self.n_blocks = n_blocks
        self.block_len = block_len
        self._lock = threading.Lock()
        self._free: deque = deque(range(1, n_blocks))
        self._ref = np.zeros((n_blocks,), np.int32)
        self._index: "OrderedDict[str, int]" = OrderedDict()  # LRU
        self._key_of: Dict[int, str] = {}

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh blocks at refcount 1, or None when even evicting
        every unreferenced cached prefix block cannot free enough."""
        with self._lock:
            if n <= 0:
                return []
            while len(self._free) < n:
                if not self._evict_one_locked():
                    return None
            out = [self._free.popleft() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
            return out

    def _evict_one_locked(self) -> bool:
        for key, blk in self._index.items():  # oldest (LRU) first
            if self._ref[blk] == 0:
                del self._index[key]
                del self._key_of[blk]
                self._free.append(blk)
                return True
        return False

    def lookup_run(self, keys: List[str], max_blocks: int) -> List[int]:
        """Longest run of prefix-index hits from block 0, each RETAINED
        for the caller (and bumped to MRU), capped at ``max_blocks``."""
        out: List[int] = []
        with self._lock:
            for key in keys[:max_blocks]:
                blk = self._index.get(key)
                if blk is None:
                    break
                self._index.move_to_end(key)
                self._ref[blk] += 1
                out.append(blk)
        return out

    def release(self, block: int) -> None:
        """Drop one reference; unreferenced unregistered blocks go back
        to the free list, registered ones stay cached (evictable)."""
        with self._lock:
            self._ref[block] -= 1
            if self._ref[block] <= 0:
                self._ref[block] = 0
                if block not in self._key_of:
                    self._free.append(block)

    def register(self, key: str, block: int) -> bool:
        """Publish a full prompt block under its chain-hash key.  First
        writer wins; a duplicate stays private and is freed at retire."""
        with self._lock:
            if key in self._index or block in self._key_of:
                return False
            self._index[key] = block
            self._key_of[block] = key
            return True

    def stats(self) -> Dict[str, int]:
        with self._lock:
            used = int((self._ref[1:] > 0).sum())
            cached = sum(1 for b in self._key_of if self._ref[b] == 0)
            return {"total": self.n_blocks - 1, "used": used,
                    "cached": cached, "free": len(self._free)}


class _Slot:
    """Host-side state of one active decode slot."""

    __slots__ = ("req", "resp", "pos", "last", "generated", "remaining",
                 "t_last", "blocks")

    def __init__(self, req: ServeRequest, resp: ServeResponse, pos: int,
                 first_token: int, t_now: float,
                 blocks: Optional[List[int]]):
        self.req = req
        self.resp = resp
        self.pos = pos                    # position of the token to feed
        self.last = first_token           # token to feed next step
        self.generated = [first_token]
        self.remaining = req.max_new_tokens - 1
        self.t_last = t_now               # per-token latency anchor
        self.blocks = blocks              # physical KV blocks (paged)


class _PrefillCursor:
    """A long prompt streaming in through chunked prefill.  The cursor
    owns its blocks-so-far (released exactly once), but its slot's row in
    the table array stays ZEROED until completion: decode feeds inactive
    rows token 0 at position 0, and that write must keep routing to the
    garbage block, not into the half-prefilled prompt's first block."""

    __slots__ = ("req", "resp", "blocks", "shared", "keys", "pos",
                 "chunks", "t_start")

    def __init__(self, req: ServeRequest, resp: ServeResponse,
                 shared: List[int], keys: List[str], pos: int,
                 t_start: float):
        self.req = req
        self.resp = resp
        self.blocks = list(shared)   # grows as chunks land
        self.shared = list(shared)   # prefix-cache hits (refcounted)
        self.keys = keys
        self.pos = pos               # next prompt position to feed
        self.chunks = 0
        self.t_start = t_start


class ServeEngine:
    """Continuous-batching greedy inference over one model replica.

    ``max_slots``: fixed decode batch.  ``queue_depth``: admission cap
    beyond the slots.  ``max_total_len``: per-slot token budget sizing
    the default pool or the dense cache (defaults to the model's
    max_seq_len).  ``paged=False``: the dense engine, whose prompts pad
    to ``prompt_block`` multiples.
    ``block_len``: tokens per KV block; ``n_blocks``: physical blocks in
    the pool (+1 reserved garbage block; the default gives every slot its
    full ``max_total_len``); ``prefix_cache``: shared-prefix reuse;
    ``pool_overcommit``: scales the admission-time block budget.
    ``chunked_prefill``: prompts longer than RLA_TPU_SERVE_CHUNK_BLOCKS
    blocks stream in chunk by chunk between decode steps (big chunks while
    decode is idle, RLA_TPU_SERVE_CHUNK_MIN_BLOCKS-block chunks between
    decode waves), and admission judges prompts against the model's
    max_seq_len (paged only).  ``draft_model`` / ``draft_params`` /
    ``spec_k`` arm the speculative lane (paged only; a draft pins the
    table span to ``max_total_len``, which its dense cache must cover
    with ``spec_k`` to spare).  ``slo``: an ``SloPolicy``, None, or
    ``"env"`` (the SLO knobs; none set means no tracker).
    ``perf_timeline``: an object with ``observe(phase, seconds)``.
    ``handoff_wave_bytes``: the KV handoff's per-wave byte bound
    (RLA_TPU_SERVE_HANDOFF_WAVE_BYTES by default)."""

    def __init__(self, model: Any, params: Any, *, max_slots: int = 4,
                 queue_depth: int = 64,
                 max_total_len: Optional[int] = None,
                 max_new_tokens_cap: Optional[int] = None,
                 prompt_block: int = 8,
                 metrics: Optional[ServeMetrics] = None,
                 perf_timeline: Any = None,
                 idle_poll_s: float = 0.05,
                 paged: bool = True,
                 block_len: int = 16,
                 n_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 pool_overcommit: float = 1.0,
                 draft_model: Any = None,
                 draft_params: Any = None,
                 spec_k: int = 4,
                 slo: Any = "env",
                 handoff_wave_bytes: Optional[int] = None,
                 chunked_prefill: bool = True):
        if model.cfg.sliding_window is not None:
            raise ValueError(
                "the serve engine needs linear cache slots; "
                "sliding_window models are unsupported (their rolling "
                "ring cache cannot slot-join)")
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        W = (max_total_len if max_total_len is not None
             else model.cfg.max_seq_len)
        if W > model.cfg.max_seq_len:
            raise ValueError(
                f"max_total_len {W} exceeds the model's max_seq_len "
                f"{model.cfg.max_seq_len}")
        self.model = model
        self.device = model.device
        # layers unstacked once: each step reads per-layer views
        self.params = model.unstack_layers(params)
        self.max_slots = max_slots
        self.max_total_len = W
        self.metrics = metrics or ServeMetrics()
        self.perf_timeline = perf_timeline
        self._idle_poll_s = idle_poll_s
        self.paged = bool(paged)

        # SLO engine: no policy (or one with no target) means no tracker
        if isinstance(slo, str) and slo == "env":
            slo = SloPolicy.from_env()
        if slo is not None and not isinstance(slo, SloPolicy):
            raise ValueError("slo must be an SloPolicy, None, or 'env'; "
                             f"got {type(slo).__name__}")
        self.slo_policy = slo if slo is not None and slo.enabled else None
        self._slo = (SloTracker(self.slo_policy, self.metrics)
                     if self.slo_policy is not None else None)
        if self._slo is not None:
            self.metrics.bind_slo(self._slo.gauges)

        # speculative lane
        self.draft_model = draft_model
        self.draft_params = None
        self.spec_k = int(spec_k)
        if draft_model is not None:
            self._check_draft(model, draft_model, spec_k)
            self.draft_params = draft_model.unstack_layers(draft_params)
            self._d_propose = build_draft_proposer(
                draft_model, self.draft_params, self.spec_k)

        if self.paged:
            self._init_paged(model, queue_depth, max_new_tokens_cap,
                             block_len, n_blocks, prefix_cache,
                             pool_overcommit, chunked_prefill)
        else:
            self.chunked_prefill = False  # dense rows cannot chunk-join
            self.prompt_block = max(1, int(prompt_block))
            self.batcher = AdmissionController(
                queue_depth=queue_depth, max_total_len=W,
                max_new_tokens_cap=max_new_tokens_cap,
                slo_policy=self.slo_policy)
        self.metrics.bind_queue(lambda: self.batcher.depth)
        # KV handoff: an export's blocks stay pinned here, with its
        # object-store wave refs, until the caller calls release_handoff
        if handoff_wave_bytes is None:
            handoff_wave_bytes = knobs.get_int(
                "RLA_TPU_SERVE_HANDOFF_WAVE_BYTES")
        self.handoff_wave_bytes = max(1, int(handoff_wave_bytes))
        self._handoff_lock = threading.Lock()
        self._handoffs: Dict[int, Tuple[ServeRequest, List[int],
                                        List[Any]]] = {}
        self._handoff_ids = itertools.count()
        # the paged pool or the dense cache
        self._cache: Optional[Dict[str, torch.Tensor]] = None
        self._pool_bytes = 0
        self._slots: List[Optional[_Slot]] = [None] * max_slots
        self._cursors: List[Optional[_PrefillCursor]] = [None] * max_slots
        self._spec_active = 0
        self._stop = threading.Event()
        # this engine's label on the process's live plane while it serves
        self._live_label: Optional[str] = None
        self._cancel_active = False
        self._thread: Optional[threading.Thread] = None

    def _check_draft(self, model: Any, draft_model: Any,
                     spec_k: int) -> None:
        if not self.paged:
            raise ValueError("the speculative lane needs the paged engine "
                             "(its chunk scorer drafts into scratch "
                             "blocks); pass paged=True")
        if spec_k < 1:
            raise ValueError("spec_k must be >= 1")
        if draft_model.cfg.sliding_window is not None:
            raise ValueError("speculative decoding needs a linear draft "
                             "cache (sliding_window unsupported)")
        if draft_model.cfg.vocab_size != model.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {draft_model.cfg.vocab_size} != target "
                f"vocab {model.cfg.vocab_size}")

    def _init_paged(self, model: Any, queue_depth: int,
                    max_new_tokens_cap: Optional[int], block_len: int,
                    n_blocks: Optional[int], prefix_cache: bool,
                    pool_overcommit: float, chunked_prefill: bool) -> None:
        W = self.max_total_len
        self.block_len = int(block_len)
        if self.block_len < 1:
            raise ValueError("block_len must be >= 1")
        drafting = self.draft_model is not None
        # the speculative lane drafts spec_k positions past the budget
        headroom = self.spec_k if drafting else 0
        self.max_blocks_per_slot = -(-(W + headroom) // self.block_len)
        # chunked long-prompt prefill: the per-slot table span widens to
        # the model's max_seq_len; the pool budget bounds what places
        self.chunked_prefill = bool(chunked_prefill)
        self._chunk_blocks = max(1, knobs.get_int(
            "RLA_TPU_SERVE_CHUNK_BLOCKS", 8))
        self._chunk_min_blocks = max(1, min(
            knobs.get_int("RLA_TPU_SERVE_CHUNK_MIN_BLOCKS", 1),
            self._chunk_blocks))
        self.table_blocks = self.max_blocks_per_slot
        if self.chunked_prefill and not drafting:
            self.table_blocks = max(
                self.table_blocks,
                -(-model.cfg.max_seq_len // self.block_len))
        if n_blocks is None:
            n_blocks = self.max_slots * self.max_blocks_per_slot + 1
        if n_blocks < self.max_blocks_per_slot + 1:
            raise ValueError(
                f"n_blocks {n_blocks} cannot hold even one full "
                f"request ({self.max_blocks_per_slot} blocks + the "
                "reserved garbage block)")
        self.n_blocks = int(n_blocks)
        if drafting:
            # the draft's dense cache covers every padded prompt bucket
            # the table can map, plus the drafting headroom (the port
            # raises on a cache write past its end)
            self._draft_cache_len = (self.max_blocks_per_slot
                                     * self.block_len + self.spec_k)
            if self.draft_model.cfg.max_seq_len < self._draft_cache_len:
                raise ValueError(
                    f"draft max_seq_len {self.draft_model.cfg.max_seq_len} "
                    f"< the engine's block-table span + spec_k "
                    f"({self._draft_cache_len})")
        self.prefix_cache = bool(prefix_cache)
        self.allocator = BlockAllocator(self.n_blocks, self.block_len)
        self.batcher = AdmissionController(
            queue_depth=queue_depth,
            block_len=self.block_len,
            pool_blocks=self.n_blocks - 1,
            max_blocks_per_slot=self.table_blocks,
            max_new_tokens_cap=max_new_tokens_cap,
            spec_headroom=headroom,
            pool_overcommit=pool_overcommit,
            hard_total_cap=model.cfg.max_seq_len,
            slo_policy=self.slo_policy)
        self._tables = np.zeros((self.max_slots, self.table_blocks),
                                np.int32)
        self.metrics.bind_pool(self._pool_gauges)
        self.metrics.bind_chunks(lambda: {
            "active_long_prefills": sum(
                1 for c in self._cursors if c is not None)})

    # ------------------------------------------------------------------ #
    # Lifecycle                                                          #
    # ------------------------------------------------------------------ #
    def start(self) -> "ServeEngine":
        if self._thread is not None:
            raise RuntimeError("engine already started")
        if self.paged:
            self._cache = self.model.paged_cache_alloc(self.n_blocks,
                                                       self.block_len)
        else:
            self._cache = self.model.decode_cache_alloc(
                self.max_slots, self.max_total_len)
        self._pool_bytes = sum(t.numel() * t.element_size()
                               for t in self._cache.values())
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rla-torch-serve-engine")
        self._thread.start()
        # the live plane (telemetry/live.py): with RLA_TPU_METRICS_PORT
        # set, this engine's ServeMetrics and SLO burn rate are on the
        # process's /metrics and /statusz while it serves
        from ..telemetry import live
        srv = live.maybe_start_from_env()
        if srv is not None:
            self._live_label = f"engine{next(_ENGINE_SEQ)}"
            srv.sources.add_serve(self._live_label, self.metrics,
                                  slo=self._slo)
        return self

    def stop(self, cancel_active: bool = False,
             timeout: float = 60.0) -> None:
        """Stop admitting; by default FINISH the in-flight slots, cancel
        everything still queued with ``ServeCancelled``, then join the
        loop.  ``cancel_active=True`` cancels in-flight requests too."""
        self._cancel_active = cancel_active
        self._stop.set()
        self.batcher.kick()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        n = self.batcher.shutdown()
        if n:
            self.metrics.inc("cancelled", n)
        # export holds the caller never released: free their blocks and
        # object-store payloads now
        with self._handoff_lock:
            held = list(self._handoffs)
        for hid in held:
            self.release_handoff(hid)
        if self._live_label is not None:
            from ..telemetry import live
            srv = live.get_server()
            if srv is not None:
                srv.sources.remove_serve(self._live_label)
            self._live_label = None

    def __enter__(self) -> "ServeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------------ #
    # Client surface                                                     #
    # ------------------------------------------------------------------ #
    def submit(self, prompt: Any, max_new_tokens: int,
               speculative: bool = False) -> ServeResponse:
        """Admit a request (typed QueueFull/PoolExhausted/RequestRejected
        backpressure); the response resolves to prompt + greedily
        generated tokens.  ``speculative=True`` hints the engine to serve
        this single-stream request through the speculative lane when it
        is idle (needs a draft model; a busy engine uses a slot)."""
        if speculative and self.draft_model is None:
            self.metrics.inc("rejected")
            raise RequestRejected(
                "speculative routing needs a draft model: construct the "
                "engine with draft_model=/draft_params=")
        return self._admit_request(prompt, max_new_tokens,
                                   speculative=speculative)

    def submit_handoff(self, prompt: Any, max_new_tokens: int, *,
                       t_submit: Optional[float] = None,
                       deadline: Optional[float] = None,
                       trace_id: Optional[str] = None) -> ServeResponse:
        """Admit a prefill-only request: the engine prefills the prompt
        into its pool and the response resolves to a KV handoff
        descriptor (a picklable dict that ``submit_import`` on a decode
        engine turns back into a live slot) instead of tokens.  The
        prefilled blocks stay pinned here until ``release_handoff``.
        ``t_submit`` / ``deadline`` / ``trace_id`` carry the client's
        original stamps."""
        if not self.paged:
            self.metrics.inc("rejected")
            raise RequestRejected(
                "KV handoff needs the paged engine (the descriptor is a "
                "block-table span); pass paged=True")
        return self._admit_request(prompt, max_new_tokens,
                                   export_handoff=True, t_submit=t_submit,
                                   deadline=deadline, trace_id=trace_id)

    def submit_import(self, descriptor: Dict[str, Any]) -> ServeResponse:
        """Admit a request whose prefill happened on another engine
        (``descriptor`` is a ``submit_handoff`` result): this engine
        allocates its own blocks, writes the descriptor's waves into them
        and decodes from there; the response resolves to prompt +
        generated tokens as ``submit``'s does.  Bypasses the queue-depth
        cap but not the pool check."""
        if not self.paged:
            self.metrics.inc("rejected")
            raise RequestRejected(
                "KV handoff import needs the paged engine; pass paged=True")
        if int(descriptor.get("block_len", -1)) != self.block_len:
            self.metrics.inc("rejected")
            raise RequestRejected(
                f"handoff block_len {descriptor.get('block_len')} != this "
                f"engine's block_len {self.block_len}: a block-id remap "
                "cannot re-tile blocks")
        return self._admit_request(
            descriptor["prompt"], int(descriptor["max_new_tokens"]),
            import_handoff=descriptor, t_submit=descriptor.get("t_submit"),
            deadline=descriptor.get("deadline"),
            trace_id=descriptor.get("trace_id"))

    def _admit_request(self, prompt: Any, max_new_tokens: int,
                       **lane) -> ServeResponse:
        try:
            resp = self.batcher.submit(prompt, max_new_tokens, **lane)
        except PoolExhausted:
            self.metrics.inc("rejected")
            self.metrics.inc("pool_exhausted")
            raise
        except (QueueFull, RequestRejected):
            self.metrics.inc("rejected")
            raise
        self.metrics.inc("submitted")
        # the request's trace (minted at admission) follows it through
        # admit -> prefill -> respond
        lane_flags = {k: True for k in ("export_handoff", "import_handoff")
                      if lane.get(k) is not None and lane.get(k) is not False}
        recorder.emit("serve_admit", trace=resp.request.trace_id,
                      request=resp.request.request_id,
                      prompt_len=int(resp.request.prompt.size), **lane_flags)
        return resp

    def release_handoff(self, handoff_id: int) -> bool:
        """Drop an export's hold: release its pinned blocks (registered
        prompt blocks stay cached for prefix hits), return its admission
        reservation and delete its object-store payloads.  Idempotent
        (True the first time only); safe from any thread: the allocator,
        the admission controller and the store are each locked, and the
        pool is not touched."""
        with self._handoff_lock:
            held = self._handoffs.pop(handoff_id, None)
        if held is None:
            return False
        req, blocks, refs = held
        for b in blocks:
            self.allocator.release(b)
        self.batcher.release_blocks(req)
        store = object_store.global_store()
        for ref in refs:
            try:
                store.delete(ref)
            except Exception:
                pass  # best effort: an owner that died already unlinked
        recorder.emit("serve_kv_release", request=req.request_id,
                      handoff=handoff_id, blocks=len(blocks))
        return True

    def stats(self) -> Dict[str, Any]:
        out = self.metrics.snapshot()
        if self._slo is not None:
            # the ttft-vs-cadence burn split rides every snapshot
            out["slo_families"] = self._slo.family_rates()
        return out

    # ------------------------------------------------------------------ #
    # Pool gauges (paged)                                                #
    # ------------------------------------------------------------------ #
    def _active_count(self) -> int:
        return (sum(1 for s in self._slots if s is not None)
                + sum(1 for c in self._cursors if c is not None)
                + self._spec_active)

    def _pool_gauges(self) -> Dict[str, Any]:
        """Live block-pool occupancy and device-memory truth.
        ``dense_equivalent_bytes`` is what a dense allocator would pin for
        the same live sequences (one full max-length row each)."""
        st = self.allocator.stats()
        per_block = (self._pool_bytes / self.n_blocks
                     if self._pool_bytes else 0.0)
        row_bytes = per_block * self.max_blocks_per_slot
        used_bytes = st["used"] * per_block
        dense_eq = self._active_count() * row_bytes
        return {
            "block_pool_total": st["total"],
            "block_pool_used": st["used"],
            "block_pool_cached": st["cached"],
            "block_pool_free": st["free"],
            "block_pool_occupancy": (st["used"] / st["total"]
                                     if st["total"] else 0.0),
            "block_len": self.block_len,
            "hbm_cache_bytes": self._pool_bytes,
            "hbm_used_bytes": int(used_bytes),
            "dense_equivalent_bytes": int(dense_eq),
            "cache_waste_ratio": (1.0 - used_bytes / dense_eq
                                  if dense_eq > 0 else 0.0),
        }

    # ------------------------------------------------------------------ #
    # Driver loop                                                        #
    # ------------------------------------------------------------------ #
    def _run(self) -> None:
        try:
            while True:
                if not self._stop.is_set():
                    self._admit()
                active = [i for i, s in enumerate(self._slots)
                          if s is not None]
                prefilling = any(c is not None for c in self._cursors)
                if self._stop.is_set() and self._cancel_active \
                        and (active or prefilling):
                    self._cancel_slots()
                    continue
                if prefilling:
                    # cadence-aware chunk budget: big chunks while decode
                    # is idle, small chunks between decode waves
                    self._advance_prefills(decode_active=bool(active))
                    # a cursor that completed this iteration just armed its
                    # slot's table: recompute the wave so the row decodes
                    # now -- a stale wave would feed token 0 at position 0
                    # THROUGH the armed table and stomp the prompt's KV
                    active = [i for i, s in enumerate(self._slots)
                              if s is not None]
                if active:
                    self._decode_step(active)
                elif prefilling:
                    continue  # cursors advancing; no decode, no sleep
                elif self._stop.is_set():
                    return
                else:
                    self.batcher.wait_for_work(self._idle_poll_s)
        except BaseException as e:  # engine death must fail loudly, typed
            log.error("serve engine loop died: %s", e)
            for i, s in enumerate(self._slots):
                if s is not None:
                    if s.resp._fail(e):
                        self.metrics.inc("failed")
                    self._release_request(s.req, s.blocks)
                self._slots[i] = None
            for i, cur in enumerate(self._cursors):
                if cur is not None:
                    if cur.resp._fail(e):
                        self.metrics.inc("failed")
                    self._release_request(cur.req, cur.blocks)
                self._cursors[i] = None
            n = self.batcher.shutdown()
            if n:  # keep completed + failed + cancelled == submitted
                self.metrics.inc("cancelled", n)
            raise

    # -- device calls ---------------------------------------------------- #
    def _chunk_prefill(self, table: np.ndarray, tokens: np.ndarray,
                       pos0: int, last_rel: int) -> torch.Tensor:
        """Paged chunk prefill of ``tokens`` ([1, P]) at their true
        positions through ``table``; returns the greedy token (on the
        device) of chunk position ``last_rel``."""
        dev = self.device
        logits, self._cache = self.model.decode_chunk_paged(
            self.params, self._cache, torch.from_numpy(table).to(dev),
            torch.from_numpy(tokens).to(dev), pos0, last_index=last_rel)
        return torch.argmax(logits, dim=-1)

    # -- block bookkeeping ---------------------------------------------- #
    def _release_request(self, req: ServeRequest,
                         blocks: Optional[List[int]]) -> None:
        """Return a request's blocks (refcounted) and its admission-time
        reservation; exactly once per placed request."""
        if self.paged:
            for b in blocks:
                self.allocator.release(b)
        self.batcher.release_blocks(req)

    def _observe_pool(self) -> None:
        if self.paged:
            self.metrics.observe_pool(self.allocator.stats()["used"],
                                      self._active_count())

    def _lookup_prefix(self, req: ServeRequest) -> Tuple[List[int],
                                                          List[str]]:
        """Prefix-index lookup for a prompt: (retained shared blocks,
        chain keys).  Keeps >= 1 suffix token: the last prompt position's
        hidden state must actually be computed to produce token 0."""
        if not self.prefix_cache:
            return [], []
        s0 = int(req.prompt.size)
        keys = chain_prefix_keys(req.prompt, self.block_len)
        if keys:
            self.metrics.inc("prefix_lookups")
        shared = self.allocator.lookup_run(keys, (s0 - 1) // self.block_len)
        if shared:
            self.metrics.inc("prefix_hits")
            self.metrics.inc("prefix_hit_blocks", len(shared))
        return shared, keys

    def _place_blocks(self, req: ServeRequest
                      ) -> Optional[Tuple[List[int], List[int], List[str]]]:
        """Prefix-lookup + allocate a request's remaining blocks.
        Returns (blocks, shared, keys) or None when the pool cannot place
        it right now (the caller pushes the request back)."""
        needed = req.blocks_reserved or blocks_for_request(
            int(req.prompt.size), req.max_new_tokens, self.block_len,
            self.spec_k if req.speculative else 0)
        shared, keys = self._lookup_prefix(req)
        fresh = self.allocator.alloc(needed - len(shared))
        if fresh is None:
            for b in shared:
                self.allocator.release(b)
            return None
        return shared + fresh, shared, keys

    def _register_prompt_blocks(self, req: ServeRequest,
                                blocks: List[int], shared: List[int],
                                keys: List[str]) -> None:
        """Publish this prompt's newly computed FULL blocks for future
        prefix hits (partial/pad blocks never register)."""
        if not self.prefix_cache:
            return
        for j in range(len(shared), int(req.prompt.size) // self.block_len):
            self.allocator.register(keys[j], blocks[j])

    # -- admission ------------------------------------------------------ #
    def _pop_admittable(self) -> Optional[Tuple[ServeRequest,
                                                ServeResponse]]:
        """Next queued request still worth serving.  With an SLO tracker,
        a request whose deadline passed while it queued is shed typed
        (``DeadlineExceeded``) here, before any prefill, its block
        reservation returned, and the pop moves on.  (Deadline-met is
        observed at prefill: a pool-full head request is re-popped every
        loop iteration.)"""
        while True:
            item = self.batcher.pop()
            if item is None:
                return None
            req, resp = item
            if self._slo is not None and req.deadline is not None \
                    and time.monotonic() > req.deadline:
                exc = self._slo.shed(req, time.monotonic() - req.t_submit)
                if resp._fail(exc):
                    self.metrics.inc("failed")
                self.batcher.release_blocks(req)
                continue
            return item

    def _admit(self) -> int:
        """Fill free slots from the queue: prefill each request into its
        blocks (or start a prefill cursor for a long prompt, join an
        imported handoff, or serve a hinted request through the
        speculative lane while every slot is idle) and record TTFT."""
        admitted = 0
        for i in range(self.max_slots):
            if self._slots[i] is not None or self._cursors[i] is not None:
                continue
            item = self._pop_admittable()
            if item is None:
                break
            req, resp = item
            if not self.paged:
                try:
                    self._admit_dense(i, req, resp)
                except BaseException as e:
                    # the popped request is in neither the queue nor a
                    # slot: its future must fail here or the client hangs
                    if resp._fail(e):
                        self.metrics.inc("failed")
                    raise
                admitted += 1
                continue
            if self.chunked_prefill and req.import_handoff is None \
                    and not req.speculative and int(req.prompt.size) \
                    > self._chunk_blocks * self.block_len:
                # long prompt: stream it through a prefill cursor the loop
                # advances between decode waves (blocks allocated chunk
                # by chunk)
                self._start_cursor(i, req, resp)
                admitted += 1
                continue
            if req.import_handoff is not None:
                # decode-lane entry: no prefill, a block remap
                if not self._admit_import(i, req, resp):
                    break  # the pool cannot place it now; pushed back
                admitted += 1
                continue
            if req.speculative and self.draft_model is not None \
                    and all(s is None for s in self._slots):
                # idle engine: the single-stream latency lane
                if not self._run_speculative(req, resp):
                    break  # the pool cannot place it now; pushed back
                admitted += 1
                continue
            placed = self._place_blocks(req)
            if placed is None:
                # pool exhausted right now: the FIFO head waits (retires
                # free blocks every step)
                self.batcher.push_front(item)
                break
            blocks, shared, keys = placed
            try:
                self._admit_one(i, req, resp, blocks, shared, keys)
            except BaseException as e:
                # the popped request is in neither the queue nor a slot:
                # its future must fail here or the client hangs
                if resp._fail(e):
                    self.metrics.inc("failed")
                self._release_request(req, blocks)
                raise
            admitted += 1
        return admitted

    def _record_first_token(self, req: ServeRequest, resp: ServeResponse,
                            tok0: torch.Tensor, t_start: float,
                            t_phase: Optional[float] = None
                            ) -> Tuple[int, float]:
        """Bring the first token to the host (the TTFT gate: it must be
        real before it is timed) and record TTFT, the SLO observations
        and the prefill time since ``t_start``; ``perf_timeline`` gets
        the time since ``t_phase`` (default ``t_start``)."""
        first = int(tok0.reshape(-1)[0].item())
        now = time.monotonic()
        resp.ttft_s = now - req.t_submit
        self.metrics.observe_ttft(resp.ttft_s)
        if self._slo is not None:
            self._slo.observe_ttft(resp.ttft_s, req)
            self._slo.observe_deadline_met(req)
        self.metrics.observe_prefill(now - t_start)
        if self.perf_timeline is not None:
            self.perf_timeline.observe(
                "prefill", now - (t_start if t_phase is None else t_phase))
        return first, now

    def _paged_prefill(self, req: ServeRequest, resp: ServeResponse,
                       blocks: List[int], shared: List[int],
                       keys: List[str], slot: int,
                       speculative: bool = False
                       ) -> Tuple[int, np.ndarray, float]:
        """Build the request's table, chunk-prefill the un-shared suffix
        into its blocks, register the new full prompt blocks, and record
        TTFT.  Returns (first token, table row, completion time)."""
        t_a = time.monotonic()
        # queue wait = admission -> this slot-join moment
        self.metrics.observe_queue_wait(t_a - req.t_submit)
        self.metrics.observe_long_prefill(int(req.prompt.size))
        start = len(shared) * self.block_len
        sfx = req.prompt[start:]
        P = -(-int(sfx.size) // self.block_len) * self.block_len
        padded = np.zeros((1, P), np.int32)
        padded[0, :sfx.size] = sfx
        table = np.zeros((self.table_blocks,), np.int32)
        table[:len(blocks)] = blocks
        tok0 = self._chunk_prefill(table, padded, start, int(sfx.size) - 1)
        self.metrics.inc("prefill_chunks")
        self._register_prompt_blocks(req, blocks, shared, keys)
        first, now = self._record_first_token(req, resp, tok0, t_a)
        recorder.emit("serve_prefill", trace=req.trace_id,
                      request=req.request_id, bucket=P, slot=slot,
                      shared_blocks=len(shared), speculative=speculative,
                      ttft_ms=round(resp.ttft_s * 1e3, 3))
        return first, table, now

    def _admit_one(self, i: int, req: ServeRequest, resp: ServeResponse,
                   blocks: List[int], shared: List[int],
                   keys: List[str]) -> None:
        """Prefill one placed request into slot ``i`` (or finish it at
        prefill for a single-token budget)."""
        first, table, now = self._paged_prefill(req, resp, blocks, shared,
                                                keys, slot=i)
        if req.export_handoff:
            # prefill lane: the request's life on this engine ends here;
            # its blocks stay pinned until release_handoff
            self._export_handoff(req, resp, blocks, keys, first)
            self._observe_pool()
            return
        if req.max_new_tokens == 1:
            self._finish(req, resp, [first])
            self._release_request(req, blocks)
        else:
            self._slots[i] = _Slot(req, resp, pos=int(req.prompt.size),
                                   first_token=first, t_now=now,
                                   blocks=blocks)
            self._tables[i, :] = table
        self._observe_pool()

    # -- dense admission -------------------------------------------------- #
    def _bucket(self, s0: int) -> int:
        b = self.prompt_block
        return min(-(-s0 // b) * b, self.max_total_len)

    def _prefill_fn(self, padded: np.ndarray, last_index: int
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Dense bucketed pad-prefill of ``padded`` ([1, P], the prompt
        right-padded): the greedy token (on the device) of position
        ``last_index`` and the row's cache [L, 1, H, P, D]."""
        model = self.model
        h_last, row_cache = model._prefill(
            self.params, torch.from_numpy(padded).to(self.device),
            padded.shape[1], last_index=last_index)
        logits = model._unembed_matmul(h_last, self.params,
                                       model.compute_dtype)
        return torch.argmax(logits, dim=-1), row_cache

    def _admit_dense(self, i: int, req: ServeRequest,
                     resp: ServeResponse) -> None:
        """Prefill one request into dense slot ``i`` (or finish it at
        prefill for a single-token budget)."""
        t_a = time.monotonic()
        self.metrics.observe_queue_wait(t_a - req.t_submit)
        s0 = int(req.prompt.size)
        padded = np.zeros((1, self._bucket(s0)), np.int32)
        padded[0, :s0] = req.prompt
        tok0, row_cache = self._prefill_fn(padded, s0 - 1)
        if req.max_new_tokens > 1:
            # single-token requests finish at prefill; joining their row
            # would copy it for nothing
            self.model.cache_join(self._cache, row_cache, i)
        first, now = self._record_first_token(req, resp, tok0, t_a)
        recorder.emit("serve_prefill", trace=req.trace_id,
                      request=req.request_id, bucket=padded.shape[1],
                      slot=i, shared_blocks=0,
                      ttft_ms=round(resp.ttft_s * 1e3, 3))
        if req.max_new_tokens == 1:
            self._finish(req, resp, [first])
            self._release_request(req, None)
        else:
            self._slots[i] = _Slot(req, resp, pos=s0, first_token=first,
                                   t_now=now, blocks=None)

    # -- chunked long-prompt prefill ------------------------------------- #
    def _start_cursor(self, i: int, req: ServeRequest,
                      resp: ServeResponse) -> None:
        """Begin streaming a long prompt into slot ``i``: the prefix
        lookup happens now (the cursor starts past a hit's blocks), other
        blocks are allocated chunk by chunk.  The slot's table row stays
        zeroed until completion (see :class:`_PrefillCursor`)."""
        t_a = time.monotonic()
        self.metrics.observe_queue_wait(t_a - req.t_submit)
        self.metrics.observe_long_prefill(int(req.prompt.size))
        shared, keys = self._lookup_prefix(req)
        self._cursors[i] = _PrefillCursor(
            req, resp, shared, keys, pos=len(shared) * self.block_len,
            t_start=t_a)
        recorder.emit("serve_prefill_start", trace=req.trace_id,
                      request=req.request_id, slot=i,
                      prompt=int(req.prompt.size),
                      shared_blocks=len(shared), streamed=True)

    def _advance_prefills(self, decode_active: bool) -> None:
        """Advance every streaming prefill by ONE chunk: the big quantum
        while no decode slot is live, the small one between decode
        waves, so decode cadence stays bounded by one small chunk."""
        for i, cur in enumerate(self._cursors):
            if cur is not None:
                self._advance_cursor(i, cur, decode_active)

    def _advance_cursor(self, i: int, cur: _PrefillCursor,
                        decode_active: bool) -> None:
        C = (self._chunk_min_blocks if decode_active
             else self._chunk_blocks) * self.block_len
        rem = int(cur.req.prompt.size) - cur.pos
        if rem <= C:
            self._complete_cursor(i, cur)
            return
        # intermediate chunk at the exact quantum (no pad): allocate the
        # blocks its real positions write, run it through the table, and
        # discard its greedy token (later chunks attend over these blocks)
        need = -(-(cur.pos + C) // self.block_len) - len(cur.blocks)
        if need > 0:
            fresh = self.allocator.alloc(need)
            if fresh is None:
                return  # pool full now; the cursor waits, holding its
                        # blocks-so-far (decode retires free blocks)
            cur.blocks.extend(fresh)
        table = np.zeros((self.table_blocks,), np.int32)
        table[:len(cur.blocks)] = cur.blocks
        chunk = np.ascontiguousarray(
            cur.req.prompt[cur.pos:cur.pos + C].reshape(1, C))
        t0 = time.monotonic()
        self._chunk_prefill(table, chunk, cur.pos, C - 1)
        cur.pos += C
        cur.chunks += 1
        self.metrics.inc("prefill_chunks")
        if self.perf_timeline is not None:
            self.perf_timeline.observe("prefill", time.monotonic() - t0)

    def _complete_cursor(self, i: int, cur: _PrefillCursor) -> None:
        """Final chunk: allocate the request's remaining (decode) blocks,
        run the padded tail, surface the first token, and promote the
        cursor to a live slot (or finish it).  Pad positions past the
        allocated span route to the garbage block through the zeroed
        table tail; in-span pads sit at positions >= s0 that decode
        rewrites before the causal mask exposes them."""
        req, resp = cur.req, cur.resp
        s0 = int(req.prompt.size)
        needed = req.blocks_reserved or blocks_for_request(
            s0, req.max_new_tokens, self.block_len)
        need = needed - len(cur.blocks)
        if need > 0:
            fresh = self.allocator.alloc(need)
            if fresh is None:
                return  # pool full now; retry next loop iteration
            cur.blocks.extend(fresh)
        rem = s0 - cur.pos
        P = -(-rem // self.block_len) * self.block_len
        padded = np.zeros((1, P), np.int32)
        padded[0, :rem] = req.prompt[cur.pos:]
        table = np.zeros((self.table_blocks,), np.int32)
        table[:len(cur.blocks)] = cur.blocks
        t0 = time.monotonic()
        tok0 = self._chunk_prefill(table, padded, cur.pos, rem - 1)
        cur.chunks += 1
        self.metrics.inc("prefill_chunks")
        self._register_prompt_blocks(req, cur.blocks, cur.shared, cur.keys)
        first, now = self._record_first_token(req, resp, tok0, cur.t_start,
                                              t_phase=t0)
        recorder.emit("serve_prefill", trace=req.trace_id,
                      request=req.request_id, bucket=P, slot=i,
                      shared_blocks=len(cur.shared), streamed=True,
                      chunks=cur.chunks,
                      ttft_ms=round(resp.ttft_s * 1e3, 3))
        self._cursors[i] = None
        if req.export_handoff:
            # the prefill lane rides the same cursor
            self._export_handoff(req, resp, cur.blocks, cur.keys, first)
            self._observe_pool()
            return
        if req.max_new_tokens == 1:
            self._finish(req, resp, [first])
            self._release_request(req, cur.blocks)
        else:
            self._slots[i] = _Slot(req, resp, pos=s0, first_token=first,
                                   t_now=now, blocks=cur.blocks)
            self._tables[i, :] = 0
            self._tables[i, :len(cur.blocks)] = cur.blocks
        self._observe_pool()

    # -- KV handoff (disaggregated lanes) -------------------------------- #
    def _export_handoff(self, req: ServeRequest, resp: ServeResponse,
                        blocks: List[int], keys: List[str],
                        first: int) -> None:
        """Ship a just-prefilled request's KV blocks to the object store
        in bounded waves and resolve its response with the handoff
        descriptor (the JAX engine's keys).  Each wave gathers its blocks
        (a copy, so later writes to the pool cannot reach the bytes in
        flight) and brings them to the host; a wave holds exactly its
        blocks, as no program needs a fixed width here.  A bf16 pool
        ships its raw 16-bit words (numpy has no bfloat16) with the
        dtype's name in the payload.  The blocks stay pinned until
        ``release_handoff``."""
        # per-block payload bytes (k + v), measured from the real pool
        per_block = max(1, self._pool_bytes // self.n_blocks)
        waves = wave_schedule([per_block] * len(blocks),
                              self.handoff_wave_bytes)
        store = object_store.global_store()
        refs: List[Any] = []
        wave_out: List[Tuple[int, Any]] = []
        total_bytes = 0
        try:
            for w in waves:
                k, v = self.model.paged_blocks_gather(
                    self._cache, [blocks[j] for j in w])
                payload = _wave_payload(k.cpu(), v.cpu())
                ref = store.put(payload)
                refs.append(ref)
                wave_out.append((len(w), ref))
                total_bytes += payload["k"].nbytes + payload["v"].nbytes
        except BaseException:
            for ref in refs:  # leak no segment on a failed ship
                try:
                    store.delete(ref)
                except Exception:
                    pass
            raise
        hid = next(self._handoff_ids)
        desc = {
            "handoff_id": hid,
            "request_id": req.request_id,
            "prompt": req.prompt,
            "max_new_tokens": req.max_new_tokens,
            "first": first,
            "pos": int(req.prompt.size),
            "keys": list(keys),
            "block_len": self.block_len,
            "wave_cap": max(len(w) for w in waves),
            "waves": wave_out,
            "bytes": total_bytes,
            "t_submit": req.t_submit,
            "deadline": req.deadline,
            "trace_id": req.trace_id,
        }
        with self._handoff_lock:
            self._handoffs[hid] = (req, list(blocks), refs)
        self.metrics.inc("kv_handoffs")
        self.metrics.inc("kv_handoff_bytes", total_bytes)
        recorder.emit("serve_kv_export", trace=req.trace_id,
                      request=req.request_id, handoff=hid,
                      blocks=len(blocks), waves=len(wave_out),
                      bytes=total_bytes)
        if resp._complete(desc):
            self.metrics.inc("completed")

    def _admit_import(self, i: int, req: ServeRequest,
                      resp: ServeResponse) -> bool:
        """Turn a handoff descriptor into a live decode slot: allocate
        this engine's own blocks (no prefix lookup: the shipped bytes are
        the prefix), write the waves into them, register the full prompt
        blocks (only once every wave has landed) and join mid-decode.
        Returns False when the pool cannot place it now (pushed back).  A
        stale ref fails this response with ``ObjectStoreError`` and the
        loop lives on."""
        desc = req.import_handoff
        needed = req.blocks_reserved or blocks_for_request(
            int(req.prompt.size), req.max_new_tokens, self.block_len)
        blocks = self.allocator.alloc(needed)
        if blocks is None:
            self.batcher.push_front((req, resp))
            return False
        try:
            store = object_store.global_store()
            idx = 0
            for count, ref in desc["waves"]:
                k, v = _wave_tensors(store.get(ref))
                self.model.paged_blocks_scatter(
                    self._cache, blocks[idx:idx + count], k, v)
                idx += count
        except object_store.ObjectStoreError as e:
            self._release_request(req, blocks)
            if resp._fail(e):
                self.metrics.inc("failed")
            return True  # consumed; the loop lives on
        except BaseException as e:
            self._release_request(req, blocks)
            if resp._fail(e):
                self.metrics.inc("failed")
            raise
        if self.prefix_cache:
            for j, key in enumerate(desc.get("keys", ())):
                self.allocator.register(key, blocks[j])
        first = int(desc["first"])
        # no TTFT observation: the first token was timed where it was made
        now = time.monotonic()
        recorder.emit("serve_kv_import", trace=req.trace_id,
                      request=req.request_id,
                      handoff=desc.get("handoff_id"),
                      blocks=len(blocks), waves=len(desc["waves"]))
        if req.max_new_tokens == 1:
            self._finish(req, resp, [first])
            self._release_request(req, blocks)
        else:
            self._slots[i] = _Slot(req, resp, pos=int(desc["pos"]),
                                   first_token=first, t_now=now,
                                   blocks=blocks)
            self._tables[i, :] = 0
            self._tables[i, :len(blocks)] = blocks
        self._observe_pool()
        return True

    # -- speculative lane ------------------------------------------------ #
    def _run_speculative(self, req: ServeRequest,
                         resp: ServeResponse) -> bool:
        """Serve one request end to end through greedy speculative decode
        against the paged pool.  Returns False when the pool cannot place
        it now (pushed back, nothing consumed)."""
        placed = self._place_blocks(req)
        if placed is None:
            self.batcher.push_front((req, resp))
            return False
        blocks, shared, keys = placed
        self._spec_active = 1
        try:
            try:
                self._spec_decode(req, resp, blocks, shared, keys)
            except BaseException as e:
                # in neither the queue nor a slot: fail its future here
                if resp._fail(e):
                    self.metrics.inc("failed")
                raise
        finally:
            self._spec_active = 0
            self._release_request(req, blocks)
            self._observe_pool()
        return True

    def _spec_decode(self, req: ServeRequest, resp: ServeResponse,
                     blocks: List[int], shared: List[int],
                     keys: List[str]) -> None:
        """The target's paged prefill (prefix hits included), the draft's
        dense prefill of the padded prompt, then rounds: the draft
        proposes ``spec_k`` tokens, the target scores ``[last, d_1 ..
        d_{k-1}]`` at ``pos ..`` in one chunk pass through the request's
        table, and the agreeing prefix plus the target's correction are
        kept.  ``stop(cancel_active=True)`` interrupts at a round
        boundary."""
        s0 = int(req.prompt.size)
        first, table, now = self._paged_prefill(req, resp, blocks, shared,
                                                keys, slot=-1,
                                                speculative=True)
        self.metrics.inc("speculative_requests")
        self._observe_pool()
        out = [first]
        mx = req.max_new_tokens
        if mx > 1:
            dev, ddev = self.device, self.draft_model.device
            table_t = torch.from_numpy(table).to(dev)
            # the padded prompt bucket, without the dense engine's
            # max_total_len clamp (the table span covers it)
            PB = -(-s0 // self.block_len) * self.block_len
            dpad = np.zeros((1, PB), np.int64)
            dpad[0, :s0] = req.prompt
            _, d_cache = self.draft_model._prefill(
                self.draft_params, torch.from_numpy(dpad).to(ddev),
                self._draft_cache_len, last_index=s0 - 1)
            k = self.spec_k
            t_last_tok = now
            while len(out) < mx:
                if self._stop.is_set() and self._cancel_active:
                    if resp._fail(ServeCancelled(
                            f"request {req.request_id} cancelled "
                            "mid-speculative-decode: engine stopped with "
                            "cancel_active")):
                        self.metrics.inc("cancelled")
                    return
                pos = s0 + len(out) - 1  # the newest real token's slot
                last = torch.tensor([out[-1]], device=ddev)
                d_cache, draft_toks = self._d_propose(d_cache, last, pos)
                drafts = [int(t) for t in draft_toks.tolist()]
                chunk = torch.tensor([[out[-1]] + drafts[:-1]], device=dev)
                t0 = time.monotonic()
                logits, self._cache = self.model.decode_chunk_paged(
                    self.params, self._cache, table_t, chunk, pos)
                greedy = torch.argmax(logits[0], dim=-1).tolist()
                accept = 0
                while accept < k and greedy[accept] == drafts[accept] \
                        and len(out) + accept + 1 < mx:
                    accept += 1
                self.metrics.inc("speculative_tokens_accepted", accept)
                new = drafts[:accept] + [int(greedy[accept])] \
                    if accept < k else drafts[:accept]
                new = new[:mx - len(out)]
                now = time.monotonic()
                self.metrics.observe_spec_round(now - t0, len(new))
                # the round's tokens came from one target pass: each gets
                # an equal share of the time since the last token
                dt_tok = (now - t_last_tok) / max(1, len(new))
                for _ in new:
                    self.metrics.observe_token_latency(dt_tok)
                    if self._slo is not None:
                        self._slo.observe_token(dt_tok, req)
                t_last_tok = now
                out.extend(new)
        self._finish(req, resp, out)

    # -- decode --------------------------------------------------------- #
    def _decode_step(self, active: List[int]) -> None:
        """One batched step over ALL slots (fixed shape); only active rows
        advance host-side.  Inactive rows feed token 0 at position 0 --
        paged: through their all-zero table row, i.e. into the garbage
        block; dense: into their own slot, which the next join rewrites
        before the causal mask can expose it."""
        toks = np.zeros((self.max_slots,), np.int64)
        poss = np.zeros((self.max_slots,), np.int64)
        for i in active:
            s = self._slots[i]
            toks[i] = s.last
            poss[i] = s.pos
        dev = self.device
        t0 = time.monotonic()
        if self.paged:
            logits, self._cache = self.model.decode_step_rows_paged(
                self.params, self._cache,
                torch.from_numpy(self._tables).to(dev),
                torch.from_numpy(toks).to(dev),
                torch.from_numpy(poss).to(dev))
        else:
            # positions go to the model on the host, where it checks
            # they lie inside the cache
            logits, self._cache = self.model.decode_step_rows(
                self.params, self._cache, torch.from_numpy(toks).to(dev),
                torch.from_numpy(poss))
        # greedy token and the numeric guard's per-row health bit, brought
        # to the host together: step k+1's input IS step k's output, so
        # this is the one sync a greedy feed cannot avoid
        row_ok = torch.isfinite(logits).all(dim=-1)
        both = torch.stack([torch.argmax(logits, dim=-1),
                            row_ok.long()]).cpu().numpy()
        nxt, okh = both[0], both[1]
        now = time.monotonic()
        self.metrics.observe_step(now - t0, len(active))
        if self.perf_timeline is not None:
            self.perf_timeline.observe("decode", now - t0)
        # one event a step, not a slot: a slot's identity lives in its
        # request's admit / prefill / respond events
        recorder.emit("serve_decode_step", active=len(active),
                      step_ms=round((now - t0) * 1e3, 3))
        retired = False
        for i in active:
            s = self._slots[i]
            if not bool(okh[i]):
                # non-finite logits for THIS row: fail the one request
                # typed instead of streaming garbage tokens; its blocks go
                # back to the pool and the other rows are untouched
                err = NumericAnomaly.for_trip(
                    step=s.pos, blame="unknown",
                    flags={"decode_logits_nonfinite": True},
                    detail="serve decode produced non-finite logits")
                self.metrics.inc("numeric_anomalies")
                if s.resp._fail(err):
                    self.metrics.inc("failed")
                recorder.emit("anomaly_trip", tier="serve", slot=i,
                              pos=s.pos, request_id=id(s.req))
                self._retire(i)
                retired = True
                continue
            tok = int(nxt[i])
            s.generated.append(tok)
            s.pos += 1
            s.last = tok
            s.remaining -= 1
            gap = now - s.t_last
            self.metrics.observe_token_latency(gap)
            if self._slo is not None:
                self._slo.observe_token(gap, s.req)
            s.t_last = now
            if s.remaining <= 0:
                self._finish(s.req, s.resp, s.generated)
                self._retire(i)  # retire = host-side table write
                retired = True
        if retired:
            self._observe_pool()

    def _retire(self, i: int) -> None:
        """Free slot ``i``: its blocks and reservation go back, and (paged)
        its table row zeroes so later steps write to the garbage block."""
        s = self._slots[i]
        self._release_request(s.req, s.blocks)
        if self.paged:
            self._tables[i, :] = 0
        self._slots[i] = None

    def _finish(self, req: ServeRequest, resp: ServeResponse,
                generated: List[int]) -> None:
        tokens = np.concatenate([req.prompt,
                                 np.asarray(generated, np.int32)])
        if resp._complete(tokens):
            self.metrics.inc("completed")
            recorder.emit("serve_respond", trace=req.trace_id,
                          request=req.request_id, tokens=len(generated))

    def _cancel_slots(self) -> None:
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            if s.resp._fail(ServeCancelled(
                    f"request {s.req.request_id} cancelled mid-decode: "
                    "engine stopped with cancel_active")):
                self.metrics.inc("cancelled")
            self._retire(i)
        for i, cur in enumerate(self._cursors):
            if cur is None:
                continue
            if cur.resp._fail(ServeCancelled(
                    f"request {cur.req.request_id} cancelled "
                    "mid-prefill: engine stopped with cancel_active")):
                self.metrics.inc("cancelled")
            self._release_request(cur.req, cur.blocks)
            self._cursors[i] = None


def _wave_payload(k: torch.Tensor, v: torch.Tensor) -> Dict[str, Any]:
    """One handoff wave for the object store: host k / v as numpy, a
    dtype numpy lacks (bfloat16) as its raw 16-bit words, and the torch
    dtype's name to view them back."""
    name = str(k.dtype).replace("torch.", "")
    if k.dtype == torch.bfloat16:
        k, v = k.view(torch.int16), v.view(torch.int16)
    return {"k": k.numpy(), "v": v.numpy(), "dtype": name}


def _wave_tensors(payload: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k / v tensors of a wave payload, in its shipped dtype."""
    dtype = getattr(torch, payload.get("dtype", "float32"))
    k = torch.from_numpy(np.ascontiguousarray(payload["k"]))
    v = torch.from_numpy(np.ascontiguousarray(payload["v"]))
    if dtype == torch.bfloat16:
        k, v = k.view(torch.bfloat16), v.view(torch.bfloat16)
    return k, v
