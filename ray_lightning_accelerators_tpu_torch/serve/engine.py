"""Continuous-batching serve engine over the block-paged KV pool.

Port of the paged ``ServeEngine`` of the JAX
package's ``serve/engine.py``.  The engine owns a fixed pool of
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

**Exactness contract**: greedy only; masked positions contribute
exactly-zero softmax terms and shared prefix blocks hold the same k/v a
fresh prefill would write, so the tokens equal those of the JAX
package's engine on the same weights (CPU tests hold the two to it).

PyTorch runs eagerly, so there are no compiled programs to memoize; the
pool is updated in place where the JAX engine donates it.  The engine
thread is a daemon and ``stop()`` joins it.

Later slices (the constructor or call raises ``NotImplementedError``):
``paged=False`` (needs ``_prefill`` and flash attention), the speculative
lane, KV handoff, the SLO engine, ``perf_timeline``.  The live metrics
plane and the flight-recorder emits are not part of this slice.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analysis import knobs
from ..core.module import not_ported
from ..runtime.guardian import NumericAnomaly
from .batcher import (AdmissionController, PoolExhausted, QueueFull,
                      RequestRejected, ServeCancelled, ServeRequest,
                      ServeResponse, blocks_for_request, chain_prefix_keys)
from .metrics import ServeMetrics

log = logging.getLogger("rla_tpu_torch")



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
                 first_token: int, t_now: float, blocks: List[int]):
        self.req = req
        self.resp = resp
        self.pos = pos                    # position of the token to feed
        self.last = first_token           # token to feed next step
        self.generated = [first_token]
        self.remaining = req.max_new_tokens - 1
        self.t_last = t_now               # per-token latency anchor
        self.blocks = blocks              # physical KV blocks


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
    the default pool (defaults to the model's max_seq_len).
    ``block_len``: tokens per KV block; ``n_blocks``: physical blocks in
    the pool (+1 reserved garbage block; the default gives every slot its
    full ``max_total_len``); ``prefix_cache``: shared-prefix reuse;
    ``pool_overcommit``: scales the admission-time block budget.
    ``chunked_prefill``: prompts longer than RLA_TPU_SERVE_CHUNK_BLOCKS
    blocks stream in chunk by chunk between decode steps (big chunks while
    decode is idle, RLA_TPU_SERVE_CHUNK_MIN_BLOCKS-block chunks between
    decode waves), and admission judges prompts against the model's
    max_seq_len."""

    def __init__(self, model: Any, params: Any, *, max_slots: int = 4,
                 queue_depth: int = 64,
                 max_total_len: Optional[int] = None,
                 max_new_tokens_cap: Optional[int] = None,
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
                 slo: Any = None,
                 chunked_prefill: bool = True):
        if not paged:
            raise not_ported("paged=False (the dense engine: _prefill, "
                             "flash attention)", "generation")
        if draft_model is not None or draft_params is not None:
            raise not_ported("the speculative lane", "speculative/KV-handoff")
        if slo is not None:
            raise not_ported("the serve SLO engine", "runtime")
        if perf_timeline is not None:
            raise not_ported("perf_timeline", "telemetry")
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
        self._idle_poll_s = idle_poll_s

        self.block_len = int(block_len)
        if self.block_len < 1:
            raise ValueError("block_len must be >= 1")
        self.max_blocks_per_slot = -(-W // self.block_len)
        # chunked long-prompt prefill: the per-slot table span widens to
        # the model's max_seq_len; the pool budget bounds what places
        self.chunked_prefill = bool(chunked_prefill)
        self._chunk_blocks = max(1, knobs.get_int(
            "RLA_TPU_SERVE_CHUNK_BLOCKS", 8))
        self._chunk_min_blocks = max(1, min(
            knobs.get_int("RLA_TPU_SERVE_CHUNK_MIN_BLOCKS", 1),
            self._chunk_blocks))
        self.table_blocks = self.max_blocks_per_slot
        if self.chunked_prefill:
            self.table_blocks = max(
                self.table_blocks,
                -(-model.cfg.max_seq_len // self.block_len))
        if n_blocks is None:
            n_blocks = max_slots * self.max_blocks_per_slot + 1
        if n_blocks < self.max_blocks_per_slot + 1:
            raise ValueError(
                f"n_blocks {n_blocks} cannot hold even one full "
                f"request ({self.max_blocks_per_slot} blocks + the "
                "reserved garbage block)")
        self.n_blocks = int(n_blocks)
        self.prefix_cache = bool(prefix_cache)
        self.allocator = BlockAllocator(self.n_blocks, self.block_len)
        self.batcher = AdmissionController(
            queue_depth=queue_depth,
            block_len=self.block_len,
            pool_blocks=self.n_blocks - 1,
            max_blocks_per_slot=self.table_blocks,
            max_new_tokens_cap=max_new_tokens_cap,
            pool_overcommit=pool_overcommit,
            hard_total_cap=model.cfg.max_seq_len)
        self._tables = np.zeros((max_slots, self.table_blocks), np.int32)
        self.metrics.bind_pool(self._pool_gauges)
        self.metrics.bind_chunks(lambda: {
            "active_long_prefills": sum(
                1 for c in self._cursors if c is not None)})
        self.metrics.bind_queue(lambda: self.batcher.depth)
        self._cache: Optional[Dict[str, torch.Tensor]] = None  # the pool
        self._pool_bytes = 0
        self._slots: List[Optional[_Slot]] = [None] * max_slots
        self._cursors: List[Optional[_PrefillCursor]] = [None] * max_slots
        self._stop = threading.Event()
        self._cancel_active = False
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #
    # Lifecycle                                                          #
    # ------------------------------------------------------------------ #
    def start(self) -> "ServeEngine":
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._cache = self.model.paged_cache_alloc(self.n_blocks,
                                                   self.block_len)
        self._pool_bytes = sum(t.numel() * t.element_size()
                               for t in self._cache.values())
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rla-torch-serve-engine")
        self._thread.start()
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
        generated tokens."""
        if speculative:
            raise not_ported("speculative routing", "speculative/KV-handoff")
        try:
            resp = self.batcher.submit(prompt, max_new_tokens)
        except PoolExhausted:
            self.metrics.inc("rejected")
            self.metrics.inc("pool_exhausted")
            raise
        except (QueueFull, RequestRejected):
            self.metrics.inc("rejected")
            raise
        self.metrics.inc("submitted")
        return resp

    def submit_handoff(self, *args, **kwargs):
        raise not_ported("KV handoff (prefill lane)", "speculative/KV-handoff")

    def submit_import(self, *args, **kwargs):
        raise not_ported("KV handoff (decode lane)", "speculative/KV-handoff")

    def stats(self) -> Dict[str, Any]:
        return self.metrics.snapshot()

    # ------------------------------------------------------------------ #
    # Pool gauges                                                        #
    # ------------------------------------------------------------------ #
    def _active_count(self) -> int:
        return (sum(1 for s in self._slots if s is not None)
                + sum(1 for c in self._cursors if c is not None))

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
                         blocks: List[int]) -> None:
        """Return a request's blocks (refcounted) and its admission-time
        reservation; exactly once per placed request."""
        for b in blocks:
            self.allocator.release(b)
        self.batcher.release_blocks(req)

    def _observe_pool(self) -> None:
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
            int(req.prompt.size), req.max_new_tokens, self.block_len)
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
    def _admit(self) -> int:
        """Fill free slots from the queue: prefill each request into its
        blocks (or start a prefill cursor for a long prompt) and record
        TTFT."""
        admitted = 0
        for i in range(self.max_slots):
            if self._slots[i] is not None or self._cursors[i] is not None:
                continue
            item = self.batcher.pop()
            if item is None:
                break
            req, resp = item
            if self.chunked_prefill and int(req.prompt.size) \
                    > self._chunk_blocks * self.block_len:
                # long prompt: stream it through a prefill cursor the loop
                # advances between decode waves (blocks allocated chunk
                # by chunk)
                self._start_cursor(i, req, resp)
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
                            tok0: torch.Tensor, t_start: float
                            ) -> Tuple[int, float]:
        """Bring the first token to the host (the TTFT gate: it must be
        real before it is timed) and record TTFT and prefill time."""
        first = int(tok0.reshape(-1)[0].item())
        now = time.monotonic()
        resp.ttft_s = now - req.t_submit
        self.metrics.observe_ttft(resp.ttft_s)
        self.metrics.observe_prefill(now - t_start)
        return first, now

    def _paged_prefill(self, req: ServeRequest, resp: ServeResponse,
                       blocks: List[int], shared: List[int],
                       keys: List[str]) -> Tuple[int, np.ndarray, float]:
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
        return first, table, now

    def _admit_one(self, i: int, req: ServeRequest, resp: ServeResponse,
                   blocks: List[int], shared: List[int],
                   keys: List[str]) -> None:
        """Prefill one placed request into slot ``i`` (or finish it at
        prefill for a single-token budget)."""
        first, table, now = self._paged_prefill(req, resp, blocks, shared,
                                                keys)
        if req.max_new_tokens == 1:
            self._finish(req, resp, [first])
            self._release_request(req, blocks)
        else:
            self._slots[i] = _Slot(req, resp, pos=int(req.prompt.size),
                                   first_token=first, t_now=now,
                                   blocks=blocks)
            self._tables[i, :] = table
        self._observe_pool()

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
        self._chunk_prefill(table, chunk, cur.pos, C - 1)
        cur.pos += C
        cur.chunks += 1
        self.metrics.inc("prefill_chunks")

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
        tok0 = self._chunk_prefill(table, padded, cur.pos, rem - 1)
        cur.chunks += 1
        self.metrics.inc("prefill_chunks")
        self._register_prompt_blocks(req, cur.blocks, cur.shared, cur.keys)
        first, now = self._record_first_token(req, resp, tok0, cur.t_start)
        self._cursors[i] = None
        if req.max_new_tokens == 1:
            self._finish(req, resp, [first])
            self._release_request(req, cur.blocks)
        else:
            self._slots[i] = _Slot(req, resp, pos=s0, first_token=first,
                                   t_now=now, blocks=cur.blocks)
            self._tables[i, :] = 0
            self._tables[i, :len(cur.blocks)] = cur.blocks
        self._observe_pool()

    # -- decode --------------------------------------------------------- #
    def _decode_step(self, active: List[int]) -> None:
        """One batched step over ALL slots (fixed shape); only active rows
        advance host-side.  Inactive rows feed token 0 at position 0
        through their all-zero table row, i.e. into the garbage block."""
        toks = np.zeros((self.max_slots,), np.int64)
        poss = np.zeros((self.max_slots,), np.int64)
        for i in active:
            s = self._slots[i]
            toks[i] = s.last
            poss[i] = s.pos
        dev = self.device
        t0 = time.monotonic()
        logits, self._cache = self.model.decode_step_rows_paged(
            self.params, self._cache, torch.from_numpy(self._tables).to(dev),
            torch.from_numpy(toks).to(dev), torch.from_numpy(poss).to(dev))
        # greedy token and the numeric guard's per-row health bit, brought
        # to the host together: step k+1's input IS step k's output, so
        # this is the one sync a greedy feed cannot avoid
        row_ok = torch.isfinite(logits).all(dim=-1)
        both = torch.stack([torch.argmax(logits, dim=-1),
                            row_ok.long()]).cpu().numpy()
        nxt, okh = both[0], both[1]
        now = time.monotonic()
        self.metrics.observe_step(now - t0, len(active))
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
                self._release_request(s.req, s.blocks)
                self._tables[i, :] = 0
                self._slots[i] = None
                retired = True
                continue
            tok = int(nxt[i])
            s.generated.append(tok)
            s.pos += 1
            s.last = tok
            s.remaining -= 1
            self.metrics.observe_token_latency(now - s.t_last)
            s.t_last = now
            if s.remaining <= 0:
                self._finish(s.req, s.resp, s.generated)
                self._release_request(s.req, s.blocks)
                self._tables[i, :] = 0
                self._slots[i] = None  # retire = host-side table write
                retired = True
        if retired:
            self._observe_pool()

    def _finish(self, req: ServeRequest, resp: ServeResponse,
                generated: List[int]) -> None:
        tokens = np.concatenate([req.prompt,
                                 np.asarray(generated, np.int32)])
        if resp._complete(tokens):
            self.metrics.inc("completed")

    def _cancel_slots(self) -> None:
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            if s.resp._fail(ServeCancelled(
                    f"request {s.req.request_id} cancelled mid-decode: "
                    "engine stopped with cancel_active")):
                self.metrics.inc("cancelled")
            self._release_request(s.req, s.blocks)
            self._tables[i, :] = 0
            self._slots[i] = None
        for i, cur in enumerate(self._cursors):
            if cur is None:
                continue
            if cur.resp._fail(ServeCancelled(
                    f"request {cur.req.request_id} cancelled "
                    "mid-prefill: engine stopped with cancel_active")):
                self.metrics.inc("cancelled")
            self._release_request(cur.req, cur.blocks)
            self._cursors[i] = None
