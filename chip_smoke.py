#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

Drives the port's main paths with the GPT-2-small class model (vocab
50304, d_model 768, 12 heads, d_ff 3072, 12 layers, bf16 compute) and
random weights from ``--seed`` -- the paged ``ServeEngine``,
``GPT.generate()``, the dense ``ServeEngine(paged=False)``, a
sliding-window ``generate()``, ``speculative_generate`` and
``Trainer.fit`` at the repo's GPT training benchmark config --, the
``layer_norm`` op, and ``Trainer.fit`` / ``validate`` / ``test`` of the
MNIST MLP, ResNet-18 and ViT at the repo's vision configs, the ranks'
layouts and the MPMD pipeline runner, and checks every hand-written
CUDA kernel on the way:

1. build: compile ``ray_lightning_accelerators_tpu_torch/csrc/*.cu`` for
   sm_90a (one nvcc per source, started together), print each kernel's
   registers and shared memory (``-Xptxas -v``) and check with
   ``cuobjdump -sass`` that K5's and K6's bf16/f16 bodies multiply on the
   tensor cores (HMMA) and their f32 bodies do not;
2. kernels: hold K1 rms_norm, K5 int8_matmul and K6 int8_matmul_nt
   against their plain PyTorch versions on the card at the serve path's
   shapes (K5 and K6 at 1, 16 and, K5, 128 rows in bf16 and one f32 row
   each, also to a relative L2 of 1e-2, timed in turns with
   ``torch._weight_int8pack_mm``; one K5 call is one launch that
   allocates only its output), K2 flash attention at the prefill and
   training shapes (2b), and the flash backward K3a + K3b (split) and K4
   (fused) at the training shapes against the f32 autograd of the plain
   attention (2c), and time each
   (CUDA events, L2 flushed before every launch) beside the plain
   version, one PyTorch library call where there is one (SDPA's backward
   for K3a/K3b/K4), and the least time the card could take (bound), with
   the achieved TFLOP/s, share of the bound and the time of the scalar
   body each bf16 kernel replaced; 2b and 2c fail if bf16 K2, K3a, K3b
   or K4 at the training shape is not below the time its operations
   need on the f32 CUDA cores (the check that the tensor cores ran); 2d
   drives the ``layer_norm`` op (K7) forward and backward, holds K7
   against its plain version at five shapes and times it beside
   ``F.layer_norm``; K1 (at the serve and training shapes) and K7 are
   timed in turns with their library call (``F.rms_norm``,
   ``F.layer_norm``: medians), beside the launch floor (a one-element
   fill) and each wrapper's host microseconds per call;
3. serving: 16 requests with 128-token prompts (half sharing a 64-token
   system prompt, so the prefix cache hits) plus one 400-token prompt
   (so the chunked-prefill cursor runs), 64 new tokens each, through
   ``ServeEngine(max_slots=16, block_len=16, max_total_len=512)``; every
   request must complete, prefix hits and batched steps must happen, and
   each kernel must have launched during the int8 run (counts reset just
   before each run); then a profiled window of batched decode steps
   with bf16 and with int8 weights reports each step's device time side
   by side, the busy share and the port kernels' time a step and a call
   (a measurement, not a check);
   3d: ``generate()`` at the repo's decode benchmark config (batch 16,
   128-token prompts, 128 greedy tokens; bench.py ``bench_decode``) with
   bf16 and int8 weights: prefill and per-token times, tokens/s, and the
   kernels' launch counts (K2 once per layer per prefill), plus the
   greedy agreement with the paged engine on the same prompts;
   3e: the dense engine ``ServeEngine(paged=False, max_slots=16,
   max_total_len=512)`` on phase 3's request set: every request must
   complete and K2 must launch;
   3f: ``generate()`` with a 256-token sliding window (batch 2, 400-token
   prompts, so K2 skips tiles and the prefill scatters a rolling cache),
   its prefill logits against the CPU port, and ``speculative_generate``
   with the model as its own draft (k = 4);
   3g: the engine's lanes.  The speculative lane: 4 single-stream
   128-token requests (64 new) one at a time through
   ``serve_speculative`` on an idle ``ServeEngine(draft_model=<the model
   itself>, spec_k=4)``: all complete, the lane's counters move, K1 and
   K2 (the draft's prefill) launch, the pool drains; accept rate and ms
   a token beside normal slots.  The KV handoff, with bf16 and with int8
   weights (K5, K6 on the decode side): phase 3's 17 requests through
   ``submit_handoff`` on one engine, ``submit_import`` on another and
   ``release_handoff``; every payload read back from the object store
   bitwise equal to the source pool's blocks, ``kv_handoff_bytes`` equal
   to the blocks shipped, blocks and shm bytes back to 0; a 128-token
   and the 400-token request served alone through a handoff and through
   a normal engine, token-identical; export and import ms (GB/s) and
   their stages for the 400-token request;
4. logits: one ``decode_chunk_paged`` pass and one
   ``decode_step_rows_paged`` step on the card (bf16, kernels) against
   the same calls on the CPU in f32 with the plain versions, same weights
   and tokens (4a, 4b), and ``_prefill`` + unembedding of a 128-token
   prompt at 8 positions (4c);
6. training: 6a ``Trainer.fit(GPT(cfg, lr=3e-4))`` at bench.py
   ``bench_gpt``'s config (seq 1024, batch 16, fused loss in 2048-row
   chunks, 1024 flash blocks, so the backward is K4) for 2 epochs of 8
   steps on a learnable token pattern: warm step ms, tokens/s, MFU, peak
   memory, the loss falling, launches per step (K1 25, K2 12, K4 12),
   and one step under torch.profiler for each kernel's share; 6b the
   same fit at 2 layers with the default 512 key blocks (K3a + K3b);
   6c three f32 steps on the card against the CPU port from the same
   weights (loss and params within 1e-3 relative);
7. vision: 7a the MNIST MLP at bench.py ``bench_mnist``'s config (batch
   1024, the committed real-MNIST subset tiled to 24 steps an epoch, 5
   epochs): steady imgs/s, t10k accuracy from ``trainer.test``, peak
   memory; 7b ResNet-18 at ``bench_cifar``'s config (batch 256, SGD
   nesterov, synthetic CIFAR-10, 4 epochs): imgs/s, val accuracy from
   ``validate(datamodule=...)``, peak memory and a profiled step; 7c ViT
   at the default ``ViTConfig`` on the same data: the same, plus K1 13,
   K2 6 and K4 6 launches per step; 7d f32 ResNet-18 (width 8) and a
   small ViT on the card against the CPU port (within 1e-3);
8. mixture-of-experts and the training extras, on the GPT widths above
   with 8 experts (top-2, capacity factor 1.25): 8a phase 3's burst
   through the paged engine with bf16 and int8 weights (every request
   completes, the pool drains, K5 only on the attention projections and
   K6 on the LM head) and a profiled decode step with the MoE layer's
   device time; 8b ``generate()`` at the decode benchmark config; 8c
   prefill logits against the CPU port (f32 within 1e-3; bf16 within
   twice the CPU's own bf16 drift, since bf16 moves tokens to other
   experts) with the expert sets that differ; 8d ``Trainer.fit`` at
   6a's recipe at batch 8 (K1, K2, K4 a step, ``moe_aux_loss``, a
   profiled step with the expert and dispatch/combine products split
   out); 8e f32 MoE training against the CPU port; 8f remat at 6a's
   config under each policy (first-step loss and grad norm, K2 24 or 12
   a step, peak memory) and ``Trainer(int8_matmul=True)`` (K5 24 a
   training step, the last loss within 2% of bf16's; K5 at the training
   shapes beside ``x @ dq``); 8g BPE over the committed text corpus ->
   ``StreamingLMDataset`` -> ``Trainer.fit`` with an EMA (the loss
   falls, validation reads the shadow);
9. data parallelism over spawned ranks: 9a 6a's fit (same seed and
   data) through ``Trainer(accelerator=RayAccelerator(num_workers=1,
   use_gpu=True))``, one rank over an NCCL group of world size 1 (the
   machine has one card): the rank on cuda:0 over NCCL, one gradient
   all-reduce a step (CUDA events in the rank), K1 25, K2 12 and K4 12
   launches a step counted in the rank, rank 0's weights in the
   driver's module equal to its checkpoint, the first loss bitwise and
   the last within 1% of 6a's, ``trainer.test`` in the same world, warm
   step ms beside 6a's, spawn and rendezvous seconds, all-reduce ms; 9b
   two ranks sharing the card over gloo (``DistributedWorld(2,
   backend="gloo")``), 8 rows each of one global batch of 16, one step:
   the averaged grad norm and the params against one in-process step on
   all 16 rows (1e-2, bf16), the gloo all-reduce of the 124M-element
   bucket timed;
10. sharded data parallelism: 10a one epoch of 6a's fit through
   ``Trainer(accelerator=RayTPUAccelerator(1, use_fsdp=True),
   grad_compression="int8", checkpoint_format="sharded")``, one rank
   over NCCL (world size 1: fsdp=1 splits nothing, the int8 two-phase
   exchange's arithmetic runs on the card): one int8 exchange per
   compressible leaf a step, residuals nonzero, K1 25, K2 12, K4 12 a
   step in the rank, the first loss bitwise and the step-8 loss within
   7e-6 of 6a's, the exchange's ms a step, the checkpoint verified and
   restored bitwise; 10b two gloo ranks sharing the card, ``Trainer.fit``
   of 6a's widths at 4 layers (cut from 12 for the time limit) for 2
   steps on one global batch of 16 under data parallelism, ZeRO-1,
   FSDP and FSDP + int8 (512 key blocks: K3a + K3b, whose backward is
   reproducible) against 2 in-process steps on all rows (1e-2, bf16),
   each rank's state bytes within 5% of the plan's prediction, ZeRO-1
   bitwise the data-parallel run, the 2-rank sharded checkpoint restored
   into a world-1 trainer (params bitwise, residuals reset), the gather,
   reduce-scatter and all-to-all times;
11. the model-parallel axes: one step over NCCL at world size 1 (the
   rank's groups made by ``new_group`` on NCCL), then two gloo ranks
   sharing the card (the card is one), 3 bf16 steps of 6a's full-width
   GPT at 4 layers (``MP_LAYERS``; phases 11-13 ran 12 until PR 19) on
   one global batch of 8 against 3 in-process steps on the same rows
   (1e-2, bf16): 11a ``tensor=2`` (K1 9, K2 4, K4 4 a step on each
   rank, each rank's params and moments within 1% of the plan's
   prediction, the replicated leaves bitwise equal across the ranks),
   11b ``seq_parallel=2`` Ulysses (K1 9, K2 4, K4 4), 11c ring (K1 9,
   no flash kernel), 11d ``expert=2`` on 8d's MoE GPT (K1 9, K2 4, K4
   4, the expert leaves halved); each with its step time and each
   collective's calls and CUDA-event ms a step;
12. the 2-D layouts and the pipeline axis, gloo ranks sharing the card,
   3 bf16 steps of the same GPT on a global batch of 8 against 3
   in-process steps (1e-2): 12a fsdp=2 x tensor=2 over 4 ranks (the
   logged global grad norm too, each rank's params and moments within
   0.1 MiB of the plan, a 4-rank sharded checkpoint restored bitwise,
   K1 9, K2 4, K4 4 a step), 12b ``int8_matmul=True`` at tensor=2
   (K5 8 a step on each rank), 12c ``pipeline=2`` with 4 microbatches
   (K1 21, K2 10, K4 10 a step on each rank: 2 layers for 5 ticks; the
   activations' hops by all-gather and their ms), 12d ``pipeline=2 x
   tensor=2`` on 12a's 4 ranks (the same launches a step, the logged
   grad norm, the hops within each tensor coordinate's pipeline group),
   12e ViT at the default config at ``pipeline=2`` on 12b's 2 ranks (no
   schedule: each rank launches what one in-process ViT step does);
13. the MPMD pipeline runner (``parallel/mpmd``): two stage workers
   spawned by ``PipelineRunner``, both on the one card, activations
   crossing the shm object store, each case against an in-process run
   on the card (same seed, split into 4 microbatches, accumulation
   order): 13a the port's PipelineBoringModel (f32) under 1F1B and
   GPipe, 3 steps (losses within 1e-5, no failure charged, measured and
   analytic bubble); 13b 6a's GPT layers as stages (2 a stage, bf16,
   global batch 8 of 1024 tokens, 3 steps: losses and params within
   1e-2, K1 96 / K2 48 / K4 24 launched in stage 0's worker and 48 /
   24 / 24 in stage 1's, step wall, busy and handoff ms); 13c a crash of
   stage 1's worker at step 2 replayed (one replay, stage 1 charged,
   losses within 1e-5 of 13a's); 13d 13b's stages at ``fsdp=2``: 4
   workers on the card in 2 gloo groups, 13b's limits against its
   in-process run, each member's owned params against the plan (half of
   each leaf of 4096 elements or more), 13b's launches on each member,
   the groups' collective ms a step;
14. Tune (``tune/``): 14a ``tune.run`` over a grid of 2 learning rates
   (cut from 3 for the time limit),
   each trial fitting 6a's GPT (one step an epoch, 6 epochs) through
   ``RayAccelerator(num_workers=1, use_gpu=True)`` (one rank over NCCL),
   ``TuneReportCallback`` every epoch and a checkpoint-only tune callback
   at fit end (the whole state through the world's query channel); a
   scheduler defined here STOPs the second trial at its second report:
   it ends STOPPED with 2 iterations and its rank at step 2, the other
   TERMINATED with 6; the first reported loss is 6a's bitwise; K1 25, K2
   12 and K4 12 launches a step in each rank; the best checkpoint
   restores into the GPT with its ``global_step`` and the fit's weights;
   no rank outlives ``tune.run``; each trial's wall, spawn seconds,
   report query ms and the checkpoint payload's bytes and ms; 14b
   ``trial_executor="process"``: two trials fitting 4 steps in their own
   subprocess (forked from the trial forkserver, no accelerator) and
   reporting each step over the queue, and one that ``os._exit``s: the
   two TERMINATED with pids other than the driver's, their first loss
   6a's bitwise, the launches each counted in its subprocess, the crash
   ERROR and the experiment complete; 14c ``tune.autotune_step`` with 4
   trials over ``default_step_space()``, the measure the median of 3
   warm steps of 6a's fit (CUDA events): every config and its ms, the
   default as trial 0, the best no slower than it, every config
   measured (a ``gather_mode="scan"`` one as the tree gather, since PR
   21, as the JAX Trainer falls back outside the compressed-FSDP regime);
15. the Trainer's single-card defaults (``guard="auto"``,
   ``prefetch_batches=2``, ``cache_dataset_on_device="auto"``): 15a 6a's
   GPT fit at the defaults and with the three off: K1 25, K2 12, K4 12 a
   step, the losses of the two runs, the warm step ms of each and in
   turns, and the guard's device ms in a profiled step (profiler ranges
   around its work, ``_guard_ranges``); 15b 7a's MNIST MLP on the
   whole-epoch path (the cached step loop never runs), the host path
   with and without the producer thread and the old defaults: imgs/s,
   the device-idle share of a profiled epoch, the weights bitwise equal;
   15c a NaN row in a small f32 model's data: the card's
   ``NumericAnomaly`` the CPU port's, the quarantine ledger and a second
   fit skipping the batch; 15d the native batch engine's batches
   bitwise the Python loader's at 7a's arrays, batches/s of each; 15e
   fit -> test -> predict over one NCCL rank, the data shipped once
   (``ship_stats``), the store removed at teardown;
16. fault tolerance on one host (``runtime/{watchdog,preemption,
   elastic}.py``, ``testing/chaos.py``), at 6a's GPT unless a line says
   otherwise: 16a the preemption drain in process (SIGTERM after step
   5 of 8: ``preempt-step5.ckpt``, ``Preempted``, ``fit(ckpt_path=
   "last")``; the first resumed loss bitwise the drained run's next-step
   loss, the rest within 1e-3 of an uninterrupted run; the checkpoint's
   bytes, the drain's and the resume's seconds); 16b ``ElasticRunner``
   over ``ActorPool(1)`` with ``crash@rank0:step2:once`` (the retry's
   first loss bitwise a clean continuation from the same checkpoint, the
   dead worker's memory back, death to first step split into respawn,
   CUDA init, restore and first step, the goodput fraction); 16c
   ``Trainer(accelerator=RayAccelerator(1, use_gpu=True),
   worker_deadline_s=30)`` with ``hang@rank0:step2:once``
   (``WorkerWedged`` within the deadline plus 15 s, the memory back, a
   second fit to its end); 16d ``badbatch@step3`` rewound by
   ``ElasticRunner(max_rewinds=2)`` at 2 layers (typed
   ``NumericAnomaly``, one rewind, the window skipped, params against a
   clean run); 16e ``Trainer(pipeline_stages=2, worker_deadline_s=4)``
   with ``hang@stage1:step2:once`` (stage 1 reaped and replayed, losses
   against an in-process run); K1 / K2 / K4 25 / 12 / 12 a step after
   each recovery (16a-16c);
17. host agents and the live resize (``runtime/agent.py``, ``cli.py``,
   ``Trainer.resize_in_memory``): 17a an agent started with the port's
   CLI in a subprocess (``--port 0``, loopback), then 6a's fit at full
   width for 3 steps through ``RayTPUAccelerator(1, agents=[addr])``:
   one NCCL rank the agent spawned (its spawn_count 1 after fit and
   after validate), K1 / K2 / K4 25 / 12 / 12 a step, the losses within
   10a's 7e-6 of 6a's; spawn, first-step and warm-step times; 17b two
   gloo ranks sharing the card at 6a's widths and 2 layers under ZeRO-1:
   1 step, ``resize_in_memory(1)``, 1 live step, ``resize_in_memory(2)``
   (a rank spawned), 1 live step; the 3 losses within 1e-2 of one
   uninterrupted in-process run, no ``.ckpt`` written, each resize's
   bytes moved, waves, seconds and the card's free bytes;
18. telemetry on the card (``utils/profiler.py``, ``telemetry/``): 18a
   6a's fit for 8 steps with ``profiler=Profiler()`` and the perf
   observatory, its HBM ledger sampling every step: each step's phases
   within its wall, the pools no more than the ledger's total (the
   card's ``memory_allocated``), params and opt_state at 4 N and 8 N
   bytes, ``profiler.mfu`` equal to 6a's formula, the registry's JSON
   keys and Prometheus lines, the warm step ms beside 6a's and, in turns
   on the same trainer, with the two detached and attached; 18b two warm
   steps inside ``Profiler.trace``: ``trace_op_summary`` and
   ``rla-tpu-torch trace`` in process, K1 / K2 / K4 at 25 / 12 / 12
   trace events a step, as their launch counters say, with their self ms
   and shares;
19. the live plane and multi-slice meshes (``telemetry/live.py``,
   ``parallel/mesh.py`` ``build_hybrid_mesh``): 19a two in-process
   loopback host agents, one gloo rank each on the card,
   ``RayTPUAccelerator(1, agents=[a, b], dcn_data=2)`` at 6a's widths and
   4 layers for 10 steps with ``RLA_TPU_METRICS_PORT=0``: both ranks'
   portfiles and ``/healthz`` ok, the driver's ``/metrics`` scraped
   mid-fit with both ranks' series and a growing ``global_step``, one
   rank an agent along ``data``, K1 / K2 / K4 9 / 4 / 4 a step in each
   rank, the losses within 1e-2 of one in-process run; each endpoint's
   scrape ms and the warm step ms with and without a 10 Hz scraper; 19b
   the paged engine (12 layers, bf16) with an SLO policy serving 16
   requests alone and under a 10 Hz scraper: ``engine<N>`` with its
   burn rate on ``/statusz``, its series on ``/metrics``, K1 launched;
   decode step p50 / p99 both ways;
20. the serving tier (``serve/replicas.py``, ``serve/controller.py``):
   ``ServeReplicas`` over engine replicas forked from the port's
   forkserver (checked to hold no CUDA context), each building phase 3's
   weights from the seed on the one card: 20a two bf16 replicas serve
   phase 3's 17 requests, token-identical to 3a, K1 launched in each
   replica, compile counts flat over a second wave; 20b two int8
   replicas under ``crash@replica0:chunk2:once`` and
   ``hang@replica1:chunk2:once`` with a forced SLO burn and
   ``max_replicas=3``: every request answered once and token-identical
   to 3b (first ``P20B_NEW`` tokens), both replicas revived through the
   breaker, one scale-up and one drain, K5 / K6 launched in a surviving
   replica; 20c one prefill and one decode replica: every request through
   a KV handoff, prefix routes that hit, tokens identical to 3a (the
   400-token prompt to an engine serving it alone, see
   ``phase_tier_lanes``),
   no shm segment left; the tier's tokens/s beside 3a's engine, TTFT
   p50 / p99, death to a revived replica's first chunk, the hang's
   detection, hedges and the handoff's ms a request are printed;
21. the analysis layer (``testing/spmd_sanitizer.py``, ``analysis/``):
   21a 6a's GPT at ``MP_LAYERS`` over 2 gloo ranks on the card, the
   ranks booted with ``RLA_TPU_SPMD_SANITIZER=1``, four fits in turns
   with the sanitizer off, on, on, off: K1 / K2 / K4 9 / 4 / 4 a step on
   each rank, the sequences equal, step 1's loss bitwise in all four;
   the records a step by op and axes, a spill's ms and the warm step ms
   both ways; 21b rank
   1 of a gloo world over CUDA tensors issues one ``all_reduce`` more and
   blocks: ``ElasticRunner`` raises ``CollectiveMismatch`` naming call #1
   after one attempt, the seconds from dispatch printed; 21c
   ``assert_no_new_compiles`` around 6a's warm steps and a warm 3a
   engine's decode, 0 builds each, a ``compile_count_record`` line; 21d
   ``scripts/torch_graftlint.py`` over the port's tree: 0 active
   findings, its seconds;
5. card identity (``nvidia-smi``), the kernels JSON line, and the result
   line ``{"ok": true, "device": {...}}`` last.

Any failed phase ends the run with a non-zero exit and no result line; so
does a machine without a CUDA device, or a directory without the port.

    python3 chip_smoke.py [--seed 0]
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Optional

import numpy as np
import torch

try:  # phases 9-16's workers unpickle this module's classes by name
    from ray_lightning_accelerators_tpu_torch import Callback as _Callback
    from ray_lightning_accelerators_tpu_torch import (
        RayTPUAccelerator as _RayTPUAccelerator)
    from ray_lightning_accelerators_tpu_torch import (
        TorchModule as _TorchModule)
    from ray_lightning_accelerators_tpu_torch import (
        TuneReportCallback as _TuneReportCallback)
    from ray_lightning_accelerators_tpu_torch.tune.callbacks import (
        _TuneCheckpointCallback)
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT as _GPT)
except ImportError:  # no port beside the script: main() says so
    _Callback = _RayTPUAccelerator = _TorchModule = _GPT = object
    _TuneReportCallback = _TuneCheckpointCallback = object

HERE = os.path.dirname(os.path.abspath(__file__))
# the card every phase runs on (a CPU rehearsal of the control flow at a
# small size may point these at the CPU and a host timer)
DEV = "cuda"


def sync() -> None:
    torch.cuda.synchronize()


# H100 SXM published rates (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

CFG = dict(vocab_size=50304, d_model=768, n_heads=12, d_ff=3072,
           n_layers=12, max_seq_len=512)
SLOTS, BLOCK_LEN, MAX_TOTAL = 16, 16, 512
PROMPT, SYSTEM, LONG_PROMPT, NEW_TOKENS = 128, 64, 400, 64


def log(msg: str) -> None:
    print(msg, flush=True)


class Phases:
    """Collects failures; a failed check never stops the later phases from
    reporting, but any failure ends the run non-zero."""

    def __init__(self):
        self.failures = []
        self.seconds = {}     # each phase's wall seconds, by name

    def check(self, ok: bool, what: str) -> bool:
        log(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.failures.append(what)
        return ok

    def run(self, name: str, fn, *args):
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            return fn(*args)
        except Exception:
            self.failures.append(f"{name}: {traceback.format_exc()}")
            log(f"  [FAIL] {name} raised:\n{traceback.format_exc()}")
            return None
        finally:
            self.seconds[name] = time.perf_counter() - t0
            log(f"  ({self.seconds[name]:.2f} s)")


# --------------------------------------------------------------------- #
# timing                                                                 #
# --------------------------------------------------------------------- #
_flush_buf = None


def _event_ms(fns, rounds: int):
    """Device ms of every call when ``fns`` run in that order ``rounds``
    times: CUDA events around each call, with the 50 MB L2 flushed before
    it (decode finds its weights cold).  One list of times per fn."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    pairs = [[] for _ in fns]
    for _ in range(rounds):
        for fn, got in zip(fns, pairs):
            _flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            got.append((s, e))
    torch.cuda.synchronize()
    return [[s.elapsed_time(e) for s, e in got] for got in pairs]


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of ``fn`` per call, L2 flushed before each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return float(np.mean(_event_ms([fn], iters)[0]))


def time_in_turns(kernel, library, rounds: int = 20):
    """Median device times (kernel, library) per call, taken in turns --
    library, kernel, kernel, library, each L2-flushed -- so both see the
    same card state: 2 * rounds calls each."""
    for _ in range(3):
        library()
        kernel()
    torch.cuda.synchronize()
    lib_a, ker_a, ker_b, lib_b = _event_ms(
        [library, kernel, kernel, library], rounds)
    return float(np.median(ker_a + ker_b)), float(np.median(lib_a + lib_b))


def launch_floor_ms() -> float:
    """The launch floor: a one-element fill timed as ``time_ms`` times a
    call (40 calls, L2 flushed), its median beside the kernels' medians
    (the mean is printed too): the part of a small call that no kernel
    body can remove."""
    t = torch.zeros(1, device=DEV)
    fill = _event_ms([lambda: t[:1].zero_()], 40)[0]
    log(f"  launch floor (a one-element fill): median "
        f"{np.median(fill) * 1e3:.2f} us, mean {np.mean(fill) * 1e3:.2f}")
    return float(np.median(fill))


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call: ``perf_counter`` over ``calls`` calls
    with no synchronise inside the loop (what the caller's thread pays)."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    sync()
    return us


def host_us_in_turns(port, library, calls: int = 1000, rounds: int = 3):
    """(port, library) host us per call, the minimum of 2 * rounds runs
    each, taken in turns: library, port, port, library."""
    got = {port: [], library: []}
    for _ in range(rounds):
        for f in (library, port, port, library):
            got[f].append(host_us(f, calls))
    return min(got[port]), min(got[library])


def _turns_row(kernel: str, name: str, shape: str, err: float, fn, plain,
               library, bound, floor_ms: float) -> dict:
    """A timing row of a kernel timed in turns with its library call (with
    its plain version where PyTorch has no such call): the kernel's, the
    plain version's and the library call's means as ``time_ms`` reads them
    (``ms``, ``plain_ms``, ``library_ms``, as every other kernel row), the
    kernel's and the library call's medians in turns (``median_ms``,
    ``library_median_ms``), the launch floor, the median's share of the
    bound and the earlier time."""
    median_ms, partner_ms = time_in_turns(fn, library or plain)
    return dict(kernel=kernel, name=name, shape=shape, err=err,
                ms=time_ms(fn), plain_ms=time_ms(plain),
                library_ms=time_ms(library) if library else None,
                median_ms=median_ms,
                library_median_ms=partner_ms if library else None,
                floor_ms=floor_ms, bound=bound,
                bound_share=bound[0] / median_ms,
                earlier_us=EARLIER_US.get((kernel, shape)))


def _log_turns_rows(rows, library: str) -> None:
    log(f"  kernel  shape                        median_us  mean_us  "
        f"plain_us  {library}_us (median, mean)  floor_us  bound_us (by)  "
        f"median of bound  earlier_us")
    for r in rows:
        was = "" if r["earlier_us"] is None else f"{r['earlier_us']:.2f}"
        lib = ("n/a" if r["library_ms"] is None else
               f"{r['library_median_ms'] * 1e3:.2f}, "
               f"{r['library_ms'] * 1e3:.2f}")
        log(f"  {r['kernel']:<6}  {r['shape']:<27}  "
            f"{r['median_ms'] * 1e3:<9.2f}  {r['ms'] * 1e3:<7.2f}  "
            f"{r['plain_ms'] * 1e3:<8.2f}  {lib:<{len(library) + 18}}  "
            f"{r['floor_ms'] * 1e3:<8.2f}  "
            f"{r['bound'][0] * 1e3:.3f} ({r['bound'][1]})  "
            f"{r['bound_share']:.3f}  {was}")


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------- #
# phases                                                                 #
# --------------------------------------------------------------------- #
def phase_build(ph: Phases):
    from ray_lightning_accelerators_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_logs()
    log(f"  built {sorted(logs)} for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s from {_build.CSRC}")
    for stem, text in sorted(logs.items()):
        for line in text.splitlines():
            if any(k in line for k in ("Compiling entry", "Used",
                                       "spill", "error")):
                log(f"  ptxas[{stem}] {line.strip()}")
    ph.check(set(logs) >= {"attention", "attention_bwd", "norms", "quant"},
             "attention.cu, attention_bwd.cu, norms.cu and quant.cu built")
    # K5 and K6: the bf16/f16 bodies multiply on the tensor cores (HMMA in
    # their SASS), the f32 bodies do not
    counts = _sass_counts(_build.library_path("quant"), "HMMA")
    for fn, n in sorted(counts.items()):
        log(f"  sass[quant] {n:4d} HMMA  {fn}")
    tc = {f: n for f, n in counts.items() if "_tc" in f}
    f32 = {f: n for f, n in counts.items() if "_f32" in f}
    ph.check(len(tc) == 18 and all(n > 0 for n in tc.values())
             and len(f32) == 2 and not any(f32.values()),
             f"quant: HMMA in all {len(tc)} tensor-core bodies, none in the "
             f"{len(f32)} f32 bodies")


def _sass_counts(lib: str, opcode: str) -> dict:
    """Instructions of ``opcode`` in each kernel of a built library, as
    ``cuobjdump -sass`` lists them, by function name."""
    from ray_lightning_accelerators_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and opcode in line:
            counts[fn] += 1
    return counts


def phase_kernels(ph: Phases, seed: int):
    """Each kernel against its plain version at the serve path's shapes.
    Tolerances: the kernel and the plain version both accumulate in f32
    and round once to bf16, so they may differ by one bf16 rounding
    (2^-8 relative) plus f32 summation-order noise: rtol 1e-2, and an atol
    of 1e-2 of the output's largest magnitude."""
    from ray_lightning_accelerators_tpu_torch.ops import norms, quant
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    bf = torch.bfloat16
    d, f, V = CFG["d_model"], CFG["d_ff"], CFG["vocab_size"]
    rows = []

    def close(got, ref):
        err = (got.float() - ref.float()).abs().max().item()
        lim = 1e-2 * ref.float().abs().max().item()
        ok = torch.allclose(got.float(), ref.float(), rtol=1e-2, atol=lim)
        return ok, err

    # the first timed call of a process pays one-time costs (flush buffer,
    # event pool); pay them on a throwaway measurement
    x0 = torch.randn(16, d, generator=g, device=dev).to(bf)
    time_ms(lambda: norms.rms_norm_reference(x0, x0[0]))
    floor = launch_floor_ms()
    rms_lib = torch.nn.functional.rms_norm

    # K1 rms_norm: rows = slots at decode, chunk length at prefill (bf16
    # scale, as the serve path casts its weights); the GPT training step
    # (phase 6a, 16 x 1024 tokens at d 768) and ViT's (phase 7c, 256
    # images x 64 patches at d 256) normalize bf16 activations with the
    # f32 master scale
    for m, dk, sdt in ((16, d, bf), (128, d, bf),
                       (256 * 64, 256, torch.float32),
                       (16 * 1024, d, torch.float32)):
        x = torch.randn(m, dk, generator=g, device=dev).to(bf)
        s = (1.0 + 0.1 * torch.randn(dk, generator=g, device=dev)).to(sdt)
        got = norms.rms_norm(x, s)
        ok, err = close(got, norms.rms_norm_reference(x, s))
        f32_scale = sdt == torch.float32
        tag = ",scale f32" if f32_scale else ""
        ph.check(ok and got.dtype == bf,
                 f"K1 rms_norm [{m},{dk}] bf16{tag.replace(',', ', ')} "
                 f"max|err|={err:.3e}")
        sl = s.to(bf)
        nbytes = 2 * m * dk * 2 + dk * s.element_size()
        rows.append(_turns_row(
            "K1", "rms_norm", f"rows={m},d={dk}{tag}", err,
            lambda: norms.rms_norm(x, s),
            lambda: norms.rms_norm_reference(x, s),
            lambda: rms_lib(x, (dk,), sl, 1e-6),
            bound_ms(nbytes, 4 * m * dk, F32_FLOPS), floor))
    _log_turns_rows(rows, "F.rms_norm")
    x = torch.randn(16, d, generator=g, device=dev).to(bf)
    s = torch.ones(d, device=dev, dtype=bf)
    port_us, lib_us = host_us_in_turns(lambda: norms.rms_norm(x, s),
                                       lambda: rms_lib(x, (d,), s, 1e-6))
    log(f"  host per call at [16,{d}] bf16 (1000 calls, no sync inside): "
        f"norms.rms_norm {port_us:.2f} us, F.rms_norm {lib_us:.2f} us")
    rows[0]["host_us"], rows[0]["library_host_us"] = port_us, lib_us
    # the wrappers' stream lookup against the Stream object they built
    # before (what their host path lost besides the library lock)
    from ray_lightning_accelerators_tpu_torch.ops import _build
    raw_us, obj_us = host_us_in_turns(
        lambda: _build.stream_of(x),
        lambda: torch.cuda.current_stream(x.device).cuda_stream)
    log(f"  stream lookup per call: _build.stream_of {raw_us:.2f} us, "
        f"torch.cuda.current_stream(dev).cuda_stream {obj_us:.2f} us")

    # K5 int8_matmul: q/k/v/o (768x768), MLP up (768x3072), down
    # (3072x768) at one live row, at 16 (decode) and at a 128-token
    # prefill chunk; K6 int8_matmul_nt: the tied unembedding at decode
    # (M = live slots).  bf16 (tensor cores), then one f32 row each (CUDA
    # cores), each timed in turns with _weight_int8pack_mm
    q8 = []
    for m in (1, 16, 128):
        for k, n in ((d, d), (d, f), (f, d)):
            q8.append(("K5", m, k, n, bf))
    q8 += [("K6", 1, d, V, bf), ("K6", 16, d, V, bf),
           ("K5", 16, d, f, torch.float32), ("K6", 16, d, V, torch.float32)]
    q8_rows = []
    for kernel, m, k, n, dt in q8:
        x = torch.randn(m, k, generator=g, device=dev)
        if kernel == "K5":
            wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                               dtype=torch.int8)
            sc = (torch.rand(n, generator=g, device=dev) + 0.5) * 0.03 / 127
            x = x.to(dt)
            w_nk = wq.T.contiguous()
            fn = (lambda x=x, wq=wq, sc=sc: quant.int8_matmul(x, wq, sc))
            plain = (lambda x=x, wq=wq, sc=sc:
                     quant.int8_matmul_reference(x, wq, sc))
            nbytes = m * k * x.element_size() + k * n + n * 4 + \
                m * n * x.element_size()
            name = "int8_matmul"
        else:
            sv = (torch.rand(k, generator=g, device=dev) + 0.5) * 0.1 / 127
            x = (x * sv).to(dt)                   # scales folded into x
            wq = w_nk = torch.randint(-127, 128, (n, k), generator=g,
                                      device=dev, dtype=torch.int8)
            sc = torch.ones(n, device=dev)
            fn = lambda x=x, wq=wq: quant.int8_matmul_nt(x, wq)
            plain = lambda x=x, wq=wq: quant.int8_matmul_nt_reference(x, wq)
            nbytes = m * k * x.element_size() + n * k + \
                m * n * x.element_size()
            name = "int8_matmul_nt"
        got, ref = fn(), plain()
        if dt == torch.float32:
            err = (got - ref).abs().max().item()
            ok = torch.allclose(got, ref, rtol=1e-4, atol=1e-4 * ref.abs()
                                .max().item())
        else:
            ok, err = close(got, ref)
        rel = _rel_l2(got, ref)
        tag = "" if dt == bf else f" {str(dt).split('.')[-1]}"
        shape = f"M={m},K={k},N={n}{tag}"
        ph.check(ok and rel <= 1e-2 and got.dtype == dt,
                 f"{kernel} {name} {shape} max|err|={err:.3e} rel L2="
                 f"{rel:.3e} (limit 1e-2)")
        q8_rows.append(_turns_row(
            kernel, name, shape, err, fn, plain,
            _int8pack_call(x, w_nk, sc),
            bound_ms(nbytes, 2 * m * k * n,
                     BF16_TENSOR_FLOPS if dt == bf else F32_FLOPS), floor))
    _log_turns_rows(q8_rows, "_weight_int8pack_mm")
    rows += q8_rows

    # one int8_matmul call is one kernel launch, and allocates its output
    # and nothing else
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(16, d, generator=g, device=dev).to(bf)
    wq = torch.randint(-127, 128, (d, f), generator=g, device=dev,
                       dtype=torch.int8)
    sc = torch.ones(f, device=dev)
    quant.int8_matmul(x, wq, sc)
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = quant.int8_matmul(x, wq, sc)
        sync()
    extra = torch.cuda.max_memory_allocated() - base
    launched = [e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA]
    ph.check(len(launched) == 1 and "int8_mm_kernel_tc" in launched[0]
             and extra <= -(-out.numel() * out.element_size() // 512) * 512,
             f"K5 M=16,K={d},N={f}: one call launched {launched} and "
             f"allocated {extra} bytes (its output: "
             f"{out.numel() * out.element_size()})")
    return rows


def _int8pack_call(x, w_nk, scales):
    """PyTorch's one-call weight-only int8 product (x @ (w_nk * s).T), as
    the yardstick, where this build runs it on CUDA; else None."""
    op = getattr(torch, "_weight_int8pack_mm", None)
    if op is None:
        return None
    try:
        op(x, w_nk, scales.to(x.dtype))
        sync()
    except Exception as e:  # not every build has a CUDA kernel for it
        log(f"  (library yardstick _weight_int8pack_mm unavailable: "
            f"{type(e).__name__})")
        return None
    s = scales.to(x.dtype)
    return lambda: op(x, w_nk, s)


def _to(tree, **kw):
    if isinstance(tree, dict):
        return {k: _to(v, **kw) for k, v in tree.items()}
    return tree.to(**kw)


def _cast_floats(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def _requests(seed: int):
    rng = np.random.default_rng(seed)
    V = CFG["vocab_size"]
    system = rng.integers(0, V, SYSTEM).astype(np.int32)
    reqs = []
    for i in range(SLOTS):
        if i % 2 == 0:   # half share the system prompt
            p = np.concatenate([system, rng.integers(
                0, V, PROMPT - SYSTEM).astype(np.int32)])
        else:
            p = rng.integers(0, V, PROMPT).astype(np.int32)
        reqs.append(p)
    reqs.insert(SLOTS // 2, rng.integers(0, V, LONG_PROMPT).astype(np.int32))
    return reqs


def _reset_counts():
    from ray_lightning_accelerators_tpu_torch.ops import (attention, norms,
                                                          quant)
    attention.flash_forward.launches = 0
    norms.rms_norm.launches = 0
    norms.layer_norm.launches = 0
    quant.int8_matmul.launches = 0
    quant.int8_matmul_nt.launches = 0


def _read_counts():
    from ray_lightning_accelerators_tpu_torch.ops import (attention, norms,
                                                          quant)
    return {"flash_attention": attention.flash_forward.launches,
            "rms_norm": norms.rms_norm.launches,
            "layer_norm": norms.layer_norm.launches,
            "int8_matmul": quant.int8_matmul.launches,
            "int8_matmul_nt": quant.int8_matmul_nt.launches}


def phase_serve(ph: Phases, model, params, label: str, seed: int,
                expect_q8: bool):
    from ray_lightning_accelerators_tpu_torch.serve import ServeEngine
    reqs = _requests(seed)
    # warm-up (cuBLAS handles, allocator pools) outside the counted run
    with ServeEngine(model, params, max_slots=SLOTS, block_len=BLOCK_LEN,
                     max_total_len=MAX_TOTAL) as eng:
        eng.submit(reqs[1], 4).result(timeout=600)
    sync()
    _reset_counts()
    t0 = time.perf_counter()
    with ServeEngine(model, params, max_slots=SLOTS, block_len=BLOCK_LEN,
                     max_total_len=MAX_TOTAL) as eng:
        resps = [eng.submit(p, NEW_TOKENS) for p in reqs]
        outs = [r.result(timeout=900) for r in resps]
    sync()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    st = eng.stats()
    V = CFG["vocab_size"]
    done = all(o.shape == (p.size + NEW_TOKENS,)
               and (o[:p.size] == p).all() and (o >= 0).all()
               and (o < V).all() for o, p in zip(outs, reqs))
    ph.check(done and st["completed"] == len(reqs),
             f"{label}: {st['completed']}/{len(reqs)} requests completed "
             f"with {NEW_TOKENS} new in-vocab tokens each")
    ph.check(st["prefix_hits"] > 0,
             f"{label}: prefix_hits={st['prefix_hits']} "
             f"(hit blocks {st['prefix_hit_blocks']})")
    ph.check(st["steps_batch_gt1"] > 0,
             f"{label}: steps_batch_gt1={st['steps_batch_gt1']} "
             f"(max batch {st['max_batch']})")
    ph.check(st["longest_prefill_tokens"] == LONG_PROMPT
             and st["prefill_chunks"] > len(reqs),
             f"{label}: chunked prefill ran (prefill_chunks="
             f"{st['prefill_chunks']} for {len(reqs)} requests)")
    ph.check(launches["rms_norm"] > 0,
             f"{label}: K1 rms_norm launches={launches['rms_norm']}")
    if expect_q8:
        ph.check(launches["int8_matmul"] > 0 and launches["int8_matmul_nt"]
                 > 0, f"{label}: K5 int8_matmul launches="
                      f"{launches['int8_matmul']}, K6 int8_matmul_nt "
                      f"launches={launches['int8_matmul_nt']}")
    ttft, step = st["ttft_s"], st["decode_step_s"]
    log(f"  {label}: {st['tokens_generated']} tokens in {wall:.2f} s wall; "
        f"throughput_tok_s={st['throughput_tok_s']:.1f} "
        f"ttft_p50_ms={ttft['p50_s'] * 1e3:.2f} "
        f"ttft_p99_ms={ttft['p99_s'] * 1e3:.2f} "
        f"decode_step_p50_ms={step['p50_s'] * 1e3:.3f} "
        f"decode_step_p99_ms={step['p99_s'] * 1e3:.3f} "
        f"steps={st['steps']} launches={json.dumps(launches)}")
    return {"launches": launches, "tokens": outs, "wall_s": wall,
            "stats": {
        k: st[k] for k in ("throughput_tok_s", "tokens_generated", "steps",
                           "prefix_hits", "prefill_chunks", "max_batch",
                           "completed", "block_pool_used")},
        "ttft_p50_ms": ttft["p50_s"] * 1e3,
        "ttft_p99_ms": ttft["p99_s"] * 1e3,
        "decode_step_p50_ms": step["p50_s"] * 1e3,
        "decode_step_p99_ms": step["p99_s"] * 1e3}


def phase_profile(model, params, label: str, seed: int):
    """Where a batched decode step's time goes (16 live rows at position
    128): host-clock wall per step, the device's kernel time per step from
    torch.profiler, their ratio (the device busy share), kernels launched
    per step, and the top kernels by device time.  A measurement, not a
    check: without device times from the profiler it reports them as not
    measured."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(seed + 9)
    B, per_row, ctx = SLOTS, 9, PROMPT
    pool = model.paged_cache_alloc(1 + B * per_row, BLOCK_LEN)
    tables = torch.zeros(B, MAX_TOTAL // BLOCK_LEN, dtype=torch.long)
    for r in range(B):
        tables[r, :per_row] = 1 + r * per_row + torch.arange(per_row)
    dev = torch.device(DEV)
    tables = tables.to(dev)
    toks = torch.from_numpy(rng.integers(0, CFG["vocab_size"], B)).to(dev)
    pos = torch.full((B,), ctx, dtype=torch.long, device=dev)
    p = model.unstack_layers(params)

    def steps(n):
        for _ in range(n):
            logits, _ = model.decode_step_rows_paged(p, pool, tables, toks,
                                                     pos)
            logits.argmax(-1).cpu()     # the engine's per-step feed sync

    n = 10
    steps(3)
    sync()
    t0 = time.perf_counter()
    steps(n)
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(n)
    gpu_events = _device_events(prof)
    dev_us = sum(e.device_time_total for e in gpu_events) / n
    out = {"wall_ms_per_step": wall_ms,
           "device_ms_per_step": dev_us / 1e3 if gpu_events else None,
           "busy_share": (dev_us / 1e3 / wall_ms) if gpu_events else None,
           "device_ops_per_step": len(gpu_events) / n}
    averages = [e for e in prof.key_averages()
                if not e.key.startswith(MOE_RANGE_PREFIX)]
    top = sorted(averages,
                 key=lambda e: -getattr(e, "self_device_time_total", 0.0))
    # the port's kernels in the step: device us a step and a call
    out["port_kernels"] = {}
    for kernel, key in (("K1 rms_norm", "rms_norm_kernel"),
                        ("K5 int8_matmul", "int8_mm_kernel"),
                        ("K6 int8_matmul_nt", "int8_mm_nt_kernel")):
        hits = [e for e in averages if key in e.key
                and getattr(e, "self_device_time_total", 0.0) > 0]
        us = sum(e.self_device_time_total for e in hits)
        calls = sum(e.count for e in hits)
        if calls:
            out["port_kernels"][kernel] = (us / n, calls / n, us / calls)
    out["top"] = [(e.key[:60], getattr(e, "self_device_time_total", 0.0)
                   / n) for e in top[:8]]
    # device us a step under the ranges _moe_ranges() opens (none unless
    # an MoE model runs inside it)
    out["ranges"] = {k: ms * 1e3 / n for k, ms in _range_ms(prof).items()}
    if gpu_events:
        log(f"  {label}: decode step wall {wall_ms:.3f} ms, device "
            f"{dev_us / 1e3:.3f} ms -> busy share {out['busy_share']:.3f}; "
            f"{out['device_ops_per_step']:.0f} device ops per step")
        for name, us in out["top"]:
            log(f"    {us:9.1f} us/step  {name}")
        for kernel, (us, calls, per) in out["port_kernels"].items():
            log(f"    {kernel}: {us:.1f} us/step in {calls:.0f} calls, "
                f"{per:.2f} us a call")
    else:
        log(f"  {label}: decode step wall {wall_ms:.3f} ms; device time "
            "not measured (the profiler saw no device events)")
    return out


def phase_profiles(model, params, q8, seed: int):
    """phase_profile with bf16 and with int8 weights, and the int8 step's
    device time beside the bf16 one."""
    out = {label: phase_profile(model, p, label, seed)
           for label, p in (("bf16", params), ("int8", q8))}
    dev_ms = [out[k]["device_ms_per_step"] for k in ("bf16", "int8")]
    if None not in dev_ms:
        log(f"  decode step device time: int8 {dev_ms[1]:.3f} ms, bf16 "
            f"{dev_ms[0]:.3f} ms (int8 - bf16 = "
            f"{dev_ms[1] - dev_ms[0]:+.3f} ms)")
    return out


def phase_logits(ph: Phases, cfg_obj, params_gpu, label: str, seed: int):
    """The card (bf16 compute, CUDA kernels) against the port on the CPU
    (f32 compute, plain versions), same weights and tokens.  Tolerance:
    12 layers of bf16 activations give a relative L2 logit error of order
    1e-2; the check allows 5e-2."""
    from ray_lightning_accelerators_tpu_torch.models.transformer import GPT
    rng = np.random.default_rng(seed + 7)
    V = CFG["vocab_size"]
    live, n, B, nb = 4, 48, SLOTS, 1 + 4 * 4
    toks = rng.integers(0, V, (live, n)).astype(np.int64)
    tables = np.zeros((B, 32), np.int64)
    for r in range(live):
        tables[r, :4] = 1 + 4 * r + np.arange(4)
    step_tok = rng.integers(0, V, B).astype(np.int64)
    step_pos = np.zeros(B, np.int64)
    step_pos[:live] = n

    def run(model, params):
        pool = model.paged_cache_alloc(nb, BLOCK_LEN)
        chunk = []
        for r in range(live):
            lg, pool = model.decode_chunk_paged(
                params, pool, torch.from_numpy(tables[r]),
                torch.from_numpy(toks[r:r + 1]), 0)
            chunk.append(lg.float().cpu())
        lg, pool = model.decode_step_rows_paged(
            params, pool, torch.from_numpy(tables),
            torch.from_numpy(step_tok), torch.from_numpy(step_pos))
        return torch.cat(chunk, 0), lg[:live].float().cpu()

    gpu = GPT(cfg_obj, device=DEV, compute_dtype=torch.bfloat16)
    cpu = GPT(cfg_obj, device="cpu", compute_dtype=torch.float32)
    g_chunk, g_step = run(gpu, params_gpu)
    c_chunk, c_step = run(cpu, _cast_floats(_to(params_gpu, device="cpu"),
                                            torch.float32))
    out = {}
    for what, a, b in (("chunk", g_chunk, c_chunk), ("step", g_step, c_step)):
        rel = ((a - b).norm() / b.norm()).item()
        err = (a - b).abs().max().item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        finite = bool(torch.isfinite(a).all())
        ph.check(finite and rel <= 5e-2,
                 f"{label} {what} logits {tuple(a.shape)}: rel L2 err="
                 f"{rel:.3e} max|err|={err:.3e} (|ref| max "
                 f"{b.abs().max().item():.3e}) greedy agreement="
                 f"{agree:.3f}")
        out[what] = {"rel_l2": rel, "max_abs_err": err, "greedy_agree": agree}
    return out


# K2 at the prefill and training shapes: (bh, seq, head_dim, causal,
# window, dtype).  generate() at the bench config prefills [16*12, 128,
# 64]; the engines prefill one request at a time, [12, P, 64] for P in
# {128, 400}; ViT's training step (phase 7c) attends over its 64 patches
# without a mask at [256*4, 64, 64]; the GPT training step (phase 6a)
# runs [16*12, 1024, 64] causal.
FLASH_SHAPES = [
    (192, 1024, 64, True, None, torch.bfloat16),
    (1024, 64, 64, False, None, torch.bfloat16),
    (192, 128, 64, True, None, torch.bfloat16),
    (12, 128, 64, True, None, torch.bfloat16),
    (12, 400, 64, True, None, torch.bfloat16),
    (12, 512, 64, True, None, torch.bfloat16),
    (12, 400, 64, True, 256, torch.bfloat16),
    (12, 256, 128, True, None, torch.bfloat16),
    (12, 128, 64, False, None, torch.bfloat16),
    (12, 400, 64, True, None, torch.float32),
]


# K2, K3a, K3b and K4 per call with their scalar bodies, before the
# tensor-core ones (us, on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md's
# kernel table), printed beside this run's times.  K2 at the training
# shape is the mean of its 12 calls in a profiled 6a step before the
# redesign (14.48 ms): a warm in-step mean, not a per-call time with the
# L2 flushed as the rest are.
EARLIER_US = {
    ("K2", "[192,1024,64] bfloat16 causal"): 1206.67,
    ("K2", "[1024,64,64] bfloat16 full"): 83.45,
    ("K2", "[192,128,64] bfloat16 causal"): 48.23,
    ("K2", "[12,128,64] bfloat16 causal"): 26.36,
    ("K2", "[12,400,64] bfloat16 causal"): 62.69,
    ("K2", "[12,512,64] bfloat16 causal"): 78.29,
    ("K2", "[12,400,64] bfloat16 causal window=256"): 51.90,
    ("K2", "[12,256,128] bfloat16 causal"): 98.26,
    ("K2", "[12,128,64] bfloat16 full"): 25.06,
    ("K2", "[12,400,64] float32 causal"): 67.45,
    ("K3a", "[192,1024,64] bfloat16 causal"): 3358.20,
    ("K3a", "[1024,64,64] bfloat16 full"): 156.31,
    ("K3a", "[12,256,128] bfloat16 causal"): 82.71,
    ("K3a", "[12,400,64] bfloat16 causal window=256"): 86.05,
    ("K3a", "[12,400,64] float32 causal"): 105.32,
    ("K4", "[192,1024,64] bfloat16 causal"): 5303.12,
    ("K4", "[1024,64,64] bfloat16 full"): 261.83,
    ("K4", "[12,256,128] bfloat16 causal"): 149.13,
    ("K4", "[12,400,64] bfloat16 causal window=256"): 168.33,
    ("K4", "[12,400,64] float32 causal"): 205.92,
    ("K3b", "[192,1024,64] bfloat16 causal"): 3888.30,
    ("K3b", "[1024,64,64] bfloat16 full"): 186.50,
    ("K3b", "[12,256,128] bfloat16 causal"): 106.36,
    ("K3b", "[12,400,64] bfloat16 causal window=256"): 122.23,
    ("K3b", "[12,400,64] float32 causal"): 152.24,
    # K1 and K7 before their redesign for one trip to memory and a
    # persistent row stream, as time_ms's means (PERF.md's kernel table)
    ("K1", "rows=16,d=768"): 9.24,
    ("K1", "rows=128,d=768"): 7.58,
    ("K1", "rows=16384,d=256,scale f32"): 15.10,
    ("K7", "rows=16,d=768 bfloat16"): 8.45,
    ("K7", "rows=16384,d=768 bfloat16"): 32.50,
    ("K7", "rows=16384,d=256 bfloat16"): 17.92,
    ("K7", "rows=4096,d=768 float32"): 15.36,
    ("K7", "rows=4096,d=768 float32 mean=10"): 15.91,
    ("K7", "rows=1000,d=200 bfloat16"): 7.27,
    # K5 and K6 before their redesign for the tensor cores: medians in
    # turns with _weight_int8pack_mm (PERF.md's kernel table)
    ("K5", "M=1,K=768,N=768"): 18.96,
    ("K5", "M=1,K=768,N=3072"): 28.78,
    ("K5", "M=1,K=3072,N=768"): 27.87,
    ("K5", "M=16,K=768,N=768"): 18.70,
    ("K5", "M=16,K=768,N=3072"): 28.77,
    ("K5", "M=16,K=3072,N=768"): 29.26,
    ("K5", "M=128,K=768,N=768"): 28.26,
    ("K5", "M=128,K=768,N=3072"): 62.46,
    ("K5", "M=128,K=3072,N=768"): 79.87,
    ("K6", "M=1,K=768,N=50304"): 201.41,
    ("K6", "M=16,K=768,N=50304"): 230.08,
    ("K5", "M=16,K=768,N=3072 float32"): 28.80,
    ("K6", "M=16,K=768,N=50304 float32"): 204.50,
}
# the shape at which the bf16 attention kernels must beat the f32 CUDA
# cores' floor (their operations at 67 TFLOP/s): a time below it needs
# the tensor cores
TC_FLOOR_SHAPE = "[192,1024,64] bfloat16 causal"


def _check_tensor_cores(ph, kernel: str, shape: str, ms: float,
                        flops: float):
    floor_ms = flops / F32_FLOPS * 1e3
    ph.check(ms < floor_ms,
             f"{kernel} {shape}: {ms * 1e3:.2f} us, below the "
             f"{floor_ms * 1e3:.2f} us its {flops / 1e9:.1f} GFLOP need "
             f"on the f32 CUDA cores (67 TFLOP/s): the tensor cores ran")


def flash_work(bh: int, s: int, d: int, causal: bool, window, elem: int):
    """(bytes, flops) the attention needs: q, k, v read once and out
    written once plus the f32 lse; two products of 2*d flops for every
    (query, key) pair the mask keeps."""
    if window is not None:
        pairs = sum(min(i + 1, window) for i in range(s))
    elif causal:
        pairs = s * (s + 1) // 2
    else:
        pairs = s * s
    return 4 * bh * s * d * elem + 4 * bh * s, 4 * bh * pairs * d


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def phase_flash(ph: Phases, seed: int):
    """K2 against its plain version at the prefill and training shapes.
    Tolerances: both sides take f32 products and sums, round p to v's
    dtype and the output once; bf16 outputs may differ by a rounding:
    rtol 2e-2 with an atol of 2e-2 of the largest |out| (f32: 1e-4), and a
    relative L2 over the whole output of the same size.  The atol is set
    by the largest |out| (row 0 of a causal head is v[0]), which is many
    times the typical |out| of a row over hundreds of keys; the relative
    L2 is what holds those rows.  lse is f32 on both sides: 1e-3
    absolute."""
    from ray_lightning_accelerators_tpu_torch.ops import attention
    F = torch.nn.functional
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    rows = []
    for bh, s, d, causal, window, dt in FLASH_SHAPES:
        q, k, v = (torch.randn(bh, s, d, generator=g, device=dev).to(dt)
                   for _ in range(3))
        out, lse = attention.flash_forward(q, k, v, causal=causal,
                                           window=window)
        ref, ref_lse = attention.attention_reference_lse(q, k, v, causal,
                                                         window=window)
        t = 2e-2 if dt != torch.float32 else 1e-4
        err = (out.float() - ref.float()).abs().max().item()
        rel = _rel_l2(out, ref)
        lse_err = (lse - ref_lse).abs().max().item()
        close = torch.allclose(out.float(), ref.float(), rtol=t,
                               atol=t * ref.float().abs().max().item())
        ok = close and rel <= t and lse_err <= 1e-3 \
            and bool(torch.isfinite(out).all())
        shape = (f"[{bh},{s},{d}] {str(dt).split('.')[-1]} "
                 f"{'causal' if causal else 'full'}"
                 f"{'' if window is None else f' window={window}'}")
        ph.check(ok, f"K2 flash_attention {shape} max|err|={err:.3e} "
                     f"({'inside' if close else 'outside'} the elementwise "
                     f"tolerance) rel L2 {rel:.3e} (limit {t:.0e}) "
                     f"lse max|err|={lse_err:.3e}")
        q4, k4, v4 = (x.view(1, bh, s, d) for x in (q, k, v))
        if window is None:
            lib = (lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal))
        else:
            qi = torch.arange(s, device=dev)
            keep = (qi[:, None] >= qi[None, :]) & \
                (qi[:, None] - qi[None, :] < window)
            lib = (lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                          attn_mask=keep))
        nbytes, flops = flash_work(bh, s, d, causal, window,
                                   q.element_size())
        peak = BF16_TENSOR_FLOPS if dt != torch.float32 else F32_FLOPS
        ms = time_ms(lambda: attention.flash_forward(
            q, k, v, causal=causal, window=window))
        bound = bound_ms(nbytes, flops, peak)
        rows.append(dict(
            kernel="K2", name="flash_attention", shape=shape, err=err,
            rel_l2=rel, lse_err=lse_err, ms=ms,
            plain_ms=time_ms(lambda: attention.attention_reference_lse(
                q, k, v, causal, window=window)),
            library_ms=time_ms(lib), bound=bound,
            tflops=flops / ms / 1e9, bound_share=bound[0] / ms,
            earlier_us=EARLIER_US.get(("K2", shape))))
        if shape == TC_FLOOR_SHAPE:
            _check_tensor_cores(ph, "K2", shape, ms, flops)
    log("  kernel  shape                                kernel_us  "
        "plain_us  sdpa_us  bound_us (by)  TFLOP/s  of bound  earlier_us")
    for r in rows:
        was = ("" if r["earlier_us"] is None
               else f"{r['earlier_us']:.2f}")
        log(f"  {r['kernel']:<6}  {r['shape']:<35}  {r['ms'] * 1e3:<9.2f}  "
            f"{r['plain_ms'] * 1e3:<8.2f}  {r['library_ms'] * 1e3:<7.2f}  "
            f"{r['bound'][0] * 1e3:.3f} ({r['bound'][1]})  "
            f"{r['tflops']:.1f}  {r['bound_share']:.3f}  {was}")
    return rows


GEN_BATCH, GEN_PROMPT, GEN_NEW = 16, 128, 128    # bench.py bench_decode


def _gen_prompts(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (GEN_BATCH, GEN_PROMPT)).astype(np.int64)


def phase_generate(ph: Phases, model, params, label: str, seed: int,
                   expect_q8: bool):
    """generate() at the decode benchmark's config: the prefill alone,
    then the whole call, each timed on the host clock around work that
    ends in a synchronise; launch counts from the counted generate()."""
    prompts = torch.from_numpy(_gen_prompts(seed)).to(DEV)
    model.generate(params, prompts[:2, :16], 4)          # warm-up
    sync()
    t0 = time.perf_counter()
    h, _ = model._prefill(params, prompts, GEN_PROMPT + GEN_NEW)
    model._unembed_matmul(h, params, model.compute_dtype).argmax(-1)
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    _reset_counts()
    t0 = time.perf_counter()
    out = model.generate(params, prompts, GEN_NEW)
    sync()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    V = CFG["vocab_size"]
    ok = tuple(out.shape) == (GEN_BATCH, GEN_PROMPT + GEN_NEW) and \
        bool((out[:, :GEN_PROMPT] == prompts).all()) and \
        bool(((out >= 0) & (out < V)).all())
    ph.check(ok, f"{label}: generate() returned {tuple(out.shape)} with "
                 f"in-vocab tokens after the prompts")
    ph.check(launches["flash_attention"] == CFG["n_layers"],
             f"{label}: K2 flash_attention launches="
             f"{launches['flash_attention']} (one per layer per prefill)")
    ph.check(launches["rms_norm"] > 0,
             f"{label}: K1 rms_norm launches={launches['rms_norm']}")
    if expect_q8:
        ph.check(launches["int8_matmul"] > 0
                 and launches["int8_matmul_nt"] > 0,
                 f"{label}: K5 int8_matmul launches="
                 f"{launches['int8_matmul']}, K6 int8_matmul_nt launches="
                 f"{launches['int8_matmul_nt']}")
    decode_ms = (wall * 1e3 - prefill_ms) / (GEN_NEW - 1)
    tok_s = GEN_BATCH * GEN_NEW / wall
    log(f"  {label}: generate() {GEN_BATCH}x{GEN_PROMPT} -> +{GEN_NEW} in "
        f"{wall * 1e3:.1f} ms: prefill_ms={prefill_ms:.2f} "
        f"decode_ms_per_token={decode_ms:.3f} tokens_per_s={tok_s:.1f} "
        f"launches={json.dumps(launches)}")
    return {"launches": launches, "wall_ms": wall * 1e3,
            "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
            "tokens_per_s": tok_s, "tokens": out.cpu().numpy()}


def phase_generate_vs_paged(model, params, gen_tokens, seed: int):
    """Greedy agreement of generate() with the paged engine on the same
    16 prompts (a measurement: bf16 rounds differently on the two paths,
    so near-tied logits may break differently)."""
    from ray_lightning_accelerators_tpu_torch.serve import ServeEngine
    prompts = _gen_prompts(seed)
    with ServeEngine(model, params, max_slots=GEN_BATCH,
                     block_len=BLOCK_LEN, max_total_len=MAX_TOTAL) as eng:
        outs = [r.result(timeout=600) for r in
                [eng.submit(p, GEN_NEW) for p in prompts]]
    eng_new = np.stack(outs)[:, GEN_PROMPT:]
    gen_new = gen_tokens[:, GEN_PROMPT:]
    same = eng_new == gen_new
    # tokens up to each row's first disagreement
    lead = np.where(same.all(1), GEN_NEW, np.argmin(same, 1))
    out = {"rows_identical": int(same.all(1).sum()),
           "token_agreement": float(same.mean()),
           "mean_tokens_before_divergence": float(lead.mean())}
    log(f"  bf16: generate() vs paged engine, {GEN_BATCH} prompts: "
        f"{out['rows_identical']}/{GEN_BATCH} rows identical, token "
        f"agreement {out['token_agreement']:.3f}, mean "
        f"{out['mean_tokens_before_divergence']:.1f} tokens before the "
        "first divergence")
    return out


def phase_dense_engine(ph: Phases, model, params, seed: int):
    from ray_lightning_accelerators_tpu_torch.serve import ServeEngine
    reqs = _requests(seed)
    with ServeEngine(model, params, max_slots=SLOTS, paged=False,
                     max_total_len=MAX_TOTAL) as eng:       # warm-up
        eng.submit(reqs[1], 4).result(timeout=600)
    sync()
    _reset_counts()
    t0 = time.perf_counter()
    with ServeEngine(model, params, max_slots=SLOTS, paged=False,
                     max_total_len=MAX_TOTAL) as eng:
        outs = [r.result(timeout=900)
                for r in [eng.submit(p, NEW_TOKENS) for p in reqs]]
    sync()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    st = eng.stats()
    V = CFG["vocab_size"]
    done = all(o.shape == (p.size + NEW_TOKENS,) and (o[:p.size] == p).all()
               and (o >= 0).all() and (o < V).all()
               for o, p in zip(outs, reqs))
    ph.check(done and st["completed"] == len(reqs),
             f"dense bf16: {st['completed']}/{len(reqs)} requests completed "
             f"with {NEW_TOKENS} new in-vocab tokens each")
    ph.check(launches["flash_attention"] >= len(reqs) * CFG["n_layers"],
             f"dense bf16: K2 flash_attention launches="
             f"{launches['flash_attention']} (>= one per layer per request)")
    ttft, step = st["ttft_s"], st["decode_step_s"]
    log(f"  dense bf16: {st['tokens_generated']} tokens in {wall:.2f} s "
        f"wall; throughput_tok_s={st['throughput_tok_s']:.1f} "
        f"ttft_p50_ms={ttft['p50_s'] * 1e3:.2f} "
        f"ttft_p99_ms={ttft['p99_s'] * 1e3:.2f} "
        f"decode_step_p50_ms={step['p50_s'] * 1e3:.3f} "
        f"steps={st['steps']} launches={json.dumps(launches)}")
    return {"launches": launches,
            "throughput_tok_s": st["throughput_tok_s"],
            "ttft_p50_ms": ttft["p50_s"] * 1e3,
            "ttft_p99_ms": ttft["p99_s"] * 1e3,
            "decode_step_p50_ms": step["p50_s"] * 1e3,
            "steps": st["steps"]}


WIN, WIN_BATCH, WIN_PROMPT, WIN_NEW = 256, 2, 400, 32
SPEC_PROMPT, SPEC_NEW, SPEC_K = 128, 64, 4


def phase_window_spec(ph: Phases, cfg_obj, params, seed: int):
    """A sliding-window generate() (rolling prefill cache, K2 tile
    skipping) with its prefill logits against the CPU port, then
    speculative decoding with the model as its own draft."""
    import dataclasses

    from ray_lightning_accelerators_tpu_torch.models.speculative import (
        speculative_generate)
    from ray_lightning_accelerators_tpu_torch.models.transformer import GPT
    rng = np.random.default_rng(seed + 11)
    V = CFG["vocab_size"]
    wcfg = dataclasses.replace(cfg_obj, sliding_window=WIN)
    wgpu = GPT(wcfg, device=DEV, compute_dtype=torch.bfloat16)
    prompts = torch.from_numpy(rng.integers(0, V, (WIN_BATCH, WIN_PROMPT))
                               ).to(DEV)
    _reset_counts()
    t0 = time.perf_counter()
    out = wgpu.generate(params, prompts, WIN_NEW)
    sync()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    ph.check(tuple(out.shape) == (WIN_BATCH, WIN_PROMPT + WIN_NEW)
             and bool(((out >= 0) & (out < V)).all())
             and launches["flash_attention"] == CFG["n_layers"],
             f"window {WIN}: generate() {tuple(out.shape)} in "
             f"{wall * 1e3:.1f} ms, K2 launches="
             f"{launches['flash_attention']}")
    # its prefill logits (the rolling cache's prompt) against the CPU port
    wcpu = GPT(wcfg, device="cpu", compute_dtype=torch.float32)
    pcpu = _cast_floats(_to(params, device="cpu"), torch.float32)
    h_g, c_g = wgpu._prefill(params, prompts[:1], WIN)
    h_c, c_c = wcpu._prefill(pcpu, prompts[:1].cpu(), WIN)
    lg = wgpu._unembed_matmul(h_g, params, torch.bfloat16).float().cpu()
    lc = wcpu._unembed_matmul(h_c, pcpu, torch.float32)
    rel = ((lg - lc).norm() / lc.norm()).item()
    kv_rel = ((c_g["k"].float().cpu() - c_c["k"]).norm()
              / c_c["k"].norm()).item()
    ph.check(bool(torch.isfinite(lg).all()) and rel <= 5e-2
             and kv_rel <= 5e-2,
             f"window {WIN}: prefill logits rel L2 err={rel:.3e}, rolling "
             f"cache k rel L2 err={kv_rel:.3e} vs the CPU port (limit 5e-2)")
    # speculative decoding, the model drafting for itself
    target = GPT(cfg_obj, device=DEV, compute_dtype=torch.bfloat16)
    prompt = torch.from_numpy(rng.integers(0, V, (1, SPEC_PROMPT))).to(DEV)
    t0 = time.perf_counter()
    spec, stats = speculative_generate(target, params, target, params,
                                       prompt, SPEC_NEW, k=SPEC_K)
    sync()
    spec_ms = (time.perf_counter() - t0) * 1e3
    ref = target.generate(params, prompt, SPEC_NEW)
    same = (spec[0, SPEC_PROMPT:] == ref[0, SPEC_PROMPT:]).cpu().numpy()
    # bf16 rounds the chunk scorer and the single-token step differently,
    # so the two may part at a near-tied logit and differ from there on
    lead = SPEC_NEW if same.all() else int(np.argmin(same))
    ph.check(tuple(spec.shape) == (1, SPEC_PROMPT + SPEC_NEW)
             and bool(((spec >= 0) & (spec < V)).all()),
             f"speculative k={SPEC_K}: {tuple(spec.shape)} in "
             f"{spec_ms:.1f} ms, rounds={stats['rounds']} accept_rate="
             f"{stats['accept_rate']:.3f} accepted/checked="
             f"{stats['accepted']}/{stats['checked']}; equal to generate() "
             f"for the first {lead} of {SPEC_NEW} tokens")
    return {"window": {"wall_ms": wall * 1e3, "launches": launches,
                       "prefill_logits_rel_l2": rel, "cache_k_rel_l2": kv_rel},
            "speculative": {**stats, "wall_ms": spec_ms,
                            "tokens_equal_to_generate": lead}}


# 3g: the speculative lane drafts with the model itself, so the draft's
# dense cache (the table span + spec_k) must fit the model's 512
# positions: the lane's engine takes a 480-token budget (31 blocks + 4)
SPEC_REQS, SPEC_TOTAL = 4, 480


def _timed(fn, sink: list):
    """``fn`` with each call's wall time, the card synchronised on both
    sides, appended to ``sink``."""
    def call(*args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        sink.append(time.perf_counter() - t0)
        return out
    return call


def phase_spec_lane(ph: Phases, model, params, seed: int):
    """The engine's speculative lane: 4 single-stream requests, one at a
    time, through ``serve_speculative`` on an idle engine whose draft is
    the model itself, beside the same prompts in normal slots."""
    from ray_lightning_accelerators_tpu_torch.models.speculative import (
        serve_speculative)
    from ray_lightning_accelerators_tpu_torch.serve import ServeEngine
    rng = np.random.default_rng(seed + 13)
    V = CFG["vocab_size"]
    prompts = [rng.integers(0, V, SPEC_PROMPT).astype(np.int32)
               for _ in range(SPEC_REQS)]
    kw = dict(max_slots=SLOTS, block_len=BLOCK_LEN, max_total_len=SPEC_TOTAL)
    _reset_counts()
    walls = []
    with ServeEngine(model, params, draft_model=model, draft_params=params,
                     spec_k=SPEC_K, **kw) as eng:
        call = _timed(lambda p: serve_speculative(eng, p, SPEC_NEW,
                                                  timeout=600), walls)
        outs = [call(p) for p in prompts]
    launches = _read_counts()
    st = eng.stats()
    plain_walls = []
    with ServeEngine(model, params, **kw) as plain:
        call = _timed(lambda p: plain.submit(p, SPEC_NEW).result(
            timeout=600), plain_walls)
        refs = [call(p) for p in prompts]
    done = all(o.shape == (SPEC_PROMPT + SPEC_NEW,)
               and (o[:SPEC_PROMPT] == p).all() and (o >= 0).all()
               and (o < V).all() for o, p in zip(outs, prompts))
    ph.check(done and st["completed"] == SPEC_REQS,
             f"speculative lane: {st['completed']}/{SPEC_REQS} requests "
             f"completed with {SPEC_NEW} new in-vocab tokens each")
    ph.check(st["speculative_requests"] == SPEC_REQS
             and st["speculative_rounds"] >= SPEC_REQS
             and st["speculative_tokens_accepted"] > 0 and st["steps"] == 0,
             f"speculative lane: speculative_requests="
             f"{st['speculative_requests']} rounds="
             f"{st['speculative_rounds']} accepted="
             f"{st['speculative_tokens_accepted']} (decode steps "
             f"{st['steps']})")
    ph.check(launches["rms_norm"] > 0 and launches["flash_attention"]
             >= SPEC_REQS * CFG["n_layers"],
             f"speculative lane: K1 rms_norm launches="
             f"{launches['rms_norm']}, K2 flash_attention launches="
             f"{launches['flash_attention']} (the draft's prefill, one per "
             f"layer per request)")
    ph.check(st["block_pool_used"] == 0,
             f"speculative lane: block_pool_used={st['block_pool_used']} "
             "after the engine stopped")
    # bf16 rounds the chunk scorer and the single-token step differently,
    # so the lanes may part at a near-tied logit: a report, not a check
    leads = []
    for o, r in zip(outs, refs):
        same = o[SPEC_PROMPT:] == r[SPEC_PROMPT:]
        leads.append(SPEC_NEW if same.all() else int(np.argmin(same)))
    accept = st["speculative_tokens_accepted"] / max(
        1, st["speculative_rounds"] * SPEC_K)
    wall_ms = float(np.mean(walls)) * 1e3
    plain_ms = float(np.mean(plain_walls)) * 1e3
    log(f"  speculative lane k={SPEC_K}: accept rate {accept:.3f} "
        f"({st['speculative_tokens_accepted']} of "
        f"{st['speculative_rounds']} rounds x {SPEC_K}); "
        f"{wall_ms:.1f} ms a request, {wall_ms / SPEC_NEW:.3f} ms a token "
        f"(walls {[round(w * 1e3, 1) for w in walls]}); normal slot "
        f"{plain_ms:.1f} ms a request, {plain_ms / SPEC_NEW:.3f} ms a "
        f"token; leading tokens equal to the normal slot's {leads} of "
        f"{SPEC_NEW}; launches={json.dumps(launches)}")
    return {"accept_rate": accept, "rounds": st["speculative_rounds"],
            "accepted": st["speculative_tokens_accepted"],
            "wall_ms_per_request": wall_ms,
            "ms_per_token": wall_ms / SPEC_NEW,
            "normal_wall_ms_per_request": plain_ms,
            "normal_ms_per_token": plain_ms / SPEC_NEW,
            "leading_tokens_equal": leads, "launches": launches}


def _shipped(store, desc):
    """A descriptor's payload read back from the object store: the k and
    v 16-bit words of every wave, concatenated in block order."""
    ks, vs = [], []
    for _, ref in desc["waves"]:
        pay = store.get(ref)
        ks.append(torch.from_numpy(pay["k"]))
        vs.append(torch.from_numpy(pay["v"]))
    return torch.cat(ks, dim=1), torch.cat(vs, dim=1)


def _handoff_stages(pre, blocks, reps: int = 3):
    """Where a handoff's time goes: the export's and the import's stages
    for ``blocks`` of ``pre``'s pool, wave by wave as the engine cuts
    them, each stage synchronised; ms summed over the waves, the median
    of ``reps`` passes."""
    from ray_lightning_accelerators_tpu_torch.parallel.redistribute import (
        wave_schedule)
    from ray_lightning_accelerators_tpu_torch.runtime import object_store
    from ray_lightning_accelerators_tpu_torch.serve.engine import (
        _wave_payload, _wave_tensors)
    store = object_store.global_store()
    pool, model = pre._cache, pre.model
    scratch = {n: t.clone() for n, t in pool.items()}
    per_block = pre._pool_bytes // pre.n_blocks
    waves = wave_schedule([per_block] * len(blocks), pre.handoff_wave_bytes)
    names = ("gather", "to_host", "put", "get", "to_device", "scatter")
    passes = []
    for _ in range(reps):
        t = dict.fromkeys(names, 0.0)
        for w in waves:
            ids = [blocks[j] for j in w]
            stamps = [time.perf_counter()]

            def stage():
                sync()
                stamps.append(time.perf_counter())
            k, v = model.paged_blocks_gather(pool, ids)
            stage()
            pay = _wave_payload(k.cpu(), v.cpu())
            stage()
            ref = store.put(pay)
            stage()
            got = store.get(ref)
            stage()
            kd, vd = (x.to(pre.device) for x in _wave_tensors(got))
            stage()
            model.paged_blocks_scatter(scratch, ids, kd, vd)
            stage()
            store.delete(ref)
            for i, n in enumerate(names):
                t[n] += (stamps[i + 1] - stamps[i]) * 1e3
        passes.append(t)
    return {n: float(np.median([p[n] for p in passes])) for n in names}


def _handoff_alone(model, params, prompt, n: int):
    """One request through fresh prefill and decode engines, then through
    a fresh normal engine: (handoff tokens, normal tokens, descriptor,
    export s, import s, the stages' ms)."""
    from ray_lightning_accelerators_tpu_torch.serve import ServeEngine
    kw = dict(max_slots=SLOTS, block_len=BLOCK_LEN, max_total_len=MAX_TOTAL)
    exp_s, imp_s = [], []
    with ServeEngine(model, params, **kw) as pre, \
            ServeEngine(model, params, **kw) as dec:
        pre._export_handoff = _timed(pre._export_handoff, exp_s)
        dec._admit_import = _timed(dec._admit_import, imp_s)
        desc = pre.submit_handoff(prompt, n).result(timeout=600)
        out = dec.submit_import(desc).result(timeout=600)
        stages = _handoff_stages(pre, pre._handoffs[desc["handoff_id"]][1])
        pre.release_handoff(desc["handoff_id"])
    with ServeEngine(model, params, **kw) as plain:
        ref = plain.submit(prompt, n).result(timeout=600)
    return out, ref, desc, exp_s[0], imp_s[0], stages


def phase_handoff(ph: Phases, model, params, label: str, seed: int,
                  expect_q8: bool):
    """KV handoff: phase 3's 17 requests prefilled on one engine
    (``submit_handoff``), imported into another (``submit_import``) and
    released; every payload held bitwise against the source pool; then a
    128-token and the 400-token request served alone through a handoff
    and through a normal engine, token for token."""
    from ray_lightning_accelerators_tpu_torch.runtime import object_store
    from ray_lightning_accelerators_tpu_torch.serve import ServeEngine
    reqs = _requests(seed)
    V = CFG["vocab_size"]
    store = object_store.global_store()
    kw = dict(max_slots=SLOTS, block_len=BLOCK_LEN, max_total_len=MAX_TOTAL)
    shm = os.statvfs("/dev/shm")
    shm_free = shm.f_bavail * shm.f_frsize
    _reset_counts()
    t0 = time.perf_counter()
    with ServeEngine(model, params, **kw) as pre, \
            ServeEngine(model, params, **kw) as dec:
        per_block = pre._pool_bytes // pre.n_blocks
        # a batch of handoffs in flight at a time that /dev/shm can hold
        # (blocks of the longest prompt, twice over for the verification
        # copies)
        most = -(-LONG_PROMPT // BLOCK_LEN) * per_block
        batch = max(1, min(len(reqs), int(shm_free // (2 * most))))
        descs, outs, bitwise, shipped = [], [], True, 0
        for b0 in range(0, len(reqs), batch):
            part = [pre.submit_handoff(p, NEW_TOKENS)
                    for p in reqs[b0:b0 + batch]]
            part = [r.result(timeout=900) for r in part]
            for d in part:
                k16, v16 = _shipped(store, d)
                src = pre._handoffs[d["handoff_id"]][1]
                pool = pre._cache
                bitwise &= bool(
                    torch.equal(k16, pool["k"][:, src].cpu().view(torch.int16))
                    and torch.equal(v16,
                                    pool["v"][:, src].cpu().view(torch.int16)))
                shipped += len(src)
            resps = [dec.submit_import(d) for d in part]
            outs += [r.result(timeout=900) for r in resps]
            for d in part:
                pre.release_handoff(d["handoff_id"])
            descs += part
        sync()
        wall = time.perf_counter() - t0
        pst, dst = pre.stats(), dec.stats()
        shm_after = store.total_shm_bytes()
    launches = _read_counts()
    done = all(o.shape == (p.size + NEW_TOKENS,) and (o[:p.size] == p).all()
               and (o >= 0).all() and (o < V).all()
               for o, p in zip(outs, reqs))
    ph.check(done and dst["completed"] == len(reqs)
             and pst["kv_handoffs"] == len(reqs),
             f"{label} handoff: {dst['completed']}/{len(reqs)} imported "
             f"requests completed with {NEW_TOKENS} new in-vocab tokens "
             f"each; kv_handoffs={pst['kv_handoffs']} (in batches of "
             f"{batch}, /dev/shm free {shm_free / 2**20:.0f} MiB)")
    want = sum(sum(c for c, _ in d["waves"]) for d in descs) * per_block
    ph.check(pst["kv_handoff_bytes"] == want == sum(d["bytes"]
                                                    for d in descs),
             f"{label} handoff: kv_handoff_bytes={pst['kv_handoff_bytes']} "
             f"= {shipped} blocks x {per_block} bytes")
    ph.check(bitwise, f"{label} handoff: every payload read back from the "
                      "object store is bitwise the source pool's blocks")
    ph.check(pst["block_pool_used"] == 0 and dst["block_pool_used"] == 0
             and shm_after == 0,
             f"{label} handoff: after release, pre block_pool_used="
             f"{pst['block_pool_used']}, dec block_pool_used="
             f"{dst['block_pool_used']}, object store shm bytes={shm_after}")
    ph.check(launches["rms_norm"] > 0,
             f"{label} handoff: K1 rms_norm launches={launches['rms_norm']}")
    if expect_q8:
        ph.check(launches["int8_matmul"] > 0
                 and launches["int8_matmul_nt"] > 0,
                 f"{label} handoff: K5 int8_matmul launches="
                 f"{launches['int8_matmul']}, K6 int8_matmul_nt launches="
                 f"{launches['int8_matmul_nt']}")
    # served alone: the same bytes into the same computation
    alone = {}
    for name, p in ((str(PROMPT), reqs[0]),
                    (str(LONG_PROMPT), reqs[SLOTS // 2])):
        out, ref, desc, exp_s, imp_s, stages = _handoff_alone(
            model, params, p, NEW_TOKENS)
        ph.check(np.array_equal(out, ref),
                 f"{label} handoff: the {name}-token request alone is "
                 f"token-identical through pre -> dec and a normal engine")
        alone[name] = {
            "blocks": sum(c for c, _ in desc["waves"]),
            "waves": len(desc["waves"]), "bytes": desc["bytes"],
            "export_ms": exp_s * 1e3, "import_ms": imp_s * 1e3,
            "export_gb_s": desc["bytes"] / exp_s / 1e9,
            "import_gb_s": desc["bytes"] / imp_s / 1e9,
            "stages_ms": stages}
    a, b = alone[str(LONG_PROMPT)], alone[str(PROMPT)]
    log(f"  {label} handoff: {len(reqs)} requests in {wall:.2f} s wall; "
        f"{LONG_PROMPT}-token request: {a['blocks']} blocks in "
        f"{a['waves']} waves, {a['bytes']} bytes; export "
        f"{a['export_ms']:.2f} ms ({a['export_gb_s']:.2f} GB/s), import "
        f"{a['import_ms']:.2f} ms ({a['import_gb_s']:.2f} GB/s); "
        f"{PROMPT}-token: {b['blocks']} blocks, export "
        f"{b['export_ms']:.2f} ms, import {b['import_ms']:.2f} ms; "
        f"launches={json.dumps(launches)}")
    log(f"  {label} handoff stages, {LONG_PROMPT}-token request (ms, "
        f"summed over its waves, median of 3): "
        + ", ".join(f"{k} {v:.3f}" for k, v in a["stages_ms"].items()))
    return {"wall_s": wall, "batch": batch, "shm_free_bytes": shm_free,
            "per_block_bytes": per_block, "bytes": pst["kv_handoff_bytes"],
            "alone": alone, "launches": launches}


def phase_prefill_logits(ph: Phases, cfg_obj, params_gpu, seed: int):
    """_prefill + unembedding on the card (bf16, K2) against the port on
    the CPU (f32, plain versions) for one 128-token prompt, read at 8
    positions (the prompt repeated in 8 rows, each with its own
    last_index).  Tolerance as phase 4: relative L2 <= 5e-2."""
    from ray_lightning_accelerators_tpu_torch.models.transformer import GPT
    rng = np.random.default_rng(seed + 13)
    prompt = rng.integers(0, CFG["vocab_size"], (1, PROMPT))
    toks = torch.from_numpy(np.repeat(prompt, 8, 0))
    idx = torch.arange(PROMPT // 8 - 1, PROMPT, PROMPT // 8)

    def run(model, params):
        h, _ = model._prefill(params, toks, PROMPT, last_index=idx)
        return model._unembed_matmul(h, params,
                                     model.compute_dtype).float().cpu()

    gpu = GPT(cfg_obj, device=DEV, compute_dtype=torch.bfloat16)
    cpu = GPT(cfg_obj, device="cpu", compute_dtype=torch.float32)
    a = run(gpu, params_gpu)
    b = run(cpu, _cast_floats(_to(params_gpu, device="cpu"), torch.float32))
    rel = ((a - b).norm() / b.norm()).item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    ph.check(bool(torch.isfinite(a).all()) and rel <= 5e-2,
             f"bf16 prefill logits {tuple(a.shape)}: rel L2 err={rel:.3e} "
             f"max|err|={(a - b).abs().max().item():.3e} greedy "
             f"agreement={agree:.3f}")
    return {"rel_l2": rel, "greedy_agree": agree}



# K3a, K3b and K4 at the training shapes: (bh, seq, head_dim, causal,
# window, dtype).  The bench config's 16 x 12 heads at seq 1024 runs K4
# (block_k 1024) and, with the default 512 blocks, K3a + K3b; ViT's step
# (phase 7c) runs K4 without a mask over 64 keys at [256*4, 64, 64].  Each
# shape here goes through both branches.
FLASH_BWD_SHAPES = [
    (192, 1024, 64, True, None, torch.bfloat16),
    (1024, 64, 64, False, None, torch.bfloat16),
    (12, 256, 128, True, None, torch.bfloat16),
    (12, 400, 64, True, 256, torch.bfloat16),
    (12, 400, 64, True, None, torch.float32),
]
# tolerances, relative L2 per gradient against the f32 autograd of the
# plain attention: bf16 rounds P and dS (and the outputs) to 8 bits;
# f32 differs by summation order only, K4's dq also by its atomic order
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
K4_DQ_F32_TOL = 1e-4
def flash_bwd_work(bh: int, s: int, d: int, causal: bool, window,
                   elem: int, products: int, outputs: int):
    """(bytes, flops) of one backward kernel: q, k, v, dO read once with
    the f32 lse and delta, ``outputs`` of dq / dk / dv written once, and
    ``products`` products of 2*d flops for every (query, key) pair the
    mask keeps (K3a: S, dP, dQ; K3b: S, dP, dV, dK; K4 all five)."""
    _, flops2 = flash_work(bh, s, d, causal, window, elem)
    pairs_flops = flops2 // 2          # flash_work counts two products
    nbytes = (4 + outputs) * bh * s * d * elem + 2 * 4 * bh * s
    return nbytes, products * pairs_flops


def phase_flash_bwd(ph: Phases, seed: int):
    """K4 (one pass) and K3a + K3b (split) against the f32 autograd of the
    plain attention on the same inputs, then each kernel timed per call
    (L2 flushed) beside the plain backward, SDPA's backward (SDPA forward
    + backward through autograd, minus its forward) and its bound."""
    from ray_lightning_accelerators_tpu_torch.ops import attention as A
    F = torch.nn.functional
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(seed + 21)
    rows = []
    for bh, s, d, causal, window, dt in FLASH_BWD_SHAPES:
        q, k, v, do = (torch.randn(bh, s, d, generator=g, device=dev).to(dt)
                       for _ in range(4))
        out, lse = A.flash_forward(q, k, v, causal=causal, window=window)
        ref_in = [x.float().requires_grad_() for x in (q, k, v)]
        ref = torch.autograd.grad(
            A.attention_reference(*ref_in, causal=causal, window=window),
            ref_in, do.float())
        del ref_in
        delta = (do.float() * out.float()).sum(-1)
        shape = (f"[{bh},{s},{d}] {str(dt).split('.')[-1]} "
                 f"{'causal' if causal else 'full'}"
                 f"{'' if window is None else f' window={window}'}")
        peak = BF16_TENSOR_FLOPS if dt != torch.float32 else F32_FLOPS
        tol = BWD_TOL[dt]
        fused = A.flash_backward(q, k, v, out, lse, do, causal=causal,
                                 window=window, block_k=s)
        split = A.flash_backward(q, k, v, out, lse, do, causal=causal,
                                 window=window, block_k=min(s - 1, 512))
        sync()
        errs = {}
        for label, grads in (("K4", fused), ("K3", split)):
            for name, a, b in zip(("dq", "dk", "dv"), grads, ref):
                t = K4_DQ_F32_TOL if (label, name, dt) == (
                    "K4", "dq", torch.float32) else tol
                rel = _rel_l2(a, b)
                errs[(label, name)] = ((a.float() - b).abs().max().item(),
                                       rel)
                ph.check(bool(torch.isfinite(a).all()) and rel <= t,
                         f"{label} {name} {shape}: rel L2 {rel:.3e} "
                         f"(limit {t:.0e}) max|err|="
                         f"{errs[(label, name)][0]:.3e}")
        del fused, split, ref
        args = (q, k, v, do, lse, delta)
        kw = dict(causal=causal, window=window)
        plain_ms = time_ms(lambda: A.flash_backward_reference(
            q, k, v, out, lse, do, **kw), iters=5)
        sdpa_ms = _sdpa_backward_ms(q, k, v, do, causal, window)
        elem = q.element_size()
        for kernel, name, fn, products, outputs, err_keys in (
                ("K3a", "flash_backward_dq",
                 lambda: A.flash_backward_dq(*args, **kw), 3, 1,
                 [("K3", "dq")]),
                ("K3b", "flash_backward_dkv",
                 lambda: A.flash_backward_dkv(*args, **kw), 4, 2,
                 [("K3", "dk"), ("K3", "dv")]),
                ("K4", "flash_backward_fused",
                 lambda: A.flash_backward_fused(*args, **kw), 5, 3,
                 [("K4", "dq"), ("K4", "dk"), ("K4", "dv")])):
            nbytes, flops = flash_bwd_work(bh, s, d, causal, window, elem,
                                           products, outputs)
            ms = time_ms(fn, iters=10)
            bound = bound_ms(nbytes, flops, peak)
            rows.append(dict(
                kernel=kernel, name=name, shape=shape,
                err=max(errs[k][0] for k in err_keys),
                rel_l2=max(errs[k][1] for k in err_keys),
                ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms, bound=bound,
                tflops=flops / ms / 1e9, bound_share=bound[0] / ms,
                earlier_us=EARLIER_US.get((kernel, shape))))
            if shape == TC_FLOOR_SHAPE:
                _check_tensor_cores(ph, kernel, shape, ms, flops)
    log("  kernel  shape                                kernel_us  "
        "plain_us  sdpa_bwd_us  bound_us (by)  TFLOP/s  of bound  "
        "earlier_us")
    for r in rows:
        lib_s = ("n/a" if r["library_ms"] is None
                 else f"{r['library_ms'] * 1e3:.2f}")
        was = ("" if r["earlier_us"] is None
               else f"{r['earlier_us']:.2f}")
        log(f"  {r['kernel']:<6}  {r['shape']:<35}  {r['ms'] * 1e3:<9.2f}  "
            f"{r['plain_ms'] * 1e3:<8.2f}  {lib_s:<11}  "
            f"{r['bound'][0] * 1e3:.3f} ({r['bound'][1]})  "
            f"{r['tflops']:.1f}  {r['bound_share']:.3f}  {was}")
    return rows


# K7 at the rows of a LayerNorm over the GPT-2-small width (decode's 16,
# training's 16 x 1024), a narrower width, f32 and a ragged width:
# (rows, d, dtype, parameter dtype, input mean, input spread, probe).  The
# probe row, f32 at a mean of 10 against a spread of 1 with parameters
# near 1 and 0, is where a one-pass variance E[x^2] - mu^2 in f32 errs by
# more than the 1e-5 limit and the two-pass one stays inside it (the
# phase checks both on the card); at a mean of 100 even the two-pass
# plain version differs from an f64 one by ~5e-5, so no larger mean can
# be held to 1e-5.
LN_SHAPES = [
    (16, 768, torch.bfloat16, torch.bfloat16, 5.0, 2.0, False),
    (16 * 1024, 768, torch.bfloat16, torch.bfloat16, 5.0, 2.0, False),
    (16 * 1024, 256, torch.bfloat16, torch.bfloat16, 5.0, 2.0, False),
    (4096, 768, torch.float32, torch.float32, 5.0, 2.0, False),
    (4096, 768, torch.float32, torch.float32, 10.0, 1.0, True),
    (1000, 200, torch.bfloat16, torch.float32, 5.0, 2.0, False),
]
# the op as a user calls it: bf16 activations of a 16 x 1024-token batch
# at d 768 with f32 master parameters, forward and backward
LN_PATH = (16 * 1024, 768)


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(v), 1e-30))) - 7)


def _one_pass_layer_norm(x, w, b, eps: float = 1e-6):
    """LayerNorm with the one-pass variance E[x^2] - mu^2 in f32: what
    K7 must not compute; used only to show a row's inputs tell the two
    apart."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0)
    return (xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def phase_layer_norm(ph: Phases, seed: int):
    """K7's path is the public op ``ops.norms.layer_norm`` (no model of
    the JAX package calls it): driven once as a user would, forward and
    backward with the counts reset just before and read just after; its
    output against the plain version (one bf16 ulp of the output's
    largest magnitude) and its gradients against the plain version's
    autograd.  The backward is the plain version's VJP by design, as the
    TPU's ``_ln_bwd``, so the gradient check shows the op's autograd
    wiring (equal to 1e-6 relative L2), not K7.  Then K7 against its
    plain version at each shape: max |err| <= one bf16 ulp of the
    output's largest magnitude for bf16, <= 1e-5 for f32; on the probe
    row the one-pass variance must miss that limit, so the row shows K7
    computes the two-pass one.  K7 and ``F.layer_norm`` are timed per
    call in turns (L2 flushed; medians), the plain version by its mean,
    beside the launch floor and the bound (x read once with scale and
    bias, the output written once); then the host cost of a call of each
    at [16, 768]."""
    from ray_lightning_accelerators_tpu_torch.ops import norms
    F = torch.nn.functional
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(seed + 31)
    rows_p, d_p = LN_PATH
    x = torch.randn(rows_p, d_p, generator=g, device=dev).to(
        torch.bfloat16).requires_grad_()
    w = (1 + 0.1 * torch.randn(d_p, generator=g, device=dev)
         ).requires_grad_()
    b = (0.1 * torch.randn(d_p, generator=g, device=dev)).requires_grad_()
    do = torch.randn(rows_p, d_p, generator=g, device=dev).to(torch.bfloat16)
    norms.layer_norm.launches = 0
    y = norms.layer_norm(x, w, b)
    grads = torch.autograd.grad(y, (x, w, b), do)
    sync()
    path_launches = norms.layer_norm.launches
    y_ref = norms.layer_norm_reference(x, w, b)
    y_err = (y.float() - y_ref.float()).abs().max().item()
    y_lim = _bf16_ulp(y_ref.float().abs().max().item())
    ref = torch.autograd.grad(y_ref, (x, w, b), do)
    grad_rel = max(_rel_l2(a, r) for a, r in zip(grads, ref))
    ph.check(path_launches == 1 and y.dtype == torch.bfloat16
             and y_err <= y_lim
             and all(bool(torch.isfinite(t).all()) for t in grads)
             and grad_rel <= 1e-6,
             f"K7 layer_norm op [{rows_p},{d_p}] bf16, f32 params, forward "
             f"+ backward: {path_launches} launch, y max|err|={y_err:.3e} "
             f"(limit {y_lim:.3e}), grads vs plain autograd max rel L2 "
             f"{grad_rel:.3e} (limit 1e-6)")
    del x, w, b, do, y, y_ref, grads, ref
    floor = launch_floor_ms()
    rows = []
    for n, d, dt, pdt, mean, spread, probe in LN_SHAPES:
        x = (torch.randn(n, d, generator=g, device=dev) * spread + mean
             ).to(dt)
        if probe:       # LayerNorm's usual parameters, near 1 and 0
            w = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(pdt)
            b = (0.1 * torch.randn(d, generator=g, device=dev)).to(pdt)
        else:
            w, b = (torch.randn(d, generator=g, device=dev).to(pdt)
                    for _ in range(2))
        got = norms.layer_norm(x, w, b)
        ref = norms.layer_norm_reference(x, w, b)
        err = (got.float() - ref.float()).abs().max().item()
        lim = (_bf16_ulp(ref.float().abs().max().item())
               if dt == torch.bfloat16 else 1e-5)
        shape = f"rows={n},d={d} {str(dt).split('.')[-1]}"
        if probe:
            shape += f" mean={mean:g}"
        ok = err <= lim and got.dtype == dt and bool(torch.isfinite(got).all())
        note = ""
        if probe:
            one = (_one_pass_layer_norm(x, w, b) - ref.float()
                   ).abs().max().item()
            ok = ok and one > lim
            note = f"; one-pass variance max|err|={one:.3e} (must exceed)"
        ph.check(ok, f"K7 layer_norm {shape} (params "
                     f"{str(pdt).split('.')[-1]}) max|err|={err:.3e} "
                     f"(limit {lim:.3e}){note}")
        wl, bl = w.to(dt), b.to(dt)
        nbytes = 2 * n * d * x.element_size() + 2 * d * w.element_size()
        rows.append(_turns_row(
            "K7", "layer_norm", shape, err,
            lambda: norms.layer_norm(x, w, b),
            lambda: norms.layer_norm_reference(x, w, b),
            lambda: F.layer_norm(x, (d,), wl, bl, 1e-6),
            bound_ms(nbytes, 8 * n * d, F32_FLOPS), floor))
    _log_turns_rows(rows, "F.layer_norm")
    x = torch.randn(16, 768, generator=g, device=dev).to(torch.bfloat16)
    w, b = torch.ones_like(x[0]), torch.zeros_like(x[0])
    port_us, lib_us = host_us_in_turns(
        lambda: norms.layer_norm(x, w, b),
        lambda: F.layer_norm(x, (768,), w, b, 1e-6))
    log(f"  host per call at [16,768] bf16 (1000 calls, no sync inside): "
        f"norms.layer_norm {port_us:.2f} us, F.layer_norm {lib_us:.2f} us")
    rows[0]["host_us"], rows[0]["library_host_us"] = port_us, lib_us
    return rows, {"layer_norm": path_launches, "y_max_abs_err": y_err,
                  "grad_max_rel_l2": grad_rel}


def _sdpa_backward_ms(q, k, v, do, causal: bool, window):
    """SDPA's backward on the same inputs: the time of its forward plus
    backward through autograd, minus the time of its forward (grad
    enabled, so it saves what the backward reads)."""
    F = torch.nn.functional
    s = q.shape[1]
    q4, k4, v4 = (x.detach()[None].requires_grad_() for x in (q, k, v))
    do4 = do[None]
    mask = None
    if window is not None:
        i = torch.arange(s, device=q.device)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)

    def fwd():
        if mask is None:
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  is_causal=causal)
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    try:
        fb = time_ms(lambda: torch.autograd.grad(fwd(), (q4, k4, v4), do4),
                     iters=10)
        f = time_ms(fwd, iters=10)
    except RuntimeError as e:  # a build without a backward for this case
        log(f"  (SDPA backward unavailable: {e})")
        return None
    return fb - f


def _pattern_tokens(n: int, seq: int, vocab: int, seed: int) -> np.ndarray:
    """A learnable next-token pattern: each row counts up from a random
    start (tests/test_transformer.py's TokenDataset at this vocab)."""
    starts = np.random.default_rng(seed).integers(0, vocab, n)
    return ((starts[:, None] + np.arange(seq)[None]) % vocab
            ).astype(np.int32)


# the GPT training benchmark config (bench.py bench_gpt): GPT-2 small
# widths at seq 1024, batch 16 on one card, bf16 compute, fused LM-head
# loss in 2048-row chunks, 1024 flash blocks (so the backward is K4)
TRAIN_CFG = dict(CFG, max_seq_len=1024, fused_loss=True,
                 loss_chunk_rows=2048, flash_block_q=1024,
                 flash_block_k=1024)
TRAIN_BATCH, TRAIN_STEPS_PER_EPOCH, TRAIN_EPOCHS = 16, 8, 2
SPLIT_LAYERS, SPLIT_STEPS_PER_EPOCH = 2, 2


class _StepClock:
    """Callback: a synchronised host clock and the loss at every step."""

    def __init__(self):
        from ray_lightning_accelerators_tpu_torch import Callback

        clock = self

        class Cb(Callback):
            def on_train_batch_end(self, trainer, module, metrics, idx):
                sync()
                clock.t.append(time.perf_counter())
                clock.loss.append(float(metrics["train_loss"]))
                clock.epoch.append(trainer.current_epoch)

        self.cb, self.t, self.loss, self.epoch = Cb(), [], [], []

    def warm_step_ms(self):
        """Times of the steps after the fit's first two (the allocator's
        and cuBLAS's warm-up), leaving out each epoch's first step (it
        follows the epoch-end checkpoint save)."""
        return [(self.t[i] - self.t[i - 1]) * 1e3
                for i in range(2, len(self.t))
                if self.epoch[i] == self.epoch[i - 1]]


def _bwd_counts():
    from ray_lightning_accelerators_tpu_torch.ops import attention as A
    return {"flash_backward_dq": A.flash_backward_dq.launches,
            "flash_backward_dkv": A.flash_backward_dkv.launches,
            "flash_backward_fused": A.flash_backward_fused.launches}


def _reset_bwd_counts():
    from ray_lightning_accelerators_tpu_torch.ops import attention as A
    A.flash_backward_dq.launches = 0
    A.flash_backward_dkv.launches = 0
    A.flash_backward_fused.launches = 0


def _fit(cfg_dict: dict, steps_per_epoch: int, seed: int, root: str,
         batch: Optional[int] = None, val_data=None, callbacks=(),
         **trainer_kw):
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    cfg = TransformerConfig(**cfg_dict)
    model = GPT(cfg, device=DEV, lr=3e-4)
    batch = batch or TRAIN_BATCH
    data = _pattern_tokens(batch * steps_per_epoch, cfg.max_seq_len,
                           cfg.vocab_size, seed)
    clock = _StepClock()
    trainer = Trainer(max_epochs=TRAIN_EPOCHS, device=DEV, precision="bf16",
                      log_every_n_steps=10 ** 9, seed=seed,
                      callbacks=[clock.cb, *callbacks],
                      default_root_dir=root, **trainer_kw)
    loader = DataLoader(ArrayDataset(data), batch_size=batch,
                        shuffle=True, seed=seed)
    val = None if val_data is None else DataLoader(ArrayDataset(val_data),
                                                   batch_size=batch)
    _reset_counts()
    _reset_bwd_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.fit(model, loader, val)
    sync()
    wall = time.perf_counter() - t0
    launches = {**_read_counts(), **_bwd_counts()}
    return trainer, model, loader, clock, launches, wall


def _n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_params(v) for v in tree.values())
    return int(tree.numel())


def phase_train(ph: Phases, seed: int):
    """Trainer.fit at the bench config (6a): step time, tokens/s, MFU by
    bench.py's 6N + 12 L d S formula over the bf16 peak, peak memory, the
    loss falling, K1/K2/K4 launches per step; then one step under
    torch.profiler for each kernel's share of the step's device time."""
    steps = TRAIN_EPOCHS * TRAIN_STEPS_PER_EPOCH
    root = os.path.join(HERE, "build", "chip_smoke_fit")
    trainer, model, loader, clock, launches, wall = _fit(
        TRAIN_CFG, TRAIN_STEPS_PER_EPOCH, seed, root)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = {k: v / steps for k, v in launches.items()}
    L, d, S = TRAIN_CFG["n_layers"], TRAIN_CFG["d_model"], \
        TRAIN_CFG["max_seq_len"]
    n_params = _n_params(model.params)
    step_ms = clock.warm_step_ms()
    mean_ms = float(np.mean(step_ms))
    tokens = TRAIN_BATCH * S
    flops = (6 * n_params + 12 * L * d * S) * tokens
    mfu = flops / (mean_ms / 1e3) / BF16_TENSOR_FLOPS
    first, last = clock.loss[0], clock.loss[-1]
    ph.check(trainer.global_step == steps and len(clock.loss) == steps,
             f"6a: {trainer.global_step} steps in {TRAIN_EPOCHS} epochs")
    ph.check(all(np.isfinite(clock.loss)) and last < first,
             f"6a: loss {first:.4f} -> {last:.4f} (must fall)")
    ph.check(launches["flash_backward_fused"] == L * steps
             and launches["flash_backward_dq"] == 0
             and launches["flash_backward_dkv"] == 0,
             f"6a: K4 launched {launches['flash_backward_fused']} times "
             f"({per_step['flash_backward_fused']:.0f} per step, one per "
             f"layer), K3a/K3b {launches['flash_backward_dq']}/"
             f"{launches['flash_backward_dkv']}")
    ph.check(launches["flash_attention"] == L * steps
             and launches["rms_norm"] == (2 * L + 1) * steps,
             f"6a: K2 {per_step['flash_attention']:.0f} and K1 "
             f"{per_step['rms_norm']:.0f} launches per step")
    ckpt = trainer.checkpoint_callback.best_model_path
    ph.check(bool(ckpt) and os.path.exists(ckpt),
             f"6a: the default ModelCheckpoint wrote {os.path.basename(ckpt)}")
    log(f"  6a: {steps} steps in {wall:.2f} s wall; warm step_ms mean "
        f"{mean_ms:.2f} (min {min(step_ms):.2f}, max {max(step_ms):.2f}, "
        f"n={len(step_ms)}); tokens/s {tokens / mean_ms * 1e3:.1f}; MFU "
        f"{mfu:.4f} (6N+12LdS, N={n_params}); peak memory {peak_gb:.2f} "
        f"GiB; loss per step {[round(x, 4) for x in clock.loss]}; "
        f"launches per step {json.dumps(per_step)}")
    out = {"steps": steps, "wall_s": wall, "step_ms": step_ms,
           "step_ms_mean": mean_ms, "tokens_per_s": tokens / mean_ms * 1e3,
           "mfu": mfu, "n_params": n_params, "peak_mem_gib": peak_gb,
           "loss": clock.loss, "launches": launches,
           "launches_per_step": per_step}
    try:
        out["profile"] = _profile_train_step(trainer, loader)
    except Exception as e:  # a measurement, not a check
        log(f"  6a profile: not measured ({type(e).__name__}: {e})")
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    return out


# device-op categories by name fragment, the first match winning: the
# port's kernels, casts, copies and layout transforms, library products
# (cuBLAS, cuDNN), norm statistics (PyTorch's GroupNorm), reductions,
# softmax and loss, other elementwise
_CATEGORIES = [
    ("port kernels", ("flash_fwd_kernel", "flash_bwd", "rms_norm_kernel",
                      "layer_norm_kernel", "int8_mm")),
    ("casts, copies, layout", ("copy", "nchwToNhwc", "nhwcToNchw")),
    ("cuBLAS/cuDNN products", ("nvjet", "gemm", "conv", "xmma", "cutlass",
                               "sm90_", "cudnn", "wgrad", "dgrad")),
    ("norm statistics", ("Moments", "GroupNorm", "ComputeInternalGradients",
                         "group_norm", "Welford")),
    ("reductions", ("reduce_kernel",)),
    ("softmax and loss", ("SoftMax", "nll_loss", "cross_entropy")),
    ("other elementwise", ("elementwise",)),
]


def _category(name: str) -> str:
    for label, keys in _CATEGORIES:
        if any(k in name for k in keys):
            return label
    return "other"


# kernel-name fragments in the profiler's device events
_KERNEL_KEYS = {"K2 flash_fwd (tensor cores)": "flash_fwd_kernel_tc",
                "K2 flash_fwd (f32)": "flash_fwd_kernel_f32",
                "K3a flash_bwd_dq (tensor cores)": "flash_bwd_dq_kernel_tc",
                "K3a flash_bwd_dq (f32)": "flash_bwd_dq_kernel_f32",
                "K3b/K4 flash_bwd_kv (tensor cores)": "flash_bwd_kv_kernel_tc",
                "K3b/K4 flash_bwd_kv (f32)": "flash_bwd_kv_kernel_f32",
                "K1 rms_norm": "rms_norm_kernel"}


def _profile_train_step(trainer, loader, tag: str = "6a",
                        moe_d_ff: Optional[int] = None):
    """One more training step (the fit's own step function, on its state)
    under torch.profiler: device time per kernel and its share of the
    step's device time, the step's wall time and the device busy share.
    ``moe_d_ff``: also split out an MoE model's products (``_moe_split``)
    under ``_moe_ranges``."""
    from torch.profiler import ProfilerActivity, profile
    batch = trainer._put_batch(next(iter(loader)))
    trainer._train_step(trainer._state, batch)     # warm, outside the trace
    sync()
    ranges = _moe_ranges() if moe_d_ff else contextlib.nullcontext()
    with ranges, profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         record_shapes=bool(moe_d_ff)) as prof:
        t0 = time.perf_counter()
        trainer._train_step(trainer._state, batch)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    if not events:
        log(f"  {tag} profile: step wall {wall_ms:.2f} ms; device time not "
            "measured (the profiler saw no device events)")
        return {"wall_ms": wall_ms, "device_ms": None}
    dev_ms = sum(e.device_time_total for e in events) / 1e3
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    shares = {}
    for label, key in _KERNEL_KEYS.items():
        ms = sum(v for n, v in by_name.items() if key in n)
        shares[label] = {"ms": ms, "share": ms / dev_ms}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    cats = {}
    for n, ms in by_name.items():
        cats[_category(n)] = cats.get(_category(n), 0.0) + ms
    log(f"  {tag} profile: step wall {wall_ms:.2f} ms, device {dev_ms:.2f} "
        f"ms -> busy share {dev_ms / wall_ms:.3f}, idle share "
        f"{1 - dev_ms / wall_ms:.3f}; {len(events)} device ops")
    for label, v in shares.items():
        log(f"    {label:<34} {v['ms']:9.2f} ms  {v['share'] * 100:5.1f}%")
    for label, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"    by kind {ms:9.2f} ms  {ms / dev_ms * 100:5.1f}%  {label}")
    for name, ms in top:
        log(f"    top {ms:9.2f} ms  {name[:70]}")
    out = {"wall_ms": wall_ms, "device_ms": dev_ms,
           "busy_share": dev_ms / wall_ms, "kernels": shares,
           "by_kind": cats, "top": [(n[:70], ms) for n, ms in top]}
    if moe_d_ff:
        out["moe_split"] = _moe_split(prof, moe_d_ff, dev_ms, tag)
    return out


def phase_train_split(ph: Phases, seed: int):
    """6b: the same fit with the default 512 key blocks at 2 layers, so
    the backward takes the split pair K3a + K3b."""
    cfg = dict(TRAIN_CFG, n_layers=SPLIT_LAYERS, flash_block_q=None,
               flash_block_k=None)
    steps = TRAIN_EPOCHS * SPLIT_STEPS_PER_EPOCH
    root = os.path.join(HERE, "build", "chip_smoke_fit_split")
    trainer, _, _, clock, launches, wall = _fit(
        cfg, SPLIT_STEPS_PER_EPOCH, seed + 1, root)
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    first, last = clock.loss[0], clock.loss[-1]
    ph.check(launches["flash_backward_dq"] == SPLIT_LAYERS * steps
             and launches["flash_backward_dkv"] == SPLIT_LAYERS * steps
             and launches["flash_backward_fused"] == 0,
             f"6b: K3a {launches['flash_backward_dq']} and K3b "
             f"{launches['flash_backward_dkv']} launches over {steps} steps "
             f"(K4 {launches['flash_backward_fused']})")
    ph.check(all(np.isfinite(clock.loss)) and last < first,
             f"6b: loss {first:.4f} -> {last:.4f} (must fall)")
    step_ms = clock.warm_step_ms()
    log(f"  6b: {steps} steps in {wall:.2f} s wall; warm step_ms "
        f"{[round(x, 2) for x in step_ms]}")
    return {"launches": launches, "loss": clock.loss, "step_ms": step_ms,
            "wall_s": wall}


# 6c: f32 training on the card against the CPU port
F32_CFG = dict(vocab_size=512, d_model=256, n_heads=4, d_ff=512,
               n_layers=2, max_seq_len=256, loss_chunk_rows=300)
F32_BATCH, F32_STEPS = 4, 3


def phase_train_f32(ph: Phases, seed: int, cfg_dict: Optional[dict] = None,
                    tag: str = "6c"):
    """Three f32 steps from the same weights on the same batches, on the
    card (kernels K1, K2, K4) and on the CPU (plain versions), TF32 off:
    per-step loss within 1e-3 relative, final params within 1e-3 relative
    L2 per leaf (f32 on both sides; the card sums in other orders)."""
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    cfg = TransformerConfig(**(cfg_dict or F32_CFG))
    init = GPT(cfg, device="cpu").init_params(seed)
    data = _pattern_tokens(F32_BATCH * F32_STEPS, cfg.max_seq_len,
                           cfg.vocab_size, seed + 3)
    runs = {}
    for dev in (DEV, "cpu"):
        model = GPT(cfg, device=dev, lr=1e-3)
        model.params = init
        tr = Trainer(max_epochs=1, device=dev, precision="f32",
                     log_every_n_steps=1, enable_checkpointing=False,
                     seed=seed)
        tr.fit(model, DataLoader(ArrayDataset(data), batch_size=F32_BATCH))
        runs[dev] = ([r["train_loss"] for r in tr.logger.history],
                     _flat_params(model.params))
    (lg, pg), (lc, pc) = runs[DEV], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    param_rel = max(_rel_l2(pg[k].cpu(), pc[k]) for k in pc)
    ph.check(len(lg) == len(lc) == F32_STEPS and loss_rel <= 1e-3
             and param_rel <= 1e-3,
             f"{tag}: f32 card vs CPU over {F32_STEPS} steps: loss max rel "
             f"{loss_rel:.3e}, params max rel L2 {param_rel:.3e} (limits "
             f"1e-3); losses card {[round(x, 6) for x in lg]} cpu "
             f"{[round(x, 6) for x in lc]}")
    return {"loss_card": lg, "loss_cpu": lc, "loss_max_rel": loss_rel,
            "params_max_rel_l2": param_rel}


def _flat_params(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_params(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach()}


# --------------------------------------------------------------------- #
# 7: the vision families through the Trainer                             #
# --------------------------------------------------------------------- #
# bench.py bench_mnist: batch 1024, layer_1 128, layer_2 256, lr 1e-3,
# bf16, the committed real-MNIST subset tiled to 24 steps an epoch, 5
# epochs; bench_cifar: ResNet-18 width 64, batch 256, lr 0.01, SGD with
# nesterov momentum 0.9 and weight decay 5e-4, synthetic CIFAR-10 with
# 256 x 12 training and 512 validation images, 4 epochs; ViT at the
# default ViTConfig (d 256, 6 layers, 4 heads, d_ff 1024, patch 4: 64
# patches of 32 x 32 x 3), batch 256 on the same data, lr 1e-3, 4 epochs
MNIST_BATCH, MNIST_STEPS, MNIST_EPOCHS = 1024, 24, 5
CIFAR_BATCH, CIFAR_STEPS, CIFAR_VAL, CIFAR_EPOCHS = 256, 12, 512, 4
MNIST_DATA = os.path.join(HERE, "tests", "data", "mnist")


class _EpochClock:
    """Callback: a synchronised host clock at every training epoch's
    start and end (bench.py's ``_EpochClock``), and each step's loss kept
    on the device until the fit ends (no per-step host sync)."""

    def __init__(self):
        from ray_lightning_accelerators_tpu_torch import Callback

        clock = self

        class Cb(Callback):
            def on_train_epoch_start(self, trainer, module):
                sync()
                clock.starts.append(time.perf_counter())

            def on_train_epoch_end(self, trainer, module):
                sync()
                clock.ends.append(time.perf_counter())

            def on_train_batch_end(self, trainer, module, metrics, idx):
                clock.loss.append(metrics["train_loss"])

        self.cb, self.starts, self.ends, self.loss = Cb(), [], [], []

    def steady_s(self) -> float:
        """Epoch-2 start to the last epoch's end (epoch 1 absorbs the
        allocator's and cuDNN's warm-up)."""
        return self.ends[-1] - self.starts[1]


def _vision_fit(model, loader, epochs: int, seed: int):
    """A bf16 train-only ``Trainer.fit`` (the timed window holds training
    steps only) with the counts reset just before and read just after:
    (trainer, record)."""
    from ray_lightning_accelerators_tpu_torch import Trainer
    clock = _EpochClock()
    trainer = Trainer(max_epochs=epochs, device=DEV, precision="bf16",
                      enable_checkpointing=False, log_every_n_steps=10 ** 9,
                      seed=seed, callbacks=[clock.cb],
                      default_root_dir=os.path.join(HERE, "build",
                                                    "chip_smoke_vision"))
    _reset_counts()
    _reset_bwd_counts()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold is not this fit's memory
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer.fit(model, loader)
    sync()
    wall = time.perf_counter() - t0
    launches = {**_read_counts(), **_bwd_counts()}
    steps = trainer.global_step
    imgs = loader.batch_size * len(loader) * (epochs - 1)
    loss = [float(v) for v in clock.loss]
    rec = {"steps": steps, "wall_s": wall,
           "imgs_per_s": imgs / clock.steady_s(),
           "epoch_s": [e - b for b, e in zip(clock.starts, clock.ends)],
           "peak_mem_gib": (torch.cuda.max_memory_allocated() - base)
           / 2 ** 30,
           "loss": loss, "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()}}
    return trainer, rec


def _check_fit(ph: Phases, tag: str, rec: dict, steps: int):
    loss = rec["loss"]
    ph.check(rec["steps"] == steps and len(loss) == steps,
             f"{tag}: {rec['steps']} steps")
    # the first epoch's mean against the last's: a per-step loss on
    # shuffled batches is noisy, an epoch's mean is not
    per_epoch = len(loss) // len(rec["epoch_s"])
    first = float(np.mean(loss[:per_epoch]))
    last = float(np.mean(loss[-per_epoch:]))
    ph.check(all(np.isfinite(loss)) and last < first,
             f"{tag}: epoch-mean loss {first:.4f} -> {last:.4f} (must "
             f"fall)")


def phase_mnist(ph: Phases, seed: int):
    """7a: the MNIST MLP at bench_mnist's config: steady imgs/s over
    epochs 2-5, ``trainer.test`` accuracy on the t10k split, peak memory.
    The committed data holds no disjoint evaluation set: its t10k
    images also appear among its training images (the phase counts them),
    so this accuracy shows the pipeline fits; it says nothing of
    generalisation."""
    from ray_lightning_accelerators_tpu_torch import DataLoader
    from ray_lightning_accelerators_tpu_torch.data import vision
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.mnist import (
        MNISTClassifier)
    x, y = vision.load_mnist(MNIST_DATA, "train")
    seen = {im.tobytes() for im in x}
    n = MNIST_BATCH * MNIST_STEPS
    reps = -(-n // len(x))
    x, y = np.tile(x, (reps, 1, 1))[:n], np.tile(y, reps)[:n]
    model = MNISTClassifier({"layer_1": 128, "layer_2": 256, "lr": 1e-3,
                             "batch_size": MNIST_BATCH}, device=DEV)
    loader = DataLoader(ArrayDataset(x, y), batch_size=MNIST_BATCH,
                        shuffle=True, seed=seed)
    trainer, rec = _vision_fit(model, loader, MNIST_EPOCHS, seed)
    _check_fit(ph, "7a MNIST", rec, MNIST_STEPS * MNIST_EPOCHS)
    tx, ty = vision.load_mnist(MNIST_DATA, "test")
    (tested,) = trainer.test(model, DataLoader(ArrayDataset(tx, ty),
                                               batch_size=len(tx)))
    rec["test"] = tested
    rec["t10k_in_train"] = sum(im.tobytes() in seen for im in tx)
    ph.check(tested["val_accuracy"] >= 0.9,
             f"7a MNIST: t10k accuracy {tested['val_accuracy']:.4f} "
             f"(>= 0.9; {rec['t10k_in_train']} of the {len(tx)} t10k "
             f"images are also training images, so this shows the fit, "
             f"not generalisation)")
    log(f"  7a MNIST: {rec['imgs_per_s']:.1f} imgs/s over epochs 2-"
        f"{MNIST_EPOCHS} (epoch s {[round(t, 4) for t in rec['epoch_s']]})"
        f"; peak memory {rec['peak_mem_gib']:.3f} GiB above the fit's start"
        f"; loss "
        f"{rec['loss'][0]:.4f} -> {rec['loss'][-1]:.4f}; t10k "
        f"{json.dumps(tested)}")
    return rec


def _cifar_datamodule(seed: int):
    from ray_lightning_accelerators_tpu_torch.models.resnet import (
        CIFAR10DataModule)
    dm = CIFAR10DataModule(batch_size=CIFAR_BATCH,
                           n_train=CIFAR_BATCH * CIFAR_STEPS,
                           n_val=CIFAR_VAL, seed=seed)
    dm.setup("fit")
    return dm


def _nchw_layout(x):
    """``resnet._layout`` for plain NCHW memory on every device: the
    layout the model does not use on the card, timed against the one it
    does."""
    return torch.contiguous_format


def _resnet_layout_ms(trainer, loader, iters: int = 20):
    """The fit's own training step with the model's channels-last
    activations and with NCHW ones (``resnet._layout`` swapped for
    ``_nchw_layout``): the step's ms by CUDA events (mean of ``iters``
    after 3 warm steps) in the order channels-last, NCHW, NCHW,
    channels-last, twice; then one warm step of each layout under
    torch.profiler for its device time."""
    from ray_lightning_accelerators_tpu_torch.models import resnet
    batch = trainer._put_batch(next(iter(loader)))
    model_layout = resnet._layout
    layouts = {"channels_last": model_layout, "nchw": _nchw_layout}
    out = {"channels_last": [], "nchw": []}
    try:
        for name in ("channels_last", "nchw", "nchw", "channels_last") * 2:
            resnet._layout = layouts[name]
            for _ in range(3):
                trainer._train_step(trainer._state, batch)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            sync()
            start.record()
            for _ in range(iters):
                trainer._train_step(trainer._state, batch)
            end.record()
            sync()
            out[name].append(start.elapsed_time(end) / iters)
        for name, layout in layouts.items():
            resnet._layout = layout
            prof = _profile_train_step(trainer, loader, f"7b {name}")
            out[name + "_device_ms"] = prof.get("device_ms")
    finally:
        resnet._layout = model_layout
    return out


def phase_resnet(ph: Phases, seed: int):
    """7b: ResNet-18 at bench_cifar's config: steady imgs/s over epochs
    2-4, ``validate(datamodule=...)`` accuracy, peak memory, and the
    step timed with channels-last and with NCHW activations, one warm
    step of each under torch.profiler (device time, idle share, top
    ops)."""
    from ray_lightning_accelerators_tpu_torch.models.resnet import ResNet18
    dm = _cifar_datamodule(seed)
    model = ResNet18({"lr": 0.01, "batch_size": CIFAR_BATCH}, device=DEV)
    loader = dm.train_dataloader()
    trainer, rec = _vision_fit(model, loader, CIFAR_EPOCHS, seed)
    _check_fit(ph, "7b ResNet-18", rec, CIFAR_STEPS * CIFAR_EPOCHS)
    (val,) = trainer.validate(model, datamodule=dm)
    rec["val"] = val
    ph.check(val["val_accuracy"] >= 0.5,
             f"7b ResNet-18: val accuracy {val['val_accuracy']:.4f} (>= 0.5; "
             f"chance 0.1)")
    log(f"  7b ResNet-18: {rec['imgs_per_s']:.1f} imgs/s over epochs 2-"
        f"{CIFAR_EPOCHS} (epoch s {[round(t, 4) for t in rec['epoch_s']]})"
        f"; peak memory {rec['peak_mem_gib']:.3f} GiB above the fit's start"
        f"; loss per step "
        f"{[round(v, 4) for v in rec['loss']]}; val {json.dumps(val)}")
    try:
        rec["layout"] = lay = _resnet_layout_ms(trainer, loader)
        log(f"  7b layout: step ms channels-last (the model's) "
            f"{[round(v, 3) for v in lay['channels_last']]}, NCHW "
            f"{[round(v, 3) for v in lay['nchw']]}; profiled device ms "
            f"channels-last {lay['channels_last_device_ms']}, NCHW "
            f"{lay['nchw_device_ms']}")
    except Exception as e:  # a measurement, not a check
        log(f"  7b layout: not measured ({type(e).__name__}: {e})")
    return rec


def phase_vit(ph: Phases, seed: int):
    """7c: ViT at the default ViTConfig on the same data: steady imgs/s,
    ``validate(datamodule=...)`` accuracy, peak memory, and the kernels'
    launches per step from the counters (K1 2L + 1 = 13, K2 6, K4 6: the
    64 patches fit one 512-key block, so K3a/K3b 0); then one warm step
    under torch.profiler."""
    from ray_lightning_accelerators_tpu_torch.models.vit import ViT, ViTConfig
    dm = _cifar_datamodule(seed)
    cfg = ViTConfig()
    model = ViT(cfg, lr=1e-3, device=DEV)
    loader = dm.train_dataloader()
    trainer, rec = _vision_fit(model, loader, CIFAR_EPOCHS, seed)
    _check_fit(ph, "7c ViT", rec, CIFAR_STEPS * CIFAR_EPOCHS)
    per = rec["launches_per_step"]
    L = cfg.n_layers
    ph.check(per["rms_norm"] == 2 * L + 1 and per["flash_attention"] == L
             and per["flash_backward_fused"] == L
             and per["flash_backward_dq"] == 0
             and per["flash_backward_dkv"] == 0,
             f"7c ViT: launches per step K1 {per['rms_norm']:g}, K2 "
             f"{per['flash_attention']:g}, K4 {per['flash_backward_fused']:g}"
             f", K3a/K3b {per['flash_backward_dq']:g}/"
             f"{per['flash_backward_dkv']:g} (want 13, 6, 6, 0/0)")
    (val,) = trainer.validate(model, datamodule=dm)
    rec["val"] = val
    ph.check(val["val_accuracy"] >= 0.5,
             f"7c ViT: val accuracy {val['val_accuracy']:.4f} (>= 0.5; "
             f"chance 0.1)")
    log(f"  7c ViT: {rec['imgs_per_s']:.1f} imgs/s over epochs 2-"
        f"{CIFAR_EPOCHS} (epoch s {[round(t, 4) for t in rec['epoch_s']]})"
        f"; peak memory {rec['peak_mem_gib']:.3f} GiB above the fit's start"
        f"; loss per step "
        f"{[round(v, 4) for v in rec['loss']]}; val {json.dumps(val)}")
    try:
        rec["profile"] = _profile_train_step(trainer, loader, "7c")
    except Exception as e:  # a measurement, not a check
        log(f"  7c profile: not measured ({type(e).__name__}: {e})")
    return rec


VISION_F32_STEPS, VISION_F32_BATCH = 3, 8


def _f32_side(make, init, seed: int, dev):
    """A model from ``init`` and the f32 trainer state that steps it."""
    from ray_lightning_accelerators_tpu_torch import Trainer
    model = make(dev)
    model.params = init
    tr = Trainer(max_epochs=1, device=dev, precision="f32",
                 enable_checkpointing=False, seed=seed)
    tr._bind(model)
    return tr, tr._build_state(model)


def _f32_batches(x, y):
    b = VISION_F32_BATCH
    return [(x[i * b:(i + 1) * b], y[i * b:(i + 1) * b])
            for i in range(VISION_F32_STEPS)]


def _free_steps(make, init, x, y, seed: int, dev):
    """The f32 steps, each from the side's own previous one: (losses,
    final params on the CPU)."""
    tr, st = _f32_side(make, init, seed, dev)
    losses = [float(tr._train_step(st, tr._put_batch(b))["train_loss"])
              for b in _f32_batches(x, y)]
    return losses, [p.detach().cpu() for p in st.opt.params]


def _gap(a, b):
    """(max loss rel, max per-leaf params rel L2) of run a against b."""
    return (max(abs(u - v) / abs(v) for u, v in zip(a[0], b[0])),
            max(_rel_l2(p, q) for p, q in zip(a[1], b[1])))


def _group_norm_written_out(x, scale, bias, groups: int = 32,
                            eps: float = 1e-5):
    """The port's ResNet GroupNorm with its arithmetic written out
    (f32 mean, then the mean of squared deviations, as the JAX package
    writes it) in place of ``F.group_norm``: equal in exact arithmetic,
    rounded differently."""
    c = x.shape[1]
    g = min(groups, c)
    while c % g:
        g -= 1
    xf = x.float().reshape(x.shape[0], g, -1)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (y * scale.float()[:, None, None]
            + bias.float()[:, None, None]).to(x.dtype)


def phase_vision_f32(ph: Phases, seed: int):
    """7d: three f32 steps of ResNet-18 at width 8 and of a small ViT
    (d 128, 2 heads: head dim 64, which K2 and K4 take) on the card
    against the CPU port, from the same weights on the same batches,
    cuDNN and matmul TF32 off (f32 on both sides; the card sums in other
    orders): every step's loss and each final parameter leaf within
    1e-3 relative (L2 for the leaves).  For ResNet-18 two measurements
    follow, against the same CPU run: the card with NCHW activations
    instead of the model's channels-last ones, and the CPU port with its
    GroupNorm written out instead of ``F.group_norm`` (equal in exact
    arithmetic).  At width 8 every GroupNorm group is one channel and the
    norm biases' gradients come out of cancellation, so where three
    steps lead turns on rounding; the second shows how far the CPU port
    moves from itself under a rounding change alone."""
    from ray_lightning_accelerators_tpu_torch.models import resnet
    from ray_lightning_accelerators_tpu_torch.models.vit import ViT, ViTConfig
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    x, y = resnet.synthetic_cifar10(VISION_F32_STEPS * VISION_F32_BATCH,
                                    seed + 5)
    makers = {
        "resnet18_w8": lambda dev: resnet.ResNet18({"width": 8, "lr": 0.01},
                                                   device=dev),
        "vit_d128": lambda dev: ViT(ViTConfig(d_model=128, n_heads=2,
                                              d_ff=256, n_layers=2),
                                    device=dev)}
    out = {}
    for name, make in makers.items():
        init = make("cpu").init_params(seed)
        cpu = _free_steps(make, init, x, y, seed, "cpu")
        loss_rel, param_rel = _gap(_free_steps(make, init, x, y, seed, DEV),
                                   cpu)
        ph.check(loss_rel <= 1e-3 and param_rel <= 1e-3,
                 f"7d {name}: f32 card vs CPU over {VISION_F32_STEPS} steps: "
                 f"loss max rel {loss_rel:.3e}, params max rel L2 "
                 f"{param_rel:.3e} (limits 1e-3)")
        out[name] = {"loss_max_rel": loss_rel, "params_max_rel_l2": param_rel}
        if not name.startswith("resnet"):
            continue
        for label, attr, swap, dev in (
                ("the card with NCHW activations", "_layout", _nchw_layout,
                 DEV),
                ("the CPU port with GroupNorm written out", "_group_norm",
                 _group_norm_written_out, "cpu")):
            kept = getattr(resnet, attr)
            setattr(resnet, attr, swap)
            try:
                gap = _gap(_free_steps(make, init, x, y, seed, dev), cpu)
            finally:
                setattr(resnet, attr, kept)
            out[name][label] = {"loss_max_rel": gap[0],
                                "params_max_rel_l2": gap[1]}
            log(f"  7d {name}: {label} vs the CPU port: loss max rel "
                f"{gap[0]:.3e}, params max rel L2 {gap[1]:.3e} "
                f"(measurement)")
    return out


# --------------------------------------------------------------------- #
# 8: mixture-of-experts, remat, int8 training, EMA and streaming LM data #
# --------------------------------------------------------------------- #
# the MoE card configuration: the GPT-2-small class widths with 8
# experts, top-2 at the JAX defaults' capacity factor and aux weight
MOE_CFG = dict(CFG, num_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
               moe_aux_weight=0.01)
MOE_TRAIN_CFG = dict(TRAIN_CFG, **{k: MOE_CFG[k] for k in (
    "num_experts", "moe_top_k", "moe_capacity_factor", "moe_aux_weight")})
MOE_TRAIN_BATCH = 8
MOE_RANGE_PREFIX = "moe "
# the roles of ops/moe.py's einsums, by equation
MOE_EINSUMS = {"bsd,de->bse": "moe router", "bsec,bsd->becd": "moe dispatch",
               "becd,edf->becf": "moe experts", "becf,efd->becd":
               "moe experts", "becd,bsec->bsd": "moe combine"}
REMAT_POLICIES = ("nothing", "dots", "dots_with_no_batch_dims",
                  "everything")
LM_CORPUS = os.path.join(HERE, "tests", "data", "text", "corpus.txt")
LM_CFG = dict(d_model=768, n_heads=12, d_ff=3072, n_layers=12,
              max_seq_len=512)
LM_BATCH, LM_VOCAB, LM_BPE_CHARS, LM_EMA = 8, 384, 20_000, 0.999


class _RangedTorch:
    """``torch`` as ops/moe.py sees it inside ``_moe_ranges``: each einsum
    runs in a profiler range named for its role, so a trace can give the
    MoE products' device time (a measurement aid of this script; the port
    itself opens no ranges)."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def einsum(eq, *operands):
        if not torch.autograd._profiler_enabled():
            return torch.einsum(eq, *operands)
        with torch.profiler.record_function(MOE_EINSUMS.get(eq, eq)):
            return torch.einsum(eq, *operands)


@contextlib.contextmanager
def _moe_ranges():
    """Profiler ranges around the MoE layer (``moe mlp``: routing,
    einsums and casts) and each of its einsums, while the block runs."""
    from ray_lightning_accelerators_tpu_torch.models import transformer
    from ray_lightning_accelerators_tpu_torch.ops import moe
    real_torch, real_mlp = moe.torch, transformer.moe_mlp

    def mlp(*args, **kwargs):
        if not torch.autograd._profiler_enabled():
            return real_mlp(*args, **kwargs)
        with torch.profiler.record_function("moe mlp"):
            return real_mlp(*args, **kwargs)

    moe.torch, transformer.moe_mlp = _RangedTorch(), mlp
    try:
        yield
    finally:
        moe.torch, transformer.moe_mlp = real_torch, real_mlp


def _device_events(prof):
    """The profiler's device events, less the device-side spans that
    ``_moe_ranges``'s profiler ranges add (they cover kernels already
    counted, and the gaps between them)."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith(MOE_RANGE_PREFIX)]


def _range_ms(prof) -> dict:
    """Device ms of the kernels launched inside each ``_moe_ranges``
    range, summed over its calls (host-side range events only)."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and \
                e.name.startswith(MOE_RANGE_PREFIX):
            out[e.name] = out.get(e.name, 0.0) + e.device_time_total / 1e3
    return out


def _moe_split(prof, d_ff: int, dev_ms: float, tag: str) -> dict:
    """The MoE layer's share of a profiled step.  Forward: the device ms
    under each ``_moe_ranges`` range.  Forward and backward: every
    ``aten::bmm`` by its operands' shapes -- a batch of 1 is a product
    without batch dims (the attention projections), a batch > 1 with
    ``d_ff`` among its dims an expert product, any other the dispatch or
    the combine."""
    out = {"forward": {}, "products": {"dense products": 0.0,
                                       "moe expert products": 0.0,
                                       "moe dispatch/combine": 0.0}}
    out["forward"] = _range_ms(prof)
    for e in prof.events():
        if e.name not in ("aten::bmm", "aten::mm", "aten::addmm"):
            continue
        shapes = [list(x) for x in e.input_shapes if x]
        key = "dense products"
        if e.name == "aten::bmm" and len(shapes) >= 2 and shapes[0][0] > 1:
            dims = set(shapes[0][1:]) | set(shapes[1][1:])
            key = ("moe expert products" if d_ff in dims
                   else "moe dispatch/combine")
        out["products"][key] += e.device_time_total / 1e3
    for group in ("forward", "products"):
        for name, ms in sorted(out[group].items()):
            log(f"    {tag} {group:<8} {ms:9.2f} ms  {ms / dev_ms * 100:5.1f}%"
                f"  {name}")
    return out


def phase_moe_serve(ph: Phases, model, params, label: str, seed: int,
                    expect_q8: bool):
    """8a: phase 3's burst through the paged engine on the MoE model:
    every request completes and the pool drains; with int8 weights K5
    runs only on the four attention projections a layer (the MoE MLP
    dequantizes its experts, as in the JAX package) and K6 on the LM
    head, one K6 call per forward (chunk or decode step)."""
    out = phase_serve(ph, model, params, label, seed, expect_q8)
    if out is None:
        return None
    st, n = out["stats"], out["launches"]
    ph.check(st["completed"] == len(_requests(seed))
             and st["block_pool_used"] == 0,
             f"{label}: the pool drained (block_pool_used="
             f"{st['block_pool_used']})")
    per_fwd = 4 * CFG["n_layers"]
    if expect_q8:
        ph.check(n["int8_matmul_nt"] > 0
                 and n["int8_matmul"] == per_fwd * n["int8_matmul_nt"],
                 f"{label}: K5 {n['int8_matmul']} = {per_fwd} attention "
                 f"projections x {n['int8_matmul_nt']} forwards (K6): none "
                 "on the experts")
    else:
        ph.check(n["int8_matmul"] == 0 and n["int8_matmul_nt"] == 0,
                 f"{label}: no K5 / K6 with bf16 weights")
    return out


def phase_moe_profile(model, params, q8, seed: int):
    """8a: phase 3c's profiled decode step on the MoE model, with bf16 and
    int8 weights, and the MoE layer's and its einsums' device time."""
    out = {}
    for label, p in (("moe bf16", params), ("moe int8", q8)):
        with _moe_ranges():
            out[label] = prof = phase_profile(model, p, label, seed)
        dev = prof["device_ms_per_step"]
        for name, us in sorted(prof["ranges"].items()):
            share = "" if not dev else f" ({us / 1e3 / dev * 100:.1f}%)"
            log(f"    {label}: {name}: {us:.1f} us a step{share}")
    return out


def phase_moe_prefill_logits(ph: Phases, cfg_obj, params, seed: int):
    """8c: phase 4c's prompt (128 tokens, read at 8 positions) through the
    MoE model's ``_prefill`` + unembedding: on the card in bf16 and in f32,
    on the CPU in f32 (the reference) and in bf16.  The card's f32 run
    must be within 1e-3 relative L2 of the CPU's (f32 on both sides: the
    kernels' arithmetic).  Its bf16 run cannot be held to 4a's 5e-2: a
    bf16 rounding of the router's input moves tokens to other experts
    (and their neighbours past the capacity), so the CPU port's own bf16
    run lands ~0.1 from its f32 run on these weights (this phase reads
    it) where the dense model's card run lands ~1e-2 (4c).  The check
    is that the card's bf16 run is no further from the reference than
    twice the CPU's own bf16 run in this call (and never a bound below
    5e-2).
    Reported: how many tokens' top-k expert sets differ from the
    reference's, layer by layer (the router's choice before capacity;
    each layer sees its run's drift above it)."""
    from ray_lightning_accelerators_tpu_torch.models.transformer import GPT
    from ray_lightning_accelerators_tpu_torch.ops import moe
    rng = np.random.default_rng(seed + 13)
    prompt = rng.integers(0, CFG["vocab_size"], (1, PROMPT))
    toks = torch.from_numpy(np.repeat(prompt, 8, 0))
    idx = torch.arange(PROMPT // 8 - 1, PROMPT, PROMPT // 8)
    real, chosen = moe.top_k_routing, []

    def recording(logits, top_k, capacity):
        chosen[-1].append(torch.topk(logits.float(), top_k, dim=-1)
                          .indices.sort(-1).values[0].cpu())
        return real(logits, top_k, capacity)

    def run(dev, dt):
        model = GPT(cfg_obj, device=dev, compute_dtype=dt)
        p = _cast_floats(_to(params, device=dev), dt)
        chosen.append([])
        h, _ = model._prefill(p, toks, PROMPT, last_index=idx)
        return model._unembed_matmul(h, p, dt).float().cpu()

    f32, bf = torch.float32, torch.bfloat16
    moe.top_k_routing = recording
    try:
        ref = run("cpu", f32)
        got = {"card bf16": run(DEV, bf), "card f32": run(DEV, f32),
               "cpu bf16": run("cpu", bf)}
    finally:
        moe.top_k_routing = real
    out = {}
    for (name, a), sets in zip(got.items(), chosen[1:]):
        rel = ((a - ref).norm() / ref.norm()).item()
        differ = [int((x != y).any(-1).sum()) for x, y in
                  zip(sets, chosen[0])]
        out[name] = {"rel_l2": rel, "greedy_agree": (
            a.argmax(-1) == ref.argmax(-1)).float().mean().item(),
            "finite": bool(torch.isfinite(a).all()),
            "expert_sets_differ": differ}
        log(f"  8c {name} vs cpu f32: rel L2 {rel:.3e}, greedy agreement "
            f"{out[name]['greedy_agree']:.3f}; tokens of {PROMPT} whose "
            f"top-{cfg_obj.moe_top_k} experts differ, layer by layer: "
            f"{differ}")
    card, card32 = out["card bf16"], out["card f32"]
    bound = max(5e-2, 2 * out["cpu bf16"]["rel_l2"])
    ph.check(card32["finite"] and card32["rel_l2"] <= 1e-3,
             f"8c: MoE prefill logits, card f32 vs CPU f32: rel L2 "
             f"{card32['rel_l2']:.3e} (limit 1e-3)")
    ph.check(card["finite"] and card["rel_l2"] <= bound,
             f"8c: MoE prefill logits, card bf16 vs CPU f32: rel L2 "
             f"{card['rel_l2']:.3e} (limit {bound:.3e}: twice the CPU's "
             f"own bf16 run, {out['cpu bf16']['rel_l2']:.3e})")
    return out


def phase_moe_train(ph: Phases, seed: int):
    """8d: Trainer.fit of the MoE model at 6a's recipe (seq 1024, fused
    loss, 1024 flash blocks, AdamW 3e-4, the counting pattern, 2 epochs
    of 8 steps) at batch 8: the loss falls, ``moe_aux_loss`` reaches
    ``callback_metrics``, K1 25, K2 12 and K4 12 launches a step; step
    ms, tokens/s, peak memory and a profiled step by kind with the MoE
    products split out."""
    steps = TRAIN_EPOCHS * TRAIN_STEPS_PER_EPOCH
    root = os.path.join(HERE, "build", "chip_smoke_fit_moe")
    trainer, model, loader, clock, launches, wall = _fit(
        MOE_TRAIN_CFG, TRAIN_STEPS_PER_EPOCH, seed, root,
        batch=MOE_TRAIN_BATCH)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    L = MOE_TRAIN_CFG["n_layers"]
    first, last = clock.loss[0], clock.loss[-1]
    ph.check(trainer.global_step == steps and all(np.isfinite(clock.loss))
             and last < first,
             f"8d: {trainer.global_step} steps, loss {first:.4f} -> "
             f"{last:.4f} (must fall)")
    aux = trainer.callback_metrics.get("moe_aux_loss")
    ph.check(aux is not None and np.isfinite(aux),
             f"8d: moe_aux_loss in callback_metrics ({aux})")
    ph.check(launches["rms_norm"] == (2 * L + 1) * steps
             and launches["flash_attention"] == L * steps
             and launches["flash_backward_fused"] == L * steps,
             f"8d: K1 {launches['rms_norm'] / steps:.0f}, K2 "
             f"{launches['flash_attention'] / steps:.0f}, K4 "
             f"{launches['flash_backward_fused'] / steps:.0f} launches a "
             "step")
    step_ms = clock.warm_step_ms()
    mean_ms = float(np.mean(step_ms))
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_CFG["max_seq_len"]
    log(f"  8d: {steps} steps in {wall:.2f} s wall; warm step_ms mean "
        f"{mean_ms:.2f} (min {min(step_ms):.2f}, max {max(step_ms):.2f}); "
        f"tokens/s {tokens / mean_ms * 1e3:.1f}; peak memory "
        f"{peak_gb:.2f} GiB; loss per step "
        f"{[round(x, 4) for x in clock.loss]}; moe_aux_loss {aux}")
    out = {"step_ms": step_ms, "step_ms_mean": mean_ms,
           "tokens_per_s": tokens / mean_ms * 1e3, "peak_mem_gib": peak_gb,
           "loss": clock.loss, "moe_aux_loss": aux, "launches": launches}
    try:
        out["profile"] = _profile_train_step(trainer, loader, "8d",
                                             MOE_TRAIN_CFG["d_ff"])
    except Exception as e:  # a measurement, not a check
        log(f"  8d profile: not measured ({type(e).__name__}: {e})")
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    return out


def _first_step(cfg_dict: dict, params0, batch):
    """One bf16 training step's loss and gradient global norm from the
    f32 weights ``params0`` (forward and backward, no update), with K2's
    launches in it."""
    from ray_lightning_accelerators_tpu_torch.core.optim import (
        global_norm, tree_leaves)
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    from ray_lightning_accelerators_tpu_torch.ops import attention
    model = GPT(TransformerConfig(**cfg_dict), device=DEV,
                compute_dtype=torch.bfloat16)
    params = _tree_clone(params0)
    _reset_counts()
    loss, _ = model.training_step(params, batch)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    norm = float(global_norm(grads))
    return float(loss.detach()), norm, attention.flash_forward.launches


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def phase_remat(ph: Phases, seed: int):
    """8f: remat at 6a's config, dense.  One step from the same weights on
    the same batch under each policy against no remat: the loss within
    1e-3 relative, the gradient global norm within 1e-2 (K4's dq sums
    with atomics in no fixed order), K2 launched 24 times a step where
    the backward recomputes the layer and 12 where it does not.  Then
    Trainer.fit under each (2 epochs of 8 steps without remat, 8 steps
    under each policy, no checkpoint file: cut from 2 epochs with a
    checkpoint at each end for the script's time limit):
    step ms, peak memory (below no remat's under "nothing"), the loss
    falling."""
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    L = TRAIN_CFG["n_layers"]
    params0 = GPT(TransformerConfig(**TRAIN_CFG), device=DEV).init_params(
        seed + 31)
    batch = torch.from_numpy(_pattern_tokens(
        TRAIN_BATCH, TRAIN_CFG["max_seq_len"], TRAIN_CFG["vocab_size"],
        seed + 32)).to(DEV)
    runs = [("no remat", dict(TRAIN_CFG))] + [
        (p, dict(TRAIN_CFG, remat=True, remat_policy=p))
        for p in REMAT_POLICIES]
    out = {}
    base = None
    for name, cfg_dict in runs:
        loss, norm, k2 = _first_step(cfg_dict, params0, batch)
        recomputes = name not in ("no remat", "everything")
        if base is None:
            base = (loss, norm)
        ph.check(abs(loss - base[0]) <= 1e-3 * abs(base[0])
                 and abs(norm - base[1]) <= 1e-2 * base[1]
                 and k2 == (2 if recomputes else 1) * L,
                 f"8f {name}: first step loss {loss:.6f} (no remat "
                 f"{base[0]:.6f}), grad norm {norm:.5f} ({base[1]:.5f}), "
                 f"K2 {k2} launches")
        root = os.path.join(HERE, "build", "chip_smoke_fit_remat")
        # a finished fit's trainer and module reference each other: free
        # them before the next fit's peak is read
        gc.collect()
        held = torch.cuda.memory_allocated() / 2 ** 30
        # the fit without remat keeps its 2 epochs: 8f int8's last loss
        # is held against it
        fit = _fit(cfg_dict, TRAIN_STEPS_PER_EPOCH, seed, root,
                   enable_checkpointing=False,
                   **({} if name == "no remat"
                      else {"max_steps": TRAIN_STEPS_PER_EPOCH}))
        import shutil
        shutil.rmtree(root, ignore_errors=True)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 - held
        steps, clock, launches = fit[0].global_step, fit[3], fit[4]
        del fit     # the next fit's peak must not hold this one's state
        step_ms = clock.warm_step_ms()
        ph.check(all(np.isfinite(clock.loss))
                 and clock.loss[-1] < clock.loss[0]
                 and launches["flash_attention"] == steps * k2,
                 f"8f {name}: fit loss {clock.loss[0]:.4f} -> "
                 f"{clock.loss[-1]:.4f}, K2 {launches['flash_attention']} "
                 f"launches in {steps} steps")
        log(f"  8f {name}: warm step_ms mean {np.mean(step_ms):.2f} (min "
            f"{min(step_ms):.2f}); peak memory {peak:.2f} GiB above the "
            f"{held:.2f} GiB held before the fit")
        out[name] = {"first_loss": loss, "grad_norm": norm, "k2_step": k2,
                     "step_ms": step_ms, "step_ms_mean": float(
                         np.mean(step_ms)), "peak_mem_gib": peak,
                     "held_gib": held, "loss": clock.loss}
    if "nothing" in out:
        ph.check(out["nothing"]["peak_mem_gib"]
                 < out["no remat"]["peak_mem_gib"],
                 f"8f: peak memory under 'nothing' "
                 f"{out['nothing']['peak_mem_gib']:.2f} GiB < no remat "
                 f"{out['no remat']['peak_mem_gib']:.2f} GiB")
    return out


class _EvalLaunches:
    """Callback: K5's launches inside validation passes, so a training
    step's count can be read apart."""

    def __init__(self):
        from ray_lightning_accelerators_tpu_torch import Callback
        from ray_lightning_accelerators_tpu_torch.ops import quant
        outer = self
        self.in_eval, self._at = 0, 0

        class Cb(Callback):
            def on_validation_start(self, trainer, module):
                outer._at = quant.int8_matmul.launches

            def on_validation_end(self, trainer, module):
                outer.in_eval += quant.int8_matmul.launches - outer._at

        self.cb = Cb()


def _k5_training_rows(ph: Phases, seed: int):
    """K5 at the int8 training forward's two shapes (M = 16 x 1024 rows:
    the MLP up and down products) against its plain version, timed beside
    ``x @ dq`` in cuBLAS (bf16), the product the plain training forward
    would run, and the bound."""
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        _channel_quant)
    from ray_lightning_accelerators_tpu_torch.ops import quant
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(seed + 41)
    m, d, f = TRAIN_BATCH * TRAIN_CFG["max_seq_len"], CFG["d_model"], \
        CFG["d_ff"]
    floor = launch_floor_ms()
    rows = []
    for k, n in ((d, f), (f, d)):
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        w = torch.randn(k, n, generator=g, device=dev) * k ** -0.5
        wq, sc, dq = _channel_quant(w)
        dq = dq.to(torch.bfloat16)
        got = quant.int8_matmul(x, wq, sc)
        ref = quant.int8_matmul_reference(x, wq, sc)
        err = (got.float() - ref.float()).abs().max().item()
        rel = _rel_l2(got, ref)
        shape = f"M={m},K={k},N={n} training"
        ph.check(rel <= 1e-2, f"K5 int8_matmul {shape} max|err|={err:.3e} "
                              f"rel L2={rel:.3e} (limit 1e-2)")
        nbytes = m * k * 2 + k * n + n * 4 + m * n * 2
        rows.append(_turns_row(
            "K5", "int8_matmul", shape, err,
            lambda x=x, wq=wq, sc=sc: quant.int8_matmul(x, wq, sc),
            lambda x=x, wq=wq, sc=sc: quant.int8_matmul_reference(x, wq, sc),
            lambda x=x, dq=dq: x @ dq,
            bound_ms(nbytes, 2 * m * k * n, BF16_TENSOR_FLOPS), floor))
    _log_turns_rows(rows, "x@dq")
    return rows


def phase_int8_train(ph: Phases, seed: int, remat):
    """8f: ``Trainer(int8_matmul=True)`` at 6a's config for 16 steps with
    a validation pass each epoch: the loss falls, K5 launches exactly 24
    times a training step (the dense MLP's two products in 12 layers;
    validation's launches read apart), and the last loss is within 2% of
    the bf16 run's (the no-remat fit of ``phase_remat``, same seed and
    data: the JAX package's bar, tests/test_overlap_gather.py:303-319).
    Then K5 at the two training shapes against its plain version, timed
    beside ``x @ dq``."""
    steps = TRAIN_EPOCHS * TRAIN_STEPS_PER_EPOCH
    L = TRAIN_CFG["n_layers"]
    counter = _EvalLaunches()
    val = _pattern_tokens(TRAIN_BATCH, TRAIN_CFG["max_seq_len"],
                          TRAIN_CFG["vocab_size"], seed + 51)
    root = os.path.join(HERE, "build", "chip_smoke_fit_int8")
    trainer, model, _, clock, launches, wall = _fit(
        TRAIN_CFG, TRAIN_STEPS_PER_EPOCH, seed, root, val_data=val,
        callbacks=[counter.cb], int8_matmul=True)
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    train_k5 = launches["int8_matmul"] - counter.in_eval
    ph.check(model.int8_matmul and trainer.global_step == steps
             and train_k5 == 2 * L * steps,
             f"8f int8: K5 {train_k5} launches in {steps} training steps "
             f"({train_k5 / steps:.0f} a step, want {2 * L}); "
             f"{counter.in_eval} in validation")
    first, last = clock.loss[0], clock.loss[-1]
    ph.check(all(np.isfinite(clock.loss)) and last < first,
             f"8f int8: loss {first:.4f} -> {last:.4f} (must fall)")
    ref = ((remat or {}).get("no remat") or {}).get("loss")
    if ref is None:
        root = os.path.join(HERE, "build", "chip_smoke_fit_bf16")
        ref = _fit(TRAIN_CFG, TRAIN_STEPS_PER_EPOCH, seed, root)[3].loss
        shutil.rmtree(root, ignore_errors=True)
    gap = abs(last - ref[-1]) / ref[-1]
    ph.check(gap < 0.02, f"8f int8: last loss {last:.4f} vs bf16 "
                         f"{ref[-1]:.4f}: {gap * 100:.2f}% (limit 2%)")
    step_ms = clock.warm_step_ms()
    bf16_ms = ((remat or {}).get("no remat") or {}).get("step_ms_mean")
    log(f"  8f int8: warm step_ms mean {np.mean(step_ms):.2f} (bf16 fit "
        f"of 8f: {bf16_ms if bf16_ms is None else round(bf16_ms, 2)}); "
        f"val_loss "
        f"{trainer.callback_metrics.get('val_loss')}")
    rows = _k5_training_rows(ph, seed)
    return {"loss": clock.loss, "bf16_last_loss": ref[-1], "gap": gap,
            "k5_train_per_step": train_k5 / steps, "k5_eval":
            counter.in_eval, "step_ms": step_ms, "step_ms_mean": float(
                np.mean(step_ms)), "k5_rows": rows}


def phase_lm_ema(ph: Phases, seed: int):
    """8g: the LM data path with EMA: ``BPETokenizer`` (vocab 384) trained
    on the first 20,000 characters of the committed real-text corpus,
    the whole corpus split on blank lines into documents, a
    ``StreamingLMDataset`` of 512-token rows (the last eighth of the
    documents held out for validation) -> ``DataLoader`` (batch 8) ->
    ``Trainer.fit(GPT)`` (d 768, 12 heads, d_ff 3072, 12 layers) with
    ``ema_decay=0.999, ema_eval=True`` for 2 epochs: the loss falls,
    ``trainer.ema_params()`` differs from the raw params, and validation
    ran on the shadow (its val_loss is the shadow's, not the raw
    params')."""
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.core.optim import tree_leaves
    from ray_lightning_accelerators_tpu_torch.data.lm import (
        BPETokenizer, StreamingLMDataset)
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    with open(LM_CORPUS, encoding="utf-8") as fh:
        text = fh.read()
    t0 = time.perf_counter()
    tok = BPETokenizer(text[:LM_BPE_CHARS], vocab_size=LM_VOCAB)
    docs = [tok.encode(d) for d in text.split("\n\n") if d]
    cut = len(docs) * 7 // 8
    train_docs, val_docs = docs[:cut], docs[cut:]
    log(f"  8g: BPE ({len(tok.merges)} merges) and {len(docs)} documents, "
        f"{sum(map(len, docs))} tokens, in "
        f"{time.perf_counter() - t0:.1f} s")
    seq = LM_CFG["max_seq_len"]
    train = DataLoader(StreamingLMDataset(lambda e: iter(train_docs), seq),
                       batch_size=LM_BATCH)
    val = DataLoader(StreamingLMDataset(lambda e: iter(val_docs), seq),
                     batch_size=LM_BATCH)
    model = GPT(TransformerConfig(vocab_size=tok.vocab_size, **LM_CFG),
                device=DEV, lr=3e-4)
    clock = _StepClock()
    trainer = Trainer(max_epochs=TRAIN_EPOCHS, device=DEV, precision="bf16",
                      log_every_n_steps=10 ** 9, seed=seed,
                      ema_decay=LM_EMA, ema_eval=True,
                      callbacks=[clock.cb], enable_checkpointing=False)
    t0 = time.perf_counter()
    trainer.fit(model, train, val)
    sync()
    wall = time.perf_counter() - t0
    per_epoch = len(clock.loss) // TRAIN_EPOCHS
    first = float(np.mean(clock.loss[:per_epoch]))
    last = float(np.mean(clock.loss[per_epoch:]))
    ph.check(len(clock.loss) > 2 and all(np.isfinite(clock.loss))
             and last < first,
             f"8g: {len(clock.loss)} steps of {LM_BATCH} x {seq} tokens; "
             f"mean loss epoch 1 {first:.4f} -> epoch 2 {last:.4f} (must "
             "fall)")
    shadow = tree_leaves(trainer.ema_params())
    raw = tree_leaves(trainer._state.params)
    moved = max(float((a - b).abs().max()) for a, b in zip(shadow, raw))
    ph.check(moved > 0, f"8g: ema_params() differs from the raw params "
                        f"(max |shadow - raw| {moved:.3e})")
    on_shadow = trainer._run_eval(val, model.validation_step,
                                  trainer.ema_params())
    trainer.ema_eval = False
    on_raw = trainer._run_eval(val, model.validation_step,
                               trainer._state.params)
    reported = trainer.callback_metrics["val_loss"]
    ph.check(abs(reported - on_shadow["val_loss"]) <= 1e-6 * abs(reported)
             and abs(reported - on_raw["val_loss"]) > 1e-3,
             f"8g: val_loss {reported:.5f} is the shadow's "
             f"({on_shadow['val_loss']:.5f}), not the raw params' "
             f"({on_raw['val_loss']:.5f})")
    step_ms = clock.warm_step_ms()
    log(f"  8g: fit {wall:.2f} s wall; warm step_ms mean "
        f"{np.mean(step_ms):.2f}; loss per step "
        f"{[round(x, 4) for x in clock.loss]}")
    return {"loss": clock.loss, "val_loss_shadow": on_shadow["val_loss"],
            "val_loss_raw": on_raw["val_loss"], "step_ms": step_ms,
            "wall_s": wall}


# --------------------------------------------------------------------- #
# phase 9: data parallelism over spawned ranks                           #
# --------------------------------------------------------------------- #
class _RankStepClock(_Callback):
    """A synchronised host clock and the loss at every step, kept inside
    a rank; its state comes home with rank 0's callback states."""

    def __init__(self):
        self.t, self.loss, self.epoch = [], [], []
        self.t_fit = [0.0, 0.0]   # fit start and end, the same clock

    def on_fit_start(self, trainer, module):
        self.t_fit[0] = time.perf_counter()

    def on_fit_end(self, trainer, module):
        self.t_fit[1] = time.perf_counter()

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        self.t.append(time.perf_counter())
        self.loss.append(float(metrics["train_loss"]))
        self.epoch.append(trainer.current_epoch)

    def state_dict(self):
        return {"t": self.t, "loss": self.loss, "epoch": self.epoch,
                "t_fit": self.t_fit}

    def load_state_dict(self, state):
        self.t, self.loss, self.epoch, self.t_fit = (
            state["t"], state["loss"], state["epoch"], state["t_fit"])


def phase_dp_fit(ph: Phases, seed: int, inproc: Optional[dict]):
    """9a: 6a's fit (the GPT bench config, 2 epochs of 8 steps, same seed
    and data) through ``Trainer(accelerator=RayAccelerator(num_workers=1,
    use_gpu=True))``: one spawned rank over an NCCL group of world size 1
    (the machine has one card).  The rank ran on cuda:0 over NCCL; one
    gradient all-reduce a step (CUDA events in the rank); K1 25, K2 12 and
    K4 12 launches a step, counted in the rank and sent home with rank
    0's result; rank 0's weights in the driver's module on the card,
    equal to the checkpoint rank 0 wrote; the first step's loss bitwise
    the in-process 6a fit's (K2 is deterministic), the last within 1% (K4
    adds dq by atomics); ``trainer.test`` through the same world."""
    from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                      RayAccelerator,
                                                      Trainer)
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    from ray_lightning_accelerators_tpu_torch.utils import checkpoint
    cfg = TransformerConfig(**TRAIN_CFG)
    steps = TRAIN_EPOCHS * TRAIN_STEPS_PER_EPOCH
    L = cfg.n_layers
    data = _pattern_tokens(TRAIN_BATCH * TRAIN_STEPS_PER_EPOCH,
                           cfg.max_seq_len, cfg.vocab_size, seed)
    root = os.path.join(HERE, "build", "chip_smoke_dp")
    clock = _RankStepClock()
    acc = RayAccelerator(num_workers=1, use_gpu=DEV.startswith("cuda"))
    trainer = Trainer(max_epochs=TRAIN_EPOCHS, device=DEV, precision="bf16",
                      log_every_n_steps=10 ** 9, seed=seed, callbacks=[clock],
                      default_root_dir=root, accelerator=acc)
    model = GPT(cfg, device=DEV, lr=3e-4)
    t0 = time.perf_counter()
    world = trainer._acquire_world(acc.launch_spec())
    spawn_s = time.perf_counter() - t0
    pids = [w.pid for w in world.pool.workers]
    t0 = time.perf_counter()
    trainer.fit(model, DataLoader(ArrayDataset(data), batch_size=TRAIN_BATCH,
                                  shuffle=True, seed=seed))
    wall = time.perf_counter() - t0
    rep = trainer.rank_report
    per_step = {k: v / steps for k, v in rep["launches"].items()}
    ph.check(rep["device"] == "cuda:0" and rep["backend"] == "nccl"
             and rep["world_size"] == 1,
             f"9a: the rank ran on {rep['device']} over {rep['backend']}, "
             f"world size {rep['world_size']}")
    ph.check(trainer.global_step == steps and rep["all_reduces"] == steps,
             f"9a: {trainer.global_step} steps, {rep['all_reduces']} "
             f"gradient all-reduces of {rep['bucket_numel']} f32 "
             "(one a step)")
    ph.check(rep["launches"]["rms_norm"] == (2 * L + 1) * steps
             and rep["launches"]["flash_forward"] == L * steps
             and rep["launches"]["flash_backward_fused"] == L * steps
             and rep["launches"]["flash_backward_dq"] == 0,
             f"9a: launches a step in the rank: K1 {per_step['rms_norm']:g}, "
             f"K2 {per_step['flash_forward']:g}, K4 "
             f"{per_step['flash_backward_fused']:g}, K3a "
             f"{per_step['flash_backward_dq']:g}")
    leaves = [t for t in _flat_params(model.params).values()]
    saved = checkpoint.restore_params(checkpoint.read_checkpoint(
        trainer.checkpoint_callback.best_model_path), "cpu")
    same = all(torch.equal(a.cpu(), b) for a, b in zip(
        _flat_params(model.params).values(), _flat_params(saved).values()))
    ph.check(all(t.device.type == torch.device(DEV).type
                 and t.dtype == torch.float32 for t in leaves) and same
             and len(leaves) == len(_flat_params(saved)),
             f"9a: rank 0's {len(leaves)} weights are in the driver's "
             f"module on {leaves[0].device}, equal to the checkpoint rank 0 "
             f"wrote ({os.path.basename(trainer.checkpoint_callback.best_model_path)})")
    ref = (inproc or {}).get("loss") or []
    ok_ref = len(ref) == steps == len(clock.loss)
    ph.check(ok_ref and clock.loss[0] == ref[0],
             f"9a: first loss {clock.loss[0]!r} vs in-process 6a "
             f"{ref[0] if ref else None!r} (bitwise)")
    ph.check(ok_ref and abs(clock.loss[-1] - ref[-1]) <= 0.01 * abs(ref[-1])
             and clock.loss[-1] < clock.loss[0],
             f"9a: last loss {clock.loss[-1]:.5f} vs 6a "
             f"{ref[-1] if ref else float('nan'):.5f} (within 1%)")
    val = _pattern_tokens(TRAIN_BATCH, cfg.max_seq_len, cfg.vocab_size,
                          seed + 1)
    (tested,) = trainer.test(model, DataLoader(ArrayDataset(val),
                                               batch_size=TRAIN_BATCH))
    same_world = trainer._world is world and \
        [w.pid for w in world.pool.workers] == pids
    ph.check(same_world and np.isfinite(tested["val_loss"]),
             f"9a: trainer.test in the same world (pids {pids}): val_loss "
             f"{tested['val_loss']:.4f}")
    procs = [w._proc for w in world.pool.workers]
    trainer.shutdown_workers()
    ph.check(not any(p.is_alive() for p in procs),
             "9a: no rank outlives shutdown_workers()")
    step_ms = [(clock.t[i] - clock.t[i - 1]) * 1e3
               for i in range(2, len(clock.t))
               if clock.epoch[i] == clock.epoch[i - 1]]
    ar_ms = rep["all_reduce_ms"]
    in_ms = (inproc or {}).get("step_ms_mean", float("nan"))
    log(f"  9a: spawn + rendezvous {spawn_s:.2f} s; fit {wall:.2f} s wall "
        f"(the rank's fit {rep['fit_s']:.2f} s: to its first step "
        f"{clock.t[0] - clock.t_fit[0]:.2f} s, steps "
        f"{clock.t[-1] - clock.t[0]:.2f} s, after its last step "
        f"{clock.t_fit[1] - clock.t[-1]:.2f} s; its run "
        f"{rep['run_s']:.2f} s; 6a "
        f"{(inproc or {}).get('wall_s', float('nan')):.2f} s); "
        f"warm step_ms mean {np.mean(step_ms):.2f} (in-process 6a "
        f"{in_ms:.2f}); all-reduce of {rep['bucket_numel']} f32: the "
        f"first {ar_ms[0]:.3f} ms (NCCL forms its communicator), then "
        f"median {np.median(ar_ms[1:]):.4f} ms a step; loss per step "
        f"{[round(x, 4) for x in clock.loss]}")
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    return {"spawn_rendezvous_s": spawn_s, "wall_s": wall,
            "step_ms": step_ms, "step_ms_mean": float(np.mean(step_ms)),
            "inproc_step_ms_mean": in_ms, "loss": clock.loss,
            "all_reduce_ms": ar_ms, "report": rep,
            "launches_per_step": per_step, "test": tested}


DP_RANKS = 2


def _dp_one_step(rank: int, cfg_dict: dict, seed: int, tokens: np.ndarray,
                 device: str):
    """One rank of 9b: one bf16 step of ``cfg_dict``'s GPT from the
    seed's weights on this rank's rows of the global batch."""
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    model = GPT(TransformerConfig(**cfg_dict), device=device, lr=3e-4)
    trainer = Trainer(max_steps=1, device=device, precision="bf16",
                      log_every_n_steps=1, log_grad_norm=True, seed=seed,
                      enable_checkpointing=False)
    trainer.fit(model, DataLoader(ArrayDataset(tokens),
                                  batch_size=len(tokens)))
    out = {"grad_norm": trainer.callback_metrics["grad_norm"],
           **trainer._exchange.stats()}
    if rank == 0:
        out["params"] = {k: v.cpu().numpy()
                         for k, v in _flat_params(model.params).items()}
    else:
        out["checksum"] = float(sum(float(v.double().sum()) for v in
                                    _flat_params(model.params).values()))
    return out


def phase_dp_two_ranks(ph: Phases, seed: int):
    """9b: two ranks sharing the one card over a gloo group
    (``DistributedWorld(2, backend="gloo")``, NCCL refuses two ranks on
    one device): each takes 8 rows of one full-width global batch of 16
    and makes one bf16 step from the seed's weights; the averaged
    gradient's global norm and the post-step params against one
    in-process step on all 16 rows.  bf16 bound, 1e-2 relative for the
    norm and per-leaf relative L2 of the params: the grads come out of
    bf16 products (2^-8 relative rounding), a rank's rows are summed in
    another order than all 16, and AdamW's first update is +-lr for every
    element, so an element whose gradient is below its rounding may step
    the other way."""
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
        DistributedWorld)
    import functools
    cfg = TransformerConfig(**TRAIN_CFG)
    tokens = _pattern_tokens(TRAIN_BATCH, cfg.max_seq_len, cfg.vocab_size,
                             seed + 2)
    dev = "cuda:0" if DEV.startswith("cuda") else DEV
    t0 = time.perf_counter()
    world = DistributedWorld(DP_RANKS, devices=[dev] * DP_RANKS,
                             backend="gloo")
    spawn_s = time.perf_counter() - t0
    try:
        r0, r1 = world.run(functools.partial(
            _dp_one_step, cfg_dict=TRAIN_CFG, seed=seed, tokens=tokens,
            device=dev))
    finally:
        procs = [w._proc for w in world.pool.workers] if world.pool else []
        world.shutdown()
    model = GPT(cfg, device=DEV, lr=3e-4)
    ref = Trainer(max_steps=1, device=DEV, precision="bf16",
                  log_every_n_steps=1, log_grad_norm=True, seed=seed,
                  enable_checkpointing=False)
    ref.fit(model, DataLoader(ArrayDataset(tokens), batch_size=TRAIN_BATCH))
    ref_norm = ref.logger.history[0]["grad_norm"]
    ref_params = _flat_params(model.params)
    rel = {k: _rel_l2(torch.from_numpy(r0["params"][k]),
                      ref_params[k].cpu()) for k in ref_params}
    worst = max(rel, key=rel.get)
    flipped = sum(int(((torch.from_numpy(r0["params"][k]) -
                        ref_params[k].cpu()).abs() > 0).sum())
                  for k in ref_params)
    n_params = sum(v.numel() for v in ref_params.values())
    checksum0 = float(sum(float(torch.from_numpy(v).double().sum())
                          for v in r0["params"].values()))
    norm_rel = abs(r0["grad_norm"] - ref_norm) / ref_norm
    ph.check(r0["all_reduces"] == r1["all_reduces"] == 1
             and r0["grad_norm"] == r1["grad_norm"]
             and checksum0 == r1["checksum"],
             f"9b: {DP_RANKS} gloo ranks on {dev}: one all-reduce each, the "
             f"same averaged grad norm {r0['grad_norm']:.6f} and the same "
             "params on both ranks")
    ph.check(norm_rel <= 1e-2 and rel[worst] <= 1e-2,
             f"9b: averaged grad norm {r0['grad_norm']:.6f} vs one step on "
             f"all {TRAIN_BATCH} rows {ref_norm:.6f} (rel {norm_rel:.3e}); "
             f"params max rel L2 {rel[worst]:.3e} ({worst}); limits 1e-2 "
             f"(bf16); {flipped} of {n_params} params differ")
    ph.check(not any(p.is_alive() for p in procs),
             "9b: no rank outlives the world's shutdown")
    ar_ms = r0["all_reduce_ms"]
    log(f"  9b: spawn + rendezvous {spawn_s:.2f} s; gloo all-reduce of "
        f"{r0['bucket_numel']} f32 ({r0['bucket_numel'] * 4 / 2 ** 20:.1f} "
        f"MiB) {ar_ms[0]:.2f} ms on rank 0, {r1['all_reduce_ms'][0]:.2f} ms "
        f"on rank 1")
    return {"spawn_rendezvous_s": spawn_s, "grad_norm": r0["grad_norm"],
            "grad_norm_ref": ref_norm, "grad_norm_rel": norm_rel,
            "params_max_rel_l2": rel[worst], "params_differing": flipped,
            "n_params": n_params, "bucket_numel": r0["bucket_numel"],
            "all_reduce_ms": [ar_ms[0], r1["all_reduce_ms"][0]]}


# --------------------------------------------------------------------- #
# phase 10: sharded data parallelism                                     #
# --------------------------------------------------------------------- #
class _ResidualProbe(_Callback):
    """Inside a rank: the L1 norm of the error-feedback residuals after
    each step (their sum over the leaves); its state comes home with rank
    0's callback states."""

    def __init__(self):
        self.l1 = []

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        from ray_lightning_accelerators_tpu_torch.core.optim import (
            tree_leaves)
        res = trainer._state.residual
        self.l1.append(0.0 if res is None else float(sum(
            r.abs().sum() for r in tree_leaves(res))))

    def state_dict(self):
        return {"l1": self.l1}

    def load_state_dict(self, state):
        self.l1 = state["l1"]


class _SharedCardAccelerator(_RayTPUAccelerator):
    """``RayTPUAccelerator`` with every rank on the one card (10b, 11):
    NCCL refuses two ranks on one device, so the world is a gloo group
    the phase forms itself and binds to each trainer.  The world is
    ``num_workers`` times the model axes' sizes."""

    def select_devices(self):
        dev = (torch.device("cuda", 0) if self.device_type == "cuda"
               else torch.device("cpu"))
        cfg = self.mesh_config
        return [dev] * (self.num_workers * cfg.pipeline * cfg.expert
                        * cfg.sequence * cfg.tensor)


def _collective_ms(rep: dict) -> dict:
    """Total ms and calls of each collective kind in a rank report."""
    return {k: (round(float(sum(v)), 3), len(v))
            for k, v in rep.get("collective_ms", {}).items() if v}


def _span_ms(rep: dict) -> dict:
    """Each timed stretch of a rank's steps (the whole exchange with its
    arithmetic, the compute view's gather, ...): ms of each call."""
    return {k: [round(float(x), 3) for x in v]
            for k, v in rep.get("span_ms", {}).items() if v}


# 10a's step-8 loss against 6a's, relative.  On the H100 the sound int8
# exchange reads 2.73e-6 (two runs in one call: the same bits);
# exchanges broken on purpose read 1.68e-5 (error feedback dropped),
# 2.26e-5 (the mean doubled) and 2.78e-3 (block scales shifted by one)
INT8_LAST_LOSS_REL = 7e-6


def phase_sharded_fit(ph: Phases, seed: int, inproc: Optional[dict]):
    """10a: ``Trainer(accelerator=RayTPUAccelerator(1, use_fsdp=True),
    grad_compression="int8", checkpoint_format="sharded")``, one epoch of
    6a's fit (8 steps; same seed, data and weights), one rank over an
    NCCL group of world size 1 (the machine has one card, so fsdp=1
    splits nothing): the int8 two-phase exchange's arithmetic runs on
    the card, one exchange per compressible leaf a step, the residuals
    nonzero from step 1; K1 25, K2 12 and K4 12 launches a step in the
    rank; the first loss bitwise 6a's (the exchange runs after it), the
    last within ``INT8_LAST_LOSS_REL`` of 6a's step 8; the sharded
    checkpoint verifies and restores bitwise the params shipped home."""
    from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                      RayTPUAccelerator,
                                                      Trainer)
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    from ray_lightning_accelerators_tpu_torch.parallel import collectives
    from ray_lightning_accelerators_tpu_torch.utils import (
        sharded_checkpoint)
    cfg = TransformerConfig(**TRAIN_CFG)
    steps = TRAIN_STEPS_PER_EPOCH
    L = cfg.n_layers
    data = _pattern_tokens(TRAIN_BATCH * TRAIN_STEPS_PER_EPOCH,
                           cfg.max_seq_len, cfg.vocab_size, seed)
    root = os.path.join(HERE, "build", "chip_smoke_sharded")
    clock, probe = _RankStepClock(), _ResidualProbe()
    trainer = Trainer(max_epochs=1, device=DEV, precision="bf16",
                      log_every_n_steps=10 ** 9, seed=seed,
                      callbacks=[clock, probe], default_root_dir=root,
                      accelerator=RayTPUAccelerator(1, use_fsdp=True),
                      grad_compression="int8", checkpoint_format="sharded")
    model = GPT(cfg, device=DEV, lr=3e-4)
    t0 = time.perf_counter()
    trainer.fit(model, DataLoader(ArrayDataset(data), batch_size=TRAIN_BATCH,
                                  shuffle=True, seed=seed))
    wall = time.perf_counter() - t0
    rep = trainer.rank_report
    per_step = {k: v / steps for k, v in rep["launches"].items()}
    ph.check(rep["device"] == "cuda:0" and rep["backend"] == "nccl"
             and rep["world_size"] == 1,
             f"10a: the rank ran on {rep['device']} over {rep['backend']}, "
             f"world size {rep['world_size']}")
    ph.check(rep["launches"]["rms_norm"] == (2 * L + 1) * steps
             and rep["launches"]["flash_forward"] == L * steps
             and rep["launches"]["flash_backward_fused"] == L * steps
             and rep["launches"]["flash_backward_dq"] == 0,
             f"10a: launches a step in the rank: K1 "
             f"{per_step['rms_norm']:g}, K2 {per_step['flash_forward']:g}, "
             f"K4 {per_step['flash_backward_fused']:g}, K3a "
             f"{per_step['flash_backward_dq']:g}")
    leaves = list(_flat_params(model.params).values())
    n_comp = sum(1 for t in leaves
                 if t.numel() >= collectives.DEFAULT_MIN_COMPRESS_SIZE)
    ph.check(trainer.global_step == steps
             and rep["compressed_exchanges"] == n_comp * steps,
             f"10a: {rep['compressed_exchanges']} int8 exchanges in "
             f"{trainer.global_step} steps ({n_comp} compressible leaves "
             f"of {len(leaves)}: one each a step); plan "
             f"{rep['plan']['regime']}, {rep['plan']['fields']}")
    ph.check(len(probe.l1) == steps and min(probe.l1) > 0,
             f"10a: residual L1 after each step "
             f"{[round(x, 3) for x in probe.l1]} (nonzero from step 1)")
    ref = (inproc or {}).get("loss") or []
    ok_ref = len(ref) >= steps and len(clock.loss) == steps
    ph.check(ok_ref and clock.loss[0] == ref[0],
             f"10a: first loss {clock.loss[0]!r} vs in-process 6a "
             f"{ref[0] if ref else None!r} (bitwise)")
    last_rel = (abs(clock.loss[-1] - ref[steps - 1]) / abs(ref[steps - 1])
                if ok_ref else float("nan"))
    ph.check(ok_ref and last_rel <= INT8_LAST_LOSS_REL
             and clock.loss[-1] < clock.loss[0],
             f"10a: loss at step {steps} {clock.loss[-1]:.6f} vs 6a "
             f"{ref[steps - 1] if ok_ref else float('nan'):.6f} (rel "
             f"{last_rel:.3e}, limit {INT8_LAST_LOSS_REL:g})")
    best = trainer.checkpoint_callback.best_model_path
    verdict = sharded_checkpoint.verify_checkpoint(best)
    restored = _flat_params(sharded_checkpoint.restore_params(best, "cpu"))
    shipped = _flat_params(model.params)
    same = restored.keys() == shipped.keys() and all(
        torch.equal(restored[k], shipped[k].cpu()) for k in shipped)
    ph.check(verdict == (True, "ok") and same,
             f"10a: the sharded checkpoint {os.path.basename(best)} "
             f"verifies ({verdict[1]}) and restores bitwise the "
             f"{len(shipped)} params shipped home")
    procs = [w._proc for w in trainer._world.pool.workers]
    trainer.shutdown_workers()
    ph.check(not any(p.is_alive() for p in procs),
             "10a: no rank outlives shutdown_workers()")
    step_ms = [(clock.t[i] - clock.t[i - 1]) * 1e3
               for i in range(2, len(clock.t))]
    coll = _collective_ms(rep)
    spans = _span_ms(rep)
    ex = spans.get("exchange", [])
    ph.check(len(ex) == steps,
             f"10a: one timed exchange a step ({len(ex)} in {steps} steps)")
    ex_ms = float(np.median(ex[1:])) if len(ex) > 1 else float("nan")
    log(f"  10a: fit {wall:.2f} s wall (the rank's {rep['fit_s']:.2f} s); "
        f"warm step_ms mean {np.mean(step_ms):.2f} (in-process 6a "
        f"{(inproc or {}).get('step_ms_mean', float('nan')):.2f}); the int8 "
        f"exchange (quantization and collectives, CUDA events) median "
        f"{ex_ms:.3f} ms a step after the first "
        f"({100 * ex_ms / np.mean(step_ms):.2f}% of a warm step; each "
        f"step's {ex}); other stretches {spans}; per kind, total ms and "
        f"calls (the first NCCL all-reduce forms the communicator): {coll}; "
        f"comms_per_step "
        f"{trainer.comms_per_step}; loss per step "
        f"{[round(x, 4) for x in clock.loss]}")
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    return {"wall_s": wall, "step_ms": step_ms,
            "step_ms_mean": float(np.mean(step_ms)), "loss": clock.loss,
            "exchange_ms_per_step": ex_ms, "collective_ms": coll,
            "span_ms": spans,
            "residual_l1": probe.l1, "report": rep,
            "comms_per_step": trainer.comms_per_step,
            "launches_per_step": per_step}


SHARD_RANKS = 2
# 10b's backward is K3a + K3b (512 key blocks at 1024 keys): K4 adds dq
# by atomics, so two runs of it differ in the last bits, and ZeRO-1's
# bitwise check against data parallelism needs the same bits from both;
# 6a's widths at 4 layers (12 before), cut for the time limit
SHARD_CFG = dict(TRAIN_CFG, flash_block_k=512, n_layers=4)


def _predicted_owned_bytes(shapes: dict, layouts: dict, regime: str,
                           ranks: int, int8: bool) -> int:
    """A rank's state bytes from the plan's layouts alone: f32 params and
    AdamW's two moments, each leaf whole or 1/ranks of it, plus the int8
    residuals (the padded owned chunk of a reduce-scattered leaf, the
    whole of a replicated large one, a 1-element placeholder else)."""
    total = 0
    for name, shape in shapes.items():
        numel = int(np.prod(shape))
        split = layouts.get(name) is not None
        if regime == "zero1":
            own_p = numel
            own_m = numel // ranks if shape[0] % ranks == 0 else numel
        else:
            own_p = own_m = numel // ranks if split else numel
        total += own_p + 2 * own_m
        if int8:
            if numel < 2048:
                total += 1
            elif split:
                chunk = numel // ranks
                total += chunk + (-chunk) % 256
            else:
                total += numel
    return 4 * total


def phase_sharded_two_ranks(ph: Phases, seed: int):
    """10b: two ranks sharing the card over one gloo group
    (``DistributedWorld(2, backend="gloo")``), ``Trainer.fit`` through
    ``_SharedCardAccelerator(2, ...)`` for 2 bf16 steps from the seed's
    weights on one global batch of 16 (8 rows a rank): plain data
    parallelism, (iii) ZeRO-1, (i) ``use_fsdp`` exact and (ii)
    ``use_fsdp`` + int8 with a ``"sharded"`` checkpoint.  Against 2
    in-process steps on all 16 rows: the step-2 loss and each param's
    relative L2 within 1e-2 (9b's bf16 bound).  Each rank's owned state
    bytes (params + moments + residuals) within 5% of the plan's
    prediction; ZeRO-1's params bitwise the data-parallel run's; the
    2-rank checkpoint restored into a world-1 trainer: params bitwise
    the gathered ones, residuals zero."""
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
        DistributedWorld)
    from ray_lightning_accelerators_tpu_torch.core.optim import tree_leaves
    cfg = TransformerConfig(**SHARD_CFG)
    tokens = _pattern_tokens(TRAIN_BATCH, cfg.max_seq_len, cfg.vocab_size,
                             seed + 3)
    dev = "cuda:0" if DEV.startswith("cuda") else DEV
    root = os.path.join(HERE, "build", "chip_smoke_sharded2")
    t0 = time.perf_counter()
    world = DistributedWorld(SHARD_RANKS, devices=[dev] * SHARD_RANKS,
                             backend="gloo")
    spawn_s = time.perf_counter() - t0
    specs = [("dp", False, {}),
             ("zero1", False, dict(shard_optimizer_state=True)),
             ("fsdp", True, {}),
             ("fsdp_int8", True, dict(grad_compression="int8",
                                      checkpoint_format="sharded"))]
    runs = {}
    try:
        for name, use_fsdp, kw in specs:
            t = Trainer(max_steps=2, device=DEV, precision="bf16",
                        log_every_n_steps=1, log_grad_norm=True, seed=seed,
                        enable_checkpointing="checkpoint_format" in kw,
                        default_root_dir=os.path.join(root, name),
                        accelerator=_SharedCardAccelerator(
                            SHARD_RANKS, use_fsdp=use_fsdp), **kw)
            t._world = world          # the phase's gloo group
            model = GPT(cfg, device=DEV, lr=3e-4)
            t1 = time.perf_counter()
            t.fit(model, DataLoader(ArrayDataset(tokens),
                                    batch_size=TRAIN_BATCH))
            runs[name] = {"trainer": t, "model": model,
                          "wall_s": time.perf_counter() - t1,
                          "loss": [r["train_loss"] for r in t.logger.history
                                   if "train_loss" in r]}
            t._world = None
    finally:
        procs = [w._proc for w in world.pool.workers] if world.pool else []
        world.shutdown()
    ph.check(not any(p.is_alive() for p in procs),
             "10b: no rank outlives the world's shutdown")
    ref_model = GPT(cfg, device=DEV, lr=3e-4)
    ref = Trainer(max_steps=2, device=DEV, precision="bf16",
                  log_every_n_steps=1, log_grad_norm=True, seed=seed,
                  enable_checkpointing=False)
    ref.fit(ref_model, DataLoader(ArrayDataset(tokens),
                                  batch_size=TRAIN_BATCH))
    ref_loss = [r["train_loss"] for r in ref.logger.history
                if "train_loss" in r]
    ref_params = _flat_params(ref_model.params)
    shapes = {k: tuple(v.shape) for k, v in ref_params.items()}
    out = {"spawn_rendezvous_s": spawn_s, "runs": {}}
    for name, use_fsdp, kw in specs:
        run = runs.get(name)
        if run is None:
            ph.check(False, f"10b {name}: did not run")
            continue
        t, rep = run["trainer"], run["trainer"].rank_report
        params = _flat_params(run["model"].params)
        rel = {k: _rel_l2(params[k].cpu(), ref_params[k].cpu())
               for k in ref_params}
        worst = max(rel, key=rel.get)
        loss_rel = abs(run["loss"][-1] - ref_loss[-1]) / abs(ref_loss[-1])
        ph.check(len(run["loss"]) == 2 and loss_rel <= 1e-2
                 and rel[worst] <= 1e-2,
                 f"10b {name}: step-2 loss {run['loss'][-1]:.5f} vs "
                 f"{ref_loss[-1]:.5f} on all {TRAIN_BATCH} rows in-process "
                 f"(rel {loss_rel:.3e}); params max rel L2 {rel[worst]:.3e} "
                 f"({worst}); limits 1e-2 (bf16)")
        layouts = {"/" + "/".join(k.split("/")[1:]): v for k, v in
                   _flat_layouts(rep.get("param_layouts", {})).items()}
        regime = "zero1" if name == "zero1" else (
            "fsdp" if use_fsdp else "dp")
        want = _predicted_owned_bytes(shapes, layouts, regime, SHARD_RANKS,
                                      "grad_compression" in kw)
        owned = rep.get("owned_bytes", {})
        got = sum(owned.get(f, 0) for f in ("params", "opt_state",
                                            "residual"))
        what = "params + moments" + (" + residuals" if "grad_compression"
                                     in kw else "")
        mib = {k: round(v / 2 ** 20, 1) for k, v in owned.items()}
        ph.check(abs(got - want) <= 0.05 * want,
                 f"10b {name}: rank 0 holds {got / 2 ** 20:.1f} MiB of "
                 f"{what} ({mib} MiB), the plan predicts "
                 f"{want / 2 ** 20:.1f} (within 5%)")
        coll = _collective_ms(rep)
        spans = _span_ms(rep)
        log(f"  10b {name}: fit {run['wall_s']:.2f} s; plan "
            f"{rep['plan']['regime']} {rep['plan']['fields']}; rank 0's "
            f"stretches, ms each step: {spans}; per kind, total ms and "
            f"calls: {coll}; comms_per_step {t.comms_per_step}")
        out["runs"][name] = {"loss": run["loss"], "params_max_rel_l2":
                             rel[worst], "loss_rel": loss_rel,
                             "owned_bytes": owned, "predicted_bytes": want,
                             "collective_ms": coll, "span_ms": spans,
                             "wall_s": run["wall_s"],
                             "comms_per_step": t.comms_per_step}
    if "dp" in runs and "zero1" in runs:
        a = _flat_params(runs["dp"]["model"].params)
        b = _flat_params(runs["zero1"]["model"].params)
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        ph.check(not differ and runs["dp"]["loss"] == runs["zero1"]["loss"],
                 f"10b zero1: params and losses bitwise the data-parallel "
                 f"run's in the same world (leaves differing: {differ})")
    if "fsdp_int8" in runs:
        best = runs["fsdp_int8"]["trainer"].checkpoint_callback \
            .best_model_path
        t1 = Trainer(max_steps=2, device=DEV, precision="bf16", seed=seed,
                     grad_compression="int8", enable_checkpointing=False,
                     default_root_dir=os.path.join(root, "world1"))
        m1 = GPT(cfg, device=DEV, lr=3e-4)
        t1.fit(m1, DataLoader(ArrayDataset(tokens), batch_size=TRAIN_BATCH),
               ckpt_path=best)
        gathered = _flat_params(runs["fsdp_int8"]["model"].params)
        restored = _flat_params(m1.params)
        same = all(torch.equal(restored[k], gathered[k]) for k in gathered)
        res_zero = all(not r.any() for r in tree_leaves(t1._state.residual))
        ph.check(same and res_zero and t1.global_step == 2,
                 f"10b: the 2-rank sharded checkpoint "
                 f"{os.path.basename(best)} restores into a world-1 "
                 f"trainer: {len(gathered)} params bitwise the gathered "
                 f"ones, residuals reset to zero")
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    return out


# --------------------------------------------------------------------- #
# phase 11: the model-parallel axes                                      #
# --------------------------------------------------------------------- #
MP_RANKS = 2
MP_BATCH, MP_STEPS = 8, 3
# phases 11-13 run 6a's widths at 4 layers (12 until PR 19): their
# ranks' gloo collectives and stage workers scale with depth, and the
# script must end inside its time limit with phase 16 added
MP_LAYERS = 4


def _mp_fit(cfg_dict: dict, tokens: np.ndarray, seed: int, world,
            accelerator, steps: int = MP_STEPS, **kw):
    """``steps`` bf16 steps of ``cfg_dict``'s GPT from the seed's weights
    on the global batch ``tokens``, over ``world`` (None with an
    accelerator: its own spawned ranks; without: in this process, on all
    rows)."""
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    clock = _RankStepClock()
    t = Trainer(**{**dict(max_steps=steps, device=DEV, precision="bf16",
                          log_every_n_steps=1, log_grad_norm=True,
                          seed=seed, enable_checkpointing=False,
                          callbacks=[clock], accelerator=accelerator),
                   **kw})
    if world is not None:
        t._world = world
    model = GPT(TransformerConfig(**cfg_dict), device=DEV, lr=3e-4)
    t0 = time.perf_counter()
    t.fit(model, DataLoader(ArrayDataset(tokens), batch_size=len(tokens)))
    sync()
    wall = time.perf_counter() - t0
    if world is not None:
        t._world = None
    loss = [r["train_loss"] for r in t.logger.history if "train_loss" in r]
    return t, model, clock, loss, wall


def _mp_comms(rep: dict, steps: int) -> dict:
    """The model axes' collectives of a rank's fit: calls and CUDA-event
    ms a step, by kind."""
    mc = rep.get("model_comms", {})
    return {k: {"calls_per_step": round(n / steps, 2),
                "ms_per_step": round(float(sum(mc["ms"].get(k, []))) / steps,
                                     3)}
            for k, n in mc.get("counts", {}).items()}


def _mp_predicted_bytes(shapes: dict, layouts: dict, sizes: dict) -> int:
    """A rank's f32 params from the plan's layouts: each leaf's share
    over the axes that split it (bytes; AdamW's moments are twice it)."""
    total = 0
    for name, shape in shapes.items():
        split = int(np.prod([sizes[a] for a, _ in layouts.get(name) or ()]))
        total += int(np.prod(shape)) // split
    return 4 * total


def phase_model_parallel(ph: Phases, seed: int):
    """11: the model-parallel axes.  The machine has one card, so the
    axes run over two gloo ranks sharing it (NCCL refuses two ranks on
    one device; ``DistributedWorld(2, backend="gloo")``, one world for
    every sub-phase).  First 11-: one step over NCCL at world size 1 (the
    rank builds its mesh's groups with ``new_group`` on NCCL).  Then, 3
    bf16 steps of 6a's full-width GPT at ``MP_LAYERS`` = 4 layers (seq
    1024, 1024 flash blocks) from the seed's weights on one global batch
    of 8, each against 3
    in-process steps on the same 8 rows (9b's bf16 bound: 1e-2 relative
    on every loss and on each gathered param's relative L2 after step
    3):
    11a ``tensor=2``: K1 9, K2 4 and K4 4 launches a step on each rank
    (the ranks' own counters), each rank's params and AdamW moments
    within 1% of the plan's prediction (half of every tensor-split leaf,
    every replicated leaf whole), the replicated leaves (the ``ln*``
    scales) bitwise equal across the ranks;
    11b ``seq_parallel=2, seq_parallel_mode="ulysses"``: K1 9, K2 4, K4
    4 a step;
    11c ``seq_parallel=2, seq_parallel_mode="ring"``: K1 9 and no flash
    kernel (K2, K3a, K3b, K4 0: the ring ran, not Ulysses);
    11d ``expert=2`` on 8d's MoE GPT (8 experts, top-2, capacity 1.25):
    K1 9, K2 4, K4 4 a step, the expert leaves' bytes halved.
    Each prints the step time beside the in-process one, each collective
    kind's calls and CUDA-event ms a step, and the ppermute's route."""
    from ray_lightning_accelerators_tpu_torch import RayTPUAccelerator
    from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
        DistributedWorld)
    out = {"card": "one card: the model axes run over gloo ranks sharing "
                   "it"}
    log("  11: " + out["card"])
    # the earlier phases' cached blocks go back to the card: two ranks
    # share it with this process
    gc.collect()
    torch.cuda.empty_cache()
    dense = dict(TRAIN_CFG, n_layers=MP_LAYERS)
    moe = dict(MOE_TRAIN_CFG, n_layers=MP_LAYERS)
    L = dense["n_layers"]
    tokens = _pattern_tokens(MP_BATCH, dense["max_seq_len"],
                             dense["vocab_size"], seed + 11)
    # 11-: the groups over NCCL at world size 1, one step
    t, _, _, loss, wall = _mp_fit(dense, tokens, seed, None,
                                  RayTPUAccelerator(1), steps=1)
    rep = t.rank_report
    t.shutdown_workers()
    groups = rep.get("mesh_groups", {})
    ph.check(rep["backend"] == "nccl" and groups.get("batch") == [
        [0], "nccl"] and len(loss) == 1,
             f"11-: world size {rep['world_size']} over {rep['backend']}: "
             f"the rank's groups {groups}, {len(loss)} steps in {wall:.2f} s")
    out["nccl_world1"] = {"groups": groups, "wall_s": wall}
    refs = {}
    for name, cfg_dict in (("dense", dense), ("moe", moe),
                           ("moe_again", moe)):
        t, model, clock, loss, wall = _mp_fit(cfg_dict, tokens, seed, None,
                                              None)
        refs[name] = {"loss": loss, "params": {
            k: v.detach().float().cpu()
            for k, v in _flat_params(model.params).items()},
            "step_ms": [(clock.t[i] - clock.t[i - 1]) * 1e3
                        for i in range(1, len(clock.t))]}
    # the in-process MoE run against itself: K4's atomic dq rounds two
    # runs apart, and top-2 routing turns that into other experts' updates
    again = refs.pop("moe_again")
    drift = max(_rel_l2(again["params"][k], refs["moe"]["params"][k])
                for k in again["params"])
    out["moe_inprocess_drift"] = {"params_max_rel_l2": drift,
                                  "loss": again["loss"]}
    del t, model, clock
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  11: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} "
        f"GiB of the card before the ranks start")
    log(f"  11: the in-process MoE run twice: params max rel L2 "
        f"{drift:.3e}, losses {[round(x, 5) for x in again['loss']]} and "
        f"{[round(x, 5) for x in refs['moe']['loss']]}")
    dev = "cuda:0" if DEV.startswith("cuda") else DEV
    t0 = time.perf_counter()
    world = DistributedWorld(MP_RANKS, devices=[dev] * MP_RANKS,
                             backend="gloo")
    out["spawn_rendezvous_s"] = time.perf_counter() - t0
    specs = [("11a", "dense", dict(tensor=2), {}),
             ("11b", "dense", {}, dict(seq_parallel=2,
                                       seq_parallel_mode="ulysses")),
             ("11c", "dense", {}, dict(seq_parallel=2,
                                       seq_parallel_mode="ring")),
             ("11d", "moe", dict(expert=2), {})]
    runs = {}
    try:
        for tag, kind, axes, kw in specs:
            cfg_dict = dense if kind == "dense" else moe
            try:
                runs[tag] = _mp_fit(cfg_dict, tokens, seed, world,
                                    _SharedCardAccelerator(1, **axes), **kw)
            except Exception as e:
                ph.check(False, f"{tag}: the fit failed: "
                         f"{type(e).__name__}: {str(e)[:2000]}")
                if not world.alive():
                    break
    finally:
        procs = [w._proc for w in world.pool.workers] if world.pool else []
        world.shutdown()
    ph.check(not any(p.is_alive() for p in procs),
             "11: no rank outlives the world's shutdown")
    for tag, kind, axes, kw in specs:
        if tag not in runs:
            continue
        t, model, clock, loss, wall = runs[tag]
        rep = t.rank_report
        ref = refs[kind]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss,
                                                           ref["loss"]))
        params = _flat_params(model.params)
        rel = {k: _rel_l2(params[k].float().cpu(), ref["params"][k])
               for k in ref["params"]}
        worst = max(rel, key=rel.get)
        ph.check(len(loss) == MP_STEPS and loss_rel <= 1e-2
                 and rel[worst] <= 1e-2,
                 f"{tag} {axes or kw}: losses {[round(x, 5) for x in loss]} "
                 f"vs in-process {[round(x, 5) for x in ref['loss']]} (max "
                 f"rel {loss_rel:.3e}); gathered params after step "
                 f"{MP_STEPS} max rel L2 {rel[worst]:.3e} ({worst}); "
                 f"limits 1e-2 (bf16)")
        by_rank = rep.get("launches_by_rank", [])
        want = {"rms_norm": 2 * L + 1, "flash_forward": L,
                "flash_backward_fused": L, "flash_backward_dq": 0,
                "flash_backward_dkv": 0}
        if tag == "11c":
            want.update(flash_forward=0, flash_backward_fused=0)
        per_step = [{k: r.get(k, 0) / MP_STEPS for k in want}
                    for r in by_rank]
        ph.check(len(by_rank) == MP_RANKS
                 and all(p == want for p in per_step),
                 f"{tag}: launches a step on each rank {per_step} (want "
                 f"{want})")
        sizes = rep.get("mesh", {})
        layouts = {"/" + "/".join(k.split("/")[1:]): v for k, v in
                   _flat_layouts(rep.get("param_layouts", {})).items()}
        shapes = {k: tuple(v.shape) for k, v in ref["params"].items()}
        want_b = _mp_predicted_bytes(shapes, layouts, sizes)
        owned = rep.get("owned_bytes_by_rank", [])
        ok_bytes = len(owned) == MP_RANKS and all(
            abs(o.get("params", 0) - want_b) <= 0.01 * want_b
            and abs(o.get("opt_state", 0) - 2 * want_b) <= 0.02 * want_b
            for o in owned)
        whole = 4 * sum(int(np.prod(v)) for v in shapes.values())
        ph.check(ok_bytes,
                 f"{tag}: each rank holds params "
                 f"{[round(o.get('params', 0) / 2 ** 20, 1) for o in owned]}"
                 f" MiB and moments "
                 f"{[round(o.get('opt_state', 0) / 2 ** 20, 1) for o in owned]}"
                 f" MiB; the plan predicts {want_b / 2 ** 20:.1f} and "
                 f"{2 * want_b / 2 ** 20:.1f} (within 1%; whole "
                 f"{whole / 2 ** 20:.1f})")
        if tag == "11d":
            experts = [k for k in shapes if k.endswith(("mlp/wi",
                                                        "mlp/wo"))]
            half = all(rep["state_shapes"]["params" + k][1] * 2
                       == shapes[k][1] for k in experts)
            ph.check(bool(experts) and half,
                     f"11d: the expert leaves {experts} hold half their "
                     f"experts on each rank")
        if tag in ("11a", "11d"):
            ph.check(rep.get("replicated_bitwise_equal") is True,
                     f"{tag}: the replicated leaves (ln1, ln2, ln_f, ...) "
                     f"are bitwise equal across the ranks after step "
                     f"{MP_STEPS}")
        comms = _mp_comms(rep, MP_STEPS)
        via = rep.get("model_comms", {}).get("ppermute_via")
        step_ms = [(clock.t[i] - clock.t[i - 1]) * 1e3
                   for i in range(1, len(clock.t))]
        log(f"  {tag}: fit {wall:.2f} s; step ms {[round(x, 1) for x in step_ms]}"
            f" (in-process, all 8 rows: "
            f"{[round(x, 1) for x in ref['step_ms']]}); the model axes' "
            f"collectives a step (calls, CUDA-event ms): {comms}; "
            f"ppermute via {via}; the gradient exchange's "
            f"{_collective_ms(rep)}; spans {_span_ms(rep)}")
        out[tag] = {"axes": axes or kw, "loss": loss, "loss_rel": loss_rel,
                    "params_max_rel_l2": rel[worst], "wall_s": wall,
                    "step_ms": step_ms, "ref_step_ms": ref["step_ms"],
                    "comms_per_step": comms, "ppermute_via": via,
                    "launches_by_rank": by_rank, "owned_bytes": owned,
                    "predicted_param_bytes": want_b,
                    "replicated_bitwise_equal":
                        rep.get("replicated_bitwise_equal")}
    return out


# --------------------------------------------------------------------- #
# phase 12: the 2-D layouts and the pipeline axis                        #
# --------------------------------------------------------------------- #
P12_MICROBATCHES = 4


def _history_of(trainer, key: str) -> list:
    return [r[key] for r in trainer.logger.history if key in r]


def _p12_reference(cfg_dict: dict, tokens: np.ndarray, seed: int, **kw):
    """MP_STEPS in-process bf16 steps on all rows: the losses, the
    logged grad norms, the params and the step ms."""
    t, model, clock, loss, wall = _mp_fit(cfg_dict, tokens, seed, None,
                                          None, **kw)
    ref = {"loss": loss, "grad_norm": _history_of(t, "grad_norm"),
           "params": {k: v.detach().float().cpu()
                      for k, v in _flat_params(model.params).items()},
           "step_ms": [(clock.t[i] - clock.t[i - 1]) * 1e3
                       for i in range(1, len(clock.t))]}
    del t, model, clock
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def _p12_check_fit(ph: Phases, tag: str, run, ref: dict, what: str,
                   norm: bool = False) -> dict:
    """The fit's losses (and logged grad norms) against the in-process
    run's within 1e-2 relative (bf16), and its gathered params' max
    relative L2."""
    t, model, clock, loss, wall = run
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss, ref["loss"]))
    params = _flat_params(model.params)
    rel = {k: _rel_l2(params[k].float().cpu(), ref["params"][k])
           for k in ref["params"]}
    worst = max(rel, key=rel.get)
    out = {"loss": loss, "loss_rel": loss_rel,
           "params_max_rel_l2": rel[worst], "wall_s": wall,
           "step_ms": [(clock.t[i] - clock.t[i - 1]) * 1e3
                       for i in range(1, len(clock.t))],
           "ref_step_ms": ref["step_ms"]}
    ok = len(loss) == MP_STEPS and loss_rel <= 1e-2 and rel[worst] <= 1e-2
    msg = (f"{tag} {what}: losses {[round(x, 5) for x in loss]} vs "
           f"in-process {[round(x, 5) for x in ref['loss']]} (max rel "
           f"{loss_rel:.3e}); gathered params max rel L2 {rel[worst]:.3e} "
           f"({worst})")
    if norm:
        gn = _history_of(t, "grad_norm")
        norm_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(gn, ref["grad_norm"]))
        ok = ok and len(gn) == MP_STEPS and norm_rel <= 1e-2
        msg += (f"; logged grad_norm {[round(x, 5) for x in gn]} vs "
                f"{[round(x, 5) for x in ref['grad_norm']]} (max rel "
                f"{norm_rel:.3e})")
        out.update(grad_norm=gn, grad_norm_rel=norm_rel)
    ph.check(ok, msg + "; limits 1e-2 (bf16)")
    return out


def _p12_launch_check(ph: Phases, tag: str, rep: dict, want: dict) -> list:
    by_rank = rep.get("launches_by_rank", [])
    per_step = [{k: r.get(k, 0) / MP_STEPS for k in want} for r in by_rank]
    ph.check(bool(by_rank) and all(p == want for p in per_step),
             f"{tag}: kernel launches a step on each rank {per_step} "
             f"(want {want})")
    return by_rank


P12_VIT_BATCH = 64
# the kernels a rank report counts, by the names _read_counts gives them
_REPORT_NAMES = {"rms_norm": "rms_norm", "flash_forward": "flash_attention",
                 "flash_backward_fused": "flash_backward_fused",
                 "flash_backward_dq": "flash_backward_dq",
                 "flash_backward_dkv": "flash_backward_dkv"}


def _p12_vit_fit(x, y, seed: int, world, accelerator):
    """MP_STEPS bf16 steps of ViT at the default ``ViTConfig`` from the
    seed's weights on the rows ``x, y`` (P12_VIT_BATCH a step), over
    ``world`` with ``accelerator`` or, with neither, in this process:
    the ``_mp_fit`` tuple."""
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.vit import (ViT,
                                                                 ViTConfig)
    clock = _RankStepClock()
    t = Trainer(max_steps=MP_STEPS, device=DEV, precision="bf16",
                log_every_n_steps=1, log_grad_norm=True, seed=seed,
                enable_checkpointing=False, callbacks=[clock],
                accelerator=accelerator)
    if world is not None:
        t._world = world
    model = ViT(ViTConfig(), lr=1e-3, device=DEV)
    t0 = time.perf_counter()
    t.fit(model, DataLoader(ArrayDataset(x, y), batch_size=P12_VIT_BATCH))
    sync()
    wall = time.perf_counter() - t0
    if world is not None:
        t._world = None
    loss = [r["train_loss"] for r in t.logger.history if "train_loss" in r]
    return t, model, clock, loss, wall


def phase_2d_and_pipeline(ph: Phases, seed: int):
    """12: the 2-D layouts and the SPMD pipeline axis on 6a's full-width
    GPT at ``MP_LAYERS`` = 4 layers (seq 1024, 1024 flash blocks), global
    batch 8, 3 bf16 steps each
    against 3 in-process steps on the same rows from the seed's weights.
    The machine has one card, so the ranks are gloo ranks sharing it
    (NCCL refuses two ranks on one device): one world of 4 for 12a, one
    of 2 for 12b and 12c.
    12a fsdp 2 x tensor 2 over 4 ranks: the losses and the logged global
    grad norm within 1e-2 of in-process (the norm sums the fsdp group's
    squares too: summed over the tensor group alone it read 27% low on
    the CPU); each rank's params and AdamW moments within 0.1 MiB of the
    plan's prediction (a quarter of each leaf that fsdp and tensor both
    split); a sharded checkpoint written by the 4 ranks (format 2, a
    rectangle per part) restored in this process, params bitwise the
    gathered ones; K1 9, K2 4, K4 4 a step on each rank.
    12b ``int8_matmul=True`` at tensor 2 over 2 ranks: K5 8 a step on
    each rank (its rows of wo with the whole weight's scales, one max
    all-reduce a layer), the losses within 1e-2 of the in-process int8
    run.
    12c ``pipeline=2`` with 4 microbatches over 2 ranks: each rank runs
    its 2 layers for each of the M + S - 1 = 5 ticks, so K1 21 (2 a
    layer a tick and the final norm), K2 10 and K4 10 a step; the losses
    within 1e-2 of in-process; the activations' hops by route (gloo over
    CUDA tensors: all-gather and select) with their calls and ms.
    12d ``pipeline=2 x tensor=2`` with 4 microbatches on 12a's 4 ranks
    (before that world shuts down): each rank runs its stage's 2 layers
    on its 6 heads for 5 ticks, so K1 21, K2 10, K4 10 a step as 12c;
    the losses and the logged grad norm within 1e-2 of in-process, the
    hops within each tensor coordinate's pipeline group, every leaf
    bitwise equal over each group that does not split it.
    12e ViT at the default ``ViTConfig`` at ``pipeline=2`` on 12b's 2
    ranks, 3 steps of 64 images: no schedule, every stage runs the whole
    forward on the same rows with the layer stack gathered over the
    stages, so each rank launches what one in-process step does (K1 13,
    K2 6, K4 6); the losses within 1e-2 of the in-process ViT's."""
    import shutil
    import tempfile
    from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
        DistributedWorld)
    from ray_lightning_accelerators_tpu_torch.utils import (
        sharded_checkpoint)
    out = {"card": "one card: the ranks are gloo ranks sharing it"}
    log("  12: " + out["card"])
    gc.collect()
    torch.cuda.empty_cache()
    dense = dict(TRAIN_CFG, n_layers=MP_LAYERS)
    piped = dict(dense, pipeline_microbatches=P12_MICROBATCHES)
    L = dense["n_layers"]
    tokens = _pattern_tokens(MP_BATCH, dense["max_seq_len"],
                             dense["vocab_size"], seed + 12)
    refs = {"dense": _p12_reference(dense, tokens, seed),
            "int8": _p12_reference(dense, tokens, seed, int8_matmul=True)}
    from ray_lightning_accelerators_tpu_torch.models.resnet import (
        synthetic_cifar10)
    vx, vy = synthetic_cifar10(P12_VIT_BATCH * MP_STEPS, seed + 12)
    # the in-process ViT's launches, counted from 0 just before its fit
    _reset_counts()
    _reset_bwd_counts()
    vit_ref = _p12_vit_fit(vx, vy, seed, None, None)
    counts = {**_read_counts(), **_bwd_counts()}
    vit_launches = {k: counts[v] / MP_STEPS
                    for k, v in _REPORT_NAMES.items()}
    t_ref, m_ref, clock_ref, loss_ref, _ = vit_ref
    refs["vit"] = {
        "loss": loss_ref, "grad_norm": _history_of(t_ref, "grad_norm"),
        "params": {k: v.detach().float().cpu()
                   for k, v in _flat_params(m_ref.params).items()},
        "step_ms": [(clock_ref.t[i] - clock_ref.t[i - 1]) * 1e3
                    for i in range(1, len(clock_ref.t))]}
    del vit_ref, t_ref, m_ref, clock_ref
    gc.collect()
    torch.cuda.empty_cache()
    dev = "cuda:0" if DEV.startswith("cuda") else DEV
    root = tempfile.mkdtemp(prefix="chip_smoke_12a_")
    runs = {}
    procs = []

    def fit(tag, world, cfg_dict, axes, **kw):
        """``_mp_fit`` of ``cfg_dict`` (None: 12e's ViT) over ``world``."""
        try:
            t0 = time.perf_counter()
            acc = _SharedCardAccelerator(**axes)
            runs[tag] = (_p12_vit_fit(vx, vy, seed, world, acc)
                         if cfg_dict is None else
                         _mp_fit(cfg_dict, tokens, seed, world, acc, **kw))
            out.setdefault("fit_s", {})[tag] = time.perf_counter() - t0
        except Exception as e:
            ph.check(False, f"{tag}: the fit failed: "
                     f"{type(e).__name__}: {str(e)[:2000]}")

    t0 = time.perf_counter()
    world = DistributedWorld(4, devices=[dev] * 4, backend="gloo")
    out["spawn_rendezvous_s"] = [time.perf_counter() - t0]
    try:
        fit("12a", world, dense, dict(num_workers=2, use_fsdp=True,
                                      tensor=2),
            enable_checkpointing=True, checkpoint_format="sharded",
            default_root_dir=root)
        if world.alive():
            fit("12d", world, piped, dict(num_workers=1, pipeline=2,
                                          tensor=2))
    finally:
        procs += [w._proc for w in world.pool.workers] if world.pool else []
        world.shutdown()
    t0 = time.perf_counter()
    world = DistributedWorld(2, devices=[dev] * 2, backend="gloo")
    out["spawn_rendezvous_s"].append(time.perf_counter() - t0)
    try:
        fit("12b", world, dense, dict(num_workers=1, tensor=2),
            int8_matmul=True)
        if world.alive():
            fit("12c", world, piped, dict(num_workers=1, pipeline=2))
        if world.alive():
            fit("12e", world, None, dict(num_workers=1, pipeline=2))
    finally:
        procs += [w._proc for w in world.pool.workers] if world.pool else []
        world.shutdown()
    ph.check(not any(p.is_alive() for p in procs),
             "12: no rank outlives its world's shutdown")
    dense_want = {"rms_norm": 2 * L + 1, "flash_forward": L,
                  "flash_backward_fused": L, "flash_backward_dq": 0,
                  "flash_backward_dkv": 0}
    if "12a" in runs:
        t, model = runs["12a"][:2]
        rep = t.rank_report
        res = _p12_check_fit(ph, "12a", runs["12a"], refs["dense"],
                             "fsdp 2 x tensor 2", norm=True)
        res["launches_by_rank"] = _p12_launch_check(ph, "12a", rep,
                                                    dense_want)
        sizes = rep.get("mesh", {})
        layouts = {"/" + "/".join(k.split("/")[1:]): v for k, v in
                   _flat_layouts(rep.get("param_layouts", {})).items()}
        shapes = {k: tuple(v.shape)
                  for k, v in refs["dense"]["params"].items()}
        want_b = _mp_predicted_bytes(shapes, layouts, sizes)
        owned = rep.get("owned_bytes_by_rank", [])
        mib = 0.1 * 2 ** 20
        held = {f: [round(o.get(f, 0) / 2 ** 20, 2) for o in owned]
                for f in ("params", "opt_state")}
        ph.check(len(owned) == 4 and all(
            abs(o.get("params", 0) - want_b) <= mib
            and abs(o.get("opt_state", 0) - 2 * want_b) <= mib
            for o in owned),
                 f"12a: each rank holds params {held['params']} MiB and "
                 f"moments {held['opt_state']} MiB; the plan predicts "
                 f"{want_b / 2 ** 20:.2f} and {2 * want_b / 2 ** 20:.2f} "
                 f"(within 0.1 MiB)")
        best = t.checkpoint_callback.best_model_path
        verdict = sharded_checkpoint.verify_checkpoint(best)
        manifest = sharded_checkpoint.read_manifest(best)
        restored = _flat_params(sharded_checkpoint.restore_params(best,
                                                                  "cpu"))
        gathered = _flat_params(model.params)
        same = restored.keys() == gathered.keys() and all(
            torch.equal(restored[k], gathered[k].cpu()) for k in gathered)
        files = sorted({p["file"] for leaf in manifest["leaves"].values()
                        for p in leaf["parts"]})
        ph.check(verdict == (True, "ok") and manifest["format"] == 2
                 and same,
                 f"12a: the 4-rank sharded checkpoint (format "
                 f"{manifest['format']}, files {files}, {verdict[1]}) "
                 f"restores in this process: {len(gathered)} params "
                 f"bitwise the gathered ones")
        res.update(owned_bytes=owned, predicted_param_bytes=want_b,
                   checkpoint_files=files,
                   collective_ms=_collective_ms(rep), spans=_span_ms(rep),
                   comms_per_step=_mp_comms(rep, MP_STEPS))
        log(f"  12a: step ms {[round(x, 1) for x in res['step_ms']]} "
            f"(in-process {[round(x, 1) for x in res['ref_step_ms']]}); "
            f"the exchange {res['collective_ms']}; spans {res['spans']}; "
            f"the model axes a step {res['comms_per_step']}")
        out["12a"] = res
    shutil.rmtree(root, ignore_errors=True)
    if "12b" in runs:
        rep = runs["12b"][0].rank_report
        res = _p12_check_fit(ph, "12b", runs["12b"], refs["int8"],
                             "int8_matmul at tensor 2")
        by_rank = rep.get("launches_by_rank", [])
        k5 = [r.get("int8_matmul", 0) / MP_STEPS for r in by_rank]
        ph.check(len(k5) == 2 and all(k == 2 * L for k in k5),
                 f"12b: K5 launches a step on each rank {k5} (want "
                 f"{2 * L}: wi and wo in each layer)")
        res.update(launches_by_rank=by_rank,
                   comms_per_step=_mp_comms(rep, MP_STEPS))
        log(f"  12b: step ms {[round(x, 1) for x in res['step_ms']]} "
            f"(in-process int8 {[round(x, 1) for x in res['ref_step_ms']]})"
            f"; the model axes a step {res['comms_per_step']}")
        out["12b"] = res
    if "12c" in runs:
        rep = runs["12c"][0].rank_report
        res = _p12_check_fit(ph, "12c", runs["12c"], refs["dense"],
                             f"pipeline 2, {P12_MICROBATCHES} microbatches")
        ticks = P12_MICROBATCHES + 2 - 1
        per = L // 2
        res["launches_by_rank"] = _p12_launch_check(
            ph, "12c", rep, {"rms_norm": 2 * ticks * per + 1,
                             "flash_forward": ticks * per,
                             "flash_backward_fused": ticks * per,
                             "flash_backward_dq": 0,
                             "flash_backward_dkv": 0})
        via = rep.get("model_comms", {}).get("ppermute_via")
        comms = _mp_comms(rep, MP_STEPS)
        hops = comms.get("ppermute", {}).get("calls_per_step")
        ph.check(via == "all_gather" and hops == 2 * (ticks - 1)
                 and rep.get("replicated_bitwise_equal") is True,
                 f"12c: the activations hop {hops} times a step "
                 f"(want {2 * (ticks - 1)}: M + S - 2 each way) via {via}; "
                 f"the embedding and the final norm bitwise equal across "
                 f"the stages")
        res.update(ppermute_via=via, comms_per_step=comms,
                   spans=_span_ms(rep))
        log(f"  12c: step ms {[round(x, 1) for x in res['step_ms']]} "
            f"(in-process {[round(x, 1) for x in res['ref_step_ms']]}); "
            f"the pipeline's collectives a step (calls, CUDA-event ms) "
            f"{comms} via {via}; spans {res['spans']}")
        out["12c"] = res
    if "12d" in runs:
        rep = runs["12d"][0].rank_report
        res = _p12_check_fit(ph, "12d", runs["12d"], refs["dense"],
                             f"pipeline 2 x tensor 2, {P12_MICROBATCHES} "
                             f"microbatches", norm=True)
        ticks = P12_MICROBATCHES + 2 - 1
        per = L // 2
        res["launches_by_rank"] = _p12_launch_check(
            ph, "12d", rep, {"rms_norm": 2 * ticks * per + 1,
                             "flash_forward": ticks * per,
                             "flash_backward_fused": ticks * per,
                             "flash_backward_dq": 0,
                             "flash_backward_dkv": 0})
        via = rep.get("model_comms", {}).get("ppermute_via")
        comms = _mp_comms(rep, MP_STEPS)
        hops = comms.get("ppermute", {}).get("calls_per_step")
        groups = rep.get("mesh_groups", {})
        ph.check(via == "all_gather" and hops == 2 * (ticks - 1)
                 and groups.get("pipeline", [None])[0] == [0, 2]
                 and groups.get("tensor", [None])[0] == [0, 1]
                 and rep.get("replicated_bitwise_equal") is True,
                 f"12d: the activations hop {hops} times a step (want "
                 f"{2 * (ticks - 1)}) via {via} within rank 0's pipeline "
                 f"group {groups.get('pipeline')} (its tensor group "
                 f"{groups.get('tensor')}); every leaf bitwise equal over "
                 f"each group that does not split it")
        res.update(ppermute_via=via, comms_per_step=comms,
                   spans=_span_ms(rep))
        log(f"  12d: step ms {[round(x, 1) for x in res['step_ms']]} "
            f"(in-process {[round(x, 1) for x in res['ref_step_ms']]}); "
            f"the model axes a step (calls, CUDA-event ms) {comms}; spans "
            f"{res['spans']} ({nvidia_smi_line()})")
        out["12d"] = res
    if "12e" in runs:
        rep = runs["12e"][0].rank_report
        res = _p12_check_fit(ph, "12e", runs["12e"], refs["vit"],
                             "ViT at pipeline 2")
        res["launches_by_rank"] = _p12_launch_check(ph, "12e", rep,
                                                    vit_launches)
        comms = _mp_comms(rep, MP_STEPS)
        ph.check("ppermute" not in comms
                 and rep.get("replicated_bitwise_equal") is True,
                 f"12e: no activation hop (no schedule); the layer stack "
                 f"gathered over the stages {comms.get('all_gather')}; the "
                 f"replicated leaves bitwise equal across the stages")
        res.update(comms_per_step=comms, spans=_span_ms(rep),
                   grad_norm=_history_of(runs["12e"][0], "grad_norm"),
                   ref_grad_norm=refs["vit"]["grad_norm"])
        log(f"  12e: step ms {[round(x, 1) for x in res['step_ms']]} "
            f"(in-process {[round(x, 1) for x in res['ref_step_ms']]}); "
            f"launches a step in-process {vit_launches}; the pipeline "
            f"group's collectives a step {comms}; spans {res['spans']}")
        out["12e"] = res
    return out


# --------------------------------------------------------------------- #
# phase 13: the MPMD pipeline runner                                     #
# --------------------------------------------------------------------- #
P13_STAGES, P13_M, P13_STEPS, P13_BATCH = 2, 4, 3, 8


def _p13_reset_counts() -> None:
    """In a stage worker: every kernel's launch count to 0."""
    _reset_counts()
    _reset_bwd_counts()


def _p13_read_counts() -> dict:
    """In a stage worker: its kernels' launch counts."""
    return {**_read_counts(), **_bwd_counts()}


class _GptStages(_TorchModule):
    """13b's stage module: the port GPT's own layers as MPMD stages.
    Its params are ``GPT.unstack_layers`` of the GPT's ``init_params``;
    stage s holds layers ``[s L / S, (s + 1) L / S)`` and runs them with
    ``GPT._layer`` (K1, K2 forward, K4 backward at 1024 flash blocks) in
    bf16.  Stage 0 takes the batch's seeded activation ``x [mb, seq, d]``,
    the loss is the mean squared distance of the last hidden to the
    batch's seeded target ``t``: no embedding and no head, so no leaf is
    shared between stages."""

    def __init__(self, cfg_dict: dict, device):
        super().__init__(device=device, compute_dtype=torch.bfloat16)
        self.cfg_dict = dict(cfg_dict)
        self._model = None

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_model"] = None  # each process builds its own
        return state

    def gpt(self):
        if self._model is None:
            from ray_lightning_accelerators_tpu_torch.models import (
                transformer)
            self._model = transformer.GPT(
                transformer.TransformerConfig(**self.cfg_dict),
                device=self.device, compute_dtype=torch.bfloat16, lr=3e-4)
        return self._model

    def init_params(self, seed=0):
        return self.gpt().init_params(seed=seed)

    def configure_optimizers(self):
        return self.gpt().configure_optimizers()

    def pipeline_stage_params(self, params, stage, num_stages):
        layers = self.gpt().unstack_layers(params)["layers"]
        per = len(layers) // num_stages
        return {f"l{i:02d}": layers[i]
                for i in range(stage * per, (stage + 1) * per)}

    def pipeline_stage_forward(self, stage_params, x, stage, num_stages):
        gpt = self.gpt()
        h = (x["x"] if stage == 0 else x).to(torch.bfloat16)
        positions = torch.arange(h.shape[1], device=h.device)
        for name in sorted(stage_params):
            h, _ = gpt._layer(h, stage_params[name], positions, None)
        return h

    def pipeline_loss(self, y, batch):
        return torch.mean((y.float() - batch["t"]) ** 2)


def _p13_inprocess(module, batches, seed: int, stage_loss):
    """The in-process run the pipeline must reproduce, on the same
    device: the same init, the same split into P13_M microbatches, the
    gradients accumulated per leaf in microbatch order, scaled by 1/M,
    one optimizer step per stage.  ``stage_loss(stage_params, mb)``
    composes the stages for one microbatch.  Returns the losses and each
    stage's params on the host."""
    from ray_lightning_accelerators_tpu_torch.core.optim import (
        tree_leaves, tree_like)
    from ray_lightning_accelerators_tpu_torch.parallel.mpmd import handoff
    params = module.init_params(seed)
    tx = module.configure_optimizers()
    stages, states = [], []
    for s in range(P13_STAGES):
        p = module.pipeline_stage_params(params, s, P13_STAGES)
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in tree_leaves(p)]
        stages.append((tree_like(p, leaves), leaves))
        states.append(tx.init(leaves))
    del params
    losses = []
    for batch in batches:
        acc = [[torch.zeros_like(t, dtype=torch.float32) for t in lv]
               for _, lv in stages]
        total = 0.0
        for mb in handoff.split_microbatches(batch, P13_M):
            mb = handoff.from_wire(mb, module.device)
            loss = stage_loss([sp for sp, _ in stages], mb)
            flat = [t for _, lv in stages for t in lv]
            grads = iter(torch.autograd.grad(loss, flat))
            for a_s in acc:
                for a in a_s:
                    a.add_(next(grads).float())
            total += float(loss.detach())
        for (sp, lv), a_s, st in zip(stages, acc, states):
            tx.apply(lv, [a * (1.0 / P13_M) for a in a_s], st)
        losses.append(total / P13_M)
    sync()
    return losses, [{k: v.detach().float().cpu() for k, v in
                     _flat_params(sp).items()} for sp, _ in stages]


def _p13_run(module, batches, seed: int, workdir: str, counts=False,
             **kw):
    """One PipelineRunner over the stage workers on the card: the
    summary, each worker's kernel launches (counts set to 0 after the
    workers are built, read after the run) and the wall seconds."""
    from ray_lightning_accelerators_tpu_torch.parallel.mpmd.driver import (
        PipelineRunner)
    runner = PipelineRunner(module, num_stages=P13_STAGES,
                            num_microbatches=P13_M, seed=seed,
                            workdir=workdir, device=DEV, **kw)
    try:
        t0 = time.perf_counter()
        runner.setup()
        setup_s = time.perf_counter() - t0
        launches = None
        if counts:
            for f in runner.pool.execute_all(_p13_reset_counts):
                f.result(timeout=300)
        t0 = time.perf_counter()
        summary = runner.run(batches)
        wall = time.perf_counter() - t0
        if counts:
            launches = [f.result(timeout=300) for f in
                        runner.pool.execute_all(_p13_read_counts)]
        procs = [w._proc for w in runner.pool.workers]
    finally:
        runner.shutdown()
    return {"summary": summary, "launches": launches, "setup_s": setup_s,
            "wall_s": wall, "procs": procs,
            "owned_param_bytes": getattr(runner, "owned_param_bytes", None)}


def _p13_times(summary: dict) -> dict:
    """Per step after the first: the wall ms, each stage's busy ms (its
    compute slots, synchronised), its send ms (to_wire, the store put
    and the mailbox file) and its recv ms (the wait for the neighbour,
    the store get and from_wire)."""
    sends = ("send_act", "send_grad")
    recvs = ("recv_act", "recv_grad")
    rows = summary["steps"][1:] or summary["steps"]
    out = {"step_wall_ms": [r["wall_s"] * 1e3 for r in rows]}
    for key, ops in (("busy_ms", None), ("send_ms", sends),
                     ("recv_ms", recvs)):
        out[key] = {}
        for st in sorted(rows[0]["per_stage"]):
            if ops is None:
                vals = [r["per_stage"][st]["busy_s"] * 1e3 for r in rows]
            else:
                vals = [sum(dt for op, _, dt in r["per_stage"][st]["ticks"]
                            if op in ops) * 1e3 for r in rows]
            out[key][st] = vals
    return out


def _p13_rounded(times: dict) -> str:
    return "; ".join(
        f"{key} " + (str([round(x, 2) for x in v]) if isinstance(v, list)
                     else str({k: [round(x, 2) for x in xs]
                               for k, xs in v.items()}))
        for key, v in times.items())


def _p13_handoff_split(x: torch.Tensor, root: str, reps: int = 10) -> dict:
    """Median ms of each part of one activation's handoff, run in this
    process on ``x`` (a stage's output on the card): ``to_wire`` (the
    copy to the host), the store's put, the ref file (write, fsync,
    rename), its read, the store's get (the mapping) and ``from_wire``
    (the copy back to the card), and whether ``x`` came back bitwise."""
    from ray_lightning_accelerators_tpu_torch.parallel.mpmd import handoff
    from ray_lightning_accelerators_tpu_torch.runtime import object_store
    store = object_store.global_store()
    box = handoff.Mailbox(os.path.join(root, "split"))
    parts = {k: [] for k in ("to_wire", "put", "ref_send", "ref_recv",
                             "get", "from_wire")}
    same = True
    for i in range(reps + 1):
        t = [time.perf_counter()]
        wire = handoff.to_wire(x)
        t.append(time.perf_counter())
        ref = store.put(wire)
        t.append(time.perf_counter())
        box.send(ref, step=i, kind=handoff.KIND_ACT, src=0, dst=1,
                 microbatch=0)
        t.append(time.perf_counter())
        got = box.recv(step=i, kind=handoff.KIND_ACT, src=0, dst=1,
                       microbatch=0, timeout_s=30.0)
        t.append(time.perf_counter())
        view = store.get(got, copy=False)
        t.append(time.perf_counter())
        back = handoff.from_wire(view, x.device)
        sync()
        t.append(time.perf_counter())
        same = same and torch.equal(back.view(torch.int16),
                                    x.view(torch.int16))
        store.release(got)
        store.delete(ref)
        if i:  # the first round warms the allocator and the mapping
            for k, a, b in zip(parts, t, t[1:]):
                parts[k].append((b - a) * 1e3)
    out = {k: float(np.median(v)) for k, v in parts.items()}
    out["bitwise"] = bool(same)
    out["bytes"] = x.numel() * x.element_size()
    return out


def _p13_fsdp(ph: Phases, cfg: dict, batches, seed: int, root: str,
              ref_losses, ref_params, want_by_stage, procs) -> dict:
    """13d: ``PipelineRunner(fsdp=2)`` with 13b's GPT stages: 4 workers on
    cuda:0, each stage a gloo group of 2 (NCCL refuses two ranks on one
    card), 3 steps against 13b's in-process run within 13b's limits
    (losses 1e-2 a step, each stage's params 1e-2 relative L2 from the
    final checkpoint, which holds the whole stage).  Each member owns the
    ``fsdp_leaf_spec`` half of every leaf of 4096 elements or more and
    the whole of the rest (its owned param bytes against that plan), and
    runs the kernels of its stage on its half of each microbatch's rows:
    the launches of 13b's stage worker, on each member.  The group's
    collective ms a step (the compute view's gather, the gradient's
    reduce-scatter, the norm, the loss mean) by member."""
    from ray_lightning_accelerators_tpu_torch.parallel import mesh as M
    from ray_lightning_accelerators_tpu_torch.parallel import plan as P
    from ray_lightning_accelerators_tpu_torch.utils import (
        checkpoint as ckpt_lib)
    fsdp = 2
    workdir = os.path.join(root, "gpt_fsdp")
    run = _p13_run(_GptStages(cfg, DEV), batches, seed, workdir,
                   counts=True, ckpt_every=P13_STEPS, fsdp=fsdp)
    procs += run["procs"]
    sm = run["summary"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(sm["losses"], ref_losses))
    payload = ckpt_lib.read_checkpoint(ckpt_lib.latest_checkpoint(
        os.path.join(workdir, "ckpt")))
    worst = (0.0, None)
    for s in range(P13_STAGES):
        got = _flat_params(ckpt_lib._to_device(
            payload["pipeline_stage_states"][str(s)]["params"], "cpu"))
        for k, v in ref_params[s].items():
            r = _rel_l2(got[k].float(), v)
            if r > worst[0] or worst[1] is None:
                worst = (r, f"stage {s} {k}")
    ph.check(len(sm["losses"]) == P13_STEPS and rel <= 1e-2
             and worst[0] <= 1e-2 and payload["global_step"] == P13_STEPS
             and sm["stage_failure_budget_used"] == [0, 0]
             and sm["fsdp"] == fsdp and sm["fsdp_backend"] == "gloo",
             f"13d GPT stages at fsdp {fsdp} ({sm['fsdp_backend']} groups): "
             f"losses {[round(x, 5) for x in sm['losses']]} vs in-process "
             f"{[round(x, 5) for x in ref_losses]} (max rel {rel:.3e}); "
             f"stage params after {P13_STEPS} steps max rel L2 "
             f"{worst[0]:.3e} ({worst[1]}); limits 1e-2 (bf16)")
    # the plan: each leaf's fsdp_leaf_spec half, from the whole stage
    mesh = M.Mesh({M.FSDP_AXIS: fsdp})
    want_bytes = []
    for s in range(P13_STAGES):
        total = 0
        for k, v in ref_params[s].items():
            d = P.fsdp_leaf_spec(mesh, v)
            split = d is not None and d is not P.FSDP_FALLBACK
            total += 4 * (v.numel() // (fsdp if split else 1))
        want_bytes += [total] * fsdp
    owned = run["owned_param_bytes"]
    whole = [sum(4 * v.numel() for v in p.values()) for p in ref_params]
    ph.check(owned == want_bytes,
             f"13d: each member's owned f32 params {owned} bytes (the plan: "
             f"{want_bytes}; the stage's whole {whole})")
    want = [w for w in want_by_stage for _ in range(fsdp)]
    got = [{k: c.get(k, 0) for k in want[0]}
           for c in (run["launches"] or [])]
    ph.check(got == want,
             f"13d: kernel launches in the {len(got)} workers over "
             f"{P13_STEPS} steps {got} (want each stage's 13b launches on "
             f"each of its {fsdp} members)")
    times = _p13_times(sm)
    coll = {st: [round(r["per_stage"][st]["collective_s"] * 1e3, 2)
                 for r in sm["steps"][1:] or sm["steps"]]
            for st in sorted(sm["steps"][0]["per_stage"])}
    log(f"  13d: {_p13_rounded(times)}; the groups' collective ms a step "
        f"by member {coll}; bubble measured "
        f"{sm['measured_bubble_fraction']:.4f}; setup {run['setup_s']:.2f} "
        f"s, {P13_STEPS} steps {run['wall_s']:.2f} s ({nvidia_smi_line()})")
    return {"losses": sm["losses"], "ref_losses": ref_losses,
            "loss_rel": rel, "params_max_rel_l2": worst[0],
            "owned_param_bytes": owned, "planned_param_bytes": want_bytes,
            "launches_by_worker": got, "collective_ms": coll,
            "measured_bubble": sm["measured_bubble_fraction"],
            "setup_s": run["setup_s"], "wall_s": run["wall_s"], **times}


def _p13_batches(seed: int, shape) -> list:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(P13_STEPS)]


def phase_mpmd(ph: Phases, seed: int):
    """13: the MPMD pipeline runner (``parallel/mpmd``): 2 stage workers
    spawned by ``PipelineRunner``, activations crossing the shm object
    store through ``to_wire`` / ``from_wire``.  The machine has one
    card, so both stage workers run on cuda:0.  Each case against an
    in-process run on the card with the same seed, the same split into
    4 microbatches and the same accumulation order.
    13a the port's PipelineBoringModel (f32, depth 4, dim 8) under 1F1B
    and GPipe, 3 steps: losses within 1e-5 relative, no failure charged,
    the measured and analytic bubble.
    13b the GPT's layers as stages at 6a's width (``MP_LAYERS`` = 4: 2
    layers a stage, seq 1024, 1024 flash blocks, bf16), global batch 8 of
    1024 tokens: the losses within 1e-2 relative each step, each stage's
    params after 3 steps within 1e-2 relative L2, the kernels launched in
    the stage workers: stage 0 (forward slot and the backward's
    recompute) K1 2 x 2 x 2, K2 2 x 2 and K4 2 a microbatch, stage 1 (one
    fused forward and backward) K1 2 x 2, K2 2, K4 2; the step wall ms,
    busy ms by stage and handoff ms.
    13c a crash of stage 1's worker at step 2 (tests/torch_boring.py
    FaultyPipelineModel, once): one replay, stage 1 charged alone, the
    losses within 1e-5 of 13a's clean 1F1B run.
    13d 13b's GPT stages at ``fsdp=2`` (``_p13_fsdp``)."""
    import shutil
    import tempfile
    from tests.torch_boring import FaultyPipelineModel, PipelineBoringModel
    out = {"card": "one card: both stage workers run on cuda:0"}
    log("  13: " + out["card"])
    gc.collect()
    torch.cuda.empty_cache()
    procs = []
    root = tempfile.mkdtemp(prefix="chip_smoke_13_")
    try:
        # 13a -----------------------------------------------------------
        boring = _p13_batches(seed + 13, (P13_BATCH, 8))

        def boring_loss(sps, mb):
            mod = PipelineBoringModel(device=DEV)
            return mod.pipeline_loss(
                mod.pipeline_stage_forward(
                    sps[1], mod.pipeline_stage_forward(sps[0], mb, 0, 2),
                    1, 2), mb)[0]

        ref_losses, _ = _p13_inprocess(PipelineBoringModel(device=DEV),
                                       boring, seed, boring_loss)
        clean = None
        for schedule in ("1f1b", "gpipe"):
            tag = f"13a {schedule}"
            run = _p13_run(PipelineBoringModel(device=DEV), boring, seed,
                           os.path.join(root, schedule), schedule=schedule,
                           ckpt_every=P13_STEPS)
            procs += run["procs"]
            sm = run["summary"]
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(sm["losses"], ref_losses))
            ph.check(len(sm["losses"]) == P13_STEPS and rel <= 1e-5
                     and sm["stage_failure_budget_used"] == [0, 0]
                     and sm["replays"] == 0,
                     f"{tag}: losses {[round(x, 6) for x in sm['losses']]} "
                     f"vs in-process {[round(x, 6) for x in ref_losses]} "
                     f"(max rel {rel:.2e}, limit 1e-5); budget used "
                     f"{sm['stage_failure_budget_used']}")
            log(f"  {tag}: bubble measured "
                f"{sm['measured_bubble_fraction']:.4f} vs analytic "
                f"{sm['analytic_bubble_fraction']:.4f}; "
                f"{_p13_rounded(_p13_times(sm))}; setup "
                f"{run['setup_s']:.2f} s, {P13_STEPS} steps "
                f"{run['wall_s']:.2f} s")
            out[tag] = {"losses": sm["losses"], "ref_losses": ref_losses,
                        "loss_rel": rel,
                        "measured_bubble": sm["measured_bubble_fraction"],
                        "analytic_bubble": sm["analytic_bubble_fraction"],
                        "setup_s": run["setup_s"], "wall_s": run["wall_s"],
                        **_p13_times(sm)}
            if schedule == "1f1b":
                clean = sm["losses"]

        # 13b -----------------------------------------------------------
        cfg = dict(TRAIN_CFG, n_layers=MP_LAYERS)
        L, seq, d = cfg["n_layers"], cfg["max_seq_len"], cfg["d_model"]
        per = L // P13_STAGES
        rng = np.random.default_rng(seed + 130)
        gpt_batches = [{"x": rng.standard_normal(
            (P13_BATCH, seq, d)).astype(np.float32),
            "t": rng.standard_normal((P13_BATCH, seq, d)).astype(np.float32)}
            for _ in range(P13_STEPS)]
        stages_mod = _GptStages(cfg, DEV)

        def gpt_loss(sps, mb):
            h = stages_mod.pipeline_stage_forward(sps[0], mb, 0, 2)
            return stages_mod.pipeline_loss(
                stages_mod.pipeline_stage_forward(sps[1], h, 1, 2), mb)

        ref_losses, ref_params = _p13_inprocess(stages_mod, gpt_batches,
                                                seed, gpt_loss)
        gc.collect()
        torch.cuda.empty_cache()
        # one checkpoint at the end: a step's is ~1 GB of params and
        # moments through the workers' pipes and onto disk
        run = _p13_run(_GptStages(cfg, DEV), gpt_batches, seed,
                       os.path.join(root, "gpt"), counts=True,
                       ckpt_every=P13_STEPS)
        procs += run["procs"]
        sm = run["summary"]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(sm["losses"], ref_losses))
        from ray_lightning_accelerators_tpu_torch.utils import (
            checkpoint as ckpt_lib)
        payload = ckpt_lib.read_checkpoint(ckpt_lib.latest_checkpoint(
            os.path.join(root, "gpt", "ckpt")))
        worst = (0.0, None)
        for s in range(P13_STAGES):
            got = _flat_params(ckpt_lib._to_device(
                payload["pipeline_stage_states"][str(s)]["params"], "cpu"))
            for k, v in ref_params[s].items():
                r = _rel_l2(got[k].float(), v)
                if r > worst[0] or worst[1] is None:
                    worst = (r, f"stage {s} {k}")
        ph.check(len(sm["losses"]) == P13_STEPS and rel <= 1e-2
                 and worst[0] <= 1e-2 and payload["global_step"] == P13_STEPS
                 and sm["stage_failure_budget_used"] == [0, 0],
                 f"13b GPT layers {L} in 2 stages, bf16: losses "
                 f"{[round(x, 5) for x in sm['losses']]} vs in-process "
                 f"{[round(x, 5) for x in ref_losses]} (max rel {rel:.3e}); "
                 f"stage params after {P13_STEPS} steps max rel L2 "
                 f"{worst[0]:.3e} ({worst[1]}); limits 1e-2 (bf16)")
        mb_steps = P13_M * P13_STEPS
        want = [{"rms_norm": 4 * per * mb_steps,
                 "flash_attention": 2 * per * mb_steps,
                 "flash_backward_fused": per * mb_steps,
                 "flash_backward_dq": 0, "flash_backward_dkv": 0},
                {"rms_norm": 2 * per * mb_steps,
                 "flash_attention": per * mb_steps,
                 "flash_backward_fused": per * mb_steps,
                 "flash_backward_dq": 0, "flash_backward_dkv": 0}]
        got = [{k: c.get(k, 0) for k in want[0]}
               for c in (run["launches"] or [])]
        ph.check(got == want,
                 f"13b: kernel launches in the stage workers over "
                 f"{P13_STEPS} steps {got} (want {want}: {per} layers a "
                 f"stage, {P13_M} microbatches a step)")
        compiles = [r["compiles"] for r in sm["steps"]]
        ph.check(len(set(compiles)) == 1,
                 f"13b: kernel builds in the workers by step {compiles} "
                 f"(no build after the first step)")
        times = _p13_times(sm)
        bubble = sm["measured_bubble_fraction"]
        log(f"  13b: {_p13_rounded(times)}; bubble measured {bubble:.4f} "
            f"vs analytic {sm['analytic_bubble_fraction']:.4f} "
            f"({nvidia_smi_line()})")
        out["13b"] = {"losses": sm["losses"], "ref_losses": ref_losses,
                      "loss_rel": rel, "params_max_rel_l2": worst[0],
                      "launches_by_stage": got,
                      "measured_bubble": bubble,
                      "analytic_bubble": sm["analytic_bubble_fraction"],
                      "setup_s": run["setup_s"], "wall_s": run["wall_s"],
                      "compiles": compiles, **times}
        act = torch.randn(P13_BATCH // P13_M, seq, d, device=DEV,
                          generator=torch.Generator(device=DEV).manual_seed(
                              seed)).to(torch.bfloat16)
        split = _p13_handoff_split(act, root)
        split_ms = {k: round(v, 3) for k, v in split.items()
                    if k not in ("bitwise", "bytes")}
        ph.check(split["bitwise"],
                 f"13b: a [{P13_BATCH // P13_M}, {seq}, {d}] bf16 activation "
                 f"crosses to_wire -> put -> ref file -> get -> from_wire "
                 f"bitwise; median ms by part {split_ms} "
                 f"({split['bytes']} bytes)")
        out["13b"]["handoff_split_ms"] = split
        del act
        gc.collect()
        torch.cuda.empty_cache()

        # 13d -----------------------------------------------------------
        out["13d"] = _p13_fsdp(ph, cfg, gpt_batches, seed, root, ref_losses,
                               ref_params, want, procs)
        del ref_params
        gc.collect()
        torch.cuda.empty_cache()

        # 13c -----------------------------------------------------------
        claims = os.path.join(root, "claims")
        os.makedirs(claims)
        run = _p13_run(FaultyPipelineModel("crash", stage=1, step=2,
                                           claim_dir=claims, device=DEV),
                       boring, seed, os.path.join(root, "crash"))
        procs += run["procs"]
        sm = run["summary"]
        rel = (max(abs(a - b) / abs(b) for a, b in zip(sm["losses"], clean))
               if clean and len(sm["losses"]) == len(clean) else float("inf"))
        ph.check(sm["replays"] == 1
                 and sm["stage_failure_budget_used"] == [0, 1]
                 and rel <= 1e-5,
                 f"13c: stage 1's worker ended at step 2: replays "
                 f"{sm['replays']}, budget used "
                 f"{sm['stage_failure_budget_used']}, losses "
                 f"{[round(x, 6) for x in sm['losses']]} vs 13a's clean "
                 f"run (max rel {rel:.2e}, limit 1e-5)")
        out["13c"] = {"losses": sm["losses"], "replays": sm["replays"],
                      "budget_used": sm["stage_failure_budget_used"],
                      "loss_rel": rel, "wall_s": run["wall_s"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ph.check(bool(procs) and not any(p.is_alive() for p in procs),
             "13: no stage worker outlives its runner's shutdown")
    return out



# --------------------------------------------------------------------- #
# phase 14: Tune                                                         #
# --------------------------------------------------------------------- #
P14_LRS = [3e-4, 1e-3, 3e-3]
P14A_TRIALS = 2          # 14a's grid: the first two rates (cut from 3
                         # for the script's time limit)
P14_EPOCHS = 6           # one step an epoch: one report a step
P14_STOP_AT = 2          # the scheduler STOPs the second trial here
P14_PROC_STEPS = 4
P14_AUTOTUNE_TRIALS = 4
P14_AUTOTUNE_STEPS = 5   # the measure: the median of the last 3


class _P14Report(_TuneReportCallback):
    """TuneReportCallback timing each of its reports in the rank (the
    query to the trial's session and back, and the stop broadcast); the
    times come home with rank 0's callback states."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.ms = []

    def _handle(self, trainer, module):
        t0 = time.perf_counter()
        super()._handle(trainer, module)
        self.ms.append((time.perf_counter() - t0) * 1e3)

    def state_dict(self):
        return {"ms": self.ms}

    def load_state_dict(self, state):
        self.ms = state["ms"]


class _P14Checkpoint(_TuneCheckpointCallback):
    """The tune checkpoint callback (the whole state gathered, dumped and
    shipped through the query channel, written by the driver) without a
    report, timed in the rank."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.ms = []

    def _handle(self, trainer, module):
        t0 = time.perf_counter()
        super()._handle(trainer, module)
        self.ms.append((time.perf_counter() - t0) * 1e3)

    def state_dict(self):
        return {"ms": self.ms}

    def load_state_dict(self, state):
        self.ms = state["ms"]


def _p14_process_trial(config):
    """14b's trainable, run in a trial subprocess (sent there by name, so
    it is this module's, imported as ``chip_smoke``): 6a's fit for
    ``P14_PROC_STEPS`` steps in this process, reporting every step's loss
    and this process's kernel launches over the queue."""
    config = config["run"]
    if config.get("crash"):
        os._exit(3)   # a hard crash: no exception, no cleanup
    from ray_lightning_accelerators_tpu_torch import (Callback, DataLoader,
                                                      Trainer, tune)
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    t_start = time.time()
    dev = config["device"]
    cfg = TransformerConfig(**config["cfg"])
    data = _pattern_tokens(config["batch"] * config["steps_per_epoch"],
                           cfg.max_seq_len, cfg.vocab_size, config["seed"])

    class Report(Callback):
        def on_train_batch_end(self, trainer, module, metrics, idx):
            tune.report(loss=float(metrics["train_loss"]),
                        step=trainer.global_step, pid=float(os.getpid()),
                        t_start=t_start, **{f"launches_{k}": v for k, v in
                                            {**_read_counts(),
                                             **_bwd_counts()}.items()})

    _reset_counts()
    _reset_bwd_counts()
    model = GPT(cfg, device=dev, lr=config["lr"])
    trainer = Trainer(max_steps=P14_PROC_STEPS, device=dev, precision="bf16",
                      log_every_n_steps=10 ** 9, seed=config["seed"],
                      callbacks=[Report()], enable_checkpointing=False,
                      default_root_dir=config["root"])
    trainer.fit(model, DataLoader(ArrayDataset(data),
                                  batch_size=config["batch"], shuffle=True,
                                  seed=config["seed"]))
    return trainer.global_step


def _p14_measure(seed: int, root: str, sink: list):
    """autotune_step's measure: 6a's fit under ``config`` for
    P14_AUTOTUNE_STEPS steps; the median of the last 3 steps' times
    (synchronised, CUDA events bracket each step's host clock)."""
    def measure(config):
        policy = config["remat_policy"]
        cfg = dict(TRAIN_CFG, flash_block_q=config["flash_block_q"],
                   flash_block_k=config["flash_block_k"],
                   remat=policy != "none",
                   remat_policy=policy if policy != "none" else "nothing")
        t0 = time.perf_counter()
        try:
            trainer, model, _loader, clock, launches, _wall = _fit(
                cfg, P14_AUTOTUNE_STEPS, seed, root,
                max_steps=P14_AUTOTUNE_STEPS, enable_checkpointing=False,
                gather_mode=config["gather_mode"])
        except Exception as e:
            sink.append({"config": config, "error": f"{type(e).__name__}: "
                         f"{e}", "s": time.perf_counter() - t0})
            raise
        ms = [(clock.t[i] - clock.t[i - 1]) * 1e3
              for i in range(len(clock.t) - 3, len(clock.t))]
        sink.append({"config": config, "step_ms": ms,
                     "launches": launches, "steps": trainer.global_step,
                     "s": time.perf_counter() - t0})
        del trainer, model
        torch.cuda.empty_cache()
        return float(np.median(ms)) / 1e3
    return measure


def phase_tune(ph: Phases, seed: int, inproc: Optional[dict]):
    """14a thread trials over a rank each, 14b process trials, 14c
    autotune_step (see the module docstring)."""
    import importlib
    import multiprocessing

    from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                      RayAccelerator,
                                                      Trainer, tune)
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    from ray_lightning_accelerators_tpu_torch.utils import checkpoint
    out = {}
    ref = (inproc or {}).get("loss") or [None]
    cfg = TransformerConfig(**TRAIN_CFG)
    L = cfg.n_layers
    data = _pattern_tokens(TRAIN_BATCH * TRAIN_STEPS_PER_EPOCH,
                           cfg.max_seq_len, cfg.vocab_size, seed)
    root = os.path.join(HERE, "build", "chip_smoke_tune")

    # ---- 14a: thread trials, each fitting over one rank -------------- #
    class StopSecond(tune.TrialScheduler):
        """STOPs trial_00001 at its second report."""

        def on_result(self, trial, result):
            if trial.trial_id == "trial_00001" and \
                    result["training_iteration"] == P14_STOP_AT:
                return self.STOP
            return self.CONTINUE

    runs, procs = {}, []

    def trainable(config):
        t0 = time.perf_counter()
        acc = RayAccelerator(num_workers=1, use_gpu=DEV.startswith("cuda"))
        report, ckpt = (_P14Report({"loss": "train_loss"},
                                   on="train_epoch_end"),
                        _P14Checkpoint(on="fit_end"))
        trainer = Trainer(max_epochs=P14_EPOCHS, limit_train_batches=1,
                          device=DEV, precision="bf16",
                          log_every_n_steps=10 ** 9, seed=seed,
                          enable_checkpointing=False,
                          callbacks=[report, ckpt],
                          default_root_dir=os.path.join(root, "fit"),
                          accelerator=acc)
        model = GPT(cfg, device=DEV, lr=config["lr"])
        t1 = time.perf_counter()
        world = trainer._acquire_world(acc.launch_spec())
        spawn_s = time.perf_counter() - t1
        procs.extend(w._proc for w in world.pool.workers)
        trainer.fit(model, DataLoader(ArrayDataset(data),
                                      batch_size=TRAIN_BATCH, shuffle=True,
                                      seed=seed))
        runs[config["lr"]] = {
            "spawn_s": spawn_s, "wall_s": time.perf_counter() - t0,
            "global_step": trainer.global_step,
            "report": trainer.rank_report, "report_ms": report.ms,
            "ckpt_ms": ckpt.ms,
            "params": {k: v.detach().cpu()
                       for k, v in _flat_params(model.params).items()}}

    before = set(multiprocessing.active_children())
    t0 = time.perf_counter()
    analysis = tune.run(trainable,
                        config={"lr": tune.grid_search(P14_LRS[:P14A_TRIALS])},
                        metric="loss", mode="min", scheduler=StopSecond(),
                        local_dir=root, name="p14a", device=DEV)
    wall_a = time.perf_counter() - t0
    trials = analysis.trials
    by_id = {t.trial_id: t for t in trials}
    stopped = by_id.get("trial_00001")
    others = [t for t in trials if t.trial_id != "trial_00001"]
    ph.check(stopped is not None and stopped.status == "STOPPED"
             and stopped.training_iteration == P14_STOP_AT
             and runs.get(stopped.config["lr"], {}).get("global_step")
             == P14_STOP_AT,
             f"14a: trial_00001 {getattr(stopped, 'status', None)} after "
             f"{getattr(stopped, 'training_iteration', None)} reports, its "
             f"rank ended at step "
             f"{runs.get(getattr(stopped, 'config', {}).get('lr'), {}).get('global_step')}")
    ph.check(len(others) == P14A_TRIALS - 1 and all(
        t.status == "TERMINATED" and t.training_iteration == P14_EPOCHS
        and runs.get(t.config["lr"], {}).get("global_step") == P14_EPOCHS
        for t in others),
        f"14a: the others {[(t.status, t.training_iteration) for t in others]}")
    first = [t.results[0]["loss"] for t in trials if t.results]
    ph.check(len(first) == P14A_TRIALS and all(f == ref[0] for f in first),
             f"14a: first reported losses {first} vs 6a's {ref[0]!r} "
             "(bitwise)")
    per_step_ok = True
    for lr, r in runs.items():
        la, steps = r["report"]["launches"], r["global_step"]
        per_step_ok &= (la["rms_norm"] == (2 * L + 1) * steps
                        and la["flash_forward"] == L * steps
                        and la["flash_backward_fused"] == L * steps
                        and la["flash_backward_dq"] == 0
                        and r["report"]["backend"] == (
                            "nccl" if DEV.startswith("cuda") else "gloo"))
    la0 = next(iter(runs.values()))["report"]["launches"] if runs else {}
    st0 = next(iter(runs.values()))["global_step"] if runs else 1
    ph.check(len(runs) == P14A_TRIALS and per_step_ok,
             f"14a: launches a step in each rank: K1 "
             f"{la0.get('rms_norm', 0) / st0:g}, K2 "
             f"{la0.get('flash_forward', 0) / st0:g}, K4 "
             f"{la0.get('flash_backward_fused', 0) / st0:g}, K3a "
             f"{la0.get('flash_backward_dq', 0) / st0:g}")
    best = analysis.best_checkpoint
    ok_best, best_step, best_bytes = False, None, 0
    if best and os.path.exists(best):
        best_bytes = os.path.getsize(best)
        payload = checkpoint.read_checkpoint(best)
        best_step = payload["global_step"]
        restored = GPT(cfg, device=DEV)
        restored.params = checkpoint.restore_params(payload, DEV)
        fit_params = runs[analysis.best_config["lr"]]["params"]
        flat = _flat_params(restored.params)
        batch = torch.as_tensor(data[:2], device=DEV)
        with torch.no_grad():
            loss = float(restored.validation_step(restored.params,
                                                  batch)["val_loss"])
        ok_best = (best_step == runs[analysis.best_config["lr"]][
            "global_step"] and flat.keys() == fit_params.keys()
            and all(torch.equal(flat[k].cpu(), fit_params[k])
                    for k in flat) and np.isfinite(loss))
    ph.check(ok_best, f"14a: best checkpoint {best} (lr "
             f"{analysis.best_config.get('lr')}) restores into the GPT at "
             f"global_step {best_step}, equal to the fit's weights")
    ph.check(not any(p.is_alive() for p in procs) and not (
        set(multiprocessing.active_children()) - before),
        f"14a: none of the {len(procs)} ranks outlives tune.run")
    ckpt_ms = [m for r in runs.values() for m in r["ckpt_ms"]]
    rep_ms = [m for r in runs.values() for m in r["report_ms"]]
    log(f"  14a: tune.run {wall_a:.2f} s; per trial (lr: wall s, spawn + "
        f"rendezvous s, steps): "
        f"{ {lr: (round(r['wall_s'], 2), round(r['spawn_s'], 2), r['global_step']) for lr, r in runs.items()} }; "
        f"report (query + stop broadcast) ms in the rank: median "
        f"{np.median(rep_ms) if rep_ms else float('nan'):.3f}, max "
        f"{max(rep_ms) if rep_ms else float('nan'):.3f}; checkpoint "
        f"payload {best_bytes} bytes ({best_bytes / 2 ** 30:.3f} GiB), "
        f"gather + dump + query ms {[round(m, 1) for m in ckpt_ms]}")
    out["14a"] = {"wall_s": wall_a, "runs": {
        lr: {k: v for k, v in r.items() if k != "params"}
        for lr, r in runs.items()},
        "statuses": {t.trial_id: (t.status, t.training_iteration)
                     for t in trials},
        "first_losses": first, "checkpoint_bytes": best_bytes,
        "checkpoint_ms": ckpt_ms, "report_ms": rep_ms}
    runs.clear()

    # ---- 14b: process trials ----------------------------------------- #
    me = importlib.import_module("chip_smoke")
    base = {"device": DEV, "cfg": dict(TRAIN_CFG), "batch": TRAIN_BATCH,
            "steps_per_epoch": TRAIN_STEPS_PER_EPOCH, "seed": seed,
            "root": os.path.join(root, "proc_fit")}
    grid = [dict(base, lr=P14_LRS[0]), dict(base, lr=P14_LRS[2]),
            dict(base, lr=P14_LRS[1], crash=True)]
    before = set(multiprocessing.active_children())
    t0, t0_wall = time.perf_counter(), time.time()
    analysis = tune.run(me._p14_process_trial,
                        config={"run": tune.grid_search(grid)},
                        metric="loss", mode="min", local_dir=root,
                        name="p14b", trial_executor="process",
                        raise_on_failed_trial=False, device=DEV)
    wall_b = time.perf_counter() - t0
    fits = [t for t in analysis.trials if not t.config["run"].get("crash")]
    crashed = [t for t in analysis.trials if t.config["run"].get("crash")]
    pids = [int(t.last_result.get("pid", os.getpid())) for t in fits]
    ph.check(len(fits) == 2 and all(
        t.status == "TERMINATED" and t.training_iteration == P14_PROC_STEPS
        for t in fits) and os.getpid() not in pids and len(set(pids)) == 2,
        f"14b: the fitting trials {[(t.status, t.training_iteration) for t in fits]} "
        f"in pids {pids} (the driver is {os.getpid()})")
    firsts = [t.results[0]["loss"] for t in fits if t.results]
    ph.check(len(firsts) == 2 and all(f == ref[0] for f in firsts),
             f"14b: first losses {firsts} vs 6a's {ref[0]!r} (bitwise)")
    last = [t.last_result for t in fits]
    ok_launch = all(
        r.get("launches_rms_norm") == (2 * L + 1) * P14_PROC_STEPS
        and r.get("launches_flash_attention") == L * P14_PROC_STEPS
        and r.get("launches_flash_backward_fused") == L * P14_PROC_STEPS
        for r in last)
    ph.check(len(last) == 2 and ok_launch,
             f"14b: launches counted in each trial subprocess over "
             f"{P14_PROC_STEPS} steps: "
             f"{[{k[9:]: v for k, v in r.items() if k.startswith('launches_') and v} for r in last]}")
    ph.check(len(crashed) == 1 and crashed[0].status == "ERROR"
             and crashed[0].error is not None
             and len(analysis.trials) == 3,
             f"14b: the os._exit trial is "
             f"{[t.status for t in crashed]} ({crashed[0].error if crashed else None!s:.80}) "
             "and the experiment completed")
    ph.check(not (set(multiprocessing.active_children()) - before),
             "14b: no trial subprocess outlives tune.run")
    # seconds from tune.run's start to each trainable's start (the fork,
    # the env overlay, unpickling the config) and to its first report
    starts = [round(t.results[0]["t_start"] - t0_wall, 3)
              for t in fits if t.results]
    log(f"  14b: tune.run {wall_b:.2f} s for {len(grid)} trials (one at a "
        f"time); each fitting trainable started {starts} s after tune.run "
        f"did; losses "
        f"{[[round(r['loss'], 4) for r in t.results] for t in fits]}")
    out["14b"] = {"wall_s": wall_b, "statuses": [
        (t.status, t.training_iteration) for t in analysis.trials],
        "pids": pids, "first_losses": firsts, "last": last,
        "trainable_start_s": starts}

    # ---- 14c: autotune_step ------------------------------------------ #
    sink = []
    t0 = time.perf_counter()
    result = tune.autotune_step(_p14_measure(seed, os.path.join(
        root, "autotune"), sink), n_trials=P14_AUTOTUNE_TRIALS, seed=seed)
    wall_c = time.perf_counter() - t0
    tr = result["trials"]
    default = {"remat_policy": "none", "flash_block_q": 512,
               "flash_block_k": 512, "gather_mode": "tree"}
    ph.check(result["n_trials"] == P14_AUTOTUNE_TRIALS
             and tr[0]["config"] == default
             and result["best_step_time_s"] <= result["default_step_time_s"]
             and np.isfinite(result["default_step_time_s"]),
             f"14c: {result['n_trials']} trials, the default first "
             f"({tr[0]['step_time_s'] * 1e3:.2f} ms), the best "
             f"{result['best_step_time_s'] * 1e3:.2f} ms "
             f"({result['best_config']})")
    scans = [t for t in tr if t["config"]["gather_mode"] == "scan"]
    ph.check(all(np.isfinite(t["step_time_s"]) for t in tr),
             f"14c: every config measured, the {len(scans)} "
             "gather_mode='scan' one(s) as the tree gather (one card: no "
             "compressed-FSDP regime, where JAX falls back too)")
    for t in tr:
        log(f"  14c: {t['config']} -> {t['step_time_s'] * 1e3:.2f} ms")
    out["14c"] = {"wall_s": wall_c, "result": result, "measures": sink}
    log(f"  14: 14a {wall_a:.1f} s, 14b {wall_b:.1f} s, 14c {wall_c:.1f} s")
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    return out


def _flat_layouts(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_layouts(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# --------------------------------------------------------------------- #
# phase 15: the single-card defaults                                     #
# --------------------------------------------------------------------- #
# the Trainer's defaults before they became the JAX package's
P15_OFF = dict(guard=None, prefetch_batches=0, cache_dataset_on_device=False)
P15_GUARD_PREFIX = "guard "


class _RangedLinalg:
    """``torch.linalg`` as core/optim.py sees it inside ``_guard_ranges``:
    ``vector_norm`` (the update norms only the guard takes) in a profiler
    range."""

    def __getattr__(self, name):
        return getattr(torch.linalg, name)

    @staticmethod
    def vector_norm(*args, **kwargs):
        if not torch.autograd._profiler_enabled():
            return torch.linalg.vector_norm(*args, **kwargs)
        with torch.profiler.record_function(P15_GUARD_PREFIX + "delta norm"):
            return torch.linalg.vector_norm(*args, **kwargs)


class _GuardTorch:
    linalg = _RangedLinalg()

    def __getattr__(self, name):
        return getattr(torch, name)


@contextlib.contextmanager
def _guard_ranges():
    """Profiler ranges (``guard ...``) around the guardian's work in a
    train step: the trainer's ``_guard_tail`` and ``_sq_norms`` (outside
    an enclosing guard range) and the update norms in core/optim.py (a
    measurement aid of this script; the port opens no ranges)."""
    from ray_lightning_accelerators_tpu_torch.core import optim
    from ray_lightning_accelerators_tpu_torch.core import trainer as tr
    T = tr.Trainer
    real_tail, real_sq = T._guard_tail, T.__dict__["_sq_norms"]
    depth = [0]

    def ranged(name, fn):
        def run(*args, **kwargs):
            if depth[0] or not torch.autograd._profiler_enabled():
                return fn(*args, **kwargs)
            depth[0] += 1
            try:
                with torch.profiler.record_function(P15_GUARD_PREFIX + name):
                    return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return run

    T._guard_tail = ranged("tail", real_tail)
    T._sq_norms = staticmethod(ranged("sq norms", real_sq.__func__))
    real_torch, optim.torch = optim.torch, _GuardTorch()
    try:
        yield
    finally:
        T._guard_tail, T._sq_norms = real_tail, real_sq
        optim.torch = real_torch


def _p15_profiled_step(trainer, loader) -> dict:
    """One more training step of a fitted trainer under torch.profiler with
    ``_guard_ranges``: the step's device ms and the guard's (the device time
    of the kernels launched inside the guard ranges)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batch = trainer._put_batch(next(iter(loader)))
    trainer._train_step(trainer._state, batch)     # warm, outside the trace
    sync()
    with _guard_ranges(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        trainer._train_step(trainer._state, batch)
        sync()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.name.startswith(P15_GUARD_PREFIX)]
    guard = [e for e in prof.events() if e.device_type == DeviceType.CPU
             and e.name.startswith(P15_GUARD_PREFIX)]
    if not dev:
        return {"device_ms": None, "guard_ms": None}
    return {"device_ms": sum(e.device_time_total for e in dev) / 1e3,
            "guard_ms": sum(e.device_time_total for e in guard) / 1e3,
            "guard_ranges": len(guard)}


def _p15_in_turns(trainers: dict, rounds: int = 10) -> dict:
    """Each fitted trainer's ``_train_step`` on its own state and one
    placed batch, timed in turns (A B B A, ...; synchronised host clock):
    the step ms of each, so the two are compared under one card state."""
    batches = {k: t._put_batch(next(iter(loader)))
               for k, (t, loader) in trainers.items()}
    for k, (t, _) in trainers.items():
        t._train_step(t._state, batches[k])      # warm
    sync()
    out = {k: [] for k in trainers}
    order = list(trainers)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            t = trainers[k][0]
            t0 = time.perf_counter()
            t._train_step(t._state, batches[k])
            sync()
            out[k].append((time.perf_counter() - t0) * 1e3)
    return out


def phase_defaults_gpt(ph: Phases, seed: int):
    """15a: 6a's GPT (2 epochs of 8 steps) at the Trainer's defaults
    (guard, prefetch 2, the token array cached on the card) and at
    ``guard=None, prefetch_batches=0, cache_dataset_on_device=False``:
    warm step ms of each, K1 25 / K2 12 / K4 12 launches a step in the
    default run, the losses of the two runs (the first step bitwise; the
    rest within 1%, 9a's bound: K4 adds dq by atomics, so two runs of one
    config differ in the last bits), the cache engaged with the step loop
    (6a's per-step clock), and one profiled step of each: the step's
    device ms and the guard's device ms inside it."""
    cfg_l = TRAIN_CFG["n_layers"]
    runs, trainers = {}, {}
    for label, kw in (("defaults", {}), ("off", P15_OFF)):
        root = os.path.join(HERE, "build", f"chip_smoke_p15_{label}")
        trainer, _model, loader, clock, launches, wall = _fit(
            TRAIN_CFG, TRAIN_STEPS_PER_EPOCH, seed, root,
            enable_checkpointing=False, **kw)
        steps = trainer.global_step
        step_ms = clock.warm_step_ms()
        runs[label] = {"steps": steps, "wall_s": wall, "step_ms": step_ms,
                       "step_ms_mean": float(np.mean(step_ms)),
                       "loss": clock.loss,
                       "launches_per_step": {k: v / steps
                                             for k, v in launches.items()},
                       "cached": trainer._device_cache is not None,
                       "guard_ema": (trainer._state.guard_ema.tolist()
                                     if trainer._state.guard_ema is not None
                                     else None)}
        trainers[label] = (trainer, loader)
    d, o = runs["defaults"], runs["off"]
    per = d["launches_per_step"]
    ph.check(d["steps"] == o["steps"] == TRAIN_EPOCHS * TRAIN_STEPS_PER_EPOCH
             and per["rms_norm"] == 2 * cfg_l + 1
             and per["flash_attention"] == cfg_l
             and per["flash_backward_fused"] == cfg_l,
             f"15a: {d['steps']} steps a run; K1 {per['rms_norm']:.0f}, K2 "
             f"{per['flash_attention']:.0f}, K4 "
             f"{per['flash_backward_fused']:.0f} launches a step at the "
             f"defaults")
    ph.check(d["cached"] and not o["cached"],
             "15a: the token array cached on the card at the defaults "
             "only")
    rel = [abs(a - b) / abs(b) for a, b in zip(d["loss"], o["loss"])]
    same = sum(a == b for a, b in zip(d["loss"], o["loss"]))
    ph.check(d["loss"][0] == o["loss"][0] and max(rel) <= 1e-2
             and all(np.isfinite(d["loss"])),
             f"15a: losses at the defaults vs off: first step bitwise, "
             f"{same}/{len(rel)} steps bitwise, max rel diff {max(rel):.2e} "
             f"(<= 1e-2)")
    g = d["guard_ema"]
    ph.check(g is not None and g[2] == 0.0 and g[1] == d["steps"],
             f"15a: the guard vector after the fit: {g}")
    turns = _p15_in_turns(trainers)
    for label in ("defaults", "off"):
        runs[label]["in_turns_ms"] = turns[label]
        trainer, loader = trainers[label]
        try:
            runs[label]["profile"] = [_p15_profiled_step(trainer, loader)]
        except Exception as e:  # a measurement, not a check
            log(f"  15a profile ({label}): not measured "
                f"({type(e).__name__}: {e})")
    pd = runs["defaults"].get("profile") or [{}]
    po = runs["off"].get("profile") or [{}]
    log(f"  15a: warm step ms at the defaults {d['step_ms_mean']:.2f} "
        f"(n={len(d['step_ms'])}), off {o['step_ms_mean']:.2f} "
        f"(n={len(o['step_ms'])}); in turns (median of "
        f"{len(turns['defaults'])}) {np.median(turns['defaults']):.2f} vs "
        f"{np.median(turns['off']):.2f} ms; profiled step device ms "
        f"{[p.get('device_ms') for p in pd]} vs "
        f"{[p.get('device_ms') for p in po]}; the guard's device ms a "
        f"step {[p.get('guard_ms') for p in pd]} "
        f"({pd[0].get('guard_ranges')} ranges); off run's guard ranges "
        f"{po[0].get('guard_ranges')}")
    del trainers
    gc.collect()
    torch.cuda.empty_cache()
    return runs


class _P15EpochProbe:
    """Callback: a synchronised clock at each epoch's start and end, and
    one epoch (``profile_epoch``) under torch.profiler: the device ms of
    its kernels over its wall ms (the busy share)."""

    def __init__(self, profile_epoch: int):
        from ray_lightning_accelerators_tpu_torch import Callback

        probe = self

        class Cb(Callback):
            def on_train_epoch_start(self, trainer, module):
                sync()
                if trainer.current_epoch == profile_epoch:
                    from torch.profiler import ProfilerActivity, profile
                    probe.prof = profile(activities=[
                        ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    probe.prof.__enter__()
                probe.starts.append(time.perf_counter())

            def on_train_epoch_end(self, trainer, module):
                sync()
                probe.ends.append(time.perf_counter())
                if probe.prof is not None and probe.busy is None:
                    probe.prof.__exit__(None, None, None)
                    from torch.autograd import DeviceType
                    dev = [e for e in probe.prof.events()
                           if e.device_type == DeviceType.CUDA]
                    wall = (probe.ends[-1] - probe.starts[-1]) * 1e3
                    probe.busy = (sum(e.device_time_total for e in dev)
                                  / 1e3 / wall if dev else None)
                    probe.profiled_wall_ms = wall

        self.cb, self.starts, self.ends = Cb(), [], []
        self.prof, self.busy, self.profiled_wall_ms = None, None, None


def _p15_mnist_data():
    from ray_lightning_accelerators_tpu_torch.data import vision
    x, y = vision.load_mnist(MNIST_DATA, "train")
    n = MNIST_BATCH * MNIST_STEPS
    reps = -(-n // len(x))
    return np.tile(x, (reps, 1, 1))[:n], np.tile(y, reps)[:n]


def phase_defaults_mnist(ph: Phases, seed: int):
    """15b: 7a's MNIST MLP (batch 1024, 24 steps an epoch, 5 epochs) at the
    defaults, where the cache engages and every epoch takes the
    whole-epoch path (no per-step host read: the step loop's cached step
    never runs), against the host path (``cache_dataset_on_device=False``:
    the native engine's batches placed two ahead on the side stream), the
    host path with the Python loader on the producer thread
    (``use_native=False``) and the old defaults (all three off): steady
    imgs/s over epochs 2-5, the device-idle share of epoch 3 under
    torch.profiler, and the final weights of the runs bitwise equal (the
    guard, the prefetch and the cache move no arithmetic)."""
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.mnist import (
        MNISTClassifier)
    x, y = _p15_mnist_data()
    configs = {"defaults": ({}, None),
               "host": (dict(cache_dataset_on_device=False), None),
               "host_thread": (dict(cache_dataset_on_device=False), False),
               "off": (P15_OFF, None)}
    order = list(configs) + list(configs)[::-1]
    runs = {k: [] for k in configs}
    params = {}
    for i, label in enumerate(order):
        kw, native = configs[label]
        first = not runs[label]
        model = MNISTClassifier({"layer_1": 128, "layer_2": 256, "lr": 1e-3,
                                 "batch_size": MNIST_BATCH}, device=DEV)
        # the first run of each profiles its third epoch
        probe = _P15EpochProbe(profile_epoch=2 if first else -1)
        trainer = Trainer(max_epochs=MNIST_EPOCHS, device=DEV,
                          precision="bf16", enable_checkpointing=False,
                          log_every_n_steps=10 ** 9, seed=seed,
                          callbacks=[probe.cb],
                          default_root_dir=os.path.join(
                              HERE, "build", "chip_smoke_p15_mnist"), **kw)
        per_step = []
        real = trainer._step_cached
        trainer._step_cached = lambda *a, _r=real: per_step.append(1) or \
            _r(*a)
        loader = DataLoader(ArrayDataset(x, y), batch_size=MNIST_BATCH,
                            shuffle=True, seed=seed, use_native=native)
        trainer.fit(model, loader)
        sync()
        # epochs 2-5, less a profiled one
        steady = [e - b for j, (b, e) in enumerate(zip(probe.starts,
                                                       probe.ends))
                  if j >= 1 and not (first and j == 2)]
        runs[label].append({
            "imgs_per_s": MNIST_BATCH * MNIST_STEPS * len(steady)
            / sum(steady),
            "epoch_s": [e - b for b, e in zip(probe.starts, probe.ends)],
            "busy_share": probe.busy,
            "profiled_epoch_ms": probe.profiled_wall_ms,
            "whole_epoch": trainer._can_scan_epoch(),
            "per_step_cached_calls": len(per_step),
            "steps": trainer.global_step})
        params[(label, first)] = {
            k: v.cpu().numpy()
            for k, v in _flat_params(model.params).items()}
    out = {}
    for label, rs in runs.items():
        busy = rs[0]["busy_share"]
        out[label] = {"runs": rs,
                      "imgs_per_s": [r["imgs_per_s"] for r in rs],
                      "imgs_per_s_mean": float(np.mean(
                          [r["imgs_per_s"] for r in rs])),
                      "idle_share": None if busy is None else 1 - busy}
        log(f"  15b {label}: imgs/s over epochs 2-{MNIST_EPOCHS} "
            f"{[round(v, 1) for v in out[label]['imgs_per_s']]} (order "
            f"{' '.join(order)}); device-idle share "
            f"{out[label]['idle_share']} (epoch 3 of its first run under "
            f"the profiler, {rs[0]['profiled_epoch_ms']} ms); whole-epoch "
            f"path {rs[0]['whole_epoch']}")
    d = runs["defaults"]
    ph.check(all(r["whole_epoch"] and r["per_step_cached_calls"] == 0
                 and r["steps"] == MNIST_STEPS * MNIST_EPOCHS for r in d)
             and not runs["host"][0]["whole_epoch"],
             f"15b: the whole-epoch path ran every epoch at the defaults "
             f"({d[0]['steps']} steps, {d[0]['per_step_cached_calls']} "
             f"step-loop cached steps); the host path ran the step loop")
    ref = params[("defaults", True)]
    diffs = {f"{label}{'' if first else ' again'}": max(
        float(np.max(np.abs(p[k].astype(np.float64) - ref[k])))
        for k in ref) for (label, first), p in params.items()}
    out["max_abs_diff_vs_defaults"] = diffs
    ph.check(all(v == 0.0 for v in diffs.values()),
             f"15b: the final weights of all {len(order)} runs bitwise "
             f"equal (max abs diff against the first default run: "
             f"{diffs})")
    return out


def phase_defaults_guard(ph: Phases, seed: int):
    """15c: a NaN pixel in row 17 (batch 2 of 8) of a small f32 MNIST MLP's
    data on the card, at the defaults (the cache and the whole-epoch
    path engage): ``NumericAnomaly`` with step 2, epoch 0, batch 2 and
    blame "data", as the CPU port's; the ledger entry; a second fit on
    the same root skips the batch: 7 steps of 8."""
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.mnist import (
        MNISTClassifier, synthetic_mnist)
    from ray_lightning_accelerators_tpu_torch.runtime import guardian
    import shutil
    x, y = synthetic_mnist(64, seed=seed)
    x[17, 3, 3] = np.nan
    verdicts, roots = {}, {}
    for dev in (DEV, "cpu"):
        root = os.path.join(HERE, "build", f"chip_smoke_p15_guard_{dev}")
        shutil.rmtree(root, ignore_errors=True)
        roots[dev] = root
        model = MNISTClassifier({"layer_1": 32, "layer_2": 32, "lr": 1e-3,
                                 "batch_size": 8}, device=dev)
        trainer = Trainer(max_epochs=1, device=dev, precision="f32",
                          enable_checkpointing=False, seed=seed,
                          default_root_dir=root)
        try:
            trainer.fit(model, DataLoader(ArrayDataset(x, y), batch_size=8))
            verdicts[dev] = None
        except guardian.NumericAnomaly as e:
            verdicts[dev] = (e.step, e.epoch, e.batch_idx, e.blame,
                             {k: v for k, v in e.diagnosis["flags"].items()
                              if isinstance(v, bool)})
        if dev == DEV:
            cached = trainer._device_cache is not None
    card, cpu = verdicts[DEV], verdicts["cpu"]
    ph.check(card is not None and card == cpu and card[:4] == (2, 0, 2,
                                                               "data"),
             f"15c: NumericAnomaly on the card {card} (cache engaged: "
             f"{cached}), the CPU port's {cpu}")
    doc = guardian.load_quarantine(roots[DEV])
    ph.check(doc["entries"] == [{"epoch": 0, "batch_idx": 2, "step": 2}]
             and doc == guardian.load_quarantine(roots["cpu"]),
             f"15c: the ledger {doc}")
    model = MNISTClassifier({"layer_1": 32, "layer_2": 32, "lr": 1e-3,
                             "batch_size": 8}, device=DEV)
    trainer = Trainer(max_epochs=1, device=DEV, precision="f32",
                      enable_checkpointing=False, seed=seed,
                      default_root_dir=roots[DEV])
    trainer.fit(model, DataLoader(ArrayDataset(x, y), batch_size=8))
    ph.check(trainer.global_step == 7 and np.isfinite(
        trainer.callback_metrics.get("ptl/train_loss", float("nan"))),
        f"15c: the second fit skipped the quarantined batch: "
        f"{trainer.global_step} steps of 8, last loss "
        f"{trainer.callback_metrics.get('ptl/train_loss')}")
    return {"card": card, "cpu": cpu, "ledger": doc,
            "second_fit_steps": trainer.global_step, "cached": cached}


def phase_defaults_engine(ph: Phases, seed: int):
    """15d: the native batch engine against the Python loader at 7a's
    arrays (24576 x 28 x 28 f32 and the labels, batch 1024, shuffled):
    every batch of an epoch bitwise equal; batches/s of each (the
    engine's build and first epoch outside the timed pass)."""
    from ray_lightning_accelerators_tpu_torch import DataLoader
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    x, y = _p15_mnist_data()
    out = {}
    batches = {}
    for label, use_native in (("engine", None), ("python", False)):
        loader = DataLoader(ArrayDataset(x, y), batch_size=MNIST_BATCH,
                            shuffle=True, seed=seed, use_native=use_native)
        loader.set_epoch(0)
        for _ in loader:      # warm: the engine's build, the page cache
            pass
        loader.set_epoch(1)
        t0 = time.perf_counter()
        got = list(loader)
        dt = time.perf_counter() - t0
        batches[label] = got
        out[label] = {"batches_per_s": len(got) / dt, "epoch_s": dt,
                      "native": loader._engine is not None}
    same = len(batches["engine"]) == len(batches["python"]) == MNIST_STEPS         and all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                for a, b in zip(batches["engine"], batches["python"]))
    ph.check(same and out["engine"]["native"],
             f"15d: the engine's {len(batches['engine'])} batches bitwise "
             f"the Python loader's; batches/s engine "
             f"{out['engine']['batches_per_s']:.1f}, Python "
             f"{out['python']['batches_per_s']:.1f}")
    return out


def phase_defaults_ship(ph: Phases, seed: int):
    """15e: fit -> test -> predict of the MNIST MLP (one epoch of 7a's
    data) over one NCCL rank in one world
    (``RayAccelerator(num_workers=1, use_gpu=True)``): the training loader
    and the test loader cross once each, predict over the test loader
    sends only its key (``ship_stats`` sent 2, reused 1); the bytes
    stored, the second entry point's (test's) seconds, the predictions'
    count, and the store gone after ``teardown()``."""
    from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                      RayAccelerator,
                                                      Trainer)
    from ray_lightning_accelerators_tpu_torch.data import vision
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.mnist import (
        MNISTClassifier)
    x, y = _p15_mnist_data()
    tx, ty = vision.load_mnist(MNIST_DATA, "test")
    acc = RayAccelerator(num_workers=1, use_gpu=DEV.startswith("cuda"))
    trainer = Trainer(max_epochs=1, device=DEV, precision="bf16",
                      enable_checkpointing=False, log_every_n_steps=10 ** 9,
                      seed=seed, accelerator=acc,
                      default_root_dir=os.path.join(HERE, "build",
                                                    "chip_smoke_p15_ship"))
    model = MNISTClassifier({"layer_1": 128, "layer_2": 256, "lr": 1e-3,
                             "batch_size": MNIST_BATCH}, device=DEV)
    test_loader = DataLoader(ArrayDataset(tx, ty), batch_size=len(tx))
    times = {}
    try:
        t0 = time.perf_counter()
        trainer.fit(model, DataLoader(ArrayDataset(x, y),
                                      batch_size=MNIST_BATCH, shuffle=True,
                                      seed=seed))
        times["fit_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        (tested,) = trainer.test(model, test_loader)
        times["test_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        preds = trainer.predict(model, test_loader)
        times["predict_s"] = time.perf_counter() - t0
        world = trainer._world
        stats = dict(world.ship_stats)
        store = world.ship_dir()
        backend = trainer.rank_report["backend"]
    finally:
        trainer.teardown()
    n_pred = sum(int(p.shape[0]) for p in preds)
    ph.check(stats["sent"] >= 1 and stats["reused"] >= 1
             and backend == "nccl" and n_pred == len(tx)
             and not os.path.exists(store),
             f"15e: ship_stats {stats} over {backend}; {n_pred} "
             f"predictions; the store removed at teardown")
    log(f"  15e: fit {times['fit_s']:.2f} s, test (the second entry point) "
        f"{times['test_s']:.2f} s, predict {times['predict_s']:.2f} s; "
        f"{stats['bytes']} bytes stored; t10k accuracy "
        f"{tested.get('val_accuracy')}")
    return {**times, "ship_stats": stats, "backend": backend,
            "test": tested}


# --------------------------------------------------------------------- #
# 16: fault tolerance on one host                                        #
# --------------------------------------------------------------------- #
# 16a-16c at 6a's TRAIN_CFG (bf16, batch 16 x 1024, full width and depth);
# 16d at 6a's width and 2 layers, 16e at 6a's width, 2 layers a stage
P16_STEPS = 8            # 16a: one batch an epoch, 8 steps
P16_DRAIN_AT = 5         # 16a: the notice after step 5
P16_LOSS_REL = 1e-3      # later losses of two card runs (K4's dq atomics)
P16_PARAM_REL = 1e-3     # 16d: params of two card runs, rel L2
P16_WEDGE_S = 4.0        # 16c / 16e: the stale-heartbeat threshold
P16_DEADLINE_S = 30.0    # 16c: worker_deadline_s
P16_SLACK_S = 15.0       # 16c: WorkerWedged within the deadline + this
P16_HB = "0.5"           # the workers' heartbeat in 16b-16e
P16_MIB = 2 ** 20
P16C_HELD_MIB = 256      # 16c: the card's memory back within this
P16C_FREE_WAIT_S = 15.0  # 16c: how long the reaped context may take to go


def _p16_sync(dev: str) -> None:
    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()


def _p16_free(dev: str) -> Optional[int]:
    """The card's free bytes (every process on it), None off the card."""
    return (int(torch.cuda.mem_get_info()[0])
            if str(dev).startswith("cuda") else None)


class _P16Clock(_Callback):
    """The fit's start (after any restore) and each step's end, on a
    synchronised monotonic clock shared by every process of the host,
    and each step's loss."""

    def __init__(self, dev: str):
        self.dev, self.t_fit, self.t, self.loss = dev, None, [], []

    def on_fit_start(self, trainer, module):
        _p16_sync(self.dev)
        self.t_fit = time.monotonic()

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        _p16_sync(self.dev)
        self.t.append(time.monotonic())
        self.loss.append(float(metrics["train_loss"]))


class _P16Drain(_Callback):
    """16a: after step ``at``, the loss of the step the run would take
    next (the batch of epoch ``at`` on the live params, through the
    training step's own call), then SIGTERM to this process: the notice
    the fit drains on."""

    def __init__(self, at: int, next_batch):
        self.at, self.next_batch = at, next_batch
        self.next_loss = self.t_signal = None

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        if trainer.global_step != self.at:
            return
        from ray_lightning_accelerators_tpu_torch.core.optim import tree_like
        state = trainer._state
        out = module.training_step(
            tree_like(state.params, trainer._compute_leaves(state)),
            trainer._put_batch(self.next_batch),
            state.step_generator(trainer.device, trainer._dropout_key()))
        loss = out[0] if isinstance(out, tuple) else out
        self.next_loss = float(loss.detach())
        import signal
        self.t_signal = time.monotonic()
        os.kill(os.getpid(), signal.SIGTERM)


def _p16_counts_per_step(launches: dict, steps: int) -> dict:
    """K1 / K2 / K4 a step (a rank report names K2 ``flash_forward``)."""
    k2 = launches.get("flash_attention", launches.get("flash_forward", 0))
    return {"rms_norm": launches.get("rms_norm", 0) / steps,
            "flash_attention": k2 / steps,
            "flash_backward_fused":
                launches.get("flash_backward_fused", 0) / steps}


def _p16_launch_check(ph: Phases, tag: str, per_step: dict,
                      n_layers: int) -> None:
    want = {"rms_norm": 2 * n_layers + 1, "flash_attention": n_layers,
            "flash_backward_fused": n_layers}
    ph.check(per_step == want,
             f"{tag}: K1 / K2 / K4 launches a step {per_step} (want "
             f"{want}: the kernel path, not a plain fallback)")


def _p16_gpt(cfg_dict: dict, dev: str, cls=None):
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    return (cls or GPT)(TransformerConfig(**cfg_dict), device=dev, lr=3e-4)


def phase_fault_drain(ph: Phases, seed: int):
    """16a: the drain in process.  6a's GPT, one batch of 16 an epoch,
    in order (a resumed fit replays the drained epoch from its start, as
    the JAX Trainer's does: its batch is then the one the run would take
    next), 8 steps.  An uninterrupted fit; then the same fit with
    ``RLA_TPU_PREEMPT_GRACE_S`` set whose callback, after step 5,
    computes the loss of the next step on its live params and sends
    SIGTERM to this process: the fit drains into ``preempt-step5.ckpt``
    and raises ``Preempted`` with step 5; ``fit(ckpt_path="last")`` on a
    fresh trainer runs steps 5-7.  Checks: the first resumed loss bitwise
    the drained run's next-step loss; the resumed losses within
    P16_LOSS_REL of the uninterrupted run's (K4's dq sums with f32
    atomics: two card runs part in the last bits); K1 25, K2 12, K4 12
    launches a step in the resumed fit.  Prints the emergency
    checkpoint's bytes and the drain's seconds, the resume's seconds to
    its first step."""
    import shutil
    from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                      ModelCheckpoint,
                                                      Preempted, Trainer)
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.runtime import preemption
    from ray_lightning_accelerators_tpu_torch.utils import (
        checkpoint as ckpt_lib)
    cfg = TRAIN_CFG
    L = cfg["n_layers"]
    data = _pattern_tokens(TRAIN_BATCH, cfg["max_seq_len"],
                           cfg["vocab_size"], seed + 16)

    def loader():
        return DataLoader(ArrayDataset(data), batch_size=TRAIN_BATCH)

    next_batch = next(iter(loader()))
    roots = {k: os.path.join(HERE, "build", f"chip_smoke_p16a_{k}")
             for k in ("clean", "drain")}
    for r in roots.values():
        shutil.rmtree(r, ignore_errors=True)

    def fit(root, clock, callbacks=(), ckpt_path=None):
        # checkpointing on (the drain writes through it) but no 1.5 GB
        # save at each one-step epoch's end
        trainer = Trainer(max_steps=P16_STEPS, device=DEV, precision="bf16",
                          log_every_n_steps=10 ** 9, seed=seed,
                          callbacks=[clock, *callbacks, ModelCheckpoint(
                              monitor=None, every_n_epochs=10 ** 6)],
                          default_root_dir=root)
        trainer.fit(_p16_gpt(cfg, DEV), loader(), ckpt_path=ckpt_path)
        return trainer

    gc.collect()
    torch.cuda.empty_cache()
    clean, drained, resumed = (_P16Clock(DEV) for _ in range(3))
    fit(roots["clean"], clean)
    notice = preemption.get_notice()
    os.environ[preemption.PREEMPT_GRACE_ENV] = "60"
    drain = _P16Drain(P16_DRAIN_AT, next_batch)
    err = None
    try:
        try:
            fit(roots["drain"], drained, [drain])
        except Preempted as e:
            err = e
        t_raised = time.monotonic()
        notice.clear()
        _reset_counts()
        _reset_bwd_counts()
        t0 = time.monotonic()
        resumed_trainer = fit(roots["drain"], resumed, ckpt_path="last")
        launches = {**_read_counts(), **_bwd_counts()}
    finally:
        os.environ.pop(preemption.PREEMPT_GRACE_ENV, None)
        notice.clear()
        notice.uninstall()
    ph.check(err is not None and err.step == P16_DRAIN_AT
             and os.path.basename(err.ckpt_path or "")
             == f"preempt-step{P16_DRAIN_AT}.ckpt"
             and err.info.get("source", "").startswith("signal-"),
             f"16a: Preempted {err!r:.120} at step "
             f"{getattr(err, 'step', None)}, checkpoint "
             f"{os.path.basename(getattr(err, 'ckpt_path', '') or '')}")
    ckpt_bytes = os.path.getsize(err.ckpt_path) if err else 0
    drain_s = t_raised - drain.t_signal if drain.t_signal else None
    first_step_s = resumed.t[0] - t0 if resumed.t else None
    steps_run = len(resumed.loss)
    ph.check(resumed_trainer.global_step == P16_STEPS
             and steps_run == P16_STEPS - P16_DRAIN_AT,
             f"16a: the resumed fit ran steps {P16_DRAIN_AT}-"
             f"{P16_STEPS - 1} ({steps_run} steps, global_step "
             f"{resumed_trainer.global_step})")
    ph.check(bool(resumed.loss) and resumed.loss[0] == drain.next_loss,
             f"16a: the first resumed loss {resumed.loss[:1]} bitwise the "
             f"drained run's next-step loss {drain.next_loss} (restored "
             f"params, the same batch)")
    rel = [abs(a - b) / abs(b) for a, b in
           zip(resumed.loss, clean.loss[P16_DRAIN_AT:])]
    first_rel = (abs(clean.loss[0] - drained.loss[0])
                 if drained.loss else None)
    ph.check(len(rel) == steps_run and max(rel) <= P16_LOSS_REL,
             f"16a: resumed losses {[round(x, 5) for x in resumed.loss]} vs "
             f"the uninterrupted run's "
             f"{[round(x, 5) for x in clean.loss[P16_DRAIN_AT:]]} (max rel "
             f"{max(rel) if rel else float('nan'):.2e}, limit "
             f"{P16_LOSS_REL}); first losses of the two runs differ by "
             f"{first_rel}")
    per_step = _p16_counts_per_step(launches, max(steps_run, 1))
    _p16_launch_check(ph, "16a resumed", per_step, L)
    log(f"  16a: emergency checkpoint {ckpt_bytes} bytes, drain (SIGTERM "
        f"to Preempted) {drain_s:.3f} s; resume to its first step "
        f"{first_step_s:.3f} s (restore {resumed.t_fit - t0:.3f} s)")
    for r in roots.values():
        shutil.rmtree(r, ignore_errors=True)
    return {"drain_step": getattr(err, "step", None),
            "ckpt_bytes": ckpt_bytes, "drain_s": drain_s,
            "resume_first_step_s": first_step_s,
            "restore_s": resumed.t_fit - t0,
            "clean_loss": clean.loss, "resumed_loss": resumed.loss,
            "next_loss": drain.next_loss, "loss_rel": rel,
            "launches_per_step": per_step}


def _p16_fit_body(root: str, epochs: int, seed: int, dev: str, save: bool,
                  cfg_dict: dict, batch: int):
    """16b's body in a worker: 6a's GPT on 2 batches an epoch (a
    checkpoint every 2 steps when ``save``), ``ckpt_path="last"``.  The
    seconds from the body's start to CUDA ready, to the fit's start (the
    restore done) and to each step's end; the card's free bytes at the
    start and at the end; the losses and the kernel launches."""
    t_body = time.monotonic()
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    if dev.startswith("cuda"):
        torch.cuda.set_device(0)
        torch.zeros(1, device=dev)
        torch.cuda.synchronize()
    t_cuda = time.monotonic()
    free_start = _p16_free(dev)
    data = _pattern_tokens(2 * batch, cfg_dict["max_seq_len"],
                           cfg_dict["vocab_size"], seed + 161)
    clock = _P16Clock(dev)
    trainer = Trainer(max_epochs=epochs, device=dev, precision="bf16",
                      log_every_n_steps=10 ** 9, seed=seed,
                      enable_checkpointing=save, callbacks=[clock],
                      default_root_dir=root)
    _reset_counts()
    _reset_bwd_counts()
    trainer.fit(_p16_gpt(cfg_dict, dev),
                DataLoader(ArrayDataset(data), batch_size=batch,
                           shuffle=True, seed=seed), ckpt_path="last")
    return {"pid": os.getpid(), "t_body": t_body, "t_cuda": t_cuda,
            "t_fit": clock.t_fit, "t_steps": clock.t, "loss": clock.loss,
            "free_start": free_start, "free_end": _p16_free(dev),
            "global_step": trainer.global_step,
            "launches": {**_read_counts(), **_bwd_counts()}}


def phase_fault_restart(ph: Phases, seed: int):
    """16b: crash and restart over a worker.  ``ActorPool(1)`` on cuda:0
    with ``crash@rank0:step2:once``: dispatch 1 fits 6a's GPT for one
    epoch of 2 steps and checkpoints; ``ElasticRunner`` dispatches the
    2-epoch fit (``ckpt_path="last"``), the worker dies before it
    (dispatch 2), the runner restarts it and the retry resumes at step 2.
    Checks: ``attempts_used == 2``; the retry's first loss bitwise the
    loss of a clean continuation from the same checkpoint (this process,
    the same batch); the killed worker's memory back (the retry starts
    with more free bytes than the first worker ended with); K1 25, K2 12,
    K4 12 a step in the retry.  Prints the seconds from the death's
    detection to the retry's first step (respawn, CUDA init, restore,
    first step) and the goodput fraction (the retry's step seconds as
    productive)."""
    import shutil
    from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                      ElasticRunner, Trainer)
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.runtime.actors import (
        ActorPool)
    from ray_lightning_accelerators_tpu_torch.utils import (
        checkpoint as ckpt_lib)
    cfg, batch = TRAIN_CFG, TRAIN_BATCH
    base = os.path.join(HERE, "build", "chip_smoke_p16b")
    shutil.rmtree(base, ignore_errors=True)
    root, clean_root = os.path.join(base, "run"), os.path.join(base, "clean")
    env = {"RLA_TPU_CHAOS": "crash@rank0:step2:once",
           "RLA_TPU_CHAOS_NS": os.path.join(base, "ns"),
           "RLA_TPU_WORKER_HEARTBEAT_S": P16_HB}
    gc.collect()
    torch.cuda.empty_cache()
    deaths = []
    pool = ActorPool(1, env_per_worker=[env])
    try:
        first = pool.workers[0].execute(
            _p16_fit_body, root, 1, seed, DEV, True, cfg, batch).result(
                timeout=900)
        ckpt = ckpt_lib.latest_checkpoint(root)
        os.makedirs(clean_root)
        shutil.copy(ckpt, os.path.join(clean_root, os.path.basename(ckpt)))
        def on_failure(attempt, err):
            # the dead process's exit code, before the runner's restart
            # replaces it (the error's text may precede its reaping)
            t = time.monotonic()
            pool.workers[0]._proc.join(timeout=30)
            deaths.append((t, err, pool.workers[0].exitcode))

        runner = ElasticRunner(pool, max_failures=1, on_failure=on_failure)
        (retry,) = runner.run(_p16_fit_body, args_per_worker=lambda a: [
            (root, 2, seed, DEV, False, cfg, batch)])
    finally:
        pool.kill()
    ph.check(runner.attempts_used == 2 and len(deaths) == 1
             and deaths[0][2] == 43
             and retry["pid"] != first["pid"] and retry["global_step"] == 4,
             f"16b: attempts_used {runner.attempts_used}, the failure "
             f"{str(deaths[0][1]) if deaths else None!r:.80} (exit code "
             f"{deaths[0][2] if deaths else None}), the retry in "
             f"a new process ({retry['pid']} after {first['pid']}) at "
             f"global_step {retry['global_step']}")
    data = _pattern_tokens(2 * batch, cfg["max_seq_len"], cfg["vocab_size"],
                           seed + 161)
    clock = _P16Clock(DEV)
    Trainer(max_epochs=2, max_steps=3, device=DEV, precision="bf16",
            log_every_n_steps=10 ** 9, seed=seed, enable_checkpointing=False,
            callbacks=[clock], default_root_dir=clean_root).fit(
        _p16_gpt(cfg, DEV), DataLoader(ArrayDataset(data), batch_size=batch,
                                       shuffle=True, seed=seed),
        ckpt_path="last")
    ph.check(bool(retry["loss"]) and retry["loss"][0] == clock.loss[0],
             f"16b: the retry's first loss {retry['loss'][:1]} bitwise the "
             f"clean continuation's {clock.loss[:1]} from the same "
             f"checkpoint")
    freed = (None if first["free_end"] is None
             else (retry["free_start"] - first["free_end"]) / P16_MIB)
    ph.check(freed is not None and freed > 1024,
             f"16b: the card's free bytes {first['free_end']} before the "
             f"crash (the first worker's fit held), {retry['free_start']} "
             f"at the retry's start ({freed} MiB back: the killed context "
             f"is gone)")
    steps = len(retry["loss"])
    per_step = _p16_counts_per_step(retry["launches"], max(steps, 1))
    _p16_launch_check(ph, "16b retry", per_step, cfg["n_layers"])
    t_death = deaths[0][0] if deaths else retry["t_body"]
    split = {"respawn_s": retry["t_body"] - t_death,
             "cuda_init_s": retry["t_cuda"] - retry["t_body"],
             "restore_s": retry["t_fit"] - retry["t_cuda"],
             "first_step_s": retry["t_steps"][0] - retry["t_fit"]}
    split["death_to_first_step_s"] = retry["t_steps"][0] - t_death
    runner.goodput.absorb_profiler({"stats": {"train_step": {
        "total": retry["t_steps"][-1] - retry["t_fit"]}}})
    good = runner.goodput.snapshot()
    log(f"  16b: death to the retry's first step "
        f"{split['death_to_first_step_s']:.3f} s: respawn "
        f"{split['respawn_s']:.3f}, CUDA init {split['cuda_init_s']:.3f}, "
        f"model + restore {split['restore_s']:.3f}, first step "
        f"{split['first_step_s']:.3f}; goodput {json.dumps(good)}")
    shutil.rmtree(base, ignore_errors=True)
    return {**split, "goodput": good, "freed_mib": freed,
            "free_before_crash": first["free_end"],
            "free_at_retry_start": retry["free_start"],
            "retry_loss": retry["loss"], "clean_loss": clock.loss,
            "launches_per_step": per_step}


def phase_fault_hang(ph: Phases, seed: int):
    """16c: a hang on the card.  ``Trainer(accelerator=RayAccelerator(
    num_workers=1, use_gpu=True), worker_deadline_s=30)`` with
    ``hang@rank0:step2:once`` in the world's env (dispatch 1 of the rank
    is the rendezvous, 2 the fit), the heartbeat every 0.5 s and the
    wedge timeout 4 s: the rank's beat freezes and the watchdog reaps it.
    Checks: ``WorkerWedged`` naming rank 0 within the deadline plus 15 s
    of the fit's call; the card's free memory back to what it was before
    the world (within 256 MiB); a second fit on the same trainer (a new
    world; the once-claim spent) runs its 2 steps with K1 25, K2 12, K4
    12 a step in the rank.  Prints the detection latency (the beat's age
    at the reap) and ``last_stall_diagnosis``."""
    import shutil
    from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                      RayAccelerator,
                                                      Trainer, WorkerWedged)
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    cfg = TRAIN_CFG
    base = os.path.join(HERE, "build", "chip_smoke_p16c")
    shutil.rmtree(base, ignore_errors=True)
    env = {"RLA_TPU_CHAOS": "hang@rank0:step2:once",
           "RLA_TPU_CHAOS_NS": os.path.join(base, "ns"),
           "RLA_TPU_WEDGE_TIMEOUT_S": str(P16_WEDGE_S),
           "RLA_TPU_WORKER_HEARTBEAT_S": P16_HB}
    saved = {k: os.environ.get(k) for k in env}
    data = _pattern_tokens(2 * TRAIN_BATCH, cfg["max_seq_len"],
                           cfg["vocab_size"], seed + 162)
    gc.collect()
    torch.cuda.empty_cache()
    free_before = _p16_free(DEV)
    trainer = Trainer(max_steps=2, device=DEV, precision="bf16",
                      log_every_n_steps=10 ** 9, seed=seed,
                      enable_checkpointing=False,
                      accelerator=RayAccelerator(
                          num_workers=1, use_gpu=DEV.startswith("cuda")),
                      worker_deadline_s=P16_DEADLINE_S,
                      default_root_dir=os.path.join(base, "run"))

    def loader():
        return DataLoader(ArrayDataset(data), batch_size=TRAIN_BATCH,
                          shuffle=True, seed=seed)

    err = None
    try:
        os.environ.update(env)
        t0 = time.monotonic()
        try:
            trainer.fit(_p16_gpt(cfg, DEV), loader())
        except WorkerWedged as e:
            err = e
        elapsed = time.monotonic() - t0
        # the reaped process is gone; the card frees its context a little
        # later (seconds on a loaded host): read it until back, bounded
        t_free = time.monotonic()
        free_after = _p16_free(DEV)
        while (free_before is not None and free_after is not None
               and free_before - free_after > P16C_HELD_MIB * P16_MIB
               and time.monotonic() - t_free < P16C_FREE_WAIT_S):
            time.sleep(0.25)
            free_after = _p16_free(DEV)
        free_wait_s = time.monotonic() - t_free
        stall = trainer.last_stall_diagnosis
        trainer.fit(_p16_gpt(cfg, DEV), loader())
        report = trainer.rank_report
    finally:
        trainer.teardown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    reap = (stall or {}).get("reaped") or [{}]
    ph.check(err is not None and err.rank == 0
             and elapsed <= P16_DEADLINE_S + P16_SLACK_S,
             f"16c: WorkerWedged naming rank {getattr(err, 'rank', None)} "
             f"{elapsed:.2f} s into the fit's call (limit "
             f"{P16_DEADLINE_S + P16_SLACK_S:.0f} s: the deadline "
             f"{P16_DEADLINE_S:.0f} s + {P16_SLACK_S:.0f} s); "
             f"{(getattr(err, 'diagnosis', {}) or {}).get('detail')}")
    back = (None if free_before is None
            else (free_before - free_after) / P16_MIB)
    ph.check(back is not None and abs(back) <= P16C_HELD_MIB,
             f"16c: free bytes {free_before} before the world, {free_after} "
             f"after the reap, read {free_wait_s:.2f} s after it ({back} "
             f"MiB held: the reaped rank's context is gone)")
    per_step = _p16_counts_per_step(report["launches"], trainer.global_step)
    ph.check(trainer.global_step == 2 and report["backend"] == "nccl",
             f"16c: the second fit on the same trainer ran "
             f"{trainer.global_step} steps over {report['backend']}")
    _p16_launch_check(ph, "16c second fit", per_step, cfg["n_layers"])
    log(f"  16c: detection latency (the beat's age at the reap) "
        f"{reap[0].get('beat_age_s')} s, busy {reap[0].get('busy_s')} s; "
        f"last_stall_diagnosis "
        f"{json.dumps({k: v for k, v in (stall or {}).items() if k != 'reaped'}, default=str)[:600]}")
    shutil.rmtree(base, ignore_errors=True)
    return {"elapsed_s": elapsed, "detection_s": reap[0].get("beat_age_s"),
            "free_before": free_before, "free_after": free_after,
            "free_wait_s": free_wait_s,
            "stall": stall, "launches_per_step": per_step}


class _P16WeightedGPT(_GPT):
    """16d's model: the port GPT whose batch is ``(tokens, weights)``,
    the loss scaled by the weights' mean (all 1.0: the GPT's own loss).
    ``badbatch`` poisons float leaves only, and a NaN weight makes the
    loss NaN: the guard trips and the batch evidence blames the data."""

    def training_step(self, params, batch, rng=None):
        loss, metrics = super().training_step(params, batch[0], rng)
        w = torch.as_tensor(batch[1], device=loss.device).float().mean()
        return loss * w, metrics


def _p16_rewind_body(root: str, seed: int, dev: str, cfg_dict: dict,
                     tokens, weights, batch: int):
    """16d's body in a worker: the guarded fit of ``_P16WeightedGPT``, 2
    epochs of 2 batches, a checkpoint each epoch, ``ckpt_path="last"``:
    the final step and params (f32, by path)."""
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    model = _p16_gpt(cfg_dict, dev, _P16WeightedGPT)
    trainer = Trainer(max_epochs=2, device=dev, precision="bf16",
                      log_every_n_steps=1, seed=seed,
                      cache_dataset_on_device=False, default_root_dir=root)
    trainer.fit(model, DataLoader(ArrayDataset(tokens, weights),
                                  batch_size=batch), ckpt_path="last")
    return trainer.global_step, {k: v.float().cpu().numpy() for k, v in
                                 _flat_params(model.params).items()}


def phase_fault_rewind(ph: Phases, seed: int):
    """16d: the rewind on the card.  ``badbatch@step3`` through
    ``ElasticRunner(max_rewinds=2)`` over one CUDA worker, a GPT at 6a's
    width with 2 layers (``_P16WeightedGPT``, batch 16 x 1024), 2 epochs
    of 2 batches, a checkpoint each epoch: step 3 (epoch 1, batch 0)
    gets the poisoned batch, the guard trips, ``NumericAnomaly`` (blame
    "data") crosses the pipe typed and the runner rewinds with no failure
    charged (``max_failures=0``); the retry resumes from the anchor (the
    step-2 checkpoint) and skips the quarantined batch.  Checks: one
    rewind, attempts 2, the ledger's entry, 3 steps done, and the final
    params against a clean run in this process that skips the same
    batch (P16_PARAM_REL relative L2 per leaf, bf16 with K4's dq
    atomics)."""
    import shutil
    from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                      ElasticRunner, Trainer)
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.runtime import guardian
    from ray_lightning_accelerators_tpu_torch.runtime.actors import (
        ActorPool)
    cfg = dict(TRAIN_CFG, n_layers=2)
    batch = TRAIN_BATCH
    base = os.path.join(HERE, "build", "chip_smoke_p16d")
    shutil.rmtree(base, ignore_errors=True)
    root, clean_root = os.path.join(base, "run"), os.path.join(base, "clean")
    tokens = _pattern_tokens(2 * batch, cfg["max_seq_len"], cfg["vocab_size"],
                             seed + 163)
    weights = np.ones(2 * batch, np.float32)
    env = {"RLA_TPU_CHAOS": "badbatch@step3",
           "RLA_TPU_CHAOS_NS": os.path.join(base, "ns"),
           "RLA_TPU_WORKER_HEARTBEAT_S": P16_HB}
    charged = []
    gc.collect()
    torch.cuda.empty_cache()
    pool = ActorPool(1, env_per_worker=[env])
    try:
        runner = ElasticRunner(pool, max_failures=0, max_rewinds=2,
                               guard_root_dir=root,
                               on_failure=lambda a, e: charged.append(e))
        ((steps, got),) = runner.run(
            _p16_rewind_body, args_per_worker=lambda a: [
                (root, seed, DEV, cfg, tokens, weights, batch)])
    finally:
        pool.kill()
    ev = runner.anomaly_events[0] if runner.anomaly_events else {}
    ph.check(runner.attempts_used == 2 and charged == []
             and len(runner.anomaly_events) == 1
             and ev.get("blame") == "data" and ev.get("epoch") == 1
             and ev.get("batch_idx") == 0 and steps == 3,
             f"16d: NumericAnomaly {ev.get('blame')} at step "
             f"{ev.get('step')} (epoch {ev.get('epoch')}, batch "
             f"{ev.get('batch_idx')}) typed across the pipe: "
             f"{len(runner.anomaly_events)} rewind, {len(charged)} failures "
             f"charged, attempts {runner.attempts_used}, {steps} steps done")
    ledger = guardian.load_quarantine(root)["entries"]
    ph.check(ledger == [{"epoch": 1, "batch_idx": 0, "step": 2}]
             and str(ev.get("anchor") or "").endswith(".ckpt"),
             f"16d: the ledger {ledger}; the rewind's anchor "
             f"{os.path.basename(str(ev.get('anchor')))}")
    guardian.add_quarantine(clean_root, 1, 0, 2)
    model = _p16_gpt(cfg, DEV, _P16WeightedGPT)
    Trainer(max_epochs=2, device=DEV, precision="bf16", seed=seed,
            cache_dataset_on_device=False, enable_checkpointing=False,
            log_every_n_steps=1, default_root_dir=clean_root).fit(
        model, DataLoader(ArrayDataset(tokens, weights), batch_size=batch))
    ref = {k: v.float().cpu() for k, v in _flat_params(model.params).items()}
    rel = {k: _rel_l2(torch.from_numpy(got[k]), ref[k]) for k in ref}
    worst = max(rel.items(), key=lambda kv: kv[1])
    ph.check(set(rel) == set(got) and worst[1] <= P16_PARAM_REL,
             f"16d: params against the card's clean run skipping the same "
             f"batch: max rel L2 {worst[1]:.3e} ({worst[0]}), limit "
             f"{P16_PARAM_REL}")
    shutil.rmtree(base, ignore_errors=True)
    return {"event": ev, "param_rel_max": worst[1],
            "attempts": runner.attempts_used,
            "goodput": runner.goodput.snapshot()}


def phase_fault_pipeline(ph: Phases, seed: int):
    """16e: the MPMD watchdog.  ``Trainer(pipeline_stages=2,
    worker_deadline_s=4)`` (the runner's ``wedge_timeout_s``) over 2 GPT
    layers a stage at 6a's width (13b's ``_GptStages``, bf16, 4
    microbatches of a global batch of 8), 4 steps, both stage workers on
    the card, ``hang@stage1:step2:once`` in their env (dispatch 1 is the
    stage's build, 2 its first step): stage 1's beat freezes, the
    watchdog reaps it, stage 1 alone is charged and the step replays.
    Checks: one replay, the reap naming a stage-1 rank, the losses within
    13b's 1e-2 of an in-process run on the card (same seed, microbatches
    and accumulation order).  Prints the fit's seconds."""
    import shutil
    from ray_lightning_accelerators_tpu_torch import Trainer
    cfg = dict(TRAIN_CFG, n_layers=4)
    seq, d = cfg["max_seq_len"], cfg["d_model"]
    rng = np.random.default_rng(seed + 164)
    batches = [{"x": rng.standard_normal((P13_BATCH, seq, d)).astype(
        np.float32), "t": rng.standard_normal((P13_BATCH, seq, d)).astype(
        np.float32)} for _ in range(4)]
    stages_mod = _GptStages(cfg, DEV)

    def gpt_loss(sps, mb):
        h = stages_mod.pipeline_stage_forward(sps[0], mb, 0, 2)
        return stages_mod.pipeline_loss(
            stages_mod.pipeline_stage_forward(sps[1], h, 1, 2), mb)

    gc.collect()
    torch.cuda.empty_cache()
    ref, _ = _p13_inprocess(stages_mod, batches, seed, gpt_loss)
    del stages_mod
    gc.collect()
    torch.cuda.empty_cache()
    base = os.path.join(HERE, "build", "chip_smoke_p16e")
    shutil.rmtree(base, ignore_errors=True)
    env = {"RLA_TPU_CHAOS": "hang@stage1:step2:once",
           "RLA_TPU_CHAOS_NS": os.path.join(base, "ns"),
           "RLA_TPU_WORKER_HEARTBEAT_S": P16_HB}
    saved = {k: os.environ.get(k) for k in env}
    trainer = Trainer(max_steps=4, device=DEV, precision="bf16", seed=seed,
                      pipeline_stages=2, pipeline_microbatches=P13_M,
                      enable_checkpointing=False,
                      worker_deadline_s=P16_WEDGE_S,
                      default_root_dir=os.path.join(base, "run"))
    try:
        os.environ.update(env)
        t0 = time.perf_counter()
        trainer.fit(_GptStages(cfg, DEV), train_dataloaders=batches)
        wall = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    sm = trainer.pipeline_summary
    reaped = sm.get("reaped") or []
    ph.check(sm["replays"] == 1 and sm["stage_failure_budget_used"] == [0, 1]
             and [r["rank"] for r in reaped] == [1],
             f"16e: replays {sm['replays']}, budgets "
             f"{sm['stage_failure_budget_used']}, reaped "
             f"{[(r['rank'], r['detail']) for r in reaped]}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(sm["losses"], ref))
    ph.check(len(sm["losses"]) == 4 and rel <= 1e-2,
             f"16e: losses after the replay "
             f"{[round(x, 5) for x in sm['losses']]} vs in-process "
             f"{[round(x, 5) for x in ref]} (max rel {rel:.3e}, limit 1e-2)")
    log(f"  16e: the fit with the hang and its replay {wall:.2f} s")
    shutil.rmtree(base, ignore_errors=True)
    return {"losses": sm["losses"], "ref_losses": ref, "loss_rel": rel,
            "reaped": reaped, "wall_s": wall}


P17_STEPS = 3            # 17a: steps of 6a's fit over the agent's rank
P17_LOSS_REL = INT8_LAST_LOSS_REL   # 17a: 10a's bound against 6a's
P17B_LAYERS = 2          # 17b: 6a's widths at 2 layers
P17B_STEPS = 1           # 17b: steps at each world size (2, 1, 2);
                         # 2 until the script passed 1080 s
P17B_LOSS_REL = 1e-2     # 17b: 10b's bf16 bound (8 rows a rank vs 16)
P17_AGENT_WAIT_S = 120.0


def _p17_start_agent():
    """The port's CLI agent in a subprocess on loopback, ``--port 0``,
    started without waiting: returns the process, a reader of the port
    it prints first (``_p17_agent_address``) and the list its stderr's
    spawn lines are gathered into."""
    import threading
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_lightning_accelerators_tpu_torch.cli",
         "agent", "--port", "0"], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    lines: list = []
    threading.Thread(target=lambda: lines.extend(proc.stderr), daemon=True,
                     name="p17-agent-stderr").start()
    port: list = []
    reader = threading.Thread(
        target=lambda: port.append(proc.stdout.readline()), daemon=True,
        name="p17-agent-port")
    reader.start()
    return proc, (reader, port), lines


def _p17_agent_address(proc, port_reader) -> str:
    """The agent's address, once it printed its port (bounded)."""
    reader, port = port_reader
    reader.join(timeout=P17_AGENT_WAIT_S)
    if not port or not port[0].strip().isdigit():
        proc.kill()
        raise RuntimeError(f"the agent printed no port within "
                           f"{P17_AGENT_WAIT_S:.0f} s: {port}")
    return f"127.0.0.1:{int(port[0])}"


def _p17_spawn_count(lines: list) -> int:
    """The agent's last logged spawn_count (0 before any spawn)."""
    import re
    counts = [int(m.group(1)) for line in list(lines)
              for m in [re.search(r"spawn_count (\d+)", line)] if m]
    return counts[-1] if counts else 0


def phase_agent_fit(ph: Phases, seed: int, inproc: Optional[dict]):
    """17a: 6a's fit (the GPT bench config at full width, bf16, the same
    seed and data) for 3 steps through ``Trainer(accelerator=
    RayTPUAccelerator(1, agents=[addr]))``: the one NCCL rank spawned by
    a host agent the port's CLI started in a subprocess (``rla-tpu-torch
    agent --port 0``, loopback).  Checks: the rank on cuda:0 over NCCL,
    spawned by the agent (its spawn_count 1), still 1 after
    ``validate`` in the same world; K1 25, K2 12, K4 12 a step in the
    rank; each loss within ``P17_LOSS_REL`` (10a's 7e-6) of 6a's."""
    import importlib
    import shutil
    from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                      RayTPUAccelerator,
                                                      Trainer)
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    me = importlib.import_module("chip_smoke")   # ranks unpickle by name
    cfg = TransformerConfig(**TRAIN_CFG)
    data = _pattern_tokens(TRAIN_BATCH * TRAIN_STEPS_PER_EPOCH,
                           cfg.max_seq_len, cfg.vocab_size, seed)
    root = os.path.join(HERE, "build", "chip_smoke_p17a")
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the agent boots (an interpreter importing torch) while the model
    # is made
    proc, port_reader, lines = _p17_start_agent()
    try:
        model = GPT(cfg, device=DEV, lr=3e-4)
        addr = _p17_agent_address(proc, port_reader)
        agent_s = time.perf_counter() - t0
        clock = me._RankStepClock()
        acc = RayTPUAccelerator(1, agents=[addr])
        trainer = Trainer(max_steps=P17_STEPS, max_epochs=TRAIN_EPOCHS,
                          device=DEV, precision="bf16",
                          log_every_n_steps=10 ** 9, seed=seed,
                          callbacks=[clock], enable_checkpointing=False,
                          default_root_dir=root, accelerator=acc)
        t0 = time.perf_counter()
        world = trainer._acquire_world(acc.launch_spec())
        spawn_s = time.perf_counter() - t0
        pid = world.pool.workers[0].execute(os.getpid).result(timeout=60)
        t0 = time.perf_counter()
        trainer.fit(model, DataLoader(ArrayDataset(data),
                                      batch_size=TRAIN_BATCH, shuffle=True,
                                      seed=seed))
        wall = time.perf_counter() - t0
        after_fit = _p17_spawn_count(lines)
        val = _pattern_tokens(TRAIN_BATCH, cfg.max_seq_len, cfg.vocab_size,
                              seed + 1)
        (validated,) = trainer.validate(model, DataLoader(
            ArrayDataset(val), batch_size=TRAIN_BATCH))
        same = (trainer._world is world and world.pool.workers[0].execute(
            os.getpid).result(timeout=60) == pid)
        after_validate = _p17_spawn_count(lines)
        rep = trainer.rank_report
        trainer.shutdown_workers()
    finally:
        proc.kill()
        proc.wait(timeout=30)
    ph.check(world.agents == [addr] and rep["device"] == "cuda:0"
             and rep["backend"] == "nccl" and rep["world_size"] == 1,
             f"17a: the rank ran on {rep['device']} over {rep['backend']}, "
             f"world size {rep['world_size']}, placed on agent {addr}")
    ph.check(after_fit == 1 and after_validate == 1 and same,
             f"17a: the agent's spawn_count {after_fit} after fit, "
             f"{after_validate} after validate (the same rank, pid {pid}); "
             f"val_loss {validated.get('val_loss', float('nan')):.4f}")
    per_step = _p16_counts_per_step(rep["launches"], P17_STEPS)
    _p16_launch_check(ph, "17a", per_step, cfg.n_layers)
    ref = (inproc or {}).get("loss") or []
    rel = ([abs(a - b) / abs(b) for a, b in zip(clock.loss, ref)]
           if len(clock.loss) == P17_STEPS and len(ref) >= P17_STEPS
           else [])
    ph.check(len(rel) == P17_STEPS and max(rel) <= P17_LOSS_REL,
             f"17a: losses {clock.loss} vs in-process 6a "
             f"{ref[:P17_STEPS]} (max rel "
             f"{max(rel) if rel else float('nan'):.3e}, limit "
             f"{P17_LOSS_REL:g})")
    first_step_s = clock.t[0] - clock.t_fit[0] if clock.t else None
    warm_ms = [(clock.t[i] - clock.t[i - 1]) * 1e3
               for i in range(1, len(clock.t))]
    log(f"  17a: agent up {agent_s:.2f} s (the model made meanwhile); "
        f"spawn + rendezvous through the "
        f"agent {spawn_s:.2f} s; fit {wall:.2f} s wall (to the first step "
        f"{first_step_s:.2f} s, warm steps {[round(x, 2) for x in warm_ms]}"
        f" ms; in-process 6a {(inproc or {}).get('step_ms_mean', float('nan')):.2f}"
        f" ms); spawn_count {after_fit} -> {after_validate}; K1/K2/K4 a step "
        f"{per_step}")
    shutil.rmtree(root, ignore_errors=True)
    return {"agent_s": agent_s, "spawn_rendezvous_s": spawn_s,
            "wall_s": wall, "first_step_s": first_step_s,
            "warm_step_ms": warm_ms, "loss": clock.loss,
            "loss_rel_vs_6a": rel, "spawn_count": [after_fit, after_validate],
            "launches_per_step": per_step}


def phase_live_resize(ph: Phases, seed: int):
    """17b: the live resize.  Two gloo ranks sharing the card
    (``DistributedWorld(2, backend="gloo")``: NCCL refuses two ranks on
    one device) fit 6a's widths at ``P17B_LAYERS`` layers with ZeRO-1
    (``shard_optimizer_state=True``) for ``P17B_STEPS`` step(s), one
    epoch of global batches of 16 in order; ``resize_in_memory(1)`` and
    ``fit(ckpt_path="live")`` for ``P17B_STEPS`` more;
    ``resize_in_memory(2)``, which spawns a rank, and ``P17B_STEPS``
    more.  The losses against one
    uninterrupted in-process run over the same global batches (a rank's
    rows are strided, but the mean of the ranks' means is the global
    mean), each within ``P17B_LOSS_REL``; no ``.ckpt`` file written.
    Prints each resize's bytes moved, bytes total, waves and seconds and
    the card's free bytes before and after."""
    import shutil
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
        DistributedWorld)
    cfg = TransformerConfig(**dict(TRAIN_CFG, n_layers=P17B_LAYERS))
    # one epoch a world size: a live fit re-enters an epoch cut short from
    # its first batch, as a checkpoint restore does
    tokens = _pattern_tokens(P17B_STEPS * TRAIN_BATCH, cfg.max_seq_len,
                             cfg.vocab_size, seed + 171)
    dev = "cuda:0" if DEV.startswith("cuda") else DEV
    root = os.path.join(HERE, "build", "chip_smoke_p17b")
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    def loader():
        return DataLoader(ArrayDataset(tokens), batch_size=TRAIN_BATCH)

    import threading

    # the ranks boot and meet while the uninterrupted reference runs here
    box: list = []

    def form():
        t = time.perf_counter()
        try:
            box.append(DistributedWorld(2, devices=[dev] * 2,
                                        backend="gloo"))
        except BaseException as e:
            box.append(e)
        box.append(time.perf_counter() - t)

    former = threading.Thread(target=form, name="p17b-world")
    former.start()
    ref = Trainer(max_steps=3 * P17B_STEPS, max_epochs=100, device=DEV,
                  precision="bf16", log_every_n_steps=1, seed=seed,
                  enable_checkpointing=False,
                  default_root_dir=os.path.join(root, "ref"))
    ref.fit(GPT(cfg, device=DEV, lr=3e-4), loader())
    ref_loss = [r["train_loss"] for r in ref.logger.history
                if "train_loss" in r]
    former.join()
    world, spawn_s = box
    if isinstance(world, BaseException):
        raise world
    trainer = Trainer(max_steps=P17B_STEPS, max_epochs=100, device=DEV,
                      precision="bf16", log_every_n_steps=1, seed=seed,
                      enable_checkpointing=False, default_root_dir=root,
                      shard_optimizer_state=True,
                      accelerator=_SharedCardAccelerator(2))
    trainer._world = world
    model = GPT(cfg, device=DEV, lr=3e-4)
    resizes, worlds = [], []
    try:
        trainer.fit(model, loader())
        worlds.append(trainer.rank_report["world_size"])
        for n, until in ((1, 2 * P17B_STEPS), (2, 3 * P17B_STEPS)):
            _p16_sync(DEV)
            free0 = _p16_free(DEV)
            stats = trainer.resize_in_memory(n)
            _p16_sync(DEV)
            stats["free_before"], stats["free_after"] = free0, _p16_free(DEV)
            resizes.append(stats)
            trainer.max_steps = until
            trainer.fit(model, loader(), ckpt_path="live")
            worlds.append(trainer.rank_report["world_size"])
    finally:
        procs = ([w._proc for w in world.pool.workers]
                 if world.pool is not None else [])
        trainer.shutdown_workers()
    loss = [r["train_loss"] for r in trainer.logger.history
            if "train_loss" in r]
    ph.check(not any(p.is_alive() for p in procs),
             "17b: no rank outlives shutdown_workers()")
    ph.check(worlds == [2, 1, 2] and trainer.global_step == 3 * P17B_STEPS
             and [s["new_world"] for s in resizes] == [1, 2],
             f"17b: worlds {worlds} (2 -> 1 -> 2), global_step "
             f"{trainer.global_step}")
    rel = ([abs(a - b) / abs(b) for a, b in zip(loss, ref_loss)]
           if len(loss) == len(ref_loss) == 3 * P17B_STEPS else [])
    ph.check(len(rel) == 3 * P17B_STEPS and max(rel) <= P17B_LOSS_REL,
             f"17b: losses {[round(x, 5) for x in loss]} vs one "
             f"uninterrupted in-process run {[round(x, 5) for x in ref_loss]}"
             f" (max rel {max(rel) if rel else float('nan'):.3e}, limit "
             f"{P17B_LOSS_REL:g})")
    ckpts = [n for _, _, names in os.walk(root) for n in names
             if n.endswith(".ckpt")]
    ph.check(ckpts == [] and all(s["bytes_moved"] > 0 for s in resizes),
             f"17b: no .ckpt written ({ckpts}); bytes moved "
             f"{[s['bytes_moved'] for s in resizes]}")
    for tag, s in zip(("2->1", "1->2"), resizes):
        log(f"  17b {tag}: {s['bytes_moved']} of {s['bytes_total']} bytes "
            f"moved in {s['waves']} wave(s), {s['seconds']:.3f} s; free "
            f"card bytes {s['free_before']} -> {s['free_after']}")
    log(f"  17b: spawn + rendezvous of the 2 ranks {spawn_s:.2f} s (beside "
        f"the reference run)")
    shutil.rmtree(root, ignore_errors=True)
    return {"spawn_rendezvous_s": spawn_s, "resizes": resizes,
            "loss": loss, "ref_loss": ref_loss, "loss_rel": rel,
            "worlds": worlds}


P18_STEPS_PER_EPOCH = 4   # 18a: 6a's fit, 2 epochs of 4 steps
P18_TRACED_STEPS = 2      # 18b: warm steps inside Profiler.trace
P18_TURNS, P18_TURN_STEPS = 4, 3   # 18a: telemetry off / on in turns
# 18b: the device work the traced steps queue behind, as short spin
# kernels: late in a long process a torch.profiler trace on the H100
# machine dropped the first kernels of a burst on an idle card, more the
# older the process (2 more every ~27 s of age; PERF.md §7)
P18_LEAD_KERNELS, P18_LEAD_CYCLES = 200, 200_000   # ~0.1 ms each
# 18b: the kernels the trace summary is read for, by the name in the
# trace (a substring of the demangled kernel name), with the launch
# counter of the wrapper that launches each
P18_TRACE_KERNELS = {"K1": ("rms_norm_kernel", "rms_norm"),
                     "K2": ("flash_fwd_kernel_tc", "flash_attention"),
                     "K4": ("flash_bwd_kv_kernel_tc",
                            "flash_backward_fused")}


def _p18_in_turns(trainer, loader) -> dict:
    """Warm steps of the fitted trainer (its own ``_fit_step``, the batch
    placed from the host) in turns with its profiler and observatory
    detached and attached, ``P18_TURN_STEPS`` a turn, the order swapped
    each round: each step's ms (synchronised host clock) by side."""
    batch = next(iter(loader))
    kept = (trainer.profiler, trainer.perf)
    ms = {"off": [], "on": []}
    try:
        for r in range(P18_TURNS):
            for side in (("off", "on") if r % 2 == 0 else ("on", "off")):
                trainer.profiler, trainer.perf = \
                    kept if side == "on" else (None, None)
                for i in range(P18_TURN_STEPS):
                    sync()
                    t0 = time.perf_counter()
                    trainer._fit_step(trainer._state, "host", batch, i)
                    sync()
                    ms[side].append((time.perf_counter() - t0) * 1e3)
    finally:
        trainer.profiler, trainer.perf = kept
    return ms


def phase_telemetry_fit(ph: Phases, seed: int, inproc: Optional[dict]):
    """18a: 6a's fit (the GPT bench config at full width, bf16) for 8
    steps with ``Trainer(profiler=Profiler(), perf_observatory=...)`` (the
    HBM ledger sampling every step): each step's timeline phases against
    its wall, the HBM pools against ``torch.cuda.memory_allocated()``
    (params and opt_state against their analytic bytes), the profiler's
    MFU against 6a's own formula, the registry's JSON keys and
    Prometheus lines, the warm step ms beside 6a's and, in turns on the
    same trainer, with the profiler and the observatory detached and
    attached (``_p18_in_turns``).  Checks: the phases
    sum to within each step's wall, the pools are no more than the
    allocated total, params = 4 N and opt_state = 8 N bytes (f32 masters
    and two Adam moments), the MFUs equal, K1 / K2 / K4 25 / 12 / 12 a
    step.  Returns the trainer and its loader for 18b."""
    from ray_lightning_accelerators_tpu_torch.telemetry.perf import (
        HbmLedger, PerfObservatory)
    from ray_lightning_accelerators_tpu_torch.utils import profiler as uprof
    root = os.path.join(HERE, "build", "chip_smoke_p18")
    prof = uprof.Profiler()
    obs = PerfObservatory(hbm=HbmLedger(sample_min_s=0.0))
    trainer, model, loader, clock, launches, wall = _fit(
        TRAIN_CFG, P18_STEPS_PER_EPOCH, seed, root, profiler=prof,
        perf_observatory=obs, enable_checkpointing=False)
    steps = TRAIN_EPOCHS * P18_STEPS_PER_EPOCH
    ph.check(trainer.global_step == steps,
             f"18a: {trainer.global_step} steps with the profiler and the "
             f"observatory on")
    _p16_launch_check(ph, "18a", {k: launches[k] // steps for k in (
        "rms_norm", "flash_attention", "flash_backward_fused")},
        TRAIN_CFG["n_layers"])
    tl = obs.timeline.snapshot()
    rows = tl["recent_steps"]
    worst = max(sum(r["phases"].values()) - r["wall_s"] for r in rows)
    ph.check(len(rows) == steps and worst <= 1e-5
             and abs(tl["phase_sum_over_wall"] - 1.0) <= 1e-3,
             f"18a: every step's phases sum to within its wall (worst "
             f"excess {worst * 1e6:.2f} us over {len(rows)} steps; phase "
             f"sum / wall {tl['phase_sum_over_wall']})")
    for r in rows:
        log(f"    step {r['step']}: wall {r['wall_s'] * 1e3:.3f} ms, "
            + ", ".join(f"{k} {v * 1e3:.3f}"
                        for k, v in sorted(r["phases"].items())))
    log(f"  18a: timeline phases (s) {json.dumps(tl['phases'])}; between "
        f"steps {json.dumps(tl['between_step_phases'])}; attributed "
        f"{tl['attributed_fraction']}")
    hbm = obs.hbm.sample()
    allocated = torch.cuda.memory_allocated()
    n = _n_params(model.params)
    # the device's pools (the object store's shm is host memory)
    pools = {k: v for k, v in hbm.items()
             if k not in ("other", "total", "object_store_shm")}
    ph.check(sum(pools.values()) <= hbm["total"] <= allocated,
             f"18a: the device pools {sum(pools.values())} B are no more "
             f"than the ledger's total {hbm['total']} B (memory_allocated "
             f"{allocated} B; other {hbm['other']} B)")
    ph.check(pools["params"] == 4 * n and pools["opt_state"] == 8 * n,
             f"18a: params {pools['params']} B = 4 x {n}, opt_state "
             f"{pools['opt_state']} B = 8 x {n} (f32 masters, Adam mu/nu)")
    snap = obs.hbm.snapshot()
    log(f"  18a: HBM pools {json.dumps(hbm)}; peak total "
        f"{snap['peak_total_bytes']} B over {snap['samples']} samples; "
        f"leak alarms {snap['leak_alarms']}")
    L, d, S = TRAIN_CFG["n_layers"], TRAIN_CFG["d_model"], \
        TRAIN_CFG["max_seq_len"]
    tokens = TRAIN_BATCH * S
    flops = (6 * n + 12 * L * d * S) * tokens
    step_ms = clock.warm_step_ms()
    mean_ms = float(np.mean(step_ms))
    mfu_6a = flops / (mean_ms / 1e3) / BF16_TENSOR_FLOPS
    mfu_prof = uprof.mfu(flops, mean_ms / 1e3)
    ph.check(abs(mfu_prof - mfu_6a) <= 1e-12 * max(mfu_6a, 1.0),
             f"18a: profiler.mfu {mfu_prof:.6f} = 6a's formula "
             f"{mfu_6a:.6f} ({torch.cuda.get_device_name(0)}: peak "
             f"{BF16_TENSOR_FLOPS:.3g})")
    reg = trainer.build_metrics_registry()
    j = reg.to_json()
    prom = reg.prometheus_text().splitlines()
    ph.check({"spans", "events", "perf", "compile"} <= set(j)
             and j["spans"]["train_step"]["count"] == steps,
             f"18a: registry JSON keys {sorted(j)}, "
             f"{len(prom)} Prometheus lines, train_step spans "
             f"{j['spans']['train_step']['count']}")
    base = (inproc or {}).get("step_ms_mean")
    turns = _p18_in_turns(trainer, loader)
    med = {k: float(np.median(v)) for k, v in turns.items()}
    log(f"  18a: in turns, {P18_TURNS} x {P18_TURN_STEPS} steps a side: "
        f"median {med['on']:.2f} ms with the profiler and the observatory "
        f"on, {med['off']:.2f} ms off ({(med['on'] / med['off'] - 1) * 100:+.2f}"
        f"%); on {[round(x, 2) for x in turns['on']]}, off "
        f"{[round(x, 2) for x in turns['off']]}")
    log(f"  18a: warm step_ms mean {mean_ms:.2f} (min {min(step_ms):.2f}, "
        f"n={len(step_ms)}) with the profiler and the observatory on; 6a "
        f"without them {base if base is None else round(base, 2)}; spans "
        + ", ".join(f"{k} {v['count']} x {v['mean_s'] * 1e3:.3f} ms"
                    for k, v in sorted(j["spans"].items()))
        + f"; compiles {j['compile']}; events {json.dumps(j['events'])}")
    return {"trainer": trainer, "loader": loader, "clock_cb": clock.cb,
            "steps": steps,
            "wall_s": wall, "step_ms": step_ms, "step_ms_mean": mean_ms,
            "step_ms_6a": base, "in_turns_ms": turns, "in_turns_median": med,
            "mfu": mfu_prof, "mfu_6a": mfu_6a,
            "timeline": tl, "hbm": hbm, "memory_allocated": allocated,
            "registry_keys": sorted(j), "prometheus_lines": len(prom),
            "root": root}


def phase_telemetry_trace(ph: Phases, fit: Optional[dict]):
    """18b: two warm steps of 18a's trainer (its own ``_fit_step`` on the
    cached rows, back to back) inside ``Profiler.trace``, queued behind
    ``P18_LEAD_KERNELS`` short spin kernels; ``trace_op_summary`` of the
    written trace and ``cli.main(["trace", dir])`` in process.  Checks:
    the trace holds device events, and K1 (``rms_norm_kernel``), K2
    (``flash_fwd_kernel_tc``) and K4 (``flash_bwd_kv_kernel_tc``) show 25,
    12 and 12 a step in the summary, as their launch counters say.
    Prints their self ms and shares of the steps' device time."""
    import io
    import shutil
    from ray_lightning_accelerators_tpu_torch import cli
    from ray_lightning_accelerators_tpu_torch.utils import profiler as uprof
    if fit is None:
        raise RuntimeError("18a did not run")
    trainer, loader = fit["trainer"], fit["loader"]
    tdir = os.path.join(fit["root"], "trace")
    # the cached rows (no host copy, which would wait for the card) and no
    # per-step clock (its synchronise would idle the card between steps)
    if trainer._device_cache is not None:
        kind, payload = "cached", torch.arange(TRAIN_BATCH, device=DEV)
    else:
        kind, payload = "host", next(iter(loader))
    kept = trainer.callbacks
    trainer.callbacks = [c for c in kept if c is not fit["clock_cb"]]
    try:
        trainer._fit_step(trainer._state, kind, payload, 0)   # warm
        sync()
        _reset_counts()
        _reset_bwd_counts()
        prof = uprof.Profiler()
        t0 = time.perf_counter()
        with prof.trace(tdir):
            if DEV == "cuda":
                for _ in range(P18_LEAD_KERNELS):
                    torch.cuda._sleep(P18_LEAD_CYCLES)
            for i in range(P18_TRACED_STEPS):
                trainer._fit_step(trainer._state, kind, payload, i + 1)
            sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        trainer.callbacks = kept
    counts = {**_read_counts(), **_bwd_counts()}
    s = uprof.trace_op_summary(tdir)
    # the lead's spin kernels are not the steps' device time
    lead = [o for o in s["ops"] if "spin_kernel" in o["name"]]
    lead_ms = sum(o["self_ms"] for o in lead)
    steps_ms = s["total_ms"] - lead_ms
    ph.check(steps_ms > 0 and len(s["ops"]) > len(lead),
             f"18b: the trace holds {len(s['ops'])} device ops, "
             f"{steps_ms:.2f} ms of the steps' device time (beside the "
             f"lead's {sum(o['count'] for o in lead)} spin kernels, "
             f"{lead_ms:.2f} ms) in {wall_ms:.2f} ms of wall "
             f"({P18_TRACED_STEPS} steps)")
    rows = {}
    for k, (fragment, counter) in P18_TRACE_KERNELS.items():
        ops = [o for o in s["ops"] if fragment in o["name"]]
        n = sum(o["count"] for o in ops)
        self_ms = sum(o["self_ms"] for o in ops)
        rows[k] = {"count": n, "launches": counts[counter],
                   "per_step": n / P18_TRACED_STEPS, "self_ms": self_ms,
                   "share": self_ms / steps_ms if steps_ms > 0 else 0.0}
        want = {"K1": 2 * TRAIN_CFG["n_layers"] + 1}.get(
            k, TRAIN_CFG["n_layers"])
        ph.check(n == counts[counter] == want * P18_TRACED_STEPS,
                 f"18b: {k} {fragment}: {n} trace events, {counts[counter]} "
                 f"launches counted ({want} a step over "
                 f"{P18_TRACED_STEPS}); self {self_ms:.3f} ms, "
                 f"{rows[k]['share'] * 100:.1f}% of the steps' device time")
    log("  18b: by category " + json.dumps(
        {c: round(v["self_ms"], 3) for c, v in s["by_category"].items()}))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["trace", tdir, "--top", "0"])
    text = out.getvalue()
    # op names print cut at 44 characters
    shown = [f for f in ("rms_norm_kernel", "flash_fwd_kernel",
                         "flash_bwd_kv_ker") if f in text]
    ph.check(text.startswith("device total:") and len(shown) == 3,
             f"18b: rla-tpu-torch trace printed {len(text.splitlines())} "
             f"lines, naming {shown}")
    for line in text.splitlines()[:14]:
        log(f"    {line}")
    shutil.rmtree(fit["root"], ignore_errors=True)
    return {"wall_ms": wall_ms, "device_ms": steps_ms, "lead_ms": lead_ms,
            "kernels": rows, "by_category": s["by_category"]}


P19_STEPS = 12           # 19a: steps of the multi-slice fit
P19_WINDOW_STEPS = 2     # 19a: the 10 Hz scraper on and off in turns
                         # of this many steps, off first
P19_HZ = 10.0            # 19a / 19b: the scraper's rate
P19_WATCH_S = 0.25       # 19a: the driver's /metrics polled this often
P19_REFRESH_S = "0.2"    # 19a: the ClusterView's cadence
P19_ENDPOINT_GETS = 5    # 19a: GETs an endpoint for its scrape ms
# 19a: 6a's GPT at full width, cut to MP_LAYERS for the time limit
P19_CFG = dict(TRAIN_CFG, n_layers=MP_LAYERS)
# 19b: the paged engine's SLO targets (a decode step is ~13-21 ms: the
# token target sits among them, so the burn rate reads something)
P19_TTFT_S, P19_TOKEN_S = 0.5, 0.015
P19_ENDPOINTS = ("/metrics", "/statusz", "/healthz", "/snapshot")


@contextlib.contextmanager
def _p19_plane(tdir: str):
    """The live plane on for the phase (``RLA_TPU_METRICS_PORT=0``, the
    telemetry directory, the ClusterView's cadence), workers forked
    meanwhile inherit it; the process's server and the knobs go after."""
    from ray_lightning_accelerators_tpu_torch.telemetry import live
    keys = {"RLA_TPU_METRICS_PORT": "0", "RLA_TPU_TELEMETRY_DIR": tdir,
            "RLA_TPU_LIVE_REFRESH_S": P19_REFRESH_S}
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(keys)
    try:
        yield live
    finally:
        live.shutdown_server()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _p19_get(url: str, timeout: float = 10.0):
    """(code, body, ms) of one GET (no proxies; a 503 is an answer)."""
    import urllib.error
    from ray_lightning_accelerators_tpu_torch.telemetry.live import _OPENER
    t0 = time.perf_counter()
    try:
        with _OPENER.open(url, timeout=timeout) as r:
            code, body = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read().decode()
    return code, body, (time.perf_counter() - t0) * 1e3


def _p19_rank_series(text: str, name: str) -> dict:
    """``{rank label: value}`` of a rank-labeled Prometheus series."""
    out = {}
    for line in text.splitlines():
        if line.startswith(name + "{"):
            label = line.split('rank="', 1)[1].split('"', 1)[0]
            out[label] = float(line.rsplit(" ", 1)[1])
    return out


class _P19Scraper:
    """A thread GETting ``urls`` every ``1 / hz`` s while it is on: the
    load a monitoring stack puts on the plane.  Keeps each GET's ms and
    code, and the windows it was on (``time.perf_counter``, the
    monotonic clock the ranks' step clocks share)."""

    def __init__(self, urls, hz: float):
        import threading
        self.urls, self.period = list(urls), 1.0 / hz
        self.ms, self.codes, self.windows = [], [], []
        self._on = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="p19-scraper")
        self._thread.start()

    def set_on(self, on: bool) -> None:
        if on and not self._on.is_set():
            self.windows.append([time.perf_counter(), None])
            self._on.set()
        elif not on and self._on.is_set():
            self._on.clear()
            self.windows[-1][1] = time.perf_counter()

    def _run(self) -> None:
        while not self._stop.is_set():
            if not self._on.wait(0.05):
                continue
            t0 = time.perf_counter()
            for url in self.urls:
                code, _body, ms = _p19_get(url)
                self.codes.append(code)
                self.ms.append(ms)
            self._stop.wait(max(0.0, self.period
                                - (time.perf_counter() - t0)))

    def stop(self) -> None:
        self.set_on(False)
        self._stop.set()
        self._thread.join(timeout=30)

    def side(self, a: float, b: float) -> Optional[str]:
        """"on" when ``[a, b]`` lies inside one on-window, "off" when it
        meets none, None when it straddles an edge."""
        for lo, hi in self.windows:
            hi = float("inf") if hi is None else hi
            if lo <= a and b <= hi:
                return "on"
            if a < hi and lo < b:
                return None
        return "off"


def _p19_endpoint_ms(base: str) -> dict:
    """Each endpoint's median GET ms of ``base`` and its code."""
    out = {}
    for path in P19_ENDPOINTS:
        runs = [_p19_get(base + path) for _ in range(P19_ENDPOINT_GETS)]
        out[path] = {"code": runs[-1][0],
                     "ms": float(np.median([r[2] for r in runs]))}
    return out


def phase_multi_slice_live(ph: Phases, seed: int):
    """19a: a multi-slice fit scraped live.  Two loopback ``HostAgent``s
    (one granule each), one rank on each, gloo ranks sharing the card
    (``DistributedWorld(2, backend="gloo", agents=...)``: NCCL refuses
    two ranks on one device), ``RayTPUAccelerator(1, agents=[a, b],
    dcn_data=2)`` (one rank a granule, the data axis over DCN), 6a's GPT
    at full width and ``MP_LAYERS`` layers, bf16, ``P19_STEPS`` steps of
    global batches of 16 in order.  The plane is on
    (``RLA_TPU_METRICS_PORT=0``): the driver polls its own ``/metrics``
    while the fit steps, and a 10 Hz scraper GETs the driver's and both
    ranks' ``/metrics`` in turns of ``P19_WINDOW_STEPS`` steps on and
    off (a step is on or off when it lies wholly in one kind of turn).  Checks:
    both ranks' portfiles and ``/healthz`` ``ok``; at least two mid-fit
    scrapes of the driver's ``/metrics`` with rank-labeled series of
    both ranks, rank 0's ``global_step`` advancing between them; the
    hybrid layout puts one rank on each agent along ``data``; K1 / K2 /
    K4 9 / 4 / 4 a step in each rank; the losses within
    ``P17B_LOSS_REL`` of one in-process run over the same global
    batches.  Prints each endpoint's scrape ms (the driver's and rank
    0's) and the warm step ms with and without the 10 Hz scraper."""
    import importlib
    import shutil
    import threading
    from ray_lightning_accelerators_tpu_torch import (DataLoader,
                                                      RayTPUAccelerator,
                                                      Trainer)
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    from ray_lightning_accelerators_tpu_torch.runtime import agent
    from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
        DistributedWorld)
    me = importlib.import_module("chip_smoke")   # ranks unpickle by name
    cfg = TransformerConfig(**P19_CFG)
    tokens = _pattern_tokens(P19_STEPS * TRAIN_BATCH, cfg.max_seq_len,
                             cfg.vocab_size, seed + 191)
    dev = "cuda:0" if DEV.startswith("cuda") else DEV
    root = os.path.join(HERE, "build", "chip_smoke_p19a")
    tdir = os.path.join(root, "telemetry")
    shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    if DEV.startswith("cuda"):
        torch.cuda.empty_cache()

    def loader():
        return DataLoader(ArrayDataset(tokens), batch_size=TRAIN_BATCH)

    hosts = [agent.HostAgent(port=0) for _ in range(2)]
    for h in hosts:
        h.serve_in_background()
    addrs = [f"127.0.0.1:{h.port}" for h in hosts]
    scrapes, health, box = [], {}, {}
    with _p19_plane(tdir) as live:
        try:
            # the ranks boot through the agents and meet while the
            # in-process reference runs here
            def form():
                t = time.perf_counter()
                try:
                    box["world"] = DistributedWorld(
                        2, devices=[dev] * 2, backend="gloo", agents=addrs)
                except Exception as e:   # raised in the phase's thread
                    box["error"] = e
                box["spawn_s"] = time.perf_counter() - t

            former = threading.Thread(target=form, name="p19-world")
            former.start()
            ref = Trainer(max_steps=P19_STEPS, max_epochs=1, device=DEV,
                          precision="bf16", log_every_n_steps=1, seed=seed,
                          enable_checkpointing=False,
                          default_root_dir=os.path.join(root, "ref"))
            ref.fit(GPT(cfg, device=DEV, lr=3e-4), loader())
            ref_loss = [r["train_loss"] for r in ref.logger.history
                        if "train_loss" in r]
            del ref
            former.join()
            if "error" in box:
                raise box["error"]
            world = box["world"]
            acc = RayTPUAccelerator(1, agents=addrs, dcn_data=2)
            clock = me._RankStepClock()
            trainer = Trainer(max_steps=P19_STEPS, max_epochs=1, device=DEV,
                              precision="bf16", log_every_n_steps=1,
                              seed=seed, enable_checkpointing=False,
                              callbacks=[clock], default_root_dir=root,
                              accelerator=acc)
            trainer._world = world          # the phase's gloo group
            model = GPT(cfg, device=DEV, lr=3e-4)
            done = threading.Event()
            holder = {}

            def watch():
                """The driver's /metrics polled while the fit steps; the
                10 Hz scraper on and off in turns of P19_WINDOW_STEPS."""
                while not done.is_set():
                    srv = live.get_server()
                    if srv is not None:
                        code, text, ms = _p19_get(srv.url + "/metrics")
                        steps = _p19_rank_series(
                            text, "rla_tpu_rank_global_step")
                        healthy = _p19_rank_series(text,
                                                   "rla_tpu_rank_healthy")
                        if code == 200 and {"0", "1"} <= set(healthy):
                            scrapes.append({"ms": ms, "steps": steps,
                                            "healthy": healthy})
                        recs = {r: live.read_portfile(live.portfile_for(r))
                                for r in (0, 1)}
                        for r, rec in recs.items():
                            if rec is not None and r not in health:
                                health[r] = _p19_get(
                                    f"http://127.0.0.1:{rec['port']}"
                                    "/healthz")
                        if "scraper" not in holder and all(
                                rec is not None for rec in recs.values()):
                            holder["scraper"] = _P19Scraper(
                                [srv.url + "/metrics"] + [
                                    f"http://127.0.0.1:{rec['port']}/metrics"
                                    for rec in recs.values()], P19_HZ)
                        step = int(steps.get("0", 0))
                        if "scraper" in holder and step >= 1:
                            holder["scraper"].set_on(
                                (step - 1) // P19_WINDOW_STEPS % 2 == 1)
                    done.wait(P19_WATCH_S)

            watcher = threading.Thread(target=watch, name="p19-watch")
            t0 = time.perf_counter()
            watcher.start()
            try:
                trainer.fit(model, loader())
            finally:
                done.set()
                watcher.join(timeout=60)
                scraper = holder.get("scraper")
                if scraper is not None:
                    scraper.stop()
            wall = time.perf_counter() - t0
            # the plane after the fit, the world still up
            ms = {"driver": _p19_endpoint_ms(live.get_server().url)}
            rec0 = live.read_portfile(live.portfile_for(0))
            ms["rank0"] = (_p19_endpoint_ms(
                f"http://127.0.0.1:{rec0['port']}") if rec0 else {})
            view = trainer._cluster_view.last_view()
            rep = trainer.rank_report
            mesh = acc.build_mesh()
            placement = acc.placement()
        finally:
            if box.get("world") is not None:
                box["world"].shutdown()
            for h in hosts:
                h.shutdown()
    loss = [r["train_loss"] for r in trainer.logger.history
            if "train_loss" in r]
    ph.check(trainer.global_step == P19_STEPS
             and rep["world_size"] == 2 and rep["backend"] == "gloo",
             f"19a: {trainer.global_step} steps over world size "
             f"{rep['world_size']} ({rep['backend']}) placed on agents "
             f"{placement}")
    for r in (0, 1):
        code, body, _ = health.get(r, (None, "{}", 0.0))
        ph.check(code == 200 and json.loads(body).get("status") == "ok",
                 f"19a: rank {r}'s portfile appeared and its /healthz "
                 f"answered {code} {body[:120]}")
    mid = [s for s in scrapes if "0" in s["steps"] and "1" in s["steps"]]
    advanced = (len(mid) >= 2
                and mid[-1]["steps"]["0"] > mid[0]["steps"]["0"])
    ph.check(advanced and all(s["healthy"] == {"driver": 1.0, "0": 1.0,
                                               "1": 1.0} for s in mid),
             f"19a: {len(mid)} mid-fit scrapes of the driver's /metrics "
             f"carried both ranks' series; rank 0's global_step "
             f"{[s['steps'].get('0') for s in mid]}")
    coords = {r: mesh.coords_of(r) for r in (0, 1)}
    ph.check([coords[r]["data"] for r in (0, 1)] == [0, 1]
             and placement[0] != placement[1]
             and rep["coords"]["data"] == 0
             and rep["mesh_groups"]["data"][0] == [0, 1]
             and sorted(view["ranks"]) == ["0", "1"],
             f"19a: the hybrid layout (order {mesh.order}) puts rank 0 at "
             f"data 0 on {placement[0]} and rank 1 at data 1 on "
             f"{placement[1]}; rank 0's data group "
             f"{rep['mesh_groups']['data'][0]}; the ClusterView's ranks "
             f"{sorted(view['ranks'])}")
    for r, launches in enumerate(rep["launches_by_rank"]):
        _p16_launch_check(ph, f"19a rank {r}",
                          _p16_counts_per_step(launches, P19_STEPS),
                          cfg.n_layers)
    rel = ([abs(a - b) / abs(b) for a, b in zip(loss, ref_loss)]
           if len(loss) == len(ref_loss) == P19_STEPS else [])
    ph.check(len(rel) == P19_STEPS and max(rel) <= P17B_LOSS_REL,
             f"19a: losses {[round(x, 5) for x in loss]} vs one in-process "
             f"run {[round(x, 5) for x in ref_loss]} (max rel "
             f"{max(rel) if rel else float('nan'):.3e}, limit "
             f"{P17B_LOSS_REL:g})")
    t = clock.t
    warm = [(t[i] - t[i - 1]) * 1e3 for i in range(2, len(t))]
    by_side = {"on": [], "off": []}
    if scraper is not None:
        for i in range(2, len(t)):
            side = scraper.side(t[i - 1], t[i])
            if side is not None:
                by_side[side].append((t[i] - t[i - 1]) * 1e3)
    on, off = by_side["on"], by_side["off"]
    codes = scraper.codes if scraper is not None else []
    ph.check(bool(on) and bool(off) and bool(codes)
             and all(c == 200 for c in codes),
             f"19a: warm steps {len(off)} without and {len(on)} under the "
             f"10 Hz scraper ({len(codes)} GETs, all 200)")
    med = {k: float(np.median(v)) if v else float("nan")
           for k, v in (("off", off), ("on", on))}
    log(f"  19a: warm step ms without the 10 Hz scraper {med['off']:.2f} "
        f"({[round(x, 2) for x in off]}), with it {med['on']:.2f} "
        f"({[round(x, 2) for x in on]}); the scraper's GETs median "
        f"{float(np.median(scraper.ms)) if scraper and scraper.ms else float('nan'):.2f}"
        f" ms; mid-fit driver /metrics scrapes "
        f"{[round(s['ms'], 2) for s in mid]} ms")
    for who, rows in ms.items():
        log(f"  19a: {who} endpoints " + ", ".join(
            f"{p} {v['code']} {v['ms']:.2f} ms" for p, v in rows.items()))
    log(f"  19a: spawn + rendezvous through 2 agents {box['spawn_s']:.2f} s;"
        f" fit {wall:.2f} s; warm steps {[round(x, 2) for x in warm]} ms")
    shutil.rmtree(root, ignore_errors=True)
    return {"spawn_rendezvous_s": box["spawn_s"], "wall_s": wall,
            "loss": loss, "ref_loss": ref_loss, "loss_rel": rel,
            "warm_step_ms": warm, "step_ms_without_scraper": off,
            "step_ms_with_scraper": on, "step_ms_median": med,
            "scraper_get_ms": scraper.ms if scraper else [],
            "midfit_scrape_ms": [s["ms"] for s in mid],
            "midfit_global_step": [s["steps"].get("0") for s in mid],
            "endpoint_ms": ms, "placement": placement,
            "mesh_order": list(mesh.order) if mesh.order else None,
            "launches_by_rank": rep["launches_by_rank"]}


def phase_live_serve(ph: Phases, model, params, seed: int):
    """19b: the paged ``ServeEngine`` at the GPT-2-small class config (12
    layers, bf16, phase 3's weights) with an ``SloPolicy`` (TTFT
    ``P19_TTFT_S``, token cadence ``P19_TOKEN_S``) serving phase 3's 16
    128-token prompts, 64 new tokens each, four times: alone, under a
    10 Hz scraper of the process's ``/metrics`` and ``/statusz``, under
    it again, alone again.
    Checks: ``/statusz`` carries the engine as ``engine<N>`` with its
    SLO burn rate, ``/metrics`` its ``rla_tpu_serve_*`` series, every
    request completed, K1 launched, and ``stop()`` takes the engine off
    the plane.  Prints decode-step p50 / p99 with and without the
    scraper."""
    from ray_lightning_accelerators_tpu_torch.serve import ServeEngine
    from ray_lightning_accelerators_tpu_torch.serve.slo import SloPolicy
    reqs = _requests(seed)
    reqs.pop(SLOTS // 2)                 # the long prompt: 16 remain
    root = os.path.join(HERE, "build", "chip_smoke_p19b")
    runs = {}
    with _p19_plane(os.path.join(root, "telemetry")) as live:
        for i, side in enumerate(("alone", "scraped", "scraped", "alone")):
            _reset_counts()
            scraper = None
            with ServeEngine(model, params, max_slots=SLOTS,
                             block_len=BLOCK_LEN, max_total_len=MAX_TOTAL,
                             slo=SloPolicy(ttft_target_s=P19_TTFT_S,
                                           token_cadence_target_s=P19_TOKEN_S)
                             ) as eng:
                srv = live.get_server()
                label = eng._live_label
                if side == "scraped":
                    scraper = _P19Scraper([srv.url + "/metrics",
                                           srv.url + "/statusz"], P19_HZ)
                    scraper.set_on(True)
                resps = [eng.submit(p, NEW_TOKENS) for p in reqs]
                _code, status_body, status_ms = _p19_get(
                    srv.url + "/statusz")
                outs = [r.result(timeout=900) for r in resps]
                _code, metrics_body, metrics_ms = _p19_get(
                    srv.url + "/metrics")
                _code, after_body, _ = _p19_get(srv.url + "/statusz")
                if scraper is not None:
                    scraper.stop()
                snap = eng.metrics.snapshot()
            launches = _read_counts()
            _code, off_body, _ = _p19_get(srv.url + "/statusz")
            status, after = json.loads(status_body), json.loads(after_body)
            runs[f"{side}{i}"] = {
                "side": side, "label": label, "launches": launches,
                "completed": snap["completed"],
                "outs_ok": all(o.shape == (p.size + NEW_TOKENS,)
                               for o, p in zip(outs, reqs)),
                "burn_rate": (after.get("slo") or {}).get(
                    label, {}).get("burn_rate"),
                "midserve_engines": status.get("serve_engines", []),
                "serve_series": sum(
                    1 for line in metrics_body.splitlines()
                    if line.startswith("rla_tpu_serve_")
                    and f'rank="{label}"' in line),
                "off_after_stop": label not in (json.loads(off_body).get(
                    "serve_engines") or []),
                "statusz_ms": status_ms, "metrics_ms": metrics_ms,
                "decode_step_p50_ms": snap["decode_step_s"]["p50_s"] * 1e3,
                "decode_step_p99_ms": snap["decode_step_s"]["p99_s"] * 1e3,
                "slo_burn_rate": snap.get("slo_burn_rate"),
                "scraper_gets": len(scraper.codes) if scraper else 0,
                "scraper_ok": (all(c == 200 for c in scraper.codes)
                               if scraper else True)}
    for side, r in runs.items():
        ph.check(r["label"] is not None and r["label"].startswith("engine")
                 and r["label"] in r["midserve_engines"]
                 and isinstance(r["burn_rate"], float)
                 and r["burn_rate"] == r["slo_burn_rate"],
                 f"19b {side}: /statusz carried {r['label']} (engines "
                 f"{r['midserve_engines']}) with SLO burn rate "
                 f"{r['burn_rate']} (the engine's {r['slo_burn_rate']})")
        ph.check(r["serve_series"] > 0 and r["off_after_stop"]
                 and r["scraper_ok"],
                 f"19b {side}: {r['serve_series']} rla_tpu_serve_* lines "
                 f"for {r['label']} on /metrics; off the plane after "
                 f"stop(): {r['off_after_stop']}; scraper GETs "
                 f"{r['scraper_gets']} all 200: {r['scraper_ok']}")
        ph.check(r["completed"] == len(reqs) and r["outs_ok"]
                 and r["launches"]["rms_norm"] > 0,
                 f"19b {side}: {r['completed']}/{len(reqs)} requests with "
                 f"{NEW_TOKENS} new tokens; K1 rms_norm launches "
                 f"{r['launches']['rms_norm']}")
    for key, r in runs.items():
        log(f"  19b {key}: decode step p50 / p99 "
            f"{r['decode_step_p50_ms']:.3f} / {r['decode_step_p99_ms']:.3f}"
            f" ms; mid-serve /statusz {r['statusz_ms']:.2f} ms, after it "
            f"/metrics {r['metrics_ms']:.2f} ms; burn rate "
            f"{r['burn_rate']}")
    return runs


# --------------------------------------------------------------------- #
# phase 20: the serving tier                                             #
# --------------------------------------------------------------------- #
P20_HB = "0.1"            # the replicas' heartbeat (s)
P20B_NEW = 16             # 20b: new tokens a request (3b's first 16)
P20B_WAVE = 4             # 20b: requests a wave
P20B_WEDGE_S = 4.0        # 20b: the stale-heartbeat threshold (16c's)
# 20b: hedge only chunks older than a reaped hang takes (the JAX test's
# 5 s over its 1.2 s wedge timeout), so the chaos faults land on the
# requeue path and not on hedge copies
P20B_HEDGE_AGE_S = 10.0
P20B_HEAL_S = 180.0       # 20b: bound on the waves until both revive
P20B_SCALE_S = 90.0       # 20b: bound on the waves until the scale-up
P20B_DRAIN_S = 90.0       # 20b: bound on the drain once idle
P20_POLL_S = 0.02         # the driver's watch of the controller's table


def _p20_cuda_state():
    """In a worker forked from the port's forkserver, before anything ran
    there: (CUDA initialised, in a bad fork).  Both False when the
    forkserver never touched CUDA."""
    return (bool(torch.cuda.is_initialized()),
            bool(torch.cuda._is_in_bad_fork()))


def _p20_events():
    """In a replica: its flight recorder's serve events (monotonic clock,
    comparable across the processes of one host)."""
    from ray_lightning_accelerators_tpu_torch.telemetry import recorder
    keep = ("serve_prefill", "serve_kv_export", "serve_kv_import")
    return [e for e in recorder.get_recorder().events()
            if e["kind"] in keep]


def _p20_factory(seed: int, int8: bool, **engine):
    """Each replica's engine factory: the port's ``gpt_engine`` builds
    phase 3's weights from the seed inside the replica (bf16, then int8
    for 20b), so no weight crosses a pipe."""
    import functools
    from ray_lightning_accelerators_tpu_torch.serve import gpt_engine
    return functools.partial(
        gpt_engine, CFG, seed=seed, device=None if DEV == "cuda" else DEV,
        compute_dtype=torch.bfloat16,
        weight_dtype=torch.bfloat16, quantize=int8, max_slots=SLOTS,
        block_len=BLOCK_LEN, max_total_len=MAX_TOTAL, **engine)


def _p20_launches(group) -> dict:
    """Each live replica's kernel launch counts (``core/trainer.py``
    ``_kernel_launches``, run in the replica)."""
    from ray_lightning_accelerators_tpu_torch.core.trainer import (
        _kernel_launches)
    return {w.rank: w.execute(_kernel_launches).result(timeout=120)
            for w in group.pool.workers}


def _p20_first_diff(outs, refs, n_new=None):
    """(request, position) of the first token that differs, or None."""
    for i, (o, r) in enumerate(zip(outs, refs)):
        if n_new is not None:
            r = r[:r.size - NEW_TOKENS + n_new]
        if o.shape != r.shape:
            return i, min(o.size, r.size)
        if not np.array_equal(o, r):
            return i, int(np.argmin(o == r))
    return None


def _p20_compile_counts(group) -> dict:
    rows = group.stats()["controller"]["replicas"]
    return {r: row["compile_count"] for r, row in rows.items()}


def _p20_ttft(group) -> tuple:
    t = group.metrics.snapshot()["ttft_s"] or {}
    return (t.get("p50_s", float("nan")) * 1e3,
            t.get("p99_s", float("nan")) * 1e3)


class _P20Watch:
    """Polls the controller's table: when each replica's first infra
    failure, first revival and first chunk answered after it were seen
    (driver clock, ``P20_POLL_S`` resolution)."""

    def __init__(self, group):
        import threading
        self.group = group
        self.seen: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(P20_POLL_S):
            now = time.monotonic()
            for rank, row in self.group.controller.snapshot()[
                    "replicas"].items():
                rec = self.seen.setdefault(rank, {})
                if row["infra_failures"] and "fail" not in rec:
                    rec["fail"] = now
                if row["revivals"] and "revived" not in rec:
                    rec["revived"] = now
                    rec["chunks_at_revive"] = row["completed_chunks"]
                if "revived" in rec and "answered" not in rec \
                        and row["completed_chunks"] > rec[
                            "chunks_at_revive"]:
                    rec["answered"] = now

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=10)
        return {r: {"death_to_revived_s": rec["revived"] - rec["fail"],
                    "death_to_first_chunk_s": rec["answered"] - rec["fail"]}
                for r, rec in self.seen.items()
                if {"fail", "revived", "answered"} <= set(rec)}


def phase_tier_bf16(ph: Phases, seed: int, ref: dict):
    """20a: ``ServeReplicas(num_replicas=2)`` of bf16 engines serving
    phase 3's 17 requests in one chunk size (each replica's engine
    batches its share at once, as 3a's engine did), then a second small
    wave for the compile counts."""
    from ray_lightning_accelerators_tpu_torch.runtime.actors import Worker
    from ray_lightning_accelerators_tpu_torch.serve import ServeReplicas
    reqs = _requests(seed)
    w = Worker(99)
    try:
        cuda = w.execute(_p20_cuda_state).result(timeout=120)
    finally:
        w.shutdown()
    ph.check(cuda == (False, False),
             f"20a: a worker forked from the forkserver: CUDA initialised "
             f"{cuda[0]}, in a bad fork {cuda[1]} (the forkserver holds no "
             "CUDA context)")
    t0 = time.perf_counter()
    group = ServeReplicas(_p20_factory(seed, False), num_replicas=2,
                          chunk_size=len(reqs))
    start_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        resps = [group.submit(p, NEW_TOKENS) for p in reqs]
        outs = [r.result(timeout=600) for r in resps]
        wall = time.perf_counter() - t0
        ttft = _p20_ttft(group)
        # each replica engine's own view of the wave: its decode steps
        # and their host-clock p50 / p99, its busy window
        engines = {}
        for w in group.pool.workers:
            es = group.replica_stats(w.rank)
            engines[w.rank] = {
                "completed": es["completed"], "steps": es["steps"],
                "busy_s": es["busy_s"],
                "decode_step_p50_ms": es["decode_step_s"]["p50_s"] * 1e3,
                "decode_step_p99_ms": es["decode_step_s"]["p99_s"] * 1e3}
        before = _p20_compile_counts(group)
        extra = [group.submit(p, 8) for p in _requests(seed + 1)[:4]]
        extra_ok = all(r.result(timeout=600).shape == (PROMPT + 8,)
                       for r in extra)
        after = _p20_compile_counts(group)
        launches = _p20_launches(group)
        st = group.stats()
    finally:
        group.shutdown()
    diff = _p20_first_diff(outs, ref["tokens"])
    ph.check(diff is None and st["completed"] == len(reqs) + 4
             and st["failed"] == 0,
             f"20a: {st['completed']} requests completed, the 17 token-"
             f"identical to 3a's engine (first difference: {diff})")
    ph.check(all(c["rms_norm"] > 0 for c in launches.values())
             and len(launches) == 2,
             "20a: K1 rms_norm launches in each replica "
             + str({r: c["rms_norm"] for r, c in launches.items()}))
    ph.check(extra_ok and before == after and None not in before.values(),
             f"20a: compile counts {before} before the last wave, {after} "
             "after it")
    tok = len(reqs) * NEW_TOKENS
    return {"start_s": start_s, "wall_s": wall, "tokens_per_s": tok / wall,
            "engine_tokens_per_s": tok / ref["wall_s"],
            "ttft_p50_ms": ttft[0], "ttft_p99_ms": ttft[1],
            "launches": launches, "compile_counts": after,
            "prefix_route_hits": st["prefix_route_hits"],
            "engines": engines,
            "engine_steps": ref["stats"]["steps"],
            "engine_decode_step_p50_ms": ref["decode_step_p50_ms"],
            "engine_decode_step_p99_ms": ref["decode_step_p99_ms"],
            "first_diff": diff}


def phase_tier_chaos(ph: Phases, seed: int, ref: dict, root: str):
    """20b: two int8 replicas, ``crash@replica0:chunk2:once`` and
    ``hang@replica1:chunk2:once``, a forced SLO burn (TTFT target 0.1 ms)
    and ``max_replicas=3``, set up as the JAX package's acceptance test
    (tests/test_serve_resilience.py:583), with 16c's wedge timeout and
    the replicas' prefill quantum 8 blocks under decode too (3b's
    chunks, so the tokens can be held to 3b's): waves until both
    revive, load until one scale-up, a wave for the compile counts, then
    idle until the drain."""
    import shutil
    import threading
    from ray_lightning_accelerators_tpu_torch.serve import (
        ControllerConfig, QueueFull, ServeReplicas, SloPolicy)
    reqs = _requests(seed)
    ns = os.path.join(root, "chaos-ns")
    shutil.rmtree(ns, ignore_errors=True)
    # int8 greedy tokens depend on where the prefill's chunks fall: 3b
    # prefilled the 400-token prompt in 128-token chunks (8 blocks), and
    # beside a decoding partner the default 1-block quantum gives other
    # chunks and, at its 14th new token, another token.  A prefill quantum
    # of 8 blocks under decode too holds every replica to 3b's chunks
    # whatever runs beside it, as 20a and 20c hold theirs
    hb = {"RLA_TPU_WORKER_HEARTBEAT_S": P20_HB, "RLA_TPU_SLO_WINDOW_S": "3",
          "RLA_TPU_SERVE_CHUNK_MIN_BLOCKS": "8"}
    envs = [dict(hb, RLA_TPU_CHAOS="crash@replica0:chunk2:once",
                 RLA_TPU_CHAOS_NS=ns),
            dict(hb, RLA_TPU_CHAOS="hang@replica1:chunk2:once",
                 RLA_TPU_CHAOS_NS=ns)]
    cfg = ControllerConfig(
        max_retries=4, retry_backoff_s=0.01, retry_backoff_cap_s=0.1,
        revive_backoff_s=0.2, revive_backoff_cap_s=1.0,
        max_replicas=3, min_replicas=2, scale_up_burn=1.0,
        occupancy_high=0.95, scale_sustain_s=0.4, idle_sustain_s=3.0,
        burn_stale_s=2.0, hedge_age_s=P20B_HEDGE_AGE_S, poll_s=0.05)
    group = ServeReplicas(
        _p20_factory(seed, True, slo=SloPolicy(ttft_target_s=1e-4)),
        num_replicas=2, chunk_size=2, heartbeat_s=float(P20_HB),
        wedge_timeout_s=P20B_WEDGE_S, queue_depth=64, env_per_worker=envs,
        controller=cfg, scale_env=dict(hb))
    watch = _P20Watch(group)
    state = {"next": 0, "checked": 0, "diff": None}
    stop_feed = threading.Event()
    feeder = None

    def wave(n=P20B_WAVE):
        idx = [(state["next"] + j) % len(reqs) for j in range(n)]
        state["next"] += n
        hs = [group.submit(reqs[i], P20B_NEW) for i in idx]
        outs = [h.result(timeout=600) for h in hs]
        d = _p20_first_diff(outs, [ref["tokens"][i] for i in idx], P20B_NEW)
        if d is not None and state["diff"] is None:
            state["diff"] = (idx[d[0]], d[1])
        state["checked"] += n

    try:
        t0 = time.perf_counter()
        deadline = time.monotonic() + P20B_HEAL_S
        while time.monotonic() < deadline \
                and group.metrics.snapshot()["revived"] < 2:
            wave()
        heal_s = time.perf_counter() - t0
        snap = group.stats()
        rows = snap["controller"]["replicas"]
        ph.check(snap["revived"] >= 2 and rows["0"]["revivals"] >= 1
                 and rows["1"]["revivals"] >= 1
                 and rows["0"]["infra_failures"] >= 1
                 and rows["1"]["infra_failures"] >= 1
                 and snap["wedge_events"] >= 1 and snap["requeued"] >= 1,
                 f"20b: the crash and the hang fired (infra failures "
                 f"{rows['0']['infra_failures']} / "
                 f"{rows['1']['infra_failures']}, wedge events "
                 f"{snap['wedge_events']}, requeued {snap['requeued']}) and "
                 f"both replicas revived through the breaker (revivals "
                 f"{rows['0']['revivals']} / {rows['1']['revivals']}) in "
                 f"{heal_s:.1f} s of waves")
        feed_handles = []

        def feed():
            while not stop_feed.is_set():
                try:
                    feed_handles.append(group.submit(reqs[1], P20B_NEW))
                except QueueFull:
                    pass
                except Exception:
                    return
                time.sleep(0.15)

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        t0 = time.perf_counter()
        deadline = time.monotonic() + P20B_SCALE_S
        while time.monotonic() < deadline \
                and group.metrics.snapshot()["scale_ups"] < 1:
            wave()
        scale_s = time.perf_counter() - t0
        ph.check(group.metrics.snapshot()["scale_ups"] >= 1
                 and len(group.pool) == 3
                 and group.stats()["controller"]["max_burn"] >= 1.0,
                 f"20b: the forced burn scaled the tier up to "
                 f"{len(group.pool)} replicas in {scale_s:.1f} s")
        before = _p20_compile_counts(group)
        wave()
        after = _p20_compile_counts(group)
        stop_feed.set()
        feeder.join(timeout=30)
        feed_ref = ref["tokens"][1][:PROMPT + P20B_NEW]
        feed_ok = all(np.array_equal(h.result(timeout=600), feed_ref)
                      for h in feed_handles)
        t0 = time.perf_counter()
        deadline = time.monotonic() + P20B_DRAIN_S
        while time.monotonic() < deadline and len(group.pool) != 2:
            time.sleep(0.2)
        drain_s = time.perf_counter() - t0
        launches = _p20_launches(group)
        revive = watch.stop()
        st = group.stats()
        reaped = list(group.watchdog.reaped) if group.watchdog else []
    finally:
        stop_feed.set()
        if feeder is not None:
            feeder.join(timeout=30)
        watch.stop()
        group.shutdown()
    ph.check(st["scale_downs"] >= 1 and len(group.pool) == 2
             and sorted(w.rank for w in group.pool.workers) == [0, 1],
             f"20b: drained back to ranks "
             f"{sorted(w.rank for w in group.pool.workers)} "
             f"({st['scale_downs']} scale-down) {drain_s:.1f} s after the "
             "load stopped")
    ph.check(state["diff"] is None and feed_ok
             and st["completed"] == st["submitted"] and st["failed"] == 0
             and st["cancelled"] == 0,
             f"20b: {st['submitted']} submitted, {st['completed']} "
             f"completed, {st['failed']} failed, {st['cancelled']} "
             f"cancelled; {state['checked']} wave requests and "
             f"{len(feed_handles)} feed requests token-identical to 3b's "
             f"first {P20B_NEW} tokens (first difference: {state['diff']})")
    ph.check(before == after and None not in after.values(),
             f"20b: compile counts {before} before a wave, {after} after")
    q8 = {r: (c["int8_matmul"], c["int8_matmul_nt"])
          for r, c in launches.items()}
    ph.check(any(a > 0 and b > 0 for a, b in q8.values()),
             f"20b: K5 / K6 launches in the surviving replicas {q8}")
    hang_detect = [d.get("beat_age_s") for d in reaped]
    return {"heal_s": heal_s, "scale_up_s": scale_s, "drain_s": drain_s,
            "revive": revive, "hang_detect_beat_age_s": hang_detect,
            "hedged": st["hedged"], "hedge_wins": st["hedge_wins"],
            "requeued": st["requeued"], "submitted": st["submitted"],
            "launches": launches, "compile_counts": after}


def phase_tier_lanes(ph: Phases, seed: int, ref: dict):
    """20c: ``prefill_replicas=1`` of 2 (bf16): every request prefills on
    the prefill lane and decodes from its KV blocks on the decode lane,
    in batches that /dev/shm holds (as 3g).  A prefill replica never
    decodes, so it streams the 400-token prompt in the engine's idle
    128-token chunks where 3a's busy engine took 16-token ones; bf16
    rounds the two schedules differently, so that prompt is held to an
    in-process engine serving it alone (the same idle schedule), the 16
    others to 3a."""
    from ray_lightning_accelerators_tpu_torch.runtime import object_store
    from ray_lightning_accelerators_tpu_torch.serve import (
        ControllerConfig, ServeEngine, ServeReplicas)
    reqs = _requests(seed)
    long_i = SLOTS // 2
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    model = GPT(TransformerConfig(**CFG), device=DEV,
                compute_dtype=torch.bfloat16)
    params = _cast_floats(model.init_params(seed=seed), torch.bfloat16)
    with ServeEngine(model, params, max_slots=SLOTS, block_len=BLOCK_LEN,
                     max_total_len=MAX_TOTAL) as eng:
        alone = eng.submit(reqs[long_i], NEW_TOKENS).result(timeout=600)
    del model, params
    torch.cuda.empty_cache()
    refs = list(ref["tokens"])
    refs[long_i] = alone
    # k + v of one block: 2 x layers x heads x block_len x head_dim, bf16
    per_block = 2 * CFG["n_layers"] * CFG["d_model"] * BLOCK_LEN * 2
    shm = os.statvfs("/dev/shm")
    shm_free = shm.f_bavail * shm.f_frsize
    most = -(-LONG_PROMPT // BLOCK_LEN) * per_block
    batch = max(1, min(len(reqs), int(shm_free // (2 * most))))
    env = {"RLA_TPU_TELEMETRY_EVENTS": "8192"}
    group = ServeReplicas(_p20_factory(seed, False), num_replicas=2,
                          chunk_size=batch, env_per_worker=[env, env],
                          controller=ControllerConfig(prefill_replicas=1))
    pids = {w.pid for w in group.pool.workers}
    try:
        t0 = time.perf_counter()
        outs = []
        for b0 in range(0, len(reqs), batch):
            hs = [group.submit(p, NEW_TOKENS) for p in reqs[b0:b0 + batch]]
            outs += [h.result(timeout=600) for h in hs]
        wall = time.perf_counter() - t0
        ttft = _p20_ttft(group)
        events = [e for w in group.pool.workers
                  for e in w.execute(_p20_events).result(timeout=120)]
        st = group.stats()
        lanes = {r: row["lane"]
                 for r, row in st["controller"]["replicas"].items()}
    finally:
        group.shutdown()
    leaked = {p: object_store.segments_of(p) for p in pids}
    diff = _p20_first_diff(outs, refs)
    ph.check(diff is None and st["completed"] == st["submitted"] == len(reqs)
             and st["failed"] == 0,
             f"20c: {st['completed']}/{len(reqs)} requests through the "
             f"lanes {lanes} token-identical (first difference: {diff}; "
             f"batches of {batch}, /dev/shm free "
             f"{shm_free / 2 ** 20:.0f} MiB)")
    ph.check(st["kv_handoffs"] == len(reqs) and st["kv_handoff_bytes"] > 0,
             f"20c: kv_handoffs={st['kv_handoffs']} for {len(reqs)} "
             f"requests, kv_handoff_bytes={st['kv_handoff_bytes']}")
    ph.check(st["prefix_route_hits"] > 0,
             f"20c: prefix_route_hits={st['prefix_route_hits']}, "
             f"misses={st['prefix_route_misses']}")
    ph.check(not any(leaked.values()),
             f"20c: no shm segment of the replicas left after shutdown "
             f"{ {p: len(v) for p, v in leaked.items()} }")
    by = {}
    for e in events:
        by.setdefault(e["trace"], {})[e["kind"]] = e["ts"]
    export_ms = [(v["serve_kv_export"] - v["serve_prefill"]) * 1e3
                 for v in by.values()
                 if {"serve_prefill", "serve_kv_export"} <= set(v)]
    hop_ms = [(v["serve_kv_import"] - v["serve_kv_export"]) * 1e3
              for v in by.values()
              if {"serve_kv_export", "serve_kv_import"} <= set(v)]
    return {"wall_s": wall, "batch": batch,
            "tokens_per_s": len(reqs) * NEW_TOKENS / wall,
            "ttft_p50_ms": ttft[0], "ttft_p99_ms": ttft[1],
            "kv_handoffs": st["kv_handoffs"],
            "kv_handoff_bytes": st["kv_handoff_bytes"],
            "prefix_route_hits": st["prefix_route_hits"],
            "export_ms_median": (float(np.median(export_ms))
                                 if export_ms else None),
            "export_to_import_ms_median": (float(np.median(hop_ms))
                                           if hop_ms else None),
            "handoffs_timed": len(hop_ms), "first_diff": diff}


def phase_tier(ph: Phases, seed: int, serve: dict):
    """20: the serving tier.  Measurement lines, not limits: the tier's
    tokens/s beside 3a's engine alone, TTFT p50 / p99, death to a
    revived replica's first answered chunk, the hang's staleness at its
    reap, the hedges, the handoff's ms a request and phase 20's
    seconds."""
    t0 = time.perf_counter()
    root = os.path.join(HERE, "build", "chip_smoke_p20")
    os.makedirs(root, exist_ok=True)
    out = {}
    ref_bf16, ref_int8 = serve.get("bf16"), serve.get("int8")
    if not ref_bf16 or not ref_int8:
        ph.check(False, "20: phases 3a and 3b gave no tokens to hold the "
                        "tier to")
        return out
    for key, fn, args in (("bf16", phase_tier_bf16, (ref_bf16,)),
                          ("chaos_int8", phase_tier_chaos,
                           (ref_int8, root)),
                          ("lanes", phase_tier_lanes, (ref_bf16,))):
        log(f"  -- 20{'abc'[len(out)]}")
        try:
            out[key] = fn(ph, seed, *args)
        except Exception:
            ph.check(False, f"20 {key} raised:\n{traceback.format_exc()}")
    out["phase_s"] = time.perf_counter() - t0
    smi = nvidia_smi_line()
    a, b, c = out.get("bf16"), out.get("chaos_int8"), out.get("lanes")
    if a:
        log(f"  20a [{smi}]: tier of 2 replicas {a['tokens_per_s']:.1f} "
            f"tok/s vs one in-process engine (3a) "
            f"{a['engine_tokens_per_s']:.1f} tok/s on the same 17 requests; "
            f"TTFT p50 {a['ttft_p50_ms']:.1f} / p99 {a['ttft_p99_ms']:.1f} "
            f"ms; tier start {a['start_s']:.2f} s")
        log(f"  20a [{smi}]: "
            + "; ".join(f"replica {r}: {e['completed']} requests, "
                        f"{e['steps']} decode steps p50 / p99 "
                        f"{e['decode_step_p50_ms']:.2f} / "
                        f"{e['decode_step_p99_ms']:.2f} ms, busy "
                        f"{e['busy_s']:.2f} s"
                        for r, e in sorted(a["engines"].items()))
            + f"; 3a's engine {a['engine_steps']} steps p50 / p99 "
              f"{a['engine_decode_step_p50_ms']:.2f} / "
              f"{a['engine_decode_step_p99_ms']:.2f} ms")
    if b:
        log(f"  20b [{smi}]: death to a revived replica's first chunk "
            + ", ".join(f"replica {r} {v['death_to_first_chunk_s']:.3f} s "
                        f"(revived after {v['death_to_revived_s']:.3f} s)"
                        for r, v in sorted(b["revive"].items()))
            + f"; hang detected at a heartbeat "
              f"{b['hang_detect_beat_age_s']} s stale; hedges "
              f"{b['hedged']} (won {b['hedge_wins']}); requeued "
              f"{b['requeued']}; scale-up after {b['scale_up_s']:.1f} s "
              f"of load, drain {b['drain_s']:.1f} s after it")
    if c:
        log(f"  20c [{smi}]: lanes {c['tokens_per_s']:.1f} tok/s; TTFT "
            f"p50 {c['ttft_p50_ms']:.1f} / p99 {c['ttft_p99_ms']:.1f} ms; "
            f"{c['kv_handoffs']} handoffs, {c['kv_handoff_bytes']} bytes; "
            f"export {c['export_ms_median']} ms and export -> import "
            f"{c['export_to_import_ms_median']} ms a request (medians over "
            f"{c['handoffs_timed']})")
    log(f"  20 [{smi}]: phase 20 took {out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------------------- #
# phase 21: the analysis layer                                           #
# --------------------------------------------------------------------- #
P21_RANKS = 2
# 21a's fit: 6a's widths at MP_LAYERS, 4 steps of one global batch of 8
# (2 gloo ranks x 4 rows) each way
P21_LAYERS = MP_LAYERS
P21_BATCH, P21_STEPS = 8, 4
# 21b: the watchdog's dispatch deadline and poll
P21_DEADLINE_S, P21_POLL_S = 5.0, 0.1
P21_SPILLS = 50   # spills timed in a rank, at its ring's length


def _p21_sanitizer_stats(rank: int) -> dict:
    """Inside a rank: its sanitizer's count and ring, and the mean ms of
    ``P21_SPILLS`` spills at the ring's present length."""
    from ray_lightning_accelerators_tpu_torch.testing import spmd_sanitizer
    san = spmd_sanitizer.get_sanitizer()
    if san is None:
        return {"installed": False}
    t0 = time.perf_counter()
    for _ in range(P21_SPILLS):
        san.spill()
    ms = (time.perf_counter() - t0) * 1e3 / P21_SPILLS
    snap = san.snapshot()
    return {"installed": True, "n": snap["n"], "ring": len(snap["events"]),
            "record_ms": san.record_s * 1e3, "spill_ms": ms,
            "spill_bytes": os.path.getsize(san.spill_path)
            if san.spill_path else None}


def _p21_toggle(rank: int, on: bool) -> bool:
    """Inside a rank: install the sanitizer (a fresh ring, spilling under
    the rank's telemetry dir) or uninstall it; whether it is wrapped."""
    from ray_lightning_accelerators_tpu_torch.testing import spmd_sanitizer
    if on:
        spmd_sanitizer.install(rank=rank)
    else:
        spmd_sanitizer.uninstall()
    import torch.distributed as dist
    return bool(getattr(dist.all_reduce, "_rla_spmd_wrapped", False))


def _p21_records_per_step(snap: dict, steps: int) -> dict:
    """The records a step of a rank's spill, by op and axes."""
    out: dict = {}
    for e in snap.get("events", []):
        key = f"{e['op']}[{','.join(e['axes'])}]"
        out[key] = out.get(key, 0) + 1
    return {k: v / steps for k, v in sorted(out.items())}


def phase_sanitized_fit(ph: Phases, seed: int, tdir: str):
    """21a: 6a's GPT at ``P21_LAYERS`` over ``P21_RANKS`` gloo ranks
    sharing the card, with ``RLA_TPU_SPMD_SANITIZER=1`` and a telemetry
    dir in the world's environment, so each rank installs the sanitizer
    at boot.  In one world: a one-step warm-up fit with the ranks'
    sanitizer uninstalled (not counted), then ``P21_STEPS``-step fits in
    turns off, on, on, off (the sanitizer installed again in the ranks,
    and the knob set in the driver, for the two "on" fits, so the
    driver's seam ``Trainer._run_in_world`` checks them).  Checks: K1 /
    K2 / K4 launches a step on each rank in every fit; the seam and
    ``check_collective_sequences`` find the ranks' sequences equal after
    each "on" fit; step 1's loss bitwise equal in all four (the sanitizer
    only observes; K4 adds dq by atomics, so later steps may differ in
    their last bits between any two fits: they are held to 9b's 1e-2 and
    their bitwise count is printed).  Prints the records a step by op
    and axes, the ms a step the ranks spent recording them (spills
    included), a spill's ms at the ring's length and the warm step ms
    (steps 2 on) of each fit and both ways."""
    import functools
    from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
        DistributedWorld)
    from ray_lightning_accelerators_tpu_torch.testing import spmd_sanitizer
    cfg_dict = dict(TRAIN_CFG, n_layers=P21_LAYERS)
    L = cfg_dict["n_layers"]
    tokens = _pattern_tokens(P21_BATCH, cfg_dict["max_seq_len"],
                             cfg_dict["vocab_size"], seed + 21)
    env = {spmd_sanitizer.SANITIZER_ENV: "1", "RLA_TPU_TELEMETRY_DIR": tdir}
    saved = {k: os.environ.get(k) for k in env}
    dev = "cuda:0" if DEV.startswith("cuda") else DEV
    gc.collect()
    torch.cuda.empty_cache()
    order = ("off", "on", "on", "off")
    runs, checks, wrapped = [], [], {}
    os.environ.update(env)
    try:
        world = DistributedWorld(P21_RANKS, devices=[dev] * P21_RANKS,
                                 backend="gloo")
        try:
            at_boot = world.run(_p21_sanitizer_stats)

            def toggle(on: bool):
                wrapped[on] = world.run(functools.partial(_p21_toggle,
                                                          on=on))
                if on:
                    os.environ[spmd_sanitizer.SANITIZER_ENV] = "1"
                else:
                    os.environ.pop(spmd_sanitizer.SANITIZER_ENV, None)

            def fit(steps: int):
                return _mp_fit(cfg_dict, tokens, seed, world,
                               _SharedCardAccelerator(P21_RANKS),
                               steps=steps)

            toggle(False)
            fit(1)  # warm-up: the ranks' first step, off the comparison
            for i, how in enumerate(order):
                if i == 0 or how != order[i - 1]:
                    toggle(how == "on")
                runs.append((how, fit(P21_STEPS)))
                if how == "on":
                    snaps = spmd_sanitizer.gather_sequences(tdir)
                    checks.append((spmd_sanitizer.check_collective_sequences(
                        tdir, raise_on_mismatch=False), sorted(snaps)))
                    if len(checks) == 1:
                        first_on = snaps
                        stats = world.run(_p21_sanitizer_stats)
        finally:
            procs = ([w._proc for w in world.pool.workers]
                     if world.pool else [])
            world.shutdown()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ph.check(not any(p.is_alive() for p in procs),
             "21a: no rank outlives the world's shutdown")
    ph.check(all(s.get("installed") for s in at_boot)
             and wrapped == {False: [False] * P21_RANKS,
                             True: [True] * P21_RANKS},
             f"21a: the sanitizer installed at boot on every rank "
             f"{[s.get('installed') for s in at_boot]}; wrapped after "
             f"install / uninstall {wrapped}")
    want = {"rms_norm": 2 * L + 1, "flash_forward": L,
            "flash_backward_fused": L}
    out = {"order": list(order), "fits": []}
    for i, (how, (t, _, clock, loss, wall)) in enumerate(runs):
        by_rank = t.rank_report.get("launches_by_rank", [])
        per_step = [{k: r.get(k, 0) / P21_STEPS for k in want}
                    for r in by_rank]
        ph.check(len(by_rank) == P21_RANKS
                 and all(p == want for p in per_step),
                 f"21a fit {i + 1} (sanitizer {how}): kernel launches a "
                 f"step on each rank {per_step} (want K1 "
                 f"{want['rms_norm']}, K2 {L}, K4 {L})")
        step_ms = [(clock.t[j] - clock.t[j - 1]) * 1e3
                   for j in range(1, len(clock.t))]
        out["fits"].append({"sanitizer": how, "loss": loss,
                            "step_ms": step_ms, "wall_s": wall,
                            "launches_by_rank": by_rank})
    losses = [f["loss"] for f in out["fits"]]
    ons = [f["loss"] for f in out["fits"] if f["sanitizer"] == "on"]
    offs = [f["loss"] for f in out["fits"] if f["sanitizer"] == "off"]
    pairs = [(a, b) for a in ons for b in offs]
    bitwise = [sum(x == y for x, y in zip(a, b)) for a, b in pairs]
    rel = max(abs(x - y) / abs(y) for a, b in pairs for x, y in zip(a, b))
    ph.check(all(len(l) == P21_STEPS for l in losses)
             and len({l[0] for l in losses}) == 1 and rel <= 1e-2,
             f"21a: step 1's loss bitwise equal in all {len(losses)} fits "
             f"({losses[0][0]!r}); steps bitwise on vs off {bitwise} of "
             f"{P21_STEPS} a pair; max rel {rel:.3e} (limit 1e-2: K4's "
             f"atomic dq); losses {losses}")
    ph.check(all(m is None and labels == ["rank0", "rank1"]
                 for m, labels in checks) and len(checks) == 2,
             f"21a: check_collective_sequences after each 'on' fit -> "
             f"{[repr(m) for m, _ in checks]} over {[l for _, l in checks]}")
    records = _p21_records_per_step(first_on["rank0"], P21_STEPS)
    warm = {how: [float(np.mean(f["step_ms"][1:])) for f in out["fits"]
                  if f["sanitizer"] == how] for how in ("on", "off")}
    warm_on, warm_off = float(np.mean(warm["on"])), float(np.mean(warm["off"]))
    out.update(records_per_step=records,
               records=[s["n"] for s in stats],
               record_ms_per_step=[s["record_ms"] / P21_STEPS
                                   for s in stats],
               spill_ms=[s["spill_ms"] for s in stats],
               spill_bytes=[s["spill_bytes"] for s in stats],
               warm_step_ms=warm, warm_step_ms_on=warm_on,
               warm_step_ms_off=warm_off, losses_bitwise=bitwise)
    by_fit = [(f["sanitizer"], round(float(np.mean(f["step_ms"][1:])), 2))
              for f in out["fits"]]
    log(f"  21a: records a step (rank 0's first 'on' fit, by op[axes]) "
        f"{json.dumps(records)}; {out['records']} records on ranks 0 / 1 "
        f"over its {P21_STEPS} steps, recording them (spills included) "
        f"{[round(x, 4) for x in out['record_ms_per_step']]} ms a step; "
        f"a spill {[round(x, 4) for x in out['spill_ms']]} ms "
        f"({out['spill_bytes']} bytes); warm step ms (steps 2-"
        f"{P21_STEPS}) by fit in turns {by_fit}: on {warm_on:.2f}, off "
        f"{warm_off:.2f} ({(warm_on / warm_off - 1) * 100:+.2f}%)")
    return out


def _p21_warm(rank: int, dev: str) -> int:
    """A worker's CUDA context, off 21b's clock."""
    return int(torch.ones(1, device=dev).sum().item())


def _p21_divergent_then_block(rank: int, coordinator: str, dev: str) -> int:
    """21b's body: a gloo world of 2 over CUDA tensors, one all_reduce on
    both ranks, then one more on rank 1 alone, which blocks (rank 0
    never joins)."""
    import datetime

    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    t = torch.ones(1024, device=dev)
    dist.all_reduce(t)
    if rank == 1:
        dist.all_reduce(t)  # the rank-divergent collective
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return rank


def phase_divergent_wedge(ph: Phases, seed: int, tdir: str):
    """21b: a rank-divergent collective on the card.  Two workers with
    the sanitizer and a telemetry dir in their env, each on cuda:0; the
    body forms a gloo world of 2 over CUDA tensors and rank 1 issues one
    ``all_reduce`` more than rank 0, which blocks.  ``ElasticRunner``
    with ``dispatch_deadline_s=P21_DEADLINE_S`` reaps the wedge and
    raises ``CollectiveMismatch`` after one attempt, its diagnosis naming
    call #1: rank 1's ``all_reduce`` and no call on rank 0.  Prints the
    seconds from the dispatch to the typed raise."""
    from ray_lightning_accelerators_tpu_torch.runtime.actors import (
        ActorPool)
    from ray_lightning_accelerators_tpu_torch.runtime.bootstrap import (
        pick_coordinator_address)
    from ray_lightning_accelerators_tpu_torch.runtime.elastic import (
        ElasticRunner)
    from ray_lightning_accelerators_tpu_torch.testing import spmd_sanitizer
    env = {spmd_sanitizer.SANITIZER_ENV: "1", "RLA_TPU_TELEMETRY_DIR": tdir}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)  # the parent's sequence checker reads the same knobs
    pool = ActorPool(2, env_per_worker=[
        dict(env, RLA_TPU_WORKER_HEARTBEAT_S="0.1") for _ in range(2)])
    dev = "cuda:0" if DEV.startswith("cuda") else DEV
    err = None
    try:
        for f in pool.execute_per_worker(_p21_warm, [(r, dev)
                                                     for r in range(2)]):
            f.result(timeout=300)
        runner = ElasticRunner(pool, max_failures=2,
                               dispatch_deadline_s=P21_DEADLINE_S,
                               watchdog_poll_s=P21_POLL_S)
        coord = pick_coordinator_address()
        t0 = time.monotonic()
        try:
            runner.run(_p21_divergent_then_block,
                       args_per_worker=lambda a: [(r, coord, dev)
                                                  for r in range(2)])
        except spmd_sanitizer.CollectiveMismatch as e:
            err = e
        detect_s = time.monotonic() - t0
    finally:
        pool.kill()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    diag = getattr(err, "diagnosis", {}) or {}
    per_rank = diag.get("per_rank") or {}
    r1 = per_rank.get("rank1") or {}
    ph.check(err is not None and diag.get("first_divergence") == 1
             and per_rank.get("rank0", "missing") is None
             and r1.get("op") == "all_reduce"
             and r1.get("dtype") == "float32" and r1.get("shape") == [1024]
             and runner.attempts_used == 1,
             f"21b: CollectiveMismatch after {runner.attempts_used} "
             f"attempt(s), {detect_s:.2f} s after the dispatch: "
             f"{str(err)[:300] if err is not None else None}")
    log(f"  21b: dispatch -> typed raise {detect_s:.3f} s (dispatch "
        f"deadline {P21_DEADLINE_S} s, watchdog poll {P21_POLL_S} s); "
        f"the reaped wedge "
        f"{json.dumps(runner.wedge_events, default=str)[:400]}")
    return {"detect_s": detect_s, "attempts": runner.attempts_used,
            "diagnosis": diag, "wedge_events": runner.wedge_events}


class _P21WarmGuard(_Callback):
    """21c: ``assert_no_new_compiles`` from the end of the first step to
    the end of the fit (the warm steps)."""

    def __init__(self):
        self.guard = None
        self.window_start = None

    def on_train_batch_end(self, trainer, module, metrics, batch_idx):
        if self.guard is None:
            from ray_lightning_accelerators_tpu_torch.analysis.compile_guard \
                import assert_no_new_compiles, compile_count
            self.window_start = compile_count()
            self.guard = assert_no_new_compiles(label="21c 6a warm steps")
            self.guard.__enter__()

    def on_fit_end(self, trainer, module):
        self.guard.__exit__(None, None, None)


def phase_compile_guard(ph: Phases, seed: int):
    """21c: ``assert_no_new_compiles`` around 6a's warm steps (6a's
    config, 4 steps in process: the guard from the end of step 1) and
    around a warm 3a engine's decode (phase 3's engine on phase 3's bf16
    weights from the seed, warmed by one request, then 4 of phase 3's
    requests); 0 builds in each.  Prints a ``compile_count_record``
    line."""
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.analysis.compile_guard import (
        compile_count, compile_count_record, compile_guard)
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    from ray_lightning_accelerators_tpu_torch.serve import ServeEngine
    start = compile_count()
    cfg = TransformerConfig(**TRAIN_CFG)
    guard = _P21WarmGuard()
    trainer = Trainer(max_steps=4, device=DEV, precision="bf16",
                      log_every_n_steps=10 ** 9, seed=seed,
                      enable_checkpointing=False, callbacks=[guard])
    data = _pattern_tokens(4 * TRAIN_BATCH, cfg.max_seq_len,
                           cfg.vocab_size, seed + 213)
    trainer.fit(GPT(cfg, device=DEV, lr=3e-4),
                DataLoader(ArrayDataset(data), batch_size=TRAIN_BATCH))
    sync()
    ph.check(trainer.global_step == 4 and guard.guard.new_compiles == 0,
             f"21c: 6a's warm steps 2-4: {guard.guard.new_compiles} new "
             f"builds (assert_no_new_compiles)")
    del trainer
    model = GPT(TransformerConfig(**CFG), device=DEV,
                compute_dtype=torch.bfloat16)
    params = _cast_floats(model.init_params(seed=seed), torch.bfloat16)
    reqs = _requests(seed)
    with ServeEngine(model, params, max_slots=SLOTS, block_len=BLOCK_LEN,
                     max_total_len=MAX_TOTAL) as eng:
        eng.submit(reqs[1], 4).result(timeout=600)
        sync()
        window = compile_count()
        with compile_guard(max_new_compiles=0,
                           label="21c warm 3a decode") as g:
            outs = [r.result(timeout=600) for r in
                    [eng.submit(p, NEW_TOKENS) for p in reqs[:4]]]
            sync()
    ph.check(g.new_compiles == 0 and len(outs) == 4,
             f"21c: the warm 3a engine's decode of 4 requests: "
             f"{g.new_compiles} new builds")
    rec = compile_count_record("chip_smoke 21c", window_start=window)
    log(json.dumps(rec, sort_keys=True))
    return {"trainer_warm_builds": guard.guard.new_compiles,
            "engine_warm_builds": g.new_compiles, "record": rec,
            "builds_in_phase": compile_count() - start}


def phase_graftlint(ph: Phases, seed: int):
    """21d: ``scripts/torch_graftlint.py --format json`` over the port's
    tree in a fresh process: exit 0, 0 active findings, every pragma with
    its reason.  Prints the seconds it took and the suppressed findings by
    rule."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "scripts", "torch_graftlint.py"),
         "--format", "json"], capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    try:
        payload = json.loads(proc.stdout)
    except ValueError:
        payload = {}
    rules: dict = {}
    for f in payload.get("findings", []):
        rules[f["rule"]] = rules.get(f["rule"], 0) + 1
    ph.check(proc.returncode == 0 and payload.get("active") == 0
             and "pragma" not in rules,
             f"21d: torch_graftlint exit {proc.returncode}, "
             f"{payload.get('active')} active findings, "
             f"{payload.get('suppressed')} suppressed by a reasoned pragma "
             f"{json.dumps(rules, sort_keys=True)}; {proc.stderr[-300:]}")
    log(f"  21d: torch_graftlint over the port's tree in {secs:.2f} s")
    return {"seconds": secs, "active": payload.get("active"),
            "suppressed_by_rule": rules}


def phase_analysis(ph: Phases, seed: int):
    """21: the analysis layer on the card (21a-21d)."""
    import shutil
    base = os.path.join(HERE, "build", "chip_smoke_p21")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    out = {}
    for tag, fn, args in (
            ("21a", phase_sanitized_fit, (os.path.join(base, "a"),)),
            ("21b", phase_divergent_wedge, (os.path.join(base, "b"),)),
            ("21c", phase_compile_guard, ()),
            ("21d", phase_graftlint, ())):
        try:
            out[tag] = fn(ph, seed, *args)
        except Exception:
            ph.check(False, f"{tag} raised:\n{traceback.format_exc()}")
    out["phase_s"] = time.perf_counter() - t0
    shutil.rmtree(base, ignore_errors=True)
    log(f"  21 [{nvidia_smi_line()}]: phase 21 took {out['phase_s']:.1f} s")
    return out


def nvidia_smi_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except Exception as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


# --------------------------------------------------------------------- #
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import ray_lightning_accelerators_tpu_torch as port
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        print(f"chip_smoke: imported the port from {port.__file__}, not "
              f"from the checkout beside this script", file=sys.stderr)
        return 2
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"chip_smoke: torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} seed {args.seed}")
    ph = Phases()
    ph.run("phase 1: build", phase_build, ph)
    rows = ph.run("phase 2: kernels vs plain versions", phase_kernels, ph,
                  args.seed) or []
    rows += ph.run("phase 2b: K2 flash attention vs its plain version",
                   phase_flash, ph, args.seed) or []
    rows += ph.run("phase 2c: K3a, K3b and K4 flash backward vs the plain "
                   "version", phase_flash_bwd, ph, args.seed) or []
    rows_ln, ln_path = ph.run("phase 2d: K7 layer_norm vs its plain "
                              "version", phase_layer_norm, ph,
                              args.seed) or ([], {})
    rows += rows_ln

    cfg = TransformerConfig(**CFG)
    model = GPT(cfg, device=DEV, compute_dtype=torch.bfloat16)
    # bf16 storage, as the repo's decode benchmark deploys it; int8
    # weight-only weights quantized from those
    params = _cast_floats(model.init_params(seed=args.seed), torch.bfloat16)
    q8 = GPT.quantize_weights(params)
    serve = {}
    serve["bf16"] = ph.run("phase 3a: serve, bf16 weights", phase_serve, ph,
                           model, params, "bf16", args.seed, False)
    serve["int8"] = ph.run("phase 3b: serve, int8 weights", phase_serve, ph,
                           model, q8, "int8", args.seed, True)
    profiled = ph.run("phase 3c: where a decode step's time goes",
                      phase_profiles, model, params, q8, args.seed) or {}
    gen = {}
    gen["bf16"] = ph.run("phase 3d: generate(), bf16 weights",
                         phase_generate, ph, model, params, "bf16",
                         args.seed, False)
    gen["int8"] = ph.run("phase 3d: generate(), int8 weights",
                         phase_generate, ph, model, q8, "int8", args.seed,
                         True)
    if gen["bf16"] is not None:
        gen["vs_paged"] = ph.run(
            "phase 3d: generate() against the paged engine (measurement)",
            phase_generate_vs_paged, model, params, gen["bf16"]["tokens"],
            args.seed)
    for run in (gen["bf16"], gen["int8"]):
        if run is not None:
            run.pop("tokens")
    dense = ph.run("phase 3e: dense engine (paged=False), bf16 weights",
                   phase_dense_engine, ph, model, params, args.seed)
    window_spec = ph.run("phase 3f: sliding window and speculative decoding",
                         phase_window_spec, ph, cfg, params, args.seed)
    lanes = {}
    lanes["speculative"] = ph.run("phase 3g: the engine's speculative lane",
                                  phase_spec_lane, ph, model, params,
                                  args.seed)
    lanes["handoff_bf16"] = ph.run("phase 3g: KV handoff, bf16 weights",
                                   phase_handoff, ph, model, params, "bf16",
                                   args.seed, False)
    lanes["handoff_int8"] = ph.run("phase 3g: KV handoff, int8 weights",
                                   phase_handoff, ph, model, q8, "int8",
                                   args.seed, True)
    logits = {}
    logits["bf16"] = ph.run("phase 4a: logits vs CPU port, bf16 weights",
                            phase_logits, ph, cfg, params, "bf16", args.seed)
    logits["int8"] = ph.run("phase 4b: logits vs CPU port, int8 weights",
                            phase_logits, ph, cfg, q8, "int8", args.seed)
    logits["prefill"] = ph.run("phase 4c: prefill logits vs CPU port",
                               phase_prefill_logits, ph, cfg, params,
                               args.seed)

    train = {}
    train["bench"] = ph.run("phase 6a: Trainer.fit at the GPT bench config "
                            "(K4 backward)", phase_train, ph, args.seed)
    train["split"] = ph.run("phase 6b: Trainer.fit with 512 key blocks "
                            "(K3a + K3b backward)", phase_train_split, ph,
                            args.seed)
    train["f32_vs_cpu"] = ph.run("phase 6c: f32 training on the card vs "
                                 "the CPU port", phase_train_f32, ph,
                                 args.seed)
    vision = {}
    vision["mnist"] = ph.run("phase 7a: Trainer.fit, the MNIST MLP at the "
                             "bench config", phase_mnist, ph, args.seed)
    vision["resnet18"] = ph.run("phase 7b: Trainer.fit, ResNet-18 at the "
                                "CIFAR bench config", phase_resnet, ph,
                                args.seed)
    vision["vit"] = ph.run("phase 7c: Trainer.fit, ViT at the default "
                           "config", phase_vit, ph, args.seed)
    vision["f32_vs_cpu"] = ph.run("phase 7d: f32 vision training on the "
                                  "card vs the CPU port", phase_vision_f32,
                                  ph, args.seed)

    moe_cfg = TransformerConfig(**MOE_CFG)
    moe_model = GPT(moe_cfg, device=DEV, compute_dtype=torch.bfloat16)
    moe_params = _cast_floats(moe_model.init_params(seed=args.seed),
                              torch.bfloat16)
    moe_q8 = GPT.quantize_weights(moe_params)
    moe = {}
    moe["serve_bf16"] = ph.run("phase 8a: MoE paged serve, bf16 weights",
                               phase_moe_serve, ph, moe_model, moe_params,
                               "moe bf16", args.seed, False)
    moe["serve_int8"] = ph.run("phase 8a: MoE paged serve, int8 weights",
                               phase_moe_serve, ph, moe_model, moe_q8,
                               "moe int8", args.seed, True)
    moe["decode_profile"] = ph.run(
        "phase 8a: where an MoE decode step's time goes", phase_moe_profile,
        moe_model, moe_params, moe_q8, args.seed)
    moe["generate"] = ph.run("phase 8b: MoE generate(), bf16 weights",
                             phase_generate, ph, moe_model, moe_params,
                             "moe bf16", args.seed, False)
    if moe["generate"] is not None:
        moe["generate"].pop("tokens")
    moe["prefill_logits"] = ph.run("phase 8c: MoE prefill logits vs CPU "
                                   "port", phase_moe_prefill_logits, ph,
                                   moe_cfg, moe_params, args.seed)
    del moe_model, moe_params, moe_q8
    moe["train"] = ph.run("phase 8d: MoE Trainer.fit at the GPT bench "
                          "recipe, batch 8", phase_moe_train, ph, args.seed)
    moe["f32_vs_cpu"] = ph.run("phase 8e: f32 MoE training on the card vs "
                               "the CPU port", phase_train_f32, ph,
                               args.seed, dict(F32_CFG, num_experts=4),
                               "8e")
    extras = {}
    extras["remat"] = ph.run("phase 8f: remat at the GPT bench config",
                             phase_remat, ph, args.seed)
    extras["int8"] = ph.run("phase 8f: Trainer(int8_matmul=True) at the GPT "
                            "bench config", phase_int8_train, ph, args.seed,
                            extras["remat"])
    extras["lm_ema"] = ph.run("phase 8g: the streaming LM data path with "
                              "EMA", phase_lm_ema, ph, args.seed)
    dp = {}
    dp["fit"] = ph.run("phase 9a: Trainer(accelerator=RayAccelerator("
                       "num_workers=1)) at the GPT bench config, one rank "
                       "over NCCL", phase_dp_fit, ph, args.seed,
                       train.get("bench"))
    dp["two_ranks"] = ph.run("phase 9b: two gloo ranks on the one card vs "
                             "one step on all rows", phase_dp_two_ranks, ph,
                             args.seed)
    sharded = {}
    sharded["fit"] = ph.run("phase 10a: Trainer(accelerator=RayTPUAccelerator"
                            "(1, use_fsdp=True), grad_compression='int8', "
                            "checkpoint_format='sharded') at the GPT bench "
                            "config, one rank over NCCL", phase_sharded_fit,
                            ph, args.seed, train.get("bench"))
    sharded["two_ranks"] = ph.run("phase 10b: FSDP, FSDP + int8 and ZeRO-1 "
                                  "over two gloo ranks on the one card vs "
                                  "two steps on all rows",
                                  phase_sharded_two_ranks, ph, args.seed)
    model_parallel = ph.run("phase 11: the tensor, sequence (Ulysses, ring) "
                            "and expert axes over two gloo ranks on the one "
                            "card vs three steps on all rows",
                            phase_model_parallel, ph, args.seed)

    two_d = ph.run("phase 12: fsdp x tensor, int8 under tensor, the "
                   "pipeline axis alone, with tensor and under ViT over "
                   "gloo ranks on the one card vs three steps on all rows",
                   phase_2d_and_pipeline, ph, args.seed)

    mpmd = ph.run("phase 13: the MPMD pipeline runner, stage workers on "
                  "the one card (fsdp 2 in 13d) vs in-process runs",
                  phase_mpmd, ph, args.seed)

    tuned = ph.run("phase 14: Tune: thread trials over a rank each, "
                   "process trials and autotune_step", phase_tune, ph,
                   args.seed, train.get("bench"))

    defaults = {}
    defaults["gpt"] = ph.run("phase 15a: 6a's GPT at the Trainer's defaults "
                             "(guard, prefetch 2, cached tokens) and with "
                             "the three off", phase_defaults_gpt, ph,
                             args.seed)
    defaults["mnist"] = ph.run("phase 15b: 7a's MNIST MLP on the whole-epoch "
                               "path, the host path and the old defaults",
                               phase_defaults_mnist, ph, args.seed)
    defaults["guard"] = ph.run("phase 15c: a planted NaN row on the card vs "
                               "the CPU port, quarantine and skip",
                               phase_defaults_guard, ph, args.seed)
    defaults["engine"] = ph.run("phase 15d: the native batch engine vs the "
                                "Python loader at 7a's arrays",
                                phase_defaults_engine, ph, args.seed)
    defaults["ship"] = ph.run("phase 15e: fit -> test -> predict over one "
                              "NCCL rank, the data shipped once",
                              phase_defaults_ship, ph, args.seed)

    faults = {}
    faults["drain"] = ph.run("phase 16a: the preemption drain in process, "
                             "6a's GPT", phase_fault_drain, ph, args.seed)
    faults["restart"] = ph.run("phase 16b: crash and restart of a worker "
                               "under ElasticRunner", phase_fault_restart,
                               ph, args.seed)
    faults["hang"] = ph.run("phase 16c: a hang on the card under "
                            "worker_deadline_s", phase_fault_hang, ph,
                            args.seed)
    faults["rewind"] = ph.run("phase 16d: badbatch rewound by ElasticRunner",
                              phase_fault_rewind, ph, args.seed)
    faults["pipeline"] = ph.run("phase 16e: the MPMD watchdog replays a "
                                "hung stage", phase_fault_pipeline, ph,
                                args.seed)

    resize = {}
    resize["agent_fit"] = ph.run("phase 17a: 6a's fit over one NCCL rank a "
                                 "host agent spawned (the port's CLI)",
                                 phase_agent_fit, ph, args.seed,
                                 train.get("bench"))
    resize["live"] = ph.run("phase 17b: resize_in_memory 2 -> 1 -> 2 with "
                            "fit(ckpt_path='live'), gloo ranks on the one "
                            "card", phase_live_resize, ph, args.seed)

    telemetry = {}
    fit18 = ph.run("phase 18a: telemetry on the card: 6a's fit with the "
                   "profiler and the perf observatory", phase_telemetry_fit,
                   ph, args.seed, train.get("bench"))
    telemetry["trace"] = ph.run("phase 18b: two warm steps in "
                                "Profiler.trace, the trace summary and "
                                "rla-tpu-torch trace", phase_telemetry_trace,
                                ph, fit18)
    if fit18 is not None:
        for key in ("trainer", "loader", "clock_cb"):
            fit18.pop(key)
        telemetry["fit"] = fit18

    live_plane = {}
    live_plane["multi_slice_fit"] = ph.run(
        "phase 19a: a dcn_data=2 fit over two host agents (gloo ranks on "
        "the one card), scraped live", phase_multi_slice_live, ph,
        args.seed)
    live_plane["serve"] = ph.run(
        "phase 19b: the paged engine with an SLO policy, scraped while it "
        "serves", phase_live_serve, ph, model, params, args.seed)

    del model, params, q8
    torch.cuda.empty_cache()
    tier = ph.run("phase 20: the serving tier, ServeReplicas over forked "
                  "engine replicas on the one card", phase_tier, ph,
                  args.seed, serve)
    for run in serve.values():
        if run is not None:
            run.pop("tokens", None)
    analysis = ph.run("phase 21: the analysis layer: a sanitized fit over "
                      "two gloo ranks on the one card, a divergent "
                      "collective reaped typed, the compile guard, the "
                      "lint", phase_analysis, ph, args.seed)

    log("== phase 5: card")
    smi = nvidia_smi_line()
    # launches: K1/K5/K6 from the int8 paged serve run (phase 3b), K2
    # from generate() with bf16 weights (phase 3d), K4 from the bench
    # config fit (6a), K3a/K3b from the 512-block fit (6b), K7 from the
    # layer_norm op (2d)
    launches = dict((serve.get("int8") or {}).get("launches", {}))
    launches["layer_norm"] = ln_path.get("layer_norm", 0)
    launches["flash_attention"] = (gen.get("bf16") or {}).get(
        "launches", {}).get("flash_attention", 0)
    for run, names in (("bench", ("flash_backward_fused",)),
                       ("split", ("flash_backward_dq",
                                  "flash_backward_dkv"))):
        for name in names:
            launches[name] = (train.get(run) or {}).get(
                "launches", {}).get(name, 0)
    launched_by = {"rms_norm": "the int8 serve run",
                   "int8_matmul": "the int8 serve run",
                   "int8_matmul_nt": "the int8 serve run",
                   "flash_attention": "generate() with bf16 weights",
                   "flash_backward_dq": "the 512-block fit",
                   "flash_backward_dkv": "the 512-block fit",
                   "flash_backward_fused": "the bench config fit",
                   "layer_norm": "the layer_norm op (phase 2d)"}
    tpu = "ray_lightning_accelerators_tpu/"
    replaces = {
        "rms_norm": tpu + "ops/norms.py:50",
        "int8_matmul": tpu + "ops/quant.py:55",
        "int8_matmul_nt": tpu + "ops/quant.py:78",
        "flash_attention": tpu + "ops/attention.py:83",
        "flash_backward_dq": tpu + "ops/attention.py:226",
        "flash_backward_dkv": tpu + "ops/attention.py:256",
        "flash_backward_fused": tpu + "ops/attention.py:290",
        "layer_norm": tpu + "ops/norms.py:57"}
    csrc = "ray_lightning_accelerators_tpu_torch/csrc/"
    sources = {
        "rms_norm": csrc + "norms.cu",
        "int8_matmul": csrc + "quant.cu",
        "int8_matmul_nt": csrc + "quant.cu",
        "flash_attention": csrc + "attention.cu",
        "flash_backward_dq": csrc + "attention_bwd.cu",
        "flash_backward_dkv": csrc + "attention_bwd.cu",
        "flash_backward_fused": csrc + "attention_bwd.cu",
        "layer_norm": csrc + "norms.cu"}
    # one entry per kernel, at its main-path shape (decode: 16 live slots,
    # K5 at the MLP up-projection, its largest weight; K2: generate()'s
    # prefill; K3a/K3b/K4: the training attention, 16 x 12 heads at 1024;
    # K7: the op's path, 16 x 1024 rows of the GPT width)
    bwd_shape = "[192,1024,64] bfloat16 causal"
    headline = {"rms_norm": "rows=16,d=768",
                "int8_matmul": "M=16,K=768,N=3072",
                "int8_matmul_nt": "M=16,K=768,N=50304",
                "flash_attention": "[192,128,64] bfloat16 causal",
                "flash_backward_dq": bwd_shape,
                "flash_backward_dkv": bwd_shape,
                "flash_backward_fused": bwd_shape,
                "layer_norm": "rows=16384,d=768 bfloat16"}
    kernels = []
    for name, shape in headline.items():
        r = next((r for r in rows if r["name"] == name
                  and r["shape"] == shape), None)
        ph.check(r is not None and launches.get(name, 0) > 0,
                 f"{name}: checked at {shape} and launched "
                 f"{launches.get(name, 0)} times by {launched_by[name]}")
        if r is None:
            continue
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches.get(name, 0),
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"], "shape": shape,
            "launched_by": launched_by[name],
            **{k: r[k] for k in ("median_ms", "library_median_ms")
               if k in r}})
    if os.environ.get("CHIP_SMOKE_OUT"):
        with open(os.environ["CHIP_SMOKE_OUT"], "w") as fh:
            json.dump({"card": smi, "kernel_rows": [
                {**r, "bound": list(r["bound"])} for r in rows],
                "serve": serve, "profile": profiled, "generate": gen,
                "dense_engine": dense, "window_speculative": window_spec,
                "lanes": lanes,
                "logits": logits, "train": train, "layer_norm": ln_path,
                "vision": vision, "moe": moe, "training_extras": extras,
                "data_parallel": dp, "sharded_data_parallel": sharded,
                "model_parallel": model_parallel,
                "two_d_and_pipeline": two_d,
                "mpmd_pipeline": mpmd, "tune": tuned,
                "single_card_defaults": defaults,
                "fault_tolerance": faults,
                "agents_and_live_resize": resize,
                "telemetry": telemetry,
                "live_plane_and_multi_slice": live_plane,
                "serving_tier": tier,
                "analysis": analysis,
                "phase_s": ph.seconds,
                "failures": ph.failures}, fh, indent=1, default=str)
    log(f"chip_smoke: {len(ph.failures)} failure(s) in "
        f"{time.perf_counter() - t_start:.1f} s")
    if ph.failures:
        for f in ph.failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
