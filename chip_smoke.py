#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

Drives the port's main paths with the GPT-2-small class model (vocab
50304, d_model 768, 12 heads, d_ff 3072, 12 layers, bf16 compute) and
random weights from ``--seed`` -- the paged ``ServeEngine``,
``GPT.generate()``, the dense ``ServeEngine(paged=False)``, a
sliding-window ``generate()``, ``speculative_generate`` and
``Trainer.fit`` at the repo's GPT training benchmark config -- and checks
every hand-written CUDA kernel on the way:

1. build: compile ``ray_lightning_accelerators_tpu_torch/csrc/*.cu`` for
   sm_90a (one nvcc per source, started together) and print each
   kernel's registers and shared memory (``-Xptxas -v``);
2. kernels: hold K1 rms_norm, K5 int8_matmul and K6 int8_matmul_nt
   against their plain PyTorch versions on the card at the serve path's
   shapes, K2 flash attention at the prefill shapes (2b), and the flash
   backward K3a + K3b (split) and K4 (fused) at the training shapes
   against the f32 autograd of the plain attention (2c), and time each
   (CUDA events, L2 flushed before every launch) beside the plain
   version, one PyTorch library call where there is one (SDPA's backward
   for K3a/K3b/K4), and the least time the card could take (bound); 2d
   times ``F.layer_norm`` beside the bound of K7, which is still to port;
3. serving: 16 requests with 128-token prompts (half sharing a 64-token
   system prompt, so the prefix cache hits) plus one 400-token prompt
   (so the chunked-prefill cursor runs), 64 new tokens each, through
   ``ServeEngine(max_slots=16, block_len=16, max_total_len=512)``; every
   request must complete, prefix hits and batched steps must happen, and
   each kernel must have launched during the int8 run (counts reset just
   before each run); then a profiled window of batched decode steps
   reports the device busy share (a measurement, not a check);
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
5. card identity (``nvidia-smi``), the kernels JSON line, and the result
   line ``{"ok": true, "device": {...}}`` last.

Any failed phase ends the run with a non-zero exit and no result line; so
does a machine without a CUDA device, or a directory without the port.

    python3 chip_smoke.py [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

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

    def check(self, ok: bool, what: str) -> bool:
        log(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.failures.append(what)
        return ok

    def run(self, name: str, fn, *args):
        log(f"== {name}")
        try:
            return fn(*args)
        except Exception:
            self.failures.append(f"{name}: {traceback.format_exc()}")
            log(f"  [FAIL] {name} raised:\n{traceback.format_exc()}")
            return None


# --------------------------------------------------------------------- #
# timing                                                                 #
# --------------------------------------------------------------------- #
_flush_buf = None


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of ``fn`` per call: CUDA events around each call,
    with the 50 MB L2 flushed before it (decode finds its weights cold)."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        _flush_buf.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


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

    # K1 rms_norm: rows = slots at decode, chunk length at prefill
    for m in (16, 128):
        x = torch.randn(m, d, generator=g, device=dev).to(bf)
        s = (1.0 + 0.1 * torch.randn(d, generator=g, device=dev)).to(bf)
        got = norms.rms_norm(x, s)
        ok, err = close(got, norms.rms_norm_reference(x, s))
        ph.check(ok, f"K1 rms_norm [{m},{d}] bf16 max|err|={err:.3e}")
        lib = (lambda: torch.nn.functional.rms_norm(x, (d,), s, 1e-6)) \
            if hasattr(torch.nn.functional, "rms_norm") else None
        nbytes = 2 * m * d * 2 + d * 2
        rows.append(dict(
            kernel="K1", name="rms_norm", shape=f"rows={m},d={d}", err=err,
            ms=time_ms(lambda: norms.rms_norm(x, s)),
            plain_ms=time_ms(lambda: norms.rms_norm_reference(x, s)),
            library_ms=time_ms(lib) if lib else None,
            bound=bound_ms(nbytes, 4 * m * d, F32_FLOPS)))

    # K5 int8_matmul: q/k/v/o (768x768), MLP up (768x3072), down (3072x768)
    for m in (16, 128):
        for k, n in ((d, d), (d, f), (f, d)):
            x = torch.randn(m, k, generator=g, device=dev).to(bf)
            wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                               dtype=torch.int8)
            sc = (torch.rand(n, generator=g, device=dev) + 0.5) * 0.03 / 127
            got = quant.int8_matmul(x, wq, sc)
            ok, err = close(got, quant.int8_matmul_reference(x, wq, sc))
            ph.check(ok, f"K5 int8_matmul M={m} K={k} N={n} "
                         f"max|err|={err:.3e}")
            w_nk = wq.T.contiguous()
            lib = _int8pack_call(x, w_nk, sc)
            nbytes = m * k * 2 + k * n + n * 4 + m * n * 2
            rows.append(dict(
                kernel="K5", name="int8_matmul", shape=f"M={m},K={k},N={n}",
                err=err, ms=time_ms(lambda: quant.int8_matmul(x, wq, sc)),
                plain_ms=time_ms(
                    lambda: quant.int8_matmul_reference(x, wq, sc)),
                library_ms=time_ms(lib) if lib else None,
                bound=bound_ms(nbytes, 2 * m * k * n, BF16_TENSOR_FLOPS)))

    # K6 int8_matmul_nt: the tied unembedding at decode (M = slots)
    m = 16
    h = torch.randn(m, d, generator=g, device=dev)
    sv = (torch.rand(d, generator=g, device=dev) + 0.5) * 0.1 / 127
    x = (h * sv).to(bf)                       # scales folded into x
    w = torch.randint(-127, 128, (V, d), generator=g, device=dev,
                      dtype=torch.int8)
    got = quant.int8_matmul_nt(x, w)
    ok, err = close(got, quant.int8_matmul_nt_reference(x, w))
    ph.check(ok, f"K6 int8_matmul_nt M={m} K={d} N={V} max|err|={err:.3e}")
    lib = _int8pack_call(x, w, torch.ones(V, device=dev))
    nbytes = m * d * 2 + V * d + m * V * 2
    rows.append(dict(
        kernel="K6", name="int8_matmul_nt", shape=f"M={m},K={d},N={V}",
        err=err, ms=time_ms(lambda: quant.int8_matmul_nt(x, w)),
        plain_ms=time_ms(lambda: quant.int8_matmul_nt_reference(x, w)),
        library_ms=time_ms(lib) if lib else None,
        bound=bound_ms(nbytes, 2 * m * d * V, BF16_TENSOR_FLOPS)))

    log("  kernel  shape                       kernel_us  plain_us  "
        "library_us  bound_us (by)")
    for r in rows:
        lib_s = (f"{r['library_ms'] * 1e3:.2f}" if r["library_ms"]
                 else "n/a")
        log(f"  {r['kernel']:<6}  {r['shape']:<26}  {r['ms'] * 1e3:<9.2f}  "
            f"{r['plain_ms'] * 1e3:<8.2f}  {lib_s:<10}  "
            f"{r['bound'][0] * 1e3:.3f} ({r['bound'][1]})")
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
    quant.int8_matmul.launches = 0
    quant.int8_matmul_nt.launches = 0


def _read_counts():
    from ray_lightning_accelerators_tpu_torch.ops import (attention, norms,
                                                          quant)
    return {"flash_attention": attention.flash_forward.launches,
            "rms_norm": norms.rms_norm.launches,
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
    return {"launches": launches, "stats": {
        k: st[k] for k in ("throughput_tok_s", "tokens_generated", "steps",
                           "prefix_hits", "prefill_chunks", "max_batch")},
        "ttft_p50_ms": ttft["p50_s"] * 1e3,
        "ttft_p99_ms": ttft["p99_s"] * 1e3,
        "decode_step_p50_ms": step["p50_s"] * 1e3}


def phase_profile(model, params, label: str, seed: int):
    """Where a batched decode step's time goes (16 live rows at position
    128): host-clock wall per step, the device's kernel time per step from
    torch.profiler, their ratio (the device busy share), kernels launched
    per step, and the top kernels by device time.  A measurement, not a
    check: without device times from the profiler it reports them as not
    measured."""
    from torch.autograd import DeviceType
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
    gpu_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.device_time_total for e in gpu_events) / n
    out = {"wall_ms_per_step": wall_ms,
           "device_ms_per_step": dev_us / 1e3 if gpu_events else None,
           "busy_share": (dev_us / 1e3 / wall_ms) if gpu_events else None,
           "device_ops_per_step": len(gpu_events) / n}
    top = sorted(prof.key_averages(),
                 key=lambda e: -getattr(e, "self_device_time_total", 0.0))
    out["top"] = [(e.key[:60], getattr(e, "self_device_time_total", 0.0)
                   / n) for e in top[:8]]
    if gpu_events:
        log(f"  {label}: decode step wall {wall_ms:.3f} ms, device "
            f"{dev_us / 1e3:.3f} ms -> busy share {out['busy_share']:.3f}; "
            f"{out['device_ops_per_step']:.0f} device ops per step")
        for name, us in out["top"]:
            log(f"    {us:9.1f} us/step  {name}")
    else:
        log(f"  {label}: decode step wall {wall_ms:.3f} ms; device time "
            "not measured (the profiler saw no device events)")
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


# K2 at the prefill shapes: (bh, seq, head_dim, causal, window, dtype).
# generate() at the bench config prefills [16*12, 128, 64]; the engines
# prefill one request at a time, [12, P, 64] for P in {128, 400}.
FLASH_SHAPES = [
    (192, 128, 64, True, None, torch.bfloat16),
    (12, 128, 64, True, None, torch.bfloat16),
    (12, 400, 64, True, None, torch.bfloat16),
    (12, 512, 64, True, None, torch.bfloat16),
    (12, 400, 64, True, 256, torch.bfloat16),
    (12, 256, 128, True, None, torch.bfloat16),
    (12, 128, 64, False, None, torch.bfloat16),
    (12, 400, 64, True, None, torch.float32),
]


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


def phase_flash(ph: Phases, seed: int):
    """K2 against its plain version at the prefill shapes.  Tolerances:
    both sides take f32 products and sums, round p to v's dtype and the
    output once; bf16 outputs may differ by a rounding: rtol 2e-2 with an
    atol of 2e-2 of the largest |out| (f32: 1e-4); lse is f32 on both
    sides: 1e-3 absolute."""
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
        lse_err = (lse - ref_lse).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), rtol=t,
                            atol=t * ref.float().abs().max().item()) \
            and lse_err <= 1e-3 and bool(torch.isfinite(out).all())
        shape = (f"[{bh},{s},{d}] {str(dt).split('.')[-1]} "
                 f"{'causal' if causal else 'full'}"
                 f"{'' if window is None else f' window={window}'}")
        ph.check(ok, f"K2 flash_attention {shape} max|err|={err:.3e} "
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
        rows.append(dict(
            kernel="K2", name="flash_attention", shape=shape, err=err,
            lse_err=lse_err,
            ms=time_ms(lambda: attention.flash_forward(
                q, k, v, causal=causal, window=window)),
            plain_ms=time_ms(lambda: attention.attention_reference_lse(
                q, k, v, causal, window=window)),
            library_ms=time_ms(lib), bound=bound_ms(nbytes, flops, peak)))
    log("  kernel  shape                                kernel_us  "
        "plain_us  sdpa_us  bound_us (by)")
    for r in rows:
        log(f"  {r['kernel']:<6}  {r['shape']:<35}  {r['ms'] * 1e3:<9.2f}  "
            f"{r['plain_ms'] * 1e3:<8.2f}  {r['library_ms'] * 1e3:<7.2f}  "
            f"{r['bound'][0] * 1e3:.3f} ({r['bound'][1]})")
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
# (block_k 1024) and, with the default 512 blocks, K3a + K3b; each shape
# here goes through both branches.
FLASH_BWD_SHAPES = [
    (192, 1024, 64, True, None, torch.bfloat16),
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


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


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
            rows.append(dict(
                kernel=kernel, name=name, shape=shape,
                err=max(errs[k][0] for k in err_keys),
                rel_l2=max(errs[k][1] for k in err_keys),
                ms=time_ms(fn, iters=10), plain_ms=plain_ms,
                library_ms=sdpa_ms, bound=bound_ms(nbytes, flops, peak)))
    log("  kernel  shape                                kernel_us  "
        "plain_us  sdpa_bwd_us  bound_us (by)")
    for r in rows:
        lib_s = ("n/a" if r["library_ms"] is None
                 else f"{r['library_ms'] * 1e3:.2f}")
        log(f"  {r['kernel']:<6}  {r['shape']:<35}  {r['ms'] * 1e3:<9.2f}  "
            f"{r['plain_ms'] * 1e3:<8.2f}  {lib_s:<11}  "
            f"{r['bound'][0] * 1e3:.3f} ({r['bound'][1]})")
    return rows


def phase_layer_norm(seed: int):
    """K7 (the TPU's ``_ln_kernel``) is still to port and no model calls
    it: ``F.layer_norm``'s time per call (L2 flushed) and the kernel's
    bound, x read once with scale and bias and the output written once,
    at the decode rows and at the training rows (batch 16 x seq 1024) of
    the GPT width, bf16.  A measurement, not a check."""
    F = torch.nn.functional
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(seed + 31)
    d = CFG["d_model"]
    out = []
    for rows in (16, 16 * 1024):
        x = torch.randn(rows, d, generator=g, device=dev).to(torch.bfloat16)
        w, b = (torch.randn(d, generator=g, device=dev).to(torch.bfloat16)
                for _ in range(2))
        ms = time_ms(lambda: F.layer_norm(x, (d,), w, b, 1e-6))
        bound = bound_ms(2 * rows * d * 2 + 2 * d * 2, 8 * rows * d,
                         F32_FLOPS)
        log(f"  K7 layer_norm [{rows},{d}] bf16: F.layer_norm "
            f"{ms * 1e3:.2f} us, bound {bound[0] * 1e3:.3f} us ({bound[1]})")
        out.append({"shape": f"rows={rows},d={d}", "library_ms": ms,
                    "bound": list(bound)})
    return out


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


def _fit(cfg_dict: dict, steps_per_epoch: int, seed: int, root: str):
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    cfg = TransformerConfig(**cfg_dict)
    model = GPT(cfg, device=DEV, lr=3e-4)
    data = _pattern_tokens(TRAIN_BATCH * steps_per_epoch, cfg.max_seq_len,
                           cfg.vocab_size, seed)
    clock = _StepClock()
    trainer = Trainer(max_epochs=TRAIN_EPOCHS, device=DEV, precision="bf16",
                      log_every_n_steps=10 ** 9, seed=seed,
                      callbacks=[clock.cb], default_root_dir=root)
    loader = DataLoader(ArrayDataset(data), batch_size=TRAIN_BATCH,
                        shuffle=True, seed=seed)
    _reset_counts()
    _reset_bwd_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.fit(model, loader)
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


# kernel-name fragments in the profiler's device events
_KERNEL_KEYS = {"K2 flash_fwd": "flash_fwd_kernel",
                "K3a flash_bwd_dq": "flash_bwd_dq_kernel",
                "K3b/K4 flash_bwd_kv": "flash_bwd_kv_kernel",
                "K1 rms_norm": "rms_norm_kernel"}


def _profile_train_step(trainer, loader):
    """One more training step (the fit's own step function, on its state)
    under torch.profiler: device time per kernel and its share of the
    step's device time, the step's wall time and the device busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batch = trainer._put_batch(next(iter(loader)))
    trainer._train_step(trainer._state, batch)     # warm, outside the trace
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer._train_step(trainer._state, batch)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        log(f"  6a profile: step wall {wall_ms:.2f} ms; device time not "
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
    log(f"  6a profile: step wall {wall_ms:.2f} ms, device {dev_ms:.2f} ms "
        f"-> busy share {dev_ms / wall_ms:.3f}; {len(events)} device ops")
    for label, v in shares.items():
        log(f"    {label:<22} {v['ms']:9.2f} ms  {v['share'] * 100:5.1f}%")
    for name, ms in top:
        log(f"    top {ms:9.2f} ms  {name[:70]}")
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "busy_share": dev_ms / wall_ms, "kernels": shares,
            "top": [(n[:70], ms) for n, ms in top]}


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


def phase_train_f32(ph: Phases, seed: int):
    """Three f32 steps from the same weights on the same batches, on the
    card (kernels K1, K2, K4) and on the CPU (plain versions), TF32 off:
    per-step loss within 1e-3 relative, final params within 1e-3 relative
    L2 per leaf (f32 on both sides; the card sums in other orders)."""
    from ray_lightning_accelerators_tpu_torch import DataLoader, Trainer
    from ray_lightning_accelerators_tpu_torch.data.loader import ArrayDataset
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    cfg = TransformerConfig(**F32_CFG)
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
             f"6c: f32 card vs CPU over {F32_STEPS} steps: loss max rel "
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
    layer_norm = ph.run("phase 2d: K7 LayerNorm, still to port: "
                        "F.layer_norm and its bound (measurement)",
                        phase_layer_norm, args.seed)

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
    log("== phase 3c: where a decode step's time goes (measurement)")
    profiled = {}
    for label, p in (("bf16", params), ("int8", q8)):
        try:
            profiled[label] = phase_profile(model, p, label, args.seed)
        except Exception as e:  # a measurement, not a check
            log(f"  profile {label}: not measured ({type(e).__name__}: {e})")
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

    log("== phase 5: card")
    smi = nvidia_smi_line()
    # launches: K1/K5/K6 from the int8 paged serve run (phase 3b), K2
    # from generate() with bf16 weights (phase 3d), K4 from the bench
    # config fit (6a), K3a/K3b from the 512-block fit (6b)
    launches = dict((serve.get("int8") or {}).get("launches", {}))
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
                   "flash_backward_fused": "the bench config fit"}
    tpu = "ray_lightning_accelerators_tpu/"
    replaces = {
        "rms_norm": tpu + "ops/norms.py:50",
        "int8_matmul": tpu + "ops/quant.py:55",
        "int8_matmul_nt": tpu + "ops/quant.py:78",
        "flash_attention": tpu + "ops/attention.py:83",
        "flash_backward_dq": tpu + "ops/attention.py:226",
        "flash_backward_dkv": tpu + "ops/attention.py:256",
        "flash_backward_fused": tpu + "ops/attention.py:290"}
    csrc = "ray_lightning_accelerators_tpu_torch/csrc/"
    sources = {
        "rms_norm": csrc + "norms.cu",
        "int8_matmul": csrc + "quant.cu",
        "int8_matmul_nt": csrc + "quant.cu",
        "flash_attention": csrc + "attention.cu",
        "flash_backward_dq": csrc + "attention_bwd.cu",
        "flash_backward_dkv": csrc + "attention_bwd.cu",
        "flash_backward_fused": csrc + "attention_bwd.cu"}
    # one entry per kernel, at its main-path shape (decode: 16 live slots,
    # K5 at the MLP up-projection, its largest weight; K2: generate()'s
    # prefill; K3a/K3b/K4: the training attention, 16 x 12 heads at 1024)
    bwd_shape = "[192,1024,64] bfloat16 causal"
    headline = {"rms_norm": "rows=16,d=768",
                "int8_matmul": "M=16,K=768,N=3072",
                "int8_matmul_nt": "M=16,K=768,N=50304",
                "flash_attention": "[192,128,64] bfloat16 causal",
                "flash_backward_dq": bwd_shape,
                "flash_backward_dkv": bwd_shape,
                "flash_backward_fused": bwd_shape}
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
            "library_ms": r["library_ms"], "shape": shape})
    if os.environ.get("CHIP_SMOKE_OUT"):
        with open(os.environ["CHIP_SMOKE_OUT"], "w") as fh:
            json.dump({"card": smi, "kernel_rows": [
                {**r, "bound": list(r["bound"])} for r in rows],
                "serve": serve, "profile": profiled, "generate": gen,
                "dense_engine": dense, "window_speculative": window_spec,
                "logits": logits, "train": train, "layer_norm": layer_norm,
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
