#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

Drives the port's main paths with the GPT-2-small class model (vocab
50304, d_model 768, 12 heads, d_ff 3072, 12 layers, max_seq_len 512, bf16
compute) and random weights from ``--seed`` -- the paged ``ServeEngine``,
``GPT.generate()``, the dense ``ServeEngine(paged=False)``, a
sliding-window ``generate()`` and ``speculative_generate`` -- with bf16
and with int8 weight-only weights, and checks every hand-written CUDA
kernel on the way:

1. build: compile ``ray_lightning_accelerators_tpu_torch/csrc/*.cu`` for
   sm_90a (one nvcc per source, started together) and print each
   kernel's registers and shared memory (``-Xptxas -v``);
2. kernels: hold K1 rms_norm, K5 int8_matmul and K6 int8_matmul_nt
   against their plain PyTorch versions on the card at the serve path's
   shapes, and K2 flash attention at the prefill shapes (2b), and time
   each (CUDA events, L2 flushed before every launch) beside the plain
   version, one PyTorch library call where there is one, and the least
   time the card could take (bound);
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
    ph.check(set(logs) >= {"attention", "norms", "quant"},
             "attention.cu, norms.cu and quant.cu built")


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

    log("== phase 5: card")
    smi = nvidia_smi_line()
    # launches: K1/K5/K6 from the int8 paged serve run (phase 3b), K2
    # from generate() with bf16 weights (phase 3d)
    launches = dict((serve.get("int8") or {}).get("launches", {}))
    launches["flash_attention"] = (gen.get("bf16") or {}).get(
        "launches", {}).get("flash_attention", 0)
    launched_by = {"rms_norm": "the int8 serve run",
                   "int8_matmul": "the int8 serve run",
                   "int8_matmul_nt": "the int8 serve run",
                   "flash_attention": "generate() with bf16 weights"}
    replaces = {
        "rms_norm": "ray_lightning_accelerators_tpu/ops/norms.py:50",
        "int8_matmul": "ray_lightning_accelerators_tpu/ops/quant.py:55",
        "int8_matmul_nt": "ray_lightning_accelerators_tpu/ops/quant.py:78",
        "flash_attention":
            "ray_lightning_accelerators_tpu/ops/attention.py:83"}
    sources = {
        "rms_norm": "ray_lightning_accelerators_tpu_torch/csrc/norms.cu",
        "int8_matmul": "ray_lightning_accelerators_tpu_torch/csrc/quant.cu",
        "int8_matmul_nt":
            "ray_lightning_accelerators_tpu_torch/csrc/quant.cu",
        "flash_attention":
            "ray_lightning_accelerators_tpu_torch/csrc/attention.cu"}
    # one entry per kernel, at its main-path shape (decode: 16 live slots,
    # K5 at the MLP up-projection, its largest weight; K2: generate()'s
    # prefill)
    headline = {"rms_norm": "rows=16,d=768",
                "int8_matmul": "M=16,K=768,N=3072",
                "int8_matmul_nt": "M=16,K=768,N=50304",
                "flash_attention": "[192,128,64] bfloat16 causal"}
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
                "logits": logits,
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
