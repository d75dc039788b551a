#!/usr/bin/env python3
"""K5 (``int8_matmul``) of the PyTorch port under other launch plans, on
one NVIDIA GPU.

``ops/quant.py`` ``launch_plan`` picks how many blocks of a thread-block
cluster split K (1-8).  This script calls the kernel's C entry with every
other valid cluster size at the serve path's shapes (bf16 x, the GPT-2
small class projections at M = 1, 16 and 128) and times each in turns
with the plan the port uses (CUDA events, L2 flushed before every call,
medians), after checking each plan's output against the plain version
with the card tests' tolerance (one bf16 ulp of each output plus 1e-5 of
the largest: another split groups the f32 sum differently).  Prints one
line a plan and a JSON summary last.

    python3 scripts/torch_int8_plan_sweep.py [--rounds 20]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _event_ms(fns, rounds: int, flush: torch.Tensor):
    pairs = [[] for _ in fns]
    for _ in range(rounds):
        for fn, got in zip(fns, pairs):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            got.append((s, e))
    torch.cuda.synchronize()
    return [[s.elapsed_time(e) for s, e in got] for got in pairs]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_int8_plan_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    from ray_lightning_accelerators_tpu_torch.ops import _build, quant
    dev = torch.device("cuda")
    lib = _build.library("quant")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    code = _build.DTYPE_CODES[torch.bfloat16]
    results = []
    for m in (1, 16, 128):
        for k, n in ((768, 768), (768, 3072), (3072, 768)):
            x = torch.randn(m, k, generator=g, device=dev).bfloat16()
            wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                               dtype=torch.int8)
            sc = (torch.rand(n, generator=g, device=dev) + 0.5) * 0.03 / 127
            port = quant.int8_matmul(x, wq, sc)
            ref = quant.int8_matmul_reference(x, wq, sc).float()
            ulp = 2.0 ** (torch.floor(torch.log2(
                ref.abs().clamp_min(1e-30))) - 7)
            lim = ulp + 1e-5 * ref.abs().max()
            chunks = -(-k // 32)
            plans = sorted({(-(-chunks // -(-chunks // c)),
                             -(-chunks // c) * 32) for c in range(1, 9)
                            if c <= chunks})
            default = quant.launch_plan(k, n)

            def call(plan, out):
                err = lib.rla_int8_matmul(
                    x.data_ptr(), wq.data_ptr(), sc.data_ptr(),
                    out.data_ptr(), m, k, n, plan[0], plan[1], code,
                    _build.stream_of(x))
                _build.check(err, "int8_matmul", "quant")

            for plan in plans:
                out = torch.empty_like(port)
                call(plan, out)
                torch.cuda.synchronize()
                agree = bool(((out.float() - ref).abs() <= lim).all())
                ours = lambda: quant.int8_matmul(x, wq, sc)
                theirs = (lambda plan=plan, out=out: call(plan, out))
                for _ in range(3):
                    ours()
                    theirs()
                a, b, c, d = _event_ms([ours, theirs, theirs, ours],
                                       args.rounds, flush)
                row = {"shape": f"M={m},K={k},N={n}", "cluster": plan[0],
                       "k_per_rank": plan[1], "default": list(default),
                       "plan_us": float(np.median(b + c)) * 1e3,
                       "default_us": float(np.median(a + d)) * 1e3,
                       "within_tolerance": agree}
                results.append(row)
                print(f"{row['shape']:<20} cluster {plan[0]} x "
                      f"{plan[1]:>4} k: {row['plan_us']:7.2f} us; the "
                      f"port's plan {default}: {row['default_us']:7.2f} us"
                      f"{'' if agree else '  OUTSIDE THE TOLERANCE'}",
                      flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "plans": results}))
    return 0 if all(r["within_tolerance"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
