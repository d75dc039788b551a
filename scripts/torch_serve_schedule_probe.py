"""Does the port's paged engine give the same greedy tokens whatever the
admission pattern?  Phase 3 of ``chip_smoke.py`` (its 17 requests, 64 new
tokens, the GPT-2-small class model with random weights from the seed)
served five ways on one engine configuration: all at once (twice), one
at a time, four at a time, and each on a fresh engine; bf16 weights,
then their int8 quantization.  Prints, for each way against the first,
the requests whose tokens differ and the first position that does.

The pattern changes two things inside the engine: whether a prompt's
shared prefix is already cached (a hit prefills only the suffix, so the
prefill's matrix products have fewer rows), and whether the 400-token
prompt streams in the idle engine's big chunks or the small ones between
decode steps.  Measures only; needs one CUDA device.

    python3 scripts/torch_serve_schedule_probe.py [--seed 0]
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402  (the repo root, for phase 3's set)


def serve(model, params, reqs, mode):
    from ray_lightning_accelerators_tpu_torch.serve import ServeEngine
    kw = dict(max_slots=cs.SLOTS, block_len=cs.BLOCK_LEN,
              max_total_len=cs.MAX_TOTAL)
    n = cs.NEW_TOKENS
    if mode == "fresh":
        outs = []
        for p in reqs:
            with ServeEngine(model, params, **kw) as eng:
                outs.append(eng.submit(p, n).result(timeout=600))
        return outs
    group = {"burst": len(reqs), "serial": 1, "chunks4": 4}[mode]
    outs = []
    with ServeEngine(model, params, **kw) as eng:
        for i in range(0, len(reqs), group):
            hs = [eng.submit(p, n) for p in reqs[i:i + group]]
            outs += [h.result(timeout=600) for h in hs]
    return outs


def differing(a, b):
    return [(i, int(np.argmin(x == y))) for i, (x, y) in enumerate(zip(a, b))
            if not np.array_equal(x, y)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = GPT(TransformerConfig(**cs.CFG), device="cuda",
                compute_dtype=torch.bfloat16)
    params = cs._cast_floats(model.init_params(seed=args.seed),
                             torch.bfloat16)
    reqs = cs._requests(args.seed)
    for label, p in (("bf16", params), ("int8", GPT.quantize_weights(params))):
        runs = {}
        for name, mode in (("burst", "burst"), ("burst2", "burst"),
                           ("serial", "serial"), ("chunks4", "chunks4"),
                           ("fresh", "fresh")):
            t0 = time.perf_counter()
            runs[name] = serve(model, p, reqs, mode)
            print(f"{label} {name}: {time.perf_counter() - t0:.2f} s",
                  flush=True)
        for name in list(runs)[1:]:
            print(f"{label} burst vs {name}: differing (request, first "
                  f"position) {differing(runs['burst'], runs[name])}",
                  flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
