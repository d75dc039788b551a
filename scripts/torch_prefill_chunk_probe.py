"""Do the 400-token prompt's int8 greedy tokens depend on where its
prefill chunks fall?  Phase 3 of ``chip_smoke.py`` (its 17 requests, the
GPT-2-small class model with random weights from the seed, int8
weight-only) on one engine configuration: the 400-token prompt's first
``P20B_NEW`` new tokens served in the burst of all 17 (phase 3b's
schedule, the reference), then alone and beside other requests (a
partner submitted before or after it, some seconds apart, three at
once), each on a fresh engine; once with the default prefill quantum
under decode (``RLA_TPU_SERVE_CHUNK_MIN_BLOCKS`` = 1 block) and once
with it at 8 blocks, the idle engine's quantum.  Prints each schedule's
first difference from the reference, its prefill chunks, and which
schedules agree.

An idle engine prefills in 8-block (128-token) chunks; beside a
decoding request it advances 1 block between decode waves, so the
chunks' boundaries, and with them the prefill's matrix products, follow
the load.  ``chip_smoke.py`` phase 20b holds its replicas to 3b's tokens
and pins the quantum.  Measures only; needs one CUDA device.

    python3 scripts/torch_prefill_chunk_probe.py [--seed 0]
"""

import argparse
import hashlib
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402  (the repo root, for phase 3's set)

LONG = 8  # the 400-token prompt's place in phase 3's requests

# (name, partners, seconds between, partners submitted first)
SCHEDULES = [("alone", [], 0.0, False), ("alone again", [], 0.0, False),
             ("with 9", [9], 0.0, False), ("with 9 again", [9], 0.0, False),
             ("with 7", [7], 0.0, False), ("with 0, 1, 2", [0, 1, 2], 0.0,
                                           False),
             ("9 first", [9], 0.0, True), ("9 first, 0.3 s", [9], 0.3, True),
             ("7 first, 0.05 s", [7], 0.05, True),
             ("with 10", [10], 0.0, False), ("with 1", [1], 0.0, False)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from ray_lightning_accelerators_tpu_torch.models.transformer import (
        GPT, TransformerConfig)
    from ray_lightning_accelerators_tpu_torch.serve import ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    model = GPT(TransformerConfig(**cs.CFG), device="cuda",
                compute_dtype=torch.bfloat16)
    q8 = GPT.quantize_weights(cs._cast_floats(
        model.init_params(seed=args.seed), torch.bfloat16))
    reqs = cs._requests(args.seed)
    n = cs.P20B_NEW
    kw = dict(max_slots=cs.SLOTS, block_len=cs.BLOCK_LEN,
              max_total_len=cs.MAX_TOTAL)
    with ServeEngine(model, q8, **kw) as eng:
        hs = [eng.submit(p, n) for p in reqs]
        ref = [h.result(timeout=600) for h in hs][LONG]
    for quantum in ("1", "8"):
        os.environ["RLA_TPU_SERVE_CHUNK_MIN_BLOCKS"] = quantum
        groups: dict = {}
        for name, others, gap, first in SCHEDULES:
            with ServeEngine(model, q8, **kw) as eng:
                if first:
                    hs = [eng.submit(reqs[i], n) for i in others]
                    time.sleep(gap)
                    h = eng.submit(reqs[LONG], n)
                else:
                    h = eng.submit(reqs[LONG], n)
                    hs = [eng.submit(reqs[i], n) for i in others]
                got = h.result(timeout=600)
                for x in hs:
                    x.result(timeout=600)
                chunks = eng.stats()["prefill_chunks"]
            key = hashlib.sha1(got.tobytes()).hexdigest()[:10]
            groups.setdefault(key, []).append(name)
            print(f"quantum {quantum} block(s), {name}: first difference "
                  f"from the burst {cs._p20_first_diff([got], [ref])}; "
                  f"prefill chunks {chunks}", flush=True)
        print(f"quantum {quantum} block(s): schedules by output {groups}",
              flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
