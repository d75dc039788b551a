"""What ``chip_smoke.py``'s 10a loss bound separates, on the card.

Runs the in-process 6a fit once, then 10a (``Trainer(accelerator=
RayTPUAccelerator(1, use_fsdp=True), grad_compression="int8")`` at the
GPT bench config) twice as shipped and once with each of three faults
planted in the rank's int8 exchange: error feedback dropped, the mean
doubled, the block scales shifted by one block.  The faults live only
in the rank's memory: the accelerator's ``init_hook`` rebinds the
exchange's functions there, so no file of the port changes.  Prints and
writes (``--out``) each run's loss per step and its relative gap to 6a;
``INT8_LAST_LOSS_REL`` in ``chip_smoke.py`` lies between the sound runs'
step-8 gap and the smallest fault's.

    python3 scripts/torch_int8_bound_probe.py --out build/probe.json

Needs one CUDA card; the port only, no JAX.
"""

import argparse
import functools
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HEAD = """
import torch
import ray_lightning_accelerators_tpu_torch.parallel.collectives as c
"""
FAULTS = {
    "sound": "",
    "sound_again": "",
    "no_feedback": _HEAD + """
o1, o2 = c.GradExchange.exchange_leaf, c.GradExchange.exchange_rs_leaf
def f1(self, g, r, cfg):
    out, nr = o1(self, g, torch.zeros_like(r), cfg)
    return out, torch.zeros_like(nr)
def f2(self, g, r, dim, cfg):
    out, nr = o2(self, g, torch.zeros_like(r), dim, cfg)
    return out, torch.zeros_like(nr)
c.GradExchange.exchange_leaf, c.GradExchange.exchange_rs_leaf = f1, f2
""",
    "mean_x2": _HEAD + """
o1, o2 = c.GradExchange.exchange_leaf, c.GradExchange.exchange_rs_leaf
def f1(self, g, r, cfg):
    out, nr = o1(self, g, r, cfg)
    return out * 2, nr
def f2(self, g, r, dim, cfg):
    out, nr = o2(self, g, r, dim, cfg)
    return out * 2, nr
c.GradExchange.exchange_leaf, c.GradExchange.exchange_rs_leaf = f1, f2
""",
    "scales_rolled": _HEAD + """
od = c.dequantize_blocks
c.dequantize_blocks = lambda q, s: od(q, torch.roll(s, 1))
""",
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import ray_lightning_accelerators_tpu_torch as port
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"card": cs.nvidia_smi_line()}
    ph = cs.Phases()
    cs.phase_build(ph)
    ref = cs.phase_train(ph, args.seed)
    steps = cs.TRAIN_STEPS_PER_EPOCH
    out["6a_loss"] = ref["loss"][:steps]
    real = port.RayTPUAccelerator
    try:
        for name, code in FAULTS.items():
            def accelerator(*a, _code=code, **k):
                if _code:
                    k["init_hook"] = functools.partial(exec, _code, {})
                return real(*a, **k)
            port.RayTPUAccelerator = accelerator
            t0 = time.perf_counter()
            loss = cs.phase_sharded_fit(ph, args.seed, ref)["loss"]
            rel = [abs(a - b) / abs(b) for a, b in zip(loss, ref["loss"])]
            out[name] = {"s": time.perf_counter() - t0, "loss": loss,
                         "rel": rel, "max_rel": max(rel),
                         "last_rel": rel[-1]}
            print("PROBE", name, json.dumps(out[name]), flush=True)
    finally:
        port.RayTPUAccelerator = real
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(out["card"])
    print(json.dumps({k: v["last_rel"] for k, v in out.items()
                      if isinstance(v, dict)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
