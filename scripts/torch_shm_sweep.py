#!/usr/bin/env python3
"""The PyTorch port's object store under variants of its shm layer.

``runtime/object_store.py`` puts a KV handoff's waves into POSIX shm
segments through ``native/shm_store.cc``, which reserves a segment's
pages (``posix_fallocate``) and maps them with ``MAP_POPULATE``.  This
script builds that source as shipped and with each of the two left out
(text substitutions on the committed file, built with the same g++
flags into ``build/torch_shm_sweep/``), and times ``ObjectStore.put`` and
``get`` of the 400-token handoff's payload at the GPT-2-small class
width (4 waves of bf16 words, 7 + 7 + 7 + 4 blocks of 16 tokens x 12
layers x 12 heads x 64, k and v: 14,745,600 bytes), the variants in
turns, medians of ``--rounds``.  Each get is checked bitwise against
what was put.  Needs g++ and /dev/shm, no GPU; prints one line a variant
and a JSON summary last.

    python3 scripts/torch_shm_sweep.py [--rounds 9]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ray_lightning_accelerators_tpu_torch import native  # noqa: E402
from ray_lightning_accelerators_tpu_torch.runtime import (  # noqa: E402
    object_store)

OUT = native.BUILD_DIR.parent / "torch_shm_sweep"


def variants() -> dict:
    src = native.SRC.read_text()
    no_populate = src.replace("MAP_SHARED | MAP_POPULATE", "MAP_SHARED")
    no_reserve = re.sub(r"  // reserve the pages now.*?\n  }\n", "", src,
                        flags=re.S)
    assert no_populate != src and no_reserve != src
    return {"shipped": src, "no_populate": no_populate,
            "no_reserve": no_reserve}


def load(name: str, code: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cc, so = OUT / f"{name}.cc", OUT / f"{name}.so"
    cc.write_text(code)
    proc = subprocess.run(["g++", *native.CXX_FLAGS, "-o", str(so), str(cc),
                           *native.LINK_FLAGS], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"g++ failed on {name}: {proc.stderr[-2000:]}")
    lib = ctypes.CDLL(str(so))
    native._declare_shm(lib)
    return lib


def payloads() -> list:
    rng = np.random.default_rng(0)
    out = []
    for blocks in (7, 7, 7, 4):
        shape = (12, blocks, 12, 16, 64)  # [L, W, kv_heads, block_len, D]
        out.append({"k": rng.integers(-32768, 32767, shape, np.int16),
                    "v": rng.integers(-32768, 32767, shape, np.int16),
                    "dtype": "bfloat16"})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=9)
    args = ap.parse_args()
    libs = {name: load(name, code) for name, code in variants().items()}
    waves = payloads()
    nbytes = sum(w["k"].nbytes + w["v"].nbytes for w in waves)
    times = {name: {"put": [], "get": []} for name in libs}
    for _ in range(args.rounds):
        for name, lib in libs.items():
            native._libs[native.SRC] = lib
            store = object_store.ObjectStore()
            t0 = time.perf_counter()
            refs = [store.put(w) for w in waves]
            t1 = time.perf_counter()
            got = [store.get(r) for r in refs]
            t2 = time.perf_counter()
            for w, g in zip(waves, got):
                assert np.array_equal(w["k"], g["k"]) \
                    and np.array_equal(w["v"], g["v"])
            store.shutdown()
            times[name]["put"].append((t1 - t0) * 1e3)
            times[name]["get"].append((t2 - t1) * 1e3)
    summary = {}
    for name, t in times.items():
        put, get = float(np.median(t["put"])), float(np.median(t["get"]))
        summary[name] = {"put_ms": put, "get_ms": get,
                         "put_gb_s": nbytes / put / 1e6,
                         "get_gb_s": nbytes / get / 1e6}
        print(f"{name}: put {put:.3f} ms ({nbytes / put / 1e6:.2f} GB/s), "
              f"get {get:.3f} ms ({nbytes / get / 1e6:.2f} GB/s) for "
              f"{nbytes} bytes in {len(waves)} waves", flush=True)
    print(json.dumps({"bytes": nbytes, "rounds": args.rounds,
                      "variants": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
