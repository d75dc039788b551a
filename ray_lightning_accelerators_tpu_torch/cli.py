"""``rla-tpu-torch``: per-host agents and launches against them.

Port of the JAX package's ``cli.py``:

1. on every host: ``rla-tpu-torch agent --port 7777`` (or ``python -m
   ray_lightning_accelerators_tpu_torch.cli agent``); the agent prints its
   bound port on a line of its own first, so a script can start it with
   ``--port 0`` and read the port back, and logs each spawn with its
   ``spawn_count`` on stderr;
2. on the driver: ``rla-tpu-torch launch --agents host1:7777,host2:7777
   train.py args...`` exports the list as ``RLA_TPU_AGENTS`` and runs the
   script, where ``runtime.agent.agents_from_env`` finds it (an
   accelerator with ``num_hosts > 1``, a process-trial ``tune.run``).

3. ``rla-tpu-torch trace <dir> [--top N]`` prints the per-category and
   per-op exclusive device time of the newest ``torch.profiler`` Chrome
   trace under ``dir`` (``Profiler.start_trace`` writes one), as
   ``utils.profiler.trace_op_summary`` computes it.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        "rla-tpu-torch", description="training control plane (PyTorch)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    ag = sub.add_parser("agent", help="run a per-host worker agent")
    ag.add_argument("--port", type=int, default=7777,
                    help="port to listen on (0: any free one, printed)")
    ag.add_argument("--bind", default="127.0.0.1",
                    help="interface to listen on (agents run what they are "
                         "sent; a non-loopback bind needs "
                         "RLA_TPU_AGENT_TOKEN on agent and driver)")

    la = sub.add_parser(
        "launch", help="run a driver script against host agents")
    la.add_argument("--agents", required=True,
                    help="comma-separated host:port agent addresses")
    la.add_argument("script", help="driver python script")
    la.add_argument("script_args", nargs=argparse.REMAINDER)

    tr = sub.add_parser(
        "trace", help="summarize a torch.profiler device trace directory "
                      "(written by Profiler.start_trace) as a per-op / "
                      "per-category table")
    tr.add_argument("trace_dir", help="directory passed to start_trace")
    tr.add_argument("--top", type=int, default=25,
                    help="rows in the per-op table (0 = all)")

    args = parser.parse_args(argv)
    if args.cmd == "agent":
        import logging

        from .runtime.agent import HostAgent
        from .utils.logging import log
        # the agent's own lines (listening, each spawn with its
        # spawn_count) on stderr, through the package's rank-stamped
        # handler
        log.setLevel(logging.INFO)
        # a tokenless non-loopback bind raises inside HostAgent
        agent = HostAgent(args.port, args.bind)
        print(agent.port, flush=True)
        agent.serve_forever()
    elif args.cmd == "launch":
        import os
        import runpy

        os.environ["RLA_TPU_AGENTS"] = args.agents
        sys.argv = [args.script] + list(args.script_args)
        runpy.run_path(args.script, run_name="__main__")
    elif args.cmd == "trace":
        from .utils.profiler import trace_op_summary

        s = trace_op_summary(args.trace_dir, top=args.top)
        print(f"device total: {s['total_ms']:.2f} ms\n")
        print(f"{'category':<26} {'self ms':>10} {'GB/s':>8} "
              f"{'TF/s':>7} {'%':>6}")
        for cat, row in sorted(s["by_category"].items(),
                               key=lambda kv: -kv[1]["self_ms"]):
            print(f"{cat:<26} {row['self_ms']:>10.2f} {row['gbps']:>8.1f} "
                  f"{row['tfs']:>7.1f} {row['pct']:>6.1f}")
        print(f"\n{'op':<44} {'self ms':>10} {'n':>6} {'%':>6}")
        for op in s["ops"]:
            print(f"{op['name'][:44]:<44} {op['self_ms']:>10.2f} "
                  f"{op['count']:>6d} {op['pct']:>6.1f}")


if __name__ == "__main__":
    main()
