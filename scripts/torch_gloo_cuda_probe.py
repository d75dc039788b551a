"""Which gloo collectives run on CUDA tensors of two ranks sharing card 0.

Each case (all_reduce, all_gather, reduce_scatter, all_to_all, a
point-to-point send / receive pair, a collective over a ``new_group``)
runs in its own pair of processes, so a crash stays contained; the last
line is ``{case: [rank 0 ok, rank 1 ok]}``.  The port's ring attention
builds its ppermute from an all-gather where this shows no
point-to-point path (``parallel/collectives.py``).

    python3 scripts/torch_gloo_cuda_probe.py
"""
import os, sys, subprocess, json, socket, time

CASES = ["all_reduce", "all_gather", "reduce_scatter", "all_to_all",
         "p2p", "new_group"]

def child(case, rank, port):
    import torch, torch.distributed as dist, datetime
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=30))
    x = torch.arange(8, dtype=torch.float32, device="cuda") + 10 * rank
    if case == "all_reduce":
        dist.all_reduce(x); ok = x[0].item() == 10
    elif case == "all_gather":
        out = torch.empty(16, device="cuda"); dist.all_gather_into_tensor(out, x)
        ok = out[8].item() == 10
    elif case == "reduce_scatter":
        out = torch.empty(4, device="cuda"); dist.reduce_scatter_tensor(out, x)
        ok = out[0].item() == (10 if rank == 0 else 18)
    elif case == "all_to_all":
        out = torch.empty(8, device="cuda"); dist.all_to_all_single(out, x)
        # rank 0 receives rank 1's first half, rank 1 rank 0's second
        ok = out[4].item() == (10 if rank == 0 else 14) \
            and out[0].item() == (0 if rank == 0 else 4)
    elif case == "p2p":
        out = torch.empty(8, device="cuda")
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                       dist.P2POp(dist.irecv, out, 1 - rank)])
        for r in reqs: r.wait()
        torch.cuda.synchronize()
        ok = out[0].item() == 10 * (1 - rank)
    elif case == "new_group":
        g = dist.new_group([0, 1]); dist.all_reduce(x, group=g); ok = x[0].item() == 10
    print(json.dumps({"case": case, "rank": rank, "ok": bool(ok)}), flush=True)
    dist.destroy_process_group()

if __name__ == "__main__":
    if len(sys.argv) > 1:
        child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])); sys.exit(0)
    import torch
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    res = {}
    for case in CASES:
        s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]; s.close()
        ps = [subprocess.Popen([sys.executable, __file__, case, str(r), str(port)],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
              for r in range(2)]
        outs = []
        for p in ps:
            try:
                o, e = p.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill(); o, e = p.communicate()
                e = "TIMEOUT " + e
            outs.append((p.returncode, o.strip()[-300:], e.strip()[-600:]))
        res[case] = outs
        print(case, outs, flush=True)
    print(json.dumps({k: [o[0] == 0 and '"ok": true' in o[1] for o in v] for k, v in res.items()}))
