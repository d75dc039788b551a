"""The gradient exchange of plain data parallelism.

Port of the base case of the JAX package's ``parallel/collectives.py``:
there the mean of the replicas' gradients is the ``psum`` XLA derives
from the batch sharding; here each rank computes the gradients of its
rows and ``GradExchange.mean`` averages them across the ranks' process
group, with the step's scalar metrics in the same bucket: one flattened
f32 bucket, one ``all_reduce``, one division by the world size.  Nothing
in it waits for the device: on the card NCCL enqueues the reduction on
the current stream.  Compressed exchange (int8 / bf16 blocks with error
feedback), ZeRO-1 and FSDP come with the sharded data-parallel slice.
"""

from __future__ import annotations

import time
from typing import List

import torch
import torch.distributed as dist


def world_and_rank():
    """(world size, rank) of this process's group; (1, 0) outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class GradExchange:
    """Averages tensors across the ranks, one bucket a call, and keeps
    the count and the time of its all-reduces: CUDA events on the card
    (read once, by ``times_ms``), the host clock on the CPU, where gloo
    returns when the reduction is done."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.all_reduces = 0
        self.bucket_numel = 0
        self._events: list = []
        self._host_ms: List[float] = []

    def mean(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor's mean over the ranks, in its own dtype and shape
        (views into the reduced bucket where the dtype is f32)."""
        world = dist.get_world_size()
        bucket = torch.cat([t.detach().reshape(-1).to(torch.float32)
                            for t in tensors])
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dist.all_reduce(bucket)
            end.record()
            self._events.append((start, end))
        else:
            t0 = time.perf_counter()
            dist.all_reduce(bucket)
            self._host_ms.append((time.perf_counter() - t0) * 1e3)
        bucket.div_(world)
        self.all_reduces += 1
        self.bucket_numel = bucket.numel()
        out, offset = [], 0
        for t in tensors:
            n = t.numel()
            out.append(bucket[offset:offset + n].view(t.shape).to(t.dtype))
            offset += n
        return out

    def times_ms(self) -> List[float]:
        """Each all-reduce's time, in call order."""
        if self._events:
            self._events[-1][1].synchronize()
            self._host_ms += [s.elapsed_time(e) for s, e in self._events]
            self._events = []
        return list(self._host_ms)

    def stats(self) -> dict:
        return {"all_reduces": self.all_reduces,
                "bucket_numel": self.bucket_numel,
                "all_reduce_ms": self.times_ms()}


def sum_across_ranks(values: List[float], device: torch.device) -> List[float]:
    """Host floats summed over the ranks (f64: the evaluation loops'
    weighted sums, once per pass)."""
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t)
    return t.tolist()


def any_across_ranks(flag: bool, device: torch.device) -> bool:
    """True on every rank when any rank's ``flag`` is True."""
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
