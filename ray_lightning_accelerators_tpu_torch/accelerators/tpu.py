"""The three public accelerators, name for name with the JAX package's.

Port of the JAX package's ``accelerators/tpu.py``, with its keyword
arguments and checks:

- ``RayTPUAccelerator(num_workers)``: data parallelism over
  ``num_workers`` spawned ranks, one device each (``None``: every
  visible card; one rank on the CPU).  ``use_fsdp=True`` shards the
  parameters and their optimizer state over the ranks (the ranks' axis
  becomes ``fsdp``).  ``tensor``, ``sequence`` and ``expert`` add the
  model axes: the world is then ``num_workers * tensor * sequence *
  expert`` ranks and the batch is split over ``num_workers`` of them.
  ``pipeline`` adds the SPMD pipeline axis (the GPT's layers split in
  stages, ``parallel/pipeline.py``), with the batch axes.  Multi-slice
  meshes and host agents are accepted as keywords and refused by the
  Trainer until their slices land.
- ``RayAccelerator(num_workers, num_cpus_per_worker, use_gpu,
  init_hook)``: the reference's DDP plugin signature.  The ranks' device
  follows ``Trainer(device=)``; ``use_gpu=True`` with ``device="cpu"``
  is a contradiction and raises.
- ``HorovodRayAccelerator(num_hosts, num_slots)``: ``num_hosts *
  num_slots`` ranks.  Without host agents (they come with the runtime
  slice), ``num_hosts > 1`` degrades with a warning to that many ranks
  on this host, as the JAX package degrades to its local devices.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..parallel import mesh as mesh_lib
from ..utils.logging import log
from .base import Accelerator


class RayTPUAccelerator(Accelerator):
    """Data parallelism over spawned ranks.

    Args:
      num_workers: number of ranks (batch shards).  None = every visible
        card (one rank on the CPU).
      use_fsdp: shard params and optimizer state over the ranks (ZeRO-3);
        the axis is relabeled ``fsdp`` and the batch stays split over it.
      tensor, sequence, expert: the JAX package's model axes (Megatron
        tensor parallelism, ring / Ulysses sequence parallelism, expert
        parallelism); pipeline: the GPipe schedule over layer stages.
      init_hook: a module-level callable every rank runs at setup.
    """

    # RayAccelerator's and HorovodRayAccelerator's keyword
    use_gpu = False

    def __init__(self, num_workers: Optional[int] = None, *,
                 use_fsdp: bool = False, tensor: int = 1, sequence: int = 1,
                 pipeline: int = 1, expert: int = 1,
                 dcn_data: int = 1, dcn_pipeline: int = 1,
                 init_hook: Optional[Callable[[], None]] = None,
                 devices: Optional[list] = None,
                 num_hosts: int = 1,
                 agents: Optional[list] = None):
        if num_workers is not None and num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        dp = -1 if num_workers is None else num_workers
        if use_fsdp:
            cfg = mesh_lib.MeshConfig(data=1, fsdp=dp, tensor=tensor,
                                      sequence=sequence, pipeline=pipeline,
                                      expert=expert)
        else:
            cfg = mesh_lib.MeshConfig(data=dp, tensor=tensor,
                                      sequence=sequence, pipeline=pipeline,
                                      expert=expert)
        super().__init__(cfg, init_hook=init_hook, use_fsdp=use_fsdp,
                         dcn_data=dcn_data, dcn_pipeline=dcn_pipeline,
                         devices=devices)
        self.num_workers = num_workers
        self.num_hosts = num_hosts
        self.agents = list(agents) if agents else None

    def unported(self):
        return super().unported() + [
            (self.agents is not None, "host agents (agents=)", "runtime")]

    def bind_device(self, device) -> None:
        super().bind_device(device)
        if self.use_gpu and self.device_type != "cuda":
            raise ValueError(
                f"{type(self).__name__}(use_gpu=True) but the trainer runs "
                f"on {self.device_type!r}; drop use_gpu or train on the "
                f"card")

    def launch_spec(self):
        if self.num_hosts > 1:
            log.warning(
                "%s(num_hosts=%d) has no host agents (they come with the "
                "runtime slice); running its %d ranks on this host",
                type(self).__name__, self.num_hosts, self.world_size)
        return super().launch_spec()


class RayAccelerator(RayTPUAccelerator):
    """The reference's DDP accelerator signature."""

    def __init__(self, num_workers: int = 1, num_cpus_per_worker: int = 1,
                 use_gpu: bool = False,
                 init_hook: Optional[Callable[[], None]] = None, **kwargs):
        self.num_cpus_per_worker = num_cpus_per_worker
        self.use_gpu = use_gpu
        super().__init__(num_workers=num_workers, init_hook=init_hook,
                         **kwargs)


class HorovodRayAccelerator(RayTPUAccelerator):
    """The reference's hosts x slots accelerator: ``num_hosts *
    num_slots`` ranks."""

    def __init__(self, num_hosts: int = 1, num_slots: int = 1,
                 use_gpu: bool = False,
                 init_hook: Optional[Callable[[], None]] = None, **kwargs):
        self.num_slots = num_slots
        self.use_gpu = use_gpu
        super().__init__(num_workers=num_hosts * num_slots,
                         init_hook=init_hook, num_hosts=num_hosts, **kwargs)
