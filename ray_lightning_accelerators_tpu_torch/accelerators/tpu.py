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
  stages, ``parallel/pipeline.py``), with the batch axes.  ``devices=``
  places the ranks on a subset (a tune trial's lease).  ``agents=`` (or
  ``RLA_TPU_AGENTS`` when ``num_hosts > 1``) places the ranks on host
  agents (``runtime/agent.py``) in contiguous blocks, each rank on its
  index among its host's ranks (``cuda:<index>``); the JAX package's
  ``num_hosts`` contract holds: an agent count other than ``num_hosts``
  raises, ``num_hosts > 1`` without agents warns and runs its ranks on
  this host, and explicit agents with ``num_hosts == 1`` still fan out.
  Multi-slice meshes are accepted as keywords and refused by the
  Trainer until their slice lands.
- ``RayAccelerator(num_workers, num_cpus_per_worker, use_gpu,
  init_hook)``: the reference's DDP plugin signature.  The ranks' device
  follows ``Trainer(device=)``; ``use_gpu=True`` with ``device="cpu"``
  is a contradiction and raises.
- ``HorovodRayAccelerator(num_hosts, num_slots)``: ``num_hosts *
  num_slots`` ranks, ``num_slots`` on each host's agent.  Without host
  agents ``num_hosts > 1`` degrades with a warning to that many ranks on
  this host, as the JAX package degrades to its local devices.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional

import torch

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
      devices: the ranks' devices, rank i on entry i (e.g.
        ``tune.trial_devices()``); None = ``cuda:0..`` or the CPU.
      dcn_data, dcn_pipeline: multi-slice meshes.  ``num_workers`` (and
        the model axes) are per granule, one granule a host agent: the
        world is their product times ``dcn_data * dcn_pipeline``, and
        the ``data`` / ``pipeline`` axis is ICI x DCN, crossing agents
        only in its DCN part (JAX ``build_hybrid_mesh``).  E.g.
        ``RayTPUAccelerator(1, agents=[a, b], dcn_data=2)`` is one rank
        on each agent, two batch shards.
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
        # the agents the last launch placed the ranks on, and each rank's
        self._placed_agents: Optional[List[str]] = None
        self._placement: Optional[List[str]] = None

    def resolved_agents(self) -> Optional[List[str]]:
        """The agents this accelerator places its ranks on, by the JAX
        package's ``num_hosts`` contract: ``num_hosts == 1`` fans out only
        over explicit ``agents=`` (an ambient ``RLA_TPU_AGENTS`` must not
        redirect a one-host run); ``num_hosts > 1`` takes ``agents=`` or
        ``RLA_TPU_AGENTS``, and without either warns and runs its ranks
        on this host; a count other than ``num_hosts`` raises."""
        if self.num_hosts <= 1:
            return self.agents
        from ..runtime.agent import agents_from_env
        agents = self.agents or agents_from_env()
        if agents is None:
            log.warning(
                "%s(num_hosts=%d) has no host agents configured (pass "
                "agents=... or set RLA_TPU_AGENTS, agents started with "
                "`rla-tpu-torch agent`); running its %d ranks on this host",
                type(self).__name__, self.num_hosts, self.world_size)
            return None
        if len(agents) != self.num_hosts:
            raise ValueError(
                f"num_hosts={self.num_hosts} but {len(agents)} agent "
                f"addresses were configured ({agents}); the contract is "
                f"one agent per host -- pass exactly num_hosts agents")
        if self.num_workers is not None and \
                self.num_workers % self.num_hosts != 0:
            raise ValueError(
                f"num_workers={self.num_workers} must be divisible by "
                f"num_hosts={self.num_hosts}")
        return agents

    def _agents(self) -> Optional[List[str]]:
        """The agents the ranks are (or will be) placed on: the last
        launch's, else the explicit ``agents=``."""
        return (self._placed_agents if self._placed_agents is not None
                else self.agents)

    def select_devices(self) -> List[torch.device]:
        """Placed on agents, rank i takes its index among its agent's
        ranks (the agents' hosts' cards are not this host's to count);
        otherwise as ``Accelerator.select_devices``."""
        if not self._agents():
            return super().select_devices()
        from ..runtime.agent import local_indices
        placement = self.placement()
        if self.device_type != "cuda":
            return [torch.device("cpu")] * len(placement)
        return [torch.device("cuda", i) for i in local_indices(placement)]

    def placement(self) -> List[str]:
        """Each rank's agent: the contiguous blocks of ``assign_agents``,
        or the placement a resized world keeps (its survivors stay on
        their hosts)."""
        from ..runtime.agent import assign_agents
        cfg = self.mesh_config
        sizes = (cfg.data, cfg.fsdp, cfg.pipeline, cfg.expert,
                 cfg.sequence, cfg.tensor)
        agents = self._agents()
        # "every card" (-1) is one batch shard a host
        n = math.prod(len(agents) if s == -1 else s for s in sizes)
        if -1 not in sizes:
            n *= self.dcn_size
        if self._placement is None or len(self._placement) != n:
            self._placement = assign_agents(agents, n)
        return list(self._placement)

    def granules(self) -> List[Any]:
        """Each rank's granule: the index of its host agent (the agents'
        contiguous blocks), or one granule without agents."""
        if not self._agents():
            return super().granules()
        from ..runtime.agent import parse_agent_spec
        addrs = [parse_agent_spec(a)[0] for a in self._agents()]
        return [addrs.index(a) for a in self.placement()]

    def bind_device(self, device) -> None:
        super().bind_device(device)
        if self.use_gpu and self.device_type != "cuda":
            raise ValueError(
                f"{type(self).__name__}(use_gpu=True) but the trainer runs "
                f"on {self.device_type!r}; drop use_gpu or train on the "
                f"card")

    def launch_spec(self):
        # resolved once on the driver; the ranks read the same list from
        # the accelerator they are shipped
        agents = self.resolved_agents()
        if agents != self._placed_agents:
            self._placed_agents, self._placement = agents, None
        spec = super().launch_spec()
        if agents:
            spec["agents"] = agents
        return spec


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
