"""Mesh axes, their sizes, and each rank's place on them.

Port of the JAX package's ``parallel/mesh.py``: the axis names and their
order (``AXIS_ORDER``, which the accelerators' ``repr`` follows),
``BATCH_AXES``, ``MeshConfig`` and its ``axis_sizes``,
``mesh_axis_size`` and ``data_parallel_size``.  The port has no device
mesh: a world of N ranks, one device each, is laid out over the axes in
``AXIS_ORDER`` with ``tensor`` innermost, so rank
``((((d*F + f)*P + p)*E + e)*S + s)*T + t`` sits where the JAX package's
device of that index sits, and XLA's collectives become
``torch.distributed`` calls over per-axis process groups.

- ``Mesh``: the axis sizes of a world, the value the sharding plan is
  built for.
- ``RankMesh`` (from ``build_rank_mesh``, inside a formed world): a
  ``Mesh`` that also knows this rank's coordinates and holds one process
  group per axis of size > 1 (the ranks that differ only along it) and
  one for the batch axes (data x fsdp).  The trainer hands it to the
  module (``module.mesh``), as the JAX trainer hands its mesh.  Every
  rank creates every group, in one order, even the groups it is not in
  (``dist.new_group`` is collective over the world); the groups are made
  once per process group and reused by fit, validate, test and predict.
- ``local_mesh``: the ``RankMesh`` of a single process (every axis 1, no
  groups).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Optional, Tuple

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
PIPELINE_AXIS = "pipeline"
SEQUENCE_AXIS = "sequence"
TENSOR_AXIS = "tensor"
EXPERT_AXIS = "expert"

# outermost (slowest links) first, as in the JAX package
AXIS_ORDER = (DATA_AXIS, FSDP_AXIS, PIPELINE_AXIS, EXPERT_AXIS,
              SEQUENCE_AXIS, TENSOR_AXIS)

# the axes a global batch is split over: both plain data parallelism and
# FSDP shard the batch dimension
BATCH_AXES = (DATA_AXIS, FSDP_AXIS)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each mesh axis.  ``-1`` on one axis means "all remaining
    devices"."""

    data: int = -1
    fsdp: int = 1
    pipeline: int = 1
    expert: int = 1
    sequence: int = 1
    tensor: int = 1

    def axis_sizes(self, num_devices: int) -> dict:
        sizes = {
            DATA_AXIS: self.data,
            FSDP_AXIS: self.fsdp,
            PIPELINE_AXIS: self.pipeline,
            EXPERT_AXIS: self.expert,
            SEQUENCE_AXIS: self.sequence,
            TENSOR_AXIS: self.tensor,
        }
        fixed = math.prod(v for v in sizes.values() if v != -1)
        n_infer = sum(1 for v in sizes.values() if v == -1)
        if n_infer > 1:
            raise ValueError("at most one mesh axis may be -1 (inferred)")
        if n_infer == 1:
            if num_devices % fixed != 0:
                raise ValueError(
                    f"cannot infer axis size: {num_devices} devices not "
                    f"divisible by fixed product {fixed}")
            for k, v in sizes.items():
                if v == -1:
                    sizes[k] = num_devices // fixed
        elif fixed != num_devices:
            raise ValueError(
                f"mesh axes multiply to {fixed} but {num_devices} devices "
                f"are available")
        return sizes



@dataclasses.dataclass(frozen=True)
class Mesh:
    """The axis sizes of a world of ranks (``shape``, as ``jax.sharding.
    Mesh.shape``); its size is the number of ranks."""

    shape: dict

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def build_mesh(config: MeshConfig, num_devices: int) -> Mesh:
    return Mesh(config.axis_sizes(num_devices))


def mesh_axis_size(mesh: Optional[Mesh], axis: str) -> int:
    """The size of ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape.get(axis, 1)


def data_parallel_size(mesh: Mesh) -> int:
    """Number of batch shards (the DDP ``world_size``)."""
    return mesh_axis_size(mesh, DATA_AXIS) * mesh_axis_size(mesh, FSDP_AXIS)


@dataclasses.dataclass(frozen=True, eq=False)
class RankMesh(Mesh):
    """The world's axis sizes (``shape``) plus this rank's place on them:
    ``rank``, ``coords`` (axis -> coordinate), ``members`` (axis, and
    ``"batch"`` for the batch axes -> the global ranks of this rank's
    group, in coordinate order) and ``groups`` (the same keys -> the
    ``torch.distributed`` group, None for a group of one rank)."""

    rank: int = 0
    coords: Dict[str, int] = dataclasses.field(default_factory=dict)
    members: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str) -> Any:
        """The group along ``axis`` (``"batch"``: data x fsdp), or None
        when it holds this rank alone."""
        return self.groups.get(axis)

    @property
    def batch_size(self) -> int:
        return data_parallel_size(self)

    @property
    def batch_rank(self) -> int:
        """This rank's shard of the global batch (its coordinate on
        data x fsdp)."""
        return (self.coord(DATA_AXIS) * self.size(FSDP_AXIS)
                + self.coord(FSDP_AXIS))

    @property
    def model_lead(self) -> bool:
        """True on the rank that speaks for its batch shard: coordinate 0
        on every axis other than the batch axes."""
        return all(self.coord(a) == 0 for a in AXIS_ORDER
                   if a not in BATCH_AXES)


def rank_coords(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """The coordinates of ``rank`` in a world laid out in ``AXIS_ORDER``
    (``tensor`` innermost)."""
    coords = {}
    for axis in reversed(AXIS_ORDER):
        n = shape.get(axis, 1)
        coords[axis] = rank % n
        rank //= n
    return coords


def coords_rank(shape: Dict[str, int], coords: Dict[str, int]) -> int:
    """Inverse of ``rank_coords``."""
    r = 0
    for axis in AXIS_ORDER:
        r = r * shape.get(axis, 1) + coords.get(axis, 0)
    return r


def axis_groups(shape: Dict[str, int], axes: Tuple[str, ...]
                ) -> List[List[int]]:
    """Every group of ranks that differ only along ``axes``, each in
    coordinate order (outer axis first), the groups ordered by their
    first rank."""
    others = [a for a in AXIS_ORDER if a not in axes]
    out = []
    for fixed in itertools.product(*(range(shape.get(a, 1))
                                     for a in others)):
        base = dict(zip(others, fixed))
        out.append([coords_rank(shape, {**base, **dict(zip(axes, c))})
                    for c in itertools.product(*(range(shape.get(a, 1))
                                                 for a in axes))])
    return sorted(out)


# the groups of the current process group, by mesh shape
_GROUPS: Dict[str, Any] = {"world": None, "meshes": {}}


def local_mesh() -> RankMesh:
    """A single process: every axis of size 1, no groups."""
    return RankMesh({a: 1 for a in AXIS_ORDER}, rank=0,
                    coords={a: 0 for a in AXIS_ORDER})


def build_rank_mesh(shape: Dict[str, int]) -> RankMesh:
    """This rank's ``RankMesh`` for a world of ``shape`` (a collective:
    every rank of the process group calls it with the same shape).  The
    groups of a shape are made once per process group."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return local_mesh()
    world = dist.get_world_size()
    shape = {a: int(shape.get(a, 1)) for a in AXIS_ORDER}
    if math.prod(shape.values()) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape.values())} "
                         f"ranks but the process group has {world}")
    if _GROUPS["world"] is not dist.group.WORLD:
        _GROUPS.update(world=dist.group.WORLD, meshes={})
    key = repr(sorted(shape.items()))
    rank = dist.get_rank()
    if key not in _GROUPS["meshes"]:
        members, groups = {}, {}
        # every rank makes every group in this order, member or not
        for name, axes in [(a, (a,)) for a in AXIS_ORDER] + [
                ("batch", BATCH_AXES)]:
            if name != "batch" and shape[name] == 1:
                continue
            for ranks in axis_groups(shape, axes):
                g = dist.new_group(ranks)
                if rank in ranks:
                    members[name] = ranks
                    groups[name] = g if len(ranks) > 1 else None
        _GROUPS["meshes"][key] = (members, groups)
    members, groups = _GROUPS["meshes"][key]
    return RankMesh(shape, rank=rank, coords=rank_coords(shape, rank),
                    members=members, groups=groups)

