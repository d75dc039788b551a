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
- ``build_hybrid_mesh`` / ``hybrid_rank_array``: a multi-slice mesh
  (JAX ``build_hybrid_mesh`` / ``hybrid_device_array``).  JAX makes a
  granule of each slice (or process); the port makes one of each host
  agent's ranks, a world without agents being one granule.  The DCN
  axes (``data``, ``pipeline``) cross granules and the inner (ICI) axes
  stay inside one, so the rank at each mesh position is the one JAX's
  layout puts there for devices of the same granules.  The mesh carries
  that layout as ``order``; ``RankMesh`` coordinates and groups follow
  it.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
    Mesh.shape``); its size is the number of ranks.  ``order``: the rank
    at each mesh position, positions in ``AXIS_ORDER`` row-major (a
    hybrid mesh's layout); None puts rank i at position i."""

    shape: dict
    order: Optional[Tuple[int, ...]] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The coordinates of ``rank`` on this mesh."""
        pos = rank if self.order is None else self.order.index(rank)
        return rank_coords(self.shape, pos)


def build_mesh(config: MeshConfig, num_devices: int) -> Mesh:
    return Mesh(config.axis_sizes(num_devices))


def hybrid_rank_array(ici_shape: Sequence[int], dcn_shape: Sequence[int],
                      granules: Sequence[Any]) -> List[int]:
    """The rank at each position of a multi-slice mesh of shape
    ``ici * dcn`` (per axis, in ``AXIS_ORDER``, row-major): JAX
    ``mesh_utils.create_hybrid_device_mesh`` over ranks.  ``granules[r]``
    is rank r's granule key; the granules, sorted by key, are numbered
    row-major over ``dcn_shape``, and each lays its ranks (in rank
    order) row-major over ``ici_shape``.  A granule count other than
    ``prod(dcn_shape)``, or a granule of another size than
    ``prod(ici_shape)``, raises ``ValueError``."""
    ici, dcn = tuple(int(x) for x in ici_shape), tuple(int(x) for x in
                                                      dcn_shape)
    keys = sorted(set(granules))
    if len(keys) != math.prod(dcn):
        raise ValueError(f"Number of slices {len(keys)} must equal the "
                         f"product of dcn_mesh_shape {dcn}")
    members = [[r for r, g in enumerate(granules) if g == k] for k in keys]
    for k, ranks in zip(keys, members):
        if len(ranks) != math.prod(ici):
            raise ValueError(
                f"granule {k!r} holds {len(ranks)} ranks; the ICI mesh "
                f"{ici} needs {math.prod(ici)}")

    def ravel(idx, dims):
        r = 0
        for i, n in zip(idx, dims):
            r = r * n + i
        return r

    full = [i * d for i, d in zip(ici, dcn)]
    return [members[ravel([p // i for p, i in zip(pos, ici)], dcn)]
            [ravel([p % i for p, i in zip(pos, ici)], ici)]
            for pos in itertools.product(*(range(n) for n in full))]


def build_hybrid_mesh(config: MeshConfig, num_ranks: int,
                      granules: Sequence[Any], dcn_data: int = 1,
                      dcn_pipeline: int = 1) -> Mesh:
    """A multi-slice mesh (JAX ``build_hybrid_mesh``): the ICI axes of
    ``config``, sized per granule, inside each granule, ``data`` and
    ``pipeline`` across granules; each axis's size is ICI x DCN.  Only
    these two may cross DCN: their collectives (the gradient mean, the
    stage boundary) tolerate slow links.  One DCN group is the plain
    mesh; a world that cannot split into the groups raises
    ``ValueError``."""
    n_dcn = dcn_data * dcn_pipeline
    if n_dcn == 1:
        return build_mesh(config, num_ranks)
    if num_ranks % n_dcn:
        raise ValueError(f"{num_ranks} ranks not divisible into {n_dcn} "
                         f"DCN groups")
    ici = config.axis_sizes(num_ranks // n_dcn)
    dcn = {DATA_AXIS: dcn_data, PIPELINE_AXIS: dcn_pipeline}
    order = hybrid_rank_array([ici[a] for a in AXIS_ORDER],
                              [dcn.get(a, 1) for a in AXIS_ORDER], granules)
    return Mesh({a: ici[a] * dcn.get(a, 1) for a in AXIS_ORDER},
                order=tuple(order))


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


def axis_groups(shape: Dict[str, int], axes: Tuple[str, ...],
                order: Optional[Sequence[int]] = None) -> List[List[int]]:
    """Every group of ranks that differ only along ``axes``, each in
    coordinate order (outer axis first), the groups ordered by their
    first rank.  ``order``: the rank at each position (a hybrid mesh's
    layout; None: rank i at position i)."""
    others = [a for a in AXIS_ORDER if a not in axes]
    at = (lambda p: p) if order is None else (lambda p: order[p])
    out = []
    for fixed in itertools.product(*(range(shape.get(a, 1))
                                     for a in others)):
        base = dict(zip(others, fixed))
        out.append([at(coords_rank(shape, {**base, **dict(zip(axes, c))}))
                    for c in itertools.product(*(range(shape.get(a, 1))
                                                 for a in axes))])
    return sorted(out)


# the groups of the current process group, by mesh shape
_GROUPS: Dict[str, Any] = {"world": None, "meshes": {}}


def local_mesh() -> RankMesh:
    """A single process: every axis of size 1, no groups."""
    return RankMesh({a: 1 for a in AXIS_ORDER}, rank=0,
                    coords={a: 0 for a in AXIS_ORDER})


def build_rank_mesh(shape: Dict[str, int],
                    order: Optional[Sequence[int]] = None) -> RankMesh:
    """This rank's ``RankMesh`` for a world of ``shape`` (a collective:
    every rank of the process group calls it with the same shape and
    ``order``, the rank at each position of a hybrid mesh).  The groups
    of a layout are made once per process group."""
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
    order = tuple(order) if order is not None else None
    key = repr((sorted(shape.items()), order))
    rank = dist.get_rank()
    if key not in _GROUPS["meshes"]:
        members, groups = {}, {}
        # every rank makes every group in this order, member or not
        for name, axes in [(a, (a,)) for a in AXIS_ORDER] + [
                ("batch", BATCH_AXES)]:
            if name != "batch" and shape[name] == 1:
                continue
            for ranks in axis_groups(shape, axes, order):
                g = dist.new_group(ranks)
                if rank in ranks:
                    members[name] = ranks
                    groups[name] = g if len(ranks) > 1 else None
        _GROUPS["meshes"][key] = (members, groups)
    members, groups = _GROUPS["meshes"][key]
    mesh = Mesh(shape, order=order)
    return RankMesh(shape, order=order, rank=rank,
                    coords=mesh.coords_of(rank), members=members,
                    groups=groups)

