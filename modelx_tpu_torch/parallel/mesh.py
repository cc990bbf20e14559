"""Mesh specs and the port's live mesh (counterpart of
``modelx_tpu/parallel/mesh.py``).

Mesh specs are the string form stored in manifests / modelx.yaml
(``modelx.shard.mesh`` annotation), e.g. ``"dp=2,tp=4"`` or
``"dp=1,sp=2,tp=4"``. Axis names (scaling-book vocabulary):

    dp — data parallel (batch)           ep — expert parallel (MoE)
    tp — tensor/model parallel           pp — pipeline stage parallel
    sp — sequence/context parallel       fsdp — fully-sharded data parallel

A size of -1 means "absorb the remaining devices" (like a reshape).

The reference lays a ``jax.sharding.Mesh`` over the devices of one
process. The port runs one process per card: a rank is a device, the mesh
lays ranks 0..size-1 out row-major over the axes (rank r sits where the
reference puts device r), and each axis gets its process group from
``torch.distributed.device_mesh``. A ``Mesh`` made without a process group
is the arithmetic only (sizes, ``mesh_str``, ``weight_shard_factor``): the
tests and the pool's budget need no more.
"""

from __future__ import annotations

import dataclasses
import math

import torch

AXIS_BATCH = "dp"
AXIS_MODEL = "tp"
AXIS_SEQUENCE = "sp"
AXIS_EXPERT = "ep"
AXIS_STAGE = "pp"
AXIS_FSDP = "fsdp"

KNOWN_AXES = (AXIS_BATCH, AXIS_FSDP, AXIS_STAGE, AXIS_EXPERT, AXIS_SEQUENCE, AXIS_MODEL)

# axes whose size divides each device's WEIGHT bytes: tensor/expert/stage
# parallelism and ZeRO-3 all shard the parameters themselves. dp and sp
# replicate parameters (they shard batch/sequence), so they never reduce
# the per-device footprint.
WEIGHT_SHARDING_AXES = (AXIS_FSDP, AXIS_STAGE, AXIS_EXPERT, AXIS_MODEL)


@dataclasses.dataclass
class MeshSpec:
    axes: dict[str, int]  # ordered: outermost first, tp innermost

    def __str__(self) -> str:
        return ",".join(f"{k}={v}" for k, v in self.axes.items())

    @property
    def size(self) -> int:
        return math.prod(self.axes.values())


def parse_mesh_spec(spec: str) -> MeshSpec:
    """``"dp=2,tp=4"`` -> MeshSpec. Order in the string is mesh order; put
    the most communication-hungry axis (tp) last so its ranks are
    neighbours."""
    axes: dict[str, int] = {}
    if not spec.strip():
        raise ValueError("empty mesh spec")
    for part in spec.split(","):
        name, _, size = part.strip().partition("=")
        if not name or not size:
            raise ValueError(f"bad mesh spec segment {part!r} (want name=size)")
        try:
            n = int(size)
        except ValueError:
            raise ValueError(f"bad mesh axis size {size!r}") from None
        if n == 0 or n < -1:
            raise ValueError(f"bad mesh axis size {n} for {name}")
        if name in axes:
            raise ValueError(f"duplicate mesh axis {name!r}")
        axes[name] = n
    if sum(1 for v in axes.values() if v == -1) > 1:
        raise ValueError("at most one axis may be -1")
    return MeshSpec(axes=axes)


def resolve_axes(spec: str | MeshSpec, n: int) -> dict[str, int]:
    """The axis sizes of ``spec`` over ``n`` devices: a -1 axis absorbs
    what the others leave; the mesh may be smaller than ``n`` (it takes a
    device prefix) but never larger. The reference's messages."""
    if isinstance(spec, str):
        spec = parse_mesh_spec(spec)
    axes = dict(spec.axes)
    fixed = math.prod(v for v in axes.values() if v != -1)
    for name, v in axes.items():
        if v == -1:
            if n % fixed:
                raise ValueError(f"{n} devices not divisible by {fixed} for axis {name!r}")
            axes[name] = n // fixed
            fixed = math.prod(axes.values())
    total = math.prod(axes.values())
    if total > n:
        raise ValueError(f"mesh {spec} needs {total} devices, have {n}")
    return axes


class Mesh:
    """Ranks 0..size-1 on named axes, row-major (the last axis varies
    fastest). ``shape`` maps each axis to its size, as a JAX mesh's does.

    A live mesh (``rank`` set) wraps a ``DeviceMesh``: ``group(axis)`` is
    the process group of this rank's line along ``axis`` and
    ``coord[axis]`` its index there; ``device`` is the card (or the CPU)
    this rank computes on. A rank past the mesh's prefix of the world has
    no coordinate."""

    def __init__(self, axes: dict[str, int], devices: int, rank: int | None = None,
                 device_mesh=None, device: torch.device | None = None,
                 mesh_group=None) -> None:
        self.shape = dict(axes)
        self.axis_names = tuple(axes)
        self.size = math.prod(axes.values())
        self.devices = int(devices)
        self.rank = rank
        self.device_mesh = device_mesh
        self.device = device
        self._mesh_group = mesh_group
        self.coord: dict[str, int] | None = None
        if rank is not None and rank < self.size:
            idx, coord = rank, {}
            for name in reversed(self.axis_names):
                coord[name] = idx % axes[name]
                idx //= axes[name]
            self.coord = {name: coord[name] for name in self.axis_names}

    def __repr__(self) -> str:
        return f"Mesh({mesh_str(self)}, rank={self.rank})"

    @property
    def live(self) -> bool:
        """Whether the mesh has its process groups (else it is arithmetic,
        at ``rank``'s coordinate when one is given)."""
        return self.device_mesh is not None

    @property
    def is_leader(self) -> bool:
        """Rank 0 (or no process group at all): the rank that orders the
        others' device calls and owns the answers."""
        return not self.rank

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return (self.coord or {}).get(axis, 0)

    def group(self, axis: str):
        """The process group along ``axis`` through this rank, or None when
        the axis has one rank (nothing to communicate)."""
        if self.device_mesh is None or self.coord is None or self.axis_size(axis) <= 1:
            return None
        return self.device_mesh.get_group(axis)

    def all_reduce(self, x: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """Sum (or, ``op="max"``, the maximum of) ``x`` over ``axis`` (in
        place; a one-rank axis is a no-op)."""
        group = self.group(axis)
        if group is not None:
            import torch.distributed as dist

            reduce_op = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
            dist.all_reduce(x, op=reduce_op, group=group)
        return x

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The ``axis`` ranks' ``x`` concatenated along ``dim`` in rank order
        (a one-rank axis returns ``x``)."""
        group = self.group(axis)
        if group is None:
            return x
        import torch.distributed as dist

        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.axis_size(axis))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    def local_rows(self, b: int) -> tuple[int, int]:
        """[start, stop) of the rows of a ``b``-row batch this rank holds: a
        dp slice when dp divides ``b``, else every row (replicated)."""
        dp = self.axis_size("dp")
        if dp > 1 and b % dp == 0:
            n = b // dp
            return self.axis_index("dp") * n, (self.axis_index("dp") + 1) * n
        return 0, b

    def broadcast_from_leader(self, t: torch.Tensor) -> torch.Tensor:
        """Overwrite ``t`` on every rank with rank 0's ``t`` (in place), so
        all ranks continue from the leader's values, not their own."""
        if self.device_mesh is not None and self.size > 1:
            import torch.distributed as dist

            dist.broadcast(t, src=0, group=self._mesh_group)
        return t


def make_mesh(spec: str | MeshSpec, devices=None,
              device: torch.device | str | None = None) -> Mesh:
    """A mesh over ``devices`` (a count or a sequence).

    With ``devices`` None and a process group initialized, the mesh is
    live over the world's ranks (a prefix of them when it is smaller): a
    ``DeviceMesh`` with the named axes ("cuda" under NCCL, else "cpu"),
    whose groups every rank of the world must join, so every rank calls
    this. ``device`` is this rank's compute device (default:
    ``distributed.local_device``). Without a process group the mesh is over
    this process's one device, and a count gives the arithmetic only."""
    import torch.distributed as dist

    if isinstance(spec, str):
        spec = parse_mesh_spec(spec)
    if devices is not None:
        n = devices if isinstance(devices, int) else len(list(devices))
        return Mesh(resolve_axes(spec, n), n)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(resolve_axes(spec, 1), 1)
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from modelx_tpu_torch.parallel import distributed

    world, rank = dist.get_world_size(), dist.get_rank()
    axes = resolve_axes(spec, world)
    total = math.prod(axes.values())
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    names, sizes = tuple(axes), tuple(axes.values())
    if total == world:
        dm = init_device_mesh(device_type, sizes, mesh_dim_names=names)
        mesh_group = None  # the world
    else:
        dm = DeviceMesh(device_type, torch.arange(total).reshape(sizes), mesh_dim_names=names)
        mesh_group = dist.new_group(list(range(total)))
    dev = torch.device(device) if device is not None else distributed.local_device()
    return Mesh(axes, world, rank=rank, device_mesh=dm, device=dev, mesh_group=mesh_group)


def single_device_mesh() -> Mesh:
    """A dp=1 mesh over this process's one device."""
    return Mesh({AXIS_BATCH: 1}, 1)


def mesh_str(mesh) -> str:
    """Canonical ``"dp=2,tp=4"`` form of a mesh (or a ``MeshSpec``): the
    annotation / env-key spelling, round-trippable through
    :func:`parse_mesh_spec`."""
    axes = mesh.axes if isinstance(mesh, MeshSpec) else mesh.shape
    return ",".join(f"{k}={v}" for k, v in dict(axes).items())


def weight_shard_factor(mesh) -> int:
    """How many ways the mesh divides a model's weight bytes: the
    per-device footprint divisor the budget uses. A dp-only mesh returns 1:
    every device holds the full replica."""
    axes = mesh.axes if isinstance(mesh, MeshSpec) else mesh.shape
    return math.prod(int(size) for name, size in dict(axes).items()
                     if name in WEIGHT_SHARDING_AXES)
