"""Data and spatial parallelism over processes (port of
``cadepth_tpu.parallel.mesh``).

JAX lays a 1-D mesh over its devices, shards the batch along it and lets
XLA's partitioner insert the collectives. Here each process drives one
card, holds ``batch_size / W`` rows of every global batch and a replica
of the model and the optimizer, and the collectives are written out:

* the losses and the batch norms' training statistics are functions of
  the global batch, through :meth:`DataParallel.sum` and
  :meth:`DataParallel.mean`, all-reduces whose backward all-reduces the
  gradients of their results (``losses/depth_loss.py``,
  ``models/layers.py``);
* every rank back-propagates its copy of the global loss divided by W,
  and the parameter gradients are all-reduced once per update
  (:meth:`DataParallel.all_reduce_`, ``training/train_state.py``).

So W ranks compute the gradient of one process over the whole global
batch, up to the order of the sums. With W = 1 every collective returns
its input and the arithmetic is the single process's, bit for bit.

:func:`make_mesh_2d` (JAX's data x space mesh) splits the W ranks into
D = W / S data rows of S ranks, rank ``d * S + s`` at data index d and
space index s, as in JAX's device grid: the D rows share the global
batch as above, and the S ranks of a row share its samples' image
height, each holding a band of H / S rows (``parallel/spatial.py``). The
batch norms and the losses still reduce over all W ranks: a band's mean
is over as many elements as any other's, and a map that every rank of a
space row holds whole (the levels below those a band reaches,
``models/layers.py``) counts S times in the sum over the W ranks and S
times in W, so the mean is the global batch's either way.

The names follow the JAX module's: :func:`make_mesh` gives the
:class:`DataParallel` of the process group, :func:`batch_sharding` the
rows a rank holds, :func:`image_sharding` the rows and band of an image
it holds, :func:`shard_batch` takes them from a global batch,
:func:`replicate_state` makes every rank's state rank 0's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import torch
import torch.distributed as dist

from cadepth_tpu_torch.parallel.spatial import SpaceGroup, _AllReduceSum

BATCH_KEYS = ("rgb", "depth", "rays", "intrinsics", "k4", "extrinsics")
# the keys of a batch that hold (B, H, W, C) images
IMAGE_KEYS = ("rgb", "depth", "rays")


@dataclasses.dataclass(frozen=True, eq=False)
class DataParallel:
    """This process's place in a data-parallel group: ``rank`` of
    ``world_size`` ranks, each holding ``batch_size / world_size`` rows of
    every global batch. ``group`` carries the tensors (None: the default
    group); ``host_group``, a Gloo group over the same ranks, carries the
    host's flags and barriers. A DataParallel without a process group
    still describes a shard (the datasets read only ``rank`` and
    ``world_size``). Under spatial parallelism ``space`` is this rank's
    :class:`~cadepth_tpu_torch.parallel.spatial.SpaceGroup`, and the
    ``world_size`` ranks are ``data_size`` data rows of ``space.size``."""

    world_size: int
    rank: int
    group: Optional[object] = None
    host_group: Optional[object] = None
    space: Optional[SpaceGroup] = None

    @property
    def data_size(self) -> int:
        """The data rows: the ranks that hold different samples."""
        return self.world_size // (1 if self.space is None
                                   else self.space.size)

    @property
    def data_rank(self) -> int:
        """This rank's data row."""
        return self.rank // (1 if self.space is None else self.space.size)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, differentiable."""
        return _AllReduceSum.apply(x, self.group)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the ranks: the global mean when each
        rank's ``x`` is a mean over as many elements (equal shards)."""
        return self.sum(x) / torch.full((), float(self.world_size),
                                        dtype=x.dtype, device=x.device)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The maximum of ``x`` over the ranks (not differentiable)."""
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def all_reduce_(self, tensors: List[torch.Tensor]) -> None:
        """Sum each tensor over the ranks, in place, as one flat
        all-reduce (the tensors share a dtype and a device)."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view(t.shape))

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (a host all-reduce)."""
        t = torch.tensor([int(flag)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())

    def barrier(self) -> None:
        dist.barrier(group=self.host_group)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """The rows of a global batch's leading axis that ``rank`` holds:
    ``[rank * b / W, (rank + 1) * b / W)``."""

    rank: int
    world_size: int

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % self.world_size:
            raise ValueError(f"batch of {x.shape[0]} rows is not divisible "
                             f"by {self.world_size} ranks")
        n = x.shape[0] // self.world_size
        return x[self.rank * n:(self.rank + 1) * n]


@dataclasses.dataclass(frozen=True)
class ImageShard:
    """A (B, H, W, C) image's part on one rank (JAX's ``P("data",
    "space")``): the rows of :class:`RowShard` ``(rank, world_size)`` of
    the batch, and band ``band`` of ``bands`` along H."""

    rank: int
    world_size: int
    band: int = 0
    bands: int = 1

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        rows = RowShard(self.rank, self.world_size)(x)
        return SpaceGroup(self.bands, self.band).band(rows, 1)


def make_mesh(num_devices: int = 0) -> DataParallel:
    """The :class:`DataParallel` of the default process group, which
    :func:`~cadepth_tpu_torch.parallel.distributed.initialize_distributed`
    joined; ``num_devices`` (0 = the group's size) must be the group's
    size: the launcher, not this call, decides the processes. Every rank
    calls it (it makes the Gloo group for host flags)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call initialize_distributed() first (the "
            "train CLI's --multihost), or launch with torchrun")
    world = dist.get_world_size()
    if num_devices and num_devices != world:
        raise ValueError(f"hardware.num_devices {num_devices} but the "
                         f"process group has {world} ranks")
    host = None if dist.get_backend() == "gloo" else \
        dist.new_group(backend="gloo")
    return DataParallel(world, dist.get_rank(), None, host)


def space_grid(world: int, spatial: int) -> List[List[int]]:
    """JAX's ``make_mesh_2d`` device grid as ranks: world / spatial data
    rows, row d holding ranks ``d * spatial .. (d + 1) * spatial - 1``."""
    if spatial < 1 or world % spatial:
        raise ValueError(f"{world} ranks not divisible by spatial={spatial}")
    return [list(range(d * spatial, (d + 1) * spatial))
            for d in range(world // spatial)]


def make_mesh_2d(num_devices: int = 0, spatial: int = 1) -> DataParallel:
    """The data x space group of the default process group: W /
    ``spatial`` data rows of ``spatial`` ranks, rank ``d * spatial + s`` at
    data index d and space index s (:func:`space_grid`). With ``spatial``
    1 it is :func:`make_mesh`'s group, as JAX's 1-D mesh. Every rank
    calls it: it makes each data row's process group."""
    dp = make_mesh(num_devices)
    if spatial <= 1:
        return dp
    mine = None
    for ranks in space_grid(dp.world_size, spatial):
        group = dist.new_group(ranks=ranks)
        if dp.rank in ranks:
            mine = group
    space = SpaceGroup(spatial, dp.rank % spatial, mine)
    return dataclasses.replace(dp, space=space)


def batch_sharding(mesh: DataParallel) -> RowShard:
    """The rows of each global batch this rank holds (its data row's)."""
    return RowShard(mesh.data_rank, mesh.data_size)


def image_sharding(mesh: DataParallel) -> Union[ImageShard, RowShard]:
    """The part of a global batch's (B, H, W, C) images this rank holds: its
    data row's rows and, under spatial parallelism, its band of H."""
    if mesh.space is None:
        return batch_sharding(mesh)
    return ImageShard(mesh.data_rank, mesh.data_size, mesh.space.rank,
                      mesh.space.size)


def batch_shardings(mesh: DataParallel
                    ) -> Dict[str, Union[ImageShard, RowShard]]:
    """Per key of a batch: :func:`image_sharding` for the images (rgb,
    depth, rays), :func:`batch_sharding` for the per-sample vectors."""
    return {k: image_sharding(mesh) if k in IMAGE_KEYS
            else batch_sharding(mesh) for k in BATCH_KEYS}


def band_batch(batch: Dict[str, torch.Tensor],
               mesh: Optional[DataParallel]) -> Dict[str, torch.Tensor]:
    """A data row's batch (what its feed gives every rank of the row) with
    this rank's band of each image; the batch as it is without spatial
    parallelism."""
    if mesh is None or mesh.space is None:
        return batch
    return {k: mesh.space.band(v, 1) if k in IMAGE_KEYS else v
            for k, v in batch.items()}


def replicate_sharding(mesh: DataParallel):
    """Every rank holds the whole tensor (parameters, optimizer state)."""
    del mesh
    return lambda x: x


def shard_batch(batch: Dict[str, torch.Tensor],
                mesh: DataParallel) -> Dict[str, torch.Tensor]:
    """This rank's part of a global batch: its rows, and its band of each
    image under spatial parallelism."""
    table = batch_shardings(mesh)
    rows = batch_sharding(mesh)
    return {k: table.get(k, rows)(v) for k, v in batch.items()}


def replicate_state(state, mesh: DataParallel):
    """Make ``state`` rank 0's on every rank, in place, and return it:
    ``state`` is a module, or an object with ``model`` and ``optimizer``
    (a ``TrainStep``: parameters, buffers and the optimizer's state)."""
    tensors = []
    modules = [state] if isinstance(state, torch.nn.Module) else [state.model]
    for m in modules:
        tensors += list(m.parameters()) + list(m.buffers())
    if not isinstance(state, torch.nn.Module):
        base = state.optimizer.base
        for per_param in base.state.values():
            tensors += [v for v in per_param.values()
                        if isinstance(v, torch.Tensor)]
    nccl = dist.get_backend(mesh.group) == "nccl"
    with torch.no_grad():
        for t in tensors:
            # NCCL moves device tensors only (Adam keeps its step count on
            # the host)
            moved = nccl and t.device.type != "cuda"
            buf = t.cuda() if moved else t
            dist.broadcast(buf, src=0, group=mesh.group)
            if moved:
                t.copy_(buf)
    return state
