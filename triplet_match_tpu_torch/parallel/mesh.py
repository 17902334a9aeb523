"""Device meshes and the collectives of the sharded rounds (counterpart of
``triplet_match_tpu.parallel.mesh``).

The reference's only parallelism is ``std::async`` over RANSAC chunks and
OpenMP over voxels (include/impl/scene.hpp:146-166, impl/model.hpp:81).  The
JAX package maps hypothesis chunks and scene shards onto a ``jax.sharding.Mesh``;
here a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the process group, one process per rank (torchrun, or ``distributed.run_local``
on one machine), with the JAX package's dimension names: ``("chips",)``,
``("dp", "sp")`` or ``("dcn", "dp", "sp")``.

This module is the one home of the collectives the rounds use, one per JAX
collective: ``all_gather`` (tiled along an axis, ``lax.all_gather(tiled=True)``),
``psum`` (``lax.psum``), ``pmax`` (``lax.pmax``) and ``por`` (the OR-reduce of
first-sample marks), and ``broadcast_first``, which hands every rank rank 0's
value of a host statistic.  Each takes the mesh and a dimension name (or a
tuple of names, reduced one after another) and calls ``torch.distributed`` on
``mesh.get_group(name)``; a dimension of one rank returns its input unchanged
without a call, so a one-rank mesh makes no collective at all.

Every collective here takes the tensors where they lie, CUDA ones included,
under NCCL or gloo (gloo's CUDA support covers ``all_reduce``, ``broadcast``
and the list form of ``all_gather``, which are all this module calls).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

HYP_AXIS = "chips"
# the dimension names of the 2-D / 3-D meshes (parallel/search2d.py)
DCN_AXIS = "dcn"
DP_AXIS = "dp"
SP_AXIS = "sp"
# the torch.profiler range around every collective call (host time, waits
# included): a profile of a sharded search reads its collective share off it
COLLECTIVE = "collective"


class MeshAxis(NamedTuple):
    """A mesh dimension (or a tuple of dimensions) that a reduction runs over:
    the ``group=`` argument of the scorers, ICP and the join."""

    mesh: object  # DeviceMesh
    name: str | tuple


def _device_type(device_type: str | None) -> str:
    if device_type is None:
        device_type = "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' mesh needs a CUDA card, and this process sees none; "
                           "pass device_type='cpu' for a mesh of CPU ranks")
    return device_type


def init_mesh(shape: tuple, names: tuple, device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` over the first ranks of the process group
    (row-major), named ``names``; raises when the world is smaller."""
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= int(s)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        # an error, not a silent truncation: --dp 8 on 4 ranks would otherwise
        # get half the sampling throughput with no hint
        raise ValueError(f"need {n} ranks, the process group has {world} "
                         "(torchrun --nproc-per-node, or distributed.run_local)")
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize() first")
    return init_device_mesh(_device_type(device_type), tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(names))


def make_mesh(n_devices: int | None = None, axis: str = HYP_AXIS, *, device_type=None):
    """1-D mesh over ``n_devices`` ranks (default: the whole world)."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    return init_mesh((n_devices,), (axis,), device_type)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors lie on under ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _names(name) -> tuple:
    return tuple(name) if isinstance(name, (tuple, list)) else (name,)


def extent(mesh, name) -> int:
    """Number of ranks along ``name`` (a dimension or a tuple of them)."""
    n = 1
    for d in _names(name):
        n *= mesh.size(mesh.mesh_dim_names.index(d))
    return n


def all_gather(x: torch.Tensor, mesh, name, axis: int = 0) -> torch.Tensor:
    """Concatenation along ``axis`` of every rank's ``x`` over ``name``, in
    rank order (``lax.all_gather(..., tiled=True)``); a tuple of names gathers
    the last name first, so the result is in row-major mesh order."""
    for d in reversed(_names(name)):
        size = extent(mesh, d)
        if size == 1:
            continue
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        with torch.profiler.record_function(COLLECTIVE):
            dist.all_gather(parts, x, group=mesh.get_group(d))
        x = torch.cat(parts, dim=axis)
    return x


def _all_reduce(x: torch.Tensor, mesh, name, op) -> torch.Tensor:
    for d in _names(name):
        if extent(mesh, d) == 1:
            continue
        x = x.clone().contiguous()
        with torch.profiler.record_function(COLLECTIVE):
            dist.all_reduce(x, op=op, group=mesh.get_group(d))
    return x


def psum(x: torch.Tensor, mesh, name) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``name`` (``lax.psum``)."""
    return _all_reduce(x, mesh, name, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh, name) -> torch.Tensor:
    """Maximum of ``x`` over the ranks of ``name`` (``lax.pmax``)."""
    return _all_reduce(x, mesh, name, dist.ReduceOp.MAX)


def por(x: torch.Tensor, mesh, name) -> torch.Tensor:
    """Logical OR of boolean ``x`` over the ranks of ``name``."""
    if extent(mesh, name) == 1:
        return x
    return pmax(x.to(torch.int32), mesh, name) > 0


def broadcast_first(value: float, mesh) -> float:
    """Rank 0's ``value`` on every rank of ``mesh`` (which covers the world):
    host statistics computed in floating point on every rank (the ball
    population quantile, the fog switch) are taken from one rank, so no two
    ranks branch apart on a last-bit difference."""
    if mesh.size() == 1:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64, device=mesh_device(mesh))
    with torch.profiler.record_function(COLLECTIVE):
        dist.broadcast(t, src=0)
    return float(t.item())


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is a DeviceMesh over every rank of the process
    group: every rank is a controller and runs the whole search, so a rank
    outside the mesh would skip collectives the others wait in."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh (parallel.mesh.make_mesh, "
                        f"parallel.search2d.make_mesh_2d / _3d), not {type(mesh).__name__}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh.size() != world:
        raise ValueError(f"the mesh holds {mesh.size()} of the {world} ranks; a search needs "
                         "a mesh over every rank")


def flat_rank(mesh) -> int:
    """This rank's row-major index in ``mesh``."""
    coord = mesh.get_coordinate()
    idx = 0
    for i, c in enumerate(coord):
        idx = idx * mesh.size(i) + c
    return idx


def group_extent(group) -> int:
    """Number of ranks a ``MeshAxis`` spans (1 for None)."""
    return 1 if group is None else extent(*group)


def sharded(group) -> bool:
    """Whether ``group`` (a ``MeshAxis`` or None) spans more than one rank:
    only then do the scorers, ICP and the join take their sharded forms, so a
    one-rank dimension runs the single-device code unchanged."""
    return group_extent(group) > 1
