"""Process-group entry, meshes over every rank, scene shards and a local
launcher (counterpart of ``triplet_match_tpu.parallel.distributed``).

The reference is a single-process library (``std::async`` threads only,
include/impl/scene.hpp:146-166).  The JAX package runs one controller per
host over a global device list; here every rank is a process of its own and a
controller, which makes the JAX package's multi-controller conventions this
package's only mode:

* every rank passes IDENTICAL host inputs (model, scene, policy, seed) to the
  search;
* scene-length tensors are sharded along the mesh's ``sp`` dimension by
  :func:`make_global_cloud` / :func:`make_global_array` (each rank hands in
  the full copy and keeps its own shard, a view);
* ``driver.find_all``'s host loop reads only replicated values: the sharded
  round all-gathers its per-point outputs over ``sp`` whenever sp > 1, and
  every statistic a branch reads came from a collective or from inputs every
  rank holds whole.

On a node with one card per rank, ``torchrun`` starts the ranks and
:func:`initialize` forms the NCCL group from its environment.  On one machine
:func:`run_local` spawns the ranks itself (the counterpart of the JAX
package's virtual host devices); ranks that share one card do so through gloo,
which NCCL does not allow.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist

from triplet_match_tpu_torch.parallel.mesh import (  # noqa: F401 (the axis names, as in JAX)
    DCN_AXIS,
    DP_AXIS,
    SP_AXIS,
    init_mesh,
)

DEFAULT_TIMEOUT_S = 60.0


def default_backend(local_ranks: int, device_type: str = "cuda") -> str:
    """NCCL when every local rank has a card of its own, gloo otherwise (CPU
    ranks, or several ranks sharing one card)."""
    if device_type == "cuda" and torch.cuda.is_available() and \
            torch.cuda.device_count() >= local_ranks:
        return "nccl"
    return "gloo"


def _set_device(backend: str, device_type: str, local_rank: int) -> None:
    if device_type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' rank needs a CUDA card, and this process sees none")
    # NCCL: one card per rank; gloo ranks share the first card
    torch.cuda.set_device(local_rank if backend == "nccl" else 0)


def initialize(backend: str | None = None, *, device_type: str = "cuda",
               timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Join (or form) the process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``), and select this rank's card.  Idempotent: a second
    call in an initialized process does nothing.  The backend defaults to
    :func:`default_backend`; it is logged on stderr by rank 0."""
    if dist.is_initialized():
        return
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    backend = backend or default_backend(local_world, device_type)
    _set_device(backend, device_type, local_rank)
    # NCCL binds its communicator to this rank's card instead of guessing it
    device_id = torch.device("cuda", local_rank) if backend == "nccl" else None
    dist.init_process_group(backend, init_method="env://", device_id=device_id,
                            timeout=datetime.timedelta(seconds=timeout))
    if dist.get_rank() == 0:
        print(f"[distributed] {dist.get_world_size()} ranks, backend {backend}, device "
              f"{device_type}", file=sys.stderr, flush=True)


def make_global_mesh(shape: dict, device_type: str | None = None):
    """Mesh over the ranks of the process group, e.g.
    ``make_global_mesh({"dp": 2, "sp": 4})``.  Dimension order follows the
    dict; keep scene sharding ("sp") last, so its collectives join
    neighbouring ranks (one node's cards in torchrun's rank order)."""
    return init_mesh(tuple(shape.values()), tuple(shape.keys()), device_type)


def shard_bounds(mesh, n: int, axis: str = SP_AXIS) -> tuple[int, int]:
    """(offset, length) of this rank's shard of ``n`` points along ``axis``."""
    if axis not in (mesh.mesh_dim_names or ()):
        return 0, n
    sp = mesh.size(mesh.mesh_dim_names.index(axis))
    if n % sp:
        raise ValueError(f"{n} points are not divisible by the {axis} extent {sp}; pad the "
                         "cloud capacity (core.cloud.pad_capacity)")
    nl = n // sp
    return mesh.get_local_rank(axis) * nl, nl


def make_global_array(mesh, host_value: torch.Tensor, axis: str = SP_AXIS) -> torch.Tensor:
    """This rank's shard (a view) along dim 0 of the full ``host_value`` that
    every rank passes."""
    off, nl = shard_bounds(mesh, host_value.shape[0], axis)
    return host_value[off:off + nl]


def make_global_cloud(mesh, cloud, axis: str = SP_AXIS):
    """Shard a PointCloud's point axis over ``axis`` (views of the full,
    replicated cloud every rank passes).  The axis extent must divide the
    point capacity."""
    return dataclasses.replace(cloud, xyz=make_global_array(mesh, cloud.xyz, axis),
                               normal=make_global_array(mesh, cloud.normal, axis),
                               tangent=make_global_array(mesh, cloud.tangent, axis),
                               valid=make_global_array(mesh, cloud.valid, axis))


def _rank_entry(rank, world, store_path, backend, device_type, timeout, fn, args, queue):
    try:
        _set_device(backend, device_type, rank)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, out if rank == 0 else None))
    except BaseException:  # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))
        raise


def run_local(fn, world: int, backend: str | None = None, *args, device_type: str = "cuda",
              timeout: float = DEFAULT_TIMEOUT_S, join_timeout: float | None = None):
    """Run ``fn(*args)`` on ``world`` ranks of this machine and return rank 0's
    result (the counterpart of the JAX package's virtual host devices and of
    ``scripts/dryrun_distributed.py``).

    The ranks are spawned processes (``fn`` and ``args`` are pickled; ``fn``
    must be importable), joined by a FileStore in a temporary directory.  The
    backend defaults to :func:`default_backend` and is logged on stderr; gloo
    ranks of a CUDA run share card 0.  Every collective has the group
    ``timeout`` (seconds), and the whole run ``join_timeout`` (default 10x
    that), so a desynchronised collective fails instead of hanging.  Raises
    with the failing rank's traceback."""
    import queue as queue_mod

    import torch.multiprocessing as mp

    backend = backend or default_backend(world, device_type)
    print(f"[distributed] run_local: {world} ranks, backend {backend}, device {device_type}",
          file=sys.stderr, flush=True)
    join_timeout = 10.0 * timeout if join_timeout is None else join_timeout
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="tm_store_") as d:
        store_path = os.path.join(d, "store")
        procs = [ctx.Process(target=_rank_entry, daemon=True,
                             args=(r, world, store_path, backend, device_type, timeout, fn,
                                   args, q)) for r in range(world)]
        for p in procs:
            p.start()
        results, failures = {}, []
        deadline = datetime.datetime.now() + datetime.timedelta(seconds=join_timeout)
        try:
            while len(results) + len(failures) < world:
                left = (deadline - datetime.datetime.now()).total_seconds()
                if left <= 0:
                    raise TimeoutError(f"run_local: {world - len(results)} of {world} ranks did "
                                       f"not finish within {join_timeout:.0f} s")
                try:
                    rank, ok, payload = q.get(timeout=min(left, 5.0))
                except queue_mod.Empty:
                    dead = [p for p in procs if p.exitcode not in (None, 0)]
                    if dead and not failures:
                        failures.append((procs.index(dead[0]),
                                         f"exit code {dead[0].exitcode} without a report"))
                    if failures:
                        break
                    continue
                if ok:
                    results[rank] = payload
                else:
                    failures.append((rank, payload))
                    break
        finally:
            for p in procs:
                p.join(timeout=5.0 if not failures and len(results) == world else 0.5)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5.0)
        if failures:
            rank, tb = failures[0]
            raise RuntimeError(f"run_local: rank {rank} failed:\n{tb}")
        return results[0]
