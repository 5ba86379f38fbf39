"""Process groups, device meshes and sharding helpers on torch.distributed.

Port of python_5gtoolbox_tpu/parallel/mesh.py. The JAX package shards
arrays over the devices of one program (SPMD under jit); here every rank
is a process that holds its own block, and the work between blocks is an
explicit collective:

  * data parallelism over slots, code blocks and SNR points ("dp"):
    shard_batch hands a rank its contiguous block of the leading axis,
    gather puts the blocks back together;
  * the time (sample) axis of the channel filter ("sp"):
    parallel/timeshard.py, halos sent between neighbouring ranks;
  * the ML equalizer's candidate axis ("tp"): parallel/tp.py;
  * sweep granularity: sweep_split, disjoint SNR points per rank and one
    all_gather at the end.

Meshes are torch.distributed.device_mesh.DeviceMesh objects with the JAX
package's axis names; an axis stands for its process group. The backend
is nccl where each rank has a card of its own, else gloo (a CPU host, or
several ranks sharing one card: nccl refuses two ranks on one device).
gloo moves host tensors only, so under gloo the collectives here stage a
CUDA tensor through the host and put the result back on its device.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from python_5gtoolbox_tpu_torch import resolve_device


def default_backend(local_world_size: int | None = None) -> str:
    """nccl when every rank of this host has a card of its own, else
    gloo."""
    if local_world_size is None:
        local_world_size = int(os.environ.get(
            "LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1")))
    if dist.is_nccl_available() and torch.cuda.is_available() \
            and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     backend: str | None = None) -> bool:
    """Join the process group once. Arguments default to the env://
    variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); explicit ones
    take precedence. Returns True if a group of more than one rank is
    up, False on a single process with nothing to join (no address, no
    world size), where it starts nothing."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None and world_size is None \
            and "MASTER_ADDR" not in os.environ:
        return False
    dist.init_process_group(
        backend or default_backend(world_size),
        init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)
    return dist.get_world_size() > 1


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` when given; else the card of its local
    rank under nccl, and the card (ranks share it) under gloo."""
    if device is not None:
        return resolve_device(device)
    if dist.is_initialized() and dist.get_backend() == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        return resolve_device(f"cuda:{local % torch.cuda.device_count()}")
    return resolve_device(None)


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: int | None = None, axis: str = "dp"):
    """1-D mesh over the first n_devices ranks (default: all)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    n = dist.get_world_size() if n_devices is None else n_devices
    if n == dist.get_world_size():
        return init_device_mesh(_mesh_device_type(), (n,),
                                mesh_dim_names=(axis,))
    return DeviceMesh(_mesh_device_type(), torch.arange(n),
                      mesh_dim_names=(axis,))


def make_host_chip_mesh(axes: tuple[str, str] = ("host", "chip")):
    """2-D (host, chip) mesh over every rank: a row holds one host's
    ranks (LOCAL_WORLD_SIZE, default all ranks on one host)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    return init_device_mesh(_mesh_device_type(), (n // per_host, per_host),
                            mesh_dim_names=tuple(axes))


def make_mesh_2d(rows: int, cols: int, axes: tuple[str, str] = ("dp", "sp")):
    """rows x cols mesh over the first rows * cols ranks."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    n = dist.get_world_size()
    if rows * cols > n:
        raise ValueError(f"a {rows} x {cols} mesh needs {rows * cols} "
                         f"ranks, the group has {n}")
    if rows * cols == n:
        return init_device_mesh(_mesh_device_type(), (rows, cols),
                                mesh_dim_names=tuple(axes))
    return DeviceMesh(_mesh_device_type(),
                      torch.arange(rows * cols).reshape(rows, cols),
                      mesh_dim_names=tuple(axes))


def axis_group(mesh, axis="dp"):
    """(process group, size, this rank's index) of a mesh axis; a tuple
    of every axis name of the mesh, in order, stands for the whole mesh
    (JAX's ("dp", "sp")), which must be the whole group; mesh None: the
    whole group."""
    if mesh is None or (isinstance(axis, tuple)
                        and tuple(axis) == tuple(mesh.mesh_dim_names)):
        if mesh is not None and mesh.size() != dist.get_world_size():
            raise ValueError("a mesh's flattened axes must span every rank")
        return dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(dim), mesh.shape[dim], mesh.get_local_rank(dim)


def _host_staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """x as the backend sends it: contiguous, real (complex as pairs of
    floats, bool as bytes), on the host under gloo."""
    if x.is_complex():
        x = torch.view_as_real(x.contiguous())
    elif x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if _host_staged(group):
        x = x.cpu()
    return x.contiguous()


def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_complex():
        t = torch.view_as_complex(t.contiguous())
    elif like.dtype == torch.bool:
        t = t.bool()
    return t.to(like.device)


def shard_batch(mesh, x: torch.Tensor, axis="dp", dim: int = 0):
    """This rank's contiguous block of x along dim (default the leading
    axis); the length must divide evenly over the axis."""
    _, n, r = axis_group(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"length {x.shape[dim]} of dim {dim} does not "
                         f"divide over the {n} ranks of axis {axis!r}")
    b = x.shape[dim] // n
    return x.narrow(dim, r * b, b)


def replicate(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank holds the whole tensor: x as it is."""
    return x


def gather(mesh, x: torch.Tensor, axis="dp", dim: int = 0) -> torch.Tensor:
    """Inverse of shard_batch: the ranks' blocks concatenated along dim in
    rank order, on every rank, on x's device."""
    group, n, _ = axis_group(mesh, axis)
    if n == 1:
        return x
    t = _wire(x, group)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    d = dim % x.dim()
    return _unwire(torch.cat(parts, dim=d), x)


def all_gather_stack(mesh, x: torch.Tensor, axis="dp") -> torch.Tensor:
    """(n, *x.shape): every rank's x in rank order, on every rank."""
    return gather(mesh, x[None], axis, dim=0)


def all_reduce_min(mesh, x: torch.Tensor, axis="dp") -> torch.Tensor:
    """Elementwise minimum of x over the ranks of the axis."""
    group, n, _ = axis_group(mesh, axis)
    if n == 1:
        return x
    t = _wire(x, group).clone()
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return _unwire(t, x)


def sweep_split(points, fn, mesh=None, axis="dp") -> list:
    """Sweep-granularity split: rank r runs fn(point) for the points
    i % n == r, with no communication during the work, and one
    all_gather of the results at the end merges them. Returns every
    point's result, in order, on every rank."""
    group, n, r = axis_group(mesh, axis)
    mine = {i: fn(p) for i, p in enumerate(points) if i % n == r}
    parts = [None] * n
    dist.all_gather_object(parts, mine, group=group)
    merged = {}
    for part in parts:
        merged.update(part)
    return [merged[i] for i in range(len(points))]
