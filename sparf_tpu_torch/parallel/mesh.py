"""Data parallelism over rays with torch.distributed (torch port of
sparf_tpu/parallel/mesh.py).

The JAX package shards the sampled ray indices over a 1-D device mesh and
lets GSPMD carry the sharding through the MLP, compositing and the losses,
inserting the cross-device sums. Here the "mesh" is the process group: one
process per device, parameters and scene replicated on every rank, and the
rays of a training step split into contiguous per-rank slices.

How a step stays the unsharded step:
  - every rank takes the full draws from the same seeded stream, then keeps
    its own slice (`shard_rays`), so sharded and unsharded steps see the same
    rays;
  - every mean over rays is (local sum) / (global count) (`ray_mean`,
    `global_sum`), so the ranks' losses sum to the unsharded loss;
  - the gradients are summed across ranks (`all_reduce_grads`) before the
    clip, the non-finite check and Adam, so every rank takes the same update.

The mesh is active only while a training step runs (`active`): renders and
losses outside a step (test-time pose refinement) run replicated on every
rank. The host precomputes that a step builds on (the SfM initial poses,
the correspondence pools, triangulated depth) run on rank 0 alone and reach
the other ranks by broadcast (`on_rank0`): the geometry stage is chaotic,
so another process could land on other poses, and a cache file is written
once. `render_image_chunked` takes the mesh explicitly, splits each chunk's
rays across ranks (`shard_padded`) and gathers the results (`gather_rays`).

The backend is the caller's explicit choice (`init_process_group`): NCCL for
CUDA devices, gloo for the CPU. Each collective goes through a wrapper here
that adds its payload to `COLLECTIVE_BYTES`.
"""
from __future__ import annotations

import contextlib
import os
import pickle
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

# payload bytes sent through each kind of collective, per process
COLLECTIVE_BYTES: Dict[str, int] = {"all_reduce": 0, "broadcast": 0, "gather": 0}


def reset_collective_bytes() -> None:
    for k in COLLECTIVE_BYTES:
        COLLECTIVE_BYTES[k] = 0


@dataclass(frozen=True)
class Mesh:
    """The process group as a 1-D mesh over the ray axis."""

    world_size: int
    rank: int
    backend: str


_ACTIVE_MESH: Optional[Mesh] = None


def init_process_group(backend: str, world_size: int, rank: int,
                       init_method: str = "env://") -> None:
    """torch.distributed.init_process_group with the backend named by the
    caller ("nccl" or "gloo"); it is never swapped for another."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    dist.init_process_group(backend, init_method=init_method, world_size=int(world_size),
                            rank=int(rank))


def init_from_env(device: torch.device) -> bool:
    """Join the process group that torchrun describes (RANK, WORLD_SIZE and
    MASTER_ADDR/PORT in the environment): NCCL for a CUDA device, gloo for
    the CPU. Returns False, doing nothing, when WORLD_SIZE is absent or 1."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return dist.is_initialized()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    init_process_group("nccl" if cuda else "gloo", world, int(os.environ["RANK"]))
    return True


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The mesh of the initialised process group; `n_devices`, when given,
    must equal its world size."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs torch.distributed initialised "
                           "(torchrun, or parallel.mesh.init_process_group)")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"mesh_shape [{n_devices}] does not match the world size {world}")
    return Mesh(world, dist.get_rank(), str(dist.get_backend()))


def set_active_mesh(mesh: Optional[Mesh]) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


@contextlib.contextmanager
def active(mesh: Optional[Mesh]) -> Iterator[None]:
    """Make `mesh` the active mesh inside the block (a training step)."""
    saved = _ACTIVE_MESH
    set_active_mesh(mesh)
    try:
        yield
    finally:
        set_active_mesh(saved)


def shard_rays(x: torch.Tensor, axis: int = 0, unit: int = 1) -> torch.Tensor:
    """This rank's contiguous slice of `x` along `axis`, in whole groups of
    `unit` rays (a depth-regularisation patch); the identity without an
    active mesh. Slices differ by at most one group when the count does not
    divide: the losses divide by global counts, so that stays exact."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return x
    axis = axis % x.ndim
    n = x.shape[axis]
    if n % unit:
        raise ValueError(f"{n} rays are not whole groups of {unit}")
    q, r = divmod(n // unit, mesh.world_size)   # torch.tensor_split's sizes
    k = mesh.rank
    return x.narrow(axis, (k * q + min(k, r)) * unit, (q + (k < r)) * unit)


def draw_rays(draws, shape, n_rays: Optional[int]) -> torch.Tensor:
    """draws.uniform(shape) for rays whose axis 1 holds this rank's share of
    `n_rays` (a RayBundle's n_rays): under an active mesh the draw is taken
    at the full count from the shared stream and sliced, so that every rank
    keeps the numbers the unsharded step gives its rays."""
    if _ACTIVE_MESH is None or n_rays is None:
        return draws.uniform(shape)
    full = list(shape)
    full[1] = int(n_rays)
    local = shard_rays(draws.uniform(full), axis=1)
    if tuple(local.shape) != tuple(shape):
        raise ValueError(f"a draw for {tuple(shape)} is not this rank's share of {n_rays} rays")
    return local


def pad_to_multiple(n: int, mesh: Optional[Mesh] = None) -> int:
    """Round a ray count up so that it divides evenly across the mesh."""
    mesh = mesh or _ACTIVE_MESH
    if mesh is None:
        return n
    return -(-n // mesh.world_size) * mesh.world_size


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    COLLECTIVE_BYTES["all_reduce"] += x.numel() * x.element_size()
    dist.all_reduce(x)
    return x


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, without a gradient; `x` itself without
    an active mesh."""
    if _ACTIVE_MESH is None:
        return x
    return _all_reduce(x.detach().clone())


def ray_count(x: torch.Tensor, dim: Optional[int] = None):
    """x.numel() (or x.shape[dim]) summed over the ranks: an int without an
    active mesh, a float tensor under one."""
    n = x.numel() if dim is None else x.shape[dim]
    if _ACTIVE_MESH is None:
        return n
    return global_sum(torch.tensor(float(n), device=x.device))


def ray_mean(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """torch.mean of a tensor sharded over rays (along `dim`, or as a whole)
    as this rank's share: its local sum over the global count, so that the
    ranks' shares sum to the mean."""
    if _ACTIVE_MESH is None:
        return torch.mean(x) if dim is None else torch.mean(x, dim=dim)
    total = torch.sum(x) if dim is None else torch.sum(x, dim=dim)
    return total / ray_count(x, dim)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of a ray-sharded tensor over all ranks, without a gradient
    (for logged statistics)."""
    if _ACTIVE_MESH is None:
        return torch.mean(x.detach())
    return global_sum(torch.sum(x.detach())) / ray_count(x)


def rank_draws(draws):
    """`draws` without an active mesh. Under one, a stream of this rank's own
    for draws that each rank takes at its local shape (the density noise),
    seeded from one draw of the shared stream plus the rank: the
    counterpart of the JAX package's per-shard fold_in, and the same
    departure from the unsharded draw that it documents."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return draws
    from sparf_tpu_torch.utils.draws import Draws

    return Draws(int(draws.randint((), 0, 2**31 - 1)) + mesh.rank, draws.device)


def all_reduce_grads(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """The gradients summed over the ranks, in one flat all-reduce."""
    if _ACTIVE_MESH is None or not grads:
        return grads
    flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    return [p.view_as(g) for p, g in zip(flat.split([g.numel() for g in grads]), grads)]


def all_reduce_scalars(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalars summed over the ranks, in one all-reduce (logged losses)."""
    if _ACTIVE_MESH is None or not values:
        return values
    keys = sorted(values)
    summed = _all_reduce(torch.stack([values[k].detach().reshape(()).to(torch.float32)
                                      for k in keys]))
    return dict(zip(keys, summed.unbind(0)))


def replicate_tree(tree, mesh: Optional[Mesh] = None):
    """Broadcast every tensor of a tree from rank 0, in place; returns the tree."""
    mesh = mesh or _ACTIVE_MESH
    if mesh is None:
        return tree
    from sparf_tpu_torch.training.engine import tree_leaves

    with torch.no_grad():
        for leaf in tree_leaves(tree):
            COLLECTIVE_BYTES["broadcast"] += leaf.numel() * leaf.element_size()
            dist.broadcast(leaf, src=0)
    return tree


def on_rank0(fn: Callable[[], Any], mesh: Optional[Mesh]) -> Any:
    """fn() run on rank 0 alone, its (picklable) result broadcast to every
    rank, so that every rank holds the same bits; a failure on rank 0
    raises on every rank. fn() itself without a mesh of several ranks."""
    if mesh is None or mesh.world_size == 1:
        return fn()
    value, payload, failure = None, b"", None
    if mesh.rank == 0:
        try:
            value = fn()
            payload = pickle.dumps((True, value))
        except Exception as e:  # sent on, so that the other ranks raise too
            failure = e
            payload = pickle.dumps((False, f"{type(e).__name__}: {e}"))
    # NCCL broadcasts CUDA tensors only; gloo takes CPU tensors
    device = (torch.device("cuda", torch.cuda.current_device()) if mesh.backend == "nccl"
              else torch.device("cpu"))
    size = torch.tensor([len(payload)], dtype=torch.int64, device=device)
    dist.broadcast(size, src=0)
    buf = (torch.frombuffer(bytearray(payload), dtype=torch.uint8).to(device) if mesh.rank == 0
           else torch.empty(int(size), dtype=torch.uint8, device=device))
    COLLECTIVE_BYTES["broadcast"] += 8 + buf.numel()
    dist.broadcast(buf, src=0)
    if failure is not None:
        raise failure
    if mesh.rank == 0:
        return value
    ok, value = pickle.loads(buf.cpu().numpy().tobytes())
    if not ok:
        raise RuntimeError(f"rank 0's precompute failed: {value}")
    return value


def shard_padded(x: torch.Tensor, mesh: Optional[Mesh], axis: int = 0) -> torch.Tensor:
    """This rank's equal slice of `x` along `axis`, after padding it to a
    multiple of the world size with trailing copies (the last rays
    repeated); the identity without a mesh."""
    if mesh is None or mesh.world_size == 1:
        return x
    n = x.shape[axis]
    pad = pad_to_multiple(n, mesh) - n
    if pad:
        x = torch.cat([x, x.narrow(axis, n - pad, pad)], dim=axis)
    per = x.shape[axis] // mesh.world_size
    return x.narrow(axis, mesh.rank * per, per)


def gather_rays(x: torch.Tensor, mesh: Optional[Mesh], n: int, axis: int = 0) -> torch.Tensor:
    """The inverse of shard_padded, without a gradient: every rank's slice
    concatenated along `axis` and cropped to `n`. Built on all-reduce (each
    rank adds its slice into zeros), which every backend has for CPU and
    CUDA tensors."""
    if mesh is None or mesh.world_size == 1:
        return x
    per = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = per * mesh.world_size
    full = x.new_zeros(shape)
    full.narrow(axis, mesh.rank * per, per).copy_(x.detach())
    COLLECTIVE_BYTES["gather"] += full.numel() * full.element_size()
    dist.all_reduce(full)
    return full.narrow(axis, 0, n)
