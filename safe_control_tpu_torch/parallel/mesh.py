"""Multi-device scale-out: the scenario batch split over the ranks of a
``torch.distributed`` process group.

Port of ``safe_control_tpu/parallel/mesh.py``.  The JAX package's 1-D device
mesh with the axis ``'scenario'`` becomes the ranks of a process group, one
device each:

- ``shard_leading_axis`` gives this rank its contiguous block of every
  leading axis (``PartitionSpec('scenario')``'s block sharding);
- ``gather_leading_axis`` rebuilds the whole batch on every rank (one
  ``all_gather`` a tensor, the list form, which gloo and NCCL both have);
- ``psum_scenario`` is an ``all_reduce`` with SUM.

Robots and scenarios are independent, so this is pure data parallelism; the
caller starts the process group (``torch.distributed.init_process_group``
with its own store, world size and rank).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

SCENARIO_AXIS = "scenario"


@dataclasses.dataclass(frozen=True)
class ScenarioMesh:
    """The scenario axis: a process group, this process's rank in it, its
    size and this rank's device."""

    group: object
    rank: int
    size: int
    device: torch.device


def scenario_mesh(n_devices: Optional[int] = None, *, group=None, device=None) -> ScenarioMesh:
    """The scenario mesh over an initialized process group (the default
    group unless ``group``).  ``n_devices``, if given, must equal its size.
    ``device``: this rank's device, the current card unless ``"cpu"`` is
    asked for.  Raises without an initialized process group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("scenario_mesh: no torch.distributed process group is initialized "
                           "(call torch.distributed.init_process_group first)")
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"scenario_mesh: {n_devices} devices asked for, the group has {size}")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return ScenarioMesh(group=group, rank=rank, size=size, device=torch.device(device))


def _tensor_map(fn, tree):
    return torch.utils._pytree.tree_map(lambda t: fn(t) if isinstance(t, torch.Tensor) else t,
                                        tree)


def shard_leading_axis(mesh: ScenarioMesh, tree):
    """This rank's contiguous block of every leaf's leading axis, on the
    mesh's device (0-d leaves whole).  The axis must divide the world size."""
    def block(t):
        if t.dim() == 0:
            return t.to(mesh.device)
        n = t.shape[0]
        if n % mesh.size:
            raise ValueError(f"leading axis {n} must divide the world size {mesh.size}")
        local = n // mesh.size
        return t[mesh.rank * local:(mesh.rank + 1) * local].to(mesh.device)

    return _tensor_map(block, tree)


def replicate(mesh: ScenarioMesh, tree):
    """Every leaf whole on this rank's device (each rank holds a copy)."""
    return _tensor_map(lambda t: t.to(mesh.device), tree)


def gather_leading_axis(mesh: ScenarioMesh, tree):
    """Every leaf's blocks from all ranks, concatenated in rank order on
    every rank (the inverse of ``shard_leading_axis``; 0-d leaves stay as
    they are)."""
    def gather(t):
        if t.dim() == 0:
            return t
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(wire) for _ in range(mesh.size)]
        dist.all_gather(parts, wire, group=mesh.group)
        out = torch.cat(parts, dim=0)
        return out.to(torch.bool) if t.dtype == torch.bool else out

    return _tensor_map(gather, tree)


def psum_scenario(x, mesh: ScenarioMesh):
    """The sum of ``x`` over the ranks of the mesh (a new tensor)."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def sharded_batch_apply(mesh: ScenarioMesh, fn, reduce_stats=None):
    """Wrap ``fn(local batch) -> (local outputs, local stats)`` so that every
    rank runs it on its block of the whole batch: the wrapped function takes
    the whole batch and returns the whole outputs (gathered on every rank)
    and the stats, reduced by ``reduce_stats(stats, mesh)`` if given (for
    example ``psum_scenario``)."""

    def wrapped(batch):
        out, stats = fn(shard_leading_axis(mesh, batch))
        if reduce_stats is not None:
            stats = reduce_stats(stats, mesh)
        return gather_leading_axis(mesh, out), stats

    return wrapped
