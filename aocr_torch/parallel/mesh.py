"""The data axis as a torch.distributed process group (counterpart of
aocr/parallel/mesh.py).

aocr shards a global batch over a mesh of devices in one process; the
port runs one process per device, so the data axis is a process group
and each rank holds the rows that aocr's `shard_batch` would place on
its device: rank r of n takes rows [r * B/n, (r + 1) * B/n).  The
collectives below are the counterparts of `psum`, `pmin` and a gather
of sharded outputs.  They take the tensors where they lie: NCCL groups
and gloo groups alike (gloo runs all_reduce, all_gather and broadcast on
CUDA tensors: chip_smoke.py's probe, torch 2.11 on an H100).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def world(group=None) -> int:
    """The group's size (1 without an initialized process group)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def local_devices(device) -> List[torch.device]:
    """The devices of `device`'s kind on this machine: every CUDA device,
    or the one CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device.type)]


def make_mesh(num_data: Optional[int] = None, num_model: int = 1,
              devices: Optional[Sequence] = None,
              kind="cuda") -> List[torch.device]:
    """The devices of a (data, model) mesh, data-major: by default every
    local device of `kind` on the data axis.  Raises aocr's ValueErrors
    for an axis below 1 and for more devices than there are.  A device
    may be named more than once (each entry is one shard)."""
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else local_devices(kind))]
    if num_data is None:
        num_data = len(devs) // num_model
    if num_data < 1 or num_model < 1:
        raise ValueError(
            f"mesh axes must be >= 1, got data={num_data} "
            f"model={num_model}")
    if num_data * num_model > len(devs):
        raise ValueError(
            f"need {num_data}x{num_model} devices, have {len(devs)}")
    if num_model > 1:
        raise NotImplementedError(
            "a model axis (tensor parallelism) is not ported: ROADMAP "
            "queue 1: Tensor parallel")
    return devs[:num_data]


def rows_of(x, r: int, n: int):
    """Shard r of n of a global batch (axis 0), in aocr's shard_batch
    order.  The row count must divide by n."""
    B = x.shape[0]
    if B % n:
        raise ValueError(f"a batch of {B} rows does not split over {n} "
                         "ranks")
    return x[r * (B // n):(r + 1) * (B // n)]


def local_rows(x, group=None):
    """This rank's rows of a global batch."""
    return rows_of(x, rank(group), world(group))


def shard_batch(group, *arrays):
    """local_rows of each array (aocr's mesh.shard_batch for one rank)."""
    out = tuple(local_rows(a, group) for a in arrays)
    return out if len(out) > 1 else out[0]


def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """In place, over the group (psum / pmin); returns t.  Identity
    without a process group; a group of one still runs the collective."""
    if dist.is_initialized():
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' equal-shaped tensors concatenated along axis 0 in rank
    order: a gather of a batch-sharded output."""
    if not dist.is_initialized():
        return t
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(world(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, 0)


class _AllReduceSum(torch.autograd.Function):
    """psum with its transpose: the backward sums the cotangents over the
    group, since every rank's loss reads the reduced value."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """A differentiable sum over the group (torch.distributed.all_reduce
    is not differentiable)."""
    if not dist.is_initialized():
        return x
    return _AllReduceSum.apply(x, group)
