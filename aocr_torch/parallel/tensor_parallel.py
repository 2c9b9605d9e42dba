"""Tensor-parallel (+ data-parallel) training (counterpart of
aocr/parallel/tensor_parallel.py).

aocr annotates the decoder's wide weights over a mesh's model axis and
lets GSPMD insert the collectives.  The port runs one process per grid
rank (mesh.Grid: rank = d * num_model + m) and writes the collectives by
hand, as Megatron-LM's four conjugate operators over the model group
(`ModelAxis`):

- copy: forward the identity, backward an all-reduce of the cotangent;
- reduce: forward an all-reduce, backward the identity;
- gather: forward an all-gather along the last axis, backward this
  rank's slice;
- scatter: forward this rank's slice of the last axis, backward an
  all-gather.

Every model rank computes the same replicated activations and the same
loss, so a replicated tensor's cotangent is whole on every rank: the
backward of `mesh.all_reduce_sum` (a sum of the cotangents over the
group, right for sync-BN, where each rank's loss reads other rows)
would give num_model times the gradient here.

The layout is aocr's `param_pspecs`: each decoder layer's wi, wh (4H
output columns) and bi, bh, and w_a's output columns, are sharded; w_c
and the projector's w on their input rows; everything else (the CNN,
the encoder, the embedding, the projector's bias) is replicated.  The
packed [i|f|o|g] columns put whole gates on different ranks, so the
decoder gathers each layer's gates before the gate math
(models/decoder.py::_per_step); the teacher-forced kernels stay off, as
aocr leaves them (aocr/models/model.py:146), while the CNN and encoder
kernels run.  The collectives sum float32 partial products.  A size the
model axis does not divide raises ValueError: GSPMD pads uneven shards,
the port does not.

The step's reductions: sync-BN, the real row count, augment's and
dropout's global rows over the data group; the gradients of sharded
leaves summed over the data group, those of replicated leaves over the
world from model rank 0 of each data shard (one exact sum, the same on
every rank); the clipping norms with the sharded leaves' squares summed
over the model group, so every rank clips with the one-process norm.
"""

from __future__ import annotations

from functools import partial
from typing import List

import torch
import torch.distributed as dist

from aocr_torch.config import Config
from aocr_torch.optim import leaves
from aocr_torch.parallel import mesh
from aocr_torch.weights import tree_map


_LAYER_AXES = {"wi": 1, "wh": 1, "bi": 0, "bh": 0}


def _axis(path):
    """The sharded axis of the leaf at `path`, or None."""
    if path[0] == "decoder":
        if path[1] == "layers":
            return _LAYER_AXES[path[3]]
        return {"w_a": 1, "w_c": 0}.get(path[1])
    if path[0] == "projector" and path[1] == "w":
        return 0
    return None


def param_specs(params: dict) -> dict:
    """The params' structure (of this tree, in its own key order) with, at
    each leaf, the axis sharded over the model axis, or None
    (replicated)."""
    return tree_map(params, lambda p, _x: _axis(p))


def shard_params(params: dict, grid: mesh.Grid) -> dict:
    """This rank's contiguous slices of the whole tree (or of any tree of
    the params' structure, as an optimizer state's).  Raises ValueError
    for a size the model axis does not divide."""
    nm = grid.num_model

    def check(path, x):
        axis = _axis(path)
        if axis is not None and x.shape[axis] % nm:
            raise ValueError(
                f"{'/'.join(map(str, path))} {tuple(x.shape)}: axis {axis} "
                f"of size {x.shape[axis]} does not split over a model axis "
                f"of {nm} (uneven shards are not supported)")

    def cut(path, x):
        axis = _axis(path)
        if axis is None:
            return x
        n = x.shape[axis] // nm
        return x.narrow(axis, grid.m * n, n).contiguous()

    tree_map(params, check)
    return tree_map(params, cut)


def gather_params(params: dict, grid: mesh.Grid) -> dict:
    """The whole tree from every model rank's shards: an all-gather over
    the model group, in which every rank of it takes part."""
    def whole(path, x):
        axis = _axis(path)
        if axis is None or grid.num_model == 1:
            return x
        return torch.cat(_all_gather(x, grid.model_group, grid.num_model),
                         dim=axis)

    return tree_map(params, whole)


def _all_gather(x: torch.Tensor, group, n: int) -> List[torch.Tensor]:
    src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return parts


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, dy):
        return ctx.axis.all_reduce(dy), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_gather_last(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.axis.slice_last(dy), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.slice_last(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.axis.all_gather_last(dy), None


class ModelAxis:
    """The model axis of a grid: the four conjugate operators over its
    group (the module docstring), and the train step's gradient
    reductions."""

    def __init__(self, grid: mesh.Grid):
        self.grid = grid
        self.group, self.size, self.rank = (grid.model_group,
                                            grid.num_model, grid.m)

    # the collectives, in float32
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        out = x.float().clone().contiguous()
        dist.all_reduce(out, group=self.group)
        return out.to(x.dtype)

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        parts = _all_gather(x.float(), self.group, self.size)
        return torch.cat(parts, dim=-1).to(x.dtype)

    def slice_last(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[-1] // self.size
        return x.narrow(-1, self.rank * n, n).contiguous()

    # Megatron's operators
    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(x, self)

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        return _Scatter.apply(x, self)

    # the step's reductions
    def reduce_grads(self, params: dict, flat: list, mean_loss):
        """Each rank's gradients (leaves of params' order) and mean loss ->
        the global ones: sharded leaves summed over the data group,
        replicated leaves and the loss over the world from model rank 0 of
        each data shard (the other ranks add zeros, so the sum is exact
        and the same on every rank)."""
        specs = leaves(param_specs(params))
        rep = [g.reshape(-1) for g, s in zip(flat, specs) if s is None]
        shd = [g.reshape(-1) for g, s in zip(flat, specs) if s is not None]
        rbuf = torch.cat(rep + [mean_loss.reshape(1)])
        if self.rank != 0:
            rbuf = torch.zeros_like(rbuf)
        dist.all_reduce(rbuf)
        sbuf = mesh.all_reduce(torch.cat(shd), self.grid.data_group)
        rit = iter(rbuf[:-1].split([g.numel() for g in rep]))
        sit = iter(sbuf.split([g.numel() for g in shd]))
        out = [next(rit if s is None else sit).view_as(g)
               for g, s in zip(flat, specs)]
        return out, rbuf[-1]

    def sq_sums(self, grads: dict) -> dict:
        """Each group's squared gradient norm: the replicated leaves' once,
        the sharded leaves' summed over the model group (one all-reduce
        for all groups)."""
        specs = param_specs(grads)
        rep, shd = {}, []
        for g in grads:
            pairs = list(zip(leaves(grads[g]), leaves(specs[g])))
            rep[g] = sum(x.float().square().sum()
                         for x, s in pairs if s is None)
            shd.append(sum(x.float().square().sum()
                           for x, s in pairs if s is not None))
        dev = leaves(grads)[0].device
        buf = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                           device=dev) for v in shd])
        dist.all_reduce(buf, group=self.group)
        return {g: rep[g] + buf[i] for i, g in enumerate(grads)}


def make_tp_train_step(cfg: Config, grid: mesh.Grid):
    """The DP x TP step on this grid rank: step(params, batch_stats,
    opt_state, images, targets, targets_eval, lr, dropout_rng=None,
    real_bs=None, row_mask=None) -> TrainOutput, make_dp_train_step's
    call, with params and the optimizer state this rank's shards
    (shard_params) and the batch this data shard's rows
    (mesh.shard_batch over grid.data_group).  The returned params and
    state are this rank's shards; loss_sum and grad_norms are global."""
    from aocr_torch import train_step

    if not dist.is_initialized():
        raise RuntimeError("make_tp_train_step needs an initialized "
                           "torch.distributed process group")
    return partial(train_step._train_step, cfg=cfg.validate(),
                   group=grid.data_group, tp=ModelAxis(grid))
