"""The data-parallel train step (counterpart of
aocr/parallel/data_parallel.py).

Every rank of the process group runs the port's train step on its rows
of the global batch, kernels and all, with BatchNorm synchronized over
the group (cross-replica moments, models/cnn.py).  The loss is divided
by the *global* real row count, as the reference divides by the batch
size (its src/model/model.lua:645-647), so the gradients summed over the
group by one all-reduce are the one-device step's; clipping and the
optimizer update then run the same on every rank and the parameters
stay bitwise equal across ranks.  The explicit all-reduce is aocr's
`psum`: the parameters are a dict of tensors, not a module, and no
DistributedDataParallel is involved.

Two variants as in aocr: full batches run unmasked (BatchNorm's
closed-form backward with its sums reduced over the group); padded
tails pass a row mask (weighted moments, a differentiable all-reduce,
the real row count all-reduced from the mask).  Every rank must take the
same variant at a step, or the collectives mismatch: the trainer decides
from the global row count.
"""

from __future__ import annotations

from functools import partial

import torch.distributed as dist

from aocr_torch.config import Config
from aocr_torch import train_step


def make_dp_train_step(cfg: Config, group=None):
    """The data-parallel step over `group` (default: every process):
    step(params, batch_stats, opt_state, images, targets, targets_eval,
    lr, dropout_rng=None, real_bs=None, row_mask=None) -> TrainOutput, the
    call of train_step.make_train_step, with this rank's rows of the
    global batch (mesh.shard_batch).  real_bs, when given, is the global
    real row count; by default rows x ranks, or with row_mask the mask's
    sum over the group (at least 1).  The returned state is the same on
    every rank; loss_sum is the global token sum."""
    if not dist.is_initialized():
        raise RuntimeError("make_dp_train_step needs an initialized "
                           "torch.distributed process group")
    return partial(train_step._train_step, cfg=cfg.validate(),
                   group=dist.group.WORLD if group is None else group)
