"""Training and evaluation steps (counterpart of aocr/train_step.py).

`make_train_step(cfg)` returns the step the reference jits: one forward
in train mode (BatchNorm on the batch's moments), the token-sum NLL
divided by the batch size before the backward -- so gradients, and the
clip-at-5 threshold, are on the mean-over-batch scale -- then the
optimizer update.  It reports `loss_sum`, the token sum, as the
reference's step loss does.  With cfg.augment the images are first
augmented on the device (aocr_torch.augment) under the step key passed
as dropout_rng, and so are the decoder's dropout masks (ops/dropout.py).
On CUDA tensors every kernel of the path runs: conv1 forward and
backward, both encoder directions' forward (with residuals) and
backward recurrences, and the teacher-forced decoder's, which dropout,
remat, the simple attention and tensor parallelism leave for the
per-step decoder under autograd, as aocr does.

Parameters are nested dicts of float32 tensors; a step returns new
tensors and leaves its inputs as they were.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from aocr_torch.config import Config
from aocr_torch import augment as augment_lib
from aocr_torch import decode
from aocr_torch import loss as loss_lib
from aocr_torch import optim
from aocr_torch.models import model
from aocr_torch.parallel import mesh
from aocr_torch.weights import tree_map


class TrainOutput(NamedTuple):
    params: dict
    batch_stats: dict
    opt_state: object  # optim.SGDState or optim.AdadeltaState
    loss_sum: torch.Tensor  # token-sum NLL (the reference's step loss)
    grad_norms: dict


def _on(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on `device`."""
    return torch.as_tensor(x, device=device)


def _train_step(params: dict, batch_stats: dict, opt_state, images,
                targets, targets_eval, lr, dropout_rng=None, *,
                cfg: Config, real_bs=None, row_mask=None,
                group=None, tp=None) -> TrainOutput:
    """One step.  dropout_rng is the step key, two 32-bit words
    (augment.step_key); -augment and dropout draw from it, each on a
    stream of its own (augment.AUG_TAG, dropout.DROPOUT_TAG), keyed by
    global row.
    For a batch padded to a fixed size, real_bs is the number of real rows
    (the loss is divided by it, as the reference divides by the real batch
    size) and row_mask (B,) marks them, which keeps the padding out of the
    BatchNorm moments; the padded rows carry PAD targets and so no
    loss.

    With a process group (aocr_torch.parallel.data_parallel) the batch is
    this rank's rows of the global one: augment keys them by global row,
    BatchNorm is synchronized, real_bs is the global count (rows x ranks,
    or the all-reduced mask), and one all-reduce sums the gradients and
    the loss before the optimizer, so every rank makes the same update.

    With tp (parallel.tensor_parallel.ModelAxis) the group is the data
    axis of a (data, model) grid and params, opt_state and the returned
    ones are this rank's shards: the decoder and the projector run
    sharded, and tp reduces the gradients and the clipping norms."""
    dev = optim.leaves(params)[0].device
    images = _on(images, dev).float()
    # the batch's first global row keys the augment and dropout draws
    offset = 0 if group is None else mesh.rank(group) * images.shape[0]
    if cfg.augment:
        if dropout_rng is None:
            raise ValueError("-augment needs the step key (dropout_rng)")
        images = augment_lib.augment_batch(dropout_rng, images,
                                           cfg.augment_strength,
                                           row_offset=offset)
    targets, targets_eval = _on(targets, dev), _on(targets_eval, dev)
    if row_mask is not None:
        row_mask = _on(row_mask, dev)
    if real_bs is not None:
        batch_size = float(real_bs)
    elif group is None:
        batch_size = images.shape[0]
    elif row_mask is None:
        batch_size = images.shape[0] * mesh.world(group)
    else:
        batch_size = mesh.all_reduce(row_mask.float().sum(),
                                     group).clamp(min=1.0)
    leaves = [x.detach().requires_grad_() for x in optim.leaves(params)]
    it = iter(leaves)
    p = tree_map(params, lambda _p, _x: next(it))
    with torch.enable_grad():
        nll, new_stats, _ = model.forward_loss(
            p, batch_stats, images, targets, targets_eval, cfg, train=True,
            row_mask=row_mask, group=group, dropout_key=dropout_rng,
            row_offset=offset, tp=tp)
        mean_loss = nll / batch_size
        # the simple attention leaves w_c unused: its gradient is zero
        flat = torch.autograd.grad(mean_loss, leaves, allow_unused=True,
                                   materialize_grads=True)
    mean_loss = mean_loss.detach()
    if tp is not None:
        flat, mean_loss = tp.reduce_grads(params, list(flat), mean_loss)
    elif group is not None:
        # psum of the gradients and the loss: one flat buffer, one
        # all-reduce
        buf = mesh.all_reduce(torch.cat(
            [g.reshape(-1) for g in flat] + [mean_loss.reshape(1)]), group)
        mean_loss = buf[-1]
        flat = [v.view_as(g) for v, g in zip(
            buf[:-1].split([g.numel() for g in flat]), flat)]
    it = iter(flat)
    grads = tree_map(params, lambda _p, _x: next(it))
    sq_sums_fn = None if tp is None else tp.sq_sums
    if cfg.optimizer == "adadelta":
        new_params, new_opt, norms = optim.adadelta_update(
            params, grads, opt_state, weight_decay=cfg.weight_decay,
            sq_sums_fn=sq_sums_fn)
    else:
        new_params, new_opt, norms = optim.sgd_update(
            params, grads, opt_state, lr, optim.hyper_from_config(cfg),
            sq_sums_fn=sq_sums_fn)
    return TrainOutput(
        params=new_params,
        batch_stats=tree_map(new_stats, lambda _p, x: x.detach()),
        opt_state=new_opt, loss_sum=mean_loss * batch_size,
        grad_norms=norms)


def make_train_step(cfg: Config):
    """The train step for this configuration:
    step(params, batch_stats, opt_state, images, targets, targets_eval,
    lr, dropout_rng, real_bs=None, row_mask=None) -> TrainOutput."""
    return partial(_train_step, cfg=cfg.validate())


def init_opt_state(params: dict, cfg: Config):
    """The optimizer state the configuration asks for."""
    if cfg.optimizer == "adadelta":
        return optim.adadelta_init(params)
    return optim.sgd_init(params, optim.hyper_from_config(cfg))


@torch.no_grad()
def eval_decode_step(params: dict, batch_stats: dict, images, targets,
                     targets_eval, cfg: Config, beam_size: int, max_len: int,
                     trie_table=None, return_refills: bool = False):
    """Beam decode and the teacher-forced gold pass from ONE encode
    (aocr/train_step.py:108-145): returns (beam_from_context's output,
    token-sum NLL, per-sample gold scores (B,)).  The gold pass runs the
    tf_fwd kernel on CUDA tensors with cfg.use_pallas."""
    dev = optim.leaves(params)[0].device
    targets_eval = _on(targets_eval, dev)
    context, dec_init = model.encode(params, batch_stats,
                                     _on(images, dev).float(), cfg)
    out = decode.beam_from_context(params, context, dec_init, cfg, beam_size,
                                   max_len, trie_table, return_refills)
    nll, log_probs = model.loss_from_context(params, context, dec_init,
                                             _on(targets, dev), targets_eval,
                                             cfg)
    return out, nll, gold_scores_from_logprobs(log_probs, targets_eval)


def gold_scores_from_logprobs(log_probs: torch.Tensor,
                              targets_eval: torch.Tensor) -> torch.Tensor:
    """Per-sample summed gold log-prob: the same pick and PAD mask as the
    loss."""
    return loss_lib.gold_scores(log_probs, targets_eval)


@torch.no_grad()
def eval_loss_step(params: dict, batch_stats: dict, images, targets,
                   targets_eval, cfg: Config):
    """Eval-mode teacher-forced pass: (token-sum NLL, per-sample gold
    score (B,))."""
    dev = optim.leaves(params)[0].device
    targets_eval = _on(targets_eval, dev)
    nll, _, log_probs = model.forward_loss(
        params, batch_stats, _on(images, dev).float(), _on(targets, dev),
        targets_eval, cfg, train=False)
    return nll, gold_scores_from_logprobs(log_probs, targets_eval)
