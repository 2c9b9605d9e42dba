"""Per-group SGD and Adadelta (counterpart of aocr/optim.py).

Gradients are clipped per parameter group at norm 5: each of the five
groups {cnn, encoder_fw, encoder_bw, decoder, projector} is one flattened
vector whose float32 L2 norm is clipped.  SGD adds weight decay,
momentum (dampening, nesterov) and the annealed rate lr/(1 + n*decay);
Adadelta keeps rho=0.9, eps=1e-6 accumulators.

These are plain functions over the nested parameter dicts, evaluated
under `torch.no_grad()`; they return new tensors and leave their inputs
as they were, as the reference's pure updates do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from aocr_torch.weights import tree_map

GROUPS = ("cnn", "encoder_fw", "encoder_bw", "decoder", "projector")

CLIP_NORM = 5.0


def leaves(tree):
    """The tensors of a nested dict/list, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_zip(fn, tree, *others):
    """fn(x, *ys) over the leaves of trees of one structure, matched by
    path (dict order may differ, as in a tree that went through jax)."""
    return tree_map(tree, lambda p, x: fn(x, *(_at(o, p) for o in others)))


def _sq(tree) -> torch.Tensor:
    return sum(x.float().square().sum() for x in leaves(tree))


def group_norm(tree) -> torch.Tensor:
    """float32 L2 norm of all leaves of a group, as one flattened vector."""
    return torch.sqrt(_sq(tree))


def sq_sums(grads: dict) -> dict:
    """Each group's squared float32 L2 norm."""
    return {g: _sq(grads[g]) for g in grads}


@torch.no_grad()
def clip_grads_by_group(grads: dict, max_norm: float = CLIP_NORM,
                        sq_sums_fn=None):
    """Per-group gradient clipping.  Returns (clipped_grads, norms).
    sq_sums_fn (default `sq_sums`) gives each group's squared norm: under
    tensor parallelism the sharded leaves' squares summed over the model
    axis (parallel.tensor_parallel.ModelAxis.sq_sums)."""
    out, norms = {}, {}
    sq = (sq_sums_fn or sq_sums)(grads)
    for g in grads:
        n = torch.sqrt(sq[g])
        scale = torch.where(n > max_norm, max_norm / n, torch.ones_like(n))
        out[g] = tree_map(grads[g], lambda _p, x: x * scale)
        norms[g] = n
    return out, norms


class SGDState(NamedTuple):
    eval_counter: int  # steps taken
    momentum_buf: Optional[dict]  # the params' structure when momentum > 0
    # True until the buffer's first momentum update (the reference keys
    # "first use" on the buffer not existing yet, not on the counter)
    buf_fresh: bool = True


class SGDHyper(NamedTuple):
    learning_rate_decay: float = 0.0
    weight_decay: float = 0.0
    momentum: float = 0.0
    dampening: float = 0.0
    nesterov: bool = False


def hyper_from_config(cfg) -> SGDHyper:
    """The CLI's SGD hyperparameters; dampening < 0 means "the momentum"
    (the reference's `damp = config.dampening or mom`)."""
    damp = cfg.momentum if cfg.dampening < 0 else cfg.dampening
    return SGDHyper(learning_rate_decay=cfg.sgd_learning_rate_decay,
                    weight_decay=cfg.weight_decay, momentum=cfg.momentum,
                    dampening=damp, nesterov=cfg.nesterov)


def sgd_init(params: dict, hyper: SGDHyper = SGDHyper()) -> SGDState:
    buf = None
    if hyper.momentum > 0:
        buf = tree_map(params, lambda _p, x: torch.zeros_like(x))
    return SGDState(eval_counter=0, momentum_buf=buf, buf_fresh=True)


@torch.no_grad()
def sgd_update(params: dict, grads: dict, state: SGDState, lr,
               hyper: SGDHyper = SGDHyper(), sq_sums_fn=None
               ) -> Tuple[dict, SGDState, dict]:
    """One SGD step.  Returns (new_params, new_state, grad_norms).
    sq_sums_fn as in clip_grads_by_group."""
    grads, norms = clip_grads_by_group(grads, sq_sums_fn=sq_sums_fn)
    if hyper.weight_decay != 0.0:
        grads = tree_zip(lambda g, p: g + hyper.weight_decay * p, grads,
                         params)
    new_buf, new_fresh = state.momentum_buf, state.buf_fresh
    if hyper.momentum > 0:
        if state.buf_fresh:
            new_buf = grads
        else:
            new_buf = tree_zip(
                lambda b, g: hyper.momentum * b + (1.0 - hyper.dampening) * g,
                state.momentum_buf, grads)
        new_fresh = False
        if hyper.nesterov:
            grads = tree_zip(lambda g, b: g + hyper.momentum * b, grads,
                             new_buf)
        else:
            grads = new_buf
    clr = lr / (1.0 + state.eval_counter * hyper.learning_rate_decay)
    new_params = tree_zip(lambda p, g: p - clr * g, params, grads)
    return new_params, SGDState(state.eval_counter + 1, new_buf,
                                new_fresh), norms


class AdadeltaState(NamedTuple):
    acc_grad: dict   # E[g^2]
    acc_delta: dict  # E[dx^2]


def adadelta_init(params: dict) -> AdadeltaState:
    zeros = lambda: tree_map(params, lambda _p, x: torch.zeros_like(x))
    return AdadeltaState(acc_grad=zeros(), acc_delta=zeros())


@torch.no_grad()
def adadelta_update(params: dict, grads: dict, state: AdadeltaState,
                    rho: float = 0.9, eps: float = 1e-6,
                    weight_decay: float = 0.0, sq_sums_fn=None
                    ) -> Tuple[dict, AdadeltaState, dict]:
    grads, norms = clip_grads_by_group(grads, sq_sums_fn=sq_sums_fn)
    if weight_decay != 0.0:
        grads = tree_zip(lambda g, p: g + weight_decay * p, grads, params)
    acc_g = tree_zip(lambda a, g: rho * a + (1 - rho) * g * g,
                     state.acc_grad, grads)
    delta = tree_zip(lambda g, a, d: g * torch.sqrt(d + eps)
                     / torch.sqrt(a + eps), grads, acc_g, state.acc_delta)
    acc_d = tree_zip(lambda a, d: rho * a + (1 - rho) * d * d,
                     state.acc_delta, delta)
    new_params = tree_zip(lambda p, d: p - d, params, delta)
    return new_params, AdadeltaState(acc_g, acc_d), norms
