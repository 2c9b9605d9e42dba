"""Weight bridge between the reference's numpy pytrees and the port.

`aocr.checkpoint.load` returns the five-group `params` and the
`batch_stats` as nested dicts/lists of numpy arrays; `from_numpy` turns
them into the port's tensors and `to_numpy` goes back, so either package
reads the other's npz-v2 checkpoints.  The only layout change: conv
weights are (kh, kw, I, O) in the reference and (O, I, kh, kw) here.
`opt_state_from_numpy` / `opt_state_to_numpy` carry the optimizer state
(SGD's counter and momentum buffers, Adadelta's accumulators) the same
way.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def tree_map(tree, fn, path=()):
    """Apply fn(path, leaf) over nested dicts/lists; returns the new tree."""
    if isinstance(tree, dict):
        return {k: tree_map(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _is_conv_w(path) -> bool:
    return len(path) == 3 and path[0] == "cnn" and path[2] == "w"


def conv_to_port(params: dict) -> dict:
    """A params tree of tensors in the reference's layout -> the port's:
    the conv weights transposed (kh, kw, I, O) -> (O, I, kh, kw),
    contiguous; the other leaves as they are (the export program's first
    step)."""
    return tree_map(params, lambda path, t: t.permute(3, 2, 0, 1)
                    .contiguous() if _is_conv_w(path) else t)


def _params_in(params, device):
    """A params-shaped tree of numpy arrays -> port tensors."""
    def conv(path, a):
        a = np.asarray(a, np.float32)
        if _is_conv_w(path):
            a = a.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.array(a, np.float32, order="C")).to(device)

    return tree_map(params, conv, ())


def _params_out(params):
    """A params-shaped tree of port tensors -> the reference's numpy."""
    def conv(path, t):
        a = t.detach().float().cpu().numpy()
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) \
            if _is_conv_w(path) else a

    return tree_map(params, conv, ())


def from_numpy(params: dict, batch_stats: dict, device="cpu"
               ) -> Tuple[dict, dict]:
    """Reference (params, batch_stats) of numpy arrays -> port tensors on
    `device` (float32, as stored)."""
    return (_params_in(params, device),
            tree_map(batch_stats, lambda _p, a: torch.from_numpy(
                np.asarray(a, np.float32).copy()).to(device)))


def to_numpy(params: dict, batch_stats: dict) -> Tuple[dict, dict]:
    """Port tensors -> the reference's numpy (params, batch_stats)."""
    return (_params_out(params),
            tree_map(batch_stats, lambda _p, t: t.detach().float().cpu().numpy()))


def opt_state_from_numpy(state, device="cpu"):
    """The reference's optimizer state (its SGDState or AdadeltaState, or
    a dict of the same fields), with numpy leaves -> the port's
    (aocr_torch.optim)."""
    from aocr_torch import optim

    get = (state.get if isinstance(state, dict)
           else lambda k: getattr(state, k))
    fields = set(state) if isinstance(state, dict) else set(state._fields)
    if fields == set(optim.AdadeltaState._fields):
        return optim.AdadeltaState(_params_in(get("acc_grad"), device),
                                   _params_in(get("acc_delta"), device))
    buf = get("momentum_buf")
    return optim.SGDState(
        eval_counter=int(np.asarray(get("eval_counter"))),
        momentum_buf=None if buf is None else _params_in(buf, device),
        buf_fresh=bool(np.asarray(get("buf_fresh"))))


def opt_state_to_numpy(state) -> dict:
    """The port's optimizer state -> a dict of the reference's fields
    with numpy leaves (`aocr.optim.SGDState(**d)` rebuilds it)."""
    from aocr_torch import optim

    if isinstance(state, optim.AdadeltaState):
        return {"acc_grad": _params_out(state.acc_grad),
                "acc_delta": _params_out(state.acc_delta)}
    return {"eval_counter": np.asarray(state.eval_counter, np.int32),
            "momentum_buf": None if state.momentum_buf is None
            else _params_out(state.momentum_buf),
            "buf_fresh": np.asarray(state.buf_fresh)}

