"""Weight bridge between the reference's numpy pytrees and the port.

`aocr.checkpoint.load` returns the five-group `params` and the
`batch_stats` as nested dicts/lists of numpy arrays; `from_numpy` turns
them into the port's tensors and `to_numpy` goes back, so either package
reads the other's npz-v2 checkpoints.  The only layout change: conv
weights are (kh, kw, I, O) in the reference and (O, I, kh, kw) here.
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


def from_numpy(params: dict, batch_stats: dict, device="cpu"
               ) -> Tuple[dict, dict]:
    """Reference (params, batch_stats) of numpy arrays -> port tensors on
    `device` (float32, as stored)."""
    def conv(path, a):
        a = np.asarray(a, np.float32)
        if _is_conv_w(path):
            a = a.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.array(a, np.float32, order="C")).to(device)

    return (tree_map(params, conv, ()),
            tree_map(batch_stats, lambda _p, a: torch.from_numpy(
                np.asarray(a, np.float32).copy()).to(device)))


def to_numpy(params: dict, batch_stats: dict) -> Tuple[dict, dict]:
    """Port tensors -> the reference's numpy (params, batch_stats)."""
    def conv(path, t):
        a = t.detach().float().cpu().numpy()
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) \
            if _is_conv_w(path) else a

    return (tree_map(params, conv, ()),
            tree_map(batch_stats, lambda _p, t: t.detach().float().cpu().numpy()))
