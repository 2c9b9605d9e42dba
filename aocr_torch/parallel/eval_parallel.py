"""Data-parallel evaluation (counterpart of aocr/parallel/eval_parallel.py).

Each rank runs one encode of its rows, then the beam (or, at beam 1,
greedy) decode and the teacher-forced gold pass from it
(train_step.eval_decode_step), and the exact-match and CER metrics on
the device (aocr_torch.eval).  The token-sum NLL, the metrics and the
trie refill count are summed over the group, the fewest valid beams
min-reduced; labels, scores and gold scores are gathered in row order,
so rank 0 sees every row (the host metrics, -visualize).  Padded rows
carry PAD targets (no loss) and mask 0, which keeps them out of the
accuracy and the CER.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from aocr_torch import eval as eval_lib, optim, train_step, vocab
from aocr_torch.config import Config
from aocr_torch.parallel import mesh


class EvalOut(NamedTuple):
    labels: torch.Tensor  # (B, T) int32, every rank's rows
    scores: torch.Tensor  # (B,) float32 best-beam cumulative log-prob
    nll: torch.Tensor  # scalar, global token-sum NLL
    gold_scores: torch.Tensor  # (B,) per-sample teacher-forced log-prob
    accuracy: torch.Tensor  # scalar int32 exact-match count over real rows
    cer_sum: torch.Tensor  # scalar f32 summed normalized edit distance
    refills: torch.Tensor  # scalar int32 trie refill events (0 without trie)
    min_valid: torch.Tensor  # scalar int32 smallest valid-beam count seen


def make_dp_eval_step(cfg: Config, group=None, use_trie: bool = False):
    """The sharded eval step over `group` (default: every process).

    Returns step(params, batch_stats, images, targets, targets_eval,
    trie_table=None, row_mask=None) -> EvalOut, with this rank's rows of
    the global batch (mesh.shard_batch; every rank the same count) and
    row_mask marking its real rows (default all)."""
    if not dist.is_initialized():
        raise RuntimeError("make_dp_eval_step needs an initialized "
                           "torch.distributed process group")
    cfg = cfg.validate()
    group = dist.group.WORLD if group is None else group
    K = min(cfg.beam_size, cfg.target_vocab_size)
    T = cfg.max_decoder_l

    @torch.no_grad()
    def step(params, batch_stats, images, targets, targets_eval,
             trie_table: Optional[torch.Tensor] = None,
             row_mask=None) -> EvalOut:
        dev = optim.leaves(params)[0].device
        targets_eval = torch.as_tensor(targets_eval, device=dev)
        (labels, scores, (refills, min_valid)), nll, gold = \
            train_step.eval_decode_step(
                params, batch_stats, images, targets, targets_eval, cfg,
                beam_size=K, max_len=T,
                trie_table=trie_table if use_trie else None,
                return_refills=True)
        mask = (torch.ones((labels.shape[0],), device=dev)
                if row_mask is None
                else torch.as_tensor(row_mask, device=dev).float())
        real = mask > 0
        em = eval_lib.exact_match(labels, targets_eval)
        cer = eval_lib.char_error_rate(labels, targets_eval)
        # psum of (nll, accuracy, cer_sum, refills) in one float64
        # all-reduce, pmin of min_valid.  The CER terms (float32 in [0, 1],
        # 0 or at least 1/T) sum exactly in float64, so cer_sum is the
        # one-device sum whatever the split; nll's two float32 partials
        # add exactly too.
        sums = mesh.all_reduce(torch.stack([
            nll.double(), (em & real).sum().double(),
            (cer.double() * mask.double()).sum(),
            refills.to(dev).double()]), group)
        least = mesh.all_reduce(min_valid.to(dev, torch.int32).reshape(1),
                                group, dist.ReduceOp.MIN)
        return EvalOut(
            labels=mesh.all_gather(labels, group),
            scores=mesh.all_gather(scores.float(), group),
            nll=sums[0].float(),
            gold_scores=mesh.all_gather(gold.float(), group),
            accuracy=sums[1].to(torch.int32),
            cer_sum=sums[2].float(),
            refills=sums[3].to(torch.int32),
            min_valid=least[0])

    return step


def pad_rows(n_shards: int, *arrays, total_rows: Optional[int] = None):
    """Pad batch arrays (axis 0, repeating the last row for images / PAD
    rows for targets) to a row count divisible by n_shards, or to exactly
    total_rows (multi-host lockstep: every host contributes the same local
    row count).  Returns (real_rows, padded arrays...); numpy arrays or
    tensors."""
    B = arrays[0].shape[0]
    pad = (total_rows - B) if total_rows is not None else (-B) % n_shards
    assert pad >= 0, f"batch of {B} rows exceeds total_rows={total_rows}"
    if pad == 0:
        return (B,) + arrays
    out = []
    for a in arrays:
        if isinstance(a, torch.Tensor):
            if a.dtype.is_floating_point:
                filler = a[-1:].expand(pad, *a.shape[1:])
            else:
                filler = torch.full((pad,) + tuple(a.shape[1:]), vocab.PAD,
                                    dtype=a.dtype, device=a.device)
            out.append(torch.cat([a, filler], 0))
        elif a.dtype.kind == "f":  # images: repeat the last row
            out.append(np.concatenate([a, np.repeat(a[-1:], pad, 0)], 0))
        else:  # targets: PAD rows (zero loss)
            out.append(np.concatenate(
                [a, np.full((pad,) + a.shape[1:], vocab.PAD, a.dtype)], 0))
    return (B,) + tuple(out)
