"""Evaluation: exact-match word accuracy and edit-distance CER (the port's
counterpart of aocr/eval.py).

The reference's `evalWordErrRate` truncates predictions and gold at the
first EOS, computes the Levenshtein distance and counts an error iff the
distance is not 0: exact-match accuracy.  The host functions
(`levenshtein`, `eval_word_err_rate`) work on strings; the tensor
functions (`canonicalize`, `exact_match`, `edit_distance`,
`char_error_rate`) work on (B, T) token rows on any device, the distance
as the wavefront (anti-diagonal) dynamic program: 2T + 1 vector steps
instead of T^2 scalar ones.  Both sides give the same numbers.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from aocr_torch import vocab


# ---------------------------------------------------------------- host-side

def levenshtein(a: str, b: str) -> int:
    """Classic DP edit distance (host reference oracle)."""
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def eval_word_err_rate(labels, target_labels
                       ) -> Tuple[int, List[str], List[str]]:
    """Reference-parity eval: (num word errors, pred strings, gold
    strings).  An error is counted iff the EOS-truncated strings differ."""
    labels, target_labels = np.asarray(labels), np.asarray(target_labels)
    n = min(len(labels), len(target_labels))
    preds = vocab.decode_batch(labels[:n])
    golds = vocab.decode_batch(target_labels[:n])
    return sum(p != g for p, g in zip(preds, golds)), preds, golds


# ------------------------------------------------------------ tensor-side

def _pad_to(x: torch.Tensor, T: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, T - x.shape[1]), value=vocab.PAD)


def canonicalize(seqs: torch.Tensor):
    """Per-row canonical form matching `vocab.decode` exactly: truncate at
    the first EOS, drop PAD and GO anywhere, compact the surviving
    character tokens to the front.  Returns (compacted (B, T) int32 rows
    PAD-filled past their length, lengths (B,) int32)."""
    T = seqs.shape[1]
    pos = torch.arange(T, device=seqs.device)[None, :]
    keep = (seqs >= vocab.EOS + 1) & vocab.live_mask(seqs)
    # kept tokens keep their order, dropped ones go last (keys are unique)
    order = torch.argsort(torch.where(keep, pos, pos + T), dim=1)
    compact = torch.gather(seqs, 1, order)
    lengths = keep.sum(1).to(torch.int32)
    compact = torch.where(pos < lengths[:, None], compact,
                          torch.full_like(compact, vocab.PAD))
    return compact.to(torch.int32), lengths


def exact_match(pred: torch.Tensor, gold: torch.Tensor) -> torch.Tensor:
    """Per-sample exact match of canonicalized rows, (B,) bool: the same
    as comparing the vocab.decode'd strings."""
    T = max(pred.shape[1], gold.shape[1])
    p, lp = canonicalize(_pad_to(pred, T))
    g, lg = canonicalize(_pad_to(gold, T))
    pos = torch.arange(T, device=pred.device)[None, :]
    same = torch.where(pos < lp[:, None], p == g, torch.ones_like(p == g))
    return (lp == lg) & same.all(1)


def edit_distance(pred: torch.Tensor, gold: torch.Tensor) -> torch.Tensor:
    """Batched Levenshtein distance of canonicalized rows, (B,) int32.

    Wavefront DP: diagonal k holds D[i, k - i]; each of the 2T + 1
    diagonals is one vector update over (B, T + 1)."""
    B = pred.shape[0]
    T = max(pred.shape[1], gold.shape[1])
    dev = pred.device
    p, lp = canonicalize(_pad_to(pred, T))
    g, lg = canonicalize(_pad_to(gold, T))
    n = T + 1
    idx = torch.arange(n, device=dev)
    big = 10 ** 6
    # cost[i, j] = (pred[i-1] != gold[j-1]) for 1-based i, j
    cost = (p[:, :, None] != g[:, None, :]).to(torch.int32)
    ii = (idx - 1).clamp(min=0)
    d2 = torch.full((B, n), big, dtype=torch.int32, device=dev)
    d1 = d2.clone()
    diags = []
    for k in range(2 * T + 1):
        j = k - idx
        valid = (j >= 0) & (j <= T)
        up = torch.where(idx >= 1, d1[:, ii], big)
        left = torch.where(j >= 1, d1, big)
        diag = torch.where((idx >= 1) & (j >= 1), d2[:, ii], big)
        c = cost[:, ii, (j - 1).clamp(min=0, max=T - 1)]
        val = torch.minimum(torch.minimum(up + 1, left + 1), diag + c)
        val = torch.where(idx == 0, j.to(torch.int32).expand(B, n), val)
        val = torch.where(j == 0, idx.to(torch.int32).expand(B, n), val)
        val = torch.where(valid, val, big).to(torch.int32)
        diags.append(val)
        d2, d1 = d1, val
    diags = torch.stack(diags)  # (2T + 1, B, n)
    # D[lp, lg] lies on diagonal lp + lg at position lp
    rows = torch.arange(B, device=dev)
    return diags[(lp + lg).long(), rows, lp.long()]


def char_error_rate(pred: torch.Tensor, gold: torch.Tensor) -> torch.Tensor:
    """Normalized edit distance min(1, dist / len(gold)) per sample,
    (B,) float32."""
    dist = edit_distance(pred, gold)
    _, glen = canonicalize(gold)
    glen = glen.clamp(min=1)
    return torch.clamp(dist.float() / glen.float(), max=1.0)
