"""PAD-masked summed negative log-likelihood (counterpart of aocr/loss.py).

The PAD class has weight 0 and the result is a sum over the non-PAD target
tokens, not a mean; the train step divides by the batch size itself.
"""

from __future__ import annotations

import torch

from aocr_torch import vocab


def gold_scores(log_probs: torch.Tensor, targets_eval: torch.Tensor
                ) -> torch.Tensor:
    """Per-sample summed gold log-prob over the non-PAD target tokens:
    log_probs (B, T, V), targets_eval (B, T) -> (B,)."""
    picked = log_probs.gather(-1, targets_eval.long()[..., None])[..., 0]
    mask = (targets_eval != vocab.PAD).to(log_probs.dtype)
    return (picked * mask).sum(1)


def nll_sum(log_probs: torch.Tensor, targets_eval: torch.Tensor
            ) -> torch.Tensor:
    """Scalar token-sum NLL; PAD targets contribute zero."""
    return -gold_scores(log_probs, targets_eval).sum()
