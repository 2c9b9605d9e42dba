"""Output projector: Linear(decoder hidden -> vocab) + log-softmax
(counterpart of aocr/models/head.py)."""

from __future__ import annotations

import math

import torch

from aocr_torch.ops.mm import matmul


def init_params(gen: torch.Generator, num_hidden: int, vocab_size: int,
                device="cpu") -> dict:
    b = 1.0 / math.sqrt(num_hidden)
    u = lambda *s: ((torch.rand(*s, generator=gen) * 2 - 1) * b).to(device)
    return {"w": u(num_hidden, vocab_size), "b": u(vocab_size)}


def apply(params: dict, h: torch.Tensor,
          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """h (..., H) -> log-probs (..., V), always float32."""
    logits = matmul(h.to(compute_dtype),
                    params["w"].to(compute_dtype)) + params["b"]
    return torch.log_softmax(logits, dim=-1)
