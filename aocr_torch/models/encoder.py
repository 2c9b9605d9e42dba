"""Bidirectional LSTM encoder (counterpart of aocr/models/encoder.py).

Each direction is a stack of LSTM layers with zero initial state; the
context at column t is [h_fw_t ; h_bw_t]; the decoder starts from the
forward final state (after t=L) and the backward final state (after t=1).
Only the reference's default per-direction branch is ported
(`fused_encoder_proj=False`).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from aocr_torch.ops import lstm


def init_lstm_layer(gen: torch.Generator, input_size: int, num_hidden: int,
                    device="cpu") -> dict:
    """uniform(+-1/sqrt(fan_in)) for i2h and h2h weights and biases."""
    bi = 1.0 / math.sqrt(input_size)
    bh = 1.0 / math.sqrt(num_hidden)
    u = lambda b, *s: ((torch.rand(*s, generator=gen) * 2 - 1) * b).to(device)
    return {"wi": u(bi, input_size, 4 * num_hidden),
            "bi": u(bi, 4 * num_hidden),
            "wh": u(bh, num_hidden, 4 * num_hidden),
            "bh": u(bh, 4 * num_hidden)}


def init_params(gen: torch.Generator, input_size: int, num_hidden: int,
                num_layers: int, device="cpu") -> dict:
    return {"layers": [
        init_lstm_layer(gen, input_size if i == 0 else num_hidden,
                        num_hidden, device) for i in range(num_layers)]}


def apply_direction(params: dict, features: torch.Tensor, reverse: bool,
                    compute_dtype: torch.dtype = torch.float32,
                    use_kernel: bool = True):
    """features (B, L, D) -> (top-layer hs (B, L, H), top-layer finals)."""
    xs, final = features, None
    B = features.shape[0]
    for layer in params["layers"]:
        H = layer["wh"].shape[0]
        z = torch.zeros((B, H), dtype=torch.float32, device=features.device)
        xs, final = lstm.unidirectional_scan(layer, xs, z, z, reverse,
                                             compute_dtype, use_kernel)
    return xs, final


def apply(params_fw: dict, params_bw: dict, features: torch.Tensor,
          compute_dtype: torch.dtype = torch.float32,
          use_kernel: bool = True
          ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns context (B, L, 2H) -- a view of a scan-major (L, B, 2H)
    buffer, so `context.transpose(0, 1)` is contiguous for the decode
    kernels -- and dec_init (c0, h0), each (B, 2H) float32."""
    hs_fw, (c_fw, h_fw) = apply_direction(params_fw, features, False,
                                          compute_dtype, use_kernel)
    hs_bw, (c_bw, h_bw) = apply_direction(params_bw, features, True,
                                          compute_dtype, use_kernel)
    context = torch.cat([hs_fw.transpose(0, 1), hs_bw.transpose(0, 1)],
                        dim=-1).transpose(0, 1)
    c0 = torch.cat([c_fw, c_bw], dim=-1)
    h0 = torch.cat([h_fw, h_bw], dim=-1)
    return context, (c0, h0)
