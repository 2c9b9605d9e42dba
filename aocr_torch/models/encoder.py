"""Bidirectional LSTM encoder (counterpart of aocr/models/encoder.py).

Each direction is a stack of LSTM layers with zero initial state; the
context at column t is [h_fw_t ; h_bw_t]; the decoder starts from the
forward final state (after t=L) and the backward final state (after t=1).
With `fused_l0` (the CLI's -fused_encoder_proj) both directions' layer 0
runs from one input projection (lstm.bidirectional_scan), as
aocr/models/encoder.py does; the layers above keep the per-direction
scans.
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


def _run_layers(layers, xs: torch.Tensor, reverse: bool,
                compute_dtype: torch.dtype, use_kernel: bool, final=None):
    """Stacked layers, zero initial state each, over xs (B, L, D) ->
    (top-layer hs, top-layer finals; `final` where there is no layer)."""
    B = xs.shape[0]
    for layer in layers:
        H = layer["wh"].shape[0]
        z = torch.zeros((B, H), dtype=torch.float32, device=xs.device)
        xs, final = lstm.unidirectional_scan(layer, xs, z, z, reverse,
                                             compute_dtype, use_kernel)
    return xs, final


def apply_direction(params: dict, features: torch.Tensor, reverse: bool,
                    compute_dtype: torch.dtype = torch.float32,
                    use_kernel: bool = True):
    """features (B, L, D) -> (top-layer hs (B, L, H), top-layer finals)."""
    return _run_layers(params["layers"], features, reverse, compute_dtype,
                       use_kernel)


def apply(params_fw: dict, params_bw: dict, features: torch.Tensor,
          compute_dtype: torch.dtype = torch.float32,
          use_kernel: bool = True, fused_l0: bool = False
          ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns context (B, L, 2H) -- a view of a scan-major (L, B, 2H)
    buffer, so `context.transpose(0, 1)` is contiguous for the decode
    kernels -- and dec_init (c0, h0), each (B, 2H) float32.  fused_l0:
    layer 0 of both directions from one input projection."""
    if fused_l0:
        lf, lb = params_fw["layers"][0], params_bw["layers"][0]
        B, dev = features.shape[0], features.device
        zf = torch.zeros((B, lf["wh"].shape[0]), device=dev)
        zb = torch.zeros((B, lb["wh"].shape[0]), device=dev)
        hs_fw, fin_fw, hs_bw, fin_bw = lstm.bidirectional_scan(
            lf, lb, features, zf, zf, zb, zb, compute_dtype, use_kernel)
        hs_fw, (c_fw, h_fw) = _run_layers(params_fw["layers"][1:], hs_fw,
                                          False, compute_dtype, use_kernel,
                                          fin_fw)
        hs_bw, (c_bw, h_bw) = _run_layers(params_bw["layers"][1:], hs_bw,
                                          True, compute_dtype, use_kernel,
                                          fin_bw)
    else:
        hs_fw, (c_fw, h_fw) = apply_direction(params_fw, features, False,
                                              compute_dtype, use_kernel)
        hs_bw, (c_bw, h_bw) = apply_direction(params_bw, features, True,
                                              compute_dtype, use_kernel)
    context = torch.cat([hs_fw.transpose(0, 1), hs_bw.transpose(0, 1)],
                        dim=-1).transpose(0, 1)
    c0 = torch.cat([c_fw, c_bw], dim=-1)
    h0 = torch.cat([h_fw, h_bw], dim=-1)
    return context, (c0, h0)
