"""LSTM primitives (counterpart of aocr/ops/lstm.py, forward only).

Gate layout [i | f | o | g] (sigmoid, sigmoid, sigmoid, tanh), then
c' = f*c + i*g and h' = o*tanh(c').  The input projection of all L steps
is hoisted into one matmul that emits the scan-major (L, B, 4H) stack; the
recurrence is the `lstm_fwd` kernel (plain loop on the CPU).

The bf16 roundings of the reference's default switches are kept: the
hoisted projection is stored in the compute dtype (`XPROJ_COMPUTE_DTYPE`)
and so is the h stack (`HSTACK_COMPUTE_DTYPE`); final states stay float32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from aocr_torch.ops.cuda import lstm_fwd
from aocr_torch.ops.mm import matmul


def gate_math(gates: torch.Tensor, c_prev: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused 4H pre-activations -> (c', h').  gates (..., 4H), c (..., H)."""
    i, f, o, g = gates.chunk(4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    o = torch.sigmoid(o)
    g = torch.tanh(g)
    c = f * c_prev + i * g
    h = o * torch.tanh(c)
    return c, h


def lstm_step(w_cat: torch.Tensor, bi: torch.Tensor, bh: torch.Tensor,
              x: torch.Tensor, c_prev: torch.Tensor, h_prev: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step: gates = [x; h] @ [Wi; Wh] + bi + bh, then gate math.
    w_cat is the concatenated weight already in the compute dtype (built
    once per decode, as XLA hoists it out of the loop)."""
    cd = w_cat.dtype
    xh = torch.cat([x.to(cd), h_prev.to(cd)], dim=-1)
    gates = matmul(xh, w_cat) + bi + bh
    return gate_math(gates, c_prev)


def proj_input(layer: dict, xs_lbd: torch.Tensor, cd: torch.dtype
               ) -> torch.Tensor:
    """Hoisted input projection of a scan-major (L, B, D) input ->
    (L, B, 4H), stored in the compute dtype."""
    xp = matmul(xs_lbd.to(cd), layer["wi"].to(cd)) + layer["bi"] + layer["bh"]
    return xp.to(cd) if cd != torch.float32 else xp


def unidirectional_scan(
    layer: dict,
    xs: torch.Tensor,
    c0: torch.Tensor,
    h0: torch.Tensor,
    reverse: bool = False,
    compute_dtype: torch.dtype = torch.float32,
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Run one LSTM layer over xs (B, L, D).

    Returns (hs (B, L, H) in original time order, (c_final, h_final)).
    With reverse=True the recurrence runs L..1 and the finals are the
    state after consuming step 1.  hs is a (B, L, H) view of the
    scan-major (L, B, H) stack.  use_kernel=False runs the plain scan on
    any device."""
    cd = compute_dtype
    xp = proj_input(layer, xs.transpose(0, 1), cd)
    wh = layer["wh"].to(cd).contiguous()
    scan = lstm_fwd.lstm_fwd_scan if use_kernel else lstm_fwd.lstm_fwd_scan_plain
    hs, finals = scan(wh, xp, c0.float(), h0.float(), reverse)
    return hs.transpose(0, 1), finals
