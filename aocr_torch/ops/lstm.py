"""LSTM primitives (counterpart of aocr/ops/lstm.py).

Gate layout [i | f | o | g] (sigmoid, sigmoid, sigmoid, tanh), then
c' = f*c + i*g and h' = o*tanh(c').  The input projection of all L steps
is hoisted into one matmul that emits the scan-major (L, B, 4H) stack; the
recurrence is the `lstm_fwd` kernel (plain loop on the CPU).

Under autograd the scan is the custom backward of the reference's
`_scan_custom`: the forward kernel also stores the gate activations and
cell states, the `lstm_bwd` kernel carries only (dh, dc) back through
time, and dWh, dWi, db and dx are batched products over the whole
sequence (`ScanFn`).

The bf16 roundings of the reference's default switches are kept: the
hoisted projection is stored in the compute dtype (`XPROJ_COMPUTE_DTYPE`)
and so is the h stack (`HSTACK_COMPUTE_DTYPE`); final states stay float32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from aocr_torch.ops.cuda import lstm_bwd, lstm_fwd
from aocr_torch.ops.mm import matmul, outer_sum


def gate_math(gates: torch.Tensor, c_prev: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused 4H pre-activations -> (c', h').  gates (..., 4H), c (..., H)."""
    return gate_math_parts(gates, c_prev)[:2]


def gate_math_parts(gates: torch.Tensor, c_prev: torch.Tensor):
    """gate_math that also returns the activations (i, f, o, g), the
    residuals the training backward reads."""
    i, f, o, g = gates.chunk(4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f)
    o = torch.sigmoid(o)
    g = torch.tanh(g)
    c = f * c_prev + i * g
    h = o * torch.tanh(c)
    return c, h, (i, f, o, g)


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


def shift(seq: torch.Tensor, init: torch.Tensor, reverse: bool = False
          ) -> torch.Tensor:
    """The state each step of a scan-major (L, B, ...) stack consumed: the
    previous step's, and `init` at the first step walked."""
    init = init.to(seq.dtype)[None]
    if reverse:
        return torch.cat([seq[1:], init], dim=0)
    return torch.cat([init, seq[:-1]], dim=0)


class ScanFn(torch.autograd.Function):
    """One LSTM layer over xs (B, L, D) with the reference's custom
    backward (aocr/ops/lstm.py::_scan_custom).  Returns the scan-major h
    stack (L, B, H) in the compute dtype and the float32 finals (c_f,
    h_f).  `use_kernel` False runs the kernels' plain versions on any
    device."""

    @staticmethod
    def forward(ctx, wi, wh, bi, bh, xs, c0, h0, reverse: bool,
                cd: torch.dtype, use_kernel: bool):
        xp = proj_input({"wi": wi, "bi": bi, "bh": bh}, xs.transpose(0, 1),
                        cd)
        wh_cd = wh.to(cd).contiguous()
        scan = (lstm_fwd.lstm_fwd_scan if use_kernel
                else lstm_fwd.lstm_fwd_scan_plain)
        hs, (cf, hf), (ifog, cs) = scan(wh_cd, xp, c0.float(), h0.float(),
                                        reverse, collect=True)
        ctx.save_for_backward(wi, wh_cd, xs, c0, h0, hs, ifog, cs)
        ctx.meta = (reverse, cd, use_kernel)
        return hs, cf, hf

    @staticmethod
    def backward(ctx, dhs, dcf, dhf):
        wi, wh_cd, xs, c0, h0, hs, ifog, cs = ctx.saved_tensors
        reverse, cd, use_kernel = ctx.meta
        bwd = (lstm_bwd.lstm_bwd_scan if use_kernel
               else lstm_bwd.lstm_bwd_scan_plain)
        dg, dh0, dc0 = bwd(wh_cd, dhs.float().contiguous(), ifog, cs,
                           c0.float().contiguous(), dcf.float().contiguous(),
                           dhf.float().contiguous(), reverse)
        # weight, bias and input grads: batched over the whole sequence
        dwh = outer_sum(shift(hs, h0, reverse).to(cd), dg)
        dwi = outer_sum(xs.transpose(0, 1).to(cd), dg)
        db = dg.float().sum((0, 1))
        dxs = matmul(dg, wi.to(cd).t()).transpose(0, 1)
        return (dwi, dwh, db, db, dxs.to(xs.dtype), dc0, dh0, None, None,
                None)


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
    any device.  Where autograd records (a weight or xs requires grad),
    the scan is `ScanFn`."""
    cd = compute_dtype
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (*layer.values(), xs, c0, h0)):
        hs, cf, hf = ScanFn.apply(layer["wi"], layer["wh"], layer["bi"],
                                  layer["bh"], xs, c0, h0, reverse, cd,
                                  use_kernel)
        return hs.transpose(0, 1), (cf, hf)
    xp = proj_input(layer, xs.transpose(0, 1), cd)
    wh = layer["wh"].to(cd).contiguous()
    scan = lstm_fwd.lstm_fwd_scan if use_kernel else lstm_fwd.lstm_fwd_scan_plain
    hs, finals = scan(wh, xp, c0.float(), h0.float(), reverse)
    return hs.transpose(0, 1), finals
