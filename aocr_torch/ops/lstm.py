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


def _bidir_proj(wi_fw, wi_bw, biases_fw, biases_bw, xs, cd):
    """Both directions' layer-0 input projections from ONE (L*B, D) @
    (D, 8H) product (aocr/ops/lstm.py::_bidir_proj): (x_t (L, B, D) in the
    compute dtype, w8 (D, 8H), xp_fw, xp_bw (L, B, 4H)).  biases_*: (bi,
    bh), added in aocr's order.  The split projections are stored in the
    compute dtype, as `proj_input` stores the per-direction ones, so the
    fused path computes what the unfused one does; aocr's fused path
    keeps them float32 (it skips its XPROJ_COMPUTE_DTYPE rounding there),
    which in bf16 parts from its own unfused path by that rounding."""
    x_t = xs.transpose(0, 1).to(cd)
    w8 = torch.cat([wi_fw.to(cd), wi_bw.to(cd)], dim=1)
    proj = matmul(x_t, w8)
    G = wi_fw.shape[1]
    xp_fw = (proj[..., :G] + biases_fw[0] + biases_fw[1]).to(cd)
    xp_bw = (proj[..., G:] + biases_bw[0] + biases_bw[1]).to(cd)
    return x_t, w8, xp_fw.contiguous(), xp_bw.contiguous()


class BidirFn(torch.autograd.Function):
    """Both directions of one encoder layer from a fused input projection,
    with aocr's custom backward (aocr/ops/lstm.py::_bidir_custom): the
    forward runs one (L*B, D) @ (D, 8H) product, then each direction's
    `lstm_fwd` kernel (with residuals) from its half; the backward runs
    each direction's `lstm_bwd` kernel, then dWi is one (D, L*B) x
    (L*B, 8H) product and dxs one (L*B, 8H) x (8H, D) product, which sums
    the two directions' input cotangents.  Returns each direction's
    scan-major h stack (L, B, H) and float32 finals."""

    @staticmethod
    def forward(ctx, wi_f, wh_f, bi_f, bh_f, wi_b, wh_b, bi_b, bh_b, xs,
                c0f, h0f, c0b, h0b, cd: torch.dtype, use_kernel: bool):
        x_t, w8, xp_f, xp_b = _bidir_proj(wi_f, wi_b, (bi_f, bh_f),
                                          (bi_b, bh_b), xs, cd)
        scan = (lstm_fwd.lstm_fwd_scan if use_kernel
                else lstm_fwd.lstm_fwd_scan_plain)
        whf, whb = wh_f.to(cd).contiguous(), wh_b.to(cd).contiguous()
        hs_f, (cf_f, hf_f), (ifog_f, cs_f) = scan(
            whf, xp_f, c0f.float(), h0f.float(), False, collect=True)
        hs_b, (cf_b, hf_b), (ifog_b, cs_b) = scan(
            whb, xp_b, c0b.float(), h0b.float(), True, collect=True)
        ctx.save_for_backward(x_t, w8, whf, whb, c0f, h0f, c0b, h0b, hs_f,
                              ifog_f, cs_f, hs_b, ifog_b, cs_b)
        ctx.meta = (cd, use_kernel, xs.dtype)
        return hs_f, cf_f, hf_f, hs_b, cf_b, hf_b

    @staticmethod
    def backward(ctx, dhs_f, dcf_f, dhf_f, dhs_b, dcf_b, dhf_b):
        (x_t, w8, whf, whb, c0f, h0f, c0b, h0b, hs_f, ifog_f, cs_f, hs_b,
         ifog_b, cs_b) = ctx.saved_tensors
        cd, use_kernel, xs_dtype = ctx.meta
        bwd = (lstm_bwd.lstm_bwd_scan if use_kernel
               else lstm_bwd.lstm_bwd_scan_plain)
        f32 = lambda t: t.float().contiguous()  # noqa: E731
        dg_f, dh0f, dc0f = bwd(whf, f32(dhs_f), ifog_f, cs_f, f32(c0f),
                               f32(dcf_f), f32(dhf_f), False)
        dg_b, dh0b, dc0b = bwd(whb, f32(dhs_b), ifog_b, cs_b, f32(c0b),
                               f32(dcf_b), f32(dhf_b), True)
        # the x-side gradients of both directions: one wide product each
        dg8 = torch.cat([dg_f, dg_b], dim=-1)
        dwi8 = outer_sum(x_t, dg8)
        dxs = matmul(dg8, w8.t()).transpose(0, 1)
        dwh_f = outer_sum(shift(hs_f, h0f).to(cd), dg_f)
        dwh_b = outer_sum(shift(hs_b, h0b, True).to(cd), dg_b)
        db_f = dg_f.float().sum((0, 1))
        db_b = dg_b.float().sum((0, 1))
        G = dg_f.shape[-1]
        return (dwi8[:, :G], dwh_f, db_f, db_f, dwi8[:, G:], dwh_b, db_b,
                db_b, dxs.to(xs_dtype), dc0f, dh0f, dc0b, dh0b, None, None)


def bidirectional_scan(layer_fw: dict, layer_bw: dict, xs: torch.Tensor,
                       c0_fw, h0_fw, c0_bw, h0_bw,
                       compute_dtype: torch.dtype = torch.float32,
                       use_kernel: bool = True):
    """Both directions of one LSTM layer over xs (B, L, D) from one fused
    input projection (aocr/ops/lstm.py::bidirectional_scan): the math of
    two unidirectional_scan calls.  Returns (hs_fw (B, L, H), (c_f, h_f)
    fw, hs_bw (B, L, H), (c_f, h_f) bw); hs are views of scan-major
    stacks.  Where autograd records, the scan is `BidirFn`."""
    cd = compute_dtype
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (*layer_fw.values(),
                                      *layer_bw.values(), xs)):
        hs_f, cf_f, hf_f, hs_b, cf_b, hf_b = BidirFn.apply(
            layer_fw["wi"], layer_fw["wh"], layer_fw["bi"], layer_fw["bh"],
            layer_bw["wi"], layer_bw["wh"], layer_bw["bi"], layer_bw["bh"],
            xs, c0_fw, h0_fw, c0_bw, h0_bw, cd, use_kernel)
        return (hs_f.transpose(0, 1), (cf_f, hf_f), hs_b.transpose(0, 1),
                (cf_b, hf_b))
    _x, _w, xp_f, xp_b = _bidir_proj(
        layer_fw["wi"], layer_bw["wi"], (layer_fw["bi"], layer_fw["bh"]),
        (layer_bw["bi"], layer_bw["bh"]), xs, cd)
    scan = lstm_fwd.lstm_fwd_scan if use_kernel else lstm_fwd.lstm_fwd_scan_plain
    hs_f, fin_f = scan(layer_fw["wh"].to(cd).contiguous(), xp_f,
                       c0_fw.float(), h0_fw.float(), False)
    hs_b, fin_b = scan(layer_bw["wh"].to(cd).contiguous(), xp_b,
                       c0_bw.float(), h0_bw.float(), True)
    return hs_f.transpose(0, 1), fin_f, hs_b.transpose(0, 1), fin_b
