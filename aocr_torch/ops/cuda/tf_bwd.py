"""The teacher-forced decoder backward recurrence in one kernel
(csrc/tf_bwd.cu).

Replaces `aocr/ops/pallas/tf_bwd.py::decoder_bwd_scan`: walking t = T-1..0
over the residuals of `decoder_fwd_scan(..., collect=True)`, it carries
only dattn and each layer's (dc, dh) in float32 and emits the per-step
cotangent stacks the weight gradients are batched from: per layer dgates,
and dh~ (pre-tanh), dq and dcvec in the compute dtype, dscore float32,
plus the layer-0 initial-state cotangents.  Each step is the TPU kernel's
chain: dh~ -> dcat -> dalpha and the softmax backward (from the float32
dcvec) -> dq (from the float32 dscore) -> dtop, then the layers from the
top down; the weights are contracted in their stored orientation.
"""

from __future__ import annotations

import torch

from aocr_torch.ops import cuda
from aocr_torch.ops.cuda.lstm_bwd import gate_math_bwd
from aocr_torch.ops.mm import matmul

launches = 0


def decoder_bwd_scan_plain(ctx_lbh, wfh0, rest_w, wc, wa, dys, htl, alpha,
                           ifog, cs, c0, input_feed: bool):
    """Plain PyTorch version; same arguments and results as
    decoder_bwd_scan."""
    cd = ctx_lbh.dtype
    nl, T, B, G = ifog.shape
    H = G // 4
    dev = dys.device
    ctx = ctx_lbh.float()
    f32 = torch.float32
    zeros = torch.zeros((B, H), dtype=f32, device=dev)
    dattn, dcs, dhs = zeros, [zeros] * nl, [zeros] * nl
    dg = torch.empty((nl, T, B, G), dtype=cd, device=dev)
    dht_st, dq_st, dcvec_st = (torch.empty((T, B, H), dtype=cd, device=dev)
                               for _ in range(3))
    dscore_st = torch.empty_like(alpha)
    c0 = c0.to(cd)
    for t in range(T - 1, -1, -1):
        dht = ((dattn + dys[t].float()) * (1.0 - htl[t] * htl[t])).to(cd)
        dcat = matmul(dht, wc.t())
        dcvec, dtop = dcat[:, :H], dcat[:, H:]
        a = alpha[t]
        tmp = a * torch.einsum("lbh,bh->bl", ctx, dcvec)
        dscore = tmp - a * tmp.sum(-1, keepdim=True)
        dq = torch.einsum("bl,lbh->bh", dscore, ctx).to(cd)
        dx = dtop + matmul(dq, wa.t())
        for l in range(nl - 1, -1, -1):
            if t > 0:
                cp = cs[l, t - 1]
            else:
                cp = c0 if l == 0 else torch.zeros_like(cs[l, 0])
            dgates, dcs[l] = gate_math_bwd(dhs[l] + dx, dcs[l],
                                           ifog[l, t].chunk(4, dim=-1),
                                           cs[l, t], cp)
            dg[l, t] = dgates.to(cd)
            if l > 0:
                dxh = matmul(dg[l, t], rest_w[l - 1].t())
                dx, dhs[l] = dxh[:, :H], dxh[:, H:]
            else:
                dah = matmul(dg[0, t], wfh0.t())
                if input_feed:
                    dattn, dhs[0] = dah[:, :H], dah[:, H:]
                else:
                    dhs[0] = dah
        dht_st[t], dq_st[t], dcvec_st[t] = dht, dq, dcvec.to(cd)
        dscore_st[t] = dscore
    return dg, dht_st, dq_st, dcvec_st, dscore_st, dcs[0], dhs[0]


def decoder_bwd_scan(ctx_lbh: torch.Tensor, wfh0: torch.Tensor, rest_w,
                     wc: torch.Tensor, wa: torch.Tensor, dys: torch.Tensor,
                     htl: torch.Tensor, alpha: torch.Tensor,
                     ifog: torch.Tensor, cs: torch.Tensor, c0: torch.Tensor,
                     input_feed: bool):
    """ctx_lbh (L, B, H), wfh0 (K0, 4H), rest_w (per layer above 0, (2H, 4H)),
    wc (2H, H), wa (H, H): the forward's operands, compute dtype, stored
    orientation.  dys (T, B, H) float32 cotangent of h~; htl (T, B, H)
    and alpha (T, B, L) float32, ifog (nl, T, B, 4H) and cs (nl, T, B, H)
    compute dtype: the forward's residuals; c0 (B, H) float32.

    Returns (dgates (nl, T, B, 4H), dht, dq, dcvec (T, B, H), all compute
    dtype; dscore (T, B, L) float32; dc0, dh0 (B, H) float32).  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    global launches
    if dys.device.type == "cpu":
        return decoder_bwd_scan_plain(ctx_lbh, wfh0, rest_w, wc, wa, dys,
                                      htl, alpha, ifog, cs, c0, input_feed)
    if dys.device.type != "cuda":
        raise ValueError(f"decoder_bwd_scan: unsupported device {dys.device}")
    L, B, H = ctx_lbh.shape
    nl, T = ifog.shape[:2]
    G = 4 * H
    cd, dev = ctx_lbh.dtype, dys.device
    f32 = torch.float32
    if H % 16 or nl != 1 + len(rest_w):
        raise ValueError(f"decoder_bwd_scan: H={H} (the kernel takes "
                         f"H % 16 == 0), {nl} layers of residuals for "
                         f"{1 + len(rest_w)} of weights")
    cuda.check(ctx_lbh, "ctx_lbh", (L, B, H), cd, dev)
    cuda.check(wfh0, "wfh0", (2 * H if input_feed else H, G), cd, dev)
    for k, w in enumerate(rest_w):
        cuda.check(w, f"rest_w[{k}]", (2 * H, G), cd, dev)
    cuda.check(wc, "wc", (2 * H, H), cd, dev)
    cuda.check(wa, "wa", (H, H), cd, dev)
    cuda.check(dys, "dys", (T, B, H), f32, dev)
    cuda.check(htl, "htl", (T, B, H), f32, dev)
    cuda.check(alpha, "alpha", (T, B, L), f32, dev)
    cuda.check(ifog, "ifog", (nl, T, B, G), cd, dev)
    cuda.check(cs, "cs", (nl, T, B, H), cd, dev)
    cuda.check(c0, "c0", (B, H), f32, dev)
    wx = torch.stack(list(rest_w)) if rest_w else None
    dg = torch.empty((nl, T, B, G), dtype=cd, device=dev)
    dht, dq, dcvec = (torch.empty((T, B, H), dtype=cd, device=dev)
                      for _ in range(3))
    dscore = torch.empty((T, B, L), dtype=f32, device=dev)
    dc0 = torch.empty((B, H), dtype=f32, device=dev)
    dh0 = torch.empty((B, H), dtype=f32, device=dev)
    state = torch.empty((B, 2 * nl + 1, H), dtype=f32, device=dev)
    cuda.launch("tf_bwd", cd, dev, ctx_lbh.data_ptr(), wfh0.data_ptr(),
                None if wx is None else wx.data_ptr(), wc.data_ptr(),
                wa.data_ptr(), dys.data_ptr(), htl.data_ptr(),
                alpha.data_ptr(), ifog.data_ptr(), cs.data_ptr(),
                c0.data_ptr(), dg.data_ptr(), dht.data_ptr(), dq.data_ptr(),
                dcvec.data_ptr(), dscore.data_ptr(), dc0.data_ptr(),
                dh0.data_ptr(), state.data_ptr(), L, B, H, T, nl,
                int(input_feed))
    launches += 1
    return dg, dht, dq, dcvec, dscore, dc0, dh0
