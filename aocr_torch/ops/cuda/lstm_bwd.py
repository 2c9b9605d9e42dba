"""One encoder direction's backward recurrence in one kernel
(csrc/lstm_bwd.cu).

Replaces `aocr/ops/pallas/lstm_bwd.py::lstm_bwd_scan`: from the residuals
of `lstm_fwd_scan(..., collect=True)` and the output cotangents, it
carries only (dh, dc) in float32, walking L in the transpose order of the
forward (L-1..0 for the forward encoder, 0..L-1 for the reversed one),
and emits the per-step pre-activation gate cotangents in the compute
dtype (the TPU kernel's contract; the plain version follows it) and the
initial-state cotangents.  dh_prev = round_cd(dgates) @ Wh^T, Wh in its
stored (H, 4H) orientation.  The weight, bias and input gradients are
batched outside (aocr_torch/ops/lstm.py).
"""

from __future__ import annotations

import torch

from aocr_torch.ops import cuda
from aocr_torch.ops.mm import matmul

launches = 0


def gate_math_bwd(dh, dc, acts, c, cp):
    """Backward of the gate math from the stored activations: returns
    (dgates (..., 4H) float32, dc carried to the previous step).  Same
    operations, in the same order, as aocr/ops/pallas/lstm_bwd.py."""
    i, f, o, g = (a.float() for a in acts)
    tc = torch.tanh(c.float())
    d_o = dh * tc
    dc = dc + dh * o * (1.0 - tc * tc)
    d_i, d_g, d_f = dc * g, dc * i, dc * cp.float()
    dgates = torch.cat([d_i * i * (1.0 - i), d_f * f * (1.0 - f),
                        d_o * o * (1.0 - o), d_g * (1.0 - g * g)], dim=-1)
    return dgates, dc * f


def lstm_bwd_scan_plain(wh, dhs, ifog, cs, c0, dc_f, dh_f, reverse: bool):
    """Plain PyTorch version; same arguments and results as
    lstm_bwd_scan."""
    L, B, H = dhs.shape
    cd = wh.dtype
    c0 = c0.to(cd)
    dh, dc = dh_f.float(), dc_f.float()
    dg = torch.empty((L, B, 4 * H), dtype=cd, device=dhs.device)
    for t in (range(L) if reverse else range(L - 1, -1, -1)):
        first = t == (L - 1 if reverse else 0)
        cp = c0 if first else cs[t + 1 if reverse else t - 1]
        dgates, dc = gate_math_bwd(dh + dhs[t].float(), dc,
                                   ifog[t].chunk(4, dim=-1), cs[t], cp)
        dg[t] = dgates.to(cd)
        dh = matmul(dg[t], wh.t())
    return dg, dh, dc


def lstm_bwd_scan(wh: torch.Tensor, dhs: torch.Tensor, ifog: torch.Tensor,
                  cs: torch.Tensor, c0: torch.Tensor, dc_f: torch.Tensor,
                  dh_f: torch.Tensor, reverse: bool):
    """wh (H, 4H) compute dtype (the stored orientation); dhs (L, B, H)
    float32 cotangents of the h stack; ifog (L, B, 4H) and cs (L, B, H)
    compute dtype, as lstm_fwd_scan(collect=True) wrote them; c0 (B, H)
    float32, the forward's initial cell state; dc_f, dh_f (B, H) float32
    cotangents of the final state.  `reverse` is the forward's direction.
    Returns (dgates (L, B, 4H) compute dtype, dh0, dc0 (B, H) float32).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global launches
    if wh.device.type == "cpu":
        return lstm_bwd_scan_plain(wh, dhs, ifog, cs, c0, dc_f, dh_f,
                                   reverse)
    if wh.device.type != "cuda":
        raise ValueError(f"lstm_bwd_scan: unsupported device {wh.device}")
    L, B, H = dhs.shape
    G = 4 * H
    cd, dev = wh.dtype, wh.device
    if H % 16 or L < 1 or B < 1:
        raise ValueError(f"lstm_bwd_scan: bad dhs shape {dhs.shape} (the "
                         "kernel takes H % 16 == 0)")
    cuda.check(wh, "wh", (H, G), cd, dev)
    cuda.check(dhs, "dhs", (L, B, H), torch.float32, dev)
    cuda.check(ifog, "ifog", (L, B, G), cd, dev)
    cuda.check(cs, "cs", (L, B, H), cd, dev)
    for name, t in (("c0", c0), ("dc_f", dc_f), ("dh_f", dh_f)):
        cuda.check(t, name, (B, H), torch.float32, dev)
    dg = torch.empty((L, B, G), dtype=cd, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dc0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    cuda.launch("lstm_bwd", cd, dev, wh.data_ptr(), dhs.data_ptr(),
                ifog.data_ptr(), cs.data_ptr(), c0.data_ptr(),
                dc_f.data_ptr(), dh_f.data_ptr(), dg.data_ptr(),
                dh0.data_ptr(), dc0.data_ptr(), L, B, H, int(reverse))
    launches += 1
    return dg, dh0, dc0
