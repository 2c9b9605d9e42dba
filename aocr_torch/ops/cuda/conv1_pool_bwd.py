"""Backward of conv1 + bias + ReLU + 2x2/2 max-pool (csrc/conv1_pool_bwd.cu).

Replaces `aocr/ops/pallas/conv1_pool.py::_bwd_kernel`: the weight and
bias gradients of `conv1_relu_pool` from the pooled cotangent dy, never
materializing the pre-pool activation.  Each cell's four pre-pool scores
are recomputed as the forward rounds them; dy goes to the FIRST position
attaining the window max in row-major window order (select_and_scatter's
tie rule), and only where that max is positive (the ReLU); dW and db
accumulate in float32.  The image cotangent is `conv1_pool_dx`; both
kernels route through `csrc/conv1_route.cuh`, and both plain versions
through `routed` here.

The 9-tap score sum runs in tap order with separately rounded products
and sums on both sides, so the kernel and the plain version route every
cotangent, ties included, identically.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aocr_torch.ops import cuda

launches = 0

C1 = 64


def _scores(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """Pre-pool scores (B, 64, H, W) as float32 images of compute-dtype
    values: the 9-tap sum in tap order, rounded, + the rounded bias,
    rounded."""
    cd = x.dtype
    B, H, W, _ = x.shape
    xp = F.pad(x[..., 0].float(), (1, 1, 1, 1))
    w9 = w.reshape(C1, 9).to(cd).float()
    s = torch.zeros((B, C1, H, W), dtype=torch.float32, device=x.device)
    for k in range(9):
        ky, kx = divmod(k, 3)
        s = s + xp[:, None, ky:ky + H, kx:kx + W] * w9[:, k, None, None]
    return (s.to(cd) + b.to(cd)[:, None, None]).float()


def routed(x, w, b, dy):
    """The pooled cotangent routed to the window positions: (dz (B, 64,
    Ho, Wo, 4) float32, positions in row-major window order, and g (B, 64,
    Ho, Wo, 1) float32, dy where the window max is positive)."""
    B, H, W, _ = x.shape
    Ho, Wo = H // 2, W // 2
    z = _scores(x, w, b)[:, :, :2 * Ho, :2 * Wo]
    z = z.reshape(B, C1, Ho, 2, Wo, 2).permute(0, 1, 2, 4, 3, 5)
    z = z.reshape(B, C1, Ho, Wo, 4)
    m = z.amax(-1, keepdim=True)
    eq = z == m
    first = eq & (eq.cumsum(-1) == 1)
    g = torch.where(m > 0, dy.permute(0, 3, 1, 2)[..., None].float(), 0.0)
    return torch.where(first, g, 0.0), g


def conv1_relu_pool_bwd_plain(x, w, b, dy):
    """Plain PyTorch version; same arguments and results as
    conv1_relu_pool_bwd."""
    B, H, W, _ = x.shape
    Ho, Wo = H // 2, W // 2
    dz, g = routed(x, w, b, dy)
    db = g.sum((0, 2, 3, 4))
    dz = dz.reshape(B, C1, Ho, Wo, 2, 2).permute(0, 1, 2, 4, 3, 5)
    dz = F.pad(dz.reshape(B, C1, 2 * Ho, 2 * Wo),
               (0, W - 2 * Wo, 0, H - 2 * Ho))
    xp = F.pad(x[..., 0].float(), (1, 1, 1, 1))
    dw = torch.stack([
        (dz * xp[:, None, ky:ky + H, kx:kx + W]).sum((0, 2, 3))
        for ky in range(3) for kx in range(3)], dim=1)
    return dw.reshape(C1, 1, 3, 3), db


def conv1_relu_pool_bwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        dy: torch.Tensor):
    """Gradients of conv1_relu_pool(x, w, b) for the cotangent dy.

    x (B, H, W, 1) in the compute dtype; w (64, 1, 3, 3) and b (64,)
    float32; dy (B, H//2, W//2, 64) in x's dtype, any strides (a
    channels_last conv2 backward hands it over contiguous).  Returns
    (dw (64, 1, 3, 3), db (64,)), float32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    global launches
    if x.device.type == "cpu":
        return conv1_relu_pool_bwd_plain(x, w, b, dy)
    if x.device.type != "cuda":
        raise ValueError(f"conv1_relu_pool_bwd: unsupported device "
                         f"{x.device}")
    B, H, W, C = x.shape
    cd, dev = x.dtype, x.device
    if C != 1 or tuple(w.shape) != (C1, 1, 3, 3) or H < 2 or W < 2:
        raise ValueError(f"conv1_relu_pool_bwd: x {tuple(x.shape)} / w "
                         f"{tuple(w.shape)} is not the conv1 geometry")
    dy = dy.contiguous()
    cuda.check(x, "x", (B, H, W, 1), cd, dev)
    cuda.check(b, "b", (C1,), torch.float32, dev)
    cuda.check(dy, "dy", (B, H // 2, W // 2, C1), cd, dev)
    if w.device != dev or w.dtype != torch.float32:
        raise ValueError("conv1_relu_pool_bwd: w must be float32 on x's "
                         "device")
    w9 = w.reshape(C1, 9).t().contiguous().to(cd)
    part = torch.empty((B, C1, 10), dtype=torch.float32, device=dev)
    out = torch.empty((C1, 10), dtype=torch.float32, device=dev)
    cuda.launch("conv1_pool_bwd", cd, dev, x.data_ptr(), w9.data_ptr(),
                b.data_ptr(), dy.data_ptr(), part.data_ptr(), out.data_ptr(),
                B, H, W)
    launches += 1
    return out[:, :9].reshape(C1, 1, 3, 3), out[:, 9].contiguous()
