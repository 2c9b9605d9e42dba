"""conv1 + bias + ReLU + 2x2/2 max-pool in one kernel (csrc/conv1_pool.cu).

Replaces `aocr/ops/pallas/conv1_pool.py::_fwd_kernel` (the forward of
`conv1_relu_pool`).  The pre-pool (B, 32, W, 64) activation is never
written: each output cell reads its 4x4 input patch and keeps the four
pre-pool sums in registers.  The TPU kernel's batch-on-lanes layout is a
Mosaic relayout trick and is not carried over; the kernel writes NHWC,
which is channels_last for conv2.  Odd widths floor, as the reference's
VALID pool does (the TPU kernel took even widths only).

Numerics, as the TPU kernel and the XLA route: the 3x3 sum accumulates in
float32, rounds to the compute dtype, adds the bias in the compute dtype,
rounds again, then max and ReLU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aocr_torch.ops import cuda

launches = 0


def conv1_relu_pool_plain(x: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: x (B, H, W, 1) compute dtype, w (64, 1, 3, 3)
    float32, b (64,) float32 -> (B, H//2, W//2, 64) compute dtype."""
    cd = x.dtype
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.to(cd).float(), padding=1)
    y = y.to(cd) + b.to(cd)[:, None, None]
    y = torch.relu(F.max_pool2d(y, 2))
    return y.permute(0, 2, 3, 1).contiguous()


def conv1_relu_pool(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """max_pool_2x2(relu(conv3x3_same(x, w) + b)) for a 1-channel image.

    x (B, H, W, 1) in the compute dtype (float32 or bfloat16); w
    (64, 1, 3, 3) and b (64,) float32.  Returns (B, H//2, W//2, 64) NHWC in
    x's dtype.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    global launches
    if x.device.type == "cpu":
        return conv1_relu_pool_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"conv1_relu_pool: unsupported device {x.device}")
    B, H, W, C = x.shape
    cd = x.dtype
    if C != 1 or tuple(w.shape) != (64, 1, 3, 3) or H < 2 or W < 2:
        raise ValueError(f"conv1_relu_pool: x {tuple(x.shape)} / w "
                         f"{tuple(w.shape)} is not the conv1 geometry")
    dev = x.device
    cuda.check(x, "x", (B, H, W, 1), cd, dev)
    cuda.check(b, "b", (64,), torch.float32, dev)
    if w.device != dev or w.dtype != torch.float32:
        raise ValueError("conv1_relu_pool: w must be float32 on x's device")
    # (64, 1, 3, 3) -> (9, 64): tap-major, so 64 neighbouring threads read
    # 64 neighbouring weights
    w9 = w.reshape(64, 9).t().contiguous().to(cd)
    out = torch.empty((B, H // 2, W // 2, 64), dtype=cd, device=dev)
    cuda.launch("conv1_pool", cd, dev, x.data_ptr(), w9.data_ptr(),
                b.data_ptr(), out.data_ptr(), B, H, W)
    launches += 1
    return out
