"""Image cotangent of conv1 + bias + ReLU + 2x2/2 max-pool
(csrc/conv1_pool_dx.cu).

Replaces `aocr/ops/pallas/conv1_pool.py::_dx_kernel` (called by
`_dx_call`): the gradient of `conv1_relu_pool` with respect to the image.
Each output cell's pooled cotangent is routed as the weight gradient
routes it (`conv1_pool_bwd.routed`, the kernels' shared
`csrc/conv1_route.cuh`), then its 16 patch taps are the sum W16 @ dcat
over the 4 window positions x 64 channels, rounded to the compute dtype.
Both versions accumulate in float32, as the TPU kernel does, in one
order (`tap_sum`): each channel adds one term to each tap (its winning
position's weight times its cotangent, one rounded product), the 64
channels are 16 groups of 4 channels 4 j .. 4 j + 3, each group summed
from +0 in channel order, and the 16 group sums meet in a fixed tree
(s_k + s_{k+8}, then 4 apart, 2 apart, 1 apart).  So the kernel and the
plain version agree bit for bit, where float32 sums in two orders would
not (cancelling terms).  Scattering the taps back onto the image
(`unpatch`, the TPU's `_unpatch`) is plain PyTorch, as it is plain XLA
there: the 16 tap planes add onto the zero-padded image in (a, b) order
in the compute dtype, then the padding is cropped.  That order matters in
bfloat16.

The kernel runs conv1_pool_bwd's plan (csrc/conv1_route.cuh `cb_plan`,
with its own STAGE_MAX): as many blocks as the card holds at once, each
on an equal run of the pooled cells, 16 lanes a cell, 4 channels a lane.
The taps are laid out (B, Ho, Wo, 16), a cell's 16 values together; the
TPU kernel's (16, Ho*Wo, B) is its batch-on-lanes layout.
"""

from __future__ import annotations

from typing import Optional

import torch

from aocr_torch.ops import cuda
from aocr_torch.ops.cuda import conv1_pool_bwd

launches = 0

C1 = 64
# csrc/conv1_pool_dx.cu's constants
CPT = 4  # channels a lane, whose terms a group sums in order
STAGE_MAX = 64 * 1024  # a block's staged image rows, bytes
# its static shared memory: the tap table (4 positions x 64 channels) and
# the group sums (16 cells x 16 lanes), rows of 16 floats + 4
STATIC_BYTES = 2 * 4 * 64 * 20 * 4

# launch plans held against the kernel's, by (B, H, W, dtype): (Plan, the
# line logged for it)
plans: dict = {}
# pool positions (pi, pj) in row-major window order
_POSITIONS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _w16(w: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """(64, 1, 3, 3) float32 -> W16 (16, 4, 64) float32 images of
    compute-dtype values: [(a, b), p, c] is the weight pre-pool pixel p =
    (pi, pj) applies to patch tap (a, b), w[c, 0, a - pi, b - pj], zero
    outside the 3x3 support."""
    w3 = w.reshape(C1, 3, 3).to(cd).float().permute(1, 2, 0)
    out = w.new_zeros((4, 4, 4, C1), dtype=torch.float32)
    for p, (pi, pj) in enumerate(_POSITIONS):
        out[pi:pi + 3, pj:pj + 3, p] = w3
    return out.reshape(16, 4, C1)


def tap_sum(terms: torch.Tensor) -> torch.Tensor:
    """The kernel's float32 sum of the channels' terms (64, ...) over the
    channels: 16 groups of CPT channels (group j: 4 j .. 4 j + 3), each
    summed from +0 in channel order, then the groups' sums in a fixed tree
    (group k + group k + 8, then 4 apart, 2 apart, 1 apart)."""
    groups = terms.reshape(C1 // CPT, CPT, *terms.shape[1:])
    s = torch.zeros_like(groups[:, 0])
    for k in range(CPT):
        s = s + groups[:, k]
    while s.shape[0] > 1:
        h = s.shape[0] // 2
        s = s[:h] + s[h:]
    return s[0]


def conv1_relu_pool_dx16_plain(x, w, b, dy):
    """Plain PyTorch version; same arguments and result as
    conv1_relu_pool_dx16."""
    dz, _ = conv1_pool_bwd.routed(x, w, b, dy)  # (B, 64, Ho, Wo, 4)
    cd = x.dtype
    w16 = _w16(w, cd)
    # channel c's term on each tap: one position of the four holds its
    # cotangent, the others 0, so the sum over positions is the one
    # rounded product
    terms = torch.einsum("tpc,bchwp->cbhwt", w16, dz)
    return tap_sum(terms).to(cd)


def plan(B: int, H: int, W: int,
         resident: int) -> Optional[conv1_pool_bwd.Plan]:
    """The kernel's launch plan (csrc/conv1_route.cuh `cb_plan`) for B
    images of H x W and the blocks the card holds at once (`resident`):
    conv1_pool_bwd's, with STAGE_MAX bytes of staged rows a block."""
    return conv1_pool_bwd.plan(B, H, W, resident, STAGE_MAX)


def checked_plan(B: int, H: int, W: int,
                 cd: torch.dtype) -> conv1_pool_bwd.Plan:
    """The launch's plan: ValueError where none fits; on a shape's first
    launch held against the kernel's own, with the blocks the card holds
    at once, and logged (`cuda.held_plan`)."""
    if plan(B, H, W, 1) is None:
        raise ValueError(f"conv1_pool_dx: no kernel plan fits B={B}, "
                         f"H={H}, W={W}")
    return cuda.held_plan(
        "conv1_pool_dx", (B, H, W, cd),
        lambda out: cuda.library().aocr_conv1_pool_dx_plan(
            B, H, W, int(cd == torch.float32), out), 4,
        lambda active: plan(B, H, W, active),
        lambda p, active: conv1_pool_bwd.plan_line(
            "conv1_pool_dx", p, active, B, H, W, cd), plans)


def conv1_relu_pool_dx16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         dy: torch.Tensor) -> torch.Tensor:
    """The 16 patch taps of each output cell's image cotangent.

    x (B, H, W, 1) in the compute dtype; w (64, 1, 3, 3) and b (64,)
    float32; dy (B, H//2, W//2, 64) in x's dtype, any strides.  Returns
    (B, H//2, W//2, 16) in x's dtype, tap a*4 + b the padded image's pixel
    (2*ho + a, 2*wo + b).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    global launches
    if x.device.type == "cpu":
        return conv1_relu_pool_dx16_plain(x, w, b, dy)
    if x.device.type != "cuda":
        raise ValueError(f"conv1_relu_pool_dx16: unsupported device "
                         f"{x.device}")
    B, H, W, C = x.shape
    cd, dev = x.dtype, x.device
    if C != 1 or tuple(w.shape) != (C1, 1, 3, 3) or H < 2 or W < 2:
        raise ValueError(f"conv1_relu_pool_dx16: x {tuple(x.shape)} / w "
                         f"{tuple(w.shape)} is not the conv1 geometry")
    dy = dy.contiguous()
    cuda.check(x, "x", (B, H, W, 1), cd, dev)
    cuda.check(b, "b", (C1,), torch.float32, dev)
    cuda.check(dy, "dy", (B, H // 2, W // 2, C1), cd, dev)
    if w.device != dev or w.dtype != torch.float32:
        raise ValueError("conv1_relu_pool_dx16: w must be float32 on x's "
                         "device")
    cuda.check_aligned(dy=dy)
    p = checked_plan(B, H, W, cd)
    out = torch.empty((B, H // 2, W // 2, 16), dtype=cd, device=dev)
    cuda.launch("conv1_pool_dx", cd, dev, x.data_ptr(),
                w.reshape(C1, 9).contiguous().data_ptr(), b.data_ptr(),
                dy.data_ptr(), out.data_ptr(), B, H, W, p.blocks)
    launches += 1
    return out


def unpatch(dx16: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, Ho, Wo, 16) taps -> the (B, H, W, 1) image cotangent: each tap
    plane adds onto the zero-padded (H + 2, W + 2) image in (a, b) order,
    in the taps' dtype, then the padding is cropped (conv1_pool.py:
    304-313)."""
    B, Ho, Wo, _ = dx16.shape
    dxp = dx16.new_zeros((B, H + 2, W + 2))
    for a in range(4):
        for bb in range(4):
            dxp[:, a:a + 2 * Ho:2, bb:bb + 2 * Wo:2] += dx16[..., a * 4 + bb]
    return dxp[:, 1:H + 1, 1:W + 1, None]


def conv1_relu_pool_dx_plain(x, w, b, dy):
    """Plain PyTorch version; same arguments and result as
    conv1_relu_pool_dx."""
    return unpatch(conv1_relu_pool_dx16_plain(x, w, b, dy), x.shape[1],
                   x.shape[2])


def conv1_relu_pool_dx(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       dy: torch.Tensor) -> torch.Tensor:
    """Gradient of conv1_relu_pool(x, w, b) with respect to x for the
    pooled cotangent dy: (B, H, W, 1) in x's dtype.  The taps come from
    conv1_relu_pool_dx16 (the kernel on CUDA tensors)."""
    return unpatch(conv1_relu_pool_dx16(x, w, b, dy), x.shape[1],
                   x.shape[2])
