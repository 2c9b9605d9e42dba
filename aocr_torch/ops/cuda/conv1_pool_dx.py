"""Image cotangent of conv1 + bias + ReLU + 2x2/2 max-pool
(csrc/conv1_pool_dx.cu).

Replaces `aocr/ops/pallas/conv1_pool.py::_dx_kernel` (called by
`_dx_call`): the gradient of `conv1_relu_pool` with respect to the image.
Each output cell's pooled cotangent is routed as the weight gradient
routes it (`conv1_pool_bwd.routed`, the kernels' shared
`csrc/conv1_route.cuh`), then its 16 patch taps are the sum W16 @ dcat
over the 4 window positions x 64 channels, rounded to the compute dtype.
Both versions accumulate in float32, as the TPU kernel does, in one
order: channel by channel, each channel adding at most one term to a tap
(its winning position's), with separately rounded products and sums.  So
the kernel and the plain version agree bit for bit, where float32 sums in
two orders would not (cancelling terms).  Scattering the taps back onto the image (`unpatch`, the
TPU's `_unpatch`) is plain PyTorch, as it is plain XLA there: the 16 tap
planes add onto the zero-padded image in (a, b) order in the compute
dtype, then the padding is cropped.  That order matters in bfloat16.

The taps are laid out (B, Ho, Wo, 16), a cell's 16 values together; the
TPU kernel's (16, Ho*Wo, B) is its batch-on-lanes layout.
"""

from __future__ import annotations

import torch

from aocr_torch.ops import cuda
from aocr_torch.ops.cuda import conv1_pool_bwd

launches = 0

C1 = 64
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


def conv1_relu_pool_dx16_plain(x, w, b, dy):
    """Plain PyTorch version; same arguments and result as
    conv1_relu_pool_dx16."""
    dz, _ = conv1_pool_bwd.routed(x, w, b, dy)  # (B, 64, Ho, Wo, 4)
    cd = x.dtype
    w16 = _w16(w, cd)
    B, _, Ho, Wo, _ = dz.shape
    taps = dz.new_zeros((B, Ho, Wo, 16))
    for c in range(C1):
        # one position of the four holds the channel's term, the others 0:
        # the sum over positions is the one rounded product
        taps = taps + torch.einsum("tp,bhwp->bhwt", w16[:, :, c], dz[:, c])
    return taps.to(cd)


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
    w9 = w.reshape(C1, 9).t().contiguous().to(cd)
    out = torch.empty((B, H // 2, W // 2, 16), dtype=cd, device=dev)
    cuda.launch("conv1_pool_dx", cd, dev, x.data_ptr(), w9.data_ptr(),
                b.data_ptr(), dy.data_ptr(), out.data_ptr(), B, H, W)
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
