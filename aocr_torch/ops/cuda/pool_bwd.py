"""Fused ReLU + max-pool backward from the ReLU output (csrc/pool_bwd.cu).

Replaces `aocr/ops/pallas/pool_bwd.py::relu_pool_bwd`: the backward of
z -> max_pool(relu(z)) read from y = relu(z) alone.  dz is dy routed to
the FIRST element equal to the window max in row-major window order,
zero where y == 0.  That is bit-identical to the autograd of
`F.max_pool2d` over `torch.relu`: PyTorch's max-pool keeps the first
maximum, and the ReLU backward masks on its output, where an element with
y == 0 can only win a window whose max is 0.  The fused backward needs no
pool indices (int64, written by `max_pool2d_with_indices` and read back)
and no separate ReLU-backward pass.

`ENABLE` selects it for the CNN's pools in training (models/cnn.py
`ReluPoolFn`, as `aocr`'s flag of the same name).  Off in `aocr`, where
the TPU kernel broke XLA's layouts of the CNN backward (pool_bwd.py:
46-59); that reason does not hold on the card.  Pools whose spatial dims
do not divide the window (`supported`) keep `torch.relu` +
`F.max_pool2d`, as in `aocr`; `launches_ragged` counts those, so the
split stays visible.
"""

from __future__ import annotations

from typing import Tuple

import torch

from aocr_torch.ops import cuda

ENABLE = True

launches = 0
# pools on the training path that took torch.relu + F.max_pool2d because
# their shape is ragged (not a kernel launch)
launches_ragged = 0


def supported(shape: Tuple[int, ...], window: Tuple[int, int]) -> bool:
    """Spatial dims divisible by the window (aocr's gate, pool_bwd.py:
    144-148); shape is NCHW here."""
    _B, _C, H, W = shape
    wh, ww = window
    return H % wh == 0 and W % ww == 0


def relu_pool_bwd_plain(y: torch.Tensor, dy: torch.Tensor,
                        window: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version; same arguments and result as relu_pool_bwd
    (NCHW contiguous)."""
    B, C, H, W = y.shape
    wh, ww = window
    Ho, Wo = H // wh, W // ww
    yw = (y.reshape(B, C, Ho, wh, Wo, ww).permute(0, 1, 2, 4, 3, 5)
          .reshape(B, C, Ho, Wo, wh * ww).float())
    m = yw.amax(-1, keepdim=True)
    eq = yw == m
    first = eq & (eq.cumsum(-1) == 1)
    dz = torch.where(first & (yw > 0), dy.float()[..., None], 0.0)
    dz = dz.reshape(B, C, Ho, Wo, wh, ww).permute(0, 1, 2, 4, 3, 5)
    return dz.reshape(B, C, H, W).to(y.dtype)


def relu_pool_bwd(y: torch.Tensor, dy: torch.Tensor,
                  window: Tuple[int, int]) -> torch.Tensor:
    """Backward of z -> max_pool(relu(z), window) from the ReLU output.

    y (B, C, H, W) = relu(z), the pool's input; dy (B, C, H//wh, W//ww)
    the pooled cotangent, in y's dtype.  On CUDA y must be channels_last
    (the layout convs 2-7 keep), with H and W divisible by the window and
    C by 8; dy is made channels_last.  Returns dz like y.  CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    global launches
    if y.device.type == "cpu":
        return relu_pool_bwd_plain(y, dy, window)
    if y.device.type != "cuda":
        raise ValueError(f"relu_pool_bwd: unsupported device {y.device}")
    B, C, H, W = y.shape
    wh, ww = window
    cl = torch.channels_last
    if not supported(y.shape, window) or C % 8:
        raise ValueError(f"relu_pool_bwd: y {tuple(y.shape)} with window "
                         f"{window} is not supported")
    if y.dtype not in (torch.float32, torch.bfloat16) or dy.dtype != y.dtype:
        raise ValueError(f"relu_pool_bwd: dtypes {y.dtype} / {dy.dtype}")
    if tuple(dy.shape) != (B, C, H // wh, W // ww) or dy.device != y.device:
        raise ValueError(f"relu_pool_bwd: dy {tuple(dy.shape)} on "
                         f"{dy.device} does not match y {tuple(y.shape)}")
    if not y.is_contiguous(memory_format=cl):
        raise ValueError("relu_pool_bwd: y must be channels_last")
    dy = dy.contiguous(memory_format=cl)
    dz = torch.empty_like(y, memory_format=cl)
    if y.data_ptr() % 16 or dy.data_ptr() % 16:
        raise ValueError("relu_pool_bwd: y and dy must be 16-byte aligned")
    cuda.launch("pool_bwd", y.dtype, y.device, y.data_ptr(), dy.data_ptr(),
                dz.data_ptr(), B, H, W, C, wh, ww)
    launches += 1
    return dz
