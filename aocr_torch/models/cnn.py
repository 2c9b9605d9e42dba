"""CNN feature extractor (counterpart of aocr/models/cnn.py).

normalize (x-128)/128, then 7 convolutions (64,128,256,256,512,512,512)
with ReLU, eval BatchNorm after convs 3, 5 and 7, and four max-pools
(2x2/2, 2x2/2, then height-only 2x1 twice), ending with a 2x2 VALID conv
that collapses the height.  Output (B, L, 512), L = W//4 - 1.

Layout: images arrive NHWC as in the reference; conv1 (the `conv1_pool`
kernel) writes NHWC, which PyTorch sees as an NCHW tensor in channels_last
memory, the layout cuDNN prefers for convs 2-7.  Those convs stay
`F.conv2d`: in the reference they are XLA convolutions outside any kernel.

Numerics as the reference: each conv output is rounded to the compute
dtype before its bias is added in the compute dtype; eval BN is one affine
x*a + b in the compute dtype, with (a, b) computed in float32 from the
stored running variance.

Training (`train=True`) keeps the reference's custom backward passes:
conv1's is the `conv1_pool_bwd` kernel, and its image cotangent the
`conv1_pool_dx` kernel (`Conv1PoolFn`); the other conv biases reduce
their gradient in float32 (`BiasAddFn`, cnn.py:273-288); train-mode
BatchNorm normalizes with the batch's biased variance, stores the
unbiased n/(n-1) one in the running statistics, and runs the closed-form
backward with both channel sums in float32 (`BNTrainFn`, cnn.py:303-383),
or, under a row mask, weighted moments and plain autograd (cnn.py:
384-422); the pools after convs 2, 4 and 6 run the `pool_bwd` kernel as
their backward (`ReluPoolFn`, cnn.py:209-235) while `pool_bwd.ENABLE`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from aocr_torch.ops.cuda import (conv1_pool, conv1_pool_bwd, conv1_pool_dx,
                                 pool_bwd)

# name, in_c, out_c, kh, kw, padding, bn  (aocr/models/cnn.py:_CONV_DEFS)
CONV_DEFS = (
    ("conv1", 1, 64, 3, 3, "SAME", False),
    ("conv2", 64, 128, 3, 3, "SAME", False),
    ("conv3", 128, 256, 3, 3, "SAME", True),
    ("conv4", 256, 256, 3, 3, "SAME", False),
    ("conv5", 256, 512, 3, 3, "SAME", True),
    ("conv6", 512, 512, 3, 3, "SAME", False),
    ("conv7", 512, 512, 2, 2, "VALID", True),
)
# max-pool (h, w) window after the conv at this index
POOL_AFTER = {0: (2, 2), 1: (2, 2), 3: (2, 1), 5: (2, 1)}
BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # running stat update: new = m*old + (1-m)*batch


def output_length(width: int) -> int:
    """Column-sequence length for an input width."""
    return width // 4 - 1


def init_params(gen: torch.Generator, device="cpu") -> dict:
    """uniform(+-1/sqrt(fan_in)) conv weights (O, I, kh, kw) and biases;
    BN scale 1, shift 0."""
    params = {}
    for name, in_c, out_c, kh, kw, _pad, bn in CONV_DEFS:
        bound = 1.0 / math.sqrt(in_c * kh * kw)
        u = lambda *s: (torch.rand(*s, generator=gen) * 2 - 1) * bound
        params[name] = {"w": u(out_c, in_c, kh, kw).to(device),
                        "b": u(out_c).to(device)}
        if bn:
            params[name + "_bn"] = {
                "scale": torch.ones(out_c, device=device),
                "bias": torch.zeros(out_c, device=device)}
    return params


def init_batch_stats(device="cpu") -> dict:
    return {name + "_bn": {"mean": torch.zeros(out_c, device=device),
                           "var": torch.ones(out_c, device=device)}
            for name, _i, out_c, _kh, _kw, _p, bn in CONV_DEFS if bn}


def _bn_eval(x: torch.Tensor, p: dict, s: dict) -> torch.Tensor:
    inv = torch.rsqrt(s["var"] + BN_EPS) * p["scale"]
    a = inv.to(x.dtype)[:, None, None]
    b = (p["bias"] - s["mean"] * inv).to(x.dtype)[:, None, None]
    return x * a + b


def _channels(v: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """A per-channel (C,) vector in the compute dtype, broadcast over an
    NCHW activation."""
    return v.to(cd)[:, None, None]


class Conv1PoolFn(torch.autograd.Function):
    """conv1 + bias + ReLU + 2x2 pool: the `conv1_pool` kernel forward;
    backward, the `conv1_pool_bwd` kernel (dW, db) and the `conv1_pool_dx`
    kernel (the image cotangent), each run only when its gradient is
    needed.  x (B, H, W, 1) in the compute dtype; returns (B, H//2, W//2,
    64) NHWC."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return conv1_pool.conv1_relu_pool(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv1_pool_dx.conv1_relu_pool_dx(x, w, b, dy)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = conv1_pool_bwd.conv1_relu_pool_bwd(x, w, b, dy)
        return dx, dw, db


class ReluPoolFn(torch.autograd.Function):
    """max_pool(relu(z)) whose backward is the `pool_bwd` kernel, read
    from y = relu(z) alone: the forward keeps no pool indices, only y.
    Bit-identical to the autograd of F.max_pool2d over torch.relu."""

    @staticmethod
    def forward(ctx, z, window):
        y = torch.relu(z)
        ctx.save_for_backward(y)
        ctx.window = window
        return F.max_pool2d(y, window)

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        return pool_bwd.relu_pool_bwd(y, dy, ctx.window), None


class BiasAddFn(torch.autograd.Function):
    """x + b in the compute dtype; the bias gradient sums the cotangent
    over (N, H, W) in float32 (the reference's _bias_add)."""

    @staticmethod
    def forward(ctx, x, b):
        return x + _channels(b, x.dtype)

    @staticmethod
    def backward(ctx, dy):
        return dy, dy.float().sum((0, 2, 3))


def _bn_train_math(x, scale, bias):
    """Train-mode forward: y in the compute dtype, float32 batch (mean,
    biased var)."""
    xf = x.float()
    mean = xf.mean((0, 2, 3))
    var = xf.square().mean((0, 2, 3)) - mean.square()
    inv = torch.rsqrt(var + BN_EPS) * scale
    return (x * _channels(inv, x.dtype)
            + _channels(bias - mean * inv, x.dtype)), mean, var


class BNTrainFn(torch.autograd.Function):
    """Train-mode BatchNorm with the closed-form backward of the
    reference's _bn_train_cvjp.  Returns (y, mean, var); the moments feed
    only the running statistics and get no gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias):
        y, mean, var = _bn_train_math(x, scale, bias)
        ctx.save_for_backward(x, scale, mean, var)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, var = ctx.saved_tensors
        cd = x.dtype
        inv0 = torch.rsqrt(var + BN_EPS)
        xhat = x * _channels(inv0, cd) + _channels(-mean * inv0, cd)
        sum_dy = dy.float().sum((0, 2, 3))
        sum_dyxh = (dy * xhat).float().sum((0, 2, 3))
        n = float(x.numel() // x.shape[1])
        ginv = scale * inv0
        dx = (dy * _channels(ginv, cd) - _channels(ginv * (sum_dy / n), cd)
              - xhat * _channels(ginv * (sum_dyxh / n), cd))
        return dx, sum_dyxh, sum_dy


def _bn_train(x: torch.Tensor, p: dict, s: dict, row_mask=None):
    """Train-mode BN: (y, new running stats); the running variance is the
    unbiased n/(n-1) form (Torch7 parity, cnn.py:371-383).  row_mask (B,)
    marks the real rows of a padded batch: the moments and the count
    exclude the others, and the backward is plain autograd over the
    weighted moments (cnn.py:384-422)."""
    if row_mask is None:
        y, mean, var = BNTrainFn.apply(x, p["scale"], p["bias"])
        count = float(x.numel() // x.shape[1])
        unbiased = var * (count / max(count - 1.0, 1.0))
    else:
        xf = x.float()
        wgt = row_mask.float()[:, None, None, None]
        count = (wgt.sum() * (x.shape[2] * x.shape[3])).clamp(min=1.0)
        mean = (xf * wgt).sum((0, 2, 3)) / count
        var = (xf.square() * wgt).sum((0, 2, 3)) / count - mean.square()
        inv = torch.rsqrt(var + BN_EPS) * p["scale"]
        y = (x * _channels(inv, x.dtype)
             + _channels(p["bias"] - mean * inv, x.dtype))
        mean, var = mean.detach(), var.detach()
        unbiased = var * (count / (count - 1.0).clamp(min=1.0))
    return y, {"mean": BN_MOMENTUM * s["mean"] + (1.0 - BN_MOMENTUM) * mean,
               "var": BN_MOMENTUM * s["var"] + (1.0 - BN_MOMENTUM) * unbiased}


def _relu_pool(x: torch.Tensor, idx: int, fused: bool) -> torch.Tensor:
    """The ReLU after conv `idx` and the pool after it, if any: through
    ReluPoolFn when `fused` (training on the kernel route with
    pool_bwd.ENABLE) and the shape divides the window, else torch.relu +
    F.max_pool2d."""
    window = POOL_AFTER.get(idx)
    if window is None:
        return torch.relu(x)
    if fused and pool_bwd.supported(x.shape, window):
        return ReluPoolFn.apply(x, window)
    if fused:
        pool_bwd.launches_ragged += 1
    return F.max_pool2d(torch.relu(x), window)


def apply(params: dict, batch_stats: dict, images: torch.Tensor,
          compute_dtype: torch.dtype = torch.float32,
          use_kernel: bool = True, train: bool = False, row_mask=None,
          axis_name=None):
    """images (B, 32, W, 1) float32 in [0, 255] -> features (B, L, 512) in
    the compute dtype; with train=True -> (features, new batch_stats),
    BatchNorm on the batch's moments (only the rows row_mask marks, when
    given).  use_kernel=False runs conv1 as a plain conv and the pools
    under plain autograd.  axis_name (sync-BN) belongs to data-parallel
    training, which is not ported."""
    if axis_name is not None:
        raise NotImplementedError(
            "synchronized BatchNorm belongs to data-parallel training: "
            "ROADMAP queue 1: Parallel")
    cd = compute_dtype
    fused = train and use_kernel and pool_bwd.ENABLE
    x = ((images - 128.0) / 128.0).to(cd)
    new_stats = dict(batch_stats)
    for idx, (name, _i, _o, _kh, _kw, pad, bn) in enumerate(CONV_DEFS):
        if idx == 0 and use_kernel:
            x = Conv1PoolFn.apply(
                x, params[name]["w"], params[name]["b"]).permute(0, 3, 1, 2)
            continue
        if idx == 0:
            x = x.permute(0, 3, 1, 2)
        x = F.conv2d(x, params[name]["w"].to(cd),
                     padding=1 if pad == "SAME" else 0)
        x = BiasAddFn.apply(x, params[name]["b"])
        if bn and train:
            x, new_stats[name + "_bn"] = _bn_train(
                x, params[name + "_bn"], batch_stats[name + "_bn"], row_mask)
        elif bn:
            x = _bn_eval(x, params[name + "_bn"], batch_stats[name + "_bn"])
        x = _relu_pool(x, idx, fused)
    # (B, 512, 1, L) -> (B, L, 512)
    features = x.squeeze(2).transpose(1, 2)
    return (features, new_stats) if train else features


def num_params() -> int:
    return sum(kh * kw * i * o + o + (2 * o if bn else 0)
               for _n, i, o, kh, kw, _p, bn in CONV_DEFS)
