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
conv1's is the `conv1_pool_bwd` kernel (`Conv1PoolFn`); the other conv
biases reduce their gradient in float32 (`BiasAddFn`, cnn.py:273-288);
train-mode BatchNorm normalizes with the batch's biased variance, stores
the unbiased n/(n-1) one in the running statistics, and runs the
closed-form backward with both channel sums in float32 (`BNTrainFn`,
cnn.py:303-383).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from aocr_torch.ops.cuda import conv1_pool, conv1_pool_bwd

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
    """conv1 + bias + ReLU + 2x2 pool: the `conv1_pool` kernel forward,
    the `conv1_pool_bwd` kernel backward (dW, db).  x (B, H, W, 1) in the
    compute dtype; returns (B, H//2, W//2, 64) NHWC."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return conv1_pool.conv1_relu_pool(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        if ctx.needs_input_grad[0]:
            raise NotImplementedError(
                "the image cotangent of conv1 (the TPU's _dx_kernel) is not "
                "ported: ROADMAP queue 2 item 6")
        dw, db = conv1_pool_bwd.conv1_relu_pool_bwd(x, w, b, dy)
        return None, dw, db


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


def _bn_train(x: torch.Tensor, p: dict, s: dict):
    """Train-mode BN: (y, new running stats); the running variance is the
    unbiased n/(n-1) form (Torch7 parity, cnn.py:371-383)."""
    y, mean, var = BNTrainFn.apply(x, p["scale"], p["bias"])
    count = float(x.numel() // x.shape[1])
    unbiased = var * (count / max(count - 1.0, 1.0))
    return y, {"mean": BN_MOMENTUM * s["mean"] + (1.0 - BN_MOMENTUM) * mean,
               "var": BN_MOMENTUM * s["var"] + (1.0 - BN_MOMENTUM) * unbiased}


def apply(params: dict, batch_stats: dict, images: torch.Tensor,
          compute_dtype: torch.dtype = torch.float32,
          use_kernel: bool = True, train: bool = False, row_mask=None,
          axis_name=None):
    """images (B, 32, W, 1) float32 in [0, 255] -> features (B, L, 512) in
    the compute dtype; with train=True -> (features, new batch_stats),
    BatchNorm on the batch's moments.  use_kernel=False runs conv1 as a
    plain conv.  row_mask and axis_name (masked moments, sync-BN) belong
    to data-parallel training, which is not ported."""
    if row_mask is not None or axis_name is not None:
        raise NotImplementedError(
            "masked and synchronized BatchNorm belong to data-parallel "
            "training: ROADMAP queue 1 item 11")
    cd = compute_dtype
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
                x, params[name + "_bn"], batch_stats[name + "_bn"])
        elif bn:
            x = _bn_eval(x, params[name + "_bn"], batch_stats[name + "_bn"])
        x = torch.relu(x)
        if idx in POOL_AFTER:
            x = F.max_pool2d(x, POOL_AFTER[idx])
    # (B, 512, 1, L) -> (B, L, 512)
    features = x.squeeze(2).transpose(1, 2)
    return (features, new_stats) if train else features


def num_params() -> int:
    return sum(kh * kw * i * o + o + (2 * o if bn else 0)
               for _n, i, o, kh, kw, _p, bn in CONV_DEFS)
