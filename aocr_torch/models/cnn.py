"""CNN feature extractor, eval mode (counterpart of aocr/models/cnn.py).

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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from aocr_torch.ops.cuda import conv1_pool

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


def apply(params: dict, batch_stats: dict, images: torch.Tensor,
          compute_dtype: torch.dtype = torch.float32,
          use_kernel: bool = True) -> torch.Tensor:
    """images (B, 32, W, 1) float32 in [0, 255] -> features (B, L, 512) in
    the compute dtype.  use_kernel=False runs conv1 as a plain conv."""
    cd = compute_dtype
    x = ((images - 128.0) / 128.0).to(cd)
    for idx, (name, _i, _o, _kh, _kw, pad, bn) in enumerate(CONV_DEFS):
        if idx == 0 and use_kernel:
            x = conv1_pool.conv1_relu_pool(
                x, params[name]["w"], params[name]["b"]).permute(0, 3, 1, 2)
            continue
        if idx == 0:
            x = x.permute(0, 3, 1, 2)
        x = F.conv2d(x, params[name]["w"].to(cd),
                     padding=1 if pad == "SAME" else 0)
        x = x + params[name]["b"].to(cd)[:, None, None]
        if bn:
            x = _bn_eval(x, params[name + "_bn"], batch_stats[name + "_bn"])
        x = torch.relu(x)
        if idx in POOL_AFTER:
            x = F.max_pool2d(x, POOL_AFTER[idx])
    # (B, 512, 1, L) -> (B, L, 512)
    return x.squeeze(2).transpose(1, 2)


def num_params() -> int:
    return sum(kh * kw * i * o + o + (2 * o if bn else 0)
               for _n, i, o, kh, kw, _p, bn in CONV_DEFS)
