"""Training-time image augmentation on the device (counterpart of
aocr/augment.py): random affine jitter (rotation, shear, scale, shift),
brightness and contrast jitter, and Gaussian noise, applied inside the
train step (`-augment`) on (B, 32, W, 1) images in [0, 255].

The math is aocr.augment._augment_one's (`augment_from_draws`); only the
draws differ.  JAX's threefry stream cannot be reproduced here, so each
row's seven uniforms and its (H, W) normals come from Philox-4x32-10
(Salmon et al., SC'11), counter-based and computed with integer tensor
ops on the device in one vectorized pass:

- key: the step key, two 32-bit words (`step_key(seed, global_step)` in
  the trainer, so a resumed run replays the same augmentations);
- counter: (element index, GLOBAL row index, stream, AUG_TAG), stream 0
  for the geometry and photometric uniforms, 1 for the noise (Box-Muller
  on pairs of uniforms).

So a row's draws depend only on (step key, global row): a shard of rows
[k, B) augmented with row_offset=k gives the whole batch's rows k..B-1,
the determinism contract of aocr/augment.py.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

# strength-1.0 magnitudes (all scale linearly with -augment_strength)
_ROT_MAX = 0.05      # radians, ~3 degrees
_SHEAR_MAX = 0.15    # horizontal shear per vertical pixel
_LOG_SCALE_MAX = 0.08
_SHIFT_X = 2.0       # pixels
_SHIFT_Y = 1.5
_BRIGHT_MAX = 16.0   # additive, on [0, 255]
_CONTRAST_MAX = 0.15
_NOISE_STD = 8.0

_BACKGROUND = 255.0

# the fourth counter word: augmentation's stream, apart from any other
# use of the step key (aocr/train_step.py's _AUG_TAG)
AUG_TAG = 0x6175

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_ROUNDS = 10


def step_key(seed: int, step: int) -> Tuple[int, int]:
    """The augmentation key of a train step: (seed, global step) as two
    32-bit words."""
    return int(seed) & _M32, int(step) & _M32


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for a 32-bit constant m and int64 x
    holding 32-bit words, without overflowing int64: x times each 16-bit
    half of m is under 2^48."""
    a = x * (m & 0xFFFF)
    b = x * (m >> 16)
    t = a + ((b & 0xFFFF) << 16)
    return (t >> 32) + (b >> 16), t & _M32


def philox4x32(counter: Sequence[torch.Tensor], key: Tuple[int, int]):
    """Philox-4x32-10 of the four counter words (int64 tensors of 32-bit
    values or ints, broadcast together; at least one a tensor) under key
    (k0, k1): four int64 tensors of 32-bit words."""
    dev = next(c.device for c in counter if isinstance(c, torch.Tensor))
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.int64, device=dev)
          for c in counter))
    k0, k1 = key
    for _ in range(_ROUNDS):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _M32
        k1 = (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def _unit(x: torch.Tensor) -> torch.Tensor:
    """32-bit words -> float32 in [0, 1): their top 24 bits."""
    return (x >> 8).float() * (1.0 / (1 << 24))


def draws(key, rows: torch.Tensor, h: int, w: int):
    """(u (B, 7) uniform in [-1, 1), noise (B, h, w) standard normal) for
    the global row indices `rows` (B,) under the step key."""
    key = (int(key[0]) & _M32, int(key[1]) & _M32)
    dev = rows.device
    r = rows.to(torch.int64)[:, None]  # (B, 1)
    # stream 0: two calls a row, the first seven of their eight words
    idx = torch.arange(2, dtype=torch.int64, device=dev)[None, :]
    words = philox4x32((idx, r, 0, AUG_TAG), key)
    u = torch.stack(words, -1).reshape(len(rows), 8)[:, :7]
    u = _unit(u) * 2.0 - 1.0
    # stream 1: four normals a call, Box-Muller on the two pairs
    calls = (h * w + 3) // 4
    idx = torch.arange(calls, dtype=torch.int64, device=dev)[None, :]
    x0, x1, x2, x3 = philox4x32((idx, r, 1, AUG_TAG), key)
    normals = []
    for a, b in ((x0, x1), (x2, x3)):
        radius = torch.sqrt(-2.0 * torch.log(_unit(a) + 1.0 / (1 << 24)))
        theta = (2.0 * math.pi) * _unit(b)
        normals += [radius * torch.cos(theta), radius * torch.sin(theta)]
    noise = torch.stack(normals, -1).reshape(len(rows), 4 * calls)
    return u, noise[:, :h * w].reshape(len(rows), h, w)


def augment_from_draws(u: torch.Tensor, noise: torch.Tensor,
                       img: torch.Tensor, strength: float) -> torch.Tensor:
    """aocr.augment._augment_one's math for a batch: u (B, 7), noise
    (B, H, W), img (B, H, W, 1) float32 in [0, 255] -> (B, H, W, 1)."""
    B, h, w = img.shape[0], img.shape[1], img.shape[2]
    col = lambda v: v[:, None, None]  # noqa: E731  (B,) -> (B, 1, 1)
    rot = col(u[:, 0] * _ROT_MAX * strength)
    shear = col(u[:, 1] * _SHEAR_MAX * strength)
    scale = col(torch.exp(u[:, 2] * _LOG_SCALE_MAX * strength))
    dx = col(u[:, 3] * _SHIFT_X * strength)
    dy = col(u[:, 4] * _SHIFT_Y * strength)
    bright = col(u[:, 5] * _BRIGHT_MAX * strength)
    contrast = col(1.0 + u[:, 6] * _CONTRAST_MAX * strength)

    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yo = (torch.arange(h, dtype=torch.float32, device=img.device)
          - cy)[None, :, None]  # (1, h, 1)
    xo = (torch.arange(w, dtype=torch.float32, device=img.device)
          - cx)[None, None, :]  # (1, 1, w)
    cos, sin = torch.cos(rot), torch.sin(rot)
    # output pixel -> source coordinate (inverse warp); shear adds a
    # row-dependent horizontal offset, matching tests/synth.distort
    src_x = scale * (cos * xo - sin * yo) + shear * yo + cx + dx
    src_y = scale * (sin * xo + cos * yo) + cy + dy
    warped = _bilinear_constant(img[..., 0], src_y, src_x, _BACKGROUND)
    out = (warped - 127.5) * contrast + 127.5 + bright
    out = out + noise * (_NOISE_STD * strength)
    return out.clamp(0.0, 255.0)[..., None]


def _bilinear_constant(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                       cval: float) -> torch.Tensor:
    """jax.scipy.ndimage.map_coordinates(order=1, mode="constant") of each
    (H, W) plane of img (B, H, W) at (ys, xs) (B, H, W): each of the four
    neighbours outside the plane reads cval (not only points wholly
    outside), and the terms are summed in its order."""
    B, h, w = img.shape
    flat = img.reshape(B, h * w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (1.0 - (ys - y0), ys - y0)
    wx = (1.0 - (xs - x0), xs - x0)
    iy0, ix0 = y0.long(), x0.long()
    out = None
    for dy_ in (0, 1):
        iy = iy0 + dy_
        vy = (iy >= 0) & (iy < h)
        for dx_ in (0, 1):
            ix = ix0 + dx_
            valid = vy & (ix >= 0) & (ix < w)
            at = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(B, -1)
            v = flat.gather(1, at).reshape(B, h, w)
            term = (wy[dy_] * wx[dx_]) * torch.where(
                valid, v, torch.full_like(v, cval))
            out = term if out is None else out + term
    return out


def augment_batch(key, images: torch.Tensor, strength: float = 1.0,
                  row_offset: int = 0) -> torch.Tensor:
    """Augment a (B, H, W, 1) [0, 255] batch under the step key (two
    32-bit words).  `row_offset` is the batch's first GLOBAL row index,
    which keys each row's draws (the module docstring's contract)."""
    images = images.float()
    B, h, w = images.shape[0], images.shape[1], images.shape[2]
    rows = row_offset + torch.arange(B, device=images.device)
    u, noise = draws(key, rows, h, w)
    return augment_from_draws(u, noise, images, float(strength))
