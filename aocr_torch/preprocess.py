"""Device-side image preprocessing: luminance, bilinear resize, layout
(counterpart of aocr/preprocess.py).

The host decodes the bytes (PIL, or np.load for `.npy`) and ships the
raw pixel batch; the ITU-R 601 luminance and the half-pixel-centre
bilinear resize to (32, W) run here as a few PyTorch ops over the whole
batch on the model's device.  The conventions are aocr_torch.data's host
path's, so host- and device-preprocessed batches are interchangeable
(tests/test_torch_port_preprocess.py).

Each function takes numpy arrays or tensors; a tensor stays on its
device, a numpy array goes to `device` (default: the CUDA device, as
every entry point of the port).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aocr_torch import devices

LUMA = (0.299, 0.587, 0.114)


def _on_device(x, device) -> torch.Tensor:
    """x as a tensor: a tensor on `device` if named, else where it is; a
    numpy array on `device` (None: the CUDA device).  Copied as it is
    (uint8 stays uint8), so the host ships the fewest bytes."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(devices.resolve(device))
    return torch.as_tensor(x).to(devices.resolve(device))


def _luminance(x: torch.Tensor) -> torch.Tensor:
    """(..., C>=3) RGB or (..., 1) gray float -> (...) luminance."""
    if x.shape[-1] >= 3:
        return (LUMA[0] * x[..., 0] + LUMA[1] * x[..., 1]
                + LUMA[2] * x[..., 2])
    return x[..., 0]


def preprocess_batch(raw, out_h: int = 32, out_w: int = 100,
                     device=None) -> torch.Tensor:
    """(B, H, W, C) uint8/float RGB (or (B, H, W) / C=1 gray) -> (B, out_h,
    out_w, 1) float32 luminance in [0, 255], resized with bilinear
    half-pixel centres and no antialias prefilter (jax.image.resize's
    "bilinear" with antialias=False)."""
    x = _on_device(raw, device).float()
    if x.ndim == 3:
        x = x[..., None]
    y = F.interpolate(_luminance(x)[:, None], size=(out_h, out_w),
                      mode="bilinear", align_corners=False, antialias=False)
    return y[:, 0, :, :, None]


def _centres(n: int, size: torch.Tensor) -> torch.Tensor:
    """(i + 0.5) * (size / n) - 0.5 for i < n, (B, 1) sizes -> (B, n),
    rounded as the JAX package's compiled program rounds it: size / n as
    size times n's float32 reciprocal, then the product and the offset
    rounded once (a fused multiply-add, exact in float64).  A sample
    coordinate off by one float32 ulp moves a pixel by up to ~2e-3 on
    [0, 255]; these agree with aocr.preprocess within 1e-4."""
    recip = torch.tensor(1.0 / n, dtype=torch.float32, device=size.device)
    i = torch.arange(n, dtype=torch.float64, device=size.device) + 0.5
    return (i * (size * recip).double() - 0.5).float()


def preprocess_varsize(raw, sizes, out_h: int = 32, out_w: int = 100,
                       device=None) -> torch.Tensor:
    """Mixed-size batch preprocessing on the device.

    raw:   (B, Hp, Wp, C) uint8/float images padded (bottom/right) to a
           common buffer shape; C in {1, 3, 4}
    sizes: (B, 2) int true (h, w) of each image
    ->     (B, out_h, out_w, 1) float32 luminance in [0, 255]

    The math of aocr.preprocess._resize_one for every row at once: half-
    pixel centres over each row's true (h, w), sample indices clipped
    inside it, so the padding is never read; one gather over the batch.
    """
    x = _on_device(raw, device).float()
    if x.ndim == 3:
        x = x[..., None]
    lum = _luminance(x)  # (B, Hp, Wp)
    B, _hp, wp = lum.shape
    s = _on_device(sizes, lum.device).long()
    h, w = s[:, :1], s[:, 1:]  # (B, 1)
    hf, wf = h.float(), w.float()
    ys = _centres(out_h, hf)  # (B, out_h)
    xs = _centres(out_w, wf)  # (B, out_w)
    y0 = torch.minimum(ys.floor().clamp_min(0), hf - 1).long()
    x0 = torch.minimum(xs.floor().clamp_min(0), wf - 1).long()
    y1 = torch.minimum(y0 + 1, h - 1)
    x1 = torch.minimum(x0 + 1, w - 1)
    wy = (ys - y0).clamp(0.0, 1.0)[:, :, None]  # (B, out_h, 1)
    wx = (xs - x0).clamp(0.0, 1.0)[:, None, :]  # (B, 1, out_w)

    def rows(y):  # (B, out_h, Wp)
        return lum.gather(1, y[:, :, None].expand(B, out_h, wp))

    def cols(r, xi):  # (B, out_h, out_w)
        return r.gather(2, xi[:, None, :].expand(B, out_h, out_w))

    r0, r1 = rows(y0), rows(y1)
    top = cols(r0, x0) * (1 - wx) + cols(r0, x1) * wx
    bot = cols(r1, x0) * (1 - wx) + cols(r1, x1) * wx
    return (top * (1 - wy) + bot * wy)[..., None]


def preprocess_and_normalize(raw, out_h: int = 32, out_w: int = 100,
                             device=None) -> torch.Tensor:
    """preprocess_batch and the CNN's (x - 128) / 128 normalization."""
    return (preprocess_batch(raw, out_h, out_w, device) - 128.0) / 128.0
