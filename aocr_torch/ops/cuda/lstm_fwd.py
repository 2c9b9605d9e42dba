"""One encoder direction's whole recurrence in one kernel (csrc/lstm_fwd.cu).

Replaces `aocr/ops/pallas/lstm_fwd.py::lstm_fwd_scan` with collect=False:
the recurrence over the hoisted input projection, (c, h) carried in
float32, the reverse direction by walking L-1..0 and writing hs at the
original time index.  Each block owns a batch tile and all H columns and
loops over L inside, so no step needs a grid-wide sync; Wh (2 MiB in bf16
at H=512) is re-read from L2 every step.

Numerics as `aocr/ops/lstm.py::_scan_from_proj`: gates = x_proj[t] (upcast)
+ h.astype(cd) @ Wh with float32 accumulation, gate math in float32.
"""

from __future__ import annotations

import torch

from aocr_torch.ops import cuda
from aocr_torch.ops import lstm
from aocr_torch.ops.mm import matmul

launches = 0


def lstm_fwd_scan_plain(wh, x_proj, c0, h0, reverse: bool):
    """Plain PyTorch version; same arguments and results as
    lstm_fwd_scan."""
    L, B, G = x_proj.shape
    cd = wh.dtype
    c, h = c0.float(), h0.float()
    hs = torch.empty((L, B, G // 4), dtype=cd, device=x_proj.device)
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        gates = x_proj[t].float() + matmul(h.to(cd), wh)
        c, h = lstm.gate_math(gates, c)
        hs[t] = h.to(hs.dtype)
    return hs, (c, h)


def lstm_fwd_scan(wh: torch.Tensor, x_proj: torch.Tensor, c0: torch.Tensor,
                  h0: torch.Tensor, reverse: bool):
    """wh (H, 4H) compute dtype; x_proj (L, B, 4H) float32 or compute
    dtype; c0, h0 (B, H) float32.  Returns (hs (L, B, H) scan-major in the
    compute dtype, (c_f, h_f) float32).  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    global launches
    if wh.device.type == "cpu":
        return lstm_fwd_scan_plain(wh, x_proj, c0, h0, reverse)
    if wh.device.type != "cuda":
        raise ValueError(f"lstm_fwd_scan: unsupported device {wh.device}")
    L, B, G = x_proj.shape
    H = G // 4
    cd, dev = wh.dtype, wh.device
    if G != 4 * H or H % 2 or L < 1 or B < 1:
        raise ValueError(f"lstm_fwd_scan: bad x_proj shape {x_proj.shape}")
    if x_proj.dtype not in (torch.float32, cd):
        raise ValueError(f"lstm_fwd_scan: x_proj dtype {x_proj.dtype}")
    cuda.check(wh, "wh", (H, G), cd, dev)
    cuda.check(x_proj, "x_proj", (L, B, G), x_proj.dtype, dev)
    cuda.check(c0, "c0", (B, H), torch.float32, dev)
    cuda.check(h0, "h0", (B, H), torch.float32, dev)
    hs = torch.empty((L, B, H), dtype=cd, device=dev)
    cf = torch.empty((B, H), dtype=torch.float32, device=dev)
    hf = torch.empty((B, H), dtype=torch.float32, device=dev)
    cuda.launch("lstm_fwd", cd, dev, wh.data_ptr(), x_proj.data_ptr(),
                int(x_proj.dtype == torch.float32), c0.data_ptr(),
                h0.data_ptr(), hs.data_ptr(), cf.data_ptr(), hf.data_ptr(),
                L, B, H, int(reverse))
    launches += 1
    return hs, (cf, hf)
