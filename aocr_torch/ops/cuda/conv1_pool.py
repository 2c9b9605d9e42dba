"""conv1 + bias + ReLU + 2x2/2 max-pool in one kernel (csrc/conv1_pool.cu).

Replaces `aocr/ops/pallas/conv1_pool.py::_fwd_kernel` (the forward of
`conv1_relu_pool`).  The pre-pool (B, 32, W, 64) activation is never
written: each output cell reads its 4x4 input patch and keeps the four
pre-pool sums in registers.  The TPU kernel's batch-on-lanes layout is a
Mosaic relayout trick and is not carried over; the kernel writes NHWC,
which is channels_last for conv2.  Odd widths floor, as the reference's
VALID pool does (the TPU kernel took even widths only).

Numerics, as the TPU kernel and the XLA route: the sums accumulate in
float32, round to the compute dtype, add the bias in the compute dtype,
round again, then max and ReLU.  In bfloat16 the kernel computes them as
the TPU kernel does, each cell's 16-tap patch times `w16` on the tensor
cores; in float32 as the first port did, the 9 taps in order
by fused multiply-adds, so its results stay bit for bit.

The kernel runs the card's blocks, each on an equal run of the batch's
pooled cells (`plan`), staging the image rows of its pool rows in shared
memory.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from aocr_torch.ops import cuda
from aocr_torch.ops.cuda.conv1_pool_bwd import run_rows

launches = 0

C1 = 64
# csrc/conv1_pool.cu's constants
WARPS = 8
MIN_RUN = 16 * WARPS  # cells: an m16 tile a warp
STAGE_MAX = 64 * 1024  # a block's staged image rows, bytes
OUT_STAGE = WARPS * 16 * 36 * 4  # bf16: a warp's 16 output cells, bytes
# the blocks an H100 SXM holds at once (132 SMs x 2)
RESIDENT = 264

# launch plans held against the kernel's, by (B, H, W, dtype): (Plan, the
# line logged for it)
plans: dict = {}


class Plan(NamedTuple):
    """How the kernel splits a batch (csrc/conv1_pool.cu `cf_plan`, which
    this mirrors field for field)."""
    blocks: int  # one run of cells each
    run: int  # the most cells a block owns
    rows: int  # the most image rows a block stages
    smem: int  # their bytes, rounded to 16 (bf16: + OUT_STAGE)

    def cells(self, i: int, B: int, H: int, W: int) -> range:
        """The pooled cells (image, row, column order) block i owns."""
        n = B * (H // 2) * (W // 2)
        return range(i * n // self.blocks, (i + 1) * n // self.blocks)


def _rows_bytes(n: int, W: int, esz: int) -> int:
    return (n * esz * ((W + 3) & ~1) + 15) & ~15


def plan(B: int, H: int, W: int, dtype: torch.dtype,
         resident: int = RESIDENT) -> Optional[Plan]:
    """The kernel's launch plan for B images of H x W in `dtype` and the
    blocks the card holds at once: as many blocks as the card holds
    (fewer where runs would drop below MIN_RUN cells; at least one), and
    the fewest more whose staged rows (`run_rows` of (W + 3) & ~1
    elements) fit STAGE_MAX bytes; None where one cell's run does not
    fit."""
    esz = torch.empty((), dtype=dtype).element_size()
    Ho, Wo = H // 2, W // 2
    cells = B * Ho * Wo
    rb = esz * ((W + 3) & ~1)
    if cells < 1 or resident < 1 or run_rows(1, B, Ho, Wo) * rb > STAGE_MAX:
        return None

    def fits(n):
        return run_rows(-(-cells // n), B, Ho, Wo) * rb <= STAGE_MAX

    lo, hi = max(1, min(resident, cells // MIN_RUN)), cells
    if not fits(lo):  # the fewest blocks that fit: fits(hi) holds
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if fits(mid):
                hi = mid
            else:
                lo = mid
        lo = hi
    run = -(-cells // lo)
    rows = run_rows(run, B, Ho, Wo)
    return Plan(lo, run, rows,
                _rows_bytes(rows, W, esz) + (OUT_STAGE if esz == 2 else 0))


def checked_plan(B: int, H: int, W: int, cd: torch.dtype) -> Plan:
    """The launch's plan: ValueError where none fits; on a shape's first
    launch held against the kernel's own, with the blocks the card holds
    at once, and logged (`cuda.held_plan`)."""
    key = (B, H, W, cd)
    if key not in plans and plan(B, H, W, cd, 1) is None:
        raise ValueError(f"conv1_relu_pool: no kernel plan fits B={B}, "
                         f"H={H}, W={W}")
    return cuda.held_plan(
        "conv1_pool", key,
        lambda out: cuda.library().aocr_conv1_pool_plan(
            B, H, W, int(cd == torch.float32), out), 5,
        lambda active: plan(B, H, W, cd, active),
        lambda p, active: (
            f"conv1_pool plan B={B} H={H} W={W} {cd}: {p.blocks} blocks "
            f"({active} at once) of {p.run} cells or one fewer, at most "
            f"{p.rows} image rows staged ({p.smem} B of shared memory)"),
        plans)


# the pool positions in row-major window order (aocr's _POSITIONS)
POSITIONS = ((0, 0), (0, 1), (1, 0), (1, 1))


def w16(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """w (64, 1, 3, 3) -> W16 (16, 256) in dtype: column p*64 + c holds
    the weights the pre-pool pixel at pool position p applies to the 16
    taps of its cell's 4x4 patch (w[c, 0, a - pi, b - pj] at tap 4a + b,
    zero off the 3x3 support), as aocr's `_w16`.  The bf16 kernel's B
    fragments are these columns."""
    k = w[:, 0].permute(1, 2, 0)  # (3, 3, 64)
    cols = [F.pad(k, (0, 0, pj, 1 - pj, pi, 1 - pi)).reshape(16, C1)
            for pi, pj in POSITIONS]
    return torch.cat(cols, dim=1).to(dtype)


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
    x's dtype.  Runs the custom op aocr_torch::conv1_relu_pool (`op`):
    CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv1_relu_pool: unsupported device {x.device}")
    return op(x, w, b)


@torch.library.custom_op("aocr_torch::conv1_relu_pool", mutates_args=())
def op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """conv1_relu_pool as a custom op, so that torch.export traces it as
    one node (its fake version below states the output from the input
    shapes); the plan is picked here, from the real batch."""
    global launches
    if x.device.type == "cpu":
        return conv1_relu_pool_plain(x, w, b)
    B, H, W, C = x.shape
    cd = x.dtype
    if C != 1 or tuple(w.shape) != (C1, 1, 3, 3) or H < 2 or W < 2:
        raise ValueError(f"conv1_relu_pool: x {tuple(x.shape)} / w "
                         f"{tuple(w.shape)} is not the conv1 geometry")
    dev = x.device
    w = w.contiguous()
    cuda.check(x, "x", (B, H, W, 1), cd, dev)
    cuda.check(w, "w", (C1, 1, 3, 3), torch.float32, dev)
    cuda.check(b, "b", (C1,), torch.float32, dev)
    p = checked_plan(B, H, W, cd)
    out = torch.empty((B, H // 2, W // 2, C1), dtype=cd, device=dev)
    cuda.launch("conv1_pool", cd, dev, x.data_ptr(), w.data_ptr(),
                b.data_ptr(), out.data_ptr(), B, H, W, p.blocks)
    launches += 1
    return out


@op.register_fake
def _(x, w, b):
    B, H, W, _ = x.shape
    return x.new_empty((B, H // 2, W // 2, C1))
