"""Backward of conv1 + bias + ReLU + 2x2/2 max-pool (csrc/conv1_pool_bwd.cu).

Replaces `aocr/ops/pallas/conv1_pool.py::_bwd_kernel`: the weight and
bias gradients of `conv1_relu_pool` from the pooled cotangent dy, never
materializing the pre-pool activation.  Each cell's four pre-pool scores
are recomputed as the forward rounds them; dy goes to the FIRST position
attaining the window max in row-major window order (select_and_scatter's
tie rule), and only where that max is positive (the ReLU); dW and db
accumulate in float32.  The image cotangent is `conv1_pool_dx`; both
kernels route through `csrc/conv1_route.cuh`, and both plain versions
through `routed` here.

The 9-tap score sum runs in tap order with separately rounded products
and sums on both sides, so the kernel and the plain version route every
cotangent, ties included, identically.

The kernel runs as many blocks as the card holds at once, each owning an
equal run of the batch's pooled cells (`plan`), and adds the blocks' (64,
10) partial sums in the same launch, in a fixed tree of FAN partials a
node (`levels`), so two calls on one card give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from aocr_torch.ops import cuda

launches = 0

C1 = 64
# csrc/conv1_pool_bwd.cu's constants
FAN = 16  # partials a node of the tree adds
STAGE_MAX = 96 * 1024  # a block's staged image rows, bytes

# launch plans held against the kernel's, by (B, H, W, dtype): (Plan, the
# line logged for it)
plans: dict = {}
# the tree's buffers by (device, stream): (partials, counters); the
# counters are zero between launches (each launch's last arrivals reset
# them), and launches on one stream never overlap
_tree: dict = {}


class Plan(NamedTuple):
    """How the kernel splits a batch (csrc/conv1_pool_bwd.cu `cb_plan`,
    which this mirrors field for field)."""
    blocks: int  # one run of cells each
    rows: int  # the most image rows a block stages
    smem: int  # their bytes

    def cells(self, i: int, B: int, H: int, W: int) -> range:
        """The pooled cells (image, row, column order) block i owns."""
        n = B * (H // 2) * (W // 2)
        return range(i * n // self.blocks, (i + 1) * n // self.blocks)


def base(g: int, g0: int, Ho: int) -> int:
    """The first staged row of pool row g (image g // Ho) in a block whose
    first pool row is g0 (csrc `cb_base`): consecutive pool rows of an
    image share 2 of their 4 rows, and each image the block touches adds
    2."""
    return 2 * (g - g0) + 2 * (g // Ho - g0 // Ho)


def run_rows(m: int, B: int, Ho: int, Wo: int) -> int:
    """The most rows a run of m pooled cells stages (csrc `cb_rows`): it
    touches at most r = (m - 1) // Wo + 2 pool rows and (r - 1) // Ho + 2
    images."""
    r = min((m - 1) // Wo + 2, B * Ho)
    return 2 * (r + min((r - 1) // Ho + 2, B))


def plan(B: int, H: int, W: int, resident: int,
         stage_max: int = STAGE_MAX) -> Optional[Plan]:
    """The kernel's launch plan (csrc/conv1_route.cuh `cb_plan`, which
    conv1_pool_dx shares with its own stage_max) for B images of H x W and
    the blocks the card holds at once (`resident`: 264 on an H100 SXM, 2 a
    SM): at least `resident` blocks (fewer where there are fewer cells),
    and the fewest more whose staged rows (`run_rows` of (W + 3) & ~1
    floats) fit stage_max bytes; None where one cell's run does not fit."""
    Ho, Wo = H // 2, W // 2
    cells = B * Ho * Wo
    rb = 4 * ((W + 3) & ~1)
    if cells < 1 or resident < 1 or run_rows(1, B, Ho, Wo) * rb > stage_max:
        return None

    def fits(n):
        return run_rows(-(-cells // n), B, Ho, Wo) * rb <= stage_max

    lo, hi = min(resident, cells), cells
    if not fits(lo):  # the fewest blocks that fit: fits(hi) holds
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if fits(mid):
                hi = mid
            else:
                lo = mid
        lo = hi
    rows = run_rows(-(-cells // lo), B, Ho, Wo)
    return Plan(lo, rows, rows * rb)


def plan_line(kernel: str, p: Plan, active: int, B: int, H: int, W: int,
              cd: torch.dtype) -> str:
    """A plan of `kernel` (this one, or conv1_pool_dx: `cb_plan`) in
    words, as the logs print it."""
    return (f"{kernel} plan B={B} H={H} W={W} {cd}: {p.blocks} blocks "
            f"({active} at once) of "
            f"{-(-B * (H // 2) * (W // 2) // p.blocks)} cells or one "
            f"fewer, at most {p.rows} image rows staged ({p.smem} B)")


def checked_plan(B: int, H: int, W: int, cd: torch.dtype) -> Plan:
    """The launch's plan: ValueError where none fits; on a shape's first
    launch held against the kernel's own, with the blocks the card holds
    at once, and logged (`cuda.held_plan`)."""
    if plan(B, H, W, 1) is None:
        raise ValueError(f"conv1_pool_bwd: no kernel plan fits B={B}, "
                         f"H={H}, W={W}")
    return cuda.held_plan(
        "conv1_pool_bwd", (B, H, W, cd),
        lambda out: cuda.library().aocr_conv1_pool_bwd_plan(
            B, H, W, int(cd == torch.float32), out), 4,
        lambda active: plan(B, H, W, active),
        lambda p, active: plan_line("conv1_pool_bwd", p, active, B, H, W,
                                    cd), plans)


def _tree_buffers(dev: torch.device, blocks: int):
    """The tree's partials (every level but the output, 640 floats an
    entry) and its counters (one a group) for `blocks` blocks on the
    current stream of `dev`, grown where too small."""
    lv = levels(blocks)
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    part, count = _tree.get(key, (None, None))
    if part is None or part.numel() < max(sum(lv[:-1]), 1) * C1 * 10 \
            or count.numel() < max(sum(lv[1:]), 1):
        part = torch.empty((max(sum(lv[:-1]), 1) * C1 * 10,),
                           dtype=torch.float32, device=dev)
        count = torch.zeros((max(sum(lv[1:]), 1),), dtype=torch.int32,
                            device=dev)
        _tree[key] = (part, count)
    return part, count


def levels(n: int) -> list:
    """The partials at each level of the kernel's sum over n blocks: n,
    then ceil(n / FAN) group sums, ... down to 1, the output.  Block i's
    partial is level 0's entry i; group g of a level adds its entries g
    FAN .. g FAN + FAN - 1 in order into the next level's entry g."""
    out = [n]
    while out[-1] > 1:
        out.append(-(-out[-1] // FAN))
    return out


def _scores(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """Pre-pool scores (B, 64, H, W) as float32 images of compute-dtype
    values: the 9-tap sum in tap order, rounded, + the rounded bias,
    rounded."""
    cd = x.dtype
    B, H, W, _ = x.shape
    xp = F.pad(x[..., 0].float(), (1, 1, 1, 1))
    w9 = w.reshape(C1, 9).to(cd).float()
    s = torch.zeros((B, C1, H, W), dtype=torch.float32, device=x.device)
    for k in range(9):
        ky, kx = divmod(k, 3)
        s = s + xp[:, None, ky:ky + H, kx:kx + W] * w9[:, k, None, None]
    return (s.to(cd) + b.to(cd)[:, None, None]).float()


def routed(x, w, b, dy):
    """The pooled cotangent routed to the window positions: (dz (B, 64,
    Ho, Wo, 4) float32, positions in row-major window order, and g (B, 64,
    Ho, Wo, 1) float32, dy where the window max is positive)."""
    B, H, W, _ = x.shape
    Ho, Wo = H // 2, W // 2
    z = _scores(x, w, b)[:, :, :2 * Ho, :2 * Wo]
    z = z.reshape(B, C1, Ho, 2, Wo, 2).permute(0, 1, 2, 4, 3, 5)
    z = z.reshape(B, C1, Ho, Wo, 4)
    m = z.amax(-1, keepdim=True)
    eq = z == m
    first = eq & (eq.cumsum(-1) == 1)
    g = torch.where(m > 0, dy.permute(0, 3, 1, 2)[..., None].float(), 0.0)
    return torch.where(first, g, 0.0), g


def conv1_relu_pool_bwd_plain(x, w, b, dy):
    """Plain PyTorch version; same arguments and results as
    conv1_relu_pool_bwd."""
    B, H, W, _ = x.shape
    Ho, Wo = H // 2, W // 2
    dz, g = routed(x, w, b, dy)
    db = g.sum((0, 2, 3, 4))
    dz = dz.reshape(B, C1, Ho, Wo, 2, 2).permute(0, 1, 2, 4, 3, 5)
    dz = F.pad(dz.reshape(B, C1, 2 * Ho, 2 * Wo),
               (0, W - 2 * Wo, 0, H - 2 * Ho))
    xp = F.pad(x[..., 0].float(), (1, 1, 1, 1))
    dw = torch.stack([
        (dz * xp[:, None, ky:ky + H, kx:kx + W]).sum((0, 2, 3))
        for ky in range(3) for kx in range(3)], dim=1)
    return dw.reshape(C1, 1, 3, 3), db


def conv1_relu_pool_bwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        dy: torch.Tensor):
    """Gradients of conv1_relu_pool(x, w, b) for the cotangent dy.

    x (B, H, W, 1) in the compute dtype; w (64, 1, 3, 3) and b (64,)
    float32; dy (B, H//2, W//2, 64) in x's dtype, any strides (a
    channels_last conv2 backward hands it over contiguous).  Returns
    (dw (64, 1, 3, 3), db (64,)), float32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    global launches
    if x.device.type == "cpu":
        return conv1_relu_pool_bwd_plain(x, w, b, dy)
    if x.device.type != "cuda":
        raise ValueError(f"conv1_relu_pool_bwd: unsupported device "
                         f"{x.device}")
    B, H, W, C = x.shape
    cd, dev = x.dtype, x.device
    if C != 1 or tuple(w.shape) != (C1, 1, 3, 3) or H < 2 or W < 2:
        raise ValueError(f"conv1_relu_pool_bwd: x {tuple(x.shape)} / w "
                         f"{tuple(w.shape)} is not the conv1 geometry")
    dy = dy.contiguous()
    cuda.check(x, "x", (B, H, W, 1), cd, dev)
    cuda.check(b, "b", (C1,), torch.float32, dev)
    cuda.check(dy, "dy", (B, H // 2, W // 2, C1), cd, dev)
    if w.device != dev or w.dtype != torch.float32:
        raise ValueError("conv1_relu_pool_bwd: w must be float32 on x's "
                         "device")
    cuda.check_aligned(dy=dy)
    p = checked_plan(B, H, W, cd)
    part, count = _tree_buffers(dev, p.blocks)
    dw = torch.empty((C1, 1, 3, 3), dtype=torch.float32, device=dev)
    db = torch.empty((C1,), dtype=torch.float32, device=dev)
    cuda.launch("conv1_pool_bwd", cd, dev, x.data_ptr(),
                w.reshape(C1, 9).contiguous().data_ptr(), b.data_ptr(),
                dy.data_ptr(), part.data_ptr(), count.data_ptr(),
                dw.data_ptr(), db.data_ptr(), B, H, W, p.blocks)
    launches += 1
    return dw, db
