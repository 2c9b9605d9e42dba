"""One encoder direction's whole recurrence in one kernel (csrc/lstm_fwd.cu).

Replaces `aocr/ops/pallas/lstm_fwd.py::lstm_fwd_scan` in both of its
modes: the recurrence over the hoisted input projection, (c, h) carried
in float32, the reverse direction by walking L-1..0 and writing hs at the
original time index; with collect=True (training) it also writes the
residual stacks the backward kernel reads, the gate activations ifog
(L, B, 4H) and the cell states cs (L, B, H), rounded to the compute
dtype.

The kernel is a persistent RNN on thread-block clusters (`plan` below):
a cluster of up to 16 SMs owns a tile of batch rows for all L steps, each
SM owns H/cs hidden units and keeps its slice of Wh in shared memory for
the whole scan (the rows that do not fit stream from L2), multiplies on
the tensor cores in bf16 (CUDA cores in float32), and stores its slice of
h to hs; after one cluster barrier a step, each SM reads the tile's whole
h back from L2 (distributed shared memory was measured slower on an
H100).  What bounds it is no longer re-reading Wh from L2 (each block of
the old design read all of it every step) but a step's chain of
latencies: in bf16 on an H100 at 700 W, a step of B=512 (bt=48) takes
6,704 product, 4,719 gate-math, 1,351 barrier and 3,087 read-back cycles,
and one of B=1 (bt=16) 2,608 / 2,337 / 1,350 / 691
(`tools/lstm_fwd_phases_torch.py`); in float32 the FMA loop and the part
of the slice streamed from L2 dominate.

Numerics as `aocr/ops/lstm.py::_scan_from_proj` / `_collect_from_proj`:
gates = x_proj[t] (upcast) + h.astype(cd) @ Wh with float32 accumulation,
gate math in float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from aocr_torch.ops import cuda
from aocr_torch.ops import lstm
from aocr_torch.ops.mm import matmul

launches = 0
# launches with collect=True (training), a part of `launches`
launches_collect = 0

# csrc/lstm_fwd.cu's constants
THREADS = 256
SMEM_MAX = 232448  # the H100's shared memory a block, bytes
MAX_CLUSTER = 16  # a non-portable cluster size on the H100
MMA_TILES = 2  # (16-row, 8-unit) mma tiles a warp, bf16
MMA_TILES_WIDE = 3  # the same past 128 units a block
FMA_ROWS = 4  # batch rows a thread, float32
BT_MAX = 64  # largest batch tile
STEP_ROWS = 32  # a step's fixed cost in rows of the per-row cost
CHUNK = 64  # most rows of a streamed chunk of the Wh slice
STAGES = 2  # streamed chunks in shared memory

# launch plans held against the kernel's, by shape key: (Plan, the line
# logged for it)
plans: dict = {}


class Plan(NamedTuple):
    """How the kernel splits one direction's scan (csrc/lstm_fwd.cu
    `lf_plan`, which this mirrors field for field)."""
    cs: int  # blocks (SMs) in a cluster
    bt: int  # batch rows a cluster
    units: int  # hidden units a block, a multiple of 8
    kp: int  # H rounded up to 16: the depth of the product
    kres: int  # rows of the block's Wh slice resident in shared memory
    kc: int  # rows a streamed chunk; 0: the whole slice is resident
    smem: int  # dynamic shared memory bytes a block
    clusters: int  # ceil(B / bt), one batch tile each

    def unit_range(self, s: int, H: int) -> range:
        """The hidden units block s of a cluster owns (maybe none)."""
        return range(s * self.units, min((s + 1) * self.units, H))

    def row_range(self, c: int, B: int) -> range:
        """The batch rows cluster c owns."""
        return range(c * self.bt, min((c + 1) * self.bt, B))


def _round_up(a: int, m: int) -> int:
    return (a + m - 1) // m * m


def mma_tiles(units: int) -> int:
    """The mma tiles a warp holds in bf16 with `units` a block:
    MMA_TILES, or MMA_TILES_WIDE past 128 units (H > 2048 at 16 blocks),
    which the kernel serves with a second instance."""
    return MMA_TILES if units <= 128 else MMA_TILES_WIDE


def plan(H: int, B: int, dtype: torch.dtype, active: int) -> Optional[Plan]:
    """The kernel's launch plan for hidden size H, batch B, the compute
    dtype and the clusters of the plan's size the card runs at once
    (`active`: 7 of 16 blocks on an H100 SXM); None where no plan fits the
    card's shared memory.

    The cluster is the smallest power of two that gives each block 8 of
    the H units or more, up to 16 (U a block, a multiple of 8; the last
    blocks may own fewer, or none, and are masked in the kernel).  The
    batch tile bt is the multiple of 16 (bf16: mma rows) or 4 (float32)
    up to 64 that fits and costs least, waves x (bt + STEP_ROWS), waves =
    ceil(clusters / active), the smaller on a tie; in bf16 a warp holds
    `mma_tiles(U)` (16-row, 8-unit) tiles.  Shared memory holds the
    tile's h (bt x (kp + 16 bytes)) and as many rows of the block's
    (kp, 4U) slice of Wh as fit; the rest stream from L2 through STAGES
    chunks of the most rows (CHUNK, halved down to 16) that fit."""
    esz = torch.empty((), dtype=dtype).element_size()
    cs = 1
    while cs < MAX_CLUSTER and cs * 8 < H:
        cs *= 2
    U = _round_up(-(-H // cs), 8)
    kp, pad = _round_up(H, 16), 16 // esz
    wrow, hrow = (4 * U + pad) * esz, (kp + pad) * esz
    rowq = 16 if esz == 2 else FMA_ROWS
    best, out = None, None
    for bt in range(rowq, min(BT_MAX, B + rowq - 1) + 1, rowq):
        tiles = (bt // 16) * (U // 8) if esz == 2 else (bt // FMA_ROWS) * U
        if tiles > (THREADS // 32 * mma_tiles(U) if esz == 2 else THREADS):
            continue
        fixed, kres, kc = bt * hrow, kp, 0
        if fixed + kp * wrow > SMEM_MAX:
            # the largest chunk (64, 32 or 16 rows) whose stages fit;
            # resident rows: what fits beside them, whole chunks streamed
            for kc in (CHUNK, CHUNK // 2, CHUNK // 4):
                avail = SMEM_MAX - fixed - STAGES * kc * wrow
                kres = (kp - _round_up(kp - avail // wrow, kc)
                        if avail >= 0 else -1)
                if kres >= 0:
                    break
            if kres < 0:
                continue
        clusters = -(-B // bt)
        cost = -(-clusters // active) * (bt + STEP_ROWS)
        if best is not None and cost >= best:
            continue
        best = cost
        smem = fixed + (kres + (STAGES * kc if kc else 0)) * wrow
        out = Plan(cs, bt, U, kp, kres, kc, smem, clusters)
    return out


def plan_line(p: Plan, H: int, B: int, cd: torch.dtype, xd: torch.dtype,
              active: int) -> str:
    """The plan in words, as the logs print it."""
    row = 4 * p.units * torch.empty((), dtype=cd).element_size()
    return (
        f"lstm_fwd plan H={H} B={B} {cd} (x_proj {xd}): cluster "
        f"{p.cs} x {p.units} units, bt={p.bt}, {p.clusters} clusters, "
        f"{active} at once ({-(-p.clusters // active)} waves); Wh slice "
        f"{p.kp} x {4 * p.units}: {p.kres} rows ({p.kres * row} B) "
        f"resident, {p.kp - p.kres} ({(p.kp - p.kres) * row} B) streamed "
        f"in chunks of {p.kc}; smem {p.smem} B")


def checked_plan(H: int, B: int, cd: torch.dtype, xd: torch.dtype) -> Plan:
    """The launch's plan: ValueError where none fits; on a shape's first
    launch held against the kernel's own, with the clusters the card runs
    at once, and logged (`cuda.held_plan`)."""
    if plan(H, B, cd, 1) is None:
        raise ValueError(f"lstm_fwd_scan: no kernel plan fits H={H}, B={B} "
                         f"in {cd} (the h tile and the Wh chunks exceed "
                         "the shared memory)")
    return cuda.held_plan(
        "lstm_fwd", (H, B, cd, xd),
        lambda out: cuda.library().aocr_lstm_fwd_plan(
            H, B, int(cd == torch.float32), int(xd == torch.float32), out),
        9, lambda active: plan(H, B, cd, active),
        lambda p, active: plan_line(p, H, B, cd, xd, active), plans)


def lstm_fwd_scan_plain(wh, x_proj, c0, h0, reverse: bool,
                        collect: bool = False):
    """Plain PyTorch version; same arguments and results as
    lstm_fwd_scan."""
    L, B, G = x_proj.shape
    cd = wh.dtype
    c, h = c0.float(), h0.float()
    hs = torch.empty((L, B, G // 4), dtype=cd, device=x_proj.device)
    if collect:
        ifog = torch.empty((L, B, G), dtype=cd, device=x_proj.device)
        cs = torch.empty_like(hs)
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        gates = x_proj[t].float() + matmul(h.to(cd), wh)
        c, h, acts = lstm.gate_math_parts(gates, c)
        hs[t] = h.to(cd)
        if collect:
            ifog[t] = torch.cat(acts, dim=-1).to(cd)
            cs[t] = c.to(cd)
    if collect:
        return hs, (c, h), (ifog, cs)
    return hs, (c, h)


def lstm_fwd_scan(wh: torch.Tensor, x_proj: torch.Tensor, c0: torch.Tensor,
                  h0: torch.Tensor, reverse: bool, collect: bool = False):
    """wh (H, 4H) compute dtype; x_proj (L, B, 4H) float32 or compute
    dtype; c0, h0 (B, H) float32.  Returns (hs (L, B, H) scan-major in the
    compute dtype, (c_f, h_f) float32), and with collect the residuals
    (ifog (L, B, 4H), cs (L, B, H)) in the compute dtype.  Runs the custom
    op aocr_torch::lstm_fwd_scan (`op`): CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if wh.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm_fwd_scan: unsupported device {wh.device}")
    hs, cf, hf, ifog, cs = op(wh, x_proj, c0, h0, reverse, collect)
    if collect:
        return hs, (cf, hf), (ifog, cs)
    return hs, (cf, hf)


@torch.library.custom_op("aocr_torch::lstm_fwd_scan", mutates_args=())
def op(wh: torch.Tensor, x_proj: torch.Tensor, c0: torch.Tensor,
       h0: torch.Tensor, reverse: bool, collect: bool
       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor]:
    """lstm_fwd_scan as a custom op: (hs, c_f, h_f, ifog, cs), the last
    two empty without collect.  The plan is picked here, from the real
    batch, so that torch.export traces the scan as one node."""
    global launches, launches_collect
    if wh.device.type == "cpu":
        out = lstm_fwd_scan_plain(wh, x_proj, c0, h0, reverse, collect)
        hs, (cf, hf) = out[:2]
        ifog, cs = out[2] if collect else (wh.new_empty(0), wh.new_empty(0))
        return hs, cf, hf, ifog, cs
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
    checked_plan(H, B, cd, x_proj.dtype)
    hs = torch.empty((L, B, H), dtype=cd, device=dev)
    cf = torch.empty((B, H), dtype=torch.float32, device=dev)
    hf = torch.empty((B, H), dtype=torch.float32, device=dev)
    ifog = torch.empty((L, B, G) if collect else 0, dtype=cd, device=dev)
    cs = torch.empty((L, B, H) if collect else 0, dtype=cd, device=dev)
    cuda.launch("lstm_fwd", cd, dev, wh.data_ptr(), x_proj.data_ptr(),
                int(x_proj.dtype == torch.float32), c0.data_ptr(),
                h0.data_ptr(), hs.data_ptr(), cf.data_ptr(), hf.data_ptr(),
                ifog.data_ptr() if collect else None,
                cs.data_ptr() if collect else None, L, B, H, int(reverse))
    launches += 1
    if collect:
        launches_collect += 1
    return hs, cf, hf, ifog, cs


@op.register_fake
def _(wh, x_proj, c0, h0, reverse, collect):
    L, B, G = x_proj.shape
    H = G // 4
    hs = wh.new_empty((L, B, H))
    ifog = wh.new_empty((L, B, G) if collect else 0)
    cs = wh.new_empty((L, B, H) if collect else 0)
    return hs, c0.new_empty((B, H)), c0.new_empty((B, H)), ifog, cs
