"""One encoder direction's backward recurrence in one kernel
(csrc/lstm_bwd.cu).

Replaces `aocr/ops/pallas/lstm_bwd.py::lstm_bwd_scan`: from the residuals
of `lstm_fwd_scan(..., collect=True)` and the output cotangents, it
carries only (dh, dc) in float32, walking L in the transpose order of the
forward (L-1..0 for the forward encoder, 0..L-1 for the reversed one),
and emits the per-step pre-activation gate cotangents in the compute
dtype (the TPU kernel's contract; the plain version follows it) and the
initial-state cotangents.  dh_prev = round_cd(dgates) @ Wh^T, Wh in its
stored (H, 4H) orientation.  The weight, bias and input gradients are
batched outside (aocr_torch/ops/lstm.py).

The kernel has two routes (`plan` below, by dtype and shape).  bf16 runs
a persistent RNN on thread-block clusters, as lstm_fwd (ROUTE_CLUSTERS): a
cluster of up to 16 SMs owns a tile of batch rows for all L steps, each
SM owns H/cs units of the (dh, dc) carries and keeps lstm_fwd's (H, 4U)
slice of Wh in shared memory, and the product is split by the
contraction: each SM multiplies its own dgates columns into a float32
partial dh, and the partials are reduce-scattered through L2 and summed
in block order.  float32, and bf16 where the slice does not fit (H >
640), run the first port's kernel (ROUTE_ROWS: a block per 4 batch rows
streaming Wh from L2 every step).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from aocr_torch.ops import cuda
from aocr_torch.ops.mm import matmul

launches = 0

# csrc/lstm_bwd.cu's constants
ROUTE_ROWS, ROUTE_CLUSTERS = 0, 1
ROUTE_NAMES = ("rows", "clusters, partial sums through L2")
THREADS = 256
SMEM_MAX = 232448  # the H100's shared memory a block, bytes
MAX_CLUSTER = 16  # a non-portable cluster size on the H100
BT_MAX = 64  # largest batch tile
PAIRS = 4  # (row, unit pair)s a thread at most
STEP_ROWS = 32  # a step's fixed cost in rows of the per-row cost
ROWS_BT = 4  # batch rows a block, rows route

# launch plans held against the kernel's, by shape key: (Plan, the line
# logged for it)
plans: dict = {}


class Plan(NamedTuple):
    """How the kernel splits one direction's scan (csrc/lstm_bwd.cu
    `lb_plan`, which this mirrors field for field)."""
    route: int  # ROUTE_*
    cs: int  # blocks (SMs) in a cluster; rows: 1
    bt: int  # batch rows a cluster (rows: a block)
    units: int  # hidden units a block, a multiple of 8 (rows: H)
    smem: int  # dynamic shared memory bytes a block
    clusters: int  # ceil(B / bt) (rows: blocks)

    def unit_range(self, s: int, H: int) -> range:
        """The hidden units block s of a cluster owns (maybe none)."""
        return range(s * self.units, min((s + 1) * self.units, H))

    def row_range(self, c: int, B: int) -> range:
        """The batch rows cluster c owns."""
        return range(c * self.bt, min((c + 1) * self.bt, B))

    def scratch_bytes(self) -> int:
        """The clusters' partials in global memory (clusters x cs x cs x
        bt x U floats); 0 for the rows route."""
        if self.route != ROUTE_CLUSTERS:
            return 0
        return 4 * self.clusters * self.cs * self.cs * self.bt * self.units


def cluster(H: int):
    """(cs, U): the smallest power of two up to 16 giving every block 8
    units or more, and the units a block (a multiple of 8)."""
    cs = 1
    while cs < MAX_CLUSTER and cs * 8 < H:
        cs *= 2
    per = -(-H // cs)
    return cs, -(-per // 8) * 8


def smem_bytes(bt: int, U: int, H: int) -> int:
    """A cluster plan's shared memory: the (H, 4U) slice and the tile's own
    dgates (bt x 4U, rows padded by 16 bytes), the carries (bt x U floats,
    two)."""
    return (H + bt) * 2 * (4 * U + 8) + 8 * bt * U


def plan(H: int, B: int, dtype: torch.dtype, active: int) -> Optional[Plan]:
    """The kernel's launch plan for hidden size H, batch B, the compute
    dtype and the clusters of the cluster route's size the card runs at
    once (`active`; 7 of 16 blocks on an H100 SXM): bf16 takes the
    clusters where the slice fits (H <= 640), else (and float32) the rows
    route; None where neither fits (H % 16 != 0, or H > 2416).

    The clusters take `cluster(H)` and the batch tile bt, a multiple of 16
    up to 64 with at most PAIRS (row, unit pair)s a thread, whose shared
    memory fits and that costs least, waves x (bt + STEP_ROWS) with waves
    = ceil(clusters / active), the smaller on a tie."""
    if H < 16 or H % 16 or B < 1:
        return None
    best, out = None, None
    if dtype == torch.bfloat16 and active > 0:
        cs, U = cluster(H)
        for bt in range(16, min(BT_MAX, B + 15) + 1, 16):
            smem = smem_bytes(bt, U, H)
            if bt * U // 2 > PAIRS * THREADS or smem > SMEM_MAX:
                continue
            clusters = -(-B // bt)
            cost = -(-clusters // active) * (bt + STEP_ROWS)
            if best is not None and cost >= best:
                continue
            best = cost
            out = Plan(ROUTE_CLUSTERS, cs, bt, U, smem, clusters)
    if out is not None:
        return out
    smem = 4 * ROWS_BT * 6 * H
    if smem > SMEM_MAX:
        return None
    return Plan(ROUTE_ROWS, 1, ROWS_BT, H, smem, -(-B // ROWS_BT))


def plan_line(p: Plan, H: int, B: int, cd: torch.dtype, active: int) -> str:
    """The plan in words, as chip_smoke.py and the logs print it."""
    head = f"lstm_bwd plan H={H} B={B} {cd}: {ROUTE_NAMES[p.route]}"
    if p.route == ROUTE_ROWS:
        return (f"{head}: {p.clusters} blocks of {p.bt} batch rows, Wh read "
                f"from L2 every step; smem {p.smem} B")
    return (f"{head}: cluster {p.cs} x {p.units} units, bt={p.bt}, "
            f"{p.clusters} clusters, {active} at once "
            f"({-(-p.clusters // active)} waves); Wh slice {H} x "
            f"{4 * p.units} resident; partials {p.bt} x {p.units} floats "
            f"from each of {p.cs} blocks; smem {p.smem} B; scratch "
            f"{p.scratch_bytes()} B")


def checked_plan(H: int, B: int, cd: torch.dtype) -> Plan:
    """The launch's plan: ValueError where none fits; on a shape's first
    launch held against the kernel's own, with the clusters the card runs
    at once, and logged (`cuda.held_plan`)."""
    if plan(H, B, cd, 1) is None:
        raise ValueError(
            f"lstm_bwd_scan: no kernel plan fits H={H}, B={B} in {cd} (the "
            "kernel takes H % 16 == 0 and a block's shared memory)")
    return cuda.held_plan(
        "lstm_bwd", (H, B, cd),
        lambda out: cuda.library().aocr_lstm_bwd_plan(
            H, B, int(cd == torch.float32), out), 7,
        lambda active: plan(H, B, cd, active),
        lambda p, active: plan_line(p, H, B, cd, active), plans)


def gate_math_bwd(dh, dc, acts, c, cp):
    """Backward of the gate math from the stored activations: returns
    (dgates (..., 4H) float32, dc carried to the previous step).  Same
    operations, in the same order, as aocr/ops/pallas/lstm_bwd.py."""
    i, f, o, g = (a.float() for a in acts)
    tc = torch.tanh(c.float())
    d_o = dh * tc
    dc = dc + dh * o * (1.0 - tc * tc)
    d_i, d_g, d_f = dc * g, dc * i, dc * cp.float()
    dgates = torch.cat([d_i * i * (1.0 - i), d_f * f * (1.0 - f),
                        d_o * o * (1.0 - o), d_g * (1.0 - g * g)], dim=-1)
    return dgates, dc * f


def lstm_bwd_scan_plain(wh, dhs, ifog, cs, c0, dc_f, dh_f, reverse: bool):
    """Plain PyTorch version; same arguments and results as
    lstm_bwd_scan."""
    L, B, H = dhs.shape
    cd = wh.dtype
    c0 = c0.to(cd)
    dh, dc = dh_f.float(), dc_f.float()
    dg = torch.empty((L, B, 4 * H), dtype=cd, device=dhs.device)
    for t in (range(L) if reverse else range(L - 1, -1, -1)):
        first = t == (L - 1 if reverse else 0)
        cp = c0 if first else cs[t + 1 if reverse else t - 1]
        dgates, dc = gate_math_bwd(dh + dhs[t].float(), dc,
                                   ifog[t].chunk(4, dim=-1), cs[t], cp)
        dg[t] = dgates.to(cd)
        dh = matmul(dg[t], wh.t())
    return dg, dh, dc


def lstm_bwd_scan(wh: torch.Tensor, dhs: torch.Tensor, ifog: torch.Tensor,
                  cs: torch.Tensor, c0: torch.Tensor, dc_f: torch.Tensor,
                  dh_f: torch.Tensor, reverse: bool):
    """wh (H, 4H) compute dtype (the stored orientation); dhs (L, B, H)
    float32 cotangents of the h stack; ifog (L, B, 4H) and cs (L, B, H)
    compute dtype, as lstm_fwd_scan(collect=True) wrote them; c0 (B, H)
    float32, the forward's initial cell state; dc_f, dh_f (B, H) float32
    cotangents of the final state.  `reverse` is the forward's direction.
    Returns (dgates (L, B, 4H) compute dtype, dh0, dc0 (B, H) float32).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (ValueError for a shape no plan serves)."""
    global launches
    if wh.device.type == "cpu":
        return lstm_bwd_scan_plain(wh, dhs, ifog, cs, c0, dc_f, dh_f,
                                   reverse)
    if wh.device.type != "cuda":
        raise ValueError(f"lstm_bwd_scan: unsupported device {wh.device}")
    L, B, H = dhs.shape
    G = 4 * H
    cd, dev = wh.dtype, wh.device
    if L < 1:
        raise ValueError(f"lstm_bwd_scan: bad dhs shape {dhs.shape}")
    p = checked_plan(H, B, cd)
    cuda.check(wh, "wh", (H, G), cd, dev)
    cuda.check(dhs, "dhs", (L, B, H), torch.float32, dev)
    cuda.check(ifog, "ifog", (L, B, G), cd, dev)
    cuda.check(cs, "cs", (L, B, H), cd, dev)
    for name, t in (("c0", c0), ("dc_f", dc_f), ("dh_f", dh_f)):
        cuda.check(t, name, (B, H), torch.float32, dev)
    if p.route == ROUTE_CLUSTERS:  # vector loads
        cuda.check_aligned(wh=wh, dhs=dhs, ifog=ifog, cs=cs, c0=c0,
                           dc_f=dc_f, dh_f=dh_f)
    dg = torch.empty((L, B, G), dtype=cd, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dc0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    scratch = (torch.empty(p.scratch_bytes(), dtype=torch.uint8, device=dev)
               if p.route == ROUTE_CLUSTERS else None)
    cuda.launch("lstm_bwd", cd, dev, wh.data_ptr(), dhs.data_ptr(),
                ifog.data_ptr(), cs.data_ptr(), c0.data_ptr(),
                dc_f.data_ptr(), dh_f.data_ptr(), dg.data_ptr(),
                dh0.data_ptr(), dc0.data_ptr(), cuda.ptr(scratch), L, B, H,
                int(reverse))
    launches += 1
    return dg, dh0, dc0
