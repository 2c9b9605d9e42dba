"""aocr_torch's lstm_bwd launch plan and its split of the backward
recurrence, and conv1_pool_bwd's split of a batch and sum of its
partials, on CPU.

The plan (`lstm_bwd.plan`, the mirror of csrc/lstm_bwd.cu's `lb_plan`)
decides which block of which cluster owns each (batch row, hidden unit)
and so each dgates column, how the product dh = round(dgates) @ Wh^T is
split (bf16: by the contraction, each block's partial over its own gate
columns, the partials summed in block order; float32 and bf16 past
H=640: a block per 4 batch rows), and the shared memory a block needs.
These tests hold the partition, the shapes served and refused, and a
replay of the split in plain PyTorch: against `lstm_bwd_scan_plain`
within 1e-6 relative in float32 (only the summation order of dh
changes), and against aocr's `lstm_bwd_scan` in interpret mode within
the lstm tests' tolerances (float32 1e-5, bfloat16 3e-2 of the scale),
inputs from a numpy seed, the residuals from the plain forward.  The
conv1 weight-gradient kernel's plan (`conv1_pool_bwd.plan`) gives each
block a run of the batch's pooled cells and sums the blocks' partials in
a fixed tree (`levels`): every cell is added once, in a fixed order, and
the replay equals the plain version within 1e-5 of its scale.
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from aocr.ops.pallas import lstm_bwd as jlb
from aocr_torch.ops import lstm
from aocr_torch.ops.cuda import conv1_pool_bwd, lstm_bwd, lstm_fwd
from aocr_torch.ops.mm import matmul

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
SMEM_MAX = 232448
# clusters of 16 blocks an H100 SXM runs at once (cudaOccupancyMaxActive-
# Clusters, as chip_smoke.py logs it)
ACTIVE = 7


def _blocks(p, B, H):
    """(cluster, block, rows, units) of every block the plan launches."""
    if p.route == lstm_bwd.ROUTE_ROWS:
        return [(k, 0, p.row_range(k, B), range(H))
                for k in range(p.clusters)]
    return [(k, s, p.row_range(k, B), p.unit_range(s, H))
            for k in range(p.clusters) for s in range(p.cs)]


def _replay(wh, dhs, ifog, cs, c0, dc_f, dh_f, reverse, p):
    """lstm_bwd_scan_plain's recurrence routed through the plan, as
    csrc/lstm_bwd.cu routes it.  The gate backward is elementwise, so it
    is taken once a step on the whole batch, as the plain version takes
    it, and each block keeps its (row, unit) pairs' dgates and dc.  The
    clusters: block s of cluster k multiplies its rows' rounded
    dgates in its own four gate columns by the same columns of Wh into a
    float32 partial dh (rows x H), and block d's dh of its units is the
    sum of the cs partials' columns in block order.  The rows route takes
    each block's rows of the whole product.  Returns the results and how
    many blocks computed each (row, unit) a step."""
    L, B, H = dhs.shape
    cd = wh.dtype
    blocks = _blocks(p, B, H)
    count = torch.zeros((B, H), dtype=torch.int64)
    for _k, _s, rows, units in blocks:
        count[rows.start:rows.stop, units.start:units.stop] += 1
    dh, dc = dh_f.float().clone(), dc_f.float().clone()
    dg = torch.empty((L, B, 4 * H), dtype=cd)
    for t in (range(L) if reverse else range(L - 1, -1, -1)):
        first = t == (L - 1 if reverse else 0)
        cp = c0.to(cd) if first else cs[t + 1 if reverse else t - 1]
        dgates, dc_all = lstm_bwd.gate_math_bwd(
            dh + dhs[t].float(), dc, ifog[t].chunk(4, dim=-1), cs[t], cp)
        dg[t] = dgates.to(cd)
        new_dh = torch.full_like(dh, float("nan"))
        new_dc = torch.full_like(dc, float("nan"))
        if p.route == lstm_bwd.ROUTE_ROWS:
            prod = matmul(dg[t], wh.t())
            for _k, _s, rows, _units in blocks:
                r = slice(rows.start, rows.stop)
                new_dh[r] = prod[r]
                new_dc[r] = dc_all[r]
        else:
            for k in range(p.clusters):
                rows = p.row_range(k, B)
                r = slice(rows.start, rows.stop)
                partials = []
                for s in range(p.cs):
                    units = p.unit_range(s, H)
                    cols = [q * H + j for q in range(4) for j in units]
                    part = torch.zeros((len(rows), H))
                    if cols:
                        part = matmul(dg[t][r][:, cols], wh[:, cols].t())
                    partials.append(part)
                for d in range(p.cs):
                    units = p.unit_range(d, H)
                    if not len(units):
                        continue
                    u = slice(units.start, units.stop)
                    acc = partials[0][:, u]
                    for part in partials[1:]:
                        acc = acc + part[:, u]
                    new_dh[r, u] = acc
                    new_dc[r, u] = dc_all[r, u]
        dh, dc = new_dh, new_dc
    return (dg, dh, dc), count


def _case(H, B, L, reverse, td, seed):
    """wh, and the backward's inputs on the plain forward's residuals,
    as numpy float32 arrays and torch tensors in the compute dtype."""
    rs = np.random.RandomState(seed)
    b = H ** -0.5
    wh = rs.uniform(-b, b, (H, 4 * H)).astype(np.float32)
    xp = rs.uniform(-1, 1, (L, B, 4 * H)).astype(np.float32)
    c0 = rs.uniform(-1, 1, (B, H)).astype(np.float32)
    h0 = rs.uniform(-1, 1, (B, H)).astype(np.float32)
    dhs = rs.uniform(-0.1, 0.1, (L, B, H)).astype(np.float32)
    dcf = rs.uniform(-0.1, 0.1, (B, H)).astype(np.float32)
    dhf = rs.uniform(-0.1, 0.1, (B, H)).astype(np.float32)
    t = lambda a, d=torch.float32: torch.from_numpy(a).to(d)
    _, _, (ifog, cs) = lstm_fwd.lstm_fwd_scan_plain(
        t(wh, td), t(xp, td), t(c0), t(h0), reverse, collect=True)
    return (t(wh, td), t(dhs), ifog, cs, t(c0), t(dcf), t(dhf), reverse)


# (H, B): blocks of 8 units over two to sixteen blocks, units past H
# (H=48: blocks 6 and 7 own none), ragged tiles, the encoder's width
REPLAY = [(16, 3), (48, 33), (64, 1), (128, 40), (512, 5)]


@pytest.mark.parametrize("route_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,B", REPLAY)
def test_lstm_bwd_split_replay_float32(H, B, route_dtype):
    """The split of the plan for route_dtype (bf16: the clusters; float32:
    the rows), float32 values, so that only dh's summation order differs:
    each (row, unit) computed by exactly one block, and within 1e-6 of the
    plain version's scale."""
    p = lstm_bwd.plan(H, B, route_dtype, ACTIVE)
    assert p.route == (lstm_bwd.ROUTE_CLUSTERS
                       if route_dtype == torch.bfloat16
                       else lstm_bwd.ROUTE_ROWS)
    args = _case(H, B, 3, B % 2 == 1, torch.float32, H + B)
    got, count = _replay(*args, p)
    assert bool((count == 1).all())
    want = lstm_bwd.lstm_bwd_scan_plain(*args)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-6 * scale
    if p.route == lstm_bwd.ROUTE_ROWS:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("H,B", [(48, 33), (128, 6)])
def test_lstm_bwd_split_replay_matches_aocr_kernel(dtype, reverse, H, B):
    """The dtype's own plan's split against aocr's lstm_bwd_scan in
    interpret mode (wh_t = wh.T, cprev the shifted cs), within TOL of the
    scale."""
    jd, td = DT[dtype]
    p = lstm_bwd.plan(H, B, td, ACTIVE)
    assert p.route == (lstm_bwd.ROUTE_ROWS if dtype == "float32"
                       else lstm_bwd.ROUTE_CLUSTERS)
    args = _case(H, B, 4, reverse, td, 7 * H + B)
    wh, dhs, ifog, cs, c0, dcf, dhf, _ = args
    got, _count = _replay(*args, p)
    j = lambda x: jnp.asarray(x.float().numpy()).astype(
        jd if x.dtype == td and td != torch.float32 else jnp.float32)
    cprev = lstm.shift(cs, c0, reverse)
    want = jlb.lstm_bwd_scan(
        jnp.asarray(wh.t().float().numpy()).astype(jd), j(dhs), j(ifog),
        j(cs), j(cprev), j(dcf), j(dhf), reverse, interpret=True)
    tol = TOL[dtype]
    for g, w in zip(got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        scale = float(np.abs(w).max())
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 33, 400, 512])
@pytest.mark.parametrize("H", [16, 48, 64, 128, 256, 512, 576, 640, 656,
                               1024, 2416])
def test_lstm_bwd_plan_partition(dtype, B, H):
    """Every (row, unit), and so every dgates column q H + j, is owned by
    exactly one block of one cluster; a block's shared memory fits the
    H100's 232,448 bytes; the tile covers B; each block receives one
    partial from every block of its cluster, at its source's slot."""
    plans = [lstm_bwd.plan(H, B, dtype, ACTIVE)]
    if dtype == torch.bfloat16:  # no resident cluster: the rows route
        plans.append(lstm_bwd.plan(H, B, dtype, 0))
        assert plans[-1] == lstm_bwd.plan(H, B, torch.float32, ACTIVE)
    for p in plans:
        assert p.smem <= SMEM_MAX
        assert p.clusters * p.bt >= B > (p.clusters - 1) * p.bt
        count = torch.zeros((B, H), dtype=torch.int64)
        for _k, _s, rows, units in _blocks(p, B, H):
            count[rows.start:rows.stop, units.start:units.stop] += 1
        assert bool((count == 1).all())
        if p.route == lstm_bwd.ROUTE_ROWS:
            assert p.bt == 4 and p.units == H and p.scratch_bytes() == 0
            continue
        assert p.units % 8 == 0 and p.bt % 16 == 0
        assert p.bt * p.units // 2 <= lstm_bwd.PAIRS * lstm_bwd.THREADS
        # the reduce-scatter: slot (dest d, source s) of the L2 scratch
        # holds block s's partial of block d's units
        slots = [(d, s) for d in range(p.cs) for s in range(p.cs)]
        assert len(set(slots)) == p.cs * p.cs
        assert p.scratch_bytes() == 4 * p.clusters * len(slots) * \
            p.bt * p.units
        assert p.smem == lstm_bwd.smem_bytes(p.bt, p.units, H)


def test_lstm_bwd_plan_limits():
    """Every H % 16 == 0 up to 2416 is served at B = 1, 33, 400, 512 in
    both dtypes (the first port's kernel's limit), bf16 on the clusters up
    to H=640 and by rows past it; H=2432 and up, and H % 16 != 0, are
    refused (the wrapper raises ValueError on a CUDA tensor for these)."""
    for dt in (torch.float32, torch.bfloat16):
        for B in (1, 33, 400, 512):
            for H in range(16, 2417, 16):
                p = lstm_bwd.plan(H, B, dt, ACTIVE)
                assert p is not None and p.smem <= SMEM_MAX, (dt, B, H)
                cluster = dt == torch.bfloat16 and H <= 640
                assert p.route == (lstm_bwd.ROUTE_CLUSTERS if cluster
                                   else lstm_bwd.ROUTE_ROWS), (dt, B, H)
            for H in (2432, 4096, 24, 100, 8):
                assert lstm_bwd.plan(H, B, dt, ACTIVE) is None
        assert lstm_bwd.plan(512, 400, dt, 0) == lstm_bwd.plan(
            512, 400, torch.float32, ACTIVE)


def test_lstm_bwd_plan_at_the_train_step():
    """The train step's encoder (H=512, B=400): one wave of 7 clusters of
    64 rows, 16 blocks of 32 units, their partials through L2."""
    p = lstm_bwd.plan(512, 400, torch.bfloat16, ACTIVE)
    assert p == lstm_bwd.Plan(lstm_bwd.ROUTE_CLUSTERS, 16, 64, 32, 173056,
                              7)
    assert p.scratch_bytes() == 4 * 7 * 16 * 16 * 64 * 32
    line = lstm_bwd.plan_line(p, 512, 400, torch.bfloat16, ACTIVE)
    assert "bt=64, 7 clusters, 7 at once (1 waves)" in line
    assert "rows" in lstm_bwd.plan_line(
        lstm_bwd.plan(512, 400, torch.float32, ACTIVE), 512, 400,
        torch.float32, 0)


# ---- conv1_pool_bwd: the batch's cells split over the card's blocks and
# the blocks' partials summed in a fixed tree


def _conv1_case(B, H, W, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, lo=-1.0, hi=1.0: torch.rand(*s, generator=g) * (hi - lo) + lo
    x = r(B, H, W, 1)
    w, b = r(64, 1, 3, 3, lo=-0.3, hi=0.3), r(64, lo=-0.3, hi=0.3)
    return x, w, b, r(B, H // 2, W // 2, 64)


def _cell_terms(x, w, b, dy):
    """Each pooled cell's (64, 10) term (9 dW taps, db) in (image, row,
    column) order, from the plain version's routing."""
    B, H, W, _ = x.shape
    Ho, Wo = H // 2, W // 2
    dz, g = conv1_pool_bwd.routed(x, w, b, dy)  # (B, 64, Ho, Wo, 4)
    xp = torch.nn.functional.pad(x[..., 0].float(), (1, 1, 1, 1))
    # the 4x4 patch of each cell: rows 2 ho .. 2 ho + 3 of the padded image
    patch = torch.stack([torch.stack([
        xp[:, a:a + 2 * Ho:2, c:c + 2 * Wo:2] for c in range(4)], -1)
        for a in range(4)], -2)  # (B, Ho, Wo, 4, 4)
    taps = torch.stack([
        sum(dz[..., p] * patch[:, None, ..., p // 2 + k // 3,
                               p % 2 + k % 3] for p in range(4))
        for k in range(9)], -1)  # (B, 64, Ho, Wo, 9)
    terms = torch.cat([taps, g], -1)  # (B, 64, Ho, Wo, 10)
    return terms.permute(0, 2, 3, 1, 4).reshape(B * Ho * Wo, 64, 10)


@pytest.mark.parametrize("B,H,W,resident", [
    (3, 8, 10, 7), (3, 8, 10, 40), (5, 9, 13, 264), (2, 32, 100, 264),
    (400, 32, 100, 264)])
def test_conv1_pool_bwd_plan_and_tree(B, H, W, resident):
    """Every pooled cell of every image is owned by exactly one block, the
    pool rows a block stages hold all of its cells and fit; the tree adds
    every block's partial exactly once, in block order; and dW, db through
    the blocks and the tree equal the plain version's within 1e-5 of the
    scale (only the summation order differs)."""
    p = conv1_pool_bwd.plan(B, H, W, resident)
    Ho, Wo = H // 2, W // 2
    cells = B * Ho * Wo
    assert p is not None and p.smem <= conv1_pool_bwd.STAGE_MAX
    assert p.blocks == min(resident, cells)
    runs = [p.cells(i, B, H, W) for i in range(p.blocks)]
    assert [c for r in runs for c in r] == list(range(cells))
    # the rows a block stages (its last pool row's 4 end the count) fit
    for r in runs:
        g0, g1 = r[0] // Wo, r[-1] // Wo
        assert conv1_pool_bwd.base(g1, g0, Ho) + 4 <= p.rows
        # pool row g's 4 rows: image rows 2 ho - 1 .. 2 ho + 2 of its image
        for g in range(g0, g1):
            step = conv1_pool_bwd.base(g + 1, g0, Ho) - \
                conv1_pool_bwd.base(g, g0, Ho)
            assert step == (2 if (g + 1) % Ho else 4)
    # the tree: group g of a level adds entries g FAN .. g FAN + FAN - 1
    lv = conv1_pool_bwd.levels(p.blocks)
    assert lv[-1] == 1 and all(lv[i + 1] == -(-lv[i] // 16)
                               for i in range(len(lv) - 1))
    order = [[i] for i in range(p.blocks)]
    for n in lv[1:]:
        order = [sum(order[16 * g:16 * g + 16], []) for g in range(n)]
    assert order == [list(range(p.blocks))]
    if cells > 2000:
        return
    x, w, b, dy = _conv1_case(B, H, W, B + H + W)
    terms = _cell_terms(x, w, b, dy)
    part = [terms[r.start:r.stop].sum(0) for r in runs]
    for n in lv[1:]:
        part = [sum(part[16 * g + 1:16 * g + 16], part[16 * g])
                for g in range(n)]
    dw, db = conv1_pool_bwd.conv1_relu_pool_bwd_plain(x, w, b, dy)
    for got, want in ((part[0][:, :9].reshape(64, 1, 3, 3), dw),
                      (part[0][:, 9], db)):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale


def test_conv1_pool_bwd_plan_limits():
    """A block stages 2 image rows a pool row and 2 more an image; wider
    images and larger batches take more blocks (the fewest that fit); past
    3,069 columns (4,093 for one image: 6 rows instead of 8) none fits."""
    for W in (2, 3, 100, 1707, 3000):
        p = conv1_pool_bwd.plan(64, 32, W, 264)
        assert p is not None and p.smem <= conv1_pool_bwd.STAGE_MAX
    big = conv1_pool_bwd.plan(20000, 32, 100, 264)
    assert big.blocks > 264 and big.smem <= conv1_pool_bwd.STAGE_MAX
    fewer = conv1_pool_bwd.Plan(big.blocks - 1, 0, 0)
    m = -(-20000 * 16 * 50 // fewer.blocks)
    assert conv1_pool_bwd.run_rows(m, 20000, 16, 50) * 4 * 102 > \
        conv1_pool_bwd.STAGE_MAX
    assert conv1_pool_bwd.plan(64, 32, 3069, 264) is not None
    assert conv1_pool_bwd.plan(64, 32, 3071, 264) is None
    assert conv1_pool_bwd.plan(1, 32, 4093, 264) is not None
    assert conv1_pool_bwd.plan(1, 32, 4095, 264) is None
    assert conv1_pool_bwd.plan(1, 1, 100, 264) is None
