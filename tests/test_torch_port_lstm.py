"""aocr_torch LSTM, encoder and lstm_fwd kernel against the JAX reference
on CPU.

Seeded numpy inputs go through the JAX function -- `lstm_fwd_scan` in
interpret mode, or the XLA scans -- and through the port, whose
`lstm_fwd` wrapper runs its plain version on CPU tensors.

Tolerances: float32 within 1e-5 relative; bfloat16 h stacks (stored in
bf16) within a few bf16 steps of the state scale, since a rounding that
flips at one step feeds every later step.
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aocr.models import encoder as jenc
from aocr.ops import lstm as jlstm
from aocr.ops.pallas import lstm_fwd as jlf
from aocr_torch import weights
from aocr_torch.models import encoder
from aocr_torch.ops import lstm
from aocr_torch.ops.cuda import lstm_fwd
from aocr_torch.ops.mm import matmul

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# clusters of 16 blocks an H100 SXM runs at once (cudaOccupancyMaxActive-
# Clusters, as chip_smoke.py logs it): the lstm_fwd plan's wave count
ACTIVE = 7


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B", [1, 5])
def test_lstm_fwd_scan_matches_kernel(dtype, reverse, B):
    jd, td = DT[dtype]
    L, H = 6, 64
    rs = np.random.RandomState(10 + B)
    wh = rs.uniform(-0.2, 0.2, (H, 4 * H)).astype(np.float32)
    xp = rs.uniform(-1, 1, (L, B, 4 * H)).astype(np.float32)
    c0 = rs.uniform(-1, 1, (B, H)).astype(np.float32)
    h0 = rs.uniform(-1, 1, (B, H)).astype(np.float32)
    hs_j, (cf_j, hf_j) = jlf.lstm_fwd_scan(
        jnp.asarray(wh).astype(jd), jnp.asarray(xp).astype(jd),
        jnp.asarray(c0), jnp.asarray(h0), reverse, collect=False,
        interpret=True)
    hs, (cf, hf) = lstm_fwd.lstm_fwd_scan(_t(wh, td), _t(xp, td), _t(c0),
                                          _t(h0), reverse)
    assert hs.dtype == td and tuple(hs.shape) == (L, B, H)
    tol = TOL[dtype]
    for got, want in ((hs, hs_j), (cf, cf_j), (hf, hf_j)):
        np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("reverse", [False, True])
def test_unidirectional_scan_matches_reference(reverse):
    B, L, D, H = 5, 7, 16, 32
    rs = np.random.RandomState(20)
    layer = jax.tree.map(np.asarray, jlstm.init_lstm_layer(
        jax.random.PRNGKey(3), D, H))
    xs = rs.uniform(-1, 1, (B, L, D)).astype(np.float32)
    c0 = rs.uniform(-1, 1, (B, H)).astype(np.float32)
    h0 = rs.uniform(-1, 1, (B, H)).astype(np.float32)
    hs_j, (cf_j, hf_j) = jlstm.unidirectional_scan(
        jax.tree.map(jnp.asarray, layer), jnp.asarray(xs), jnp.asarray(c0),
        jnp.asarray(h0), reverse=reverse)
    tl = {k: _t(v) for k, v in layer.items()}
    for use_kernel in (True, False):
        hs, (cf, hf) = lstm.unidirectional_scan(tl, _t(xs), _t(c0), _t(h0),
                                                reverse, torch.float32,
                                                use_kernel)
        for got, want in ((hs, hs_j), (cf, cf_j), (hf, hf_j)):
            np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                       atol=1e-5)


def test_gate_math_matches_reference():
    rs = np.random.RandomState(21)
    g = rs.uniform(-4, 4, (3, 4 * 8)).astype(np.float32)
    c = rs.uniform(-2, 2, (3, 8)).astype(np.float32)
    cj, hj = jlstm.gate_math(jnp.asarray(g), jnp.asarray(c))
    ct, ht = lstm.gate_math(_t(g), _t(c))
    np.testing.assert_allclose(ct.numpy(), _np(cj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ht.numpy(), _np(hj), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("jax_kernel", [False, True])
@pytest.mark.parametrize("B", [1, 5])
def test_encoder_apply_matches_reference(monkeypatch, dtype, jax_kernel, B):
    """Context and dec_init ([fw final at t=L ; bw final at t=1]) through
    the JAX XLA scans or its lstm_fwd kernel (interpret mode)."""
    jd, td = DT[dtype]
    L, D, H = 6, 512, 64
    rs = np.random.RandomState(30 + B)
    pf = jax.tree.map(np.asarray, jenc.init_params(
        jax.random.PRNGKey(1), D, H, 1))
    pb = jax.tree.map(np.asarray, jenc.init_params(
        jax.random.PRNGKey(2), D, H, 1))
    feats = rs.uniform(-1, 1, (B, L, D)).astype(np.float32)
    monkeypatch.setattr(jlstm, "_PALLAS_LSTM_FWD_INTERPRET", jax_kernel)
    monkeypatch.setattr(jlstm, "_SCAN_VJP_CACHE", {})
    ctx_j, (c0_j, h0_j) = jenc.apply(
        jax.tree.map(jnp.asarray, pf), jax.tree.map(jnp.asarray, pb),
        jnp.asarray(feats).astype(jd), compute_dtype=jd)
    tp, _ = weights.from_numpy({"encoder_fw": pf, "encoder_bw": pb}, {})
    ctx, (c0, h0) = encoder.apply(tp["encoder_fw"], tp["encoder_bw"],
                                  _t(feats, td), td)
    assert tuple(ctx.shape) == (B, L, 2 * H) and ctx.dtype == td
    assert ctx.transpose(0, 1).is_contiguous()
    tol = TOL[dtype]
    for got, want in ((ctx, ctx_j), (c0, c0_j), (h0, h0_j)):
        np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                                   atol=tol)


def _plan_scan(wh, xp, c0, h0, reverse, p):
    """lstm_fwd_scan_plain's recurrence (collect=True) routed through the
    plan's tiles and slices, as csrc/lstm_fwd.cu routes it: cluster k owns
    the rows p.row_range(k, B), block s of it the units p.unit_range(s, H)
    and their four gate columns (j, H+j, 2H+j, 3H+j); a block gathers its
    gates from its x_proj columns and the product, keeps its c, writes its
    h, hs, cs and ifog, and the next step reads the h all blocks wrote.
    The product and the gate math are taken once a step on the whole
    batch, as the plain version takes them (a CPU BLAS and vectorized
    tanh/sigmoid give results that depend on the operands' shapes in the
    last bit); each block gathers and scatters its rows and columns.
    Returns the plain version's results and the number of times each
    (row, unit) was computed a step."""
    L, B, G = xp.shape
    H, cd = G // 4, wh.dtype
    c, h = c0.float().clone(), h0.float().clone()
    hs = torch.empty((L, B, H), dtype=cd)
    ifog = torch.empty((L, B, G), dtype=cd)
    cs = torch.empty((L, B, H), dtype=cd)
    count = torch.zeros((B, H), dtype=torch.int64)
    blocks = []
    for k in range(p.clusters):
        rows = torch.tensor(list(p.row_range(k, B)))[:, None]
        for s in range(p.cs):
            units = torch.tensor(list(p.unit_range(s, H)))[None, :]
            count[rows, units] += 1
            blocks.append((rows, units,
                           torch.cat([q * H + units for q in range(4)], 1)))
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        prod = matmul(h.to(cd), wh)
        gates = torch.full((B, G), float("nan"))
        for rows, _units, cols in blocks:
            gates[rows, cols] = xp[t][rows, cols].float() + prod[rows, cols]
        c_all, h_all, acts = lstm.gate_math_parts(gates, c)
        acts = torch.cat(acts, dim=-1)
        h = torch.full_like(h, float("nan"))
        for rows, units, cols in blocks:
            c[rows, units] = c_all[rows, units]
            h[rows, units] = h_all[rows, units]
            hs[t, rows, units] = h_all[rows, units].to(cd)
            cs[t, rows, units] = c_all[rows, units].to(cd)
            ifog[t, rows, cols] = acts[rows, cols].to(cd)
    return (hs, (c, h), (ifog, cs)), count


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 6, 400, 512])
@pytest.mark.parametrize("H", [64, 128, 256, 512, 1024])
def test_lstm_fwd_plan_partition(dtype, B, H):
    """The kernel's launch plan: every (row, unit) is computed by exactly
    one block of one cluster, a block's shared memory fits the H100's
    232,448 bytes, and the recurrence through the plan's tiles and slices
    equals the plain version exactly and aocr's kernel (interpret mode)
    within TOL."""
    jd, td = DT[dtype]
    p = lstm_fwd.plan(H, B, td, ACTIVE)
    assert p is not None and p.smem <= 232448
    assert p.units % 8 == 0 and p.kres % 16 == 0 and p.kres <= p.kp
    assert p.clusters * p.bt >= B > (p.clusters - 1) * p.bt
    L = 2
    rs = np.random.RandomState(H + B)
    b = H ** -0.5
    wh = rs.uniform(-b, b, (H, 4 * H)).astype(np.float32)
    xp = rs.uniform(-1, 1, (L, B, 4 * H)).astype(np.float32)
    c0 = rs.uniform(-1, 1, (B, H)).astype(np.float32)
    h0 = rs.uniform(-1, 1, (B, H)).astype(np.float32)
    args = (_t(wh, td), _t(xp, td), _t(c0), _t(h0), True)
    got, count = _plan_scan(*args, p)
    assert bool((count == 1).all())
    want = lstm_fwd.lstm_fwd_scan_plain(*args, collect=True)
    flat = lambda o: (o[0], *o[1], *o[2])
    for g, w in zip(flat(got), flat(want)):
        assert torch.equal(g, w)
    hs_j, fin_j, res_j = jlf.lstm_fwd_scan(
        jnp.asarray(wh).astype(jd), jnp.asarray(xp).astype(jd),
        jnp.asarray(c0), jnp.asarray(h0), True, collect=True, interpret=True)
    tol = TOL[dtype]
    for g, w in zip(flat(got), (hs_j, *fin_j, *res_j)):
        np.testing.assert_allclose(g.float().numpy(), _np(w), rtol=tol,
                                   atol=tol)


def test_lstm_fwd_plan_limits():
    """Shapes the plan serves and those it refuses (the wrapper raises
    ValueError on a CUDA tensor for these): every even H up to 2420 in
    both dtypes (the previous kernel's limit; past 2048 in bf16 a warp
    holds 3 mma tiles), none past 4096."""
    for dt in (torch.float32, torch.bfloat16):
        for H in (2, 130, 200, 520, 1030, 2048, 2050, 2400, 2420):
            for B in (1, 33, 512):
                p = lstm_fwd.plan(H, B, dt, ACTIVE)
                assert p is not None and p.smem <= 232448
                assert sum(len(p.unit_range(s, H))
                           for s in range(p.cs)) == H
                if dt == torch.bfloat16:
                    tiles = (p.bt // 16) * (p.units // 8)
                    assert tiles <= 8 * lstm_fwd.mma_tiles(p.units)
        assert lstm_fwd.plan(4098, 1, dt, ACTIVE) is None
    for dt in (torch.float32, torch.bfloat16):
        assert all(lstm_fwd.plan(H, 512, dt, ACTIVE) is not None
                   for H in range(2, 2422, 2))
