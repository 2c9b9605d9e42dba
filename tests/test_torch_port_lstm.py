"""aocr_torch LSTM, encoder and lstm_fwd kernel against the JAX reference
on CPU.

Seeded numpy inputs go through the JAX function -- `lstm_fwd_scan` in
interpret mode, or the XLA scans -- and through the port, whose
`lstm_fwd` wrapper runs its plain version on CPU tensors.

Tolerances: float32 within 1e-5 relative; bfloat16 h stacks (stored in
bf16) within a few bf16 steps of the state scale, since a rounding that
flips at one step feeds every later step.
"""

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

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


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
