"""The port's training options against the JAX package on the CPU:
dropout (on JAX's own masks, and the port's Philox draws), remat, the
simple attention in training and the fused encoder projection
(-fused_encoder_proj).

The reference's steps run its XLA routes (the per-step decoder scan that
dropout, remat and the simple attention take there too); the port runs
its kernels' plain versions on CPU tensors.  Tolerances are
tests/test_torch_port_train.py's float32 ones (loss 1e-5 relative, grad
norms 1e-4 relative, params 1e-5 absolute) and, for remat against no
remat, tests/test_decoder.py's (rtol 1e-4, atol 1e-5).
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aocr import optim as joptim
from aocr import train_step as jts
from aocr import vocab
from aocr.config import Config
from aocr.models import decoder as jdec
from aocr.models import encoder as jenc
from aocr.models import model as jmodel
from aocr_torch import augment, optim, train_step, weights
from aocr_torch.config import Config as TConfig
from aocr_torch.models import decoder, encoder
from aocr_torch.ops import dropout, lstm

WORDS = ["ab1", "xyz", "k", "wxyz"]
TOLS = (1e-5, 1e-4, 1e-5)
RATE = 0.3


def _kw(**kw):
    return dict(input_feed=True, encoder_num_hidden=16,
                target_embedding_size=8, batch_size=len(WORDS), **kw)


def _problem(seed=0, **kw):
    cfg = Config(**_kw(**kw)).validate()
    ms = jmodel.init(jax.random.PRNGKey(seed), cfg)
    images = np.random.RandomState(seed).uniform(
        0, 255, (len(WORDS), 32, 36, 1)).astype(np.float32)
    targets, targets_eval, _ = vocab.encode_batch(WORDS)
    return (cfg, TConfig(**_kw(**kw)).validate(),
            jax.tree.map(np.asarray, ms.params),
            jax.tree.map(np.asarray, ms.batch_stats), images, targets,
            targets_eval)


def _jax_step(cfg, params, stats, images, t, te, key):
    return jts.make_train_step(cfg)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        joptim.sgd_init(params), jnp.asarray(images), jnp.asarray(t),
        jnp.asarray(te), jnp.float32(0.1), key)


def _port_step(tcfg, params, stats, images, t, te, key=None):
    tp, ts = weights.from_numpy(params, stats)
    return train_step.make_train_step(tcfg)(
        tp, ts, train_step.init_opt_state(tp, tcfg), images, t, te, 0.1,
        key)


def _assert_step(got, want, tols=TOLS):
    loss_tol, norm_tol, param_tol = tols
    np.testing.assert_allclose(float(got.loss_sum), float(want.loss_sum),
                               rtol=loss_tol)
    for g in want.grad_norms:
        np.testing.assert_allclose(float(got.grad_norms[g]),
                                   float(want.grad_norms[g]), rtol=norm_tol,
                                   err_msg=g)
    gp, gs = weights.to_numpy(got.params, got.batch_stats)
    wp, ws = want.params, want.batch_stats
    if isinstance(optim.leaves(wp)[0], torch.Tensor):  # a port step
        wp, ws = weights.to_numpy(wp, ws)
    check = lambda a, b: np.testing.assert_allclose(  # noqa: E731
        a, np.asarray(b), rtol=0, atol=param_tol)
    jax.tree.map(check, gp, wp)
    jax.tree.map(check, gs, ws)


def jax_masks(key, T, num_layers, B, H, rate=RATE):
    """aocr's dropout masks, rebuilt from its own key splits
    (aocr/models/decoder.py:650-690): per step rng, sub = split(rng); for
    each layer i >= 1 and then h~, sub, k = split(sub) and the mask is
    bernoulli(k, 1 - rate, (B, H)).  Returns (T, num_layers, B, H)."""
    rng, out = key, []
    for _ in range(T):
        rng, sub = jax.random.split(rng)
        step = []
        for _ in range(num_layers):  # layers 1.. and h~
            sub, k = jax.random.split(sub)
            step.append(np.asarray(jax.random.bernoulli(k, 1.0 - rate,
                                                        (B, H))))
        out.append(step)
    return torch.from_numpy(np.asarray(out))


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's draw function, replaced by JAX's masks under the key
    the test passes as the port's step key."""
    seen = []

    def draw(key, rows, steps, sites, width, rate):
        seen.append((tuple(key), rows.tolist()))
        return jax_masks(jax.random.PRNGKey(int(key[1])), steps, sites,
                         len(rows), width, rate)

    monkeypatch.setattr(dropout, "masks", draw)
    return seen


def test_dropout_step_matches_reference_on_jax_masks(jax_draws):
    """Float32 h~, then one whole train step with dropout 0.3, against
    aocr with the same dropout_rng, the port applying JAX's masks."""
    cfg, tcfg, params, stats, images, t, te = _problem(dropout=RATE)
    key = jax.random.PRNGKey(7)
    # h~ of the decoder alone
    rs = np.random.RandomState(1)
    H, L = cfg.decoder_num_hidden, 5
    ctx = rs.uniform(-1, 1, (len(WORDS), L, H)).astype(np.float32)
    c0, h0 = (rs.uniform(-1, 1, (len(WORDS), H)).astype(np.float32)
              for _ in "ch")
    want = jdec.teacher_forced(
        jax.tree.map(jnp.asarray, params["decoder"]), (c0, h0),
        jnp.asarray(t), jnp.asarray(ctx), input_feed=True, dropout=RATE,
        train=True, dropout_rng=key)
    tp, _ = weights.from_numpy(params, stats)
    got = decoder.teacher_forced(
        tp["decoder"], (torch.from_numpy(c0), torch.from_numpy(h0)),
        torch.from_numpy(t), torch.from_numpy(ctx), input_feed=True,
        dropout=RATE, train=True, dropout_key=(0, 7))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # the whole step: aocr's train step hands the step rng to the decoder
    want = _jax_step(cfg, params, stats, images, t, te, key)
    got = _port_step(tcfg, params, stats, images, t, te, (0, 7))
    _assert_step(got, want)
    assert jax_draws[-1] == ((0, 7), list(range(len(WORDS))))
    # dropout changed the step
    plain = _port_step(tcfg.replace(dropout=0.0), params, stats, images, t,
                       te, (0, 7))
    assert float(plain.loss_sum) != float(got.loss_sum)


def test_dropout_draws():
    """The port's draws: a pure function of (key, global row, step, site,
    column), at the keep rate, applied as aocr's where(mask, x / keep,
    0)."""
    rows = torch.arange(64)
    m = dropout.masks((3, 4), rows, 3, 2, 1024, RATE)
    assert m.shape == (3, 2, 64, 1024) and m.dtype == torch.bool
    assert torch.equal(m, dropout.masks((3, 4), rows, 3, 2, 1024, RATE))
    # global rows: a shard of rows draws the whole batch's rows
    assert torch.equal(m[:, :, 40:], dropout.masks(
        (3, 4), torch.arange(40, 64), 3, 2, 1024, RATE))
    # another key, step, site, row or column draws another bit
    other = dropout.masks((3, 5), rows, 3, 2, 1024, RATE)
    assert (m != other).float().mean() > 0.3
    assert (m[0] != m[1]).float().mean() > 0.3
    assert (m[:, 0] != m[:, 1]).float().mean() > 0.3
    assert (m[:, :, 0] != m[:, :, 1]).float().mean() > 0.3
    assert (m[..., :512] != m[..., 512:]).float().mean() > 0.3
    # the keep rate: 393,216 draws, the band ~11 sigma
    assert abs(float(m.float().mean()) - (1 - RATE)) < 0.008
    big = dropout.masks((9, 9), torch.arange(400), 11, 2, 1024, RATE)
    assert abs(float(big.float().mean()) - (1 - RATE)) < 0.002
    # the arithmetic
    x = torch.randn(64, 1024)
    y = dropout.apply(x, m[0, 0], RATE)
    np.testing.assert_array_equal(
        y.numpy(), np.where(m[0, 0].numpy(),
                            x.numpy() / np.float32(1 - RATE), 0.0))


def test_dropout_eval_and_missing_key():
    """Eval ignores dropout; train with dropout and no key raises
    ValueError, as aocr's teacher_forced does."""
    cfg, tcfg, params, stats, images, t, te = _problem(dropout=RATE)
    tp, ts = weights.from_numpy(params, stats)
    nll, gold = train_step.eval_loss_step(tp, ts, images, t, te, tcfg)
    nll0, gold0 = train_step.eval_loss_step(tp, ts, images, t, te,
                                            tcfg.replace(dropout=0.0))
    assert float(nll) == float(nll0)
    assert torch.equal(gold, gold0)
    with pytest.raises(ValueError, match="dropout_rng"):
        _port_step(tcfg, params, stats, images, t, te, None)
    with pytest.raises(ValueError, match="dropout_rng"):
        jdec.teacher_forced(
            jax.tree.map(jnp.asarray, params["decoder"]),
            (jnp.zeros((4, 32)), jnp.zeros((4, 32))), jnp.asarray(t),
            jnp.zeros((4, 5, 32)), input_feed=True, dropout=RATE,
            train=True)


def test_augment_draws_unchanged_by_dropout(monkeypatch):
    """Augment reads the step key on a stream of its own: the augmented
    images of a step are bit for bit the same with dropout on or off,
    and a step with both repeats for one key."""
    _cfg, tcfg, params, stats, images, t, te = _problem(augment=True)
    seen = []
    real = augment.augment_batch

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    monkeypatch.setattr(train_step.augment_lib, "augment_batch", spy)
    key = augment.step_key(5, 3)
    a = _port_step(tcfg, params, stats, images, t, te, key)
    b = _port_step(tcfg.replace(dropout=RATE), params, stats, images, t, te,
                   key)
    c = _port_step(tcfg.replace(dropout=RATE), params, stats, images, t, te,
                   key)
    assert torch.equal(seen[0], seen[1]) and torch.equal(seen[1], seen[2])
    assert float(a.loss_sum) != float(b.loss_sum)
    assert float(b.loss_sum) == float(c.loss_sum)
    # PR 12's draws: the row keys of augment.draws, unchanged
    want = augment.augment_batch(key, torch.from_numpy(images), 1.0)
    assert torch.equal(seen[0], want)


@pytest.mark.parametrize("what", ["remat", "remat_dropout"])
def test_remat_matches_no_remat(what):
    """Decoder gradients with remat (each step under
    torch.utils.checkpoint) against the step without, and with dropout
    (the recompute reads the same masks); rtol 1e-4, atol 1e-5."""
    cfg, _tcfg, params, stats, _im, t, _te = _problem()
    rs = np.random.RandomState(2)
    H, L = cfg.decoder_num_hidden, 5
    ctx = rs.uniform(-1, 1, (4, L, H)).astype(np.float32)
    c0, h0 = (rs.uniform(-1, 1, (4, H)).astype(np.float32) for _ in "ch")
    r = rs.uniform(-1, 1, (4, t.shape[1], H)).astype(np.float32)
    rate = RATE if what == "remat_dropout" else 0.0

    def grads(remat):
        tp, _ = weights.from_numpy(params, stats)
        leaves = [x.requires_grad_() for x in optim.leaves(tp["decoder"])]
        ctx_t = torch.from_numpy(ctx).requires_grad_()
        hs = decoder.teacher_forced(
            tp["decoder"], (torch.from_numpy(c0), torch.from_numpy(h0)),
            torch.from_numpy(t), ctx_t, input_feed=True, dropout=rate,
            train=True, dropout_key=(1, 2), remat=remat)
        return torch.autograd.grad((hs * torch.from_numpy(r)).sum(),
                                   leaves + [ctx_t])

    for a, b in zip(grads(True), grads(False)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("what", ["remat", "simple_attention"])
def test_option_step_matches_reference(what):
    """One float32 train step with remat, or with the simple attention
    (h~ = ctx + h_top; w_c's gradient zero), against aocr's step on the
    same weights."""
    cfg, tcfg, params, stats, images, t, te = _problem(**{what: True})
    want = _jax_step(cfg, params, stats, images, t, te,
                     jax.random.PRNGKey(1))
    got = _port_step(tcfg, params, stats, images, t, te)
    _assert_step(got, want)


def _encoder_problem(num_layers, seed=20):
    B, L, D, H = 3, 6, 4, 8
    pf = jax.tree.map(np.asarray, jenc.init_params(
        jax.random.PRNGKey(seed), D, H, num_layers))
    pb = jax.tree.map(np.asarray, jenc.init_params(
        jax.random.PRNGKey(seed + 1), D, H, num_layers))
    rs = np.random.RandomState(seed)
    feats = rs.normal(size=(B, L, D)).astype(np.float32)
    rc = rs.uniform(-1, 1, (B, L, 2 * H)).astype(np.float32)
    rf = rs.uniform(-1, 1, (2, B, 2 * H)).astype(np.float32)
    return pf, pb, feats, rc, rf


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_layers", [1, 2])
def test_fused_encoder_projection(monkeypatch, dtype, num_layers):
    """encoder.apply(fused_l0=True): context, dec_init and every gradient
    against aocr's fused encoder (its custom VJP; bf16 within 2e-2, aocr
    keeping its split projections float32) and against the port's
    per-direction path (float32 1e-5, bf16 1e-2); the fused Function
    runs, on the features."""
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    tol = 1e-5 if dtype == "float32" else 2e-2
    pf, pb, feats, rc, rf = _encoder_problem(num_layers)

    def jloss(pf_, pb_, x):
        ctx, (c0, h0) = jenc.apply(pf_, pb_, x, compute_dtype=jd,
                                   fused_l0=True)
        return (jnp.sum(ctx.astype(jnp.float32) * rc) + jnp.sum(c0 * rf[0])
                + jnp.sum(h0 * rf[1])), (ctx, c0, h0)

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jax.tree.map(jnp.asarray, pf), jax.tree.map(jnp.asarray, pb),
        jnp.asarray(feats))

    calls = []
    real = lstm.BidirFn.apply
    monkeypatch.setattr(lstm.BidirFn, "apply",
                        lambda *a: calls.append(a[8].shape) or real(*a))

    def tgrads(fused):
        tf = weights.tree_map(pf, lambda _p, a: torch.from_numpy(
            np.array(a)).requires_grad_())
        tb = weights.tree_map(pb, lambda _p, a: torch.from_numpy(
            np.array(a)).requires_grad_())
        x = torch.from_numpy(feats).requires_grad_()
        ctx, (c0, h0) = encoder.apply(tf, tb, x, td, fused_l0=fused)
        loss = ((ctx.float() * torch.from_numpy(rc)).sum()
                + (c0 * torch.from_numpy(rf[0])).sum()
                + (h0 * torch.from_numpy(rf[1])).sum())
        leaves = optim.leaves(tf) + optim.leaves(tb) + [x]
        return (ctx, c0, h0), torch.autograd.grad(loss, leaves)

    out, g = tgrads(True)
    assert calls == [feats.shape]  # BidirFn ran, on the features
    close = lambda a, b: np.testing.assert_allclose(  # noqa: E731
        np.asarray(a, np.float32), np.asarray(b, np.float32), rtol=tol,
        atol=tol)
    for a, b in zip(out, jout):
        close(a.float().detach().numpy(), b.astype(jnp.float32))
    it = iter(g)
    gf, gb = (weights.tree_map(p, lambda _p, _a: next(it)) for p in (pf, pb))
    jax.tree.map(lambda a, b: close(a.float().numpy(), b), (gf, gb),
                 jgrads[:2])
    close(next(it).float().numpy(), jgrads[2])
    # the per-direction path: the split projections are stored in the
    # compute dtype on both (aocr's fused path keeps them float32)
    out0, g0 = tgrads(False)
    same = 1e-5 if dtype == "float32" else 1e-2
    for a, b in zip(out + g, out0 + g0):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(), rtol=same,
                                   atol=same / 10)
    # without autograd: the kernels' forward only, same outputs
    with torch.no_grad():
        tf, tb = (weights.tree_map(p, lambda _p, a: torch.tensor(a))
                  for p in (pf, pb))
        ctx, (c0, h0) = encoder.apply(tf, tb, torch.from_numpy(feats), td,
                                      fused_l0=True)
    for a, b in zip((ctx, c0, h0), out):
        assert torch.equal(a, b.detach())


def test_fused_projection_step_matches_reference():
    """-fused_encoder_proj through a whole float32 train step against
    aocr's step with the flag, and against the port's unfused step."""
    cfg, tcfg, params, stats, images, t, te = _problem(
        fused_encoder_proj=True)
    want = _jax_step(cfg, params, stats, images, t, te,
                     jax.random.PRNGKey(1))
    got = _port_step(tcfg, params, stats, images, t, te)
    _assert_step(got, want)
    _assert_step(got, _port_step(tcfg.replace(fused_encoder_proj=False),
                                 params, stats, images, t, te))
