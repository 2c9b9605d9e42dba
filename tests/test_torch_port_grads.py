"""aocr_torch's training gradients against jax.grad through the JAX package
on CPU, module by module.

The same seeded numpy inputs and cotangents go through the JAX function
-- its Pallas kernels in interpret mode, switched on with the package's
own flags -- and through the port, whose kernel wrappers run their plain
versions on CPU tensors.  Covered: conv1 + pool (the conv1_pool backward),
the LSTM scan (lstm_fwd with residuals + lstm_bwd), the teacher-forced
decoder (tf_fwd + tf_bwd), train-mode BatchNorm and the float32 bias
gradient, the loss, and the optimizers.

Tolerances: float32 within 1e-5 of the gradient's scale (the two sides
sum the same products in another order); bfloat16 within a few percent
of the scale, since the stored stacks round to bf16 and a rounding that
lands on the other side of a tie feeds every later step.
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aocr import loss as jloss
from aocr import optim as joptim
from aocr.models import cnn as jcnn
from aocr.models import decoder as jdec
from aocr.ops import lstm as jlstm
from aocr.ops.pallas import conv1_pool as jconv1
from aocr_torch import loss, optim, weights
from aocr_torch.models import cnn, decoder
from aocr_torch.ops import lstm

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32, grad=False):
    t = torch.from_numpy(np.array(a, np.float32)).to(dtype)
    return t.requires_grad_() if grad else t


def _close(got, want, tol, what=""):
    """|got - want| <= tol * max|want| (+ a floor for all-zero grads)."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = _np(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _word_like(rs, B, W):
    """Images of a few grey levels on white: many tied pool windows."""
    x = np.full((B, 32, W, 1), 255.0, np.float32)
    for img in x:
        for _ in range(4):
            c, w = rs.randint(0, W - 4), rs.randint(1, 4)
            img[rs.randint(2, 12):rs.randint(18, 30), c:c + w] = \
                rs.choice([0.0, 64.0, 128.0])
    return x


@pytest.mark.parametrize("dtype,images", [("float32", "noise"),
                                          ("bfloat16", "noise"),
                                          ("bfloat16", "ties")])
def test_conv1_pool_grads_match_kernel(dtype, images):
    """dW, db of conv1 + ReLU + pool: the TPU backward kernel (interpret)
    against the port's Conv1PoolFn (conv1_pool_bwd's plain version)."""
    jd, td = DT[dtype]
    rs = np.random.RandomState(40)
    B, W = 2, 36
    raw = (rs.uniform(0, 255, (B, 32, W, 1)).astype(np.float32)
           if images == "noise" else _word_like(rs, B, W))
    x = (raw - 128.0) / 128.0
    w = rs.uniform(-1 / 3, 1 / 3, (3, 3, 1, 64)).astype(np.float32)
    b = rs.uniform(-1 / 3, 1 / 3, (64,)).astype(np.float32)
    r = rs.uniform(-1, 1, (B, 16, W // 2, 64)).astype(np.float32)
    xj = jnp.asarray(x).astype(jd)
    assert jconv1.supported(xj.shape)
    dw_j, db_j = jax.grad(
        lambda w_, b_: jnp.sum(jconv1.conv1_relu_pool(xj, w_, b_, True)
                               .astype(jnp.float32)
                               * jnp.asarray(r).astype(jd)
                               .astype(jnp.float32)),
        argnums=(0, 1))(jnp.asarray(w), jnp.asarray(b))
    wt = _t(w.transpose(3, 2, 0, 1), grad=True)
    bt = _t(b, grad=True)
    y = cnn.Conv1PoolFn.apply(_t(x, td), wt, bt)
    dw, db = torch.autograd.grad(y, (wt, bt), _t(r, td))
    tol = 1e-5 if dtype == "float32" else 1e-2
    _close(dw, np.asarray(dw_j).transpose(3, 2, 0, 1), tol, "dw")
    _close(db, db_j, tol, "db")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_grads_match_kernels(monkeypatch, dtype, reverse):
    """Every gradient of one LSTM layer (dWi, dWh, dbi, dbh, dxs, dc0,
    dh0) through the reference's custom VJP with its lstm_fwd (collect)
    and lstm_bwd kernels in interpret mode, against ScanFn."""
    jd, td = DT[dtype]
    monkeypatch.setattr(jlstm, "_PALLAS_LSTM_FWD_INTERPRET", True)
    monkeypatch.setattr(jlstm, "_PALLAS_LSTM_BWD_INTERPRET", True)
    monkeypatch.setattr(jlstm, "_SCAN_VJP_CACHE", {})
    B, L, D, H = 3, 5, 16, 16
    rs = np.random.RandomState(41)
    layer = jax.tree.map(np.asarray, jlstm.init_lstm_layer(
        jax.random.PRNGKey(4), D, H))
    xs = rs.uniform(-1, 1, (B, L, D)).astype(np.float32)
    c0, h0 = (rs.uniform(-1, 1, (B, H)).astype(np.float32) for _ in "ch")
    r_hs = rs.uniform(-1, 1, (B, L, H)).astype(np.float32)
    r_c, r_h = (rs.uniform(-1, 1, (B, H)).astype(np.float32) for _ in "ch")

    def jloss_fn(layer_, xs_, c0_, h0_):
        hs, (cf, hf) = jlstm.unidirectional_scan(
            layer_, xs_, c0_, h0_, reverse=reverse, compute_dtype=jd)
        return (jnp.sum(hs.astype(jnp.float32)
                        * jnp.asarray(r_hs).astype(jd).astype(jnp.float32))
                + jnp.sum(cf * r_c) + jnp.sum(hf * r_h))

    want = jax.grad(jloss_fn, argnums=(0, 1, 2, 3))(
        jax.tree.map(jnp.asarray, layer), jnp.asarray(xs).astype(jd),
        jnp.asarray(c0), jnp.asarray(h0))
    tl = {k: _t(v, grad=True) for k, v in layer.items()}
    xt, c0t, h0t = _t(xs, td, True), _t(c0, grad=True), _t(h0, grad=True)
    hs, (cf, hf) = lstm.unidirectional_scan(tl, xt, c0t, h0t, reverse, td)
    out = (hs.float() * _t(r_hs, td).float()).sum() + (cf * _t(r_c)).sum() \
        + (hf * _t(r_h)).sum()
    got = torch.autograd.grad(out, (*tl.values(), xt, c0t, h0t))
    tol = TOL[dtype]
    for k, g in zip(tl, got):
        _close(g, want[0][k], tol, k)
    for g, w, k in zip(got[4:], want[1:], ("xs", "c0", "h0")):
        _close(g, w, tol, k)


def _decoder_problem(seed, input_feed, B=3, T=4, H=16, E=4, L=5, nl=2):
    rs = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, jdec.init_params(
        jax.random.PRNGKey(seed), 39, E, H, nl, input_feed))
    targets = rs.randint(1, 39, (B, T)).astype(np.int32)
    ctx = rs.uniform(-1, 1, (B, L, H)).astype(np.float32)
    c0, h0 = (rs.uniform(-1, 1, (B, H)).astype(np.float32) for _ in "ch")
    r = rs.uniform(-1, 1, (B, T, H)).astype(np.float32)
    return params, targets, ctx, c0, h0, r


def _decoder_grads(params, targets, ctx, c0, h0, r, jd, td, input_feed,
                   custom):
    def jfn(p, ctx_, c0_, h0_):
        hs = jdec.teacher_forced(p, (c0_, h0_), jnp.asarray(targets), ctx_,
                                 input_feed=input_feed, compute_dtype=jd,
                                 custom_grad=custom)
        return jnp.sum(hs * r)

    want = jax.grad(jfn, argnums=(0, 1, 2, 3))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(ctx).astype(jd),
        jnp.asarray(c0), jnp.asarray(h0))
    tp = weights.tree_map(params, lambda _p, a: _t(a, grad=True))
    ctxt, c0t, h0t = _t(ctx, td, True), _t(c0, grad=True), _t(h0, grad=True)
    hs = decoder.teacher_forced(tp, (c0t, h0t), torch.from_numpy(targets),
                                ctxt, input_feed=input_feed,
                                compute_dtype=td, custom_grad=custom)
    named = _named(tp)
    got = torch.autograd.grad((hs * _t(r)).sum(),
                              (*named.values(), ctxt, c0t, h0t))
    want_named = _named(want[0])
    return ([(g, want_named[n], n) for n, g in zip(named, got)]
            + list(zip(got[len(named):], want[1:], ("ctx", "c0", "h0"))))


def _named(tree) -> dict:
    """{"layers/0/wi": leaf, ...} of a params tree."""
    out = {}
    weights.tree_map(tree, lambda p, x: out.__setitem__(
        "/".join(map(str, p)), x))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("input_feed", [True, False])
def test_teacher_forced_grads_match_kernels(monkeypatch, dtype, input_feed):
    """Every decoder gradient (embedding, all layers, W_a, W_c, context,
    c0, h0) through the reference's custom VJP with tf_fwd and tf_bwd in
    interpret mode, against TFCoreFn and the hoisted projection."""
    jd, td = DT[dtype]
    monkeypatch.setattr(jdec, "_PALLAS_TF_FWD_INTERPRET", True)
    monkeypatch.setattr(jdec, "_PALLAS_TF_BWD_INTERPRET", True)
    monkeypatch.setattr(jdec, "_TF_VJP_CACHE", {})
    prob = _decoder_problem(42, input_feed)
    for got, want, name in _decoder_grads(*prob, jd, td, input_feed, True):
        _close(got, want, TOL[dtype], name)


def test_teacher_forced_plain_autograd_matches_reference():
    """decoder_custom_vjp=False: plain autograd over the per-step decoder
    against the reference's plain autodiff scan (float32)."""
    prob = _decoder_problem(43, True)
    for got, want, name in _decoder_grads(*prob, jnp.float32, torch.float32,
                                          True, False):
        _close(got, want, 1e-5, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_train_and_bias_grads_match_reference(dtype):
    """Train-mode BN forward, running statistics (unbiased variance) and
    closed-form backward, and the float32 bias gradient, against
    cnn._batch_norm / _bn_train_cvjp / _bias_add (NHWC there, NCHW here)."""
    jd, td = DT[dtype]
    rs = np.random.RandomState(44)
    x = rs.normal(0.3, 1.5, (4, 3, 5, 8)).astype(np.float32)  # NHWC
    scale = rs.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rs.uniform(-0.2, 0.2, 8).astype(np.float32)
    bconv = rs.uniform(-0.2, 0.2, 8).astype(np.float32)
    stats = {"mean": rs.uniform(-0.1, 0.1, 8).astype(np.float32),
             "var": rs.uniform(0.5, 2, 8).astype(np.float32)}
    r, r2 = (rs.uniform(-1, 1, x.shape).astype(np.float32) for _ in "ab")
    # the loss also reads the biased activation itself: through BN alone
    # the conv bias's gradient is zero up to rounding
    dot = lambda a, c: jnp.sum(a.astype(jnp.float32)
                               * jnp.asarray(c).astype(jd).astype(jnp.float32))

    def jfn(x_, s_, b_, bc_):
        xb = jcnn._bias_add(x_, bc_)
        y, new = jcnn._batch_norm(xb, {"scale": s_, "bias": b_},
                                  jax.tree.map(jnp.asarray, stats), True)
        return dot(y, r) + dot(xb, r2), (y, new)

    (_, (y_j, new_j)), g_j = jax.value_and_grad(
        jfn, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x).astype(jd), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(bconv))
    nchw = lambda a: a.transpose(0, 3, 1, 2)
    xt = _t(nchw(x), td, True)
    st, bt, bct = _t(scale, grad=True), _t(bias, grad=True), \
        _t(bconv, grad=True)
    xb = cnn.BiasAddFn.apply(xt, bct)
    y, new = cnn._bn_train(xb, {"scale": st, "bias": bt},
                           {k: _t(v) for k, v in stats.items()})
    tdot = lambda a, c: (a.float() * _t(nchw(c), td).float()).sum()
    got = torch.autograd.grad(tdot(y, r) + tdot(xb, r2), (xt, st, bt, bct))
    tol = TOL[dtype]
    _close(y, nchw(_np(y_j)), tol, "y")
    for k in ("mean", "var"):
        _close(new[k], new_j[k], 1e-5, k)
    _close(got[0], nchw(_np(g_j[0])), tol, "dx")
    for g, w, k in zip(got[1:], g_j[1:], ("dscale", "dbias", "dbias_conv")):
        _close(g, w, tol, k)


def test_nll_and_gold_scores_match_reference():
    rs = np.random.RandomState(45)
    logits = rs.normal(0, 2, (3, 6, 39)).astype(np.float32)
    lp = _np(jax.nn.log_softmax(jnp.asarray(logits), -1))
    te = rs.randint(1, 39, (3, 6)).astype(np.int32)
    te[0, 4:] = 0  # PAD targets weigh 0
    te[2, 1:] = 0
    np.testing.assert_allclose(
        loss.gold_scores(_t(lp), torch.from_numpy(te)).numpy(),
        _np(jloss.gold_scores(jnp.asarray(lp), jnp.asarray(te))), rtol=1e-6)
    np.testing.assert_allclose(
        float(loss.nll_sum(_t(lp), torch.from_numpy(te))),
        float(jloss.nll_sum(jnp.asarray(lp), jnp.asarray(te))), rtol=1e-6)


def _opt_problem(seed):
    rs = np.random.RandomState(seed)

    def tree(k_cnn, k):
        a = lambda k_, *s: rs.normal(0, k_, s).astype(np.float32)
        layer = lambda: {"layers": [{"wi": a(k, 3, 8), "bi": a(k, 8)}]}
        return {"cnn": {"conv1": {"w": a(k_cnn, 3, 3, 1, 4),
                                  "b": a(k_cnn, 4)}},
                "encoder_fw": layer(), "encoder_bw": layer(),
                "decoder": {"w_a": a(k, 4, 4), "w_c": a(k, 8, 4)},
                "projector": {"w": a(k, 4, 5), "b": a(k, 5)}}

    # three steps of gradients; the cnn group's norm exceeds the clip
    return tree(0.5, 0.5), [tree(4.0, 0.3) for _ in range(3)]


OPT_CASES = {
    "plain": dict(),
    "momentum": dict(momentum=0.9),
    "nesterov_decay": dict(momentum=0.8, dampening=0.0, nesterov=True,
                           weight_decay=1e-3, sgd_learning_rate_decay=0.1),
    "dampening": dict(momentum=0.5, dampening=0.3),
}


@pytest.mark.parametrize("case", [*OPT_CASES, "adadelta"])
def test_optimizers_match_reference(case):
    """Three updates with per-group clipping: SGD (momentum, dampening,
    nesterov, weight decay, lr decay) and Adadelta against aocr.optim;
    the state crosses to the reference and back through the bridge
    before the last step (a resume), buf_fresh included."""
    from aocr.config import Config

    from aocr_torch.config import Config as TConfig

    params, grads = _opt_problem(46)
    j_params = jax.tree.map(jnp.asarray, params)
    t_params, _ = weights.from_numpy(params, {})
    if case == "adadelta":
        j_state, t_state = joptim.adadelta_init(j_params), \
            optim.adadelta_init(t_params)
        j_upd = lambda p, g, s: joptim.adadelta_update(p, g, s,
                                                       weight_decay=1e-3)
        t_upd = lambda p, g, s: optim.adadelta_update(p, g, s,
                                                      weight_decay=1e-3)
    else:
        jh = joptim.hyper_from_config(Config(**OPT_CASES[case]).validate())
        th = optim.hyper_from_config(TConfig(**OPT_CASES[case]).validate())
        assert tuple(jh) == tuple(th)
        j_state, t_state = joptim.sgd_init(j_params, jh), \
            optim.sgd_init(t_params, th)
        j_upd = lambda p, g, s: joptim.sgd_update(p, g, s, 0.1, jh)
        t_upd = lambda p, g, s: optim.sgd_update(p, g, s, 0.1, th)
    for k, g in enumerate(grads):
        if k == 2:  # resume the port from the reference's state
            t_state = weights.opt_state_from_numpy(
                jax.tree.map(np.asarray, j_state))
            back = weights.opt_state_to_numpy(t_state)
            jax.tree.map(np.testing.assert_array_equal,
                         jax.tree.map(np.asarray, j_state._asdict()), back)
        j_params, j_state, j_norms = j_upd(
            j_params, jax.tree.map(jnp.asarray, g), j_state)
        t_params, t_state, t_norms = t_upd(
            t_params, weights.from_numpy(g, {})[0], t_state)
        for grp in j_norms:
            np.testing.assert_allclose(float(t_norms[grp]),
                                       float(j_norms[grp]), rtol=1e-6)
        got, _ = weights.to_numpy(t_params, {})
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), rtol=1e-6, atol=1e-7), got, j_params)
