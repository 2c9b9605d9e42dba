"""aocr_torch's training step, eval step and scoring against the JAX
package on CPU.

One `make_train_step` step of both packages from the same params, batch
stats, optimizer state and batch: the JAX step runs every Pallas kernel
of its default custom-VJP route in interpret mode (conv1, the encoder's
lstm_fwd/lstm_bwd, the decoder's tf_fwd/tf_bwd), the port runs their
plain versions on CPU tensors.

Tolerances: float32 loss_sum within 1e-5 relative, each group's grad
norm within 1e-4 relative, updated params and batch stats within 1e-5
absolute; bfloat16 1e-3 on the loss and 5e-3 on norms, params and stats
(the stored stacks round to bf16 on both sides, not always at the same
side of a tie).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aocr import optim as joptim
from aocr import train_step as jts
from aocr import vocab
from aocr.api import AttentionOCR as JaxOCR
from aocr.config import Config
from aocr.models import cnn as jcnn
from aocr.models import decoder as jdec
from aocr.models import model as jmodel
from aocr.ops import lstm as jlstm
from aocr_torch import augment, optim, train_step, weights
from aocr_torch.api import AttentionOCR
from aocr_torch.config import Config as TConfig
from aocr_torch.models import cnn

WORDS = ["ab1", "xyz", "k", "wxyz"]
TOLS = {"float32": (1e-5, 1e-4, 1e-5), "bfloat16": (1e-3, 5e-3, 5e-3)}


@pytest.fixture
def jax_kernels(monkeypatch):
    """Every Pallas kernel of the reference's train step, in interpret
    mode (the package's own switches)."""
    monkeypatch.setattr(jcnn, "_PALLAS_CONV1_INTERPRET", True)
    monkeypatch.setattr(jlstm, "_PALLAS_LSTM_FWD_INTERPRET", True)
    monkeypatch.setattr(jlstm, "_PALLAS_LSTM_BWD_INTERPRET", True)
    monkeypatch.setattr(jlstm, "_SCAN_VJP_CACHE", {})
    monkeypatch.setattr(jdec, "_PALLAS_TF_FWD_INTERPRET", True)
    monkeypatch.setattr(jdec, "_PALLAS_TF_BWD_INTERPRET", True)
    monkeypatch.setattr(jdec, "_TF_VJP_CACHE", {})


def _kw(**kw):
    return dict(input_feed=True, encoder_num_hidden=16,
                target_embedding_size=8, batch_size=len(WORDS), **kw)


def _cfg(**kw):
    """The reference's Config."""
    return Config(**_kw(**kw)).validate()


def _tcfg(**kw):
    """The port's Config, from the same arguments as _cfg's."""
    return TConfig(**_kw(**kw)).validate()


def _problem(cfg, seed=0):
    ms = jmodel.init(jax.random.PRNGKey(seed), cfg)
    images = np.random.RandomState(seed).uniform(
        0, 255, (len(WORDS), 32, 36, 1)).astype(np.float32)
    targets, targets_eval, _ = vocab.encode_batch(WORDS)
    return (jax.tree.map(np.asarray, ms.params),
            jax.tree.map(np.asarray, ms.batch_stats), images, targets,
            targets_eval)


def _assert_step(got, want, tols):
    loss_tol, norm_tol, param_tol = tols
    np.testing.assert_allclose(float(got.loss_sum), float(want.loss_sum),
                               rtol=loss_tol)
    for g in want.grad_norms:
        np.testing.assert_allclose(float(got.grad_norms[g]),
                                   float(want.grad_norms[g]), rtol=norm_tol,
                                   err_msg=g)
    gp, gs = weights.to_numpy(got.params, got.batch_stats)
    check = lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=0, atol=param_tol)
    jax.tree.map(check, gp, want.params)
    jax.tree.map(check, gs, want.batch_stats)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_reference(jax_kernels, dtype):
    cfg, tcfg = _cfg(compute_dtype=dtype), _tcfg(compute_dtype=dtype)
    params, stats, images, t, te = _problem(cfg)
    want = jts.make_train_step(cfg)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        joptim.sgd_init(params), jnp.asarray(images), jnp.asarray(t),
        jnp.asarray(te), jnp.float32(0.1), jax.random.PRNGKey(1))
    tp, ts = weights.from_numpy(params, stats)
    got = train_step.make_train_step(tcfg)(
        tp, ts, train_step.init_opt_state(tp, tcfg), images, t, te, 0.1,
        None)
    _assert_step(got, want, TOLS[dtype])
    # a step leaves its inputs as they were
    np.testing.assert_array_equal(
        weights.to_numpy(tp, ts)[0]["decoder"]["w_a"],
        params["decoder"]["w_a"])


def test_momentum_training_resumes_across_packages():
    """Nesterov SGD, float32, two steps: the port's step 1, then the
    reference's step 2 from the port's params and optimizer state (the
    bridge), against the reference's two steps; and the other way round
    for step 2 on the port.  Step-2 params within 1e-4 from the same
    step-1 state: the nesterov update (1+m)g + m^2 buf is ~2.7x the plain
    step, so the gradients' summation-order rounding shows at that scale;
    within 1e-3 from the other package's step-1 state, whose rounding
    train-mode BN over few positions (32 at conv7) amplifies in the deep
    conv weights."""
    kw = dict(momentum=0.9, dampening=0.0, nesterov=True,
              sgd_learning_rate_decay=0.5, weight_decay=1e-4)
    cfg, tcfg = _cfg(**kw), _tcfg(**kw)
    params, stats, images, t, te = _problem(cfg, seed=2)
    jstep = jts.make_train_step(cfg)
    tstep = train_step.make_train_step(tcfg)
    jargs = (jnp.asarray(images), jnp.asarray(t), jnp.asarray(te),
             jnp.float32(0.1), jax.random.PRNGKey(0))
    hyper = joptim.hyper_from_config(cfg)
    j1 = jstep(jax.tree.map(jnp.asarray, params),
               jax.tree.map(jnp.asarray, stats),
               joptim.sgd_init(params, hyper), *jargs)
    j2 = jstep(j1.params, j1.batch_stats, j1.opt_state, *jargs)
    tp, ts = weights.from_numpy(params, stats)
    t1 = tstep(tp, ts, train_step.init_opt_state(tp, tcfg), images, t, te,
               0.1)
    _assert_step(t1, j1, TOLS["float32"])
    # the port's state into the reference, one more step there
    p1, s1 = weights.to_numpy(t1.params, t1.batch_stats)
    o1 = joptim.SGDState(**jax.tree.map(
        jnp.asarray, weights.opt_state_to_numpy(t1.opt_state)))
    assert not bool(o1.buf_fresh) and int(o1.eval_counter) == 1
    j2b = jstep(jax.tree.map(jnp.asarray, p1), jax.tree.map(jnp.asarray, s1),
                o1, *jargs)
    # the reference's state into the port, one more step here
    t2 = tstep(*weights.from_numpy(jax.tree.map(np.asarray, j1.params),
                                   jax.tree.map(np.asarray, j1.batch_stats)),
               weights.opt_state_from_numpy(jax.tree.map(np.asarray,
                                                         j1.opt_state)),
               images, t, te, 0.1)
    _assert_step(t2, j2, TOLS["float32"][:2] + (1e-4,))
    np.testing.assert_allclose(float(j2b.loss_sum), float(j2.loss_sum),
                               rtol=1e-5)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-4), j2b.grad_norms,
        j2.grad_norms)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=0, atol=1e-3), j2b.params,
        j2.params)


def test_adadelta_train_step_matches_reference():
    """cfg.optimizer="adadelta" through the whole step (float32, the
    reference's XLA route)."""
    kw = dict(optimizer="adadelta", weight_decay=1e-4)
    cfg, tcfg = _cfg(**kw), _tcfg(**kw)
    params, stats, images, t, te = _problem(cfg, seed=5)
    want = jts.make_train_step(cfg)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        joptim.adadelta_init(jax.tree.map(jnp.asarray, params)),
        jnp.asarray(images), jnp.asarray(t), jnp.asarray(te),
        jnp.float32(0.1), jax.random.PRNGKey(1))
    tp, ts = weights.from_numpy(params, stats)
    got = train_step.make_train_step(tcfg)(
        tp, ts, train_step.init_opt_state(tp, tcfg), images, t, te, 0.1)
    assert isinstance(got.opt_state, optim.AdadeltaState)
    _assert_step(got, want, TOLS["float32"])
    back = weights.opt_state_to_numpy(got.opt_state)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=1e-4, atol=1e-10), back,
        want.opt_state._asdict())


def test_eval_loss_step_matches_reference(jax_kernels):
    cfg = _cfg()
    params, stats, images, t, te = _problem(cfg, seed=3)
    nll_j, gold_j = jts.eval_loss_step(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        jnp.asarray(images), jnp.asarray(t), jnp.asarray(te), cfg)
    nll, gold = train_step.eval_loss_step(*weights.from_numpy(params, stats),
                                          images, t, te, _tcfg())
    np.testing.assert_allclose(float(nll), float(nll_j), rtol=1e-5)
    np.testing.assert_allclose(gold.numpy(), np.asarray(gold_j), rtol=1e-5)


def test_score_matches_reference():
    """AttentionOCR.score on mixed widths, input order kept."""
    cfg = _cfg()
    jocr = JaxOCR.create(cfg)
    rs = np.random.RandomState(4)
    images = [rs.uniform(0, 255, (32, w)).astype(np.float32)
              for w in (36, 100, 36, 81)]
    want = jocr.score(images, WORDS)
    ocr = AttentionOCR(_tcfg(), *weights.from_numpy(
        jax.tree.map(np.asarray, jocr.params),
        jax.tree.map(np.asarray, jocr.batch_stats)), device="cpu")
    np.testing.assert_allclose(ocr.score(images, WORDS), want, rtol=1e-5)
    with pytest.raises(ValueError, match="transcripts"):
        ocr.score(images, WORDS[:2])


@pytest.mark.parametrize("what", ["dropout", "remat", "simple_attention",
                                  "augment"])
def test_unported_training_options_raise(what):
    """Dropout, remat and simple attention in training name their ROADMAP
    item; -augment, once refused too, now runs: under a step key the
    augmented step's loss is finite, differs from the plain step's, and
    repeats for the same key."""
    cfg = _tcfg(**{what: 0.1 if what == "dropout" else True})
    tp, ts = weights.from_numpy(*_problem(_cfg())[:2])
    images, t, te = _problem(_cfg())[2:]
    step = lambda c, key: train_step.make_train_step(c)(  # noqa: E731
        tp, ts, optim.sgd_init(tp), images, t, te, 0.1, key)
    if what != "augment":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            step(cfg, None)
        return
    key = augment.step_key(cfg.seed, 4)
    loss = float(step(cfg, key).loss_sum)
    assert np.isfinite(loss)
    assert loss != float(step(cfg.replace(augment=False), key).loss_sum)
    assert loss == float(step(cfg, key).loss_sum)


def test_image_gradient_of_conv1_raises():
    """The conv1 image cotangent (the TPU's _dx_kernel) no longer raises:
    d(features)/d(images) through cnn.apply(train=True) on the kernel
    route (Conv1PoolFn's conv1_pool_dx, ReluPoolFn's pool_bwd) equals
    plain autograd over F.conv2d, torch.relu and F.max_pool2d
    (use_kernel=False), float32, within 1e-5 of the gradient's scale."""
    tp, ts = weights.from_numpy(*_problem(_cfg())[:2])
    rs = np.random.RandomState(71)
    images = rs.uniform(0, 255, (3, 32, 36, 1)).astype(np.float32)
    r = torch.from_numpy(rs.uniform(-1, 1, (3, 8, 512)).astype(np.float32))
    grads = []
    for kernel in (True, False):
        im = torch.from_numpy(images).requires_grad_()
        feats, _ = cnn.apply(tp["cnn"], ts, im, use_kernel=kernel,
                             train=True)
        grads.append(torch.autograd.grad((feats * r).sum(), im)[0])
    scale = float(grads[1].abs().max())
    assert scale > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=0,
                               atol=1e-5 * scale)


def test_masked_and_synced_batchnorm_raise():
    """Sync-BN, once refused, runs: over a process group of one (gloo, an
    in-memory store) cnn.apply(train=True, group=...) gives the features,
    the new running statistics and the weight gradients of the
    unsynchronized BN bit for bit, unmasked and with the row mask of a
    padded batch (tests/test_torch_port_parallel.py holds two ranks
    against the one-process BN and aocr's data-parallel step)."""
    import torch.distributed as dist

    tp, ts = weights.from_numpy(*_problem(_cfg())[:2])
    images = torch.from_numpy(np.random.RandomState(9).uniform(
        0, 255, (2, 32, 36, 1)).astype(np.float32))
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        for mask in (None, torch.tensor([1.0, 0.0])):
            outs = []
            for group in (None, dist.group.WORLD):
                leaves = [x.detach().requires_grad_()
                          for x in optim.leaves(tp["cnn"])]
                it = iter(leaves)
                p = weights.tree_map(tp["cnn"], lambda _p, _x: next(it))
                feats, stats = cnn.apply(p, ts, images, train=True,
                                         row_mask=mask, group=group)
                grads = torch.autograd.grad(feats.square().sum(), leaves)
                outs.append((feats, optim.leaves(stats), grads))
            (f0, s0, g0), (f1, s1, g1) = outs
            assert bool(torch.isfinite(f0).all())
            assert torch.equal(f0, f1)
            assert all(torch.equal(a, b) for a, b in zip(s0, s1))
            assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    finally:
        dist.destroy_process_group()
