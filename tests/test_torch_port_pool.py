"""aocr_torch's two last kernels against the JAX package on CPU: the
fused ReLU + max-pool backward (`pool_bwd`, `ReluPoolFn`) and conv1's
image cotangent (`conv1_pool_dx`, through `Conv1PoolFn`).

The same seeded numpy inputs go through `aocr`'s Pallas kernels in
interpret mode (switched on with the package's own flags) and through the
port, whose kernel wrappers run their plain versions on CPU tensors.

Tolerances: the pool backward is bit-identical in float32 and bfloat16,
ties and all-zero windows included; the conv1 image cotangent as
test_torch_port_grads.py holds conv1's dW and db (1e-5 of the gradient's
scale in float32, 1e-2 in bfloat16); one whole train step with the pool
kernel on in both packages as test_torch_port_train.py holds the step.
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from aocr import optim as joptim
from aocr import train_step as jts
from aocr import vocab
from aocr.config import Config
from aocr.models import cnn as jcnn
from aocr.models import decoder as jdec
from aocr.models import model as jmodel
from aocr.ops import lstm as jlstm
from aocr.ops.pallas import conv1_pool as jconv1
from aocr.ops.pallas import pool_bwd as jpool
from aocr_torch import train_step, weights
from aocr_torch.config import Config as TConfig
from aocr_torch.models import cnn
from aocr_torch.ops.cuda import pool_bwd

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (B, C, H, W) and the window: the three pool shapes of the CNN, cut down
SHAPES = [((3, 8, 8, 12), (2, 2)), ((3, 16, 4, 5), (2, 1)),
          ((2, 8, 2, 7), (2, 1))]


def _quantized(rs, shape):
    """Signed multiples of 0.5: exact ties inside windows, exact zeros
    after the ReLU and all-negative windows."""
    return rs.randint(-2, 3, size=shape).astype(np.float32) * 0.5


def _nhwc(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 3, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,window", SHAPES)
def test_pool_bwd_plain_matches_kernel(dtype, shape, window):
    """The plain version against aocr's relu_pool_bwd kernel in interpret
    mode, bit for bit."""
    jd, td = DT[dtype]
    rs = np.random.RandomState(50 + shape[3])
    y = np.maximum(_quantized(rs, shape), 0.0)
    B, C, H, W = shape
    dy = rs.uniform(-1, 1, (B, C, H // window[0], W // window[1])
                    ).astype(np.float32)
    want = jpool.relu_pool_bwd(jnp.asarray(_nhwc(y)).astype(jd),
                               jnp.asarray(_nhwc(dy)).astype(jd), window,
                               interpret=True)
    got = pool_bwd.relu_pool_bwd(torch.from_numpy(y).to(td),
                                 torch.from_numpy(dy).to(td), window)
    assert got.dtype == td and got.shape == shape
    np.testing.assert_array_equal(
        _nhwc(got.float().numpy()),
        np.asarray(jnp.asarray(want, jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,window", SHAPES)
def test_relu_pool_fn_matches_autograd(dtype, shape, window):
    """ReluPoolFn's output and gradient against autograd of F.max_pool2d
    over torch.relu, bit for bit, in channels_last memory as convs 2-7
    leave the activations."""
    td = DT[dtype][1]
    rs = np.random.RandomState(60 + shape[3])
    z = torch.from_numpy(_quantized(rs, shape)).to(td).contiguous(
        memory_format=torch.channels_last)
    r = torch.from_numpy(rs.uniform(-1, 1, shape).astype(np.float32))
    outs = []
    for fused in (True, False):
        zz = z.detach().clone().requires_grad_()
        y = (cnn.ReluPoolFn.apply(zz, window) if fused
             else F.max_pool2d(torch.relu(zz), window))
        dy = r[:, :, :y.shape[2], :y.shape[3]].to(td)
        (g,) = torch.autograd.grad(y, zz, dy)
        outs.append((y, g))
    (y, g), (y_ref, g_ref) = outs
    assert torch.equal(y, y_ref)
    assert torch.equal(g, g_ref)


@pytest.mark.parametrize("shape,window", [
    ((2, 8, 16, 50), (2, 2)), ((2, 8, 16, 51), (2, 2)),
    ((2, 8, 8, 25), (2, 1)), ((2, 8, 5, 25), (2, 1)),
    ((2, 8, 4, 1), (2, 1)), ((2, 8, 3, 3), (2, 2))])
def test_supported_gate_matches_aocr(shape, window):
    B, C, H, W = shape
    assert pool_bwd.supported(shape, window) == \
        jpool.supported((B, H, W, C), window)


def _x_w_b(rs, B, W, ties):
    raw = rs.uniform(0, 255, (B, 32, W, 1)).astype(np.float32)
    if ties:  # a few grey levels: many tied pool windows
        raw = np.round(raw / 64.0) * 64.0
    x = (raw - 128.0) / 128.0
    w = rs.uniform(-1 / 3, 1 / 3, (3, 3, 1, 64)).astype(np.float32)
    b = rs.uniform(-1 / 3, 1 / 3, (64,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("dtype,ties", [("float32", False),
                                        ("bfloat16", False),
                                        ("bfloat16", True)])
def test_conv1_image_cotangent_matches_jax(dtype, ties):
    """jax.grad with respect to x of aocr's conv1_relu_pool (its _dx_kernel
    in interpret mode) against Conv1PoolFn's image cotangent
    (conv1_pool_dx's plain version)."""
    jd, td = DT[dtype]
    rs = np.random.RandomState(70 + ties)
    B, W = 2, 36
    x, w, b = _x_w_b(rs, B, W, ties)
    r = rs.uniform(-1, 1, (B, 16, W // 2, 64)).astype(np.float32)
    xj = jnp.asarray(x).astype(jd)
    assert jconv1.supported(xj.shape)
    want = jax.grad(
        lambda x_: jnp.sum(jconv1.conv1_relu_pool(x_, jnp.asarray(w),
                                                  jnp.asarray(b), True)
                           .astype(jnp.float32)
                           * jnp.asarray(r).astype(jd).astype(jnp.float32))
    )(xj)
    xt = torch.from_numpy(x).to(td).requires_grad_()
    y = cnn.Conv1PoolFn.apply(xt, torch.from_numpy(w.transpose(3, 2, 0, 1)
                                                   .copy()),
                              torch.from_numpy(b))
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(r).to(td))
    assert got.dtype == td and got.shape == xt.shape
    want = np.asarray(jnp.asarray(want, jnp.float32))
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.fixture
def jax_kernels(monkeypatch):
    """Every Pallas kernel of the reference's train step in interpret
    mode, the pool backward switched on (ENABLE) as the port has it."""
    monkeypatch.setattr(jpool, "ENABLE", True)
    monkeypatch.setattr(jcnn, "_PALLAS_POOL_BWD_INTERPRET", True)
    monkeypatch.setattr(jcnn, "_PALLAS_CONV1_INTERPRET", True)
    monkeypatch.setattr(jlstm, "_PALLAS_LSTM_FWD_INTERPRET", True)
    monkeypatch.setattr(jlstm, "_PALLAS_LSTM_BWD_INTERPRET", True)
    monkeypatch.setattr(jlstm, "_SCAN_VJP_CACHE", {})
    monkeypatch.setattr(jdec, "_PALLAS_TF_FWD_INTERPRET", True)
    monkeypatch.setattr(jdec, "_PALLAS_TF_BWD_INTERPRET", True)
    monkeypatch.setattr(jdec, "_TF_VJP_CACHE", {})


WORDS = ["ab1", "xyz", "k", "wxyz"]


@pytest.mark.parametrize("width,ragged", [(36, 0), (38, 1)])
def test_train_step_with_pool_kernel_matches_reference(monkeypatch,
                                                       jax_kernels, width,
                                                       ragged):
    """One float32 make_train_step step with the pool backward on in both
    packages.  At W=36 every pool after conv2/4/6 takes the fused
    backward; at W=38 the pool after conv2 is ragged (16 x 19) and takes
    autograd in both, which the port counts.  Tolerances as
    test_torch_port_train.py's."""
    kw = dict(input_feed=True, encoder_num_hidden=16, target_embedding_size=8,
              batch_size=len(WORDS))
    cfg, tcfg = Config(**kw).validate(), TConfig(**kw).validate()
    ms = jmodel.init(jax.random.PRNGKey(0), cfg)
    params = jax.tree.map(np.asarray, ms.params)
    stats = jax.tree.map(np.asarray, ms.batch_stats)
    images = np.random.RandomState(0).uniform(
        0, 255, (len(WORDS), 32, width, 1)).astype(np.float32)
    t, te, _ = vocab.encode_batch(WORDS)
    want = jts.make_train_step(cfg)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        joptim.sgd_init(params), jnp.asarray(images), jnp.asarray(t),
        jnp.asarray(te), jnp.float32(0.1), jax.random.PRNGKey(1))
    calls = []
    plain = pool_bwd.relu_pool_bwd

    def counted(*a):
        calls.append(tuple(a[0].shape))
        return plain(*a)

    monkeypatch.setattr(pool_bwd, "relu_pool_bwd", counted)
    monkeypatch.setattr(pool_bwd, "launches_ragged", 0)
    tp, ts = weights.from_numpy(params, stats)
    got = train_step.make_train_step(tcfg)(
        tp, ts, train_step.init_opt_state(tp, tcfg), images, t, te, 0.1)
    assert len(calls) == 3 - ragged and pool_bwd.launches_ragged == ragged
    np.testing.assert_allclose(float(got.loss_sum), float(want.loss_sum),
                               rtol=1e-5)
    for g in want.grad_norms:
        np.testing.assert_allclose(float(got.grad_norms[g]),
                                   float(want.grad_norms[g]), rtol=1e-4)
    gp, gs = weights.to_numpy(got.params, got.batch_stats)
    check = lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                                    atol=1e-5)
    jax.tree.map(check, gp, want.params)
    jax.tree.map(check, gs, want.batch_stats)
