"""aocr_torch CNN and conv1 kernel against the JAX reference on CPU.

The same numpy inputs (seeded) go through the JAX function -- its Pallas
conv1 kernel in interpret mode, or its XLA route -- and through the
port, whose `conv1_pool` wrapper runs its plain version on CPU tensors.

Tolerances: float32 within 1e-5 relative (the two sides sum the same
products in another order); bfloat16 within one bf16 step (2**-8
relative) per rounding that can land on the other side of a tie, which
for conv1 is one rounding and for the 7-conv stack a few percent of the
feature scale.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aocr.models import cnn as jcnn
from aocr.ops.pallas import conv1_pool as jconv1
from aocr_torch import weights
from aocr_torch.models import cnn
from aocr_torch.ops.cuda import conv1_pool

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _params(seed):
    """Reference CNN params + batch stats as numpy, with random BN
    statistics so the eval affine is exercised."""
    rs = np.random.RandomState(seed)
    p = jax.tree.map(np.asarray, jcnn.init_params(jax.random.PRNGKey(seed)))
    s = jax.tree.map(np.asarray, jcnn.init_batch_stats())
    for k in s:
        c = s[k]["mean"].shape[0]
        p[k] = {"scale": rs.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": rs.uniform(-0.2, 0.2, c).astype(np.float32)}
        s[k] = {"mean": rs.uniform(-0.3, 0.3, c).astype(np.float32),
                "var": rs.uniform(0.5, 2.0, c).astype(np.float32)}
    return p, s


def _port(p, s):
    tp, ts = weights.from_numpy({"cnn": p}, s)
    return tp["cnn"], ts


def _images(seed, B, W):
    rs = np.random.RandomState(seed)
    return rs.uniform(0, 255, (B, 32, W, 1)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,W", [(1, 32), (5, 100), (5, 81)])
def test_conv1_relu_pool_matches_reference(dtype, B, W):
    jd, td = DT[dtype]
    p, s = _params(1)
    tp, _ = _port(p, s)
    x = ((_images(2, B, W) - 128.0) / 128.0)
    xj = jnp.asarray(x).astype(jd)
    w, b = jnp.asarray(p["conv1"]["w"]), jnp.asarray(p["conv1"]["b"])
    if jconv1.supported(xj.shape):
        want = jconv1.conv1_relu_pool(xj, w, b, True)  # interpret mode
    else:  # odd width: the reference's XLA conv + bias + relu + pool
        y = jax.lax.conv_general_dilated(
            xj, w.astype(jd), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32).astype(jd) + b.astype(jd)
        want = jcnn._max_pool(jax.nn.relu(y), (2, 2))
    got = conv1_pool.conv1_relu_pool(torch.from_numpy(x).to(td),
                                     tp["conv1"]["w"], tp["conv1"]["b"])
    assert tuple(got.shape) == (B, 16, W // 2, 64) and got.dtype == td
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,W", [(1, 32), (5, 100), (5, 81)])
@pytest.mark.parametrize("jax_kernel", [True, False])
def test_cnn_apply_matches_reference(monkeypatch, dtype, B, W, jax_kernel):
    jd, td = DT[dtype]
    p, s = _params(3)
    tp, ts = _port(p, s)
    images = _images(4, B, W)
    monkeypatch.setattr(jcnn, "_PALLAS_CONV1_INTERPRET", jax_kernel)
    want, _ = jcnn.apply(jax.tree.map(jnp.asarray, p),
                         jax.tree.map(jnp.asarray, s), jnp.asarray(images),
                         train=False, compute_dtype=jd)
    got = cnn.apply(tp, ts, torch.from_numpy(images), td)
    assert tuple(got.shape) == (B, cnn.output_length(W), 512)
    want = _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=4e-2 * scale)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_cnn_routes_agree(use_kernel):
    """The conv1 wrapper and the generic conv path give the same features
    (float32), so use_pallas=False is the same model."""
    p, s = _params(5)
    tp, ts = _port(p, s)
    images = torch.from_numpy(_images(6, 3, 100))
    a = cnn.apply(tp, ts, images, torch.float32, use_kernel=use_kernel)
    b = cnn.apply(tp, ts, images, torch.float32, use_kernel=not use_kernel)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("W", [32, 36, 81, 100, 121, 181, 271])
def test_output_length_matches_reference(W):
    assert cnn.output_length(W) == jcnn.output_length(W)
    assert cnn.num_params() == jcnn.num_params()


def test_conv1_wrapper_rejects_other_devices():
    x = torch.zeros((1, 32, 8, 1), device="meta")
    w = torch.zeros((64, 1, 3, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv1_pool.conv1_relu_pool(x, w, torch.zeros(64, device="meta"))
