"""aocr_torch.augment, the training-time augmentation, against the JAX
package on the CPU.

The deterministic core (`augment_from_draws`) is held against
aocr.augment._augment_one, and the jitted aocr.augment.augment_batch, on
the draws JAX makes from the same key (split, uniform and normal exactly
as aocr/augment.py draws them), within 5e-3 on [0, 255]: two float32
ulps of a sample coordinate across a 0-to-255 edge of the striped crops.
A coordinate moves by an ulp because XLA's exp, cos and sin differ from
PyTorch's by one ulp on ~7% of float32 arguments, and because the jitted
program contracts multiply-adds; _augment_one and augment_batch differ
from each other by up to ~4e-3 for the same reason.  The sampler alone,
on the same coordinates, is held within 1e-4 of
jax.scipy.ndimage.map_coordinates.  The port's own draws (Philox) are
checked against the generator's published test vectors, by range and
moments, and by the determinism contract; then tests/test_augment.py's
cases on the port's generator.
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aocr import augment as jaug
from aocr import vocab
from aocr_torch import augment, optim, train_step, weights
from aocr_torch.config import Config as TConfig
from aocr.config import Config
from aocr.models import model as jmodel
from tests import synth

KW = dict(batch_size=8, input_feed=True, encoder_num_hidden=16,
          target_embedding_size=8, image_width=32, augment=True)


def _images(labels, width=32):
    return np.stack([synth.render_word(l, 32, width)
                     for l in labels])[..., None].astype(np.float32)


def _jax_draws(rng, b, h, w):
    """Each row's (u, noise) as aocr/augment.py draws them."""
    us, ns = [], []
    for i in range(b):
        k_geo, k_noise = jax.random.split(jax.random.fold_in(rng, i))
        us.append(np.asarray(jax.random.uniform(k_geo, (7,), minval=-1.0,
                                                maxval=1.0)))
        ns.append(np.asarray(jax.random.normal(k_noise, (h, w))))
    return torch.from_numpy(np.stack(us)), torch.from_numpy(np.stack(ns))


@pytest.mark.parametrize("width,strength", [(32, 1.0), (100, 1.0),
                                            (100, 2.5), (36, 0.0)])
@pytest.mark.parametrize("seed", [0, 2])
def test_core_matches_reference(seed, width, strength):
    labels = ["ab", "cd1", "xyz", "k", "hello", "q0"]
    imgs = _images(labels, width)
    rng = jax.random.PRNGKey(seed)
    u, noise = _jax_draws(rng, len(labels), 32, width)
    got = augment.augment_from_draws(u, noise, torch.from_numpy(imgs),
                                     strength).numpy()
    want = np.stack([np.asarray(jaug._augment_one(
        jax.random.fold_in(rng, i), jnp.asarray(imgs[i]), strength))
        for i in range(len(labels))])
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
    jitted = np.asarray(jaug.augment_batch(rng, jnp.asarray(imgs),
                                           strength=strength))
    np.testing.assert_allclose(got, jitted, rtol=0, atol=5e-3)
    # the warp reaches the background: some neighbours are read as 255
    if strength >= 2.5:
        assert not np.allclose(got, imgs, atol=1.0)


def test_constant_mode_fills_each_outside_neighbour():
    """map_coordinates(mode="constant") reads cval for each neighbour
    outside the plane, so a point half a pixel outside blends the edge
    with 255 (not the edge alone), and a point wholly outside is 255; on
    a striped crop at random coordinates, a third of them off the plane,
    the sampler equals JAX's within 1e-4."""
    img = torch.zeros(1, 2, 3)
    ys = torch.tensor([[[-0.5, 0.0, 1.5], [0.0, 0.5, -2.0]]])
    xs = torch.tensor([[[0.0, -0.25, 2.0], [3.5, 1.0, 1.0]]])
    got = augment._bilinear_constant(img, ys, xs, 255.0)
    np.testing.assert_allclose(got[0].numpy(),
                               [[127.5, 63.75, 127.5], [255.0, 0.0, 255.0]])
    rs = np.random.RandomState(5)
    plane = _images(["hello"], 40)[0, :, :, 0]
    ys = rs.uniform(-3, 35, (32, 40)).astype(np.float32)
    xs = rs.uniform(-4, 44, (32, 40)).astype(np.float32)
    want = jax.scipy.ndimage.map_coordinates(
        plane, [ys, xs], order=1, mode="constant", cval=255.0)
    got = augment._bilinear_constant(
        torch.from_numpy(plane)[None], torch.from_numpy(ys)[None],
        torch.from_numpy(xs)[None], 255.0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))])
def test_philox_known_answers(counter, key, want):
    """Philox-4x32-10's known-answer vectors (Random123's kat_vectors)."""
    c = (torch.tensor([counter[0]], dtype=torch.int64),) + counter[1:]
    got = augment.philox4x32(c, key)
    assert tuple(int(x[0]) for x in got) == want


def test_draws_range_and_moments():
    u, noise = augment.draws((5, 9), torch.arange(64), 32, 100)
    assert u.shape == (64, 7) and noise.shape == (64, 32, 100)
    assert float(u.min()) >= -1.0 and float(u.max()) < 1.0
    assert abs(float(u.mean())) < 0.05
    assert abs(float(noise.mean())) < 0.01
    assert abs(float(noise.std()) - 1.0) < 0.01
    assert bool(torch.isfinite(noise).all())
    # the step key, the row and the stream each change the draws
    u2, _ = augment.draws((5, 10), torch.arange(64), 32, 100)
    assert not torch.equal(u, u2)
    assert not torch.equal(u[0], u[1])
    assert augment.step_key(910820, 7) == (910820, 7)


def test_deterministic_and_bounded():
    imgs = torch.from_numpy(_images(["ab", "cd", "ef"]))
    key = augment.step_key(7, 0)
    a = augment.augment_batch(key, imgs)
    b = augment.augment_batch(key, imgs)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = augment.augment_batch(augment.step_key(7, 1), imgs)
    assert not torch.allclose(a, c)  # another step, another augmentation
    assert a.shape == imgs.shape
    assert float(a.min()) >= 0.0 and float(a.max()) <= 255.0
    # rows are independently keyed: identical inputs augment differently
    same = torch.from_numpy(_images(["ab", "ab"]))
    out = augment.augment_batch(key, same)
    assert not torch.allclose(out[0], out[1])


def test_strength_zero_is_identity():
    imgs = torch.from_numpy(_images(["ab", "cd"]))
    out = augment.augment_batch((0, 0), imgs, strength=0.0)
    torch.testing.assert_close(out, imgs, rtol=0, atol=1e-3)


def test_row_offset_keys_global_rows():
    """Augmenting a slice with its global offset reproduces the whole
    batch's augmentation of those rows: the data-parallel shard
    invariant."""
    imgs = torch.from_numpy(_images(["ab", "cd", "ef", "gh"]))
    key = (3, 0)
    full = augment.augment_batch(key, imgs)
    part = augment.augment_batch(key, imgs[2:], row_offset=2)
    torch.testing.assert_close(full[2:], part, rtol=0, atol=0)


def test_augment_changes_the_loss_but_stays_finite():
    """The augmented step trains on genuinely different pixels, and the
    same step key gives the same step."""
    labels = ["ab", "cd"]
    imgs = _images(labels)
    targets, targets_eval, _ = vocab.encode_batch(labels)
    ms = jmodel.init(jax.random.PRNGKey(0), Config(**KW))
    params, stats = weights.from_numpy(
        jax.tree.map(np.asarray, ms.params),
        jax.tree.map(np.asarray, ms.batch_stats))
    cfg = TConfig(**KW)
    opt = optim.sgd_init(params)
    key = augment.step_key(cfg.seed, 1)

    def loss(c, k):
        out = train_step.make_train_step(c)(params, stats, opt, imgs,
                                            targets, targets_eval, 0.1, k)
        return float(out.loss_sum)

    aug, plain = loss(cfg, key), loss(cfg.replace(augment=False), key)
    assert np.isfinite(aug)
    assert aug != plain
    assert loss(cfg, key) == aug
    with pytest.raises(ValueError, match="step key"):
        loss(cfg, None)
