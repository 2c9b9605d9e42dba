"""aocr_torch.preprocess and the device-preprocess half of
aocr_torch.data against the JAX package on the CPU, and
tests/test_preprocess.py's cases against the port's own host path.

Tolerances: the device functions within 1e-4 of aocr.preprocess's on
[0, 255] (float32; the resize's sample coordinates are rounded as the
JAX package's compiled program rounds them); against the host path as
tests/test_preprocess.py holds aocr's (rtol 1e-4, atol 0.05; 0.5 for the
PNG round trip); load_raw, pack_raw and the DataGen payload exact."""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import os

import numpy as np
import pytest
import torch

from aocr import data as jdata
from aocr import preprocess as jpre
from aocr.config import Config
from aocr_torch import data, preprocess
from aocr_torch.config import Config as TConfig
from tests import synth


def _varsize_batch(rs, dtype, channels):
    """A padded mixed-size batch: sizes from tiny to wider than the
    buffer's first multiple of 64, a 1 x 1 image among them."""
    sizes = [(48, 160), (31, 99), (64, 200), (17, 333), (1, 1), (5, 3)]
    buf = np.zeros((len(sizes), 64, 384, channels), dtype)
    for i, (h, w) in enumerate(sizes):
        if dtype == np.uint8:
            buf[i, :h, :w] = rs.randint(0, 256, (h, w, channels))
        else:
            buf[i, :h, :w] = rs.uniform(0, 255, (h, w, channels))
    return buf, np.array(sizes, np.int32)


@pytest.mark.parametrize("dtype,channels", [
    (np.uint8, 3), (np.float32, 1), (np.uint8, 4), (np.float32, 3)])
@pytest.mark.parametrize("out_w", [100, 77])
def test_preprocess_varsize_matches_reference(dtype, channels, out_w):
    buf, sizes = _varsize_batch(np.random.RandomState(channels + out_w),
                                dtype, channels)
    want = np.asarray(jpre.preprocess_varsize(buf, sizes, 32, out_w))
    got = preprocess.preprocess_varsize(buf, sizes, 32, out_w, "cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # a tensor input stays where it is, and gives the same numbers
    again = preprocess.preprocess_varsize(torch.from_numpy(buf),
                                          torch.from_numpy(sizes), 32, out_w)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [
    (3, 48, 150, 3), (2, 20, 60, 3), (2, 32, 100, 3), (2, 40, 120, 4),
    (2, 32, 100), (2, 64, 300, 1)])
def test_preprocess_batch_matches_reference(shape):
    rs = np.random.RandomState(len(shape) + shape[1])
    raw = rs.randint(0, 256, shape).astype(np.uint8)
    want = np.asarray(jpre.preprocess_batch(raw, 32, 100))
    got = preprocess.preprocess_batch(raw, 32, 100, "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    norm = preprocess.preprocess_and_normalize(raw, 32, 100, "cpu").numpy()
    np.testing.assert_allclose(
        norm, np.asarray(jpre.preprocess_and_normalize(raw, 32, 100)),
        rtol=0, atol=1e-6)


def test_matches_host_path(np_rng):
    """Device-preprocessed batches match the port's host (numpy) path."""
    raw = np_rng.randint(0, 256, (3, 48, 160, 3)).astype(np.uint8)
    out = preprocess.preprocess_batch(raw, 32, 100, "cpu").numpy()
    assert out.shape == (3, 32, 100, 1)
    for i in range(3):
        lum = data._rgb_to_luminance(raw[i].astype(np.float32) / 255.0) * 255.0
        host = data._bilinear_resize(lum, 32, 100)
        np.testing.assert_allclose(out[i, :, :, 0], host, rtol=1e-4, atol=0.05)


def test_grayscale_input(np_rng):
    raw = np_rng.randint(0, 256, (2, 32, 100)).astype(np.uint8)
    out = preprocess.preprocess_batch(raw, 32, 100, "cpu").numpy()
    np.testing.assert_allclose(out[..., 0], raw.astype(np.float32),
                               rtol=1e-5, atol=1e-3)


def test_normalized_range(np_rng):
    raw = np_rng.randint(0, 256, (2, 40, 120, 3)).astype(np.uint8)
    out = preprocess.preprocess_and_normalize(raw, 32, 100, "cpu").numpy()
    assert out.min() >= -1.0 - 1e-5 and out.max() <= 1.0 + 1e-5


def test_identity_when_same_size(np_rng):
    raw = np_rng.randint(0, 256, (1, 32, 100, 1)).astype(np.uint8)
    out = preprocess.preprocess_batch(raw, 32, 100, "cpu").numpy()
    np.testing.assert_allclose(out[0, :, :, 0],
                               raw[0, :, :, 0].astype(np.float32), atol=1e-3)


def test_varsize_matches_host_path(np_rng):
    """preprocess_varsize on a padded mixed-size batch matches per-image
    host preprocessing (luminance and clipped-aspect bilinear resize)."""
    sizes = [(48, 160), (31, 99), (64, 200), (17, 333)]
    raws = [np_rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in sizes]
    buf, got_sizes = data.pack_raw(raws)
    np.testing.assert_array_equal(got_sizes, sizes)
    out = preprocess.preprocess_varsize(buf, got_sizes, 32, 100,
                                        "cpu").numpy()
    assert out.shape == (len(raws), 32, 100, 1)
    for i, r in enumerate(raws):
        lum = data._rgb_to_luminance(r.astype(np.float32) / 255.0) * 255.0
        host = data._bilinear_resize(lum, 32, 100)
        np.testing.assert_allclose(out[i, :, :, 0], host, rtol=1e-4,
                                   atol=0.05)


def test_load_raw_and_pack_raw_match_reference(tmp_path):
    """load_raw on .npy crops (uint8 gray, float in [0, 1], RGB, a broken
    file) and a PNG, then pack_raw, equal aocr.data's."""
    from PIL import Image

    rs = np.random.RandomState(4)
    items = [synth.render_word("ab", 32, 60).astype(np.uint8),
             (synth.render_word("cd", 20, 90) / 255.0).astype(np.float32),
             rs.randint(0, 256, (40, 130, 3)).astype(np.uint8)]
    paths = []
    for i, a in enumerate(items):
        paths.append(str(tmp_path / f"{i}.npy"))
        np.save(paths[-1], a)
    Image.fromarray(items[2]).save(tmp_path / "c.png")
    paths.append(str(tmp_path / "c.png"))
    (tmp_path / "bad.npy").write_bytes(b"not an array")
    for kw in ({}, {"keep_aspect_ratio": True}):
        cfg, tcfg = Config(**kw), TConfig(**kw)
        assert data.load_raw(str(tmp_path / "bad.npy"), tcfg) is None
        ours = [data.load_raw(p, tcfg) for p in paths]
        ref = [jdata.load_raw(p, cfg) for p in paths]
        for (a, wa), (b, wb) in zip(ours, ref):
            assert wa == wb and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for group in ([0, 1, 2, 3], [2, 3]):  # float, then uint8 only
            buf, sizes = data.pack_raw([ours[i][0] for i in group])
            jbuf, jsizes = jdata.pack_raw([ref[i][0] for i in group])
            assert buf.dtype == jbuf.dtype
            np.testing.assert_array_equal(buf, jbuf)
            np.testing.assert_array_equal(sizes, jsizes)


def test_datagen_device_mode_matches_host_mode(tmp_path, np_rng):
    """DataGen batches under -device_preprocess (the host decodes bytes
    only, the device does luminance and resize) match the host-mode
    batches of the same manifest, with non-uniform source sizes, and
    carry aocr's DataGen payload (raw, sizes, out_w) exactly."""
    from PIL import Image

    d = tmp_path
    (d / "images").mkdir()
    labels = ["abc", "de", "fgh1", "xy"]
    lines = []
    for i, lab in enumerate(labels):
        h, w = [(48, 160), (32, 100), (56, 222), (40, 131)][i]
        img = np_rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        p = f"images/{i}_{lab}.png"
        Image.fromarray(img).save(d / p)
        lines.append(f"{p} {lab}")
    (d / "train.txt").write_text("\n".join(lines) + "\n")

    cfg_host = TConfig(decode_workers=0)
    cfg_dev = cfg_host.replace(device_preprocess=True)
    hb = data.DataGen(str(d), "train.txt", cfg_host).next_batch(4)
    db = data.DataGen(str(d), "train.txt", cfg_dev).next_batch(4)
    jb = jdata.DataGen(str(d), "train.txt", Config(
        decode_workers=0, device_preprocess=True)).next_batch(4)
    assert db.images is None and db.raw is not None
    assert db.raw.dtype == np.uint8
    assert list(db.img_paths) == list(hb.img_paths) == list(jb.img_paths)
    np.testing.assert_array_equal(db.targets, hb.targets)
    np.testing.assert_array_equal(db.raw, jb.raw)
    np.testing.assert_array_equal(db.sizes, jb.sizes)
    assert db.out_w == jb.out_w == 100
    dev_images = preprocess.preprocess_varsize(
        db.raw, db.sizes, cfg_dev.image_height, db.out_w, "cpu").numpy()
    np.testing.assert_allclose(dev_images, hb.images, rtol=1e-4, atol=0.5)


def test_device_preprocess_cli(tmp_path):
    """-device_preprocess trains end to end on the CPU (decode workers and
    the prefetch thread on) and reaches a checkpoint."""
    from aocr_torch import checkpoint
    from aocr_torch.train import main

    d = str(tmp_path)
    labels = ["ab", "cd", "ef", "gh"]
    synth.make_dataset(d, labels, "train.txt", width=32)
    synth.make_dataset(d, labels, "val.txt", width=32)
    main([
        "-data_base_dir", d, "-data_path", "train.txt",
        "-val_data_path", "val.txt",
        "-model_dir", os.path.join(d, "model"),
        "-log_path", os.path.join(d, "log.txt"),
        "-batch_size", "4", "-num_batches_val", "1",
        "-encoder_num_hidden", "16", "-target_embedding_size", "8",
        "-max_decoder_l", "8", "-image_width", "32", "-input_feed",
        "-device_preprocess",
        "-phase", "train", "-num_epochs", "1", "-steps_per_checkpoint", "2",
    ], device="cpu")
    assert checkpoint.try_load_final(os.path.join(d, "model")) is not None


def test_default_device_is_cuda():
    """A numpy input without a device goes to CUDA: without it, raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preprocess.preprocess_batch(np.zeros((1, 32, 100), np.uint8))
