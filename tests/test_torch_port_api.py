"""aocr_torch's library surface against the JAX package on CPU: a
checkpoint that `aocr` writes loads into `aocr_torch` and recognizes
mixed-width images to the same transcripts (float32), greedy and beam-5,
with and without a dictionary; the weight bridge round-trips; the entry
points run on CUDA unless the caller names the CPU; and neither the port
nor chip_smoke.py imports jax or the JAX package."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import torch

from aocr import checkpoint
from aocr.api import AttentionOCR as JaxOCR
from aocr.config import Config
from aocr.models import model as jmodel
from aocr_torch import weights
from aocr_torch.api import AttentionOCR
from aocr_torch.config import Config as TConfig
from aocr_torch.models import model
from aocr_torch.ops import cuda
from tests import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kw(**kw):
    return dict(input_feed=True, encoder_num_hidden=64,
                target_embedding_size=8, max_decoder_l=8, **kw)


def _cfg(**kw):
    """The reference's Config."""
    return Config(**_kw(**kw))


def _tcfg(**kw):
    """The port's Config, from the same arguments as _cfg's."""
    return TConfig(**_kw(**kw))


def _sharpened(ocr):
    """Scale the reference init so transcripts depend on the image and some
    rows emit EOS (see test_torch_port_decode._jax_model)."""
    p = jax.tree.map(lambda a: np.array(a), ocr.params)
    for conv in p["cnn"].values():
        if "w" in conv:
            conv["w"] *= 3
    for group in ("encoder_fw", "encoder_bw", "decoder"):
        for layer in p[group]["layers"]:
            layer["wi"] *= 3
            layer["wh"] *= 3
    p["decoder"]["w_a"] *= 3
    p["decoder"]["w_c"] *= 3
    p["projector"]["w"] *= 6
    ocr.params = jax.tree.map(jax.numpy.asarray, p)
    return ocr


def _mixed_images():
    words = [("ab", 32), ("cd", 100), ("e1", 81), ("xyz", 100), ("0", 81)]
    return [synth.render_word(w, 32, W) for w, W in words]


@pytest.mark.parametrize("pallas_greedy", ["auto", "tail"])
def test_checkpoint_from_aocr_recognizes_identically(tmp_path, pallas_greedy):
    jocr = _sharpened(JaxOCR.create(_cfg(seed=905)))
    jocr.save(str(tmp_path))
    images = _mixed_images()
    want_words, want_scores = jocr.recognize(images)
    ocr = AttentionOCR.load(str(tmp_path), device="cpu",
                            cfg=TConfig(pallas_greedy=pallas_greedy))
    assert ocr.cfg.encoder_num_hidden == 64 and ocr.cfg.input_feed
    assert ocr.cfg.pallas_greedy == pallas_greedy
    words, scores = ocr.recognize(images)
    assert words == want_words
    np.testing.assert_allclose(scores, want_scores, rtol=1e-5, atol=1e-4)
    # a stacked batch gives the same rows as the list
    stacked = np.stack([im for im in images if im.shape[1] == 100])
    sw, ss = ocr.recognize(stacked)
    assert sw == [w for w, im in zip(words, images) if im.shape[1] == 100]


def test_param_count_and_weight_round_trip(tmp_path):
    cfg = _cfg()
    ms = jmodel.init(jax.random.PRNGKey(3), cfg)
    params = jax.tree.map(np.asarray, ms.params)
    stats = jax.tree.map(np.asarray, ms.batch_stats)
    tp, ts = weights.from_numpy(params, stats)
    assert model.num_params(tp) == jmodel.num_params(ms.params)
    assert tuple(tp["cnn"]["conv1"]["w"].shape) == (64, 1, 3, 3)
    back_p, back_s = weights.to_numpy(tp, ts)
    jax.tree.map(np.testing.assert_array_equal, back_p, params)
    jax.tree.map(np.testing.assert_array_equal, back_s, stats)
    # the port's save is an npz-v2 checkpoint the reference reads
    AttentionOCR(_tcfg(), tp, ts, device="cpu").save(str(tmp_path))
    ck = checkpoint.load(checkpoint.final_path(str(tmp_path)))
    jax.tree.map(np.testing.assert_array_equal, ck["params"], params)


def test_create_is_seeded_and_sized():
    cfg = _tcfg()
    a = AttentionOCR.create(cfg, seed=1, device="cpu")
    b = AttentionOCR.create(cfg, seed=1, device="cpu")
    c = AttentionOCR.create(cfg, seed=2, device="cpu")
    ref = jmodel.init(jax.random.PRNGKey(0), _cfg())
    assert model.num_params(a.params) == jmodel.num_params(ref.params)
    wa = a.params["decoder"]["w_a"]
    assert torch.equal(wa, b.params["decoder"]["w_a"])
    assert not torch.equal(wa, c.params["decoder"]["w_a"])
    words, scores = a.recognize(_mixed_images())
    assert len(words) == 5 and np.isfinite(scores).all()


def test_unported_surfaces_raise(tmp_path):
    """Device-side preprocessing of image paths, once refused, now runs:
    recognize() with device_preprocess on .npy paths of mixed sizes
    (decoded on the host by data.load_raw, luminance and resize by
    preprocess.preprocess_varsize on the model's device) gives aocr.api's
    device-preprocess transcripts on the same checkpoint and paths, scores
    within 1e-5 relative (float32), and the host path's transcripts."""
    jocr = _sharpened(JaxOCR.create(_cfg(seed=908, device_preprocess=True)))
    jocr.save(str(tmp_path / "model"))
    ocr = AttentionOCR.load(str(tmp_path / "model"), device="cpu",
                            cfg=TConfig(device_preprocess=True))
    host = AttentionOCR.load(str(tmp_path / "model"), device="cpu")
    assert ocr.cfg.device_preprocess and not host.cfg.device_preprocess
    paths = []
    for i, (word, h, w) in enumerate([("ab", 32, 60), ("cd", 48, 150),
                                      ("e1", 20, 140), ("xyz", 32, 100)]):
        img = synth.render_word(word, h, w)
        if i % 2:
            img = np.repeat(img[..., None], 3, -1).astype(np.uint8)
        paths.append(str(tmp_path / f"{i}.npy"))
        np.save(paths[-1], img)
    want_words, want_scores = jocr.recognize(paths)
    words, scores = ocr.recognize(paths)
    assert words == want_words
    np.testing.assert_allclose(scores, want_scores, rtol=1e-5, atol=1e-5)
    assert host.recognize(paths)[0] == words
    with pytest.raises(ValueError, match="cannot decode"):
        ocr.recognize([str(tmp_path / "missing.npy")])


@pytest.mark.parametrize("beam_size", [1, 2])
def test_recognize_image_paths_matches_reference(tmp_path, beam_size):
    """recognize() on .npy image paths of mixed sizes (decoded, luminance
    and resize on the host by aocr_torch.data) against aocr.api on the same
    checkpoint and paths: the same transcripts, scores within 1e-5
    relative (float32); a bare path is one image."""
    jocr = _sharpened(JaxOCR.create(_cfg(seed=907)))
    jocr.save(str(tmp_path / "model"))
    ocr = AttentionOCR.load(str(tmp_path / "model"), device="cpu")
    rs = np.random.RandomState(8)
    paths = []
    for i, (word, w) in enumerate([("ab", 60), ("cd", 100), ("e1", 140),
                                   ("xyz", 100), ("0", 45)]):
        img = synth.render_word(word, 32, w)
        if i % 2:  # an RGB crop at another height: luminance and resize
            img = np.repeat(img[::2, :, None], 3, -1).astype(np.uint8)
        p = str(tmp_path / f"{i}.npy")
        np.save(p, img)
        paths.append(p)
    want_words, want_scores = jocr.recognize(paths, beam_size=beam_size)
    words, scores = ocr.recognize(paths, beam_size=beam_size)
    assert words == want_words
    np.testing.assert_allclose(scores, want_scores, rtol=1e-5, atol=1e-5)
    one_word, _ = ocr.recognize(paths[1], beam_size=beam_size)
    assert one_word == [words[1]]


@pytest.mark.parametrize("beam_size", [1, 5])
def test_recognize_beam_and_dictionary_match_reference(tmp_path, beam_size):
    """recognize(beam_size=...) without and with use_dictionary, through
    AttentionOCR on the CPU, against aocr.api.AttentionOCR on the same
    checkpoint (float32, mixed widths)."""
    jocr = _sharpened(JaxOCR.create(_cfg(seed=906)))
    jocr.save(str(tmp_path))
    ocr = AttentionOCR.load(str(tmp_path), device="cpu")
    images = _mixed_images()
    lexicon = ["ab", "cd", "e1", "xyz", "0", "abc", "zz"]
    for dictionary in (False, True):
        if dictionary:
            jocr.use_dictionary(lexicon)
            ocr.use_dictionary(lexicon)
        want_words, want_scores = jocr.recognize(images, beam_size=beam_size)
        words, scores = ocr.recognize(images, beam_size=beam_size)
        assert words == want_words
        np.testing.assert_allclose(scores, want_scores, rtol=1e-5, atol=1e-5)
    # the trie admits lexicon words and, as PAD is always valid, prefixes
    assert all(any(x.startswith(w) for x in lexicon) for w in words)


def test_dictionary_table_surface():
    """set_dictionary_table keeps an int32 table on the model's device;
    clear_dictionary drops it; a table of the wrong width raises."""
    ocr = AttentionOCR.create(_tcfg(), device="cpu")
    assert ocr.dictionary_table is None
    table = np.full((3, 39), -1, np.int64)
    table[0, 13] = 1
    ocr.set_dictionary_table(table)
    assert ocr.dictionary_table.dtype == torch.int32
    assert ocr.dictionary_table.device == ocr.device
    assert ocr.dictionary_table.shape == (3, 39)
    ocr.clear_dictionary()
    assert ocr.dictionary_table is None
    with pytest.raises(ValueError, match="trie table"):
        ocr.set_dictionary_table(np.zeros((2, 38), np.int32))
    ocr.use_dictionary(["ab", "b"])
    assert ocr.dictionary_table.shape[1] == 39


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AttentionOCR.create(_tcfg(), device="cuda")


def test_default_device_is_cuda():
    """No device means CUDA: without it, create and load raise, and the
    CPU runs only when the caller names it."""
    if torch.cuda.is_available():
        assert AttentionOCR.create(_tcfg()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AttentionOCR.create(_tcfg())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AttentionOCR(_tcfg(), *weights.from_numpy(
            jax.tree.map(np.asarray, jmodel.init(
                jax.random.PRNGKey(0), _cfg()).params), {}))
    assert AttentionOCR.create(_tcfg(), device="cpu").device.type == "cpu"


def _jax_or_aocr(names):
    return sorted(k for k in names if k in ("jax", "aocr")
                  or k.startswith(("jax.", "aocr.", "jaxlib")))


def _port_modules_loaded(platform):
    """The modules loaded after importing every aocr_torch module in a
    clean interpreter, with JAX_PLATFORM_NAME unset or set to platform."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import aocr_torch\n"
        "for m in pkgutil.walk_packages(aocr_torch.__path__, 'aocr_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(' '.join(sys.modules))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORM_NAME", "JAX_PLATFORMS")}
    if platform is not None:
        env["JAX_PLATFORM_NAME"] = platform
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def _assert_port_only(loaded):
    assert _jax_or_aocr(loaded) == []
    port = {k for k in loaded if k.startswith("aocr_torch")}
    assert len(port) >= 30
    assert {"aocr_torch.loss", "aocr_torch.optim", "aocr_torch.train_step",
            "aocr_torch.config", "aocr_torch.vocab", "aocr_torch.checkpoint",
            "aocr_torch.utils.trie",
            "aocr_torch.train", "aocr_torch.eval", "aocr_torch.data",
            "aocr_torch.utils.logging_util", "aocr_torch.utils.native",
            "aocr_torch.serve", "aocr_torch.preprocess",
            "aocr_torch.augment", "aocr_torch.devices",
            "aocr_torch.t7", "aocr_torch.torch_import",
            "aocr_torch.parallel.mesh", "aocr_torch.parallel.multihost",
            "aocr_torch.parallel.data_parallel",
            "aocr_torch.parallel.eval_parallel",
            *(f"aocr_torch.ops.cuda.{k}" for k in cuda.KERNELS)} <= port
    assert cuda.KERNELS == (
        "conv1_pool", "lstm_fwd", "decode_step", "greedy_loop",
        "conv1_pool_bwd", "lstm_bwd", "tf_fwd", "tf_bwd", "beam_step",
        "beam_loop", "conv1_pool_dx", "pool_bwd")


def test_port_never_imports_jax():
    """Every aocr_torch module imports in a clean interpreter without
    loading jax or any module of the JAX package `aocr`
    (JAX_PLATFORM_NAME unset)."""
    _assert_port_only(_port_modules_loaded(None))


def test_port_never_imports_jax_with_cpu_platform():
    """The same with JAX_PLATFORM_NAME=cpu, where aocr/__init__ imports
    jax: any import of `aocr` would load it."""
    _assert_port_only(_port_modules_loaded("cpu"))


def test_chip_smoke_imports_neither_jax_nor_aocr():
    """Every import statement of chip_smoke.py, at any depth, names only
    the port, the standard library, numpy or torch."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    assert names, "no imports found"
    assert _jax_or_aocr(names) == []
    assert {"aocr_torch.config", "aocr_torch.api"} <= names
