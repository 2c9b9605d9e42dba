"""aocr_torch's library surface against the JAX package on CPU: a
checkpoint that `aocr` writes loads into `aocr_torch` and recognizes
mixed-width images to the same transcripts (float32), the weight bridge
round-trips, and the port never imports jax."""

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
from aocr_torch.models import model
from tests import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**kw):
    return Config(input_feed=True, encoder_num_hidden=64,
                  target_embedding_size=8, max_decoder_l=8, **kw)


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
                            cfg=Config(pallas_greedy=pallas_greedy))
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
    AttentionOCR(cfg, tp, ts, device="cpu").save(str(tmp_path))
    ck = checkpoint.load(checkpoint.final_path(str(tmp_path)))
    jax.tree.map(np.testing.assert_array_equal, ck["params"], params)


def test_create_is_seeded_and_sized():
    cfg = _cfg()
    a = AttentionOCR.create(cfg, seed=1, device="cpu")
    b = AttentionOCR.create(cfg, seed=1, device="cpu")
    c = AttentionOCR.create(cfg, seed=2, device="cpu")
    ref = jmodel.init(jax.random.PRNGKey(0), cfg)
    assert model.num_params(a.params) == jmodel.num_params(ref.params)
    wa = a.params["decoder"]["w_a"]
    assert torch.equal(wa, b.params["decoder"]["w_a"])
    assert not torch.equal(wa, c.params["decoder"]["w_a"])
    words, scores = a.recognize(_mixed_images())
    assert len(words) == 5 and np.isfinite(scores).all()


def test_unported_surfaces_raise():
    ocr = AttentionOCR.create(_cfg(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ocr.use_dictionary(["abc"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ocr.set_dictionary_table(np.zeros((1, 39), np.int32))
    with pytest.raises(NotImplementedError, match="slice 3"):
        ocr.recognize(_mixed_images(), beam_size=5)
    with pytest.raises(NotImplementedError, match="paths"):
        ocr.recognize(["word.png"])


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AttentionOCR.create(_cfg(), device="cuda")


def test_port_never_imports_jax():
    """Every aocr_torch module imports in a clean interpreter without
    pulling in jax (JAX_PLATFORM_NAME unset: aocr/__init__ imports jax
    when it is set to cpu)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import aocr_torch\n"
        "for m in pkgutil.walk_packages(aocr_torch.__path__, 'aocr_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, sorted(\n"
        "    k for k in sys.modules if k.startswith('jax'))\n"
        "print(' '.join(k for k in sys.modules\n"
        "               if k.startswith('aocr_torch')))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORM_NAME", "JAX_PLATFORMS")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert len(loaded) >= 25
    assert {"aocr_torch.loss", "aocr_torch.optim", "aocr_torch.train_step",
            *(f"aocr_torch.ops.cuda.{k}" for k in (
                "conv1_pool_bwd", "lstm_bwd", "tf_fwd", "tf_bwd"))} <= loaded
