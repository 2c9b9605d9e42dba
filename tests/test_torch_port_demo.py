"""aocr_torch.demo, the counterpart of examples/synthetic_demo.py: its
renderers and dataset equal tests/synth.py's, and `python -m
aocr_torch.demo --device cpu` runs every stage (dataset, train, greedy
and dictionary beam-5 tests, gallery, artifact replay) at a tiny width."""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import os
import subprocess
import sys

import numpy as np

from aocr_torch import demo
from tests import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_renderers_and_dataset_equal_the_tests_own(tmp_path):
    for w in ("ab", "e1x", "0", "", "zz9q"):
        np.testing.assert_array_equal(demo.render_word(w, 32, 81),
                                      synth.render_word(w, 32, 81))
    assert demo.font_paths() == list(synth.FONT_PATHS)
    for seed in (None, 3):
        rng = lambda: None if seed is None else np.random.RandomState(seed)
        np.testing.assert_array_equal(
            demo.render_word_font("hello", 32, 100, rng=rng()),
            synth.render_word_font("hello", 32, 100, rng=rng()))
    words = demo.demo_words(40)
    assert words == sorted(set(words)) and 30 < len(words) <= 40
    assert all(3 <= len(w) <= 8 for w in words)
    demo.make_dataset(str(tmp_path / "a"), words[:5], "m.txt")
    synth.make_dataset(str(tmp_path / "b"), words[:5], "m.txt")
    for name in ("m.txt", *(f"images/{f}" for f in
                            os.listdir(tmp_path / "b" / "images"))):
        a, b = tmp_path / "a" / name, tmp_path / "b" / name
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            assert a.read_text() == b.read_text()


def test_demo_runs_on_the_cpu(tmp_path):
    work = tmp_path / "demo"
    run = subprocess.run(
        [sys.executable, "-m", "aocr_torch.demo", "--workdir", str(work),
         "--words", "12", "--epochs", "2", "--batch_size", "4",
         "--device", "cpu", "--extra",
         "-encoder_num_hidden 8 -target_embedding_size 4 -max_decoder_l 10"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    out = run.stdout
    for stage in ("dataset: 12 words", "=== training ===",
                  "=== greedy evaluation ===",
                  "=== beam-5 + dictionary evaluation ===", "gallery:",
                  "replayed 8 val images, 8/8 match the live model",
                  "exact match: greedy"):
        assert stage in out, out[-3000:]
    assert (work / "results" / "website" / "index.html").exists()
    assert (work / "model.aocrx").exists()
    assert len((work / "results" / "results.txt").read_text()
               .splitlines()) == 12
