"""aocr_torch.visualizer.generate_html against aocr's on the CPU: the same
results.txt gives a byte-equal index.html and the same image names and
bytes (.npy crops rendered to PNGs, .png crops copied), with a .json
and a .pkl frequency file; the same FileNotFoundErrors; and the gallery
of the port trainer's own -visualize output."""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import json
import os
import pickle
import re

import numpy as np
import pytest

from aocr.visualizer import generate_html as jvis
from aocr_torch import train
from aocr_torch.visualizer import generate_html as tvis
from tests import synth


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture
def results(tmp_path):
    """A results.txt over .npy crops (float in [0, 255], in [0, 1], with
    a channel axis), .png crops (one beside a colliding flattened name),
    a missing image, a malformed line and HTML-special text; .json and
    .pkl frequency files."""
    data = tmp_path / "data"
    (data / "x").mkdir(parents=True)
    rs = np.random.RandomState(0)
    np.save(data / "a.npy", synth.render_word("ab", 32, 36))
    np.save(data / "x" / "b.npy", rs.uniform(0, 1, (32, 40)).astype(
        np.float32))
    np.save(data / "c.npy", rs.uniform(0, 255, (32, 20, 1)).astype(
        np.float32))
    (data / "x" / "d.png").write_bytes(b"\x89PNG one")
    (data / "x_d.png").write_bytes(b"\x89PNG two")
    lines = ["a.npy\tab\tab\t-0.25\t-0.25",
             "x/b.npy\tcd\tcb\t-1.5\t-2.75",
             "c.npy\t<e>\t<e>\t-0.1\t-0.2",
             "x/d.png\tq#1\tq%1\t-3\t-4",
             "x_d.png\tz\tz\t-0.5\t-0.5",
             "missing.png\tm\tn\t-1\t-1",
             "malformed line"]
    freq = {"ab": 10, "cd": 5, "z": 1}
    (tmp_path / "freq.json").write_text(json.dumps(freq))
    with open(tmp_path / "freq.pkl", "wb") as f:
        pickle.dump(freq, f, protocol=2)
    return tmp_path, data, "\n".join(lines) + "\n"


@pytest.mark.parametrize("freq", [None, "freq.json", "freq.pkl"])
def test_generate_matches_reference(results, freq):
    root, data, text = results
    trees = {}
    for name, mod in (("jax", jvis), ("port", tvis)):
        out = root / name
        out.mkdir()
        (out / "results.txt").write_text(text)
        path = mod.generate(str(out), str(data),
                            None if freq is None else str(root / freq))
        assert path == str(out / "website" / "index.html")
        trees[name] = _tree(out / "website")
    assert trees["port"] == trees["jax"]
    html = trees["port"]["index.html"].decode()
    assert html.count("<li ") == 6
    # the three .npy crops rendered, both .png crops copied
    images = [k for k in trees["port"] if k.startswith("images")]
    assert len(images) == 5
    assert sum(k.endswith(".png") for k in images) == 5
    if freq is not None:
        assert "gold frequency: 10 out of 16" in html


def test_errors_match_reference(tmp_path):
    for mod in (jvis, tvis):
        with pytest.raises(FileNotFoundError, match="results.txt not found"):
            mod.generate(str(tmp_path), str(tmp_path))
    (tmp_path / "results.txt").write_text("")
    for mod in (jvis, tvis):
        with pytest.raises(FileNotFoundError,
                           match=re.escape(f"freq file {tmp_path}/nope.json "
                                           "not found")):
            mod.generate(str(tmp_path), str(tmp_path),
                         str(tmp_path / "nope.json"))


def test_renders_port_trainer_results(tmp_path):
    """-phase test -visualize of the port's trainer, then the port's
    main(): one <li> a row of results.txt, every .npy crop a PNG."""
    words = ["ab", "cd1", "xyz", "k", "q0"]
    data = tmp_path / "data"
    data.mkdir()
    lines = []
    for i, w in enumerate(words):
        np.save(data / f"{i}.npy", synth.render_word(w, 32, 36))
        lines.append(f"{i}.npy {w}")
    (data / "test.txt").write_text("\n".join(lines) + "\n")
    out = tmp_path / "results"
    train.main(["-phase", "test", "-data_base_dir", str(data),
                "-data_path", str(data / "test.txt"),
                "-model_dir", str(tmp_path / "model"),
                "-log_path", str(tmp_path / "log.txt"),
                "-output_dir", str(out), "-visualize", "-batch_size", "2",
                "-encoder_num_hidden", "16", "-target_embedding_size", "8",
                "-max_decoder_l", "6", "-image_width", "36",
                "-beam_size", "2"], device="cpu")
    rows = (out / "results.txt").read_text().splitlines()
    assert len(rows) == len(words)
    tvis.main(["--output_dir", str(out), "--data_base_dir", str(data)])
    html = (out / "website" / "index.html").read_text()
    assert html.count("<li ") == len(words)
    pngs = sorted(os.listdir(out / "website" / "images"))
    assert len(pngs) == len(words) and all(p.endswith(".png") for p in pngs)
