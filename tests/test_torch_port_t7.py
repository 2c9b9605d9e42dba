"""aocr_torch's Torch7 reader/writer and checkpoint import against the
JAX package's (aocr.t7, aocr.torch_import) on the CPU.

The streams: tests/torch_fixture.py's reference-layout checkpoints
(aocr's writer, with and without the -prealloc name tags) and
tests/t7_golden.py's independent writer with its variants (legacy
versionless classes with CudaTensor records, every group's weights as
views into one shared flat storage, 4-byte longs, function records,
cyclic tables).  Each is read by both packages to equal objects; the
port's import equals aocr's array for array (array_equal) with the same
config, global_step and optim_state; a model dir written by either
package loads in the other, and their float32 transcripts are identical.
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import numpy as np
import pytest

import jax

from aocr import t7 as jt7
from aocr import torch_import as jimport
from aocr.api import AttentionOCR as JaxOCR
from aocr.config import Config
from aocr_torch import t7, torch_import
from aocr_torch.api import AttentionOCR
from aocr_torch.config import Config as TConfig
from tests import synth, t7_golden, torch_fixture
from tests.test_t7_golden import ENC_H, EMB, VOCAB, _golden_checkpoint

WORDS = ["ab", "c1d", "xyz", "k"]


def _same(a, b, path="") -> None:
    """Two read trees are equal: aocr's and the port's TorchObject by
    class name and fields, arrays by dtype and value."""
    if isinstance(a, (jt7.TorchObject, t7.TorchObject)):
        assert isinstance(b, (jt7.TorchObject, t7.TorchObject)), path
        assert a.torch_typename == b.torch_typename, path
        _same(a.fields, b.fields, path + "." + a.torch_typename)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def _weights(seed=20260817):
    return torch_fixture.make_weights(np.random.RandomState(seed), ENC_H,
                                      EMB, VOCAB)


def _stream(tmp_path, kind):
    """A checkpoint stream of the given kind; returns (path, long_size)."""
    p = str(tmp_path / f"{kind}.t7")
    w = _weights()
    if kind in ("fixture", "fixture-untagged"):
        torch_fixture.save_reference_checkpoint(
            p, w, enc_h=ENC_H, emb=EMB, vocab=VOCAB, global_step=123,
            learning_rate=0.05, tag_names=kind == "fixture")
        return p, 8
    kw = {"golden": {}, "legacy-cuda": {"legacy_classes": True,
                                        "cuda": True},
          "long4": {"long_size": 4}}[kind]
    _golden_checkpoint(p, w, **kw)
    return p, kw.get("long_size", 8)


STREAMS = ["fixture", "fixture-untagged", "golden", "legacy-cuda", "long4"]


@pytest.mark.parametrize("kind", STREAMS)
def test_load_matches_reference(tmp_path, kind):
    """Both readers give equal trees for every stream variant."""
    p, ls = _stream(tmp_path, kind)
    _same(t7.load(p, long_size=ls), jt7.load(p, long_size=ls))


def test_load_matches_reference_on_odd_records(tmp_path):
    """Function records (skipped, memoized), shared flat storage with
    strided views, long tensors in a 4-byte-long stream and a cyclic
    table read the same in both packages."""
    flat = t7_golden.Storage(np.arange(12, dtype=np.float32))
    fn = t7_golden.Function(upvalues={"captured": 3.0})
    obj = {"w": t7_golden.View(flat, (2, 3), (3, 1), 0),
           "b": t7_golden.View(flat, (3,), (1,), 6),
           "col": t7_golden.View(flat, (2,), (3,), 1),
           "f": [fn, fn, 5.0],
           "idx": np.array([3, -1, 2 ** 31 - 1], np.int64)}
    for ls in (8, 4):
        p = str(tmp_path / f"odd{ls}.t7")
        t7_golden.save(p, obj, long_size=ls)
        _same(t7.load(p, long_size=ls), jt7.load(p, long_size=ls))
    cyc = {"name": "loop"}
    cyc["self"] = cyc
    p = str(tmp_path / "cyc.t7")
    t7_golden.save(p, cyc)
    got = t7.load(p)
    assert got["self"] is got and got["name"] == "loop"


@pytest.mark.parametrize("long_size", [8, 4])
def test_writer_round_trip(tmp_path, long_size):
    """The port's writer: its stream reads back through both readers;
    with 8-byte longs it is byte for byte aocr's writer's stream."""
    rs = np.random.RandomState(3)
    shared = rs.normal(size=(3, 4)).astype(np.float32)
    obj = [{"a": shared, "b": shared, "n": 2.5, "s": "text", "t": True,
            "none": None, "longs": np.array([1, -2, 3], np.int64),
            "bytes": np.arange(5, dtype=np.uint8)},
           t7.TorchObject("nn.Linear", {"weight": shared.T.copy()})]
    p = str(tmp_path / "w.t7")
    t7.save(p, obj, long_size=long_size)
    back = t7.load(p, long_size=long_size)
    assert back[0]["a"] is back[0]["b"]
    _same(back, jt7.load(p, long_size=long_size))
    _same(back[0], {k: v for k, v in obj[0].items()})
    q = str(tmp_path / "j.t7")
    jt7.save(q, [obj[0], jt7.TorchObject("nn.Linear", obj[1].fields)])
    ours, theirs = open(p, "rb").read(), open(q, "rb").read()
    if long_size == 8:
        assert ours == theirs
    else:  # 4 bytes fewer for each C long, the same otherwise
        assert len(ours) < len(theirs)


def _import_equal(got, want) -> None:
    assert got["config"] == want["config"]
    assert got["global_step"] == want["global_step"]
    assert got["optim_state"] == want["optim_state"]
    assert jax.tree.structure(got["params"]) == jax.tree.structure(
        want["params"])
    for tree in ("params", "batch_stats"):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b)
                     or None, got[tree], want[tree])
        for a, b in zip(jax.tree.leaves(got[tree]),
                        jax.tree.leaves(want[tree])):
            assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("kind", STREAMS)
def test_import_matches_reference(tmp_path, kind):
    """import_checkpoint equals aocr.torch_import's array for array."""
    p, ls = _stream(tmp_path, kind)
    got = torch_import.import_checkpoint(p, long_size=ls)
    _import_equal(got, jimport.import_checkpoint(p, long_size=ls))
    assert got["global_step"] == 123
    assert got["optim_state"]["learning_rate"] == 0.05


def test_model_dirs_load_across_packages(tmp_path, capsys):
    """A model dir written by the port (python -m aocr_torch.torch_import
    with --summary) loads in aocr.api, one written by aocr loads in the
    port; float32 greedy and beam-2 transcripts are identical across the
    four loads, scores within 1e-5."""
    p, _ = _stream(tmp_path, "fixture")
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert torch_import._cli([p, port_dir, "--summary"]) == 0
    out = capsys.readouterr().out
    jimport.import_to_model_dir(p, jax_dir)
    want = jimport.import_checkpoint(p)
    for group, tree in want["params"].items():
        n = sum(int(np.asarray(x).size) for x in jax.tree.leaves(tree))
        assert f"  {group}: {n} params" in out
    assert "global_step: 123" in out
    images = [synth.render_word(w, 32, 32 + 8 * i).astype(np.float32)
              for i, w in enumerate(WORDS)]
    cfg = dict(max_decoder_l=8)
    runs = []
    for load in (lambda d: JaxOCR.load(d, cfg=Config(**cfg)),
                 lambda d: AttentionOCR.load(d, cfg=TConfig(**cfg),
                                             device="cpu")):
        for d in (port_dir, jax_dir):
            ocr = load(d)
            assert ocr.global_step == 123
            runs.append([ocr.recognize(images, beam_size=k)
                         for k in (1, 2)])
    for run in runs[1:]:
        for (words, scores), (w0, s0) in zip(run, runs[0]):
            assert words == w0
            np.testing.assert_allclose(scores, s0, rtol=1e-5, atol=1e-5)
