"""aocr_torch.export (`.aocrx` artifacts of torch.export programs) on the
CPU, against aocr.export's StableHLO artifacts and the port's live
recognize on one checkpoint.

The checkpoint is aocr's init (a JAX seed, scaled so that transcripts
depend on the image), saved as numpy arrays and read by both packages
(the port through aocr_torch.weights).  Tolerances: transcripts equal;
scores against aocr's artifact rtol 1e-5, atol 1e-4 (the package
crossing's, test_torch_port_decode.py); against the port's own live
recognize rtol 1e-5.  The tiny model decodes 8 steps of 32x32 crops.
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import io
import json
import os
import zipfile

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from aocr import export as jexport
from aocr.api import AttentionOCR as JaxOCR
from aocr.config import Config
from aocr_torch import decode
from aocr_torch import export as texport
from aocr_torch.api import AttentionOCR
from aocr_torch.config import Config as TConfig
from aocr_torch.ops import cuda
from tests import synth
from tests.test_torch_port_api import _sharpened

KW = dict(input_feed=True, encoder_num_hidden=16, target_embedding_size=8,
          max_decoder_l=8, image_width=32)
# the port's live model held against a plain artifact: the plain route
PLAIN = TConfig(**KW, use_pallas=False)
WORDS = ["ab", "cd", "ef", "gh", "ij"]
# words of the characters the model emits on WORDS, so that the
# dictionary's beam-5 transcripts differ between images
LEXICON = ["4p", "dp", "dd", "kp", "kpd", "ddd", "pd", "42"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(model dir, aocr's model): aocr's init, sharpened, saved."""
    d = str(tmp_path_factory.mktemp("export_ckpt"))
    jocr = _sharpened(JaxOCR.create(Config(**KW, seed=905)))
    jocr.save(d)
    return d, jocr


@pytest.fixture(scope="module")
def ocr(ckpt):
    return AttentionOCR.load(ckpt[0], cfg=PLAIN, device="cpu")


@pytest.fixture(scope="module")
def images():
    return np.stack([synth.render_word(w, 32, 32)[..., None]
                     for w in WORDS]).astype(np.float32)


@pytest.fixture(scope="module")
def arts(ckpt, ocr, tmp_path_factory):
    """The port's and aocr's artifacts of the checkpoint: greedy with a
    symbolic batch, and dictionary beam-5 pinned at batch 2."""
    d = tmp_path_factory.mktemp("export_arts")
    jocr = ckpt[1]
    out = {}
    out["greedy", "torch"] = texport.export_recognizer(
        ocr, str(d / "g.aocrx"), device="cpu")
    out["greedy", "jax"] = jexport.export_recognizer(
        jocr, str(d / "gj.aocrx"), platforms=("cpu",))
    ocr.use_dictionary(LEXICON)
    jocr.use_dictionary(LEXICON)
    try:
        out["dict-beam5", "torch"] = texport.export_recognizer(
            ocr, str(d / "b.aocrx"), beam_size=5, batch=2, device="cpu")
        out["dict-beam5", "jax"] = jexport.export_recognizer(
            jocr, str(d / "bj.aocrx"), beam_size=5, batch=2,
            platforms=("cpu",))
    finally:
        ocr.clear_dictionary()
        jocr.clear_dictionary()
    return out


@pytest.fixture(scope="module")
def loaded(arts):
    """The port's artifacts of `arts`, loaded on the CPU."""
    return {mode: texport.ExportedRecognizer.load(path, "cpu")
            for (mode, pkg), path in arts.items() if pkg == "torch"}


@pytest.mark.parametrize("mode", ["greedy", "dict-beam5"])
def test_artifact_matches_aocr_artifact(arts, loaded, images, mode):
    """The port's plain artifact and aocr's StableHLO artifact of one
    checkpoint give the same transcripts on the same images."""
    got_w, got_s = loaded[mode].recognize(images)
    want_w, want_s = jexport.ExportedRecognizer.load(
        arts[mode, "jax"]).recognize(images)
    assert got_w == want_w
    assert len(set(got_w)) > 1
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", ["greedy", "dict-beam5"])
def test_artifact_matches_live_recognize(ocr, loaded, images, mode):
    """An artifact replays the live plain-route decode: exact transcripts,
    scores rtol 1e-5; one poly program serves batches of 5 and 2, and the
    pinned one chunks 5 rows into 3 calls of 2."""
    rec = loaded[mode]
    K = 5 if mode == "dict-beam5" else 1
    if K > 1:
        ocr.use_dictionary(LEXICON)
    try:
        want_w, want_s = ocr.recognize(images, beam_size=K)
    finally:
        ocr.clear_dictionary()
    got_w, got_s = rec.recognize(images)
    assert got_w == want_w
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5)
    assert rec.recognize(images[:2])[0] == want_w[:2]
    assert rec.meta["batch"] == ("poly" if K == 1 else 2)
    assert rec.meta["use_dictionary"] is (K > 1)
    if K > 1:
        assert all(any(v.startswith(w) for v in LEXICON) for w in got_w)


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {i.filename: z.read(i) for i in z.infolist()}


@pytest.mark.parametrize("mode", ["greedy", "dict-beam5"])
def test_weight_members_equal_aocr(arts, mode):
    """The weight (and trie) members have the names, shapes, dtypes and
    values of aocr's artifact of the same checkpoint; the meta has aocr's
    keys, torch_version for jax_version and device for platforms."""
    got, want = _members(arts[mode, "torch"]), _members(arts[mode, "jax"])
    npy = lambda m: {k: np.lib.format.read_array(io.BytesIO(v))  # noqa: E731
                     for k, v in m.items() if k.endswith(".npy")}
    g, w = npy(got), npy(want)
    assert sorted(g) == sorted(w) and len(g) > 20
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert ("trie.npy" in g) is (mode == "dict-beam5")
    gm, wm = (json.loads(m["__meta__.json"]) for m in (got, want))
    assert set(gm) - set(wm) == {"torch_version", "device"}
    assert set(wm) - set(gm) == {"jax_version", "platforms"}
    assert gm["format"] == "aocrx-torch" and wm["format"] == "aocrx"
    assert gm["skeleton"] == wm["skeleton"]
    for k in ("beam_size", "max_len", "batch", "widths", "geometry",
              "vocab", "use_dictionary", "use_pallas", "compute_dtype"):
        assert gm[k] == wm[k], k


def test_program_holds_no_weights(arts):
    """The program member holds no weight bytes: it is much smaller than
    the weights, and the largest weight's bytes are not in it."""
    m = _members(arts["greedy", "torch"])
    (prog,) = [v for k, v in m.items() if k.startswith("__program__")]
    weights = {k: np.lib.format.read_array(io.BytesIO(v))
               for k, v in m.items() if k.endswith(".npy")}
    total = sum(a.nbytes for a in weights.values())
    assert len(prog) < total / 4
    big = max(weights.values(), key=lambda a: a.nbytes)
    assert big.tobytes()[:4096] not in prog


def test_update_weights_reuses_program(ckpt, ocr, arts, images, tmp_path):
    """Weight-only re-export: other weights under the SAME program bytes
    give the live model's output with those weights; a changed tree and
    a dictionary mismatch are refused (tests/test_export.py's case)."""
    src = arts["greedy", "torch"]
    other = AttentionOCR.load(ckpt[0], cfg=PLAIN, device="cpu")
    for t in other.params["decoder"]["layers"][0].values():
        t.mul_(1.5)
    out = str(tmp_path / "updated.aocrx")
    texport.update_weights(src, other, out)
    w_exp, s_exp = texport.ExportedRecognizer.load(out, "cpu").recognize(
        images)
    w_live, s_live = other.recognize(images)
    assert w_exp == w_live
    np.testing.assert_allclose(s_exp, s_live, rtol=1e-5)
    assert not np.allclose(s_exp, ocr.recognize(images)[1])
    a, b = _members(src), _members(out)
    progs = [k for k in a if k.startswith("__program__")]
    assert progs and all(a[k] == b[k] for k in progs)
    other.use_dictionary(["cat"])
    with pytest.raises(ValueError, match="dictionary presence"):
        texport.update_weights(src, other, str(tmp_path / "x.aocrx"))
    other.clear_dictionary()
    bigger = AttentionOCR.create(PLAIN.replace(encoder_num_hidden=24),
                                 device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        texport.update_weights(src, bigger, str(tmp_path / "y.aocrx"))


def test_multi_width_artifact(ocr, tmp_path):
    """-widths exports one program per width; mixed widths bucket per
    program (equal to the live model at the exported widths), a width
    between steps pads up with background, wider ones are refused.  Four
    steps a decode, to keep the two traces short."""
    art = str(tmp_path / "mw.aocrx")
    texport.export_recognizer(ocr, art, widths=[24, 32], max_len=4,
                              device="cpu")
    r = texport.ExportedRecognizer.load(art, "cpu")
    assert r.widths == [24, 32]
    im24 = synth.render_word("ab", 32, 24).astype(np.float32)
    im32 = synth.render_word("cd", 32, 32).astype(np.float32)
    w_exp, s_exp = r.recognize([im24, im32, im24])
    w_live, s_live = ocr.recognize([im24, im32, im24], max_len=4)
    assert w_exp == w_live
    np.testing.assert_allclose(s_exp, s_live, rtol=1e-5)
    im20 = synth.render_word("ef", 32, 20).astype(np.float32)
    padded = np.pad(im20, ((0, 0), (0, 4)), constant_values=255.0)
    assert (r.recognize([im20])[0]
            == ocr.recognize([padded], max_len=4)[0])
    with pytest.raises(ValueError, match="widest exported"):
        r.recognize([synth.render_word("gh", 32, 40).astype(np.float32)])


def test_recognize_paths(ocr, loaded, tmp_path):
    """Path inputs, a list or one bare path, go through the live API's
    preprocessing."""
    _, names = synth.make_dataset(str(tmp_path), ["ab", "cd"], width=32)
    paths = [str(tmp_path / p) for p in names]
    r = loaded["greedy"]
    assert r.recognize(paths)[0] == ocr.recognize(paths)[0]
    assert r.recognize(paths[0])[0] == r.recognize(paths[:1])[0]
    assert r.recognize([])[0] == []


def _future(path, tmp_path):
    fut = str(tmp_path / "future.aocrx")
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(fut, "w") as zout:
        for info in zin.infolist():
            data = zin.read(info)
            if info.filename == "__meta__.json":
                meta = json.loads(data)
                meta["version"] += 1
                data = json.dumps(meta).encode()
            zout.writestr(info.filename, data)
    return fut


@pytest.mark.parametrize("case", ["aocr_by_port", "port_by_aocr",
                                  "future", "foreign"])
def test_loaders_refuse(arts, tmp_path, case):
    """Each package's loader refuses the other's artifact (the port's
    names the way to re-export), a future version and a foreign zip."""
    if case == "aocr_by_port":
        with pytest.raises(ValueError, match="python -m aocr_torch.export"):
            texport.ExportedRecognizer.load(arts["greedy", "jax"], "cpu")
    elif case == "port_by_aocr":
        with pytest.raises(ValueError, match="not an aocrx artifact"):
            jexport.ExportedRecognizer.load(arts["greedy", "torch"])
    elif case == "future":
        fut = _future(arts["greedy", "torch"], tmp_path)
        with pytest.raises(ValueError, match="version"):
            texport.ExportedRecognizer.load(fut, "cpu")
        with pytest.raises(ValueError, match="version"):
            texport.update_weights(fut, None, str(tmp_path / "u.aocrx"))
    else:
        bad = str(tmp_path / "bad.zip")
        with zipfile.ZipFile(bad, "w") as z:
            z.writestr("__meta__.json", json.dumps({"format": "other"}))
        with pytest.raises(ValueError, match="not an aocrx-torch"):
            texport.ExportedRecognizer.load(bad, "cpu")


def test_cli_round_trip(ckpt, ocr, images, tmp_path):
    """`main(argv, device="cpu")` exports the checkpoint dir with aocr's
    flags, -update_from reuses the program, and -platforms is refused
    before any load."""
    out = str(tmp_path / "cli.aocrx")
    assert texport.main(["-model_dir", ckpt[0], "-out", out,
                         "-max_len", "8", "-batch", "3"], device="cpu") == 0
    r = texport.ExportedRecognizer.load(out, "cpu")
    assert r.meta["batch"] == 3
    live = AttentionOCR.load(ckpt[0], device="cpu",
                             cfg=TConfig(use_pallas=False))
    assert r.recognize(images)[0] == live.recognize(images)[0]
    upd = str(tmp_path / "upd.aocrx")
    assert texport.main(["-model_dir", ckpt[0], "-out", upd,
                         "-update_from", out], device="cpu") == 0
    assert _members(upd) == _members(out)
    with pytest.raises(ValueError, match="moved to the serving device"):
        texport.main(["-model_dir", "missing", "-out", out, "-platforms",
                      "cpu,tpu"], device="cpu")


def test_export_refuses_bad_arguments(ocr, tmp_path):
    for kw, match in ((dict(widths=[0, 32]), "bad widths"),
                      (dict(batch=0), "batch must be >= 1")):
        with pytest.raises(ValueError, match=match):
            texport.export_recognizer(ocr, str(tmp_path / "x.aocrx"),
                                      device="cpu", **kw)


# the custom ops a kernel artifact's route holds, by (route, K)
ROUTE_OPS = {("loop", 1): "fused_greedy_loop",
             ("tail", 1): "fused_decode_tail",
             ("loop", 5): "fused_beam_loop",
             ("tail", 5): "fused_beam_tail"}


def _op_names(rec) -> set:
    """The aocr_torch:: ops in a loaded artifact's programs."""
    return {str(n.target).split(".")[1] for m in rec._programs.values()
            for n in m.graph.nodes if n.op == "call_function"
            and str(n.target).startswith("aocr_torch.")}


@pytest.mark.parametrize("route,K", sorted(ROUTE_OPS))
def test_kernel_artifact_holds_its_ops(ckpt, loaded, images, tmp_path, route,
                                       K):
    """A kernel artifact (use_pallas) traced on the CPU holds the custom
    ops of its route as nodes, and runs on the CPU through their plain
    versions, equal to the plain artifact (under the dictionary for
    beam-5); a plain artifact holds none."""
    m = AttentionOCR.load(ckpt[0], device="cpu", cfg=TConfig(
        **KW, pallas_greedy=route, pallas_beam=route))
    if K > 1:
        m.use_dictionary(LEXICON)
    art = str(tmp_path / "k.aocrx")
    texport.export_recognizer(m, art, beam_size=K, use_pallas=True,
                              batch=2 if K > 1 else "poly", device="cpu")
    rec = texport.ExportedRecognizer.load(art, "cpu")
    assert _op_names(rec) == {"conv1_relu_pool", "lstm_fwd_scan",
                              ROUTE_OPS[route, K]}
    plain = loaded["greedy" if K == 1 else "dict-beam5"]
    assert _op_names(plain) == set()
    got_w, got_s = rec.recognize(images)
    want_w, want_s = plain.recognize(images)
    assert got_w == want_w
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", ["greedy", "beam5", "dict-beam5"])
@pytest.mark.parametrize("route", ["plain", "tail"])
def test_decode_without_early_exit_matches(ocr, images, mode, route):
    """Running every host-loop step (early_exit=False, what export traces)
    gives the same labels and scores as stopping once all rows froze."""
    cfg = ocr.cfg.replace(use_pallas=route == "tail", pallas_greedy=route,
                          pallas_beam=route)
    trie = None
    if mode == "dict-beam5":
        ocr.use_dictionary(LEXICON)
        trie = ocr.dictionary_table
        ocr.clear_dictionary()
    K = 1 if mode == "greedy" else 5
    x = torch.from_numpy(images)
    with torch.no_grad():
        outs = [decode.beam_decode(ocr.params, ocr.batch_stats, x, cfg, K,
                                   12, trie_table=trie, early_exit=e)
                for e in (True, False)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


class _Recorder(TorchDispatchMode):
    """The first call of each aocr_torch:: op: {name: (op, args, kwargs)}."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "aocr_torch":
            self.calls.setdefault(func._opname, (func, args, kwargs or {}))
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def op_calls(ckpt, images):
    """Each op's first call on a decode of two images on its route."""
    rec = _Recorder()
    x = torch.from_numpy(images[:2])
    m = AttentionOCR.load(ckpt[0], device="cpu", cfg=TConfig(**KW))
    m.use_dictionary(LEXICON)
    with torch.no_grad(), rec:
        for route, K in sorted(ROUTE_OPS):
            cfg = m.cfg.replace(pallas_greedy=route, pallas_beam=route)
            decode.beam_decode(m.params, m.batch_stats, x, cfg, K, 4,
                               trie_table=m.dictionary_table)
    return rec.calls


@pytest.mark.parametrize("name", ["conv1_relu_pool", "lstm_fwd_scan",
                                  "fused_greedy_loop", "fused_decode_tail",
                                  "fused_beam_loop", "fused_beam_tail"])
def test_op_passes_opcheck(op_calls, name):
    """torch.library.opcheck (schema, fake version, autograd registration,
    AOT dispatch with dynamic shapes) on the CPU at the arguments a
    decode gave each op; the module's OPS name all six."""
    assert len(cuda.OPS) == 6
    func, args, kwargs = op_calls[name]
    torch.library.opcheck(func, args, kwargs)
