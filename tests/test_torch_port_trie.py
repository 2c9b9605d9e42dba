"""aocr_torch's own copies of the framework-neutral modules (config, vocab,
checkpoint, utils/trie, utils/logging_util, utils/native) against the JAX package's originals, and greedy
dictionary decoding against `aocr.decode.greedy_decode(..., use_trie=True)`
on CPU: the port's loop, tail and plain routes against aocr's XLA path and
its greedy_loop / decode_step kernels in interpret mode.

Tolerances: tables, token ids and float32 labels identical; scores within
1e-5 relative.
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import os
from dataclasses import asdict

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aocr import checkpoint as jcheckpoint
from aocr import config as jconfig
from aocr import decode as jdecode
from aocr import vocab as jvocab
from aocr.models import decoder as jdecoder
from aocr.models import head as jhead
from aocr.models import model as jmodel
from aocr.ops.pallas import decode_step as jds
from aocr.ops.pallas import greedy_loop as jgl
from aocr.utils import trie as jtrie
from aocr_torch import checkpoint, config, decode, vocab, weights
from aocr_torch.ops.cuda import decode_step, greedy_loop
from aocr_torch.utils import trie
from tests import synth

LEXICON = ["ab", "cd", "e1", "xyz", "abc", "zq", "m", "e10", "0"]


def test_config_copy_equals_the_original():
    assert asdict(config.Config()) == asdict(jconfig.Config())
    assert config.GEOMETRY_FIELDS == jconfig.GEOMETRY_FIELDS
    assert config.STRUCT_FIELDS == jconfig.STRUCT_FIELDS
    kw = dict(input_feed=True, beam_size=5, compute_dtype="bfloat16")
    assert asdict(config.Config(**kw).validate()) == \
        asdict(jconfig.Config(**kw).validate())


def test_vocab_copy_equals_the_original():
    assert (vocab.PAD, vocab.GO, vocab.EOS, vocab.VOCAB_SIZE) == \
        (jvocab.PAD, jvocab.GO, jvocab.EOS, jvocab.VOCAB_SIZE)
    chars = "0123456789abcdefghijklmnopqrstuvwxyz"
    assert [vocab.char_to_id(c) for c in chars] == \
        [jvocab.char_to_id(c) for c in chars]
    words = ["hello", "World", "42", "a", "xyz0"]
    for a, b in zip(vocab.encode_batch(words), jvocab.encode_batch(words)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert vocab.decode(jvocab.encode("abc")[1:]) == "abc"


@pytest.mark.parametrize("writer", ["port", "aocr"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """An npz-v2 checkpoint written by either package's checkpoint module
    loads in the other with the same arrays, config and step."""
    rs = np.random.RandomState(0)
    params = {"a": {"w": rs.standard_normal((3, 4)).astype(np.float32)},
              "layers": [{"b": np.arange(5, dtype=np.float32)}]}
    stats = {"bn": {"mean": np.zeros(4, np.float32)}}
    cfg = asdict(config.Config(beam_size=3))
    save, load = ((checkpoint.save, jcheckpoint.load) if writer == "port"
                  else (jcheckpoint.save, checkpoint.load))
    save(str(tmp_path), params, stats, cfg, 7, {"learning_rate": 0.5})
    ck = load(jcheckpoint.final_path(str(tmp_path)))
    jax.tree.map(np.testing.assert_array_equal, ck["params"], params)
    jax.tree.map(np.testing.assert_array_equal, ck["batch_stats"], stats)
    assert ck["config"]["beam_size"] == 3 and ck["global_step"] == 7


def _code(module) -> str:
    """A module's AST with every docstring dropped."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(module))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("name", ["utils.logging_util", "utils.native"])
def test_host_module_copy_equals_the_original(name, tmp_path):
    """The port's copies of the logger and the native-library bindings
    hold the originals' code, docstrings aside, and take the same host
    path: the same library (or the same numpy fallback), the same edit
    distances and resizes, the same log lines."""
    import importlib

    mine = importlib.import_module(f"aocr_torch.{name}")
    orig = importlib.import_module(f"aocr.{name}")
    assert _code(mine) == _code(orig)
    if name == "utils.native":
        assert mine.available() == orig.available()
        rs = np.random.RandomState(4)
        pred = rs.randint(0, 12, (6, 9)).astype(np.int32)
        gold = rs.randint(0, 12, (6, 9)).astype(np.int32)
        for a, b in ((mine.edit_distance_batch(pred, gold, 2),
                      orig.edit_distance_batch(pred, gold, 2)),
                     (mine.luminance_resize(pred.astype(np.float32), 4, 5),
                      orig.luminance_resize(pred.astype(np.float32), 4, 5))):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
    else:
        for mod, f in ((mine, "a.txt"), (orig, "b.txt")):
            log = mod.Logger(str(tmp_path / f))
            log.info("line 1")
            log.shutdown()
        lines = [(tmp_path / f).read_text().split(" ", 2)[2]
                 for f in ("a.txt", "b.txt")]
        assert lines[0] == lines[1] == "line 1\n"


@pytest.mark.parametrize("words,digit_prefix", [
    (["talking", "walking", "balking", "walk", "talk", "a"], False),
    (["hello", "héllo", "it's", "ok", "", "  Ok  ", "x-ray", "xray"], False),
    (["cat", "car", "7up", "42nd", "street"], True),
])
def test_transition_table_equals_the_original(words, digit_prefix):
    """Shared suffixes (minimized into one chain), out-of-vocabulary and
    blank words (skipped), case folding, and allow_digit_prefix: the two
    builders give the same table bit for bit."""
    got = trie.build_transition_table(words, digit_prefix)
    want = jtrie.build_transition_table(words, digit_prefix)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_load_dictionary_cache_round_trip(tmp_path):
    p = tmp_path / "words.txt"
    p.write_text("cat\ncar\ndog\n")
    t1 = trie.load_dictionary(str(p))
    cache = str(p) + ".dp0.dawg.npz"
    assert os.path.exists(cache)
    # warm: the port's cache entry serves both packages
    np.testing.assert_array_equal(trie.load_dictionary(str(p)), t1)
    np.testing.assert_array_equal(jtrie.load_dictionary(str(p)), t1)
    p.write_text("cat\n")
    os.utime(p, ns=(1, 1))
    t2 = trie.load_dictionary(str(p))
    assert t2.shape[0] < t1.shape[0]
    np.testing.assert_array_equal(t2, jtrie.build_transition_table(["cat"]))


def _jax_model(seed, **kw):
    """Both packages' Configs from the same arguments, and the reference
    init sharpened so that transcripts depend on the image
    (test_torch_port_decode._jax_model)."""
    base = dict(input_feed=True, encoder_num_hidden=64,
                target_embedding_size=8, max_decoder_l=8, seed=seed)
    base.update(kw)
    jcfg = jconfig.Config(**base).validate()
    ms = jmodel.init(jax.random.PRNGKey(seed), jcfg)
    p = jax.tree.map(lambda a: np.array(a), ms.params)
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
    return (jcfg, config.Config(**base).validate(), p,
            jax.tree.map(np.asarray, ms.batch_stats))


@pytest.mark.parametrize("route", ["loop", "tail", "plain"])
@pytest.mark.parametrize("words", [LEXICON, ["zz", "zq"]])
def test_greedy_trie_matches_reference(monkeypatch, route, words):
    """Dictionary greedy decoding end to end in float32: every port route
    against aocr's XLA path and its kernel of the same name in interpret
    mode (the loop kernel's in-kernel trie, the tail's per-step plane)."""
    seed = {"loop": 911, "tail": 912, "plain": 913}[route] + len(words)
    jcfg, cfg, p, stats = _jax_model(seed)
    table = jtrie.build_transition_table(words)
    images = np.stack([synth.render_word(w, 32, 100) for w in
                       ["ab", "cd", "e1", "xyz", "0"]])[..., None]
    images = images.astype(np.float32)
    kernel = route != "plain"
    pallas_greedy = "tail" if route == "tail" else "auto"
    tp, ts = weights.from_numpy(p, stats)
    lab, sc = decode.greedy_decode(
        tp, ts, torch.from_numpy(images),
        cfg.replace(use_pallas=kernel, pallas_greedy=pallas_greedy),
        cfg.max_decoder_l, trie_table=torch.from_numpy(table))
    wants = [(False, jcfg.replace(use_pallas=False))]
    if kernel:
        wants.append((True, jcfg.replace(pallas_greedy=pallas_greedy)))
    for interpret, jc in wants:
        monkeypatch.setattr(jdecode, "_PALLAS_GREEDY_INTERPRET", interpret)
        lab_j, sc_j = jdecode.greedy_decode(
            jax.tree.map(jnp.asarray, p), stats, jnp.asarray(images), jc,
            jcfg.max_decoder_l, jnp.asarray(table), use_trie=True)
        np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_j))
        np.testing.assert_allclose(sc.numpy(), np.asarray(sc_j), rtol=1e-5,
                                   atol=1e-6)
    # every transcript is a lexicon word (or empty: no EOS within T)
    for row in lab.numpy():
        text = vocab.decode(row)
        assert text in words or (vocab.EOS not in row)


def _dec_params(seed, H=128, V=39, E=8):
    dec = jax.tree.map(np.array, jdecoder.init_params(
        jax.random.PRNGKey(seed), V, E, H, 2, True))
    proj = jax.tree.map(np.array, jhead.init_params(
        jax.random.PRNGKey(seed + 1), H, V))
    proj["w"] *= 6
    tp, _ = weights.from_numpy({"decoder": dec, "projector": proj}, {})
    return dec, proj, tp["decoder"], tp["projector"]


def test_fused_decode_tail_valid_plane_matches_kernel():
    """decode_step's plain version with a trie plane against aocr's
    fused_decode_tail(valid=) in interpret mode, frozen rows included."""
    B, L, H = 6, 6, 128
    rs = np.random.RandomState(21)
    dec, proj, tdec, tproj = _dec_params(23)
    h = rs.uniform(-1, 1, (B, H)).astype(np.float32)
    ctx = rs.uniform(-1, 1, (L, B, H)).astype(np.float32)
    prev = np.array([vocab.GO, 5, vocab.EOS, 17, vocab.PAD, 9], np.int32)
    pw_j, pb_j = jds.pad_projector(jnp.asarray(proj["w"]),
                                   jnp.asarray(proj["b"]))
    valid = (rs.uniform(size=(B, pw_j.shape[1])) < 0.2).astype(np.float32)
    valid[:, 39:] = 0
    valid[:2, vocab.PAD] = 0
    out_j = jds.fused_decode_tail(
        jnp.asarray(h), jnp.asarray(ctx), jnp.asarray(prev),
        jnp.asarray(dec["w_a"]), jnp.asarray(dec["w_c"]), pw_j, pb_j,
        interpret=True, valid=jnp.asarray(valid))
    pw, pb = decode_step.pad_projector(tproj["w"], tproj["b"])
    out = decode_step.fused_decode_tail(
        torch.from_numpy(h), torch.from_numpy(ctx), torch.from_numpy(prev),
        tdec["w_a"], tdec["w_c"], pw, pb, valid=torch.from_numpy(valid))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(out_j[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(out_j[1]))
    np.testing.assert_allclose(out[2].numpy(), np.asarray(out_j[2]),
                               rtol=1e-5, atol=1e-5)
    live = ~np.isin(prev, [vocab.PAD, vocab.EOS])
    assert (valid[live, out[1].numpy()[live]] > 0).all()


@pytest.mark.parametrize("B", [1, 5])
def test_fused_greedy_loop_trie_matches_kernel(B):
    """greedy_loop's plain version with the in-kernel trie against aocr's
    fused_greedy_loop(trie_table=) in interpret mode."""
    T, L, H = 7, 6, 128
    rs = np.random.RandomState(30 + B)
    dec, proj, tdec, tproj = _dec_params(31)
    ctx = rs.uniform(-1, 1, (L, B, H)).astype(np.float32)
    c0 = rs.uniform(-1, 1, (B, H)).astype(np.float32)
    h0 = rs.uniform(-1, 1, (B, H)).astype(np.float32)
    table = jtrie.build_transition_table(LEXICON)
    tables_j = jgl.build_tables(jax.tree.map(jnp.asarray, dec),
                                jax.tree.map(jnp.asarray, proj), 8, True,
                                jnp.float32)
    lab_j, sc_j = jgl.fused_greedy_loop(
        jnp.asarray(ctx), jnp.asarray(c0), jnp.asarray(h0), tables_j, 2,
        True, T, interpret=True, trie_table=jnp.asarray(table))
    tables = greedy_loop.build_tables(tdec, tproj, 8, True, torch.float32)
    lab, sc = greedy_loop.fused_greedy_loop(
        torch.from_numpy(ctx), torch.from_numpy(c0), torch.from_numpy(h0),
        tables, 2, True, T, trie_table=torch.from_numpy(table))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_j))
    np.testing.assert_allclose(sc.numpy(), np.asarray(sc_j), rtol=1e-5,
                               atol=1e-5)
    for row in lab.numpy():
        assert vocab.decode(row) in LEXICON or vocab.EOS not in row
