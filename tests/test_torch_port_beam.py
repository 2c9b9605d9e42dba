"""aocr_torch beam search, with and without a dictionary, against the JAX
reference on CPU.

Seeded weights (the reference init, sharpened so that transcripts depend
on the image and rows stop at different steps) and word images go through
`aocr.decode.beam_decode` -- on its XLA path, and with its beam_step /
beam_loop Pallas kernels in interpret mode -- and through the port's
plain, tail and loop routes, whose kernel wrappers run their plain
versions on CPU tensors.  The two packages get Configs built from the same
keyword arguments.

Tolerances: float32 labels, parents, tokens and refill counts identical;
scores within 1e-5 relative (sums of up to T float32 log-probs taken in
another order).  In bfloat16 agreement is reported, not asserted: near-
ties flip on random weights (ROADMAP.md, "How the port is judged").
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aocr import decode as jdecode
from aocr.config import Config as JConfig
from aocr.models import decoder as jdecoder
from aocr.models import model as jmodel
from aocr.ops.pallas import beam_loop as jbl
from aocr.ops.pallas import beam_step as jbs
from aocr.ops.pallas import decode_step as jds
from aocr.ops.pallas import greedy_loop as jgl
from aocr.utils import trie as jtrie
from aocr_torch import decode, vocab, weights
from aocr_torch.config import Config
from aocr_torch.models import decoder
from aocr_torch.ops.cuda import beam_loop, beam_step, decode_step, greedy_loop
from tests import synth

WORDS = ["ab", "cd", "e1", "xyz", "0", "qq", "m", "zz", "fg"]
LEXICON = ["ab", "cd", "e1", "xyz", "abc", "zq", "m", "e10"]


def _cfgs(**kw):
    """The reference's and the port's Config from the same arguments."""
    base = dict(input_feed=True, encoder_num_hidden=64,
                target_embedding_size=8, max_decoder_l=8, image_width=32)
    base.update(kw)
    return JConfig(**base).validate(), Config(**base).validate()


def _model(seed, jcfg):
    """Reference init with weights scaled up so that rows differ and some
    emit EOS early (test_torch_port_decode._jax_model)."""
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
    stats = jax.tree.map(np.asarray, ms.batch_stats)
    return p, stats


def _images(B, W=32):
    return np.stack([synth.render_word(w, 32, W)
                     for w in WORDS[:B]])[..., None].astype(np.float32)


def _jax_beam(monkeypatch, p, stats, images, jcfg, K, route, table):
    """aocr's beam_decode: 'xla' (use_pallas=False), or its 'tail' or
    'loop' kernel in interpret mode."""
    monkeypatch.setattr(jdecode, "_PALLAS_BEAM_INTERPRET", route == "tail")
    monkeypatch.setattr(jdecode, "_PALLAS_BEAM_LOOP_INTERPRET",
                        route == "loop")
    cfg = jcfg.replace(use_pallas=route != "xla",
                       pallas_beam="tail" if route == "tail" else "auto")
    kw = {}
    if table is not None:
        kw = dict(trie_table=jnp.asarray(table), use_trie=True,
                  return_refills=True)
    out = jdecode.beam_decode(jax.tree.map(jnp.asarray, p), stats,
                              jnp.asarray(images), cfg, K,
                              jcfg.max_decoder_l, **kw)
    return jax.tree.map(np.asarray, out)


def _port_beam(p, stats, images, cfg, K, route, table):
    cfg = cfg.replace(use_pallas=route != "plain",
                      pallas_beam="tail" if route == "tail" else "auto")
    tp, ts = weights.from_numpy(p, stats)
    kw = {}
    if table is not None:
        kw = dict(trie_table=torch.from_numpy(table), return_refills=True)
    out = decode.beam_decode(tp, ts, torch.from_numpy(images), cfg, K,
                             cfg.max_decoder_l, **kw)
    return jax.tree.map(lambda t: t.numpy(), out)


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)
    if len(want) > 2:  # (refills, min_valid)
        assert (int(got[2][0]), int(got[2][1])) == \
            (int(want[2][0]), int(want[2][1]))


CASES = {
    "K2_no_input_feed": dict(K=2, B=5, input_feed=False),
    "K5": dict(K=5, B=7),
    "K12_tail": dict(K=12, B=3),
    "K5_trie_refills": dict(K=5, B=6, trie=["zz", "zq", "ab"]),
    "K3_trie_lennorm": dict(K=3, B=9, trie=LEXICON, length_normalize=True),
}
_XLA: dict = {}  # aocr's XLA result of each case, shared by the routes


@pytest.mark.parametrize("route", ["plain", "tail", "loop"])
@pytest.mark.parametrize("case", list(CASES))
def test_beam_decode_matches_reference(monkeypatch, case, route):
    """float32, end to end: the port's route against aocr's XLA path and,
    for the kernel routes, against its kernel of the same name in
    interpret mode (a K above beam_loop.MAX_K takes the tail on both)."""
    c = dict(CASES[case])
    K, B = c.pop("K"), c.pop("B")
    words = c.pop("trie", None)
    table = None if words is None else jtrie.build_transition_table(words)
    seed = 300 + list(CASES).index(case)
    jcfg, cfg = _cfgs(seed=seed, **c)
    p, stats = _model(seed, jcfg)
    images = _images(B)
    got = _port_beam(p, stats, images, cfg, K, route, table)
    if case not in _XLA:
        _XLA[case] = _jax_beam(monkeypatch, p, stats, images, jcfg, K, "xla",
                               table)
    _assert_same(got, _XLA[case])
    if route != "plain":
        _assert_same(got, _jax_beam(monkeypatch, p, stats, images, jcfg, K,
                                    route, table))
    if case == "K5_trie_refills":
        assert int(got[2][0]) > 0 and int(got[2][1]) < K


def test_beam_decode_transcripts_vary():
    """The fixture is not degenerate: beam-5 transcripts differ between
    images, some end before T, and beam-5 scores are at least greedy's."""
    jcfg, cfg = _cfgs(seed=301)
    p, stats = _model(301, jcfg)
    images = _images(7)
    lab5, sc5 = _port_beam(p, stats, images, cfg, 5, "loop", None)
    lab1, sc1 = _port_beam(p, stats, images, cfg, 1, "loop", None)
    assert len({tuple(r) for r in lab5}) >= 3
    assert (lab5 == 0).any()
    assert (sc5 >= sc1 - 1e-5).all()


def _beam_step_case(seed, B, K, H=128, L=6, V=39):
    rs = np.random.RandomState(seed)
    dec = jax.tree.map(np.array, jdecoder.init_params(
        jax.random.PRNGKey(seed), V, 8, H, 2, True))
    pw = rs.uniform(-0.5, 0.5, (H, V)).astype(np.float32)
    pb = rs.uniform(-1, 1, (V,)).astype(np.float32)
    h = rs.uniform(-1, 1, (B, K * H)).astype(np.float32)
    ctx = rs.uniform(-1, 1, (L, B, H)).astype(np.float32)
    prev = rs.choice([5, 17, 30, vocab.PAD, vocab.EOS],
                     size=(B, K)).astype(np.int32)
    prev[0] = 5
    scores = np.sort(rs.uniform(-6, -1, (B, K)).astype(np.float32))[:, ::-1]
    return dec, pw, pb, h, ctx, prev, np.ascontiguousarray(scores)


@pytest.mark.parametrize("use_trie", [False, True])
def test_fused_beam_tail_matches_kernel(use_trie):
    """beam_step's plain version against aocr's fused_beam_tail in
    interpret mode: h~, scores, parents, tokens, and the valid counts of a
    plane that leaves some rows fewer than K candidates."""
    B, K, V = 5, 3, 39
    dec, pw, pb, h, ctx, prev, scores = _beam_step_case(61, B, K)
    pw_j, pb_j = jds.pad_projector(jnp.asarray(pw), jnp.asarray(pb))
    vp = pw_j.shape[1]
    valid = None
    if use_trie:
        rs = np.random.RandomState(62)
        valid = (rs.uniform(size=(B, K, vp)) < 0.3).astype(np.float32)
        valid[:, :, V:] = 0
        valid[0, :, :] = 0
        valid[0, 0, 7] = 1  # row 0: one valid candidate, K - 1 refills
        valid = valid.reshape(B, K * vp)
    out_j = jbs.fused_beam_tail(
        jnp.asarray(ctx), jnp.asarray(h), jnp.asarray(prev),
        jnp.asarray(scores), jnp.asarray(dec["w_a"]), jnp.asarray(dec["w_c"]),
        pw_j, pb_j, K, V, interpret=True,
        valid=None if valid is None else jnp.asarray(valid))
    tpw, tpb = decode_step.pad_projector(torch.from_numpy(pw),
                                         torch.from_numpy(pb))
    out = beam_step.fused_beam_tail(
        torch.from_numpy(ctx), torch.from_numpy(h), torch.from_numpy(prev),
        torch.from_numpy(scores), torch.from_numpy(dec["w_a"]),
        torch.from_numpy(dec["w_c"]), tpw, tpb, K, V,
        valid=None if valid is None else torch.from_numpy(valid))
    assert len(out) == len(out_j) == (5 if use_trie else 4)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(out_j[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(out_j[1]),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(out[2:], out_j[2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if use_trie:
        assert out[4][0] == 1 and (out[2][0] == out[2][0, 0]).all()


def _loop_case(seed, B, K, nl, input_feed, table):
    """Decoder tables and a t=1 state for fused_beam_loop, in both
    packages: (jax args, port args)."""
    H, L, V, E = 128, 6, 39, 8
    rs = np.random.RandomState(seed)
    dec = jax.tree.map(np.array, jdecoder.init_params(
        jax.random.PRNGKey(seed), V, E, H, nl, input_feed))
    for layer in dec["layers"]:
        layer["wi"] *= 3
        layer["wh"] *= 3
    proj = {"w": rs.uniform(-1.5, 1.5, (H, V)).astype(np.float32),
            "b": rs.uniform(-1, 1, (V,)).astype(np.float32)}
    proj["b"][vocab.EOS] += 2.0  # so that beams stop at different steps
    ctx = rs.uniform(-1, 1, (L, B, H)).astype(np.float32)
    st = [rs.uniform(-1, 1, (B, H)).astype(np.float32)
          for _ in range(1 + 2 * nl)]
    tok0 = rs.randint(3, V, (B, K)).astype(np.int32)
    sc0 = np.sort(rs.uniform(-4, -1, (B, K)).astype(np.float32))[:, ::-1]
    sc0 = np.ascontiguousarray(sc0)
    nodes0 = None
    if table is not None:
        roots = np.nonzero(table[0] >= 0)[0]
        tok0 = rs.choice(roots, (B, K)).astype(np.int32)
        nodes0 = np.maximum(table[0][tok0], 0).astype(np.int32)
    jst = jdecoder.DecoderState(attn=jnp.asarray(st[0]),
                                cs=tuple(jnp.asarray(a) for a in st[1::2]),
                                hs=tuple(jnp.asarray(a) for a in st[2::2]))
    jt = jgl.build_tables(jax.tree.map(jnp.asarray, dec),
                          jax.tree.map(jnp.asarray, proj), E, input_feed,
                          jnp.float32)
    tp, _ = weights.from_numpy({"decoder": dec, "projector": proj}, {})
    tt = greedy_loop.build_tables(tp["decoder"], tp["projector"], E,
                                  input_feed, torch.float32)
    tst = decoder.DecoderState(attn=torch.from_numpy(st[0]),
                               cs=tuple(map(torch.from_numpy, st[1::2])),
                               hs=tuple(map(torch.from_numpy, st[2::2])))
    j = (jnp.asarray(ctx), jst, jnp.asarray(tok0), jnp.asarray(sc0),
         None if nodes0 is None else jnp.asarray(nodes0), jt)
    t = (torch.from_numpy(ctx), tst, torch.from_numpy(tok0),
         torch.from_numpy(sc0),
         None if nodes0 is None else torch.from_numpy(nodes0), tt)
    return j, t


@pytest.mark.parametrize("K,nl,input_feed,lennorm,trie", [
    (3, 2, True, False, None),
    (5, 2, True, True, ["ab", "abc", "cd", "e1", "zz"]),
    (2, 1, False, True, ["zq"]),
    (7, 2, True, False, None),  # the kernel's ragged tile: 77 of 80 rows
])
def test_fused_beam_loop_matches_kernel(K, nl, input_feed, lennorm, trie):
    """beam_loop's plain version against aocr's fused_beam_loop in
    interpret mode, from the same t=1 state: histories, scores, lengths
    and refill counts."""
    B, T = 4, 7
    table = None if trie is None else jtrie.build_transition_table(trie)
    j, t = _loop_case(70 + K, B, K, nl, input_feed, table)
    out_j = jbl.fused_beam_loop(
        *j, nl, input_feed, T, K, lennorm,
        trie_table=None if table is None else jnp.asarray(table),
        interpret=True)
    out = beam_loop.fused_beam_loop(
        *t, nl, input_feed, T, K, lennorm,
        trie_table=None if table is None else torch.from_numpy(table))
    assert len(out) == len(out_j)
    for k in (0, 1, 3):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(out_j[k]))
    np.testing.assert_allclose(out[2].numpy(), np.asarray(out_j[2]),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(out[4:], out_j[4:]):
        assert int(a) == int(b)
    assert (out[0].numpy()[1:] != 0).any()  # the search ran past t=0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_grouped_matches_reference(dtype):
    B, K, L, H = 3, 4, 6, 32
    rs = np.random.RandomState(80)
    dec = jax.tree.map(np.array, jdecoder.init_params(
        jax.random.PRNGKey(81), 39, 8, H, 1, True))
    h = rs.uniform(-1, 1, (B, K, H)).astype(np.float32)
    ctx = rs.uniform(-1, 1, (B, L, H)).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jdecoder.attention_grouped(jax.tree.map(jnp.asarray, dec),
                                      jnp.asarray(h), jnp.asarray(ctx), jd)
    tp, _ = weights.from_numpy({"decoder": dec}, {})
    got = decoder.attention_grouped(decoder.prepare(tp["decoder"], td),
                                    torch.from_numpy(h),
                                    torch.from_numpy(ctx))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    # K queries against B contexts equal K separate single-query calls
    one = decoder.attention(decoder.prepare(tp["decoder"], td),
                            torch.from_numpy(h[:, 1]), torch.from_numpy(ctx))
    np.testing.assert_allclose(got[:, 1].numpy(), one.numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("route", ["plain", "loop"])
@pytest.mark.parametrize("use_trie", [False, True])
def test_beam_row_finality_batch_independent(route, use_trie):
    """A row decoded alone equals the same row inside a batch
    (aocr's tests/test_beam_loop.py case): a fully frozen row is final,
    whatever its batchmates do.  length_normalize is where a resurrected
    beam would win."""
    table = (jtrie.build_transition_table(["a", "z", "abcdef", "zyxwvu"])
             if use_trie else None)
    jcfg, cfg = _cfgs(seed=331, length_normalize=True)
    p, stats = _model(331, jcfg)
    images = _images(5)
    lab_b, sc_b = _port_beam(p, stats, images, cfg, 3, route, table)[:2]
    for r in range(len(images)):
        lab_1, sc_1 = _port_beam(p, stats, images[r:r + 1], cfg, 3, route,
                                 table)[:2]
        np.testing.assert_array_equal(lab_1[0], lab_b[r])
        np.testing.assert_allclose(sc_1[0], sc_b[r], rtol=1e-5, atol=1e-6)


def test_bf16_beam_agreement_is_reported(monkeypatch, capsys):
    """bfloat16 beam-5, loop route against aocr's loop kernel: labels are
    well formed and finite; how many rows agree is printed, not asserted
    (near-ties on random weights)."""
    jcfg, cfg = _cfgs(seed=341, compute_dtype="bfloat16")
    p, stats = _model(341, jcfg)
    images = _images(6)
    got = _port_beam(p, stats, images, cfg, 5, "loop", None)
    want = _jax_beam(monkeypatch, p, stats, images, jcfg, 5, "loop", None)
    assert got[0].shape == want[0].shape and np.isfinite(got[1]).all()
    agree = float(np.mean([(a == b).all() for a, b in zip(got[0], want[0])]))
    print(f"bf16 beam-5 rows identical to aocr's: {agree:.2f}")
