"""aocr_torch decode kernels and greedy decoding against the JAX reference
on CPU.

Seeded numpy inputs and weights go through the JAX function -- its Pallas
decode kernels in interpret mode, or its XLA route -- and through the
port, whose kernel wrappers run their plain versions on CPU tensors.

Tolerances: float32 h~ and per-step log-probs within 1e-5, cumulative
scores within 1e-4 (sums of up to T log-probs), labels identical.  In
bfloat16 h~ within 2e-2 (one bf16 step of a matmul operand moves it by
about that much) and tokens identical wherever the port's best
log-prob beats the runner-up by more than 1e-2.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aocr import decode as jdecode
from aocr import vocab
from aocr.config import Config
from aocr.models import cnn as jcnn
from aocr.models import decoder as jdecoder
from aocr.models import head as jhead
from aocr.models import model as jmodel
from aocr.ops import lstm as jlstm
from aocr.ops.pallas import decode_step as jds
from aocr.ops.pallas import greedy_loop as jgl
from aocr_torch import decode, weights
from aocr_torch.models import decoder, head
from aocr_torch.ops.cuda import decode_step, greedy_loop
from tests import synth

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
H, L, V, E = 128, 6, 39, 8


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _dec_params(seed):
    dec = jax.tree.map(np.asarray, jdecoder.init_params(
        jax.random.PRNGKey(seed), V, E, H, 2, True))
    proj = jax.tree.map(np.asarray, jhead.init_params(
        jax.random.PRNGKey(seed + 1), H, V))
    tp, _ = weights.from_numpy({"decoder": dec, "projector": proj}, {})
    return dec, proj, tp["decoder"], tp["projector"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 5])
def test_fused_decode_tail_matches_kernel(dtype, B):
    jd, td = DT[dtype]
    rs = np.random.RandomState(40 + B)
    dec, proj, _, tproj = _dec_params(7)
    h = rs.uniform(-1, 1, (B, H)).astype(np.float32)
    ctx = rs.uniform(-1, 1, (L, B, H)).astype(np.float32)
    prev = rs.choice([vocab.GO, vocab.EOS, vocab.PAD, 5, 17],
                     size=(B,)).astype(np.int32)
    prev[0] = vocab.GO
    pw_j, pb_j = jds.pad_projector(jnp.asarray(proj["w"]),
                                   jnp.asarray(proj["b"]))
    ht_j, tok_j, d_j = jds.fused_decode_tail(
        jnp.asarray(h), jnp.asarray(ctx).astype(jd), jnp.asarray(prev),
        jnp.asarray(dec["w_a"]).astype(jd), jnp.asarray(dec["w_c"]).astype(jd),
        pw_j.astype(jd), pb_j, interpret=True)
    pw, pb = decode_step.pad_projector(tproj["w"].to(td), tproj["b"])
    np.testing.assert_array_equal(pb.numpy(), _np(pb_j)[0])
    ht, tok, d = decode_step.fused_decode_tail(
        _t(h), _t(ctx, td), torch.from_numpy(prev), _t(dec["w_a"], td),
        _t(dec["w_c"], td), pw, pb)
    assert ht.dtype == torch.float32 and tok.dtype == torch.int32
    frozen = np.isin(prev, [vocab.PAD, vocab.EOS])
    assert (tok.numpy()[frozen] == vocab.PAD).all()
    np.testing.assert_array_equal(d.numpy()[frozen], 0.0)
    if dtype == "float32":
        np.testing.assert_allclose(ht.numpy(), _np(ht_j), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))
        np.testing.assert_allclose(d.numpy(), _np(d_j), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(ht.numpy(), _np(ht_j), atol=2e-2)
        _, logp = decode_step.attention_logp_tail(
            _t(h, td), _t(ctx, td), _t(dec["w_a"], td), _t(dec["w_c"], td),
            pw, pb, td)
        top2 = logp.topk(2, dim=-1).values
        clear = ((top2[:, 0] - top2[:, 1]) > 1e-2).numpy() | frozen
        np.testing.assert_array_equal(tok.numpy()[clear],
                                      np.asarray(tok_j)[clear])


@pytest.mark.parametrize("B", [1, 5])
def test_fused_greedy_loop_matches_kernel(B):
    T = 7
    rs = np.random.RandomState(50 + B)
    dec, proj, tdec, tproj = _dec_params(9)
    ctx = rs.uniform(-1, 1, (L, B, H)).astype(np.float32)
    c0 = rs.uniform(-1, 1, (B, H)).astype(np.float32)
    h0 = rs.uniform(-1, 1, (B, H)).astype(np.float32)
    tables_j = jgl.build_tables(jax.tree.map(jnp.asarray, dec),
                                jax.tree.map(jnp.asarray, proj), E, True,
                                jnp.float32)
    lab_j, sc_j = jgl.fused_greedy_loop(
        jnp.asarray(ctx), jnp.asarray(c0), jnp.asarray(h0), tables_j, 2,
        True, T, interpret=True)
    tables = greedy_loop.build_tables(tdec, tproj, E, True, torch.float32)
    np.testing.assert_allclose(tables["eg"].numpy(),
                               _np(tables_j["eg"])[:V], rtol=1e-6, atol=1e-6)
    lab, sc = greedy_loop.fused_greedy_loop(_t(ctx), _t(c0), _t(h0), tables,
                                            2, True, T)
    assert lab.dtype == torch.int32 and tuple(lab.shape) == (B, T)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_j))
    np.testing.assert_allclose(sc.numpy(), _np(sc_j), rtol=1e-5, atol=1e-4)


def _jax_model(seed):
    """A small model whose transcripts depend on the image: the reference
    init, with weights scaled up so that rows differ and some emit EOS
    (at init the CNN features barely vary between images)."""
    cfg = Config(input_feed=True, encoder_num_hidden=64,
                 target_embedding_size=E, max_decoder_l=8,
                 seed=seed).validate()
    ms = jmodel.init(jax.random.PRNGKey(seed), cfg)
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
    return cfg, jax.tree.map(jnp.asarray, p), ms.batch_stats


WORDS = ["ab", "cd", "e1", "xyz", "0"]


def _images(B, W):
    return np.stack([synth.render_word(w, 32, W)
                     for w in WORDS[:B]])[..., None].astype(np.float32)


@pytest.mark.parametrize("route", ["loop", "tail", "xla"])
@pytest.mark.parametrize("B,W", [(1, 32), (5, 100), (5, 81)])
def test_greedy_decode_matches_reference(monkeypatch, route, B, W):
    """End to end in float32: JAX greedy_decode with its conv1, lstm_fwd
    and decode kernels in interpret mode (or its XLA route) against the
    port's route of the same name."""
    # a distinct cfg per route: Config is greedy_decode's jit key, and the
    # interpret flags are read while tracing
    seed = {"loop": 901, "tail": 902, "xla": 903}[route]
    cfg, params, stats = _jax_model(seed)
    cfg = cfg.replace(use_pallas=route != "xla",
                      pallas_greedy="tail" if route == "tail" else "auto")
    images = _images(B, W)
    kernels = route != "xla"
    monkeypatch.setattr(jdecode, "_PALLAS_GREEDY_INTERPRET", kernels)
    monkeypatch.setattr(jcnn, "_PALLAS_CONV1_INTERPRET", kernels)
    monkeypatch.setattr(jlstm, "_PALLAS_LSTM_FWD_INTERPRET", kernels)
    monkeypatch.setattr(jlstm, "_SCAN_VJP_CACHE", {})
    lab_j, sc_j = jdecode.greedy_decode(params, stats, jnp.asarray(images),
                                        cfg, cfg.max_decoder_l)
    lab_j, sc_j = np.asarray(lab_j), _np(sc_j)
    tp, ts = weights.from_numpy(jax.tree.map(np.asarray, params),
                                jax.tree.map(np.asarray, stats))
    lab, sc = decode.greedy_decode(tp, ts, torch.from_numpy(images), cfg,
                                   cfg.max_decoder_l)
    np.testing.assert_array_equal(lab.numpy(), lab_j)
    np.testing.assert_allclose(sc.numpy(), sc_j, rtol=1e-5, atol=1e-4)


def test_decoder_step_and_head_match_reference():
    """The XLA-route pieces: decoder.step (lstm_stack + attention with q
    and alpha rounded to the compute dtype) and head.apply."""
    B = 5
    rs = np.random.RandomState(70)
    dec, proj, tdec, tproj = _dec_params(11)
    ctx = rs.uniform(-1, 1, (B, L, H)).astype(np.float32)
    c0 = rs.uniform(-1, 1, (B, H)).astype(np.float32)
    h0 = rs.uniform(-1, 1, (B, H)).astype(np.float32)
    toks = np.array([vocab.GO, 5, 7, vocab.EOS, 30], np.int32)
    st_j = jdecoder.init_state((jnp.asarray(c0), jnp.asarray(h0)), 2)
    st_j, ht_j = jdecoder.step(jax.tree.map(jnp.asarray, dec), st_j,
                               jnp.asarray(toks), jnp.asarray(ctx),
                               input_feed=True)
    st_j, ht_j = jdecoder.step(jax.tree.map(jnp.asarray, dec), st_j,
                               jnp.asarray(toks), jnp.asarray(ctx),
                               input_feed=True)
    lp_j = jhead.apply(jax.tree.map(jnp.asarray, proj), ht_j)
    prep = decoder.prepare(tdec, torch.float32)
    st = decoder.init_state((_t(c0), _t(h0)), 2)
    for _ in range(2):
        st, ht = decoder.step(prep, st, torch.from_numpy(toks), _t(ctx),
                              input_feed=True)
    lp = head.apply(tproj, ht)
    np.testing.assert_allclose(ht.numpy(), _np(ht_j), rtol=1e-5, atol=1e-5)
    for a, b in zip(st.cs + st.hs, st_j.cs + st_j.hs):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lp.numpy(), _np(lp_j), rtol=1e-5, atol=1e-5)


def test_beam_search_is_not_ported():
    cfg, params, stats = _jax_model(904)
    tp, ts = weights.from_numpy(jax.tree.map(np.asarray, params),
                                jax.tree.map(np.asarray, stats))
    with pytest.raises(NotImplementedError, match="slice 3"):
        decode.beam_decode(tp, ts, torch.zeros((1, 32, 32, 1)), cfg,
                           beam_size=5, max_len=4)
