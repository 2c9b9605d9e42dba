"""im2markup (aocr_torch/models/im2markup.py) on the port's recognize path
against its plain reference (portbench/reference/im2markup.py, the
benchmark's), float32 on
the CPU, at a tiny spec: 32 x 64 images, narrow convs, a 4 x 8 map (L =
32), encoder 8 a direction, decoder 16, V = 20, T = 8.

Tolerances: float32 on both sides, the same products in another order
and grouping (the port projects all steps' inputs at once and packs the
decoder's weights; the reference steps one row at a time), so sums of at
most a few hundred terms of size ~1 differ by a few float32 ulps; 1e-5
on activations and log-probs, 1e-4 on a score summed over 8 steps."""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import numpy as np
import pytest
import torch

from aocr_torch import decode
from aocr_torch.api import AttentionOCR
from aocr_torch.models import im2markup, model
from aocr_torch.ops.cuda import conv1_pool, greedy_loop, lstm_fwd
from portbench.reference import im2markup as ref

TINY = (("conv1", 1, 64, 3, 1, False, (2, 2)),
        ("conv2", 64, 16, 3, 1, False, (2, 2)),
        ("conv3", 16, 16, 3, 1, True, None),
        ("conv4", 16, 16, 3, 1, False, (2, 1)),
        ("conv5", 16, 32, 3, 1, True, (1, 2)),
        ("conv6", 32, 32, 3, 1, True, None))
SPEC = im2markup.Spec(convs=TINY, max_rows=4, vocab_size=20)
T = 8


def _cfg(**kw):
    return im2markup.config(encoder_num_hidden=8, target_embedding_size=6,
                            target_vocab_size=20, max_decoder_l=T,
                            image_height=32, image_width=64,
                            cnn_feature_size=32, **kw)


def _ocr(seed=0, **kw):
    """A model whose transcripts depend on the image: the conv and LSTM
    weights scaled up from the init law, BatchNorm's statistics random."""
    ocr = AttentionOCR.create(_cfg(**kw), seed=seed, device="cpu", spec=SPEC)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, conv in ocr.params["cnn"].items():
            if "w" in conv:
                conv["w"] *= 2
        for st in ocr.batch_stats.values():
            st["mean"].uniform_(-0.2, 0.2, generator=g)
            st["var"].uniform_(0.5, 1.5, generator=g)
        for d in ("encoder_fw", "encoder_bw", "decoder"):
            for layer in ocr.params[d]["layers"]:
                layer["wi"] *= 2
                layer["wh"] *= 2
        ocr.params["projector"]["w"] *= 3
    return ocr


def _images(n=5, seed=0):
    rng = np.random.RandomState(seed)
    return rng.uniform(0, 255, (n, 32, 64)).astype(np.float32)


def _context(ocr, x):
    with torch.inference_mode():
        return im2markup.encode(ocr.params, ocr.batch_stats,
                                torch.from_numpy(x), ocr.cfg, SPEC)


@pytest.mark.parametrize("kernels", [True, False])
def test_context_matches_reference(kernels):
    ocr = _ocr(use_pallas=kernels)
    x = _images()
    context, (c0, h0) = _context(ocr, x)
    want = ref.encode(ocr.params, ocr.batch_stats, torch.from_numpy(x), TINY)
    assert context.shape == want.shape == (5, 32, 16)
    torch.testing.assert_close(context, want, rtol=0, atol=1e-5)
    assert not c0.any() and not h0.any()  # the decoder starts from zeros


def test_logits_match_reference():
    """The port's teacher-forced decoder over its own context against the
    reference's full forward pass, on the reference's greedy tokens."""
    ocr = _ocr()
    x = _images()
    context, dec_init = _context(ocr, x)
    x = torch.from_numpy(x)
    want_ctx = ref.encode(ocr.params, ocr.batch_stats, x, TINY)
    toks, _ = ref.greedy(ocr.params, want_ctx, True, T)
    fed = torch.cat([torch.full((5, 1), ref.GO), toks[:, :-1]], 1)
    want = ref.teacher_forced(ocr.params, want_ctx, fed, True)
    with torch.inference_mode():
        _nll, got = model.loss_from_context(ocr.params, context, dec_init,
                                            fed, toks, ocr.cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kernels", [True, False])
def test_greedy_matches_reference(kernels):
    ocr = _ocr(use_pallas=kernels)
    x = _images(6, seed=3)
    texts, scores = ocr.recognize(x)
    ctx = ref.encode(ocr.params, ocr.batch_stats, torch.from_numpy(x), TINY)
    toks, want = ref.greedy(ocr.params, ctx, True, T)
    assert texts == SPEC.decode_batch(toks.numpy())
    assert len(set(texts)) > 1  # the transcripts depend on the image
    np.testing.assert_allclose(scores, want.numpy(), rtol=0, atol=1e-4)


def test_beam3_plain_route_matches_reference():
    ocr = _ocr(use_pallas=False)
    x = _images(4, seed=5)
    texts, scores = ocr.recognize(x, beam_size=3)
    ctx = ref.encode(ocr.params, ocr.batch_stats, torch.from_numpy(x), TINY)
    toks, want = ref.beam(ocr.params, ctx, True, T, 3)
    assert texts == SPEC.decode_batch(toks.numpy())
    np.testing.assert_allclose(scores, want.numpy(), rtol=0, atol=1e-4)
    greedy = ocr.recognize(x)[1]
    assert (scores >= greedy - 1e-5).all()


@pytest.mark.parametrize("direction", ["encoder_fw", "encoder_bw"])
@pytest.mark.parametrize("row", [0, 2])
def test_row_start_moves_only_its_row(direction, row):
    ocr = _ocr()
    x = _images(3)
    before = _context(ocr, x)[0]
    ocr.params[direction]["rows"]["h"][0, row] += 0.5
    after = _context(ocr, x)[0]
    Wf = 8
    moved = (after - before).abs().amax(-1).view(3, 4, Wf).amax((0, 2)) > 0
    assert moved.tolist() == [r == row for r in range(4)]


def test_save_load_round_trip(tmp_path):
    ocr = _ocr()
    ocr.save(str(tmp_path))
    back = AttentionOCR.load(str(tmp_path), device="cpu")
    assert back.spec == SPEC
    assert back.cfg.image_height == 32 and back.cfg.target_vocab_size == 20
    x = _images(3)
    a, b = ocr.recognize(x), back.recognize(x)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])


def test_reference_copies_agree():
    """The reference (one copy, the benchmark's) agrees with itself on
    seeded inputs: encode and greedy give the same twice, and teacher
    forcing greedy's tokens gives its picks' log-probs, whose sum over
    the steps before EOS is its score."""
    ocr = _ocr(seed=7)
    x = torch.from_numpy(_images(3, seed=7))
    ctx = ref.encode(ocr.params, ocr.batch_stats, x, TINY)
    assert torch.equal(ctx, ref.encode(ocr.params, ocr.batch_stats, x, TINY))
    toks, scores = ref.greedy(ocr.params, ctx, True, T)
    for got, want in zip(ref.greedy(ocr.params, ctx, True, T),
                         (toks, scores)):
        assert torch.equal(got, want)
    fed = torch.cat([torch.full((3, 1), ref.GO), toks[:, :-1]], 1)
    lp = ref.teacher_forced(ocr.params, ctx, fed, True)
    live = (fed != ref.PAD) & (fed != ref.EOS)
    picked = lp.gather(2, toks[:, :, None])[..., 0]
    torch.testing.assert_close((picked * live).sum(1), scores, rtol=0,
                               atol=1e-4)


def test_paths_and_score_refused():
    ocr = _ocr()
    with pytest.raises(ValueError, match="stacked"):
        ocr.recognize(["formula.png"])
    with pytest.raises(ValueError, match="score"):
        ocr.score(_images(1), ["t4"])


def test_positions_attended_counted():
    ocr = _ocr()
    im2markup.reset_attended_count()
    ocr.recognize(_images(4))
    labels = np.array([[5, 6, 2, 0], [5, 6, 7, 8], [0, 0, 0, 0]])
    steps = 3 + 4 + 1
    before = im2markup.attended_count()
    im2markup.count_attended(labels, 32)
    assert im2markup.attended_count() - before == 32 * steps
    assert 0 < before <= 4 * 32 * T


def test_decode_batch_names_and_range():
    spec = im2markup.Spec(convs=TINY, vocab_size=6, tokens=("x", "\\frac"))
    assert spec.decode_batch([[4, 3, 5, 2, 4], [1, 5, 0, 4, 0]]) == [
        "x <unk> \\frac", "\\frac x"]
    with pytest.raises(ValueError):
        spec.decode_batch([[4, 6, 2]])
    with pytest.raises(ValueError):
        im2markup.Spec(vocab_size=6, tokens=("x",))


def test_published_shapes_plan_on_the_kernels():
    """At the published widths (160 x 500, L = 1,240, H = 512, V = 503,
    T = 150, B = 256, bf16) the decode's route is greedy_loop and the
    CNN's conv1 and the rows' scans have kernel plans (the mirrors of the
    kernels' own plans)."""
    spec, cfg = im2markup.Spec(), im2markup.config(compute_dtype="bfloat16")
    assert spec.feature_shape(160, 500) == (20, 62)
    assert spec.context_length(160, 500) == 1240
    assert cfg.decoder_num_hidden == 512
    assert decode.greedy_route(cfg, 256, 1240, 512) == "loop"
    Vp = decode._plan_args(cfg, 256)[2]
    assert Vp == 512
    assert greedy_loop.plan(512, 256, torch.bfloat16, 1240, Vp, 1,
                            7) is not None
    assert lstm_fwd.plan(256, 256 * 20, torch.bfloat16, 7) is not None
    assert conv1_pool.plan(256, 160, 500, torch.bfloat16) is not None
    assert im2markup._conv1_pool_applies(0, spec.convs[0])
