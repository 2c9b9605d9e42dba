"""The plain reference against the port's plain CPU route on a tiny model
(float32): the encoder, the teacher-forced log-probs, greedy and beam
decoding, and one SGD step."""

import pytest
import torch

from portbench import inputs
from portbench.reference import compare
from portbench.reference import network as net

TOL = dict(rtol=1e-5, atol=1e-5)


def tiny(feed):
    return {"encoder_num_hidden": 8, "encoder_num_layers": 1,
            "decoder_num_layers": 2, "target_embedding_size": 4,
            "target_vocab_size": 39, "input_feed": feed,
            "compute_dtype": "float32", "max_decoder_l": 6,
            "batch_size": 5}


def setup(feed, seed=5):
    from aocr_torch import weights as wlib
    from aocr_torch.config import Config

    c = tiny(feed)
    params, stats = inputs.make_weights(c, seed, "cpu")
    port = wlib.conv_to_port(inputs.clone_tree(params))
    rng = inputs.host_rng(seed, 1)
    images = torch.from_numpy(inputs.word_images(rng, 5, 24))
    return c, Config(**c), params, stats, port, inputs.clone_tree(stats), images


@pytest.mark.parametrize("feed", [True, False])
def test_encode_and_teacher_forced(feed):
    from aocr_torch.models import model

    c, cfg, params, stats, port, pstats, images = setup(feed)
    ctx, (c0, h0) = model.encode(port, pstats, images[..., None], cfg)
    rctx, (rc0, rh0) = net.encode(params, stats, images)
    torch.testing.assert_close(ctx, rctx, **TOL)
    torch.testing.assert_close(c0, rc0, **TOL)
    torch.testing.assert_close(h0, rh0, **TOL)
    words = inputs.words(inputs.host_rng(1, 3), 5,
                         {"shape": 4.0, "scale": 1.6, "min": 3, "max": 13})
    tg, te = (torch.from_numpy(a) for a in inputs.encode_batch(words))
    _nll, lp = model.loss_from_context(port, ctx, (c0, h0), tg, te, cfg)
    rlp = net.teacher_forced(params, rctx, (rc0, rh0), tg, feed)
    torch.testing.assert_close(lp, rlp, **TOL)


@pytest.mark.parametrize("feed", [True, False])
@pytest.mark.parametrize("K", [1, 3])
def test_decode(feed, K):
    from aocr_torch import decode

    c, cfg, params, stats, port, pstats, images = setup(feed, seed=7)
    labels, scores = decode.beam_decode(port, pstats, images[..., None], cfg,
                                        beam_size=K, max_len=6)
    rctx, init = net.encode(params, stats, images)
    if K == 1:
        toks, rscores = net.greedy(params, rctx, init, feed, 6)
    else:
        toks, rscores = net.beam(params, rctx, init, feed, 6, K)
    assert [compare.text_of(r) for r in labels.tolist()] == \
        [compare.text_of(r) for r in toks.tolist()]
    torch.testing.assert_close(scores, rscores, **TOL)


@pytest.mark.parametrize("feed", [True, False])
def test_train_step(feed):
    from aocr_torch import train_step

    c, cfg, params, stats, port, pstats, images = setup(feed, seed=9)
    words = inputs.words(inputs.host_rng(2, 3), 5,
                         {"shape": 4.0, "scale": 1.6, "min": 3, "max": 13})
    tg, te = (torch.from_numpy(a) for a in inputs.encode_batch(words))
    step = train_step.make_train_step(cfg)
    out = step(port, pstats, train_step.init_opt_state(port, cfg),
               images[..., None], tg, te, 0.1)
    loss, _grads, new = net.train_step(params, stats, images, tg, te, 0.1,
                                       feed)
    torch.testing.assert_close(out.loss_sum, loss, **TOL)
    got = compare.flatten(out.params)
    for k, v in new.items():
        g = got[k].permute(2, 3, 1, 0) if k[0] == "cnn" and k[-1] == "w" \
            else got[k]
        torch.testing.assert_close(g, v, **TOL)


def test_transcripts_read_back():
    assert compare.tokens_of("ab", 6) == [13, 14, net.EOS]
    assert compare.tokens_of("abcdef", 6) == [13, 14, 15, 16, 17, 18]
    assert compare.tokens_of("abcdefg", 6) is None
    assert compare.tokens_of("aB", 6) is None
    assert compare.text_of([13, 3, net.EOS, 14]) == "a0"


@pytest.mark.parametrize("pr", ["float32", "tf32", "fp8"])
def test_products_own_tf32(monkeypatch, pr):
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    for flag in (True, False):
        monkeypatch.setattr(mm, "allow_tf32", flag)
        monkeypatch.setattr(dnn, "allow_tf32", flag)
        with net.products(net.Precision(pr)):
            assert mm.allow_tf32 is dnn.allow_tf32 is (pr == "tf32")
        assert mm.allow_tf32 is dnn.allow_tf32 is flag


@pytest.mark.parametrize("K", [1, 3])
def test_wrong_pick_reads_a_gap(K):
    c, cfg, params, stats, port, pstats, images = setup(True, seed=11)
    right = compare.decode_control(params, stats, c, images, K, 6, "float32")
    wrong = compare.decode_control(params, stats, c, images, K, 6, "float32",
                                   wrong_pick=True)
    key = "token_gap" if K == 1 else "beam_gap_median"
    got = {k: compare.recognize_readings(params, stats, c, images, *ans,
                                         K, 6)
           for k, ans in (("right", right), ("wrong", wrong))}
    assert got["right"]["score_err"] < 1e-4 and got["right"][key] < 1e-4
    assert got["wrong"]["score_err"] < 1e-4  # each pick keeps its own score
    assert got["wrong"][key] > 1e-3
