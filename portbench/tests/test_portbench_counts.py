"""The operation and byte counts against hand counts, and against
torch's FLOP counter on the plain reference, at a tiny size."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, inputs
from portbench.reference import network as net


def test_step_flops_by_hand():
    # H=4, L=3, V=5, E=2, two layers: layer 0 over [emb 2; h~ 4; h 4]
    # (feed) = 10 columns, layer 1 over 8: 2*16*(10+8) = 576; q 32;
    # scores + context 4*3*4 = 48; W_c 2*8*4 = 64; projector 2*4*5 = 40
    assert counts.step_flops(4, 3, 5, 2, 2, True) == 760
    assert counts.step_flops(4, 3, 5, 2, 2, False) == 760 - 2 * 16 * 4
    assert counts.step_flops(4, 3, 5, 2, 2, True, embed=False) == 760 - 64
    assert counts.step_flops(4, 3, 5, 2, 2, True, proj=False) == 720


def test_cnn_flops_by_hand():
    # 32x8: conv1 32x8, pool; conv2 16x4, pool; conv3, conv4 8x2, pool
    # (2,1); conv5, conv6 4x2, pool (2,1); conv7 2x2 VALID on 2x2 -> 1x1
    want = (2 * 9 * 1 * 64 * 256 + 2 * 9 * 64 * 128 * 64
            + 2 * 9 * 128 * 256 * 16 + 2 * 9 * 256 * 256 * 16
            + 2 * 9 * 256 * 512 * 8 + 2 * 9 * 512 * 512 * 8
            + 2 * 4 * 512 * 512 * 1)
    assert counts.cnn_flops(8, 32) == want == 96763904


def test_small_counts_by_hand():
    assert counts.lstm_bwd_flops(3, 2, 4) == 2 * 3 * 2 * 16 * 4
    assert counts.encoder_flops(3, 5, 4) == 2 * 3 * 2 * 16 * (5 + 4)
    assert counts.context_length(100) == 24
    # ops-bound and bytes-bound
    assert counts.bound_s(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12, "float32") == pytest.approx(1.0)
    assert counts.bound_s(67e12, 3.35e12 * 2, "float32") == pytest.approx(2.0)


def tiny_cfg(feed=True):
    return {"encoder_num_hidden": 4, "encoder_num_layers": 1,
            "decoder_num_layers": 2, "target_embedding_size": 3,
            "target_vocab_size": 39, "input_feed": feed}


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("feed", [True, False])
def test_step_flops_against_counter(feed):
    cfg = tiny_cfg(feed)
    params, stats = inputs.make_weights(cfg, 3, "cpu")
    B, L, H = 2, 5, 8
    ctx = torch.randn(B, L, H)
    init = (torch.randn(B, H), torch.randn(B, H))
    dec = net.Decoder(params, init, feed)
    got = _flops(lambda: dec.step(torch.tensor([1, 4]), ctx))
    assert got == B * counts.step_flops(H, L, 39, 3, 2, feed)


def test_forward_flops_against_counter():
    cfg = tiny_cfg()
    params, stats = inputs.make_weights(cfg, 4, "cpu")
    images = torch.rand(2, 32, 16) * 255
    steps = 3

    def fwd():
        context, init = net.encode(params, stats, images)
        net.teacher_forced(params, context, init,
                           torch.ones(2, steps, dtype=torch.long), True)

    got = _flops(fwd)
    want = counts.forward_flops(cfg, 16, [steps, steps])
    # the counter also counts each conv's bias add as nothing and each
    # LSTM input projection as one product, as counts does
    assert got == want
    assert math.isclose(counts.cnn_flops(16) * 2
                        + 2 * counts.encoder_flops(3, 512, 4), want
                        - 2 * steps * counts.step_flops(8, 3, 39, 3, 2, True))
