"""The im2markup cell's own pieces on the CPU: the counts at the published
shapes, the benchmark's weights against the program's tree, the images
and the transcript read-back."""

import json

import numpy as np
import pytest
import torch

from portbench import counts, inputs, markup_counts, markup_inputs, registry
from portbench.drivers import markup
from portbench.reference import compare, markup_compare

BENCH = registry.Benchmark()
CFG = BENCH.config("im2markup-bf16")
CALL = {"B": 256, "T": 150, "Hi": 160, "W": 500, "row_steps": [150] * 256}


def test_counts_at_the_published_shapes():
    d = markup_counts.dims(CFG, CALL)
    assert (d["Hf"], d["Wf"], d["L"], d["H"]) == (20, 62, 1240, 512)
    assert d["cnn"] == pytest.approx(23.638e9, rel=1e-4)  # 11.8 GMAC
    # the context read once a step and row: 150 x 256 x 1240 x 512 x 2 B
    ctx = 150 * 256 * 1240 * 512 * 2
    b = markup_counts.loop_bytes(CFG, CALL, "bfloat16")
    assert ctx < b < ctx * 1.001
    f = markup_counts.loop_flops(CFG, CALL)
    assert counts.bound_s(f, b, "bfloat16") == pytest.approx(
        b / counts.PEAK_BYTES)
    fwd = markup_counts.forward_flops(CFG, CALL)
    assert fwd > 256 * d["cnn"] + f


def test_weights_match_the_programs_tree():
    from aocr_torch.config import Config
    from aocr_torch.models import im2markup

    cfg = dict(CFG, config=dict(CFG["config"], encoder_num_hidden=8,
                                target_embedding_size=4))
    spec = im2markup.Spec(**cfg["spec"])
    mine, stats = markup_inputs.make_weights(cfg, 5, "cpu", ["PAD"])
    prog, pstats = im2markup.init(Config(**cfg["config"]), spec,
                                  torch.Generator().manual_seed(0))
    shapes = lambda t: {k: tuple(v.shape)  # noqa: E731
                        for k, v in compare.flatten(t).items()}
    assert shapes(mine) == shapes(prog)
    assert shapes(stats) == shapes(pstats)
    again, _ = markup_inputs.make_weights(cfg, 5, "cpu", ["PAD"])
    assert all(torch.equal(a, b) for a, b in zip(
        compare.flatten(mine).values(), compare.flatten(again).values()))
    assert float(mine["projector"]["b"][0]) == inputs.NEVER_EMITTED_BIAS


def test_formula_images_from_the_seed():
    a = markup_inputs.formula_images(inputs.host_rng(2**40 + 3, 1), 3, 160,
                                     500)
    b = markup_inputs.formula_images(inputs.host_rng(2**40 + 3, 1), 3, 160,
                                     500)
    assert a.shape == (3, 160, 500) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert 0 <= a.min() < 90 and a.max() == 255
    assert not np.array_equal(a[0], a[1])


def test_transcripts_read_back():
    names = markup.names(CFG)
    ids = {n: i for i, n in enumerate(names)}
    assert len(names) == CFG["config"]["target_vocab_size"]
    assert markup_compare.tokens_of("s4 <unk> s502", 150, ids) == [4, 3, 502,
                                                                  2]
    assert markup_compare.tokens_of(" ".join(["s7"] * 150), 150, ids) == \
        [7] * 150
    assert markup_compare.tokens_of("s4 x", 150, ids) is None
    assert markup_compare.tokens_of(" ".join(["s7"] * 151), 150, ids) is None
    assert markup_compare.row_steps(["", "s4 s5", " ".join(["s4"] * 150)],
                                    150) == [1, 3, 150]


def test_config_file_states_the_spec():
    assert CFG["spec"]["vocab_size"] == CFG["config"]["target_vocab_size"]
    assert CFG["reduced"] == []
    assert json.loads(json.dumps(CFG)) == CFG
