"""bfloat16 transcripts of aocr_torch on trained fixtures, against aocr.

On random weights bf16 near-ties flip tokens between any two summation
orders, so the port's other bf16 checks report agreement.  On a trained
model the best token leads by a wide margin, so the transcripts must be
IDENTICAL: tiny models trained to exact match with aocr
(`tests/test_transcript_parity.py::_trained`, H=128, at most 300 SGD
steps) are carried over with `weights.from_numpy`, and the port's bf16
greedy and beam-5 decodes, with and without a trie, on each of its routes
(plain, the per-step tail, the whole-loop kernel; on CPU tensors the
kernel wrappers run their plain versions) must give aocr's bf16 XLA
labels.  Scores agree within 2e-2 (bf16 sums in another order).
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aocr import decode as jdecode
from aocr.utils import trie as jtrie
from aocr_torch import decode, vocab, weights
from aocr_torch.config import Config
from tests.test_transcript_parity import DECOYS, _trained

SEEDS = [0, 1]
_REF: dict = {}  # aocr's bf16 labels and scores of a case


def _port_cfg(jcfg, route: str) -> Config:
    """The port's Config from the fixture's arguments, bf16, on `route`."""
    return Config(
        batch_size=jcfg.batch_size, input_feed=jcfg.input_feed,
        encoder_num_hidden=jcfg.encoder_num_hidden,
        target_embedding_size=jcfg.target_embedding_size,
        max_decoder_l=jcfg.max_decoder_l, image_width=jcfg.image_width,
        seed=jcfg.seed, compute_dtype="bfloat16",
        use_pallas=route != "plain",
        pallas_greedy="tail" if route == "tail" else "loop",
        pallas_beam="tail" if route == "tail" else "loop").validate()


def _reference(seed: int, use_trie: bool, K: int):
    key = (seed, use_trie, K)
    if key not in _REF:
        jcfg, params, stats, im, labels = _trained(seed)
        cfg = jcfg.replace(compute_dtype="bfloat16")
        table = (jtrie.build_transition_table(labels + DECOYS)
                 if use_trie else None)
        kw = ({} if table is None else
              dict(trie_table=jnp.asarray(table), use_trie=True))
        if K == 1:
            lab, sc = jdecode.greedy_decode(params, stats, im, cfg,
                                            cfg.max_decoder_l, **kw)
        else:
            lab, sc = jdecode.beam_decode(params, stats, im, cfg, K,
                                          cfg.max_decoder_l, **kw)
        _REF[key] = (np.asarray(lab), np.asarray(sc), table)
    return _REF[key]


@pytest.mark.parametrize("route", ["plain", "tail", "loop"])
@pytest.mark.parametrize("K", [1, 5], ids=["greedy", "beam5"])
@pytest.mark.parametrize("use_trie", [False, True], ids=["notrie", "trie"])
@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_transcripts_on_trained_fixture(seed, use_trie, K, route):
    jcfg, params, stats, im, labels = _trained(seed)
    want, want_sc, table = _reference(seed, use_trie, K)
    # the fixture reads back its words on aocr's bf16 path, or the
    # comparison below would hold garbage against garbage
    assert [vocab.decode(r) for r in want] == labels
    cfg = _port_cfg(jcfg, route)
    tp, ts = weights.from_numpy(
        *(jax.tree.map(np.asarray, t) for t in (params, stats)))
    images = torch.from_numpy(np.array(im))
    tt = None if table is None else torch.from_numpy(table)
    if K == 1:
        lab, sc = decode.greedy_decode(tp, ts, images, cfg,
                                       cfg.max_decoder_l, trie_table=tt)
    else:
        lab, sc = decode.beam_decode(tp, ts, images, cfg, K,
                                     cfg.max_decoder_l, trie_table=tt)
    np.testing.assert_array_equal(lab.numpy(), want)
    np.testing.assert_allclose(sc.numpy(), want_sc, rtol=2e-2, atol=2e-2)
