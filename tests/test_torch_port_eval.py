"""aocr_torch's evaluation functions, data pipeline, LR schedule and
masked BatchNorm step against the JAX package on CPU.

Tolerances: the eval functions and the batch stream are exact (the same
integers, strings and pixels); the masked train step as
test_torch_port_train.py holds a step in float32 (loss 1e-5 relative,
grad norms 1e-4 relative, params and batch stats 1e-5 absolute).
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aocr import data as jdata
from aocr import eval as jeval
from aocr import optim as joptim
from aocr import train as jtrain
from aocr import train_step as jts
from aocr import vocab
from aocr.config import Config
from aocr.models import cnn as jcnn
from aocr.models import decoder as jdec
from aocr.models import model as jmodel
from aocr.ops import lstm as jlstm
from aocr_torch import data, eval as teval, train, train_step, weights
from aocr_torch.config import Config as TConfig
from tests import synth


def _rows(seed: int, B: int = 24, T: int = 9) -> np.ndarray:
    """Token rows with every oddity the canonical form handles: random
    characters, a stray GO or PAD mid-word, rows without EOS, EOS first,
    all PAD."""
    rs = np.random.RandomState(seed)
    rows = rs.randint(3, 8, (B, T)).astype(np.int32)  # few chars: matches
    for r in rows:
        kind = rs.randint(5)
        if kind == 0:
            r[rs.randint(T)] = vocab.GO
        elif kind == 1:
            r[rs.randint(T)] = vocab.PAD
        elif kind == 2:
            r[rs.randint(1, T):] = vocab.PAD  # no EOS
        elif kind == 3:
            r[rs.randint(T)] = vocab.EOS
    rows[0, 0] = vocab.EOS
    rows[1] = vocab.PAD
    return rows


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_functions_match_reference(seed):
    pred, gold = _rows(seed), _rows(seed + 10, T=7)
    gold[:4] = pred[:4, :7]  # some exact matches
    gold[2, 3] = vocab.EOS
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gold)
    for ours, ref in ((teval.canonicalize(tp), jeval.canonicalize(pred)),):
        np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(teval.exact_match(tp, tg).numpy(),
                                  np.asarray(jeval.exact_match(pred, gold)))
    dist = teval.edit_distance(tp, tg).numpy()
    np.testing.assert_array_equal(dist,
                                  np.asarray(jeval.edit_distance(pred, gold)))
    np.testing.assert_array_equal(
        teval.char_error_rate(tp, tg).numpy(),
        np.asarray(jeval.char_error_rate(pred, gold)))
    errs, preds, golds = teval.eval_word_err_rate(pred, gold)
    assert (errs, preds, golds) == jeval.eval_word_err_rate(pred, gold)
    # the host oracle agrees with the wavefront on the decoded strings
    assert [teval.levenshtein(p, g) for p, g in zip(preds, golds)] == \
        dist.tolist()
    assert teval.levenshtein("kitten", "sitting") == \
        jeval.levenshtein("kitten", "sitting") == 3


def _manifest(tmp_path, n: int, widths) -> str:
    """n .npy crops (uint8, float in [0, 1], RGB; heights and widths
    varying) with random words, one unreadable file, one out-of-vocab
    label and one over-long label: the manifest's path."""
    rs = np.random.RandomState(3)
    lines = []
    for i in range(n):
        word = "".join(rs.choice(list("abcdxyz019"), rs.randint(1, 6)))
        img = synth.render_word(word, 32, int(widths[i % len(widths)]))
        if i % 3 == 1:
            img = (img / 255.0).astype(np.float32)
        elif i % 3 == 2:
            img = np.repeat(img[::2, :, None], 3, -1).astype(np.uint8)
        np.save(tmp_path / f"{i}.npy", img)
        lines.append(f"{i}.npy {word}")
    (tmp_path / "broken.npy").write_bytes(b"not an array")
    lines += ["broken.npy abc", "0.npy a#b", "1.npy " + "x" * 40]
    (tmp_path / "m.txt").write_text("\n".join(lines) + "\n")
    return str(tmp_path / "m.txt")


@pytest.mark.parametrize("keep_aspect", [False, True])
def test_datagen_stream_matches_reference(tmp_path, keep_aspect):
    """Both packages' DataGen on one manifest and seed give the same
    batches (images, targets, targets_eval, num_nonzeros, paths) in the
    same order over two shuffled epochs: full buckets, then the partial
    ones flushed; under keep_aspect_ratio the width buckets."""
    path = _manifest(tmp_path, 23, [40, 100, 70, 100])
    kw = dict(batch_size=4, max_decoder_l=12, keep_aspect_ratio=keep_aspect,
              snap_width_ladder=keep_aspect, seed=5)
    streams = []
    for pkg, cfg in ((data, TConfig(**kw)), (jdata, Config(**kw))):
        gen = pkg.DataGen(str(tmp_path), path, cfg, log=lambda _m: None)
        out = []
        for _ in range(2):
            gen.shuffle()
            out.append(list(pkg.prefetched(gen.epoch(4), 2)))
        streams.append(out)
    ours, ref = streams
    assert [len(e) for e in ours] == [len(e) for e in ref]
    # the broken file and the OOV label skipped, the long label truncated
    assert sum(b.rows for b in ours[0]) == 23 + 1
    if keep_aspect:
        assert len({b.images.shape[2] for b in ours[0]}) > 1
    for a, b in zip(ours[0] + ours[1], ref[0] + ref[1]):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.targets, b.targets)
        np.testing.assert_array_equal(a.targets_eval, b.targets_eval)
        assert a.num_nonzeros == b.num_nonzeros
        assert a.img_paths == b.img_paths


def test_device_preprocess_raises(tmp_path):
    """-device_preprocess, once refused, now streams: both packages'
    DataGen in device mode on one manifest and seed give the same batches
    (raw buffers, sizes, out_w, targets, paths) over two shuffled epochs,
    and the port's raw batches, resized by preprocess_varsize, match the
    host-mode stream's images (as tests/test_preprocess.py holds aocr's:
    rtol 1e-4, atol 0.5)."""
    from aocr_torch import preprocess

    path = _manifest(tmp_path, 11, [40, 100, 70])
    kw = dict(batch_size=4, max_decoder_l=12, keep_aspect_ratio=True,
              seed=6, device_preprocess=True)
    streams = []
    for pkg, cfg in ((data, TConfig(**kw)), (jdata, Config(**kw))):
        gen = pkg.DataGen(str(tmp_path), path, cfg, log=lambda _m: None)
        out = []
        for _ in range(2):
            gen.shuffle()
            out += list(pkg.prefetched(gen.epoch(4), 2))
        streams.append(out)
    ours, ref = streams
    assert len(ours) == len(ref) > 2
    for a, b in zip(ours, ref):
        assert a.images is None and b.images is None
        np.testing.assert_array_equal(a.raw, b.raw)
        np.testing.assert_array_equal(a.sizes, b.sizes)
        assert a.out_w == b.out_w
        np.testing.assert_array_equal(a.targets, b.targets)
        np.testing.assert_array_equal(a.targets_eval, b.targets_eval)
        assert a.num_nonzeros == b.num_nonzeros
        assert a.img_paths == b.img_paths
    host = data.DataGen(str(tmp_path), path, TConfig(**{
        **kw, "device_preprocess": False}), log=lambda _m: None)
    dev = data.DataGen(str(tmp_path), path, TConfig(**kw),
                       log=lambda _m: None)
    for hb, db in zip(host.epoch(4), dev.epoch(4)):
        assert hb.img_paths == db.img_paths
        images = preprocess.preprocess_varsize(db.raw, db.sizes, 32,
                                               db.out_w, "cpu").numpy()
        np.testing.assert_allclose(images, hb.images, rtol=1e-4, atol=0.5)


@pytest.mark.parametrize("initial,minimum,decay,losses", [
    (0.1, 0.01, 0.5, [5.0, 6.0, 4.0, 4.5, 4.6, 4.7, 4.8, 3.0]),
    (0.001, 0.01, 0.5, [1.0, 2.0]),        # start clamped to the floor
    (1.0, 0.0, 0.9, [3.0, 3.0, 3.1, 2.0]),  # an equal loss does not decay
])
def test_val_driven_lr_matches_reference(initial, minimum, decay, losses):
    ours = train.ValDrivenLR(initial, minimum, decay)
    ref = jtrain.ValDrivenLR(initial, minimum, decay)
    assert ours.lr == ref.lr
    for v in losses:
        assert ours.update(v) == ref.update(v)
        assert ours.lr == ref.lr


@pytest.fixture
def jax_kernels(monkeypatch):
    """Every Pallas kernel of the reference's train step in interpret
    mode (the package's own switches)."""
    monkeypatch.setattr(jcnn, "_PALLAS_CONV1_INTERPRET", True)
    monkeypatch.setattr(jlstm, "_PALLAS_LSTM_FWD_INTERPRET", True)
    monkeypatch.setattr(jlstm, "_PALLAS_LSTM_BWD_INTERPRET", True)
    monkeypatch.setattr(jlstm, "_SCAN_VJP_CACHE", {})
    monkeypatch.setattr(jdec, "_PALLAS_TF_FWD_INTERPRET", True)
    monkeypatch.setattr(jdec, "_PALLAS_TF_BWD_INTERPRET", True)
    monkeypatch.setattr(jdec, "_TF_VJP_CACHE", {})


def test_masked_batchnorm_step_matches_reference(jax_kernels):
    """A float32 step on a batch of 3 real rows padded to 4 (the
    Trainer's epoch tail): real_bs and row_mask through both packages'
    make_train_step; the padding row is a copy of the last real one with
    PAD targets, so only the mask keeps it out of the moments."""
    words = ["ab1", "xyz", "k"]
    kw = dict(input_feed=True, encoder_num_hidden=16,
              target_embedding_size=8, batch_size=4)
    cfg, tcfg = Config(**kw).validate(), TConfig(**kw).validate()
    ms = jmodel.init(jax.random.PRNGKey(4), cfg)
    params = jax.tree.map(np.asarray, ms.params)
    stats = jax.tree.map(np.asarray, ms.batch_stats)
    images = np.random.RandomState(4).uniform(0, 255, (3, 32, 36, 1)
                                              ).astype(np.float32)
    images = np.concatenate([images, images[-1:]], 0)
    t, te, _ = vocab.encode_batch(words)
    pad = np.full((1, t.shape[1]), vocab.PAD, t.dtype)
    t, te = np.concatenate([t, pad]), np.concatenate([te, pad])
    mask = np.array([1, 1, 1, 0], np.float32)
    want = jts.make_train_step(cfg)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
        joptim.sgd_init(params), jnp.asarray(images), jnp.asarray(t),
        jnp.asarray(te), jnp.float32(0.1), jax.random.PRNGKey(1),
        real_bs=jnp.float32(3), row_mask=jnp.asarray(mask))
    tp, ts = weights.from_numpy(params, stats)
    got = train_step.make_train_step(tcfg)(
        tp, ts, train_step.init_opt_state(tp, tcfg), images, t, te, 0.1,
        None, real_bs=3.0, row_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(float(got.loss_sum), float(want.loss_sum),
                               rtol=1e-5)
    for g in want.grad_norms:
        np.testing.assert_allclose(float(got.grad_norms[g]),
                                   float(want.grad_norms[g]), rtol=1e-4,
                                   err_msg=g)
    gp, gs = weights.to_numpy(got.params, got.batch_stats)
    check = lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                                    atol=1e-5)
    jax.tree.map(check, gp, want.params)
    jax.tree.map(check, gs, want.batch_stats)
    # the mask matters: unmasked moments give other running statistics
    unmasked = train_step.make_train_step(tcfg)(
        tp, ts, train_step.init_opt_state(tp, tcfg), images, t, te, 0.1,
        None, real_bs=3.0)
    assert not torch.allclose(unmasked.batch_stats["conv3_bn"]["mean"],
                              got.batch_stats["conv3_bn"]["mean"])
