"""aocr_torch.parallel, sync-BN, the data-parallel trainer,
AttentionOCR.shard and serve's -num_shards against the JAX package on
the CPU.

One gloo group of two spawned processes (tests/torch_parallel_worker.py,
joined with a 120 s limit) runs every two-rank case of the module: the
synchronized BatchNorm, make_dp_train_step (full, masked with ranks
holding 4 and 1 real rows, -augment), make_dp_eval_step (beam, greedy,
trie) and the CLI trainer at -num_shards 2.  The test process holds each
against the reference: aocr.parallel's steps on a 2-device CPU mesh
(tests/conftest.py forces 8 host devices) from the same weights and
batch, with tests/test_data_parallel.py's tolerances (loss 1e-5
relative, params and BN statistics rtol 1e-3 atol 2e-4); the sync-BN
against the port's one-process BN on the whole batch (1e-5); augment
and the trainer port against port, one process against two (the port's
Philox draws are not JAX's threefry).  Parameters must be bit-equal
across the ranks.
"""

import os
import re
import shutil
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aocr import optim as joptim
from aocr import serve as jserve
from aocr import vocab
from aocr.config import Config
from aocr.models import model as jmodel
from aocr.parallel import data_parallel as jdp
from aocr.parallel import eval_parallel as jep
from aocr.parallel import mesh as jmesh
from aocr.parallel import multihost as jmultihost
from aocr.utils import trie as jtrie
from aocr_torch import augment, checkpoint, serve, train, train_step, weights
from aocr_torch.api import AttentionOCR
from aocr_torch.config import Config as TConfig
from aocr_torch.models import cnn
from aocr_torch.parallel import mesh, multihost
from tests import synth
from tests.torch_parallel_worker import run_group

KW = dict(batch_size=8, input_feed=True, encoder_num_hidden=16,
          target_embedding_size=8, image_width=32)
EVAL_KW = dict(KW, max_decoder_l=8, beam_size=2)
LABELS = ["ab", "cd", "ef", "gh", "ij", "kl", "mn", "op"]
MASK = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)  # ranks: 4 and 1
TRAINER_WORDS = ["ab", "cd1", "xyz", "k", "wxyz", "q0", "mm", "abc", "z9"]
TRAIN_ARGS = ["-phase", "train", "-load_model", "-model_dir", "model",
              "-data_base_dir", "../data", "-data_path", "../data/train.txt",
              "-val_data_path", "../data/val.txt", "-log_path", "log.txt",
              "-batch_size", "4", "-num_epochs", "1",
              "-steps_per_checkpoint", "2", "-num_batches_val", "1",
              "-momentum", "0.9", "-learning_rate", "0.1"]
TEST_ARGS = ["-phase", "test", "-load_model", "-model_dir", "model",
             "-data_base_dir", "../data", "-data_path", "../data/val.txt",
             "-log_path", "log.txt", "-output_dir", "results", "-visualize",
             "-beam_size", "2", "-batch_size", "4",
             "-steps_per_checkpoint", "1"]
T_KW = dict(input_feed=True, encoder_num_hidden=16, target_embedding_size=8,
            max_decoder_l=8, image_width=36, seed=3)


def _problem(seed=0, labels=LABELS, width=32, pad=None):
    """aocr weights as numpy, and a batch of rendered words; with pad,
    the rows past `pad` get PAD targets (a padded tail)."""
    ms = jmodel.init(jax.random.PRNGKey(seed), Config(**KW).validate())
    images = np.stack([synth.render_word(w, 32, width)
                       for w in labels])[..., None].astype(np.float32)
    targets, targets_eval, _ = vocab.encode_batch(labels)
    if pad is not None:
        targets[pad:] = vocab.PAD
        targets_eval[pad:] = vocab.PAD
    return (jax.tree.map(np.asarray, ms.params),
            jax.tree.map(np.asarray, ms.batch_stats), images, targets,
            targets_eval)


def _eval_problem():
    """Five rows of eval targets padded to 6 (a row of padding on rank
    1), and the trie of three words."""
    params, stats, _, _, _ = _problem()
    labels = LABELS[:5]
    images = np.stack([synth.render_word(w, 32, 32)
                       for w in labels])[..., None].astype(np.float32)
    t, te, _ = vocab.encode_batch(labels, pad_to=EVAL_KW["max_decoder_l"])
    real, im, tg, tge = jep.pad_rows(2, images, t, te)
    mask = (np.arange(im.shape[0]) < real).astype(np.float32)
    trie = np.asarray(jtrie.build_transition_table(["ab", "cd", "zz"]),
                      np.int32)
    return params, stats, im, tg, tge, mask, trie


def _trainer_data(root):
    d = os.path.join(root, "data")
    os.makedirs(d)
    lines = []
    for i, w in enumerate(TRAINER_WORDS):
        np.save(os.path.join(d, f"{i}.npy"), synth.render_word(w, 32, 36))
        lines.append(f"{i}.npy {w}")
    with open(os.path.join(d, "train.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(d, "val.txt"), "w") as f:
        f.write("\n".join(lines[:5]) + "\n")
    from aocr.api import AttentionOCR as JaxOCR

    init = os.path.join(root, "init", "model")
    JaxOCR.create(Config(**T_KW)).save(init)
    for r in (0, 1):
        shutil.copytree(init, os.path.join(root, f"rank{r}", "model"))


def _bn_problem():
    rs = np.random.RandomState(5)
    x = rs.normal(1.0, 2.0, (8, 6, 3, 5)).astype(np.float32)
    return dict(x=x, scale=rs.uniform(0.5, 1.5, 6).astype(np.float32),
                bias=rs.normal(size=6).astype(np.float32),
                mean=rs.normal(size=6).astype(np.float32),
                var=rs.uniform(0.5, 2.0, 6).astype(np.float32),
                dy=rs.normal(size=x.shape).astype(np.float32))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every two-rank case of the module in one spawned gloo group."""
    root = str(tmp_path_factory.mktemp("dp"))
    _trainer_data(root)
    p, s, im, t, te = _problem()
    pm, sm, imm, tm, tem = _problem(pad=5)
    ep, es, eim, et, ete, emask, trie = _eval_problem()
    bn = _bn_problem()
    key = augment.step_key(7, 2)
    aug = dict(KW, augment=True)
    jobs = [
        ("bn", "batchnorm", bn),
        ("bn_masked", "batchnorm", dict(bn, row_mask=MASK)),
        ("full", "dp_step", dict(cfg_kw=KW, params=p, stats=s, images=im,
                                 targets=t, targets_eval=te, steps=2)),
        ("masked", "dp_step", dict(cfg_kw=KW, params=pm, stats=sm,
                                   images=imm, targets=tm, targets_eval=tem,
                                   row_mask=MASK)),
        ("augment", "dp_step", dict(cfg_kw=aug, params=p, stats=s,
                                    images=im, targets=t, targets_eval=te,
                                    key=key)),
    ]
    for name, kw, tr in (("beam", EVAL_KW, None),
                         ("greedy", dict(EVAL_KW, beam_size=1), None),
                         ("trie", EVAL_KW, trie)):
        jobs.append((f"eval_{name}", "dp_eval", dict(
            cfg_kw=kw, params=ep, stats=es, images=eim, targets=et,
            targets_eval=ete, row_mask=emask, trie=tr)))
    jobs.append(("train", "trainer", dict(
        root=root, argv=TRAIN_ARGS + ["-num_shards", "2"])))
    # the test phase reads the checkpoint rank 0 wrote (a shared disk)
    test_args = [("../rank0/model" if a == "model" else a)
                 for a in TEST_ARGS]
    jobs.append(("test", "trainer", dict(
        root=root, argv=test_args + ["-num_shards", "2"])))
    ranks = run_group(jobs, timeout=120)
    return {"ranks": ranks, "root": root, "aug_key": key}


# ---------------------------------------------------------- single process

@pytest.mark.parametrize("args,match", [
    (dict(num_data=0), "mesh axes must be >= 1"),
    (dict(num_data=2, num_model=0), "mesh axes must be >= 1"),
    (dict(num_data=9), "need 9x1 devices, have 8"),
    (dict(num_data=3, devices=["cpu"] * 2), "need 3x1 devices, have 2")])
def test_make_mesh_errors_match_reference(args, match):
    """make_mesh's user-facing ValueErrors are aocr's, word for word."""
    jargs = dict(args, devices=jax.devices()[:len(args["devices"])]) \
        if "devices" in args else args
    with pytest.raises(ValueError, match=re.escape(match)):
        jmesh.make_mesh(**jargs)
    targs = args if "devices" in args else dict(args, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match=re.escape(match)):
        mesh.make_mesh(**targs)


def test_local_rows_follow_shard_batch():
    """Shard r of n is the block aocr's shard_batch puts on device r."""
    x = np.arange(24, dtype=np.float32).reshape(12, 2)
    for n in (2, 3, 4):
        m = jmesh.make_mesh(num_data=n)
        placed = jmesh.shard_batch(m, jnp.asarray(x))
        blocks = {s.device: np.asarray(s.data)
                  for s in placed.addressable_shards}
        for r, d in enumerate(m.devices[:, 0]):
            np.testing.assert_array_equal(mesh.rows_of(x, r, n), blocks[d])
    assert mesh.world() == 1 and mesh.rank() == 0
    np.testing.assert_array_equal(mesh.local_rows(x), x)
    with pytest.raises(ValueError, match="does not split"):
        mesh.rows_of(x[:5], 0, 2)


@pytest.mark.parametrize("scripts", [
    [[3, 2, 4], [4, 1]],           # host 1 runs out first
    [[1], [2, 2, 2]],              # host 0 runs out first
    [[], [4]],                     # one host has no data at all
    [[2, 2], [2, 2]]])             # even
def test_lockstep_matches_reference(scripts):
    """lockstep() with an injected sync over uneven scripted per-host
    iterators yields what aocr's yields, host by host; local_batch_size
    too."""
    def run(lockstep):
        batches = [[("b", n) for n in s] for s in scripts]

        def sync(*counts):
            return tuple(int(c) for c in counts)

        out = []
        for host, bs in enumerate(batches):
            others = [len(x) for i, x in enumerate(batches) if i != host]

            def hsync(have, nnz, rows, _i=[0]):  # noqa: B006
                step = _i[0]
                _i[0] += 1
                extra = [1 if step < n else 0 for n in others]
                ext_rows = [scripts[i][step] if step < len(scripts[i]) else 0
                            for i in range(len(scripts)) if i != host]
                return sync(have + sum(extra), nnz + sum(ext_rows),
                            rows + sum(ext_rows))

            out.append(list(lockstep(iter(bs), lambda: ("dummy", 0),
                                     lambda b: (b[1], b[1]), hsync)))
        return out

    assert run(multihost.lockstep) == run(jmultihost.lockstep)
    for g, p in ((8, 2), (7, 3), (4, 4)):
        assert multihost.local_batch_size(g, p) == \
            jmultihost.local_batch_size(g, p)
    assert multihost.sync_counts(3, 4) == (3, 4)
    assert multihost.process_info() == (0, 1)


def test_sync_batchnorm_without_group_is_plain():
    """group=None leaves the train-mode BatchNorm as it was: no process
    group is needed or touched."""
    bn = _bn_problem()
    x = torch.from_numpy(bn["x"])
    p = {"scale": torch.from_numpy(bn["scale"]),
         "bias": torch.from_numpy(bn["bias"])}
    s = {"mean": torch.from_numpy(bn["mean"]),
         "var": torch.from_numpy(bn["var"])}
    y0, st0 = cnn._bn_train(x, p, s)
    y1, st1 = cnn._bn_train(x, p, s, group=None)
    assert torch.equal(y0, y1) and torch.equal(st0["var"], st1["var"])


@pytest.mark.parametrize("beam_size", [1, 2])
def test_shard_pads_splits_and_gathers(beam_size):
    """shard(devices=[cpu] * 3) pads a batch of 7 to 9 rows, splits it
    over three decode threads and gathers: transcripts and scores equal
    unshard()'s, on a stacked batch and on mixed widths; shard(1) is
    unshard; bad arguments raise as aocr.api's do."""
    p, s, _, _, _ = _problem()
    ocr = AttentionOCR(TConfig(**EVAL_KW), *weights.from_numpy(p, s),
                       device="cpu")
    stacked = np.stack([synth.render_word(w, 32, 32) for w in LABELS[:7]])
    mixed = [synth.render_word(w, 32, 24 + 8 * (i % 3))
             for i, w in enumerate(LABELS[:7])]
    want = [ocr.recognize(x, beam_size=beam_size) for x in (stacked, mixed)]
    assert ocr.shard(devices=["cpu"] * 3) is ocr and ocr.num_shards == 3
    got = [ocr.recognize(x, beam_size=beam_size) for x in (stacked, mixed)]
    for (gw, gs), (ww, ws) in zip(got, want):
        assert gw == ww
        np.testing.assert_array_equal(gs, ws)
    ocr.use_dictionary(["ab", "cd", "zz"])
    dict_got = ocr.recognize(stacked, beam_size=beam_size)
    assert ocr.unshard().num_shards == 1
    assert ocr.recognize(stacked, beam_size=beam_size)[0] == dict_got[0]
    assert ocr.shard(1).num_shards == 1
    for bad, match in ((dict(num_shards=0), "num_shards must be >= 1"),
                       (dict(devices=[]), "devices must be non-empty"),
                       (dict(num_shards=2), "need 2x1 devices, have 1")):
        with pytest.raises(ValueError, match=match):
            ocr.shard(**bad)


@pytest.mark.parametrize("num_shards", [-1, 9])
def test_serve_num_shards_errors_match_reference(monkeypatch, num_shards):
    """-num_shards below 0 raises aocr.serve's ValueError word for word;
    more than the local devices (aocr's 8 forced host devices, the port's
    one CPU) its message with the count; both before any load."""
    def no_load(*_a, **_k):
        raise AssertionError("the checkpoint was loaded")

    monkeypatch.setattr(serve.AttentionOCR, "load", no_load)
    monkeypatch.setattr(jserve.AttentionOCR, "load", no_load)
    with pytest.raises(ValueError) as want:
        jserve.serve("missing", num_shards=num_shards)
    port_n = num_shards if num_shards < 0 else 2
    with pytest.raises(ValueError) as got:
        serve.serve("missing", num_shards=port_n, device="cpu")
    if num_shards < 0:
        assert str(got.value) == str(want.value)
    else:
        assert str(want.value) == "-num_shards 9 but only 8 local devices"
        assert str(got.value) == "-num_shards 2 but only 1 local devices"


def test_serve_shards_over_local_devices(tmp_path):
    """-num_shards 0 (every local device: the one CPU) serves through
    AttentionOCR.shard, and a server resharded over [cpu, cpu] answers
    what the unsharded model recognizes."""
    p, s, _, _, _ = _problem()
    d = str(tmp_path / "model")
    AttentionOCR(TConfig(**EVAL_KW), *weights.from_numpy(p, s),
                 device="cpu").save(d)
    ready, box = threading.Event(), []
    t = threading.Thread(target=serve.serve, kwargs=dict(
        model_dir=d, host="127.0.0.1", port=0, max_batch=4,
        cfg=TConfig(**EVAL_KW), ready_event=ready, server_box=box,
        num_shards=0, warmup=False, device="cpu"), daemon=True)
    t.start()
    assert ready.wait(120), "the server did not start"
    httpd, rec = box[0]
    try:
        assert rec.ocr.num_shards == 1
        imgs = [synth.render_word(w, 32, 32).astype(np.float32)
                for w in LABELS[:3]]
        want = rec.ocr.unshard().recognize(
            [rec.pad_width(im) for im in imgs])[0]
        rec.ocr.shard(devices=["cpu", "cpu"])
        futures = [rec.submit_async(im, EVAL_KW["beam_size"])
                   for im in imgs]
        got = [rec.wait(f).text for f in futures]
        assert got == want
    finally:
        httpd.shutdown()
        t.join(30)
        assert not t.is_alive()


# ------------------------------------------------------------- two ranks

def test_sync_batchnorm_matches_one_process(group):
    """At world size 2, unmasked (BNTrainFn's sums over the group) and
    masked (4 and 1 real rows; the differentiable all-reduce of count and
    moments): y, dx, the scale and bias gradients summed over the ranks,
    and the running statistics (global count in the unbiased variance)
    equal the one-process BN on the whole batch within 1e-5."""
    bn = _bn_problem()
    for name, mask in (("bn", None), ("bn_masked", MASK)):
        r0, r1 = (r[name] for r in group["ranks"])
        x = torch.from_numpy(bn["x"]).requires_grad_()
        p = {"scale": torch.from_numpy(bn["scale"]).requires_grad_(),
             "bias": torch.from_numpy(bn["bias"]).requires_grad_()}
        s = {"mean": torch.from_numpy(bn["mean"]),
             "var": torch.from_numpy(bn["var"])}
        y, new = cnn._bn_train(x, p, s, None if mask is None
                               else torch.from_numpy(mask))
        (y * torch.from_numpy(bn["dy"])).sum().backward()
        close = lambda a, b: np.testing.assert_allclose(  # noqa: E731
            a, b.detach().numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
        close(np.concatenate([r0["y"], r1["y"]]), y)
        close(np.concatenate([r0["dx"], r1["dx"]]), x.grad)
        close(r0["dscale"] + r1["dscale"], p["scale"].grad)
        close(r0["dbias"] + r1["dbias"], p["bias"].grad)
        for k in ("mean", "var"):
            close(r0[k], new[k])
            np.testing.assert_array_equal(r0[k], r1[k])


def _reference_step(params, stats, images, targets, targets_eval,
                    row_mask=None, steps=1):
    m = jmesh.make_mesh(num_data=2)
    cfg = Config(**KW).validate()
    step = jdp.make_dp_train_step(cfg, m)
    p = jax.tree.map(jnp.asarray, params)
    s = jax.tree.map(jnp.asarray, stats)
    opt = joptim.sgd_init(p)
    arrays = (images, targets, targets_eval) + (
        () if row_mask is None else (row_mask,))
    sharded = jmesh.shard_batch(m, *arrays)
    extra = {} if row_mask is None else {"row_mask": sharded[3]}
    losses = []
    for i in range(steps):
        out = step(p, s, opt, *sharded[:3], jnp.float32(0.1),
                   jax.random.PRNGKey(42 + i), **extra)
        p, s, opt = out.params, out.batch_stats, out.opt_state
        losses.append(float(out.loss_sum))
    return jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s), losses


@pytest.mark.parametrize("variant", ["full", "masked"])
def test_dp_step_matches_reference(group, variant):
    """make_dp_train_step at world size 2 (two steps full; one masked
    step with 4 and 1 real rows) against aocr's on a 2-device mesh:
    loss 1e-5 relative, params and BN statistics rtol 1e-3 atol 2e-4;
    the ranks' params and statistics bit-equal."""
    r0, r1 = (r[variant] for r in group["ranks"])
    if variant == "full":
        p, s, losses = _reference_step(*_problem(), steps=2)
    else:
        p, s, losses = _reference_step(*_problem(pad=5), row_mask=MASK)
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
    for tree, want in (("params", p), ("stats", s)):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a, b, rtol=1e-3, atol=2e-4), r0[tree], want)
        for a, b in zip(jax.tree.leaves(r0[tree]), jax.tree.leaves(r1[tree])):
            np.testing.assert_array_equal(a, b)
    assert r0["losses"] == r1["losses"]


def test_dp_step_augment_matches_one_process(group):
    """-augment keys each row's draws by its global row: the two ranks'
    step equals the port's one-process step on the whole batch under the
    same key (loss 1e-5 relative, params atol 2e-4)."""
    r0 = group["ranks"][0]["augment"]
    p, s, im, t, te = _problem()
    cfg = TConfig(**KW, augment=True).validate()
    tp, ts = weights.from_numpy(p, s)
    out = train_step.make_train_step(cfg)(
        tp, ts, train_step.init_opt_state(tp, cfg), im, t, te, 0.1,
        group["aug_key"])
    np.testing.assert_allclose(r0["losses"][0], float(out.loss_sum),
                               rtol=1e-5)
    plain = group["ranks"][0]["full"]["losses"][0]
    assert abs(r0["losses"][0] - plain) > 1e-3
    gp, _ = weights.to_numpy(out.params, out.batch_stats)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=1e-3, atol=2e-4), r0["params"], gp)


@pytest.mark.parametrize("name", ["beam", "greedy", "trie"])
def test_dp_eval_matches_reference(group, name):
    """make_dp_eval_step at world size 2 over 5 rows padded to 6 against
    aocr's on a 2-device mesh: labels, accuracy and cer_sum exactly,
    nll 1e-5 relative, scores and gold scores 1e-4; refills and
    min_valid equal; both ranks hold the gathered rows."""
    ep, es, im, tg, te, mask, trie = _eval_problem()
    kw = dict(EVAL_KW, beam_size=1) if name == "greedy" else EVAL_KW
    m = jmesh.make_mesh(num_data=2)
    step = jep.make_dp_eval_step(Config(**kw).validate(), m,
                                 use_trie=name == "trie")
    args = jmesh.shard_batch(m, im, tg, te, mask)
    want = step(jax.tree.map(jnp.asarray, ep), jax.tree.map(jnp.asarray, es),
                *args[:3], jnp.asarray(trie) if name == "trie" else None,
                args[3])
    r0, r1 = (r[f"eval_{name}"] for r in group["ranks"])
    real = int(mask.sum())
    np.testing.assert_array_equal(r0["labels"][:real],
                                  np.asarray(want.labels)[:real])
    assert int(r0["accuracy"]) == int(want.accuracy)
    assert float(r0["cer_sum"]) == float(want.cer_sum)
    np.testing.assert_allclose(float(r0["nll"]), float(want.nll), rtol=1e-5)
    for k in ("scores", "gold_scores"):
        np.testing.assert_allclose(r0[k][:real], np.asarray(
            getattr(want, k))[:real], rtol=1e-4, atol=1e-4)
    assert int(r0["refills"]) == int(want.refills)
    assert int(r0["min_valid"]) == int(want.min_valid)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k])


def test_trainer_num_shards_2_matches_one(group):
    """The CLI trainer at -num_shards 2 (9 crops at batch 4: two full
    steps and a 1-row tail, masked under DP with rank 1 holding no real
    row) equals -num_shards 1 from the same checkpoint: step perplexities
    1e-5 relative, final params 1e-5 absolute, global_step 3; the beam-2
    -visualize test phase writes the same results.txt.  Only rank 0
    writes the log, checkpoints and results.txt."""
    root = group["root"]
    one = os.path.join(root, "one")
    shutil.copytree(os.path.join(root, "init"), one)
    cwd = os.getcwd()
    os.chdir(one)
    try:
        train.main(TRAIN_ARGS, device="cpu")
        with open("log.txt") as f:
            one_log = f.read()
        os.rename("log.txt", "train_log.txt")
        train.main(TEST_ARGS, device="cpu")
    finally:
        os.chdir(cwd)
    with open(os.path.join(root, "rank0", "log.txt")) as f:
        dp_log = f.read()
    assert "Data-parallel training over 2 processes (gloo" in dp_log
    ppl = lambda log: [float(m) for m in re.findall(  # noqa: E731
        r"^\S+ \S+ (nan|[0-9.]+)$", log, re.M)]
    a, b = ppl(dp_log.split("End Command")[1]), ppl(one_log)
    assert len(a) == len(b) == 3
    np.testing.assert_allclose(a[1:], b[1:], rtol=1e-5)
    got = checkpoint.load(checkpoint.final_path(
        os.path.join(root, "rank0", "model")))
    want = checkpoint.load(checkpoint.final_path(os.path.join(one, "model")))
    assert got["global_step"] == want["global_step"] == 3
    jax.tree.map(lambda x, y: np.testing.assert_allclose(
        x, y, rtol=0, atol=1e-5), got["params"], want["params"])
    with open(os.path.join(root, "rank0", "results", "results.txt")) as f:
        dp_rows = f.read().splitlines()
    with open(os.path.join(one, "results", "results.txt")) as f:
        one_rows = f.read().splitlines()
    assert [r.split("\t")[:3] for r in dp_rows] == \
        [r.split("\t")[:3] for r in one_rows]
    rank1 = os.path.join(root, "rank1")
    assert sorted(os.listdir(rank1)) == ["model"]
    assert sorted(os.listdir(os.path.join(rank1, "model"))) == sorted(
        os.listdir(os.path.join(root, "init", "model")))
