"""aocr_torch.parallel.tensor_parallel (DP x TP) against the JAX package
on the CPU.

Two spawned gloo groups (tests/torch_parallel_worker.py, each joined
within 120 s): four ranks run the (2, 2) grid's steps and the CLI
trainer at -num_shards 2 -num_model_shards 2; two ranks the (1, 2)
grid's.  Each grid runs a full step, a masked step (the data shards
holding 4 and 1 real rows) and a step with dropout.  The test process
holds them to aocr.parallel.tensor_parallel.make_tp_train_step on a 2x2
CPU mesh (tests/conftest.py forces 8 host devices) and to aocr's
one-device step, with tests/test_tensor_parallel.py's tolerances (loss
rtol 1e-4, params rtol 1e-3 atol 3e-4); the per-group gradient norms to
the port's one-process step's (rtol 1e-5: a norm doubled by a wrong
collective would show); the dropout step to the port's one-process
dropout step (the port's Philox masks are not JAX's).  Replicated
leaves must be bit-equal on every rank, and each shard across the data
ranks that hold it.
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aocr import optim as joptim
from aocr import train_step as jts
from aocr import vocab
from aocr.api import AttentionOCR as JaxOCR
from aocr.config import Config
from aocr.models import model as jmodel
from aocr.parallel import mesh as jmesh
from aocr.parallel import tensor_parallel as jtp
from aocr_torch import augment, optim, train_step, weights
from aocr_torch.config import Config as TConfig
from aocr_torch.parallel import mesh, tensor_parallel
from tests import synth
from tests.torch_parallel_worker import run_group

# aocr's TP test configuration (tests/test_tensor_parallel.py)
KW = dict(batch_size=8, input_feed=True, encoder_num_hidden=64,
          target_embedding_size=8, image_width=32)
LABELS = ["ab", "cd", "ef", "gh", "ij", "kl", "mn", "op"]
MASK = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)  # shards: 4 and 1
KEY = augment.step_key(11, 3)
RATE = 0.3
GRIDS = [(2, 2), (1, 2)]
TRAIN_ARGS = ["-phase", "train", "-load_model", "-model_dir", "model",
              "-data_base_dir", "../data", "-data_path", "../data/train.txt",
              "-val_data_path", "../data/val.txt", "-log_path", "log.txt",
              "-batch_size", "4", "-num_epochs", "1",
              "-steps_per_checkpoint", "2", "-num_batches_val", "1",
              "-momentum", "0.9", "-learning_rate", "0.1"]
TRAINER_WORDS = ["ab", "cd1", "xyz", "k", "wxyz", "q0", "mm", "abc"]
T_KW = dict(input_feed=True, encoder_num_hidden=16, target_embedding_size=8,
            max_decoder_l=8, image_width=36, seed=3)


def _problem(pad=None):
    ms = jmodel.init(jax.random.PRNGKey(0), Config(**KW).validate())
    images = np.stack([synth.render_word(w, 32, 32)
                       for w in LABELS])[..., None].astype(np.float32)
    targets, targets_eval, _ = vocab.encode_batch(LABELS)
    if pad is not None:
        targets[pad:] = vocab.PAD
        targets_eval[pad:] = vocab.PAD
    return (jax.tree.map(np.asarray, ms.params),
            jax.tree.map(np.asarray, ms.batch_stats), images, targets,
            targets_eval)


def _trainer_root(root):
    d = os.path.join(root, "data")
    os.makedirs(d)
    lines = []
    for i, w in enumerate(TRAINER_WORDS):
        np.save(os.path.join(d, f"{i}.npy"), synth.render_word(w, 32, 36))
        lines.append(f"{i}.npy {w}")
    for name, rows in (("train.txt", lines), ("val.txt", lines[:4])):
        with open(os.path.join(d, name), "w") as f:
            f.write("\n".join(rows) + "\n")
    init = os.path.join(root, "init", "model")
    JaxOCR.create(Config(**T_KW)).save(init)
    for r in range(4):
        shutil.copytree(init, os.path.join(root, f"rank{r}", "model"))


def _jobs(nd, nm):
    p, s, im, t, te = _problem()
    pm, sm, imm, tm, tem = _problem(pad=5)
    base = dict(cfg_kw=KW, num_data=nd, num_model=nm)
    return [
        (f"full_{nd}x{nm}", "tp_step", dict(
            base, params=p, stats=s, images=im, targets=t, targets_eval=te)),
        (f"masked_{nd}x{nm}", "tp_step", dict(
            base, params=pm, stats=sm, images=imm, targets=tm,
            targets_eval=tem, row_mask=MASK)),
        (f"dropout_{nd}x{nm}", "tp_step", dict(
            base, cfg_kw=dict(KW, dropout=RATE), params=p, stats=s,
            images=im, targets=t, targets_eval=te, key=KEY)),
    ]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp"))
    _trainer_root(root)
    four = run_group(_jobs(2, 2) + [("train", "trainer", dict(
        root=root, argv=TRAIN_ARGS + ["-num_shards", "2",
                                      "-num_model_shards", "2"]))],
        world=4, timeout=120)
    two = run_group(_jobs(1, 2), world=2, timeout=120)
    return {"ranks": {(2, 2): four, (1, 2): two}, "root": root}


def _port_one(kind, dropout=0.0):
    """The port's one-process step on the whole batch."""
    p, s, im, t, te = _problem(pad=5 if kind == "masked" else None)
    cfg = TConfig(**dict(KW, dropout=dropout)).validate()
    tp, ts = weights.from_numpy(p, s)
    extra = {} if kind != "masked" else {
        "row_mask": torch.from_numpy(MASK), "real_bs": float(MASK.sum())}
    return train_step.make_train_step(cfg)(
        tp, ts, train_step.init_opt_state(tp, cfg), im, t, te, 0.1, KEY,
        **extra)


@pytest.fixture(scope="module")
def reference():
    """aocr's DP x TP step on a 2x2 CPU mesh and its one-device step,
    full and masked."""
    cfg = Config(**KW).validate()
    out = {}
    m = jmesh.make_mesh(num_data=2, num_model=2)
    step = jtp.make_tp_train_step(cfg, m)
    single = jts.make_train_step(cfg)
    for kind in ("full", "masked"):
        p, s, im, t, te = _problem(pad=5 if kind == "masked" else None)
        jp = jax.tree.map(jnp.asarray, p)
        mask = MASK if kind == "masked" else None
        args = (joptim.sgd_init(jp), jnp.float32(0.1),
                jax.random.PRNGKey(7))
        sh = jmesh.shard_batch(m, jnp.asarray(im), jnp.asarray(t),
                               jnp.asarray(te))
        out[("tp", kind)] = step(jtp.shard_params(jp, m),
                                 jax.tree.map(jnp.asarray, s), args[0], *sh,
                                 args[1], args[2], row_mask=mask)
        extra = {} if mask is None else dict(
            real_bs=jnp.float32(MASK.sum()), row_mask=jnp.asarray(MASK))
        out[("one", kind)] = single(jp, jax.tree.map(jnp.asarray, s),
                                    args[0], jnp.asarray(im),
                                    jnp.asarray(t), jnp.asarray(te),
                                    args[1], args[2], **extra)
    return out


def _close_params(got, want, rtol=1e-3, atol=3e-4):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=rtol, atol=atol), got, want)


@pytest.mark.parametrize("grid", GRIDS, ids=["2x2", "1x2"])
@pytest.mark.parametrize("kind", ["full", "masked"])
def test_tp_step_matches_reference(groups, reference, grid, kind):
    """The port's DP x TP step against aocr's on a 2x2 mesh and aocr's
    one-device step: loss rtol 1e-4, gathered params rtol 1e-3 atol
    3e-4; the grad norms against the port's one-process step (rtol
    1e-5)."""
    ranks = groups["ranks"][grid]
    got = ranks[0][f"{kind}_{grid[0]}x{grid[1]}"]
    for which in ("tp", "one"):
        want = reference[(which, kind)]
        np.testing.assert_allclose(got["losses"][0], float(want.loss_sum),
                                   rtol=1e-4)
        _close_params(got["params"], want.params)
    one = _port_one(kind)
    np.testing.assert_allclose(got["losses"][0], float(one.loss_sum),
                               rtol=1e-5)
    for g, n in one.grad_norms.items():
        np.testing.assert_allclose(got["norms"][0][g], float(n), rtol=1e-5,
                                   err_msg=g)


@pytest.mark.parametrize("grid", GRIDS, ids=["2x2", "1x2"])
def test_tp_ranks_agree(groups, grid):
    """Every rank returns the same gathered state; replicated leaves are
    bit-equal on every rank and each shard across its data ranks;
    gather_params(shard_params(x)) is x."""
    nd, nm = grid
    ranks = groups["ranks"][grid]
    p, _s, _im, _t, _te = _problem()
    tree, _ = weights.from_numpy(p, _s)
    specs = optim.leaves(tensor_parallel.param_specs(tree))
    for kind in ("full", "masked", "dropout"):
        name = f"{kind}_{nd}x{nm}"
        outs = [r[name] for r in ranks]
        assert [o["grid"] for o in outs] == [divmod(r, nm)
                                             for r in range(nd * nm)]
        assert all(o["roundtrip"] for o in outs)
        for o in outs[1:]:
            assert o["losses"] == outs[0]["losses"]
            jax.tree.map(np.testing.assert_array_equal, o["params"],
                         outs[0]["params"])
        for i, spec in enumerate(specs):
            for r, o in enumerate(outs):
                # the same m on another data rank, or any rank if replicated
                peer = outs[r % nm] if spec is not None else outs[0]
                np.testing.assert_array_equal(o["local"][i],
                                              peer["local"][i])


@pytest.mark.parametrize("grid", GRIDS, ids=["2x2", "1x2"])
def test_tp_dropout_matches_one_process(groups, grid):
    """A TP step with dropout 0.3 against the port's one-process dropout
    step (the masks keyed by global row, the same on every model rank)."""
    got = groups["ranks"][grid][0][f"dropout_{grid[0]}x{grid[1]}"]
    one = _port_one("full", RATE)
    np.testing.assert_allclose(got["losses"][0], float(one.loss_sum),
                               rtol=1e-5)
    for g, n in one.grad_norms.items():
        np.testing.assert_allclose(got["norms"][0][g], float(n), rtol=1e-5,
                                   err_msg=g)
    _close_params(got["params"], weights.to_numpy(one.params,
                                                  one.batch_stats)[0],
                  rtol=0, atol=1e-5)
    # and dropout moved the step
    assert got["losses"][0] != groups["ranks"][grid][0][
        f"full_{grid[0]}x{grid[1]}"]["losses"][0]


def test_tp_shards_and_uneven_sizes():
    """shard_params gives each model rank its contiguous slices, as aocr's
    param_pspecs lays them out (test_tp_weights_actually_sharded's
    shapes); a size the model axis does not divide raises ValueError."""
    p, s, _im, _t, _te = _problem()
    tree, _ = weights.from_numpy(p, s)
    parts = [tensor_parallel.shard_params(tree, mesh.Grid(2, 4, 0, m, None,
                                                          None))
             for m in range(4)]
    w = tree["decoder"]["layers"][0]["wi"]
    assert {tuple(x["decoder"]["layers"][0]["wi"].shape) for x in parts} \
        == {(w.shape[0], w.shape[1] // 4)}
    for axis, get in ((1, lambda t: t["decoder"]["layers"][1]["wh"]),
                      (0, lambda t: t["decoder"]["layers"][1]["bi"]),
                      (1, lambda t: t["decoder"]["w_a"]),
                      (0, lambda t: t["decoder"]["w_c"]),
                      (0, lambda t: t["projector"]["w"])):
        assert torch.equal(torch.cat([get(x) for x in parts], axis),
                           get(tree))
    for get in (lambda t: t["decoder"]["embedding"],
                lambda t: t["projector"]["b"], lambda t: t["cnn"]["conv1"]
                ["w"], lambda t: t["encoder_fw"]["layers"][0]["wi"]):
        assert all(get(x) is get(tree) for x in parts)
    with pytest.raises(ValueError, match="does not split over a model axis "
                                         "of 3"):
        tensor_parallel.shard_params(tree, mesh.Grid(1, 3, 0, 0, None, None))


def test_tp_trainer_cli(groups):
    """-num_shards 2 -num_model_shards 2 in four processes: rank 0 logs
    aocr's mesh line and the flat eval's, trains the epoch's steps with
    finite perplexities, and writes a whole checkpoint that
    aocr.api.AttentionOCR.load reads; the other ranks write nothing."""
    root = groups["root"]
    with open(os.path.join(root, "rank0", "log.txt")) as f:
        log = f.read()
    assert "DP x TP training over a 2x2 (data, model) mesh" in log
    assert "Sharded evaluation over 4 devices" in log
    steps = [float(line.split()[-1]) for line in log.splitlines()
             if "training perplexity" in line]
    assert steps and all(np.isfinite(steps))
    for r in (1, 2, 3):
        assert not os.path.exists(os.path.join(root, f"rank{r}", "log.txt"))
    ocr = JaxOCR.load(os.path.join(root, "rank0", "model"))
    init = JaxOCR.load(os.path.join(root, "init", "model"))
    a, b = (jax.tree.leaves(o.params) for o in (ocr, init))
    assert [x.shape for x in a] == [x.shape for x in b]
    assert max(float(jnp.abs(x - y).max()) for x, y in zip(a, b)) > 1e-4
