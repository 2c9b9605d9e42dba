"""The CLI trainer `python -m aocr_torch.train` against `aocr.train` on
CPU, through both packages' `main` on one tiny `.npy` word set.

One module fixture writes an `aocr` checkpoint (a narrow model: encoder
16, embedding 8, 36-pixel crops, T=8) and ten crops, then runs each
package's `-phase train -load_model` from it for one epoch at batch 4
(two full steps and a padded partial one, a checkpoint and a validation
sweep every 2 steps, SGD with momentum), each test phase on the trained
`aocr` checkpoint, and each package's resume from the other's
checkpoint.  The port runs with device="cpu", so every kernel wrapper
takes its plain version.

Tolerances: final params within 1e-5 absolute and perplexity lines
within 1e-5 relative (float32); global_step and the learning rate equal;
test transcripts identical but where a row parts at a near-tie (the two
best scores within 1e-4), which the test reports.
"""

import os
import re
import shutil

import numpy as np
import pytest

import jax
import torch

from aocr import checkpoint
from aocr import train as jtrain
from aocr.api import AttentionOCR as JaxOCR
from aocr.config import Config
from aocr_torch import eval as teval
from aocr_torch import train
from aocr_torch.config import Config as TConfig
from tests import synth

WORDS = ["ab", "cd1", "xyz", "k", "wxyz", "q0", "mm", "abc", "z9", "hello"]
KW = dict(input_feed=True, encoder_num_hidden=16, target_embedding_size=8,
          max_decoder_l=8, image_width=36, seed=3)
TRAIN_ARGS = ["-phase", "train", "-load_model", "-model_dir", "model",
              "-data_base_dir", "../data", "-data_path", "../data/train.txt",
              "-val_data_path", "../data/val.txt", "-log_path", "log.txt",
              "-batch_size", "4", "-num_epochs", "1",
              "-steps_per_checkpoint", "2", "-num_batches_val", "1",
              "-momentum", "0.9", "-learning_rate", "0.1"]


def _test_args(dictionary: bool):
    return (["-phase", "test", "-load_model", "-model_dir", "model",
             "-data_base_dir", "../data", "-data_path", "../data/val.txt",
             "-log_path", "log.txt", "-output_dir", "results", "-visualize",
             "-beam_size", "2", "-batch_size", "4",
             "-steps_per_checkpoint", "1"]
            + (["-use_dictionary", "-dictionary_path", "../data/dict.txt"]
               if dictionary else []))


def _run(main, workdir, args, model_from=None, **kw):
    """main(args) from workdir, its model/ a copy of model_from's."""
    os.makedirs(workdir, exist_ok=True)
    if model_from is not None:
        shutil.copytree(os.path.join(model_from, "model"),
                        os.path.join(workdir, "model"))
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        main(list(args), **kw)
    finally:
        os.chdir(cwd)
    with open(os.path.join(workdir, "log.txt")) as f:
        return f.read().splitlines()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trainer"))
    d = os.path.join(root, "data")
    os.makedirs(d)
    lines = []
    for i, w in enumerate(WORDS):
        np.save(os.path.join(d, f"{i}.npy"), synth.render_word(w, 32, 36))
        lines.append(f"{i}.npy {w}")
    with open(os.path.join(d, "train.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(d, "val.txt"), "w") as f:
        f.write("\n".join(lines[:6]) + "\n")
    with open(os.path.join(d, "dict.txt"), "w") as f:
        f.write("\n".join(WORDS + ["abd", "xy", "kk", "q", "zz"]) + "\n")
    JaxOCR.create(Config(**KW)).save(os.path.join(root, "init", "model"))
    init = os.path.join(root, "init")
    port_main = lambda a: train.main(a, device="cpu")
    out = {"root": root}
    out["jax"] = _run(jtrain.main, f"{root}/jax", TRAIN_ARGS, init)
    out["port"] = _run(port_main, f"{root}/port", TRAIN_ARGS, init)
    for dictionary in (False, True):
        for name, main in (("jax", jtrain.main), ("port", port_main)):
            key = f"{name}_test{'_dict' if dictionary else ''}"
            out[key] = _run(main, f"{root}/{key}", _test_args(dictionary),
                            f"{root}/jax")
    # each package resumes the other's checkpoint
    out["jax_from_port"] = _run(jtrain.main, f"{root}/jax_from_port",
                                TRAIN_ARGS, f"{root}/port")
    out["port_from_jax"] = _run(port_main, f"{root}/port_from_jax",
                                TRAIN_ARGS, f"{root}/jax")
    return out


def _parallel_run(runs, flag) -> None:
    """The module's train run with flag in two spawned gloo ranks, each
    in its own directory beside data/."""
    from tests.torch_parallel_worker import run_group

    root = runs["root"]
    tag = "_".join(f[1:] for f in flag if f.startswith("-"))
    for r in (0, 1):
        shutil.copytree(os.path.join(root, "init", "model"),
                        os.path.join(root, tag, f"rank{r}", "model"))
    argv = [a.replace("../data", "../../data") for a in TRAIN_ARGS + flag]
    run_group([("train", "trainer", dict(root=os.path.join(root, tag),
                                         argv=argv))], timeout=120)
    with open(os.path.join(root, tag, "rank0", "log.txt")) as f:
        step, window = _ppl(f.read().splitlines())
    assert len(step) == 3 and all(np.isfinite(window))
    assert sorted(os.listdir(os.path.join(root, tag, "rank1", "model"))) \
        == sorted(os.listdir(os.path.join(root, "init", "model")))
    got = _final(root, f"{tag}/rank0")
    plain = _final(root, "port")
    assert got["global_step"] == plain["global_step"] == 3
    if "-multihost" in flag:
        init = _final(root, "init")
        diff = max(float(np.abs(x - y).max()) for x, y in zip(
            jax.tree.leaves(got["params"]),
            jax.tree.leaves(init["params"])))
        assert diff > 1e-4
        return
    step_one, _ = _ppl(runs["port"])
    np.testing.assert_allclose(step[1:], step_one[1:], rtol=1e-5)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=1e-5), got["params"], plain["params"])


def _final(root, name):
    return checkpoint.load(checkpoint.final_path(
        os.path.join(root, name, "model")))


def _ppl(log):
    """The per-step perplexity lines and the 'training perplexity' ones."""
    msgs = [line.split(" ", 2)[2] for line in log]
    step = [float(m) for m in msgs if re.fullmatch(r"nan|[0-9.]+", m)]
    window = [float(m.rsplit("= ", 1)[1]) for m in msgs
              if "training perplexity" in m]
    return step, window


def _close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, equal_nan=True)


def test_training_matches_reference(runs):
    """Three steps from one checkpoint (the third a batch of 2 padded to
    4): final params and batch stats within 1e-5, the momentum buffers
    within 1e-4 of their scale, equal global_step, learning rate and
    step counter, perplexity lines within 1e-5 relative."""
    want, got = _final(runs["root"], "jax"), _final(runs["root"], "port")
    assert got["global_step"] == want["global_step"] == 3
    for k in ("learning_rate", "eval_counter", "buf_fresh"):
        assert got["optim_state"][k] == want["optim_state"][k], k
    check = lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    jax.tree.map(check, got["params"], want["params"])
    jax.tree.map(check, got["batch_stats"], want["batch_stats"])
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=1e-4 * max(1.0, float(np.abs(b).max()))),
        got["optim_state"]["momentum_buf"],
        want["optim_state"]["momentum_buf"])
    (gs, gw), (ws, ww) = _ppl(runs["port"]), _ppl(runs["jax"])
    assert len(gs) == 3 and len(gw) == 1
    _close(gs, ws, 1e-5)
    _close(gw, ww, 1e-5)
    for pattern in ("Val Accuracy = ", "Throughput: "):
        assert sum(pattern in line for line in runs["port"]) == \
            sum(pattern in line for line in runs["jax"]) > 0


def _results(root, key):
    with open(os.path.join(root, key, "results", "results.txt")) as f:
        return [line.rstrip("\n").split("\t") for line in f]


@pytest.mark.parametrize("dictionary", [False, True])
def test_test_phase_matches_reference(runs, dictionary):
    """-phase test -visualize -beam_size 2 on the trained aocr checkpoint:
    the same results.txt paths and golds; predictions identical but at
    near-ties; the accuracy and CER lines agree with the predictions."""
    sfx = "_dict" if dictionary else ""
    got = _results(runs["root"], f"port_test{sfx}")
    want = _results(runs["root"], f"jax_test{sfx}")
    assert [r[:2] for r in got] == [r[:2] for r in want]
    parted = [(g, w) for g, w in zip(got, want) if g[2] != w[2]]
    for g, w in parted:
        assert abs(float(g[3]) - float(w[3])) < 1e-4, (g, w)
    print(f"rows parted at near-ties: {len(parted)} of {len(got)}")
    same = [g for g, w in zip(got, want) if g[2] == w[2]]
    for g, w in zip(got, want):
        if g[2] == w[2]:
            np.testing.assert_allclose(float(g[3]), float(w[3]), rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_allclose(float(g[4]), float(w[4]), rtol=1e-5,
                                   atol=1e-5)
    assert same
    if dictionary:
        words = set(open(os.path.join(runs["root"], "data",
                                      "dict.txt")).read().split())
        assert all(any(w.startswith(r[2]) for w in words) for r in got)
    log = runs[f"port_test{sfx}"]
    acc = float([line for line in log if "Epoch: 1 Number of samples" in line
                 ][0].rsplit("= ", 1)[1])
    cer = float([line for line in log if "Character error rate" in line
                 ][0].rsplit("= ", 1)[1])
    assert acc == pytest.approx(np.mean([r[1] == r[2] for r in got]),
                                abs=1e-6)
    assert cer == pytest.approx(np.mean(
        [min(1.0, teval.levenshtein(r[2], r[1]) / max(len(r[1]), 1))
         for r in got]), abs=1e-6)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resume_crosses_packages(runs, writer):
    """Each package resumes the other's checkpoint (params, batch stats,
    momentum buffers, step counter, learning rate) and trains on: the
    global step and counter continue, and the params match the other
    package's resume of this one's checkpoint within 1e-4."""
    reader = "jax" if writer == "port" else "port"
    got = _final(runs["root"], f"{reader}_from_{writer}")
    src = _final(runs["root"], writer)
    assert got["global_step"] == 6
    assert got["optim_state"]["eval_counter"] == 6
    assert not got["optim_state"]["buf_fresh"]
    assert got["optim_state"]["learning_rate"] <= \
        src["optim_state"]["learning_rate"]
    assert any("Loading model from" in line
               for line in runs[f"{reader}_from_{writer}"])
    # the other package, resuming this one's (near-equal) checkpoint
    other = _final(runs["root"], f"{writer}_from_{reader}")
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0,
                                                         atol=1e-4),
                 got["params"], other["params"])


def test_trainer_defaults_to_cuda(tmp_path):
    """Trainer and main run on CUDA unless told otherwise: without it they
    raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    log = type("Log", (), {"info": lambda self, m: None})()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.Trainer(TConfig(**KW), log)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["-phase", "test", "-log_path",
                    str(tmp_path / "log.txt")])


TENSOR_PARALLEL = "ROADMAP queue 1: Tensor parallel"


@pytest.mark.parametrize("flag,item", [
    (["-num_shards", "2"], None), (["-num_model_shards", "2"],
                                   TENSOR_PARALLEL),
    (["-multihost", "-num_shards", "2"], None), (["-augment"], None),
    (["-device_preprocess", "-no_snap_width_ladder"], None)],
    # the cases' ids from when the items were named by number
    ids=["flag0-item 11", "flag1-item 11", "flag2-item 11", "flag3-item 10",
         "flag4-item 10"])
def test_unported_options_raise(runs, tmp_path, flag, item):
    """Tensor parallelism names its ROADMAP item.  The other options,
    once refused, now train: the module's run from the same checkpoint
    with each flag added.  -num_shards 2 runs in two processes over gloo
    (tests/torch_parallel_worker.py) and gives the one-process run's
    params within 1e-5; -multihost -num_shards 2 shards the manifest (5
    rows a process, steps of 2, 2 and a masked 1), keeps the processes
    in lockstep and trains 3 steps.  Only rank 0 writes the log and the
    checkpoints.  The crops are already 32 x 36, so device preprocessing
    gives the host-mode run's params (within 1e-6); -augment draws from
    (-seed, global step), so two runs give the same params, and not the
    unaugmented run's."""
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            train.main(["-phase", "test", "-log_path",
                        str(tmp_path / "l.txt")] + flag, device="cpu")
        return
    if "-num_shards" in flag:
        _parallel_run(runs, flag)
        return
    root = runs["root"]
    port_main = lambda a: train.main(a, device="cpu")  # noqa: E731
    tags = [f"{flag[0][1:]}_{n}" for n in
            ((0, 1) if flag == ["-augment"] else (0,))]
    for tag in tags:  # beside data/, which TRAIN_ARGS name relatively
        log = _run(port_main, os.path.join(root, tag), TRAIN_ARGS + flag,
                   os.path.join(root, "init"))
        step, window = _ppl(log)
        assert len(step) == 3 and all(np.isfinite(window))
    got = _final(root, tags[0])
    plain = _final(root, "port")
    assert got["global_step"] == plain["global_step"] == 3
    close = lambda a, b: jax.tree.map(  # noqa: E731
        lambda x, y: np.testing.assert_allclose(x, y, rtol=0, atol=1e-6),
        a, b)
    if flag == ["-augment"]:
        close(got["params"], _final(root, tags[1])["params"])
        diff = max(float(np.abs(x - y).max()) for x, y in zip(
            jax.tree.leaves(got["params"]), jax.tree.leaves(plain["params"])))
        assert diff > 1e-4
    else:
        close(got["params"], plain["params"])
