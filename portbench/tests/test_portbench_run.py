"""The harness end to end at a tiny size on the CPU: every cell comes out
correct, and with the timed path broken underneath, `correct` comes out
false; the command refuses to run without a card; nothing it loads is
JAX or the JAX package."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.tests.tiny import TinyBench

ROOT = Path(run.__file__).resolve().parents[1]
PKG = ROOT / "portbench"
CELLS = [w["name"] for w in TinyBench().doc["workloads"]]
RECOGNIZE = [w for w in CELLS if "train" not in w]
SEED = 2**40 + 17


def run_tiny(workload, seed=SEED):
    return run.run_cell(TinyBench(), workload, seed, 0.3, False,
                        device="cpu")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct(workload):
    out = run_tiny(workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {
        m["name"] for m in TinyBench().end_to_end(workload)}
    assert "setup_s" in out["metrics"]
    assert list(out)[-1] == "checks"
    assert set(out["counters"]["launches"]) >= {"greedy_loop", "tf_fwd"}


def _wrap_decode(monkeypatch, alter):
    from aocr_torch import decode

    real = decode.beam_decode

    def broken(*a, **kw):
        labels, scores = real(*a, **kw)
        return alter(labels.clone(), scores.clone())

    monkeypatch.setattr(decode, "beam_decode", broken)


def _token_altered(labels, scores):
    # every row's first token moved to another character
    ch = labels[:, 0]
    labels[:, 0] = torch.where(ch >= 3, (ch - 3 + 1) % 36 + 3, 3)
    return labels, scores


def _half_left_out(labels, scores):
    # the second half of the rows never decoded: PAD labels, score 0
    h = labels.shape[0] // 2
    labels[h:], scores[h:] = 0, 0.0
    return labels, scores


@pytest.mark.parametrize("fault", [_token_altered, _half_left_out],
                         ids=["token_altered", "half_left_out"])
@pytest.mark.parametrize("workload", RECOGNIZE)
def test_recognize_fault_is_not_correct(monkeypatch, workload, fault):
    _wrap_decode(monkeypatch, fault)
    assert not run_tiny(workload)["correct"]


def _broken_step(monkeypatch, fault):
    from aocr_torch import train_step

    real = train_step.make_train_step

    def make(cfg):
        step = real(cfg)

        def broken(p, s, o, images, tg, te, *a, **kw):
            if fault == "half_batch":
                h = images.shape[0] // 2
                return step(p, s, o, images[:h], tg[:h], te[:h], *a, **kw)
            out = step(p, s, o, images, tg, te, *a, **kw)
            return out._replace(params=p)  # state unchanged

        return broken

    monkeypatch.setattr(train_step, "make_train_step", make)


@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged"])
def test_train_fault_is_not_correct(monkeypatch, fault):
    _broken_step(monkeypatch, fault)
    assert not run_tiny("cli-f32.train-b400")["correct"]


def test_no_card_no_result():
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout == ""
    assert "CUDA device" in p.stderr


def test_a_run_loads_no_jax():
    code = ("from portbench import run\n"
            "from portbench.tests.tiny import TinyBench\n"
            f"run.run_cell(TinyBench(), {CELLS[0]!r}, 3, 0.2, True, "
            "device='cpu')\n"
            "import json, sys; print(json.dumps(run.loaded_forbidden()))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.splitlines()[-1]) == []


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_module_walk(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "aocr"}, path
    if "reference" in path.relative_to(PKG).parts:
        assert "aocr_torch" not in tops and "portbench" not in tops, path
