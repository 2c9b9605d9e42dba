"""The kernels' plan check (`aocr_torch.ops.cuda.held_plan`) on the CPU.

Each kernel's `checked_plan` holds its wrapper's launch plan against the
kernel's own, read once per shape through `aocr_<kernel>_plan`.  Here a
fake library stands in for the compiled one: its plan queries fill the
out-array with a given plan and return a given code, so the match, the
mismatch, the failed query, the cache and the rows route (an all-zero
kernel plan, which only beam_step and decode_step have) are tested for
every kernel without a card.
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import logging

import pytest
import torch

from aocr_torch.ops import cuda
from aocr_torch.ops.cuda import (beam_loop, beam_step, conv1_pool,
                                 conv1_pool_bwd, conv1_pool_dx, decode_step,
                                 greedy_loop, lstm_bwd, lstm_fwd, tf_bwd,
                                 tf_fwd)

BF, F32 = torch.bfloat16, torch.float32
ACTIVE = 7  # 16-SM clusters an H100 runs at once
RESIDENT = 264  # blocks an H100 holds at once (conv1 kernels)

# id: (kernel, module, its checked_plan at a shape -> plan, the wrapper's
# plan at `active` clusters or blocks, that active)
CASES = {
    "conv1_pool": ("conv1_pool", conv1_pool,
                   lambda: conv1_pool.checked_plan(6, 32, 100, BF),
                   lambda a: conv1_pool.plan(6, 32, 100, BF, a), RESIDENT),
    "conv1_pool_bwd": ("conv1_pool_bwd", conv1_pool_bwd,
                       lambda: conv1_pool_bwd.checked_plan(6, 32, 100, F32),
                       lambda a: conv1_pool_bwd.plan(6, 32, 100, a),
                       RESIDENT),
    "conv1_pool_dx": ("conv1_pool_dx", conv1_pool_dx,
                      lambda: conv1_pool_dx.checked_plan(6, 32, 100, BF),
                      lambda a: conv1_pool_dx.plan(6, 32, 100, a), RESIDENT),
    "lstm_fwd": ("lstm_fwd", lstm_fwd,
                 lambda: lstm_fwd.checked_plan(256, 33, BF, F32),
                 lambda a: lstm_fwd.plan(256, 33, BF, a), ACTIVE),
    "lstm_bwd": ("lstm_bwd", lstm_bwd,
                 lambda: lstm_bwd.checked_plan(512, 33, BF),
                 lambda a: lstm_bwd.plan(512, 33, BF, a), ACTIVE),
    # float32 takes lstm_bwd's rows route, a Plan of its own (route 0)
    "lstm_bwd_rows": ("lstm_bwd", lstm_bwd,
                      lambda: lstm_bwd.checked_plan(512, 33, F32),
                      lambda a: lstm_bwd.plan(512, 33, F32, a), ACTIVE),
    "greedy_loop": ("greedy_loop", greedy_loop,
                    lambda: greedy_loop.checked_plan(256, 6, BF, 24, 128,
                                                     2)[0],
                    lambda a: greedy_loop.plan(256, 6, BF, 24, 128, 2, a),
                    ACTIVE),
    "tf_fwd": ("tf_fwd", tf_fwd,
               lambda: tf_fwd.checked_plan(256, 6, BF, 24, 2),
               lambda a: tf_fwd.plan(256, 6, BF, 24, 2, a), ACTIVE),
    "tf_bwd": ("tf_bwd", tf_bwd,
               lambda: tf_bwd.checked_plan(256, 6, BF, 24, 2),
               lambda a: tf_bwd.plan(256, 6, BF, 24, 2, a), ACTIVE),
    "beam_step": ("beam_step", beam_step,
                  lambda: beam_step.checked_plan(256, 6, 5, BF, 24, 128),
                  lambda a: beam_step.plan(256, 6, 5, BF, 24, 128, a),
                  ACTIVE),
    # K=90 beams pass the largest tile: the rows route, None
    "beam_step_rows": ("beam_step", beam_step,
                       lambda: beam_step.checked_plan(1024, 3, 90, BF, 9,
                                                      128),
                       lambda a: beam_step.plan(1024, 3, 90, BF, 9, 128, a),
                       ACTIVE),
    "decode_step": ("decode_step", decode_step,
                    lambda: decode_step.checked_plan(256, 6, BF, 24, 128),
                    lambda a: decode_step.plan(256, 6, BF, 24, 128, a),
                    ACTIVE),
    # no cluster plan past 16 blocks of greedy_loop.MAX_UNITS: the rows
    # route, None
    "decode_step_rows": ("decode_step", decode_step,
                         lambda: decode_step.checked_plan(8200, 1, BF, 24,
                                                          128),
                         lambda a: decode_step.plan(8200, 1, BF, 24, 128, a),
                         ACTIVE),
    "beam_loop": ("beam_loop", beam_loop,
                  lambda: beam_loop.checked_plan(256, 6, 5, BF, 24, 128, 2),
                  lambda a: beam_loop.plan(256, 6, 5, BF, 24, 128, 2, a),
                  ACTIVE),
}
# the kernels whose rows route is no plan (None, all 0 from the kernel)
ROWS_NONE = ("beam_step", "decode_step")
# the plan fields each kernel's query writes before the active count
FIELDS = {"conv1_pool": 4, "conv1_pool_bwd": 3, "conv1_pool_dx": 3,
          "lstm_fwd": 8, "lstm_bwd": 6, "greedy_loop": 9, "tf_fwd": 9,
          "tf_bwd": 9, "beam_step": 10, "decode_step": 10, "beam_loop": 10}


class FakeLibrary:
    """Stands in for `cuda.library()`: every `aocr_<kernel>_plan` writes
    `fields` and then `active` into its out-array and returns `rc`;
    `queries` counts them.  greedy_loop's split query answers 0, as the
    kernel does for a context this short."""

    def __init__(self, fields, active, rc=0):
        self.fields, self.active, self.rc, self.queries = (
            fields, active, rc, 0)

    def aocr_greedy_loop_split(self, *args):
        return 0

    def __getattr__(self, name):
        if not (name.startswith("aocr_") and name.endswith("_plan")):
            raise AttributeError(name)

        def query(*args):
            self.queries += 1
            out = args[-1]
            for i, v in enumerate((*self.fields, self.active)):
                out[i] = v
            return self.rc
        return query


@pytest.fixture
def case(request, monkeypatch):
    """The case's kernel, checked_plan, mirror and active, with the
    module's plan cache emptied for the test."""
    kernel, mod, checked, mirror, active = CASES[request.param]
    monkeypatch.setattr(mod, "plans", {})
    if mod is greedy_loop:
        monkeypatch.setattr(mod, "splits", {})
    return kernel, mod, checked, mirror, active


def _use(monkeypatch, lib):
    monkeypatch.setattr(cuda, "library", lambda: lib)
    return lib


def _as_fields(p, kernel):
    return (0,) * FIELDS[kernel] if p is None else tuple(p)


@pytest.mark.parametrize("case", list(CASES), indirect=True)
def test_plan_check_holds_and_caches_the_kernels_plan(case, monkeypatch,
                                                      caplog):
    """The kernel's own plan equal to the wrapper's: the plan is returned,
    logged once on the kernel's logger and cached with its line; a second
    launch of the shape neither queries nor logs again."""
    kernel, mod, checked, mirror, active = case
    want = mirror(active)
    lib = _use(monkeypatch, FakeLibrary(_as_fields(want, kernel), active))
    with caplog.at_level(logging.INFO, logger="aocr_torch.ops.cuda"):
        assert checked() == want
        assert checked() == want
    assert lib.queries == 1
    (p, line), = mod.plans.values()
    assert p == want
    assert [(r.name, r.getMessage()) for r in caplog.records] == [
        (f"aocr_torch.ops.cuda.{kernel}", line)]
    assert line.startswith(f"{kernel} plan ")


@pytest.mark.parametrize("case", list(CASES), indirect=True)
def test_plan_check_raises_on_a_mismatch(case, monkeypatch):
    """A kernel plan that differs from the wrapper's in one field raises
    the mismatch, naming both, and caches nothing."""
    kernel, mod, checked, mirror, active = case
    got = list(_as_fields(mirror(active), kernel))
    got[-1] += 1
    _use(monkeypatch, FakeLibrary(got, active))
    with pytest.raises(RuntimeError,
                       match=f"^{kernel} plan mismatch: kernel "):
        checked()
    assert not mod.plans


@pytest.mark.parametrize("case", list(CASES), indirect=True)
def test_plan_check_raises_on_a_failed_query(case, monkeypatch):
    """A plan query that returns a CUDA error raises it and caches
    nothing."""
    kernel, mod, checked, mirror, active = case
    _use(monkeypatch, FakeLibrary(_as_fields(mirror(active), kernel),
                                  active, rc=7))
    with pytest.raises(RuntimeError,
                       match=f"^aocr_{kernel}_plan failed: CUDA error 7$"):
        checked()
    assert not mod.plans


@pytest.mark.parametrize("none_active", [False, True])
@pytest.mark.parametrize(
    "case", [k for k in CASES if k != "lstm_fwd"], indirect=True)
def test_plan_check_all_zero_plan(case, none_active, monkeypatch):
    """An all-zero kernel plan is the rows route, None, for beam_step and
    decode_step where the wrapper's plan is None too (a shape no tile
    takes, or a card that runs none of the clusters); everywhere else it
    is a mismatch, also where a kernel with no rows route finds no plan
    (lstm_bwd's rows route is a Plan; lstm_fwd's mirror divides by the
    active clusters)."""
    kernel, mod, checked, mirror, active = case
    active = 0 if none_active else active
    _use(monkeypatch, FakeLibrary((0,) * FIELDS[kernel], active))
    if kernel in ROWS_NONE and mirror(active) is None:
        assert checked() is None
        (p, line), = mod.plans.values()
        assert p is None and ": the rows route (" in line
    else:
        with pytest.raises(RuntimeError, match=f"^{kernel} plan mismatch"):
            checked()
