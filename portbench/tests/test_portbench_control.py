"""On the card, at each cell's own size, on three seeds: the program's
readings stay within the cell's limits, and its control's (the plain
reference in the program's place, a precision below the
configuration's) and each fault's of its driver do not, save the one
fault that no number catches.  Run with

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        portbench/tests/test_portbench_control.py
"""

import pytest
import torch

from portbench import control, registry

BENCH = registry.Benchmark()
CELLS = [w["name"] for w in BENCH.doc["workloads"]]
SEEDS = [2**35 + 11, 2**35 + 1013, 2**35 + 65537]
# beam-5 returning its second beam: with random weights the beams lie
# within rounding of each other (PERF.md, Open questions)
UNCAUGHT = {("if-bf16.beam5-b512", "wrong_pick")}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(card, workload):
    limits = BENCH.limits(workload)
    got = control.readings(BENCH, workload, SEEDS, 2.0, len(SEEDS), True)
    for k, lim in limits.items():
        assert got["program_max"][k] <= lim, (k, got)
    # on every seed the control, and each fault, fails the same number
    kinds = [k[:-len("_min")] for k in got if k.endswith("_min")]
    assert "control" in kinds and len(kinds) >= 2, got
    for kind in kinds:
        caught = any(got[kind + "_min"][k] > lim for k, lim in limits.items())
        assert caught != ((workload, kind) in UNCAUGHT), (kind, got)
