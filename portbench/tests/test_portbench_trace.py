"""The percentile, the trace's reduction and the per-layer readers, on
numbers whose answers are known."""

import numpy as np
import pytest

from portbench import counts, registry, stats
from portbench.drivers import recognize
from portbench.run import RunInfo
from portbench.trace import Trace, breakdown, union


@pytest.mark.parametrize("n", [1, 2, 7, 100, 571])
def test_percentile_matches_numpy(n):
    v = np.random.default_rng(n).exponential(size=n).tolist()
    assert stats.percentile(v, 95) == pytest.approx(np.percentile(v, 95))


def test_p95_is_over_all_calls():
    st = recognize.State({}, {"batch": 4}, 0, None, None, [])
    # 19 fast calls and one slow: the slow one sits above the 95th rank
    calls = [(0, 0.010, [], [])] * 19 + [(0, 0.110, [], [])]
    res = recognize.Result(seconds=2.0, calls=calls)
    e2e = recognize.end_to_end(st, res)
    assert e2e["recognize_p95_ms"] == pytest.approx(15.0)
    assert e2e["recognize_images_per_s"] == pytest.approx(40.0)


def chrome(events):
    return {"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": a, "dur": d}
        for c, n, a, d in events]}


DOC = chrome([
    ("user_annotation", "portbench.call", 0, 100),
    ("user_annotation", "portbench.call", 120, 100),
    ("cpu_op", "aten::copy_", 80, 30),
    ("kernel", "void aocr::greedy_cluster_kernel<float, 10>(x)", 10, 40),
    ("kernel", "other", 30, 30),            # overlaps: counted once
    ("gpu_memcpy", "Memcpy HtoD", 130, 20),
    ("kernel", "void aocr::greedy_cluster_kernel<float, 10>(x)", 160, 40),
])


def test_union_and_window():
    tr = Trace.from_chrome(DOC)
    assert tr.window() == (0, 220)
    assert union(tr.device, 0, 220) == [[10, 60], [130, 150], [160, 200]]
    assert tr.busy(0, 220) == 50 + 20 + 40
    assert tr.kernel_time(lambda n: "greedy" in n) == (80, 2)


def test_breakdown():
    b = breakdown(Trace.from_chrome(DOC))
    assert b["device_ops"][0] == [
        "void aocr::greedy_cluster_kernel<float, 10>(x)", pytest.approx(80e-6)]
    # gaps: 0-10, 60-130, 150-160, 200-220; the longest is named by the
    # call span and the host op running at its middle
    assert b["idle_gaps"][0] == ["call/aten::copy_", pytest.approx(70e-6)]
    assert len(b["idle_gaps"]) == 4


def test_readers_on_a_known_trace():
    cfg = registry.Benchmark().config("aocr-cli-f32")
    calls = [{"entry": "recognize", "B": 512, "K": 1, "T": 50, "W": 100,
              "row_steps": [50] * 512}] * 2
    run = RunInfo(Trace.from_chrome(DOC), calls, cfg)
    c = cfg["config"]
    bound = counts.bound_s(counts.loop_flops(c, 100, 512 * 50),
                           counts.loop_bytes(c, 100, 512, 1, 50, "float32"),
                           "float32")
    assert registry.reader("greedy_loop_roofline")(run) == \
        pytest.approx(100 * 2 * bound / 80e-6)
    assert registry.reader("device_idle_pct.recognize")(run) == \
        pytest.approx(100 * (1 - 110 / 220))
    assert registry.reader("recognize_host_ms")(run) == pytest.approx(
        ((100 - 50) + (100 - 60)) / 2 * 1e-3)
    flops = counts.forward_flops(c, 100, [50] * 512)
    assert registry.reader("recognize_mfu_pct")(run) == pytest.approx(
        100 * 2 * flops / 220e-6 / 67e12)
    # nothing to read: None, never 0
    assert registry.reader("beam_loop_roofline")(run) is None
    assert registry.reader("train_gemm_ms")(run) is None
    assert registry.reader("device_idle_pct.train")(run) is None


@pytest.mark.parametrize("base", ["recognize_host_ms", "greedy_loop_roofline",
                                  "recognize_mfu_pct",
                                  "device_idle_pct.recognize"])
def test_host_paced_readers_read_their_quantity(base):
    cfg = registry.Benchmark().config("aocr-if-bf16")
    calls = [{"entry": "recognize", "B": 512, "K": 1, "T": 50, "W": 100,
              "row_steps": [50] * 512}] * 2
    run = RunInfo(Trace.from_chrome(DOC), calls, cfg)
    name = base.split(".")[0] + ".host_paced"
    assert registry.reader(name)(run) == registry.reader(base)(run)
