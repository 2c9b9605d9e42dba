"""The readers of the program's own spans (`aocr_torch.recognize.*`,
`aocr_torch.decode.pack`) on a trace whose answers are known, and on a
tiny traced run on the CPU."""

import pytest

from portbench import registry, run
from portbench.run import RunInfo
from portbench.tests.tiny import TinyBench
from portbench.trace import Trace, breakdown

SPANS = ("recognize_idle_transcripts_ms", "recognize_idle_input_ms",
         "recognize_idle_dispatch_ms", "recognize_weight_packs")
R = "aocr_torch.recognize"
PACK = "aocr_torch.decode.pack"


def chrome(events):
    return {"traceEvents": [
        {"ph": "X", "cat": c, "name": n, "ts": a, "dur": d}
        for c, n, a, d in events]}


def call(t0, transcripts, packs):
    """A recognize call at t0 (100 us long): its spans, and the device
    busy 15-25 (the copy) and 40-68 (the decode) after t0."""
    u = "user_annotation"
    return [(u, "portbench.call", t0, 100), (u, R, t0 + 1, 98),
            (u, R + ".prepare", t0 + 2, 8),       # idle 8
            (u, R + ".copy", t0 + 10, 10),        # busy 15-20: idle 5
            (u, R + ".decode", t0 + 20, 30),      # busy 20-25, 40-50: idle 15
            (u, R + ".fetch", t0 + 50, 20),       # busy 50-68: idle 2
            (u, R + ".transcripts", t0 + 70, transcripts),
            ("cpu_op", "aten::mm", t0 + 21, 2),
            ("gpu_memcpy", "Memcpy HtoD", t0 + 15, 10),
            ("kernel", "void aocr::greedy_cluster_kernel<bf16>(x)", t0 + 40,
             28)] + [(u, PACK, t0 + 22 + 3 * i, 2) for i in range(packs)]


def runinfo(events):
    cfg = registry.Benchmark().config("aocr-if-bf16")
    calls = [{"entry": "recognize", "B": 512, "K": 1, "T": 50, "W": 100,
              "row_steps": [50] * 512}] * 2
    return RunInfo(Trace.from_chrome(chrome(events)), calls, cfg)


KNOWN = call(0, 25, 2) + call(120, 19, 1)


def test_span_readers_on_a_known_trace():
    r = runinfo(KNOWN)
    read = lambda name: registry.reader(name)(r)
    assert read("recognize_idle_transcripts_ms") == pytest.approx(
        (25 + 19) / 2 * 1e-3)
    assert read("recognize_idle_input_ms") == pytest.approx(13e-3)
    assert read("recognize_idle_dispatch_ms") == pytest.approx(15e-3)
    assert read("recognize_weight_packs") == pytest.approx(1.5)
    # the leaves' idle plus fetch's is the calls' host time, less the
    # idle outside the leaves (t0 to t0 + 2, and 95-100 / 89-100)
    fetch_ms = 2e-3
    assert (read("recognize_idle_transcripts_ms")
            + read("recognize_idle_input_ms")
            + read("recognize_idle_dispatch_ms") + fetch_ms) == \
        pytest.approx(read("recognize_host_ms") - (2 + (5 + 11) / 2) * 1e-3)


def test_longest_gaps_are_named_by_program_spans():
    gaps = [g[0] for g in breakdown(runinfo(KNOWN).trace)["idle_gaps"]]
    # 188-220 in the second call lies in its transcript decode
    assert "call/" + R + ".transcripts" in gaps


@pytest.mark.parametrize("name", SPANS)
def test_span_readers_read_none_without_the_program_spans(name):
    # the parent's trace: the benchmark's spans and the device alone
    bare = [e for e in KNOWN if not e[1].startswith("aocr_torch.")]
    for n in (name, name + ".host_paced"):
        assert registry.reader(n)(runinfo(bare)) is None


@pytest.mark.parametrize("name,gone", [
    ("recognize_idle_transcripts_ms", (R + ".transcripts",)),
    ("recognize_idle_input_ms", (R + ".prepare", R + ".copy")),
    ("recognize_idle_dispatch_ms", (R + ".decode",))])
def test_idle_reader_reads_none_without_its_span(name, gone):
    r = runinfo([e for e in KNOWN if e[1] not in gone])
    assert registry.reader(name)(r) is None


def test_weight_packs_read_zero_where_calls_pack_nothing():
    r = runinfo([e for e in KNOWN if e[1] != PACK])
    assert registry.reader("recognize_weight_packs")(r) == 0


@pytest.mark.parametrize("name", SPANS)
def test_host_paced_twins_read_their_quantity(name):
    r = runinfo(KNOWN)
    assert registry.reader(name + ".host_paced")(r) == \
        registry.reader(name)(r)


@pytest.mark.parametrize("workload", ["if-bf16.greedy-b512",
                                      "cli-f32.greedy-b512"])
def test_traced_tiny_run_reports_the_span_metrics(monkeypatch, workload):
    """The program's spans reach the readers through a real trace: the
    cell's traced run on the CPU reports every span metric it lists (CPU
    numbers, no device in them) and the greedy loop route's one
    build_tables a call."""
    # traced from the first call, however slow the CPU
    monkeypatch.setattr(run, "TRACE_AFTER", 0.0)
    out = run.run_cell(TinyBench(), workload, 5, 0.3, True, device="cpu")
    listed = {m["name"] for m in TinyBench().per_layer(workload)
              if m["name"].split(".")[0] in SPANS}
    assert len(listed) == 4 and listed <= set(out["metrics"])
    packs = [v["value"] for k, v in out["metrics"].items()
             if k.startswith("recognize_weight_packs")]
    assert packs == [1.0]
