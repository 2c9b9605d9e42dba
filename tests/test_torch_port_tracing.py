"""The port's spans (aocr_torch/utils/tracing.py) on the CPU: the guard,
the recognize spans and their nesting in a chrome trace, the weight
packing spans, and an exported artifact that holds no profiler op.  The
tiny model decodes 8 steps of 32- and 40-pixel crops."""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import contextlib
import json

import numpy as np
import pytest
import torch

from aocr_torch import export as texport
from aocr_torch.api import AttentionOCR
from aocr_torch.config import Config
from aocr_torch.ops.cuda import greedy_loop
from aocr_torch.utils import tracing

KW = dict(input_feed=True, encoder_num_hidden=16, target_embedding_size=8,
          max_decoder_l=8, image_width=32)
ROOT = "aocr_torch.recognize"
# the leaves of a recognize call in the order they run; copy, decode and
# fetch once a width group (and shard)
LEAVES = ("prepare", "copy", "decode", "fetch", "transcripts")
PER_GROUP = ("copy", "decode", "fetch")


def _images(widths):
    rng = np.random.default_rng(7)
    return [rng.uniform(0, 255, (32, w)).astype(np.float32) for w in widths]


def _spans(prof, tmp_path) -> list:
    """(name, start, end, tid) of the program's spans in the profile's
    chrome trace, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"],
                    e.get("tid")) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("aocr_torch.")),
                  key=lambda s: s[1])


def test_span_is_shared_null_context_unless_a_profiler_records():
    off = tracing.span("a")
    assert isinstance(off, contextlib.nullcontext)
    assert tracing.span("b") is off
    with torch.profiler.profile():
        assert isinstance(tracing.span("a"), torch.profiler.record_function)
    assert tracing.span("a") is off


@pytest.mark.parametrize("beam", [1, 5])
@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("shards", [1, 2])
def test_recognize_spans_nest_in_order(tmp_path, monkeypatch, beam,
                                       use_pallas, shards):
    """Two calls on two width groups: each call one recognize span, its
    prepare and transcripts once, copy < decode < fetch once a group and
    shard (on the shard's pool thread under shard(), recorded by a session
    that profiles every thread), every leaf inside
    its call in the order prepare < copy < decode < fetch < transcripts;
    one pack span a build_tables call, each inside a decode span, and
    none on the plain route."""
    ocr = AttentionOCR.create(Config(**KW, use_pallas=use_pallas),
                              device="cpu")
    if shards > 1:
        ocr.shard(devices=["cpu"] * shards)
    builds = []
    build = greedy_loop.build_tables
    monkeypatch.setattr(greedy_loop, "build_tables",
                        lambda *a: builds.append(1) or build(*a))
    images = _images([32, 40, 32, 40, 40])
    want = ocr.recognize(images, beam_size=beam)
    builds.clear()
    # torch's profiler records the thread that starts it; the shards' pool
    # threads only in a session that profiles every thread
    cfg = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=shards > 1)
    with torch.profiler.profile(experimental_config=cfg) as prof:
        got = [ocr.recognize(images, beam_size=beam) for _ in range(2)]
    ocr.unshard()
    for words, scores in got:
        assert words == want[0]
        np.testing.assert_array_equal(scores, want[1])
    spans = _spans(prof, tmp_path)
    calls = [s for s in spans if s[0] == ROOT]
    assert len(calls) == 2
    groups = 2 * shards
    packs = [s for s in spans if s[0] == tracing.PACK]
    assert len(packs) == len(builds) == (2 * groups if use_pallas else 0)
    decodes = [s for s in spans if s[0] == ROOT + ".decode"]
    assert all(any(d[1] <= p[1] and p[2] <= d[2] for d in decodes)
               for p in packs)
    for _n, a, b, tid in calls:
        inside = [s for s in spans if a <= s[1] and s[2] <= b]
        leaves = [s for s in inside if s[0].startswith(ROOT + ".")]
        names = [s[0][len(ROOT) + 1:] for s in leaves]
        assert sorted(names) == sorted(
            ["prepare", "transcripts"] + list(PER_GROUP) * groups)
        order = [LEAVES.index(n) for n in names]
        if shards == 1:
            # one thread: the leaves run one after another
            assert order == [0] + [1, 2, 3] * groups + [4]
            assert all(x[2] <= y[1] for x, y in zip(leaves, leaves[1:]))
            assert {s[3] for s in leaves} == {tid}
        else:
            assert order[0] == 0 and order[-1] == 4
            for n in PER_GROUP:
                assert all(s[3] != tid for s in leaves if s[0].endswith(n))
        first = {n: min(s[1] for s in leaves if s[0].endswith("." + n))
                 for n in LEAVES}
        assert first["prepare"] < first["copy"] < first["decode"] < \
            first["fetch"] < first["transcripts"]


@pytest.mark.parametrize("beam", [1, 5])
def test_exported_program_holds_no_profiler_op(tmp_path, beam):
    """A kernel artifact exported while a profiler records holds no
    profiler op, and recognizes the same transcripts and scores with a
    profiler running as without."""
    ocr = AttentionOCR.create(Config(**KW), device="cpu")
    art = str(tmp_path / "m.aocrx")
    with torch.profiler.profile():
        texport.export_recognizer(ocr, art, beam_size=beam, use_pallas=True,
                                  device="cpu")
    rec = texport.ExportedRecognizer.load(art, "cpu")
    targets = {str(n.target) for m in rec._programs.values()
               for n in m.graph.nodes if n.op == "call_function"}
    assert any(t.startswith("aocr_torch.") for t in targets)
    assert not [t for t in targets if "profiler" in t or "record" in t]
    images = np.stack(_images([32] * 4))
    want = rec.recognize(images)
    with torch.profiler.profile():
        got = rec.recognize(images)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
