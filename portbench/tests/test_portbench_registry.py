"""BENCHMARK.json against the files it names and the contract's shapes."""

import importlib
import json

import pytest

from portbench import registry

BENCH = registry.Benchmark()
DOC = BENCH.doc


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["portbench"]
    assert 1 <= DOC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", DOC["workloads"], ids=lambda c: c["name"])
def test_every_cell_finds_its_files(cell):
    cfg = BENCH.config(cell["config"])
    assert cfg["config"]["compute_dtype"] == cfg["precision"]
    traffic = BENCH.traffic(cell["traffic"])
    drv = importlib.import_module(f"portbench.drivers.{traffic['entry']}")
    for fn in ("setup", "window", "end_to_end", "layer_info", "release",
               "check"):
        assert callable(getattr(drv, fn))
    assert BENCH.limits(cell["name"])
    assert cell["chips"] == 1


@pytest.mark.parametrize("cell", DOC["workloads"], ids=lambda c: c["name"])
def test_every_cell_reports_setup_another_and_a_layer(cell):
    names = [m["name"] for m in BENCH.end_to_end(cell["name"])]
    assert "setup_s" in names and len(names) >= 2
    layers = BENCH.per_layer(cell["name"])
    assert layers
    for m in layers:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", DOC["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    assert callable(registry.reader(metric["name"]))
    assert metric["moves"] in [m["name"] for m in DOC["end_to_end"]]


def test_names_unique_and_files_distinct():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in DOC[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert len({c["file"] for c in DOC["configs"]}) == len(DOC["configs"])
    pairs = [(w["config"], w["traffic"]) for w in DOC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name", ["a b", "a,b", "a/b", "", "-a", "µs",
                                  "x" * 65, "tab\t"])
def test_bad_names_refused(name):
    with pytest.raises(ValueError):
        registry.check_name(name)


@pytest.mark.parametrize("name", ["if-bf16.greedy-b512", "_x", "9", "a" * 64])
def test_good_names_pass(name):
    assert registry.check_name(name) == name


@pytest.mark.parametrize("unit", ["tokens per second", "µs", "x" * 17,
                                  "", "a,b"])
def test_bad_units_refused(unit):
    with pytest.raises(ValueError):
        registry.check_unit(unit)


@pytest.mark.parametrize("unit", ["images/s", "%", "ms", "s", "GB/s"])
def test_good_units_pass(unit):
    assert registry.check_unit(unit) == unit


def test_bad_name_in_file_refused(tmp_path):
    doc = json.loads(json.dumps(DOC))
    doc["workloads"][0]["name"] = "two words"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    with pytest.raises(ValueError):
        registry.Benchmark(tmp_path)


def test_per_layer_metric_without_workloads_refused(tmp_path):
    doc = json.loads(json.dumps(DOC))
    del doc["per_layer"][0]["workloads"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    with pytest.raises(ValueError):
        registry.Benchmark(tmp_path)
