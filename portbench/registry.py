"""BENCHMARK.json and the files it names, found by name:

- configs/<config>.json   one model configuration (its `Config` fields,
                          precision, source, reduced, assumed)
- traffic/<traffic>.json  one traffic mix (the driver `entry` in
                          drivers/, batch, beam, lengths, pool, trace)
- limits/<workload>.json  the limit of each number `correct` compares
- metrics/<metric>.py     the reader of one per-layer metric: `read(run)`
                          returns a number, or None where it finds
                          nothing to read
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad name {name!r}: 1-64 of [A-Za-z0-9_.-], "
                         "starting with a letter, digit or _")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.match(unit):
        raise ValueError(f"bad unit {unit!r}: 1-16 of [A-Za-z0-9_/%.-]")
    return unit


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Benchmark:
    def __init__(self, root: Path = HERE.parent):
        self.root = Path(root)
        self.doc = _json(self.root / "BENCHMARK.json")
        for c in self.doc["configs"]:
            check_name(c["name"])
            for k in c["reduced"]:
                check_name(k)
        for w in self.doc["workloads"]:
            for k in ("name", "config", "traffic"):
                check_name(w[k])
        for m in self.doc["end_to_end"] + self.doc["per_layer"]:
            check_name(m["name"])
            check_unit(m["unit"])
        for m in self.doc["per_layer"]:
            if "workloads" not in m:
                raise ValueError(f"per-layer metric {m['name']!r} lists "
                                 "no workloads")

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return _json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(HERE / "traffic" / f"{check_name(name)}.json")

    def limits(self, workload: str) -> dict:
        return _json(HERE / "limits" / f"{check_name(workload)}.json")

    @staticmethod
    def _reports(metric: dict, workload: str) -> bool:
        """Whether the cell reports the metric: listed under its
        `workloads` (every per-layer metric has the key); an end-to-end
        metric without it is every cell's."""
        return workload in metric.get("workloads", [workload])

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.doc["end_to_end"]
                if self._reports(m, workload)]

    def per_layer(self, workload: str) -> list:
        return [m for m in self.doc["per_layer"]
                if self._reports(m, workload)]


def reader(metric: str):
    """The `read` function of metrics/<metric>.py."""
    path = HERE / "metrics" / f"{check_name(metric)}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
