"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  With --trace 0 the result's metrics are
the cell's end-to-end metrics; with --trace 1 its per-layer metrics,
read from a torch.profiler trace of `trace_calls` calls after the first
0.3 of the window, and the device's busy time.  The last line of
standard output is one JSON object; the numbers `correct` compared go,
each beside its limit, to the last lines of standard error and under
the result's last key, "checks".  The line before it holds the
program's own counters of the window: each kernel's launches
(`aocr_torch.ops.cuda.launch_counts`) and the decode routes taken
(`aocr_torch.decode.routes`).
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "aocr"}
TRACE_AFTER = 0.3  # of the window, before the traced stretch starts


def _process_age() -> float:
    """Seconds since this process started (from /proc), or 0."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE, _T0 = _process_age(), time.perf_counter()


def since_start() -> float:
    return _AGE + time.perf_counter() - _T0


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc build is build/aocr_torch there by its own code)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class RunInfo:
    """What a per-layer reader reads: the trace, the traced calls (each a
    dict of entry, B, K, T, W, row_steps), the configuration and the
    compute dtype."""

    def __init__(self, trace, calls, cfg: dict):
        self.trace, self.calls, self.cfg = trace, calls, cfg
        self.dtype = cfg["config"]["compute_dtype"]


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def run_cell(bench, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """One run of a cell; returns the result line as a dict (without the
    device's name and power limit)."""
    import torch

    from aocr_torch import decode
    from aocr_torch.ops import cuda as kernels

    from . import registry
    from .trace import Tracer, breakdown

    cell = bench.workload(workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(workload)
    drv = importlib.import_module(f"portbench.drivers.{traffic['entry']}")
    st = drv.setup(cfg, traffic, seed, device)
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = since_start()
    kernels.reset_launch_counts()
    tracer = Tracer(TRACE_AFTER * seconds, traffic["trace_calls"]) \
        if trace else None
    res = drv.window(st, seconds, tracer)
    counters = {"launches": kernels.launch_counts(),
                "routes": {str(k): v for k, v in decode.routes.items()}}
    dev = {"platform": "gpu" if device != "cpu" else "cpu", "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if device != "cpu" else 0)}
    bad = loaded_forbidden()
    if bad:
        raise SystemExit(f"portbench: {', '.join(bad)} loaded in the "
                         "process that measured; no result")
    out = {"correct": False, "attempted": res.attempted,
           "failed": res.failed, "metrics": {}, "device": dev,
           "counters": counters}
    if trace:
        tr = tracer.read()
        start, end = tr.window()
        dev["busy_s"] = tr.busy(start, end) * 1e-6
        dev["window_s"] = (end - start) * 1e-6
        info = RunInfo(tr, drv.layer_info(st, res), cfg)
        for m in bench.per_layer(workload):
            v = registry.reader(m["name"])(info)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        out["breakdown"] = breakdown(tr)
    else:
        values = dict(drv.end_to_end(st, res), setup_s=setup_s)
        for m in bench.end_to_end(workload):
            # <quantity>.<qualifier>: the quantity, in the cells listed
            # under that name and held to a bound of its own
            v = values[m["name"].split(".")[0]]
            out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    drv.release(st)
    readings = drv.check(st, res)
    values = {k: readings.get(k, math.inf) for k in limits}
    out["correct"] = res.failed == 0 and all(
        values[k] <= lim for k, lim in limits.items())
    # a reading that is not a number is printed as a string (JSON has none)
    out["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                         "limit": limits[k]} for k, v in values.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    import torch

    from . import registry

    bench = registry.Benchmark(ROOT)
    chips = bench.workload(args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s), "
              f"found {found}; no result", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    out["device"]["kind"] = torch.cuda.get_device_name(0)
    out["device"]["power_limit_w"] = power_limit_w()
    # the program's own counters of the window: a line of their own
    print(json.dumps({"counters": out.pop("counters")}))
    checks = out.pop("checks")
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
