"""The readings that a cell's limits are set from, on the chip:

    python3 -m portbench.control --workload <name> --seeds 1,2,3 \
        --seconds 2 [--controls 3] [--faults]

For each seed, in one process: set-up, a short window at the cell's own
load, then the numbers `correct` compares for the program, and for the
first `--controls` seeds the same numbers for the control (the plain
reference in the program's place at the precision below the
configuration's: TF32 below float32, fp8 below bfloat16) and, with
--faults, for each fault of the cell's driver (`FAULTS`) planted in the
reference put in the program's place: a training step that leaves out
half of its batch and takes the mean over the rest; a recognition that
picks a wrong token or beam.  One JSON line a seed, then the largest
program reading and the smallest control and fault readings of each
number.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import sys

import torch

from . import registry, run
from .reference import network


def readings(bench, workload: str, seeds, seconds: float, controls: int,
             faults: bool, device: str = "cuda") -> dict:
    cell = bench.workload(workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    drv = importlib.import_module(f"portbench.drivers.{traffic['entry']}")
    lower = network.control_precision(cfg["config"]["compute_dtype"])
    kinds = {"program": {}, "control": {}}
    for f in drv.FAULTS if faults else ():
        kinds[f] = {}
    for i, seed in enumerate(seeds):
        st = drv.setup(cfg, traffic, seed, device)
        res = drv.window(st, seconds)
        drv.release(st)
        line = {"seed": seed, "program": drv.check(st, res)}
        if i < controls:
            for k in kinds:
                if k != "program":
                    line[k] = drv.check(st, res, control=lower
                                        if k == "control" else k)
        print(json.dumps(line), flush=True)
        for k in kinds:
            for name, v in line.get(k, {}).items():
                kinds[k].setdefault(name, []).append(v)
        del st, res
    summary = {"program_max": {k: max(v) for k, v in
                               kinds["program"].items()}}
    for k in kinds:
        if k != "program" and kinds[k]:
            summary[k + "_min"] = {n: min(v) for n, v in kinds[k].items()}
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    run._caches()
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = readings(registry.Benchmark(run.ROOT), args.workload, seeds,
                   args.seconds, args.controls, args.faults)
    out["device"] = torch.cuda.get_device_name(0)
    out["power_limit_w"] = run.power_limit_w()
    print(json.dumps(out, default=lambda v: None if not math.isfinite(v)
                     else v), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
