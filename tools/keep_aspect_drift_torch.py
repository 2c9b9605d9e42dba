#!/usr/bin/env python3
"""How far the keep-aspect Adadelta CLI trainer's kernel and plain runs
part, against how far runs part that no kernel tells apart, on one card.

    python3 tools/keep_aspect_drift_torch.py

chip_smoke.py's keep-aspect trainer (-keep_aspect_ratio
-snap_width_ladder -optimizer adadelta, no input feed, float32, a step
a ladder width on B_ASPECT crops a width) runs

- as the card runs by default: twice with the kernels and twice with
  -no_use_pallas (each route against itself: cuDNN's run-to-run drift);
- under cuDNN's deterministic algorithms: with the kernels, with
  -no_use_pallas twice, and with -no_use_pallas from initial params each
  moved by a uniform draw in +-PERTURB (the control: the plain route
  alone, from a change the size of one step's kernel-vs-plain
  difference).

Each pair prints its step perplexities' largest relative difference, its
final params' largest absolute difference and the leaves that differ
most, then the step perplexities.  Prints the card's name and power
limit.  Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the control's change of every initial param: the size of the largest
# params difference after one kernel step against one plain step from one
# state (chip_smoke's aspect_held_steps, about 1.2e-7 at every width)
PERTURB = 1e-7


def leaves_by_name(tree, prefix=""):
    """(path, array) of every leaf of a nested dict / list tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_by_name(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_by_name(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@contextlib.contextmanager
def perturbed_init(scale: float, seed: int = 1):
    """model.init's fresh params each moved by a uniform draw in
    +-scale (from a generator of its own), for the trainers run inside."""
    import torch

    from aocr_torch import weights
    from aocr_torch.models import model

    init = model.init

    def nudged(cfg, gen, device="cpu"):
        params, stats = init(cfg, gen, device)
        g = torch.Generator().manual_seed(seed)
        params = weights.tree_map(params, lambda _p, t: t + (
            (torch.rand(t.shape, generator=g, dtype=t.dtype) * 2 - 1)
            * scale).to(t.device))
        return params, stats

    model.init = nudged
    try:
        yield
    finally:
        model.init = init


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as cs
    from aocr_torch import checkpoint
    from aocr_torch.ops import cuda

    if not torch.cuda.is_available():
        print("keep_aspect_drift_torch.py: no CUDA device", file=sys.stderr)
        return 2
    cuda.build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    seed, root = 0, tempfile.mkdtemp(prefix="aocr_drift_")
    nullc = contextlib.nullcontext
    plain = ("-no_use_pallas",)
    # tag: (cuDNN's algorithms, the initial params, the route)
    runs = {"k1": (nullc, nullc, ()), "k2": (nullc, nullc, ()),
            "p1": (nullc, nullc, plain), "p2": (nullc, nullc, plain),
            "kd": (cs.deterministic_cudnn, nullc, ()),
            "pd": (cs.deterministic_cudnn, nullc, plain),
            "pd2": (cs.deterministic_cudnn, nullc, plain),
            "pd~": (cs.deterministic_cudnn,
                    lambda: perturbed_init(PERTURB), plain)}
    pairs = (("k1", "k2", "kernels, run to run"),
             ("p1", "p2", "plain, run to run"),
             ("k1", "p1", "kernels vs plain"),
             ("pd", "pd2", "deterministic: plain, run to run"),
             ("kd", "pd", "deterministic: kernels vs plain"),
             ("pd", "pd~", f"deterministic: plain vs plain from params "
                           f"moved by +-{PERTURB:g} (the control)"))
    try:
        n = cs.B_ASPECT * len(cs.LADDER)
        cs.write_dataset(root, seed, (n, n), cs.LADDER)
        args = ("-phase", "train", "-keep_aspect_ratio",
                "-snap_width_ladder", "-batch_size", str(cs.B_ASPECT),
                "-optimizer", "adadelta", "-num_epochs", "1",
                "-steps_per_checkpoint", "100", "-num_batches_val", "1")
        out = {}
        for tag, (algos, init, extra) in runs.items():
            with algos(), init():
                msgs, _c, _s = cs.run_trainer(root, tag, seed, *args,
                                              *extra, input_feed=False)
            ck = checkpoint.load(checkpoint.final_path(
                os.path.join(root, tag)))
            out[tag] = (cs.step_perplexities(msgs),
                        dict(leaves_by_name(ck["params"])))
        for a, b, what in pairs:
            (pa, ca), (pb, cb) = out[a], out[b]
            diffs = sorted(((float(np.abs(ca[k] - cb[k]).max()), k)
                            for k in ca), reverse=True)
            print(f"{a} vs {b} ({what}): perplexity rel err "
                  f"{cs.perplexity_rel_err(pa, pb):.3g}; params max abs "
                  f"{diffs[0][0]:.3g}; top leaves "
                  f"{[(round(d, 6), k) for d, k in diffs[:4]]}")
        for tag in runs:
            print(f"step perplexities {tag}: {out[tag][0]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
