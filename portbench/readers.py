"""What the per-layer readers (metrics/<name>.py) share: the kernels'
names in a trace, and the sums of bounds and of model operations over
the traced calls.  Each function returns None where the run has nothing
for it to read, never 0."""

from __future__ import annotations

import re

from . import counts

KERNELS = {
    "greedy_loop": re.compile(r"\bgreedy_cluster_kernel\b"),
    "beam_loop": re.compile(r"\bbeam_cluster_kernel\b"),
    "tf_fwd": re.compile(r"\btf_fwd_cluster_kernel\b"),
    "tf_bwd": re.compile(r"\btf_bwd_cluster_kernel\b"),
    "lstm_bwd": re.compile(r"\blstm_bwd_(rows|cluster)_kernel\b"),
}
# cuBLAS's real products; cuDNN's convolutions (implicit gemms, and the
# complex gemms of its FFT route) are not these
GEMM = re.compile(r"gemm|gemv", re.I)
NOT_GEMM = re.compile(r"implicit|conv|fprop|dgrad|wgrad|cudnn|cf32", re.I)


def calls(run, entry: str) -> list:
    return [c for c in run.calls if c["entry"] == entry]


def roofline_pct(run, kernel: str, entry: str, bound_of):
    """100 x the summed bounds of the traced calls (bound_of(call, run) in
    seconds) over the kernel's summed device time."""
    cs = calls(run, entry)
    us, n = run.trace.kernel_time(KERNELS[kernel].search)
    if not cs or n == 0 or us <= 0:
        return None
    return 100.0 * sum(bound_of(c, run) for c in cs) / (us * 1e-6)


def beam_steps(c) -> list:
    """Decoder row steps of a beam call: the batch-sized first step, then
    K beams a step while the best beam lives (a floor: other beams may
    live longer)."""
    return [1 + c["K"] * max(s - 1, 0) for s in c["row_steps"]]


def model_flops(c, cfg: dict) -> float:
    if c["entry"] == "train":
        return 3.0 * counts.forward_flops(cfg, c["W"], c["row_steps"])
    steps = c["row_steps"] if c["K"] == 1 else beam_steps(c)
    return counts.forward_flops(cfg, c["W"], steps)


def mfu_pct(run, entry: str):
    """The model's operations in the traced stretch over its length, as a
    share of the configuration's peak."""
    cs = calls(run, entry)
    start, end = run.trace.window()
    if not cs or end <= start:
        return None
    flops = sum(model_flops(c, run.cfg["config"]) for c in cs)
    return 100.0 * flops / ((end - start) * 1e-6) / counts.PEAK_FLOPS[run.dtype]


def idle_pct(run, entry: str):
    start, end = run.trace.window()
    if not calls(run, entry) or end <= start or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy(start, end) / (end - start))
