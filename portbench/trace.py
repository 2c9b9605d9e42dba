"""A steady stretch of the window under torch.profiler, reduced to
device intervals and host spans.

The benchmark wraps its own calls in `record_function` spans
("portbench.batch", "portbench.call", "portbench.read"); spans inside the
program are the program's business.  Device busy time is the union of
the intervals of every device operation (kernels, copies, sets), never
a sum of self times, so overlapping streams count once.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
SPAN_PREFIX = "portbench."


@dataclass
class Trace:
    """Times in microseconds on the profiler's clock."""
    device: list = field(default_factory=list)  # (name, start, end)
    host: list = field(default_factory=list)    # (name, start, end, cat)
    spans: list = field(default_factory=list)   # benchmark spans

    @classmethod
    def from_chrome(cls, doc: dict) -> "Trace":
        tr = cls()
        for ev in doc.get("traceEvents", []):
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat, ts = ev.get("cat", ""), float(ev["ts"])
            item = (ev.get("name", ""), ts, ts + float(ev["dur"]))
            if cat in DEVICE_CATS:
                tr.device.append(item)
            elif cat in HOST_CATS:
                tr.host.append(item + (cat,))
                if cat == "user_annotation" and item[0].startswith(
                        SPAN_PREFIX):
                    tr.spans.append(item)
        tr.device.sort(key=lambda x: x[1])
        tr.spans.sort(key=lambda x: x[1])
        return tr

    def calls(self) -> list:
        """The spans of the benchmark's calls into the program."""
        return [s for s in self.spans if s[0] == SPAN_PREFIX + "call"]

    def window(self) -> tuple:
        """(start, end): the first call span's start to the last's end."""
        calls = self.calls()
        return (calls[0][1], calls[-1][2]) if calls else (0.0, 0.0)

    def busy(self, start: float, end: float) -> float:
        """Microseconds in [start, end] in which a device operation ran."""
        return sum(b - a for a, b in union(self.device, start, end))

    def kernel_time(self, match) -> tuple:
        """(microseconds, launches) of the device operations whose name
        `match` accepts."""
        hits = [e - s for n, s, e in self.device if match(n)]
        return sum(hits), len(hits)


def union(intervals, start: float, end: float) -> list:
    """The merged [a, b] intervals of (name, a, b) clipped to [start,
    end]."""
    out = []
    for _n, a, b in sorted(intervals, key=lambda x: x[1]):
        a, b = max(a, start), min(b, end)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the stretch (seconds,
    summed by name), and its longest idle gaps, each named by the
    benchmark span and the innermost host operation running at the gap's
    middle."""
    start, end = tr.window()
    by_name: dict = {}
    for n, a, b in tr.device:
        a, b = max(a, start), min(b, end)
        if b > a:
            by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    busy = union(tr.device, start, end)
    edges = [start] + [x for iv in busy for x in iv] + [end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = [h for h in tr.host if not h[0].startswith(SPAN_PREFIX)]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        span = [s[0] for s in tr.spans if s[1] <= mid <= s[2]]
        inner = [h for h in host if h[1] <= mid <= h[2]]
        before = [h for h in host if h[2] <= mid]
        # Python between operations where none runs: named by the last
        op = (max(inner, key=lambda h: h[1])[0] if inner else
              "after " + max(before, key=lambda h: h[2])[0] if before
              else "host")
        label = (span[-1][len(SPAN_PREFIX):] + "/" if span else "") + op
        named.append([label, (b - a) * 1e-6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


class Tracer:
    """Profiles `calls` consecutive calls once `after_s` seconds of the
    window have passed, then stops; `read()` gives the Trace."""

    def __init__(self, after_s: float, calls: int):
        self.after_s, self.left = after_s, calls
        self.prof = None
        self.traced: list = []  # indices of the traced calls
        self.done = False

    def before(self, index: int, elapsed: float) -> None:
        if self.prof is None and not self.done and elapsed >= self.after_s:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
        if self.prof is not None and not self.done:
            self.traced.append(index)

    def after(self) -> None:
        if self.prof is not None and not self.done:
            self.left -= 1
            if self.left <= 0:
                self.stop()

    def stop(self) -> None:
        if self.prof is not None and not self.done:
            self.prof.stop()
            self.done = True

    def read(self) -> Trace:
        self.stop()
        if self.prof is None:
            return Trace()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return Trace.from_chrome(json.load(f))
        finally:
            os.unlink(path)
