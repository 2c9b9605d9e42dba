"""Device idle inside the program's `aocr_torch.recognize.prepare` (host
staging of the batch) and `aocr_torch.recognize.copy` (its copy to the
device) spans: each span's length less the device-busy time inside it,
summed over the traced stretch, a call (ms)."""

SPANS = ("aocr_torch.recognize.prepare", "aocr_torch.recognize.copy")


def read(run):
    start, end = run.trace.window()
    spans = [h for h in run.trace.host if h[3] == "user_annotation"
             and h[0] in SPANS and start <= h[1] and h[2] <= end]
    calls = run.trace.calls()
    if not spans or not calls:
        return None
    idle = sum((b - a) - run.trace.busy(a, b) for _n, a, b, _c in spans)
    return idle / len(calls) * 1e-3
