"""Device idle inside the program's `aocr_torch.recognize.decode` spans
(the host's dispatch of the CNN, the encoder, the weight packing and the
decode route, and a tail route's host loop): each span's length less the
device-busy time inside it, summed over the traced stretch, a call
(ms)."""

SPANS = ("aocr_torch.recognize.decode",)


def read(run):
    start, end = run.trace.window()
    spans = [h for h in run.trace.host if h[3] == "user_annotation"
             and h[0] in SPANS and start <= h[1] and h[2] <= end]
    calls = run.trace.calls()
    if not spans or not calls:
        return None
    idle = sum((b - a) - run.trace.busy(a, b) for _n, a, b, _c in spans)
    return idle / len(calls) * 1e-3
