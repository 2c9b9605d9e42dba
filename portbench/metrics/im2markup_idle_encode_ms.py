"""Device idle inside the program's `aocr_torch.im2markup.cnn` and
`aocr_torch.im2markup.rows` spans (the host's dispatch of the CNN and of
the row encoder): each span's length less the device-busy time inside
it, summed over the traced stretch, a call (ms).  None where the program
records neither span."""

SPANS = ("aocr_torch.im2markup.cnn", "aocr_torch.im2markup.rows")


def read(run):
    start, end = run.trace.window()
    spans = [h for h in run.trace.host if h[3] == "user_annotation"
             and h[0] in SPANS and start <= h[1] and h[2] <= end]
    calls = run.trace.calls()
    if not spans or not calls:
        return None
    idle = sum((b - a) - run.trace.busy(a, b) for _n, a, b, _c in spans)
    return idle / len(calls) * 1e-3
