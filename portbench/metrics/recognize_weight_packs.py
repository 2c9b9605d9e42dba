"""Packings of the decoder's weights for a decode kernel a call: the
program's `aocr_torch.decode.pack` spans in the traced stretch over its
calls.  None where the program records no `aocr_torch.recognize` span;
0 where it records calls that pack nothing (a packing cache that hits)."""


def read(run):
    start, end = run.trace.window()
    names = [h[0] for h in run.trace.host if h[3] == "user_annotation"
             and start <= h[1] and h[2] <= end]
    calls = run.trace.calls()
    if "aocr_torch.recognize" not in names or not calls:
        return None
    return names.count("aocr_torch.decode.pack") / len(calls)
