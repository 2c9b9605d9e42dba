"""A recognize call's host time: its span's length minus the device-busy
time inside it, averaged over the traced calls (ms)."""


def read(run):
    from portbench import readers

    spans = run.trace.calls()
    if not readers.calls(run, "recognize") or not spans:
        return None
    host = [(e - s) - run.trace.busy(s, e) for _n, s, e in spans]
    return sum(host) / len(host) * 1e-3
