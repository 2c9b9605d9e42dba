"""An im2markup recognize call's model operations (CNN, row encoder, the
decoder steps that ran; markup_counts.forward_flops) over the traced
stretch, as a share of the configuration's dtype peak (989 TFLOP/s bf16,
67 float32; %)."""


def read(run):
    from portbench import counts, markup_counts, readers

    cs = readers.calls(run, "markup")
    start, end = run.trace.window()
    if not cs or end <= start:
        return None
    flops = sum(markup_counts.forward_flops(run.cfg, c) for c in cs)
    return 100.0 * flops / ((end - start) * 1e-6) / counts.PEAK_FLOPS[run.dtype]
