"""A recognize call's model operations (CNN, encoder, the decoder steps
that ran) over the traced stretch, as a share of the configuration's
dtype peak (989 TFLOP/s bf16, 67 float32; %)."""


def read(run):
    from portbench import readers

    return readers.mfu_pct(run, "recognize")
