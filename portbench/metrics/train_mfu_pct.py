"""A train step's model operations (three times the forward pass, each
row's decoder steps up to its EOS target) over the traced stretch, as a
share of the configuration's dtype peak (%)."""


def read(run):
    from portbench import readers

    return readers.mfu_pct(run, "train")
