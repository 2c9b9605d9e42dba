"""The share of the traced stretch of train steps in which no device
operation ran (the union of their intervals; %)."""


def read(run):
    from portbench import readers

    return readers.idle_pct(run, "train")
