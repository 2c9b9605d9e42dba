"""lstm_bwd's share of its roofline: both encoder directions' backward
recurrences over every column of every row, over the kernel's device
time (%)."""


def read(run):
    from portbench import counts, readers

    def bound(c, run):
        cfg = run.cfg["config"]
        L, He = counts.context_length(c["W"]), cfg["encoder_num_hidden"]
        n = 2 * cfg["encoder_num_layers"]
        return n * counts.bound_s(counts.lstm_bwd_flops(L, c["B"], He),
                                  counts.lstm_bwd_bytes(L, c["B"], He,
                                                        run.dtype),
                                  run.dtype)

    return readers.roofline_pct(run, "lstm_bwd", "train", bound)
