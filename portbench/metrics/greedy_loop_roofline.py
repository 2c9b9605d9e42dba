"""greedy_loop's share of its roofline: the traced calls' bounds (each
row's steps up to its EOS, or T) over the kernel's device time (%)."""


def read(run):
    from portbench import counts, readers

    def bound(c, run):
        cfg = run.cfg["config"]
        return counts.bound_s(
            counts.loop_flops(cfg, c["W"], sum(c["row_steps"])),
            counts.loop_bytes(cfg, c["W"], c["B"], 1, c["T"], run.dtype),
            run.dtype)

    return readers.roofline_pct(run, "greedy_loop", "recognize", bound)
