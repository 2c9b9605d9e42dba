"""greedy_loop's share of its roofline in an im2markup cell: the traced
calls' bounds (markup_counts: each row's steps up to its EOS, or T, with
each live row's context read once a step) over the kernel's device time
(%)."""


def read(run):
    from portbench import counts, markup_counts, readers

    def bound(c, run):
        return counts.bound_s(markup_counts.loop_flops(run.cfg, c),
                              markup_counts.loop_bytes(run.cfg, c, run.dtype),
                              run.dtype)

    return readers.roofline_pct(run, "greedy_loop", "markup", bound)
