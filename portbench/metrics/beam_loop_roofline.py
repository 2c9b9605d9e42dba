"""beam_loop's share of its roofline: K beams a step after the first,
while each row's best beam lives, over the kernel's device time (%)."""


def read(run):
    from portbench import counts, readers

    def bound(c, run):
        cfg = run.cfg["config"]
        steps = sum(readers.beam_steps(c)) - len(c["row_steps"])
        return counts.bound_s(
            counts.loop_flops(cfg, c["W"], steps),
            counts.loop_bytes(cfg, c["W"], c["B"], c["K"], c["T"], run.dtype),
            run.dtype)

    return readers.roofline_pct(run, "beam_loop", "recognize", bound)
