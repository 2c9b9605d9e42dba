"""tf_fwd's share of its roofline: each row's steps up to its EOS target
over the kernel's device time (%)."""


def read(run):
    from portbench import counts, readers

    def bound(c, run):
        cfg = run.cfg["config"]
        return counts.bound_s(
            counts.tf_flops(cfg, c["W"], sum(c["row_steps"])),
            counts.tf_bytes(cfg, c["W"], c["B"], c["T"], run.dtype),
            run.dtype)

    return readers.roofline_pct(run, "tf_fwd", "train", bound)
