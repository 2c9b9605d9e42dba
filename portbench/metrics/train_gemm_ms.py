"""Device time of the cuBLAS products (the weight gradients and the
hoisted projections) a train step, over the traced steps (ms)."""


def read(run):
    from portbench import readers

    steps = readers.calls(run, "train")
    us, n = run.trace.kernel_time(
        lambda k: bool(readers.GEMM.search(k))
        and not readers.NOT_GEMM.search(k))
    if not steps or n == 0:
        return None
    return us * 1e-3 / len(steps)
