"""The attention decode's share of the device's work in an im2markup
cell: greedy_loop's (`greedy_cluster_kernel`) device time over the
device-busy time of the traced stretch (%)."""


def read(run):
    from portbench import readers

    start, end = run.trace.window()
    us, n = run.trace.kernel_time(readers.KERNELS["greedy_loop"].search)
    busy = run.trace.busy(start, end)
    if not readers.calls(run, "markup") or n == 0 or busy <= 0:
        return None
    return 100.0 * us / busy
