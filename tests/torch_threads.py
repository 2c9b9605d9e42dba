"""One CPU thread budget for the port's tests, set on import.

Every `tests/test_torch_port_*.py` imports this module first.  It gives
torch's intra-op pool `max(1, cores // workers)` threads: `cores` are the
CPUs this process may run on, `workers` the pytest-xdist workers
(`PYTEST_XDIST_WORKER_COUNT`, which xdist sets in each worker; 1 without
xdist).  Each xdist worker collects every test file before it runs a
test, so the budget holds in every worker from its first test on, the
JAX package's test files included.

Why: torch's default pool is as wide as the machine, so six workers on
eight cores run six eight-thread pools, and every small tensor op waits
on a barrier of threads that are not running.  One case of
`test_torch_port_lstm.py::test_lstm_fwd_plan_partition` ([512-512-float32],
~4,000 small indexed ops) takes 0.41 s alone, 115 s in each of six
processes run at once with the default pool, and 0.39-0.49 s in each of
the six with this budget (8 cores, torch 2.13 CPU).

The library itself never sets a thread count: that is the caller's.
"""

import os

import torch


def budget() -> int:
    """Intra-op threads for one test process: the CPUs it may run on,
    shared evenly among the xdist workers, at least one."""
    cores = len(os.sched_getaffinity(0))
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, cores // workers)


torch.set_num_threads(budget())
