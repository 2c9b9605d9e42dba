"""Multi-host (multi-process) training support (counterpart of
aocr/parallel/multihost.py).

One process per device, launched by torchrun on every host:

    torchrun --nnodes H --nproc_per_node N --rdzv_endpoint <host:port> \\
        -m aocr_torch.train -phase train -multihost -num_shards <H*N> ...

`initialize()` joins the processes into one default process group from
torchrun's environment.  Under -multihost each process reads its own
slice of the manifest, so the hosts must stay in **lockstep**: every
process must issue the same sequence of collectives, while they hold
different slices and reach their epoch's end at different steps.  As in
aocr: fixed per-host row counts (targets padded to max_decoder_l), row
masks for the padding, and `lockstep()`, which all-reduces (have_batch,
num_nonzeros, rows) each step and has the processes whose epoch ended
feed all-masked dummy batches until every process is done.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Optional, Tuple

import torch
import torch.distributed as dist


def initialize(backend: Optional[str] = None, device=None) -> None:
    """init_process_group from torchrun's environment (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE); the backend by default NCCL for a
    CUDA device, gloo otherwise.  Does nothing when a process group is
    already initialized, so a caller may set up its own first."""
    if dist.is_initialized():
        return
    if backend is None:
        cuda = device is None or torch.device(device).type == "cuda"
        backend = "nccl" if cuda else "gloo"
    dist.init_process_group(backend, init_method="env://")


def process_info() -> tuple:
    """(rank, process count) of the default group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_rank() -> int:
    """This process's index on its host (torchrun's LOCAL_RANK)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def local_batch_size(global_batch_size: int, process_count: int) -> int:
    """Per-host rows: the reference's batch_size stays the *global* batch
    (its src/train.lua:41); each host feeds its share."""
    assert global_batch_size >= process_count, (
        f"batch_size {global_batch_size} < process_count {process_count}"
    )
    return global_batch_size // process_count


def count_group():
    """A gloo group over every process, for host integers (sync_counts'
    group): a CUDA collective would sync the data loader with the device.
    The default group (None) when it is gloo already.  Collective: every
    process makes the call."""
    if dist.get_backend() == "gloo":
        return None
    return dist.new_group(backend="gloo")


def sync_counts(*counts: int, group=None) -> Tuple[int, ...]:
    """All-reduce (sum) small host-side integers across the processes of
    a gloo group (count_group()).  Single-process: identity."""
    if process_info()[1] == 1:
        return tuple(int(c) for c in counts)
    t = torch.tensor([int(c) for c in counts], dtype=torch.int64)
    dist.all_reduce(t, group=group)
    return tuple(int(x) for x in t.tolist())


def lockstep(
    iterator: Iterator,
    make_dummy: Callable[[], object],
    nnz_rows: Callable[[object], Tuple[int, int]],
    sync: Callable[..., Tuple[int, ...]] = sync_counts,
):
    """Iterate batches in lockstep across processes.

    Yields (batch, is_real, global_nnz, global_rows) until *every* process
    has exhausted its iterator.  Processes that run out early yield dummy
    (all-masked) batches so each host issues the same number of collective
    programs.  `sync` is injectable for single-process testing.
    """
    it = iter(iterator)
    while True:
        batch = next(it, None)
        have = batch is not None
        nnz, rows = nnz_rows(batch) if have else (0, 0)
        total_have, total_nnz, total_rows = sync(int(have), nnz, rows)
        if total_have == 0:
            return
        yield (batch if have else make_dummy()), have, total_nnz, total_rows
