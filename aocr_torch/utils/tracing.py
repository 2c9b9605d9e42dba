"""Named spans of the port's own work, on torch.profiler's clock.

`span(name)` is `torch.profiler.record_function(name)` while a
torch.profiler session records, and one shared null context otherwise:
a span costs only the check when nothing records it (a
`record_function` costs microseconds even then).  The spans land in the
same trace as the kernels, nested on the calling thread, so any
`torch.profiler` session around a call sees them.  A torch.export trace
keeps no profiler op: the guard is off there unless a session records,
and export drops the op where one does.
"""

from __future__ import annotations

import contextlib

import torch

# the span of each per-call or per-step packing of the decoder's weights
# for a decode kernel (build_tables, the kernels' pack_weights)
PACK = "aocr_torch.decode.pack"

_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager that records `name` as a span while a
    torch.profiler session records, and does nothing otherwise."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL
