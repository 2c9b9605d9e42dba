"""The decoder's dropout (counterpart of aocr/models/decoder.py::_dropout):
kept activations are divided by the keep rate, dropped ones are zero,
`where(mask, x / keep, 0)` with keep = 1 - rate, as aocr computes it
(a multiply by 1/keep would differ in the last bit).

JAX's threefry stream cannot be reproduced here, so the masks are the
port's own draws, split from their use as augment's are (`masks` draws,
`apply` applies): a test feeds JAX's masks into `apply`.  The bits come
from Philox-4x32-10 (`augment.philox4x32`) under the step key, with the
counter (column / 4, GLOBAL row, step * SITES_MAX + site, DROPOUT_TAG):

- site i - 1 is the input of decoder layer i >= 1, site num_layers - 1
  the attention output h~ (the reference's dropout sites,
  src/model/LSTM.lua:56-117);
- DROPOUT_TAG keeps the stream apart from augment's (AUG_TAG), which
  reads the same step key: augment's draws are the same with dropout on
  or off.

So each bit is a pure function of (step key, global row, step, site,
column).  The remat recompute reads the masks drawn before it (never a
generator's state, which `torch.utils.checkpoint` restores only for the
default generators), every model rank holding a row draws that row's
mask, and a data- or tensor-parallel step applies the one-process step's
masks.  aocr's shard_map data parallelism draws from one key on every
shard (aocr/parallel/data_parallel.py), so its masks depend on the shard
count; the port's do not.
"""

from __future__ import annotations

import torch

from aocr_torch.augment import philox4x32

# the fourth counter word: dropout's stream ("drop")
DROPOUT_TAG = 0x64726F70

# sites a step may have: the layers above the first, and h~
SITES_MAX = 64

_M32 = 0xFFFFFFFF


def masks(key, rows: torch.Tensor, steps: int, sites: int, width: int,
          rate: float) -> torch.Tensor:
    """Keep masks (steps, sites, B, width) bool for the global row indices
    `rows` (B,) under the step key (two 32-bit words): a bit is kept when
    its uniform (the top 24 bits of its word) is below 1 - rate."""
    if sites > SITES_MAX:
        raise ValueError(f"dropout: {sites} sites a step, at most "
                         f"{SITES_MAX}")
    key = (int(key[0]) & _M32, int(key[1]) & _M32)
    dev = rows.device
    calls = (width + 3) // 4
    col = torch.arange(calls, dtype=torch.int64, device=dev)
    row = rows.to(torch.int64)[:, None]
    site = (torch.arange(steps, dtype=torch.int64, device=dev)[:, None]
            * SITES_MAX
            + torch.arange(sites, dtype=torch.int64, device=dev)[None, :])
    words = philox4x32((col[None, None, None, :], row[None, None],
                        site[:, :, None, None], DROPOUT_TAG), key)
    u = torch.stack(words, -1).reshape(steps, sites, len(rows), 4 * calls)
    # the top 24 bits as an integer against keep * 2^24
    threshold = int(round((1.0 - rate) * (1 << 24)))
    return (u[..., :width] >> 8) < threshold


def apply(x: torch.Tensor, keep_mask: torch.Tensor, rate: float
          ) -> torch.Tensor:
    """where(keep_mask, x / keep, 0), keep = 1 - rate, in x's dtype."""
    keep = 1.0 - rate
    return torch.where(keep_mask, x / keep, torch.zeros_like(x))
