"""39-symbol vocabulary codec for word-image OCR (the port's own copy of
aocr/vocab.py: the same ids and batch packing).

Semantics follow the reference codec (`reference src/utils/utils.lua:104-134`,
declared at `src/train.lua:53`): PAD, GO, EOS, digits 0-9, lowercase letters
a-z, case-insensitive.  The reference uses 1-based Lua ids (PAD=1, GO=2,
EOS=3, digits 4-13, letters 14-39); this framework uses the same ordering
0-based (PAD=0, GO=1, EOS=2, digits 3-12, letters 13-38) — a pure index shift
with identical structure, so transcripts round-trip identically.
"""

from __future__ import annotations

import threading
from typing import List, Sequence

import numpy as np

PAD = 0
GO = 1
EOS = 2
NUM_SPECIAL = 3
VOCAB_SIZE = 39  # 3 special + 10 digits + 26 letters


def char_to_id(c: str) -> int:
    o = ord(c)
    if 97 <= o <= 122:  # 'a'..'z' -> 13..38
        return o - 97 + 10 + NUM_SPECIAL
    if 48 <= o <= 57:  # '0'..'9' -> 3..12
        return o - 48 + NUM_SPECIAL
    raise ValueError(f"character {c!r} not in vocabulary (lowercase a-z, 0-9)")


def id_to_char(i: int) -> str:
    if NUM_SPECIAL <= i < NUM_SPECIAL + 10:
        return chr(i - NUM_SPECIAL + 48)
    if NUM_SPECIAL + 10 <= i < VOCAB_SIZE:
        return chr(i - NUM_SPECIAL - 10 + 97)
    raise ValueError(f"id {i} is not a printable vocabulary id")


def encode(label: str) -> List[int]:
    """String -> [GO, c1, ..., cn, EOS] (reference `str2numlist`)."""
    return [GO] + [char_to_id(c) for c in label.lower()] + [EOS]


def decode(ids: Sequence[int]) -> str:
    """Ids -> string, stopping at the first EOS; PAD/GO are skipped.

    The reference's `numlist2str` assumes the caller already stripped
    specials (`evalWordErrRate` truncates at EOS, utils.lua:147-161); here
    truncation is folded in for convenience.
    """
    out = []
    for i in ids:
        i = int(i)
        if i == EOS:
            break
        if i in (PAD, GO):
            continue
        out.append(id_to_char(i))
    return "".join(out)


# code point of each printable id; 0 for PAD, GO and EOS
_POINTS = np.zeros((VOCAB_SIZE,), np.uint32)
_POINTS[NUM_SPECIAL:NUM_SPECIAL + 10] = np.arange(48, 58)
_POINTS[NUM_SPECIAL + 10:] = np.arange(97, 123)

# rows whose kept ids decode_batch moved forward: a PAD or GO before a
# printable id, both before the row's first EOS (serve's handler threads
# may decode at once)
compacted_rows = 0
_compacted_lock = threading.Lock()


def compaction_count() -> int:
    return compacted_rows


def reset_compaction_count() -> None:
    global compacted_rows
    with _compacted_lock:
        compacted_rows = 0


def live_mask(seqs):
    """(B, T) bool: the positions before each row's first EOS, the part
    of a row that `decode` reads.  `seqs` is a numpy array or a torch
    tensor (on any device) of (B, T) ids."""
    return (seqs == EOS).cumsum(1) == 0


def decode_batch(labels) -> List[str]:
    """`decode` of every row of a (B, T) integer array, in one pass over
    the block: truncate each row at its first EOS, drop PAD and GO before
    it, raise ValueError on any other id outside the vocabulary before it.

    Each row becomes T UCS-4 code points, 0 for PAD, GO and whatever
    follows the EOS; `tolist()` strips the trailing 0s, and a 0 left
    inside a row's string (a PAD or GO before a printable id) is removed
    from it, the row counted in `compacted_rows`."""
    global compacted_rows
    a = np.asarray(labels)
    if a.ndim == 1 and a.size == 0:
        return []  # an empty list of rows
    if a.ndim != 2:
        raise ValueError(f"labels must be 2-D (B, T), got shape {a.shape}")
    if a.dtype.kind != "i":
        a = a.astype(np.int64)  # as decode's int(); take() wants signed ids
    B, T = a.shape
    if B == 0 or T == 0:
        return [""] * B
    live = live_mask(a)
    bad = live & ((a < 0) | (a >= VOCAB_SIZE))
    if bad.any():
        r, c = np.argwhere(bad)[0]
        raise ValueError(f"id {int(a[r, c])} is not a printable vocabulary id")
    codes = _POINTS.take(a, mode="clip")  # ids after an EOS may lie outside
    codes *= live
    rows = codes.view(f"U{T}").ravel().tolist()
    moved = sum("\0" in w for w in rows)
    with _compacted_lock:
        compacted_rows += moved
    return [w.replace("\0", "") for w in rows]


def encode_batch(labels: Sequence[str], pad_to: int | None = None):
    """Encode labels into reference-style (targets, targets_eval, num_nonzeros).

    targets[i]      = [GO, c1..cn] padded with PAD   (decoder input)
    targets_eval[i] = [c1..cn, EOS] padded with PAD  (loss/eval target)
    num_nonzeros    = sum_i (len(label_i) + 1)       (non-PAD tokens in eval)

    Mirrors the batch packing in `reference src/data/data_gen.lua:106-117`.
    """
    seqs = [encode(s) for s in labels]
    width = max(len(s) for s in seqs) - 1
    if pad_to is not None:
        # pad_to is a fixed-shape CONTRACT (multihost lockstep and
        # -pad_targets rely on every batch having identical target
        # width), not a floor — silently widening past it would wedge
        # cross-host collectives / defeat the bounded jit-cache goal.
        if width > pad_to:
            raise ValueError(
                f"label of length {width} exceeds pad_to={pad_to} "
                f"(truncate labels to max_decoder_l - 1 upstream)")
        width = pad_to
    n = len(seqs)
    targets = np.full((n, width), PAD, dtype=np.int32)
    targets_eval = np.full((n, width), PAD, dtype=np.int32)
    num_nonzeros = 0
    for i, s in enumerate(seqs):
        m = len(s) - 1
        targets[i, :m] = s[:-1]
        targets_eval[i, :m] = s[1:]
        num_nonzeros += m
    return targets, targets_eval, num_nonzeros
