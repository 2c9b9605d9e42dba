"""aocr_torch.vocab.decode_batch against the single-row codecs, the port's
`vocab.decode` and the reference package's: every row of a (B, T) block
decodes as they decode it (truncation at the first EOS, PAD and GO dropped
before it, ids after it ignored), a bad id before the EOS raises
ValueError, and the compaction counter counts the rows whose printable ids
moved forward (a PAD or GO before one of them, before the EOS)."""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import sys
import threading

import numpy as np
import pytest
import torch

from aocr import vocab as jvocab
from aocr_torch import eval as teval
from aocr_torch import vocab


def _decoded(a):
    """Each row by the port's single-row codec, held to the reference's."""
    want = [vocab.decode(r) for r in a]
    assert want == [jvocab.decode(r) for r in a]
    return want


def _rows(B: int, T: int, dtype, seed: int) -> np.ndarray:
    """Seeded rows of every kind in turn: printable ids with no EOS; an
    EOS at 0; PAD and GO before and after an EOS; out-of-range ids after
    an EOS; printable ids then an EOS."""
    rng = np.random.default_rng(seed)
    a = rng.integers(vocab.NUM_SPECIAL, vocab.VOCAB_SIZE, (B, T))
    for r in range(B):
        if T == 0:
            break
        kind = r % 5
        at = int(rng.integers(0, T))
        if kind == 1:
            a[r, 0] = vocab.EOS
        elif kind == 2:
            a[r] = rng.integers(0, vocab.VOCAB_SIZE, T)
            a[r, a[r] == vocab.EOS] = vocab.GO
            a[r, at] = vocab.EOS
        elif kind == 3:
            a[r, at] = vocab.EOS
            a[r, at + 1:] = rng.integers(-50, 200, T - at - 1)
        elif kind == 4:
            a[r, at] = vocab.EOS
    return a.astype(dtype)


def _decoder_rows(B: int, T: int, dtype, seed: int) -> np.ndarray:
    """Seeded rows as the decoders emit them: printable ids, then an EOS
    and PAD (or GO, or more EOS) after it, or no EOS at all."""
    rng = np.random.default_rng(seed)
    a = rng.integers(vocab.NUM_SPECIAL, vocab.VOCAB_SIZE, (B, T))
    for r in range(B):
        if T == 0 or r % 4 == 0:
            continue
        at = int(rng.integers(0, T))
        a[r, at] = vocab.EOS
        a[r, at + 1:] = rng.integers(0, vocab.NUM_SPECIAL, T - at - 1)
    return a.astype(dtype)


@pytest.mark.parametrize("layout", ["any", "decoder"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("T", [0, 1, 50])
@pytest.mark.parametrize("B", [0, 1, 7, 512])
def test_decode_batch_matches_decode(B, T, dtype, layout):
    rows = _rows if layout == "any" else _decoder_rows
    a = rows(B, T, dtype, seed=1000 * B + T)
    assert a.shape == (B, T) and a.dtype == dtype
    assert vocab.decode_batch(a) == _decoded(a)
    # a list of rows decodes alike
    assert vocab.decode_batch(a.tolist()) == vocab.decode_batch(a)


def test_decode_batch_edge_rows():
    a = np.array([[vocab.EOS, 3, 4],  # EOS at 0
                  [vocab.PAD, vocab.GO, 3],  # specials dropped
                  [3, vocab.EOS, 99],  # out of range after EOS
                  [38, vocab.PAD, 13],  # compacted: "z" + "a"
                  [vocab.GO, vocab.GO, vocab.PAD]])  # nothing left
    assert vocab.decode_batch(a) == ["", "0", "0", "za", ""] == _decoded(a)
    assert vocab.decode_batch(np.zeros((0, 50), np.int64)) == []
    assert vocab.decode_batch(np.zeros((3, 0), np.int32)) == [""] * 3
    assert vocab.decode_batch([]) == []
    # other dtypes
    for dtype in (np.uint8, np.uint32, np.uint64, np.int8, np.bool_,
                  np.float64):
        b = a.astype(dtype)
        assert vocab.decode_batch(b) == _decoded(b)
    # a view that is not C-contiguous
    t = np.random.default_rng(2).integers(0, vocab.VOCAB_SIZE, (50, 7)).T
    assert not t.flags["C_CONTIGUOUS"]
    assert vocab.decode_batch(t) == _decoded(t)


@pytest.mark.parametrize("row, compacted", [
    ([3, 4, vocab.EOS, vocab.PAD, vocab.PAD], 0),
    ([3, 4, vocab.EOS, vocab.GO, vocab.EOS], 0),
    ([3, 4, 5, 6, 7], 0),
    ([vocab.EOS, vocab.PAD, vocab.PAD, vocab.PAD, vocab.PAD], 0),
    ([3, 4, vocab.PAD, vocab.PAD, vocab.PAD], 0),  # PAD freeze, no EOS
    ([vocab.GO, 3, 4, vocab.EOS, vocab.PAD], 1),
    ([3, vocab.PAD, vocab.EOS, vocab.PAD, vocab.PAD], 0),
    ([vocab.PAD, vocab.EOS, vocab.PAD, vocab.PAD, vocab.PAD], 0),
    ([3, vocab.PAD, vocab.GO, 4, vocab.EOS], 1),
    ([vocab.PAD, 3, vocab.PAD, 4, 5], 1),
    ([3, vocab.EOS, 4, vocab.PAD, vocab.PAD], 0),  # printable after EOS
    ([3, vocab.EOS, 4, 5, 6], 0),
    ([3, vocab.EOS, vocab.PAD, 4, 5], 0),  # a gap after the EOS
    ([3, vocab.EOS, 99, -1, vocab.PAD], 0),  # out of range after EOS
])
def test_decode_batch_rows_on_either_path(row, compacted):
    """A row among printable rows, its printable ids moved forward or not:
    the same string as decode, and counted iff they moved (a PAD or GO
    before a printable id, both before the row's EOS)."""
    a = np.full((3, 5), 20)
    a[1] = row
    vocab.reset_compaction_count()
    assert vocab.decode_batch(a) == _decoded(a)
    assert vocab.compaction_count() == compacted
    vocab.reset_compaction_count()


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("bad", [-1, -7, vocab.VOCAB_SIZE, 1000])
@pytest.mark.parametrize("eos", [True, False])
def test_decode_batch_raises_on_a_bad_live_id(bad, eos, dtype):
    a = np.full((7, 50), 13, dtype)
    a[4, 20] = bad
    if eos:
        a[4, 30] = vocab.EOS
    with pytest.raises(ValueError, match=f"id {bad} "):
        vocab.decode(a[4])
    with pytest.raises(ValueError, match=f"id {bad} "):
        vocab.decode_batch(a)
    # the same id after the row's EOS is ignored, by both
    a[4, 10] = vocab.EOS
    assert vocab.decode_batch(a) == [vocab.decode(r) for r in a]


def test_decode_batch_refuses_other_ranks():
    with pytest.raises(ValueError, match="2-D"):
        vocab.decode_batch(np.array([3, 4, vocab.EOS]))


def test_compaction_counter_counts_rows_with_pad_or_go_before_eos():
    vocab.reset_compaction_count()
    assert vocab.compaction_count() == 0
    printable = np.random.default_rng(3).integers(
        vocab.NUM_SPECIAL, vocab.VOCAB_SIZE, (512, 50))
    printable[::3, 25] = vocab.EOS
    vocab.decode_batch(printable)
    assert vocab.compaction_count() == 0

    a = _rows(512, 50, np.int32, seed=4)
    first = [list(r).index(vocab.EOS) if vocab.EOS in r else 50 for r in a]
    # rows whose printable ids before the EOS are not a prefix of it
    kept = [[i for i in range(n) if r[i] > vocab.EOS]
            for r, n in zip(a.tolist(), first)]
    want = sum(k != list(range(len(k))) for k in kept)
    assert 0 < want < 512
    assert vocab.decode_batch(a) == _decoded(a)
    assert vocab.compaction_count() == want
    vocab.decode_batch(a)
    assert vocab.compaction_count() == 2 * want
    # a PAD or GO only after the EOS, or only after the printable ids,
    # moves nothing
    after = np.full((3, 6), 3)
    after[:2, 2] = vocab.EOS
    after[0, 4], after[1, 5] = vocab.PAD, vocab.GO
    after[2, 2:] = vocab.PAD
    vocab.decode_batch(after)
    assert vocab.compaction_count() == 2 * want
    vocab.reset_compaction_count()
    assert vocab.compaction_count() == 0


@pytest.mark.parametrize("T", [0, 1, 50])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_live_mask_and_canonicalize_agree_with_decode_batch(T, dtype):
    """live_mask is the same on a numpy array and a torch tensor, and ends
    each row at its first EOS; canonicalize, built on it, keeps as many
    ids in each row as decode_batch's string has characters."""
    a = _rows(64, T, dtype, seed=5 + T)
    first = [list(r).index(vocab.EOS) if vocab.EOS in r else T for r in a]
    want = np.arange(T)[None, :] < np.array(first, np.int64)[:, None]
    t = torch.from_numpy(a)
    assert (vocab.live_mask(a) == want).all()
    assert (vocab.live_mask(t).numpy() == want).all()
    a[a < 0] = vocab.PAD  # canonicalize's ids are in range
    a[a >= vocab.VOCAB_SIZE] = vocab.PAD
    words = vocab.decode_batch(a)
    compact, lengths = teval.canonicalize(torch.from_numpy(a))
    assert lengths.tolist() == [len(w) for w in words]
    assert vocab.decode_batch(compact.numpy()) == words


def test_compaction_counter_under_threads():
    """Threads decoding at once (serve's handlers may) lose no count."""
    a = np.full((16, 8), 13)
    a[::2, 3] = vocab.PAD  # 8 rows to compact
    threads = [threading.Thread(target=lambda: [vocab.decode_batch(a)
                                                for _ in range(200)])
               for _ in range(16)]
    interval = sys.getswitchinterval()
    vocab.reset_compaction_count()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert vocab.compaction_count() == 16 * 200 * 8
    vocab.reset_compaction_count()
