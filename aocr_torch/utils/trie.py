"""Dictionary trie as a dense transition table for on-device decoding
(the port's own copy of aocr/utils/trie.py, over aocr_torch.vocab; the
two must build identical tables).

The reference builds a dynamic nested-hash trie over a word list rooted at
the GO symbol (`reference src/utils/utils.lua:177-218`); beam search
walks it host-side per beam.  On the device the trie becomes a static
(num_nodes, vocab) int32 transition table: entry [n, v] is the child node id
for emitting token v at node n, or -1 if the continuation is invalid.  The
decode loop then walks it with one row read per beam and step.

Node 0 is the root (the reference's trie[2], the GO node).  A word's
terminal EOS edge points to a dedicated leaf node (no outgoing edges), so
after EOS only PAD continues — same freeze behavior as the reference.

`allow_digit_prefix` (utils.lua:193-199) adds root self-loops for all digit
tokens and an EOS edge from root back to root, allowing arbitrary digit
prefixes (and empty output) before a dictionary word.
"""

from __future__ import annotations

import os
from typing import Iterable

import numpy as np

from aocr_torch import vocab


def build_transition_table(
    words: Iterable[str], allow_digit_prefix: bool = False
) -> np.ndarray:
    """Build the (num_nodes, VOCAB_SIZE) int32 transition table."""
    # Geometric preallocation: one row per trie node before minimization
    # (Synth90k-scale lexicons create ~500k nodes — allocating each row
    # individually dominated build time).
    table = np.full((1024, vocab.VOCAB_SIZE), -1, np.int64)
    num_nodes = 1

    def new_node() -> int:
        nonlocal table, num_nodes
        if num_nodes == table.shape[0]:
            table = np.concatenate([table, np.full_like(table, -1)])
        num_nodes += 1
        return num_nodes - 1

    root = 0
    if allow_digit_prefix:
        table[root, vocab.EOS] = root  # "output nothing", restart at root
        for d in "0123456789":
            table[root, vocab.char_to_id(d)] = root
    for word in words:
        word = word.strip().lower()
        if not word:
            continue
        try:
            toks = [vocab.char_to_id(ch) for ch in word]
        except ValueError:
            continue  # out-of-vocab word: skip without committing a prefix
        node = root
        for tok in toks:
            nxt = table[node, tok]
            if nxt < 0:
                nxt = new_node()
                table[node, tok] = nxt
            node = nxt
        if table[node, vocab.EOS] < 0:
            table[node, vocab.EOS] = new_node()  # terminal leaf
    return _minimize(table[:num_nodes].astype(np.int32))


def _minimize(table: np.ndarray) -> np.ndarray:
    """Merge indistinguishable states (Moore minimization).  Decoding only
    ever consumes the transition function from the root — node ids appear
    nowhere else — so merging is semantics-preserving and collapses the
    trie into a DAWG: every word's terminal leaf becomes ONE shared node,
    and shared word suffixes ('talking'/'walking' -> 'alking') share one
    chain.  On large flat lexicons this shrinks num_nodes several-fold,
    which is what keeps Synth90k-scale dictionaries under the VMEM gate
    of the whole-loop Pallas decode kernels (decode.py).

    The build-time trie is acyclic below the root (new_node ids only; the
    only back/self edges are the root's allow_digit_prefix loops), so one
    bottom-up sweep by node height reaches the fixpoint: equivalent nodes
    have equal height, and by the time a height level is deduplicated its
    children's ids are final.  ~25x faster than the iterated whole-table
    fixpoint at Synth90k scale (88k words: ~86s -> ~3s).  Falls back to
    the fixpoint if the no-edges-into-root invariant ever fails."""
    N = table.shape[0]
    if N <= 1:
        return table
    if (table[1:] == 0).any():  # non-root edge into the root: cyclic
        return _minimize_fixpoint(table)
    # Height: longest path to a sink, over nodes 1..N-1 (root excluded —
    # it is never merged and its self-loops would diverge).  Relaxation
    # converges within N passes on any acyclic graph (longest path < N);
    # a table still changing after that has a non-root cycle the cheap
    # edges-into-root check above couldn't see — fall back to the
    # fixpoint oracle rather than diverge.
    idx = np.maximum(table, 0)
    edge_valid = table >= 0
    edge_valid[0] = False  # drop the root's (possibly self-loop) edges
    height = np.zeros(N, np.int64)
    for _ in range(N):
        new_h = ((height[idx] + 1) * edge_valid).max(axis=1)
        if (new_h == height).all():
            break
        height = new_h
    else:
        return _minimize_fixpoint(table)
    new_id = np.arange(N, dtype=np.int64)
    for h in range(int(height[1:].min()), int(height[1:].max()) + 1):
        idx = np.nonzero(height == h)[0]
        idx = idx[idx > 0]
        if idx.size == 0:
            continue
        rows = table[idx]
        remapped = np.where(rows >= 0, new_id[rows], -1)
        _, first, inverse = np.unique(
            remapped, axis=0, return_index=True, return_inverse=True)
        new_id[idx] = idx[first][inverse]
    keep = np.nonzero(new_id == np.arange(N))[0]  # ascending, root first
    rank = np.full(N, -1, np.int64)
    rank[keep] = np.arange(keep.size)
    out = table[keep].copy()
    valid = out >= 0
    out[valid] = rank[new_id[out[valid]]].astype(table.dtype)
    return out


def _minimize_fixpoint(table: np.ndarray) -> np.ndarray:
    """Reference minimization: merge identical rows until fixpoint.  Kept
    as the oracle for _minimize's single-sweep algorithm (tests) and as
    the fallback for (never-built) cyclic tables."""
    while True:
        _, first_idx, inverse = np.unique(
            table, axis=0, return_index=True, return_inverse=True)
        if len(first_idx) == len(table):
            return table
        # renumber merge classes by first occurrence so the root stays 0
        order = np.argsort(first_idx)
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        node_to_new = rank[inverse].astype(table.dtype)
        table = table[np.sort(first_idx)].copy()
        valid = table >= 0
        table[valid] = node_to_new[table[valid]]


def load_dictionary(
    path: str, allow_digit_prefix: bool = False, cache: bool = True
) -> np.ndarray:
    """Reference `loadDictionary`: one word per line.

    The built DAWG is cached next to the word list (`<path>.dawg.npz`,
    keyed on the source file's mtime+size and the build options) so warm
    train/serve/test startups skip the build (~15 s for an 88k-word
    lexicon).  Cache reads and writes fail soft: a read-only dictionary
    directory just rebuilds every time."""
    st = os.stat(path)
    key = (f"v1:{st.st_mtime_ns}:{st.st_size}:{int(allow_digit_prefix)}"
           f":{vocab.VOCAB_SIZE}")
    # option bits ride in the filename so e.g. a -allow_digit_prefix
    # trainer and a plain server sharing one word list keep separate
    # cache entries instead of thrashing a single file
    cache_path = f"{path}.dp{int(allow_digit_prefix)}.dawg.npz"
    if cache and os.path.exists(cache_path):
        try:
            with np.load(cache_path, allow_pickle=False) as z:
                if str(z["key"]) == key:
                    return z["table"]
        except Exception:
            pass  # stale/corrupt cache: rebuild below
    with open(path) as f:
        table = build_transition_table(f, allow_digit_prefix)
    if cache:
        tmp = f"{cache_path}.{os.getpid()}.tmp.npz"
        try:
            np.savez(tmp, key=key, table=table)
            os.replace(tmp, cache_path)
        except OSError:
            # read-only dictionary dir / disk full: skip caching, but
            # don't leave a half-written temp file behind
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return table
