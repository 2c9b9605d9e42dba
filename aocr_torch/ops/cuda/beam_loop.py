"""The whole K-beam search after the t=1 GO step in one kernel
(csrc/beam_loop.cu).

Replaces `aocr/ops/pallas/beam_loop.py::fused_beam_loop` and reuses
greedy_loop's `build_tables`.  Every step t = 1 .. T-1 of every batch row:
each beam's LSTM stack from its previous token, attention over the row's
context, the projector with the PAD/EOS freeze, its score added, the trie
(PAD always valid), the top-K over K x V with refill (beam_step's
`topk_refill` order), row finality, the parent reorder of the decoder
state, the trie node step (PAD keeps the parent's node), the lengths (a
PAD counts only when its parent was live) and the token and parent
histories; each block of batch rows stops once all its beams are frozen.
"""

from __future__ import annotations

from typing import Optional

import torch

from aocr_torch import vocab
from aocr_torch.ops import cuda, lstm
from aocr_torch.ops.cuda import beam_step, greedy_loop
from aocr_torch.ops.mm import matmul

launches = 0

MAX_K = 8  # beam widths of the kernel; wider beams take the beam_step route


def gather_beams(x: torch.Tensor, parents: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) gathered along K by parents (B, K)."""
    idx = parents.long().reshape(parents.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(parents.shape + x.shape[2:]))


def advance_beams(frozen, new_scores, parents, toks, scores, nodes, lengths,
                  trie_table, nvalid, refills, min_valid,
                  count_lengths: bool):
    """One search step's bookkeeping after the top-K, (B, K) tensors
    throughout: row finality (a row whose beams were all frozen keeps its
    scores and writes identity parents and PAD, aocr/decode.py:658-685),
    the trie node step (PAD keeps the parent's node), the live rows'
    refill counts (nvalid (B,) valid candidates), and under count_lengths
    the lengths (a PAD counts only when its parent was live).  Returns
    (scores, parents, toks, nodes, lengths, refills, min_valid)."""
    B, K = frozen.shape
    live = ~frozen.all(dim=1, keepdim=True)
    ident = torch.arange(K, dtype=torch.int32, device=frozen.device)
    scores = torch.where(live, new_scores, scores)
    parents = torch.where(live, parents, ident.expand(B, K))
    toks = torch.where(live, toks, vocab.PAD)
    if trie_table is not None:
        pnodes = gather_beams(nodes, parents)
        nodes = torch.where(toks == vocab.PAD, pnodes,
                            greedy_loop.trie_step(trie_table, pnodes, toks))
        nvalid = nvalid[:, None]
        refills = refills + (live & (nvalid < K)).sum().to(torch.int32)
        min_valid = torch.minimum(min_valid, torch.where(
            live, nvalid, K).min().to(torch.int32))
    if count_lengths:
        emitted = (toks != vocab.PAD) | ~gather_beams(frozen, parents)
        lengths = gather_beams(lengths, parents) + emitted.to(torch.int32)
    return scores, parents, toks, nodes, lengths, refills, min_valid


def fused_beam_loop_plain(context_lbh, init_state, tokens0, scores0, nodes0,
                          tables: dict, num_layers: int, input_feed: bool,
                          T: int, K: int, count_lengths: bool,
                          trie_table: Optional[torch.Tensor] = None,
                          return_margins: bool = False):
    """Plain PyTorch version; same arguments and results as
    fused_beam_loop.  Each beam's arithmetic is fused_greedy_loop_plain's
    step and beam_step's plain tail, as the TPU kernel's is.  With
    return_margins it also returns (T, B) float32 margins: at each step of
    each live row, the smallest gap between neighbours among its K+1 best
    candidates (inf elsewhere), which tells a near-tie from a fault when
    two versions' histories part."""
    L, B, H = context_lbh.shape
    cd = tables["wa"].dtype
    dev = context_lbh.device
    V = tables["eg"].shape[0]
    rep = lambda x: x.float().repeat_interleave(K, dim=0)  # (B*K, H)
    attn = rep(init_state.attn)
    cs = [rep(c) for c in init_state.cs]
    hs = [rep(h) for h in init_state.hs]
    prev, scores = tokens0.to(torch.int32), scores0.float()
    nodes = (nodes0.to(torch.int32) if trie_table is not None
             else torch.zeros((B, K), dtype=torch.int32, device=dev))
    lengths = torch.ones((B, K), dtype=torch.int32, device=dev)
    ident = torch.arange(K, dtype=torch.int32, device=dev).expand(B, K)
    tok_hist = torch.full((T, B, K), vocab.PAD, dtype=torch.int32,
                          device=dev)
    tok_hist[0] = prev
    par_hist = ident.expand(T, B, K).clone()
    refills = torch.zeros((), dtype=torch.int32, device=dev)
    min_valid = torch.full((), K, dtype=torch.int32, device=dev)
    margins = torch.full((T, B), float("inf"), device=dev)
    for t in range(1, T):
        frozen = (prev == vocab.PAD) | (prev == vocab.EOS)
        if bool(frozen.all()):
            break
        ah = torch.cat([attn, hs[0]], dim=-1) if input_feed else hs[0]
        gates = (tables["eg"][prev.reshape(-1).long()].float()
                 + matmul(ah.to(cd), tables["wfh0"]))
        cs[0], hs[0] = lstm.gate_math(gates, cs[0])
        x = hs[0]
        for l in range(1, num_layers):
            g = matmul(torch.cat([x, hs[l]], dim=-1).to(cd),
                       tables["wx"][l - 1]) + tables["bx"][l - 1]
            cs[l], hs[l] = lstm.gate_math(g, cs[l])
            x = hs[l]
        valid = (None if trie_table is None else greedy_loop.trie_valid(
            trie_table, nodes, tables["pw"].shape[1], pad_ok=True
        ).reshape(B, -1))
        htld, total = beam_step.beam_totals(
            context_lbh, x.reshape(B, K * H), prev, scores, tables["wa"],
            tables["wc"], tables["pw"], tables["pb"], K, V, valid)
        nsc, idx, nvalid = beam_step.topk_refill(total, K, valid is not None)
        if return_margins:
            margins[t] = torch.where(frozen.all(dim=1), margins[t],
                                     beam_step.topk_margin(total, K))
        scores, parents, toks, nodes, lengths, refills, min_valid = \
            advance_beams(frozen, nsc, (idx // V).to(torch.int32),
                          (idx % V).to(torch.int32), scores, nodes, lengths,
                          trie_table, nvalid, refills, min_valid,
                          count_lengths)
        rows = (torch.arange(B, device=dev)[:, None] * K + parents).reshape(-1)
        attn = htld.reshape(B * K, H)[rows]
        cs = [c[rows] for c in cs]
        hs = [h[rows] for h in hs]
        prev = toks
        tok_hist[t] = toks
        par_hist[t] = parents
    out = (tok_hist, par_hist, scores, lengths)
    if trie_table is not None:
        out += (refills, min_valid)
    return out + (margins,) if return_margins else out


def fused_beam_loop(context_lbh: torch.Tensor, init_state, tokens0, scores0,
                    nodes0: Optional[torch.Tensor], tables: dict,
                    num_layers: int, input_feed: bool, T: int, K: int,
                    count_lengths: bool,
                    trie_table: Optional[torch.Tensor] = None):
    """Run beam steps t = 1 .. T-1; t = 0 is the batch-sized GO step whose
    picks seed tokens0, scores0, nodes0 (B, K) and whose decoder state
    (a DecoderState of (B, H) float32 rows) every beam starts from.

    context_lbh (L, B, H) scan-major, compute dtype; tables from
    greedy_loop.build_tables; trie_table an optional (N, V) int32
    transition table (then nodes0 is required).  Returns (tok_hist
    (T, B, K) int32, par_hist (T, B, K) int32, scores (B, K) float32,
    lengths (B, K) int32), and with a trie (refills, min_valid), 0-d int32:
    the live rows' steps with fewer than K valid candidates and the fewest
    valid candidates seen.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    global launches
    if context_lbh.device.type == "cpu":
        return fused_beam_loop_plain(context_lbh, init_state, tokens0,
                                     scores0, nodes0, tables, num_layers,
                                     input_feed, T, K, count_lengths,
                                     trie_table)
    if context_lbh.device.type != "cuda":
        raise ValueError(f"fused_beam_loop: unsupported device "
                         f"{context_lbh.device}")
    L, B, H = context_lbh.shape
    cd, dev = tables["wa"].dtype, context_lbh.device
    Vp = tables["pw"].shape[1]
    V = tables["eg"].shape[0]
    G = 4 * H
    if H % 4 or Vp % 4 or T < 1 or not 1 <= K <= min(MAX_K, V):
        raise ValueError(f"fused_beam_loop: H={H}, Vp={Vp}, T={T}, K={K}")
    cuda.check(context_lbh, "context_lbh", (L, B, H), cd, dev)
    cuda.check(tokens0, "tokens0", (B, K), torch.int32, dev)
    cuda.check(scores0, "scores0", (B, K), torch.float32, dev)
    cuda.check(tables["eg"], "eg", (V, G), cd, dev)
    cuda.check(tables["wfh0"], "wfh0", (2 * H if input_feed else H, G), cd,
               dev)
    cuda.check(tables["wx"], "wx", (num_layers - 1, 2 * H, G), cd, dev)
    cuda.check(tables["bx"], "bx", (num_layers - 1, G), torch.float32, dev)
    cuda.check(tables["wa"], "wa", (H, H), cd, dev)
    cuda.check(tables["wc"], "wc", (2 * H, H), cd, dev)
    cuda.check(tables["pw"], "pw", (H, Vp), cd, dev)
    cuda.check(tables["pb"], "pb", (Vp,), torch.float32, dev)
    if trie_table is not None:
        cuda.check(trie_table, "trie_table", (None, V), torch.int32, dev)
        cuda.check(nodes0, "nodes0", (B, K), torch.int32, dev)
    # the t=1 state, one (2*nl+1, H) block a batch row: attn, c_l, h_l
    slots = [init_state.attn]
    for c, h in zip(init_state.cs, init_state.hs):
        slots += [c, h]
    init = torch.stack([s.float() for s in slots], dim=1).contiguous()
    cuda.check(init, "init_state", (B, 2 * num_layers + 1, H), torch.float32,
               dev)
    tok_hist = torch.empty((T, B, K), dtype=torch.int32, device=dev)
    par_hist = torch.empty((T, B, K), dtype=torch.int32, device=dev)
    scores = torch.empty((B, K), dtype=torch.float32, device=dev)
    lengths = torch.empty((B, K), dtype=torch.int32, device=dev)
    refills = minv = None
    if trie_table is not None:
        refills = torch.empty((B,), dtype=torch.int32, device=dev)
        minv = torch.empty((B,), dtype=torch.int32, device=dev)
    state = torch.empty((2, B * K, 2 * num_layers + 1, H),
                        dtype=torch.float32, device=dev)
    t = tables
    cuda.launch("beam_loop", cd, dev, context_lbh.data_ptr(),
                init.data_ptr(), tokens0.data_ptr(), scores0.data_ptr(),
                cuda.ptr(nodes0 if trie_table is not None else None),
                t["eg"].data_ptr(), t["wfh0"].data_ptr(), t["wx"].data_ptr(),
                t["bx"].data_ptr(), t["wa"].data_ptr(), t["wc"].data_ptr(),
                t["pw"].data_ptr(), t["pb"].data_ptr(), cuda.ptr(trie_table),
                tok_hist.data_ptr(), par_hist.data_ptr(), scores.data_ptr(),
                lengths.data_ptr(), cuda.ptr(refills), cuda.ptr(minv),
                state.data_ptr(), L, B, H, Vp, V, T, num_layers,
                int(input_feed), K, int(count_lengths))
    launches += 1
    out = (tok_hist, par_hist, scores, lengths)
    if trie_table is None:
        return out
    return out + (refills.sum().to(torch.int32),
                  minv.min().to(torch.int32))
