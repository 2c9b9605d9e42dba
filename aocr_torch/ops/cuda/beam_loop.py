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
histories; each tile of batch rows stops once all its beams are frozen.

The kernel runs on greedy_loop's thread-block-cluster design
(csrc/decoder_cluster.cuh, `plan` below): a cluster of up to 16 SMs owns
a tile of nb whole batch rows with all K beams (nb x K <= bt beam rows)
for the whole search; each SM owns H/cs hidden units of every layer and
the same columns of W_a and W_c and streams its slices of the weights
(greedy_loop's `pack_weights`, at each call) through a ring of bulk
copies, multiplying them with the tile's beam rows on the tensor cores in
bf16 or the CUDA cores in float32.  The parent reorder moves no state:
each SM reads its products and cell states back at the parent's row (the
products are row-wise), so only a parent index a beam row crosses the
cluster, beside its token.  The attention, the log-softmax, the top-K
and the beams' bookkeeping are split by batch row.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional, Tuple

import torch

from aocr_torch import vocab
from aocr_torch.ops import cuda, lstm
from aocr_torch.ops.cuda import beam_step, greedy_loop
from aocr_torch.ops.mm import matmul
from aocr_torch.utils.tracing import PACK, span

launches = 0

MAX_K = 8  # beam widths of the kernel; wider beams take the beam_step route

# launch plans held against the kernel's, by shape key: (Plan, the line
# logged for it)
plans: dict = {}


# the launch plan's fields (csrc/beam_loop.cu `bl_plan`)
Plan = beam_step.Plan


def _ldf(U: int) -> int:
    """The row stride (floats) of the permuted epilogue's float tile."""
    return 4 * U + 4


def _smem(p: Plan, esz: int, K: int, H: int, L: int, Vp: int,
          nl: int) -> int:
    """csrc/beam_loop.cu `bl_smem`: the ring, the float tile, the cells and
    the per-row words (tokens and parents of the tile, 8 words an own beam
    row, 3 an own batch row), with the row-split scratch (R = Rb x K rows
    of H + L + Vp floats) and the permuted epilogue's tiles overlaid on the
    ring; 0 where an overlay does not fit."""
    ldh, ring = p.units + 8, greedy_loop.ring_bytes(p, esz)
    Rb = -(-p.nb // p.cs)
    R = Rb * K
    if (R * (H + L + Vp) * 4 > ring
            or p.bt * (_ldf(p.units) + p.units) * 4 > ring):
        return 0
    cells = p.bt * nl * p.units * 4 if p.cres else 0
    words = 2 * p.bt + 8 * R + 3 * Rb
    return (ring + p.bt * ldh * 4 + cells
            + greedy_loop._round_up(4 * words, 8) + greedy_loop.BARS)


def plan(H: int, B: int, K: int, dtype: torch.dtype, L: int, Vp: int,
         num_layers: int, active: int) -> Optional[Plan]:
    """The kernel's launch plan for hidden size H, batch B, beam width K,
    the compute dtype, the context length L, the padded vocabulary Vp, the
    decoder's layers and the clusters of the plan's size the card runs at
    once (`active`); None where no plan fits (K past MAX_K, more than
    greedy_loop.MAX_UNITS units a block, or no shared-memory fit):
    `beam_step.beam_plan_fit` with `_smem`."""
    if K > MAX_K:
        return None
    esz = torch.empty((), dtype=dtype).element_size()
    return beam_step.beam_plan_fit(
        H, B, K, dtype, active, greedy_loop.FIXED_ROWS,
        lambda q: _smem(q, esz, K, H, L, Vp, num_layers))


def scratch_bytes(p: Plan, dtype: torch.dtype, H: int, num_layers: int,
                  V: int) -> int:
    """Bytes of the kernel's zeroed scratch (csrc/beam_loop.cu
    `bl_scratch`): greedy_loop's regions, then the tile's parents."""
    return (greedy_loop.scratch_bytes(p, dtype, H, num_layers, V)
            + greedy_loop._round_up(p.clusters * p.bt * 4, greedy_loop.ALIGN))


def checked_plan(H: int, B: int, K: int, cd: torch.dtype, L: int, Vp: int,
                 nl: int) -> Plan:
    """The launch's plan: ValueError where none fits; on a shape's first
    launch held against the kernel's own and logged (`cuda.held_plan`)."""
    if plan(H, B, K, cd, L, Vp, nl, 1) is None:
        raise ValueError(f"fused_beam_loop: no kernel plan fits H={H}, "
                         f"B={B}, K={K}, L={L}, Vp={Vp}, {nl} layers in "
                         f"{cd} (wider beams or decoders take "
                         f"pallas_beam='tail')")
    return cuda.held_plan(
        "beam_loop", (H, B, K, cd, L, Vp, nl),
        lambda out: cuda.library().aocr_beam_loop_plan(
            H, B, K, int(cd == torch.float32), L, Vp, nl, out), 11,
        lambda active: plan(H, B, K, cd, L, Vp, nl, active),
        lambda p, active: (
            f"beam_loop plan H={H} B={B} K={K} L={L} {cd}: cluster "
            f"{p.cs} x {p.units} units, bt={p.bt} beam rows (rt="
            f"{p.rt}) = {p.nb} batch rows x {K} beams, {p.clusters} "
            f"clusters, {active} at once ({-(-p.clusters // active)} "
            f"waves); chunks of {p.kc} rows, {p.stages} stages; cell "
            f"states in {'shared memory' if p.cres else 'L2'}; smem "
            f"{p.smem} B"), plans)


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
    valid candidates seen.  Runs the custom op aocr_torch::fused_beam_loop
    (`op`, the state and tables as its flat arguments): CPU tensors take
    the plain version; CUDA tensors launch the kernel, or raise ValueError
    where no plan fits the shape (K past MAX_K among them:
    pallas_beam="tail" takes those).  The projector's columns past V must
    be pad_projector's zeros."""
    if context_lbh.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_beam_loop: unsupported device "
                         f"{context_lbh.device}")
    state = [init_state.attn]
    for c, h in zip(init_state.cs, init_state.hs):
        state += [c, h]
    t = tables
    out = op(context_lbh, state, tokens0, scores0, nodes0, t["eg"],
             t["wfh0"], t["wx"], t["bx"], t["wa"], t["wc"], t["pw"],
             t["pb"], trie_table, num_layers, input_feed, T, K,
             count_lengths)
    return out if trie_table is not None else out[:4]


@torch.library.custom_op("aocr_torch::fused_beam_loop", mutates_args=())
def op(context_lbh: torch.Tensor, init_state: List[torch.Tensor],
       tokens0: torch.Tensor, scores0: torch.Tensor,
       nodes0: Optional[torch.Tensor], eg: torch.Tensor, wfh0: torch.Tensor,
       wx: torch.Tensor, bx: torch.Tensor, wa: torch.Tensor,
       wc: torch.Tensor, pw: torch.Tensor, pb: torch.Tensor,
       trie_table: Optional[torch.Tensor], num_layers: int,
       input_feed: bool, T: int, K: int, count_lengths: bool
       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor, torch.Tensor]:
    """fused_beam_loop as a custom op: init_state the GO step's [attn,
    c_0, h_0, c_1, h_1, ...]; returns (tok_hist, par_hist, scores,
    lengths, refills, min_valid), the last two 0 and K without a trie.
    The plan, the weight packing and the scratch are sized here, from
    the real batch, so that torch.export traces the search as one node."""
    global launches
    t = {"eg": eg, "wfh0": wfh0, "wx": wx, "bx": bx, "wa": wa, "wc": wc,
         "pw": pw, "pb": pb}
    if context_lbh.device.type == "cpu":
        st = SimpleNamespace(attn=init_state[0], cs=init_state[1::2],
                             hs=init_state[2::2])
        # scores0 copied: a search that ends at once returns its scores,
        # and an op's outputs must not alias its inputs
        out = fused_beam_loop_plain(context_lbh, st, tokens0,
                                    scores0.clone(), nodes0, t, num_layers,
                                    input_feed, T, K, count_lengths,
                                    trie_table)
        if trie_table is None:
            out += (torch.zeros((), dtype=torch.int32),
                    torch.full((), K, dtype=torch.int32))
        return out
    L, B, H = context_lbh.shape
    cd, dev = wa.dtype, context_lbh.device
    Vp = pw.shape[1]
    V = eg.shape[0]
    G = 4 * H
    if H % 4 or Vp % 4 or T < 1 or num_layers < 1 or not 1 <= K <= V:
        raise ValueError(f"fused_beam_loop: H={H}, Vp={Vp}, T={T}, K={K}, "
                         f"num_layers={num_layers}")
    p = checked_plan(H, B, K, cd, L, Vp, num_layers)
    cuda.check(context_lbh, "context_lbh", (L, B, H), cd, dev)
    cuda.check(tokens0, "tokens0", (B, K), torch.int32, dev)
    cuda.check(scores0, "scores0", (B, K), torch.float32, dev)
    cuda.check(eg, "eg", (V, G), cd, dev)
    cuda.check(wfh0, "wfh0", (2 * H if input_feed else H, G), cd, dev)
    cuda.check(wx, "wx", (num_layers - 1, 2 * H, G), cd, dev)
    cuda.check(bx, "bx", (num_layers - 1, G), torch.float32, dev)
    cuda.check(wa, "wa", (H, H), cd, dev)
    cuda.check(wc, "wc", (2 * H, H), cd, dev)
    cuda.check(pw, "pw", (H, Vp), cd, dev)
    cuda.check(pb, "pb", (Vp,), torch.float32, dev)
    if trie_table is not None:
        cuda.check(trie_table, "trie_table", (None, V), torch.int32, dev)
        cuda.check(nodes0, "nodes0", (B, K), torch.int32, dev)
    # the t=1 state, one (2*nl+1, H) block a batch row: attn, c_l, h_l
    init = torch.stack([s.float() for s in init_state], dim=1).contiguous()
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
    scratch = torch.zeros((scratch_bytes(p, cd, H, num_layers, V),),
                          dtype=torch.uint8, device=dev)
    with span(PACK):
        w = greedy_loop.pack_weights(t, p, num_layers, input_feed)
    cuda.launch("beam_loop", cd, dev, context_lbh.data_ptr(),
                init.data_ptr(), tokens0.data_ptr(), scores0.data_ptr(),
                cuda.ptr(nodes0 if trie_table is not None else None),
                eg.data_ptr(), w["w0"].data_ptr(), w["wl"].data_ptr(),
                bx.data_ptr(), w["wq"].data_ptr(), w["wc"].data_ptr(),
                pw.data_ptr(), pb.data_ptr(), cuda.ptr(trie_table),
                tok_hist.data_ptr(), par_hist.data_ptr(), scores.data_ptr(),
                lengths.data_ptr(), cuda.ptr(refills), cuda.ptr(minv),
                scratch.data_ptr(), L, B, H, Vp, V, T, num_layers,
                int(input_feed), K, int(count_lengths))
    launches += 1
    if trie_table is None:
        return (tok_hist, par_hist, scores, lengths,
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.full((), K, dtype=torch.int32, device=dev))
    return (tok_hist, par_hist, scores, lengths,
            refills.sum().to(torch.int32), minv.min().to(torch.int32))


@op.register_fake
def _(context_lbh, init_state, tokens0, scores0, nodes0, eg, wfh0, wx, bx,
      wa, wc, pw, pb, trie_table, num_layers, input_feed, T, K,
      count_lengths):
    B = context_lbh.shape[1]
    i32 = torch.int32
    return (context_lbh.new_empty((T, B, K), dtype=i32),
            context_lbh.new_empty((T, B, K), dtype=i32),
            context_lbh.new_empty((B, K), dtype=torch.float32),
            context_lbh.new_empty((B, K), dtype=i32),
            context_lbh.new_empty((), dtype=i32),
            context_lbh.new_empty((), dtype=i32))
