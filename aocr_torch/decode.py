"""Greedy and beam decoding, with an optional dictionary (counterpart of
aocr/decode.py: greedy_decode, greedy_from_context, beam_decode,
beam_from_context, _apply_trie_and_topk, _backtrack_best).

Greedy routes, chosen as the reference chooses them:

- cfg.use_pallas, pallas_greedy "auto" or "loop": the whole decode is the
  `greedy_loop` kernel, the trie in the kernel.  The reference falls back
  to the per-step tail when its VMEM estimate does not fit; that gate has
  no meaning on the card, so "auto" always takes the loop here.
- cfg.use_pallas, pallas_greedy "tail": a host loop of steps, each the
  plain LSTM stack followed by the `decode_step` kernel (its weight
  slices packed at the first step, `decode_step.recall`), the trie plane
  gathered per step.
- use_pallas=False (or simple_attention): the XLA-equivalent route,
  `decoder.step` + `head.apply` in plain PyTorch.

Beam routes (K = min(beam_size, V); K = 1 is greedy).  Every route first
runs the batch-sized t=1 GO step in plain PyTorch and its top-K over V:

- cfg.use_pallas, pallas_beam "auto" or "loop", K <= beam_loop.MAX_K: the
  rest of the search is one `beam_loop` launch.  The TPU's VMEM `fits`
  gate means nothing on the card.
- pallas_beam "tail", or K > MAX_K: a host loop of steps, each the plain
  LSTM stack over the B*K beams followed by the `beam_step` kernel.  The
  reference's B >= 512 gate on this route was a TPU measurement and is
  not carried over.
- use_pallas=False (or simple_attention): the XLA-equivalent route,
  `decoder.lstm_stack` + `decoder.attention_grouped` + `head.apply`.

On CPU tensors each kernel's plain version runs in its place.  Every
route keeps the PAD/EOS freeze (a beam whose previous token is PAD or EOS
gets logp[PAD] = 0, so it emits PAD with an unchanged score), the
finality of a batch row whose beams are all frozen, and the trie rules:
at t=1 only the root's children, without PAD; later PAD always valid and
keeping the node.  A host loop synchronises once a step, on its
all-frozen check, unless early_exit=False: then it runs all max_len
steps and branches on no tensor's value, so that torch.export traces the
decode (aocr_torch/export.py).  The kernels are reached through their
custom ops (`aocr_torch::...`), which a traced program keeps as nodes.
"""

from __future__ import annotations

from typing import Optional

import torch

from aocr_torch import vocab
from aocr_torch.config import Config
from aocr_torch.models import decoder, head, model
from aocr_torch.ops.cuda import beam_loop, beam_step, decode_step, greedy_loop


def greedy_decode(params: dict, batch_stats: dict, images: torch.Tensor,
                  cfg: Config, max_len: int,
                  trie_table: Optional[torch.Tensor] = None,
                  early_exit: bool = True):
    """images (B, 32, W, 1) -> (labels (B, max_len) int32, scores (B,)
    float32 cumulative log-probs).  early_exit as in
    greedy_from_context."""
    context, dec_init = model.encode(params, batch_stats, images, cfg)
    return greedy_from_context(params, context, dec_init, cfg, max_len,
                               trie_table, early_exit=early_exit)


def greedy_from_context(params: dict, context: torch.Tensor, dec_init,
                        cfg: Config, max_len: int,
                        trie_table: Optional[torch.Tensor] = None,
                        early_exit: bool = True):
    """Greedy decode from an encoder context (B, L, H) and dec_init;
    trie_table an optional (N, V) int32 transition table on the same
    device.  early_exit=False runs all max_len steps of the host loop
    instead of stopping once every row is frozen (the same labels and
    scores: a frozen row emits PAD at no cost), so that nothing branches
    on a tensor's value and torch.export can trace the decode."""
    cd = model.compute_dtype(cfg)
    context = context.to(cd)
    dec_params, proj = params["decoder"], params["projector"]
    fused = cfg.use_pallas and not cfg.simple_attention
    if fused and cfg.pallas_greedy in ("auto", "loop"):
        tables = greedy_loop.build_tables(dec_params, proj,
                                          cfg.target_embedding_size,
                                          cfg.input_feed, cd)
        c0, h0 = dec_init
        return greedy_loop.fused_greedy_loop(
            context.transpose(0, 1).contiguous(), c0, h0, tables,
            cfg.decoder_num_layers, cfg.input_feed, max_len,
            trie_table=trie_table)

    B, dev = context.shape[0], context.device
    prep = decoder.prepare(dec_params, cd)
    state = decoder.init_state(dec_init, cfg.decoder_num_layers)
    width = cfg.target_vocab_size  # of the validity plane
    if fused:
        pw, pb = decode_step.pad_projector(proj["w"].to(cd), proj["b"])
        ctx_lbh = context.transpose(0, 1).contiguous()
        width = pw.shape[1]
    prev = torch.full((B,), vocab.GO, dtype=torch.int32, device=dev)
    nodes = torch.zeros((B,), dtype=torch.int32, device=dev)
    labels = torch.full((B, max_len), vocab.PAD, dtype=torch.int32,
                        device=dev)
    scores = torch.zeros((B,), dtype=torch.float32, device=dev)
    for t in range(max_len):
        if early_exit and t > 0 and bool(
                ((prev == vocab.PAD) | (prev == vocab.EOS)).all()):
            break
        # the root's children at t=0, without PAD; later PAD always valid
        valid = (None if trie_table is None else greedy_loop.trie_valid(
            trie_table, nodes, width, pad_ok=t > 0))
        if fused:
            cs, hs, h_top = decoder.lstm_stack(prep, state, prev,
                                               input_feed=cfg.input_feed)
            h_tilde, tok, delta = decode_step.fused_decode_tail(
                h_top, ctx_lbh, prev, prep["w_a"], prep["w_c"], pw, pb,
                valid=valid, V=cfg.target_vocab_size)
            state = decoder.DecoderState(attn=h_tilde.to(cd), cs=cs, hs=hs)
        else:
            state, h_tilde = decoder.step(prep, state, prev, context,
                                          input_feed=cfg.input_feed,
                                          simple=cfg.simple_attention)
            logp = head.apply(proj, h_tilde, cd)
            tok, delta, _ = decode_step.freeze_and_pick(logp, prev, valid)
        if trie_table is not None:
            stepped = greedy_loop.trie_step(trie_table, nodes, tok)
            nodes = stepped if t == 0 else torch.where(
                tok == vocab.PAD, nodes, stepped)
        scores = scores + delta
        prev = tok
        labels[:, t] = tok
    return labels, scores


def beam_decode(params: dict, batch_stats: dict, images: torch.Tensor,
                cfg: Config, beam_size: int, max_len: int,
                trie_table: Optional[torch.Tensor] = None,
                return_refills: bool = False, early_exit: bool = True):
    """Decode a batch; beam_size is clamped to the vocab size, and 1 is the
    greedy path.  Returns (labels (B, max_len) int32, scores (B,) float32,
    the best beam's cumulative log-prob), and with return_refills also
    (refills, min_valid): the live rows' steps with fewer than K valid
    trie continuations and the fewest valid continuations seen (the
    reference's 'valid beam size' warnings, model.lua:421-436).
    early_exit=False runs every step of the host loops (as
    greedy_from_context)."""
    context, dec_init = model.encode(params, batch_stats, images, cfg)
    return beam_from_context(params, context, dec_init, cfg, beam_size,
                             max_len, trie_table, return_refills,
                             early_exit)


def _apply_trie_and_topk(total: torch.Tensor, valid: Optional[torch.Tensor],
                         K: int):
    """Top-K of total (B, C) with the trie mask (valid (B, C) bool) and
    the reference's refill: fewer than K valid candidates duplicate the
    best valid one.  Returns (scores, indices, valid counts or None)."""
    if valid is not None:
        total = torch.where(valid, total,
                            torch.full_like(total, beam_step.NEG))
    return beam_step.topk_refill(total, K, valid is not None)


def beam_from_context(params: dict, context: torch.Tensor, dec_init,
                      cfg: Config, beam_size: int, max_len: int,
                      trie_table: Optional[torch.Tensor] = None,
                      return_refills: bool = False, early_exit: bool = True):
    """beam_decode from an encoder context (B, L, H) and dec_init."""
    K = min(beam_size, cfg.target_vocab_size)
    if K == 1:
        out = greedy_from_context(params, context, dec_init, cfg, max_len,
                                  trie_table, early_exit)
        if return_refills:
            # PAD is always a valid greedy continuation: no refills
            return out + ((torch.zeros((), dtype=torch.int32),
                           torch.full((), K, dtype=torch.int32)),)
        return out
    V, T = cfg.target_vocab_size, max_len
    cd = model.compute_dtype(cfg)
    context = context.to(cd)
    B, L, H = context.shape
    dev = context.device
    dec_params, proj = params["decoder"], params["projector"]
    prep = decoder.prepare(dec_params, cd)
    use_trie = trie_table is not None

    # ---- t = 1: the batch-sized step from GO, top-K over V ----
    state = decoder.init_state(dec_init, cfg.decoder_num_layers)
    go = torch.full((B,), vocab.GO, dtype=torch.int32, device=dev)
    state, h_tilde = decoder.step(prep, state, go, context,
                                  input_feed=cfg.input_feed,
                                  simple=cfg.simple_attention)
    logp = head.apply(proj, h_tilde, cd)  # (B, V)
    valid0 = (trie_table[0] >= 0).expand(B, V) if use_trie else None
    scores, tokens0, nvalid0 = _apply_trie_and_topk(logp, valid0, K)
    tokens0 = tokens0.to(torch.int32)
    if use_trie:
        refills = (nvalid0 < K).sum().to(torch.int32)
        min_valid = nvalid0.min().to(torch.int32)
        nodes = trie_table[0][tokens0.long()].clamp(min=0).to(torch.int32)
    else:
        refills = torch.zeros((), dtype=torch.int32, device=dev)
        min_valid = torch.full((), K, dtype=torch.int32, device=dev)
        nodes = torch.zeros((B, K), dtype=torch.int32, device=dev)

    fused = cfg.use_pallas and not cfg.simple_attention
    if fused and cfg.pallas_beam != "tail" and K <= beam_loop.MAX_K:
        tables = greedy_loop.build_tables(dec_params, proj,
                                          cfg.target_embedding_size,
                                          cfg.input_feed, cd)
        outs = beam_loop.fused_beam_loop(
            context.transpose(0, 1).contiguous(), state, tokens0, scores,
            nodes if use_trie else None, tables, cfg.decoder_num_layers,
            cfg.input_feed, T, K, bool(cfg.length_normalize),
            trie_table=trie_table)
        tok_hist, par_hist, fin_scores, fin_lengths = outs[:4]
        if use_trie:
            refills = refills + outs[4]
            min_valid = torch.minimum(min_valid, outs[5])
        return _backtrack_best(cfg, fin_scores, fin_lengths, tok_hist,
                               par_hist, refills, min_valid, return_refills)

    # the decoder state expanded to B*K rows; the context is not (grouped
    # attention)
    rep = lambda x: x.repeat_interleave(K, dim=0)
    state = decoder.DecoderState(attn=rep(state.attn),
                                 cs=tuple(rep(c) for c in state.cs),
                                 hs=tuple(rep(h) for h in state.hs))
    if fused:
        pw, pb = decode_step.pad_projector(proj["w"].to(cd), proj["b"])
        ctx_lbh = context.transpose(0, 1).contiguous()
    prev = tokens0
    lengths = torch.ones((B, K), dtype=torch.int32, device=dev)
    tok_hist = torch.full((T, B, K), vocab.PAD, dtype=torch.int32,
                          device=dev)
    tok_hist[0] = tokens0
    par_hist = torch.arange(K, dtype=torch.int32, device=dev).expand(
        T, B, K).clone()
    for t in range(1, T):
        frozen = (prev == vocab.PAD) | (prev == vocab.EOS)
        if early_exit and bool(frozen.all()):
            break
        cs, hs, h_top = decoder.lstm_stack(prep, state, prev.reshape(-1),
                                           input_feed=cfg.input_feed)
        if fused:
            plane = (greedy_loop.trie_valid(
                trie_table, nodes, pw.shape[1], pad_ok=True).reshape(B, -1)
                if use_trie else None)
            out = beam_step.fused_beam_tail(
                ctx_lbh, h_top.reshape(B, K * H), prev, scores,
                prep["w_a"], prep["w_c"], pw, pb, K, V, valid=plane)
            h_t, new_scores, parents, toks = out[:4]
            nvalid = out[4] if use_trie else None
            h_t = h_t.reshape(B * K, H)
        else:
            h_t = decoder.attention_grouped(
                prep, h_top.reshape(B, K, H), context,
                simple=cfg.simple_attention).reshape(B * K, H)
            lp = decode_step.freeze_logp(
                head.apply(proj, h_t, cd).reshape(B, K, V), prev)
            total = (scores[:, :, None] + lp).reshape(B, K * V)
            valid = None
            if use_trie:
                ok = trie_table[nodes.long()] >= 0  # (B, K, V)
                ok[..., vocab.PAD] = True
                valid = ok.reshape(B, K * V)
            new_scores, raw, nvalid = _apply_trie_and_topk(total, valid, K)
            parents = (raw // V).to(torch.int32)
            toks = (raw % V).to(torch.int32)
        # a row whose beams were all frozen is final: otherwise a frozen
        # row that other rows keep stepping could resurrect a beam, and
        # under length_normalize its transcript would depend on its
        # batchmates
        scores, parents, toks, nodes, lengths, refills, min_valid = \
            beam_loop.advance_beams(frozen, new_scores, parents, toks,
                                    scores, nodes, lengths, trie_table,
                                    nvalid, refills, min_valid,
                                    cfg.length_normalize)
        rows = (torch.arange(B, device=dev)[:, None] * K
                + parents).reshape(-1)
        state = decoder.DecoderState(attn=h_t[rows],
                                     cs=tuple(c[rows] for c in cs),
                                     hs=tuple(h[rows] for h in hs))
        prev = toks
        tok_hist[t] = toks
        par_hist[t] = parents
    return _backtrack_best(cfg, scores, lengths, tok_hist, par_hist, refills,
                           min_valid, return_refills)


def _backtrack_best(cfg: Config, scores, lengths, tok_hist, par_hist,
                    refills, min_valid, return_refills: bool):
    """The best beam of each row (by score, or by score per emitted token
    under length_normalize; ties to the first beam) and its transcript by
    parent backtracking (reference model.lua:573-585)."""
    B = scores.shape[0]
    norm = (scores / lengths.clamp(min=1).float() if cfg.length_normalize
            else scores)
    best = norm.argmax(dim=1)
    best_scores = scores.gather(1, best[:, None])[:, 0]
    rows = torch.arange(B, device=scores.device)
    idx = best
    labels = torch.empty((B, tok_hist.shape[0]), dtype=torch.int32,
                         device=scores.device)
    for t in range(tok_hist.shape[0] - 1, -1, -1):
        labels[:, t] = tok_hist[t][rows, idx]
        idx = par_hist[t][rows, idx].long()
    if return_refills:
        return labels, best_scores, (refills, min_valid)
    return labels, best_scores
