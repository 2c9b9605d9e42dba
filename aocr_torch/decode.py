"""Greedy and beam decoding, with an optional dictionary (counterpart of
aocr/decode.py: greedy_decode, greedy_from_context, beam_decode,
beam_from_context, _apply_trie_and_topk, _backtrack_best).

The routes are chosen as the reference chooses them, from the kernels'
plan functions (`greedy_route`, `beam_route`), and logged once a shape:

- greedy, cfg.use_pallas, pallas_greedy "auto" or "loop": the whole
  decode is the `greedy_loop` kernel, the trie in the kernel, where
  `greedy_loop.plan` fits the shape.  Where it does not (a decoder wider
  than 16 blocks of greedy_loop.MAX_UNITS units, for one), the per-step
  tail below, as the reference falls back when its VMEM estimate does
  not fit; "loop" then warns, as the reference's does.
- greedy, pallas_greedy "tail" (or the fallback): a host loop of steps,
  each the plain LSTM stack followed by the `decode_step` kernel (its
  weight slices packed at the first step, `decode_step.recall`), the trie
  plane gathered per step, where `decode_step.fits` the shape (its
  cluster plan, or its rows route); else the plain route.
- use_pallas=False (or simple_attention), or no kernel fits: the
  XLA-equivalent route, `decoder.step` + `head.apply` in plain PyTorch.

Beam routes (K = min(beam_size, V); K = 1 is greedy).  Every route first
runs the batch-sized t=1 GO step in plain PyTorch and its top-K over V:

- cfg.use_pallas, pallas_beam "auto" or "loop": the rest of the search
  is one `beam_loop` launch where `beam_loop.plan` fits the shape (K <=
  beam_loop.MAX_K, as the reference's `fits`).  Else, and for "tail":
- a host loop of steps, each the plain LSTM stack over the B*K beams
  followed by the `beam_step` kernel, where `beam_step.fits` the shape.
  The reference's B >= 512 gate on this route was a TPU measurement and
  is not carried over.  Else:
- use_pallas=False (or simple_attention), or no kernel fits: the
  XLA-equivalent route, `decoder.lstm_stack` +
  `decoder.attention_grouped` + `head.apply`.  A forced "loop" or "tail"
  that does not get its kernel warns.

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

import logging
import warnings
from typing import Optional

import torch

from aocr_torch import vocab
from aocr_torch.config import Config
from aocr_torch.models import decoder, head, model
from aocr_torch.ops.cuda import beam_loop, beam_step, decode_step, greedy_loop
from aocr_torch.utils.tracing import PACK, span


_log = logging.getLogger(__name__)
# the route taken at each shape key, logged at its first decode
routes: dict = {}


def _route(what: str, mode: str, loop_fits, tail_fits, key: tuple,
           shape: str) -> str:
    """"loop" where mode is not "tail" and loop_fits(), else "tail" where
    tail_fits(), else "plain"; a forced mode ("loop", "tail") that does
    not get its kernel warns, as the reference's does (a forced mode
    silently measuring another route would corrupt A/B numbers).  Logged
    at a key's first decode."""
    route = ("loop" if mode != "tail" and loop_fits() else
             "tail" if tail_fits() else "plain")
    if mode in ("loop", "tail") and route != mode:
        warnings.warn(f"pallas_{what}={mode!r} requested but its kernel has "
                      f"no plan ({shape}); falling back to the {route} "
                      "route", stacklevel=3)
    if (what, key) not in routes:
        routes[(what, key)] = route
        _log.info(f"{what} route at {key}: {route}")
    return route


def _plan_args(cfg: Config, B):
    """(compute dtype, the batch the plans are read at, padded vocabulary,
    layers): B, or 1 where B is symbolic (a program traced for any
    batch); a plan that fits one row fitted every batch tried
    (tests/test_torch_port_routes.py)."""
    Vp = -(-cfg.target_vocab_size // decode_step.PACK_VP) * \
        decode_step.PACK_VP
    return (model.compute_dtype(cfg), B if isinstance(B, int) else 1, Vp,
            cfg.decoder_num_layers)


def greedy_route(cfg: Config, B, L: int, H: int) -> str:
    """The greedy decode's route for B rows over a context of L x H:
    "loop" (greedy_loop), "tail" (decode_step a step) or "plain" (module
    docstring)."""
    if not cfg.use_pallas or cfg.simple_attention:
        return "plain"
    cd, b, Vp, nl = _plan_args(cfg, B)
    return _route(
        "greedy", cfg.pallas_greedy,
        lambda: H % 4 == 0 and greedy_loop.plan(H, b, cd, L, Vp, nl,
                                                1) is not None,
        lambda: decode_step.fits(H, b, cd, L, Vp), (H, b, str(cd), L, nl),
        f"L={L}, H={H}, B={B}, {nl} layers, {cd}")


def beam_route(cfg: Config, B, L: int, H: int, K: int) -> str:
    """The beam search's route after its t=1 step, for B rows of K beams
    over a context of L x H: "loop" (beam_loop), "tail" (beam_step a step)
    or "plain" (module docstring)."""
    if not cfg.use_pallas or cfg.simple_attention:
        return "plain"
    cd, b, Vp, nl = _plan_args(cfg, B)
    return _route(
        "beam", cfg.pallas_beam,
        lambda: H % 4 == 0 and beam_loop.plan(H, b, K, cd, L, Vp, nl,
                                              1) is not None,
        lambda: beam_step.fits(H, b, K, cd, L, Vp, cfg.target_vocab_size),
        (H, b, K, str(cd), L, nl),
        f"L={L}, H={H}, B={B}, K={K}, {nl} layers, {cd}")


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
    B, L, H = context.shape
    route = greedy_route(cfg, B, L, H)
    if route == "loop":
        with span(PACK):
            tables = greedy_loop.build_tables(dec_params, proj,
                                              cfg.target_embedding_size,
                                              cfg.input_feed, cd)
        c0, h0 = dec_init
        return greedy_loop.fused_greedy_loop(
            context.transpose(0, 1).contiguous(), c0, h0, tables,
            cfg.decoder_num_layers, cfg.input_feed, max_len,
            trie_table=trie_table)

    dev = context.device
    fused = route == "tail"
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
                return_refills: bool = False, early_exit: bool = True,
                encode=model.encode):
    """Decode a batch; beam_size is clamped to the vocab size, and 1 is the
    greedy path.  Returns (labels (B, max_len) int32, scores (B,) float32,
    the best beam's cumulative log-prob), and with return_refills also
    (refills, min_valid): the live rows' steps with fewer than K valid
    trie continuations and the fewest valid continuations seen (the
    reference's 'valid beam size' warnings, model.lua:421-436).
    early_exit=False runs every step of the host loops (as
    greedy_from_context).  `encode` is the model's encoder, with
    model.encode's signature (im2markup's for that network)."""
    context, dec_init = encode(params, batch_stats, images, cfg)
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

    route = beam_route(cfg, B, L, H, K)
    if route == "loop":
        with span(PACK):
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
    fused = route == "tail"
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
