"""Greedy decoding (counterpart of aocr/decode.py: greedy_decode,
greedy_from_context and the beam_size=1 branch of beam_decode).

Routes, chosen as the reference chooses them:

- cfg.use_pallas, pallas_greedy "auto" or "loop": the whole decode is the
  `greedy_loop` kernel.  The reference falls back to the per-step tail
  when its VMEM estimate does not fit; that gate has no meaning on the
  card, so "auto" always takes the loop here.
- cfg.use_pallas, pallas_greedy "tail": a host loop of steps, each the
  plain LSTM stack followed by the `decode_step` kernel.
- use_pallas=False (or simple_attention): the XLA-equivalent route,
  `decoder.step` + `head.apply` in plain PyTorch.

On CPU tensors each kernel's plain version runs in its place.  Every
route keeps the PAD/EOS freeze (a row whose previous token is PAD or EOS
gets logp[PAD] = 0, so it emits PAD with an unchanged score) and stops
once every row is frozen.  Dictionary (trie) decoding is not ported yet.
"""

from __future__ import annotations

import torch

from aocr import vocab
from aocr.config import Config
from aocr_torch.models import decoder, head, model
from aocr_torch.ops.cuda import decode_step, greedy_loop


def greedy_decode(params: dict, batch_stats: dict, images: torch.Tensor,
                  cfg: Config, max_len: int):
    """images (B, 32, W, 1) -> (labels (B, max_len) int32, scores (B,)
    float32 cumulative log-probs)."""
    context, dec_init = model.encode(params, batch_stats, images, cfg)
    return greedy_from_context(params, context, dec_init, cfg, max_len)


def greedy_from_context(params: dict, context: torch.Tensor, dec_init,
                        cfg: Config, max_len: int):
    """Greedy decode from an encoder context (B, L, H) and dec_init."""
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
            cfg.decoder_num_layers, cfg.input_feed, max_len)

    B, dev = context.shape[0], context.device
    prep = decoder.prepare(dec_params, cd)
    state = decoder.init_state(dec_init, cfg.decoder_num_layers)
    if fused:
        pw, pb = decode_step.pad_projector(proj["w"].to(cd), proj["b"])
        ctx_lbh = context.transpose(0, 1).contiguous()
    prev = torch.full((B,), vocab.GO, dtype=torch.int32, device=dev)
    labels = torch.full((B, max_len), vocab.PAD, dtype=torch.int32,
                        device=dev)
    scores = torch.zeros((B,), dtype=torch.float32, device=dev)
    for t in range(max_len):
        if t > 0 and bool(((prev == vocab.PAD) | (prev == vocab.EOS)).all()):
            break
        if fused:
            cs, hs, h_top = decoder.lstm_stack(prep, state, prev,
                                               input_feed=cfg.input_feed)
            h_tilde, tok, delta = decode_step.fused_decode_tail(
                h_top, ctx_lbh, prev, prep["w_a"], prep["w_c"], pw, pb)
            state = decoder.DecoderState(attn=h_tilde.to(cd), cs=cs, hs=hs)
        else:
            state, h_tilde = decoder.step(prep, state, prev, context,
                                          input_feed=cfg.input_feed,
                                          simple=cfg.simple_attention)
            logp = head.apply(proj, h_tilde, cd)
            tok, delta, _ = decode_step.freeze_and_pick(logp, prev)
        scores = scores + delta
        prev = tok
        labels[:, t] = tok
    return labels, scores


def beam_decode(params: dict, batch_stats: dict, images: torch.Tensor,
                cfg: Config, beam_size: int, max_len: int):
    """Decode a batch; beam_size is clamped to the vocab size, and 1 is the
    greedy path.  Returns (labels (B, max_len) int32, scores (B,))."""
    if min(beam_size, cfg.target_vocab_size) != 1:
        raise NotImplementedError(
            "beam search (beam_size > 1) is not ported yet: ROADMAP slice 3")
    return greedy_decode(params, batch_stats, images, cfg, max_len)
