"""One beam-search step after the LSTM stack in one kernel
(csrc/beam_step.cu).

Replaces `aocr/ops/pallas/beam_step.py::fused_beam_tail`: per beam, the
grouped attention over its batch row's one context row and the projector
with log-softmax (decode_step's attention tail), the PAD/EOS freeze, the
beam's score added, the optional trie plane, then the top-K over the K x V
candidates of each batch row in lax.top_k's order (ties to the first
index of the k-major flattening) with the reference's refill: fewer than K
valid candidates duplicate the best one (model.lua:421-436).

The (B*K, H) top hidden state is row-major identical to (B, K*H), so the
kernel takes K*H-wide rows and returns h~ in the same packed layout.
"""

from __future__ import annotations

from typing import Optional

import torch

from aocr_torch.ops import cuda
from aocr_torch.ops.cuda import decode_step

launches = 0

# A candidate the trie forbids scores NEG; a top-K pick at or below half
# of it is no valid candidate (aocr/decode.py::_apply_trie_and_topk).
NEG = -1e30


def topk_refill(total: torch.Tensor, K: int, refill: bool):
    """The top-K of each row of total (B, C), in lax.top_k's order:
    descending, ties to the lowest index.  With refill, picks <= NEG / 2
    take the first pick's score and index.  Returns (scores (B, K)
    float32, indices (B, K) int64, valid picks (B,) int32 or None)."""
    scores, idx = torch.sort(total, dim=-1, descending=True, stable=True)
    scores, idx = scores[:, :K].contiguous(), idx[:, :K].contiguous()
    if not refill:
        return scores, idx, None
    bad = scores <= NEG * 0.5
    nvalid = (K - bad.sum(dim=1)).to(torch.int32)
    scores = torch.where(bad, scores[:, :1], scores)
    idx = torch.where(bad, idx[:, :1], idx)
    return scores, idx, nvalid


def beam_totals(context_lbh, h_top_packed, prev_tokens, scores, w_a, w_c,
                pw_padded, pb_padded, K: int, V: int,
                valid: Optional[torch.Tensor] = None):
    """The plain step before the top-K: (h_tilde (B, K*H) float32, the
    scored candidates (B, K*V) float32, NEG where the plane forbids).
    Beam k's attention and projector are decode_step's on the batch rows'
    context, as the TPU kernel computes them."""
    cd = w_a.dtype
    B = prev_tokens.shape[0]
    H, vp = w_a.shape[0], pw_padded.shape[1]
    h = h_top_packed.to(cd).reshape(B, K, H)
    hts, totals = [], []
    for k in range(K):
        ht, logp = decode_step.attention_logp_tail(
            h[:, k], context_lbh, w_a, w_c, pw_padded, pb_padded, cd)
        hts.append(ht)
        tot = scores[:, k:k + 1] + decode_step.freeze_logp(
            logp[:, :V], prev_tokens[:, k])
        if valid is not None:
            ok = valid.reshape(B, K, vp)[:, k, :V] > 0
            tot = torch.where(ok, tot, torch.full_like(tot, NEG))
        totals.append(tot)
    return torch.cat(hts, dim=1), torch.cat(totals, dim=1)


def topk_margin(total: torch.Tensor, K: int) -> torch.Tensor:
    """The smallest gap between neighbours among the K+1 best valid
    candidates of each row (B,): a near-tie below it may order two
    versions of the top-K differently."""
    top = total.topk(min(K + 1, total.shape[1]), dim=-1).values
    gaps = top[:, :-1] - top[:, 1:]
    return torch.where(top[:, 1:] > NEG * 0.5, gaps,
                       torch.full_like(gaps, float("inf"))).min(dim=-1).values


def fused_beam_tail_plain(context_lbh, h_top_packed, prev_tokens, scores,
                          w_a, w_c, pw_padded, pb_padded, K: int, V: int,
                          valid: Optional[torch.Tensor] = None):
    """Plain PyTorch version; same arguments and results as
    fused_beam_tail."""
    htld, total = beam_totals(context_lbh, h_top_packed, prev_tokens, scores,
                              w_a, w_c, pw_padded, pb_padded, K, V, valid)
    new_scores, idx, nvalid = topk_refill(total, K, valid is not None)
    out = (htld, new_scores, (idx // V).to(torch.int32),
           (idx % V).to(torch.int32))
    return out + (nvalid,) if valid is not None else out


def fused_beam_tail(context_lbh: torch.Tensor, h_top_packed: torch.Tensor,
                    prev_tokens: torch.Tensor, scores: torch.Tensor,
                    w_a: torch.Tensor, w_c: torch.Tensor,
                    pw_padded: torch.Tensor, pb_padded: torch.Tensor, K: int,
                    V: int, valid: Optional[torch.Tensor] = None):
    """context_lbh (L, B, H) scan-major, compute dtype; h_top_packed
    (B, K*H); prev_tokens (B, K) int32; scores (B, K) float32; w_a, w_c,
    pw_padded (H, Vp) in the compute dtype, pb_padded (Vp,) float32
    (decode_step.pad_projector); valid an optional (B, K*Vp) float32 0/1
    trie plane.

    Returns (h_tilde (B, K*H) float32, new_scores (B, K) float32, parents
    (B, K) int32, tokens (B, K) int32), and with `valid` the valid-
    candidate count (B,) int32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    global launches
    if context_lbh.device.type == "cpu":
        return fused_beam_tail_plain(context_lbh, h_top_packed, prev_tokens,
                                     scores, w_a, w_c, pw_padded, pb_padded,
                                     K, V, valid)
    if context_lbh.device.type != "cuda":
        raise ValueError(f"fused_beam_tail: unsupported device "
                         f"{context_lbh.device}")
    L, B, H = context_lbh.shape
    Vp = pw_padded.shape[1]
    cd, dev = w_a.dtype, context_lbh.device
    if H % 4 or Vp % 4 or not 1 <= K <= V <= Vp:
        raise ValueError(f"fused_beam_tail: H={H}, Vp={Vp}, K={K}, V={V}")
    h = h_top_packed.to(cd).contiguous()
    cuda.check(context_lbh, "context_lbh", (L, B, H), cd, dev)
    cuda.check(h, "h_top_packed", (B, K * H), cd, dev)
    cuda.check(prev_tokens, "prev_tokens", (B, K), torch.int32, dev)
    cuda.check(scores, "scores", (B, K), torch.float32, dev)
    cuda.check(w_a, "w_a", (H, H), cd, dev)
    cuda.check(w_c, "w_c", (2 * H, H), cd, dev)
    cuda.check(pw_padded, "pw_padded", (H, Vp), cd, dev)
    cuda.check(pb_padded, "pb_padded", (Vp,), torch.float32, dev)
    if valid is not None:
        cuda.check(valid, "valid", (B, K * Vp), torch.float32, dev)
    h_tilde = torch.empty((B, K * H), dtype=torch.float32, device=dev)
    new_scores = torch.empty((B, K), dtype=torch.float32, device=dev)
    parents = torch.empty((B, K), dtype=torch.int32, device=dev)
    tokens = torch.empty((B, K), dtype=torch.int32, device=dev)
    nvalid = (torch.empty((B,), dtype=torch.int32, device=dev)
              if valid is not None else None)
    cuda.launch("beam_step", cd, dev, context_lbh.data_ptr(), h.data_ptr(),
                prev_tokens.data_ptr(), scores.data_ptr(), w_a.data_ptr(),
                w_c.data_ptr(), pw_padded.data_ptr(), pb_padded.data_ptr(),
                cuda.ptr(valid), h_tilde.data_ptr(), new_scores.data_ptr(),
                parents.data_ptr(), tokens.data_ptr(), cuda.ptr(nvalid), L,
                B, H, Vp, V, K)
    launches += 1
    out = (h_tilde, new_scores, parents, tokens)
    return out + (nvalid,) if valid is not None else out
