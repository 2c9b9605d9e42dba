"""One greedy step after the LSTM stack in one kernel (csrc/decode_step.cu).

Replaces `aocr/ops/pallas/decode_step.py::fused_decode_tail` (and the
`attention_logp_tail` it shares with the whole-loop kernel): q = W_a h, a
float32 softmax over L, the context vector, h~ = tanh(W_c [ctx; h]), the
padded projector, float32 log-softmax, the PAD/EOS freeze and the argmax.
The trie validity plane is not ported yet.

The plain version mirrors the kernel's numerics, not the XLA route's:
scores and the context vector are float32 sums over the compute-dtype
context (`decoder.attention` rounds q and alpha to the compute dtype).
"""

from __future__ import annotations

from typing import Tuple

import torch

from aocr import vocab
from aocr_torch.ops import cuda
from aocr_torch.ops.mm import matmul

launches = 0

# Lane width the projector pads to (aocr/ops/pallas/decode_step.py PACK_VP).
PACK_VP = 128


def pad_projector(pw: torch.Tensor, pb: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad the (H, V) projector weight and (V,) bias to a multiple of
    PACK_VP columns; the padding gets a -1e30 bias, so it never wins the
    argmax and adds nothing to the log-softmax.  Returns (pw (H, Vp) in
    pw's dtype, pb (Vp,) float32)."""
    H, V = pw.shape
    vp = -(-V // PACK_VP) * PACK_VP
    pw_p = torch.zeros((H, vp), dtype=pw.dtype, device=pw.device)
    pw_p[:, :V] = pw
    pb_p = torch.full((vp,), -1e30, dtype=torch.float32, device=pb.device)
    pb_p[:V] = pb.float()
    return pw_p, pb_p


def attention_logp_tail(h, context, wa, wc, pw, pb, cd):
    """Plain attention + projector + log-softmax of the decode kernels.

    h (B, H); context (L, B, H) compute dtype; wa (H, H), wc (2H, H),
    pw (H, Vp) compute dtype; pb (Vp,) float32.
    Returns (h_tilde (B, H) float32, logp (B, Vp) float32)."""
    q = matmul(h.to(cd), wa)  # (B, H) float32
    ctxf = context.float()
    scores = torch.einsum("lbh,bh->lb", ctxf, q)
    sb = scores.t()  # (B, L)
    m = sb.max(dim=-1, keepdim=True).values
    e = torch.exp(sb - m)
    alpha = e / e.sum(dim=-1, keepdim=True)
    ctx = torch.einsum("bl,lbh->bh", alpha, ctxf)
    H = h.shape[-1]
    pre = matmul(ctx.to(cd), wc[:H]) + matmul(h.to(cd), wc[H:])
    h_tilde = torch.tanh(pre)
    logits = matmul(h_tilde.to(cd), pw) + pb
    m2 = logits.max(dim=-1, keepdim=True).values
    lse = m2 + torch.log(torch.exp(logits - m2).sum(dim=-1, keepdim=True))
    return h_tilde, logits - lse


def freeze_and_pick(logp: torch.Tensor, prev: torch.Tensor):
    """PAD/EOS freeze (logp[PAD] := 0 where prev is PAD or EOS), then the
    argmax (ties to the lowest index) and its value.  Returns (tokens
    (B,) int32, delta (B,) float32, the frozen logp)."""
    frozen = (prev == vocab.PAD) | (prev == vocab.EOS)
    logp = logp.clone()
    logp[:, vocab.PAD] = torch.where(frozen, torch.zeros_like(
        logp[:, vocab.PAD]), logp[:, vocab.PAD])
    delta, tok = logp.max(dim=-1)
    return tok.to(torch.int32), delta, logp


def fused_decode_tail_plain(h_top, context_lbh, prev, w_a, w_c, pw_padded,
                            pb_padded):
    """Plain PyTorch version; same arguments and results as
    fused_decode_tail."""
    cd = w_a.dtype
    h_tilde, logp = attention_logp_tail(h_top.to(cd), context_lbh, w_a, w_c,
                                        pw_padded, pb_padded, cd)
    tok, delta, _ = freeze_and_pick(logp, prev)
    return h_tilde, tok, delta


def fused_decode_tail(h_top: torch.Tensor, context_lbh: torch.Tensor,
                      prev: torch.Tensor, w_a: torch.Tensor,
                      w_c: torch.Tensor, pw_padded: torch.Tensor,
                      pb_padded: torch.Tensor):
    """h_top (B, H); context_lbh (L, B, H) scan-major, compute dtype; prev
    (B,) int32; w_a (H, H), w_c (2H, H), pw_padded (H, Vp) in the compute
    dtype; pb_padded (Vp,) float32 (pad_projector).

    Returns (h_tilde (B, H) float32, tokens (B,) int32, score_delta (B,)
    float32): the picked token's log-prob after the freeze, 0 for frozen
    rows.  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    global launches
    if h_top.device.type == "cpu":
        return fused_decode_tail_plain(h_top, context_lbh, prev, w_a, w_c,
                                       pw_padded, pb_padded)
    if h_top.device.type != "cuda":
        raise ValueError(f"fused_decode_tail: unsupported device "
                         f"{h_top.device}")
    L, B, H = context_lbh.shape
    Vp = pw_padded.shape[1]
    cd, dev = w_a.dtype, h_top.device
    if H % 4 or Vp % 4:
        raise ValueError(f"fused_decode_tail: H={H} and Vp={Vp} must be "
                         "multiples of 4")
    h = h_top.to(cd).contiguous()
    cuda.check(h, "h_top", (B, H), cd, dev)
    cuda.check(context_lbh, "context_lbh", (L, B, H), cd, dev)
    cuda.check(prev, "prev", (B,), torch.int32, dev)
    cuda.check(w_a, "w_a", (H, H), cd, dev)
    cuda.check(w_c, "w_c", (2 * H, H), cd, dev)
    cuda.check(pw_padded, "pw_padded", (H, Vp), cd, dev)
    cuda.check(pb_padded, "pb_padded", (Vp,), torch.float32, dev)
    h_tilde = torch.empty((B, H), dtype=torch.float32, device=dev)
    tok = torch.empty((B,), dtype=torch.int32, device=dev)
    delta = torch.empty((B,), dtype=torch.float32, device=dev)
    cuda.launch("decode_step", cd, dev, h.data_ptr(), context_lbh.data_ptr(),
                prev.data_ptr(), w_a.data_ptr(), w_c.data_ptr(),
                pw_padded.data_ptr(), pb_padded.data_ptr(),
                h_tilde.data_ptr(), tok.data_ptr(), delta.data_ptr(),
                L, B, H, Vp)
    launches += 1
    return h_tilde, tok, delta
