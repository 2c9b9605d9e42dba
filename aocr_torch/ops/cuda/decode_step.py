"""One greedy step after the LSTM stack in one kernel (csrc/decode_step.cu).

Replaces `aocr/ops/pallas/decode_step.py::fused_decode_tail` (and the
`attention_logp_tail` it shares with the whole-loop kernel): q = W_a h, a
float32 softmax over L, the context vector, h~ = tanh(W_c [ctx; h]), the
padded projector, float32 log-softmax, the PAD/EOS freeze and the argmax,
with the optional trie validity plane: a (B, Vp) float32 0/1 plane that
the caller gathers from the transition table and in which it bakes the
PAD rule (no PAD at t=1, PAD always valid later); invalid log-probs count
as -1e30 before the argmax, then the freeze (decode_step.py:115-128).

The kernel runs `beam_step`'s cluster step at K = 1 (csrc/
step_cluster.cuh, `plan` below): a cluster of up to 16 SMs owns a tile of
batch rows; each SM streams its column slices of W_a and W_c (greedy_loop's
packing, `pack_weights`, once a decode) and multiplies them with the
tile's rows on the tensor cores in bf16 or the CUDA cores in float32; the
attention, log-softmax, freeze and argmax are split by rows.  Where no
plan fits, or where ROUTE says so, the first port's kernel runs (the rows
route: a block of 4 batch rows streaming every weight), logged once per
shape.

The plain version mirrors the kernel's numerics, not the XLA route's:
scores and the context vector are float32 sums over the compute-dtype
context (`decoder.attention` rounds q and alpha to the compute dtype).
"""

from __future__ import annotations

import weakref
from typing import Optional, Tuple

import torch

from aocr_torch import vocab
from aocr_torch.ops import cuda
from aocr_torch.ops.cuda import beam_step
from aocr_torch.ops.mm import matmul
from aocr_torch.utils.tracing import PACK, span

launches = 0
# the rows route's launches (counted in `launches` too)
launches_rows = 0

# "auto": the cluster plan where one fits, else the rows route; "rows":
# the rows route at every shape (to hold the two kernels against each
# other)
ROUTE = "auto"

# launch plans held against the kernel's, by shape key: (beam_step.Plan or
# None for the rows route, the line logged for it)
plans: dict = {}

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


def freeze_logp(logp: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """A copy of logp (..., V) with logp[PAD] := 0 where prev (...) is PAD
    or EOS: a finished row or beam continues as PAD at no cost."""
    frozen = (prev == vocab.PAD) | (prev == vocab.EOS)
    logp = logp.clone()
    logp[..., vocab.PAD] = torch.where(frozen, torch.zeros_like(
        logp[..., vocab.PAD]), logp[..., vocab.PAD])
    return logp


def freeze_and_pick(logp: torch.Tensor, prev: torch.Tensor,
                    valid: Optional[torch.Tensor] = None):
    """The optional validity mask (logp := -1e30 where valid is not > 0),
    then the PAD/EOS freeze (logp[PAD] := 0 where prev is PAD or EOS), then
    the argmax (ties to the lowest index) and its value.  Returns (tokens
    (B,) int32, delta (B,) float32, the masked and frozen logp)."""
    if valid is not None:
        logp = torch.where(valid > 0, logp, torch.full_like(logp, -1e30))
    logp = freeze_logp(logp, prev)
    delta, tok = logp.max(dim=-1)
    return tok.to(torch.int32), delta, logp


def fused_decode_tail_plain(h_top, context_lbh, prev, w_a, w_c, pw_padded,
                            pb_padded, valid=None, packed=None, V=None):
    """Plain PyTorch version; same arguments and results as
    fused_decode_tail (`packed` and V, the kernel's operands, are not
    read)."""
    cd = w_a.dtype
    h_tilde, logp = attention_logp_tail(h_top.to(cd), context_lbh, w_a, w_c,
                                        pw_padded, pb_padded, cd)
    tok, delta, _ = freeze_and_pick(logp, prev, valid)
    return h_tilde, tok, delta


def plan(H: int, B: int, dtype: torch.dtype, L: int, Vp: int,
         active: int) -> Optional[beam_step.Plan]:
    """The kernel's cluster plan (csrc/decode_step.cu `ds_plan`) for
    hidden size H, batch B, the compute dtype, the context length L, the
    padded vocabulary Vp and the clusters of the plan's size the card runs
    at once (`active`): beam_step's plan at K = 1, nb = bt batch rows a
    tile; None (the rows route) where none fits."""
    return beam_step.plan(H, B, 1, dtype, L, Vp, active)


# batch rows a block of the rows route (csrc/decode_tail.cuh DEC_BT)
ROWS_BT = 4


def rows_smem(H: int, L: int, Vp: int, rows: int = ROWS_BT,
              extra: int = 0) -> int:
    """Dynamic shared memory bytes of a rows-route block of `rows` rows
    (csrc/decode_tail.cuh `TailSmemT::bytes`): 3H + L + Vp floats and 3
    words a row, then `extra` floats."""
    return 4 * (rows * (3 * H + L + Vp + 3) + extra)


def fits(H: int, B: int, dtype: torch.dtype, L: int, Vp: int) -> bool:
    """Whether a launch runs the shape: H a multiple of 4, and its cluster
    plan, or else a rows-route block within a block's shared memory."""
    from aocr_torch.ops.cuda import greedy_loop

    return H % 4 == 0 and (
        (ROUTE != "rows" and plan(H, B, dtype, L, Vp, 1) is not None)
        or rows_smem(H, L, Vp) <= greedy_loop.SMEM_MAX)


def checked_plan(H: int, B: int, cd: torch.dtype, L: int,
                 Vp: int) -> Optional[beam_step.Plan]:
    """The launch's route: its cluster plan, or None for the rows route,
    held against the kernel's own (`aocr_decode_step_plan`, all 0 for the
    rows route) on a shape's first launch and logged (`cuda.held_plan`;
    beam_step's at K = 1)."""
    return cuda.held_plan(
        "decode_step", (H, B, 1, cd, L, Vp),
        lambda out: cuda.library().aocr_decode_step_plan(
            H, B, int(cd == torch.float32), L, Vp, out), 11,
        lambda active: plan(H, B, cd, L, Vp, active),
        lambda p, active: beam_step.plan_line(
            "decode_step", p, active, H, B, 1, cd, L, Vp,
            "a block per 4 batch rows"),
        plans, rows=True)


def pack_weights(w_a: torch.Tensor, w_c: torch.Tensor,
                 context_lbh: torch.Tensor, pw_padded: torch.Tensor,
                 V: Optional[int] = None) -> Optional[dict]:
    """The cluster route's operands for a decode's shape, built once for
    all its steps: {"plan", "wq", "wc" (beam_step.packed_weights), "V"
    (the projector's real columns; Vp where not given), "scratch"}; None
    on the CPU and where the launches take the rows route.  The result is
    also kept for this context tensor and these weights (`remember`), so
    the steps of the decode find it there."""
    global packs
    if context_lbh.device.type != "cuda" or ROUTE == "rows":
        return None
    L, B, H = context_lbh.shape
    Vp, cd = pw_padded.shape[1], w_a.dtype
    p = checked_plan(H, B, cd, L, Vp)
    if p is None:
        return None
    V = Vp if V is None else V
    scratch = torch.empty((beam_step.scratch_bytes(p, cd, H, V),),
                          dtype=torch.uint8, device=context_lbh.device)
    packed = {"plan": p, **beam_step.packed_weights(w_a, w_c, p), "V": V,
              "scratch": scratch}
    packs += 1
    remember(context_lbh, w_a, w_c, packed)
    return packed


# packings done (a decode on the cluster route packs once)
packs = 0
# the packed operands of the decodes under way, by id of their context
# tensor: (weak references to the context, W_a and W_c; the packing).  A
# decode's steps are separate launches (and separate calls of the custom
# op, which takes tensors only), so its first step packs and the others
# find the packing here; an entry goes when its context tensor is freed,
# so a later decode, even with the same weight tensors changed in place,
# packs anew.
_packed: dict = {}


def remember(context_lbh: torch.Tensor, w_a: torch.Tensor,
             w_c: torch.Tensor, packed: dict) -> None:
    """Keep `packed` (pack_weights of these weights) for the steps of the
    decode over context_lbh."""
    key = id(context_lbh)

    def gone(ref, key=key):
        if _packed.get(key, (None,))[0] is ref:
            del _packed[key]

    _packed[key] = (weakref.ref(context_lbh, gone), weakref.ref(w_a),
                    weakref.ref(w_c), packed)


def recall(context_lbh: torch.Tensor, w_a: torch.Tensor, w_c: torch.Tensor,
           plan, V: int) -> Optional[dict]:
    """The packing remembered for this context tensor and these weights,
    of this plan and V; None where there is none."""
    e = _packed.get(id(context_lbh))
    if (e is None or e[0]() is not context_lbh or e[1]() is not w_a
            or e[2]() is not w_c or e[3]["plan"] != plan
            or e[3]["V"] != V):
        return None
    return e[3]


def fused_decode_tail(h_top: torch.Tensor, context_lbh: torch.Tensor,
                      prev: torch.Tensor, w_a: torch.Tensor,
                      w_c: torch.Tensor, pw_padded: torch.Tensor,
                      pb_padded: torch.Tensor,
                      valid: Optional[torch.Tensor] = None,
                      packed: Optional[dict] = None,
                      V: Optional[int] = None):
    """h_top (B, H); context_lbh (L, B, H) scan-major, compute dtype; prev
    (B,) int32; w_a (H, H), w_c (2H, H), pw_padded (H, Vp) in the compute
    dtype; pb_padded (Vp,) float32 (pad_projector); valid: an optional
    (B, Vp) float32 0/1 trie validity plane; V the projector's real
    columns (Vp where not given).  The cluster route's weight packing is
    made at a decode's first step and found by its later ones (`recall`);
    packed, `pack_weights` of these weights and this shape, is that
    packing made ahead (its V is used).

    Returns (h_tilde (B, H) float32, tokens (B,) int32, score_delta (B,)
    float32): the picked token's log-prob after the freeze, 0 for frozen
    rows.  Runs the custom op aocr_torch::fused_decode_tail (`op`): CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if h_top.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_decode_tail: unsupported device "
                         f"{h_top.device}")
    if packed is not None:
        remember(context_lbh, w_a, w_c, packed)
        V = packed["V"]
    return op(h_top, context_lbh, prev, w_a, w_c, pw_padded, pb_padded,
              valid, pw_padded.shape[1] if V is None else V)


@torch.library.custom_op("aocr_torch::fused_decode_tail", mutates_args=())
def op(h_top: torch.Tensor, context_lbh: torch.Tensor, prev: torch.Tensor,
       w_a: torch.Tensor, w_c: torch.Tensor, pw_padded: torch.Tensor,
       pb_padded: torch.Tensor, valid: Optional[torch.Tensor], V: int
       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fused_decode_tail as a custom op, so that torch.export traces a
    step as one node; the route and plan are picked, and the weights
    packed or recalled, here, from the real batch."""
    global launches, launches_rows
    if h_top.device.type == "cpu":
        return fused_decode_tail_plain(h_top, context_lbh, prev, w_a, w_c,
                                       pw_padded, pb_padded, valid)
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
    if valid is not None:
        cuda.check(valid, "valid", (B, Vp), torch.float32, dev)
    p = None if ROUTE == "rows" else checked_plan(H, B, cd, L, Vp)
    if p is None and not fits(H, B, cd, L, Vp):
        raise ValueError(f"fused_decode_tail: no route fits H={H}, B={B}, "
                         f"L={L}, Vp={Vp} in {cd}")
    w: dict = {}
    if p is not None:
        cuda.check_aligned(context_lbh=context_lbh)
        w = recall(context_lbh, w_a, w_c, p, V)
        if w is None:
            with span(PACK):
                w = pack_weights(w_a, w_c, context_lbh, pw_padded, V)
    h_tilde = torch.empty((B, H), dtype=torch.float32, device=dev)
    tok = torch.empty((B,), dtype=torch.int32, device=dev)
    delta = torch.empty((B,), dtype=torch.float32, device=dev)
    cuda.launch("decode_step", cd, dev, h.data_ptr(), context_lbh.data_ptr(),
                prev.data_ptr(), w_a.data_ptr(), w_c.data_ptr(),
                cuda.ptr(w.get("wq")), cuda.ptr(w.get("wc")),
                pw_padded.data_ptr(), pb_padded.data_ptr(), cuda.ptr(valid),
                h_tilde.data_ptr(), tok.data_ptr(), delta.data_ptr(),
                cuda.ptr(w.get("scratch")), L, B, H, Vp,
                V if p is not None else Vp, p.nb if p is not None else 0)
    launches += 1
    if p is None:
        launches_rows += 1
    return h_tilde, tok, delta


@op.register_fake
def _(h_top, context_lbh, prev, w_a, w_c, pw_padded, pb_padded, valid, V):
    B, H = h_top.shape
    return (h_top.new_empty((B, H), dtype=torch.float32),
            h_top.new_empty((B,), dtype=torch.int32),
            h_top.new_empty((B,), dtype=torch.float32))
