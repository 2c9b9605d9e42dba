"""Input-feeding attention LSTM decoder (counterpart of
aocr/models/decoder.py: DecoderState, init_state, lstm_stack, attention,
attention_grouped, step, and the teacher-forced scan of training and
scoring).

Layer 1 takes [emb ; h~_prev] (input feed); the stacked layers use fused
[i|f|o|g] gates; attention is Luong "general" on the top hidden state,
h~ = tanh(W_c [ctx ; h_top]) with bias-free W_a and W_c.  The XLA-route
numerics are kept: q and alpha are rounded to the compute dtype before
their contractions (the fused kernels keep them in float32).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from aocr_torch.models.encoder import init_lstm_layer
from aocr_torch.ops import dropout as dropout_lib
from aocr_torch.ops import lstm
from aocr_torch.ops.cuda import tf_bwd, tf_fwd
from aocr_torch.ops.mm import matmul, outer_sum


class DecoderState(NamedTuple):
    attn: torch.Tensor             # (B, H) h~ of the previous step
    cs: Tuple[torch.Tensor, ...]   # per-layer cell states (B, H)
    hs: Tuple[torch.Tensor, ...]   # per-layer hidden states (B, H)


def init_params(gen: torch.Generator, vocab_size: int, embedding_size: int,
                num_hidden: int, num_layers: int, input_feed: bool,
                device="cpu") -> dict:
    embedding = torch.randn(vocab_size, embedding_size,
                            generator=gen).to(device)
    layers = [init_lstm_layer(
        gen, (embedding_size + (num_hidden if input_feed else 0))
        if i == 0 else num_hidden, num_hidden, device)
        for i in range(num_layers)]
    ba = 1.0 / math.sqrt(num_hidden)
    bc = 1.0 / math.sqrt(2 * num_hidden)
    u = lambda b, *s: ((torch.rand(*s, generator=gen) * 2 - 1) * b).to(device)
    return {"embedding": embedding, "layers": layers,
            "w_a": u(ba, num_hidden, num_hidden),
            "w_c": u(bc, 2 * num_hidden, num_hidden)}


def prepare(params: dict, cd: torch.dtype) -> dict:
    """Cast the loop-invariant weights to the compute dtype once per decode
    (XLA hoists the same casts and concats out of its decode loop)."""
    return {
        "embedding": params["embedding"],
        "layers": [{"w": torch.cat([l["wi"], l["wh"]], dim=0).to(cd),
                    "bi": l["bi"], "bh": l["bh"]} for l in params["layers"]],
        "w_a": params["w_a"].to(cd), "w_c": params["w_c"].to(cd),
    }


def init_state(dec_init, num_layers: int) -> DecoderState:
    """Layer 1 from the encoder finals; other layers and input feed zero."""
    c0, h0 = dec_init
    zeros = torch.zeros_like(c0)
    return DecoderState(attn=zeros,
                        cs=(c0,) + (zeros,) * (num_layers - 1),
                        hs=(h0,) + (zeros,) * (num_layers - 1))


def lstm_stack(prep: dict, state: DecoderState, tokens: torch.Tensor, *,
               input_feed: bool):
    """Embedding + input-feed concat + stacked LSTM layers: everything of a
    step before attention.  prep from `prepare`.  Returns (cs, hs, h_top)."""
    x = prep["embedding"][tokens.long()]
    if input_feed:
        x = torch.cat([x, state.attn.to(x.dtype)], dim=-1)
    cs, hs = [], []
    for i, layer in enumerate(prep["layers"]):
        c, h = lstm.lstm_step(layer["w"], layer["bi"], layer["bh"], x,
                              state.cs[i], state.hs[i])
        cs.append(c)
        hs.append(h)
        x = h
    return tuple(cs), tuple(hs), hs[-1]


def attention(prep: dict, h_top: torch.Tensor, context: torch.Tensor,
              simple: bool = False) -> torch.Tensor:
    """Luong-general attention over context (B, L, H); returns h~ (B, H)
    float32.  simple=True is the reference's additive variant
    h~ = ctx + h_top."""
    cd = prep["w_a"].dtype
    ctx_cd = context.to(cd)
    query = matmul(h_top.to(cd), prep["w_a"])
    scores = torch.einsum("blh,bh->bl", ctx_cd.float(),
                          query.to(cd).float())
    alpha = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bl,blh->bh", alpha.to(cd).float(), ctx_cd.float())
    if simple:
        return ctx + h_top.float()
    cat = torch.cat([ctx, h_top.float()], dim=-1)
    return torch.tanh(matmul(cat.to(cd), prep["w_c"]))


def attention_grouped(prep: dict, h_top: torch.Tensor, context: torch.Tensor,
                      simple: bool = False) -> torch.Tensor:
    """attention for beam search: K query rows h_top (B, K, H) per context
    row of context (B, L, H), as batched products against the unexpanded
    context (the reference's beam_replicate copies it to B*K rows,
    model.lua:322-359; no (B*K, L, H) tensor is built here).  Returns h~
    (B, K, H) float32."""
    cd = prep["w_a"].dtype
    ctx_cd = context.to(cd).float()
    query = matmul(h_top.to(cd), prep["w_a"])  # (B, K, H)
    scores = torch.einsum("blh,bkh->bkl", ctx_cd, query.to(cd).float())
    alpha = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkl,blh->bkh", alpha.to(cd).float(), ctx_cd)
    if simple:
        return ctx + h_top.float()
    cat = torch.cat([ctx, h_top.float()], dim=-1)
    return torch.tanh(matmul(cat.to(cd), prep["w_c"]))


def step(prep: dict, state: DecoderState, tokens: torch.Tensor,
         context: torch.Tensor, *, input_feed: bool, simple: bool = False):
    """One decode step from token ids: (new_state, h~ (B, H))."""
    cs, hs, h_top = lstm_stack(prep, state, tokens, input_feed=input_feed)
    h_tilde = attention(prep, h_top, context, simple)
    return DecoderState(attn=h_tilde, cs=cs, hs=hs), h_tilde


class TFCoreFn(torch.autograd.Function):
    """The teacher-forced scan with the reference's custom backward
    (aocr/models/decoder.py::_tf_core): the `tf_fwd` kernel stores the
    residual stacks, the `tf_bwd` kernel carries only the recurrent
    cotangents back through time, and every weight, bias and context
    gradient is a batched product over the whole sequence
    (decoder.py:453-477).  Inputs: meta = (input_feed, use_kernel); the
    compute-dtype weights wfh0 (K0, 4H), wa (H, H), wc (2H, H); xp
    (T, B, 4H) compute dtype; context (B, L, H); c0, h0 (B, H); then
    (w, bi, bh) of each layer above 0.  Returns h~ (T, B, H) float32."""

    @staticmethod
    def forward(ctx, meta, wfh0, wa, wc, xp, context, c0, h0, *rest_flat):
        input_feed, use_kernel = meta
        cd = wfh0.dtype
        rest = [tuple(rest_flat[i:i + 3]) for i in range(0, len(rest_flat), 3)]
        ctx_lbh = context.to(cd).transpose(0, 1).contiguous()
        fwd = (tf_fwd.decoder_fwd_scan if use_kernel
               else tf_fwd.decoder_fwd_scan_plain)
        htl, hs, ifog, cs, alpha, cvec = fwd(
            ctx_lbh, wfh0, rest, wa, wc, xp, c0.float().contiguous(),
            h0.float().contiguous(), input_feed, True)
        ctx.meta = (meta, context.dtype, xp.dtype, len(rest))
        ctx.save_for_backward(wfh0, wa, wc, ctx_lbh, c0, h0, htl, hs, ifog,
                              cs, alpha, cvec, *[w for w, _, _ in rest])
        return htl

    @staticmethod
    def backward(ctx, dys):
        (input_feed, use_kernel), ctx_dtype, xp_dtype, n_rest = ctx.meta
        (wfh0, wa, wc, ctx_lbh, c0, h0, htl, hs, ifog, cs, alpha, cvec,
         *rest_w) = ctx.saved_tensors
        cd = wfh0.dtype
        bwd = (tf_bwd.decoder_bwd_scan if use_kernel
               else tf_bwd.decoder_bwd_scan_plain)
        dg, dht, dq, dcvec, dscore, dc0, dh0 = bwd(
            ctx_lbh, wfh0, rest_w, wc, wa, dys.float().contiguous(), htl,
            alpha, ifog, cs, c0.float().contiguous(), input_feed)
        # the inputs of each step's matmuls, from the residual stacks
        h_prev0 = lstm.shift(hs[0], h0).to(cd)
        if input_feed:
            ah = torch.cat([lstm.shift(htl, torch.zeros_like(h0)).to(cd),
                            h_prev0], dim=-1)
        else:
            ah = h_prev0
        dwfh0 = outer_sum(ah, dg[0])
        drest = []
        for li in range(1, 1 + n_rest):
            xh = torch.cat([hs[li - 1],
                            lstm.shift(hs[li], torch.zeros_like(h0))],
                           dim=-1).to(cd)
            db = dg[li].float().sum((0, 1))
            drest += [outer_sum(xh, dg[li]).to(cd), db, db]
        h_top = hs[-1].to(cd)
        dwc = outer_sum(torch.cat([cvec.to(cd), h_top], dim=-1), dht)
        dwa = outer_sum(h_top, dq)
        q = matmul(h_top, wa).to(cd)
        dctx = (torch.einsum("tbl,tbh->blh", alpha.to(cd).float(),
                             dcvec.float())
                + torch.einsum("tbl,tbh->blh", dscore.to(cd).float(),
                               q.float()))
        return (None, dwfh0.to(cd), dwa.to(cd), dwc.to(cd),
                dg[0].to(xp_dtype), dctx.to(ctx_dtype), dc0, dh0, *drest)


def _identity(x):
    return x


def _per_step(params: dict, dec_init, targets: torch.Tensor,
              context: torch.Tensor, *, input_feed: bool, cd: torch.dtype,
              rate: float, keep, remat: bool, simple: bool, tp
              ) -> torch.Tensor:
    """The teacher-forced decode as aocr's scan body
    (aocr/models/decoder.py:657-695) a step at a time under plain
    autograd: the hoisted layer-0 projection, then per step the layer-0
    gates, the layers above with dropout on their inputs, the attention
    and dropout on h~.  keep: the masks (T, sites, B, H) of
    ops.dropout.masks, or None.  remat runs each step under
    torch.utils.checkpoint (aocr's jax.checkpoint(body)).

    tp: None, or the model axis of tensor parallelism
    (parallel.tensor_parallel.ModelAxis) with `params` this rank's shard:
    each gate product and the query are this rank's columns, gathered
    before the gate math and the scores; W_c multiplies this rank's rows
    of [ctx ; h_top] and the partial products are summed over the axis.
    Replicated inputs enter a product through `copy`, whose backward sums
    the ranks' partial cotangents."""
    if tp is None:
        copy = gather = scatter = reduce = _identity
    else:
        copy, gather, scatter, reduce = tp.copy, tp.gather, tp.scatter, \
            tp.reduce
    layer0 = params["layers"][0]
    E = params["embedding"].shape[1]
    # products take the compute-dtype values widened to float32 (mm.matmul
    # does the same), so a copy's cotangent sums over ranks in float32
    wide = lambda x: x.to(cd).float()  # noqa: E731
    emb = params["embedding"][targets.t().long()]  # (T, B, E) scan-major
    xp = matmul(copy(wide(emb)), layer0["wi"][:E].to(cd)) + layer0["bi"] \
        + layer0["bh"]
    xp = xp.to(cd)
    if input_feed:
        wfh0 = torch.cat([layer0["wi"][E:].to(cd), layer0["wh"].to(cd)], 0)
    else:
        wfh0 = layer0["wh"].to(cd)
    rest = [(torch.cat([l["wi"].to(cd), l["wh"].to(cd)], 0), l["bi"],
             l["bh"]) for l in params["layers"][1:]]
    wa, wc = params["w_a"].to(cd), params["w_c"].to(cd)
    nl = len(params["layers"])
    # the context in the compute dtype, widened once for every step
    ctx_f = context.to(cd).float()

    def body(attn, cs, hs, xp_t, keep_t):
        if input_feed:
            ah = torch.cat([wide(attn), wide(hs[0])], dim=-1)
        else:
            ah = wide(hs[0])
        gates = gather(xp_t + matmul(copy(ah), wfh0))
        c, h = lstm.gate_math(gates, cs[0])
        new_cs, new_hs = [c], [h]
        x = h
        for i, (w, bi, bh) in enumerate(rest, start=1):
            if keep_t is not None:
                x = dropout_lib.apply(x, keep_t[i - 1], rate)
            xh = torch.cat([wide(x), wide(hs[i])], dim=-1)
            gates = gather(matmul(copy(xh), w) + bi + bh)
            c, h = lstm.gate_math(gates, cs[i])
            new_cs.append(c)
            new_hs.append(h)
            x = h
        h_top = new_hs[-1]
        query = gather(matmul(copy(wide(h_top)), wa))
        scores = torch.einsum("blh,bh->bl", ctx_f, query.to(cd).float())
        alpha = torch.softmax(scores, dim=-1)
        cvec = torch.einsum("bl,blh->bh", alpha.to(cd).float(), ctx_f)
        if simple:
            h_tilde = cvec + h_top.float()
        else:
            cat = torch.cat([cvec, h_top.float()], dim=-1)
            h_tilde = torch.tanh(reduce(matmul(scatter(cat).to(cd), wc)))
        if keep_t is not None:
            h_tilde = dropout_lib.apply(h_tilde, keep_t[nl - 1], rate)
        return (h_tilde, *new_cs, *new_hs)

    state = init_state(dec_init, nl)
    attn, cs, hs = state.attn, state.cs, state.hs
    checkpointed = remat and torch.is_grad_enabled()
    hts = []
    for t in range(targets.shape[1]):
        args = (attn, cs, hs, xp[t], None if keep is None else keep[t])
        if checkpointed:
            out = checkpoint(body, *args, use_reentrant=False)
        else:
            out = body(*args)
        attn, cs, hs = out[0], tuple(out[1:1 + nl]), tuple(out[1 + nl:])
        hts.append(attn)
    return torch.stack(hts, dim=1)


def teacher_forced(params: dict, dec_init, targets: torch.Tensor,
                   context: torch.Tensor, *, input_feed: bool,
                   compute_dtype: torch.dtype = torch.float32,
                   dropout: float = 0.0, train: bool = False,
                   dropout_key=None, row_offset: int = 0,
                   remat: bool = False, simple: bool = False,
                   custom_grad: bool = True, use_kernel: bool = True,
                   tp=None) -> torch.Tensor:
    """Teacher-forced decode over targets (B, T) -> h~ (B, T, H) float32.

    The embedding part of layer 0's input projection is hoisted into one
    matmul over all T steps and stored in the compute dtype, with both
    layer-0 biases (decoder.py:608-618).  The route is aocr's choice
    (decoder.py:629-632): `TFCoreFn` (the tf_fwd / tf_bwd kernels, their
    plain versions with use_kernel=False), or the `tf_fwd` kernel alone
    where autograd does not record, unless custom_grad is off, remat or
    the simple attention is on, dropout applies (train with dropout > 0)
    or the weights are sharded over a model axis (tp); those run
    `_per_step` under plain autograd.

    Dropout draws its masks from dropout_key, the step key (two 32-bit
    words), for the global rows row_offset.. (ops/dropout.py); train
    with dropout > 0 and no key raises ValueError.  Eval ignores
    dropout."""
    cd = compute_dtype
    drop = train and dropout > 0.0
    if drop and dropout_key is None:
        raise ValueError("dropout>0 in train mode requires dropout_rng")
    if not custom_grad or remat or simple or drop or tp is not None:
        keep = None
        if drop:
            B, T = targets.shape
            rows = row_offset + torch.arange(B, device=targets.device)
            keep = dropout_lib.masks(dropout_key, rows, T,
                                     len(params["layers"]),
                                     params["w_a"].shape[0], dropout)
        return _per_step(params, dec_init, targets, context,
                         input_feed=input_feed, cd=cd, rate=dropout,
                         keep=keep, remat=remat, simple=simple, tp=tp)
    c0, h0 = dec_init
    layer0 = params["layers"][0]
    E = params["embedding"].shape[1]
    emb = params["embedding"][targets.t().long()]  # (T, B, E) scan-major
    xp = matmul(emb.to(cd), layer0["wi"][:E].to(cd)) + layer0["bi"] \
        + layer0["bh"]
    xp = xp.to(cd)
    if input_feed:
        wfh0 = torch.cat([layer0["wi"][E:].to(cd), layer0["wh"].to(cd)], 0)
    else:
        wfh0 = layer0["wh"].to(cd)
    rest = [(torch.cat([l["wi"].to(cd), l["wh"].to(cd)], 0), l["bi"],
             l["bh"]) for l in params["layers"][1:]]
    wa, wc = params["w_a"].to(cd), params["w_c"].to(cd)
    inputs = (wfh0, wa, wc, xp, context, c0, h0) + tuple(
        x for r in rest for x in r)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        htl = TFCoreFn.apply((input_feed, use_kernel), *inputs)
    else:
        fwd = (tf_fwd.decoder_fwd_scan if use_kernel
               else tf_fwd.decoder_fwd_scan_plain)
        htl = fwd(context.to(cd).transpose(0, 1).contiguous(),
                  wfh0.contiguous(), rest, wa, wc, xp,
                  c0.float().contiguous(), h0.float().contiguous(),
                  input_feed, False)
    return htl.transpose(0, 1)
