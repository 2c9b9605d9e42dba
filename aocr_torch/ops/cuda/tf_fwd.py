"""The teacher-forced decoder forward in one kernel (csrc/tf_fwd.cu).

Replaces `aocr/ops/pallas/tf_fwd.py::decoder_fwd_scan`, the training
mirror of the greedy loop: per step, layer 0 on [h~_prev; h_0] with the
hoisted input projection xp[t] added, the upper layers on
[h_{l-1}; h_l] plus both biases, then Luong attention and
h~ = tanh(W_c [ctx; h_top]) with q and alpha rounded to the compute
dtype before their contractions.  With collect it also writes the
residual stacks the backward (tf_bwd) reads.

The kernel runs on greedy_loop's thread-block clusters
(csrc/decoder_cluster.cuh): a cluster of up to 16 SMs owns a tile of bt
batch rows for all T steps, each SM owns H/cs hidden units of every layer
and the same columns of W_a and W_c, and streams its slices of the
weights (greedy_loop.pack_weights, at each call) by bulk copies,
multiplying on the tensor cores in bf16 and on the CUDA cores in
float32; the attention is split by rows.  `plan` mirrors the kernel's
launch plan; the wrapper holds the two equal on each shape's first
launch.

Numerics as the TPU kernel and the XLA scan body of
`aocr/models/decoder.py::_tf_core`: matmuls of compute-dtype operands
accumulate in float32, gate math and softmax in float32, the input-feed
carry h~ stays float32 and is rounded at the matmul.
"""

from __future__ import annotations

from typing import Optional

import torch

from aocr_torch.ops import cuda
from aocr_torch.ops import lstm
from aocr_torch.ops.cuda import greedy_loop
from aocr_torch.ops.cuda.greedy_loop import Plan
from aocr_torch.ops.mm import matmul

launches = 0

# launch plans held against the kernel's, by shape key: (Plan, the line
# logged for it)
plans: dict = {}


def _smem(p: Plan, esz: int, H: int, L: int, nl: int) -> int:
    """csrc/tf_fwd.cu `tf_fwd_smem`: the ring, the float tile, the cell
    states and the mbarriers, with the attention's rows (R x (H + L)
    floats) overlaying the ring; 0 where they do not fit."""
    ring = greedy_loop.ring_bytes(p, esz)
    if -(-p.bt // p.cs) * (H + L) * 4 > ring:
        return 0
    cells = p.bt * nl * p.units * 4 if p.cres else 0
    return ring + p.bt * (p.units + 8) * 4 + cells + greedy_loop.BARS


def plan(H: int, B: int, dtype: torch.dtype, L: int, num_layers: int,
         active: int) -> Optional[Plan]:
    """The kernel's launch plan for hidden size H, batch B, the compute
    dtype, the context length L and the decoder's layers, with `active`
    clusters on the card at once (csrc/tf_fwd.cu `tf_launch_plan`):
    greedy_loop.plan_fit with this kernel's shared memory (no projector,
    no tokens).  At the train step's B=400 in bf16 that is 7 clusters of
    64 rows, one wave."""
    esz = torch.empty((), dtype=dtype).element_size()
    return greedy_loop.plan_fit(H, B, dtype, active,
                                lambda q: _smem(q, esz, H, L, num_layers))


def scratch_bytes(p: Plan, dtype: torch.dtype, H: int,
                  num_layers: int) -> int:
    """Bytes of the kernel's zeroed scratch: greedy_loop's regions without
    the projector's (V = 0)."""
    return greedy_loop.scratch_bytes(p, dtype, H, num_layers, 0)


def checked_plan(H: int, B: int, cd: torch.dtype, L: int, nl: int) -> Plan:
    """The launch's plan: ValueError where none fits; on a shape's first
    launch held against the kernel's own (`cuda.held_plan`)."""
    if plan(H, B, cd, L, nl, 1) is None:
        raise ValueError(f"decoder_fwd_scan: no kernel plan fits H={H}, "
                         f"B={B}, L={L}, {nl} layers in {cd}")
    return cuda.held_plan(
        "tf_fwd", (H, B, cd, L, nl),
        lambda out: cuda.library().aocr_tf_fwd_plan(
            H, B, int(cd == torch.float32), L, nl, out), 10,
        lambda active: plan(H, B, cd, L, nl, active),
        lambda p, active: greedy_loop.plan_line(
            "tf_fwd", f"H={H} B={B} L={L} {cd}", p, active), plans)


def decoder_fwd_scan_plain(ctx_lbh, wfh0, rest, wa, wc, xp, c0, h0,
                           input_feed: bool, collect: bool):
    """Plain PyTorch version; same arguments and results as
    decoder_fwd_scan."""
    cd = ctx_lbh.dtype
    T, B, G = xp.shape
    H = G // 4
    nl = 1 + len(rest)
    dev = xp.device
    ctx = ctx_lbh.float()
    zeros = torch.zeros((B, H), dtype=torch.float32, device=dev)
    attn, cs, hs = zeros, [c0.float()] + [zeros] * (nl - 1), \
        [h0.float()] + [zeros] * (nl - 1)
    htl = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    if collect:
        hs_st = torch.empty((nl, T, B, H), dtype=cd, device=dev)
        ifog_st = torch.empty((nl, T, B, G), dtype=cd, device=dev)
        cs_st = torch.empty((nl, T, B, H), dtype=cd, device=dev)
        alpha_st = torch.empty((T, B, ctx.shape[0]), dtype=torch.float32,
                               device=dev)
        cvec_st = torch.empty((T, B, H), dtype=cd, device=dev)
    for t in range(T):
        ah = torch.cat([attn, hs[0]], -1) if input_feed else hs[0]
        x = xp[t].float() + matmul(ah.to(cd), wfh0)
        for l in range(nl):
            if l > 0:
                w, bi, bh = rest[l - 1]
                x = matmul(torch.cat([hs[l - 1], hs[l]], -1).to(cd), w) \
                    + bi + bh
            cs[l], hs[l], acts = lstm.gate_math_parts(x, cs[l])
            if collect:
                hs_st[l, t] = hs[l].to(cd)
                ifog_st[l, t] = torch.cat(acts, -1).to(cd)
                cs_st[l, t] = cs[l].to(cd)
        q = matmul(hs[-1].to(cd), wa).to(cd).float()
        alpha = torch.softmax(torch.einsum("lbh,bh->bl", ctx, q), dim=-1)
        cvec = torch.einsum("bl,lbh->bh", alpha.to(cd).float(), ctx)
        attn = torch.tanh(matmul(torch.cat([cvec, hs[-1]], -1).to(cd), wc))
        htl[t] = attn
        if collect:
            alpha_st[t] = alpha
            cvec_st[t] = cvec.to(cd)
    if collect:
        return htl, hs_st, ifog_st, cs_st, alpha_st, cvec_st
    return htl


def decoder_fwd_scan(ctx_lbh: torch.Tensor, wfh0: torch.Tensor, rest,
                     wa: torch.Tensor, wc: torch.Tensor, xp: torch.Tensor,
                     c0: torch.Tensor, h0: torch.Tensor, input_feed: bool,
                     collect: bool):
    """ctx_lbh (L, B, H) compute dtype, scan-major; wfh0 (K0, 4H) compute
    dtype, K0 = 2H with input feed ([Wi_feed; Wh] of layer 0) else H;
    rest, per layer above 0, (w (2H, 4H) compute dtype, bi, bh (4H,)
    float32); wa (H, H), wc (2H, H) compute dtype; xp (T, B, 4H) compute
    dtype, the hoisted input projection with both layer-0 biases; c0, h0
    (B, H) float32.

    Returns h~ (T, B, H) float32; with collect, also the residuals
    (hs (nl, T, B, H), ifog (nl, T, B, 4H), cs (nl, T, B, H), in the
    compute dtype; alpha (T, B, L) float32; cvec (T, B, H) compute dtype).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global launches
    if xp.device.type == "cpu":
        return decoder_fwd_scan_plain(ctx_lbh, wfh0, rest, wa, wc, xp, c0,
                                      h0, input_feed, collect)
    if xp.device.type != "cuda":
        raise ValueError(f"decoder_fwd_scan: unsupported device {xp.device}")
    L, B, H = ctx_lbh.shape
    T, G = xp.shape[0], 4 * H
    nl = 1 + len(rest)
    cd, dev = ctx_lbh.dtype, xp.device
    if H % 4 or T < 1:
        raise ValueError(f"decoder_fwd_scan: H={H}, T={T}")
    p = checked_plan(H, B, cd, L, nl)
    cuda.check(ctx_lbh, "ctx_lbh", (L, B, H), cd, dev)
    cuda.check(wfh0, "wfh0", (2 * H if input_feed else H, G), cd, dev)
    cuda.check(wa, "wa", (H, H), cd, dev)
    cuda.check(wc, "wc", (2 * H, H), cd, dev)
    cuda.check(xp, "xp", (T, B, G), cd, dev)
    cuda.check(c0, "c0", (B, H), torch.float32, dev)
    cuda.check(h0, "h0", (B, H), torch.float32, dev)
    cuda.check_aligned(ctx_lbh=ctx_lbh, xp=xp, c0=c0, h0=h0)
    wx, bi, bh = _stack_rest(rest, H, cd, dev)
    w = greedy_loop.pack_weights({"wfh0": wfh0, "wx": wx, "wa": wa,
                                  "wc": wc}, p, nl, input_feed)
    f32 = torch.float32
    htl = torch.empty((T, B, H), dtype=f32, device=dev)
    res = (torch.empty((nl, T, B, H), dtype=cd, device=dev),
           torch.empty((nl, T, B, G), dtype=cd, device=dev),
           torch.empty((nl, T, B, H), dtype=cd, device=dev),
           torch.empty((T, B, L), dtype=f32, device=dev),
           torch.empty((T, B, H), dtype=cd, device=dev)) if collect else None
    scratch = torch.zeros((scratch_bytes(p, cd, H, nl),), dtype=torch.uint8,
                          device=dev)
    cuda.launch("tf_fwd", cd, dev, ctx_lbh.data_ptr(), c0.data_ptr(),
                h0.data_ptr(), xp.data_ptr(), w["w0"].data_ptr(),
                w["wl"].data_ptr(), cuda.ptr(bi), cuda.ptr(bh),
                w["wq"].data_ptr(), w["wc"].data_ptr(), htl.data_ptr(),
                *(cuda.ptr(r) for r in (res or (None,) * 5)),
                scratch.data_ptr(), L, B, H, T, nl, int(input_feed))
    launches += 1
    return (htl,) + res if collect else htl


def _stack_rest(rest, H, cd, dev):
    """The weights of the layers above 0 (a list of (2H, 4H)) and their
    biases as (nl-1, 4H) stacks (None without such layers)."""
    for k, (w, bi, bh) in enumerate(rest):
        cuda.check(w, f"rest[{k}].w", (2 * H, 4 * H), cd, dev)
        cuda.check(bi, f"rest[{k}].bi", (4 * H,), torch.float32, dev)
        cuda.check(bh, f"rest[{k}].bh", (4 * H,), torch.float32, dev)
    if not rest:
        return [], None, None
    return ([w for w, _, _ in rest], torch.stack([b for _, b, _ in rest]),
            torch.stack([b for _, _, b in rest]))
