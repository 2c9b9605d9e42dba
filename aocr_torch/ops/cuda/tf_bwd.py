"""The teacher-forced decoder backward recurrence in one kernel
(csrc/tf_bwd.cu).

Replaces `aocr/ops/pallas/tf_bwd.py::decoder_bwd_scan`: walking t = T-1..0
over the residuals of `decoder_fwd_scan(..., collect=True)`, it carries
only dattn and each layer's (dc, dh) in float32 and emits the per-step
cotangent stacks the weight gradients are batched from: per layer dgates,
and dh~ (pre-tanh), dq and dcvec in the compute dtype, dscore float32,
plus the layer-0 initial-state cotangents.  Each step is the TPU kernel's
chain: dh~ -> dcat -> dalpha and the softmax backward (from the float32
dcvec) -> dq (from the float32 dscore) -> dtop, then the layers from the
top down.

The kernel runs on tf_fwd's thread-block clusters
(csrc/decoder_cluster.cuh): each SM of a cluster owns H/cs units of every
carry, so its gate backward is elementwise, and computes its units'
columns of each product from its slice of the transposed weights
(`pack_weights`, at each call), after the left operand (dh~, dq, or a
layer's dgates) is exchanged through L2.
"""

from __future__ import annotations

from typing import Optional

import torch

from aocr_torch.ops import cuda
from aocr_torch.ops.cuda import greedy_loop
from aocr_torch.ops.cuda.greedy_loop import Plan
from aocr_torch.ops.cuda.lstm_bwd import gate_math_bwd
from aocr_torch.ops.mm import matmul

launches = 0

# launch plans held against the kernel's, by shape key: (Plan, the line
# logged for it)
plans: dict = {}


def _carry_bytes(p: Plan, nl: int) -> int:
    """csrc/tf_bwd.cu `tb_cbytes`: the carries in shared memory (dc and dh
    of each layer, dattn and the dh passed down, a block's units of each
    tile row), with cres."""
    return p.bt * (2 * nl + 2) * p.units * 4 if p.cres else 0


def _smem(p: Plan, esz: int, H: int, L: int, nl: int) -> int:
    """csrc/tf_bwd.cu `tf_bwd_smem`: the ring (stages sized for two column
    blocks of U), the carries and the mbarriers, with the attention
    backward's rows (R x (H + L) floats) overlaying the ring; 0 where they
    do not fit."""
    ring = greedy_loop.ring_bytes(p, esz, 2)
    if -(-p.bt // p.cs) * (H + L) * 4 > ring:
        return 0
    return ring + _carry_bytes(p, nl) + greedy_loop.BARS


def plan(H: int, B: int, dtype: torch.dtype, L: int, num_layers: int,
         active: int) -> Optional[Plan]:
    """The kernel's launch plan (csrc/tf_bwd.cu `tb_launch_plan`):
    greedy_loop.plan_fit with this kernel's shared memory."""
    esz = torch.empty((), dtype=dtype).element_size()
    return greedy_loop.plan_fit(H, B, dtype, active,
                                lambda q: _smem(q, esz, H, L, num_layers))


def scratch_bytes(p: Plan, dtype: torch.dtype, H: int,
                  num_layers: int) -> int:
    """Bytes of the kernel's zeroed scratch (csrc/tf_bwd.cu `tb_scratch`):
    the exchange planes in the compute dtype (dh~, dq and four dgates
    planes for each of min(nl, 2) layer parities), dcvec in float32 and,
    without cres, the carries, each region aligned to ALIGN bytes."""
    esz = torch.empty((), dtype=dtype).element_size()
    bp, hs = p.clusters * p.bt, -(-H // p.kc) * p.kc
    plane = p.clusters * (hs // p.kc) * p.bt * (p.kc + 16 // esz)
    sizes = ((2 + 4 * min(num_layers, 2)) * plane * esz, bp * hs * 4,
             0 if p.cres else bp * (2 * num_layers + 2) * H * 4)
    return sum(greedy_loop._round_up(n, greedy_loop.ALIGN) for n in sizes)


def pack_weights(wfh0: torch.Tensor, rest_w, wc: torch.Tensor,
                 wa: torch.Tensor, p: Plan, input_feed: bool) -> dict:
    """The kernel's weight operands: each block's slices of the transposed
    weights, contiguous, kc rows a chunk (greedy_loop.pack_into over W^T):
    w0 (cs, 4, hs, nq0*U + pad), layer 0's four gate segments of rows of
    wfh0^T, columns [dattn | dh0] (nq0 = 2) with input feed, else dh0;
    wl (nl-1, cs, 4, hs, 2U + pad) likewise of W_l^T, columns [dh of the
    layer below | dh_l]; wct (cs, hs, 2U + pad) W_c^T, columns [dcvec |
    dtop]; wat (cs, hs, U + pad) W_a^T.  One copy each."""
    H = wa.shape[0]
    new = lambda lead, nq: greedy_loop.packed(p, H, wa, lead, nq)
    w0 = new((p.cs, 4), 2 if input_feed else 1)
    greedy_loop.pack_into(w0, wfh0.t(), H, p)
    wl = new((len(rest_w), p.cs, 4), 2)
    for l, w in enumerate(rest_w):
        greedy_loop.pack_into(wl[l], w.t(), H, p)
    wct = new((p.cs, 1), 2)
    greedy_loop.pack_into(wct, wc.t(), H, p)
    wat = new((p.cs, 1), 1)
    greedy_loop.pack_into(wat, wa.t(), H, p)
    return {"w0": w0, "wl": wl, "wct": wct[:, 0], "wat": wat[:, 0]}


def checked_plan(H: int, B: int, cd: torch.dtype, L: int, nl: int) -> Plan:
    """The launch's plan: ValueError where none fits; on a shape's first
    launch held against the kernel's own (`cuda.held_plan`)."""
    if plan(H, B, cd, L, nl, 1) is None:
        raise ValueError(f"decoder_bwd_scan: no kernel plan fits H={H}, "
                         f"B={B}, L={L}, {nl} layers in {cd}")
    return cuda.held_plan(
        "tf_bwd", (H, B, cd, L, nl),
        lambda out: cuda.library().aocr_tf_bwd_plan(
            H, B, int(cd == torch.float32), L, nl, out), 10,
        lambda active: plan(H, B, cd, L, nl, active),
        lambda p, active: greedy_loop.plan_line(
            "tf_bwd", f"H={H} B={B} L={L} {cd}", p, active), plans)


def decoder_bwd_scan_plain(ctx_lbh, wfh0, rest_w, wc, wa, dys, htl, alpha,
                           ifog, cs, c0, input_feed: bool):
    """Plain PyTorch version; same arguments and results as
    decoder_bwd_scan."""
    cd = ctx_lbh.dtype
    nl, T, B, G = ifog.shape
    H = G // 4
    dev = dys.device
    ctx = ctx_lbh.float()
    f32 = torch.float32
    zeros = torch.zeros((B, H), dtype=f32, device=dev)
    dattn, dcs, dhs = zeros, [zeros] * nl, [zeros] * nl
    dg = torch.empty((nl, T, B, G), dtype=cd, device=dev)
    dht_st, dq_st, dcvec_st = (torch.empty((T, B, H), dtype=cd, device=dev)
                               for _ in range(3))
    dscore_st = torch.empty_like(alpha)
    c0 = c0.to(cd)
    for t in range(T - 1, -1, -1):
        dht = ((dattn + dys[t].float()) * (1.0 - htl[t] * htl[t])).to(cd)
        dcat = matmul(dht, wc.t())
        dcvec, dtop = dcat[:, :H], dcat[:, H:]
        a = alpha[t]
        tmp = a * torch.einsum("lbh,bh->bl", ctx, dcvec)
        dscore = tmp - a * tmp.sum(-1, keepdim=True)
        dq = torch.einsum("bl,lbh->bh", dscore, ctx).to(cd)
        dx = dtop + matmul(dq, wa.t())
        for l in range(nl - 1, -1, -1):
            if t > 0:
                cp = cs[l, t - 1]
            else:
                cp = c0 if l == 0 else torch.zeros_like(cs[l, 0])
            dgates, dcs[l] = gate_math_bwd(dhs[l] + dx, dcs[l],
                                           ifog[l, t].chunk(4, dim=-1),
                                           cs[l, t], cp)
            dg[l, t] = dgates.to(cd)
            if l > 0:
                dxh = matmul(dg[l, t], rest_w[l - 1].t())
                dx, dhs[l] = dxh[:, :H], dxh[:, H:]
            else:
                dah = matmul(dg[0, t], wfh0.t())
                if input_feed:
                    dattn, dhs[0] = dah[:, :H], dah[:, H:]
                else:
                    dhs[0] = dah
        dht_st[t], dq_st[t], dcvec_st[t] = dht, dq, dcvec.to(cd)
        dscore_st[t] = dscore
    return dg, dht_st, dq_st, dcvec_st, dscore_st, dcs[0], dhs[0]


def decoder_bwd_scan(ctx_lbh: torch.Tensor, wfh0: torch.Tensor, rest_w,
                     wc: torch.Tensor, wa: torch.Tensor, dys: torch.Tensor,
                     htl: torch.Tensor, alpha: torch.Tensor,
                     ifog: torch.Tensor, cs: torch.Tensor, c0: torch.Tensor,
                     input_feed: bool):
    """ctx_lbh (L, B, H), wfh0 (K0, 4H), rest_w (per layer above 0, (2H, 4H)),
    wc (2H, H), wa (H, H): the forward's operands, compute dtype, stored
    orientation.  dys (T, B, H) float32 cotangent of h~; htl (T, B, H)
    and alpha (T, B, L) float32, ifog (nl, T, B, 4H) and cs (nl, T, B, H)
    compute dtype: the forward's residuals; c0 (B, H) float32.

    Returns (dgates (nl, T, B, 4H), dht, dq, dcvec (T, B, H), all compute
    dtype; dscore (T, B, L) float32; dc0, dh0 (B, H) float32).  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    global launches
    if dys.device.type == "cpu":
        return decoder_bwd_scan_plain(ctx_lbh, wfh0, rest_w, wc, wa, dys,
                                      htl, alpha, ifog, cs, c0, input_feed)
    if dys.device.type != "cuda":
        raise ValueError(f"decoder_bwd_scan: unsupported device {dys.device}")
    L, B, H = ctx_lbh.shape
    nl, T = ifog.shape[:2]
    G = 4 * H
    cd, dev = ctx_lbh.dtype, dys.device
    f32 = torch.float32
    if H % 4 or nl != 1 + len(rest_w):
        raise ValueError(f"decoder_bwd_scan: H={H}, {nl} layers of "
                         f"residuals for {1 + len(rest_w)} of weights")
    p = checked_plan(H, B, cd, L, nl)
    cuda.check(ctx_lbh, "ctx_lbh", (L, B, H), cd, dev)
    cuda.check(wfh0, "wfh0", (2 * H if input_feed else H, G), cd, dev)
    for k, w in enumerate(rest_w):
        cuda.check(w, f"rest_w[{k}]", (2 * H, G), cd, dev)
    cuda.check(wc, "wc", (2 * H, H), cd, dev)
    cuda.check(wa, "wa", (H, H), cd, dev)
    cuda.check(dys, "dys", (T, B, H), f32, dev)
    cuda.check(htl, "htl", (T, B, H), f32, dev)
    cuda.check(alpha, "alpha", (T, B, L), f32, dev)
    cuda.check(ifog, "ifog", (nl, T, B, G), cd, dev)
    cuda.check(cs, "cs", (nl, T, B, H), cd, dev)
    cuda.check(c0, "c0", (B, H), f32, dev)
    cuda.check_aligned(ctx_lbh=ctx_lbh, dys=dys, htl=htl, ifog=ifog, cs=cs,
                       c0=c0)
    w = pack_weights(wfh0, rest_w, wc, wa, p, input_feed)
    dg = torch.empty((nl, T, B, G), dtype=cd, device=dev)
    dht, dq, dcvec = (torch.empty((T, B, H), dtype=cd, device=dev)
                      for _ in range(3))
    dscore = torch.empty((T, B, L), dtype=f32, device=dev)
    dc0 = torch.empty((B, H), dtype=f32, device=dev)
    dh0 = torch.empty((B, H), dtype=f32, device=dev)
    scratch = torch.zeros((scratch_bytes(p, cd, H, nl),), dtype=torch.uint8,
                          device=dev)
    cuda.launch("tf_bwd", cd, dev, ctx_lbh.data_ptr(), w["w0"].data_ptr(),
                w["wl"].data_ptr(), w["wct"].data_ptr(), w["wat"].data_ptr(),
                dys.data_ptr(), htl.data_ptr(), alpha.data_ptr(),
                ifog.data_ptr(), cs.data_ptr(), c0.data_ptr(), dg.data_ptr(),
                dht.data_ptr(), dq.data_ptr(), dcvec.data_ptr(),
                dscore.data_ptr(), dc0.data_ptr(), dh0.data_ptr(),
                scratch.data_ptr(), L, B, H, T, nl, int(input_feed))
    launches += 1
    return dg, dht, dq, dcvec, dscore, dc0, dh0
