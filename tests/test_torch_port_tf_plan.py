"""The launch plans and the packed weights of aocr_torch's teacher-forced
decoder kernels (csrc/tf_fwd.cu and csrc/tf_bwd.cu on thread-block
clusters), on the CPU.

The kernels run only on the card; what their correctness rests on beside
the arithmetic is checked here in pure Python: every shape the previous
kernels took (H a multiple of 4, any B, one to three layers) gets a plan
of each kernel whose shared memory fits the H100's 232,448 bytes a block,
whose blocks own every hidden unit once and whose clusters and row-split
owners hold every batch row once; the backward's packed slices of the
transposed weights hold, at each (block, gate segment, row, column), the
weight they stand for; and the backward's split by output columns (each
block's own gate backward on its units, the exchanged round(dgates) times
its slice of W^T) computes what decoder_bwd_scan_plain computes.
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import numpy as np
import pytest
import torch

from aocr_torch.ops.cuda import greedy_loop, tf_bwd, tf_fwd
from aocr_torch.ops.cuda.lstm_bwd import gate_math_bwd
from aocr_torch.ops.mm import matmul

ACTIVE = 7  # 16-SM clusters an H100 runs at once (cudaOccupancy...)
SMEM = 232448
KERNELS = {"tf_fwd": tf_fwd, "tf_bwd": tf_bwd}


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [4, 132, 256, 1020, 1024, 2048])
def test_tf_plan_covers(kernel, dtype, H):
    mod = KERNELS[kernel]
    for B in (1, 5, 17, 400, 1000):
        for nl in (1, 2, 3):
            p = mod.plan(H, B, dtype, 24, nl, ACTIVE)
            assert p is not None, (kernel, H, B, nl, dtype)
            assert p.smem <= SMEM
            assert p.units % 8 == 0 and p.kc % 16 == 0 and \
                2 <= p.stages <= 4
            units = [u for s in range(p.cs) for u in p.unit_range(s, H)]
            assert units == list(range(H))
            rows = [r for c in range(p.clusters) for r in p.row_range(c, B)]
            assert rows == list(range(B))
            owned = sorted(r for c in range(p.clusters) for s in range(p.cs)
                           for r in p.owned_rows(c, s, B))
            assert owned == list(range(B))
            if dtype == torch.bfloat16:
                assert p.bt == 16 * p.rt
                assert greedy_loop.warp_tiles(0, p.units // 8, p.rt) <= \
                    greedy_loop.TILES
            else:
                assert p.bt == greedy_loop.THREADS // (p.units // 2) * p.rt
            assert mod.scratch_bytes(p, dtype, H, nl) % \
                greedy_loop.ALIGN == 0


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_tf_plan_at_the_train_step(kernel):
    """The train step's decoder (H=1024, 2 layers, L=24) at B=400: bf16 in
    one wave of the 7 clusters the card holds, 64 rows a tile (448 rows;
    greedy's 80-row tile would leave 2 of the 7 idle); float32 in two
    waves of 13 tiles of 32 rows.  One row takes one cluster of the
    narrowest tile."""
    mod = KERNELS[kernel]
    p = mod.plan(1024, 400, torch.bfloat16, 24, 2, ACTIVE)
    assert (p.cs, p.units, p.bt, p.clusters) == (16, 64, 64, 7)
    p = mod.plan(1024, 400, torch.float32, 24, 2, ACTIVE)
    assert (p.cs, p.units, p.bt, p.clusters) == (16, 64, 32, 13)
    for dtype in (torch.float32, torch.bfloat16):
        q = mod.plan(1024, 1, dtype, 24, 2, ACTIVE)
        assert q.clusters == 1 and q.bt == (8 if dtype == torch.float32
                                             else 16)
    assert mod.plan(8200, 1, torch.float32, 24, 2, ACTIVE) is None


def _weights(rs, H, nl, input_feed):
    """wfh0, the upper layers' W, W_c and W_a at the init law's bound"""
    b = H ** -0.5
    u = lambda *s: torch.from_numpy(rs.uniform(-b, b, s).astype(np.float32))
    return (u(2 * H if input_feed else H, 4 * H),
            [u(2 * H, 4 * H) for _ in range(nl - 1)], u(2 * H, H), u(H, H))


@pytest.mark.parametrize("H,B,nl,input_feed", [
    (132, 5, 2, True), (128, 40, 3, False), (36, 1, 1, True)])
def test_tf_bwd_packed_weights(H, B, nl, input_feed):
    """pack_weights' slices of the transposed weights: block s, gate
    segment q, row k, column i*U + u holds W[i*H + s*U + u, q*H + k] (a
    numpy gather), zeros past H and in the padding."""
    rs = np.random.RandomState(H + nl)
    wfh0, rest_w, wc, wa = _weights(rs, H, nl, input_feed)
    p = tf_bwd.plan(H, B, torch.float32, 9, nl, ACTIVE)
    w = tf_bwd.pack_weights(wfh0, rest_w, wc, wa, p, input_feed)
    U, hs = p.units, -(-H // p.kc) * p.kc

    def want(m, nseg, nq):
        """(cs, nseg, hs, nq*U + 4): the gather of m's rows (output units)
        and columns (the contraction)"""
        m = m.numpy()
        out = np.zeros((p.cs, nseg, hs, nq * U + 4), np.float32)
        for s in range(p.cs):
            for u in range(U):
                if s * U + u >= H:
                    continue
                for q in range(nseg):
                    for i in range(nq):
                        out[s, q, :H, i * U + u] = \
                            m[i * H + s * U + u, q * H:(q + 1) * H]
        return out

    nq0 = 2 if input_feed else 1
    np.testing.assert_array_equal(w["w0"].numpy(), want(wfh0, 4, nq0))
    assert w["wl"].shape[0] == nl - 1
    for l in range(nl - 1):
        np.testing.assert_array_equal(w["wl"][l].numpy(),
                                      want(rest_w[l], 4, 2))
    np.testing.assert_array_equal(w["wct"].numpy(), want(wc, 1, 2)[:, 0])
    np.testing.assert_array_equal(w["wat"].numpy(), want(wa, 1, 1)[:, 0])


def _tf_case(rs, H, B, T, L, nl, input_feed):
    u = lambda lo, hi, *s: torch.from_numpy(rs.uniform(lo, hi, s)
                                            .astype(np.float32))
    wfh0, rest_w, wc, wa = _weights(rs, H, nl, input_feed)
    rest = [(w, u(-0.1, 0.1, 4 * H), u(-0.1, 0.1, 4 * H)) for w in rest_w]
    ctx = u(-1, 1, L, B, H)
    xp = u(-1, 1, T, B, 4 * H)
    c0, h0 = u(-1, 1, B, H), u(-1, 1, B, H)
    htl, _hs, ifog, cs, alpha, _cv = tf_fwd.decoder_fwd_scan_plain(
        ctx, wfh0, rest, wa, wc, xp, c0, h0, input_feed, True)
    dys = u(-1, 1, T, B, H)
    return (ctx, wfh0, rest_w, wc, wa, dys, htl, alpha, ifog, cs, c0,
            input_feed)


def _block_split_bwd(p, ctx, wfh0, rest_w, wc, wa, dys, htl, alpha, ifog,
                     cs, c0, input_feed):
    """csrc/tf_bwd.cu's step in plain PyTorch, float32: block s keeps the
    carries of its units and runs their gate backward; a product's left
    operand is the blocks' pieces put together (the exchange), and block s
    computes its units' output columns from its packed W^T slice."""
    nl, T, B, G = ifog.shape
    H = G // 4
    w = tf_bwd.pack_weights(wfh0, rest_w, wc, wa, p, input_feed)
    blocks = [p.unit_range(s, H) for s in range(p.cs)]
    blocks = [(s, slice(r.start, r.stop)) for s, r in enumerate(blocks)
              if len(r)]
    z = lambda: {s: torch.zeros(B, j.stop - j.start) for s, j in blocks}
    dc, dh = [z() for _ in range(nl)], [z() for _ in range(nl)]
    dattn, dx = z(), z()
    own = lambda s, j, x: x[..., :j.stop - j.start]
    whole = lambda parts: torch.cat([parts[s] for s, _ in blocks], -1)
    dg = torch.empty(nl, T, B, G)
    dht_st, dq_st, dcv_st = (torch.empty(T, B, H) for _ in range(3))
    dscore_st = torch.empty(T, B, ctx.shape[0])
    for t in range(T - 1, -1, -1):
        dht = whole({s: (dattn[s] + dys[t][:, j])
                     * (1 - htl[t][:, j] * htl[t][:, j]) for s, j in blocks})
        dcv = {}
        for s, j in blocks:
            out = matmul(dht, w["wct"][s, :H])
            dcv[s], dx[s] = own(s, j, out[:, :p.units]), \
                own(s, j, out[:, p.units:2 * p.units])
        dcvec = whole(dcv)
        a = alpha[t]
        tmp = a * torch.einsum("lbh,bh->bl", ctx, dcvec)
        dscore = tmp - a * tmp.sum(-1, keepdim=True)
        dq = torch.einsum("bl,lbh->bh", dscore, ctx)
        for s, j in blocks:
            dx[s] = dx[s] + own(s, j, matmul(dq, w["wat"][s, :H]))
        for l in range(nl - 1, -1, -1):
            parts = {}
            for s, j in blocks:
                acts = [ifog[l, t][:, q * H:(q + 1) * H][:, j]
                        for q in range(4)]
                cp = cs[l, t - 1][:, j] if t > 0 else (
                    c0[:, j] if l == 0 else torch.zeros_like(dx[s]))
                parts[s], dc[l][s] = gate_math_bwd(dh[l][s] + dx[s], dc[l][s],
                                                   acts, cs[l, t][:, j], cp)
            # the exchange: the blocks' units of each gate, side by side
            dgl = torch.cat([whole({s: parts[s][:, q * (j.stop - j.start):
                                                (q + 1) * (j.stop - j.start)]
                                    for s, j in blocks}) for q in range(4)],
                            -1)
            dg[l, t] = dgl
            slices = w["wl"][l - 1] if l > 0 else w["w0"]
            nq = 2 if l > 0 or input_feed else 1
            for s, j in blocks:
                # one sum over the four segments, as the kernel's stream
                out = matmul(dgl, slices[s, :, :H].reshape(G, -1))
                if nq == 1:
                    dh[0][s] = own(s, j, out[:, :p.units])
                    continue
                lo, hi = own(s, j, out[:, :p.units]), \
                    own(s, j, out[:, p.units:2 * p.units])
                if l > 0:
                    dx[s], dh[l][s] = lo, hi
                else:
                    dattn[s], dh[0][s] = lo, hi
        dht_st[t], dq_st[t], dcv_st[t], dscore_st[t] = dht, dq, dcvec, dscore
    return (dg, dht_st, dq_st, dcv_st, dscore_st, whole(dc[0]),
            whole(dh[0]))


@pytest.mark.parametrize("input_feed", [True, False])
def test_tf_bwd_block_split_matches_plain(input_feed):
    """The backward split the kernel's way (16 blocks of 8 units at H=128)
    equals decoder_bwd_scan_plain within 1e-6 of each output's scale in
    float32 (the products sum over the same axis in another blocking)."""
    H, B, T, L, nl = 128, 6, 5, 7, 2
    args = _tf_case(np.random.RandomState(5), H, B, T, L, nl, input_feed)
    p = tf_bwd.plan(H, B, torch.float32, L, nl, ACTIVE)
    assert (p.cs, p.units) == (16, 8)
    got = _block_split_bwd(p, *args)
    want = tf_bwd.decoder_bwd_scan_plain(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())
