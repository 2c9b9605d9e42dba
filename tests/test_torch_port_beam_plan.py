"""The launch plans and the packed weights of aocr_torch's beam kernels
(csrc/beam_loop.cu and csrc/beam_step.cu on thread-block clusters), on
the CPU.

The kernels run only on the card; what their correctness rests on beside
the arithmetic is checked here in pure Python.  beam_loop, for every beam
width it takes (K 1..8), both dtypes, H in {128, 512, 1024, 2048} and B
in {1, 5, 17, 512, 513}: every tile holds whole batch rows (all K beams
of each), every batch row has exactly one tile and one owner block in
the row-split phases, the shared memory fits the H100's 232,448 bytes a
block, clusters = ceil(B / nb); shapes past the kernel get no plan and
the wrapper's plan check raises ValueError; the weights the kernel
streams are greedy_loop's packing, with the same slices.  beam_step, for
every K from 1 to V=39 and every B from 1 to 512 at the default decoder,
both dtypes: the same properties, and the shapes no cluster plan takes
(the rows route); and the kernel's split, each block's batch rows with
their top-K by K passes of argmax and mask (csrc/beam_tail.cuh), in
plain PyTorch, against aocr's fused_beam_tail in interpret mode at K 3,
9, 12 and 20 with a trie plane, refills and frozen rows.
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aocr import vocab
from aocr.ops.pallas import beam_step as jbs
from aocr.ops.pallas import decode_step as jds
from aocr_torch.ops.cuda import beam_loop, beam_step, decode_step, greedy_loop

ACTIVE = 7  # 16-SM clusters an H100 runs at once (cudaOccupancy...)
SMEM = 232448
L, VP, NL = 24, 128, 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [128, 512, 1024, 2048])
def test_beam_loop_plan_covers(dtype, H):
    for K in range(1, beam_loop.MAX_K + 1):
        for B in (1, 5, 17, 512, 513):
            p = beam_loop.plan(H, B, K, dtype, L, VP, NL, ACTIVE)
            assert p is not None, (H, B, K, dtype)
            assert 0 < p.smem <= SMEM
            assert p.nb >= 1 and p.nb * K <= p.bt and p.nb == p.bt // K
            assert p.clusters == -(-B // p.nb)
            assert p.units % 8 == 0 and p.kc % 16 == 0
            f32 = dtype == torch.float32
            assert (p.bt, p.rt) in {greedy_loop.tile(o, p.units, f32)
                                    for o in range(greedy_loop.TILES)}
            rows = [r for c in range(p.clusters) for r in p.batch_rows(c, B)]
            assert rows == list(range(B))
            owned = sorted(r for c in range(p.clusters) for s in range(p.cs)
                           for r in p.owned_batch_rows(c, s, B))
            assert owned == list(range(B))
            units = [u for s in range(p.cs) for u in p.unit_range(s, H)]
            assert units == list(range(H))
            assert beam_loop.scratch_bytes(p, dtype, H, NL, 39) % \
                greedy_loop.ALIGN == 0


def test_beam_loop_plan_fills_the_card():
    """At the serving batch (B=512, K=5) the default decoder's beam rows
    run in tiles of 16 batch rows x 5 beams (80 rows), 32 clusters; K=7
    takes a ragged tile (77 of 80 rows); one batch row takes one cluster
    of the narrowest tile."""
    for dtype in (torch.bfloat16, torch.float32):
        p = beam_loop.plan(1024, 512, 5, dtype, L, VP, NL, ACTIVE)
        assert (p.cs, p.units, p.bt, p.nb, p.clusters) == (16, 64, 80, 16,
                                                           32)
        q = beam_loop.plan(1024, 1, 5, dtype, L, VP, NL, ACTIVE)
        assert q.clusters == 1 and q.bt < p.bt
    p = beam_loop.plan(1024, 512, 7, torch.bfloat16, L, VP, NL, ACTIVE)
    assert (p.bt, p.nb, p.clusters) == (80, 11, 47)


def test_beam_loop_plan_refuses_past_the_kernel():
    """Beams past MAX_K (or none) and more than 512 units a block get no
    plan; the wrapper's plan check raises ValueError (on a CUDA tensor the
    wrapper never runs the plain version) before it touches the card."""
    for dtype in (torch.float32, torch.bfloat16):
        assert beam_loop.plan(1024, 4, beam_loop.MAX_K + 1, dtype, L, VP, NL,
                              ACTIVE) is None
        assert beam_loop.plan(8200, 1, 5, dtype, L, VP, NL, ACTIVE) is None
        assert beam_loop.plan(1024, 4, 0, dtype, L, VP, NL, ACTIVE) is None
        with pytest.raises(ValueError, match="no kernel plan"):
            beam_loop.checked_plan(1024, 4, 9, dtype, L, VP, NL)
        with pytest.raises(ValueError, match="no kernel plan"):
            beam_loop.checked_plan(8200, 1, 5, dtype, L, VP, NL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_beam_loop_packs_greedy_loop_weights(dtype):
    """The kernel streams greedy_loop.pack_weights' slices of the beam
    plan's geometry: the same tensors as for the greedy plan of that
    cluster, units and chunk, each block's slice holding its units."""
    rs = np.random.RandomState(5)
    H, E, V, nl = 132, 8, 39, 2
    u = lambda *s: torch.from_numpy(rs.uniform(-1, 1, s).astype(np.float32))
    layers = [{"wi": u(E + H if i == 0 else H, 4 * H), "wh": u(H, 4 * H),
               "bi": u(4 * H), "bh": u(4 * H)} for i in range(nl)]
    dec = {"embedding": u(V, E), "layers": layers, "w_a": u(H, H),
           "w_c": u(2 * H, H)}
    t = greedy_loop.build_tables(dec, {"w": u(H, V), "b": u(V)}, E, True,
                                 dtype)
    p = beam_loop.plan(H, 17, 5, dtype, 9, VP, nl, ACTIVE)
    g = greedy_loop.Plan(*p[:9])
    w = greedy_loop.pack_weights(t, p, nl, True)
    want = greedy_loop.pack_weights(t, g, nl, True)
    assert w.keys() == want.keys()
    for k in w:
        assert torch.equal(w[k], want[k]), k
    # block s's layer-0 slice: rows of wfh0, the block's units of gate i
    U, pad = p.units, 16 // torch.empty((), dtype=dtype).element_size()
    assert w["w0"].shape[-1] == 4 * U + pad
    for s in range(p.cs):
        cols = list(p.unit_range(s, H))
        for gate in range(4):
            got = w["w0"][s, 1, :H, gate * U:gate * U + len(cols)]
            ref = t["wfh0"][H:2 * H, [gate * H + c for c in cols]]
            assert torch.equal(got, ref), (s, gate)


def _check_beam_plan(p, B, K):
    """A plan's tiles hold whole batch rows with all K beams, and every
    batch row has one tile and one owner block."""
    assert 0 < p.smem <= SMEM
    assert p.nb >= 1 and p.nb * K <= p.bt and p.nb == p.bt // K
    assert p.clusters == -(-B // p.nb)
    assert p.units % 8 == 0 and p.kc % 16 == 0
    rows = [r for c in range(p.clusters) for r in p.batch_rows(c, B)]
    assert rows == list(range(B))
    owned = sorted(r for c in range(p.clusters) for s in range(p.cs)
                   for r in p.owned_batch_rows(c, s, B))
    assert owned == list(range(B))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_beam_step_plan_covers(dtype):
    """Every K from 1 to V=39 and every B from 1 to 512 at the default
    decoder (H=1024, L=24, Vp=40) take a cluster plan."""
    vp = decode_step.pad_projector(torch.zeros(1024, 39),
                                   torch.zeros(39))[0].shape[1]
    f32 = dtype == torch.float32
    for K in range(1, 40):
        for B in range(1, 513):
            p = beam_step.plan(1024, B, K, dtype, L, vp, ACTIVE)
            assert p is not None, (B, K, dtype)
            assert p.smem <= SMEM and p.nb * K <= p.bt
            assert p.clusters == -(-B // p.nb)
            assert (p.bt, p.rt) in {greedy_loop.tile(o, p.units, f32)
                                    for o in range(greedy_loop.TILES)}
        for B in (1, 7, 100, 512):
            p = beam_step.plan(1024, B, K, dtype, L, vp, ACTIVE)
            _check_beam_plan(p, B, K)
            assert beam_step.scratch_bytes(p, dtype, 1024, 39) % \
                greedy_loop.ALIGN == 0


def test_beam_step_plan_at_the_beam_shapes():
    """At B=512 the default decoder's K=5 beams run in tiles of 16 batch
    rows x 5 beams (32 clusters, as beam_loop), K=10 in tiles of 8 batch
    rows (bf16, 64 clusters); K=39 two batch rows a tile."""
    vp = 40
    for dtype in (torch.bfloat16, torch.float32):
        p = beam_step.plan(1024, 512, 5, dtype, L, vp, ACTIVE)
        assert (p.cs, p.units, p.bt, p.nb, p.clusters) == (16, 64, 80, 16, 32)
        q = beam_step.plan(1024, 512, 39, dtype, L, vp, ACTIVE)
        assert (q.bt, q.nb, q.clusters) == (80, 2, 256)
    p = beam_step.plan(1024, 512, 10, torch.bfloat16, L, vp, ACTIVE)
    assert (p.bt, p.nb, p.clusters) == (80, 8, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_beam_step_rows_route(dtype):
    """The shapes no cluster plan takes, which run the rows kernel: more
    beams than the largest tile (80 beam rows at H=1024), more than
    greedy_loop.MAX_UNITS units a block, and a card that runs no cluster
    of the size (no active clusters); every K the largest tile holds
    takes a plan at the default decoder."""
    assert beam_step.plan(1024, 4, 81, dtype, L, 128, ACTIVE) is None
    assert beam_step.plan(8200, 1, 5, dtype, L, VP, ACTIVE) is None
    assert beam_step.plan(1024, 4, 5, dtype, L, VP, 0) is None
    ks = [K for K in range(1, 100)
          if beam_step.plan(1024, 512, K, dtype, L, 128, ACTIVE)]
    assert ks == list(range(1, 81))


def _topk_passes(total, K, V, refill):
    """csrc/beam_tail.cuh's beam_topk_warp in plain PyTorch: K passes of
    argmax (ties to the first index) and mask over one batch row's K x V
    candidates; with refill a pick at or below -5e29 takes the first
    pick's score and index.  Returns (scores, parents, tokens, valid
    picks)."""
    t = total.clone()
    out, nbad = [], 0
    for j in range(K):
        raw = int(torch.argmax(t))
        best, idx = float(t[raw]), raw
        if j == 0:
            first = (best, idx)
        if refill and best <= -5e29:
            nbad += 1
            best, idx = first
        out.append((best, idx // V, idx % V))
        t[raw] = -float("inf")
    sc, par, tok = (torch.tensor(c) for c in zip(*out))
    return sc.float(), par.int(), tok.int(), K - nbad


@pytest.mark.parametrize("K", [3, 9, 12, 20])
def test_beam_step_split_matches_aocr(K):
    """The kernel's split in plain PyTorch (beam_totals for each beam,
    then each owner block's batch rows through _topk_passes, tile by
    tile) against aocr's fused_beam_tail in interpret mode, float32:
    h~ and scores within 1e-5, parents, tokens and valid counts equal,
    with a trie plane (row 0 one valid candidate, row 1 K - 1: refills),
    a frozen beam and a frozen row, and a ragged last tile."""
    rs = np.random.RandomState(K)
    H, Lc, V = 64, 5, 39
    # two tiles of the float32 plan, the last ragged
    B = beam_step.plan(H, 100, K, torch.float32, Lc, 40, ACTIVE).nb + 2
    # the init laws' scales (decoder.init_params)
    w_a = rs.uniform(-1, 1, (H, H)).astype(np.float32) * H ** -0.5
    w_c = rs.uniform(-1, 1, (2 * H, H)).astype(np.float32) * (2 * H) ** -0.5
    pw = rs.uniform(-1.5, 1.5, (H, V)).astype(np.float32)
    pb = rs.uniform(-1, 1, (V,)).astype(np.float32)
    ctx = rs.uniform(-1, 1, (Lc, B, H)).astype(np.float32)
    h = rs.uniform(-1, 1, (B, K * H)).astype(np.float32)
    prev = rs.randint(3, V, (B, K)).astype(np.int32)
    prev[2, 1], prev[3] = vocab.EOS, vocab.PAD
    scores = np.ascontiguousarray(
        np.sort(rs.uniform(-6, -1, (B, K)).astype(np.float32))[:, ::-1])
    ok = rs.uniform(size=(B, K, V)) < 0.3
    ok[:, :, vocab.PAD] = True
    ok[0] = False
    ok[0, 0, 7] = True
    ok[1] = False
    ok[1, :, 5][:K - 1] = True
    ok[1, 0, 5:5 + K - 1] = True
    ok[1, 1:] = False

    pw_j, pb_j = jds.pad_projector(jnp.asarray(pw), jnp.asarray(pb))
    vj = pw_j.shape[1]
    plane_j = np.zeros((B, K, vj), np.float32)
    plane_j[..., :V] = ok
    want = jbs.fused_beam_tail(
        jnp.asarray(ctx), jnp.asarray(h), jnp.asarray(prev),
        jnp.asarray(scores), jnp.asarray(w_a), jnp.asarray(w_c), pw_j, pb_j,
        K, V, interpret=True, valid=jnp.asarray(plane_j.reshape(B, -1)))
    want = [np.asarray(x) for x in want]

    tpw, tpb = decode_step.pad_projector(torch.from_numpy(pw),
                                         torch.from_numpy(pb))
    vp = tpw.shape[1]
    plane = torch.zeros((B, K, vp))
    plane[..., :V] = torch.from_numpy(ok).float()
    args = (torch.from_numpy(ctx), torch.from_numpy(h),
            torch.from_numpy(prev), torch.from_numpy(scores),
            torch.from_numpy(w_a), torch.from_numpy(w_c), tpw, tpb, K, V)
    htld, total = beam_step.beam_totals(*args, valid=plane.reshape(B, -1))
    p = beam_step.plan(H, B, K, torch.float32, Lc, vp, ACTIVE)
    assert p.clusters > 1 and B % p.nb  # several tiles, the last ragged
    got = [torch.zeros(B, K), torch.zeros(B, K, dtype=torch.int32),
           torch.zeros(B, K, dtype=torch.int32),
           torch.zeros(B, dtype=torch.int32)]
    seen = []
    for c in range(p.clusters):
        for s in range(p.cs):
            for b in p.owned_batch_rows(c, s, B):
                seen.append(b)
                sc, par, tok, nv = _topk_passes(total[b], K, V, True)
                got[0][b], got[1][b], got[2][b], got[3][b] = sc, par, tok, nv
    assert sorted(seen) == list(range(B))
    np.testing.assert_allclose(htld.numpy(), want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), want[1], rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(got[1:], want[2:]):
        np.testing.assert_array_equal(a.numpy(), b)
    assert got[3][0] == 1 and got[3][1] == K - 1 and (got[1][0] == 0).all()
    # the frozen row's best candidate: its best beam on PAD, score kept
    assert got[2][3, 0] == vocab.PAD and got[1][3, 0] == 0
    assert float(got[0][3, 0]) == float(scores[3, 0])


def test_beam_step_packs_greedy_loop_weights():
    """The cluster route streams greedy_loop.pack_weights' wq and wc
    slices."""
    rs = np.random.RandomState(7)
    H = 132
    u = lambda *s: torch.from_numpy(rs.uniform(-1, 1, s).astype(np.float32))
    t = {"wa": u(H, H), "wc": u(2 * H, H)}
    p = beam_step.plan(H, 17, 5, torch.float32, 9, VP, ACTIVE)
    w = beam_step.packed_weights(t["wa"], t["wc"], p)
    g = greedy_loop.pack_weights(
        dict(t, wfh0=u(2 * H, 4 * H), wx=u(1, 2 * H, 4 * H)), p, 2, True)
    assert torch.equal(w["wq"], g["wq"]) and torch.equal(w["wc"], g["wc"])
