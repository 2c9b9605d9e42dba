"""The launch plan and the packed weights of aocr_torch's greedy_loop
kernel (csrc/greedy_loop.cu on thread-block clusters), on the CPU.

The kernel runs only on the card; what its correctness rests on beside
the arithmetic is checked here in pure Python: every shape the previous
kernel took (H a multiple of 4, any B, one to three layers, input feed on
or off) gets a plan whose shared memory fits the H100's 232,448 bytes a
block, whose blocks own every hidden unit once and whose clusters and
row-split owners hold every batch row once; a shape past the kernel's
reach gets none (the wrapper raises); and the packed weight slices the
kernel streams hold, at each (block, row, column), the weight of the
build_tables operand it stands for, with zeros past H.
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import numpy as np
import pytest
import torch

from aocr_torch.ops.cuda import greedy_loop

ACTIVE = 7  # 16-SM clusters an H100 runs at once (cudaOccupancy...)
SMEM = 232448


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [4, 132, 256, 1020, 1024, 2048])
def test_greedy_loop_plan_covers(dtype, H):
    for B, nl in ((1, 1), (5, 2), (17, 3), (512, 2), (1000, 3)):
        p = greedy_loop.plan(H, B, dtype, 24, 128, nl, ACTIVE)
        assert p is not None, (H, B, dtype)
        assert p.smem <= SMEM
        assert p.units % 8 == 0 and p.kc % 16 == 0 and 2 <= p.stages <= 4
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
        for nl in (1, 2, 3):
            assert greedy_loop.scratch_bytes(p, dtype, H, nl, 39) % \
                greedy_loop.ALIGN == 0


def test_greedy_loop_plan_fills_the_card():
    """At the serving batch the default decoder runs in one wave of the
    clusters the card holds, with the widest tiles; a single row takes
    one cluster of the narrowest."""
    for dtype, bt in ((torch.bfloat16, 80), (torch.float32, 80)):
        p = greedy_loop.plan(1024, 512, dtype, 24, 128, 2, ACTIVE)
        assert (p.cs, p.units, p.bt, p.clusters) == (16, 64, bt, 7)
        q = greedy_loop.plan(1024, 1, dtype, 24, 128, 2, ACTIVE)
        assert q.clusters == 1 and q.bt < p.bt


def test_greedy_loop_plan_refuses_past_the_kernel():
    """The previous kernel's widest decoder (H=4,800 at L=24, Vp=128) gets
    a plan; more than 512 units a block gets none (the wrapper raises
    ValueError on a CUDA tensor, and never runs the plain version)."""
    for dtype in (torch.float32, torch.bfloat16):
        assert greedy_loop.plan(4800, 512, dtype, 24, 128, 2, ACTIVE) is not None
        assert greedy_loop.plan(8200, 1, dtype, 24, 128, 2, ACTIVE) is None


def _tables(rs, H, nl, input_feed, E=8, V=39):
    u = lambda *s: torch.from_numpy(rs.uniform(-1, 1, s).astype(np.float32))
    layers = [{"wi": u((E + H) if (i == 0 and input_feed) else
                       (E if i == 0 else H), 4 * H),
               "wh": u(H, 4 * H), "bi": u(4 * H), "bh": u(4 * H)}
              for i in range(nl)]
    dec = {"embedding": u(V, E), "layers": layers, "w_a": u(H, H),
           "w_c": u(2 * H, H)}
    return greedy_loop.build_tables(dec, {"w": u(H, V), "b": u(V)}, E,
                                    input_feed, torch.float32)


@pytest.mark.parametrize("H,B,nl,input_feed", [
    (132, 5, 2, True), (256, 40, 3, False), (36, 1, 1, True)])
def test_greedy_loop_packed_weights(H, B, nl, input_feed):
    """pack_weights' slices: block s, segment k, row k, column i*U + u
    holds the operand's weight of that row and unit s*U + u, zeros past
    H; a layer's segments are its own last h first, then the layer
    below's."""
    rs = np.random.RandomState(H + nl)
    t = _tables(rs, H, nl, input_feed)
    p = greedy_loop.plan(H, B, torch.float32, 9, 128, nl, ACTIVE)
    w = greedy_loop.pack_weights(t, p, nl, input_feed)
    U, hs = p.units, -(-H // p.kc) * p.kc

    def unpack(x, nq):
        """(cs, hs, nq*U + pad) -> (H, nq, H) of the blocks' units"""
        assert x.shape == (p.cs, hs, nq * U + 4)
        assert bool((x[:, H:] == 0).all()) and bool((x[..., nq * U:] == 0)
                                                    .all())
        y = x[:, :H, :nq * U].reshape(p.cs, H, nq, U).permute(1, 2, 0, 3)
        y = y.reshape(H, nq, p.cs * U)
        assert bool((y[..., H:] == 0).all())
        return y[..., :H]

    lstm = lambda m, r0: m[r0:r0 + H].reshape(H, 4, H)
    segs0 = [0, H] if input_feed else [0]
    assert w["w0"].shape[1] == len(segs0)
    for k, r0 in enumerate(segs0):
        assert torch.equal(unpack(w["w0"][:, k], 4), lstm(t["wfh0"], r0))
    assert w["wl"].shape[0] == nl - 1
    for l in range(nl - 1):
        for k, r0 in enumerate((H, 0)):
            assert torch.equal(unpack(w["wl"][l, :, k], 4),
                               lstm(t["wx"][l], r0))
    q = unpack(w["wq"], 2)
    assert torch.equal(q[:, 0], t["wa"]) and torch.equal(q[:, 1],
                                                         t["wc"][H:])
    assert torch.equal(unpack(w["wc"], 1)[:, 0], t["wc"][:H])


def _row_stages(p, esz, H, L, Vp):
    """Whether one tile row's context stages in the ring beside the row
    split's q rows, scores and logits (the row split's nb >= 1)."""
    R = -(-p.bt // p.cs)
    rows = -(-R * (H + L + Vp) * 4 // 16) * 16  # q rows, scores, logits
    room = greedy_loop.ring_bytes(p, esz) - rows
    return room >= L * H * esz


@pytest.mark.parametrize("dtype,bt,split,rows,stages", [
    (torch.bfloat16, 48, 8, 24, 5), (torch.float32, 16, 16, 16, 4)])
def test_greedy_loop_plan_splits_long_contexts(dtype, bt, split, rows,
                                               stages):
    """At im2markup's published shapes (H=512, L=1,240, one layer, Vp=512,
    B=256) no tile row's context stages in the ring, so the attention is
    split by positions: the tile's rows fall in row groups the warps hold
    (3 rows a warp at H=512), the ring holds `stages` positions of a
    group's rows beside their mbarriers, the slices cover the positions,
    the shared memory fits and the scratch holds every block's
    partials."""
    H, L, Vp, nl, B = 512, 1240, 512, 1, 256
    esz = torch.empty((), dtype=dtype).element_size()
    p = greedy_loop.plan(H, B, dtype, L, Vp, nl, ACTIVE)
    n = greedy_loop.split(p, esz, H, L, Vp)
    assert (p.bt, n, greedy_loop.split_rows(p, n)) == (bt, split, rows)
    assert 0 < p.smem <= SMEM
    assert not _row_stages(p, esz, H, L, Vp)
    ng = p.cs // n
    assert ng * n == p.cs and ng * rows >= p.bt
    assert rows <= greedy_loop.WARPS * greedy_loop.SPLIT_RW
    ring = greedy_loop.ring_bytes(p, esz)
    assert greedy_loop.split_stages(ring, rows * H * esz) == stages
    assert greedy_loop.SPLIT_BARS + stages * rows * H * esz <= ring
    assert -(-L // n) * n >= L
    assert greedy_loop.split_bytes(p, H, n) == \
        p.clusters * p.cs * rows * (H + 2) * 4
    assert greedy_loop.split_bytes(p, H, 0) == 0


# the default decoder's plans at L=24 (H=1024, 2 layers, Vp=128), as they
# were before the split attention
WORD_PLANS = {
    (torch.bfloat16, 512): (16, 64, 80, 5, 64, 3, 1, 200360, 7),
    (torch.bfloat16, 1): (16, 64, 16, 1, 128, 3, 1, 228744, 1),
    (torch.float32, 512): (16, 64, 80, 10, 32, 3, 1, 198824, 7),
    (torch.float32, 1): (16, 64, 8, 1, 64, 3, 1, 212712, 1)}


@pytest.mark.parametrize("dtype,B", list(WORD_PLANS))
def test_greedy_loop_plan_word_model_by_rows(dtype, B):
    """At the word model's shapes (L=24) a tile row's context stages in
    the ring: the plan is the row split's, field for field as before, and
    the attention is not split."""
    esz = torch.empty((), dtype=dtype).element_size()
    p = greedy_loop.plan(1024, B, dtype, 24, 128, 2, ACTIVE)
    assert tuple(p) == WORD_PLANS[(dtype, B)]
    assert greedy_loop.split(p, esz, 1024, 24, 128) == 0


@pytest.mark.parametrize("L,B,dtype,stages", [
    (3, 512, torch.bfloat16, True), (3, 1, torch.bfloat16, True),
    (3, 512, torch.float32, True), (3, 1, torch.float32, True),
    (79, 512, torch.bfloat16, False), (79, 1, torch.bfloat16, True),
    (79, 512, torch.float32, False), (79, 1, torch.float32, False)])
def test_greedy_loop_plan_keep_aspect(L, B, dtype, stages):
    """Keep-aspect contexts of the word model (H=1024, 2 layers): at L=3
    every row stages in the ring; at L=79 a row stages only in the one-row
    bf16 tile's ring.  Either way the attention stays split by rows: the
    warps hold q and the vector of rows of at most 512 units."""
    esz = torch.empty((), dtype=dtype).element_size()
    p = greedy_loop.plan(1024, B, dtype, L, 128, 2, ACTIVE)
    assert _row_stages(p, esz, 1024, L, 128) == stages
    assert greedy_loop.split(p, esz, 1024, L, 128) == 0
    assert tuple(p) == tuple(greedy_loop.plan(1024, B, dtype, 24, 128, 2,
                                              ACTIVE))
