"""The launch plan and the packed weights of aocr_torch's beam_loop kernel
(csrc/beam_loop.cu on thread-block clusters), on the CPU.

The kernel runs only on the card; what its correctness rests on beside
the arithmetic is checked here in pure Python, for every beam width the
kernel takes (K 1..8), both dtypes, H in {128, 512, 1024, 2048} and B in
{1, 5, 17, 512, 513}: every tile holds whole batch rows (all K beams of
each), every batch row has exactly one tile and one owner block in the
row-split phases, the shared memory fits the H100's 232,448 bytes a
block, clusters = ceil(B / nb); shapes past the kernel get no plan and
the wrapper's plan check raises ValueError; the weights the kernel
streams are greedy_loop's packing, with the same slices.
"""

import numpy as np
import pytest
import torch

from aocr_torch.ops.cuda import beam_loop, greedy_loop

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
