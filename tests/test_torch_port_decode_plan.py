"""The launch plan and the row split of aocr_torch's decode_step kernel
(csrc/decode_step.cu: beam_step's cluster step at K = 1 on thread-block
clusters), on the CPU.

The kernel runs only on the card; what its results rest on beside the
card is checked here.  The plan (`decode_step.plan`, beam_step's at K = 1)
covers every batch from 1 to 512 at the default decoder in both dtypes,
and the widths and batches around it, with tiles of whole rows, every
row in one tile and one owner block, the shared memory within an H100
block's; the shapes no cluster plan takes (H past 16 blocks of
greedy_loop.MAX_UNITS, a card that runs no such cluster) are the rows
route.  The kernel's split, emulated in plain PyTorch tile by tile and
owner block by owner block (each owner's rows through the attention and
log-softmax, the plane, the freeze and decode_tail.cuh's pick: the
first strict maximum from PAD at -inf, so NaN never wins and an all-NaN
row picks PAD), matches aocr's fused_decode_tail in interpret mode in
float32 with a trie plane, an all-invalid row, a frozen row, a ragged
last tile and an all-NaN row.
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aocr import vocab
from aocr.ops.pallas import decode_step as jds
from aocr_torch.ops.cuda import beam_step, decode_step, greedy_loop

ACTIVE = 7  # 16-SM clusters an H100 runs at once (cudaOccupancy...)
SMEM = 232448
L, VP = 24, 128


def _check_plan(p, B, dtype):
    """Tiles of whole rows (nb = bt), every row in one tile and one owner
    block of the row-split phases, the tile one of greedy_loop's, the
    shared memory within a block's."""
    f32 = dtype == torch.float32
    assert p is not None and p.nb == p.bt and p.smem <= SMEM
    assert p.clusters == -(-B // p.nb)
    assert (p.bt, p.rt) in {greedy_loop.tile(o, p.units, f32)
                            for o in range(greedy_loop.TILES)}
    assert p.units % 8 == 0 and p.kc % 16 == 0
    rows = [r for c in range(p.clusters) for r in p.batch_rows(c, B)]
    assert rows == list(range(B))
    owned = sorted(r for c in range(p.clusters) for s in range(p.cs)
                   for r in p.owned_batch_rows(c, s, B))
    assert owned == list(range(B))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_step_plan_covers(dtype):
    """Every batch from 1 to 512 at the default decoder (H=1024, L=24,
    Vp=128) takes a cluster plan, as do the widths around it; it is
    beam_step's plan at K = 1."""
    for B in range(1, 513):
        p = decode_step.plan(1024, B, dtype, L, VP, ACTIVE)
        assert p is not None, (B, dtype)
        assert p.smem <= SMEM and p.clusters == -(-B // p.nb)
        assert p == beam_step.plan(1024, B, 1, dtype, L, VP, ACTIVE)
    for B in (1, 7, 37, 100, 512):
        _check_plan(decode_step.plan(1024, B, dtype, L, VP, ACTIVE), B,
                    dtype)
    widest = 8192 if dtype == torch.float32 else 5120
    for H in (8, 64, 128, 256, 512, 2048, 4096, widest):
        for B in (1, 5, 65, 512, 2000):
            p = decode_step.plan(H, B, dtype, L, VP, ACTIVE)
            _check_plan(p, B, dtype)
            assert beam_step.scratch_bytes(p, dtype, H, 39) % \
                greedy_loop.ALIGN == 0


def test_decode_step_plan_at_the_recognize_shape():
    """At B=512 the default decoder's greedy steps run in 80-row tiles on
    7 clusters of 16 SMs, one wave; one image runs one 16-row tile
    (bf16) or 8-row tile (float32)."""
    for dtype in (torch.bfloat16, torch.float32):
        p = decode_step.plan(1024, 512, dtype, L, VP, ACTIVE)
        assert (p.cs, p.units, p.bt, p.clusters) == (16, 64, 80, 7)
    assert decode_step.plan(1024, 1, torch.bfloat16, L, VP, ACTIVE).bt == 16
    assert decode_step.plan(1024, 1, torch.float32, L, VP, ACTIVE).bt == 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_step_rows_route(dtype):
    """The shapes no cluster plan takes, which run the first port's rows
    kernel: more than greedy_loop.MAX_UNITS units a block (bf16: more
    than 320, past the 5 mma tiles a warp holds), and a card that runs no
    cluster of the size."""
    assert decode_step.plan(8200, 1, dtype, L, VP, ACTIVE) is None
    assert decode_step.plan(1024, 4, dtype, L, VP, 0) is None
    bf16 = decode_step.plan(5128, 1, torch.bfloat16, L, VP, ACTIVE)
    f32 = decode_step.plan(5128, 1, torch.float32, L, VP, ACTIVE)
    assert bf16 is None and f32 is not None


def _pick(x, ok, frozen):
    """decode_tail.cuh's projector_pick (csrc dc_pick_row) on one row of
    log-probs x (Vp): invalid tokens count -1e30 except PAD of a frozen
    row, then the first strict maximum from PAD at -inf (NaN never wins;
    ties to the lowest index).  Returns (token, value)."""
    keep = ok.clone()
    keep[vocab.PAD] |= frozen
    y = torch.where(keep, x, torch.full_like(x, -1e30))
    best, tok = -float("inf"), vocab.PAD
    for v in range(y.shape[0]):
        if float(y[v]) > best:  # NaN compares False
            best, tok = float(y[v]), v
    return tok, best


def test_decode_step_split_matches_aocr():
    """The kernel's split in plain PyTorch (attention_logp_tail on each
    owner block's rows, tile by tile, then the freeze and _pick) against
    aocr's fused_decode_tail in interpret mode, float32: h~ within 1e-5,
    tokens equal, deltas within 1e-6, with a trie plane, an all-invalid
    live row
    (PAD at -1e30), a frozen row (PAD at 0), a ragged last tile and an
    all-NaN row (PAD)."""
    rs = np.random.RandomState(11)
    H, Lc, V = 64, 5, 39
    # two tiles of the float32 plan, the last ragged
    B = decode_step.plan(H, 100, torch.float32, Lc, VP, ACTIVE).nb + 3
    w_a = rs.uniform(-1, 1, (H, H)).astype(np.float32) * H ** -0.5
    w_c = rs.uniform(-1, 1, (2 * H, H)).astype(np.float32) * (2 * H) ** -0.5
    pw = rs.uniform(-1.5, 1.5, (H, V)).astype(np.float32)
    pb = rs.uniform(-1, 1, (V,)).astype(np.float32)
    ctx = rs.uniform(-1, 1, (Lc, B, H)).astype(np.float32)
    h = rs.uniform(-1, 1, (B, H)).astype(np.float32)
    nan_row, dead_row, frozen_row = B - 2, 1, 2
    h[nan_row] = np.nan
    prev = rs.randint(3, V, (B,)).astype(np.int32)
    prev[frozen_row] = vocab.EOS
    ok = rs.uniform(size=(B, V)) < 0.3
    ok[:, vocab.PAD] = True
    ok[dead_row] = False
    ok[frozen_row] = False

    pw_j, pb_j = jds.pad_projector(jnp.asarray(pw), jnp.asarray(pb))
    assert pw_j.shape[1] == VP
    plane = np.zeros((B, VP), np.float32)
    plane[:, :V] = ok
    plane[nan_row] = 1.0  # every log-prob NaN after the plane too
    want = jds.fused_decode_tail(
        jnp.asarray(h), jnp.asarray(ctx), jnp.asarray(prev),
        jnp.asarray(w_a), jnp.asarray(w_c), pw_j, pb_j, interpret=True,
        valid=jnp.asarray(plane))
    want = [np.asarray(x) for x in want]

    tpw, tpb = decode_step.pad_projector(torch.from_numpy(pw),
                                         torch.from_numpy(pb))
    tplane = torch.from_numpy(plane)
    p = decode_step.plan(H, B, torch.float32, Lc, VP, ACTIVE)
    assert p.clusters == 2 and B % p.nb == 3  # the last tile ragged
    ht = torch.zeros(B, H)
    tok = torch.zeros(B, dtype=torch.int32)
    delta = torch.zeros(B)
    seen = []
    for c in range(p.clusters):
        for s in range(p.cs):
            own = list(p.owned_batch_rows(c, s, B))
            if not own:
                continue
            seen += own
            rows = torch.tensor(own)
            hts, logp = decode_step.attention_logp_tail(
                torch.from_numpy(h)[rows], torch.from_numpy(ctx)[:, rows],
                torch.from_numpy(w_a), torch.from_numpy(w_c), tpw, tpb,
                torch.float32)
            ht[rows] = hts
            for i, b in enumerate(own):
                frozen = int(prev[b]) in (vocab.PAD, vocab.EOS)
                x = logp[i].clone()
                if frozen:
                    x[vocab.PAD] = 0.0
                tok[b], delta[b] = _pick(x, tplane[b] > 0, frozen)
    assert sorted(seen) == list(range(B))
    fin = np.arange(B) != nan_row
    np.testing.assert_allclose(ht.numpy()[fin], want[0][fin], rtol=1e-5,
                               atol=1e-5)
    assert np.isnan(ht.numpy()[nan_row]).all()
    np.testing.assert_array_equal(tok.numpy(), want[1])
    # the log-softmax's float32 sums run in another order in each
    np.testing.assert_allclose(delta.numpy()[fin], want[2][fin], rtol=1e-6,
                               atol=1e-6)
    # the all-NaN row picks PAD (aocr's argmax takes its first NaN; its
    # delta is NaN there, the kernel's -inf)
    assert tok[nan_row] == vocab.PAD and delta[nan_row] == -float("inf")
    assert tok[dead_row] == vocab.PAD
    assert float(delta[dead_row]) == float(torch.tensor(-1e30))
    assert tok[frozen_row] == vocab.PAD and float(delta[frozen_row]) == 0.0
    live = [b for b in range(B) if b not in (nan_row, dead_row, frozen_row)]
    assert bool((tplane[live, tok[live].long()] > 0).all())


def test_decode_step_packs_greedy_loop_weights():
    """The cluster route streams beam_step's packing of W_a and W_c
    (greedy_loop.pack_weights' wq and wc slices) for the plan at K = 1;
    on the CPU there is nothing to pack."""
    rs = np.random.RandomState(5)
    H = 256
    w_a = torch.from_numpy(rs.uniform(-1, 1, (H, H)).astype(np.float32))
    w_c = torch.from_numpy(rs.uniform(-1, 1, (2 * H, H)).astype(np.float32))
    p = decode_step.plan(H, 33, torch.float32, L, VP, ACTIVE)
    got = beam_step.packed_weights(w_a, w_c, p)
    U, hs = p.units, greedy_loop._round_up(H, p.kc)
    for s in range(p.cs):
        units = list(p.unit_range(s, H))
        slab = got["wq"][s].reshape(hs, -1)
        np.testing.assert_array_equal(slab[:H, :len(units)].numpy(),
                                      w_a[:, units].numpy())
        np.testing.assert_array_equal(
            slab[:H, U:U + len(units)].numpy(), w_c[H:, units].numpy())
        slab = got["wc"][s].reshape(hs, -1)
        np.testing.assert_array_equal(slab[:H, :len(units)].numpy(),
                                      w_c[:H, units].numpy())
    ctx = torch.zeros(L, 33, H)
    assert decode_step.pack_weights(w_a, w_c, ctx, torch.zeros(H, VP)) \
        is None
