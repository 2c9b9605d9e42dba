"""aocr_torch's CUDA kernels against their plain PyTorch versions, on the
card.  Marked `cuda`; each test skips without a CUDA device.  This file
imports no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py

(`--noconftest`: tests/conftest.py configures jax).  Shapes are small
but keep the slice's structure: ragged batch tiles (B not a multiple of
the kernels' 4-row tiles), odd widths, both directions, both dtypes.
Tolerances: float32 1e-4 (the kernels sum in another order); bfloat16
outputs within a few bf16 steps.  The training kernels (conv1 backward,
lstm_fwd with residuals, lstm_bwd, tf_fwd, tf_bwd) are held the same way,
on residuals their plain forward wrote; tf_fwd and tf_bwd (thread-block
clusters) also at a ragged batch, one to three layers, without input
feed, the default width, and their plans against the kernels'.  conv1_pool
at one image, ragged runs and the serving batch, widths 2 to 200, two calls
bit-identical.  The beam kernels (beam_step,
beam_loop) and the trie operands of decode_step and greedy_loop: float32
tokens, parents, histories and refill counts identical to the plain
version's (a row may part only at a step whose plain margin is a
near-tie), scores within 1e-5 relative; bfloat16 as the decode checks.
beam_step (thread-block clusters since its redesign) also at K 1 to 39,
ragged tiles over several clusters, and one shape on its rows route.
beam_loop (thread-block clusters, as greedy_loop) also at its plan's
edges: ragged tiles, K up to 8, one batch row, several waves, a search
that ends at once, its plan against the kernel's, refused shapes.
greedy_loop (thread-block clusters) also at its plan's edges: ragged
tiles, masked units, one to three layers, no input feed, an early exit,
more tiles than one wave, the attention split by positions at
im2markup's L=1,240 (B=256 and 37, a trie, early exits); and a model
trained on the card must give the plain route's bf16 transcripts through
every decode kernel.
lstm_bwd also at its plan's edges (B=1, ragged tiles, the train step's
B=400, H=2400 by rows, distributed shared memory) and its refusals;
conv1_pool_bwd also at B=400 and ragged widths, two calls bit-identical;
a float32 train step through the kernels against the plain route.
The pool backward (pool_bwd, ReluPoolFn) is bit-identical to its plain
version and to autograd of F.max_pool2d over torch.relu, ties included;
conv1's image cotangent (conv1_pool_dx) within 1e-5 of its scale in
float32 and within one bfloat16 step per tap; the CLI trainer on the
card within 1e-4 of the same run on the CPU.
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aocr_torch import checkpoint, train, train_step, vocab
from aocr_torch.api import AttentionOCR
from aocr_torch.config import Config
from aocr_torch.models import cnn
from aocr_torch.models.decoder import DecoderState
from aocr_torch.ops.cuda import (beam_loop, beam_step, conv1_pool,
                                 conv1_pool_bwd, conv1_pool_dx, decode_step,
                                 greedy_loop, lstm_bwd, lstm_fwd, pool_bwd,
                                 tf_bwd, tf_fwd)
from aocr_torch.utils import trie

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
NEG_F32 = float(torch.tensor(-1e30))  # an invalid token's score


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(gen, *shape, lo=-1.0, hi=1.0):
    return torch.rand(*shape, generator=gen) * (hi - lo) + lo


def _close(got, want, tol):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("W", [100, 81, 2, 3, 200])
@pytest.mark.parametrize("B", [6, 1, 7, 512])
def test_conv1_pool_kernel(dev, dtype, W, B):
    """Against the plain version at odd and even widths, one image (runs
    of MIN_RUN cells), ragged runs, the serving batch (the card's blocks);
    the kernel's plan equals conv1_pool.plan (held at the launch), and
    two calls give the same bits."""
    g = torch.Generator().manual_seed(1)
    x = _rand(g, B, 32, W, 1).to(dev, dtype)
    w = _rand(g, 64, 1, 3, 3, lo=-0.3, hi=0.3).to(dev)
    b = _rand(g, 64, lo=-0.3, hi=0.3).to(dev)
    n = conv1_pool.launches
    got = conv1_pool.conv1_relu_pool(x, w, b)
    assert conv1_pool.launches == n + 1
    assert (B, 32, W, dtype) in conv1_pool.plans
    torch.cuda.synchronize()
    _close(got, conv1_pool.conv1_relu_pool_plain(x, w, b),
           TOL[dtype] if dtype == torch.float32 else 2 ** -7)
    assert torch.equal(got, conv1_pool.conv1_relu_pool(x, w, b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("H", [128, 256, 512, 200, 1024, 1030])
@pytest.mark.parametrize("B", [1, 6, 33, 400])
def test_lstm_fwd_kernel(dev, dtype, collect, reverse, H, B):
    """The cluster kernel against its plain version: ragged batch tiles
    (B=1, 6, 33, 400 against 4- to 32-row tiles), 16-block clusters whose
    last blocks own fewer units or none (H=200: 12 blocks of 16 units and
    one of 8; H=1030: 14 of 72, one of 22, one idle), the Wh slice
    resident (bf16 up to H=512) or partly streamed by the copy engine
    (float32 at H=512, H=1024) or, where its rows are no 16-byte
    multiple, by 4-byte cp.async (H=1030), both directions and both
    modes."""
    g = torch.Generator().manual_seed(2)
    wh, xp, c0, h0 = _lstm_case(g, dev, dtype, L=5, B=B, H=H)
    n, nc = lstm_fwd.launches, lstm_fwd.launches_collect
    got = lstm_fwd.lstm_fwd_scan(wh, xp, c0, h0, reverse, collect=collect)
    torch.cuda.synchronize()
    assert lstm_fwd.launches == n + 1
    assert lstm_fwd.launches_collect == nc + int(collect)
    want = lstm_fwd.lstm_fwd_scan_plain(wh, xp, c0, h0, reverse,
                                        collect=collect)
    flat = lambda o: (o[0], *o[1], *(o[2] if collect else ()))
    _close_all(flat(got), flat(want), TOL[dtype])


def test_lstm_fwd_kernel_float32_xproj(dev):
    """bf16 weights with a float32 x_proj (the xp_is_f32 route)."""
    g = torch.Generator().manual_seed(3)
    for B, H in ((33, 200), (6, 512)):
        wh, xp, c0, h0 = _lstm_case(g, dev, torch.bfloat16, L=5, B=B, H=H)
        xp = xp.float()
        got = lstm_fwd.lstm_fwd_scan(wh, xp, c0, h0, True, collect=True)
        torch.cuda.synchronize()
        want = lstm_fwd.lstm_fwd_scan_plain(wh, xp, c0, h0, True,
                                            collect=True)
        _close_all((got[0], *got[1], *got[2]), (want[0], *want[1], *want[2]),
                   TOL[torch.bfloat16])


def test_lstm_fwd_plan_matches_kernel(dev):
    """The wrapper's plan is the kernel's, field for field, and the card
    runs at least one cluster of every plan the tests launch."""
    import ctypes

    from aocr_torch.ops import cuda

    lib = cuda.library()
    for dtype, xd in ((torch.float32, torch.float32),
                      (torch.bfloat16, torch.bfloat16),
                      (torch.bfloat16, torch.float32)):
        for H in (2, 64, 128, 130, 200, 256, 512, 520, 1024, 1030, 2048,
                  2400, 2420):
            for B in (1, 6, 33, 400, 512):
                out = (ctypes.c_int * 9)()
                err = lib.aocr_lstm_fwd_plan(H, B, int(dtype == torch.float32),
                                             int(xd == torch.float32), out)
                assert err == 0, (H, B, dtype, xd, err)
                assert out[8] >= 1, (H, B, dtype, out[:])
                p = lstm_fwd.plan(H, B, dtype, out[8])
                assert tuple(out[:8]) == tuple(p), (H, B, dtype, out[:], p)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("H,B", [(2400, 8), (2420, 1), (2050, 33)])
def test_lstm_fwd_kernel_wide(dev, dtype, collect, H, B):
    """Past 128 units a block (H > 2048) bf16 warps hold 3 mma tiles: the
    kernel's second instance against the plain version."""
    g = torch.Generator().manual_seed(H + B)
    wh, xp, c0, h0 = _lstm_case(g, dev, dtype, L=3, B=B, H=H)
    n = lstm_fwd.launches
    got = lstm_fwd.lstm_fwd_scan(wh, xp, c0, h0, True, collect=collect)
    assert lstm_fwd.launches == n + 1
    torch.cuda.synchronize()
    want = lstm_fwd.lstm_fwd_scan_plain(wh, xp, c0, h0, True,
                                        collect=collect)
    flat = lambda o: (o[0], *o[1], *(o[2] if collect else ()))
    _close_all(flat(got), flat(want), TOL[dtype])


def test_lstm_fwd_unserved_shape_raises(dev):
    """A shape no plan fits raises ValueError; nothing falls back."""
    H = 4098
    assert lstm_fwd.plan(H, 4, torch.bfloat16, 1) is None
    wh = torch.zeros(H, 4 * H, device=dev, dtype=torch.bfloat16)
    xp = torch.zeros(2, 4, 4 * H, device=dev, dtype=torch.bfloat16)
    z = torch.zeros(4, H, device=dev)
    n = lstm_fwd.launches
    with pytest.raises(ValueError, match="no kernel plan"):
        lstm_fwd.lstm_fwd_scan(wh, xp, z, z, False)
    assert lstm_fwd.launches == n


def _decoder_tables(g, dev, dtype, H, V=39, E=8, nl=2, input_feed=True):
    # +-0.1 up to H=256, the init law's 1/sqrt(H) above (as _lstm_case):
    # wider layers at +-0.1 saturate every gate
    w = 0.1 if H <= 256 else H ** -0.5
    k0 = E + H if input_feed else E
    layers = [{"wi": _rand(g, k0 if i == 0 else H, 4 * H, lo=-w, hi=w),
               "wh": _rand(g, H, 4 * H, lo=-w, hi=w),
               "bi": _rand(g, 4 * H, lo=-w, hi=w),
               "bh": _rand(g, 4 * H, lo=-w, hi=w)} for i in range(nl)]
    dec = {"embedding": torch.randn(V, E, generator=g), "layers": layers,
           "w_a": _rand(g, H, H, lo=-w, hi=w),
           "w_c": _rand(g, 2 * H, H, lo=-w, hi=w)}
    proj = {"w": _rand(g, H, V, lo=-0.3, hi=0.3), "b": _rand(g, V)}
    move = lambda d: {k: ([{kk: vv.to(dev) for kk, vv in x.items()}
                           for x in v] if k == "layers" else v.to(dev))
                      for k, v in d.items()}
    return greedy_loop.build_tables(move(dec), move(proj), E, input_feed,
                                    dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", ["auto", "rows"])
@pytest.mark.parametrize("B", [6, 1, 512])
def test_decode_step_kernel(dev, dtype, route, B, monkeypatch):
    """Both routes (the cluster plan, the first port's rows kernel) against
    the plain version at one batch row, a ragged few and the serving
    batch; row 3 of the wider batches is all NaN and picks PAD, row 2
    (prev PAD) is frozen; the weights packed once (the decode's call)
    give the same bits as packed at the call."""
    g = torch.Generator().manual_seed(3)
    L, H = 9, 256
    t = _decoder_tables(g, dev, dtype, H)
    h = _rand(g, B, H)
    if B > 3:
        h[3] = float("nan")
    h = h.to(dev, dtype)
    ctx = _rand(g, L, B, H).to(dev, dtype)
    prev = torch.tensor([1, 2, 0, 5, 17, 1], dtype=torch.int32)
    prev = prev.repeat(-(-B // 6))[:B].to(dev)
    monkeypatch.setattr(decode_step, "ROUTE", route)
    args = (h, ctx, prev, t["wa"], t["wc"], t["pw"], t["pb"])
    assert decode_step.checked_plan(H, B, dtype, L, t["pw"].shape[1]) \
        is not None  # the rows route here only where asked for
    n, nr = decode_step.launches, decode_step.launches_rows
    ht, tok, d = decode_step.fused_decode_tail(*args)
    assert decode_step.launches == n + 1
    assert decode_step.launches_rows == nr + (route == "rows")
    torch.cuda.synchronize()
    ht_p, tok_p, d_p = decode_step.fused_decode_tail_plain(*args)
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    if B > 3:
        ok[3] = False
        assert int(tok[3]) == int(tok_p[3]) == vocab.PAD
        assert bool(torch.isnan(ht[3]).all())
    _close(ht[ok], ht_p[ok], TOL[dtype])
    _close(d[ok], d_p[ok], TOL[dtype])
    if B > 2:
        assert int(tok[2]) == vocab.PAD and float(d[2]) == 0.0
    if dtype == torch.float32:
        assert torch.equal(tok.cpu(), tok_p.cpu())
    if route == "auto":
        packed = decode_step.pack_weights(t["wa"], t["wc"], ctx, t["pw"],
                                          39)
        got = decode_step.fused_decode_tail(*args, packed=packed)
        for a, b in zip(got, (ht, tok, d)):
            assert torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 6])
def test_greedy_loop_kernel(dev, dtype, B):
    g = torch.Generator().manual_seed(4)
    L, H, T = 9, 256, 12
    t = _decoder_tables(g, dev, dtype, H)
    ctx = _rand(g, L, B, H).to(dev, dtype)
    c0, h0 = _rand(g, B, H).to(dev), _rand(g, B, H).to(dev)
    lab, sc = greedy_loop.fused_greedy_loop(ctx, c0, h0, t, 2, True, T)
    torch.cuda.synchronize()
    lab_p, sc_p, margin = greedy_loop.fused_greedy_loop_plain(
        ctx, c0, h0, t, 2, True, T, return_margins=True)
    lab, lab_p, margin = lab.cpu(), lab_p.cpu(), margin.cpu()
    # tokens agree up to the first step whose plain margin is a near-tie
    for r in range(B):
        diff = (lab[r] != lab_p[r]).nonzero()
        if len(diff):
            first = int(diff[0])
            assert margin[r, first] < TOL[dtype], (r, first, lab[r], lab_p[r])
        else:
            _close(sc[r], sc_p[r], 1e-3 if dtype == torch.float32 else 0.1)


def _greedy_agrees(lab, sc, lab_p, sc_p, margin, dtype):
    """Rows identical up to the first step whose plain margin is a
    near-tie (< TOL), PAD after EOS, and the scores of identical rows
    close; returns the rows that parted."""
    lab, lab_p, margin = lab.cpu(), lab_p.cpu(), margin.cpu()
    parted = 0
    for r in range(lab.shape[0]):
        diff = (lab[r] != lab_p[r]).nonzero()
        if len(diff):
            first = int(diff[0])
            assert margin[r, first] < TOL[dtype], (r, first, lab[r],
                                                   lab_p[r])
            parted += 1
        else:
            _close(sc[r], sc_p[r], 1e-3 if dtype == torch.float32 else 0.1)
    ended = (lab == vocab.EOS).cumsum(1) > 0
    after = torch.cat([torch.zeros_like(ended[:, :1]), ended[:, :-1]], 1)
    assert bool((lab[after] == vocab.PAD).all())
    return parted


def _greedy_case(g, dev, dtype, B, H, L=9, nl=2, input_feed=True):
    t = _decoder_tables(g, dev, dtype, H, nl=nl, input_feed=input_feed)
    ctx = _rand(g, L, B, H).to(dev, dtype)
    c0, h0 = _rand(g, B, H).to(dev), _rand(g, B, H).to(dev)
    return t, ctx, c0, h0


def test_greedy_loop_plan_matches_kernel(dev):
    """The wrapper's plan is the kernel's, field for field, and so is the
    attention's split; the card runs at least one cluster of each, and
    the plan's smem fits: at L=24 over widths, batches and layers, and at
    im2markup's L=1,240 (H=512, one layer, Vp=512), split."""
    import ctypes

    from aocr_torch.ops import cuda

    lib = cuda.library()
    shapes = [(H, B, nl, 24, 128) for H in (4, 132, 256, 1020, 1024, 2048)
              for B, nl in ((1, 1), (5, 2), (17, 3), (512, 2), (1000, 3))]
    shapes += [(512, B, 1, 1240, 512) for B in (256, 37)]
    for dtype in DTYPES:
        esz = torch.empty((), dtype=dtype).element_size()
        for H, B, nl, L, Vp in shapes:
            f32 = int(dtype == torch.float32)
            out = (ctypes.c_int * 10)()
            err = lib.aocr_greedy_loop_plan(H, B, f32, L, Vp, nl, out)
            assert err == 0, (H, B, dtype, err)
            assert out[9] >= 1, (H, B, dtype, out[:])
            p = greedy_loop.plan(H, B, dtype, L, Vp, nl, out[9])
            assert tuple(out[:9]) == tuple(p), (H, B, dtype, out[:], p)
            n = greedy_loop.split(p, esz, H, L, Vp)
            assert lib.aocr_greedy_loop_split(H, B, f32, L, Vp, nl) == n
            assert (n > 0) == (L == 1240), p


# (B, H, nl, input_feed, T): a ragged last tile, H not a multiple of
# 8 x cs (the last block's units masked), one and three layers, no input
# feed, and the default decoder's width
GREEDY_EDGES = [(37, 256, 2, True, 9), (5, 132, 2, True, 7),
                (90, 1020, 2, True, 6), (6, 256, 1, True, 8),
                (20, 256, 3, True, 8), (7, 256, 2, False, 8),
                (3, 1024, 2, True, 5)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,nl,input_feed,T", GREEDY_EDGES)
def test_greedy_loop_kernel_edges(dev, dtype, B, H, nl, input_feed, T):
    g = torch.Generator().manual_seed(B + H + nl)
    t, ctx, c0, h0 = _greedy_case(g, dev, dtype, B, H, nl=nl,
                                  input_feed=input_feed)
    n = greedy_loop.launches
    lab, sc = greedy_loop.fused_greedy_loop(ctx, c0, h0, t, nl, input_feed,
                                            T)
    assert greedy_loop.launches == n + 1
    torch.cuda.synchronize()
    lab_p, sc_p, margin = greedy_loop.fused_greedy_loop_plain(
        ctx, c0, h0, t, nl, input_feed, T, return_margins=True)
    parted = _greedy_agrees(lab, sc, lab_p, sc_p, margin, dtype)
    if dtype == torch.float32:
        assert parted == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_greedy_loop_kernel_early_exit(dev, dtype):
    """Every row emits EOS at step 1 (each tile leaves after it, the rest
    of the history PAD), and half the rows do (frozen rows beside live
    ones in one tile)."""
    g = torch.Generator().manual_seed(31)
    B, H, T = 40, 256, 9
    t, ctx, c0, h0 = _greedy_case(g, dev, dtype, B, H)
    for bias, every in ((60.0, True), (None, False)):
        tt = dict(t, pb=t["pb"].clone())
        if bias is None:  # the bias at which about half the rows stop
            lo, hi = -60.0, 60.0
            for _ in range(25):
                mid = (lo + hi) / 2
                tt["pb"][vocab.EOS] = t["pb"][vocab.EOS] + mid
                first, _ = greedy_loop.fused_greedy_loop_plain(
                    ctx, c0, h0, tt, 2, True, 1)
                if (first[:, 0] == vocab.EOS).float().mean() < 0.5:
                    lo = mid
                else:
                    hi = mid
            bias = hi
        tt["pb"][vocab.EOS] = t["pb"][vocab.EOS] + bias
        lab, sc = greedy_loop.fused_greedy_loop(ctx, c0, h0, tt, 2, True, T)
        torch.cuda.synchronize()
        lab_p, sc_p, margin = greedy_loop.fused_greedy_loop_plain(
            ctx, c0, h0, tt, 2, True, T, return_margins=True)
        _greedy_agrees(lab, sc, lab_p, sc_p, margin, dtype)
        stopped = (lab_p[:, 0] == vocab.EOS).cpu()
        if every:
            assert bool(stopped.all())
            assert bool((lab[:, 1:] == vocab.PAD).all())
        else:
            assert 0 < int(stopped.sum()) < B


@pytest.mark.parametrize("dtype", DTYPES)
def test_greedy_loop_kernel_waves(dev, dtype):
    """More tiles than the card runs clusters at once: the later waves
    start after the first leave, each with its own tile of rows."""
    import ctypes

    from aocr_torch.ops import cuda

    H, L, T = 256, 9, 6
    out = (ctypes.c_int * 10)()
    assert cuda.library().aocr_greedy_loop_plan(
        H, 1000, int(dtype == torch.float32), L, 128, 2, out) == 0
    active = out[9]
    # more rows than the clusters at once hold at the largest tile
    U = greedy_loop.plan(H, 1000, dtype, L, 128, 2, active).units
    most = (16 * greedy_loop.TILES if dtype == torch.bfloat16 else
            greedy_loop.THREADS // (U // 2) * greedy_loop.FMA_RT[-1])
    B = most * active + 3
    g = torch.Generator().manual_seed(33)
    t, ctx, c0, h0 = _greedy_case(g, dev, dtype, B, H, L=L)
    p = greedy_loop.plan(H, B, dtype, L, 128, 2, active)
    assert p.clusters > active
    lab, sc = greedy_loop.fused_greedy_loop(ctx, c0, h0, t, 2, True, T)
    torch.cuda.synchronize()
    lab_p, sc_p, margin = greedy_loop.fused_greedy_loop_plain(
        ctx, c0, h0, t, 2, True, T, return_margins=True)
    parted = _greedy_agrees(lab, sc, lab_p, sc_p, margin, dtype)
    if dtype == torch.float32:
        assert parted == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,L,V", [(3, 150, 39), (100, 9, 2000)])
def test_greedy_loop_kernel_wide_operands(dev, dtype, B, L, V):
    """A context too long to stage in shared memory (the attention reads
    it from global memory) and a vocabulary whose projector slice does
    not fit the ring (the partial logits read it from global memory), at
    the default decoder's width."""
    g = torch.Generator().manual_seed(L + V)
    H, T = 1024, 5
    t = _decoder_tables(g, dev, dtype, H, V=V)
    ctx = _rand(g, L, B, H).to(dev, dtype)
    c0, h0 = _rand(g, B, H).to(dev), _rand(g, B, H).to(dev)
    lab, sc = greedy_loop.fused_greedy_loop(ctx, c0, h0, t, 2, True, T)
    torch.cuda.synchronize()
    lab_p, sc_p, margin = greedy_loop.fused_greedy_loop_plain(
        ctx, c0, h0, t, 2, True, T, return_margins=True)
    parted = _greedy_agrees(lab, sc, lab_p, sc_p, margin, dtype)
    if dtype == torch.float32:
        assert parted == 0


def _markup_trie(dev, V, nodes=64, fan=12, seed=5):
    """A random (nodes, V) transition table over an im2markup-sized
    vocabulary: each node has `fan` children among the tokens past EOS
    and, at every third node, an EOS edge."""
    rs = np.random.RandomState(seed)
    table = np.full((nodes, V), -1, np.int32)
    for n in range(nodes):
        kids = rs.choice(np.arange(3, V), fan, replace=False)
        table[n, kids] = rs.randint(0, nodes, fan)
        if n % 3 == 0:
            table[n, vocab.EOS] = n
    return torch.from_numpy(table).to(dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [256, 37])
@pytest.mark.parametrize("with_trie", [False, True])
def test_greedy_loop_kernel_split_attention(dev, dtype, B, with_trie):
    """im2markup's decode (L=1,240, H=512, one layer, V=503, T=150): the
    attention split by positions against the plain version, at the cell's
    B=256 and a ragged B=37, with and without a trie; launches_split
    counts each such launch, and none at L=24."""
    g = torch.Generator().manual_seed(B + 40 * with_trie)
    H, L, V, T = 512, 1240, 503, 150
    t = _decoder_tables(g, dev, dtype, H, V=V, E=80, nl=1)
    ctx = _rand(g, L, B, H).to(dev, dtype)
    c0, h0 = _rand(g, B, H).to(dev), _rand(g, B, H).to(dev)
    table = _markup_trie(dev, V) if with_trie else None
    Vp, esz = t["pw"].shape[1], torch.empty((), dtype=dtype).element_size()
    assert greedy_loop.split(greedy_loop.plan(H, B, dtype, L, Vp, 1, 1), esz,
                             H, L, Vp)
    n, ns = greedy_loop.launches, greedy_loop.launches_split
    lab, sc = greedy_loop.fused_greedy_loop(ctx, c0, h0, t, 1, True, T,
                                            trie_table=table)
    assert (greedy_loop.launches, greedy_loop.launches_split) == (n + 1,
                                                                  ns + 1)
    torch.cuda.synchronize()
    lab_p, sc_p, margin = greedy_loop.fused_greedy_loop_plain(
        ctx, c0, h0, t, 1, True, T, return_margins=True, trie_table=table)
    _greedy_agrees(lab, sc, lab_p, sc_p, margin, dtype)
    if with_trie:
        nodes = torch.zeros(B, dtype=torch.int64)
        tab = table.cpu().long()
        for step in range(T):
            tok = lab[:, step].cpu().long()
            live = tok != vocab.PAD
            ok = tab[nodes, tok] >= 0
            assert bool(ok[live].all()), step
            nodes = torch.where(live, tab[nodes, tok].clamp(min=0), nodes)
    t24, ctx24, c24, h24 = _greedy_case(g, dev, dtype, 6, 256)
    greedy_loop.fused_greedy_loop(ctx24, c24, h24, t24, 2, True, 4)
    assert (greedy_loop.launches, greedy_loop.launches_split) == (n + 2,
                                                                  ns + 1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_greedy_loop_kernel_split_early_exit(dev, dtype):
    """The split attention's tiles leave together: every row emits EOS at
    step 1 (the rest of the history PAD), and about half the rows do."""
    g = torch.Generator().manual_seed(41)
    B, H, L, V, T = 37, 512, 1240, 503, 12
    t = _decoder_tables(g, dev, dtype, H, V=V, E=80, nl=1)
    ctx = _rand(g, L, B, H).to(dev, dtype)
    c0, h0 = _rand(g, B, H).to(dev), _rand(g, B, H).to(dev)
    for bias, every in ((60.0, True), (None, False)):
        tt = dict(t, pb=t["pb"].clone())
        if bias is None:  # the bias at which about half the rows stop
            lo, hi = -60.0, 60.0
            for _ in range(25):
                mid = (lo + hi) / 2
                tt["pb"][vocab.EOS] = t["pb"][vocab.EOS] + mid
                first, _ = greedy_loop.fused_greedy_loop_plain(
                    ctx, c0, h0, tt, 1, True, 1)
                if (first[:, 0] == vocab.EOS).float().mean() < 0.5:
                    lo = mid
                else:
                    hi = mid
            bias = hi
        tt["pb"][vocab.EOS] = t["pb"][vocab.EOS] + bias
        ns = greedy_loop.launches_split
        lab, sc = greedy_loop.fused_greedy_loop(ctx, c0, h0, tt, 1, True, T)
        assert greedy_loop.launches_split == ns + 1
        torch.cuda.synchronize()
        lab_p, sc_p, margin = greedy_loop.fused_greedy_loop_plain(
            ctx, c0, h0, tt, 1, True, T, return_margins=True)
        _greedy_agrees(lab, sc, lab_p, sc_p, margin, dtype)
        stopped = (lab_p[:, 0] == vocab.EOS).cpu()
        if every:
            assert bool(stopped.all())
            assert bool((lab[:, 1:] == vocab.PAD).all())
        else:
            assert 0 < int(stopped.sum()) < B


def test_greedy_loop_unserved_shape_raises(dev):
    """A shape no plan fits raises ValueError; nothing falls back."""
    H = 8200  # more than 512 units a block
    assert greedy_loop.plan(H, 1, torch.bfloat16, 2, 128, 1, 1) is None
    # the plan is checked before the tables, so these stand in for them
    # (every build_tables key: the wrapper passes each to the custom op)
    z1 = lambda *s_: torch.zeros(*s_, device=dev, dtype=torch.bfloat16)
    t = {"eg": z1(39, 4), "wa": z1(1, 1), "pw": z1(1, 128), "wfh0": z1(1, 4),
         "wx": z1(0, 1, 4), "bx": torch.zeros(0, 4, device=dev),
         "wc": z1(2, 1), "pb": torch.zeros(128, device=dev)}
    ctx = torch.zeros(2, 1, H, device=dev, dtype=torch.bfloat16)
    z = torch.zeros(1, H, device=dev)
    n = greedy_loop.launches
    with pytest.raises(ValueError, match="no kernel plan"):
        greedy_loop.fused_greedy_loop(ctx, z, z, t, 1, True, 3)
    assert greedy_loop.launches == n


def test_trained_fixture_bf16_transcripts(dev):
    """A tiny model trained on the card to exact match (chip_smoke.py's
    trained_fixture: the port's make_train_step, no jax): its bf16 greedy
    and beam-5 transcripts through greedy_loop, decode_step, beam_loop and
    beam_step, without and with a trie, equal the plain route's."""
    import chip_smoke

    for what, ok in chip_smoke.fixture_transcripts(dev):
        assert ok, what


def test_trained_fixture_bf16_transcripts_no_input_feed(dev):
    """The same fixture without input feed (the CLI's default decoder:
    layer 0's weights one segment)."""
    import chip_smoke

    for what, ok in chip_smoke.fixture_transcripts(dev, input_feed=False):
        assert ok, what


def test_tail_wrappers_raise_where_no_route_fits(dev):
    """A shape that neither the cluster plan nor the rows route's shared
    memory fits raises ValueError before any launch, as decode.py's
    routes (decode_step.fits, beam_step.fits) foresee; nothing falls
    back."""
    H, L, B = 8192, 2, 1
    dt = torch.bfloat16
    assert not decode_step.fits(H, B, dt, L, 128)
    assert not beam_step.fits(H, B, 2, dt, L, 128, 39)
    z = lambda *s_: torch.zeros(*s_, device=dev, dtype=dt)
    ctx, prev = z(L, B, H), torch.zeros(B, dtype=torch.int32, device=dev)
    n = (decode_step.launches, beam_step.launches)
    with pytest.raises(ValueError, match="no route fits"):
        decode_step.fused_decode_tail(z(B, H), ctx, prev, z(H, H),
                                      z(2 * H, H), z(H, 128),
                                      torch.zeros(128, device=dev))
    with pytest.raises(ValueError, match="no route fits"):
        beam_step.fused_beam_tail(ctx, z(B, 2 * H), prev.repeat(2)[None],
                                  torch.zeros(B, 2, device=dev), z(H, H),
                                  z(2 * H, H), z(H, 128),
                                  torch.zeros(128, device=dev), 2, 39)
    assert (decode_step.launches, beam_step.launches) == n


@pytest.mark.parametrize("route", ["auto", "tail"])
def test_recognize_on_cuda_matches_cpu(dev, route):
    cfg = Config(input_feed=True, encoder_num_hidden=64,
                 target_embedding_size=8, max_decoder_l=10,
                 pallas_greedy=route)
    cpu = AttentionOCR.create(cfg, seed=5, device="cpu")
    gpu = AttentionOCR(cfg, cpu.params, cpu.batch_stats, device=dev)
    rs = np.random.RandomState(6)
    images = [rs.uniform(0, 255, (32, w)).astype(np.float32)
              for w in (100, 81, 100, 32, 81)]
    wc, sc = cpu.recognize(images)
    wg, sg = gpu.recognize(images)
    assert wg == wc
    np.testing.assert_allclose(sg, sc, rtol=1e-4, atol=1e-3)


def _close_all(got, want, tol):
    for a, b in zip(got, want):
        _close(a, b, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("W,ties", [(100, False), (81, False), (36, True)])
def test_conv1_pool_bwd_kernel(dev, dtype, W, ties):
    """dW, db against the plain version.  ties: an image of a few grey
    levels, so many pool windows hold equal maxima (first-max routing);
    dy arrives non-contiguous, as an NCHW conv2 backward hands it."""
    g = torch.Generator().manual_seed(8)
    B = 5
    x = _rand(g, B, 32, W, 1)
    if ties:
        x = (x * 2).round() / 2
    x = x.to(dev, dtype)
    w = _rand(g, 64, 1, 3, 3, lo=-0.3, hi=0.3).to(dev)
    b = _rand(g, 64, lo=-0.3, hi=0.3).to(dev)
    dy = _rand(g, B, 64, 16, W // 2).to(dev, dtype).permute(0, 2, 3, 1)
    n = conv1_pool_bwd.launches
    dw, db = conv1_pool_bwd.conv1_relu_pool_bwd(x, w, b, dy)
    assert conv1_pool_bwd.launches == n + 1
    torch.cuda.synchronize()
    dw_p, db_p = conv1_pool_bwd.conv1_relu_pool_bwd_plain(x, w, b, dy)
    # the routing is bit-identical, so only the summation order differs
    for got, want in ((dw, dw_p), (db, db_p)):
        _close(got, want, 1e-4 * float(want.abs().max()) + 1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,W,ties", [(400, 100, True), (400, 100, False),
                                      (37, 81, True), (3, 17, False)])
def test_conv1_pool_bwd_kernel_batch(dev, dtype, B, W, ties):
    """At the train step's batch and at ragged widths: the card's blocks
    split the cells and sum their partials in a fixed tree, so two calls
    give the same bits, within 1e-4 of the plain version's scale; the plan
    held against the kernel's own."""
    g = torch.Generator().manual_seed(B + W)
    x = _rand(g, B, 32, W, 1)
    if ties:
        x = (x * 2).round() / 2
    x = x.to(dev, dtype)
    w = _rand(g, 64, 1, 3, 3, lo=-1 / 3, hi=1 / 3).to(dev)
    b = _rand(g, 64, lo=-1 / 3, hi=1 / 3).to(dev)
    dy = _rand(g, B, 16, W // 2, 64).to(dev, dtype)
    first = conv1_pool_bwd.conv1_relu_pool_bwd(x, w, b, dy)
    second = conv1_pool_bwd.conv1_relu_pool_bwd(x, w, b, dy)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    assert (B, 32, W, dtype) in conv1_pool_bwd.plans
    want = conv1_pool_bwd.conv1_relu_pool_bwd_plain(x, w, b, dy)
    for got, ref in zip(first, want):
        _close(got, ref, 1e-4 * float(ref.abs().max()))


def test_train_step_kernels_match_plain_route_float32(dev):
    """One float32 SGD step of the default model (the encoder at H=512,
    so lstm_bwd at its real width) at B=20 through every training kernel
    equals the same step through the plain versions on the card
    (use_pallas=False): grad norms and params within 1e-4 relative."""
    kw = dict(input_feed=True)
    rs = np.random.RandomState(15)
    images = rs.uniform(0, 255, (20, 32, 100, 1)).astype(np.float32)
    t, te, _ = vocab.encode_batch(["abc", "x", "hello", "42", "word"] * 4)
    outs = []
    base = AttentionOCR.create(Config(**kw), seed=16, device="cpu")
    for use_pallas in (False, True):
        cfg = Config(use_pallas=use_pallas, **kw)
        m = AttentionOCR(cfg, base.params, base.batch_stats, device=dev)
        step = train_step.make_train_step(cfg)
        outs.append(step(m.params, m.batch_stats,
                         train_step.init_opt_state(m.params, cfg), images,
                         t, te, 0.1))
    want, got = outs
    _close(got.loss_sum, want.loss_sum, 1e-5)
    for k in want.grad_norms:
        _close(got.grad_norms[k], want.grad_norms[k], 1e-4)
    _close_all(_leaves(got.params), _leaves(want.params), 1e-4)


def bf16_steps(got, want):
    """|got - want| in units of one bfloat16 step (ulp) of the larger
    magnitude of the two (exact zeros on both sides count 0)."""
    got, want = got.float(), want.float()
    m = torch.maximum(got.abs(), want.abs())
    ulp = torch.exp2(torch.floor(torch.log2(m.clamp(min=1e-30))) - 7)
    return ((got - want).abs() / ulp).max().item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("W,ties", [(100, False), (81, False), (36, True)])
@pytest.mark.parametrize("B", [5, 1, 37, 512])
def test_conv1_pool_dx_kernel(dev, dtype, W, ties, B):
    """The image cotangent's 16 patch taps against the plain version
    (float32 within 1e-5 of the scale, bfloat16 within one step, and both
    bit for bit: the kernel sums in the plain version's order), and the
    unpatched (B, H, W, 1) cotangent; ties as in the dW test; one image,
    a ragged batch and the serving batch."""
    g = torch.Generator().manual_seed(31)
    x = _rand(g, B, 32, W, 1)
    if ties:
        x = (x * 2).round() / 2
    x = x.to(dev, dtype)
    w = _rand(g, 64, 1, 3, 3, lo=-0.3, hi=0.3).to(dev)
    b = _rand(g, 64, lo=-0.3, hi=0.3).to(dev)
    dy = _rand(g, B, 64, 16, W // 2).to(dev, dtype).permute(0, 2, 3, 1)
    n = conv1_pool_dx.launches
    taps = conv1_pool_dx.conv1_relu_pool_dx16(x, w, b, dy)
    assert conv1_pool_dx.launches == n + 1
    torch.cuda.synchronize()
    want = conv1_pool_dx.conv1_relu_pool_dx16_plain(x, w, b, dy)
    assert taps.shape == want.shape == (B, 16, W // 2, 16)
    if dtype == torch.float32:
        _close(taps, want, 1e-5 * float(want.abs().max()))
    else:
        assert bf16_steps(taps, want) <= 1.0
    assert torch.equal(taps, want)
    dx = conv1_pool_dx.conv1_relu_pool_dx(x, w, b, dy)
    dx_p = conv1_pool_dx.conv1_relu_pool_dx_plain(x, w, b, dy)
    assert dx.shape == x.shape and dx.dtype == dtype
    _close(dx, dx_p, (1e-5 if dtype == torch.float32 else 3e-2)
           * float(dx_p.float().abs().max()))


# (B, C, H, W) and the window: the CNN's three pools after conv2, 4, 6
POOLS = [((3, 128, 16, 50), (2, 2)), ((3, 256, 8, 25), (2, 1)),
         ((2, 512, 4, 25), (2, 1))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,window", POOLS)
def test_pool_bwd_kernel(dev, dtype, shape, window):
    """dz bit-identical to the plain version and to autograd of
    F.max_pool2d over torch.relu, on channels_last activations of a few
    levels (ties, zeros, all-negative windows); ReluPoolFn launches the
    kernel once a backward."""
    g = torch.Generator().manual_seed(32)
    z = ((_rand(g, *shape) * 2).round() / 2).to(dev, dtype).contiguous(
        memory_format=torch.channels_last)
    z[0, :, :2] = -1.0  # whole windows below zero
    y = torch.relu(z)
    B, C, H, W = shape
    dy = _rand(g, B, C, H // window[0], W // window[1]).to(dev, dtype)
    n = pool_bwd.launches
    dz = pool_bwd.relu_pool_bwd(y, dy, window)
    assert pool_bwd.launches == n + 1
    assert dz.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(dz, pool_bwd.relu_pool_bwd_plain(y, dy, window))
    zz = z.detach().requires_grad_()
    (ref,) = torch.autograd.grad(F.max_pool2d(torch.relu(zz), window), zz,
                                 dy)
    assert torch.equal(dz, ref)
    zz = z.detach().requires_grad_()
    out = cnn.ReluPoolFn.apply(zz, window)
    (got,) = torch.autograd.grad(out, zz, dy)
    assert pool_bwd.launches == n + 2
    assert torch.equal(out, F.max_pool2d(y, window))
    assert torch.equal(got, ref)


def test_image_gradient_on_cuda(dev):
    """d(features)/d(images) through cnn.apply(train=True) on the kernel
    route (conv1_pool_dx, pool_bwd) equals the plain route's on the card,
    float32, within 1e-5 of the gradient's scale."""
    cfg = Config(input_feed=True, encoder_num_hidden=32)
    m = AttentionOCR.create(cfg, seed=33, device=dev)
    rs = np.random.RandomState(33)
    images = torch.from_numpy(rs.uniform(0, 255, (6, 32, 100, 1)).astype(
        np.float32)).to(dev)
    r = torch.from_numpy(rs.uniform(-1, 1, (6, 24, 512)).astype(
        np.float32)).to(dev)
    grads = []
    n = (conv1_pool_dx.launches, pool_bwd.launches)
    for kernel in (True, False):
        im = images.clone().requires_grad_()
        feats, _ = cnn.apply(m.params["cnn"], m.batch_stats, im,
                             use_kernel=kernel, train=True)
        grads.append(torch.autograd.grad((feats * r).sum(), im)[0])
    assert conv1_pool_dx.launches == n[0] + 1
    assert pool_bwd.launches == n[1] + 3
    _close(grads[0], grads[1], 1e-5 * float(grads[1].abs().max()))


def test_trainer_on_cuda_matches_cpu(tmp_path):
    """python -m aocr_torch.train's main on the default device (CUDA): one
    epoch of 20 crops at batch 8 (a padded partial batch of 4), a
    checkpoint and a validation sweep every 2 steps; pool_bwd launches 3
    times a step; final params within 1e-4 of the same run on the CPU.
    At learning rate 0.01: three steps at this batch amplify rounding
    (a ReLU or pool decision that flips between two summation orders),
    and at 0.1 images perturbed by 1e-6 relative alone move conv1's
    weights by 5.5e-4 on the CPU (1.2e-5 at 0.01)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rs = np.random.RandomState(34)
    words = ["ab", "cd1", "xyz", "k", "wxyz", "q0", "mm", "abc", "z9",
             "hi"] * 2
    lines = []
    for i, word in enumerate(words):
        np.save(tmp_path / f"{i}.npy", rs.uniform(0, 255, (32, 100)))
        lines.append(f"{i}.npy {word}")
    (tmp_path / "m.txt").write_text("\n".join(lines) + "\n")
    finals = []
    for d in ("cuda", "cpu"):
        args = ["-phase", "train", "-data_base_dir", str(tmp_path),
                "-data_path", "m.txt", "-val_data_path", "m.txt",
                "-model_dir", str(tmp_path / d), "-log_path",
                str(tmp_path / f"{d}.log"), "-batch_size", "8",
                "-num_epochs", "1", "-steps_per_checkpoint", "2",
                "-num_batches_val", "1", "-input_feed",
                "-encoder_num_hidden", "32", "-max_decoder_l", "8",
                "-learning_rate", "0.01"]
        n = pool_bwd.launches
        train.main(args, device=None if d == "cuda" else "cpu")
        if d == "cuda":
            assert pool_bwd.launches == n + 3 * 3
        finals.append(checkpoint.load(checkpoint.final_path(
            str(tmp_path / d))))
    assert finals[0]["global_step"] == finals[1]["global_step"] == 3
    for a, b in zip(_leaves(finals[0]["params"]),
                    _leaves(finals[1]["params"])):
        _close(torch.from_numpy(a), torch.from_numpy(b), 1e-4)


def _lstm_case(g, dev, dtype, L=7, B=6, H=128):
    bound = 0.1 if H == 128 else H ** -0.5
    wh = _rand(g, H, 4 * H, lo=-bound, hi=bound).to(dev, dtype)
    xp = _rand(g, L, B, 4 * H).to(dev, dtype)
    c0, h0 = _rand(g, B, H).to(dev), _rand(g, B, H).to(dev)
    return wh, xp, c0, h0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_fwd_residuals_through_lstm_bwd(dev, dtype, reverse):
    """lstm_bwd on the cluster kernel's ifog and cs (B=33: a ragged
    32-row tile) against the plain pair."""
    g = torch.Generator().manual_seed(9)
    wh, xp, c0, h0 = _lstm_case(g, dev, dtype, B=33)
    hs, _, (ifog, cs) = lstm_fwd.lstm_fwd_scan(wh, xp, c0, h0, reverse,
                                               collect=True)
    torch.cuda.synchronize()
    _, _, (ifog_p, cs_p) = lstm_fwd.lstm_fwd_scan_plain(wh, xp, c0, h0,
                                                        reverse, collect=True)
    L, B, H = hs.shape
    dhs = _rand(g, L, B, H).to(dev)
    dcf, dhf = _rand(g, B, H).to(dev), _rand(g, B, H).to(dev)
    got = lstm_bwd.lstm_bwd_scan(wh, dhs, ifog, cs, c0, dcf, dhf, reverse)
    torch.cuda.synchronize()
    want = lstm_bwd.lstm_bwd_scan_plain(wh, dhs, ifog_p, cs_p, c0, dcf, dhf,
                                        reverse)
    _close_all(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_bwd_kernel(dev, dtype, reverse):
    g = torch.Generator().manual_seed(10)
    wh, xp, c0, h0 = _lstm_case(g, dev, dtype)
    hs, _, (ifog, cs) = lstm_fwd.lstm_fwd_scan_plain(wh, xp, c0, h0, reverse,
                                                     collect=True)
    L, B, H = hs.shape
    dhs = _rand(g, L, B, H).to(dev)
    dcf, dhf = _rand(g, B, H).to(dev), _rand(g, B, H).to(dev)
    got = lstm_bwd.lstm_bwd_scan(wh, dhs, ifog, cs, c0, dcf, dhf, reverse)
    torch.cuda.synchronize()
    want = lstm_bwd.lstm_bwd_scan_plain(wh, dhs, ifog, cs, c0, dcf, dhf,
                                        reverse)
    _close_all(got, want, TOL[dtype])


def _lstm_bwd_case(g, dev, dtype, B, H, L, reverse):
    """lstm_bwd's inputs on the plain forward's residuals, the init law's
    weights (H^-0.5)."""
    b = H ** -0.5
    wh = _rand(g, H, 4 * H, lo=-b, hi=b).to(dev, dtype)
    xp = _rand(g, L, B, 4 * H).to(dev, dtype)
    c0 = _rand(g, B, H).to(dev)
    _, _, (ifog, cs) = lstm_fwd.lstm_fwd_scan_plain(wh, xp, c0, c0 * 0.5,
                                                    reverse, collect=True)
    dhs = (_rand(g, L, B, H) * 0.1).to(dev)
    dcf, dhf = (_rand(g, B, H) * 0.1).to(dev), (_rand(g, B, H) * 0.1).to(dev)
    return wh, dhs, ifog, cs, c0, dcf, dhf, reverse


# (B, H, L) of lstm_bwd's plan edges: one row, a ragged batch over three
# 16-row tiles, the train step's 7 clusters of 64 rows (and with H=64, 8
# blocks of 8 units), and H=2400 (bf16 past the cluster slice's 640: the
# rows route, as float32 everywhere)
LSTM_BWD_SHAPES = [(1, 64, 5), (33, 64, 7), (400, 64, 4), (1, 512, 5),
                   (33, 512, 7), (400, 512, 24), (8, 2400, 3)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("B,H,L", LSTM_BWD_SHAPES)
def test_lstm_bwd_kernel_plan_edges(dev, dtype, reverse, B, H, L):
    """The plan's route (bf16 up to H=640: 16-SM clusters summing the
    partials through L2; else the rows route) against the plain version,
    the plan held against the kernel's own on the first launch."""
    g = torch.Generator().manual_seed(B + H + L)
    args = _lstm_bwd_case(g, dev, dtype, B, H, L, reverse)
    want = lstm_bwd.lstm_bwd_scan_plain(*args)
    n = lstm_bwd.launches
    got = lstm_bwd.lstm_bwd_scan(*args)
    torch.cuda.synchronize()
    assert lstm_bwd.launches == n + 1
    p = lstm_bwd.plans[(H, B, dtype)][0]
    assert p.route == (lstm_bwd.ROUTE_CLUSTERS
                       if dtype == torch.bfloat16 and H <= 640
                       else lstm_bwd.ROUTE_ROWS)
    for a, w in zip(got, want):
        _close(a, w, TOL[dtype] * float(w.float().abs().max()))


def test_lstm_bwd_unserved_shape_raises(dev):
    """Shapes no plan serves raise ValueError and launch nothing: H not a
    multiple of 16, H past 2416."""
    g = torch.Generator().manual_seed(3)
    n = lstm_bwd.launches
    for H, dtype in ((24, torch.bfloat16), (2432, torch.float32),
                     (2432, torch.bfloat16)):
        args = _lstm_bwd_case(g, torch.device("cpu"), dtype, 1, H, 1, False)
        args = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
        with pytest.raises(ValueError):
            lstm_bwd.lstm_bwd_scan(*args)
    assert lstm_bwd.launches == n


def _tf_case(g, dev, dtype, input_feed, L=9, B=6, H=128, T=5, nl=2):
    # weights within +-0.1 at H=128, shrinking as the init law's H^-0.5
    # at wider decoders
    b = 0.1 * min(1.0, (128 / H) ** 0.5)
    u = lambda *s: _rand(g, *s, lo=-b, hi=b)
    wfh0 = u(2 * H if input_feed else H, 4 * H).to(dev, dtype)
    rest = [(u(2 * H, 4 * H).to(dev, dtype), u(4 * H).to(dev),
             u(4 * H).to(dev)) for _ in range(nl - 1)]
    wa, wc = u(H, H).to(dev, dtype), u(2 * H, H).to(dev, dtype)
    ctx = _rand(g, L, B, H).to(dev, dtype)
    xp = _rand(g, T, B, 4 * H).to(dev, dtype)
    c0, h0 = _rand(g, B, H).to(dev), _rand(g, B, H).to(dev)
    return ctx, wfh0, rest, wa, wc, xp, c0, h0


# (B, H, num_layers) of the teacher-forced kernels' cases: the parity
# shape (16 blocks of 8 units, one 16-row tile), a ragged batch over three
# tiles, one and three layers, the default decoder's width, and units
# past H (H=132: 16 units a block, block 8 owns 4, the rest none)
TF_SHAPES = [(6, 128, 2), (37, 128, 2), (6, 128, 1), (6, 128, 3),
             (8, 1024, 2), (6, 132, 2)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("input_feed", [True, False])
@pytest.mark.parametrize("B,H,nl", TF_SHAPES)
def test_tf_fwd_kernel(dev, dtype, input_feed, B, H, nl):
    g = torch.Generator().manual_seed(11)
    args = _tf_case(g, dev, dtype, input_feed, B=B, H=H, nl=nl)
    n = tf_fwd.launches
    got = tf_fwd.decoder_fwd_scan(*args, input_feed, True)
    torch.cuda.synchronize()
    assert tf_fwd.launches == n + 1
    want = tf_fwd.decoder_fwd_scan_plain(*args, input_feed, True)
    _close_all(got, want, TOL[dtype])
    _close(tf_fwd.decoder_fwd_scan(*args, input_feed, False), want[0],
           TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("input_feed", [True, False])
@pytest.mark.parametrize("B,H,nl", TF_SHAPES)
def test_tf_bwd_kernel(dev, dtype, input_feed, B, H, nl):
    g = torch.Generator().manual_seed(12)
    ctx, wfh0, rest, wa, wc, xp, c0, h0 = _tf_case(g, dev, dtype, input_feed,
                                                   B=B, H=H, nl=nl)
    htl, _hs, ifog, cs, alpha, _cv = tf_fwd.decoder_fwd_scan_plain(
        ctx, wfh0, rest, wa, wc, xp, c0, h0, input_feed, True)
    dys = _rand(g, *htl.shape).to(dev)
    args = (ctx, wfh0, [w for w, _, _ in rest], wc, wa, dys, htl, alpha,
            ifog, cs, c0, input_feed)
    n = tf_bwd.launches
    got = tf_bwd.decoder_bwd_scan(*args)
    torch.cuda.synchronize()
    assert tf_bwd.launches == n + 1
    want = tf_bwd.decoder_bwd_scan_plain(*args)
    _close_all(got, want, TOL[dtype])


def test_tf_kernels_refuse_misaligned_inputs(dev):
    """A contiguous view that starts off a 16-byte boundary raises
    ValueError before a launch (the kernels load rows by vectors and bulk
    copies)."""
    g = torch.Generator().manual_seed(13)
    ctx, wfh0, rest, wa, wc, xp, c0, h0 = _tf_case(g, dev, torch.float32,
                                                   True)
    c0_off = torch.cat([torch.zeros(1, device=dev), c0.flatten()])[1:]
    n = tf_fwd.launches
    with pytest.raises(ValueError, match="16-byte"):
        tf_fwd.decoder_fwd_scan(ctx, wfh0, rest, wa, wc, xp,
                                c0_off.view_as(c0), h0, True, True)
    assert tf_fwd.launches == n


@pytest.mark.parametrize("dtype", DTYPES)
def test_tf_plans_match_the_kernel(dev, dtype):
    """Each teacher-forced kernel's plan in Python equals the kernel's own
    (aocr_tf_fwd_plan, aocr_tf_bwd_plan) at the train step's B=400 and at
    ragged and narrow shapes; a shape past the kernels raises ValueError."""
    for mod in (tf_fwd, tf_bwd):
        for B, H, nl in ((400, 1024, 2), (37, 128, 2), (1, 132, 3),
                         (513, 256, 1)):
            p = mod.checked_plan(H, B, dtype, 24, nl)
            assert p == mod.plans[(H, B, dtype, 24, nl)][0]
        with pytest.raises(ValueError):
            mod.checked_plan(8200, 1, dtype, 24, 2)


def test_train_step_on_cuda_matches_cpu(dev):
    """One float32 SGD step through every training kernel equals the
    CPU's (plain versions): loss within 1e-5, grad norms 1e-4 relative,
    params and batch stats within 1e-4.  Not closer: at this size a 1e-7
    relative change of the images alone moves conv weights by up to ~1e-5
    on the CPU (a ReLU or pool decision flips; B=5 moved them 7e-5), and
    the card sums in another order."""
    cfg = Config(input_feed=True, encoder_num_hidden=32,
                 target_embedding_size=8)
    cpu = AttentionOCR.create(cfg, seed=13, device="cpu")
    rs = np.random.RandomState(14)
    images = rs.uniform(0, 255, (16, 32, 100, 1)).astype(np.float32)
    t, te, _ = vocab.encode_batch(["abc", "x", "hello", "42", "word"] * 3
                                  + ["z"])
    step = train_step.make_train_step(cfg)
    outs = []
    for d in ("cpu", dev):
        m = AttentionOCR(cfg, cpu.params, cpu.batch_stats, device=d)
        outs.append(step(m.params, m.batch_stats,
                         train_step.init_opt_state(m.params, cfg), images,
                         t, te, 0.1))
    (want, got) = outs
    _close(got.loss_sum, want.loss_sum, 1e-5)
    for k in want.grad_norms:
        _close(got.grad_norms[k], want.grad_norms[k], 1e-4)
    for tree in ("params", "batch_stats"):
        _close_all(_leaves(getattr(got, tree)), _leaves(getattr(want, tree)),
                   1e-4)


def _leaves(tree):
    from aocr_torch.optim import leaves

    return leaves(tree)


LEXICON = ["ab", "abc", "cd", "e1", "xyz", "zq", "m", "e10", "0", "hello"]


def _trie(dev, words=LEXICON):
    return torch.from_numpy(trie.build_transition_table(words)).to(dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", ["auto", "rows"])
def test_decode_step_kernel_valid_plane(dev, dtype, route, monkeypatch):
    """The trie plane on both routes: picks only valid tokens, row 4 (live)
    has no valid token and picks PAD at -1e30, row 1 (prev EOS) is
    frozen and picks PAD at 0."""
    g = torch.Generator().manual_seed(20)
    L, B, H = 9, 7, 256
    t = _decoder_tables(g, dev, dtype, H)
    h = _rand(g, B, H).to(dev, dtype)
    ctx = _rand(g, L, B, H).to(dev, dtype)
    prev = torch.tensor([1, 2, 0, 5, 17, 1, 9], dtype=torch.int32,
                        device=dev)
    table = _trie(dev)
    inner = (table >= 0).any(1).nonzero().flatten().cpu()  # have children
    nodes = inner[torch.arange(B) % len(inner)].to(torch.int32)
    valid = greedy_loop.trie_valid(table, nodes.to(dev), t["pw"].shape[1],
                                   pad_ok=False)
    valid[1] = 0.0
    valid[4] = 0.0
    monkeypatch.setattr(decode_step, "ROUTE", route)
    args = (h, ctx, prev, t["wa"], t["wc"], t["pw"], t["pb"])
    n = decode_step.launches
    ht, tok, d = decode_step.fused_decode_tail(*args, valid=valid)
    assert decode_step.launches == n + 1
    torch.cuda.synchronize()
    ht_p, tok_p, d_p = decode_step.fused_decode_tail_plain(*args,
                                                           valid=valid)
    _close(ht, ht_p, TOL[dtype])
    _close(d, d_p, TOL[dtype])
    assert int(tok[4]) == vocab.PAD and float(d[4]) == NEG_F32
    assert int(tok[1]) == vocab.PAD and float(d[1]) == 0.0
    live = ~((prev == vocab.PAD) | (prev == vocab.EOS))
    live[4] = False
    picked = valid.gather(1, tok.long()[:, None])[:, 0]
    assert bool((picked[live] > 0).all())
    if dtype == torch.float32:
        assert torch.equal(tok.cpu(), tok_p.cpu())


def _first_parting(got, want, margin, tol):
    """Rows of (T, B[, K]) histories where got and want part: each must
    part at a step whose margin (T, B) is a near-tie (< tol)."""
    differ = (got != want).reshape(got.shape[0], got.shape[1], -1).any(-1)
    for b in differ.any(0).nonzero().flatten().tolist():
        t = int(differ[:, b].float().argmax())
        assert margin[t, b] < tol, (b, t, float(margin[t, b]))
    return int(differ.any(0).sum())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 6])
def test_greedy_loop_kernel_trie(dev, dtype, B):
    g = torch.Generator().manual_seed(21)
    L, H, T = 9, 256, 10
    t = _decoder_tables(g, dev, dtype, H)
    t["pb"][vocab.EOS] += 2.0  # rows reach EOS at different steps
    ctx = _rand(g, L, B, H).to(dev, dtype)
    c0, h0 = _rand(g, B, H).to(dev), _rand(g, B, H).to(dev)
    table = _trie(dev)
    lab, sc = greedy_loop.fused_greedy_loop(ctx, c0, h0, t, 2, True, T,
                                            trie_table=table)
    torch.cuda.synchronize()
    lab_p, sc_p, margin = greedy_loop.fused_greedy_loop_plain(
        ctx, c0, h0, t, 2, True, T, return_margins=True, trie_table=table)
    parted = _first_parting(lab.t().cpu(), lab_p.t().cpu(),
                            margin.t().cpu(), TOL[dtype])
    if dtype == torch.float32:
        assert parted == 0
        _close(sc, sc_p, 1e-5)
    for row in lab.cpu().numpy():
        word = vocab.decode(row)
        assert any(w.startswith(word) for w in LEXICON), word


def _beam_case(g, dev, dtype, B, K, H=256, L=9):
    t = _decoder_tables(g, dev, dtype, H)
    t["pb"][vocab.EOS] += 2.0
    ctx = _rand(g, L, B, H).to(dev, dtype)
    return t, ctx


# (B, K, trie): one tile (B=6 batch rows), the narrowest beam, beam_loop's
# widest (K=8) and the first past it (K=9), ragged tiles over several
# clusters (B=37, 20), every beam the vocabulary holds (K=39), refills
BEAM_STEP_CASES = [(6, 3, False), (6, 5, True), (6, 12, False),
                   (6, 5, "refill"), (1, 1, False), (37, 8, True),
                   (37, 9, "refill"), (20, 12, True), (9, 39, False),
                   (23, 39, "refill"), (300, 5, False)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,K,use_trie", BEAM_STEP_CASES)
def test_beam_step_kernel(dev, dtype, B, K, use_trie):
    g = torch.Generator().manual_seed(22)
    V = 39
    t, ctx = _beam_case(g, dev, dtype, B, K)
    H = ctx.shape[2]
    h = _rand(g, B, K * H).to(dev, dtype)
    prev = torch.randint(3, V, (B, K), generator=g, dtype=torch.int32)
    prev[1::3, -1], prev[2::3, :] = vocab.EOS, vocab.PAD  # frozen beams, rows
    scores = -torch.rand(B, K, generator=g).sort(dim=1, descending=True)[0]
    prev, scores = prev.to(dev), (scores * 5).to(dev)
    valid = None
    if use_trie:
        # refill: a tiny lexicon and a plane without PAD, so rows have
        # fewer than K valid candidates
        words = ["zq"] if use_trie == "refill" else LEXICON
        table = _trie(dev, words)
        nodes = torch.randint(0, table.shape[0], (B, K), generator=g,
                              dtype=torch.int32)
        valid = greedy_loop.trie_valid(table, nodes.to(dev),
                                       t["pw"].shape[1],
                                       pad_ok=use_trie != "refill")
        valid = valid.reshape(B, -1)
    args = (ctx, h, prev, scores, t["wa"], t["wc"], t["pw"], t["pb"], K, V)
    n = beam_step.launches
    got = beam_step.fused_beam_tail(*args, valid=valid)
    assert beam_step.launches == n + 1
    torch.cuda.synchronize()
    want = beam_step.fused_beam_tail_plain(*args, valid=valid)
    _close(got[0], want[0], TOL[dtype])
    _close(got[1], want[1], TOL[dtype] if dtype == torch.bfloat16 else 1e-5)
    if dtype == torch.float32:
        for a, b in zip(got[2:], want[2:]):
            assert torch.equal(a.cpu(), b.cpu())
    if use_trie == "refill":
        assert int(got[4].min()) < K
    p = beam_step.plans[(ctx.shape[2], B, K, dtype, ctx.shape[0],
                         t["pw"].shape[1])][0]
    assert p is not None and p.nb * K <= p.bt  # the cluster route


@pytest.mark.parametrize("dtype", DTYPES)
def test_beam_step_kernel_rows_route(dev, dtype):
    """K=90 beams over V=100 tokens: wider than the largest tile (80 beam
    rows at H=1024), so beam_step's plan takes the rows route, and the
    first port's kernel runs."""
    g = torch.Generator().manual_seed(23)
    B, K, V, H, L = 3, 90, 100, 1024, 9
    t = _decoder_tables(g, dev, dtype, H, V=V)
    ctx = _rand(g, L, B, H).to(dev, dtype)
    h = _rand(g, B, K * H).to(dev, dtype)
    prev = torch.randint(3, V, (B, K), generator=g, dtype=torch.int32)
    prev[1, :4] = vocab.EOS
    scores = -torch.rand(B, K, generator=g).sort(dim=1, descending=True)[0]
    args = (ctx, h, prev.to(dev), (scores * 5).to(dev), t["wa"], t["wc"],
            t["pw"], t["pb"], K, V)
    assert beam_step.plan(H, B, K, dtype, L, t["pw"].shape[1], 7) is None
    n = beam_step.launches
    got = beam_step.fused_beam_tail(*args)
    assert beam_step.launches == n + 1
    assert beam_step.plans[(H, B, K, dtype, L, t["pw"].shape[1])][0] is None
    torch.cuda.synchronize()
    want = beam_step.fused_beam_tail_plain(*args)
    _close(got[0], want[0], TOL[dtype])
    if dtype == torch.float32:
        _close(got[1], want[1], 1e-5)
        for a, b in zip(got[2:], want[2:]):
            assert torch.equal(a.cpu(), b.cpu())


# (B, K, length_normalize, trie): a ragged last tile, each K of the
# kernel (K=7: 77 of a tile's 80 bf16 rows), one batch row, several tiles
# of one wave, more tiles than the card runs at once (waves), the trie, a
# tiny lexicon where most beams dead-end (PAD is always valid after t=1,
# so the refills of a search come from its t=1 step)
BEAM_LOOP_CASES = [
    (7, 2, False, False), (5, 3, True, True), (6, 5, True, False),
    (4, 5, False, True), (3, 8, False, False), (5, 4, False, "refill"),
    (17, 5, False, False), (1, 5, True, True), (5, 7, False, False),
    (4, 8, True, True), (300, 5, False, False)]


def _beam_loop_args(g, dev, dtype, B, K, lennorm, use_trie, T=9, nl=2):
    """A search from one random t=1 state: (args, trie table)."""
    V = 39
    t, ctx = _beam_case(g, dev, dtype, B, K)
    H = ctx.shape[2]
    st = DecoderState(attn=_rand(g, B, H).to(dev),
                      cs=tuple(_rand(g, B, H).to(dev) for _ in range(nl)),
                      hs=tuple(_rand(g, B, H).to(dev) for _ in range(nl)))
    table = nodes0 = None
    tok0 = torch.randint(3, V, (B, K), generator=g, dtype=torch.int32)
    if use_trie:
        words = ["zq", "zz"] if use_trie == "refill" else LEXICON
        table = _trie(dev, words)
        roots = (table[0] >= 0).nonzero().flatten().cpu()
        tok0 = roots[torch.randint(0, len(roots), (B, K), generator=g)]
        tok0 = tok0.to(torch.int32)
        nodes0 = table[0].cpu()[tok0.long()].clamp(min=0).to(dev)
    sc0 = (-5 * torch.rand(B, K, generator=g)).sort(1, descending=True)[0]
    return (ctx, st, tok0.to(dev), sc0.to(dev), nodes0, t, nl, True, T, K,
            lennorm), table


def _beam_loop_agrees(got, want, dtype):
    """Histories part only at plain near-ties (a row's first step where a
    token or a parent differs: candidates that swap slots at a tie can
    share a token); in float32 none part, and scores (1e-5), lengths and
    refill counts agree."""
    margin = want[-1].cpu()
    parted = _first_parting(torch.stack([got[0], got[1]], -1).cpu(),
                            torch.stack([want[0], want[1]], -1).cpu(),
                            margin, TOL[dtype])
    if dtype == torch.float32:
        assert parted == 0
        assert torch.equal(got[3].cpu(), want[3].cpu())
        _close(got[2], want[2], 1e-5)
        for a, b in zip(got[4:6], want[4:6]):
            assert int(a) == int(b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,K,lennorm,use_trie", BEAM_LOOP_CASES)
def test_beam_loop_kernel(dev, dtype, B, K, lennorm, use_trie):
    """The whole search against its plain version from the same t=1
    state, at the plan's edges (BEAM_LOOP_CASES); one launch a call."""
    g = torch.Generator().manual_seed(23 + K)
    args, table = _beam_loop_args(g, dev, dtype, B, K, lennorm, use_trie)
    L, _, H = args[0].shape
    n = beam_loop.launches
    got = beam_loop.fused_beam_loop(*args, trie_table=table)
    assert beam_loop.launches == n + 1
    torch.cuda.synchronize()
    want = beam_loop.fused_beam_loop_plain(*args, trie_table=table,
                                           return_margins=True)
    _beam_loop_agrees(got, want, dtype)
    assert (got[0][1:] != vocab.PAD).any()  # the search ran past t=0
    p = beam_loop.plans[(H, B, K, dtype, L, args[5]["pw"].shape[1], 2)][0]
    assert p.nb * K <= p.bt and p.clusters == -(-B // p.nb)
    if B == 17:
        assert p.clusters > 1 and B % p.nb  # several tiles, the last ragged


@pytest.mark.parametrize("dtype", DTYPES)
def test_beam_loop_kernel_all_eos(dev, dtype):
    """Every beam's t=1 pick is EOS (the search leaves before its first
    step: histories PAD and identity parents after t=0, the t=1 scores),
    and every beam picks EOS at its first step (each tile leaves after
    it)."""
    g = torch.Generator().manual_seed(41)
    args, _ = _beam_loop_args(g, dev, dtype, 20, 5, True, False)
    eos = list(args)
    eos[2] = torch.full_like(args[2], vocab.EOS)
    got = beam_loop.fused_beam_loop(*eos)
    torch.cuda.synchronize()
    want = beam_loop.fused_beam_loop_plain(*eos, return_margins=True)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())
    assert bool((got[0][1:] == vocab.PAD).all())
    stop = list(args)
    stop[5] = dict(args[5], pb=args[5]["pb"].clone())
    stop[5]["pb"][vocab.EOS] += 1e4
    got = beam_loop.fused_beam_loop(*stop)
    torch.cuda.synchronize()
    want = beam_loop.fused_beam_loop_plain(*stop, return_margins=True)
    _beam_loop_agrees(got, want, dtype)
    assert bool((got[0][1] == vocab.EOS).all())
    assert bool((got[0][2:] == vocab.PAD).all())


def test_beam_loop_plan_matches_kernel(dev):
    """The wrapper's plan is the kernel's, field for field, and the card
    runs at least one cluster of each."""
    import ctypes

    from aocr_torch.ops import cuda

    lib = cuda.library()
    for dtype in DTYPES:
        for H in (128, 256, 1024, 2048):
            for B in (1, 5, 17, 512, 513):
                for K in range(1, 9):
                    out = (ctypes.c_int * 11)()
                    err = lib.aocr_beam_loop_plan(
                        H, B, K, int(dtype == torch.float32), 24, 128, 2,
                        out)
                    assert err == 0, (H, B, K, dtype, err)
                    assert out[10] >= 1, (H, B, K, dtype, out[:])
                    p = beam_loop.plan(H, B, K, dtype, 24, 128, 2, out[10])
                    assert tuple(out[:10]) == tuple(p), (H, B, K, out[:], p)
    out = (ctypes.c_int * 11)()
    assert lib.aocr_beam_loop_plan(256, 4, 9, 0, 9, 128, 2, out) != 0


def test_beam_loop_unserved_shape_raises(dev):
    """A shape no plan fits (a beam past MAX_K, more than 512 units a
    block) raises ValueError; nothing falls back or launches."""
    g = torch.Generator().manual_seed(42)
    args, _ = _beam_loop_args(g, dev, torch.bfloat16, 3, 5, False, False)
    n = beam_loop.launches
    wide = list(args)
    wide[2] = torch.full((3, 9), 5, dtype=torch.int32, device=dev)
    wide[3] = torch.zeros((3, 9), device=dev)
    wide[9] = 9
    with pytest.raises(ValueError, match="no kernel plan"):
        beam_loop.fused_beam_loop(*wide)
    with pytest.raises(ValueError, match="no kernel plan"):
        beam_loop.checked_plan(8200, 1, 5, torch.bfloat16, 2, 128, 1)
    assert beam_loop.launches == n


@pytest.mark.parametrize("route", ["loop", "tail"])
def test_beam_recognize_on_cuda_matches_cpu(dev, route):
    """recognize(beam_size=5), without and with a dictionary, on the card
    against the CPU (float32)."""
    cfg = Config(input_feed=True, encoder_num_hidden=64,
                 target_embedding_size=8, max_decoder_l=10,
                 pallas_beam=route)
    cpu = AttentionOCR.create(cfg, seed=24, device="cpu")
    gpu = AttentionOCR(cfg, cpu.params, cpu.batch_stats, device=dev)
    rs = np.random.RandomState(25)
    images = [rs.uniform(0, 255, (32, w)).astype(np.float32)
              for w in (100, 81, 100, 32, 81)]
    for dictionary in (False, True):
        if dictionary:
            cpu.use_dictionary(LEXICON)
            gpu.use_dictionary(LEXICON)
            assert gpu.dictionary_table.device.type == "cuda"
        wc, sc = cpu.recognize(images, beam_size=5)
        n = (beam_loop if route == "loop" else beam_step).launches
        wg, sg = gpu.recognize(images, beam_size=5)
        assert (beam_loop if route == "loop" else beam_step).launches > n
        assert wg == wc
        np.testing.assert_allclose(sg, sc, rtol=1e-4, atol=1e-3)


# the kernel an export route's artifact launches, by (route, beam size)
EXPORT_ROUTES = {("loop", 1): greedy_loop, ("tail", 1): decode_step,
                 ("loop", 5): beam_loop, ("tail", 5): beam_step}


@pytest.mark.parametrize("route,K", sorted(EXPORT_ROUTES))
def test_kernel_artifact_matches_live_recognize(dev, tmp_path, route, K):
    """A kernel artifact (export_recognizer(use_pallas=True)) traced on
    the card holds its route's custom ops; loaded on the card, its
    recognize (under the dictionary at beam-5) launches the route's
    kernels and equals the live kernel recognize: transcripts identical,
    float32 scores within 1e-5 relative.  A tail-route greedy decode
    packs decode_step's weights once."""
    from aocr_torch import export

    cfg = Config(input_feed=True, encoder_num_hidden=64,
                 target_embedding_size=8, max_decoder_l=10,
                 pallas_greedy=route, pallas_beam=route)
    ocr = AttentionOCR.create(cfg, seed=26, device=dev)
    if K > 1:
        ocr.use_dictionary(LEXICON)
    rs = np.random.RandomState(27)
    images = rs.uniform(0, 255, (37, 32, 100)).astype(np.float32)
    art = export.export_recognizer(ocr, str(tmp_path / "k.aocrx"),
                                   beam_size=K, use_pallas=True, device=dev)
    rec = export.ExportedRecognizer.load(art, dev)
    kernel = EXPORT_ROUTES[route, K]
    n, packs = (conv1_pool.launches, lstm_fwd.launches,
                kernel.launches), decode_step.packs
    got_w, got_s = rec.recognize(images)
    assert conv1_pool.launches > n[0] and lstm_fwd.launches > n[1]
    assert kernel.launches > n[2]
    if kernel is decode_step:
        assert decode_step.packs == packs + 1
    want_w, want_s = ocr.recognize(images, beam_size=K)
    assert got_w == want_w
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5)
