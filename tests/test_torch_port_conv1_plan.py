"""The bf16 arithmetic and the launch plan of aocr_torch's conv1_pool
kernel (csrc/conv1_pool.cu), on the CPU.

The kernel runs only on the card.  What its results rest on beside the
card is checked here: its W16 matrix (`conv1_pool.w16`, whose columns are
the kernel's tensor-core B fragments) equals aocr's `_w16`; the kernel's
arithmetic in plain PyTorch (each cell's 16-tap patch times W16 in
float32, the window max, then the rounding epilogue, over the runs of
cells the plan gives each block) equals aocr's conv1_relu_pool in
interpret mode within 1e-6 in float32 and within one bf16 step in
bfloat16 (only the order of the float32 sums differs); and the plan
gives every cell one block, stages every row a block reads, and fits the
H100's shared memory.  Odd widths floor: aocr (even widths only) is run
on the image with one zero column appended, its last pool column
dropped.  The image cotangent (conv1_pool_dx): its plain version's fixed
order of the channels' float32 sum, which the kernel runs bit for bit,
pinned by numpy scalar arithmetic, and its plan (conv1_pool_bwd's) over
the image-gradient shapes.
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aocr.ops.pallas import conv1_pool as jconv1
from aocr_torch.ops.cuda import conv1_pool, conv1_pool_bwd, conv1_pool_dx

SMEM = 232448  # an H100 block's shared memory, bytes
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("name", list(DTYPES))
def test_w16_equals_aocr(name):
    dt, jdt = DTYPES[name]
    w = np.random.RandomState(3).uniform(-1, 1, (64, 1, 3, 3))
    w = w.astype(np.float32)
    want = jconv1._w16(jnp.asarray(w.transpose(2, 3, 1, 0)), jdt)
    got = conv1_pool.w16(torch.from_numpy(w), dt)
    assert got.shape == (16, 256) and got.dtype == dt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def patches(x):
    """x (B, H, W, 1) -> (B * H//2 * W//2, 16): cell (b, ho, wo)'s tap
    4a + b' is the zero-padded image's pixel (2 ho + a, 2 wo + b'), cells
    in (image, row, column) order: the bf16 kernel's A operand."""
    B, H, W, _ = x.shape
    Ho, Wo = H // 2, W // 2
    xp = torch.nn.functional.pad(x[..., 0], (1, 1, 1, 1))
    taps = [xp[:, a:a + 2 * Ho:2, b:b + 2 * Wo:2]
            for a in range(4) for b in range(4)]
    return torch.stack(taps, dim=-1).reshape(B * Ho * Wo, 16)


def emulate(x, w, b, p):
    """The kernel's arithmetic in plain PyTorch: for each block's run of
    cells, patches @ W16 in float32, the max over the four pool
    positions (rounding is monotone, so it commutes with the max),
    rounded to x's dtype, + the bias in that dtype, rounded, ReLU."""
    cd = x.dtype
    B, H, W, _ = x.shape
    P = patches(x).float()
    w16 = conv1_pool.w16(w, cd).float()
    bc = b.to(cd).float()
    runs = []
    for i in range(p.blocks):
        cells = p.cells(i, B, H, W)
        s = P[cells.start:cells.stop] @ w16
        m = s.reshape(-1, 4, 64).amax(dim=1)
        runs.append(torch.relu((m.to(cd).float() + bc).to(cd)))
    return torch.cat(runs).reshape(B, H // 2, W // 2, 64)


def _aocr(x, w, b, jdt):
    """aocr's conv1_relu_pool in interpret mode; odd widths floor."""
    W = x.shape[2]
    xe = np.pad(x, ((0, 0), (0, 0), (0, W % 2), (0, 0)))
    f = jax.jit(lambda x, w, b: jconv1.conv1_relu_pool(x, w, b, True))
    out = f(jnp.asarray(xe).astype(jdt), jnp.asarray(w.transpose(2, 3, 1, 0)),
            jnp.asarray(b))
    return np.array(out.astype(jnp.float32))[:, :, :W // 2]


def _bf16_steps(got, want):
    """Largest distance in bf16 steps between two non-negative bf16
    tensors (their bit patterns are ordered as their values)."""
    a = got.view(torch.int16).int()
    b = want.view(torch.int16).int()
    return int((a - b).abs().max())


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("W", [2, 3, 81, 100])
def test_kernel_arithmetic_matches_aocr(name, W):
    dt, jdt = DTYPES[name]
    rs = np.random.RandomState(W)
    x = rs.uniform(-1, 1, (3, 32, W, 1)).astype(np.float32)
    w = rs.uniform(-1 / 3, 1 / 3, (64, 1, 3, 3)).astype(np.float32)
    b = rs.uniform(-1 / 3, 1 / 3, (64,)).astype(np.float32)
    want = _aocr(x, w, b, jdt)  # each image's output is its own
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    for B in (1, 3):
        tx = torch.from_numpy(x[:B]).to(dt)
        p = conv1_pool.plan(B, 32, W, dt)
        got = emulate(tx, tw, tb, p)
        ref = torch.from_numpy(want[:B])
        assert got.shape == ref.shape
        if dt == torch.float32:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                                       atol=1e-6)
        else:
            assert _bf16_steps(got, ref.to(dt)) <= 1
        # the plain version (F.conv2d) agrees as closely
        plain = conv1_pool.conv1_relu_pool(tx, tw, tb)
        if dt == torch.float32:
            np.testing.assert_allclose(plain.numpy(), ref.numpy(),
                                       rtol=1e-6, atol=1e-6)
        else:
            assert _bf16_steps(plain, ref.to(dt)) <= 1


def _check_plan(B, W, dt, resident=conv1_pool.RESIDENT):
    H, Ho, Wo = 32, 16, W // 2
    esz = torch.empty((), dtype=dt).element_size()
    p = conv1_pool.plan(B, H, W, dt, resident)
    assert p is not None, (B, W, dt)
    cells = B * Ho * Wo
    rb = esz * ((W + 3) & ~1)
    assert 1 <= p.blocks <= cells and p.run == -(-cells // p.blocks)
    least = max(1, min(resident, cells // conv1_pool.MIN_RUN))
    assert p.blocks >= least
    if p.blocks > least:  # the fewest blocks whose rows fit
        fewer = -(-cells // (p.blocks - 1))
        assert conv1_pool_bwd.run_rows(fewer, B, Ho, Wo) * rb > \
            conv1_pool.STAGE_MAX
    assert p.rows * rb <= conv1_pool.STAGE_MAX
    assert 0 < p.smem <= SMEM // 2 - 4096  # two blocks a SM
    # the runs partition the cells; each block's staged rows (the
    # kernel's cb_base(g1, g0) + 4 for its first and last pool rows g0,
    # g1) fit the plan's rows
    i = np.arange(p.blocks)
    lo, hi = i * cells // p.blocks, (i + 1) * cells // p.blocks
    assert lo[0] == 0 and hi[-1] == cells and (lo[1:] == hi[:-1]).all()
    assert (hi > lo).all() and (hi - lo).max() == p.run
    g0, g1 = lo // Wo, (hi - 1) // Wo
    nsr = conv1_pool_bwd.base(g1, g0, Ho) + 4
    assert nsr.max() <= p.rows
    return p


@pytest.mark.parametrize("name", list(DTYPES))
def test_plan_covers_every_shape(name):
    dt = DTYPES[name][0]
    for W in range(2, 401):
        for B in (1, 2, 3, 8, 400, 512):
            _check_plan(B, W, dt)
    for W in (2, 3, 100, 101, 400):
        for B in range(1, 513):
            _check_plan(B, W, dt)


def test_plan_at_the_main_paths():
    """B=512 recognize and B=400 train-step crops run as many blocks as
    an H100 holds (2 a SM); one image runs a few blocks of at least
    MIN_RUN cells; a card that holds fewer blocks gets fewer."""
    for dt in (torch.float32, torch.bfloat16):
        assert conv1_pool.plan(512, 32, 100, dt).blocks == 264
        assert conv1_pool.plan(400, 32, 100, dt).blocks == 264
        p = conv1_pool.plan(1, 32, 100, dt)
        assert p.blocks == 800 // conv1_pool.MIN_RUN
        assert conv1_pool.plan(512, 32, 100, dt, 132).blocks == 132


def _dx_case(dt, B, W, seed):
    """An image, conv1's weights and a pooled cotangent for the image
    cotangent: x in the compute dtype, w and b float32, dy (B, 16, W//2,
    64) in the compute dtype."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.uniform(-1, 1, (B, 32, W, 1)).astype(np.float32))
    w = torch.from_numpy(rs.uniform(-1 / 3, 1 / 3, (64, 1, 3, 3))
                         .astype(np.float32))
    b = torch.from_numpy(rs.uniform(-1 / 3, 1 / 3, (64,)).astype(np.float32))
    dy = torch.from_numpy(rs.uniform(-1, 1, (B, 16, W // 2, 64))
                          .astype(np.float32))
    return x.to(dt), w, b, dy.to(dt)


@pytest.mark.parametrize("name", list(DTYPES))
def test_dx_tap_order(name):
    """conv1_pool_dx's plain version sums the channels' terms in the
    kernel's fixed order (csrc/conv1_pool_dx.cu), pinned here by numpy
    float32 scalar arithmetic: each channel's term the one rounded
    product W16[tap, p, c] x dy at its winning position p; the 16 groups
    of 4 channels each summed from +0 in channel order; the group sums
    added k + (k + 8), then 4 apart, 2 apart, 1 apart; rounded to the
    compute dtype."""
    dt = DTYPES[name][0]
    B, W = 2, 10
    x, w, b, dy = _dx_case(dt, B, W, 9)
    got = conv1_pool_dx.conv1_relu_pool_dx16_plain(x, w, b, dy)
    dz, _ = conv1_pool_bwd.routed(x, w, b, dy)  # (B, 64, Ho, Wo, 4)
    dz = dz.permute(1, 0, 2, 3, 4).reshape(64, -1, 4).numpy()
    pos = np.abs(dz).argmax(-1)  # the winning position (any, where 0)
    g = np.take_along_axis(dz, pos[..., None], -1)[..., 0]
    w16 = conv1_pool_dx._w16(w, dt).numpy()  # (16, 4, 64)
    wsel = w16[:, pos, np.arange(64)[:, None]]  # (16 taps, 64, cells)
    terms = (wsel * g[None]).astype(np.float32)  # float32 products
    s = []
    for j in range(16):
        acc = np.zeros(terms.shape[::2], np.float32)  # (16, cells)
        for k in range(4):
            acc = (acc + terms[:, 4 * j + k]).astype(np.float32)
        s.append(acc)
    for half in (8, 4, 2, 1):
        s = [(s[k] + s[k + half]).astype(np.float32) for k in range(half)]
    want = torch.from_numpy(np.ascontiguousarray(s[0].T)).reshape(
        B, 16, W // 2, 16).to(dt)
    assert got.dtype == dt
    assert torch.equal(got, want)


@pytest.mark.parametrize("B", [1, 37, 400])
@pytest.mark.parametrize("W", [2, 36, 100])
def test_dx_plan_covers_the_image_gradient(B, W):
    """conv1_pool_dx runs conv1_pool_bwd's plan (csrc/conv1_route.cuh
    `cb_plan`) with its own staging limit: the runs partition the cells,
    each block's staged rows fit the plan's rows and STAGE_MAX, and two
    blocks with the kernel's static shared memory (the tap table and the
    group sums) fit a SM; 264 blocks (2 an SM of an H100) wherever there
    are that many cells."""
    H, Ho, Wo = 32, 16, W // 2
    resident = 264
    p = conv1_pool_dx.plan(B, H, W, resident)
    assert p is not None
    cells = B * Ho * Wo
    rb = 4 * ((W + 3) & ~1)
    assert p.blocks == min(resident, cells)
    assert p.rows * rb == p.smem <= conv1_pool_dx.STAGE_MAX
    assert 2 * (p.smem + conv1_pool_dx.STATIC_BYTES) <= SMEM
    i = np.arange(p.blocks)
    lo, hi = i * cells // p.blocks, (i + 1) * cells // p.blocks
    assert lo[0] == 0 and hi[-1] == cells and (lo[1:] == hi[:-1]).all()
    assert (hi > lo).all()
    g0, g1 = lo // Wo, (hi - 1) // Wo
    assert (conv1_pool_bwd.base(g1, g0, Ho) + 4).max() <= p.rows
    assert p == conv1_pool_bwd.plan(B, H, W, resident,
                                    conv1_pool_dx.STAGE_MAX)
