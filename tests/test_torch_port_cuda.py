"""aocr_torch's CUDA kernels against their plain PyTorch versions, on the
card.  Marked `cuda`; each test skips without a CUDA device.  This file
imports no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py

(`--noconftest`: tests/conftest.py configures jax).  Shapes are small
but keep the slice's structure: ragged batch tiles (B not a multiple of
the kernels' 4-row tiles), odd widths, both directions, both dtypes.
Tolerances: float32 1e-4 (the kernels sum in another order); bfloat16
outputs within a few bf16 steps.
"""

import numpy as np
import pytest
import torch

from aocr.config import Config
from aocr_torch.api import AttentionOCR
from aocr_torch.ops.cuda import conv1_pool, decode_step, greedy_loop, lstm_fwd

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


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
@pytest.mark.parametrize("W", [100, 81])
def test_conv1_pool_kernel(dev, dtype, W):
    g = torch.Generator().manual_seed(1)
    x = _rand(g, 6, 32, W, 1).to(dev, dtype)
    w = _rand(g, 64, 1, 3, 3, lo=-0.3, hi=0.3).to(dev)
    b = _rand(g, 64, lo=-0.3, hi=0.3).to(dev)
    n = conv1_pool.launches
    got = conv1_pool.conv1_relu_pool(x, w, b)
    assert conv1_pool.launches == n + 1
    torch.cuda.synchronize()
    _close(got, conv1_pool.conv1_relu_pool_plain(x, w, b),
           TOL[dtype] if dtype == torch.float32 else 2 ** -7)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_fwd_kernel(dev, dtype, reverse):
    g = torch.Generator().manual_seed(2)
    L, B, H = 7, 6, 128
    wh = _rand(g, H, 4 * H, lo=-0.1, hi=0.1).to(dev, dtype)
    xp = _rand(g, L, B, 4 * H).to(dev, dtype)
    c0, h0 = _rand(g, B, H).to(dev), _rand(g, B, H).to(dev)
    hs, (cf, hf) = lstm_fwd.lstm_fwd_scan(wh, xp, c0, h0, reverse)
    torch.cuda.synchronize()
    hs_p, (cf_p, hf_p) = lstm_fwd.lstm_fwd_scan_plain(wh, xp, c0, h0, reverse)
    for a, b in ((hs, hs_p), (cf, cf_p), (hf, hf_p)):
        _close(a, b, TOL[dtype])


def _decoder_tables(g, dev, dtype, H, V=39, E=8, nl=2):
    layers = [{"wi": _rand(g, (E + H) if i == 0 else H, 4 * H, lo=-0.1,
                           hi=0.1),
               "wh": _rand(g, H, 4 * H, lo=-0.1, hi=0.1),
               "bi": _rand(g, 4 * H, lo=-0.1, hi=0.1),
               "bh": _rand(g, 4 * H, lo=-0.1, hi=0.1)} for i in range(nl)]
    dec = {"embedding": torch.randn(V, E, generator=g), "layers": layers,
           "w_a": _rand(g, H, H, lo=-0.1, hi=0.1),
           "w_c": _rand(g, 2 * H, H, lo=-0.1, hi=0.1)}
    proj = {"w": _rand(g, H, V, lo=-0.3, hi=0.3), "b": _rand(g, V)}
    move = lambda d: {k: ([{kk: vv.to(dev) for kk, vv in x.items()}
                           for x in v] if k == "layers" else v.to(dev))
                      for k, v in d.items()}
    return greedy_loop.build_tables(move(dec), move(proj), E, True, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_kernel(dev, dtype):
    g = torch.Generator().manual_seed(3)
    L, B, H = 9, 6, 256
    t = _decoder_tables(g, dev, dtype, H)
    h = _rand(g, B, H).to(dev, dtype)
    ctx = _rand(g, L, B, H).to(dev, dtype)
    prev = torch.tensor([1, 2, 0, 5, 17, 1], dtype=torch.int32, device=dev)
    ht, tok, d = decode_step.fused_decode_tail(h, ctx, prev, t["wa"], t["wc"],
                                               t["pw"], t["pb"])
    torch.cuda.synchronize()
    ht_p, tok_p, d_p = decode_step.fused_decode_tail_plain(
        h, ctx, prev, t["wa"], t["wc"], t["pw"], t["pb"])
    _close(ht, ht_p, TOL[dtype])
    _close(d, d_p, TOL[dtype])
    assert torch.equal(tok[2:3].cpu(), torch.zeros(1, dtype=torch.int32))
    if dtype == torch.float32:
        assert torch.equal(tok.cpu(), tok_p.cpu())


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
