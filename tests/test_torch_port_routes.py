"""The decode routes where no loop kernel's plan fits, against
aocr/decode.py on the CPU.

aocr's "auto" greedy decode takes its per-step fused tail where the
whole-decode kernel does not fit its VMEM estimate, and its beam search
the beam tail (or its XLA path) where the beam-loop kernel does not fit;
a forced "loop" warns.  The port routes from its kernels' plan functions
(`decode.greedy_route`, `decode.beam_route`): here those plans are
patched to None, and the port's fallback is held against aocr's own
fallback on the same numpy weights and images (aocr's kernels in
interpret mode, as its tests run them, its fits patched to False), with
spies on the port's kernel wrappers for the route each decode took.

Tolerances as tests/test_torch_port_beam.py: float32 labels identical,
scores within 1e-5 relative.
"""

import tests.torch_threads  # noqa: F401  (sets the CPU thread budget)

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aocr import decode as jdecode
from aocr.ops.pallas import beam_loop as jbl
from aocr.ops.pallas import beam_step as jbs
from aocr.ops.pallas import greedy_loop as jgl
from aocr_torch import decode, weights
from aocr_torch.ops.cuda import beam_loop, beam_step, decode_step, greedy_loop
from tests.test_torch_port_beam import _cfgs, _images, _model

K, B = 3, 5


def _spy(monkeypatch, module, name):
    """Count the calls of module.name (a kernel wrapper)."""
    calls = []
    f = getattr(module, name)

    def spy(*a, **kw):
        calls.append(1)
        return f(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def _no_plan(*_a, **_kw):
    return None


def _jax(monkeypatch, p, stats, images, jcfg, beam, **flags):
    """aocr's decode with its interpret flags set as given; its fits gates
    patched to refuse the loop kernels (and, with no_tail, the beam tail),
    so that it takes its own fallback."""
    for name in ("_PALLAS_GREEDY_INTERPRET", "_PALLAS_BEAM_INTERPRET",
                 "_PALLAS_BEAM_LOOP_INTERPRET"):
        monkeypatch.setattr(jdecode, name, flags.get(name, False))
    monkeypatch.setattr(jgl, "vmem_bytes", lambda *a, **kw: 1 << 40)
    monkeypatch.setattr(jbl, "fits", lambda *a, **kw: False)
    if flags.get("no_tail"):
        monkeypatch.setattr(jbs, "fits_vmem", lambda *a, **kw: False)
    jp = jax.tree.map(jnp.asarray, p)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if beam == 1:
            out = jdecode.greedy_decode(jp, stats, jnp.asarray(images), jcfg,
                                        jcfg.max_decoder_l)
        else:
            out = jdecode.beam_decode(jp, stats, jnp.asarray(images), jcfg,
                                      beam, jcfg.max_decoder_l)
    return [np.asarray(x) for x in out]


def _port(p, stats, images, cfg, beam):
    tp, ts = weights.from_numpy(p, stats)
    out = decode.beam_decode(tp, ts, torch.from_numpy(images), cfg, beam,
                             cfg.max_decoder_l)
    return [t.numpy() for t in out]


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["auto", "loop"])
def test_greedy_falls_back_to_the_tail(monkeypatch, mode):
    """No greedy_loop plan: "auto" and "loop" take decode_step's tail
    ("loop" warns), as aocr's do where its loop kernel does not fit."""
    seed = {"auto": 610, "loop": 611}[mode]
    jcfg, cfg = _cfgs(seed=seed, pallas_greedy=mode)
    p, stats = _model(seed, jcfg)
    images = _images(B)
    want = _jax(monkeypatch, p, stats, images, jcfg, 1,
                _PALLAS_GREEDY_INTERPRET=True)
    monkeypatch.setattr(greedy_loop, "plan", _no_plan)
    loop = _spy(monkeypatch, greedy_loop, "fused_greedy_loop")
    tail = _spy(monkeypatch, decode_step, "fused_decode_tail")
    if mode == "loop":
        with pytest.warns(UserWarning, match="pallas_greedy='loop'.*tail"):
            got = _port(p, stats, images, cfg, 1)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = _port(p, stats, images, cfg, 1)
    assert not loop and len(tail) >= 1
    assert decode.greedy_route(cfg.replace(pallas_greedy="auto"), B, 2,
                               128) == "tail"
    _same(got, want)


def test_greedy_falls_back_to_the_plain_route(monkeypatch):
    """No greedy_loop plan and no decode_step route: the plain route,
    equal to aocr's XLA path; a forced "tail" warns."""
    jcfg, cfg = _cfgs(seed=612)
    p, stats = _model(612, jcfg)
    images = _images(B)
    want = _jax(monkeypatch, p, stats, images,
                jcfg.replace(use_pallas=False), 1)
    monkeypatch.setattr(greedy_loop, "plan", _no_plan)
    monkeypatch.setattr(decode_step, "fits", lambda *a, **kw: False)
    loop = _spy(monkeypatch, greedy_loop, "fused_greedy_loop")
    tail = _spy(monkeypatch, decode_step, "fused_decode_tail")
    got = _port(p, stats, images, cfg, 1)
    assert not loop and not tail
    _same(got, want)
    with pytest.warns(UserWarning, match="pallas_greedy='tail'.*plain"):
        assert decode.greedy_route(cfg.replace(pallas_greedy="tail"), B, 2,
                                   128) == "plain"


@pytest.mark.parametrize("mode", ["auto", "loop"])
def test_beam_falls_back_to_beam_step(monkeypatch, mode):
    """No beam_loop plan: "auto" and "loop" take beam_step's tail ("loop"
    warns), against aocr's fallback: its beam tail for "auto", its XLA
    path for "loop"."""
    seed = {"auto": 613, "loop": 614}[mode]
    jcfg, cfg = _cfgs(seed=seed, pallas_beam=mode)
    p, stats = _model(seed, jcfg)
    images = _images(B)
    want = _jax(monkeypatch, p, stats, images, jcfg, K,
                _PALLAS_BEAM_INTERPRET=True, _PALLAS_BEAM_LOOP_INTERPRET=True)
    monkeypatch.setattr(beam_loop, "plan", _no_plan)
    loop = _spy(monkeypatch, beam_loop, "fused_beam_loop")
    tail = _spy(monkeypatch, beam_step, "fused_beam_tail")
    if mode == "loop":
        with pytest.warns(UserWarning, match="pallas_beam='loop'.*tail"):
            got = _port(p, stats, images, cfg, K)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = _port(p, stats, images, cfg, K)
    assert not loop and len(tail) >= 1
    _same(got, want)


def test_beam_falls_back_to_the_plain_route(monkeypatch):
    """No beam_loop plan and no beam_step route: the plain route, equal to
    aocr's XLA path (its tail refused too); a forced "tail" warns."""
    jcfg, cfg = _cfgs(seed=615, pallas_beam="tail")
    p, stats = _model(615, jcfg)
    images = _images(B)
    want = _jax(monkeypatch, p, stats, images, jcfg, K,
                _PALLAS_BEAM_INTERPRET=True, no_tail=True)
    monkeypatch.setattr(beam_loop, "plan", _no_plan)
    monkeypatch.setattr(beam_step, "fits", lambda *a, **kw: False)
    loop = _spy(monkeypatch, beam_loop, "fused_beam_loop")
    tail = _spy(monkeypatch, beam_step, "fused_beam_tail")
    with pytest.warns(UserWarning, match="pallas_beam='tail'.*plain"):
        got = _port(p, stats, images, cfg, K)
    assert not loop and not tail
    _same(got, want)
    assert decode.beam_route(cfg.replace(pallas_beam="auto"), B, 2, 128,
                             K) == "plain"


def test_routes_where_plans_fit():
    """The default decoder (H=1024, 2 layers) takes the loop kernels at
    every width of the ladder (L = 3 ... 79), both dtypes; beams past
    beam_loop.MAX_K take beam_step.  H=8192 has no loop plan: float32
    greedy and beam-5 take their tails, bf16 ones (no tail plan, and a
    rows-route block past shared memory) the plain route.
    use_pallas=False is plain."""
    from aocr_torch.config import Config

    for dt in ("float32", "bfloat16"):
        cfg = Config(compute_dtype=dt)
        for L in (3, 5, 8, 12, 19, 29, 44, 66, 79):
            assert decode.greedy_route(cfg, 512, L, 1024) == "loop"
            assert decode.beam_route(cfg, 512, L, 1024, 5) == "loop"
            assert decode.beam_route(cfg, 512, L, 1024, 10) == "tail"
        wide = "tail" if dt == "float32" else "plain"
        assert decode.greedy_route(cfg, 512, 24, 8192) == wide
        assert decode.beam_route(cfg, 512, 24, 8192, 5) == wide
        assert decode.greedy_route(cfg.replace(use_pallas=False), 512, 24,
                                   1024) == "plain"


def test_a_plan_for_one_row_fits_every_batch():
    """A program traced for any batch routes at a batch of 1
    (decode._plan_args): wherever a plan fits one row, it fits each
    batch tried."""
    batches = (2, 3, 37, 400, 512, 2048)
    for H in (64, 1024, 4096, 8192):
        for L in (3, 79, 400):
            for dt in (torch.float32, torch.bfloat16):
                if greedy_loop.plan(H, 1, dt, L, 128, 2, 1) is not None:
                    assert all(greedy_loop.plan(H, b, dt, L, 128, 2, 1)
                               for b in batches)
                for k in (2, 5, 8, 10):
                    if beam_loop.plan(H, 1, k, dt, L, 128, 2, 1) is not None:
                        assert all(beam_loop.plan(H, b, k, dt, L, 128, 2, 1)
                                   for b in batches)
                    if beam_step.plan(H, 1, k, dt, L, 128, 1) is not None:
                        assert all(beam_step.plan(H, b, k, dt, L, 128, 1)
                                   for b in batches)


def test_tail_routes_fit_where_their_blocks_do():
    """decode_step.fits and beam_step.fits: the cluster plan, else the
    rows route's block within a block's shared memory."""
    assert decode_step.fits(1024, 512, torch.bfloat16, 79, 128)
    assert beam_step.fits(1024, 512, 39, torch.float32, 79, 128, 39)
    assert not decode_step.fits(1022, 8, torch.float32, 24, 128)
    # past the cluster plans, the rows route up to its shared memory
    H = 4096 * 4
    assert decode_step.plan(H, 8, torch.float32, 24, 128, 1) is None
    assert decode_step.rows_smem(H, 24, 128) > greedy_loop.SMEM_MAX
    assert not decode_step.fits(H, 8, torch.float32, 24, 128)
    assert not beam_step.fits(H, 8, 5, torch.float32, 24, 128, 39)
