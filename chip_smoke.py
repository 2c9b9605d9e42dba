#!/usr/bin/env python3
"""Smoke run of aocr_torch on one NVIDIA GPU (H100): greedy recognition at
the full width of the default model, through its four CUDA kernels.

    python3 chip_smoke.py [--seed N]

Phases, each raising on failure:
  1. environment: the card (nvidia-smi), CUDA, the kernel build from
     aocr_torch/csrc (nvcc, sm_90a);
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes, in float32 and bfloat16, with stated tolerances;
  3. end to end: numpy weights from --seed through aocr_torch.weights,
     AttentionOCR.recognize on requests of 1, 8, 32 and 512 word images
     (W=100) and a mixed-width list, bf16 (the serving configuration) and
     float32, pallas_greedy "loop" and "tail"; every kernel's launch count
     must move; float32 transcripts must equal the plain route's on the
     card and the CPU's on a small input;
  4. timing: each kernel against its plain version (CUDA events), and
     recognize images/s at B=512, W=100, bf16, T=50.
Prints the card's name and power limit, one JSON line of kernel results,
and last {"ok": true, "device": {...}}.  Exits non-zero without a CUDA
device or outside a checkout of the repo.  Never imports jax.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# The serving batch and crop of the default model (aocr.serve's ladder)
B_SERVE, W_SERVE, T_MAX = 512, 100, 50


def base_config():
    """The repo's default model at full width, as AttentionOCR.create
    makes it: CNN 64->512, encoder 512 per direction, decoder 1024 x 2
    layers with input feed, E=20, V=39."""
    from aocr.config import Config

    return Config(input_feed=True, max_decoder_l=T_MAX)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ weights / data

def numpy_model(cfg, seed: int):
    """Reference-layout (params, batch_stats) made with numpy: the
    reference's init laws (uniform +-1/sqrt(fan_in), normal embedding),
    with a gain of 2 on the conv weights and the projector so that
    transcripts depend on the image (at init the CNN features barely
    vary between images).  The recurrent weights keep the init law: with
    larger gains the random decoder turns chaotic and float32 summation
    order alone flips tokens after a few dozen steps.  Rows rarely emit
    EOS, so a decode runs all T steps: the early exit's worst case."""
    import numpy as np

    from aocr_torch.models.cnn import CONV_DEFS

    rs = np.random.RandomState(seed)

    def u(bound, *shape, gain=1.0):
        return (rs.uniform(-bound, bound, shape) * gain).astype(np.float32)

    cnn, stats = {}, {}
    for name, i, o, kh, kw, _pad, bn in CONV_DEFS:
        b = 1.0 / math.sqrt(i * kh * kw)
        cnn[name] = {"w": u(b, kh, kw, i, o, gain=2.0), "b": u(b, o)}
        if bn:
            cnn[name + "_bn"] = {"scale": np.ones(o, np.float32),
                                 "bias": np.zeros(o, np.float32)}
            stats[name + "_bn"] = {"mean": np.zeros(o, np.float32),
                                   "var": np.ones(o, np.float32)}

    def layer(i, h):
        return {"wi": u(1 / math.sqrt(i), i, 4 * h),
                "bi": u(1 / math.sqrt(i), 4 * h),
                "wh": u(1 / math.sqrt(h), h, 4 * h),
                "bh": u(1 / math.sqrt(h), 4 * h)}

    He, Hd, E, V = (cfg.encoder_num_hidden, cfg.decoder_num_hidden,
                    cfg.target_embedding_size, cfg.target_vocab_size)
    enc = lambda: {"layers": [layer(cfg.cnn_feature_size if k == 0 else He,
                                    He)
                              for k in range(cfg.encoder_num_layers)]}
    params = {
        "cnn": cnn, "encoder_fw": enc(), "encoder_bw": enc(),
        "decoder": {
            "embedding": rs.standard_normal((V, E)).astype(np.float32),
            "layers": [layer((E + Hd) if k == 0 else Hd, Hd)
                       for k in range(cfg.decoder_num_layers)],
            "w_a": u(1 / math.sqrt(Hd), Hd, Hd),
            "w_c": u(1 / math.sqrt(2 * Hd), 2 * Hd, Hd)},
        "projector": {"w": u(1 / math.sqrt(Hd), Hd, V, gain=2.0),
                      "b": u(1 / math.sqrt(Hd), V)},
    }
    return params, stats


def word_images(rs, n: int, width: int):
    """n (32, width) float32 images in [0, 255]: dark vertical strokes of
    random position, width and ink on white, a different layout each."""
    import numpy as np

    imgs = np.full((n, 32, width), 255.0, np.float32)
    for img in imgs:
        for _ in range(rs.randint(2, 9)):
            x = rs.randint(0, width - 3)
            w = rs.randint(1, 4)
            y0, y1 = sorted(rs.randint(4, 29, 2))
            img[y0:y1 + 2, x:x + w] = rs.uniform(0, 90)
    return imgs


# ------------------------------------------------------------ helpers

def cuda_ms(fn, n: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


@contextlib.contextmanager
def plain_route():
    """Run each kernel's plain PyTorch version in its wrapper's place (on
    the card), to hold the kernel route against it."""
    from aocr_torch.ops.cuda import (conv1_pool, decode_step, greedy_loop,
                                     lstm_fwd)

    swaps = [(conv1_pool, "conv1_relu_pool", conv1_pool.conv1_relu_pool_plain),
             (lstm_fwd, "lstm_fwd_scan", lstm_fwd.lstm_fwd_scan_plain),
             (decode_step, "fused_decode_tail",
              decode_step.fused_decode_tail_plain),
             (greedy_loop, "fused_greedy_loop",
              greedy_loop.fused_greedy_loop_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, f in swaps:
            setattr(m, n, f)
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ------------------------------------------------------------ phase 2

def kernel_checks(dev, results: dict) -> None:
    """Each kernel vs its plain version at the main path's shapes."""
    import torch

    from aocr_torch import weights
    from aocr_torch.ops.cuda import (conv1_pool, decode_step, greedy_loop,
                                     lstm_fwd)

    g = torch.Generator().manual_seed(7)
    rand = lambda *s, lo=-1.0, hi=1.0: (torch.rand(*s, generator=g)
                                        * (hi - lo) + lo)
    cfg = base_config()
    B, L, T = B_SERVE, W_SERVE // 4 - 1, T_MAX
    He, Hd, E = (cfg.encoder_num_hidden, cfg.decoder_num_hidden,
                 cfg.target_embedding_size)
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        # conv1: images scaled to [-1, 1], conv1's init law
        for W in (100, 81):
            x = rand(B, 32, W, 1).to(dev, dt)
            w = rand(64, 1, 3, 3, lo=-1 / 3, hi=1 / 3).to(dev)
            b = rand(64, lo=-1 / 3, hi=1 / 3).to(dev)
            got = conv1_pool.conv1_relu_pool(x, w, b)
            want = conv1_pool.conv1_relu_pool_plain(x, w, b)
            tol = 1e-5 if dt == torch.float32 else 2 ** -7
            err = (got.float() - want.float()).abs()
            check(bool((err <= tol + tol * want.float().abs()).all()),
                  f"conv1_pool {name} W={W}: max err {err.max().item()}")
            results.setdefault(("conv1_pool", name), []).append(
                err.max().item())
            log(f"check conv1_pool {name} B={B} W={W}: max_abs_err "
                f"{err.max().item():.3g} (tol {tol:.3g} abs + rel)")
        # lstm_fwd: one encoder direction, H=512, L=24
        wh = rand(He, 4 * He, lo=-He ** -0.5, hi=He ** -0.5).to(dev, dt)
        xp = rand(L, B, 4 * He).to(dev, dt)
        c0, h0 = torch.zeros(B, He, device=dev), torch.zeros(B, He, device=dev)
        tol = 1e-4 if dt == torch.float32 else 5e-2
        for reverse in (False, True):
            hs, (cf, hf) = lstm_fwd.lstm_fwd_scan(wh, xp, c0, h0, reverse)
            hs_p, (cf_p, hf_p) = lstm_fwd.lstm_fwd_scan_plain(wh, xp, c0, h0,
                                                              reverse)
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in ((hs, hs_p), (cf, cf_p), (hf, hf_p)))
            check(err <= tol, f"lstm_fwd {name} reverse={reverse}: {err}")
            results.setdefault(("lstm_fwd", name), []).append(err)
            log(f"check lstm_fwd {name} B={B} L={L} H={He} "
                f"reverse={reverse}: max_abs_err {err:.3g} (tol {tol:.3g})")
        # decoder tables from the default model's weights (numpy_model)
        p, _ = numpy_model(cfg, 3)
        tp, _ = weights.from_numpy({"decoder": p["decoder"],
                                    "projector": p["projector"]}, {}, dev)
        tables = greedy_loop.build_tables(tp["decoder"], tp["projector"], E,
                                          True, dt)
        ctx = rand(L, B, Hd).to(dev, dt)
        # tail: one step, a mix of live and frozen rows
        h = rand(B, Hd).to(dev, dt)
        prev = torch.randint(0, cfg.target_vocab_size, (B,), generator=g,
                             dtype=torch.int32).to(dev)
        ht, tok, d = decode_step.fused_decode_tail(
            h, ctx, prev, tables["wa"], tables["wc"], tables["pw"],
            tables["pb"])
        ht_p, tok_p, d_p = decode_step.fused_decode_tail_plain(
            h, ctx, prev, tables["wa"], tables["wc"], tables["pw"],
            tables["pb"])
        _, logp = decode_step.attention_logp_tail(
            h, ctx, tables["wa"], tables["wc"], tables["pw"], tables["pb"],
            dt)
        _, _, logp = decode_step.freeze_and_pick(logp, prev)
        top2 = logp.topk(2, dim=-1).values
        tol = 1e-4 if dt == torch.float32 else 3e-2
        clear = (top2[:, 0] - top2[:, 1]) > tol
        err = max((ht - ht_p).abs().max().item(), (d - d_p).abs().max().item())
        check(err <= tol, f"decode_step {name}: max err {err}")
        check(bool((tok == tok_p)[clear].all()),
              f"decode_step {name}: tokens differ beyond near-ties")
        results.setdefault(("decode_step", name), []).append(err)
        log(f"check decode_step {name} B={B} L={L} H={Hd}: max_abs_err "
            f"{err:.3g} (tol {tol:.3g}); tokens agree "
            f"{(tok == tok_p).float().mean().item():.4f} "
            f"(all rows with margin > tol)")
        # loop: the whole T-step decode; then with the EOS bias raised so
        # that about half the rows stop at step 1 (the PAD/EOS freeze beside
        # live rows of the same block), and so that every row does (each
        # block's early exit)
        c0, h0 = rand(B, Hd).to(dev), rand(B, Hd).to(dev)
        loop_args = (ctx, c0, h0, cfg.decoder_num_layers, T)
        err = check_loop(name, tables, loop_args, tol, "")
        results.setdefault(("greedy_loop", name), []).append(err)
        for frac in (0.5, 1.0):
            eos = eos_tables(tables, loop_args, frac)
            err = check_loop(name, eos, loop_args, tol,
                             f", EOS at step 1 for ~{frac:.0%} of rows")
            results[("greedy_loop", name)].append(err)


def eos_tables(tables: dict, loop_args, frac: float) -> dict:
    """A copy of the loop tables whose EOS bias makes `frac` of the rows
    emit EOS at step 1 (bisection on the plain version's first step)."""
    from aocr import vocab
    from aocr_torch.ops.cuda import greedy_loop

    ctx, c0, h0, nl, _T = loop_args
    lo, hi = -100.0, 100.0
    for _ in range(30):
        mid = (lo + hi) / 2
        t = dict(tables, pb=tables["pb"].clone())
        t["pb"][vocab.EOS] += mid
        lab, _ = greedy_loop.fused_greedy_loop_plain(ctx, c0, h0, t, nl, True,
                                                     1)
        if (lab[:, 0] == vocab.EOS).float().mean().item() < frac:
            lo = mid
        else:
            hi = mid
    t = dict(tables, pb=tables["pb"].clone())
    t["pb"][vocab.EOS] += hi
    return t


def check_loop(name: str, tables: dict, loop_args, tol: float,
               what: str) -> float:
    """greedy_loop against its plain version: rows agree up to the first
    step whose plain margin is a near-tie (< tol); after EOS a row holds
    PAD; scores of agreeing rows within stol.  Returns the score error."""
    import torch

    from aocr import vocab
    from aocr_torch.ops.cuda import greedy_loop

    ctx, c0, h0, nl, T = loop_args
    B = ctx.shape[1]
    lab, sc = greedy_loop.fused_greedy_loop(ctx, c0, h0, tables, nl, True, T)
    lab_p, sc_p, margin = greedy_loop.fused_greedy_loop_plain(
        ctx, c0, h0, tables, nl, True, T, return_margins=True)
    differ = lab != lab_p
    first = torch.where(differ.any(1), differ.float().argmax(1),
                        torch.full_like(differ[:, 0], T, dtype=torch.long))
    for r in differ.any(1).nonzero().flatten().tolist():
        check(margin[r, first[r]].item() < tol,
              f"greedy_loop {name}{what}: row {r} differs at step "
              f"{first[r].item()} with margin {margin[r, first[r]]}")
    ended = (lab == vocab.EOS).cumsum(1) > 0
    after = torch.cat([torch.zeros_like(ended[:, :1]), ended[:, :-1]], 1)
    check(bool((lab[after] == vocab.PAD).all()),
          f"greedy_loop {name}{what}: a token after EOS is not PAD")
    same = ~differ.any(1)
    err = (sc - sc_p)[same].abs().max().item()
    stol = 1e-3 if tables["wa"].dtype == torch.float32 else 0.5
    check(err <= stol, f"greedy_loop {name}{what}: score err {err}")
    steps = (lab != vocab.PAD).sum(1).float()
    log(f"check greedy_loop {name} B={B} T={T} L={ctx.shape[0]} "
        f"H={ctx.shape[2]}{what}: rows identical "
        f"{same.float().mean().item():.4f} (the rest diverge at a near-tie "
        f"< {tol:.3g}); rows ended by EOS {ended[:, -1].float().mean():.4f},"
        f" mean steps {steps.mean().item():.2f}; score max_abs_err "
        f"{err:.3g} (tol {stol:.3g})")
    return err


# ------------------------------------------------------------ phase 3

def end_to_end(dev, seed: int):
    """Drive AttentionOCR.recognize; returns (launch counts, the models,
    the requests)."""
    import numpy as np
    import torch

    from aocr_torch import weights
    from aocr_torch.api import AttentionOCR
    from aocr_torch.ops import cuda

    base = base_config()
    np_params, np_stats = numpy_model(base, seed)
    rs = np.random.RandomState(seed + 1)
    requests = [word_images(rs, n, W_SERVE) for n in (1, 8, 32, B_SERVE)]
    mixed = [im for w in (100, 81, 121, 100, 81, 181, 100, 81)
             for im in word_images(rs, 2, w)]
    requests.append(mixed)

    def model(dtype, route):
        cfg = base.replace(compute_dtype=dtype, pallas_greedy=route)
        p, s = weights.from_numpy(np_params, np_stats)
        return AttentionOCR(cfg, p, s, device=dev)

    models = {(dt, r): model(dt, r) for dt in ("bfloat16", "float32")
              for r in ("loop", "tail")}
    cuda.reset_launch_counts()
    outs = {k: [m.recognize(req) for req in requests]
            for k, m in models.items()}
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    log(f"main path launch counts: {counts}")
    for k, v in counts.items():
        check(v > 0, f"kernel {k} never launched on the recognize path")

    for (dt, route), res in outs.items():
        for req, (words, scores) in zip(requests, res):
            check(len(words) == len(req) and scores.shape == (len(req),),
                  "recognize returned the wrong number of results")
            check(bool(np.isfinite(scores).all()), "non-finite scores")
            check(bool((scores <= 0).all()), "log-prob scores above 0")
    with plain_route():
        plain = {k: [m.recognize(req) for req in requests]
                 for k, m in models.items()}
    for (dt, route), res in outs.items():
        got = [w for words, _ in res for w in words]
        want = [w for words, _ in plain[(dt, route)] for w in words]
        agree = float(np.mean([a == b for a, b in zip(got, want)]))
        lens = [len(w) for w in got]
        log(f"e2e {dt} {route}: {len(got)} transcripts, {len(set(got))} "
            f"distinct, mean length {np.mean(lens):.2f}; agreement with "
            f"the plain route on the card {agree:.4f}")
        if dt == "float32":
            check(got == want, f"float32 {route}: kernel and plain routes "
                               "disagree")
            dsc = max(np.abs(a[1] - b[1]).max() for a, b in
                      zip(res, plain[(dt, route)]))
            check(dsc <= 1e-3, f"float32 {route}: score gap {dsc}")
    # a reference on a small input: the port on the CPU (plain versions)
    small = requests[2][:4]
    ref = AttentionOCR(models[("float32", "loop")].cfg,
                       *weights.from_numpy(np_params, np_stats), device="cpu")
    want_w, want_s = ref.recognize(small)
    for route in ("loop", "tail"):
        got_w, got_s = models[("float32", route)].recognize(small)
        check(got_w == want_w, f"float32 {route}: card and CPU disagree")
        check(bool(np.allclose(got_s, want_s, rtol=1e-4, atol=1e-3)),
              f"float32 {route}: card and CPU scores differ")
    log(f"e2e float32 card == CPU on 4 images: {want_w}")
    return counts, models, requests


# ------------------------------------------------------------ phase 4

def timings(dev, models, requests, card: str) -> dict:
    import numpy as np
    import torch

    from aocr_torch.ops.cuda import (conv1_pool, decode_step, greedy_loop,
                                     lstm_fwd)

    g = torch.Generator().manual_seed(11)
    rand = lambda *s: torch.rand(*s, generator=g) * 2 - 1
    cfg = base_config()
    B, L, T = B_SERVE, W_SERVE // 4 - 1, T_MAX
    He, Hd, E = (cfg.encoder_num_hidden, cfg.decoder_num_hidden,
                 cfg.target_embedding_size)
    nl = cfg.decoder_num_layers
    ms = {}
    for dt in (torch.float32, torch.bfloat16):
        name = "f32" if dt == torch.float32 else "bf16"
        x = rand(B, 32, W_SERVE, 1).to(dev, dt)
        w, b = (rand(64, 1, 3, 3) / 3).to(dev), (rand(64) / 3).to(dev)
        pairs = {"conv1_pool": (lambda: conv1_pool.conv1_relu_pool(x, w, b),
                                lambda: conv1_pool.conv1_relu_pool_plain(
                                    x, w, b), 20)}
        wh = (rand(He, 4 * He) * He ** -0.5).to(dev, dt)
        xp = rand(L, B, 4 * He).to(dev, dt)
        z = torch.zeros(B, He, device=dev)
        pairs["lstm_fwd"] = (
            lambda: lstm_fwd.lstm_fwd_scan(wh, xp, z, z, False),
            lambda: lstm_fwd.lstm_fwd_scan_plain(wh, xp, z, z, False), 10)
        m = models[("float32" if dt == torch.float32 else "bfloat16", "loop")]
        tables = greedy_loop.build_tables(
            m.params["decoder"], m.params["projector"], E, True, dt)
        ctx = rand(L, B, Hd).to(dev, dt)
        h = rand(B, Hd).to(dev, dt)
        prev = torch.full((B,), 5, dtype=torch.int32, device=dev)
        args = (h, ctx, prev, tables["wa"], tables["wc"], tables["pw"],
                tables["pb"])
        pairs["decode_step"] = (lambda: decode_step.fused_decode_tail(*args),
                                lambda: decode_step.fused_decode_tail_plain(
                                    *args), 20)
        c0, h0 = rand(B, Hd).to(dev), rand(B, Hd).to(dev)
        loop_args = (ctx, c0, h0, tables, nl, True, T)
        lab, _ = greedy_loop.fused_greedy_loop(*loop_args)
        steps = int((lab != 0).sum(1).max().item())
        pairs["greedy_loop"] = (
            lambda: greedy_loop.fused_greedy_loop(*loop_args),
            lambda: greedy_loop.fused_greedy_loop_plain(*loop_args), 3)
        for k, (fk, fp, n) in pairs.items():
            # plain, kernel, kernel, plain
            p1 = cuda_ms(fp, max(1, n // 2), 1)
            k1 = cuda_ms(fk, n)
            k2 = cuda_ms(fk, n)
            p2 = cuda_ms(fp, max(1, n // 2), 1)
            ms[(k, name)] = (min(k1, k2), min(p1, p2))
            extra = f" ({steps} of {T} steps run)" if k == "greedy_loop" else ""
            log(f"time {k} {name}: kernel {k1:.4f} / {k2:.4f} ms, plain "
                f"{p1:.4f} / {p2:.4f} ms{extra}")
        eos = eos_tables(tables, (ctx, c0, h0, nl, T), 1.0)
        ke = cuda_ms(lambda: greedy_loop.fused_greedy_loop(
            ctx, c0, h0, eos, nl, True, T), 10)
        log(f"time greedy_loop {name}, every row EOS at step 1 (each block's "
            f"early exit): kernel {ke:.4f} ms")

    m = models[("bfloat16", "loop")]
    batch = requests[3]
    m.recognize(batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        words, _ = m.recognize(batch)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    mean_len = float(np.mean([len(w) for w in words]))
    log(f"recognize bf16 loop B={len(batch)} W={W_SERVE} T={T_MAX}: "
        f"{len(batch) / med:.1f} images/s (median of 5: {med * 1e3:.2f} ms; "
        f"mean transcript length {mean_len:.2f}) on {card}")
    profile_recognize(m, batch)
    for dt, route in (("bfloat16", "tail"), ("float32", "loop")):
        mm = models[(dt, route)]
        mm.recognize(batch)
        t0 = time.perf_counter()
        mm.recognize(batch)
        el = time.perf_counter() - t0
        log(f"recognize {dt} {route} B={len(batch)}: "
            f"{len(batch) / el:.1f} images/s ({el * 1e3:.2f} ms, one run)")
    return ms


def profile_recognize(model, batch) -> None:
    """Where one recognize call spends its time: device time by kernel
    (torch.profiler / CUPTI) against the host wall clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.recognize(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(k[1] for k in kernels)
    if not kernels:
        log("profile recognize: device time not measured (no CUDA events)")
        return
    log(f"profile recognize bf16 loop B={len(batch)}: device busy "
        f"{busy:.2f} ms of {wall_ms:.2f} ms wall (profiled)")
    for name, ms, n in sorted(kernels, key=lambda k: -k[1])[:10]:
        log(f"  {ms:9.3f} ms  x{n:<4d} {name[:90]}")


# ------------------------------------------------------------ main

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "aocr_torch", "csrc")):
        print("chip_smoke.py: run it from a checkout of the repo "
              "(aocr_torch/ not found)", file=sys.stderr)
        return 2
    # aocr/__init__ imports jax when JAX_PLATFORM_NAME=cpu; the port must not
    os.environ.pop("JAX_PLATFORM_NAME", None)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    from aocr_torch.ops import cuda

    t0 = time.perf_counter()
    lib = cuda.build(verbose=True)
    cuda.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s -> "
        f"{os.path.relpath(lib, ROOT)}")

    results: dict = {}
    kernel_checks(dev, results)
    counts, models, requests = end_to_end(dev, args.seed)
    ms = timings(dev, models, requests, card)

    check("jax" not in sys.modules, "jax was imported")
    main_dtype = {"conv1_pool": "bf16", "lstm_fwd": "bf16",
                  "decode_step": "f32", "greedy_loop": "bf16"}
    replaces = {"conv1_pool": "aocr/ops/pallas/conv1_pool.py:244",
                "lstm_fwd": "aocr/ops/pallas/lstm_fwd.py:158",
                "decode_step": "aocr/ops/pallas/decode_step.py:199",
                "greedy_loop": "aocr/ops/pallas/greedy_loop.py:362"}
    kernels = []
    for k in cuda.KERNELS:
        d = main_dtype[k]
        kernels.append({
            "name": k, "route": "cuda", "source": f"aocr_torch/csrc/{k}.cu",
            "replaces": replaces[k], "launches": counts[k],
            "max_abs_err": max(results[(k, d)]), "dtype": d,
            "ms": ms[(k, d)][0], "plain_ms": ms[(k, d)][1]})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
