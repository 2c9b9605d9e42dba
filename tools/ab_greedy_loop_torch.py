#!/usr/bin/env python3
"""Time one of aocr_torch's kernels from several checkouts on one card.

    python3 tools/ab_greedy_loop_torch.py DIR_A DIR_B [--turns 4]
        [--kernel greedy_loop|beam_loop|tf_fwd|tf_bwd|lstm_bwd|
                  conv1_pool_bwd|conv1_pool|beam_step|decode_step|
                  conv1_pool_dx] [--K 5]

Each DIR is a checkout that holds aocr_torch/.  greedy_loop and beam_loop
are timed at the recognition shape (L=24, T=50, the default decoder:
H=1024, 2 layers, input feed, V=39, PAD and EOS biased off so that every
step runs) at B=512 and B=1 in float32 and bf16: greedy_loop with
decode_step (the per-step tail, csrc/decode_tail.cuh) at B=512 in bf16
beside it, or beam_loop at K=5 from a random t=1 state.  tf_fwd and
tf_bwd are timed at the train step's shape (L=24, T=11, the same
decoder, random weights at the init laws): tf_fwd with its residuals at
B=400 and without (score's call) at B=400, 32 and 1; tf_bwd on the
residuals of the plain forward at B=400.  lstm_bwd is timed at the
train step's encoder (L=24, H=512) on the plain forward's residuals at
B=400 and 33, conv1_pool_bwd at the train step's B=400 crops of 32 x 100
(the whole call, then each of its kernels by the profiler, as for
conv1_pool and beam_step).  conv1_pool is timed at the recognition shape (B=512 crops of 32 x 100), with a
digest of its output (bit-identical outputs give the same digest in every
checkout); beam_step at B=512 with K beams (--K, 5 or 10), every beam
live, at the recognition decoder's shape.  decode_step at the same shape
at B=512, 32, 8 and 1, every row live (with the weights packed once, as
a decode calls it, where the checkout packs them), then the bf16
tail-route recognize (pallas_greedy="tail", decode_step once a step) of
512 random crops of 32 x 100 on a model of random weights, so that every
row runs all 50 steps, the median of 5; conv1_pool_dx at the train
step's B=400 crops of 32 x 100, with a digest of its taps.
In turns A, B, B, A, ..., each
turn in a fresh process that builds that checkout's kernels (CUDA events
over back-to-back launches).  Prints one line a turn and the card's name
and power limit.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

TURN = r"""
import json, math, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
from aocr_torch import weights
from aocr_torch.ops import cuda
from aocr_torch.ops.cuda import decode_step, greedy_loop
cuda.build()
dev = torch.device("cuda")
rs = np.random.RandomState(3)
H, E, V, L, T = 1024, 20, 39, 24, 50
u = lambda b, *s: rs.uniform(-b, b, s).astype(np.float32)
layer = lambda i: {{"wi": u(i ** -0.5, i, 4 * H), "bi": u(i ** -0.5, 4 * H),
                    "wh": u(H ** -0.5, H, 4 * H), "bh": u(H ** -0.5, 4 * H)}}
dec = {{"embedding": rs.standard_normal((V, E)).astype(np.float32),
       "layers": [layer(E + H), layer(H)], "w_a": u(H ** -0.5, H, H),
       "w_c": u((2 * H) ** -0.5, 2 * H, H)}}
proj = {{"w": u(2 * H ** -0.5, H, V), "b": u(H ** -0.5, V)}}
tp, _ = weights.from_numpy({{"decoder": dec, "projector": proj}}, {{}}, dev)
g = torch.Generator().manual_seed(11)
out = {{}}

# each kernel's device time a call whose name holds key (the profiler),
# into out under label
def kernel_ms(run, key, label, n=20):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if key in e.key and t > 0:
            out[f"  {{e.key.split('(')[0][-40:]}} {{label}}"] = (
                t / e.count / 1000)

def ms(run, n=3):
    run()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        run()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n

for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
    r = lambda *s: (torch.rand(*s, generator=g) * 2 - 1).to(dev)
    if {kernel!r} == "lstm_bwd":
        from aocr_torch.ops.cuda import lstm_bwd, lstm_fwd
        He = 512
        wh = (r(He, 4 * He) * He ** -0.5).to(dt)
        for B in (400, 33):
            z = torch.zeros(B, He, device=dev)
            _, _, (ifog, cs) = lstm_fwd.lstm_fwd_scan_plain(
                wh, r(L, B, 4 * He).to(dt), z, z, False, collect=True)
            largs = (wh, r(L, B, He) * 0.1, ifog, cs, z, r(B, He) * 0.1,
                     r(B, He) * 0.1, False)
            out[f"lstm_bwd {{name}} B={{B}}"] = ms(
                lambda: lstm_bwd.lstm_bwd_scan(*largs), 20)
        continue
    if {kernel!r} == "conv1_pool":
        import hashlib
        from aocr_torch.ops.cuda import conv1_pool
        B = 512
        x = r(B, 32, 100, 1).to(dt)
        w, b = r(64, 1, 3, 3) / 3, r(64) / 3
        run = lambda: conv1_pool.conv1_relu_pool(x, w, b)
        out[f"conv1_pool {{name}} B={{B}}"] = ms(run, 50)
        kernel_ms(run, "conv1_pool", name)
        y = run().float().cpu().numpy()
        out[f"conv1_pool {{name}} digest"] = hashlib.sha256(
            y.tobytes()).hexdigest()[:16]
        continue
    if {kernel!r} == "beam_step":
        from aocr_torch.ops.cuda import beam_step
        t = greedy_loop.build_tables(tp["decoder"], tp["projector"], E, True,
                                     dt)
        B, K = 512, {K}
        ctx = r(L, B, H).to(dt)
        h = r(B, K * H).to(dt)
        prev = torch.full((B, K), 5, dtype=torch.int32, device=dev)
        sc = (-torch.arange(K, dtype=torch.float32,
                            device=dev)).expand(B, K).contiguous()
        run = lambda: beam_step.fused_beam_tail(
            ctx, h, prev, sc, t["wa"], t["wc"], t["pw"], t["pb"], K, V)
        out[f"beam_step {{name}} B={{B}} K={{K}}"] = ms(run, 20)
        kernel_ms(run, "beam", name)
        continue
    if {kernel!r} == "conv1_pool_dx":
        import hashlib
        from aocr_torch.ops.cuda import conv1_pool_dx
        B = 400
        x = r(B, 32, 100, 1).to(dt)
        w, b = r(64, 1, 3, 3) / 3, r(64) / 3
        dy = r(B, 16, 50, 64).to(dt)
        run = lambda: conv1_pool_dx.conv1_relu_pool_dx16(x, w, b, dy)
        out[f"conv1_pool_dx {{name}} B={{B}}"] = ms(run, 50)
        kernel_ms(run, "conv1_pool_dx", name)
        y = run().float().cpu().numpy()
        out[f"conv1_pool_dx {{name}} digest"] = hashlib.sha256(
            y.tobytes()).hexdigest()[:16]
        continue
    if {kernel!r} == "decode_step":
        import time
        from aocr_torch.api import AttentionOCR
        from aocr_torch.config import Config
        t = greedy_loop.build_tables(tp["decoder"], tp["projector"], E, True,
                                     dt)
        w = (t["wa"], t["wc"], t["pw"], t["pb"])
        for B in (512, 32, 8, 1):
            ctx = r(L, B, H).to(dt)
            h = r(B, H).to(dt)
            prev = torch.full((B,), 5, dtype=torch.int32, device=dev)
            kw = {{}}
            if hasattr(decode_step, "pack_weights"):
                kw["packed"] = decode_step.pack_weights(w[0], w[1], ctx,
                                                        w[2], V)
            run = lambda: decode_step.fused_decode_tail(h, ctx, prev, *w,
                                                        **kw)
            out[f"decode_step {{name}} B={{B}}"] = ms(run, 20)
            if B == 512:
                kernel_ms(run, "decode_step", name)
                kernel_ms(run, "step_cluster", name)
        if name == "bf16":
            m = AttentionOCR.create(Config(
                input_feed=True, max_decoder_l=T, compute_dtype="bfloat16",
                pallas_greedy="tail"), device=dev)
            imgs = rs.randint(0, 256, (512, 32, 100, 1)).astype(np.uint8)
            m.recognize(imgs)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m.recognize(imgs)
                times.append((time.perf_counter() - t0) * 1e3)
            out["recognize bf16 tail B=512 (host ms, median of 5)"] = \
                float(np.median(times))
        continue
    if {kernel!r} == "conv1_pool_bwd":
        from aocr_torch.ops.cuda import conv1_pool_bwd
        B = 400
        x = r(B, 32, 100, 1).to(dt)
        w, b = r(64, 1, 3, 3) / 3, r(64) / 3
        dy = r(B, 16, 50, 64).to(dt)
        run = lambda: conv1_pool_bwd.conv1_relu_pool_bwd(x, w, b, dy)
        out[f"conv1_pool_bwd {{name}} B={{B}}"] = ms(run, 50)
        # the call's kernels apart (the first port's makes two launches)
        kernel_ms(run, "conv1_pool_bwd", name)
        continue
    if {kernel!r} in ("tf_fwd", "tf_bwd"):
        from aocr_torch.ops.cuda import tf_bwd, tf_fwd
        d = {{k: v.to(dt) if v.dim() == 2 else v
             for k, v in tp["decoder"]["layers"][1].items()}}
        l0 = tp["decoder"]["layers"][0]
        wfh0 = torch.cat([l0["wi"][E:], l0["wh"]]).to(dt)
        rest = [(torch.cat([d["wi"], d["wh"]]), d["bi"], d["bh"])]
        wa = tp["decoder"]["w_a"].to(dt)
        wc = tp["decoder"]["w_c"].to(dt)
        for B in ((400,) if {kernel!r} == "tf_bwd" else (400, 32, 1)):
            r = lambda *s: (torch.rand(*s, generator=g) * 2 - 1).to(dev)
            fargs = (r(L, B, H).to(dt), wfh0, rest, wa, wc,
                     r(11, B, 4 * H).to(dt), r(B, H), r(B, H), True)
            if {kernel!r} == "tf_fwd":
                if B == 400:
                    out[f"tf_fwd {{name}} B=400 collect"] = ms(
                        lambda: tf_fwd.decoder_fwd_scan(*fargs, True), 5)
                out[f"tf_fwd {{name}} B={{B}}"] = ms(
                    lambda: tf_fwd.decoder_fwd_scan(*fargs, False), 5)
                continue
            htl, _, ifog, cs, alpha, _ = tf_fwd.decoder_fwd_scan_plain(
                *fargs, True)
            bargs = (fargs[0], wfh0, [rest[0][0]], wc, wa,
                     r(11, B, H) * 0.1, htl, alpha, ifog, cs, fargs[6], True)
            out[f"tf_bwd {{name}} B={{B}}"] = ms(
                lambda: tf_bwd.decoder_bwd_scan(*bargs), 5)
        continue
    t = greedy_loop.build_tables(tp["decoder"], tp["projector"], E, True, dt)
    t["pb"][[0, 2]] = -1e4  # PAD and EOS biased off: all T steps run
    if {kernel!r} == "beam_loop":
        from aocr_torch.models.decoder import DecoderState
        from aocr_torch.ops.cuda import beam_loop
        K = 5
        for B in (512, 1):
            r = lambda *s: (torch.rand(*s, generator=g) * 2 - 1).to(dev)
            ctx = r(L, B, H).to(dt)
            st = DecoderState(attn=r(B, H), cs=(r(B, H), r(B, H)),
                              hs=(r(B, H), r(B, H)))
            tok0 = torch.randint(3, V, (B, K), generator=g,
                                 dtype=torch.int32).to(dev)
            sc0 = -torch.arange(K, dtype=torch.float32,
                                device=dev).expand(B, K).contiguous()
            out[f"beam_loop {{name}} B={{B}}"] = ms(
                lambda: beam_loop.fused_beam_loop(
                    ctx, st, tok0, sc0, None, t, 2, True, T, K, False), 2)
        continue
    for B in (512, 1):
        ctx = (torch.rand(L, B, H, generator=g) * 2 - 1).to(dev, dt)
        c0 = (torch.rand(B, H, generator=g) * 2 - 1).to(dev)
        h0 = (torch.rand(B, H, generator=g) * 2 - 1).to(dev)
        out[f"{{name}} B={{B}}"] = ms(lambda: greedy_loop.fused_greedy_loop(
            ctx, c0, h0, t, 2, True, T))
    if name == "bf16":
        B = 512
        ctx = (torch.rand(L, B, H, generator=g) * 2 - 1).to(dev, dt)
        h = (torch.rand(B, H, generator=g) * 2 - 1).to(dev, dt)
        prev = torch.full((B,), 5, dtype=torch.int32, device=dev)
        out["decode_step bf16 B=512"] = ms(lambda: decode_step.fused_decode_tail(
            h, ctx, prev, t["wa"], t["wc"], t["pw"], t["pb"]), 20)
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs=2)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--kernel", default="greedy_loop",
                    choices=("greedy_loop", "beam_loop", "tf_fwd",
                             "tf_bwd", "lstm_bwd", "conv1_pool_bwd",
                             "conv1_pool", "beam_step", "decode_step",
                             "conv1_pool_dx"))
    ap.add_argument("--K", type=int, default=5,
                    help="beam_step's beams (5 or 10)")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    order = [args.dirs[(t + t // 2) % 2] for t in range(args.turns)]
    for root in order:
        root = os.path.abspath(root)
        proc = subprocess.run(
            [sys.executable, "-c",
             TURN.format(root=root, kernel=args.kernel, K=args.K)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        ms = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{root}: " + ", ".join(
            f"{k} {v:.4f} ms" if isinstance(v, float) else f"{k} {v}"
            for k, v in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
