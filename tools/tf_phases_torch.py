#!/usr/bin/env python3
"""Where a step of aocr_torch's teacher-forced kernels (tf_fwd, tf_bwd)
spends its time, and A/B variants of their source, on one card.

    python3 tools/tf_phases_torch.py [VARIANT ...]

As tools/greedy_loop_phases_torch.py (whose VARIANTS, of
csrc/decoder_cluster.cuh, apply here too, with "bt80": the tile of 80
rows wherever the plan can take it), for csrc/tf_fwd.cu and
csrc/tf_bwd.cu: each variant is built with -DDC_PROBES into
build/tf_phases/ and called through its own C entry points at the train
step's shape (L=24, T=11, the default decoder: H=1024, 2 layers, input
feed; random weights at the init laws) at B=400 in bf16 and float32:
one line each with the largest error against the plain version (of the
plain version's largest magnitude), the CUDA-event ms of the probed
kernel, that of the package's own (unprobed) build of the same shape,
the variant's plan, and the cycles a step of each phase, per block (the
products on landed chunks, the waits for the stream, the epilogues: gate
math and its backward, the stores; the row-split attention or its
backward; the cluster-barrier waits; issuing the chunks' copies).
Prints the card's name, power limit and SM clock.  Needs one CUDA device
and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

import greedy_loop_phases_torch as glp

from aocr_torch.ops.cuda import greedy_loop, tf_bwd, tf_fwd  # noqa: E402

OUT = os.path.join(glp.ROOT, "build", "tf_phases")
# the 80-row tile wherever the plan can take it (greedy's at B=512)
glp.VARIANTS["bt80"] = [(
    "decoder_cluster.cuh",
    "    if (!dc_tile(opt, U, f32, &bt, &rt)) continue;\n",
    "    if (!dc_tile(opt, U, f32, &bt, &rt) || bt != 80) continue;\n")]
ENTRY = """
extern "C" int phases_read(unsigned long long* o) {{
  return (int)cudaMemcpyFromSymbol(o, aocr::{sym}, sizeof(aocr::{sym}));
}}
extern "C" int phases_zero() {{
  unsigned long long z[aocr::DC_NPHASES + 1] = {{0}};
  return (int)cudaMemcpyToSymbol(aocr::{sym}, z, sizeof(z));
}}
"""
KERNELS = {"tf_fwd": ("tf_fwd.cu", "tf_prof", tf_fwd, 17),
           "tf_bwd": ("tf_bwd.cu", "tb_prof", tf_bwd, 19)}


def inputs(dt, B, g, dev):
    """The train step's decoder operands at the init laws, the forward's
    arguments and the backward's (on the plain forward's residuals)."""
    H, L, T = 1024, 24, 11
    r = lambda b, *s: ((torch.rand(*s, generator=g) * 2 - 1) * b).to(dev)
    wfh0 = r(H ** -0.5, 2 * H, 4 * H).to(dt)
    rest = [(r(H ** -0.5, 2 * H, 4 * H).to(dt), r(H ** -0.5, 4 * H),
             r(H ** -0.5, 4 * H))]
    wa, wc = r(H ** -0.5, H, H).to(dt), r((2 * H) ** -0.5, 2 * H, H).to(dt)
    ctx, xp = r(1, L, B, H).to(dt), r(1, T, B, 4 * H).to(dt)
    c0, h0 = r(1, B, H), r(1, B, H)
    fargs = (ctx, wfh0, rest, wa, wc, xp, c0, h0, True, True)
    htl, _, ifog, cs, alpha, _ = tf_fwd.decoder_fwd_scan_plain(*fargs)
    bargs = (ctx, wfh0, [rest[0][0]], wc, wa, r(0.1, T, B, H), htl, alpha,
             ifog, cs, c0, True)
    return fargs, bargs


def rel(got, want) -> float:
    e = max(float((a.float() - b.float()).abs().max())
            for a, b in zip(got, want))
    return e / max(float(b.float().abs().max()) for b in want)


def run(kernel, name):
    _src, _sym, mod, nptr = KERNELS[kernel]
    lib = ctypes.CDLL(os.path.join(OUT, kernel, f"{name}.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    for suffix in ("f32", "bf16"):
        getattr(lib, f"aocr_{kernel}_{suffix}").argtypes = \
            [P] * nptr + [I] * 6 + [P]
    getattr(lib, f"aocr_{kernel}_plan").argtypes = [I] * 5 + \
        [ctypes.POINTER(I)]
    dev, H, L, T, nl, B = torch.device("cuda"), 1024, 24, 11, 2, 400
    g = torch.Generator().manual_seed(21)
    for dt in (torch.bfloat16, torch.float32):
        fargs, bargs = inputs(dt, B, g, dev)
        out = (ctypes.c_int * 10)()
        getattr(lib, f"aocr_{kernel}_plan")(H, B, int(dt == torch.float32),
                                            L, nl, out)
        p = greedy_loop.Plan(*out[:9])  # the variant's own plan
        scratch = torch.zeros((mod.scratch_bytes(p, dt, H, nl),),
                              dtype=torch.uint8, device=dev)
        st = torch.cuda.current_stream().cuda_stream
        fn = getattr(lib, f"aocr_{kernel}_"
                     + ("f32" if dt == torch.float32 else "bf16"))
        if kernel == "tf_fwd":
            ctx, wfh0, rest, wa, wc, xp, c0, h0 = fargs[:8]
            w = greedy_loop.pack_weights(
                {"wfh0": wfh0, "wx": [rest[0][0]], "wa": wa, "wc": wc}, p, nl,
                True)
            res = [torch.empty((T, B, H), device=dev),
                   torch.empty((nl, T, B, H), dtype=dt, device=dev),
                   torch.empty((nl, T, B, 4 * H), dtype=dt, device=dev),
                   torch.empty((nl, T, B, H), dtype=dt, device=dev),
                   torch.empty((T, B, L), device=dev),
                   torch.empty((T, B, H), dtype=dt, device=dev)]
            bi, bh = rest[0][1][None], rest[0][2][None]

            def call():
                scratch.zero_()
                return fn(ctx.data_ptr(), c0.data_ptr(), h0.data_ptr(),
                          xp.data_ptr(), w["w0"].data_ptr(),
                          w["wl"].data_ptr(), bi.data_ptr(), bh.data_ptr(),
                          w["wq"].data_ptr(), w["wc"].data_ptr(),
                          *(x.data_ptr() for x in res), scratch.data_ptr(),
                          L, B, H, T, nl, 1, st)
            want = tf_fwd.decoder_fwd_scan_plain(*fargs)
            pkg = lambda: tf_fwd.decoder_fwd_scan(*fargs)
        else:
            (ctx, wfh0, rest_w, wc, wa, dys, htl, alpha, ifog, cs, c0,
             _) = bargs
            w = tf_bwd.pack_weights(wfh0, rest_w, wc, wa, p, True)
            res = [torch.empty((nl, T, B, 4 * H), dtype=dt, device=dev)] + \
                [torch.empty((T, B, H), dtype=dt, device=dev)
                 for _ in range(3)] + \
                [torch.empty((T, B, L), device=dev),
                 torch.empty((B, H), device=dev),
                 torch.empty((B, H), device=dev)]

            def call():
                scratch.zero_()
                return fn(ctx.data_ptr(), w["w0"].data_ptr(),
                          w["wl"].data_ptr(), w["wct"].data_ptr(),
                          w["wat"].data_ptr(), dys.data_ptr(),
                          htl.data_ptr(), alpha.data_ptr(), ifog.data_ptr(),
                          cs.data_ptr(), c0.data_ptr(),
                          *(x.data_ptr() for x in res), scratch.data_ptr(),
                          L, B, H, T, nl, 1, st)
            want = tf_bwd.decoder_bwd_scan_plain(*bargs)
            pkg = lambda: tf_bwd.decoder_bwd_scan(*bargs)
        rc = call()
        if rc:
            print(f"{kernel} {name} {dt} B={B}: launch error {rc}",
                  flush=True)
            continue
        torch.cuda.synchronize()
        err = rel(res, want)
        ms = glp.cuda_ms(call)
        pkg_ms = glp.cuda_ms(pkg)
        lib.phases_zero()
        call()
        torch.cuda.synchronize()
        n = len(glp.PHASES)
        prof = (ctypes.c_ulonglong * (n + 1))()
        lib.phases_read(prof)
        per = [prof[i] / prof[n] / T for i in range(n)]
        print(f"{kernel} {name} {str(dt)[6:]} B={B} (bt={p.bt}, "
              f"{p.clusters} clusters, kc={p.kc} x {p.stages}, "
              f"cres={p.cres}): max err {err:.3g} of the plain scale, "
              f"{ms:.4f} ms probed, {pkg_ms:.4f} ms unprobed (the "
              f"package's plan); cycles a step: "
              + ", ".join(f"{glp.PHASES[i]} {per[i]:.0f}" for i in range(n)
                          if per[i] > 0)
              + f"; total {sum(per):.0f}", flush=True)


def main() -> int:
    names = sys.argv[1:] or ["kernel", "bt80"]
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for kernel, (src, sym, _, _) in KERNELS.items():
        glp.build(names, source=src, entry=ENTRY.format(sym=sym),
                  out=os.path.join(OUT, kernel))
    for kernel in KERNELS:
        for name in names:
            run(kernel, name)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
