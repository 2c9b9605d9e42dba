#!/usr/bin/env python3
"""Where a step of aocr_torch's lstm_bwd kernel spends its time, and A/B
variants of its source, on one card.

    python3 tools/lstm_bwd_phases_torch.py [VARIANT ...]

Each VARIANT (default: all) is csrc/lstm_bwd.cu with a few lines replaced
(VARIANTS below), compiled with -DLB_PROBES: `clock64()` probes that
thread 0 of every block of the cluster kernel sums over the steps, by
phase: the gate backward (with its stores and the next step's loads),
the product (mma and the partials' stores), the cluster-barrier waits,
and the partials read back and summed.  Each build lands in
build/lstm_bwd_phases/ and is called through its own C entry points at
L=24, H=512 in bf16, at the train step's batch (B=400) and B=512, 33 and
1: one line each with the largest error
against the plain version (of the plain version's largest magnitude),
the CUDA-event ms, the plan's tile and the cycles a step of each phase,
a block.  Prints the card's name, power limit and SM clock.  Needs one
CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from aocr_torch.ops import cuda  # noqa: E402
from aocr_torch.ops.cuda import lstm_bwd, lstm_fwd  # noqa: E402

SRC = os.path.join(ROOT, "aocr_torch", "csrc", "lstm_bwd.cu")
OUT = os.path.join(ROOT, "build", "lstm_bwd_phases")
PHASES = ["gate backward", "barrier", "sums", "product"]
# name: [(text in csrc/lstm_bwd.cu, its replacement), ...]
VARIANTS = {
    "kernel": [],
    # tiles of at most 32 rows (two waves at B=400)
    "bt32": [("constexpr int LB_BT_MAX = 64;", "constexpr int LB_BT_MAX = 32;")],
    # no partials stored (wrong results): the product's multiply alone
    "nostore": [("          *reinterpret_cast<float2*>(dst + r * U + u) = "
                 "make_float2(v[0], v[1]);\n"
                 "          *reinterpret_cast<float2*>(dst + (r + 8) * U + u) =\n"
                 "              make_float2(v[2], v[3]);\n",
                 "          if (v[0] == 12345.f) dst[r * U + u] = v[1];\n")],
    # fragments loaded, no mma (wrong results)
    "nomma": [("              mma_bf16(acc[mi][ni], af[mi], bf[ni / 2][2 * (ni % 2)],\n"
               "                       bf[ni / 2][2 * (ni % 2) + 1]);\n",
               "              acc[mi][ni][0] += __uint_as_float(af[mi][0] ^ bf[ni / 2][0]);\n")],
    # mma on the fragments of the first 16-deep step only (wrong results)
    "noldm": [("      for (int kk = 0; kk < 4 * U; kk += 16) {\n"
               "        uint32_t af[2][4], bf[2][4];\n",
               "      uint32_t af[2][4], bf[2][4];\n"
               "      for (int kk = 0; kk < 4 * U; kk += 16) {\n"
               "        if (kk == 0) {\n"),
              ("        ldmatrix_b_nk(bf[1], wres, ld, n0 * 8 + 16, kk, H - 1);\n",
               "        ldmatrix_b_nk(bf[1], wres, ld, n0 * 8 + 16, kk, H - 1);\n"
               "        }\n")],
    # mma alone, no fragment loads or stores (wrong results)
    "mmaonly": "nostore+noldm",
    # the product's loops alone (wrong results)
    "bare": "nostore+noldm+nomma",
    # no product at all (wrong results)
    "noproduct": [("    for (int it = warp; it < items; it += LB_WARPS) {",
                   "    for (int it = warp; it < 0; it += LB_WARPS) {")],
    # the step's inputs loaded at the gate backward, not a step ahead
    "noprefetch": [
        ("    if (s + 1 < a.L) lb_load(a, k, a.reverse ? s + 1 : a.L - 2 - s, in);",
         ""),
        ("    const bool first = lb_first(a, t);\n",
         "    const bool first = lb_first(a, t);\n    lb_load(a, k, t, in);\n")],
}
ENTRY = """
extern "C" int phases_read(unsigned long long* o) {
  return (int)cudaMemcpyFromSymbol(o, aocr::lb_prof, sizeof(aocr::lb_prof));
}
extern "C" int phases_zero() {
  unsigned long long z[aocr::LB_NPHASES + 1] = {0};
  return (int)cudaMemcpyToSymbol(aocr::lb_prof, z, sizeof(z));
}
"""


def replacements(name):
    """A variant's (old, new) pairs; a variant named "a+b" is both."""
    v = VARIANTS[name]
    if isinstance(v, str):
        return [r for part in v.split("+") for r in replacements(part)]
    return v


def build(names):
    os.makedirs(OUT, exist_ok=True)
    base = open(SRC).read()
    sources = {}
    for name in names:
        src = base
        for old, new in replacements(name):
            assert old in src, (name, old)
            src = src.replace(old, new)
        sources[name] = src
    procs = {}
    for name, src in sources.items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src + ENTRY)
        procs[name] = subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-DLB_PROBES", "-Xptxas=-v",
             "-I", os.path.dirname(SRC), "-shared", "-o",
             os.path.join(OUT, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        regs = [ln.split("Used")[1].split(",")[0].strip()
                for ln in log.splitlines() if "registers" in ln]
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and " 0 bytes spill stores" not in ln]
        print(f"{name}: nvcc rc {p.returncode}; registers {regs}"
              + (f"; {spills}" if spills else ""), flush=True)
        if p.returncode:
            print(log)


def cuda_ms(fn, n=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def run(name):
    lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.aocr_lstm_bwd_bf16.argtypes = [P] * 11 + [I] * 4 + [P]
    lib.aocr_lstm_bwd_plan.argtypes = [I] * 3 + [ctypes.POINTER(I)]
    dev, H, L, dt = torch.device("cuda"), 512, 24, torch.bfloat16
    g = torch.Generator().manual_seed(0)
    rand = lambda *s: torch.rand(*s, generator=g) * 2 - 1
    wh = (rand(H, 4 * H) * H ** -0.5).to(dev, dt)
    for B in (400, 512, 33, 1):
        xp = rand(L, B, 4 * H).to(dev, dt)
        c0 = rand(B, H).to(dev)
        _, _, (ifog, cs) = lstm_fwd.lstm_fwd_scan_plain(wh, xp, c0, c0, False,
                                                        collect=True)
        dhs = (rand(L, B, H) * 0.1).to(dev)
        dcf, dhf = (rand(B, H) * 0.1).to(dev), (rand(B, H) * 0.1).to(dev)
        want = lstm_bwd.lstm_bwd_scan_plain(wh, dhs, ifog, cs, c0, dcf, dhf,
                                            False)
        out = (ctypes.c_int * 7)()
        if lib.aocr_lstm_bwd_plan(H, B, 0, out):
            print(f"{name} B={B}: no plan", flush=True)
            continue
        p = lstm_bwd.Plan(*out[:6])
        scratch = torch.empty(max(p.scratch_bytes(), 16), dtype=torch.uint8,
                              device=dev)
        dg = torch.empty(L, B, 4 * H, device=dev, dtype=dt)
        dh0, dc0 = torch.empty_like(c0), torch.empty_like(c0)
        st = torch.cuda.current_stream().cuda_stream
        call = lambda: lib.aocr_lstm_bwd_bf16(
            wh.data_ptr(), dhs.data_ptr(), ifog.data_ptr(), cs.data_ptr(),
            c0.data_ptr(), dcf.data_ptr(), dhf.data_ptr(), dg.data_ptr(),
            dh0.data_ptr(), dc0.data_ptr(), scratch.data_ptr(), L, B, H, 0,
            st)
        rc = call()
        if rc:
            print(f"{name} B={B}: launch error {rc}", flush=True)
            continue
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max())
                  / float(b.float().abs().max())
                  for a, b in zip((dg, dh0, dc0), want))
        ms = cuda_ms(call)
        lib.phases_zero()
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        prof = (ctypes.c_ulonglong * 5)()
        lib.phases_read(prof)
        per = [prof[i] / prof[4] / L for i in range(4)]
        print(f"{name} B={B} ({lstm_bwd.ROUTE_NAMES[p.route]}, bt={p.bt}, "
              f"{p.clusters} clusters): max err {err:.3g} of the scale, "
              f"{ms:.4f} ms; cycles a step: "
              + ", ".join(f"{PHASES[i]} {per[i]:.0f}" for i in range(4))
              + f"; total {sum(per):.0f}", flush=True)


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    build(names)
    for name in names:
        run(name)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
