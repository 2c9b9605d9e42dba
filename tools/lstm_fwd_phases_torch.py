#!/usr/bin/env python3
"""Where a step of aocr_torch's lstm_fwd kernel spends its time, and A/B
variants of its source, on one card.

    python3 tools/lstm_fwd_phases_torch.py [VARIANT ...]

Each VARIANT (default: all) is csrc/lstm_fwd.cu with a few lines replaced
(VARIANTS below), compiled with `clock64()` probes that thread 0 of every
block sums over the steps: the product (x_proj loads, resident and
streamed rows), the gate math and stores, the cluster barrier and the
read-back of h.  Each build lands in build/lstm_fwd_phases/ and is called
through its own C entry points at L=24, H=512 and the main paths' batches
(B=512 collect=False, B=400 collect=True) and B=32, 1, in float32 and
bf16: one line each with the max error against the plain version, the
CUDA-event ms of the unprobed launch sequence, and the cycles a step of
each phase.  A variant that skips work (nostream) is wrong by design and
times only what it keeps.  Prints the card's name, power limit and SM
clock.  Needs one CUDA device and nvcc.
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
from aocr_torch.ops.cuda import lstm_fwd  # noqa: E402

SRC = os.path.join(ROOT, "aocr_torch", "csrc", "lstm_fwd.cu")
OUT = os.path.join(ROOT, "build", "lstm_fwd_phases")
PHASES = ["product", "gate math", "barrier", "read-back"]
SFU = """
__device__ __forceinline__ float sig_sfu(float x) {
  return __frcp_rn(1.f + __expf(-x));
}
__device__ __forceinline__ float tanh_sfu(float x) {
  return 1.f - 2.f * __frcp_rn(1.f + __expf(2.f * x));
}
__device__ __forceinline__ void gate_math_sfu(float gi, float gf, float go,
    float gg, float cp, float* c, float* h, float (&a)[4]) {
  a[0] = sig_sfu(gi); a[1] = sig_sfu(gf); a[2] = sig_sfu(go);
  a[3] = tanh_sfu(gg);
  *c = a[1] * cp + a[0] * a[3];
  *h = a[2] * tanh_sfu(*c);
}
"""
DIRECT = """
// float32: the streamed rows read straight from L2 in the FMA loop
__device__ __forceinline__ void product_fma_l2(
    float (&acc)[4 * LF_FMA_ROWS], const float* h, int ldh,
    const float* __restrict__ wh, int H, int j0, int nu, int k0, int k1,
    int r0, int u) {
  const bool ok = u < nu;
  const float* wcol = wh + j0 + u;
  const float* hr = h + r0 * ldh;
#pragma unroll 4
  for (int k = k0; k < k1; k += 4) {
    float4 hv[LF_FMA_ROWS];
#pragma unroll
    for (int r = 0; r < LF_FMA_ROWS; ++r)
      hv[r] = *reinterpret_cast<const float4*>(hr + r * ldh + k);
    float wq[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wq[kk][q] = ok && k + kk < H
                        ? __ldg(wcol + (size_t)(k + kk) * 4 * H + q * H)
                        : 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < LF_FMA_ROWS; ++r) {
        const float x = kk == 0 ? hv[r].x : kk == 1 ? hv[r].y
                        : kk == 2 ? hv[r].z : hv[r].w;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[r * 4 + q] = fmaf(x, wq[kk][q], acc[r * 4 + q]);
      }
  }
}

"""
# name: [(text in csrc/lstm_fwd.cu, its replacement), ...]
VARIANTS = {
    "kernel": [],
    # the batch tile of the first cut: at most 32 rows
    "bt32": [("constexpr int LF_BT_MAX = 64;", "constexpr int LF_BT_MAX = 32;")],
    # four stages of 16-row chunks for the streamed rows
    "chunk16": [("constexpr int LF_CHUNK = 64;", "constexpr int LF_CHUNK = 16;"),
                ("constexpr int LF_STAGES = 2;", "constexpr int LF_STAGES = 4;")],
    # exponentials on the SFU (__expf) and IEEE reciprocals in the gate math
    "sfu": [("namespace aocr {\n", "namespace aocr {\n" + SFU),
            ("          gate_math_parts(g[0], g[1], g[2], g[3], c[ti][i][e],",
             "          gate_math_sfu(g[0], g[1], g[2], g[3], c[ti][i][e],")],
    # float32's streamed rows read from L2 in the FMA loop, no staging
    "direct": [("template <typename T, typename XP>\n__global__",
                DIRECT + "template <typename T, typename XP>\n__global__"),
               ("    for (int ci = 0; ci < nchunks; ++ci) {",
                "    if constexpr (!MMA) {\n"
                "      int r0, u;\n"
                "      if (nchunks && tile_of(0, r0, u))\n"
                "        product_fma_l2(acc[0], hb, hld, wh, H, j0, nu, "
                "p.kres, p.kp, r0, u);\n"
                "    }\n"
                "    for (int ci = 0; MMA && ci < nchunks; ++ci) {")],
    # no streamed rows (wrong results): the resident rows' share
    "nostream": [("    for (int ci = 0; ci < nchunks; ++ci) {",
                  "    for (int ci = 0; ci < 0; ++ci) {")],
}


def probed(src: str) -> str:
    """src with per-phase clock64() sums (thread 0 of each block) and two
    C entry points to read and clear them."""
    def at(marker, text, after=False):
        nonlocal src
        assert marker in src, marker
        src = src.replace(marker, marker + text if after else text + marker, 1)

    def tick(i):
        return (f"    _u = clock64(); if (threadIdx.x == 0) _tp[{i}] += "
                f"_u - _t; _t = _u;\n")

    src = src.replace("namespace aocr {\n", "namespace aocr {\n__device__ "
                      "unsigned long long g_prof[8];\n", 1)
    at("  for (int s = 0; s < L; ++s) {",
       "  unsigned long long _tp[4] = {0, 0, 0, 0};\n"
       "  long long _k0 = clock64(), _t, _u;\n")
    at("    const bool last = s == L - 1;\n", "    _t = clock64();\n", True)
    at("    // the gate math of the thread", tick(0))
    at("    if (last) break;", tick(1))
    at("    const T* src = hs + ((size_t)t * B + b0) * H;", tick(2))
    end = "      pull_h<uint32_t>(hb, hld, src, H, nrows);\n    __syncthreads();\n"
    at(end, tick(3), True)
    at(end + tick(3) + "  }\n",
       "  if (threadIdx.x == 0) {\n"
       "    for (int i = 0; i < 4; ++i) atomicAdd(&g_prof[i], _tp[i]);\n"
       "    atomicAdd(&g_prof[4], (unsigned long long)(clock64() - _k0));\n"
       "    atomicAdd(&g_prof[5], 1ull);\n  }\n", True)
    return src + (
        '\nextern "C" int phases_read(unsigned long long* o) {\n'
        "  return (int)cudaMemcpyFromSymbol(o, aocr::g_prof, 64);\n}\n"
        'extern "C" int phases_zero() {\n'
        "  unsigned long long z[8] = {0};\n"
        "  return (int)cudaMemcpyToSymbol(aocr::g_prof, z, 64);\n}\n")


def build(names):
    os.makedirs(OUT, exist_ok=True)
    base = open(SRC).read()
    procs = {}
    for name in names:
        src = base
        for old, new in VARIANTS[name]:
            assert old in src, (name, old)
            src = src.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(probed(src))
        procs[name] = subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-Xptxas=-v", "-I",
             os.path.dirname(SRC), "-shared", "-o",
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
    for fn in ("aocr_lstm_fwd_f32", "aocr_lstm_fwd_bf16"):
        getattr(lib, fn).argtypes = [P, P, I] + [P] * 7 + [I] * 4 + [P]
    dev, H, L = torch.device("cuda"), 512, 24
    g = torch.Generator().manual_seed(0)
    for dt, fn in ((torch.bfloat16, lib.aocr_lstm_fwd_bf16),
                   (torch.float32, lib.aocr_lstm_fwd_f32)):
        wh = ((torch.rand(H, 4 * H, generator=g) * 2 - 1)
              * H ** -0.5).to(dev, dt)
        for B, collect in ((512, False), (400, True), (32, False),
                           (1, False)):
            xp = (torch.rand(L, B, 4 * H, generator=g) * 2 - 1).to(dev, dt)
            z = torch.zeros(B, H, device=dev)
            hs = torch.empty(L, B, H, device=dev, dtype=dt)
            cf, hf = torch.empty_like(z), torch.empty_like(z)
            ifog = torch.empty(L, B, 4 * H, device=dev, dtype=dt)
            cs = torch.empty(L, B, H, device=dev, dtype=dt)
            st = torch.cuda.current_stream().cuda_stream
            call = lambda: fn(wh.data_ptr(), xp.data_ptr(),
                              int(dt == torch.float32), z.data_ptr(),
                              z.data_ptr(), hs.data_ptr(), cf.data_ptr(),
                              hf.data_ptr(),
                              ifog.data_ptr() if collect else None,
                              cs.data_ptr() if collect else None, L, B, H, 0,
                              st)
            rc = call()
            if rc:
                print(f"{name} {dt} B={B}: launch error {rc}", flush=True)
                continue
            torch.cuda.synchronize()
            want = lstm_fwd.lstm_fwd_scan_plain(wh, xp, z, z, False, collect)
            got = (hs, (cf, hf), (ifog, cs))
            flat = lambda o: (o[0], *o[1], *(o[2] if collect else ()))
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(flat(got), flat(want)))
            ms = cuda_ms(call)
            lib.phases_zero()
            for _ in range(5):
                call()
            torch.cuda.synchronize()
            out = (ctypes.c_ulonglong * 8)()
            lib.phases_read(out)
            per = [out[i] / out[5] / (L if i < 2 else L - 1)
                   for i in range(4)]
            print(f"{name} {str(dt)[6:]} B={B} collect={collect}: max err "
                  f"{err:.3g}, {ms:.4f} ms; cycles a step: "
                  + ", ".join(f"{PHASES[i]} {per[i]:.0f}" for i in range(4))
                  + f"; {out[4] / out[5]:.0f} a block", flush=True)


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
