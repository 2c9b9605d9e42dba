#!/usr/bin/env python3
"""Where a launch of aocr_torch's beam_step kernel spends its time, and
A/B variants of its source, on one card.

    python3 tools/beam_step_phases_torch.py [VARIANT ...]

As tools/beam_loop_phases_torch.py, for csrc/beam_step.cu's cluster
route (the kernel template of csrc/step_cluster.cuh): each variant
(tools/greedy_loop_phases_torch.py's VARIANTS, of
csrc/decoder_cluster.cuh) is built with -DDC_PROBES into
build/beam_step_phases/ and called through its own C entry points at the
recognition decoder's shape (L=24, H=1024, V=39, random weights, every
beam live) at B=512 with K=5 and K=10, in bf16 and float32: one line each
with the picks' agreement with the plain version, the CUDA-event ms of
the probed kernel and of the package's own (unprobed) build, and the
cycles a launch of each phase, per block ("tail": the logits, the
log-softmax and the scored candidates; "top-K": the top-K).  Prints the
card's name, power limit and SM clock.  Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

import greedy_loop_phases_torch as glp

from aocr_torch.ops.cuda import beam_step, greedy_loop  # noqa: E402

OUT = os.path.join(glp.ROOT, "build", "beam_step_phases")
# the attention's parts, each left out in turn (the picks then differ;
# the times say what the part costs)
glp.VARIANTS.update({
    # the context read from L2 twice, not staged in shared memory
    "nostage": [("step_cluster.cuh",
                 "  const int nst = (int)min((long)(R + K - 1) / K + 1,\n"
                 "                           (region - rs_bytes) / "
                 "((long)L * H * ESZ));",
                 "  const int nst = 0;")],
    # no scores (the dot products of q with the context rows)
    "noscores": [("decoder_cluster.cuh",
                  "          for (int e = 0; e < 4; ++e) s[g] = "
                  "fmaf(x[e], qr[e], s[g]);\n",
                  "          s[g] += x[0];\n")],
    # no staging (the scores and context vectors read stale shared memory)
    "skipstage": [("decoder_cluster.cuh",
                   "    if (nb > 0) dc_stage_context<T>(ctx, L, B, H, crow0 + "
                   "c0, mc, cbuf, ring);\n",
                   "")],
    # the context staged by cp.async (16-byte pieces, every warp), not by
    # one bulk copy a (row, l)
    "cpasync": [("decoder_cluster.cuh", "  if (rowb % 16 == 0) {\n"
                 "    uint64_t* bar = ring.bar + DC_MAX_STAGES;",
                 "  if (false) {\n    uint64_t* bar = ring.bar + DC_MAX_STAGES;"),
                ("decoder_cluster.cuh",
                 "    const int per = (int)rowb / 8;",
                 "    const int per = (int)rowb / 16;"),
                ("decoder_cluster.cuh",
                 "        cp_async<8>(to + 8 * k, from + 8 * k, 8);",
                 "        cp_async<16>(to + 16 * k, from + 16 * k, 16);")],
    # the attention inlined into the kernel
    "inline": [("decoder_cluster.cuh",
                "__device__ __noinline__ void dc_attend_rows(",
                "__device__ __forceinline__ void dc_attend_rows(")],
    # no q read back from L2 (zeros)
    "noq": [("decoder_cluster.cuh",
             "    load4_cg(q + (row0 + r) * b.hs + h, v);",
             "    v[0] = v[1] = v[2] = v[3] = 0.f;")],
    # no softmax
    "nosoft": [("decoder_cluster.cuh",
                "  // alpha = softmax over L: a warp a row\n"
                "  for (int r = warp; r < m; r += DC_WARPS) {",
                "  for (int r = warp; r < 0; r += DC_WARPS) {")],
    # no context vector (the sum over L of alpha x the context rows)
    "nocv": [("decoder_cluster.cuh",
              "      for (int l = 0; l < L; ++l) {\n        float x[4];",
              "      for (int l = 0; l < 1; ++l) {\n        float x[4];")],
})
ENTRY = """
extern "C" int phases_read(unsigned long long* o) {
  return (int)cudaMemcpyFromSymbol(o, aocr::bs_prof, sizeof(aocr::bs_prof));
}
extern "C" int phases_zero() {
  unsigned long long z[aocr::DC_NPHASES + 1] = {0};
  return (int)cudaMemcpyToSymbol(aocr::bs_prof, z, sizeof(z));
}
"""


def run(name, tp, E):
    lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in ("aocr_beam_step_f32", "aocr_beam_step_bf16"):
        getattr(lib, fn).argtypes = [P] * 17 + [I] * 7 + [P]
    lib.aocr_beam_step_plan.argtypes = [I] * 6 + [ctypes.POINTER(I)]
    dev, H, L, B = torch.device("cuda"), 1024, 24, 512
    g = torch.Generator().manual_seed(11)
    r = lambda *s: (torch.rand(*s, generator=g) * 2 - 1).to(dev)
    for dt, fn in ((torch.bfloat16, lib.aocr_beam_step_bf16),
                   (torch.float32, lib.aocr_beam_step_f32)):
        t = greedy_loop.build_tables(tp["decoder"], tp["projector"], E, True,
                                     dt)
        V, Vp = t["eg"].shape[0], t["pw"].shape[1]
        ctx = r(L, B, H).to(dt)
        for K in (5, 10):
            h = r(B, K * H).to(dt)
            prev = torch.full((B, K), 5, dtype=torch.int32, device=dev)
            sc = -torch.arange(K, dtype=torch.float32,
                               device=dev).expand(B, K).contiguous()
            out = (ctypes.c_int * 11)()
            lib.aocr_beam_step_plan(H, B, K, int(dt == torch.float32), L, Vp,
                                    out)
            if not out[9]:
                print(f"{name} {dt} K={K}: the rows route", flush=True)
                continue
            p = beam_step.Plan(*out[:10])  # the variant's own plan
            w = beam_step.packed_weights(t["wa"], t["wc"], p)
            scratch = torch.empty((beam_step.scratch_bytes(p, dt, H, V),),
                                  dtype=torch.uint8, device=dev)
            ht = torch.empty((B, K * H), device=dev)
            nsc = torch.empty((B, K), device=dev)
            par = torch.empty((B, K), dtype=torch.int32, device=dev)
            tok = torch.empty_like(par)
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                return fn(ctx.data_ptr(), h.data_ptr(), prev.data_ptr(),
                          sc.data_ptr(), t["wa"].data_ptr(),
                          t["wc"].data_ptr(), w["wq"].data_ptr(),
                          w["wc"].data_ptr(), t["pw"].data_ptr(),
                          t["pb"].data_ptr(), None, ht.data_ptr(),
                          nsc.data_ptr(), par.data_ptr(), tok.data_ptr(),
                          None, scratch.data_ptr(), L, B, H, Vp, V, K, p.nb,
                          stream)

            rc = call()
            if rc:
                print(f"{name} {dt} K={K}: launch error {rc}", flush=True)
                continue
            torch.cuda.synchronize()
            args = (ctx, h, prev, sc, t["wa"], t["wc"], t["pw"], t["pb"], K,
                    V)
            want = beam_step.fused_beam_tail_plain(*args)
            agree = ((par == want[2]) & (tok == want[3])).float().mean()
            ms = glp.cuda_ms(call, 10)
            pkg_ms = glp.cuda_ms(lambda: beam_step.fused_beam_tail(*args), 10)
            lib.phases_zero()
            call()
            torch.cuda.synchronize()
            n = len(glp.PHASES)
            prof = (ctypes.c_ulonglong * (n + 1))()
            lib.phases_read(prof)
            per = [prof[i] / prof[n] for i in range(n)]
            print(f"{name} {str(dt)[6:]} B={B} K={K} (bt={p.bt}, nb={p.nb}, "
                  f"{p.clusters} clusters, kc={p.kc} x {p.stages}): picks "
                  f"agree {agree.item():.4f}, {ms:.4f} ms probed, "
                  f"{pkg_ms:.4f} ms unprobed; cycles a launch: "
                  + ", ".join(f"{glp.PHASES[i]} {per[i]:.0f}"
                              for i in range(n) if per[i])
                  + f"; total {sum(per):.0f}", flush=True)


def main() -> int:
    names = sys.argv[1:] or ["kernel"]
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    glp.build(names, source="beam_step.cu", entry=ENTRY, out=OUT)
    tp, E = glp.decoder(torch.device("cuda"))
    for name in names:
        run(name, tp, E)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
