#!/usr/bin/env python3
"""Where a step of aocr_torch's greedy_loop kernel spends its time, and A/B
variants of its source, on one card.

    python3 tools/greedy_loop_phases_torch.py [VARIANT ...] [--L 24]
        [--H 1024] [--layers 2] [--V 39] [--T 50] [--B 512,32,1]
        [--E 20] [--dtypes bf16,f32]

Each VARIANT (default: all) is csrc/greedy_loop.cu with
csrc/decoder_cluster.cuh, a few lines of either replaced (VARIANTS
below), compiled with -DDC_PROBES: thread 0 of every block sums
`clock64()` cycles by phase over the decode (decoder_cluster.cuh's
DcPhase: the products on landed chunks, the waits for the streamed
chunks, the epilogues (gate math, stores), the row-split attention, the
row-split tail (log-softmax, argmax, tokens), the cluster-barrier waits,
the token read-back, issuing the chunks' copies and the partial
projector).  Each build lands in
build/greedy_loop_phases/ and is called through its own C entry points at
a shape given by the options, by default the recognition shape (L=24, the
default decoder: H=1024, 2 layers, input feed, E=20, V=39, T=50) at
B=512, 32 and 1, in bf16 and float32 (im2markup's: --L 1240 --H 512
--layers 1 --E 80 --V 503 --T 150 --B 256), random weights at the init
laws with PAD and EOS biased off so that every row runs all steps: one
line each with the plan (the attention's position slices, `split`, 0 for
the row split), the tokens' agreement with the plain version, the
CUDA-event ms of the probed kernel, that of the package's own (unprobed)
build of the same shape, and the cycles a step of each phase, per block.
A variant that skips work (nomma, splitload, splitcalc) is wrong by design
and times only what it keeps.  Prints the card's name, power limit and SM
clock.  Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from aocr_torch import vocab, weights  # noqa: E402
from aocr_torch.ops import cuda  # noqa: E402
from aocr_torch.ops.cuda import greedy_loop  # noqa: E402

CSRC = os.path.join(ROOT, "aocr_torch", "csrc")
OUT = os.path.join(ROOT, "build", "greedy_loop_phases")
PHASES = ["product", "stream wait", "epilogue", "attention", "tail",
          "barrier", "read-back", "issue", "projector", "top-K", "permute"]
# name: [(file in csrc, text, its replacement), ...]
VARIANTS = {
    "kernel": [],
    # the stream alone: no product on the landed chunks
    "nomma": [("decoder_cluster.cuh",
               "    compute(sa, sa + b.bt * b.g.lda);\n", "")],
    # every chunk's product twice (the second pass: compute alone)
    "mma2x": [("decoder_cluster.cuh",
               "    compute(sa, sa + b.bt * b.g.lda);\n",
               "    compute(sa, sa + b.bt * b.g.lda);\n"
               "    compute(sa, sa + b.bt * b.g.lda);\n")],
    # chunks of at most 64 rows
    "kc64": [("decoder_cluster.cuh",
              "    if (p->kc > 64 && p->kc > dc_round_up(H, 16)) continue;\n",
              "    if (p->kc > 64) continue;\n")],
    # the cell states in L2 (a block-private buffer), not shared memory
    "cl2": [("decoder_cluster.cuh", "    p->cres = c < DC_NCHUNKS;\n",
             "    p->cres = 0;\n")],
    # the split attention's stream alone: each position waited for, its
    # stage released and refilled
    "splitload": [("greedy_loop.cu",
                   "    const T* xs = stage + (size_t)(l % S) * slot;\n",
                   "    if (l < n) {\n      __syncwarp();\n"
                   "      if (lane == 0) mbar_arrive(done + l % S);\n"
                   "      if (tid == 0 && l + S < n) {\n"
                   "        mbar_wait(done + l % S, (l / S) & 1);\n"
                   "        issue(l + S);\n      }\n      continue;\n    }\n"
                   "    const T* xs = stage + (size_t)(l % S) * slot;\n")],
    # the split attention's updates alone, on stale stages: each stage's
    # mbarrier completed by an arrival, no copy
    "splitcalc": [("greedy_loop.cu",
                   "      mbar_expect_tx(bar + l % S, rowb);\n",
                   "      mbar_arrive(bar + l % S);\n      if (false)\n")],
    # the split attention with two stages
    "split2": [("greedy_loop.cu", "constexpr int GL_SPLIT_STAGES = 16;\n",
                "constexpr int GL_SPLIT_STAGES = 2;\n")],
}
ENTRY = """
extern "C" int phases_read(unsigned long long* o) {
  return (int)cudaMemcpyFromSymbol(o, aocr::gl_prof, sizeof(aocr::gl_prof));
}
extern "C" int phases_zero() {
  unsigned long long z[aocr::DC_NPHASES + 1] = {0};
  return (int)cudaMemcpyToSymbol(aocr::gl_prof, z, sizeof(z));
}
"""


def build(names, source="greedy_loop.cu", entry=ENTRY, out=OUT):
    """Each variant of csrc with `entry` appended to `source`, built
    with -DDC_PROBES into out/<name>.so, all nvcc processes at once."""
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(out, name)
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(CSRC, src)
        for fname, old, new in VARIANTS[name]:
            path = os.path.join(src, fname)
            text = open(path).read()
            assert old in text, (name, old)
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        with open(os.path.join(src, source), "a") as f:
            f.write(entry)
        procs[name] = subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-DDC_PROBES", "-Xptxas=-v",
             "-I", src, "-shared", "-o", os.path.join(out, f"{name}.so"),
             os.path.join(src, source)],
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


def cuda_ms(fn, n=5):
    for _ in range(2):
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


def decoder(dev, H, nl, E, V):
    """Input-feed decoder weights (H units, nl layers, embedding E,
    vocabulary V) at the init laws, the projector at gain 2, from a fixed
    seed."""
    rs = np.random.RandomState(3)
    u = lambda b, *s: rs.uniform(-b, b, s).astype(np.float32)
    layer = lambda i: {"wi": u(i ** -0.5, i, 4 * H), "bi": u(i ** -0.5, 4 * H),
                       "wh": u(H ** -0.5, H, 4 * H),
                       "bh": u(H ** -0.5, 4 * H)}
    dec = {"embedding": rs.standard_normal((V, E)).astype(np.float32),
           "layers": [layer(E + H)] + [layer(H) for _ in range(nl - 1)],
           "w_a": u(H ** -0.5, H, H),
           "w_c": u((2 * H) ** -0.5, 2 * H, H)}
    proj = {"w": u(2 * H ** -0.5, H, V), "b": u(H ** -0.5, V)}
    tp, _ = weights.from_numpy({"decoder": dec, "projector": proj}, {}, dev)
    return tp


def run(name, tp, a):
    lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in ("aocr_greedy_loop_f32", "aocr_greedy_loop_bf16"):
        getattr(lib, fn).argtypes = [P] * 15 + [I] * 8 + [P]
    lib.aocr_greedy_loop_plan.argtypes = [I] * 6 + [ctypes.POINTER(I)]
    lib.aocr_greedy_loop_split.argtypes = [I] * 6
    dev, H, L, T, nl = torch.device("cuda"), a.H, a.L, a.T, a.layers
    g = torch.Generator().manual_seed(11)
    kinds = {"bf16": (torch.bfloat16, lib.aocr_greedy_loop_bf16),
             "f32": (torch.float32, lib.aocr_greedy_loop_f32)}
    for dt, fn in (kinds[k] for k in a.dtypes.split(",")):
        t = greedy_loop.build_tables(tp["decoder"], tp["projector"], a.E,
                                     True, dt)
        # PAD and EOS biased off: every row runs all T steps
        t["pb"][[vocab.PAD, vocab.EOS]] = -1e4
        V, Vp = t["eg"].shape[0], t["pw"].shape[1]
        for B in (int(x) for x in a.B.split(",")):
            ctx = (torch.rand(L, B, H, generator=g) * 2 - 1).to(dev, dt)
            c0 = (torch.rand(B, H, generator=g) * 2 - 1).to(dev)
            h0 = (torch.rand(B, H, generator=g) * 2 - 1).to(dev)
            out = (ctypes.c_int * 10)()
            f32 = int(dt == torch.float32)
            lib.aocr_greedy_loop_plan(H, B, f32, L, Vp, nl, out)
            p = greedy_loop.Plan(*out[:9])  # the variant's own plan
            ns = lib.aocr_greedy_loop_split(H, B, f32, L, Vp, nl)
            scratch = torch.zeros(
                (greedy_loop.scratch_bytes(p, dt, H, nl, V)
                 + greedy_loop.split_bytes(p, H, ns),),
                dtype=torch.uint8, device=dev)
            labels = torch.empty((B, T), dtype=torch.int32, device=dev)
            scores = torch.empty((B,), device=dev)
            st = torch.cuda.current_stream().cuda_stream
            w = greedy_loop.pack_weights(t, p, nl, True)

            def call():
                scratch.zero_()
                return fn(ctx.data_ptr(), c0.data_ptr(), h0.data_ptr(),
                          t["eg"].data_ptr(), w["w0"].data_ptr(),
                          w["wl"].data_ptr(), t["bx"].data_ptr(),
                          w["wq"].data_ptr(), w["wc"].data_ptr(),
                          t["pw"].data_ptr(), t["pb"].data_ptr(), None,
                          labels.data_ptr(), scores.data_ptr(),
                          scratch.data_ptr(), L, B, H, Vp, V, T, nl, 1, st)

            rc = call()
            if rc:
                print(f"{name} {dt} B={B}: launch error {rc}", flush=True)
                continue
            torch.cuda.synchronize()
            want, _ = greedy_loop.fused_greedy_loop_plain(
                ctx, c0, h0, t, nl, True, T)
            agree = (labels == want).float().mean().item()
            steps = int((labels != 0).sum(1).max().item())
            ms = cuda_ms(call)
            pkg_ms = cuda_ms(lambda: greedy_loop.fused_greedy_loop(
                ctx, c0, h0, t, nl, True, T))
            lib.phases_zero()
            call()
            torch.cuda.synchronize()
            n = len(PHASES)
            prof = (ctypes.c_ulonglong * (n + 1))()
            lib.phases_read(prof)
            per = [prof[i] / prof[n] / max(steps, 1) for i in range(n)]
            print(f"{name} {str(dt)[6:]} L={L} H={H} B={B} (bt={p.bt}, "
                  f"{p.clusters} clusters, kc={p.kc} x {p.stages}, "
                  f"cres={p.cres}, split={ns}): tokens "
                  f"agree "
                  f"{agree:.4f}, {ms:.4f} ms probed, {pkg_ms:.4f} ms "
                  f"unprobed ({steps} steps); cycles a step: "
                  + ", ".join(f"{PHASES[i]} {per[i]:.0f}" for i in range(n))
                  + f"; total {sum(per):.0f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"of {', '.join(VARIANTS)}")
    for opt, default in (("L", 24), ("H", 1024), ("layers", 2), ("V", 39),
                         ("T", 50), ("E", 20)):
        ap.add_argument(f"--{opt}", type=int, default=default)
    ap.add_argument("--B", default="512,32,1", help="batches, commas")
    ap.add_argument("--dtypes", default="bf16,f32", help="bf16,f32")
    a = ap.parse_args()
    names = a.variants or list(VARIANTS)
    if set(names) - set(VARIANTS):
        ap.error(f"no variant {sorted(set(names) - set(VARIANTS))}")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    build(names)
    tp = decoder(torch.device("cuda"), a.H, a.layers, a.E, a.V)
    for name in names:
        run(name, tp, a)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
