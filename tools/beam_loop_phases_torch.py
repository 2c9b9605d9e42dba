#!/usr/bin/env python3
"""Where a step of aocr_torch's beam_loop kernel spends its time, and A/B
variants of its source, on one card.

    python3 tools/beam_loop_phases_torch.py [VARIANT ...]

As tools/greedy_loop_phases_torch.py (whose VARIANTS, of
csrc/decoder_cluster.cuh, apply here too), for csrc/beam_loop.cu: each
variant is built with -DDC_PROBES into build/beam_loop_phases/ and
called through its own C entry points at the recognition shape (L=24,
the default decoder: H=1024, 2 layers, input feed, V=39, T=50, K=5,
random weights with PAD and EOS biased off so that every beam runs all
steps) at B=512, 32 and 1, in bf16 and float32: one line each with the
histories' agreement with the plain version, the CUDA-event ms of the
probed kernel and of the package's own (unprobed) build, and the cycles
a step of each phase, per block: the phases of greedy_loop and the beam
kernel's own two, the scored candidates with the top-K ("top-K") and the
accumulators and cell states read back at the parents' rows
("permute").  Prints the card's name, power limit and SM clock.  Needs
one CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

import greedy_loop_phases_torch as glp

from aocr_torch import vocab  # noqa: E402  (glp put the repo on sys.path)
from aocr_torch.models.decoder import DecoderState  # noqa: E402
from aocr_torch.ops.cuda import beam_loop, greedy_loop  # noqa: E402

OUT = os.path.join(glp.ROOT, "build", "beam_loop_phases")
ENTRY = """
extern "C" int phases_read(unsigned long long* o) {
  return (int)cudaMemcpyFromSymbol(o, aocr::bl_prof, sizeof(aocr::bl_prof));
}
extern "C" int phases_zero() {
  unsigned long long z[aocr::DC_NPHASES + 1] = {0};
  return (int)cudaMemcpyToSymbol(aocr::bl_prof, z, sizeof(z));
}
"""


def run(name, tp, E):
    lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in ("aocr_beam_loop_f32", "aocr_beam_loop_bf16"):
        getattr(lib, fn).argtypes = [P] * 21 + [I] * 10 + [P]
    lib.aocr_beam_loop_plan.argtypes = [I] * 7 + [ctypes.POINTER(I)]
    dev, H, L, T, nl, K = torch.device("cuda"), 1024, 24, 50, 2, 5
    g = torch.Generator().manual_seed(11)
    r = lambda *s: (torch.rand(*s, generator=g) * 2 - 1).to(dev)
    for dt, fn in ((torch.bfloat16, lib.aocr_beam_loop_bf16),
                   (torch.float32, lib.aocr_beam_loop_f32)):
        t = greedy_loop.build_tables(tp["decoder"], tp["projector"], E, True,
                                     dt)
        # PAD and EOS biased off: every beam runs all T - 1 steps
        t["pb"][[vocab.PAD, vocab.EOS]] = -1e4
        V, Vp = t["eg"].shape[0], t["pw"].shape[1]
        for B in (512, 32, 1):
            ctx = r(L, B, H).to(dt)
            st = DecoderState(attn=r(B, H), cs=(r(B, H), r(B, H)),
                              hs=(r(B, H), r(B, H)))
            init = torch.stack([st.attn, st.cs[0], st.hs[0], st.cs[1],
                                st.hs[1]], dim=1).contiguous()
            tok0 = torch.randint(3, V, (B, K), generator=g,
                                 dtype=torch.int32).to(dev)
            sc0 = -torch.arange(K, dtype=torch.float32,
                                device=dev).expand(B, K).contiguous()
            out = (ctypes.c_int * 11)()
            lib.aocr_beam_loop_plan(H, B, K, int(dt == torch.float32), L, Vp,
                                    nl, out)
            p = beam_loop.Plan(*out[:10])  # the variant's own plan
            scratch = torch.zeros(
                (beam_loop.scratch_bytes(p, dt, H, nl, V),),
                dtype=torch.uint8, device=dev)
            hist = torch.empty((T, B, K), dtype=torch.int32, device=dev)
            par = torch.empty_like(hist)
            scores = torch.empty((B, K), device=dev)
            lengths = torch.empty((B, K), dtype=torch.int32, device=dev)
            stream = torch.cuda.current_stream().cuda_stream
            w = greedy_loop.pack_weights(t, p, nl, True)

            def call():
                scratch.zero_()
                return fn(ctx.data_ptr(), init.data_ptr(), tok0.data_ptr(),
                          sc0.data_ptr(), None, t["eg"].data_ptr(),
                          w["w0"].data_ptr(), w["wl"].data_ptr(),
                          t["bx"].data_ptr(), w["wq"].data_ptr(),
                          w["wc"].data_ptr(), t["pw"].data_ptr(),
                          t["pb"].data_ptr(), None, hist.data_ptr(),
                          par.data_ptr(), scores.data_ptr(),
                          lengths.data_ptr(), None, None, scratch.data_ptr(),
                          L, B, H, Vp, V, T, nl, 1, K, 0, stream)

            rc = call()
            if rc:
                print(f"{name} {dt} B={B}: launch error {rc}", flush=True)
                continue
            torch.cuda.synchronize()
            want = beam_loop.fused_beam_loop_plain(ctx, st, tok0, sc0, None,
                                                   t, nl, True, T, K, False)
            agree = (hist == want[0]).float().mean().item()
            steps = T - 1
            ms = glp.cuda_ms(call, 2)
            pkg_ms = glp.cuda_ms(lambda: beam_loop.fused_beam_loop(
                ctx, st, tok0, sc0, None, t, nl, True, T, K, False), 2)
            lib.phases_zero()
            call()
            torch.cuda.synchronize()
            n = len(glp.PHASES)
            prof = (ctypes.c_ulonglong * (n + 1))()
            lib.phases_read(prof)
            per = [prof[i] / prof[n] / steps for i in range(n)]
            print(f"{name} {str(dt)[6:]} B={B} K={K} (bt={p.bt}, nb={p.nb}, "
                  f"{p.clusters} clusters, kc={p.kc} x {p.stages}, cres="
                  f"{p.cres}): tokens agree {agree:.4f}, {ms:.4f} ms probed, "
                  f"{pkg_ms:.4f} ms unprobed ({steps} steps); cycles a step: "
                  + ", ".join(f"{glp.PHASES[i]} {per[i]:.0f}"
                              for i in range(n))
                  + f"; total {sum(per):.0f}", flush=True)


def main() -> int:
    names = sys.argv[1:] or ["kernel"]
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    glp.build(names, source="beam_loop.cu", entry=ENTRY, out=OUT)
    tp, E = glp.decoder(torch.device("cuda"))
    for name in names:
        run(name, tp, E)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
