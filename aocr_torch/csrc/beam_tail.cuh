// The top-K of the beam kernels (beam_step.cu, beam_loop.cu): counterpart
// of the iterative top-K of aocr/ops/pallas/beam_step.py:109-137 and
// beam_loop.py:197-225, and of decode.py::_apply_trie_and_topk.
#pragma once

#include "decode_tail.cuh"

namespace aocr {

constexpr float NEG_BIG = -1e30f;    // the score of an invalid candidate
constexpr float BAD_BELOW = -5e29f;  // a pick at or below it is invalid

// The top-K of one batch row, run by one whole warp.  tot holds the row's
// K x V scored candidates, candidate (k, v) at tot[k * ld + v] (NEG_BIG
// where the trie forbids it); K passes of argmax-and-mask over the k-major
// flattening give lax.top_k's order, ties to the first index.  Each pass
// masks its raw pick, even when a refill replaces it.  With refill (a
// trie), a pick <= BAD_BELOW is replaced by the first pick (the
// reference's refill, model.lua:421-436).  Slot j's score, parent beam and
// token go to nsc[j], par[j], tk[j] (written by lane 0); returns the
// number of valid picks, on every lane.  Parents and tokens are in V
// space: idx / V and idx % V over the unpadded candidates, which orders
// them as the TPU kernels' padded K x Vp buffer does (its padding columns
// hold -1e30 and never outrank a real candidate).  kDense: ld is V, so
// candidate i is tot[i] (no division a candidate).
template <bool kDense = false>
__device__ __forceinline__ int beam_topk_warp(float* tot, int ld, int K,
                                              int V, bool refill, float* nsc,
                                              int* par, int* tk) {
  const int lane = threadIdx.x & 31;
  const int n = K * V;
  float best0 = 0.f;
  int idx0 = 0, nbad = 0;
  for (int j = 0; j < K; ++j) {
    float best = -INFINITY;
    int bi = n;
    for (int i = lane; i < n; i += 32) {
      const float x = kDense ? tot[i] : tot[(i / V) * ld + i % V];
      if (x > best || (x == best && i < bi)) {
        best = x;
        bi = i;
      }
    }
    warp_argmax(&best, &bi);
    const int raw = bi;
    int idx = raw;
    if (j == 0) {
      best0 = best;
      idx0 = idx;
    }
    if (refill && best <= BAD_BELOW) {
      ++nbad;
      best = best0;
      idx = idx0;
    }
    if (lane == 0) {
      nsc[j] = best;
      par[j] = idx / V;
      tk[j] = idx % V;
      tot[kDense ? raw : (raw / V) * ld + raw % V] = -INFINITY;
    }
    __syncwarp();
  }
  return K - nbad;
}

}  // namespace aocr
