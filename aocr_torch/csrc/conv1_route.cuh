// The pool routing of conv1 + bias + ReLU + 2x2/2 max-pool, shared by the
// two backward kernels (conv1_pool_bwd.cu: dW, db; conv1_pool_dx.cu: the
// image cotangent), so that both always see the same winners.
//
// The routing of aocr/ops/pallas/conv1_pool.py::_routed (conv1_pool.py:
// 174-189): recompute the four pre-pool scores of one output cell as the
// forward rounds them (float32 sum of the 9 taps -> compute dtype, + the
// bias in the compute dtype -> compute dtype), then the FIRST position
// attaining the window max in row-major window order (select_and_scatter's
// tie rule), or none where that max is not positive (the ReLU drops the
// cotangent).  The 9-tap sum runs in tap order with separately rounded
// products and sums (__fmul_rn / __fadd_rn): the operations the plain
// versions run (ops/cuda/conv1_pool_bwd.py::_scores), so the routing, ties
// included, is bit-identical to theirs.
#pragma once

#include "common.cuh"

namespace aocr {

constexpr int CONV1_C = 64;  // conv1 output channels

// cell: the top-left of the cell's 4x4 patch of the zero-padded image
// (float, row stride Wp); wt: the channel's 9 taps (compute-dtype values);
// bc: its bias rounded to the compute dtype.  Returns the winning window
// position p (row-major: 0 = (0,0), 1 = (0,1), 2 = (1,0), 3 = (1,1)), or -1
// where the max is not positive.
template <typename T>
__device__ __forceinline__ int conv1_route(const float* cell, int Wp,
                                           const float (&wt)[9], float bc) {
  float z[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float* pt = cell + (p / 2) * Wp + p % 2;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k)
      s = __fadd_rn(s, __fmul_rn(pt[(k / 3) * Wp + k % 3], wt[k]));
    z[p] = round_cd<T>(round_cd<T>(s) + bc);
  }
  const float m = fmaxf(fmaxf(z[0], z[1]), fmaxf(z[2], z[3]));
  if (!(m > 0.f)) return -1;
  return z[0] == m ? 0 : z[1] == m ? 1 : z[2] == m ? 2 : 3;
}

}  // namespace aocr
