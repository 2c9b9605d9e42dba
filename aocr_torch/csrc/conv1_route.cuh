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
// products and sums (__fmul_rn / __fadd_rn), or fused multiply-adds where
// those give the same bits (conv1_route_n): the operations the plain
// versions run (ops/cuda/conv1_pool_bwd.py::_scores), so the routing, ties
// included, is bit-identical to theirs.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace aocr {

constexpr int CONV1_C = 64;  // conv1 output channels

// The runs of cells of conv1_pool.cu and conv1_pool_bwd.cu: a block owns
// a run of consecutive pooled cells (image, row, column order) and stages
// the zero-padded image rows its pool rows read, one after another.
// The first staged row of pool row g (image g / Ho) in a block whose
// first pool row is g0: consecutive pool rows of an image share 2 of
// their 4 rows, and each image the block touches adds 2.
__host__ __device__ inline int cb_base(int g, int g0, int Ho) {
  return 2 * (g - g0) + 2 * (g / Ho - g0 / Ho);
}

// The most rows a run of m pooled cells stages: it touches at most r =
// (m - 1) / Wo + 2 pool rows and (r - 1) / Ho + 2 images (of B, B Ho).
static inline long cb_rows(long m, int B, int Ho, int Wo) {
  const long r = std::min((m - 1) / Wo + 2, (long)B * Ho);
  const long imgs = std::min((r - 1) / Ho + 2, (long)B);
  return 2 * (r + imgs);
}

// The launch plan of the two backward kernels for B images of H x W, the
// blocks the card holds at once (resident) and the bytes a block may stage
// (stage_max): blocks, each owning ceil or floor of the B (H/2) (W/2)
// cells / blocks, at least `resident` (fewer where there are fewer cells)
// and the fewest more whose staged rows (cb_rows, floats) fit stage_max;
// rows: the most rows a block stages; smem: their bytes.  False where the
// rows of one cell's run do not fit.
static inline bool cb_plan(int B, int H, int W, int resident, int stage_max,
                           int* blocks, int* rows, int* smem) {
  const int Ho = H / 2, Wo = W / 2;
  const long cells = (long)B * Ho * Wo, rb = 4L * ((W + 3) & ~1);
  if (cells < 1 || resident < 1 || cb_rows(1, B, Ho, Wo) * rb > stage_max)
    return false;
  auto fits = [&](long n) {
    return cb_rows((cells + n - 1) / n, B, Ho, Wo) * rb <= stage_max;
  };
  long lo = std::min((long)resident, cells), hi = cells;
  if (!fits(lo)) {  // the fewest blocks that fit: fits(hi) holds
    while (hi - lo > 1) {
      const long mid = (lo + hi) / 2;
      (fits(mid) ? hi : lo) = mid;
    }
    lo = hi;
  }
  *blocks = (int)lo;
  *rows = (int)cb_rows((cells + lo - 1) / lo, B, Ho, Wo);
  *smem = (int)(*rows * rb);
  return true;
}

constexpr int CB_STAGE_ROWS = 8;  // rows a warp stages at a time

// Stage the zero-padded image rows that pool rows g0..g1 read into img,
// (W + 3) & ~1 elements a row: for each image b they touch, rows 2 ho - 1
// .. 2 ho + 2 of its first to last pool row ho, one after another (pool
// row g's 4 rows start at cb_base(g, g0)); staged column c holds image
// column c - 1, zeros at column 0, past W and off the image.  A warp
// stages rows, its lanes columns, CB_STAGE_ROWS rows x 4 columns of loads
// a lane in flight before their stores, so that the latencies overlap
// (one load at a time took a sixth of conv1_pool_bwd's time).  seen(v)
// gets every staged value as a float.  The caller __syncthreads after.
template <int WARPS, typename T, typename S, typename Seen>
__device__ __forceinline__ void cb_stage(const T* __restrict__ x, S* img,
                                         int H, int W, int g0, int g1,
                                         Seen seen) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Ho = H / 2, Wp = (W + 3) & ~1, b0 = g0 / Ho;
  const int nsr = cb_base(g1, g0, Ho) + 4;  // staged rows
  for (int r0 = warp; r0 < nsr; r0 += WARPS * CB_STAGE_ROWS) {
    int src[CB_STAGE_ROWS];  // the rows' first pixels in x; -1: zeros
#pragma unroll
    for (int q = 0; q < CB_STAGE_ROWS; ++q) {
      const int sr = r0 + q * WARPS;
      // image b0 + k's rows start at row `start`, from pool row gf
      int k = 0, start = 0, gf = g0;
      for (;;) {
        const int gl = min(g1, (b0 + k + 1) * Ho - 1);
        const int cnt = 2 * (gl - gf + 1) + 2;
        if (sr < start + cnt || gl == g1) break;
        start += cnt;
        gf = gl + 1;
        ++k;
      }
      const int b = b0 + k, y = 2 * (gf - b * Ho) - 1 + (sr - start);
      src[q] = sr < nsr && y >= 0 && y < H ? (b * H + y) * W : -1;
    }
    for (int c0 = lane - 1; c0 < Wp - 1; c0 += 128) {
      T v[CB_STAGE_ROWS][4];
#pragma unroll
      for (int q = 0; q < CB_STAGE_ROWS; ++q)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int xc = c0 + 32 * m;
          v[q][m] = src[q] >= 0 && xc >= 0 && xc < W ? x[src[q] + xc]
                                                   : from_f<T>(0.f);
        }
#pragma unroll
      for (int q = 0; q < CB_STAGE_ROWS; ++q)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int sr = r0 + q * WARPS, xc = c0 + 32 * m;
          if (sr < nsr && xc + 1 < Wp) {
            if constexpr (sizeof(S) == sizeof(T))
              img[sr * Wp + xc + 1] = v[q][m];
            else
              img[sr * Wp + xc + 1] = to_f(v[q][m]);
          }
          seen(to_f(v[q][m]));
        }
    }
  }
}

// The window position from the four positions' 9-tap sums s (float32,
// in tap order) and the channel's bias rounded to the compute dtype: the
// scores rounded as the forward rounds them, then the first position
// attaining the max (row-major: 0 = (0,0), 1 = (0,1), 2 = (1,0), 3 =
// (1,1)), or -1 where the max is not positive.  (No branch: the bf16
// roundings two at a time, the pick by selects.  In bf16 the rounded sum
// plus the bias is one bf16 add: the float32 sum rounded to bf16 is the
// exact sum rounded once, float32 carrying more than 2 x 8 + 2 bits, and
// it saved 4% of conv1_pool_bwd's bf16 time on an H100, PERF.md.)
template <typename T>
__device__ __forceinline__ int conv1_pick(const float (&s)[4], float bc) {
  float z[4];
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162 b2 = __float2bfloat162_rn(bc);
#pragma unroll
    for (int p = 0; p < 4; p += 2) {
      const float2 v = __bfloat1622float2(
          __hadd2(__floats2bfloat162_rn(s[p], s[p + 1]), b2));
      z[p] = v.x;
      z[p + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) z[p] = round_cd<T>(round_cd<T>(s[p]) + bc);
  }
  const float m = fmaxf(fmaxf(z[0], z[1]), fmaxf(z[2], z[3]));
  const int first = z[0] == m ? 0 : z[1] == m ? 1 : z[2] == m ? 2 : 3;
  return m > 0.f ? first : -1;
}

// The routing of NC channels of one cell from its 4x4 patch of the
// zero-padded image (P[row][col], float): wt[j] is channel j's 9 taps
// (compute-dtype values), bc[j] its bias rounded to the compute dtype, and
// win[j] its winning position (conv1_pick).  Each sum runs in tap order
// from the first tap's product (0 + it would differ only in the sign of
// a zero sum, which no pick can see).  FMA: each tap as one fused multiply-add, which
// equals the separately rounded product and sum wherever the product is
// exact in float32: for bf16 operands (8 significant bits each, 16 in the
// product) wherever |pixel| |tap| >= 2^-133 or either is 0 (the caller
// checks that every nonzero pixel and tap is at least 2^-60).
template <typename T, int NC, bool FMA = false>
__device__ __forceinline__ void conv1_route_n(const float (&P)[4][4],
                                              const float (&wt)[NC][9],
                                              const float (&bc)[NC],
                                              int (&win)[NC]) {
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    float s[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      s[p] = __fmul_rn(P[p / 2][p % 2], wt[j][0]);
#pragma unroll
      for (int k = 1; k < 9; ++k) {
        const float x = P[p / 2 + k / 3][p % 2 + k % 3];
        s[p] = FMA ? fmaf(x, wt[j][k], s[p])
                   : __fadd_rn(s[p], __fmul_rn(x, wt[j][k]));
      }
    }
    win[j] = conv1_pick<T>(s, bc[j]);
  }
}

// True where a value is nonzero and below 2^-60 in magnitude: one such
// pixel or tap keeps conv1_route_n's bf16 sums from fused multiply-adds.
__device__ __forceinline__ bool conv1_tiny(float v) {
  return v != 0.f && fabsf(v) < 0x1p-60f;
}

}  // namespace aocr
