// Image cotangent of conv1 (1 -> 64 channels, 3x3 SAME) + bias + ReLU +
// 2x2/2 max-pool, as the 16 taps of each output cell's 4x4 input patch.
//
// Replaces aocr/ops/pallas/conv1_pool.py::_dx_kernel (pl.pallas_call at
// conv1_pool.py:287, the kernel at :217).  For each output cell the kernel
// routes the pooled cotangent dy exactly as conv1_pool_bwd.cu does (the
// shared conv1_route.cuh), then computes the 16 tap values
//   dx16[tap] = sum over (p, c) of W16[tap, p*64 + c] * dcat[p*64 + c],
// where dcat holds the routed cotangent (dy at channel c's winning
// position p, zero elsewhere) and W16[(a, b), p*64 + c] = w[a-pi, b-pj, c],
// the compute-dtype weight that pre-pool pixel (pi, pj) applies to patch
// tap (a, b) (zero outside the 3x3 support), and rounds it to the compute
// dtype (conv1_pool.py:217-225).  Scattering the taps back onto the image
// (the TPU's _unpatch, plain XLA there) is plain PyTorch in
// ops/cuda/conv1_pool_dx.py.
//
// The sum is float32 in one fixed order, which the plain version runs too
// (ops/cuda/conv1_pool_dx.py), so the two agree bit for bit: each channel
// adds one term to each tap (W16's weight at its winning position times
// its cotangent, zero where the ReLU drops it), and the 64 channels are 16
// groups of 4; a group's sum runs from +0 over its 4 channels in order,
// and the 16 group sums meet in a fixed tree: s_k + s_{k+8}, then + the
// sum 4 apart, 2 apart, 1 apart.  A float32 sum in another order (the
// TPU's dot) lands up to tens of bfloat16 steps away where the channels'
// terms cancel.  Each term is one rounded product and one rounded sum
// (__fmul_rn, __fadd_rn); for bf16 operands a fused multiply-add gives the
// same bits wherever the product is exact in float32, which the kernel
// checks (dx_inexact).
//
// Bound on the H100: the issue of the recompute (the four 9-tap scores of
// every cell and channel, 36 multiply-adds, the roundings and the pick)
// and of the taps (16 multiply-adds a cell and channel), far above the
// read of dy (B x 800 x 64 values at W=100) and the write of the taps.  So
// the design is conv1_pool_bwd.cu's, in one launch: as many blocks as the
// card holds at once (cb_plan), each owning an equal run of the batch's
// pooled cells, the zero-padded image rows of its pool rows staged in
// shared memory (cb_stage); a warp takes 2 cells at a time, 16 lanes a
// cell, a lane 4 channels: it loads the cell's 4x4 patch once, its 4
// channels' dy as one vector, routes them, and adds each channel's 16
// taps from a shared table of the channel's weights by winning position
// (zeros outside the support; no branch on the position); the 16 lanes'
// sums go through shared memory, lane k adds tap k's in the tree's order,
// and the 16 lanes store the cell's taps together.  (A reduce-scatter by
// shuffles took 4% longer in float32, 2% in bf16; rounding the routing's
// bf16 scores by integer arithmetic instead of conversions, 28% longer in
// bf16: tools/ab_greedy_loop_torch.py on an H100, PERF.md.)  The first
// port's kernel took one 64-thread block a pool row, a thread a cell with
// its 64 channels one after another: 0.274-0.291 ms at B=400, W=100 on
// an H100 (PERF.md).
#include "conv1_route.cuh"

namespace aocr {

constexpr int DX_THREADS = 256;
constexpr int DX_WARPS = DX_THREADS / 32;
constexpr int DX_CPT = 4;                      // channels a lane
constexpr int DX_LANES = CONV1_C / DX_CPT;     // lanes a cell: 16
constexpr int DX_SLOTS = DX_THREADS / DX_LANES;  // cells at a time: 16
constexpr int DX_STAGE_MAX = 64 * 1024;        // staged image rows, bytes
// the tap table: entry (channel 4 j + k, position p) is 16 taps at
// ((k * 4 + p) * 16 + j) * DX_TAB_LD floats, 4 floats of padding after
// them, so that the 8 lanes of a 16-byte load's phase (8 channel groups
// j) hit distinct banks
constexpr int DX_TAB_LD = 20;
constexpr int DX_TAB = DX_CPT * 4 * DX_LANES * DX_TAB_LD;

// True where a fused multiply-add of a tap's weight and a cotangent may
// round differently from the separate product and sum: a nonzero value
// outside [2^-60, 2^60] (the bf16 product of two values inside is exact in
// float32 and finite) or not a number.
__device__ __forceinline__ bool dx_inexact(float v) {
  const float a = fabsf(v);
  return v != 0.f && !(a >= 0x1p-60f && a <= 0x1p60f);
}

// The terms of a lane's DX_CPT channels added onto its 16 taps, channel
// by channel: W16's weights at each channel's position (from the table
// row wr[k]) times its cotangent g[k]; kFma: as fused multiply-adds.
template <bool kFma>
__device__ __forceinline__ void dx_terms(float (&acc)[16],
                                         const float4* const (&wr)[DX_CPT],
                                         const float (&g)[DX_CPT]) {
#pragma unroll
  for (int k = 0; k < DX_CPT; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = wr[k][q];
      const float wq[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[4 * q + e] = kFma ? fmaf(wq[e], g[k], acc[4 * q + e])
                              : __fadd_rn(acc[4 * q + e],
                                          __fmul_rn(wq[e], g[k]));
    }
}

// x (B, H, W); w (64, 9) float32; bias (64,); dy (B, H/2, W/2, 64);
// out (B, H/2, W/2, 16).  Block i owns the cells [i C / n, (i + 1) C / n)
// of the C = B (H/2) (W/2) pooled cells in (image, row, column) order.
template <typename T>
__global__ void __launch_bounds__(DX_THREADS, 2)
conv1_pool_dx_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias,
                     const T* __restrict__ dy, T* __restrict__ out, int B,
                     int H, int W) {
  extern __shared__ __align__(16) float img[];  // rows x 4 x Wp
  __shared__ __align__(16) float tab[DX_TAB];
  // each lane's 16 group sums (rows padded as the table's: the 8 lanes of
  // a 16-byte store's phase hit distinct banks)
  __shared__ __align__(16) float red[DX_SLOTS][DX_LANES][DX_TAB_LD];
  const int Ho = H / 2, Wo = W / 2, Wp = (W + 3) & ~1;
  const long cells = (long)B * Ho * Wo, nb = gridDim.x;
  const long c_lo = blockIdx.x * cells / nb;
  const long c_hi = (blockIdx.x + 1) * cells / nb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slot = warp * 2 + (lane >> 4), j = lane & (DX_LANES - 1);
  const int c0 = j * DX_CPT;

  // the zero-padded image rows of the block's pool rows g0..g1
  const int g0 = (int)(c_lo / Wo), g1 = (int)((c_hi - 1) / Wo);
  bool tiny = false;
  cb_stage<DX_WARPS>(x, img, H, W, g0, g1,
                     [&](float v) { tiny |= conv1_tiny(v); });
  // the tap table: channel c's compute-dtype weight that position p
  // applies to tap (a, b), w[c, a - pi, b - pj], zero outside the support
  for (int i = tid; i < CONV1_C * 4 * 16; i += DX_THREADS) {
    const int c = i >> 6, p = (i >> 4) & 3, t = i & 15;
    const int ky = (t >> 2) - (p >> 1), kx = (t & 3) - (p & 1);
    const bool in = ky >= 0 && ky < 3 && kx >= 0 && kx < 3;
    tab[(((c & 3) * 4 + p) * DX_LANES + (c >> 2)) * DX_TAB_LD + t] =
        in ? round_cd<T>(w[c * 9 + ky * 3 + kx]) : 0.f;
  }
  float wt[DX_CPT][9], bc[DX_CPT];
  bool wide = false;
#pragma unroll
  for (int k = 0; k < DX_CPT; ++k) {
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      wt[k][q] = round_cd<T>(w[(c0 + k) * 9 + q]);
      tiny |= conv1_tiny(wt[k][q]);
      wide |= dx_inexact(wt[k][q]);
    }
    bc[k] = round_cd<T>(bias[c0 + k]);
  }
  // (a barrier: the staged rows and the table are complete) bf16 sums by
  // fused multiply-adds where they give the same bits: the routing unless
  // a pixel or tap is tiny (conv1_route_n), the taps unless a weight (any
  // of the block's) or the cell's cotangent is outside dx_inexact's range
  const bool any_tiny = __syncthreads_or(tiny);
  const bool any_wide = __syncthreads_or(wide);
  const bool fused = sizeof(T) == 2 && !any_tiny;
  const bool fused_taps = sizeof(T) == 2 && !any_wide;

  // the lane's cells c_lo + slot, + DX_SLOTS, ...: column wo of pool row
  // g, whose staged rows start at `base`, kept by increments; a warp's two
  // cells go together (its shuffles take every lane), so a lane past the
  // run computes on zeros and stores nothing
  const int gs = (int)((c_lo + slot) / Wo);
  int wo = (int)((c_lo + slot) % Wo), ho = gs % Ho, base = cb_base(gs, g0, Ho);
  const T* dyc = dy + (size_t)(c_lo + slot) * CONV1_C + c0;
  T* oc = out + (size_t)(c_lo + slot) * 16 + j;
  const float* tj = tab + j * DX_TAB_LD;
  const int n = (int)(c_hi - c_lo);
  for (int i = slot; i - (lane >> 4) < n; i += DX_SLOTS) {
    const bool live = i < n;
    float gv[DX_CPT] = {0.f, 0.f, 0.f, 0.f};
    if (live) load_row(dyc, gv);
    const float* pt = live ? img + base * Wp + 2 * wo : img;
    float P[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 a = *reinterpret_cast<const float2*>(pt + r * Wp);
      const float2 c = *reinterpret_cast<const float2*>(pt + r * Wp + 2);
      P[r][0] = a.x;
      P[r][1] = a.y;
      P[r][2] = c.x;
      P[r][3] = c.y;
    }
    int win[DX_CPT];
    if (fused)
      conv1_route_n<T, DX_CPT, true>(P, wt, bc, win);
    else
      conv1_route_n<T, DX_CPT>(P, wt, bc, win);
    // each channel's term: its cotangent (0 where the ReLU drops it) times
    // the table row of its winning position
    const float4* wr[DX_CPT];
    float g[DX_CPT];
    bool exact = fused_taps;
#pragma unroll
    for (int k = 0; k < DX_CPT; ++k) {
      const bool on = win[k] >= 0;
      g[k] = on ? gv[k] : 0.f;
      exact &= !dx_inexact(g[k]);
      wr[k] = reinterpret_cast<const float4*>(
          tj + (k * 4 + (on ? win[k] : 0)) * DX_LANES * DX_TAB_LD);
    }
    // the group's sum from +0, channel by channel, then the tree
    float acc[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) acc[t] = 0.f;
    if (exact)
      dx_terms<true>(acc, wr, g);
    else
      dx_terms<false>(acc, wr, g);
    // the 16 groups' sums of tap j through shared memory (lane j reads
    // column j), added k + (k + 8), then 4 apart, 2 apart, 1 apart
    float* mine = red[slot][j];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<float4*>(mine + 4 * q) =
          make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                      acc[4 * q + 3]);
    __syncwarp();
    float t[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) t[k] = red[slot][k][j];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 8; ++k) t[k] += t[k + 8];
#pragma unroll
    for (int k = 0; k < 4; ++k) t[k] += t[k + 4];
#pragma unroll
    for (int k = 0; k < 2; ++k) t[k] += t[k + 2];
    if (live) *oc = from_f<T>(t[0] + t[1]);
    dyc += DX_SLOTS * CONV1_C;
    oc += DX_SLOTS * 16;
    for (wo += DX_SLOTS; wo >= Wo; wo -= Wo) {
      base += 2;
      if (++ho == Ho) {  // the next image's rows: 2 more of padding
        ho = 0;
        base += 2;
      }
    }
  }
}

// The blocks of the kernel the card holds at once.
template <typename T>
static int dx_resident() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, sms = 0, per = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        set_smem((const void*)conv1_pool_dx_kernel<T>, DX_STAGE_MAX) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, conv1_pool_dx_kernel<T>, DX_THREADS, DX_STAGE_MAX) !=
            cudaSuccess)
      return 0;
    n = sms * per;
  }
  return n;
}

template <typename T>
static int launch(const void* x, const void* w, const void* b,
                  const void* dy, void* out, int B, int H, int W, int blocks,
                  cudaStream_t stream) {
  int n, rows, smem;
  if (B < 1 || H < 2 || W < 2 ||
      !cb_plan(B, H, W, dx_resident<T>(), DX_STAGE_MAX, &n, &rows, &smem) ||
      n != blocks)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = set_smem((const void*)conv1_pool_dx_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  conv1_pool_dx_kernel<T><<<n, DX_THREADS, smem, stream>>>(
      (const T*)x, (const float*)w, (const float*)b, (const T*)dy, (T*)out,
      B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace aocr

#define AOCR_CONV1_DX_ARGS                                             \
  const void *x, const void *w, const void *b, const void *dy,        \
      void *out, int B, int H, int W, int blocks, void *stream

// w: (64, 9) float32; blocks: the plan's (aocr_conv1_pool_dx_plan); a
// launch of another plan is refused.
extern "C" int aocr_conv1_pool_dx_f32(AOCR_CONV1_DX_ARGS) {
  return aocr::launch<float>(x, w, b, dy, out, B, H, W, blocks,
                             (cudaStream_t)stream);
}

extern "C" int aocr_conv1_pool_dx_bf16(AOCR_CONV1_DX_ARGS) {
  return aocr::launch<__nv_bfloat16>(x, w, b, dy, out, B, H, W, blocks,
                                     (cudaStream_t)stream);
}

// The plan of a launch: out[0..2] = blocks, rows, smem (as
// aocr_torch/ops/cuda/conv1_pool_dx.py::plan gives them for out[3]) and
// out[3] = the blocks the card holds at once.  Returns a CUDA error code.
extern "C" int aocr_conv1_pool_dx_plan(int B, int H, int W, int is_f32,
                                       int* out) {
  const int resident = is_f32 ? aocr::dx_resident<float>()
                              : aocr::dx_resident<__nv_bfloat16>();
  int n, rows, smem;
  if (!aocr::cb_plan(B, H, W, resident, aocr::DX_STAGE_MAX, &n, &rows,
                     &smem))
    return (int)cudaErrorInvalidValue;
  const int v[4] = {n, rows, smem, resident};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
  return 0;
}
