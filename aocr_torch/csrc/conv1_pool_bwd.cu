// Backward of conv1 (1 -> 64 channels, 3x3 SAME) + bias + ReLU + 2x2/2
// max-pool: the weight and bias gradients.
//
// Replaces aocr/ops/pallas/conv1_pool.py::_bwd_kernel (pl.pallas_call at
// conv1_pool.py:266).  The image cotangent is conv1_pool_dx.cu.
//
// For each pooled cell the kernel routes the pooled cotangent dy as
// conv1_route.cuh does (the routing both backward kernels share: the
// four pre-pool scores recomputed as the forward rounds them, the FIRST
// position attaining the window max, nothing unless that max is
// positive), and accumulates dW (64 x 9) and db (64) in float32.
//
// Bound on the H100: the recompute, 36 separately rounded multiplies and
// adds a cell and channel (with the roundings, the pick and the 9 FMAs of
// dW ~125 instructions: ~75 us of issue at B=400, W=100 across 132 SMs),
// far above the read of dy (B x 800 x 64 values, ~12 us in bf16).  So the
// design keeps every instruction it can off that path, in one launch:
//   - as many blocks as the card holds at once (cb_plan), each owning an
//     equal run of the batch's pooled cells (to one cell), so no SM idles
//     at the end; a block stages the zero-padded image rows of its pool
//     rows in shared memory, and its 256 threads are 16 cell slots x 16
//     groups of 4 channels: a thread loads a cell's 4x4 patch once (8
//     two-float loads) for its 4 channels, and their dy as one vector (the
//     4 lanes of a cell read 16 channels, one 32-byte sector in bf16);
//   - the block's sums: a butterfly over the warp's 8 cell slots, then the
//     channel group's two warps in order; its (64, 10) partial to global
//     memory;
//   - the partials' sum in the same launch, a fixed tree: the last block
//     of each group of CB_FAN (an integer counter tells it) adds its
//     group's partials in block order, level by level, and the last one
//     writes the output.  No float atomics, so the result is
//     deterministic (the summation order is fixed by the card's plan).
// (The first port's kernel took one block per image and added the B
// per-image partials in a second launch: 0.224 + 0.008 ms in bf16 at
// B=400, W=100 on an H100, PERF.md.)
#include "conv1_route.cuh"

namespace aocr {

constexpr int CB_C = CONV1_C;
constexpr int CB_OUT = 10;        // 9 weight taps + the bias, per channel
constexpr int CB_THREADS = 256;
constexpr int CB_WARPS = CB_THREADS / 32;
constexpr int CB_CPT = 4;         // channels a thread
constexpr int CB_SLOTS = CB_THREADS * CB_CPT / CB_C;  // cells at a time: 16
constexpr int CB_FAN = 16;        // partials a block of the tree adds
constexpr int CB_STAGE_MAX = 96 * 1024;  // staged image rows, bytes

// x (B, H, W); w (64, 9) float32; bias (64,); dy (B, H/2, W/2, 64);
// part: the tree's partials, level by level (ops/cuda/conv1_pool_bwd.py::
// levels); count: a counter for each group of each level, zero at the
// launch and left zero (the last arrival resets it); dw (64, 9), db (64,).  Block i owns the cells [i C / n, (i + 1) C / n) of the C =
// B (H/2) (W/2) pooled cells in (image, row, column) order.
template <typename T>
__global__ void __launch_bounds__(CB_THREADS, 2)
conv1_pool_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias,
                      const T* __restrict__ dy, float* part, int* count,
                      float* dw_out, float* db_out, int B, int H, int W) {
  extern __shared__ __align__(16) float img[];  // rows x 4 x Wp
  __shared__ float red[CB_C * CB_OUT];
  __shared__ int s_last;
  const int Ho = H / 2, Wo = W / 2, Wp = (W + 3) & ~1;
  const long cells = (long)B * Ho * Wo, nb = gridDim.x;
  const long c_lo = blockIdx.x * cells / nb;
  const long c_hi = (blockIdx.x + 1) * cells / nb;
  const int u = blockIdx.x, tid = threadIdx.x, warp = tid >> 5,
            lane = tid & 31;
  const int slot = (warp >> 2) * 8 + (lane >> 2);
  const int c0 = ((warp & 3) * 4 + (lane & 3)) * CB_CPT;

  // the zero-padded image rows of the block's pool rows g0..g1
  const int g0 = (int)(c_lo / Wo), g1 = (int)((c_hi - 1) / Wo);
  bool tiny = false;
  cb_stage<CB_WARPS>(x, img, H, W, g0, g1,
                     [&](float v) { tiny |= conv1_tiny(v); });
  float wt[CB_CPT][9], bc[CB_CPT];
#pragma unroll
  for (int j = 0; j < CB_CPT; ++j) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      wt[j][k] = round_cd<T>(w[(c0 + j) * 9 + k]);
      tiny |= conv1_tiny(wt[j][k]);
    }
    bc[j] = round_cd<T>(bias[c0 + j]);
  }
  // (a barrier: the staged rows are complete) bf16 sums by fused
  // multiply-adds unless a pixel or tap is tiny (conv1_route_n): the same
  // bits, a third fewer instructions
  const bool any_tiny = __syncthreads_or(tiny);
  const bool fused = sizeof(T) == 2 && !any_tiny;

  float dw[CB_CPT][9], db[CB_CPT];
#pragma unroll
  for (int j = 0; j < CB_CPT; ++j) {
    db[j] = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) dw[j][k] = 0.f;
  }
  // the thread's cells c_lo + slot, + CB_SLOTS, ...: column wo of pool
  // row g, whose staged rows start at `base`, kept by increments (no
  // division a cell)
  const int gs = (int)((c_lo + slot) / Wo);
  int wo = (int)((c_lo + slot) % Wo), ho = gs % Ho, base = cb_base(gs, g0, Ho);
  const T* dyc = dy + (size_t)(c_lo + slot) * CB_C + c0;
  for (int n = (int)(c_hi - c_lo), i = slot; i < n; i += CB_SLOTS) {
    float gv[CB_CPT];
    load_row(dyc, gv);
    const float* pt = img + base * Wp + 2 * wo;
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
    int win[CB_CPT];
    if (fused)
      conv1_route_n<T, CB_CPT, true>(P, wt, bc, win);
    else
      conv1_route_n<T, CB_CPT>(P, wt, bc, win);
    // every channel's window updates dW, the ReLU's dropped cotangents as
    // zeros (no divergent branch): adding 0 x a finite pixel changes no
    // sum
#pragma unroll
    for (int j = 0; j < CB_CPT; ++j) {
      const bool on = win[j] >= 0;
      const float g = on ? gv[j] : 0.f;
      const int p = on ? win[j] : 0;
      const float* q = pt + (p >> 1) * Wp + (p & 1);
      db[j] += g;
#pragma unroll
      for (int k = 0; k < 9; ++k)
        dw[j][k] = fmaf(g, q[(k / 3) * Wp + k % 3], dw[j][k]);
    }
    dyc += CB_SLOTS * CB_C;
    for (wo += CB_SLOTS; wo >= Wo; wo -= Wo) {
      base += 2;
      if (++ho == Ho) {  // the next image's rows: 2 more of padding
        ho = 0;
        base += 2;
      }
    }
  }

  // output q = channel * CB_OUT + tap (tap 9: the bias) of the sum
  auto put = [&](int q, float v) {
    const int c = q / CB_OUT, k = q % CB_OUT;
    if (k < 9)
      dw_out[c * 9 + k] = v;
    else
      db_out[c] = v;
  };
  // the block's sums: the warp's 8 cell slots (a butterfly, every lane
  // ends with the same sum), then the channel group's two warps in order
  float* mine = part + (size_t)u * CB_C * CB_OUT;
#pragma unroll
  for (int j = 0; j < CB_CPT; ++j)
#pragma unroll
    for (int k = 0; k < CB_OUT; ++k) {
      float v = k < 9 ? dw[j][k] : db[j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (k < 9) dw[j][k] = v;
      else db[j] = v;
      if (warp >= 4 && lane < 4) red[(c0 + j) * CB_OUT + k] = v;
    }
  __syncthreads();
  if (warp < 4 && lane < 4) {
#pragma unroll
    for (int j = 0; j < CB_CPT; ++j)
#pragma unroll
      for (int k = 0; k < CB_OUT; ++k) {
        const int q = (c0 + j) * CB_OUT + k;
        const float v = (k < 9 ? dw[j][k] : db[j]) + red[q];
        if (gridDim.x == 1)
          put(q, v);
        else
          mine[q] = v;
      }
  }

  // the tree: at each level the last block of a group of CB_FAN partials
  // adds them in order into the next level (the output at the top)
  float* lvl = part;
  int n = gridDim.x, idx = u;
  while (n > 1) {
    const int ng = (n + CB_FAN - 1) / CB_FAN, g = idx / CB_FAN;
    const int gs = min(CB_FAN, n - g * CB_FAN);
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(count + g, 1) == gs - 1;
    __syncthreads();
    if (!s_last) return;
    if (tid == 0) count[g] = 0;  // every block of the group has arrived
    __threadfence();
    const float* src = lvl + (size_t)g * CB_FAN * CB_C * CB_OUT;
    float* next = lvl + (size_t)n * CB_C * CB_OUT;
    float* dst = next + (size_t)g * CB_C * CB_OUT;
    for (int qi = tid; qi < CB_C * CB_OUT; qi += CB_THREADS) {
      float v[CB_FAN];
#pragma unroll
      for (int i = 0; i < CB_FAN; ++i)
        if (i < gs) v[i] = __ldcg(src + (size_t)i * CB_C * CB_OUT + qi);
      float acc = v[0];
#pragma unroll
      for (int i = 1; i < CB_FAN; ++i)
        if (i < gs) acc += v[i];
      if (ng == 1)
        put(qi, acc);
      else
        dst[qi] = acc;
    }
    lvl = next;
    count += ng;
    n = ng;
    idx = g;
  }
}

// The blocks of the kernel the card holds at once.
template <typename T>
static int cb_resident() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, sms = 0, per = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        set_smem((const void*)conv1_pool_bwd_kernel<T>, CB_STAGE_MAX) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, conv1_pool_bwd_kernel<T>, CB_THREADS, CB_STAGE_MAX) !=
            cudaSuccess)
      return 0;
    n = sms * per;
  }
  return n;
}

template <typename T>
static int launch(const void* x, const void* w, const void* b,
                  const void* dy, void* part, void* count, void* dw,
                  void* db, int B, int H, int W, int blocks,
                  cudaStream_t stream) {
  int n, rows, smem;
  if (B < 1 || H < 2 || W < 2 ||
      !cb_plan(B, H, W, cb_resident<T>(), CB_STAGE_MAX, &n, &rows,
               &smem) ||
      n != blocks)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = set_smem((const void*)conv1_pool_bwd_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  conv1_pool_bwd_kernel<T><<<n, CB_THREADS, smem, stream>>>(
      (const T*)x, (const float*)w, (const float*)b, (const T*)dy,
      (float*)part, (int*)count, (float*)dw, (float*)db, B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace aocr

#define AOCR_CONV1_BWD_ARGS                                            \
  const void *x, const void *w, const void *b, const void *dy,        \
      void *part, void *count, void *dw, void *db, int B, int H, int W, \
      int blocks, void *stream

// blocks: the plan's (aocr_conv1_pool_bwd_plan), by which the caller
// sized part and count; a launch of another plan is refused.
extern "C" int aocr_conv1_pool_bwd_f32(AOCR_CONV1_BWD_ARGS) {
  return aocr::launch<float>(x, w, b, dy, part, count, dw, db, B, H, W,
                             blocks,
                             (cudaStream_t)stream);
}

extern "C" int aocr_conv1_pool_bwd_bf16(AOCR_CONV1_BWD_ARGS) {
  return aocr::launch<__nv_bfloat16>(x, w, b, dy, part, count, dw, db, B, H,
                                     W,
                                     blocks, (cudaStream_t)stream);
}

// The plan of a launch: out[0..2] = blocks, rows, smem (as
// aocr_torch/ops/cuda/conv1_pool_bwd.py::plan gives them for out[3]) and
// out[3] = the blocks the card holds at once.  Returns a CUDA error code.
extern "C" int aocr_conv1_pool_bwd_plan(int B, int H, int W, int is_f32,
                                        int* out) {
  const int resident = is_f32 ? aocr::cb_resident<float>()
                              : aocr::cb_resident<__nv_bfloat16>();
  int n, rows, smem;
  if (!aocr::cb_plan(B, H, W, resident, aocr::CB_STAGE_MAX, &n, &rows,
                     &smem))
    return (int)cudaErrorInvalidValue;
  const int v[4] = {n, rows, smem, resident};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
  return 0;
}
