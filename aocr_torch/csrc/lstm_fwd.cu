// One encoder direction's LSTM recurrence, all L steps in one launch.
//
// Replaces aocr/ops/pallas/lstm_fwd.py::lstm_fwd_scan (pl.pallas_call at
// lstm_fwd.py:158) in both modes: collect=False (inference), and
// collect=True (training), which also writes the residual stacks the
// backward kernel (lstm_bwd.cu) reads: the gate activations ifog
// (L, B, 4H) and the cell states cs (L, B, H), both rounded to the
// compute dtype as aocr/ops/lstm.py::_collect_from_proj stores them.
//
// Bound on the H100: reads of Wh.  Every step needs every column of h, so
// a block owns a tile of BT batch rows and ALL 4H gate columns and loops
// over L inside: no step needs a grid-wide sync.  The price is that each
// block re-reads the whole (H, 4H) Wh every step (2 MiB in bf16 at
// H=512) from L2, so how fast one block streams Wh through its FMA loop
// bounds the kernel (BT multiply-adds per weight read), as in
// greedy_loop.cu.  The TPU kernel kept Wh resident in
// VMEM; splitting H across a cluster of SMs (distributed shared memory)
// or a cooperative grid would do the same here and is later work.
//
// Each thread owns U consecutive hidden units j and computes their four
// gate columns (j, H+j, 2H+j, 3H+j) for the BT rows, so the gate math
// needs no exchange; (c, h) stay float32.  h is kept in shared memory
// rounded to the compute dtype (the matmul operand), double-buffered so
// the step needs a single __syncthreads.  reverse walks L-1..0 and writes
// hs at the original time index; the finals are the state after the
// last step walked.
//
// Numerics as aocr/ops/lstm.py::_scan_from_proj: gates = x_proj[t]
// (upcast) + round_cd(h) @ Wh in float32, gate math in float32.
#include "common.cuh"

namespace aocr {

// 8-row tiles (64 blocks at B=512) ran faster on an H100 than 4- or
// 2-row tiles: fewer re-reads of Wh per step outweigh the idle SMs.
constexpr int LSTM_BT = 8;
constexpr int LSTM_U = 2;
constexpr int LSTM_THREADS = 256;

template <typename T, typename XP>
__global__ void __launch_bounds__(LSTM_THREADS)
lstm_fwd_kernel(const T* __restrict__ wh,      // (H, 4H)
                const XP* __restrict__ xp,     // (L, B, 4H)
                const float* __restrict__ c0,  // (B, H)
                const float* __restrict__ h0,  // (B, H)
                T* __restrict__ hs,            // (L, B, H)
                float* __restrict__ cf, float* __restrict__ hf,  // (B, H)
                T* __restrict__ ifog,  // (L, B, 4H) or null: no residuals
                T* __restrict__ cs,    // (L, B, H) or null
                int L, int B, int H, int reverse) {
  constexpr int BT = LSTM_BT, U = LSTM_U;
  extern __shared__ float sm[];
  float* cur = sm;              // BT x H: round_cd(h) read this step
  float* nxt = sm + BT * H;     // BT x H: round_cd(h) written this step
  float* cst = sm + 2 * BT * H; // BT x H: c
  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);
  const int G = 4 * H;
  for (int i = threadIdx.x; i < BT * H; i += blockDim.x) {
    int r = i / H, j = i % H;
    bool ok = r < nrows;
    size_t g = (size_t)(b0 + r) * H + j;
    cst[i] = ok ? c0[g] : 0.f;
    cur[i] = ok ? round_cd<T>(h0[g]) : 0.f;
    nxt[i] = 0.f;
  }
  __syncthreads();

  for (int s = 0; s < L; ++s) {
    const int t = reverse ? L - 1 - s : s;
    for (int ch = threadIdx.x; ch * U < H; ch += blockDim.x) {
      const int j0 = ch * U;
      float acc[4][U][BT];
      zero(acc);
      mm_cols<T, BT, 4, U>(cur, H, H, wh, G, H, j0, acc);
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        if (r >= nrows) continue;
        const size_t row = (size_t)t * B + b0 + r;
        const XP* xr = xp + row * G;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u;
          float c, h, a[4];
          gate_math_parts(to_f(xr[j]) + acc[0][u][r],
                          to_f(xr[H + j]) + acc[1][u][r],
                          to_f(xr[2 * H + j]) + acc[2][u][r],
                          to_f(xr[3 * H + j]) + acc[3][u][r], cst[r * H + j],
                          &c, &h, a);
          cst[r * H + j] = c;
          nxt[r * H + j] = round_cd<T>(h);
          hs[row * H + j] = from_f<T>(h);
          if (ifog != nullptr) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              ifog[row * G + q * H + j] = from_f<T>(a[q]);
            cs[row * H + j] = from_f<T>(c);
          }
          if (s == L - 1) {
            cf[(size_t)(b0 + r) * H + j] = c;
            hf[(size_t)(b0 + r) * H + j] = h;
          }
        }
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

template <typename T, typename XP>
static int launch(const void* wh, const void* xp, const void* c0,
                  const void* h0, void* hs, void* cf, void* hf, void* ifog,
                  void* cs, int L, int B, int H, int reverse,
                  cudaStream_t stream) {
  auto* fn = lstm_fwd_kernel<T, XP>;
  size_t smem = sizeof(float) * 3 * LSTM_BT * H;
  cudaError_t e = set_smem((const void*)fn, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + LSTM_BT - 1) / LSTM_BT);
  fn<<<grid, LSTM_THREADS, smem, stream>>>(
      (const T*)wh, (const XP*)xp, (const float*)c0, (const float*)h0, (T*)hs,
      (float*)cf, (float*)hf, (T*)ifog, (T*)cs, L, B, H, reverse);
  return (int)cudaGetLastError();
}

}  // namespace aocr

#define AOCR_LSTM_FWD_ARGS                                                 \
  const void *wh, const void *xp, int xp_is_f32, const void *c0,          \
      const void *h0, void *hs, void *cf, void *hf, void *ifog, void *cs, \
      int L, int B, int H, int reverse, void *stream

extern "C" int aocr_lstm_fwd_f32(AOCR_LSTM_FWD_ARGS) {
  if (!xp_is_f32) return (int)cudaErrorInvalidValue;
  return aocr::launch<float, float>(wh, xp, c0, h0, hs, cf, hf, ifog, cs, L,
                                    B, H, reverse, (cudaStream_t)stream);
}

extern "C" int aocr_lstm_fwd_bf16(AOCR_LSTM_FWD_ARGS) {
  if (xp_is_f32)
    return aocr::launch<__nv_bfloat16, float>(wh, xp, c0, h0, hs, cf, hf,
                                              ifog, cs, L, B, H, reverse,
                                              (cudaStream_t)stream);
  return aocr::launch<__nv_bfloat16, __nv_bfloat16>(
      wh, xp, c0, h0, hs, cf, hf, ifog, cs, L, B, H, reverse,
      (cudaStream_t)stream);
}
