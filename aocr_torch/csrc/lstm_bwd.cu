// One encoder direction's LSTM backward recurrence, all L steps in one
// launch.
//
// Replaces aocr/ops/pallas/lstm_bwd.py::lstm_bwd_scan (pl.pallas_call at
// lstm_bwd.py:131).  From the residuals lstm_fwd.cu wrote in its collect
// mode (gate activations ifog, cell states cs, compute dtype) and the
// output cotangents, it carries only the recurrent (dh, dc) chain and
// emits the per-step pre-activation gate cotangents dgates (L, B, 4H) in
// the compute dtype (the TPU kernel's contract, lstm_bwd.py:104-112), plus
// the initial-state cotangents dh0, dc0 (float32).  dWh, dWi, db and dx
// are batched products over the whole sequence outside the kernel
// (aocr_torch/ops/lstm.py).
//
// The walk is the transpose of the forward's: L-1..0 for the forward
// encoder, 0..L-1 for the reversed one.  The previous cell state of each
// step is read from the cs stack (c0, rounded to the compute dtype, at
// the first step of the forward walk), so no shifted copy is made.
//
// Bound on the H100: reads of Wh, as in lstm_fwd.cu.  A block owns BT
// batch rows and all H columns and loops over L inside; (dh, dc) stay
// float32 in shared memory.  dh_prev = round_cd(dgates) @ Wh^T contracts
// Wh in its stored (H, 4H) orientation: each warp takes NR rows of Wh and
// splits the 4H axis over its lanes (mm_rows), so the loads stay
// coalesced without a transposed copy.  Needs H % 16 == 0.
#include "common.cuh"

namespace aocr {

constexpr int LB_BT = 4;        // batch rows per block
// rows of Wh per warp pass: one shared-memory read of dgates serves 16
// rows (an A/B on an H100, PERF.md: 1.30 vs 2.55 ms bf16 with 4 rows)
constexpr int LB_NR = 16;
constexpr int LB_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(LB_THREADS)
lstm_bwd_kernel(const T* __restrict__ wh,       // (H, 4H)
                const float* __restrict__ dhs,  // (L, B, H)
                const T* __restrict__ ifog,     // (L, B, 4H)
                const T* __restrict__ cs,       // (L, B, H)
                const float* __restrict__ c0,   // (B, H)
                const float* __restrict__ dcf,  // (B, H)
                const float* __restrict__ dhf,  // (B, H)
                T* __restrict__ dg,             // (L, B, 4H)
                float* __restrict__ dh0, float* __restrict__ dc0,  // (B, H)
                int L, int B, int H, int reverse) {
  constexpr int BT = LB_BT, NR = LB_NR;
  extern __shared__ __align__(16) float sm[];
  const int G = 4 * H;
  float* dgs = sm;              // BT x 4H: round_cd(dgates), matmul operand
  float* dh = sm + BT * G;      // BT x H: dh carry
  float* dc = dh + BT * H;      // BT x H: dc carry
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, nwarps = nthr >> 5;
  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);

  for (int i = tid; i < BT * H; i += nthr) {
    const int r = i / H, j = i % H;
    const bool ok = r < nrows;
    const size_t g = (size_t)(b0 + r) * H + j;
    dh[i] = ok ? dhf[g] : 0.f;
    dc[i] = ok ? dcf[g] : 0.f;
  }
  __syncthreads();

  for (int s = 0; s < L; ++s) {
    const int t = reverse ? s : L - 1 - s;
    // the step the forward walk took just before t, and whether t was
    // its first step (then c_prev is c0)
    const int tp = reverse ? t + 1 : t - 1;
    const bool first = reverse ? t == L - 1 : t == 0;
    for (int i = tid; i < BT * H; i += nthr) {
      const int r = i / H, j = i % H;
      if (r >= nrows) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dgs[r * G + q * H + j] = 0.f;
        continue;
      }
      const size_t row = (size_t)t * B + b0 + r;
      const T* a = ifog + row * G;
      const float cp =
          first ? round_cd<T>(c0[(size_t)(b0 + r) * H + j])
                : to_f(cs[((size_t)tp * B + b0 + r) * H + j]);
      float d[4], dcp;
      gate_math_bwd(dh[i] + dhs[row * H + j], dc[i], to_f(a[j]),
                    to_f(a[H + j]), to_f(a[2 * H + j]), to_f(a[3 * H + j]),
                    to_f(cs[row * H + j]), cp, d, &dcp);
      dc[i] = dcp;
      T* o = dg + row * G;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const T v = from_f<T>(d[q]);
        o[q * H + j] = v;
        dgs[r * G + q * H + j] = to_f(v);
      }
    }
    __syncthreads();
    // dh <- round_cd(dgates) @ Wh^T
    for (int n0 = warp * NR; n0 < H; n0 += nwarps * NR) {
      float acc[NR][BT];
      mm_rows<T, BT, NR>(dgs, G, G, wh, G, n0, acc);
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int r = 0; r < BT; ++r)
          if (lane_stores(n, r, BT)) dh[r * H + n0 + n] = acc[n][r];
    }
    __syncthreads();
  }
  for (int i = tid; i < nrows * H; i += nthr) {
    const size_t g = (size_t)b0 * H + i;
    dh0[g] = dh[i];
    dc0[g] = dc[i];
  }
}

template <typename T>
static int launch(const void* wh, const void* dhs, const void* ifog,
                  const void* cs, const void* c0, const void* dcf,
                  const void* dhf, void* dg, void* dh0, void* dc0, int L,
                  int B, int H, int reverse, cudaStream_t stream) {
  auto* fn = lstm_bwd_kernel<T>;
  size_t smem = sizeof(float) * LB_BT * 6 * H;
  cudaError_t e = set_smem((const void*)fn, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + LB_BT - 1) / LB_BT);
  fn<<<grid, LB_THREADS, smem, stream>>>(
      (const T*)wh, (const float*)dhs, (const T*)ifog, (const T*)cs,
      (const float*)c0, (const float*)dcf, (const float*)dhf, (T*)dg,
      (float*)dh0, (float*)dc0, L, B, H, reverse);
  return (int)cudaGetLastError();
}

}  // namespace aocr

#define AOCR_LSTM_BWD_ARGS                                                \
  const void *wh, const void *dhs, const void *ifog, const void *cs,     \
      const void *c0, const void *dcf, const void *dhf, void *dg,        \
      void *dh0, void *dc0, int L, int B, int H, int reverse, void *stream

extern "C" int aocr_lstm_bwd_f32(AOCR_LSTM_BWD_ARGS) {
  return aocr::launch<float>(wh, dhs, ifog, cs, c0, dcf, dhf, dg, dh0, dc0,
                             L, B, H, reverse, (cudaStream_t)stream);
}

extern "C" int aocr_lstm_bwd_bf16(AOCR_LSTM_BWD_ARGS) {
  return aocr::launch<__nv_bfloat16>(wh, dhs, ifog, cs, c0, dcf, dhf, dg, dh0,
                                     dc0, L, B, H, reverse,
                                     (cudaStream_t)stream);
}
