// One greedy step after the LSTM stack: attention, h~, projector,
// log-softmax, PAD/EOS freeze, argmax.
//
// Replaces aocr/ops/pallas/decode_step.py::fused_decode_tail (pl.pallas_call
// at decode_step.py:199), with its optional trie plane: a (B, Vp) float32
// 0/1 validity plane that the caller gathers from the transition table;
// invalid log-probs count as -1e30 before the argmax, then the freeze
// (decode_step.py:115-128).
//
// Bound on the H100: weight reads.  Per step a block of BT rows reads
// W_a (H x H), W_c (2H x H) and W_p (H x Vp) once -- 6.3 MiB in bf16, 12.5
// MiB in float32 at H=1024 -- and the (L, BT, H) context slice twice,
// against BT multiply-adds per weight element.  The TPU kernel kept the
// weights in VMEM across the batch grid; here every block streams them,
// and one block's stream bounds the step, as in greedy_loop.cu.  Every
// intermediate (q, scores, alpha, ctx, h~, logits) stays in shared
// memory, so device memory sees only the context, the weights and the
// (B, H) h~ output.  The math lives in decode_tail.cuh, shared with
// greedy_loop.cu.
#include "decode_tail.cuh"

namespace aocr {

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
decode_step_kernel(const T* __restrict__ h,      // (B, H)
                   const T* __restrict__ ctx,    // (L, B, H)
                   const int* __restrict__ prev, // (B,)
                   const T* __restrict__ wa, const T* __restrict__ wc,
                   const T* __restrict__ pw, const float* __restrict__ pb,
                   const float* __restrict__ valid,  // (B, Vp) or null
                   float* __restrict__ htilde,   // (B, H)
                   int* __restrict__ tok, float* __restrict__ delta,  // (B,)
                   int L, int B, int H, int Vp) {
  extern __shared__ float smem[];
  TailSmem sm(smem, H, L, Vp);
  const int b0 = blockIdx.x * DEC_BT;
  const int nrows = min(DEC_BT, B - b0);
  for (int i = threadIdx.x; i < DEC_BT * H; i += blockDim.x) {
    const int r = i / H, j = i % H;
    sm.X[r * 2 * H + H + j] =
        r < nrows ? to_f(h[(size_t)(b0 + r) * H + j]) : 0.f;
  }
  if (threadIdx.x < DEC_BT)
    sm.prev[threadIdx.x] = threadIdx.x < nrows ? prev[b0 + threadIdx.x] : PAD;
  __syncthreads();
  attention_tail<T>(
      ctx, L, B, H, b0, nrows, wa, wc, pw, pb, Vp, sm,
      [&](int r, int j, float v) { htilde[(size_t)(b0 + r) * H + j] = v; },
      [&](int r, int v) {
        return valid == nullptr || valid[(size_t)(b0 + r) * Vp + v] > 0.f;
      });
  if (threadIdx.x < nrows) {
    tok[b0 + threadIdx.x] = sm.tok[threadIdx.x];
    delta[b0 + threadIdx.x] = sm.delta[threadIdx.x];
  }
}

template <typename T>
static int launch(const void* h, const void* ctx, const void* prev,
                  const void* wa, const void* wc, const void* pw,
                  const void* pb, const void* valid, void* htilde, void* tok,
                  void* delta, int L, int B, int H, int Vp,
                  cudaStream_t stream) {
  size_t smem = TailSmem::bytes(H, L, Vp, 0);
  cudaError_t e = set_smem((const void*)decode_step_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + DEC_BT - 1) / DEC_BT);
  decode_step_kernel<T><<<grid, DEC_THREADS, smem, stream>>>(
      (const T*)h, (const T*)ctx, (const int*)prev, (const T*)wa,
      (const T*)wc, (const T*)pw, (const float*)pb, (const float*)valid,
      (float*)htilde, (int*)tok, (float*)delta, L, B, H, Vp);
  return (int)cudaGetLastError();
}

}  // namespace aocr

#define AOCR_STEP_ARGS                                                      \
  const void *h, const void *ctx, const void *prev, const void *wa,         \
      const void *wc, const void *pw, const void *pb, const void *valid,    \
      void *htilde, void *tok, void *delta, int L, int B, int H, int Vp,    \
      void *stream

extern "C" int aocr_decode_step_f32(AOCR_STEP_ARGS) {
  return aocr::launch<float>(h, ctx, prev, wa, wc, pw, pb, valid, htilde, tok,
                             delta, L, B, H, Vp, (cudaStream_t)stream);
}

extern "C" int aocr_decode_step_bf16(AOCR_STEP_ARGS) {
  return aocr::launch<__nv_bfloat16>(h, ctx, prev, wa, wc, pw, pb, valid,
                                     htilde, tok, delta, L, B, H, Vp,
                                     (cudaStream_t)stream);
}
