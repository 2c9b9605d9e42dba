// The teacher-forced decoder forward, all T steps in one launch.
//
// Replaces aocr/ops/pallas/tf_fwd.py::decoder_fwd_scan (pl.pallas_call at
// tf_fwd.py:252), the training mirror of the greedy loop (greedy_loop.cu):
// the hoisted input projection xp[t] (emb @ Wi[:E] + bi + bh, computed
// batched outside) streams in instead of an embedding gather, there is no
// projector or argmax, and the residual stacks the backward (tf_bwd.cu)
// reads are written every step.
//
// Each step of each row: layer 0 on [attn; h0] @ wfh0 + xp[t], layers
// l >= 1 on [h_{l-1}; h_l] @ W_l + bi_l + bh_l (the two biases added
// separately, as the reference's scan body), then the attention and h~ of
// decode_tail.cuh with q and alpha rounded to the compute dtype before
// their contractions (tf_fwd.py:125-132).  The input-feed carry h~ stays
// float32 and is rounded at the matmul.  The LSTM stack step and the state
// layout are greedy_loop.cu's (decoder_stack_step).
//
// Outputs: h~ (T, B, H) float32; with collect, per layer the h, gate
// activation and cell-state stacks (nl, T, B, H | 4H | H) in the compute
// dtype, alpha (T, B, L) float32 and the context vectors (T, B, H) in the
// compute dtype.
//
// Bound on the H100: one block's weight stream, as greedy_loop.cu.  One
// block owns BT batch rows and runs the T-step loop itself, streaming the
// ~39 MiB (bf16) of decoder weights from L2 / device memory each step;
// the per-row state (attn, and c, h of each layer, float32) lives in a
// global scratch buffer that only this block touches.  Tensor cores are
// later work.
#include "decode_tail.cuh"

namespace aocr {

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
tf_fwd_kernel(const T* __restrict__ ctx,     // (L, B, H)
              const float* __restrict__ c0,  // (B, H)
              const float* __restrict__ h0,  // (B, H)
              const T* __restrict__ xp,      // (T, B, 4H)
              const T* __restrict__ wfh0,    // (K0, 4H)
              const T* __restrict__ wx,      // (nl-1, 2H, 4H)
              const float* __restrict__ bi,  // (nl-1, 4H)
              const float* __restrict__ bh,  // (nl-1, 4H)
              const T* __restrict__ wa, const T* __restrict__ wc,
              float* __restrict__ htl,       // (T, B, H)
              T* __restrict__ hs,            // (nl, T, B, H), or null
              T* __restrict__ ifog,          // (nl, T, B, 4H)
              T* __restrict__ cs,            // (nl, T, B, H)
              float* __restrict__ alpha,     // (T, B, L)
              T* __restrict__ cvec,          // (T, B, H)
              float* __restrict__ state,     // (B, 2*nl+1, H)
              int L, int B, int H, int T_, int nl, int input_feed) {
  constexpr int BT = DEC_BT;
  extern __shared__ float smem[];
  TailSmem sm(smem, H, L, 0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);
  const int G = 4 * H, H2 = 2 * H;
  const int nslot = 2 * nl + 1;
  const bool collect = hs != nullptr;
  auto st = [&](int r, int slot) {
    return state + ((size_t)(b0 + r) * nslot + slot) * H;
  };

  decoder_state_init(st, c0, h0, b0, nrows, H, nl);
  __syncthreads();

  for (int t = 0; t < T_; ++t) {
    // layer 0 adds xp[t], the other layers bi then bh (separately, as the
    // reference's scan body); with collect, each unit's residuals are kept
    auto pre = [&](int l, int r, int q, int j, float acc) {
      const size_t c = (size_t)q * H + j;
      if (l == 0) return to_f(xp[((size_t)t * B + b0 + r) * G + c]) + acc;
      return acc + bi[(size_t)(l - 1) * G + c] + bh[(size_t)(l - 1) * G + c];
    };
    auto seen = [&](int l, int r, int j, float c, float h,
                    const float (&a)[4]) {
      if (!collect) return;
      const size_t row = ((size_t)l * T_ + t) * B + b0 + r;
      hs[row * H + j] = from_f<T>(h);
      cs[row * H + j] = from_f<T>(c);
#pragma unroll
      for (int q = 0; q < 4; ++q) ifog[row * G + q * H + j] = from_f<T>(a[q]);
    };
    decoder_stack_step<T>(st, sm.X, wfh0, wx, H, nl, nrows, input_feed, pre,
                          seen);
    attention_htilde<true>(
        ctx, L, B, H, b0, nrows, wa, wc, sm, [&](int r, int j, float v) {
          st(r, 0)[j] = v;
          htl[((size_t)t * B + b0 + r) * H + j] = v;
        });
    if (collect) {
      for (int i = tid; i < nrows * L; i += nthr)
        alpha[((size_t)t * B + b0) * L + i] = sm.A[i];
      for (int i = tid; i < nrows * H; i += nthr) {
        const int r = i / H, j = i % H;
        cvec[((size_t)t * B + b0 + r) * H + j] = from_f<T>(sm.X[r * H2 + j]);
      }
    }
    __syncthreads();
  }
}

template <typename T>
static int launch(const void* ctx, const void* c0, const void* h0,
                  const void* xp, const void* wfh0, const void* wx,
                  const void* bi, const void* bh, const void* wa,
                  const void* wc, void* htl, void* hs, void* ifog, void* cs,
                  void* alpha, void* cvec, void* state, int L, int B, int H,
                  int T_, int nl, int input_feed, cudaStream_t stream) {
  size_t smem = TailSmem::bytes(H, L, 0, 0);
  cudaError_t e = set_smem((const void*)tf_fwd_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + DEC_BT - 1) / DEC_BT);
  tf_fwd_kernel<T><<<grid, DEC_THREADS, smem, stream>>>(
      (const T*)ctx, (const float*)c0, (const float*)h0, (const T*)xp,
      (const T*)wfh0, (const T*)wx, (const float*)bi, (const float*)bh,
      (const T*)wa, (const T*)wc, (float*)htl, (T*)hs, (T*)ifog, (T*)cs,
      (float*)alpha, (T*)cvec, (float*)state, L, B, H, T_, nl, input_feed);
  return (int)cudaGetLastError();
}

}  // namespace aocr

#define AOCR_TF_FWD_ARGS                                                     \
  const void *ctx, const void *c0, const void *h0, const void *xp,          \
      const void *wfh0, const void *wx, const void *bi, const void *bh,     \
      const void *wa, const void *wc, void *htl, void *hs, void *ifog,      \
      void *cs, void *alpha, void *cvec, void *state, int L, int B, int H,  \
      int T_, int nl, int input_feed, void *stream

extern "C" int aocr_tf_fwd_f32(AOCR_TF_FWD_ARGS) {
  return aocr::launch<float>(ctx, c0, h0, xp, wfh0, wx, bi, bh, wa, wc, htl,
                             hs, ifog, cs, alpha, cvec, state, L, B, H, T_,
                             nl, input_feed, (cudaStream_t)stream);
}

extern "C" int aocr_tf_fwd_bf16(AOCR_TF_FWD_ARGS) {
  return aocr::launch<__nv_bfloat16>(ctx, c0, h0, xp, wfh0, wx, bi, bh, wa,
                                     wc, htl, hs, ifog, cs, alpha, cvec,
                                     state, L, B, H, T_, nl, input_feed,
                                     (cudaStream_t)stream);
}
