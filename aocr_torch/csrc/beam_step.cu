// One beam-search step after the LSTM stack: grouped attention, h~, the
// projector, log-softmax, the PAD/EOS freeze, the score add, the optional
// trie plane, and the top-K over the K x V candidates of each batch row,
// with refill.
//
// Replaces aocr/ops/pallas/beam_step.py::fused_beam_tail (pl.pallas_call
// at beam_step.py:185).  Inputs: the packed (B, K*H) top hidden state (row-
// major identical to (B*K, H)), the scan-major (L, B, H) context, prev and
// scores (B, K), and optionally a (B, K*Vp) float32 0/1 validity plane
// gathered from the trie.  Outputs: h~ (B, K*H) float32, new scores,
// parents and tokens (B, K), and with the plane the valid-candidate count
// (B,).
//
// One block owns one batch row and all its K beams, since the top-K spans
// them.  The beams go through attention and the projector in chunks of
// BEAM_BT rows (any K, up to V), each chunk's scored candidates land in a
// K x V buffer in shared memory, and one warp runs the top-K over it
// (beam_tail.cuh).  The K beams of the row attend over its one context row:
// the context is never replicated per beam.
//
// Bound on the H100: as decode_step.cu, one block's stream of W_a, W_c and
// the projector (6.3 MiB bf16 at H=1024) per chunk, against BEAM_BT
// multiply-adds per weight element; the B x K rows of a step take
// ceil(K / BEAM_BT) such streams per block.  Tensor cores are later work.
#include "beam_tail.cuh"

namespace aocr {

constexpr int BEAM_BT = 8;  // beam rows of a chunk

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
beam_step_kernel(const T* __restrict__ ctx,       // (L, B, H)
                 const T* __restrict__ h,         // (B*K, H)
                 const int* __restrict__ prev,    // (B, K)
                 const float* __restrict__ scores,  // (B, K)
                 const T* __restrict__ wa, const T* __restrict__ wc,
                 const T* __restrict__ pw, const float* __restrict__ pb,
                 const float* __restrict__ valid,  // (B, K*Vp) or null
                 float* __restrict__ htilde,      // (B*K, H)
                 float* __restrict__ nsc,         // (B, K)
                 int* __restrict__ par, int* __restrict__ tok,  // (B, K)
                 int* __restrict__ nvalid,        // (B,) or null
                 int L, int B, int H, int Vp, int V, int K) {
  constexpr int BT = BEAM_BT;
  extern __shared__ float smem[];
  TailSmemT<BT> sm(smem, H, L, Vp);
  float* tot = sm.delta + BT;          // K x V scored candidates
  float* score = tot + (size_t)K * V;  // K running scores
  float* osc = score + K;              // K: the top-K's scores
  int* opar = reinterpret_cast<int*>(osc + K);
  int* otok = opar + K;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b = blockIdx.x;
  const size_t r0 = (size_t)b * K;  // the row's first beam
  for (int k = tid; k < K; k += nthr) score[k] = scores[r0 + k];

  for (int c0 = 0; c0 < K; c0 += BT) {
    const int nrows = min(BT, K - c0);
    for (int i = tid; i < BT * H; i += nthr) {
      const int r = i / H, j = i % H;
      sm.X[r * 2 * H + H + j] =
          r < nrows ? to_f(h[(r0 + c0 + r) * H + j]) : 0.f;
    }
    if (tid < BT) sm.prev[tid] = tid < nrows ? prev[r0 + c0 + tid] : PAD;
    __syncthreads();
    // every row of the chunk attends over context row b (r / BT == 0)
    attention_htilde(
        ctx, L, B, H, b, nrows, wa, wc, sm,
        [&](int r, int j, float v) { htilde[(r0 + c0 + r) * H + j] = v; },
        BT);
    projector_logp<T>(H, nrows, pw, pb, Vp, sm);
    for (int i = tid; i < nrows * V; i += nthr) {
      const int r = i / V, v = i % V, k = c0 + r;
      const bool ok =
          valid == nullptr || valid[(r0 + k) * Vp + v] > 0.f;
      tot[k * V + v] = ok ? score[k] + sm.P[r * Vp + v] : NEG_BIG;
    }
    __syncthreads();
  }

  if (tid < 32) {
    const int nv =
        beam_topk_warp(tot, V, K, V, valid != nullptr, osc, opar, otok);
    if (tid == 0 && nvalid != nullptr) nvalid[b] = nv;
  }
  __syncthreads();
  for (int k = tid; k < K; k += nthr) {
    nsc[r0 + k] = osc[k];
    par[r0 + k] = opar[k];
    tok[r0 + k] = otok[k];
  }
}

template <typename T>
static int launch(const void* ctx, const void* h, const void* prev,
                  const void* scores, const void* wa, const void* wc,
                  const void* pw, const void* pb, const void* valid,
                  void* htilde, void* nsc, void* par, void* tok, void* nvalid,
                  int L, int B, int H, int Vp, int V, int K,
                  cudaStream_t stream) {
  size_t smem = TailSmemT<BEAM_BT>::bytes(H, L, Vp, K * V + 4 * K);
  cudaError_t e = set_smem((const void*)beam_step_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  beam_step_kernel<T><<<B, DEC_THREADS, smem, stream>>>(
      (const T*)ctx, (const T*)h, (const int*)prev, (const float*)scores,
      (const T*)wa, (const T*)wc, (const T*)pw, (const float*)pb,
      (const float*)valid, (float*)htilde, (float*)nsc, (int*)par, (int*)tok,
      (int*)nvalid, L, B, H, Vp, V, K);
  return (int)cudaGetLastError();
}

}  // namespace aocr

#define AOCR_BEAM_STEP_ARGS                                                  \
  const void *ctx, const void *h, const void *prev, const void *scores,     \
      const void *wa, const void *wc, const void *pw, const void *pb,       \
      const void *valid, void *htilde, void *nsc, void *par, void *tok,     \
      void *nvalid, int L, int B, int H, int Vp, int V, int K, void *stream

extern "C" int aocr_beam_step_f32(AOCR_BEAM_STEP_ARGS) {
  return aocr::launch<float>(ctx, h, prev, scores, wa, wc, pw, pb, valid,
                             htilde, nsc, par, tok, nvalid, L, B, H, Vp, V, K,
                             (cudaStream_t)stream);
}

extern "C" int aocr_beam_step_bf16(AOCR_BEAM_STEP_ARGS) {
  return aocr::launch<__nv_bfloat16>(ctx, h, prev, scores, wa, wc, pw, pb,
                                     valid, htilde, nsc, par, tok, nvalid, L,
                                     B, H, Vp, V, K, (cudaStream_t)stream);
}
