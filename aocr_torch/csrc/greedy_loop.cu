// The whole T-step greedy decode in one launch.
//
// Replaces aocr/ops/pallas/greedy_loop.py::fused_greedy_loop (pl.pallas_call
// at greedy_loop.py:362) without the in-kernel trie (later work).
//
// Each step of each row: the emb_gates row of the previous token (a
// gather; the TPU's one-hot matmul was a Mosaic workaround), layer 0 on
// [attn; h0] @ [Wi[E:]; Wh], the other layers on [x; h_l] @ [Wi; Wh] + b,
// then the shared attention tail (decode_tail.cuh), the PAD/EOS freeze,
// the argmax, the score sum and the token history.
//
// Bound on the H100: one block's weight stream.  The TPU kernel kept
// every decoder weight in VMEM for the whole decode; at H=1024 they are
// ~39 MiB in bf16 and ~79 MiB in float32, far beyond the 227 KB a block
// can hold.  So one block owns BT batch rows and runs the T-step loop
// itself, streaming the weights from L2 / device memory every step: BT
// multiply-adds per weight element read.  On an H100 a lone block takes
// nearly as long as 128 of them (68 vs 77 ms in bf16 at T=50), and ~95%
// of its step is the four weight matmuls: the block's CUDA-core FMA loop
// and the loads it keeps in flight bound it, not the card's bandwidth.
// The per-row decoder state (attn, and c, h of each layer, float32) lives
// in a global scratch buffer that only this block touches; matmul
// operands are staged in shared memory rounded to the compute dtype.
// A block stops as soon as all its rows are frozen (per-tile early exit);
// the history was PAD-filled first, as the reference's buffer.  Tensor
// cores, and splitting the gate columns across a cluster or the grid, are
// later work.
#include "decode_tail.cuh"

namespace aocr {

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
greedy_loop_kernel(const T* __restrict__ ctx,     // (L, B, H)
                   const float* __restrict__ c0,  // (B, H)
                   const float* __restrict__ h0,  // (B, H)
                   const T* __restrict__ eg,      // (V, 4H)
                   const T* __restrict__ wfh0,    // (K0, 4H)
                   const T* __restrict__ wx,      // (nl-1, 2H, 4H)
                   const float* __restrict__ bx,  // (nl-1, 4H)
                   const T* __restrict__ wa, const T* __restrict__ wc,
                   const T* __restrict__ pw, const float* __restrict__ pb,
                   int* __restrict__ labels,      // (B, T)
                   float* __restrict__ scores,    // (B,)
                   float* __restrict__ state,     // (B, 2*nl+1, H)
                   int L, int B, int H, int Vp, int T_, int nl,
                   int input_feed) {
  constexpr int BT = DEC_BT, U = DEC_U;
  extern __shared__ float smem[];
  TailSmem sm(smem, H, L, Vp);
  float* score = sm.delta + BT;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);
  const int G = 4 * H, H2 = 2 * H;
  const int K0 = input_feed ? H2 : H;
  const int nslot = 2 * nl + 1;
  // slot 0: attn (h~ of the last step); 1 + 2l: c_l; 2 + 2l: h_l
  auto st = [&](int r, int slot) {
    return state + ((size_t)(b0 + r) * nslot + slot) * H;
  };

  for (int i = tid; i < nrows * H; i += nthr) {
    const int r = i / H, j = i % H;
    const size_t g = (size_t)(b0 + r) * H + j;
    st(r, 0)[j] = 0.f;
    st(r, 1)[j] = c0[g];
    st(r, 2)[j] = h0[g];
    for (int l = 1; l < nl; ++l) {
      st(r, 1 + 2 * l)[j] = 0.f;
      st(r, 2 + 2 * l)[j] = 0.f;
    }
  }
  for (int i = tid; i < nrows * T_; i += nthr)
    labels[(size_t)b0 * T_ + i] = PAD;
  if (tid < BT) {
    sm.prev[tid] = tid < nrows ? GO : PAD;  // rows past B start frozen
    score[tid] = 0.f;
  }
  __syncthreads();

  for (int t = 0; t < T_; ++t) {
    bool live = false;
#pragma unroll
    for (int r = 0; r < BT; ++r)
      live |= !(sm.prev[r] == PAD || sm.prev[r] == EOS);
    if (!live) break;  // uniform: every thread read the same shared words

    // ---- layer 0: eg[prev] + [attn; h0] @ wfh0 ----
    for (int i = tid; i < BT * K0; i += nthr) {
      const int r = i / K0, k = i % K0;
      float v = 0.f;
      if (r < nrows)
        v = (input_feed && k < H) ? st(r, 0)[k]
                                  : st(r, 2)[input_feed ? k - H : k];
      sm.X[i] = round_cd<T>(v);
    }
    __syncthreads();
    for (int ch = tid; ch * U < H; ch += nthr) {
      const int j0 = ch * U;
      float acc[4][U][BT];
      zero(acc);
      mm_cols<T, BT, 4, U>(sm.X, K0, K0, wfh0, G, H, j0, acc);
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        if (r >= nrows) continue;
        const T* egr = eg + (size_t)sm.prev[r] * G;
        float* cr = st(r, 1);
        float* hr = st(r, 2);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u;
          gate_math(to_f(egr[j]) + acc[0][u][r], to_f(egr[H + j]) + acc[1][u][r],
                    to_f(egr[2 * H + j]) + acc[2][u][r],
                    to_f(egr[3 * H + j]) + acc[3][u][r], cr[j], &cr[j], &hr[j]);
        }
      }
    }
    __syncthreads();

    // ---- layers 1..nl-1: [x; h_l] @ [Wi; Wh] + (bi + bh) ----
    for (int l = 1; l < nl; ++l) {
      for (int i = tid; i < BT * H2; i += nthr) {
        const int r = i / H2, k = i % H2;
        float v = 0.f;
        if (r < nrows) v = k < H ? st(r, 2 * l)[k] : st(r, 2 + 2 * l)[k - H];
        sm.X[i] = round_cd<T>(v);
      }
      __syncthreads();
      const T* w = wx + (size_t)(l - 1) * H2 * G;
      const float* b = bx + (size_t)(l - 1) * G;
      for (int ch = tid; ch * U < H; ch += nthr) {
        const int j0 = ch * U;
        float acc[4][U][BT];
        zero(acc);
        mm_cols<T, BT, 4, U>(sm.X, H2, H2, w, G, H, j0, acc);
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          if (r >= nrows) continue;
          float* cr = st(r, 1 + 2 * l);
          float* hr = st(r, 2 + 2 * l);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int j = j0 + u;
            gate_math(acc[0][u][r] + b[j], acc[1][u][r] + b[H + j],
                      acc[2][u][r] + b[2 * H + j], acc[3][u][r] + b[3 * H + j],
                      cr[j], &cr[j], &hr[j]);
          }
        }
      }
      __syncthreads();
    }

    // ---- attention tail on h_top ----
    for (int i = tid; i < BT * H; i += nthr) {
      const int r = i / H, j = i % H;
      sm.X[r * H2 + H + j] = r < nrows ? round_cd<T>(st(r, 2 * nl)[j]) : 0.f;
    }
    __syncthreads();
    attention_tail<T>(ctx, L, B, H, b0, nrows, wa, wc, pw, pb, Vp, sm,
                      [&](int r, int j, float v) { st(r, 0)[j] = v; });
    if (tid < nrows) {
      const int tk = sm.tok[tid];
      score[tid] += sm.delta[tid];
      sm.prev[tid] = tk;
      labels[(size_t)(b0 + tid) * T_ + t] = tk;
    }
    __syncthreads();
  }
  if (tid < nrows) scores[b0 + tid] = score[tid];
}

template <typename T>
static int launch(const void* ctx, const void* c0, const void* h0,
                  const void* eg, const void* wfh0, const void* wx,
                  const void* bx, const void* wa, const void* wc,
                  const void* pw, const void* pb, void* labels, void* scores,
                  void* state, int L, int B, int H, int Vp, int T_, int nl,
                  int input_feed, cudaStream_t stream) {
  size_t smem = TailSmem::bytes(H, L, Vp, DEC_BT);
  cudaError_t e = set_smem((const void*)greedy_loop_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + DEC_BT - 1) / DEC_BT);
  greedy_loop_kernel<T><<<grid, DEC_THREADS, smem, stream>>>(
      (const T*)ctx, (const float*)c0, (const float*)h0, (const T*)eg,
      (const T*)wfh0, (const T*)wx, (const float*)bx, (const T*)wa,
      (const T*)wc, (const T*)pw, (const float*)pb, (int*)labels,
      (float*)scores, (float*)state, L, B, H, Vp, T_, nl, input_feed);
  return (int)cudaGetLastError();
}

}  // namespace aocr

#define AOCR_LOOP_ARGS                                                       \
  const void *ctx, const void *c0, const void *h0, const void *eg,          \
      const void *wfh0, const void *wx, const void *bx, const void *wa,     \
      const void *wc, const void *pw, const void *pb, void *labels,         \
      void *scores, void *state, int L, int B, int H, int Vp, int T_, int nl, \
      int input_feed, void *stream

extern "C" int aocr_greedy_loop_f32(AOCR_LOOP_ARGS) {
  return aocr::launch<float>(ctx, c0, h0, eg, wfh0, wx, bx, wa, wc, pw, pb,
                             labels, scores, state, L, B, H, Vp, T_, nl,
                             input_feed, (cudaStream_t)stream);
}

extern "C" int aocr_greedy_loop_bf16(AOCR_LOOP_ARGS) {
  return aocr::launch<__nv_bfloat16>(ctx, c0, h0, eg, wfh0, wx, bx, wa, wc,
                                     pw, pb, labels, scores, state, L, B, H,
                                     Vp, T_, nl, input_feed,
                                     (cudaStream_t)stream);
}
