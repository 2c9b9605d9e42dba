// The whole T-step greedy decode in one launch.
//
// Replaces aocr/ops/pallas/greedy_loop.py::fused_greedy_loop (pl.pallas_call
// at greedy_loop.py:362), in-kernel trie included.
//
// Each step of each row: the emb_gates row of the previous token (a
// gather; the TPU's one-hot matmul was a Mosaic workaround), layer 0 on
// [attn; h0] @ [Wi[E:]; Wh], the other layers on [x; h_l] @ [Wi; Wh] + b,
// then the shared attention tail (decode_tail.cuh), the PAD/EOS freeze,
// the argmax, the score sum and the token history.
//
// Dictionary decoding: the dense (N, V) int32 transition table stays in
// device memory, unpadded (a 110k-node lexicon is 17 MB), and each row
// keeps its node id in shared memory; a step's validity is an integer read
// of the node's row (the TPU's one-hot f32 matmul lookup was a Mosaic
// workaround).  At t = 0 only the root's children are valid, PAD not;
// later PAD always is.  PAD keeps the node, any other token steps it
// (clamped at 0), as greedy_loop.py:153-187.
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
                   const int* __restrict__ trie,  // (N, V) or null
                   int* __restrict__ labels,      // (B, T)
                   float* __restrict__ scores,    // (B,)
                   float* __restrict__ state,     // (B, 2*nl+1, H)
                   int L, int B, int H, int Vp, int V, int T_, int nl,
                   int input_feed) {
  constexpr int BT = DEC_BT;
  extern __shared__ float smem[];
  TailSmem sm(smem, H, L, Vp);
  float* score = sm.delta + BT;
  int* node = reinterpret_cast<int*>(score + BT);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);
  const int G = 4 * H;
  const int nslot = 2 * nl + 1;
  auto st = [&](int r, int slot) {
    return state + ((size_t)(b0 + r) * nslot + slot) * H;
  };
  // layer 0 adds the emb_gates row of the previous token, the other
  // layers their summed biases
  auto pre = [&](int l, int r, int q, int j, float acc) {
    return l == 0 ? to_f(eg[(size_t)sm.prev[r] * G + q * H + j]) + acc
                  : acc + bx[(size_t)(l - 1) * G + q * H + j];
  };
  auto seen = [](int, int, int, float, float, const float(&)[4]) {};

  decoder_state_init(st, c0, h0, b0, nrows, H, nl);
  for (int i = tid; i < nrows * T_; i += nthr)
    labels[(size_t)b0 * T_ + i] = PAD;
  if (tid < BT) {
    sm.prev[tid] = tid < nrows ? GO : PAD;  // rows past B start frozen
    score[tid] = 0.f;
    node[tid] = 0;  // the root
  }
  __syncthreads();

  for (int t = 0; t < T_; ++t) {
    bool live = false;
#pragma unroll
    for (int r = 0; r < BT; ++r)
      live |= !(sm.prev[r] == PAD || sm.prev[r] == EOS);
    if (!live) break;  // uniform: every thread read the same shared words

    decoder_stack_step<T>(st, sm.X, wfh0, wx, H, nl, nrows, input_feed, pre,
                          seen);
    attention_tail<T>(
        ctx, L, B, H, b0, nrows, wa, wc, pw, pb, Vp, sm,
        [&](int r, int j, float v) { st(r, 0)[j] = v; },
        [&](int r, int v) {
          return trie == nullptr ||
                 (v < V && trie[(size_t)node[r] * V + v] >= 0) ||
                 (v == PAD && t > 0);
        });
    if (tid < nrows) {
      const int tk = sm.tok[tid];
      if (trie != nullptr && !(tk == PAD && t > 0))
        node[tid] =
            tk < V ? max(trie[(size_t)node[tid] * V + tk], 0) : 0;
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
                  const void* pw, const void* pb, const void* trie,
                  void* labels, void* scores, void* state, int L, int B,
                  int H, int Vp, int V, int T_, int nl, int input_feed,
                  cudaStream_t stream) {
  size_t smem = TailSmem::bytes(H, L, Vp, 2 * DEC_BT);
  cudaError_t e = set_smem((const void*)greedy_loop_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + DEC_BT - 1) / DEC_BT);
  greedy_loop_kernel<T><<<grid, DEC_THREADS, smem, stream>>>(
      (const T*)ctx, (const float*)c0, (const float*)h0, (const T*)eg,
      (const T*)wfh0, (const T*)wx, (const float*)bx, (const T*)wa,
      (const T*)wc, (const T*)pw, (const float*)pb, (const int*)trie,
      (int*)labels, (float*)scores, (float*)state, L, B, H, Vp, V, T_, nl,
      input_feed);
  return (int)cudaGetLastError();
}

}  // namespace aocr

#define AOCR_LOOP_ARGS                                                       \
  const void *ctx, const void *c0, const void *h0, const void *eg,          \
      const void *wfh0, const void *wx, const void *bx, const void *wa,     \
      const void *wc, const void *pw, const void *pb, const void *trie,     \
      void *labels, void *scores, void *state, int L, int B, int H, int Vp,  \
      int V, int T_, int nl, int input_feed, void *stream

extern "C" int aocr_greedy_loop_f32(AOCR_LOOP_ARGS) {
  return aocr::launch<float>(ctx, c0, h0, eg, wfh0, wx, bx, wa, wc, pw, pb,
                             trie, labels, scores, state, L, B, H, Vp, V, T_,
                             nl, input_feed, (cudaStream_t)stream);
}

extern "C" int aocr_greedy_loop_bf16(AOCR_LOOP_ARGS) {
  return aocr::launch<__nv_bfloat16>(ctx, c0, h0, eg, wfh0, wx, bx, wa, wc,
                                     pw, pb, trie, labels, scores, state, L,
                                     B, H, Vp, V, T_, nl, input_feed,
                                     (cudaStream_t)stream);
}
