// The whole K-beam search after the t=1 GO step in one launch.
//
// Replaces aocr/ops/pallas/beam_loop.py::fused_beam_loop (pl.pallas_call at
// beam_loop.py:514).  Each step t = 1 .. T-1 of each batch row: the LSTM
// stack of each of its K beams (decoder_stack_step, the emb_gates row of
// the beam's previous token), the attention tail over the row's one
// context row, the projector and log-softmax with the PAD/EOS freeze, the
// beam's score added, the trie's validity (PAD always valid), the top-K
// over the K x V candidates with refill (beam_tail.cuh); then row
// finality, the parent reorder of every layer's c and h and the attention
// vector, the trie node step (PAD keeps the parent's node), the lengths
// (a PAD counts only when its parent was live), the per-row refill
// counts, and the token and parent histories.  A block stops once all its
// beams are frozen.
//
// Layout: a block owns NB = BT / K whole batch rows with all their K beams
// (the top-K and the reorder span a batch row), BT = 4, 5 or 8 rows
// (beam_loop_rows); a ragged last block's rows past the batch start
// frozen, so they never keep it alive.  The per-beam decoder state
// (attn, then c and h of each layer, float32) lives in a global scratch
// (2, B*K, 2*nl+1, H) that only the block touches, double-buffered: the
// reorder reads the parents' state from one buffer and writes the
// children's into the other, never in place.  The trie is the (N, V)
// int32 table in device memory, unpadded, read by node id (the TPU's
// one-hot f32 lookup was a Mosaic workaround).
//
// Row finality (beam_loop.py:227-241): a batch row whose K beams are all
// frozen at a step's start is final: it keeps its scores, writes identity
// parents and PAD, and no longer counts refills, so its transcript never
// depends on its batchmates or on block boundaries.
//
// Bound on the H100: as greedy_loop.cu, one block's stream of the ~39 MiB
// (bf16) of decoder weights a step against BT multiply-adds per weight
// element, now for K rows per batch row: the CUDA-core FMA loop of the
// block bounds it.  Tensor cores are later work.
#include "beam_tail.cuh"

namespace aocr {

// rows of a block for beam width K <= 8: the fewest of 4, 5, 8 that hold
// whole batch rows
inline int beam_loop_rows(int K) { return K <= 4 ? 4 : (K == 5 ? 5 : 8); }

template <typename T, int BT>
__global__ void __launch_bounds__(DEC_THREADS)
beam_loop_kernel(const T* __restrict__ ctx,       // (L, B, H)
                 const float* __restrict__ init,  // (B, 2*nl+1, H)
                 const int* __restrict__ tok0,    // (B, K)
                 const float* __restrict__ sc0,   // (B, K)
                 const int* __restrict__ node0,   // (B, K) or null
                 const T* __restrict__ eg,        // (V, 4H)
                 const T* __restrict__ wfh0,      // (K0, 4H)
                 const T* __restrict__ wx,        // (nl-1, 2H, 4H)
                 const float* __restrict__ bx,    // (nl-1, 4H)
                 const T* __restrict__ wa, const T* __restrict__ wc,
                 const T* __restrict__ pw, const float* __restrict__ pb,
                 const int* __restrict__ trie,    // (N, V) or null
                 int* __restrict__ tok_hist,      // (T, B, K)
                 int* __restrict__ par_hist,      // (T, B, K)
                 float* __restrict__ fsc,         // (B, K)
                 int* __restrict__ flen,          // (B, K)
                 int* __restrict__ refills,       // (B,) or null
                 int* __restrict__ minv,          // (B,) or null
                 float* __restrict__ state,       // (2, B*K, 2*nl+1, H)
                 int L, int B, int H, int Vp, int V, int T_, int nl,
                 int input_feed, int K, int count_lengths) {
  extern __shared__ float smem[];
  TailSmemT<BT> sm(smem, H, L, Vp);
  float* score = sm.delta + BT;  // BT: each beam's running score
  float* osc = score + BT;       // BT: slot j's new score
  int* opar = reinterpret_cast<int*>(osc + BT);  // slot j's parent beam
  int* otok = opar + BT;         // slot j's token
  int* node = otok + BT;         // BT: each beam's trie node
  int* len = node + BT;          // BT: each beam's emitted tokens
  int* live = len + BT;          // per batch row: a beam still live
  int* nval = live + BT;         // per batch row: valid picks
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int nb = BT / K;                    // batch rows of the block
  const int b0 = blockIdx.x * nb;
  const int nbr = min(nb, B - b0);          // real batch rows
  const int nrows = nbr * K;                // real beam rows
  const size_t r0 = (size_t)b0 * K;         // the block's first beam row
  const size_t BK = (size_t)B * K;
  const int G = 4 * H, nslot = 2 * nl + 1;
  const bool use_trie = trie != nullptr;
  int cur = 0;
  auto buf = [&](int which, int r, int slot) {
    return state + (((size_t)which * BK + r0 + r) * nslot + slot) * H;
  };
  auto st = [&](int r, int slot) { return buf(cur, r, slot); };
  auto frozen = [&](int r) {
    return sm.prev[r] == PAD || sm.prev[r] == EOS;
  };
  auto pre = [&](int l, int r, int q, int j, float acc) {
    return l == 0 ? to_f(eg[(size_t)sm.prev[r] * G + q * H + j]) + acc
                  : acc + bx[(size_t)(l - 1) * G + q * H + j];
  };
  auto seen = [](int, int, int, float, float, const float(&)[4]) {};

  // every beam of a batch row starts from the row's t=1 state
  for (size_t i = tid; i < (size_t)nrows * nslot * H; i += nthr) {
    const int r = i / ((size_t)nslot * H);
    const int rest = i % ((size_t)nslot * H);
    st(r, 0)[rest] = init[(size_t)(b0 + r / K) * nslot * H + rest];
  }
  // histories: t = 0 holds the t=1 picks; later steps PAD and identity
  // parents, what a final row would write
  for (size_t i = tid; i < (size_t)T_ * nrows; i += nthr) {
    const int t = i / nrows, r = i % nrows;
    const size_t g = (size_t)t * BK + r0 + r;
    tok_hist[g] = t == 0 ? tok0[r0 + r] : PAD;
    par_hist[g] = r % K;
  }
  if (tid < BT) {
    const bool real = tid < nrows;
    sm.prev[tid] = real ? tok0[r0 + tid] : PAD;  // rows past B start frozen
    score[tid] = real ? sc0[r0 + tid] : 0.f;
    node[tid] = real && use_trie ? node0[r0 + tid] : 0;
    len[tid] = real ? 1 : 0;
  }
  int my_refills = 0, my_minv = K;  // thread tid < nbr: batch row tid
  __syncthreads();

  for (int t = 1; t < T_; ++t) {
    bool any = false;
#pragma unroll
    for (int r = 0; r < BT; ++r)
      any |= !(sm.prev[r] == PAD || sm.prev[r] == EOS);
    if (!any) break;  // uniform: every thread read the same shared words
    if (tid < nbr) {
      bool l = false;
      for (int k = 0; k < K; ++k) l |= !frozen(tid * K + k);
      live[tid] = l;
    }

    decoder_stack_step<T, BT>(st, sm.X, wfh0, wx, H, nl, nrows, input_feed,
                              pre, seen);
    attention_htilde<false>(
        ctx, L, B, H, b0, nrows, wa, wc, sm,
        [&](int r, int j, float v) { st(r, 0)[j] = v; }, K);
    projector_logp<T>(H, nrows, pw, pb, Vp, sm);

    // scored candidates in place of the log-probs, then the top-K: a warp
    // a batch row
    for (int bi = warp; bi < nbr; bi += nwarps) {
      for (int i = lane; i < K * V; i += 32) {
        const int r = bi * K + i / V, v = i % V;
        const bool ok = !use_trie || v == PAD ||
                        trie[(size_t)node[r] * V + v] >= 0;
        float* p = sm.P + r * Vp + v;
        *p = ok ? score[r] + *p : NEG_BIG;
      }
      __syncwarp();
      const int nv = beam_topk_warp(sm.P + bi * K * Vp, Vp, K, V, use_trie,
                                    osc + bi * K, opar + bi * K,
                                    otok + bi * K);
      if (lane == 0) nval[bi] = nv;
    }
    __syncthreads();

    // row finality, then each new beam's node and length from its parent
    int new_node = 0, new_len = 0;
    float new_score = 0.f;
    if (tid < nrows) {
      const int bi = tid / K, j = tid % K;
      if (!live[bi]) {
        opar[tid] = j;
        otok[tid] = PAD;
        osc[tid] = score[tid];
      }
      const int p = bi * K + opar[tid], tk = otok[tid];
      new_score = osc[tid];
      new_node = !use_trie ? 0
                 : tk == PAD ? node[p]
                 : max(trie[(size_t)node[p] * V + tk], 0);
      new_len = count_lengths ? len[p] + ((tk != PAD) || !frozen(p))
                              : len[tid];
      const size_t g = (size_t)t * BK + r0 + tid;
      tok_hist[g] = tk;
      par_hist[g] = opar[tid];
    }
    if (use_trie && tid < nbr) {
      if (live[tid] && nval[tid] < K) ++my_refills;
      my_minv = min(my_minv, live[tid] ? nval[tid] : K);
    }
    __syncthreads();
    if (tid < nrows) {
      score[tid] = new_score;
      node[tid] = new_node;
      len[tid] = new_len;
      sm.prev[tid] = otok[tid];
    }
    // the reorder: child beam r takes its parent's attn, c and h
    const int nxt = 1 - cur;
    for (size_t i = tid; i < (size_t)nrows * nslot * H; i += nthr) {
      const int r = i / ((size_t)nslot * H);
      const int rest = i % ((size_t)nslot * H);
      const int p = (r / K) * K + opar[r];
      buf(nxt, r, 0)[rest] = buf(cur, p, 0)[rest];
    }
    cur = nxt;
    __syncthreads();
  }

  if (tid < nrows) {
    fsc[r0 + tid] = score[tid];
    flen[r0 + tid] = len[tid];
  }
  if (use_trie && tid < nbr) {
    refills[b0 + tid] = my_refills;
    minv[b0 + tid] = my_minv;
  }
}

template <typename T, int BT>
static int launch_rows(const void* ctx, const void* init, const void* tok0,
                       const void* sc0, const void* node0, const void* eg,
                       const void* wfh0, const void* wx, const void* bx,
                       const void* wa, const void* wc, const void* pw,
                       const void* pb, const void* trie, void* tok_hist,
                       void* par_hist, void* fsc, void* flen, void* refills,
                       void* minv, void* state, int L, int B, int H, int Vp,
                       int V, int T_, int nl, int input_feed, int K,
                       int count_lengths, cudaStream_t stream) {
  size_t smem = TailSmemT<BT>::bytes(H, L, Vp, 8 * BT);
  cudaError_t e = set_smem((const void*)beam_loop_kernel<T, BT>, smem);
  if (e != cudaSuccess) return (int)e;
  const int nb = BT / K;
  dim3 grid((B + nb - 1) / nb);
  beam_loop_kernel<T, BT><<<grid, DEC_THREADS, smem, stream>>>(
      (const T*)ctx, (const float*)init, (const int*)tok0,
      (const float*)sc0, (const int*)node0, (const T*)eg, (const T*)wfh0,
      (const T*)wx, (const float*)bx, (const T*)wa, (const T*)wc,
      (const T*)pw, (const float*)pb, (const int*)trie, (int*)tok_hist,
      (int*)par_hist, (float*)fsc, (int*)flen, (int*)refills, (int*)minv,
      (float*)state, L, B, H, Vp, V, T_, nl, input_feed, K, count_lengths);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* ctx, const void* init, const void* tok0,
                  const void* sc0, const void* node0, const void* eg,
                  const void* wfh0, const void* wx, const void* bx,
                  const void* wa, const void* wc, const void* pw,
                  const void* pb, const void* trie, void* tok_hist,
                  void* par_hist, void* fsc, void* flen, void* refills,
                  void* minv, void* state, int L, int B, int H, int Vp, int V,
                  int T_, int nl, int input_feed, int K, int count_lengths,
                  cudaStream_t stream) {
  if (K < 1 || K > 8) return (int)cudaErrorInvalidValue;
#define AOCR_BEAM_LOOP_LAUNCH(BT)                                            \
  launch_rows<T, BT>(ctx, init, tok0, sc0, node0, eg, wfh0, wx, bx, wa, wc, \
                     pw, pb, trie, tok_hist, par_hist, fsc, flen, refills,  \
                     minv, state, L, B, H, Vp, V, T_, nl, input_feed, K,    \
                     count_lengths, stream)
  switch (beam_loop_rows(K)) {
    case 4: return AOCR_BEAM_LOOP_LAUNCH(4);
    case 5: return AOCR_BEAM_LOOP_LAUNCH(5);
    default: return AOCR_BEAM_LOOP_LAUNCH(8);
  }
#undef AOCR_BEAM_LOOP_LAUNCH
}

}  // namespace aocr

#define AOCR_BEAM_LOOP_ARGS                                                  \
  const void *ctx, const void *init, const void *tok0, const void *sc0,     \
      const void *node0, const void *eg, const void *wfh0, const void *wx,  \
      const void *bx, const void *wa, const void *wc, const void *pw,       \
      const void *pb, const void *trie, void *tok_hist, void *par_hist,     \
      void *fsc, void *flen, void *refills, void *minv, void *state, int L, \
      int B, int H, int Vp, int V, int T_, int nl, int input_feed, int K,   \
      int count_lengths, void *stream

extern "C" int aocr_beam_loop_f32(AOCR_BEAM_LOOP_ARGS) {
  return aocr::launch<float>(ctx, init, tok0, sc0, node0, eg, wfh0, wx, bx,
                             wa, wc, pw, pb, trie, tok_hist, par_hist, fsc,
                             flen, refills, minv, state, L, B, H, Vp, V, T_,
                             nl, input_feed, K, count_lengths,
                             (cudaStream_t)stream);
}

extern "C" int aocr_beam_loop_bf16(AOCR_BEAM_LOOP_ARGS) {
  return aocr::launch<__nv_bfloat16>(
      ctx, init, tok0, sc0, node0, eg, wfh0, wx, bx, wa, wc, pw, pb, trie,
      tok_hist, par_hist, fsc, flen, refills, minv, state, L, B, H, Vp, V, T_,
      nl, input_feed, K, count_lengths, (cudaStream_t)stream);
}
