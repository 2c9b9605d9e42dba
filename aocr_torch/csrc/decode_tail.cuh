// The per-step decoder tail of the one-block decode kernels (the rows
// routes of decode_step.cu and beam_step.cu), for one block of BT rows:
// Luong attention and h~ = tanh(W_c [ctx; h]) (attention_htilde), then
// the projector and float32 log-softmax with the PAD/EOS freeze
// (projector_logp) and the argmax (projector_pick) or the beams' top-K
// (beam_tail.cuh).  Their cluster routes (step_cluster.cuh), greedy_loop.cu,
// beam_loop.cu and the teacher-forced tf_fwd.cu and tf_bwd.cu run the step
// on clusters (decoder_cluster.cuh), with projector_pick's argmax as
// dc_pick_row.
// Counterpart of aocr/ops/pallas/decode_step.py::attention_logp_tail plus
// the freeze/argmax of its _kernel_body, which all the TPU decode kernels
// share.
//
// BT, the rows of a block, is a template parameter: DEC_BT (4 batch rows)
// for the greedy rows route; beam_step's gives a block whole batch rows
// with all their K beams (beam_tail.cuh).
#pragma once

#include "common.cuh"

namespace aocr {

constexpr int DEC_BT = 4;       // batch rows per block (decode_step rows)
constexpr int DEC_THREADS = 256;

// consecutive columns per thread in the matmuls: 4, or 2 above 5 rows
// (the accumulators are U * BT registers a column group)
template <int BT>
struct DecU {
  static constexpr int value = BT > 5 ? 2 : 4;
};

// Shared-memory views of one block (float unless noted).
template <int BT = DEC_BT>
struct TailSmemT {
  float* X;      // BT x 2H: [round_cd(ctx) ; round_cd(h_top)]
  float* S;      // BT x H: q, then round_cd(h~)
  float* A;      // BT x L: scores, then alpha
  float* P;      // BT x Vp: logits, then log-probs
  int* prev;     // BT: previous token (PAD for rows past the batch)
  int* tok;      // BT: picked token
  float* delta;  // BT: picked log-prob after the freeze

  __device__ TailSmemT(float* base, int H, int L, int Vp) {
    X = base;
    S = X + BT * 2 * H;
    A = S + BT * H;
    P = A + BT * L;
    prev = reinterpret_cast<int*>(P + BT * Vp);
    tok = prev + BT;
    delta = reinterpret_cast<float*>(tok + BT);
  }
  // bytes of the views, then extra_floats more (from delta + BT on)
  static size_t bytes(int H, int L, int Vp, int extra_floats) {
    return sizeof(float) *
           ((size_t)BT * (3 * H + L + Vp) + 3 * BT + extra_floats);
  }
};
using TailSmem = TailSmemT<DEC_BT>;

// Luong attention and h~ for BT rows: q = round_cd(h_top) @ W_a, scores
// over the context, alpha = softmax, the context vector, then
// h~ = tanh(W_c [ctx; h_top]), q and alpha in float32 (the teacher-forced
// forward's rounding is decoder_cluster.cuh's dc_attend_rows<T, true>).
// On entry X[r][H + j] holds round_cd(h_top) (0 for r >= nrows), after a
// __syncthreads.  hout(r, j, h~) receives the float32 h~ of each real row.
// On exit, after a __syncthreads, A holds alpha (float32), X[r][0:H]
// round_cd of the context vector, and S round_cd(h~).
//
// ctx (L, B, H) compute dtype, scan-major; wa (H, H), wc (2H, H) compute
// dtype.  Row r attends over context row b0 + r / kg: kg = K groups the K
// beams of a batch row on their one context row (the reference's
// beam_replicate without the copy), kg = 1 is one row each.
template <int BT = DEC_BT, typename T, typename HOut>
__device__ void attention_htilde(const T* __restrict__ ctx, int L, int B,
                                 int H, int b0, int nrows,
                                 const T* __restrict__ wa,
                                 const T* __restrict__ wc, TailSmemT<BT> sm,
                                 HOut hout, int kg = 1) {
  constexpr int U = DecU<BT>::value;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int H2 = 2 * H;

  // q = round_cd(h) @ W_a, float32
  for (int ch = tid; ch * U < H; ch += nthr) {
    float acc[1][U][BT];
    zero(acc);
    mm_cols<T, BT, 1, U>(sm.X + H, H2, H, wa, H, 0, ch * U, acc);
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int u = 0; u < U; ++u)
        sm.S[r * H + ch * U + u] = acc[0][u][r];
  }
  __syncthreads();

  // scores[r][l] = sum_h ctx[l, r, h] * q[r, h]: one warp per (r, l)
  for (int p = warp; p < nrows * L; p += nwarps) {
    const int r = p / L, l = p % L;
    const T* cr = ctx + ((size_t)l * B + b0 + r / kg) * H;
    float s = 0.f;
    for (int h = lane; h < H; h += 32) s = fmaf(to_f(cr[h]), sm.S[r * H + h], s);
    s = warp_sum(s);
    if (lane == 0) sm.A[r * L + l] = s;
  }
  __syncthreads();

  // alpha = softmax over L, float32: one warp per row
  for (int r = warp; r < nrows; r += nwarps) {
    float* a = sm.A + r * L;
    float m = -INFINITY;
    for (int l = lane; l < L; l += 32) m = fmaxf(m, a[l]);
    m = warp_max(m);
    float sum = 0.f;
    for (int l = lane; l < L; l += 32) {
      float e = expf(a[l] - m);
      a[l] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int l = lane; l < L; l += 32) a[l] = a[l] / sum;
  }
  __syncthreads();

  // ctx vector = sum_l alpha * ctx, float32, rounded into X[r][0:H]
  for (int i = tid; i < BT * H; i += nthr) {
    const int r = i / H, h = i % H;
    float v = 0.f;
    if (r < nrows) {
      const T* cp = ctx + (size_t)(b0 + r / kg) * H + h;
      for (int l = 0; l < L; ++l) {
        v = fmaf(sm.A[r * L + l], to_f(cp[(size_t)l * B * H]), v);
      }
    }
    sm.X[r * H2 + h] = round_cd<T>(v);
  }
  __syncthreads();

  // h~ = tanh(ctx @ W_c[:H] + h @ W_c[H:]) (two float32 sums, as the
  // reference's two dots)
  for (int ch = tid; ch * U < H; ch += nthr) {
    float a1[1][U][BT], a2[1][U][BT];
    zero(a1);
    zero(a2);
    mm_cols<T, BT, 1, U>(sm.X, H2, H, wc, H, 0, ch * U, a1);
    mm_cols<T, BT, 1, U>(sm.X + H, H2, H, wc + (size_t)H * H, H, 0, ch * U,
                         a2);
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = ch * U + u;
        const float ht = tanhf(a1[0][u][r] + a2[0][u][r]);
        if (r < nrows) hout(r, j, ht);
        sm.S[r * H + j] = round_cd<T>(ht);
      }
  }
  __syncthreads();
}

// The projector, float32 log-softmax and PAD/EOS freeze on round_cd(h~)
// in S (attention_htilde's exit state) and prev[].  On exit, after a
// __syncthreads, P[r][v] holds the log-prob of token v for each real row,
// with P[r][PAD] = 0 where prev[r] is PAD or EOS.  pw (H, Vp) compute
// dtype; pb (Vp,) float32 with -1e30 on the padding.
template <typename T, int BT>
__device__ void projector_logp(int H, int nrows, const T* __restrict__ pw,
                               const float* __restrict__ pb, int Vp,
                               TailSmemT<BT> sm) {
  constexpr int U = DecU<BT>::value;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;

  // logits = round_cd(h~) @ W_p + b_p
  for (int ch = tid; ch * U < Vp; ch += nthr) {
    float acc[1][U][BT];
    zero(acc);
    mm_cols<T, BT, 1, U>(sm.S, H, H, pw, Vp, 0, ch * U, acc);
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = ch * U + u;
        sm.P[r * Vp + v] = acc[0][u][r] + pb[v];
      }
  }
  __syncthreads();

  // log-softmax and freeze: a warp a row
  for (int r = warp; r < nrows; r += nwarps) {
    float* lg = sm.P + r * Vp;
    float m = -INFINITY;
    for (int v = lane; v < Vp; v += 32) m = fmaxf(m, lg[v]);
    m = warp_max(m);
    float s = 0.f;
    for (int v = lane; v < Vp; v += 32) s += expf(lg[v] - m);
    s = warp_sum(s);
    const float lse = m + logf(s);
    const bool frozen = sm.prev[r] == PAD || sm.prev[r] == EOS;
    for (int v = lane; v < Vp; v += 32)
      lg[v] = (frozen && v == PAD) ? 0.f : lg[v] - lse;
  }
  __syncthreads();
}

// The argmax of each real row's log-probs in P (projector_logp's exit
// state), ties to the lowest index.  valid(r, v) says whether token v may
// follow: an invalid one counts as -1e30, except PAD of a frozen row
// (the reference masks, then freezes).  On exit, after a __syncthreads,
// tok[]/delta[] hold the picks.
template <int BT, typename Valid>
__device__ void projector_pick(int nrows, int Vp, TailSmemT<BT> sm,
                               Valid valid) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  for (int r = warp; r < nrows; r += nwarps) {
    const float* lp = sm.P + r * Vp;
    const bool frozen = sm.prev[r] == PAD || sm.prev[r] == EOS;
    // bi starts at PAD, so a row whose log-probs are all NaN picks PAD and
    // greedy_loop's emb_gates gather stays inside the table
    float best = -INFINITY;
    int bi = PAD;
    for (int v = lane; v < Vp; v += 32) {
      const float x =
          (valid(r, v) || (frozen && v == PAD)) ? lp[v] : -1e30f;
      if (x > best) {
        best = x;
        bi = v;
      }
    }
    warp_argmax(&best, &bi);
    if (lane == 0) {
      sm.tok[r] = bi;
      sm.delta[r] = best;
    }
  }
  __syncthreads();
}

// The whole greedy tail: attention_htilde (q and alpha in float32), then
// projector_logp and projector_pick.  On entry X[r][H + j] holds
// round_cd(h_top) (0 for r >= nrows) and prev[] is set, after a
// __syncthreads.  On exit tok[]/delta[] hold the picks of the real rows.
template <typename T, typename HOut, typename Valid>
__device__ void attention_tail(const T* __restrict__ ctx, int L, int B, int H,
                               int b0, int nrows, const T* __restrict__ wa,
                               const T* __restrict__ wc,
                               const T* __restrict__ pw,
                               const float* __restrict__ pb, int Vp,
                               TailSmem sm, HOut hout, Valid valid) {
  attention_htilde(ctx, L, B, H, b0, nrows, wa, wc, sm, hout);
  projector_logp<T>(H, nrows, pw, pb, Vp, sm);
  projector_pick(nrows, Vp, sm, valid);
}

}  // namespace aocr
