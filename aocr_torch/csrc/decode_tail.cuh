// The greedy decode tail shared by decode_step.cu and greedy_loop.cu:
// Luong attention, h~ = tanh(W_c [ctx; h]), projector, float32
// log-softmax, the PAD/EOS freeze and the argmax, for one block of BT
// batch rows.  Counterpart of aocr/ops/pallas/decode_step.py::
// attention_logp_tail plus the freeze/argmax of its _kernel_body, which
// all the TPU decode kernels share.
#pragma once

#include "common.cuh"

namespace aocr {

constexpr int DEC_BT = 4;       // batch rows per block
constexpr int DEC_U = 4;        // consecutive columns per thread
constexpr int DEC_THREADS = 256;

// Shared-memory views of one block (float unless noted).
struct TailSmem {
  float* X;      // BT x 2H: [round_cd(ctx) ; round_cd(h_top)]
  float* S;      // BT x H: q, then round_cd(h~)
  float* A;      // BT x L: scores, then alpha
  float* P;      // BT x Vp: logits
  int* prev;     // BT: previous token (PAD for rows past the batch)
  int* tok;      // BT: picked token
  float* delta;  // BT: picked log-prob after the freeze

  __device__ TailSmem(float* base, int H, int L, int Vp) {
    X = base;
    S = X + DEC_BT * 2 * H;
    A = S + DEC_BT * H;
    P = A + DEC_BT * L;
    prev = reinterpret_cast<int*>(P + DEC_BT * Vp);
    tok = prev + DEC_BT;
    delta = reinterpret_cast<float*>(tok + DEC_BT);
  }
  static size_t bytes(int H, int L, int Vp, int extra_floats) {
    return sizeof(float) *
           ((size_t)DEC_BT * (3 * H + L + Vp) + 3 * DEC_BT + extra_floats);
  }
};

// On entry X[r][H + j] holds round_cd(h_top) (0 for r >= nrows) and
// prev[] is set, after a __syncthreads.  hout(r, j, h~) receives the
// float32 h~ of each real row.  On exit tok[]/delta[] hold the picks of
// the real rows, after a __syncthreads.
//
// ctx (L, B, H) compute dtype, scan-major; wa (H, H), wc (2H, H),
// pw (H, Vp) compute dtype; pb (Vp,) float32 with -1e30 on the padding.
template <typename T, typename HOut>
__device__ void attention_tail(const T* __restrict__ ctx, int L, int B, int H,
                               int b0, int nrows, const T* __restrict__ wa,
                               const T* __restrict__ wc,
                               const T* __restrict__ pw,
                               const float* __restrict__ pb, int Vp,
                               TailSmem sm, HOut hout) {
  constexpr int BT = DEC_BT, U = DEC_U;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int H2 = 2 * H;

  // q = round_cd(h) @ W_a, float32, not rounded
  for (int ch = tid; ch * U < H; ch += nthr) {
    float acc[1][U][BT];
    zero(acc);
    mm_cols<T, BT, 1, U>(sm.X + H, H2, H, wa, H, 0, ch * U, acc);
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int u = 0; u < U; ++u) sm.S[r * H + ch * U + u] = acc[0][u][r];
  }
  __syncthreads();

  // scores[r][l] = sum_h ctx[l, r, h] * q[r, h]: one warp per (r, l)
  for (int p = warp; p < nrows * L; p += nwarps) {
    const int r = p / L, l = p % L;
    const T* cr = ctx + ((size_t)l * B + b0 + r) * H;
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
      const T* cp = ctx + (size_t)(b0 + r) * H + h;
      for (int l = 0; l < L; ++l)
        v = fmaf(sm.A[r * L + l], to_f(cp[(size_t)l * B * H]), v);
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

  // log-softmax, freeze (logp[PAD] = 0 after PAD/EOS), argmax: a warp a row
  for (int r = warp; r < nrows; r += nwarps) {
    const float* lg = sm.P + r * Vp;
    float m = -INFINITY;
    for (int v = lane; v < Vp; v += 32) m = fmaxf(m, lg[v]);
    m = warp_max(m);
    float s = 0.f;
    for (int v = lane; v < Vp; v += 32) s += expf(lg[v] - m);
    s = warp_sum(s);
    const float lse = m + logf(s);
    const bool frozen = sm.prev[r] == PAD || sm.prev[r] == EOS;
    // bi starts at PAD, so a row whose logits are all NaN picks PAD and
    // greedy_loop's emb_gates gather stays inside the table
    float best = -INFINITY;
    int bi = PAD;
    for (int v = lane; v < Vp; v += 32) {
      float lp = lg[v] - lse;
      if (frozen && v == PAD) lp = 0.f;
      if (lp > best) {
        best = lp;
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

}  // namespace aocr
