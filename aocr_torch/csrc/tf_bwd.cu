// The teacher-forced decoder backward recurrence, all T steps in one
// launch.
//
// Replaces aocr/ops/pallas/tf_bwd.py::decoder_bwd_scan (pl.pallas_call at
// tf_bwd.py:276).  Walking t = T-1..0 it carries only the recurrent
// cotangents (dattn, and dc, dh of each layer, float32) and emits the
// per-step cotangent stacks the weight gradients are batched from outside
// (aocr_torch/models/decoder.py): per layer dgates (nl, T, B, 4H), and
// dh~ (pre-tanh), dq, dcvec (T, B, H) in the compute dtype, dscore
// (T, B, L) float32; plus the layer-0 initial-state cotangents dc0, dh0.
//
// Each step follows the TPU kernel (tf_bwd.py:101-169): dh~ = (dattn +
// dy) * (1 - h~^2); dcat = round_cd(dh~) @ W_c^T, split into dcvec and
// dtop; dalpha over the context from the float32 dcvec; the softmax
// backward; dq from the float32 dscore; dtop += round_cd(dq) @ W_a^T; then
// the layers from the top down: the gate backward, and round_cd(dgates)
// @ W^T split into the carries of the layer (and dattn for layer 0) and
// the dh of the layer below.  Every weight is contracted in its stored
// orientation (tf_bwd.py:44-50) by mm_rows: a warp takes NR rows of W and
// splits the contraction axis over its lanes, so loads stay coalesced
// without a transposed copy.  The previous cell state of a step is read
// from the cs stack (c0 rounded to the compute dtype for layer 0 at t=0,
// zero for the other layers).
//
// Bound on the H100: one block's weight stream, as tf_fwd.cu and
// greedy_loop.cu: one block per BT batch rows, the same ~39 MiB (bf16) of
// weights read every step.  The carries live in a global scratch buffer
// that only this block touches.  Needs H % 16 == 0.
#include "decode_tail.cuh"

namespace aocr {

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
tf_bwd_kernel(const T* __restrict__ ctx,      // (L, B, H)
              const T* __restrict__ wfh0,     // (K0, 4H)
              const T* __restrict__ wx,       // (nl-1, 2H, 4H)
              const T* __restrict__ wc,       // (2H, H)
              const T* __restrict__ wa,       // (H, H)
              const float* __restrict__ dys,  // (T, B, H)
              const float* __restrict__ htl,  // (T, B, H)
              const float* __restrict__ alpha,  // (T, B, L)
              const T* __restrict__ ifog,     // (nl, T, B, 4H)
              const T* __restrict__ cs,       // (nl, T, B, H)
              const float* __restrict__ c0,   // (B, H)
              T* __restrict__ dg,             // (nl, T, B, 4H)
              T* __restrict__ dht,            // (T, B, H)
              T* __restrict__ dq,             // (T, B, H)
              T* __restrict__ dcvec,          // (T, B, H)
              float* __restrict__ dscore,     // (T, B, L)
              float* __restrict__ dc0, float* __restrict__ dh0,  // (B, H)
              float* __restrict__ state,      // (B, 2*nl+1, H)
              int L, int B, int H, int T_, int nl, int input_feed) {
  // rows of W per warp pass of mm_rows: one shared-memory read of the
  // operand serves 16 rows in bf16 (an A/B on an H100, PERF.md: 18.3 vs
  // 29.7 ms with 4 rows); float32 keeps 4 (26.3 vs 28.4 ms with 16)
  constexpr int BT = DEC_BT, NR = sizeof(T) == 2 ? 16 : 4;
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H, H2 = 2 * H;
  const int K0 = input_feed ? H2 : H;
  float* XS = smem;           // BT x 4H: the rounded matmul operand
  float* V1 = XS + BT * G;    // BT x H: dcvec (float32)
  float* V2 = V1 + BT * H;    // BT x H: dtop, then the dh of the layer below
  float* A = V2 + BT * H;     // BT x L: dalpha, then dscore
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);
  const int nslot = 2 * nl + 1;
  // slot 0: dattn; 1 + 2l: dc_l; 2 + 2l: dh_l
  auto st = [&](int r, int slot) {
    return state + ((size_t)(b0 + r) * nslot + slot) * H;
  };

  for (int i = tid; i < nrows * H; i += nthr) {
    const int r = i / H, j = i % H;
    for (int s = 0; s < nslot; ++s) st(r, s)[j] = 0.f;
  }
  __syncthreads();

  for (int t = T_ - 1; t >= 0; --t) {
    // ---- dh~ = (dattn + dy) * (1 - h~^2) ----
    for (int i = tid; i < BT * H; i += nthr) {
      const int r = i / H, j = i % H;
      float v = 0.f;
      if (r < nrows) {
        const size_t g = ((size_t)t * B + b0 + r) * H + j;
        const float h = htl[g];
        const T vc = from_f<T>((st(r, 0)[j] + dys[g]) * (1.f - h * h));
        dht[g] = vc;
        v = to_f(vc);
      }
      XS[i] = v;
    }
    __syncthreads();
    // ---- dcat = round_cd(dh~) @ W_c^T: [dcvec | dtop] ----
    for (int n0 = warp * NR; n0 < H2; n0 += nwarps * NR) {
      float acc[NR][BT];
      mm_rows<T, BT, NR>(XS, H, H, wc, H, n0, acc);
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          if (!lane_stores(n, r, BT)) continue;
          const int d = n0 + n;
          if (d < H) {
            V1[r * H + d] = acc[n][r];
            if (r < nrows)
              dcvec[((size_t)t * B + b0 + r) * H + d] = from_f<T>(acc[n][r]);
          } else {
            V2[r * H + d - H] = acc[n][r];
          }
        }
    }
    __syncthreads();
    // ---- dalpha[r][l] = ctx[l, r, :] . dcvec[r]: a warp per (r, l) ----
    for (int p = warp; p < nrows * L; p += nwarps) {
      const int r = p / L, l = p % L;
      const T* cr = ctx + ((size_t)l * B + b0 + r) * H;
      float s = 0.f;
      for (int h = lane; h < H; h += 32) s = fmaf(to_f(cr[h]), V1[r * H + h], s);
      s = warp_sum(s);
      if (lane == 0) A[r * L + l] = s;
    }
    __syncthreads();
    // ---- softmax backward: dscore = a*da - a * sum(a*da): a warp a row ----
    for (int r = warp; r < nrows; r += nwarps) {
      const float* ar = alpha + ((size_t)t * B + b0 + r) * L;
      float sum = 0.f;
      for (int l = lane; l < L; l += 32) sum += ar[l] * A[r * L + l];
      sum = warp_sum(sum);
      for (int l = lane; l < L; l += 32) {
        const float a = ar[l];
        const float d = a * A[r * L + l] - a * sum;
        A[r * L + l] = d;
        dscore[((size_t)t * B + b0 + r) * L + l] = d;
      }
    }
    __syncthreads();
    // ---- dq[r][h] = sum_l dscore[r][l] * ctx[l, r, h] ----
    for (int i = tid; i < BT * H; i += nthr) {
      const int r = i / H, h = i % H;
      float v = 0.f;
      if (r < nrows) {
        const T* cp = ctx + (size_t)(b0 + r) * H + h;
        for (int l = 0; l < L; ++l)
          v = fmaf(A[r * L + l], to_f(cp[(size_t)l * B * H]), v);
        const T vc = from_f<T>(v);
        dq[((size_t)t * B + b0 + r) * H + h] = vc;
        v = to_f(vc);
      }
      XS[i] = v;
    }
    __syncthreads();
    // ---- dtop += round_cd(dq) @ W_a^T ----
    for (int n0 = warp * NR; n0 < H; n0 += nwarps * NR) {
      float acc[NR][BT];
      mm_rows<T, BT, NR>(XS, H, H, wa, H, n0, acc);
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int r = 0; r < BT; ++r)
          if (lane_stores(n, r, BT)) V2[r * H + n0 + n] += acc[n][r];
    }
    __syncthreads();

    // ---- the layers, top down ----
    for (int l = nl - 1; l >= 0; --l) {
      for (int i = tid; i < BT * H; i += nthr) {
        const int r = i / H, j = i % H;
        if (r >= nrows) {
#pragma unroll
          for (int q = 0; q < 4; ++q) XS[r * G + q * H + j] = 0.f;
          continue;
        }
        const size_t row = ((size_t)l * T_ + t) * B + b0 + r;
        const T* a = ifog + row * G;
        float cp = 0.f;
        if (t > 0)
          cp = to_f(cs[(row - B) * H + j]);
        else if (l == 0)
          cp = round_cd<T>(c0[(size_t)(b0 + r) * H + j]);
        float d[4], dcp;
        float* dcl = st(r, 1 + 2 * l);
        gate_math_bwd(st(r, 2 + 2 * l)[j] + V2[r * H + j], dcl[j],
                      to_f(a[j]), to_f(a[H + j]), to_f(a[2 * H + j]),
                      to_f(a[3 * H + j]), to_f(cs[row * H + j]), cp, d, &dcp);
        dcl[j] = dcp;
        T* o = dg + row * G;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const T v = from_f<T>(d[q]);
          o[q * H + j] = v;
          XS[r * G + q * H + j] = to_f(v);
        }
      }
      __syncthreads();
      // round_cd(dgates) @ W^T: layer l >= 1 -> [dh of layer l-1 | dh_l];
      // layer 0 -> [dattn | dh_0] (dh_0 alone without input feed)
      const T* w = l > 0 ? wx + (size_t)(l - 1) * H2 * G : wfh0;
      const int N = l > 0 ? H2 : K0;
      for (int n0 = warp * NR; n0 < N; n0 += nwarps * NR) {
        float acc[NR][BT];
        mm_rows<T, BT, NR>(XS, G, G, w, G, n0, acc);
#pragma unroll
        for (int n = 0; n < NR; ++n)
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            if (!lane_stores(n, r, BT)) continue;
            const int d = n0 + n;
            const float v = acc[n][r];
            if (l > 0) {
              if (d < H)
                V2[r * H + d] = v;
              else if (r < nrows)
                st(r, 2 + 2 * l)[d - H] = v;
            } else if (r < nrows) {
              if (!input_feed)
                st(r, 2)[d] = v;
              else if (d < H)
                st(r, 0)[d] = v;
              else
                st(r, 2)[d - H] = v;
            }
          }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < nrows * H; i += nthr) {
    const int r = i / H, j = i % H;
    dc0[(size_t)(b0 + r) * H + j] = st(r, 1)[j];
    dh0[(size_t)(b0 + r) * H + j] = st(r, 2)[j];
  }
}

template <typename T>
static int launch(const void* ctx, const void* wfh0, const void* wx,
                  const void* wc, const void* wa, const void* dys,
                  const void* htl, const void* alpha, const void* ifog,
                  const void* cs, const void* c0, void* dg, void* dht,
                  void* dq, void* dcvec, void* dscore, void* dc0, void* dh0,
                  void* state, int L, int B, int H, int T_, int nl,
                  int input_feed, cudaStream_t stream) {
  size_t smem = sizeof(float) * DEC_BT * (6 * H + L);
  cudaError_t e = set_smem((const void*)tf_bwd_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + DEC_BT - 1) / DEC_BT);
  tf_bwd_kernel<T><<<grid, DEC_THREADS, smem, stream>>>(
      (const T*)ctx, (const T*)wfh0, (const T*)wx, (const T*)wc,
      (const T*)wa, (const float*)dys, (const float*)htl,
      (const float*)alpha, (const T*)ifog, (const T*)cs, (const float*)c0,
      (T*)dg, (T*)dht, (T*)dq, (T*)dcvec, (float*)dscore, (float*)dc0,
      (float*)dh0, (float*)state, L, B, H, T_, nl, input_feed);
  return (int)cudaGetLastError();
}

}  // namespace aocr

#define AOCR_TF_BWD_ARGS                                                     \
  const void *ctx, const void *wfh0, const void *wx, const void *wc,        \
      const void *wa, const void *dys, const void *htl, const void *alpha,  \
      const void *ifog, const void *cs, const void *c0, void *dg, void *dht, \
      void *dq, void *dcvec, void *dscore, void *dc0, void *dh0,            \
      void *state, int L, int B, int H, int T_, int nl, int input_feed,     \
      void *stream

extern "C" int aocr_tf_bwd_f32(AOCR_TF_BWD_ARGS) {
  return aocr::launch<float>(ctx, wfh0, wx, wc, wa, dys, htl, alpha, ifog,
                             cs, c0, dg, dht, dq, dcvec, dscore, dc0, dh0,
                             state, L, B, H, T_, nl, input_feed,
                             (cudaStream_t)stream);
}

extern "C" int aocr_tf_bwd_bf16(AOCR_TF_BWD_ARGS) {
  return aocr::launch<__nv_bfloat16>(ctx, wfh0, wx, wc, wa, dys, htl, alpha,
                                     ifog, cs, c0, dg, dht, dq, dcvec,
                                     dscore, dc0, dh0, state, L, B, H, T_,
                                     nl, input_feed, (cudaStream_t)stream);
}
