// The teacher-forced decoder forward, all T steps in one launch, on
// thread-block clusters.
//
// Replaces aocr/ops/pallas/tf_fwd.py::decoder_fwd_scan (pl.pallas_call at
// tf_fwd.py:252), the training mirror of the greedy loop: the hoisted
// input projection xp[t] (emb @ Wi[:E] + bi + bh, computed batched
// outside) is added instead of an embedding gather, there is no projector
// or argmax, every row runs all T steps, and with collect the residual
// stacks the backward (tf_bwd.cu) reads are written every step.
//
// Each step of each row: layer 0 on [attn; h0] @ wfh0 + xp[t], layers
// l >= 1 on [h_{l-1}; h_l] @ W_l + bi_l + bh_l (the two biases added
// separately, as the reference's scan body), Luong attention with q and
// alpha rounded to the compute dtype before their contractions
// (tf_fwd.py:125-132), and h~ = tanh(W_c [ctx; h_top]).  The input-feed
// carry h~ stays float32 and is rounded at the product.
//
// Design: greedy_loop.cu's (decoder_cluster.cuh).  A cluster of cs blocks
// (16 at H=1024) owns a tile of bt batch rows for all T steps; block s
// owns U = H/cs hidden units of every layer with their four gate columns
// and the same columns of W_a and W_c, and streams its slices of the
// weights (packed by block by the wrapper, greedy_loop.py::pack_weights;
// ~2.5 MB a step in bf16 at H=1024, 2 layers, input feed) from L2
// through the ring of bulk (TMA) copies, multiplying bf16 on the tensor
// cores (mma.sync) and float32 on the CUDA cores.  Each weight element
// read serves bt rows (4 in the previous design, one block a 4-row tile
// that streamed every weight each step).  A step, with its cluster
// barriers (each an arrive after the stores it publishes and a wait
// before the first read of them):
//   1. layer 0's product over [attn; h0] (both published by the last
//      step), + xp[t] of the block's 4U gate columns, the gate math, h0's
//      slice published;
//   2. layer l >= 1: the product over its own last h_l, the wait for
//      h_{l-1}, that half, + bi + bh, the gate math; h_l published;
//   3. q = h_top @ W_a and h_top @ W_c[H:] over the block's columns; q's
//      slice (float32) published;
//   4. the attention of the block's own R = bt/cs tile rows (q and alpha
//      rounded), alpha and the rounded context vector published;
//   5. h~ = tanh(ctx_vec @ W_c[:H] + h_top @ W_c[H:]) over the block's
//      columns into htl (float32) and the next step's input feed.
// With collect, each block writes its own units' h, gate activations and
// c (compute dtype) at each layer's epilogue, and a row's owner its alpha
// (float32) and rounded context vector.  Rows past B are masked on every
// write (their exchange rows stay the scratch's zeros).
//
// Bound on the H100: as greedy_loop.cu's, a step's chain of dependent
// phases with nl + 3 cluster barriers; float32 by its FMA loop.  The plan
// (tf_fwd_plan: dc_plan_fit with this kernel's shared memory, mirrored by
// aocr_torch/ops/cuda/tf_fwd.py::plan) sizes the tile so that the
// clusters fill the card; a shape no plan fits is refused.
#include "decoder_cluster.cuh"

namespace aocr {

struct TfArgs {
  const void* ctx;  // (L, B, H) compute dtype
  const float* c0;  // (B, H)
  const float* h0;  // (B, H)
  const void* xp;   // (T, B, 4H) compute dtype
  // the weights packed by block (ops/cuda/greedy_loop.py::pack_weights):
  // layer 0 (cs, nseg0, hs, 4U + pad), layers 1..nl-1
  // (nl-1, cs, 2, hs, 4U + pad), [W_a | W_c[H:]] (cs, hs, 2U + pad) and
  // W_c[:H] (cs, hs, U + pad)
  const void* w0;
  const void* wl;
  const float* bi;  // (nl-1, 4H)
  const float* bh;  // (nl-1, 4H)
  const void *wq, *wcx;
  float* htl;                // (T, B, H)
  void *hs, *ifog, *cs;      // (nl, T, B, H | 4H | H), or null
  float* alpha;              // (T, B, L)
  void* cvec;                // (T, B, H)
  unsigned char* scratch;    // dc_scratch's regions (V = 0), zeroed
  int L, B, H, T, nl, input_feed;
};

// The shared memory of a plan: the ring, the float tile (h_top @ W_c[H:],
// bt x ldh), the cell states (with cres) and the mbarriers; the
// attention's q rows and scores (R x (H + L) floats) and its staged
// context overlay the ring.  0 where the overlay does not fit.
static inline long tf_fwd_smem(const DcPlan& p, int esz, int H, int L,
                               int nl) {
  const DcGeom g = dc_geom(p, esz);
  const long ring = (long)p.stages * g.stage * esz;
  if ((long)g.R * (H + L) * 4 > ring) return 0;
  return ring + (long)p.bt * g.ldh * 4 + dc_cbytes(p, nl) + DC_BARS;
}

#ifdef DC_PROBES
// the phases' cycles summed over the blocks, then the block count
__device__ unsigned long long tf_prof[DC_NPHASES + 1];
#endif

// RT: float32 rows a thread (DC_FMA_RT); bf16 instances take 1.
template <typename T, int RT>
__global__ void __launch_bounds__(DC_THREADS, 1)
tf_fwd_cluster_kernel(TfArgs a, DcPlan p) {
  constexpr int ESZ = (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const T* __restrict__ ctx = static_cast<const T*>(a.ctx);
  const T* __restrict__ xp = static_cast<const T*>(a.xp);
  const T* w0 = static_cast<const T*>(a.w0);
  const T* wl = static_cast<const T*>(a.wl);
  const T* wq = static_cast<const T*>(a.wq);
  const T* wcx = static_cast<const T*>(a.wcx);
  T* hs_out = static_cast<T*>(a.hs);
  T* ifog_out = static_cast<T*>(a.ifog);
  T* cs_out = static_cast<T*>(a.cs);
  T* cvec_out = static_cast<T*>(a.cvec);
  const bool collect = hs_out != nullptr;
  const int tid = threadIdx.x;
  const int H = a.H, G = 4 * H, nl = a.nl, T_ = a.T, B = a.B, L = a.L;

  const int cl = (int)blockIdx.x / p.cs;
  const DcBlock<T> b = dc_block<T>(p, H, cl, min(p.bt, B - cl * p.bt),
                                   (p.bt + p.cs - 1) / p.cs);
  const int j0 = b.j0, b0 = b.b0, hs = b.hs, R = b.g.R, ldh = b.g.ldh;

  // shared memory: the ring, the float tile, the cell states, the
  // mbarriers; the attention's q rows, scores and staged context overlay
  // the ring
  T* ring0 = reinterpret_cast<T*>(smem);
  const long ring_bytes = (long)p.stages * b.g.stage * ESZ;
  float* ht = reinterpret_cast<float*>(smem + ring_bytes);
  float* csm = ht + p.bt * ldh;  // (tile row, layer, unit of the block)
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(csm) + dc_cbytes(p, nl));
  DcRing<T> ring = {ring0, bars, 0, 0};
  float* qs = reinterpret_cast<float*>(smem);
  float* sc = qs + R * H;
  const long cb_off = dc_round_up((long)R * (H + L) * 4, 16);
  T* cbuf = reinterpret_cast<T*>(smem + cb_off);
  const int nb = (int)min((long)R, (ring_bytes - cb_off) /
                                       ((long)L * H * ESZ));

  // global scratch (dc_scratch without the projector's regions): the
  // exchange planes h~ and h_l by step parity, the context vector; q; the
  // cell states where shared memory does not hold them
  long off[6];
  dc_scratch(p, ESZ, H, nl, 0, off);
  T* xb = reinterpret_cast<T*>(a.scratch + off[0]);
  const size_t plane = (size_t)dc_plane(p, ESZ, H);
  auto attn = [&](int par) { return xb + par * plane; };
  auto hbuf = [&](int l, int par) { return xb + (2 + 2 * l + par) * plane; };
  T* cvb = xb + (2 + 2 * nl) * plane;
  const size_t at = b.atile();
  float* qb = reinterpret_cast<float*>(a.scratch + off[1]);
  float* cb = reinterpret_cast<float*>(a.scratch + off[2]);  // (bp, nl, H)
  // the block's packed weight slices and their row strides
  constexpr int WP = 16 / ESZ;
  const int ld4 = 4 * p.units + WP, ld1 = p.units + WP;
  const int nseg0 = a.input_feed ? 2 : 1;
  const size_t seg4 = (size_t)hs * ld4;
  auto wseg0 = [&](int k) {
    return w0 + ((size_t)b.rank * nseg0 + k) * seg4;
  };
  auto wsegl = [&](int l, int k) {
    return wl + (((size_t)(l - 1) * p.cs + b.rank) * 2 + k) * seg4;
  };

  const DcTiles tl(p.units, p.rt);
  const DcFma fm(p.units, RT);
  DcClock clk;

  if (tid == 0) {
    for (int i = 0; i <= DC_MAX_STAGES; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // c of (tile row r, layer l, unit j0 + u)
  auto cell = [&](int r, int l, int u) {
    return p.cres ? csm + ((size_t)r * nl + l) * p.units + u
                  : cb + ((size_t)(b0 + r) * nl + l) * H + j0 + u;
  };
  // c_0 and h_0 (rounded) of the block's units; h~, c and h of the other
  // layers start as zeros (the scratch's, or set here)
  for (int i = tid; i < b.nrows * b.nu; i += DC_THREADS) {
    const int r = i / b.nu, u = i % b.nu, j = j0 + u;
    const size_t row = (size_t)(b0 + r);
    *cell(r, 0, u) = a.c0[row * H + j];
    for (int l = 1; p.cres && l < nl; ++l) *cell(r, l, u) = 0.f;
    hbuf(0, 0)[b.aoff(r, j)] = from_f<T>(a.h0[row * H + j]);
  }
  fence_proxy_async();
  cluster_barrier();

  for (int t = 0; t < T_; ++t) {
    const int par = t & 1, nxt = par ^ 1;
    // the residuals of (layer l, tile row r, units j, j + 1)
    auto seen = [&](int l, int r, int j, const float (&c)[2],
                    const float (&h)[2], const float (&act)[2][4]) {
      const size_t row = ((size_t)l * T_ + t) * B + b0 + r;
      store2<T>(hs_out + row * H + j, h[0], h[1]);
      store2<T>(cs_out + row * H + j, c[0], c[1]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        store2<T>(ifog_out + row * G + q * H + j, act[0][q], act[1][q]);
    };
    // ---- 1. layer 0: [attn; h0] @ wfh0 + xp[t]
    {
      DcAcc<T, RT, 4> acc;
      dc_zero(acc);
      if (a.input_feed)
        dc_product<T, RT, 4>(acc, {attn(par) + at, wseg0(0), ld4}, b, ring,
                             clk, tl, fm);
      dc_product<T, RT, 4>(acc, {hbuf(0, par) + at, wseg0(nseg0 - 1), ld4},
                           b, ring, clk, tl, fm);
      const T* xpt = xp + (size_t)t * B * G;
      T* hn = hbuf(0, nxt);
      dc_pairs<T, RT, 4>(acc, tl, fm, [&](int r, int u, const float(&v)[4][2]) {
        if (r >= b.nrows || u >= b.nu) return;
        const int j = j0 + u;
        const T* xr = xpt + (size_t)(b0 + r) * G + j;
        float* cr = cell(r, 0, u);
        float x[4][2], c[2], h[2], act[2][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) load_row(xr + q * H, x[q]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          gate_math_parts(x[0][e] + v[0][e], x[1][e] + v[1][e],
                          x[2][e] + v[2][e], x[3][e] + v[3][e], cr[e], &c[e],
                          &h[e], act[e]);
          cr[e] = c[e];
        }
        store2<T>(hn + b.aoff(r, j), h[0], h[1]);
        if (collect) seen(0, r, j, c, h, act);
      });
      clk.tick(DC_EPILOGUE);
      dc_publish();
    }
    // ---- 2. layers 1..nl-1: [h_{l-1}; h_l] @ W_l + bi + bh
    for (int l = 1; l < nl; ++l) {
      DcAcc<T, RT, 4> acc;
      dc_zero(acc);
      dc_product<T, RT, 4>(acc, {hbuf(l, par) + at, wsegl(l, 0), ld4}, b,
                           ring, clk, tl, fm);
      cluster_wait();
      clk.tick(DC_BARRIER);
      dc_product<T, RT, 4>(acc, {hbuf(l - 1, nxt) + at, wsegl(l, 1), ld4}, b,
                           ring, clk, tl, fm);
      const float* bil = a.bi + (size_t)(l - 1) * G;
      const float* bhl = a.bh + (size_t)(l - 1) * G;
      T* hn = hbuf(l, nxt);
      dc_pairs<T, RT, 4>(acc, tl, fm, [&](int r, int u, const float(&v)[4][2]) {
        if (r >= b.nrows || u >= b.nu) return;
        const int j = j0 + u;
        float* cr = cell(r, l, u);
        float g[4][2], c[2], h[2], act[2][4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            g[q][e] = v[q][e] + bil[q * H + j + e] + bhl[q * H + j + e];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          gate_math_parts(g[0][e], g[1][e], g[2][e], g[3][e], cr[e], &c[e],
                          &h[e], act[e]);
          cr[e] = c[e];
        }
        store2<T>(hn + b.aoff(r, j), h[0], h[1]);
        if (collect) seen(l, r, j, c, h, act);
      });
      clk.tick(DC_EPILOGUE);
      dc_publish();
    }
    cluster_wait();
    clk.tick(DC_BARRIER);
    // ---- 3. q = h_top @ W_a and h_top @ W_c[H:]
    dc_query<T, RT>(hbuf(nl - 1, nxt) + at, wq, qb, ht, b, ring, clk, tl, fm);
    // ---- 4. the attention of the own rows, q and alpha rounded
    dc_attend_rows<T, true>(ctx, L, B, qb, cvb, qs, sc, cbuf, nb, b, ring,
                            (size_t)b0 + b.ra, 1);
    if (collect) {
      // alpha (left in sc) and the rounded context vector of the own rows
      const size_t row0 = (size_t)t * B + b0 + b.ra;
      for (int i = tid; i < b.nown * L; i += DC_THREADS)
        a.alpha[row0 * L + i] = sc[i];
      for (int i = tid; i < b.nown * H; i += DC_THREADS) {
        const int r = i / H, h = i % H;
        cvec_out[(row0 + r) * H + h] = cvb[b.aoff(b.ra + r, h)];
      }
    }
    clk.tick(DC_ATTEND);
    dc_publish();
    cluster_wait();
    clk.tick(DC_BARRIER);
    // ---- 5. h~ = tanh(ctx_vec @ W_c[:H] + h_top @ W_c[H:])
    {
      DcAcc<T, RT, 1> acc;
      dc_zero(acc);
      dc_product<T, RT, 1>(acc, {cvb + at, wcx + (size_t)b.rank * hs * ld1,
                                 ld1}, b, ring, clk, tl, fm);
      T* an = attn(nxt);
      float* hrow = a.htl + (size_t)t * B * H;
      dc_pairs<T, RT, 1>(acc, tl, fm, [&](int r, int u, const float(&v)[1][2]) {
        if (r >= b.nrows || u >= b.nu) return;
        const int j = j0 + u;
        const float h0 = tanhf(v[0][0] + ht[r * ldh + u]);
        const float h1 = tanhf(v[0][1] + ht[r * ldh + u + 1]);
        store2<T>(an + b.aoff(r, j), h0, h1);
        store2<float>(hrow + (size_t)(b0 + r) * H + j, h0, h1);
      });
      clk.tick(DC_EPILOGUE);
      dc_publish();
      cluster_wait();
      clk.tick(DC_BARRIER);
    }
  }
#ifdef DC_PROBES
  if (tid == 0) {
    for (int i = 0; i < DC_NPHASES; ++i) atomicAdd(&tf_prof[i], dc_prof[i]);
    atomicAdd(&tf_prof[DC_NPHASES], 1ull);
  }
#endif
}

using TfKernel = void (*)(TfArgs, DcPlan);

// The instance for a plan: bf16 one, float32 one per rows a thread.
static TfKernel tf_kernel(int esz, int rt) {
  if (esz == 2) return tf_fwd_cluster_kernel<__nv_bfloat16, 1>;
  if (rt == DC_FMA_RT[0]) return tf_fwd_cluster_kernel<float, DC_FMA_RT[0]>;
  if (rt == DC_FMA_RT[1]) return tf_fwd_cluster_kernel<float, DC_FMA_RT[1]>;
  return tf_fwd_cluster_kernel<float, DC_FMA_RT[2]>;
}

// The plan of a launch; false where none fits or the card runs no cluster
// of its size.
static bool tf_launch_plan(int esz, int H, int B, int L, int nl, DcPlan* p,
                           int* active) {
  int cs, U;
  dc_cluster(H, &cs, &U);
  *active = dc_active(tf_kernel(esz, DC_FMA_RT[2]), esz, cs);
  return *active > 0 &&
         dc_plan_fit(H, B, esz, *active, [&](const DcPlan& q) {
           return tf_fwd_smem(q, esz, H, L, nl);
         }, p);
}

static int launch(int esz, const TfArgs& a, cudaStream_t stream) {
  DcPlan p;
  int active;
  if (a.L < 1 || a.B < 1 || a.T < 1 || a.nl < 1 || a.H < 4 || a.H % 4 ||
      !tf_launch_plan(esz, a.H, a.B, a.L, a.nl, &p, &active))
    return (int)cudaErrorInvalidValue;
  return dc_launch(tf_kernel(esz, p.rt), p, a, stream);
}

}  // namespace aocr

#define AOCR_TF_FWD_ARGS                                                     \
  const void *ctx, const void *c0, const void *h0, const void *xp,          \
      const void *w0, const void *wl, const void *bi, const void *bh,       \
      const void *wq, const void *wcx, void *htl, void *hs, void *ifog,     \
      void *cs, void *alpha, void *cvec, void *scratch, int L, int B, int H, \
      int T_, int nl, int input_feed, void *stream

static aocr::TfArgs tf_args(AOCR_TF_FWD_ARGS) {
  return {ctx, (const float*)c0, (const float*)h0, xp, w0, wl,
          (const float*)bi, (const float*)bh, wq, wcx, (float*)htl, hs,
          ifog, cs, (float*)alpha, cvec, (unsigned char*)scratch, L, B, H,
          T_, nl, input_feed};
}

extern "C" int aocr_tf_fwd_f32(AOCR_TF_FWD_ARGS) {
  return aocr::launch(4,
                      tf_args(ctx, c0, h0, xp, w0, wl, bi, bh, wq, wcx, htl,
                              hs, ifog, cs, alpha, cvec, scratch, L, B, H,
                              T_, nl, input_feed, stream),
                      (cudaStream_t)stream);
}

extern "C" int aocr_tf_fwd_bf16(AOCR_TF_FWD_ARGS) {
  return aocr::launch(2,
                      tf_args(ctx, c0, h0, xp, w0, wl, bi, bh, wq, wcx, htl,
                              hs, ifog, cs, alpha, cvec, scratch, L, B, H,
                              T_, nl, input_feed, stream),
                      (cudaStream_t)stream);
}

// The plan of a launch: out[0..8] = cs, units, bt, rt, kc, stages, cres,
// smem, clusters (as aocr_torch/ops/cuda/tf_fwd.py::plan gives them for
// out[9]) and out[9] = the clusters of cs blocks the card runs at once.
// Returns a CUDA error code.
extern "C" int aocr_tf_fwd_plan(int H, int B, int is_f32, int L, int nl,
                                int* out) {
  aocr::DcPlan p;
  int active;
  if (!aocr::tf_launch_plan(is_f32 ? 4 : 2, H, B, L, nl, &p, &active))
    return (int)cudaErrorInvalidValue;
  const int v[10] = {p.cs, p.units, p.bt, p.rt, p.kc, p.stages, p.cres,
                     p.smem, p.clusters, active};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}
