// The teacher-forced decoder backward recurrence, all T steps in one
// launch, on thread-block clusters.
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
// the dh of the layer below.  The previous cell state of a step is read
// from the cs stack (c0 rounded to the compute dtype for layer 0 at t=0,
// zero for the other layers).
//
// Design: tf_fwd.cu's clusters (decoder_cluster.cuh).  A cluster of cs
// blocks owns a tile of bt batch rows for all T steps; block s owns the
// U = H/cs units [s U, (s+1) U) of every carry (dc_l, dh_l, dattn, and
// the dh a layer passes down), in shared memory where the plan fits them.
// So the gate backward of its own units is elementwise (its 4U columns of
// ifog, its U of cs), and each product is split by output columns: block
// s streams its slices of the transposed weights (packed by block by the
// wrapper, ops/cuda/tf_bwd.py::pack_weights): layer l's (4H, 2U) of
// W_l^T (its units of the dh passed down and of dh_l), (H, 2U) of W_c^T
// (dcvec and dtop), (H, U) of W_a^T.  The left operands are whole rows,
// so they are exchanged through L2 before each product: dh~ and dq (bt x
// H) and each layer's dgates (bt x 4H, four planes, streamed as four
// segments).  (Splitting the contraction instead would exchange cs
// partial sums of bt x 2H floats a layer and step.)  A step, with one
// cluster barrier after each publish:
//   1. dh~ of the own units, rounded, published;
//   2. [dcvec | dtop] = round(dh~) @ W_c^T over the block's columns; dcvec
//      published in float32 (dalpha reads it unrounded), dtop kept;
//   3. the attention backward of the block's own R = bt/cs tile rows
//      (dc_attend_bwd_rows): dscore, and dq rounded, published;
//   4. dtop += round(dq) @ W_a^T;
//   5. for each layer, top down: the gate backward of the own units,
//      round(dgates) published, then the product: dh of the layer below
//      (or dattn) and the layer's dh carry.
// Rows past B are masked on every write (their exchange rows stay the
// scratch's zeros).
//
// Bound on the H100: as tf_fwd.cu's, a step's chain of dependent phases
// (nl + 3 cluster barriers); float32 by its FMA loop.  The plan
// (tf_bwd_plan: dc_plan_fit with this kernel's shared memory, mirrored by
// aocr_torch/ops/cuda/tf_bwd.py::plan) sizes the tile; a shape no plan
// fits is refused.
#include "decoder_cluster.cuh"

namespace aocr {

struct TbArgs {
  const void* ctx;  // (L, B, H) compute dtype
  // the transposed weights packed by block (ops/cuda/tf_bwd.py::
  // pack_weights): layer 0 (cs, 4, hs, nq0 U + pad) with nq0 = 2 ([dattn |
  // dh0]) with input feed, else 1; layers 1..nl-1 (nl-1, cs, 4, hs, 2U +
  // pad) ([dh below | dh_l]); W_c^T (cs, hs, 2U + pad) ([dcvec | dtop]);
  // W_a^T (cs, hs, U + pad)
  const void *w0, *wl, *wct, *wat;
  const float* dys;    // (T, B, H)
  const float* htl;    // (T, B, H)
  const float* alpha;  // (T, B, L)
  const void* ifog;    // (nl, T, B, 4H) compute dtype
  const void* cs;      // (nl, T, B, H) compute dtype
  const float* c0;     // (B, H)
  void* dg;            // (nl, T, B, 4H) compute dtype
  void *dht, *dq, *dcvec;  // (T, B, H) compute dtype
  float* dscore;           // (T, B, L)
  float *dc0, *dh0;        // (B, H)
  unsigned char* scratch;  // tb_scratch's regions, zeroed
  int L, B, H, T, nl, input_feed;
};

// The carries in shared memory (with cres): (tile row, slot, unit of the
// block), slots 2l dc_l, 2l + 1 dh_l, 2nl dattn, 2nl + 1 the dh a layer
// passes down (dtop for the top layer).
__host__ __device__ inline long tb_cbytes(const DcPlan& p, int nl) {
  return p.cres ? (long)p.bt * (2 * nl + 2) * p.units * 4 : 0;
}

// Byte offsets of the scratch regions (zeroed by the caller): the exchange
// planes in the compute dtype (dh~, dq, and the four dgates planes of the
// layers by layer parity; each a dc_plane), dcvec (float32, bp x hs) and,
// without cres, the carries (bp x (2 nl + 2) x H floats); off[3] is the
// total.
__host__ __device__ inline void tb_scratch(const DcPlan& p, int esz, int H,
                                           int nl, long (&off)[4]) {
  const long bp = (long)p.clusters * p.bt;
  const long sizes[3] = {
      (2L + 4 * (nl < 2 ? nl : 2)) * dc_plane(p, esz, H) * esz,
      bp * dc_round_up(H, p.kc) * 4,
      p.cres ? 0 : bp * (2L * nl + 2) * H * 4};
  long at = 0;
  for (int i = 0; i < 3; ++i) {
    off[i] = at;
    at += dc_round_up(sizes[i], DC_ALIGN);
  }
  off[3] = at;
}

// The shared memory of a plan: the ring (stages sized for two column
// blocks), the carries (with cres) and the mbarriers; the attention
// backward's dcvec rows and dalpha (R x (H + L) floats) and its staged
// context overlay the ring.  0 where the overlay does not fit.
static inline long tf_bwd_smem(const DcPlan& p, int esz, int H, int L,
                               int nl) {
  const DcGeom g = dc_geom(p, esz, 2);
  const long ring = (long)p.stages * g.stage * esz;
  if ((long)g.R * (H + L) * 4 > ring) return 0;
  return ring + tb_cbytes(p, nl) + DC_BARS;
}

#ifdef DC_PROBES
// the phases' cycles summed over the blocks, then the block count
__device__ unsigned long long tb_prof[DC_NPHASES + 1];
#endif

// RT: float32 rows a thread (DC_FMA_RT); bf16 instances take 1.
template <typename T, int RT>
__global__ void __launch_bounds__(DC_THREADS, 1)
tf_bwd_cluster_kernel(TbArgs a, DcPlan p) {
  constexpr int ESZ = (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const T* __restrict__ ctx = static_cast<const T*>(a.ctx);
  const T* __restrict__ ifog = static_cast<const T*>(a.ifog);
  const T* __restrict__ cs = static_cast<const T*>(a.cs);
  const T* w0 = static_cast<const T*>(a.w0);
  const T* wl = static_cast<const T*>(a.wl);
  const T* wct = static_cast<const T*>(a.wct);
  const T* wat = static_cast<const T*>(a.wat);
  T* dg_out = static_cast<T*>(a.dg);
  T* dht_out = static_cast<T*>(a.dht);
  T* dq_out = static_cast<T*>(a.dq);
  T* dcvec_out = static_cast<T*>(a.dcvec);
  const int tid = threadIdx.x;
  const int H = a.H, G = 4 * H, nl = a.nl, T_ = a.T, B = a.B, L = a.L;

  const int cl = (int)blockIdx.x / p.cs;
  const DcBlock<T> b = dc_block<T>(p, H, cl, min(p.bt, B - cl * p.bt),
                                   (p.bt + p.cs - 1) / p.cs, 2);
  const int j0 = b.j0, b0 = b.b0, hs = b.hs, R = b.g.R, nu = b.nu;

  // shared memory: the ring, the carries, the mbarriers; the attention
  // backward's rows and staged context overlay the ring
  T* ring0 = reinterpret_cast<T*>(smem);
  const long ring_bytes = (long)p.stages * b.g.stage * ESZ;
  float* csm = reinterpret_cast<float*>(smem + ring_bytes);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + ring_bytes + tb_cbytes(p, nl));
  DcRing<T> ring = {ring0, bars, 0, 0};
  float* ds = reinterpret_cast<float*>(smem);
  float* sc = ds + R * H;
  const long cb_off = dc_round_up((long)R * (H + L) * 4, 16);
  T* cbuf = reinterpret_cast<T*>(smem + cb_off);
  const int nb = (int)min((long)R, (ring_bytes - cb_off) /
                                       ((long)L * H * ESZ));

  // global scratch (tb_scratch)
  long off[4];
  tb_scratch(p, ESZ, H, nl, off);
  T* xb = reinterpret_cast<T*>(a.scratch + off[0]);
  const size_t plane = (size_t)dc_plane(p, ESZ, H);
  T* pht = xb;
  T* pdq = xb + plane;
  auto pdg = [&](int l, int q) { return xb + (2 + 4 * (l & 1) + q) * plane; };
  float* dcf = reinterpret_cast<float*>(a.scratch + off[1]);  // (bp, hs)
  float* cg = reinterpret_cast<float*>(a.scratch + off[2]);
  const int ncar = 2 * nl + 2, DATTN = 2 * nl, DX = 2 * nl + 1;
  // carry slot k of (tile row r, unit j0 + u)
  auto car = [&](int r, int k, int u) {
    return p.cres ? csm + ((size_t)r * ncar + k) * p.units + u
                  : cg + ((size_t)(b0 + r) * ncar + k) * H + j0 + u;
  };
  const size_t at = b.atile();
  // the block's packed weight slices and their row strides
  constexpr int WP = 16 / ESZ;
  const int ld1 = p.units + WP, ld2 = 2 * p.units + WP;
  const int ld0 = (a.input_feed ? 2 : 1) * p.units + WP;
  auto w0seg = [&](int q) {
    return w0 + ((size_t)b.rank * 4 + q) * hs * ld0;
  };
  auto wlseg = [&](int l, int q) {
    return wl + (((size_t)(l - 1) * p.cs + b.rank) * 4 + q) * hs * ld2;
  };
  const T* wcts = wct + (size_t)b.rank * hs * ld2;
  const T* wats = wat + (size_t)b.rank * hs * ld1;

  const DcTiles tl(p.units, p.rt);
  const DcFma fm(p.units, RT);
  DcClock clk;

  if (tid == 0) {
    for (int i = 0; i <= DC_MAX_STAGES; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the carries start at zero (the scratch's, or set here)
  if (p.cres)
    for (int i = tid; i < p.bt * ncar * p.units; i += DC_THREADS) csm[i] = 0.f;
  fence_proxy_async();
  cluster_barrier();

  const int nu4 = nu / 4;  // nu and j0 are multiples of 4
  for (int t = T_ - 1; t >= 0; --t) {
    const size_t tb = (size_t)t * B;
    // ---- 1. dh~ = (dattn + dy) * (1 - h~^2), rounded, published
    for (int i = tid; i < b.nrows * nu4; i += DC_THREADS) {
      const int r = i / nu4, u = 4 * (i % nu4), j = j0 + u;
      const size_t g = (tb + b0 + r) * H + j;
      const float* da = car(r, DATTN, u);
      float dy[4], h[4], d[4];
      load_row(a.dys + g, dy);
      load_row(a.htl + g, h);
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = (da[e] + dy[e]) * (1.f - h[e] * h[e]);
      store4(dht_out + g, d);
      store4(pht + b.aoff(r, j), d);
    }
    clk.tick(DC_EPILOGUE);
    dc_publish();
    cluster_wait();
    clk.tick(DC_BARRIER);
    // ---- 2. [dcvec | dtop] = round(dh~) @ W_c^T
    {
      DcAcc<T, RT, 2> acc;
      dc_zero(acc);
      dc_product<T, RT, 2>(acc, {pht + at, wcts, ld2}, b, ring, clk, tl, fm);
      dc_pairs<T, RT, 2>(acc, tl, fm, [&](int r, int u, const float(&v)[2][2]) {
        if (r >= b.nrows || u >= nu) return;
        const int j = j0 + u;
        store2<float>(dcf + (size_t)(b0 + r) * hs + j, v[0][0], v[0][1]);
        store2<T>(dcvec_out + (tb + b0 + r) * H + j, v[0][0], v[0][1]);
        float* dx = car(r, DX, u);
        dx[0] = v[1][0];
        dx[1] = v[1][1];
      });
      clk.tick(DC_EPILOGUE);
      dc_publish();
      cluster_wait();
      clk.tick(DC_BARRIER);
    }
    // ---- 3. the attention backward of the own rows; round(dq) published
    dc_attend_bwd_rows<T>(ctx, L, B, dcf, a.alpha + tb * L,
                          a.dscore + tb * L, dq_out + tb * H, pdq, ds, sc,
                          cbuf, nb, b, ring);
    clk.tick(DC_ATTEND);
    dc_publish();
    cluster_wait();
    clk.tick(DC_BARRIER);
    // ---- 4. dtop += round(dq) @ W_a^T
    {
      DcAcc<T, RT, 1> acc;
      dc_zero(acc);
      dc_product<T, RT, 1>(acc, {pdq + at, wats, ld1}, b, ring, clk, tl, fm);
      dc_pairs<T, RT, 1>(acc, tl, fm, [&](int r, int u, const float(&v)[1][2]) {
        if (r >= b.nrows || u >= nu) return;
        float* dx = car(r, DX, u);
        dx[0] += v[0][0];
        dx[1] += v[0][1];
      });
      clk.tick(DC_EPILOGUE);
      __syncthreads();
    }
    // ---- 5. the layers, top down
    for (int l = nl - 1; l >= 0; --l) {
      // the gate backward of the own units; round(dgates) published
      for (int i = tid; i < b.nrows * nu4; i += DC_THREADS) {
        const int r = i / nu4, u = 4 * (i % nu4), j = j0 + u;
        const size_t row = ((size_t)l * T_ + t) * B + b0 + r;
        float act[4][4], c[4], cp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < 4; ++q) load_row(ifog + row * G + q * H + j, act[q]);
        load_row(cs + row * H + j, c);
        if (t > 0) {
          load_row(cs + (row - B) * H + j, cp);
        } else if (l == 0) {
          load_row(a.c0 + (size_t)(b0 + r) * H + j, cp);
#pragma unroll
          for (int e = 0; e < 4; ++e) cp[e] = round_cd<T>(cp[e]);
        }
        float* dc = car(r, 2 * l, u);
        const float* dh = car(r, 2 * l + 1, u);
        const float* dx = car(r, DX, u);
        float d[4][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float g4[4], dcp;
          gate_math_bwd(dh[e] + dx[e], dc[e], act[0][e], act[1][e], act[2][e],
                        act[3][e], c[e], cp[e], g4, &dcp);
          dc[e] = dcp;
#pragma unroll
          for (int q = 0; q < 4; ++q) d[q][e] = g4[q];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          store4(dg_out + row * G + q * H + j, d[q]);
          store4(pdg(l, q) + b.aoff(r, j), d[q]);
        }
      }
      clk.tick(DC_EPILOGUE);
      dc_publish();
      cluster_wait();
      clk.tick(DC_BARRIER);
      // round(dgates) @ W^T over the four gate segments: layer l >= 1 ->
      // [dh of layer l-1 | dh_l]; layer 0 -> [dattn | dh_0] (dh_0 alone
      // without input feed)
      if (l > 0 || a.input_feed) {
        DcAcc<T, RT, 2> acc;
        dc_zero(acc);
        const int kx = l > 0 ? DX : DATTN;
#pragma unroll 1
        for (int q = 0; q < 4; ++q)
          dc_product<T, RT, 2>(acc, {pdg(l, q) + at,
                                     l > 0 ? wlseg(l, q) : w0seg(q),
                                     l > 0 ? ld2 : ld0},
                               b, ring, clk, tl, fm);
        dc_pairs<T, RT, 2>(acc, tl, fm, [&](int r, int u, const float(&v)[2][2]) {
          if (r >= b.nrows || u >= nu) return;
          float* dx = car(r, kx, u);
          float* dh = car(r, 2 * l + 1, u);
          dx[0] = v[0][0];
          dx[1] = v[0][1];
          dh[0] = v[1][0];
          dh[1] = v[1][1];
        });
      } else {
        DcAcc<T, RT, 1> acc;
        dc_zero(acc);
#pragma unroll 1
        for (int q = 0; q < 4; ++q)
          dc_product<T, RT, 1>(acc, {pdg(0, q) + at, w0seg(q), ld0}, b, ring,
                               clk, tl, fm);
        dc_pairs<T, RT, 1>(acc, tl, fm, [&](int r, int u, const float(&v)[1][2]) {
          if (r >= b.nrows || u >= nu) return;
          float* dh = car(r, 1, u);
          dh[0] = v[0][0];
          dh[1] = v[0][1];
        });
      }
      clk.tick(DC_EPILOGUE);
      __syncthreads();
    }
  }
  // the initial-state cotangents: layer 0's carries after t = 0
  for (int i = tid; i < b.nrows * nu; i += DC_THREADS) {
    const int r = i / nu, u = i % nu;
    const size_t g = (size_t)(b0 + r) * H + j0 + u;
    a.dc0[g] = *car(r, 0, u);
    a.dh0[g] = *car(r, 1, u);
  }
#ifdef DC_PROBES
  if (tid == 0) {
    for (int i = 0; i < DC_NPHASES; ++i) atomicAdd(&tb_prof[i], dc_prof[i]);
    atomicAdd(&tb_prof[DC_NPHASES], 1ull);
  }
#endif
}

using TbKernel = void (*)(TbArgs, DcPlan);

// The instance for a plan: bf16 one, float32 one per rows a thread.
static TbKernel tb_kernel(int esz, int rt) {
  if (esz == 2) return tf_bwd_cluster_kernel<__nv_bfloat16, 1>;
  if (rt == DC_FMA_RT[0]) return tf_bwd_cluster_kernel<float, DC_FMA_RT[0]>;
  if (rt == DC_FMA_RT[1]) return tf_bwd_cluster_kernel<float, DC_FMA_RT[1]>;
  return tf_bwd_cluster_kernel<float, DC_FMA_RT[2]>;
}

// The plan of a launch; false where none fits or the card runs no cluster
// of its size.
static bool tb_launch_plan(int esz, int H, int B, int L, int nl, DcPlan* p,
                           int* active) {
  int cs, U;
  dc_cluster(H, &cs, &U);
  *active = dc_active(tb_kernel(esz, DC_FMA_RT[2]), esz, cs);
  return *active > 0 &&
         dc_plan_fit(H, B, esz, *active, [&](const DcPlan& q) {
           return tf_bwd_smem(q, esz, H, L, nl);
         }, p);
}

static int launch(int esz, const TbArgs& a, cudaStream_t stream) {
  DcPlan p;
  int active;
  if (a.L < 1 || a.B < 1 || a.T < 1 || a.nl < 1 || a.H < 4 || a.H % 4 ||
      !tb_launch_plan(esz, a.H, a.B, a.L, a.nl, &p, &active))
    return (int)cudaErrorInvalidValue;
  return dc_launch(tb_kernel(esz, p.rt), p, a, stream);
}

}  // namespace aocr

#define AOCR_TF_BWD_ARGS                                                     \
  const void *ctx, const void *w0, const void *wl, const void *wct,         \
      const void *wat, const void *dys, const void *htl, const void *alpha, \
      const void *ifog, const void *cs, const void *c0, void *dg, void *dht, \
      void *dq, void *dcvec, void *dscore, void *dc0, void *dh0,            \
      void *scratch, int L, int B, int H, int T_, int nl, int input_feed,   \
      void *stream

static aocr::TbArgs tb_args(AOCR_TF_BWD_ARGS) {
  return {ctx, w0, wl, wct, wat, (const float*)dys, (const float*)htl,
          (const float*)alpha, ifog, cs, (const float*)c0, dg, dht, dq,
          dcvec, (float*)dscore, (float*)dc0, (float*)dh0,
          (unsigned char*)scratch, L, B, H, T_, nl, input_feed};
}

extern "C" int aocr_tf_bwd_f32(AOCR_TF_BWD_ARGS) {
  return aocr::launch(4,
                      tb_args(ctx, w0, wl, wct, wat, dys, htl, alpha, ifog,
                              cs, c0, dg, dht, dq, dcvec, dscore, dc0, dh0,
                              scratch, L, B, H, T_, nl, input_feed, stream),
                      (cudaStream_t)stream);
}

extern "C" int aocr_tf_bwd_bf16(AOCR_TF_BWD_ARGS) {
  return aocr::launch(2,
                      tb_args(ctx, w0, wl, wct, wat, dys, htl, alpha, ifog,
                              cs, c0, dg, dht, dq, dcvec, dscore, dc0, dh0,
                              scratch, L, B, H, T_, nl, input_feed, stream),
                      (cudaStream_t)stream);
}

// The plan of a launch: out[0..8] = cs, units, bt, rt, kc, stages, cres,
// smem, clusters (as aocr_torch/ops/cuda/tf_bwd.py::plan gives them for
// out[9]) and out[9] = the clusters of cs blocks the card runs at once.
// Returns a CUDA error code.
extern "C" int aocr_tf_bwd_plan(int H, int B, int is_f32, int L, int nl,
                                int* out) {
  aocr::DcPlan p;
  int active;
  if (!aocr::tb_launch_plan(is_f32 ? 4 : 2, H, B, L, nl, &p, &active))
    return (int)cudaErrorInvalidValue;
  const int v[10] = {p.cs, p.units, p.bt, p.rt, p.kc, p.stages, p.cres,
                     p.smem, p.clusters, active};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}
