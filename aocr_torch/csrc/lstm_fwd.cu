// One encoder direction's LSTM recurrence, all L steps in one launch.
//
// Replaces aocr/ops/pallas/lstm_fwd.py::lstm_fwd_scan (pl.pallas_call at
// lstm_fwd.py:158) in both modes: collect=False (inference), and
// collect=True (training), which also writes the residual stacks the
// backward kernel (lstm_bwd.cu) reads: the gate activations ifog
// (L, B, 4H) in [i|f|o|g] blocks of H and the cell states cs (L, B, H),
// both in the compute dtype, as aocr/ops/lstm.py::_collect_from_proj
// stores them.
//
// Design: a persistent RNN on thread-block clusters.  The TPU kernel kept
// Wh resident in VMEM for all L steps.  Here a cluster of cs blocks (16
// SMs at H=512) owns a tile of bt batch rows for all L steps, and block s
// of it owns the hidden units [s*U, (s+1)*U) with their four gate columns
// (j, H+j, 2H+j, 3H+j).  So a block needs only its (H, 4U) slice of Wh,
// which it loads into shared memory once and keeps for the whole scan
// (136 KiB in bf16 at H=512, rows padded).  A step is:
//   1. gates = round_cd(h) @ Wh_slice over the tile: bf16 on the tensor
//      cores (ldmatrix + mma.sync.m16n8k16, float32 accumulators),
//      float32 on the CUDA cores (no TF32: the float32 route is the
//      correctness route).  Rows of the slice that do not fit (float32
//      at H=512: more than half; any dtype at a large H) stream from L2 by
//      cp.async through a ring of LF_STAGES chunks of up to LF_CHUNK rows
//      that runs on across steps;
//   2. the gate math of the block's (row, unit) pairs in float32, with c
//      in registers (never exchanged) and x_proj loaded into registers at
//      the step's start; hs, ifog, cs and the finals written at the
//      original time index.  In the mma path gate q of unit group ug is
//      the n-tile at slice column q*U + 8*ug, so one thread's four
//      accumulator tiles hold i, f, o and g of the same (row, unit) pairs
//      and the gate math needs no exchange;
//   3. one cluster barrier (arrive.release / wait.acquire): every block's
//      slice of hs[t] is in L2 and every block is done reading h; then
//      each block reads the tile's whole hs[t] back from L2 as the next
//      step's h, into its one h buffer.  Distributed shared memory was
//      tried for this exchange (each block storing its slice into its
//      peers' double-buffered h): on an H100 it took longer a step than
//      the read-back and needed the second buffer (PERF.md).
// Clusters never wait on each other: there is no grid-wide sync; a batch
// with more tiles than the card's resident clusters (7 of 16 SMs on an
// H100) runs in waves, and the plan sizes the tile for them.
//
// Bound on the H100: a step's chain of latencies, not bandwidth or the
// tensor cores (the bound, ~0.03 ms in bf16, is two orders below).  In
// bf16 at bt=32 the product, the gate math, the barrier and the
// read-back take 2.2, 1.3, 0.7 and 1.1 us a step; in float32 the FMA
// loop and the streamed rows dominate.  The plan (lf_plan, mirrored by
// aocr_torch/ops/cuda/lstm_fwd.py::plan) picks cs, bt and the resident
// rows from H, B, the dtype and the resident clusters; a ragged batch
// tile and units past H are masked in the kernel; past 128 units a block
// (H > 2048 in bf16) a warp holds 3 mma tiles instead of 2, in a second
// instance of the kernel; a shape no plan fits is refused.
//
// Numerics as aocr/ops/lstm.py::_scan_from_proj: gates = x_proj[t]
// (upcast) + round_cd(h) @ Wh in float32, gate math in float32, (c, h)
// carried in float32.
#include "cluster_mma.cuh"
#include "common.cuh"

namespace aocr {

constexpr int LF_THREADS = 256;
constexpr int LF_WARPS = LF_THREADS / 32;
constexpr int LF_SMEM_MAX = 232448;  // the H100's shared memory a block
constexpr int LF_MAX_CLUSTER = 16;   // non-portable cluster size
constexpr int LF_MMA_TILES = 2;      // (16-row, 8-unit) tiles a warp, bf16
constexpr int LF_MMA_TILES_WIDE = 3; // the same past 128 units a block
constexpr int LF_FMA_ROWS = 4;       // batch rows a thread, float32
constexpr int LF_BT_MAX = 64;        // largest batch tile
// a step's cost that does not grow with the tile (the cluster barrier,
// the read-back's latency, the gate math's dependent chain), in batch
// rows of the per-row cost: from the phase timings on an H100
// (tools/lstm_fwd_phases_torch.py)
constexpr int LF_STEP_ROWS = 32;
constexpr int LF_CHUNK = 64;         // most rows of a streamed chunk of Wh
constexpr int LF_STAGES = 2;         // streamed chunks in shared memory

struct LfPlan {
  int cs;        // blocks (SMs) in a cluster
  int bt;        // batch rows a cluster
  int units;     // hidden units a block, a multiple of 8
  int kp;        // H rounded up to 16: the product's depth
  int kres;      // rows of the Wh slice resident in shared memory
  int kc;        // rows a streamed chunk; 0: the whole slice is resident
  int smem;      // dynamic shared memory bytes a block
  int clusters;  // ceil(B / bt)
};

static int round_up(int a, int m) { return (a + m - 1) / m * m; }

// mma tiles a warp holds in bf16 for U units a block: LF_MMA_TILES, or
// LF_MMA_TILES_WIDE past 128 units (H > 2048 at 16 blocks), where 16
// rows of 8-unit tiles need more than 2 a warp
static int lf_mma_tiles(int U) {
  return U <= 128 ? LF_MMA_TILES : LF_MMA_TILES_WIDE;
}

// The cluster for H: the smallest power of two that gives every block 8
// units or more, up to 16; U units a block, a multiple of 8 (the last
// blocks may own fewer, or none).
static void lf_cluster(int H, int* cs, int* U) {
  *cs = 1;
  while (*cs < LF_MAX_CLUSTER && *cs * 8 < H) *cs *= 2;
  *U = round_up((H + *cs - 1) / *cs, 8);
}

// The launch plan for H, B, the compute dtype's element size esz and the
// clusters of that size the card runs at once (active); false if none
// fits.  The batch tile bt is the multiple of 16 (bf16: mma rows) or 4
// (float32) up to 64 that fits shared memory and the tiles a block holds
// and costs least, waves x (bt + LF_STEP_ROWS), waves = ceil(clusters /
// active): every wave pays the L steps, a step its fixed part and a part
// that grows with the rows.
static bool lf_plan(int H, int B, int esz, int active, LfPlan* p) {
  int cs, U;
  lf_cluster(H, &cs, &U);
  const int kp = round_up(H, 16), pad = 16 / esz;
  const long wrow = (long)(4 * U + pad) * esz;  // bytes of a slice row
  const long hrow = (long)(kp + pad) * esz;     // bytes of an h row
  const int rowq = esz == 2 ? 16 : LF_FMA_ROWS;
  long best = -1;
  for (int bt = rowq; bt <= LF_BT_MAX && bt < B + rowq; bt += rowq) {
    const int tiles =
        esz == 2 ? (bt / 16) * (U / 8) : (bt / LF_FMA_ROWS) * U;
    if (tiles > (esz == 2 ? LF_WARPS * lf_mma_tiles(U) : LF_THREADS))
      continue;
    const long fixed = bt * hrow;
    int kres = kp, kc = 0;
    if (fixed + kp * wrow > LF_SMEM_MAX) {
      // the largest chunk (64, 32 or 16 rows) whose stages fit; resident
      // rows: what fits beside them, leaving whole chunks to stream
      for (kc = LF_CHUNK; kc >= 16; kc /= 2) {
        const long avail = LF_SMEM_MAX - fixed - LF_STAGES * kc * wrow;
        kres = avail < 0 ? -1 : kp - round_up(kp - (int)(avail / wrow), kc);
        if (kres >= 0) break;
      }
      if (kres < 0) continue;
    }
    const int clusters = (B + bt - 1) / bt;
    const long cost =
        (long)((clusters + active - 1) / active) * (bt + LF_STEP_ROWS);
    if (best >= 0 && cost >= best) continue;
    best = cost;
    const long smem = fixed + (kres + (kc ? LF_STAGES * kc : 0)) * wrow;
    *p = {cs, bt, U, kp, kres, kc, (int)smem, clusters};
  }
  return best >= 0;
}

// cp.async rows k0..k0+nk-1 of this block's Wh slice into dst ([k][4U],
// row stride ld): column q*U + u holds Wh[k, q*H + j0 + u]; rows past H
// and units past the block's nu are zeros.  BYTES a copy (16 needs H a
// multiple of its elements and a 16-byte aligned wh).
template <int BYTES, typename T>
__device__ __forceinline__ void load_w_rows(T* dst, int ld,
                                            const T* __restrict__ wh, int H,
                                            int U, int j0, int nu, int k0,
                                            int nk) {
  constexpr int E = BYTES / (int)sizeof(T);
  const int per_row = 4 * U / E;
  for (int i = threadIdx.x; i < nk * per_row; i += LF_THREADS) {
    const int kr = i / per_row, n = (i % per_row) * E;
    const int q = n / U, u = n % U, k = k0 + kr;
    const int valid =
        k < H ? max(0, min(E, nu - u)) * (int)sizeof(T) : 0;
    const T* src = valid ? wh + (size_t)k * 4 * H + q * H + j0 + u : wh;
    cp_async<BYTES>(dst + kr * ld + n, src, valid);
  }
}

// acc[t][q*4 + e] += round_cd(h) @ Wh over k0..k0+nk-1 for the warp's
// NT (16-row, 8-unit) tiles t; w holds those rows of the slice ([k][4U],
// row stride ldw), h the tile's rows (row stride ldh).
template <int NT>
__device__ __forceinline__ void product_mma(
    float (&acc)[NT][16], const __nv_bfloat16* h, int ldh,
    const __nv_bfloat16* w, int ldw, int k0, int nk, int U, int ntiles) {
  const int warp = threadIdx.x >> 5, ug_n = U / 8;
#pragma unroll
  for (int ti = 0; ti < NT; ++ti) {
    const int it = warp + ti * LF_WARPS;
    if (it >= ntiles) continue;
    const int m0 = (it / ug_n) * 16, n0 = (it % ug_n) * 8;
    const __nv_bfloat16* ht = h + m0 * ldh + k0;
#pragma unroll 4
    for (int kk = 0; kk < nk; kk += 16) {
      uint32_t a[4], b[4];
      ldmatrix_a(a, ht + kk, ldh);
      const __nv_bfloat16* wr = w + kk * ldw;
      ldmatrix_b2(b, wr, ldw, n0, U + n0);  // gates i, f
      mma_bf16(acc[ti] + 0, a, b[0], b[1]);
      mma_bf16(acc[ti] + 4, a, b[2], b[3]);
      ldmatrix_b2(b, wr, ldw, 2 * U + n0, 3 * U + n0);  // gates o, g
      mma_bf16(acc[ti] + 8, a, b[0], b[1]);
      mma_bf16(acc[ti] + 12, a, b[2], b[3]);
    }
  }
}

// acc[r*4 + q] += h @ Wh over k0..k0+nk-1 for the thread's rows r0.. and
// unit u (float32, CUDA cores, k in order); nk a multiple of 4.  The
// operands of the next 4 rows of the slice load while this 4's FMAs run.
__device__ __forceinline__ void product_fma(float (&acc)[4 * LF_FMA_ROWS],
                                            const float* h, int ldh,
                                            const float* w, int ldw, int k0,
                                            int nk, int U, int r0, int u) {
  constexpr int R = LF_FMA_ROWS;
  const float* hr = h + r0 * ldh + k0;
  float4 hv[2][R];
  float wq[2][4][4];  // [stage][k][gate]
  auto load = [&](int st, int k) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      hv[st][r] = *reinterpret_cast<const float4*>(hr + r * ldh + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wq[st][kk][q] = w[(k + kk) * ldw + q * U + u];
  };
  auto fma4 = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = kk == 0 ? hv[st][r].x
                        : kk == 1 ? hv[st][r].y
                        : kk == 2 ? hv[st][r].z
                                  : hv[st][r].w;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[r * 4 + q] = fmaf(x, wq[st][kk][q], acc[r * 4 + q]);
      }
  };
  load(0, 0);
  for (int k = 0; k < nk; k += 8) {
    if (k + 4 < nk) load(1, k + 4);
    fma4(0);
    if (k + 8 < nk) load(0, k + 8);
    if (k + 4 < nk) fma4(1);
  }
}

// v rounded to T at p (one unit), or as a bf16 pair at p (two adjacent
// units, 4-byte aligned)
template <typename T>
__device__ __forceinline__ void store_units(T* p, const float (&v)[1]) {
  *p = from_f<T>(v[0]);
}
__device__ __forceinline__ void store_units(__nv_bfloat16* p,
                                            const float (&v)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}

// x_proj entries of W adjacent units, as loaded into registers
template <typename XP, int W> struct XPack;
template <> struct XPack<float, 1> { using type = float; };
template <> struct XPack<float, 2> { using type = float2; };
template <> struct XPack<__nv_bfloat16, 2> { using type = __nv_bfloat162; };
__device__ __forceinline__ float xget(float v, int) { return v; }
__device__ __forceinline__ float xget(float2 v, int e) {
  return e ? v.y : v.x;
}
__device__ __forceinline__ float xget(__nv_bfloat162 v, int e) {
  return e ? __high2float(v) : __low2float(v);
}
template <typename V> __device__ __forceinline__ V xzero() { return V{}; }
template <>
__device__ __forceinline__ __nv_bfloat162 xzero<__nv_bfloat162>() {
  return __floats2bfloat162_rn(0.f, 0.f);
}

// Rows 0..nrows-1 of the h tile, units 0..H-1, from src (row stride H,
// written by every block of the cluster) into dst (row stride ld), V (4
// or 16 bytes) a load, through L2 (ld.global.cg: this SM's L1 may hold
// nothing stale).
template <typename V, typename T>
__device__ __forceinline__ void pull_h(T* dst, int ld, const T* src, int H,
                                       int nrows) {
  const int per = H * (int)sizeof(T) / (int)sizeof(V);
  for (int i = threadIdx.x; i < nrows * per; i += LF_THREADS) {
    const int r = i / per, v = i % per;
    reinterpret_cast<V*>(dst + r * ld)[v] =
        __ldcg(reinterpret_cast<const V*>(src + (size_t)r * H) + v);
  }
}

// NTM: the mma tiles a warp holds in bf16 (lf_mma_tiles); float32 holds
// one FMA tile a thread whatever NTM is.
template <typename T, typename XP, int NTM>
__global__ void __launch_bounds__(LF_THREADS, 1)
lstm_fwd_kernel(const T* __restrict__ wh,      // (H, 4H)
                const XP* __restrict__ xp,     // (L, B, 4H)
                const float* __restrict__ c0,  // (B, H)
                const float* __restrict__ h0,  // (B, H)
                T* __restrict__ hs,            // (L, B, H)
                float* __restrict__ cf, float* __restrict__ hf,  // (B, H)
                T* __restrict__ ifog,  // (L, B, 4H) or null: no residuals
                T* __restrict__ cs,    // (L, B, H) or null
                int L, int B, int H, int reverse, int wmode, LfPlan p) {
  constexpr bool MMA = sizeof(T) == 2;
  constexpr int PAD = 16 / (int)sizeof(T);
  constexpr int NT = MMA ? NTM : 1;  // tiles a thread holds
  constexpr int NR = MMA ? 2 : LF_FMA_ROWS;   // rows a tile gives a thread
  constexpr int RS = MMA ? 8 : 1;             // their step
  constexpr int XW = MMA ? 2 : 1;             // adjacent units a thread has
  constexpr int NACC = MMA ? 16 : 4 * LF_FMA_ROWS;
  using XV = typename XPack<XP, XW>::type;
  extern __shared__ __align__(16) unsigned char sm[];
  const int rank = (int)cg::this_cluster().block_rank();
  const int b0 = (int)(blockIdx.x / p.cs) * p.bt;
  const int nrows = min(p.bt, B - b0);
  const int U = p.units, j0 = rank * U, nu = max(0, min(U, H - j0));
  const int G = 4 * H, wld = 4 * U + PAD, hld = p.kp + PAD;
  T* wres = reinterpret_cast<T*>(sm);                  // kres x wld
  T* stage = wres + (size_t)p.kres * wld;              // STAGES x kc x wld
  T* hb = stage + (size_t)LF_STAGES * p.kc * wld;      // bt x hld: h
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles =
      MMA ? (p.bt / 16) * (U / 8) : (p.bt / LF_FMA_ROWS) * U;

  // the first row and unit of the thread's ti-th tile; false: none
  auto tile_of = [&](int ti, int& r0, int& u) {
    if (MMA) {
      const int it = warp + ti * LF_WARPS;
      r0 = (it / (U / 8)) * 16 + (lane >> 2);
      u = (it % (U / 8)) * 8 + 2 * (lane & 3);
      return it < ntiles;
    }
    const int it = threadIdx.x;
    r0 = (it / U) * LF_FMA_ROWS;
    u = it % U;
    return it < ntiles;
  };
  // streamed chunk gi of the whole scan (step gi / nchunks) into its stage
  const int nchunks = p.kc ? (p.kp - p.kres) / p.kc : 0;
  auto load_chunk = [&](int gi) {
    if (gi >= L * nchunks) return;
    const int k0 = p.kres + (gi % nchunks) * p.kc;
    T* dst = stage + (size_t)(gi % LF_STAGES) * p.kc * wld;
    if (wmode)
      load_w_rows<16>(dst, wld, wh, H, U, j0, nu, k0, p.kc);
    else
      load_w_rows<4>(dst, wld, wh, H, U, j0, nu, k0, p.kc);
  };

  // the resident rows of the slice, the first streamed chunks, the tile's
  // h0 (rounded to T; zeros past nrows and H) and the thread's c0
  if (wmode)
    load_w_rows<16>(wres, wld, wh, H, U, j0, nu, 0, p.kres);
  else
    load_w_rows<4>(wres, wld, wh, H, U, j0, nu, 0, p.kres);
  for (int gi = 0; gi < LF_STAGES - 1; ++gi) {
    load_chunk(gi);
    cp_async_commit();
  }
  for (int i = threadIdx.x; i < p.bt * hld; i += LF_THREADS) {
    const int r = i / hld, k = i % hld;
    hb[i] = from_f<T>(r < nrows && k < H ? h0[(size_t)(b0 + r) * H + k]
                                         : 0.f);
  }
  float c[NT][NR][XW];
#pragma unroll
  for (int ti = 0; ti < NT; ++ti) {
    int r0, u;
    const bool has = tile_of(ti, r0, u);
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int e = 0; e < XW; ++e) {
        const int r = r0 + i * RS;
        c[ti][i][e] = has && r < nrows && u < nu
                          ? c0[(size_t)(b0 + r) * H + j0 + u + e]
                          : 0.f;
      }
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int s = 0; s < L; ++s) {
    const int t = reverse ? L - 1 - s : s;
    const bool last = s == L - 1;
    // x_proj of step t into registers; used after the product
    XV xv[NT][NR][4];
#pragma unroll
    for (int ti = 0; ti < NT; ++ti) {
      int r0, u;
      const bool has = tile_of(ti, r0, u);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = r0 + i * RS;
        const bool ok = has && r < nrows && u < nu;
        const XP* src = xp + ((size_t)t * B + b0 + r) * G + j0 + u;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xv[ti][i][q] = ok ? __ldg(reinterpret_cast<const XV*>(src + q * H))
                            : xzero<XV>();
      }
    }
    float acc[NT][NACC];
#pragma unroll
    for (int ti = 0; ti < NT; ++ti)
#pragma unroll
      for (int e = 0; e < NACC; ++e) acc[ti][e] = 0.f;
    auto product = [&](const T* w, int k0, int nk) {
      if constexpr (MMA) {
        product_mma(acc, hb, hld, w, wld, k0, nk, U, ntiles);
      } else {
        int r0, u;
        if (tile_of(0, r0, u))
          product_fma(acc[0], hb, hld, w, wld, k0, nk, U, r0, u);
      }
    };
    product(wres, 0, p.kres);
    for (int ci = 0; ci < nchunks; ++ci) {
      // chunk gi is used while the next LF_STAGES - 1 stream in (past
      // the step's last: the next step's first)
      const int gi = s * nchunks + ci;
      load_chunk(gi + LF_STAGES - 1);
      cp_async_commit();
      cp_async_wait<LF_STAGES - 1>();
      __syncthreads();
      product(stage + (size_t)(gi % LF_STAGES) * p.kc * wld,
              p.kres + ci * p.kc, p.kc);
      __syncthreads();
    }

    // the gate math of the thread's (row, unit) pairs
#pragma unroll
    for (int ti = 0; ti < NT; ++ti) {
      int r0, u;
      if (!tile_of(ti, r0, u)) continue;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = r0 + i * RS;
        float h[XW], a[XW][4];
#pragma unroll
        for (int e = 0; e < XW; ++e) {
          float g[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            g[q] = xget(xv[ti][i][q], e) +
                   (MMA ? acc[ti][q * 4 + i * 2 + e] : acc[ti][i * 4 + q]);
          gate_math_parts(g[0], g[1], g[2], g[3], c[ti][i][e],
                          &c[ti][i][e], &h[e], a[e]);
        }
        if (r >= nrows || u >= nu) continue;  // nu and u are even
        const size_t row = (size_t)t * B + b0 + r;
        const int j = j0 + u;
        store_units(hs + row * H + j, h);
        if (ifog != nullptr) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float aq[XW];
#pragma unroll
            for (int e = 0; e < XW; ++e) aq[e] = a[e][q];
            store_units(ifog + row * G + q * H + j, aq);
          }
          store_units(cs + row * H + j, c[ti][i]);
        }
        if (last) {
#pragma unroll
          for (int e = 0; e < XW; ++e) {
            cf[(size_t)(b0 + r) * H + j + e] = c[ti][i][e];
            hf[(size_t)(b0 + r) * H + j + e] = h[e];
          }
        }
      }
    }
    if (last) break;
    // every block's slice of hs[t] is written, and every thread is done
    // reading hb: the next step's h comes back from L2
    cluster_barrier();
    const T* src = hs + ((size_t)t * B + b0) * H;
    if ((H * (int)sizeof(T)) % 16 == 0)
      pull_h<uint4>(hb, hld, src, H, nrows);
    else
      pull_h<uint32_t>(hb, hld, src, H, nrows);
    __syncthreads();
  }
}

template <typename T, typename XP>
using LfKernel = void (*)(const T*, const XP*, const float*, const float*,
                          T*, float*, float*, T*, T*, int, int, int, int,
                          int, LfPlan);

// The kernel instance for U units a block: bf16 holds lf_mma_tiles(U)
// mma tiles a warp; float32 has one instance.
template <typename T, typename XP>
static LfKernel<T, XP> lf_kernel(int U) {
  if (sizeof(T) == 2 && lf_mma_tiles(U) == LF_MMA_TILES_WIDE)
    return lstm_fwd_kernel<T, XP, LF_MMA_TILES_WIDE>;
  return lstm_fwd_kernel<T, XP, LF_MMA_TILES>;
}

template <typename T, typename XP>
static cudaError_t lf_config(LfKernel<T, XP> fn, const LfPlan& p,
                             cudaStream_t stream, cudaLaunchConfig_t* cfg,
                             cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) e = set_smem((const void*)fn, p.smem);
  *cfg = {};
  cfg->gridDim = dim3(p.clusters * p.cs);
  cfg->blockDim = dim3(LF_THREADS);
  cfg->dynamicSmemBytes = p.smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return e;
}

// The clusters of cs blocks the card runs at once with the largest shared
// memory a plan takes (a smaller plan may fit more; the count only steers
// the tile size), asked once per cs and kernel instance.
template <typename T, typename XP>
static int lf_active(int cs, int U) {
  static int cache[LF_MAX_CLUSTER + 1][2] = {};
  const int wide = lf_kernel<T, XP>(U) != lf_kernel<T, XP>(8);
  if (cache[cs][wide] == 0) {
    LfPlan p = {cs, 0, 0, 0, 0, 0, LF_SMEM_MAX, 1};
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int n = 0;
    if (lf_config<T, XP>(lf_kernel<T, XP>(U), p, nullptr, &cfg, &attr) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&n, lf_kernel<T, XP>(U), &cfg) !=
            cudaSuccess)
      return 0;
    cache[cs][wide] = n;
  }
  return cache[cs][wide];
}

// The plan of a launch at (H, B) in T, with x_proj in XP; false where none
// fits or the card runs no cluster of its size.
template <typename T, typename XP>
static bool lf_launch_plan(int H, int B, LfPlan* p, int* active) {
  int cs, U;
  lf_cluster(H, &cs, &U);
  *active = lf_active<T, XP>(cs, U);
  return *active > 0 && lf_plan(H, B, sizeof(T), *active, p);
}

template <typename T, typename XP>
static int launch(const void* wh, const void* xp, const void* c0,
                  const void* h0, void* hs, void* cf, void* hf, void* ifog,
                  void* cs, int L, int B, int H, int reverse,
                  cudaStream_t stream) {
  LfPlan p;
  int active;
  if (L < 1 || B < 1 || H < 2 || H % 2 ||
      !lf_launch_plan<T, XP>(H, B, &p, &active))
    return (int)cudaErrorInvalidValue;
  constexpr int XB = (sizeof(T) == 2 ? 2 : 1) * (int)sizeof(XP);
  if ((uintptr_t)wh % 4 || (uintptr_t)xp % XB)
    return (int)cudaErrorMisalignedAddress;
  // Wh in 16-byte copies where its rows allow
  const int wmode =
      H % (16 / (int)sizeof(T)) == 0 && (uintptr_t)wh % 16 == 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const LfKernel<T, XP> fn = lf_kernel<T, XP>(p.units);
  cudaError_t e = lf_config<T, XP>(fn, p, stream, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, fn, (const T*)wh,
                         (const XP*)xp, (const float*)c0, (const float*)h0,
                         (T*)hs, (float*)cf, (float*)hf, (T*)ifog, (T*)cs, L,
                         B, H, reverse, wmode, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, typename XP>
static int plan_out(int H, int B, int* out) {
  LfPlan p;
  int active;
  if (!lf_launch_plan<T, XP>(H, B, &p, &active))
    return (int)cudaErrorInvalidValue;
  const int v[9] = {p.cs, p.bt, p.units, p.kp, p.kres, p.kc, p.smem,
                    p.clusters, active};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

}  // namespace aocr

#define AOCR_LSTM_FWD_ARGS                                                 \
  const void *wh, const void *xp, int xp_is_f32, const void *c0,          \
      const void *h0, void *hs, void *cf, void *hf, void *ifog, void *cs, \
      int L, int B, int H, int reverse, void *stream

extern "C" int aocr_lstm_fwd_f32(AOCR_LSTM_FWD_ARGS) {
  if (!xp_is_f32) return (int)cudaErrorInvalidValue;
  return aocr::launch<float, float>(wh, xp, c0, h0, hs, cf, hf, ifog, cs, L,
                                    B, H, reverse, (cudaStream_t)stream);
}

extern "C" int aocr_lstm_fwd_bf16(AOCR_LSTM_FWD_ARGS) {
  if (xp_is_f32)
    return aocr::launch<__nv_bfloat16, float>(wh, xp, c0, h0, hs, cf, hf,
                                              ifog, cs, L, B, H, reverse,
                                              (cudaStream_t)stream);
  return aocr::launch<__nv_bfloat16, __nv_bfloat16>(
      wh, xp, c0, h0, hs, cf, hf, ifog, cs, L, B, H, reverse,
      (cudaStream_t)stream);
}

// The plan of a launch at (H, B): out[0..7] = cs, bt, units, kp, kres,
// kc, smem, clusters (as aocr_torch/ops/cuda/lstm_fwd.py::plan gives
// them for out[8]) and out[8] = the clusters of cs blocks the card runs
// at once (cudaOccupancyMaxActiveClusters).  Returns a CUDA error code.
extern "C" int aocr_lstm_fwd_plan(int H, int B, int is_f32, int xp_is_f32,
                                  int* out) {
  if (is_f32) return aocr::plan_out<float, float>(H, B, out);
  if (xp_is_f32) return aocr::plan_out<__nv_bfloat16, float>(H, B, out);
  return aocr::plan_out<__nv_bfloat16, __nv_bfloat16>(H, B, out);
}
