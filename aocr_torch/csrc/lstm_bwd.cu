// One encoder direction's LSTM backward recurrence, all L steps in one
// launch.
//
// Replaces aocr/ops/pallas/lstm_bwd.py::lstm_bwd_scan (pl.pallas_call at
// lstm_bwd.py:131).  From the residuals lstm_fwd.cu wrote in its collect
// mode (gate activations ifog, cell states cs, compute dtype) and the
// output cotangents, it carries only the recurrent (dh, dc) chain and
// emits the per-step pre-activation gate cotangents dgates (L, B, 4H) in
// the compute dtype (the TPU kernel's contract, lstm_bwd.py:104-112), plus
// the initial-state cotangents dh0, dc0 (float32).  dWh, dWi, db and dx
// are batched products over the whole sequence outside the kernel
// (aocr_torch/ops/lstm.py).
//
// The walk is the transpose of the forward's: L-1..0 for the forward
// encoder, 0..L-1 for the reversed one.  The previous cell state of each
// step is read from the cs stack (c0, rounded to the compute dtype, at
// the first step of the forward walk), so no shifted copy is made.  The
// gate backward runs in float32 (common.cuh's gate_math_bwd) and
// dh_prev = round_cd(dgates) @ Wh^T sums in float32.
//
// Two routes; the plan (lb_plan, mirrored by aocr_torch/ops/cuda/
// lstm_bwd.py::plan) picks one by dtype and shape.
//
// bf16, LB_CLUSTERS: a persistent RNN on thread-block clusters, as
// lstm_fwd.cu.  A cluster of cs blocks (16 SMs at H=512) owns bt batch
// rows for all L steps; block s owns the units [s U, (s+1) U), its (dh,
// dc) carries of them stay in shared memory, so the gate backward of its
// (row, unit) pairs is elementwise, and it keeps lstm_fwd's (H, 4U) slice
// of Wh (its four gate columns of each unit) in shared memory for the
// whole scan.  The product (bt x 4H) @ (4H x H) is split by the
// contraction: block s multiplies its own dgates columns, with no dgates
// exchange, into a float32 partial dh (bt x H), bf16 on the tensor cores
// (ldmatrix + mma.sync.m16n8k16, float32 accumulators, cluster_mma.cuh);
// the cs partials are reduce-scattered through a global scratch in L2
// (block s stores columns [d U, (d+1) U) of its partial where block d
// reads them, and sums its cs partials in block order).  A step: the gate
// backward from inputs loaded during the previous step's product, the
// product and the partials' stores, one cluster barrier (the partials
// delivered), the sums, and the arrive half of a barrier whose wait, a
// step later, keeps a block from storing into partials a peer still
// reads.  Clusters never wait on each other; a batch with more tiles
// than the card's resident clusters runs in waves.  Two other designs
// were measured on an H100 and dropped (PERF.md): the partials stored
// into the peers' shared memory (distributed shared memory), which needs
// a receive buffer beside the slice and so half the tile at H=512, 0.49
// ms against the L2 sums' 0.36 at B=400; and the product split by output
// columns (each block keeping its U rows of Wh and reading the tile's
// whole dgates back from L2 every step), 1.00 ms.
//
// float32, and bf16 where the slice does not fit (H > 640): LB_ROWS, the
// kernel of the first port.  A block owns LB_BT = 4 batch rows and all H
// columns; (dh, dc) stay float32 in shared memory; the product contracts
// Wh in its stored (H, 4H) orientation on the CUDA cores (no TF32), each
// warp taking LB_NR rows of Wh (mm_rows), streaming all of Wh from L2
// every step.
//
// Bound on the H100: the bytes and operations take ~0.03 ms (bf16 at
// B=400, L=24, H=512), an order below the kernel; a step's chain of
// latencies sets its time (gate backward, product with the partials'
// stores, barrier, sums; tools/lstm_bwd_phases_torch.py), as
// lstm_fwd.cu's.
#include "cluster_mma.cuh"
#include "common.cuh"

namespace aocr {

enum LbRoute { LB_ROWS = 0, LB_CLUSTERS = 1 };

constexpr int LB_THREADS = 256;
constexpr int LB_WARPS = LB_THREADS / 32;
constexpr int LB_SMEM_MAX = 232448;  // the H100's shared memory a block
constexpr int LB_MAX_CLUSTER = 16;   // non-portable cluster size
constexpr int LB_BT_MAX = 64;        // largest batch tile
constexpr int LB_PAIRS = 4;          // (row, unit pair)s a thread at most
// a step's cost that does not grow with the tile, in batch rows of the
// per-row cost (as lstm_fwd.cu's LF_STEP_ROWS)
constexpr int LB_STEP_ROWS = 32;
// the rows route
constexpr int LB_BT = 4;  // batch rows per block
// rows of Wh per warp pass: one shared-memory read of dgates serves 16
// rows (an A/B on an H100, PERF.md: 1.30 vs 2.55 ms bf16 with 4 rows)
constexpr int LB_NR = 16;

struct LbPlan {
  int route;     // LbRoute
  int cs;        // blocks (SMs) in a cluster; rows: 1
  int bt;        // batch rows a cluster (rows: a block)
  int units;     // hidden units a block, a multiple of 8 (rows: H)
  int smem;      // dynamic shared memory bytes a block
  int clusters;  // ceil(B / bt) (rows: blocks)
};

static int lb_round_up(int a, int m) { return (a + m - 1) / m * m; }

// The cluster for H: the smallest power of two that gives every block 8
// units or more, up to 16; U units a block, a multiple of 8 (the last
// blocks may own fewer, or none).  As lstm_fwd.cu's lf_cluster.
static void lb_cluster(int H, int* cs, int* U) {
  *cs = 1;
  while (*cs < LB_MAX_CLUSTER && *cs * 8 < H) *cs *= 2;
  *U = lb_round_up((H + *cs - 1) / *cs, 8);
}

// Shared memory of a cluster plan: the (H, 4U) slice and the tile's own
// dgates (bt x 4U) with 16 bytes of padding a row, the carries dh, dc (bt
// x U floats each).
static long lb_smem(int bt, int U, int H) {
  return (long)(H + bt) * 2 * (4 * U + 8) + 8L * bt * U;
}

// The launch plan for (H, B), the compute dtype's element size esz and
// the clusters of the cluster route's size the card runs at once
// (active): bf16 takes the clusters where the slice fits, else (and
// float32) the rows route; false where neither fits.  The clusters take
// the batch tile bt, a multiple of 16 up to 64 with at most LB_PAIRS
// (row, unit pair)s a thread, that fits and costs least, waves x (bt +
// LB_STEP_ROWS) with waves = ceil(clusters / active), the smaller on a
// tie.
static bool lb_plan(int H, int B, int esz, int active, LbPlan* p) {
  if (H < 16 || H % 16 || B < 1) return false;
  long best = -1;
  if (esz == 2 && active > 0) {
    int cs, U;
    lb_cluster(H, &cs, &U);
    for (int bt = 16; bt <= LB_BT_MAX && bt < B + 16; bt += 16) {
      const long smem = lb_smem(bt, U, H);
      if (bt * U / 2 > LB_PAIRS * LB_THREADS || smem > LB_SMEM_MAX) continue;
      const int clusters = (B + bt - 1) / bt;
      const long cost =
          (long)((clusters + active - 1) / active) * (bt + LB_STEP_ROWS);
      if (best >= 0 && cost >= best) continue;
      best = cost;
      *p = {LB_CLUSTERS, cs, bt, U, (int)smem, clusters};
    }
  }
  if (best >= 0) return true;
  const long smem = 4L * LB_BT * 6 * H;
  if (smem > LB_SMEM_MAX) return false;
  *p = {LB_ROWS, 1, LB_BT, H, (int)smem, (B + LB_BT - 1) / LB_BT};
  return true;
}

// ------------------------------------------------------------ the rows route

template <typename T>
__global__ void __launch_bounds__(LB_THREADS)
lstm_bwd_rows_kernel(const T* __restrict__ wh,       // (H, 4H)
                     const float* __restrict__ dhs,  // (L, B, H)
                     const T* __restrict__ ifog,     // (L, B, 4H)
                     const T* __restrict__ cs,       // (L, B, H)
                     const float* __restrict__ c0,   // (B, H)
                     const float* __restrict__ dcf,  // (B, H)
                     const float* __restrict__ dhf,  // (B, H)
                     T* __restrict__ dg,             // (L, B, 4H)
                     float* __restrict__ dh0, float* __restrict__ dc0,
                     int L, int B, int H, int reverse) {
  constexpr int BT = LB_BT, NR = LB_NR;
  extern __shared__ __align__(16) float sm[];
  const int G = 4 * H;
  float* dgs = sm;              // BT x 4H: round_cd(dgates), matmul operand
  float* dh = sm + BT * G;      // BT x H: dh carry
  float* dc = dh + BT * H;      // BT x H: dc carry
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, nwarps = nthr >> 5;
  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);

  for (int i = tid; i < BT * H; i += nthr) {
    const int r = i / H, j = i % H;
    const bool ok = r < nrows;
    const size_t g = (size_t)(b0 + r) * H + j;
    dh[i] = ok ? dhf[g] : 0.f;
    dc[i] = ok ? dcf[g] : 0.f;
  }
  __syncthreads();

  for (int s = 0; s < L; ++s) {
    const int t = reverse ? s : L - 1 - s;
    // the step the forward walk took just before t, and whether t was
    // its first step (then c_prev is c0)
    const int tp = reverse ? t + 1 : t - 1;
    const bool first = reverse ? t == L - 1 : t == 0;
    for (int i = tid; i < BT * H; i += nthr) {
      const int r = i / H, j = i % H;
      if (r >= nrows) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dgs[r * G + q * H + j] = 0.f;
        continue;
      }
      const size_t row = (size_t)t * B + b0 + r;
      const T* a = ifog + row * G;
      const float cp =
          first ? round_cd<T>(c0[(size_t)(b0 + r) * H + j])
                : to_f(cs[((size_t)tp * B + b0 + r) * H + j]);
      float d[4], dcp;
      gate_math_bwd(dh[i] + dhs[row * H + j], dc[i], to_f(a[j]),
                    to_f(a[H + j]), to_f(a[2 * H + j]), to_f(a[3 * H + j]),
                    to_f(cs[row * H + j]), cp, d, &dcp);
      dc[i] = dcp;
      T* o = dg + row * G;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const T v = from_f<T>(d[q]);
        o[q * H + j] = v;
        dgs[r * G + q * H + j] = to_f(v);
      }
    }
    __syncthreads();
    // dh <- round_cd(dgates) @ Wh^T
    for (int n0 = warp * NR; n0 < H; n0 += nwarps * NR) {
      float acc[NR][BT];
      mm_rows<T, BT, NR>(dgs, G, G, wh, G, n0, acc);
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int r = 0; r < BT; ++r)
          if (lane_stores(n, r, BT)) dh[r * H + n0 + n] = acc[n][r];
    }
    __syncthreads();
  }
  for (int i = tid; i < nrows * H; i += nthr) {
    const size_t g = (size_t)b0 * H + i;
    dh0[g] = dh[i];
    dc0[g] = dc[i];
  }
}


// --------------------------------------------------------- the cluster route

using bf16 = __nv_bfloat16;

struct LbArgs {
  const bf16* wh;    // (H, 4H)
  const float* dhs;  // (L, B, H)
  const bf16* ifog;  // (L, B, 4H)
  const bf16* cs;    // (L, B, H)
  const float *c0, *dcf, *dhf;  // (B, H)
  bf16* dg;                     // (L, B, 4H)
  float *dh0, *dc0;             // (B, H)
  float* scratch;  // (clusters, cs, cs, bt, U): the partials
  int L, B, H, reverse;
};

// Phase clock (thread 0 of each block), a no-op unless LB_PROBES is
// defined (tools/lstm_bwd_phases_torch.py builds with it): the cycles of
// each phase summed over the steps into lb_prof, the blocks counted in
// lb_prof[LB_NPHASES].
enum LbPhase {
  LB_GATE = 0,     // gate backward and its stores, the next step's loads
  LB_BARRIER = 1,  // cluster waits
  LB_SUMS = 2,     // the partials read back and summed
  LB_PRODUCT = 3,  // mma and the partials' stores
  LB_NPHASES = 4
};
#ifdef LB_PROBES
__device__ unsigned long long lb_prof[LB_NPHASES + 1];
struct LbClock {
  long long t;
  unsigned long long acc[LB_NPHASES];
  static __device__ __forceinline__ long long now() {
    long long c;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(c));
    return c;
  }
  __device__ LbClock() : t(now()) {
    for (int i = 0; i < LB_NPHASES; ++i) acc[i] = 0;
  }
  __device__ __forceinline__ void tick(int i) {
    const long long u = now();
    acc[i] += u - t;
    t = u;
  }
  __device__ void flush() {
    if (threadIdx.x != 0) return;
    for (int i = 0; i < LB_NPHASES; ++i) atomicAdd(&lb_prof[i], acc[i]);
    atomicAdd(&lb_prof[LB_NPHASES], 1ull);
  }
};
#else
struct LbClock {
  __device__ __forceinline__ void tick(int) {}
  __device__ __forceinline__ void flush() {}
};
#endif

// B fragments of two m16n8k16 products from a bf16 tile stored [n][k]
// row-major in shared memory (row stride ld): rows n0..n0+7 into
// b[0..1] and n0+8..n0+15 into b[2..3], columns k0..k0+15; rows past
// nmax read row nmax (their products are dropped).
__device__ __forceinline__ void ldmatrix_b_nk(uint32_t (&b)[4],
                                              const bf16* base, int ld,
                                              int n0, int k0, int nmax) {
  const int l = threadIdx.x & 31;
  const int n = min(n0 + (l & 7) + ((l >> 4) & 1) * 8, nmax);
  const bf16* p = base + (size_t)n * ld + k0 + ((l >> 3) & 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(smem_addr(p)));
}

// The block's share of its cluster's tile: rows [b0, b0 + nrows), units
// [j0, j0 + nu), and its (row, unit pair)s i = tid, tid + 256, ... below
// npairs (row i / np, units 2 (i % np), + 1).
struct LbBlock {
  int cl, rank, b0, nrows, j0, nu, np, npairs;
  __device__ LbBlock(const LbPlan& p, int B, int H) {
    cl = (int)blockIdx.x / p.cs;
    rank = (int)cg::this_cluster().block_rank();
    b0 = cl * p.bt;
    nrows = min(p.bt, B - b0);
    j0 = rank * p.units;
    nu = max(0, min(p.units, H - j0));
    np = nu / 2;
    npairs = nrows * np;
  }
};

// One (row, unit pair)'s gate-backward inputs at a step, as loaded (no
// conversion, so the loads stay in flight until the inputs are used).
struct LbIn {
  float2 dy;                 // dhs
  __nv_bfloat162 act[4], c;  // ifog's gates i, f, o, g and cs
  __nv_bfloat162 cpb;        // cs at the forward's previous step
  float2 c0;                 // c0, at the forward's first step
};

__device__ __forceinline__ bool lb_first(const LbArgs& a, int t) {
  return a.reverse ? t == a.L - 1 : t == 0;
}

// The thread's pairs' inputs at step t.
__device__ __forceinline__ void lb_load(const LbArgs& a, const LbBlock& k,
                                        int t, LbIn (&in)[LB_PAIRS]) {
  const int H = a.H, G = 4 * H;
  const bool first = lb_first(a, t);
  const int tp = a.reverse ? t + 1 : t - 1;
#pragma unroll
  for (int n = 0; n < LB_PAIRS; ++n) {
    const int i = threadIdx.x + n * LB_THREADS;
    if (i >= k.npairs) break;
    const int r = i / k.np, j = k.j0 + 2 * (i % k.np);
    const size_t row = (size_t)t * a.B + k.b0 + r;
    in[n].dy = *reinterpret_cast<const float2*>(a.dhs + row * H + j);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      in[n].act[q] =
          *reinterpret_cast<const __nv_bfloat162*>(a.ifog + row * G + q * H + j);
    in[n].c = *reinterpret_cast<const __nv_bfloat162*>(a.cs + row * H + j);
    if (first)
      in[n].c0 = *reinterpret_cast<const float2*>(a.c0 +
                                                  (size_t)(k.b0 + r) * H + j);
    else
      in[n].cpb = *reinterpret_cast<const __nv_bfloat162*>(
          a.cs + ((size_t)tp * a.B + k.b0 + r) * H + j);
  }
}

__global__ void __launch_bounds__(LB_THREADS, 1)
lstm_bwd_cluster_kernel(LbArgs a, LbPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, G = 4 * H, U = p.units, bt = p.bt, cs = p.cs;
  const LbBlock k(p, a.B, H);
  const int ld = 4 * U + 8;
  bf16* wres = reinterpret_cast<bf16*>(smem);  // H x ld: column qU + u is
                                               // Wh[:, qH + j0 + u]
  bf16* as = wres + (size_t)H * ld;            // bt x ld: own dgates
  float* dhc = reinterpret_cast<float*>(as + (size_t)bt * ld);  // bt x U
  float* dcc = dhc + bt * U;                                    // bt x U
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // block d's partials in the scratch: (source block, row, unit)
  auto recv_of = [&](int d) {
    return a.scratch + (size_t)(k.cl * cs + d) * cs * bt * U;
  };
  const float* mine = recv_of(k.rank);
  LbClock clk;

  // the slice (zeros past the block's units), zero own dgates (rows past
  // the tile's and units past the block's stay zero), the carries
  {
    const int per = 4 * U / 8;  // 16-byte pieces a slice row
    for (int i = tid; i < H * per; i += LB_THREADS) {
      const int kr = i / per, n = (i % per) * 8;
      const int q = n / U, u = n % U;
      const bool ok = u < k.nu;
      cp_async<16>(wres + kr * ld + n,
                   ok ? a.wh + (size_t)kr * G + q * H + k.j0 + u : a.wh,
                   ok ? 16 : 0);
    }
    cp_async_commit();
    uint4* z = reinterpret_cast<uint4*>(as);
    for (int i = tid; i < bt * ld / 8; i += LB_THREADS)
      z[i] = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < bt * U; i += LB_THREADS) {
      const int r = i / U, u = i % U;
      const bool ok = r < k.nrows && u < k.nu;
      const size_t g = (size_t)(k.b0 + r) * H + k.j0 + u;
      dhc[i] = ok ? a.dhf[g] : 0.f;
      dcc[i] = ok ? a.dcf[g] : 0.f;
    }
    cp_async_wait<0>();
  }
  LbIn in[LB_PAIRS];
  lb_load(a, k, a.reverse ? 0 : a.L - 1, in);
  // every block runs (and its carries are set) before any partials move
  cluster_barrier();

  const int mt = bt / 16, nt = H / 8, nq_n = (nt + 3) / 4;
  const int items = (mt + 1) / 2 * nq_n;
  for (int s = 0; s < a.L; ++s) {
    const int t = a.reverse ? s : a.L - 1 - s;
    const bool first = lb_first(a, t);
    // the gate backward of the thread's pairs: dgates rounded to the
    // stack and to own dgates, dc in place
#pragma unroll
    for (int n = 0; n < LB_PAIRS; ++n) {
      const int i = tid + n * LB_THREADS;
      if (i >= k.npairs) break;
      const int r = i / k.np, u = 2 * (i % k.np), j = k.j0 + u;
      const LbIn& x = in[n];
      float2 act[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) act[q] = __bfloat1622float2(x.act[q]);
      const float2 c = __bfloat1622float2(x.c);
      const float2 cp =
          first ? make_float2(round_cd<bf16>(x.c0.x), round_cd<bf16>(x.c0.y))
                : __bfloat1622float2(x.cpb);
      const float2 dh = *reinterpret_cast<const float2*>(dhc + r * U + u);
      float* dc = dcc + r * U + u;
      float d[4][2];
      {
        float g4[4], dcp;
        gate_math_bwd(dh.x + x.dy.x, dc[0], act[0].x, act[1].x, act[2].x,
                      act[3].x, c.x, cp.x, g4, &dcp);
        dc[0] = dcp;
#pragma unroll
        for (int q = 0; q < 4; ++q) d[q][0] = g4[q];
        gate_math_bwd(dh.y + x.dy.y, dc[1], act[0].y, act[1].y, act[2].y,
                      act[3].y, c.y, cp.y, g4, &dcp);
        dc[1] = dcp;
#pragma unroll
        for (int q = 0; q < 4; ++q) d[q][1] = g4[q];
      }
      const size_t row = (size_t)t * a.B + k.b0 + r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(d[q][0], d[q][1]);
        *reinterpret_cast<__nv_bfloat162*>(a.dg + row * G + q * H + j) = v;
        *reinterpret_cast<__nv_bfloat162*>(as + r * ld + q * U + u) = v;
      }
    }
    __syncthreads();
    // the next step's inputs load during this step's product
    if (s + 1 < a.L) lb_load(a, k, a.reverse ? s + 1 : a.L - 2 - s, in);
    clk.tick(LB_GATE);
    if (s > 0) cluster_wait();  // every block is done reading step s-1's
    clk.tick(LB_BARRIER);
    // partial dh = own dgates @ slice^T, by items of 2 m-tiles x 4
    // n-tiles; each (16-row, 8-column) tile goes to the block owning its
    // columns, at this block's source slot
    for (int it = warp; it < items; it += LB_WARPS) {
      const int m0 = (it / nq_n) * 2, n0 = (it % nq_n) * 4;
      float acc[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      for (int kk = 0; kk < 4 * U; kk += 16) {
        uint32_t af[2][4], bf[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          if (m0 + mi < mt)
            ldmatrix_a(af[mi], as + (m0 + mi) * 16 * ld + kk, ld);
        ldmatrix_b_nk(bf[0], wres, ld, n0 * 8, kk, H - 1);
        ldmatrix_b_nk(bf[1], wres, ld, n0 * 8 + 16, kk, H - 1);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            if (m0 + mi < mt && n0 + ni < nt)
              mma_bf16(acc[mi][ni], af[mi], bf[ni / 2][2 * (ni % 2)],
                       bf[ni / 2][2 * (ni % 2) + 1]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        if (n0 + ni >= nt) break;
        const int col = (n0 + ni) * 8, d = col / U;
        const int u = col - d * U + 2 * (lane & 3);
        float* dst = recv_of(d) + (size_t)k.rank * bt * U;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (m0 + mi >= mt) break;
          const int r = (m0 + mi) * 16 + (lane >> 2);
          const float* v = acc[mi][ni];
          *reinterpret_cast<float2*>(dst + r * U + u) = make_float2(v[0], v[1]);
          *reinterpret_cast<float2*>(dst + (r + 8) * U + u) =
              make_float2(v[2], v[3]);
        }
      }
    }
    clk.tick(LB_PRODUCT);
    cluster_barrier();  // every partial is delivered
    clk.tick(LB_BARRIER);
    // dh of the thread's pairs: the cs partials in block order, all loads
    // in flight before the sums
#pragma unroll
    for (int n = 0; n < LB_PAIRS; ++n) {
      const int i = tid + n * LB_THREADS;
      if (i >= k.npairs) break;
      const int r = i / k.np, u = 2 * (i % k.np);
      float2 w[LB_MAX_CLUSTER];
#pragma unroll
      for (int src = 0; src < LB_MAX_CLUSTER; ++src) {
        if (src >= cs) break;
        const float2* pp =
            reinterpret_cast<const float2*>(mine + (src * bt + r) * U + u);
        w[src] = __ldcg(pp);
      }
      float2 v = w[0];
#pragma unroll
      for (int src = 1; src < LB_MAX_CLUSTER; ++src) {
        if (src >= cs) break;
        v.x += w[src].x;
        v.y += w[src].y;
      }
      *reinterpret_cast<float2*>(dhc + r * U + u) = v;
    }
    cluster_arrive();
    clk.tick(LB_SUMS);
  }
  cluster_wait();
  // the initial-state cotangents of the thread's pairs
#pragma unroll
  for (int n = 0; n < LB_PAIRS; ++n) {
    const int i = tid + n * LB_THREADS;
    if (i >= k.npairs) break;
    const int r = i / k.np, u = 2 * (i % k.np);
    const size_t g = (size_t)(k.b0 + r) * H + k.j0 + u;
    *reinterpret_cast<float2*>(a.dh0 + g) =
        *reinterpret_cast<const float2*>(dhc + r * U + u);
    *reinterpret_cast<float2*>(a.dc0 + g) =
        *reinterpret_cast<const float2*>(dcc + r * U + u);
  }
  clk.flush();
}

// ---------------------------------------------------------------- launch

using LbKernel = void (*)(LbArgs, LbPlan);

static cudaError_t lb_config(LbKernel fn, const LbPlan& p,
                             cudaStream_t stream, cudaLaunchConfig_t* cfg,
                             cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) e = set_smem((const void*)fn, p.smem);
  *cfg = {};
  cfg->gridDim = dim3(p.clusters * p.cs);
  cfg->blockDim = dim3(LB_THREADS);
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
// memory a plan takes, asked once per cs.
static int lb_active(int cs) {
  static int cache[LB_MAX_CLUSTER + 1] = {};
  if (cache[cs] == 0) {
    LbPlan p = {LB_CLUSTERS, cs, 0, 0, LB_SMEM_MAX, 1};
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int n = 0;
    if (lb_config(lstm_bwd_cluster_kernel, p, nullptr, &cfg, &attr) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&n, lstm_bwd_cluster_kernel, &cfg) !=
            cudaSuccess)
      return 0;
    cache[cs] = n;
  }
  return cache[cs];
}

// The plan of a launch; false where none fits.  active: the clusters of
// the cluster route's size the card runs at once (asked for bf16).
static bool lb_launch_plan(int H, int B, int esz, LbPlan* p, int* active) {
  *active = 0;
  if (esz == 2 && H >= 16 && H % 16 == 0) {
    int cs, U;
    lb_cluster(H, &cs, &U);
    *active = lb_active(cs);
  }
  return lb_plan(H, B, esz, *active, p);
}

template <typename T>
static int launch(const void* wh, const void* dhs, const void* ifog,
                  const void* cs, const void* c0, const void* dcf,
                  const void* dhf, void* dg, void* dh0, void* dc0,
                  void* scratch, int L, int B, int H, int reverse,
                  cudaStream_t stream) {
  LbPlan p;
  int active;
  if (L < 1 || !lb_launch_plan(H, B, sizeof(T), &p, &active))
    return (int)cudaErrorInvalidValue;
  if (p.route == LB_ROWS) {
    auto* fn = lstm_bwd_rows_kernel<T>;
    cudaError_t e = set_smem((const void*)fn, p.smem);
    if (e != cudaSuccess) return (int)e;
    fn<<<p.clusters, LB_THREADS, p.smem, stream>>>(
        (const T*)wh, (const float*)dhs, (const T*)ifog, (const T*)cs,
        (const float*)c0, (const float*)dcf, (const float*)dhf, (T*)dg,
        (float*)dh0, (float*)dc0, L, B, H, reverse);
    return (int)cudaGetLastError();
  }
  if ((uintptr_t)wh % 16 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const LbArgs a = {(const bf16*)wh, (const float*)dhs, (const bf16*)ifog,
                    (const bf16*)cs, (const float*)c0, (const float*)dcf,
                    (const float*)dhf, (bf16*)dg, (float*)dh0, (float*)dc0,
                    (float*)scratch, L, B, H, reverse};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = lb_config(lstm_bwd_cluster_kernel, p, stream, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, lstm_bwd_cluster_kernel, a, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace aocr

#define AOCR_LSTM_BWD_ARGS                                                \
  const void *wh, const void *dhs, const void *ifog, const void *cs,     \
      const void *c0, const void *dcf, const void *dhf, void *dg,        \
      void *dh0, void *dc0, void *scratch, int L, int B, int H,          \
      int reverse, void *stream

extern "C" int aocr_lstm_bwd_f32(AOCR_LSTM_BWD_ARGS) {
  return aocr::launch<float>(wh, dhs, ifog, cs, c0, dcf, dhf, dg, dh0, dc0,
                             scratch, L, B, H, reverse, (cudaStream_t)stream);
}

extern "C" int aocr_lstm_bwd_bf16(AOCR_LSTM_BWD_ARGS) {
  return aocr::launch<__nv_bfloat16>(wh, dhs, ifog, cs, c0, dcf, dhf, dg,
                                     dh0, dc0, scratch, L, B, H, reverse,
                                     (cudaStream_t)stream);
}

// The plan of a launch at (H, B): out[0..5] = route, cs, bt, units, smem,
// clusters (as aocr_torch/ops/cuda/lstm_bwd.py::plan gives them for
// out[6]) and out[6] = the clusters of the cluster route's size the card
// runs at once (cudaOccupancyMaxActiveClusters; 0 for float32).  Returns
// a CUDA error code.
extern "C" int aocr_lstm_bwd_plan(int H, int B, int is_f32, int* out) {
  aocr::LbPlan p;
  int active;
  if (!aocr::lb_launch_plan(H, B, is_f32 ? 4 : 2, &p, &active))
    return (int)cudaErrorInvalidValue;
  const int v[7] = {p.route, p.cs, p.bt, p.units, p.smem, p.clusters, active};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}
