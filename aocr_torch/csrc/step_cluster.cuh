// One decoder step after the LSTM stack on a thread-block cluster, from
// the top hidden state to the picks: the cluster route of beam_step.cu
// (the top-K over each batch row's K beams) and of decode_step.cu (the
// greedy argmax, the same step at K = 1 with decode_tail.cuh's pick).
//
// A cluster of cs blocks (16 at H=1024) owns a tile of nb = bt / K whole
// batch rows with all K beams (bs_plan; batch rows past B leave the last
// tile ragged).  The blocks copy the tile's h rows into an exchange plane
// (block s its column range), then block s streams its column slices of
// [W_a | W_c[H:]] and of W_c[:H] (greedy_loop.py::pack_weights' wq and
// wc) from L2 through the ring of bulk copies and multiplies them with the
// tile's rows on the tensor cores in bf16 (mma.sync) or the CUDA cores in
// float32, so each weight element read serves the bt rows of a tile.  The
// attention, the logits and log-softmax and the picks are split by rows:
// block s owns rows [s R, (s+1) R) of the tile, R = ceil(bt / cs), which
// attend over their batch rows' context rows (the context is never
// replicated per beam; up to BS_GROUP beams of a row share each load of
// it).  The top-K is split by batch rows (beam_step.cu); the greedy pick
// is a warp a row.
#pragma once

#include "beam_tail.cuh"
#include "decoder_cluster.cuh"

namespace aocr {

// The row-split scratch of a tile with nb batch rows: R = ceil(bt / cs)
// own beam rows of q (H), scores (L) and logits (Vp) floats, then (over
// them) the scored candidates of Rb = ceil(nb / cs) own batch rows (K x
// Vp floats each).
__host__ __device__ inline long bs_rowsplit(const DcPlan& p, int nb, int K,
                                            int H, int L, int Vp) {
  const long R = (p.bt + p.cs - 1) / p.cs, Rb = (nb + p.cs - 1) / p.cs;
  const long f = R * (H + L + Vp), t = Rb * K * Vp;
  return dc_round_up((f > t ? f : t) * 4, 16);
}

// The shared memory of a plan: a region that holds the ring (stages sized
// for products of two column blocks) and, after the products, the
// row-split scratch (and as many staged context rows as fit); the float
// tile (bt x ldh) and the mbarriers.
static inline long bs_smem(const DcPlan& p, int nb, int K, int esz, int H,
                           int L, int Vp) {
  const DcGeom g = dc_geom(p, esz, 2);
  const long ring = (long)p.stages * g.stage * esz;
  const long rs = bs_rowsplit(p, nb, K, H, L, Vp);
  return (ring > rs ? ring : rs) + (long)p.bt * g.ldh * 4 + DC_BARS;
}

// A wave's cost past its rows' products, in rows (bf16, float32): the
// attention, the partial projector, the top-K and four cluster barriers
// weigh more against beam_step's two products than against a whole
// decoder step's (tools/beam_step_phases_torch.py), so fewer, fuller
// waves pay.
constexpr int BS_FIXED_ROWS[2] = {40, 20};
// beams whose attention a warp or a thread computes together
// (dc_attend_rows' G)
constexpr int BS_GROUP = 8;
// the h elements a thread loads at once into the exchange plane
constexpr int BS_PACK = 8;

// The launch plan for (H, B, K beams, esz, L, Vp) and the clusters the
// card runs at once (active): dc_beam_plan with bs_smem and BS_FIXED_ROWS;
// false where none fits (the rows route).
static inline bool bs_plan(int H, int B, int K, int esz, int L, int Vp,
                           int active, DcPlan* out, int* nb_out) {
  return dc_beam_plan(H, B, K, esz, active, BS_FIXED_ROWS,
                      [&](const DcPlan& q, int nb) {
                        return bs_smem(q, nb, K, esz, H, L, Vp);
                      },
                      out, nb_out);
}

// Byte offsets of the scratch regions (written before they are read; no
// zeroing): two exchange planes in the compute dtype (the tile's h rows,
// then the context vector; dc_plane's chunk-major layout), q (float32,
// rows clusters x bt, columns hs), the partial logits (clusters x cs x bt
// x V, float32) and the scored candidates (clusters x bt x V, float32);
// off[4] is the total.
__host__ __device__ inline void bs_scratch(const DcPlan& p, int esz, int H,
                                           int V, long (&off)[5]) {
  const long sizes[4] = {2 * dc_plane(p, esz, H) * esz,
                         (long)p.clusters * p.bt * dc_round_up(H, p.kc) * 4,
                         (long)p.clusters * p.cs * p.bt * V * 4,
                         (long)p.clusters * p.bt * V * 4};
  long at = 0;
  for (int i = 0; i < 4; ++i) {
    off[i] = at;
    at += dc_round_up(sizes[i], DC_ALIGN);
  }
  off[4] = at;
}

// The greedy step (decode_step.cu) takes K = 1, no scores, nsc for the
// picked log-probs (delta) and tok for the tokens.
struct BsArgs {
  const void* ctx;       // (L, B, H) compute dtype
  const void* h;         // (B K, H) compute dtype
  const int* prev;       // (B, K)
  const float* scores;   // (B, K); null for the greedy step
  const void* wq;        // [W_a | W_c[H:]] packed by block (pack_weights)
  const void* wcx;       // W_c[:H] packed by block
  const void* pw;        // (H, Vp)
  const float* pb;       // (Vp,)
  const float* valid;    // (B, K Vp) or null
  float* htilde;         // (B K, H)
  float* nsc;            // (B, K)
  int* par;              // (B, K)
  int* tok;              // (B, K)
  int* nvalid;           // (B,) or null
  unsigned char* scratch;  // bs_scratch's regions
  int L, B, H, Vp, V, K;
  int nb;  // batch rows a tile (the plan's)
};

#ifdef DC_PROBES
// the phases' cycles summed over the blocks, then the block count
__device__ unsigned long long bs_prof[DC_NPHASES + 1];
#endif

// RT: float32 rows a thread (DC_FMA_RT); bf16 instances take 1.  kG: the
// greedy step (K = 1): the argmax of decode_tail.cuh's projector_pick in
// place of the score add and the top-K.  kX:
// the top-K's candidates are exchanged through L2 (bs_exchange); an
// instance of its own, since that code, compiled in, slowed the products
// by a tenth on an H100.
template <typename T, int RT, bool kX, bool kG>
__global__ void __launch_bounds__(DC_THREADS, 1)
step_cluster_kernel(BsArgs a, DcPlan p) {
  constexpr int ESZ = (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const T* __restrict__ ctx = static_cast<const T*>(a.ctx);
  const T* __restrict__ pw = static_cast<const T*>(a.pw);
  const T* wq = static_cast<const T*>(a.wq);
  const T* wcx = static_cast<const T*>(a.wcx);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.H, K = a.K, V = a.V, Vp = a.Vp, L = a.L;

  const int cl = (int)blockIdx.x / p.cs;
  const int cb = cl * a.nb;                 // the tile's first batch row
  const int nbr = max(0, min(a.nb, a.B - cb));  // its real batch rows
  // block s owns R beam rows [s R, (s + 1) R) for the attention and the
  // candidates, and Rb batch rows [s Rb, (s + 1) Rb) for their top-K
  const int R = (p.bt + p.cs - 1) / p.cs, Rb = (a.nb + p.cs - 1) / p.cs;
  const DcBlock<T> b = dc_block<T>(p, H, cl, nbr * K, R, 2);
  const size_t gb0 = (size_t)cb * K + b.ra;  // own row 0's beam row

  // shared memory: the region (the ring; after the products the row-split
  // scratch, q rows, scores and logits, then staged context rows), the
  // float tile (h_top @ W_c[H:], then round_cd(h~)), the mbarriers
  const DcGeom g2 = dc_geom(p, ESZ, 2);
  const long ring_bytes = (long)p.stages * g2.stage * ESZ;
  const long rs_bytes = bs_rowsplit(p, a.nb, K, H, L, Vp);
  const long region = ring_bytes > rs_bytes ? ring_bytes : rs_bytes;
  float* ht = reinterpret_cast<float*>(smem + region);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ht + p.bt * b.g.ldh);
  DcRing<T> ring = {reinterpret_cast<T*>(smem), bars, 0, 0};
  float* qs = reinterpret_cast<float*>(smem);
  float* sc = qs + R * H;
  float* lg = sc + R * L;
  T* cbuf = reinterpret_cast<T*>(smem + rs_bytes);
  // as many of the context rows the own beam rows span as fit
  const int nst = (int)min((long)(R + K - 1) / K + 1,
                           (region - rs_bytes) / ((long)L * H * ESZ));

  long off[5];
  bs_scratch(p, ESZ, H, V, off);
  T* hp = reinterpret_cast<T*>(a.scratch + off[0]);
  T* cvp = hp + dc_plane(p, ESZ, H);
  float* qb = reinterpret_cast<float*>(a.scratch + off[1]);
  float* part = reinterpret_cast<float*>(a.scratch + off[2]);
  float* cand = reinterpret_cast<float*>(a.scratch + off[3]) +
                (size_t)cl * p.bt * V;
  const size_t at = b.atile();

  const DcTiles tl(p.units, p.rt);
  const DcFma fm(p.units, RT);
  DcClock clk;

  if (tid == 0) {
    for (int i = 0; i <= DC_MAX_STAGES; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the tile's h rows into the h plane, zeros on both planes' padding
  // (rows past the tile's real ones, columns past H): block s the columns
  // [s cw, (s + 1) cw), BS_PACK loads a thread in flight before their
  // stores (one at a time, their latency took ~5 us a launch)
  const T* __restrict__ hin = static_cast<const T*>(a.h) + (size_t)cb * K * H;
  const int cw = (b.hs + p.cs - 1) / p.cs;
  for (int i0 = tid; i0 < p.bt * cw; i0 += DC_THREADS * BS_PACK) {
    T v[BS_PACK];
#pragma unroll
    for (int k = 0; k < BS_PACK; ++k) {
      const int i = i0 + k * DC_THREADS, r = i / cw, j = b.rank * cw + i % cw;
      v[k] = i < p.bt * cw && r < b.nrows && j < H ? hin[(size_t)r * H + j]
                                                   : from_f<T>(0.f);
    }
#pragma unroll
    for (int k = 0; k < BS_PACK; ++k) {
      const int i = i0 + k * DC_THREADS, r = i / cw, j = b.rank * cw + i % cw;
      if (i >= p.bt * cw || j >= b.hs) continue;
      hp[b.aoff(r, j)] = v[k];
      if (r >= b.nrows || j >= H) cvp[b.aoff(r, j)] = from_f<T>(0.f);
    }
  }
  dc_publish();
  cluster_wait();
  clk.tick(DC_BARRIER);
  // q = h_top @ W_a and h_top @ W_c[H:]
  dc_query<T, RT>(hp + at, wq, qb, ht, b, ring, clk, tl, fm);
  // the attention of the own batch rows' beams (a greedy row alone on its
  // context row: greedy_loop's ungrouped form)
  dc_attend_rows<T, false, kG ? 1 : BS_GROUP>(ctx, L, a.B, qb, cvp, qs, sc,
                                              cbuf, nst, b, ring,
                                              (size_t)cb + b.ra / K, K,
                                              b.ra % K);
  clk.tick(DC_ATTEND);
  dc_publish();
  cluster_wait();
  clk.tick(DC_BARRIER);
  // h~ (float32, out) and the partial logits
  float* hout = a.htilde + (size_t)cb * K * H;
  dc_htilde_to<T, RT>(cvp + at, wcx, ht, pw, Vp, V, part, b, ring, region,
                      clk, tl, fm, [&](int r, int j, float h0, float h1) {
                        store2<float>(hout + (size_t)r * H + j, h0, h1);
                      });
  dc_logits<T>(part, a.pb, Vp, V, lg, b);
  if constexpr (kG) {
    // the own rows' log-softmax and freeze, then the argmax under the
    // plane (projector_pick's: the mask, then the freeze; ties to the
    // lowest index; an all-NaN row picks PAD): a warp a row
    for (int r = warp; r < b.nown; r += DC_WARPS) {
      const size_t gr = gb0 + r;
      float* x = lg + r * Vp;
      const int pv = a.prev[gr];
      const bool frozen = pv == PAD || pv == EOS;
      dc_logp_row(x, Vp, frozen);
      float best;
      int tk;
      dc_pick_row(x, Vp, frozen, [&](int v) {
        return a.valid == nullptr || a.valid[gr * Vp + v] > 0.f;
      }, &best, &tk);
      if (lane == 0) {
        a.tok[gr] = tk;
        a.nsc[gr] = best;
      }
    }
    clk.tick(DC_TAIL);
  } else {
    // the own beam rows' candidates: the log-softmax and freeze, the
    // beam's score added, NEG_BIG where the plane forbids; a warp a beam
    // row
    for (int r = warp; r < b.nown; r += DC_WARPS) {
      const size_t gr = gb0 + r;
      float* x = lg + r * Vp;
      const int pv = a.prev[gr];
      dc_logp_row(x, Vp, pv == PAD || pv == EOS);
      const float s = a.scores[gr];
      for (int v = lane; v < V; v += 32) {
        const bool ok = a.valid == nullptr || a.valid[gr * Vp + v] > 0.f;
        x[v] = ok ? s + x[v] : NEG_BIG;
      }
    }
    __syncthreads();
    clk.tick(DC_TAIL);
    // the top-K over K x V with refill: a warp a batch row, from the own
    // candidates, or from the whole tile's through L2
    const float* tot = lg;
    int ld = Vp, row0 = b.ra / K;
    if constexpr (kX) {
      for (int i = tid; i < b.nown * V; i += DC_THREADS)
        cand[(size_t)(b.ra + i / V) * V + i % V] = lg[(i / V) * Vp + i % V];
      dc_publish();
      cluster_wait();
      clk.tick(DC_BARRIER);
      for (int i = tid; i < Rb * K * V; i += DC_THREADS) {
        const int row = b.rank * Rb + i / (K * V);
        if (row < nbr)
          qs[i] = __ldcg(cand + (size_t)row * K * V + i % (K * V));
      }
      __syncthreads();
      tot = qs;
      ld = V;
      row0 = b.rank * Rb;
    }
    const int nrows = max(0, min(kX ? Rb : b.nown / K, nbr - row0));
    for (int bi = warp; bi < nrows; bi += DC_WARPS) {
      const size_t g = (size_t)(cb + row0 + bi) * K;
      const int nv = beam_topk_warp<kX>(
          const_cast<float*>(tot) + bi * K * ld, ld, K, V,
          a.valid != nullptr, a.nsc + g, a.par + g, a.tok + g);
      if (lane == 0 && a.nvalid != nullptr) a.nvalid[cb + row0 + bi] = nv;
    }
  }
  clk.tick(DC_TOPK);
#ifdef DC_PROBES
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < DC_NPHASES; ++i) atomicAdd(&bs_prof[i], dc_prof[i]);
    atomicAdd(&bs_prof[DC_NPHASES], 1ull);
  }
#endif
}

using BsKernel = void (*)(BsArgs, DcPlan);

// Whether a plan's top-K exchanges its candidates: a block's R =
// ceil(bt / cs) beam rows are not whole batch rows of K beams.
static inline bool bs_exchange(const DcPlan& p, int K) {
  return (p.bt + p.cs - 1) / p.cs % K != 0;
}

// The instance for a plan: bf16 one, float32 one per rows a thread.
template <bool kX, bool kG>
static BsKernel bs_kernel_x(int esz, int rt) {
  if (esz == 2) return step_cluster_kernel<__nv_bfloat16, 1, kX, kG>;
  if (rt == DC_FMA_RT[0])
    return step_cluster_kernel<float, DC_FMA_RT[0], kX, kG>;
  if (rt == DC_FMA_RT[1])
    return step_cluster_kernel<float, DC_FMA_RT[1], kX, kG>;
  return step_cluster_kernel<float, DC_FMA_RT[2], kX, kG>;
}

// The cluster plan of a launch of the kernel instances `probe` stands for
// (any of them: every instance holds one block a SM) and the clusters of
// its size the card runs at once; false where no plan fits (or the card
// runs no such cluster): the rows route.
static bool bs_launch_plan(BsKernel probe, int esz, int H, int B, int K,
                           int L, int Vp, DcPlan* p, int* nb, int* active) {
  int cs, U;
  dc_cluster(H, &cs, &U);
  *active = dc_active(probe, esz, cs);
  return *active > 0 && bs_plan(H, B, K, esz, L, Vp, *active, p, nb);
}

}  // namespace aocr
