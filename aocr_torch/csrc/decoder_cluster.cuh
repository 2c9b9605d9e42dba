// One input-feeding attention decoder step on a thread-block cluster: the
// pieces greedy_loop.cu and beam_loop.cu run, and the teacher-forced
// forward and backward of training (tf_fwd.cu, tf_bwd.cu).
//
// A cluster of cs blocks owns a tile of bt batch rows for a whole decode.
// Block s owns the hidden units [s*U, (s+1)*U) of every LSTM layer, with
// their four gate columns, and the same column range of W_a and W_c: a
// step's weight products are split by columns, so each block multiplies
// only its (K, 4U) or (K, U) slices (the backward: its (K, 2U) or (K, U)
// slices of the transposed weights).  The slices (~2.5 MB a step in bf16
// at H=1024, 2 layers, input feed; far more than a block's shared memory)
// stream from L2 through a ring of `stages` chunks of kc rows, with the
// tile's matching kc columns of the product's left operand beside them,
// each chunk bulk copies (the Tensor Memory Accelerator) onto the stage's
// mbarrier: the caller packs each block's weight slices contiguously
// (aocr_torch/ops/cuda/greedy_loop.py::pack_weights, DcSeg below), and
// the left operands live chunk-major (DcBlock::aoff), so a chunk of
// either is one run of bytes.  (cp.async by every thread, 16 bytes a
// copy, took longer a step to issue than the products took, on an H100;
// PERF.md.)
// bf16 multiplies on the tensor cores (ldmatrix + mma.sync.m16n8k16,
// float32 accumulators, cluster_mma.cuh), a warp holding up to DC_TILES
// (16-row, 8-unit) tiles of one unit group; float32 on the CUDA cores
// (FMA, no TF32), a thread holding rt rows x 2 units.
//
// What the blocks exchange goes through global memory (L2): a block
// stores its slice of a result, one cluster barrier (arrive.release /
// wait.acquire, with async-proxy fences for the bulk copies) makes every
// slice visible, and the readers load it back with bulk copies or
// ld.global.cg (never through L1).  The work that needs whole rows (the
// attention over the context and its backward, the log-softmax and the
// argmax) is split by rows instead: block s owns the tile rows [s*R,
// (s+1)*R), R = ceil(bt / cs); greedy_loop.cu splits the attention over a
// context too long to stage by positions.  The exchange buffers hold bt
// rows a cluster and H columns padded with zeros to hs = a multiple of kc.
//
// Numerics as decode_tail.cuh: every product operand rounded to the
// compute dtype, float32 sums; the gate math of common.cuh; q, the
// scores, alpha, the context vector before its rounding, h~ and the
// logits in float32 (the teacher-forced forward rounds q and alpha before
// their contractions, dc_attend_rows' kRoundQA).
#pragma once

#include <type_traits>

#include "cluster_mma.cuh"
#include "common.cuh"

namespace aocr {

constexpr int DC_THREADS = 256;
constexpr int DC_WARPS = DC_THREADS / 32;
constexpr int DC_SMEM_MAX = 232448;  // the H100's shared memory a block
constexpr int DC_MAX_CLUSTER = 16;   // non-portable cluster size
constexpr int DC_TILES = 5;          // (16-row, 8-unit) mma tiles a warp
constexpr int DC_MAX_UNITS = 512;    // units a block (float32: 2 a thread)
constexpr int DC_ALIGN = 256;        // bytes, scratch regions
constexpr int DC_MAX_STAGES = 4;     // chunks in the ring
constexpr int DC_BARS = 64;          // bytes of mbarriers: stages + 1

// The launch plan (dc_plan; mirrored by aocr_torch/ops/cuda/greedy_loop.py
// ::plan, field for field).
struct DcPlan {
  int cs;        // blocks (SMs) in a cluster
  int units;     // U: hidden units a block, a multiple of 8
  int bt;        // batch rows a cluster
  int rt;        // float32: rows a thread; bf16: m-tiles (bt / 16)
  int kc;        // rows of a streamed chunk (a multiple of 16)
  int stages;    // chunks in the ring (2..4)
  int cres;      // 1: the cell states c live in shared memory (else L2)
  int smem;      // dynamic shared memory bytes a block
  int clusters;  // ceil(B / bt)
};

__host__ __device__ inline long dc_round_up(long a, long m) {
  return (a + m - 1) / m * m;
}

// The cluster for H: the smallest power of two that gives every block 8
// units or more, up to 16; U units a block, a multiple of 8 (the last
// blocks may own fewer, or none).
static inline void dc_cluster(int H, int* cs, int* U) {
  *cs = 1;
  while (*cs < DC_MAX_CLUSTER && *cs * 8 < H) *cs *= 2;
  *U = dc_round_up((H + *cs - 1) / *cs, 8);
}

// The mma tiles warp w holds with G8 unit groups of 8 and MT m-tiles: at
// 8 groups or more a warp takes the groups w, w+8, ... with every m-tile;
// with fewer, 8 / G8 warps share a group and deal out its m-tiles.
__host__ __device__ inline int dc_warp_tiles(int w, int G8, int MT) {
  if (G8 >= DC_WARPS)
    return (G8 - w + DC_WARPS - 1) / DC_WARPS * MT;
  const int wpg = DC_WARPS / G8, sl = w / G8;
  if (w >= G8 * wpg || sl >= MT) return 0;
  return (MT - sl + wpg - 1) / wpg;
}

// Geometry of the rings and buffers for a plan: element counts.
struct DcGeom {
  int lda;    // A chunk row stride (kc + 16 bytes), also in global memory
  int ldw;    // the widest W chunk's row stride (nq U + 16 bytes)
  int ldh;    // row stride of the float tile of h~ (U + 8)
  int stage;  // elements of a stage: bt x lda + kc x ldw
  int R;      // tile rows a block owns in the row-split phases
};

// nq: the widest product's column blocks of U (4: the gates; the
// backward's widest is 2)
__host__ __device__ inline DcGeom dc_geom(const DcPlan& p, int esz,
                                          int nq = 4) {
  DcGeom g;
  g.lda = p.kc + 16 / esz;
  g.ldw = nq * p.units + 16 / esz;
  g.ldh = p.units + 8;
  g.stage = p.bt * g.lda + p.kc * g.ldw;
  g.R = (p.bt + p.cs - 1) / p.cs;
  return g;
}

// The shared memory of a plan: the ring, the float tile (bt x ldh), the
// cell states (bt x nl x U floats, with cres), bt tokens, 2R per-row
// words and the mbarriers; the row-split phases overlay their q rows,
// scores and logits (R x (H + L + Vp) floats), and layer 0's epilogue its
// emb_gates rows (bt x 4U floats), on the ring.  0 where an overlay does
// not fit.
__host__ __device__ inline long dc_cbytes(const DcPlan& p, int nl) {
  return p.cres ? (long)p.bt * nl * p.units * 4 : 0;
}
static inline long dc_smem(const DcPlan& p, int esz, int H, int L, int Vp,
                           int nl) {
  const DcGeom g = dc_geom(p, esz);
  const long ring = (long)p.stages * g.stage * esz;
  if ((long)g.R * (H + L + Vp) * 4 > ring ||
      (long)p.bt * 4 * p.units * 4 > ring)
    return 0;
  return ring + (long)p.bt * g.ldh * 4 + dc_cbytes(p, nl) +
         dc_round_up((long)p.bt * 4 + 2L * g.R * 4, 8) + DC_BARS;
}

// (kc, stages) in the order the plan tries them (dc_fit)
constexpr int DC_NCHUNKS = 11;
constexpr int DC_CHUNKS[DC_NCHUNKS][2] = {
    {128, 3}, {64, 4}, {128, 2}, {64, 3}, {32, 4}, {32, 3},
    {16, 4},  {16, 3}, {64, 2},  {32, 2}, {16, 2}};
// float32 rows a thread: the kernel's instances
constexpr int DC_FMA_RT[3] = {1, 4, 10};
// a step's cost in batch rows of its per-row part: the weight stream
// sets a floor (stream_rows) under the tile's product, and the barriers,
// attention and tail add fixed_rows (from the phase timings on an H100,
// tools/greedy_loop_phases_torch.py)
constexpr int DC_STREAM_ROWS[2] = {40, 10};  // bf16, float32
constexpr int DC_FIXED_ROWS[2] = {10, 2};

// Tile option opt of a dtype: bf16 16 x rt rows (rt = opt + 1, at most
// DC_TILES mma tiles a warp), float32 rg x rt rows (rg = 256 / (U / 2) row
// groups, rt = DC_FMA_RT[opt]); false where the option does not exist.
static inline bool dc_tile(int opt, int U, int f32, int* bt, int* rt) {
  if (f32) {
    if (opt >= 3) return false;
    *rt = DC_FMA_RT[opt];
    *bt = DC_THREADS / (U / 2) * *rt;
    return true;
  }
  *rt = opt + 1;
  *bt = 16 * *rt;
  return opt < DC_TILES && dc_warp_tiles(0, U / 8, *rt) <= DC_TILES;
}

// The first (cres, kc, stages) of DC_CHUNKS, the cell states in shared
// memory first, whose shared memory smem(p) (0: an overlay does not fit)
// fits a block, into p (smem too); false where none does.  Chunks of 128
// rows are skipped where H (rounded to 16) is less.
template <typename Smem>
static inline bool dc_fit(DcPlan* p, int H, Smem smem) {
  for (int c = 0; c < 2 * DC_NCHUNKS; ++c) {
    p->cres = c < DC_NCHUNKS;
    p->kc = DC_CHUNKS[c % DC_NCHUNKS][0];
    p->stages = DC_CHUNKS[c % DC_NCHUNKS][1];
    if (p->kc > 64 && p->kc > dc_round_up(H, 16)) continue;
    const long n = smem(*p);
    if (n > 0 && n <= DC_SMEM_MAX) {
      p->smem = (int)n;
      return true;
    }
  }
  return false;
}

// The launch plan for (H, B, esz) whose shared memory smem(p) gives (0
// where an overlay does not fit), and the clusters of that size the card
// runs at once (active); false where none fits.  Of the tiles (dc_tile),
// the one that costs least, waves x (max(bt, stream rows) + fixed rows)
// with waves = ceil(clusters / active), the smaller on a tie, with
// dc_fit's chunks.
template <typename Smem>
static inline bool dc_plan_fit(int H, int B, int esz, int active, Smem smem,
                               DcPlan* out) {
  int cs, U;
  dc_cluster(H, &cs, &U);
  if (U > DC_MAX_UNITS || active < 1) return false;
  const int f32 = esz == 4;
  long best = -1;
  int prev_bt = 0;
  for (int opt = 0; opt < DC_TILES; ++opt) {
    int bt, rt;
    if (!dc_tile(opt, U, f32, &bt, &rt)) continue;
    if (prev_bt >= B) break;  // a smaller tile already holds the batch
    prev_bt = bt;
    DcPlan p = {cs, U, bt, rt, 0, 0, 0, 0, (B + bt - 1) / bt};
    if (!dc_fit(&p, H, smem)) continue;
    const long waves = (p.clusters + active - 1) / active;
    const long cost =
        waves * ((bt > DC_STREAM_ROWS[f32] ? bt : DC_STREAM_ROWS[f32]) +
                 DC_FIXED_ROWS[f32]);
    if (best >= 0 && cost >= best) continue;
    best = cost;
    *out = p;
  }
  return best >= 0;
}

// The plan of the beam kernels (beam_loop.cu, beam_step.cu) for (H, B, K
// beams, esz) whose shared memory smem(p, nb) gives (0 where an overlay
// does not fit) with nb = bt / K batch rows a tile, and the clusters of
// that size the card runs at once (active): of dc_tile's tiles that hold
// a batch row's K beams, the one that costs least, waves x (max(nb K,
// stream rows) + fixed[f32]) with waves = ceil(clusters / active),
// clusters = ceil(B / nb), the smaller on a tie, with dc_fit's chunks;
// false where none fits.  fixed: a wave's cost past its rows' products,
// in rows (bf16, float32).
template <typename Smem>
static inline bool dc_beam_plan(int H, int B, int K, int esz, int active,
                                const int (&fixed)[2], Smem smem,
                                DcPlan* out, int* nb_out) {
  int cs, U;
  dc_cluster(H, &cs, &U);
  if (U > DC_MAX_UNITS || active < 1 || K < 1) return false;
  const int f32 = esz == 4;
  long best = -1;
  int prev_nb = 0;
  for (int opt = 0; opt < DC_TILES; ++opt) {
    int bt, rt;
    if (!dc_tile(opt, U, f32, &bt, &rt) || bt < K) continue;
    const int nb = bt / K;
    if (prev_nb >= B) break;  // a smaller tile already holds the batch
    prev_nb = nb;
    DcPlan p = {cs, U, bt, rt, 0, 0, 0, 0, (B + nb - 1) / nb};
    if (!dc_fit(&p, H, [&](const DcPlan& q) { return smem(q, nb); }))
      continue;
    const long waves = (p.clusters + active - 1) / active;
    const int rows = nb * K;
    const long cost =
        waves * ((rows > DC_STREAM_ROWS[f32] ? rows : DC_STREAM_ROWS[f32]) +
                 fixed[f32]);
    if (best >= 0 && cost >= best) continue;
    best = cost;
    *out = p;
    *nb_out = nb;
  }
  return best >= 0;
}

// The decode kernels' plan for (H, B, esz, L, Vp, nl layers): dc_smem's
// shared memory.
static inline bool dc_plan(int H, int B, int esz, int L, int Vp, int nl,
                           int active, DcPlan* out) {
  return dc_plan_fit(H, B, esz, active, [&](const DcPlan& q) {
    return dc_smem(q, esz, H, L, Vp, nl);
  }, out);
}

// Byte offsets of the scratch regions (zeroed by the caller) of a launch:
// the exchange buffers in the compute dtype (h~ x 2, h_l x 2 for each
// layer, by step parity, and the context vector; each a plane of
// dc_aoff's chunk-major layout), q (float32, rows bp = clusters x bt,
// columns hs), the block-private cell states c (bp x nl x H, float32),
// the partial logits (clusters x cs x bt x V, float32) and the tokens
// (int32); off[5] is the total.
__host__ __device__ inline long dc_plane(const DcPlan& p, int esz, int H) {
  return (long)p.clusters * (dc_round_up(H, p.kc) / p.kc) * p.bt *
         (p.kc + 16 / esz);
}
__host__ __device__ inline void dc_scratch(const DcPlan& p, int esz, int H,
                                           int nl, int V, long (&off)[6]) {
  const long bp = (long)p.clusters * p.bt;
  const long hs = dc_round_up(H, p.kc);
  const long sizes[5] = {(3L + 2 * nl) * dc_plane(p, esz, H) * esz,
                         bp * hs * 4,
                         bp * nl * H * 4,
                         (long)p.clusters * p.cs * p.bt * V * 4, bp * 4};
  long at = 0;
  for (int i = 0; i < 5; ++i) {
    off[i] = at;
    at += dc_round_up(sizes[i], DC_ALIGN);
  }
  off[5] = at;
}

// Per-block view of the plan and the buffers.
template <typename T>
struct DcBlock {
  int H, U, j0, nu;  // units: this block owns [j0, j0 + nu)
  int b0, nrows;     // the tile's first batch row and its real rows
  int bt, kc, stages, hs, rank;
  int ra, nown;      // owned tile rows [ra, ra + nown) (row-split phases)
  int nch, kshift;   // chunks over hs; log2(kc)
  int cl, cs;        // the cluster's index (its tile); its blocks
  DcGeom g;

  // Element (tile row r, column j) of an exchange plane in the chunk-major
  // layout: the tile's chunk j / kc is bt rows of lda (kc + padding)
  // columns, so a chunk of the left operand is one run of bytes, laid out
  // as the ring's A chunk.
  __device__ __forceinline__ size_t aoff(int r, int j) const {
    return ((size_t)(cl * nch + (j >> kshift)) * bt + r) * g.lda +
           (j & (kc - 1));
  }
  // the first element of the tile's chunk 0 in a plane
  __device__ __forceinline__ size_t atile() const {
    return (size_t)cl * nch * bt * g.lda;
  }
};

// A product segment: the tile's left operand a (its chunk 0 in an
// exchange plane, chunk-major: chunk c at a + c * bt * lda) against the
// block's packed weight slice w (chunk c at w + c * kc * ldw: kc rows of
// ldw elements, NQ column blocks of U and 16 bytes of zeros; rows past H
// and units past nu zero).
template <typename T>
struct DcSeg {
  const T* a;
  const T* w;
  int ldw;
};

// The ring: the stages' shared memory and mbarriers, and the chunks
// issued so far (uniform across the block), which sets each stage's phase.
template <typename T>
struct DcRing {
  T* base;
  uint64_t* bar;  // DC_MAX_STAGES for the stages, one for the attention
  int seq;        // chunks issued so far
  int aseq;       // the single-copy mbarrier's uses so far
};

// Phase clock: tick(i) adds the cycles since the last tick to phase i,
// thread 0 of each block into shared memory.  A no-op unless DC_PROBES is
// defined (the phase tool builds with it).
enum DcPhase {
  DC_PRODUCT = 0,   // mma / FMA on landed chunks
  DC_STREAM = 1,    // waiting for a chunk (cp.async + the block barrier)
  DC_EPILOGUE = 2,  // gate math, q / h~ stores
  DC_ATTEND = 3,    // the row-split attention
  DC_TAIL = 4,      // the row-split log-softmax, argmax, tokens
  DC_BARRIER = 5,   // cluster waits
  DC_READBACK = 6,  // the tokens read back after the barrier
  DC_ISSUE = 7,     // issuing a chunk's copies
  DC_PROJ = 8,      // the partial projector
  DC_TOPK = 9,      // beams: the scored candidates and the top-K
  DC_PERMUTE = 10,  // beams: accumulators and cell states to parent rows
  DC_NPHASES = 11
};
#ifdef DC_PROBES
__shared__ unsigned long long dc_prof[DC_NPHASES];
#endif
struct DcClock {
#ifdef DC_PROBES
  long long t;
  static __device__ __forceinline__ long long now() {
    long long c;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(c));
    return c;
  }
  __device__ DcClock() : t(now()) {
    if (threadIdx.x < DC_NPHASES) dc_prof[threadIdx.x] = 0;
  }
  __device__ __forceinline__ void tick(int i) {
    const long long u = now();
    if (threadIdx.x == 0) dc_prof[i] += u - t;
    t = u;
  }
#else
  __device__ __forceinline__ void tick(int) {}
#endif
};

// Stream one segment through the ring: compute(sa, sw) on each chunk in
// order while the next stages - 1 chunks load, each chunk bulk copies
// onto its stage's mbarrier: lane 0 of each warp copies kc / warps of the
// weight rows (the copies' issue is spread over the warps), warp 0 also
// the left operand.  Starts with an async-proxy fence (the segment's
// operand was written by generic stores published by a cluster barrier,
// and the ring by generic stores of the row-split phases) and a
// __syncthreads; ends with a __syncthreads (the ring is free on exit).
template <typename T, typename Compute>
__device__ __forceinline__ void dc_stream(const DcSeg<T>& s,
                                          const DcBlock<T>& b,
                                          DcRing<T>& ring, DcClock& clk,
                                          Compute compute) {
  const uint32_t abytes = (uint32_t)(b.bt * b.g.lda * sizeof(T));
  const uint32_t wbytes = (uint32_t)(b.kc * s.ldw * sizeof(T));
  const int seq0 = ring.seq;
  fence_proxy_async();
  __syncthreads();
  const int warp = threadIdx.x >> 5, wrows = b.kc / DC_WARPS;
  const uint32_t wpart = (uint32_t)(wrows * s.ldw * sizeof(T));
  auto issue = [&](int c) {
    if ((threadIdx.x & 31) == 0 && c < b.nch) {
      const int st = (seq0 + c) % b.stages;
      T* sa = ring.base + (size_t)st * b.g.stage;
      if (warp == 0) {
        mbar_expect_tx(ring.bar + st, abytes + wbytes);
        bulk_copy(sa, s.a + (size_t)c * b.bt * b.g.lda, abytes,
                  ring.bar + st);
      }
      bulk_copy(sa + b.bt * b.g.lda + warp * wrows * s.ldw,
                s.w + ((size_t)c * b.kc + warp * wrows) * s.ldw, wpart,
                ring.bar + st);
    }
  };
  for (int c = 0; c < b.stages - 1; ++c) issue(c);
  for (int c = 0; c < b.nch; ++c) {
    const int q = seq0 + c, st = q % b.stages;
    mbar_wait(ring.bar + st, (q / b.stages) & 1);
    __syncthreads();  // every thread is done with chunk c - 1's stage
    clk.tick(DC_STREAM);
    issue(c + b.stages - 1);
    clk.tick(DC_ISSUE);
    const T* sa = ring.base + (size_t)st * b.g.stage;
    compute(sa, sa + b.bt * b.g.lda);
    clk.tick(DC_PRODUCT);
  }
  ring.seq = seq0 + b.nch;
  __syncthreads();
}

// ---------------------------------------------------------------- bf16

// The mma tiles of this warp: tile i is unit group g[i] (units 8g..8g+7
// of each column block) and m-tile m[i] (rows 16m..16m+15); n of them, in
// ng unit groups (1 unless the block has more groups than warps).
struct DcTiles {
  int n, ng;
  int g[DC_TILES], m[DC_TILES];
  __device__ DcTiles(int U, int MT) {
    const int w = threadIdx.x >> 5, G8 = U / 8;
    n = dc_warp_tiles(w, G8, MT);
    ng = G8 > DC_WARPS ? (n + MT - 1) / MT : 1;
#pragma unroll
    for (int i = 0; i < DC_TILES; ++i) {
      if (G8 >= DC_WARPS) {
        g[i] = w + DC_WARPS * (i / MT);
        m[i] = i % MT;
      } else {
        g[i] = w % G8;
        m[i] = w / G8 + i * (DC_WARPS / G8);
      }
    }
  }
};

// acc[i][q*4 + e] += A @ W over one chunk (kc rows) for the warp's tiles:
// A the tile's rows in sa (row stride lda), W's NQ column blocks in sw
// (row stride ldw, block q at column q*U).  Each 16-deep step loads all
// the warp's A fragments and its B fragments before the mma chain (the
// asm statements keep their order).  With one unit group (the plans up
// to 8 groups a block) B is loaded once a step into registers no mma of
// the step overwrites: a B reload between two tiles' mmas waits for the
// first tile's mmas to read their operands, which serialized the chain
// (a third of the tensor-core rate on an H100).
template <int NQ>
__device__ __forceinline__ void dc_mma_chunk(
    float (&acc)[DC_TILES][NQ * 4], const __nv_bfloat16* sa, int lda,
    const __nv_bfloat16* sw, int ldw, int kc, int U, const DcTiles& tl) {
  auto load_b = [&](uint32_t(&bf)[8], const __nv_bfloat16* wr, int g8) {
    uint32_t b4[4];
    ldmatrix_b2(b4, wr, ldw, g8, NQ > 1 ? U + g8 : g8);
#pragma unroll
    for (int e = 0; e < 4; ++e) bf[e] = b4[e];
    if (NQ == 4) {
      ldmatrix_b2(b4, wr, ldw, 2 * U + g8, 3 * U + g8);
#pragma unroll
      for (int e = 0; e < 4; ++e) bf[4 + e] = b4[e];
    }
  };
  if (tl.ng == 1 && tl.n == 1) {
    // one tile: four chains of accumulators (acc[0..3], 16-deep steps in
    // turn; dc_mma_fold sums them), so consecutive mmas do not wait for
    // each other
    const int g8 = 8 * tl.g[0];
    const __nv_bfloat16* at = sa + tl.m[0] * 16 * lda;
#pragma unroll 1
    for (int k0 = 0; k0 < kc; k0 += 64) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kk = k0 + 16 * c;
        if (kk >= kc) break;
        uint32_t a[4], bf[8];
        ldmatrix_a(a, at + kk, lda);
        load_b(bf, sw + kk * ldw, g8);
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          mma_bf16(acc[c] + 4 * q, a, bf[2 * q], bf[2 * q + 1]);
      }
    }
    return;
  }
  if (tl.ng == 1) {
    const int g8 = 8 * tl.g[0];
#pragma unroll 2
    for (int kk = 0; kk < kc; kk += 16) {
      uint32_t a[DC_TILES][4], bf[8];
#pragma unroll
      for (int i = 0; i < DC_TILES; ++i)
        if (i < tl.n) ldmatrix_a(a[i], sa + tl.m[i] * 16 * lda + kk, lda);
      load_b(bf, sw + kk * ldw, g8);
#pragma unroll
      for (int i = 0; i < DC_TILES; ++i) {
        if (i >= tl.n) break;
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          mma_bf16(acc[i] + 4 * q, a[i], bf[2 * q], bf[2 * q + 1]);
      }
    }
    return;
  }
#pragma unroll 1
  for (int kk = 0; kk < kc; kk += 16) {
    uint32_t a[DC_TILES][4];
#pragma unroll
    for (int i = 0; i < DC_TILES; ++i)
      if (i < tl.n) ldmatrix_a(a[i], sa + tl.m[i] * 16 * lda + kk, lda);
    uint32_t bf[8];
    int gl = -1;
#pragma unroll
    for (int i = 0; i < DC_TILES; ++i) {
      if (i >= tl.n) break;
      if (tl.g[i] != gl) {
        gl = tl.g[i];
        load_b(bf, sw + kk * ldw, 8 * gl);
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        mma_bf16(acc[i] + 4 * q, a[i], bf[2 * q], bf[2 * q + 1]);
    }
  }
}

// A one-tile warp's four chains (dc_mma_chunk) summed into acc[0], in
// chain order; a no-op for warps with more tiles.
template <int NQ>
__device__ __forceinline__ void dc_mma_fold(float (&acc)[DC_TILES][NQ * 4],
                                            const DcTiles& tl) {
  if (tl.ng != 1 || tl.n != 1) return;
#pragma unroll
  for (int e = 0; e < NQ * 4; ++e)
    acc[0][e] = ((acc[0][e] + acc[1][e]) + acc[2][e]) + acc[3][e];
}

// Calls f(r, u, v) for each (tile row r, unit u, u + 1) pair this thread
// holds in the warp's mma tiles, v[q][e] the accumulator of column block q
// at unit u + e.
template <int NQ, typename F>
__device__ __forceinline__ void dc_mma_pairs(
    const float (&acc)[DC_TILES][NQ * 4], const DcTiles& tl, F f) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < DC_TILES; ++i) {
    if (i >= tl.n) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[NQ][2];
#pragma unroll
      for (int q = 0; q < NQ; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) v[q][e] = acc[i][q * 4 + h * 2 + e];
      f(tl.m[i] * 16 + (lane >> 2) + 8 * h, 8 * tl.g[i] + 2 * (lane & 3), v);
    }
  }
}

// ---------------------------------------------------------------- float32

// acc[i][q][e] += A @ W over one chunk for this thread's rows r0..r0+RT-1
// and units u, u + 1 (CUDA cores, k in order).
template <int RT, int NQ>
__device__ __forceinline__ void dc_fma_chunk(float (&acc)[RT][NQ][2],
                                             const float* sa, int lda,
                                             const float* sw, int ldw, int kc,
                                             int U, int r0, int u) {
  const float* ar = sa + r0 * lda;
  const float* wr = sw + u;
#pragma unroll 4
  for (int k = 0; k < kc; ++k) {
    float2 w[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      w[q] = *reinterpret_cast<const float2*>(wr + k * ldw + q * U);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float x = ar[i * lda + k];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        acc[i][q][0] = fmaf(x, w[q].x, acc[i][q][0]);
        acc[i][q][1] = fmaf(x, w[q].y, acc[i][q][1]);
      }
    }
  }
}

// ---------------------------------------------------------------- row split

// V consecutive values at p as floats (V = 4; p aligned to 4 elements)
__device__ __forceinline__ void load4_cg(const float* p, float (&o)[4]) {
  const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Stage the context rows crow .. crow + mc - 1 (L x H each; position l of
// the c-th at cbuf + (c L + l) H) in shared memory: one bulk copy a (row,
// l) onto the ring's last mbarrier, all in flight at once, issued by warp
// 0, or cp.async in 8-byte pieces, a warp a (row, l), where a context row
// is not a multiple of 16 bytes.  The caller __syncthreads after.
template <typename T>
__device__ __forceinline__ void dc_stage_context(const T* __restrict__ ctx,
                                                 int L, int B, int H,
                                                 size_t crow, int mc, T* cbuf,
                                                 DcRing<T>& ring) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t rowb = (uint32_t)(H * sizeof(T));
  auto src = [&](int cl) {
    return ctx + ((size_t)(cl % L) * B + crow + cl / L) * H;
  };
  if (rowb % 16 == 0) {
    uint64_t* bar = ring.bar + DC_MAX_STAGES;
    fence_proxy_async();
    __syncthreads();
    if (warp == 0) {
      if (lane == 0) mbar_expect_tx(bar, (uint32_t)(mc * L) * rowb);
      __syncwarp();
      for (int cl = lane; cl < mc * L; cl += 32)
        bulk_copy(cbuf + (size_t)cl * H, src(cl), rowb, bar);
    }
    mbar_wait(bar, ring.aseq & 1);
    ++ring.aseq;
  } else {
    const int per = (int)rowb / 8;
    for (int cl = warp; cl < mc * L; cl += DC_WARPS) {
      const char* from = reinterpret_cast<const char*>(src(cl));
      char* to = reinterpret_cast<char*>(cbuf + (size_t)cl * H);
      for (int k = lane; k < per; k += 32)
        cp_async<8>(to + 8 * k, from + 8 * k, 8);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }
}

// dc_attend_rows' scores, softmax and context vectors for one pass of
// its own rows [r0, r0 + m), kg rows a context row (mc of them, the c-th
// that of the pass's rows [off + c kg, off + (c + 1) kg); row r's at
// cbase(r - r0), position l a further l cst), up to G rows of a context
// row at a time: a warp takes a (context row, l) and the rows'
// dot products together, a thread 4 columns of a context row and the
// rows' sums over l together.  The same operations in the same order as
// dc_attend_rows' own loops.  Ends with a __syncthreads.
template <typename T, bool kRoundQA, int G, typename Base>
__device__ __forceinline__ void dc_attend_grouped(int L, int H,
                                                  const float* qs, float* sc,
                                                  T* cv, const DcBlock<T>& b,
                                                  int r0, int m, int kg,
                                                  int off, int mc, Base cbase,
                                                  size_t cst) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H4 = H / 4;
  for (int p = warp; p < mc * L; p += DC_WARPS) {
    const int c = p / L, l = p % L;
    const int ra = max(off + c * kg, 0), rb = min(off + (c + 1) * kg, m);
    const T* cr = cbase(ra) + l * cst;
    for (int g0 = ra; g0 < rb; g0 += G) {
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
      for (int h = 4 * lane; h < H; h += 128) {
        float x[4];
        load_row(cr + h, x);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g0 + g >= rb) break;
          // one 16-byte load a lane (4-byte loads at a 16-byte stride
          // share banks four ways)
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + (r0 + g0 + g) * H + h);
          const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) s[g] = fmaf(x[e], qr[e], s[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g0 + g >= rb) break;
        const float v = warp_sum(s[g]);
        if (lane == 0) sc[(r0 + g0 + g) * L + l] = v;
      }
    }
  }
  __syncthreads();
  // alpha = softmax over L: a warp a row
  for (int r = warp; r < m; r += DC_WARPS) {
    float* a = sc + (r0 + r) * L;
    float mx = -INFINITY;
    for (int l = lane; l < L; l += 32) mx = fmaxf(mx, a[l]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int l = lane; l < L; l += 32) {
      const float e = expf(a[l] - mx);
      a[l] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int l = lane; l < L; l += 32) a[l] = a[l] / sum;
  }
  __syncthreads();
  // context vectors = sum_l alpha * ctx, float32, rounded
  for (int i = tid; i < mc * H4; i += DC_THREADS) {
    const int c = i / H4, h = (i % H4) * 4;
    const int ra = max(off + c * kg, 0), rb = min(off + (c + 1) * kg, m);
    const T* cr = cbase(ra) + h;
    for (int g0 = ra; g0 < rb; g0 += G) {
      float v[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[g][e] = 0.f;
      for (int l = 0; l < L; ++l) {
        float x[4];
        load_row(cr + l * cst, x);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g0 + g >= rb) break;
          const float a = sc[(r0 + g0 + g) * L + l];
          const float al = kRoundQA ? round_cd<T>(a) : a;
#pragma unroll
          for (int e = 0; e < 4; ++e) v[g][e] = fmaf(al, x[e], v[g][e]);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g0 + g >= rb) break;
        store4(cv + b.aoff(b.ra + r0 + g0 + g, h), v[g]);
      }
    }
  }
  __syncthreads();
}

// Luong attention of the block's own tile rows: q (float32, the q
// exchange buffer, row stride hs) over the context ctx (L, B, H), alpha =
// softmax in float32, and round_cd(context vector) into the exchange
// plane cv (dc_aoff) at the rows' places, as decode_tail.cuh's
// attention_htilde.  kRoundQA rounds q and alpha to the compute dtype
// before their contractions, as the teacher-forced forward does
// (aocr/ops/pallas/tf_fwd.py:125-132); the decode kernels keep both in
// float32.  Own row r attends over context batch row
// crow0 + (roff + r) / kg: kg = K groups a batch row's K beams on its one
// context row (kg = 1: a row each), and the own rows start roff rows into
// their first batch row's.  qs (own rows x H) and sc (own rows x L) are
// shared-memory scratch; on exit sc holds the own rows' alpha (float32).
// With nb >= 1 the rows' context (L x H each) is
// staged in shared memory at cbuf, nb context rows a pass
// (dc_stage_context), and read
// from L2 once a step.  With nb = 0 (a context too large for the ring) it
// is read from global memory twice, the scores and the context vector.
// Not inlined, nor is dc_partial_logits: inlined, they take registers
// from the kernels' product loops (greedy_loop and beam_loop at B=512 in
// bf16, and greedy_loop in float32, ran slower so on an H100; PERF.md).
// G > 1 computes the scores and the context vectors of up to G rows of
// one context row together, each load of the context serving them all
// (beam_step.cu's beams): a warp's dot products, one after another, are
// latency-bound (tools/beam_step_phases_torch.py).  Every sum runs in the
// same order either way, so the results are the same bits.
template <typename T, bool kRoundQA = false, int G = 1>
__device__ __noinline__ void dc_attend_rows(const T* __restrict__ ctx, int L, int B,
                               const float* q, T* cv, float* qs, float* sc,
                               T* cbuf, int nb, const DcBlock<T>& b,
                               DcRing<T>& ring, size_t crow0, int kg,
                               int roff = 0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = b.H, H4 = H / 4, n = b.nown;
  const size_t row0 = (size_t)b.b0 + b.ra;  // the first own tile row
  for (int i = tid; i < n * H4; i += DC_THREADS) {
    const int r = i / H4, h = (i % H4) * 4;
    float v[4];
    load4_cg(q + (row0 + r) * b.hs + h, v);
    if (kRoundQA) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = round_cd<T>(v[e]);
    }
    store4(qs + r * H + h, v);
  }
  // the own rows' context rows
  const int nc = n > 0 ? (roff + n + kg - 1) / kg : 0;
  const int pass = nb > 0 ? nb : max(nc, 1);
  for (int c0 = 0; c0 < nc; c0 += pass) {
    const int mc = min(pass, nc - c0), r0 = max(c0 * kg - roff, 0);
    const int m = min((c0 + mc) * kg - roff, n) - r0;  // own rows of the pass
    // own row r0 + r's context at l = 0; position l is l * cst further
    const size_t cst = nb > 0 ? (size_t)H : (size_t)B * H;
    auto cbase = [&](int r) -> const T* {
      const int c = (roff + r0 + r) / kg - c0;
      return nb > 0 ? cbuf + (size_t)c * L * H
                    : ctx + (crow0 + c0 + c) * H;
    };
    if (nb > 0) dc_stage_context<T>(ctx, L, B, H, crow0 + c0, mc, cbuf, ring);
    __syncthreads();
    if constexpr (G > 1) {
      dc_attend_grouped<T, kRoundQA, G>(L, H, qs, sc, cv, b, r0, m, kg,
                                        c0 * kg - roff - r0, mc, cbase, cst);
      continue;
    }
    // scores[r][l] = ctx[l, b, :] . q[b, :]: a warp a (row, l)
    for (int p = warp; p < m * L; p += DC_WARPS) {
      const int r = p / L, l = p % L;
      const T* cr = cbase(r) + l * cst;
      const float* qr = qs + (r0 + r) * H;
      float s = 0.f;
      for (int h = 4 * lane; h < H; h += 128) {
        float c[4];
        load_row(cr + h, c);
#pragma unroll
        for (int e = 0; e < 4; ++e) s = fmaf(c[e], qr[h + e], s);
      }
      s = warp_sum(s);
      if (lane == 0) sc[(r0 + r) * L + l] = s;
    }
    __syncthreads();
    // alpha = softmax over L: a warp a row
    for (int r = warp; r < m; r += DC_WARPS) {
      float* a = sc + (r0 + r) * L;
      float mx = -INFINITY;
      for (int l = lane; l < L; l += 32) mx = fmaxf(mx, a[l]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int l = lane; l < L; l += 32) {
        const float e = expf(a[l] - mx);
        a[l] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int l = lane; l < L; l += 32) a[l] = a[l] / sum;
    }
    __syncthreads();
    // context vector = sum_l alpha * ctx, float32, rounded
    for (int i = tid; i < m * H4; i += DC_THREADS) {
      const int r = i / H4, h = (i % H4) * 4;
      const float* a = sc + (r0 + r) * L;
      const T* cr = cbase(r) + h;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      for (int l = 0; l < L; ++l) {
        float c[4];
        load_row(cr + l * cst, c);
        const float al = kRoundQA ? round_cd<T>(a[l]) : a[l];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = fmaf(al, c[e], v[e]);
      }
      store4(cv + b.aoff(b.ra + r0 + r, h), v);
    }
    __syncthreads();
  }
}

// The attention backward of the block's own tile rows, one teacher-forced
// step (aocr/ops/pallas/tf_bwd.py:101-121): from the float32 dcvec rows
// (the exchange buffer dcv, row stride hs), the step's alpha (B, L) and
// the context, dalpha = ctx . dcvec, dscore = alpha dalpha - alpha
// sum(alpha dalpha) (float32, into dscore (B, L)), and dq = sum_l dscore
// ctx (float32, rounded into dq (B, H) and the exchange plane dqp).  The
// context is staged as in dc_attend_rows (nb rows a pass), ds (own rows x
// H) and sc (own rows x L) are shared-memory scratch.
template <typename T>
__device__ __noinline__ void dc_attend_bwd_rows(
    const T* __restrict__ ctx, int L, int B, const float* dcv,
    const float* __restrict__ alpha, float* dscore, T* dq, T* dqp, float* ds,
    float* sc, T* cbuf, int nb, const DcBlock<T>& b, DcRing<T>& ring) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = b.H, H4 = H / 4, n = b.nown;
  const size_t row0 = (size_t)b.b0 + b.ra;  // the first own row
  for (int i = tid; i < n * H4; i += DC_THREADS) {
    const int r = i / H4, h = (i % H4) * 4;
    float v[4];
    load4_cg(dcv + (row0 + r) * b.hs + h, v);
    store4(ds + r * H + h, v);
  }
  const int pass = nb > 0 ? nb : max(n, 1);
  const size_t cst = nb > 0 ? (size_t)H : (size_t)B * H;
  for (int r0 = 0; r0 < n; r0 += pass) {
    const int m = min(pass, n - r0);
    auto cbase = [&](int r) -> const T* {
      return nb > 0 ? cbuf + (size_t)r * L * H : ctx + (row0 + r0 + r) * H;
    };
    if (nb > 0) dc_stage_context<T>(ctx, L, B, H, row0 + r0, m, cbuf, ring);
    __syncthreads();
    // dalpha[r][l] = ctx[l, b, :] . dcvec[b, :]: a warp a (row, l)
    for (int p = warp; p < m * L; p += DC_WARPS) {
      const int r = p / L, l = p % L;
      const T* cr = cbase(r) + l * cst;
      const float* dr = ds + (r0 + r) * H;
      float s = 0.f;
      for (int h = 4 * lane; h < H; h += 128) {
        float c[4];
        load_row(cr + h, c);
#pragma unroll
        for (int e = 0; e < 4; ++e) s = fmaf(c[e], dr[h + e], s);
      }
      s = warp_sum(s);
      if (lane == 0) sc[(r0 + r) * L + l] = s;
    }
    __syncthreads();
    // the softmax backward: a warp a row
    for (int r = warp; r < m; r += DC_WARPS) {
      const size_t row = row0 + r0 + r;
      const float* ar = alpha + row * L;
      float* d = sc + (r0 + r) * L;
      float sum = 0.f;
      for (int l = lane; l < L; l += 32) sum += ar[l] * d[l];
      sum = warp_sum(sum);
      for (int l = lane; l < L; l += 32) {
        const float a = ar[l];
        const float v = a * d[l] - a * sum;
        d[l] = v;
        dscore[row * L + l] = v;
      }
    }
    __syncthreads();
    // dq = sum_l dscore * ctx, float32, rounded: 4 columns a thread
    for (int i = tid; i < m * H4; i += DC_THREADS) {
      const int r = i / H4, h = (i % H4) * 4;
      const float* d = sc + (r0 + r) * L;
      const T* cr = cbase(r) + h;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      for (int l = 0; l < L; ++l) {
        float c[4];
        load_row(cr + l * cst, c);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = fmaf(d[l], c[e], v[e]);
      }
      store4(dq + (row0 + r0 + r) * H + h, v);
      store4(dqp + b.aoff(b.ra + r0 + r, h), v);
    }
    __syncthreads();
  }
}

// The block's partial logits: out[r][v] = round_cd(h~)[r, own units] @
// W_p[own units, v] for the tile's real rows and v < V, float32, units in
// order, 4 columns a thread.  ht holds round_cd(h~) (row stride ldh).
// The block's rows of W_p (nu x Vp, contiguous) come into shared memory at
// ws (cap bytes) by one bulk copy onto the mbarrier bar (its phase from
// *seq), or, where they do not fit, are read from global memory.
template <typename T>
__device__ __noinline__ void dc_partial_logits(const float* ht, int ldh,
                                  const T* __restrict__ pw, int Vp, int V,
                                  T* ws, long cap, uint64_t* bar, int* seq,
                                  float* out, const DcBlock<T>& b) {
  const int tid = threadIdx.x, nu = b.nu, vq = (V + 3) / 4;
  const uint32_t bytes = (uint32_t)((size_t)nu * Vp * sizeof(T));
  const T* src = pw + (size_t)b.j0 * Vp;
  const bool staged = nu > 0 && bytes <= cap;
  if (staged) {
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(bar, bytes);
      bulk_copy(ws, src, bytes, bar);
    }
    mbar_wait(bar, *seq & 1);
    ++*seq;
    src = ws;
  }
  for (int i = tid; i < b.nrows * vq; i += DC_THREADS) {
    const int r = i / vq, v = 4 * (i % vq);
    const float* hr = ht + r * ldh;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int u = 0; u < nu; ++u) {
      const float h = hr[u];
      float w[4];
      load_row(src + (size_t)u * Vp + v, w);
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = fmaf(h, w[e], a[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (v + e < V) out[r * V + v + e] = a[e];
  }
  __syncthreads();
}

// The log-softmax of one row's logits x (Vp, float32, in place) and its
// PAD/EOS freeze (x[PAD] = 0 for a frozen row), by one warp, as
// decode_tail.cuh's projector_logp; ends with __syncwarp.
__device__ __forceinline__ void dc_logp_row(float* x, int Vp, bool frozen) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int v = lane; v < Vp; v += 32) m = fmaxf(m, x[v]);
  m = warp_max(m);
  float s = 0.f;
  for (int v = lane; v < Vp; v += 32) s += expf(x[v] - m);
  s = warp_sum(s);
  const float lse = m + logf(s);
  for (int v = lane; v < Vp; v += 32)
    x[v] = (frozen && v == PAD) ? 0.f : x[v] - lse;
  __syncwarp();
}

// The argmax of row r's log-probs x (Vp of them), ties to the lowest
// index, invalid tokens (valid(v) false) counting -1e30 except PAD of a
// frozen row, as decode_tail.cuh's projector_pick; every lane gets it.
template <typename Valid>
__device__ __forceinline__ void dc_pick_row(const float* x, int Vp,
                                            bool frozen, Valid valid,
                                            float* best_out, int* tok_out) {
  const int lane = threadIdx.x & 31;
  // bi starts at PAD, so a row whose log-probs are all NaN picks PAD
  float best = -INFINITY;
  int bi = PAD;
  for (int v = lane; v < Vp; v += 32) {
    const float y = (valid(v) || (frozen && v == PAD)) ? x[v] : -1e30f;
    if (y > best) {
      best = y;
      bi = v;
    }
  }
  warp_argmax(&best, &bi);
  *best_out = best;
  *tok_out = bi;
}

// ---------------------------------------------------------------- kernels

// A product's accumulators: bf16 DC_TILES mma tiles of NQ column blocks;
// float32 RT rows x NQ column blocks x 2 units a thread.
template <typename T, int RT, int NQ>
using DcAcc = std::conditional_t<sizeof(T) == 2, float[DC_TILES][NQ * 4],
                                 float[RT][NQ][2]>;

template <int A, int N>
__device__ __forceinline__ void dc_zero(float (&x)[A][N]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) x[i][j] = 0.f;
}
template <int A, int N, int M>
__device__ __forceinline__ void dc_zero(float (&x)[A][N][M]) {
#pragma unroll
  for (int i = 0; i < A; ++i) dc_zero(x[i]);
}

// The FMA thread of (row group rg, unit pair): rows r0..r0+RT-1, units
// u, u + 1; `on` false for the threads past the row groups.
struct DcFma {
  int r0, u;
  bool on;
  __device__ DcFma(int units, int RT) {
    const int up = units / 2, rg = threadIdx.x / up;
    r0 = rg * RT;
    u = 2 * (threadIdx.x % up);
    on = rg < DC_THREADS / up;
  }
};

// acc += the segment's product over the tile (dc_stream with the dtype's
// chunk product)
template <typename T, int RT, int NQ>
__device__ __forceinline__ void dc_product(DcAcc<T, RT, NQ>& acc,
                                           const DcSeg<T>& s,
                                           const DcBlock<T>& b,
                                           DcRing<T>& ring, DcClock& clk,
                                           const DcTiles& tl,
                                           const DcFma& fm) {
  dc_stream<T>(s, b, ring, clk, [&](const T* sa, const T* sw) {
    if constexpr (sizeof(T) == 2) {
      dc_mma_chunk<NQ>(acc, sa, b.g.lda, sw, s.ldw, b.kc, b.U, tl);
    } else {
      if (fm.on)
        dc_fma_chunk<RT, NQ>(acc, sa, b.g.lda, sw, s.ldw, b.kc, b.U, fm.r0,
                             fm.u);
    }
  });
}

// publish this block's generic stores (for bulk-copy readers too) and
// arrive at the cluster barrier
__device__ __forceinline__ void dc_publish() {
  fence_proxy_async();
  cluster_arrive();
}

// f(r, u, v) for each (tile row, unit pair) this thread's accumulators hold
template <typename T, int RT, int NQ, typename F>
__device__ __forceinline__ void dc_pairs(DcAcc<T, RT, NQ>& acc,
                                         const DcTiles& tl, const DcFma& fm,
                                         F f) {
  if constexpr (sizeof(T) == 2) {
    dc_mma_fold<NQ>(acc, tl);
    dc_mma_pairs<NQ>(acc, tl, f);
  } else {
    if (!fm.on) return;
#pragma unroll
    for (int i = 0; i < RT; ++i) f(fm.r0 + i, fm.u, acc[i]);
  }
}

// f(r, q, u, x0, x1) with references to the accumulators of (tile row r,
// column block q, units u and u + 1) for each that this thread holds,
// after folding a one-tile warp's chains into its first (the others are
// then zero): to store a product to shared memory, or to load one back
// in another row order.
template <typename T, int RT, int NQ, typename F>
__device__ __forceinline__ void dc_elems(DcAcc<T, RT, NQ>& acc,
                                         const DcTiles& tl, const DcFma& fm,
                                         F f) {
  if constexpr (sizeof(T) == 2) {
    const int lane = threadIdx.x & 31;
    dc_mma_fold<NQ>(acc, tl);
    if (tl.ng == 1 && tl.n == 1) {
#pragma unroll
      for (int i = 1; i < DC_TILES; ++i)
#pragma unroll
        for (int e = 0; e < NQ * 4; ++e) acc[i][e] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < DC_TILES; ++i) {
      if (i >= tl.n) break;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          f(tl.m[i] * 16 + (lane >> 2) + 8 * h, q,
            8 * tl.g[i] + 2 * (lane & 3), acc[i][q * 4 + h * 2],
            acc[i][q * 4 + h * 2 + 1]);
    }
  } else {
    if (!fm.on) return;
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        f(fm.r0 + i, q, fm.u, acc[i][q][0], acc[i][q][1]);
  }
}

// ---------------------------------------------------------------- phases

// The block's view of plan p: its cluster's tile cl (rows [cl bt, (cl + 1)
// bt) of the scratch buffers, nrows of them real), its rank and units, and
// the row-split rows [rank R, rank R + R) of the tile; the ring's stages
// sized for products of up to nq column blocks (dc_geom).
template <typename T>
__device__ __forceinline__ DcBlock<T> dc_block(const DcPlan& p, int H, int cl,
                                               int nrows, int R, int nq = 4) {
  DcBlock<T> b;
  b.H = H;
  b.U = p.units;
  b.rank = (int)cg::this_cluster().block_rank();
  b.j0 = b.rank * p.units;
  b.nu = max(0, min(p.units, H - b.j0));
  b.b0 = cl * p.bt;
  b.nrows = nrows;
  b.bt = p.bt;
  b.kc = p.kc;
  b.stages = p.stages;
  b.hs = dc_round_up(H, p.kc);
  b.nch = b.hs / p.kc;
  b.kshift = __ffs(p.kc) - 1;
  b.cl = cl;
  b.cs = p.cs;
  b.g = dc_geom(p, (int)sizeof(T), nq);
  b.g.R = R;
  b.ra = b.rank * R;
  b.nown = max(0, min(R, nrows - b.ra));
  return b;
}

// q = h_top @ W_a over the block's columns into the q exchange buffer qb
// (float32, row stride hs; the tile's real rows and units) and h_top @
// W_c[H:] into the float tile ht (row stride ldh), from the h_top plane
// (its tile's chunk 0) and the block's packed [W_a | W_c[H:]] slice wq;
// then published, and the wait for every block's.
template <typename T, int RT>
__device__ __forceinline__ void dc_query(const T* htop, const T* wq, float* qb,
                                         float* ht, const DcBlock<T>& b,
                                         DcRing<T>& ring, DcClock& clk,
                                         const DcTiles& tl, const DcFma& fm) {
  const int ld2 = 2 * b.U + 16 / (int)sizeof(T), ldh = b.g.ldh;
  DcAcc<T, RT, 2> acc;
  dc_zero(acc);
  dc_product<T, RT, 2>(acc, {htop, wq + (size_t)b.rank * b.hs * ld2, ld2},
                       b, ring, clk, tl, fm);
  dc_pairs<T, RT, 2>(acc, tl, fm, [&](int r, int u, const float(&v)[2][2]) {
    ht[r * ldh + u] = v[1][0];
    ht[r * ldh + u + 1] = v[1][1];
    if (r < b.nrows && u < b.nu)
      store2<float>(qb + (size_t)(b.b0 + r) * b.hs + b.j0 + u, v[0][0],
                    v[0][1]);
  });
  clk.tick(DC_EPILOGUE);
  dc_publish();
  cluster_wait();
  clk.tick(DC_BARRIER);
}

// h~ = tanh(ctx_vec @ W_c[:H] + h_top @ W_c[H:]) over the block's columns,
// from the context-vector plane cv (its tile's chunk 0), the block's
// packed W_c[:H] slice wcx and the float tile ht (h_top @ W_c[H:], then
// round_cd(h~)); out(r, j, h0, h1) gets the float32 h~ of tile row r at
// units j, j + 1 (the real rows and units), the block's partial logits
// (dc_partial_logits) go into part (the tile's cs x bt x V floats); then
// published, and the wait for every block's.
template <typename T, int RT, typename Out>
__device__ __forceinline__ void dc_htilde_to(const T* cv, const T* wcx,
                                             float* ht, const T* pw, int Vp,
                                             int V, float* part,
                                             const DcBlock<T>& b,
                                             DcRing<T>& ring, long ring_bytes,
                                             DcClock& clk, const DcTiles& tl,
                                             const DcFma& fm, Out out) {
  const int ld1 = b.U + 16 / (int)sizeof(T), ldh = b.g.ldh;
  DcAcc<T, RT, 1> acc;
  dc_zero(acc);
  dc_product<T, RT, 1>(acc, {cv, wcx + (size_t)b.rank * b.hs * ld1, ld1}, b,
                       ring, clk, tl, fm);
  dc_pairs<T, RT, 1>(acc, tl, fm, [&](int r, int u, const float(&v)[1][2]) {
    float h[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      h[e] = tanhf(v[0][e] + ht[r * ldh + u + e]);
      ht[r * ldh + u + e] = round_cd<T>(h[e]);
    }
    if (r < b.nrows && u < b.nu) out(r, b.j0 + u, h[0], h[1]);
  });
  clk.tick(DC_EPILOGUE);
  dc_partial_logits<T>(ht, ldh, pw, Vp, V, ring.base, ring_bytes,
                       ring.bar + DC_MAX_STAGES, &ring.aseq,
                       part + ((size_t)b.cl * b.cs + b.rank) * b.bt * V, b);
  clk.tick(DC_PROJ);
  dc_publish();
  cluster_wait();
  clk.tick(DC_BARRIER);
}

// dc_htilde_to with h~ rounded into the exchange plane an (the next
// step's input feed)
template <typename T, int RT>
__device__ __forceinline__ void dc_htilde(const T* cv, const T* wcx, T* an,
                                          float* ht, const T* pw, int Vp,
                                          int V, float* part,
                                          const DcBlock<T>& b,
                                          DcRing<T>& ring, long ring_bytes,
                                          DcClock& clk, const DcTiles& tl,
                                          const DcFma& fm) {
  dc_htilde_to<T, RT>(cv, wcx, ht, pw, Vp, V, part, b, ring, ring_bytes, clk,
                      tl, fm, [&](int r, int j, float h0, float h1) {
                        store2<T>(an + b.aoff(r, j), h0, h1);
                      });
}

// The logits of the block's own rows into lg (own rows x Vp): the cs
// partial sums (part: clusters x cs x bt x V) in block order, + b_p;
// columns past V hold b_p alone (pad_projector's zero weights).  Ends with
// a __syncthreads.
template <typename T>
__device__ __forceinline__ void dc_logits(const float* part, const float* pb,
                                          int Vp, int V, float* lg,
                                          const DcBlock<T>& b) {
  const int cs = b.cs;
  for (int i = threadIdx.x; i < b.nown * Vp; i += DC_THREADS) {
    const int r = i / Vp, v = i % Vp;
    float x = pb[v];
    if (v < V) {
      float s = 0.f;
      for (int k = 0; k < cs; ++k)
        s += __ldcg(part + (((size_t)b.cl * cs + k) * b.bt + b.ra + r) * V +
                    v);
      x = s + pb[v];
    }
    lg[r * Vp + v] = x;
  }
  __syncthreads();
}

// ---------------------------------------------------------------- launch

// The launch of a cluster kernel fn for plan p: p.clusters clusters of
// p.cs blocks (a non-portable size), p.smem bytes of dynamic shared memory.
template <typename Kernel>
static cudaError_t dc_config(Kernel fn, const DcPlan& p, cudaStream_t stream,
                             cudaLaunchConfig_t* cfg,
                             cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) e = set_smem((const void*)fn, p.smem);
  *cfg = {};
  cfg->gridDim = dim3(p.clusters * p.cs);
  cfg->blockDim = dim3(DC_THREADS);
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

// The clusters of cs blocks of fn (the instance for dtype esz) the card
// runs at once at nearly the largest shared memory a plan takes (1 KB left
// for a build with static shared memory; the count steers the tile size),
// queried once per kernel, dtype and cs; 0 where the query fails.
template <typename Kernel>
static int dc_active(Kernel fn, int esz, int cs) {
  static int cache[2][DC_MAX_CLUSTER + 1] = {};
  int& n = cache[esz == 4][cs];
  if (n == 0) {
    const DcPlan p = {cs, 8, 16, 1, 16, 2, 0, DC_SMEM_MAX - 1024, 1};
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    if (dc_config(fn, p, nullptr, &cfg, &attr) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess)
      n = 0;
  }
  return n;
}

// Launch fn(a, p) on stream; returns a CUDA error code (the launch's, then
// cudaGetLastError's).
template <typename Args>
static int dc_launch(void (*fn)(Args, DcPlan), const DcPlan& p,
                     const Args& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = dc_config(fn, p, stream, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, fn, a, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace aocr
