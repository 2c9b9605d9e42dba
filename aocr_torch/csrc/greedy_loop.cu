// The whole T-step greedy decode in one launch, on thread-block clusters.
//
// Replaces aocr/ops/pallas/greedy_loop.py::fused_greedy_loop (pl.pallas_call
// at greedy_loop.py:362), in-kernel trie included.
//
// Each step of each row: the emb_gates row of the previous token (a
// gather; the TPU's one-hot matmul was a Mosaic workaround), layer 0 on
// [attn; h0] @ [Wi[E:]; Wh] (h0 @ Wh without input feed), the other
// layers on [x; h_l] @ [Wi; Wh] + b, Luong attention, h~ = tanh(W_c [ctx;
// h]), the projector and float32 log-softmax, the PAD/EOS freeze, the
// argmax (ties to the lowest index), the score sum and the token history.
//
// Design (decoder_cluster.cuh): a cluster of cs blocks (16 at H=1024) owns
// a tile of bt batch rows for all T steps; block s owns U = H/cs hidden
// units of every layer with their four gate columns and the same columns
// of W_a and W_c, and streams its slices of the weights (packed by block
// by the wrapper, ~2.6 MB a step in bf16 at H=1024, 2 layers, input feed)
// from L2 through a ring of bulk (TMA) copies, with the tile's left
// operand beside each chunk, multiplying bf16 on the tensor cores
// (mma.sync) and float32 on the CUDA cores.  The TPU kernel kept every
// decoder weight in VMEM; here a step reads each weight element once a
// cluster and uses it for bt rows (4 in the previous kernel, one block a
// tile).  The cell states stay in the block (shared memory where the plan
// fits them).  A step, with its cluster barriers (each an arrive after
// the stores it publishes and a wait before the first read of them, work
// between the two where there is some):
//   1. layer 0's product over [attn; h0] (both published by the last
//      step), then wait for the last step's tokens, read them back (the
//      early exit: every block of the cluster reads the same tokens and
//      leaves at the same step once every row of the tile is PAD or EOS;
//      rows past B start as PAD), stage their emb_gates rows, the gate
//      math, h0's slice published;
//   2. layer l >= 1: the product over its own last h_l first, then the
//      wait for h_{l-1}, then that half; h_l's slice published;
//   3. q = h_top @ W_a and h_top @ W_c[H:] (kept in shared memory) over
//      the block's columns; q's slice (float32) published;
//   4. the attention of the block's own R = bt/cs tile rows: their context
//      staged in shared memory, scores, softmax, the context vector
//      (rounded), published; at long contexts split by positions instead
//      (below), with one more cluster barrier;
//   5. h~ = tanh(ctx_vec @ W_c[:H] + h_top @ W_c[H:]) over the block's
//      columns, published (the next step's input feed), and the block's
//      partial logits round_cd(h~)[:, cols] @ W_p[cols, :V];
//   6. for its own rows: the logits (the cs partial sums in block order,
//      + b_p; columns past V hold b_p alone, pad_projector's zero
//      weights), log-softmax, the freeze, the trie, the argmax, the
//      score, the history and the token, published.
// Exchanges go through L2 (stores, an async-proxy fence, the barrier, then
// bulk copies or ld.global.cg), double-buffered by step parity where a
// block may still read the last step's values while another writes the
// next.
//
// Dictionary decoding: the dense (N, V) int32 transition table stays in
// device memory, unpadded; the owner of a row keeps its node id in shared
// memory; a step's validity is an integer read of the node's row.  At
// t = 0 only the root's children are valid, PAD not; later PAD always is.
// PAD keeps the node, any other token steps it (clamped at 0), as
// greedy_loop.py:153-187.
//
// Bound on the H100: a step's chain of dependent phases, none near a
// roofline (tools/greedy_loop_phases_torch.py, H100 80GB HBM3 at 700 W,
// the default decoder, T=50).  At B=512 in bf16 (7 clusters of 80 rows) a
// step takes ~570K cycles: the mma products ~200K (a quarter of the
// tensor cores' dense rate), the epilogues ~100K, waits for the stream
// ~80K, the attention ~70K, the copies' issue ~50K, the partial projector
// ~20K, barriers ~20K.  At B=1 (one cluster of 16 rows) ~210K: the stream
// of each SM's 2.6 MB slice (~20 bytes a cycle an SM) and the latency of
// one tile's mma chain set it.  float32 is bound by the FMA loop (~80% of
// a step at B=512).  The plan (dc_plan, mirrored by
// aocr_torch/ops/cuda/greedy_loop.py::plan) sizes the tile so that the
// clusters fill the card; a ragged tile and units past H are masked; a
// shape no plan fits is refused.
//
// Long contexts (im2markup: L = 1,240 positions at H = 512).  Where not one
// tile row's context fits the ring (the row split's nb = 0), the row split
// reads each row's context from global memory twice a step (the scores,
// then the context vector), by rows B x H apart: a step at B=256 took ~1.16
// ms for 325 MB.  The launch then takes the split instance (gl_split): the
// cluster's cs blocks are cs / np row groups x np position slices; each
// block streams its slice of positions for its group's rows through the
// ring, ctx[l, the group's rows, :] one run of bytes a position in the (L,
// B, H) layout, one bulk copy each, and keeps q, a running max and sum and
// an unnormalised float32 context vector of each row in registers (an
// online softmax), so each context element is read once a step.  The
// blocks' partials meet in L2 across one more cluster barrier, and each
// block combines them for its own units (gl_attend_combine).  Bound: each
// live row's context read once a step, 48.8 GB a call of 256 rows x 150
// steps, 14.6 ms at 3.35 TB/s.  At B=256 in bf16 (6 clusters of 48 rows,
// 2 row groups x 8 slices of 155 positions) the attention takes ~295K
// cycles a step (~1.87M split by rows), its stream alone ~222K (HBM near
// its rate from 96 SMs) and its updates alone more: the chain of a
// position's loads, three rows' butterfly sums and exp, with two warps a
// scheduler, bounds it (tools/greedy_loop_phases_torch.py splitload,
// splitcalc).  The rest of a step (one layer at H=512) ~220K.
#include "decoder_cluster.cuh"

namespace aocr {

struct GlArgs {
  const void* ctx;  // (L, B, H) compute dtype
  const float* c0;  // (B, H)
  const float* h0;  // (B, H)
  const void* eg;   // (V, 4H)
  // the weights packed by block (ops/cuda/greedy_loop.py::pack_weights):
  // layer 0 (cs, nseg0, hs, 4U + pad), layers 1..nl-1
  // (nl-1, cs, 2, hs, 4U + pad), [W_a | W_c[H:]] (cs, hs, 2U + pad) and
  // W_c[:H] (cs, hs, U + pad)
  const void* w0;
  const void* wl;
  const float* bx;  // (nl-1, 4H)
  const void *wq, *wcx, *pw;  // the last two packs; the projector (H, Vp)
  const float* pb;           // (Vp,)
  const int* trie;           // (N, V) or null
  int* labels;               // (B, T)
  float* scores;             // (B,)
  unsigned char* scratch;    // dc_scratch's regions, zeroed
  int L, B, H, Vp, V, T, nl, input_feed;
  int np;  // the attention's position slices (gl_split), 0: by rows
};

#ifdef DC_PROBES
// the phases' cycles summed over the blocks, then the block count
__device__ unsigned long long gl_prof[DC_NPHASES + 1];
#endif

// ------------------------------------------- the attention split by positions

// The split attention's registers: a warp holds q and the unnormalised
// context vector of GL_SPLIT_RW tile rows, a lane GL_SPLIT_KM runs of 4
// columns of each (4i + 128c), so H is at most 128 GL_SPLIT_KM.
constexpr int GL_SPLIT_RW = 3, GL_SPLIT_KM = 4;

// The rows of a row group of plan p split into np position slices:
// ceil(bt / (cs / np)).
__host__ __device__ inline int gl_split_rows(const DcPlan& p, int np) {
  const int ng = p.cs / np;
  return (p.bt + ng - 1) / ng;
}

// The split attention's stages, each one position of a row group's rows
// (slot bytes), in the ring (ring bytes) after GL_SPLIT_BARS bytes of
// their two mbarriers each (copied, consumed): as many as fit, up to
// GL_SPLIT_STAGES.
constexpr int GL_SPLIT_STAGES = 16;
constexpr int GL_SPLIT_BARS = 16 * GL_SPLIT_STAGES;
__host__ __device__ inline int gl_split_stages(long ring, long slot) {
  const long n = (ring - GL_SPLIT_BARS) / slot;
  return (int)(n < GL_SPLIT_STAGES ? n : GL_SPLIT_STAGES);
}

// The position slices np of the split attention for plan p (ring,
// cluster and tile from dc_plan), or 0 for the row split: 0 where one tile
// row's context (L x H) fits the ring beside the row split's q rows,
// scores and logits (dc_attend_rows stages it), where H passes 128
// GL_SPLIT_KM or a context row is no multiple of 16 bytes, or where no row
// group fits.  The row groups: the fewest (a power of two up to cs) whose
// rows the warps hold (GL_SPLIT_RW a warp), with two stages or more
// (gl_split_stages).
static inline int gl_split(const DcPlan& p, int esz, int H, int L, int Vp) {
  const long ring = (long)p.stages * dc_geom(p, esz).stage * esz;
  const int R = (p.bt + p.cs - 1) / p.cs, most = DC_WARPS * GL_SPLIT_RW;
  if (ring - dc_round_up((long)R * (H + L + Vp) * 4, 16) >= (long)L * H * esz ||
      H > 128 * GL_SPLIT_KM || (H * esz) % 16)
    return 0;
  int ng = 1;
  while (ng < p.cs && (p.bt + ng - 1) / ng > most) ng *= 2;
  const int rg = (p.bt + ng - 1) / ng;
  if (rg > most || gl_split_stages(ring, (long)rg * H * esz) < 2) return 0;
  return p.cs / ng;
}

// Four context values a lane as loaded (bf16 kept packed, 8 bytes) and
// as floats: gl_attend_split loads them so, then converts, which ran its
// loop ~12% faster on an H100 than load_row into zeroed floats did
// (tools/greedy_loop_phases_torch.py, im2markup's shape).
template <typename T>
struct GlRaw {
  using type = float4;
};
template <>
struct GlRaw<__nv_bfloat16> {
  using type = uint2;
};
__device__ __forceinline__ void gl_unpack(const float4& v, float (&o)[4]) {
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void gl_unpack(const uint2& v, float (&o)[4]) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// The block's part of the split attention: its row group g = rank / np
// (tile rows [g rg, g rg + rg), the real ones) over its position slice k =
// rank % np ([k ls, k ls + ls) of L, ls = ceil(L / np)).  Warp w takes the
// group's rows w, w + 8, ... (RW of them), lane i the columns 4i + 128c (c
// < KM): q (float32, the q exchange buffer, row stride hs) and the
// unnormalised context vector in registers.  The slice streams through
// gl_split_stages stages in the ring, a position each, one bulk copy of
// the group's real rows (one run of bytes in the (L, B, H) layout) onto
// the stage's mbarrier; each warp arrives on the stage's second mbarrier
// once done with it, and thread 0 waits for the eight before it refills
// the stage, so the warps keep their own pace (the mbarriers at the
// ring's start, initialized here and invalidated on exit: the ring serves
// the products between the steps' attentions; many positions in flight
// keep HBM busy).  For each position: the scores of the warp's rows
// (float32, a warp's butterfly sum each: the same bits on every lane, so
// the branch below is uniform), then each row's running max m (where one
// rises, the vectors and the running sums rescaled by exp(m - m')), s += e
// and the vector += e ctx, e = exp(score - m).  The loop is bound by the
// latency of that chain (H100, im2markup's shape), so the RW rows' sums
// and updates run side by side, with no branch but the rare rescale.  The
// vectors go to part (clusters x cs x rg x H floats), (m, s) to ml
// (clusters x cs x rg x 2), for gl_attend_combine.  Not inlined, as
// dc_attend_rows.
template <typename T>
__device__ __noinline__ void gl_attend_split(const T* __restrict__ ctx, int L,
                                             int B, const float* q,
                                             float* part, float* ml, int np,
                                             int rg, const DcBlock<T>& b,
                                             unsigned char* ring,
                                             long ring_bytes) {
  constexpr int KM = GL_SPLIT_KM, RW = GL_SPLIT_RW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, H = b.H;
  const int r0 = b.rank / np * rg, nr = min(rg, b.nrows - r0);
  const int ls = (L + np - 1) / np, l0 = b.rank % np * ls;
  const int n = min(L - l0, ls);  // the slice's positions
  if (nr <= 0 || n <= 0) return;
  const size_t slot = (size_t)rg * H;  // elements of a staged position
  const int S = gl_split_stages(ring_bytes, (long)slot * sizeof(T));
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring);  // copied
  uint64_t* done = bar + GL_SPLIT_STAGES;              // consumed
  T* stage = reinterpret_cast<T*>(ring + GL_SPLIT_BARS);
  const uint32_t rowb = (uint32_t)((size_t)nr * H * sizeof(T));
  auto issue = [&](int l) {  // the slice's position l into stage l % S
    if (tid == 0 && l < n) {
      mbar_expect_tx(bar + l % S, rowb);
      bulk_copy(stage + (size_t)(l % S) * slot,
                ctx + ((size_t)(l0 + l) * B + b.b0 + r0) * H, rowb,
                bar + l % S);
    }
  };
  float qv[RW][KM][4], acc[RW][KM][4], mx[RW], sum[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const int r = warp + DC_WARPS * j;
    mx[j] = -INFINITY;
    sum[j] = 0.f;
#pragma unroll
    for (int c = 0; c < KM; ++c) {
      const int h = 4 * lane + 128 * c;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][c][e] = qv[j][c][e] = 0.f;
      if (r < nr && h < H)
        load4_cg(q + (size_t)(b.b0 + r0 + r) * b.hs + h, qv[j][c]);
    }
  }
  fence_proxy_async();  // the ring was last written by generic stores
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(bar + i, 1);
      mbar_init(done + i, DC_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int l = 0; l < S; ++l) issue(l);
  using Raw = typename GlRaw<T>::type;
  for (int l = 0; l < n; ++l) {
    mbar_wait(bar + l % S, (l / S) & 1);
    const T* xs = stage + (size_t)(l % S) * slot;
    // the RW rows' scores (rows past nr score 0 on zeros), summed together
    float x[RW][KM][4], s[RW];
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      const int r = warp + DC_WARPS * j;
      float sp[2] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < KM; ++c) {
        const int h = 4 * lane + 128 * c;
        Raw raw{};
        if (r < nr && h < H)
          raw = *reinterpret_cast<const Raw*>(xs + (size_t)r * H + h);
        gl_unpack(raw, x[j][c]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sp[c & 1] = fmaf(x[j][c][e], qv[j][c][e], sp[c & 1]);
      }
      s[j] = sp[0] + sp[1];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(done + l % S);  // the warp is done with it
#pragma unroll
    for (int j = 0; j < RW; ++j) s[j] = warp_sum(s[j]);
    // the rows' running maxima; where one rises, every row rescaled (by 1
    // where it did not)
    bool rise = false;
#pragma unroll
    for (int j = 0; j < RW; ++j) rise |= s[j] > mx[j];
    if (rise) {
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        const float mn = fmaxf(mx[j], s[j]), f = expf(mx[j] - mn);
        sum[j] *= f;
#pragma unroll
        for (int c = 0; c < KM; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][c][e] *= f;
        mx[j] = mn;
      }
    }
#pragma unroll
    for (int j = 0; j < RW; ++j) {
      const float ex = expf(s[j] - mx[j]);
      sum[j] += ex;
#pragma unroll
      for (int c = 0; c < KM; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][c][e] = fmaf(ex, x[j][c][e], acc[j][c][e]);
    }
    if (tid == 0 && l + S < n) {  // every warp is done with position l
      mbar_wait(done + l % S, (l / S) & 1);
      issue(l + S);
    }
  }
  __syncthreads();  // every wait is over
  if (tid == 0)
    for (int i = 0; i < S; ++i) {
      mbar_inval(bar + i);
      mbar_inval(done + i);
    }
  const size_t blk = ((size_t)b.cl * b.cs + b.rank) * rg;
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const int r = warp + DC_WARPS * j;
    if (r >= nr) continue;
#pragma unroll
    for (int c = 0; c < KM; ++c) {
      const int h = 4 * lane + 128 * c;
      if (h < H) store4(part + (blk + r) * H + h, acc[j][c]);
    }
    if (lane == 0) {
      ml[(blk + r) * 2] = mx[j];
      ml[(blk + r) * 2 + 1] = sum[j];
    }
  }
  __syncthreads();  // the ring is free on exit
}

// The context vectors of the tile's real rows at the block's own units
// from gl_attend_split's partials (published by a cluster barrier): for
// row r of group g, over the slices k that hold positions, M = max m_k and
// cv = sum_k exp(m_k - M) vec_k / sum_k exp(m_k - M) s_k, float32,
// rounded into the exchange plane cv (DcBlock::aoff), 4 units a thread.
template <typename T>
__device__ __noinline__ void gl_attend_combine(const float* part,
                                               const float* ml, T* cv, int L,
                                               int np, int rg,
                                               const DcBlock<T>& b) {
  const int nu4 = b.nu / 4, ls = (L + np - 1) / np, nk = (L + ls - 1) / ls;
  for (int i = threadIdx.x; i < b.nrows * nu4; i += DC_THREADS) {
    const int r = i / nu4, j = b.j0 + 4 * (i % nu4);
    // the partials of the row's group, slice 0
    const size_t p0 = ((size_t)b.cl * b.cs + r / rg * np) * rg + r % rg;
    float M = -INFINITY;
    for (int k = 0; k < nk; ++k) M = fmaxf(M, __ldcg(ml + (p0 + k * rg) * 2));
    float den = 0.f, v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < nk; ++k) {
      const size_t pk = p0 + (size_t)k * rg;
      const float w = expf(__ldcg(ml + pk * 2) - M);
      den = fmaf(w, __ldcg(ml + pk * 2 + 1), den);
      float a[4];
      load4_cg(part + pk * b.H + j, a);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = fmaf(w, a[e], v[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] /= den;
    store4(cv + b.aoff(r, j), v);
  }
}

// RT: float32 rows a thread (DC_FMA_RT); bf16 instances take 1.  SPLIT:
// the attention split by positions (a.np slices, gl_attend_split).
template <typename T, int RT, bool SPLIT>
__global__ void __launch_bounds__(DC_THREADS, 1)
greedy_cluster_kernel(GlArgs a, DcPlan p) {
  constexpr int ESZ = (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const T* __restrict__ ctx = static_cast<const T*>(a.ctx);
  const T* __restrict__ eg = static_cast<const T*>(a.eg);
  const T* w0 = static_cast<const T*>(a.w0);
  const T* wl = static_cast<const T*>(a.wl);
  const T* wq = static_cast<const T*>(a.wq);
  const T* wcx = static_cast<const T*>(a.wcx);
  const T* __restrict__ pw = static_cast<const T*>(a.pw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.H, G = 4 * H, nl = a.nl, T_ = a.T, V = a.V, Vp = a.Vp;

  const int cl = (int)blockIdx.x / p.cs;
  const DcBlock<T> b = dc_block<T>(p, H, cl, min(p.bt, a.B - cl * p.bt),
                                   (p.bt + p.cs - 1) / p.cs);
  const int j0 = b.j0, b0 = b.b0, hs = b.hs, R = b.g.R, ldh = b.g.ldh;

  // shared memory: the ring, the float tile (h_top @ W_c[H:], then
  // round_cd(h~)), the cell states (with cres), the tile's tokens, the own
  // rows' scores and nodes, the mbarriers; the row-split phases' q rows,
  // scores, logits and staged context, and layer 0's emb_gates rows and
  // the projector slice, overlay the ring
  T* ring0 = reinterpret_cast<T*>(smem);
  float* ht = reinterpret_cast<float*>(smem + (size_t)p.stages * b.g.stage *
                                                  ESZ);
  // the cell states with cres: (tile row, layer, unit of the block)
  float* csm = ht + p.bt * ldh;
  int* prev = reinterpret_cast<int*>(csm + dc_cbytes(p, nl) / 4);
  float* oscore = reinterpret_cast<float*>(prev + p.bt);
  int* onode = reinterpret_cast<int*>(oscore + R);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(prev) +
      dc_round_up((long)p.bt * 4 + 2L * R * 4, 8));
  DcRing<T> ring = {ring0, bars, 0, 0};
  float* qs = reinterpret_cast<float*>(smem);
  float* sc = qs + R * H;
  float* lg = sc + R * a.L;
  // the attention's staged context rows after them, as many as fit
  const long ring_bytes = (long)p.stages * b.g.stage * ESZ;
  const long cb_off = dc_round_up((long)R * (H + a.L + Vp) * 4, 16);
  T* cbuf = reinterpret_cast<T*>(smem + cb_off);
  const int nb = (int)min((long)R, (ring_bytes - cb_off) /
                                       ((long)a.L * H * ESZ));

  // global scratch (dc_scratch)
  long off[6];
  dc_scratch(p, ESZ, H, nl, V, off);
  // the exchange planes (chunk-major, DcBlock::aoff): h~ and h_l by step
  // parity, the context vector
  T* xb = reinterpret_cast<T*>(a.scratch + off[0]);
  const size_t plane = (size_t)dc_plane(p, ESZ, H);
  auto attn = [&](int par) { return xb + par * plane; };
  auto hbuf = [&](int l, int par) { return xb + (2 + 2 * l + par) * plane; };
  T* cvb = xb + (2 + 2 * nl) * plane;
  const size_t at = b.atile();  // this tile's chunk 0 in a plane
  // the block's packed weight slices and their row strides
  constexpr int WP = 16 / ESZ;
  const int ld4 = 4 * p.units + WP, nseg0 = a.input_feed ? 2 : 1;
  const size_t seg4 = (size_t)hs * ld4;
  auto wseg0 = [&](int k) {
    return w0 + ((size_t)b.rank * nseg0 + k) * seg4;
  };
  auto wsegl = [&](int l, int k) {
    return wl + (((size_t)(l - 1) * p.cs + b.rank) * 2 + k) * seg4;
  };
  float* qb = reinterpret_cast<float*>(a.scratch + off[1]);
  float* cb = reinterpret_cast<float*>(a.scratch + off[2]);  // (bp, nl, H)
  float* part = reinterpret_cast<float*>(a.scratch + off[3]);
  int* tokb = reinterpret_cast<int*>(a.scratch + off[4]);
  // the split attention's partials after dc_scratch's regions: the context
  // vectors (clusters x cs x rg x H), then (m, sum) (x 2)
  const int rg = SPLIT ? gl_split_rows(p, a.np) : 0;
  float* spart = reinterpret_cast<float*>(a.scratch + off[5]);
  float* sml = spart + (size_t)p.clusters * p.cs * rg * H;

  const DcTiles tl(p.units, p.rt);
  const DcFma fm(p.units, RT);
  DcClock clk;

  // the state: c_0 and h_0 (rounded) of the block's units; the own rows'
  // histories (PAD), tokens (GO), scores and nodes.  h~, c and h of the
  // other layers start as the scratch's zeros; rows past B stay PAD.
  if (tid == 0) {
    for (int i = 0; i <= DC_MAX_STAGES; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // c of (tile row r, layer l, unit j0 + u)
  auto cell = [&](int r, int l, int u) {
    return p.cres ? csm + ((size_t)r * nl + l) * p.units + u
                  : cb + ((size_t)(b0 + r) * nl + l) * H + j0 + u;
  };
  for (int i = tid; i < b.nrows * b.nu; i += DC_THREADS) {
    const int r = i / b.nu, u = i % b.nu, j = j0 + u;
    const size_t row = (size_t)(b0 + r);
    *cell(r, 0, u) = a.c0[row * H + j];
    for (int l = 1; p.cres && l < nl; ++l) *cell(r, l, u) = 0.f;
    hbuf(0, 0)[b.aoff(r, j)] = from_f<T>(a.h0[row * H + j]);
  }
  for (int i = tid; i < b.nown * T_; i += DC_THREADS)
    a.labels[(size_t)(b0 + b.ra) * T_ + i] = PAD;
  for (int i = tid; i < b.nown; i += DC_THREADS) {
    tokb[b0 + b.ra + i] = GO;
    oscore[i] = 0.f;
    onode[i] = 0;
  }
  fence_proxy_async();
  cluster_barrier();
  cluster_arrive();  // the tokens of "step -1"

  bool ended = false;  // the early exit; uniform across the cluster
  for (int t = 0; t < T_; ++t) {
    const int par = t & 1, nxt = par ^ 1;
    // ---- 1. layer 0
    {
      DcAcc<T, RT, 4> acc;
      dc_zero(acc);
      if (a.input_feed)
        dc_product<T, RT, 4>(acc, {attn(par) + at, wseg0(0), ld4}, b, ring,
                             clk, tl, fm);
      dc_product<T, RT, 4>(acc, {hbuf(0, par) + at, wseg0(nseg0 - 1), ld4},
                           b, ring, clk, tl, fm);
      cluster_wait();
      clk.tick(DC_BARRIER);
      for (int i = tid; i < p.bt; i += DC_THREADS) prev[i] = __ldcg(tokb + b0 + i);
      __syncthreads();
      int live = 0;
      for (int i = tid; i < p.bt; i += DC_THREADS)
        live |= !(prev[i] == PAD || prev[i] == EOS);
      clk.tick(DC_READBACK);
      if (!__syncthreads_or(live)) {
        ended = true;
        break;
      }
      // the emb_gates rows of the tile's previous tokens over the block's
      // gate columns, as floats in the (free) ring: egs[r][q*U + u]
      float* egs = reinterpret_cast<float*>(ring0);
      // 4 units of each gate a thread (nu and U are multiples of 4)
      for (int i = tid; i < p.bt * (p.units / 4); i += DC_THREADS) {
        const int r = i / (p.units / 4), u = 4 * (i % (p.units / 4));
        const T* er = eg + (size_t)prev[r] * G + j0 + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float x[4] = {0.f, 0.f, 0.f, 0.f};
          if (u < b.nu) load_row(er + q * H, x);
          store4(egs + r * 4 * p.units + q * p.units + u, x);
        }
      }
      __syncthreads();
      T* hn = hbuf(0, nxt);
      dc_pairs<T, RT, 4>(acc, tl, fm, [&](int r, int u, const float(&v)[4][2]) {
        if (r >= b.nrows || u >= b.nu) return;
        const int j = j0 + u;
        const float* er = egs + r * 4 * p.units + u;
        float* cr = cell(r, 0, u);
        float x[4][2], h[2], act[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) load_row(er + q * p.units, x[q]);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          gate_math_parts(x[0][e] + v[0][e], x[1][e] + v[1][e],
                          x[2][e] + v[2][e], x[3][e] + v[3][e], cr[e], &cr[e],
                          &h[e], act);
        store2<T>(hn + b.aoff(r, j), h[0], h[1]);
      });
      clk.tick(DC_EPILOGUE);
      dc_publish();
    }
    // ---- 2. layers 1..nl-1
    for (int l = 1; l < nl; ++l) {
      DcAcc<T, RT, 4> acc;
      dc_zero(acc);
      dc_product<T, RT, 4>(acc, {hbuf(l, par) + at, wsegl(l, 0), ld4}, b,
                           ring, clk, tl, fm);
      cluster_wait();
      clk.tick(DC_BARRIER);
      dc_product<T, RT, 4>(acc, {hbuf(l - 1, nxt) + at, wsegl(l, 1), ld4}, b,
                           ring, clk, tl, fm);
      const float* bl = a.bx + (size_t)(l - 1) * G;
      T* hn = hbuf(l, nxt);
      dc_pairs<T, RT, 4>(acc, tl, fm, [&](int r, int u, const float(&v)[4][2]) {
        if (r >= b.nrows || u >= b.nu) return;
        const int j = j0 + u;
        float* cr = cell(r, l, u);
        float h[2], act[4];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          gate_math_parts(v[0][e] + bl[j + e], v[1][e] + bl[H + j + e],
                          v[2][e] + bl[2 * H + j + e],
                          v[3][e] + bl[3 * H + j + e], cr[e], &cr[e], &h[e],
                          act);
        store2<T>(hn + b.aoff(r, j), h[0], h[1]);
      });
      clk.tick(DC_EPILOGUE);
      dc_publish();
    }
    cluster_wait();
    clk.tick(DC_BARRIER);
    // ---- 3. q = h_top @ W_a and h_top @ W_c[H:]
    dc_query<T, RT>(hbuf(nl - 1, nxt) + at, wq, qb, ht, b, ring, clk, tl, fm);
    // ---- 4. the attention: of the own rows, or split by positions
    if constexpr (SPLIT) {
      gl_attend_split<T>(ctx, a.L, a.B, qb, spart, sml, a.np, rg, b, smem,
                         ring_bytes);
      clk.tick(DC_ATTEND);
      dc_publish();
      cluster_wait();
      clk.tick(DC_BARRIER);
      gl_attend_combine<T>(spart, sml, cvb, a.L, a.np, rg, b);
    } else {
      dc_attend_rows<T>(ctx, a.L, a.B, qb, cvb, qs, sc, cbuf, nb, b, ring,
                        (size_t)b0 + b.ra, 1);
    }
    clk.tick(DC_ATTEND);
    dc_publish();
    cluster_wait();
    clk.tick(DC_BARRIER);
    // ---- 5. h~ and the partial logits
    dc_htilde<T, RT>(cvb + at, wcx, attn(nxt), ht, pw, Vp, V, part, b, ring,
                     ring_bytes, clk, tl, fm);
    // ---- 6. logits, log-softmax, freeze, trie, argmax of the own rows
    dc_logits<T>(part, a.pb, Vp, V, lg, b);
    for (int r = warp; r < b.nown; r += DC_WARPS) {
      const int pv = prev[b.ra + r], node = onode[r];
      const bool frozen = pv == PAD || pv == EOS;
      dc_logp_row(lg + r * Vp, Vp, frozen);
      float best;
      int tk;
      dc_pick_row(lg + r * Vp, Vp, frozen,
                  [&](int v) {
                    return a.trie == nullptr ||
                           (v < V && a.trie[(size_t)node * V + v] >= 0) ||
                           (v == PAD && t > 0);
                  },
                  &best, &tk);
      if (lane == 0) {
        const size_t row = (size_t)(b0 + b.ra + r);
        if (a.trie != nullptr && !(tk == PAD && t > 0))
          onode[r] = tk < V ? max(a.trie[(size_t)node * V + tk], 0) : 0;
        oscore[r] += best;
        a.labels[row * T_ + t] = tk;
        tokb[row] = tk;
      }
    }
    clk.tick(DC_TAIL);
    dc_publish();
  }
  if (!ended) cluster_wait();  // every arrive has its wait
  __syncthreads();
  for (int i = tid; i < b.nown; i += DC_THREADS)
    a.scores[b0 + b.ra + i] = oscore[i];
#ifdef DC_PROBES
  if (tid == 0) {
    for (int i = 0; i < DC_NPHASES; ++i) atomicAdd(&gl_prof[i], dc_prof[i]);
    atomicAdd(&gl_prof[DC_NPHASES], 1ull);
  }
#endif
}

using GlKernel = void (*)(GlArgs, DcPlan);

// The instance for a plan: bf16 one, float32 one per rows a thread; each
// with the row split or the split by positions.
template <bool SPLIT>
static GlKernel gl_instance(int esz, int rt) {
  if (esz == 2) return greedy_cluster_kernel<__nv_bfloat16, 1, SPLIT>;
  if (rt == DC_FMA_RT[0])
    return greedy_cluster_kernel<float, DC_FMA_RT[0], SPLIT>;
  if (rt == DC_FMA_RT[1])
    return greedy_cluster_kernel<float, DC_FMA_RT[1], SPLIT>;
  return greedy_cluster_kernel<float, DC_FMA_RT[2], SPLIT>;
}
static GlKernel gl_kernel(int esz, int rt, int np) {
  return np ? gl_instance<true>(esz, rt) : gl_instance<false>(esz, rt);
}

// The plan of a launch; false where none fits or the card runs no cluster
// of its size.
static bool gl_launch_plan(int esz, int H, int B, int L, int Vp, int nl,
                           DcPlan* p, int* active) {
  int cs, U;
  dc_cluster(H, &cs, &U);
  *active = dc_active(gl_instance<false>(esz, DC_FMA_RT[2]), esz, cs);
  return *active > 0 && dc_plan(H, B, esz, L, Vp, nl, *active, p);
}

static int launch(int esz, const GlArgs& a, cudaStream_t stream) {
  DcPlan p;
  int active;
  if (a.L < 1 || a.B < 1 || a.T < 1 || a.nl < 1 || a.H < 4 || a.H % 4 ||
      a.V < 1 || a.Vp < a.V ||
      !gl_launch_plan(esz, a.H, a.B, a.L, a.Vp, a.nl, &p, &active))
    return (int)cudaErrorInvalidValue;
  GlArgs g = a;
  g.np = gl_split(p, esz, a.H, a.L, a.Vp);
  return dc_launch(gl_kernel(esz, p.rt, g.np), p, g, stream);
}

}  // namespace aocr

#define AOCR_LOOP_ARGS                                                       \
  const void *ctx, const void *c0, const void *h0, const void *eg,          \
      const void *w0, const void *wl, const void *bx, const void *wq,       \
      const void *wcx, const void *pw, const void *pb, const void *trie,    \
      void *labels, void *scores, void *scratch, int L, int B, int H,       \
      int Vp, int V, int T_, int nl, int input_feed, void *stream

static aocr::GlArgs gl_args(AOCR_LOOP_ARGS) {
  return {ctx, (const float*)c0, (const float*)h0, eg, w0, wl,
          (const float*)bx, wq, wcx, pw, (const float*)pb, (const int*)trie,
          (int*)labels, (float*)scores, (unsigned char*)scratch, L, B, H, Vp,
          V, T_, nl, input_feed};
}

extern "C" int aocr_greedy_loop_f32(AOCR_LOOP_ARGS) {
  return aocr::launch(4,
                      gl_args(ctx, c0, h0, eg, w0, wl, bx, wq, wcx, pw, pb,
                              trie, labels, scores, scratch, L, B, H, Vp, V,
                              T_, nl, input_feed, stream),
                      (cudaStream_t)stream);
}

extern "C" int aocr_greedy_loop_bf16(AOCR_LOOP_ARGS) {
  return aocr::launch(2,
                      gl_args(ctx, c0, h0, eg, w0, wl, bx, wq, wcx, pw, pb,
                              trie, labels, scores, scratch, L, B, H, Vp, V,
                              T_, nl, input_feed, stream),
                      (cudaStream_t)stream);
}

// The plan of a launch: out[0..8] = cs, units, bt, rt, kc, stages, cres,
// smem, clusters (as aocr_torch/ops/cuda/greedy_loop.py::plan gives them
// for out[9]) and out[9] = the clusters of cs blocks the card runs at once
// (cudaOccupancyMaxActiveClusters).  Returns a CUDA error code.
extern "C" int aocr_greedy_loop_plan(int H, int B, int is_f32, int L, int Vp,
                                     int nl, int* out) {
  aocr::DcPlan p;
  int active;
  if (!aocr::gl_launch_plan(is_f32 ? 4 : 2, H, B, L, Vp, nl, &p, &active))
    return (int)cudaErrorInvalidValue;
  const int v[10] = {p.cs, p.units, p.bt, p.rt, p.kc, p.stages, p.cres,
                     p.smem, p.clusters, active};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// The attention's position slices of a launch (gl_split, as
// aocr_torch/ops/cuda/greedy_loop.py::split gives them), 0 for the row
// split; -1 where no plan fits.
extern "C" int aocr_greedy_loop_split(int H, int B, int is_f32, int L, int Vp,
                                      int nl) {
  aocr::DcPlan p;
  int active;
  const int esz = is_f32 ? 4 : 2;
  if (!aocr::gl_launch_plan(esz, H, B, L, Vp, nl, &p, &active)) return -1;
  return aocr::gl_split(p, esz, H, L, Vp);
}
