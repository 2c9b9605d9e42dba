// The whole K-beam search after the t=1 GO step in one launch, on
// thread-block clusters.
//
// Replaces aocr/ops/pallas/beam_loop.py::fused_beam_loop (pl.pallas_call at
// beam_loop.py:514).  Each step t = 1 .. T-1 of each batch row: the LSTM
// stack of each of its K beams (the emb_gates row of the beam's previous
// token), the attention over the row's one context row, h~, the projector
// and log-softmax with the PAD/EOS freeze, the beam's score added, the
// trie's validity (PAD always valid), the top-K over the K x V candidates
// with refill (beam_tail.cuh); then row finality, the trie node step (PAD
// keeps the parent's node), the lengths (a PAD counts only when its parent
// was live), the per-row refill counts, and the token and parent
// histories.
//
// Design (decoder_cluster.cuh, as greedy_loop.cu): a cluster of cs blocks
// (16 at H=1024) owns a tile of nb whole batch rows with all K of their
// beams, nb = bt / K for one of the plan's tile sizes bt (beam rows past
// nb x K, and batch rows past B, start frozen as PAD, so they never keep
// the tile alive), for all steps.  Block s owns U = H/cs hidden units of
// every layer with their four gate columns and the same columns of W_a
// and W_c, and streams its packed weight slices (the wrapper's
// pack_weights, ops/cuda/greedy_loop.py) from L2 through the ring of bulk
// copies, multiplying them with the tile's beam rows on the tensor cores
// in bf16 (mma.sync) and on the CUDA cores in float32: each weight element
// read serves bt beam rows (5 in the previous design, one block a batch
// row, which streamed all the weights through one SM).
//
// The parent reorder moves no state.  The products are row-wise,
// gates[child r] = eg[tok_r] + [attn; h_0][parent(r)] @ W, so each block
// multiplies the exchange planes as they stand, in the last step's beam
// order, stores its accumulators to a float tile in shared memory and
// reads row parent(r) back for child r (the permuted epilogue).  So does
// the own-h half of each layer l >= 1, before its x half (the new h_{l-1},
// already in child order) adds to it.  The cell states c stay with the
// block that owns their units: it copies its columns to a scratch tile and
// reads each child's parent row from it.  q, the context vector and h~
// are computed from child-order rows and need nothing.  The only new
// datum that crosses the cluster is each beam row's parent, published
// beside its token.
//
// A step, with its cluster barriers (as greedy_loop.cu's):
//   1. layer 0's product over [attn; h0] as they stand, then the wait for
//      the last step's tokens and parents, read back (the early exit: every
//      block reads the same tokens and the cluster leaves at the same step
//      once every beam row of the tile is PAD or EOS), the permuted
//      epilogue, h0's slice published;
//   2. layer l >= 1: the product over its own last h_l, permuted to parent
//      rows; the wait for h_{l-1}, that half; the epilogue, h_l published;
//   3. q and h_top @ W_c[H:] over the block's columns, q published;
//   4. the row-split phases by batch row: block s owns the batch rows
//      [s Rb, (s+1) Rb) of the tile with all K beams (Rb = ceil(nb / cs)),
//      their attention, the context staged once for K beams;
//   5. h~ over the block's columns, published, and the partial logits;
//   6. for its batch rows: the logits (the cs partial sums in block
//      order, + b_p), log-softmax and freeze, the score added, the trie,
//      the top-K with refill, row finality, each new beam's node, length
//      and score from its parent (all owned by this block, so their
//      reorder is local), the histories, then tokens and parents
//      published.
//
// Dictionary decoding: the (N, V) int32 transition table stays in device
// memory, unpadded, read by node id (the TPU's one-hot f32 lookup was a
// Mosaic workaround).
//
// Row finality (beam_loop.py:227-241): a batch row whose K beams are all
// frozen at a step's start is final: it keeps its scores, writes identity
// parents and PAD, and no longer counts refills, so its transcript never
// depends on its batchmates or on tile boundaries.
//
// Bound on the H100: as greedy_loop.cu's, a step's chain of dependent
// phases, none near a roofline (tools/beam_loop_phases_torch.py, H100
// 80GB HBM3 at 700 W, the default decoder, K=5, T=50).  At B=512 in bf16
// (32 tiles of 16 batch rows x 5 beams, five waves of the seven 16-SM
// clusters the card runs at once) a step takes ~573K cycles a block: the
// mma products ~200K, waits for the stream ~82K, the epilogues ~70K, the
// attention ~68K, issuing the copies ~53K, the top-K ~29K, the permuted
// epilogue's stores and reloads ~26K, the partial projector ~24K.  At B=1
// (one tile, 3 batch rows) ~270K: the stream, the products' latency, and
// barriers where the blocks that own no batch row wait for the one that
// does.  float32 is bound by its FMA loop (~80% of a step at B=512).  The
// plan (bl_plan, mirrored by aocr_torch/ops/cuda/beam_loop.py::plan)
// sizes the tile; a shape no plan fits is refused.
#include "beam_tail.cuh"
#include "decoder_cluster.cuh"

namespace aocr {

constexpr int BL_MAX_K = 8;  // beam widths of the kernel

// the row stride (floats) of the float tile a layer's accumulators go
// through: four column blocks of U, 16 bytes of padding
__host__ __device__ inline int bl_ldf(int U) { return 4 * U + 4; }
// the per-row words of the shared memory (int32): the tile's tokens and
// parents; the own beam rows' score, node, length and their next values
// (score, parent, token, node, length); the own batch rows' valid picks,
// refills and fewest valid picks
__host__ __device__ inline long bl_words(int bt, int R, int Rb) {
  return 2L * bt + 8L * R + 3L * Rb;
}

// The shared memory of a beam plan with nb batch rows a tile: as dc_smem,
// with the per-row words of bl_words; the row-split phases overlay R = Rb
// x K rows of (H + L + Vp) floats, and the permuted epilogue the float
// tile (bt x bl_ldf) and a layer's cell states (bt x U floats), on the
// ring.  0 where an overlay does not fit.
static inline long bl_smem(const DcPlan& p, int nb, int K, int esz, int H,
                           int L, int Vp, int nl) {
  const DcGeom g = dc_geom(p, esz);
  const long ring = (long)p.stages * g.stage * esz;
  const int Rb = (nb + p.cs - 1) / p.cs, R = Rb * K;
  if ((long)R * (H + L + Vp) * 4 > ring ||
      (long)p.bt * (bl_ldf(p.units) + p.units) * 4 > ring)
    return 0;
  return ring + (long)p.bt * g.ldh * 4 + dc_cbytes(p, nl) +
         dc_round_up(bl_words(p.bt, R, Rb) * 4, 8) + DC_BARS;
}

// The launch plan for (H, B, K beams, esz, L, Vp, nl layers) and the
// clusters of that size the card runs at once (active): dc_beam_plan with
// bl_smem, for K up to BL_MAX_K; false where none fits.
static inline bool bl_plan(int H, int B, int K, int esz, int L, int Vp,
                           int nl, int active, DcPlan* out, int* nb_out) {
  return K <= BL_MAX_K &&
         dc_beam_plan(H, B, K, esz, active, DC_FIXED_ROWS,
                      [&](const DcPlan& q, int nb) {
                        return bl_smem(q, nb, K, esz, H, L, Vp, nl);
                      },
                      out, nb_out);
}

// Byte offsets of the scratch regions (zeroed by the caller): dc_scratch's
// (off[0..4]; the tokens region holds the tile's tokens), then the
// parents (int32, clusters x bt); off[6] is the total.
__host__ __device__ inline void bl_scratch(const DcPlan& p, int esz, int H,
                                           int nl, int V, long (&off)[7]) {
  long dc[6];
  dc_scratch(p, esz, H, nl, V, dc);
  for (int i = 0; i < 6; ++i) off[i] = dc[i];
  off[6] = off[5] + dc_round_up((long)p.clusters * p.bt * 4, DC_ALIGN);
}

struct BlArgs {
  const void* ctx;    // (L, B, H) compute dtype
  const float* init;  // (B, 2 nl + 1, H): attn, then c_l, h_l of each layer
  const int* tok0;    // (B, K)
  const float* sc0;   // (B, K)
  const int* node0;   // (B, K) or null
  const void* eg;     // (V, 4H)
  // the weights packed by block (ops/cuda/greedy_loop.py::pack_weights),
  // as greedy_loop.cu's GlArgs
  const void* w0;
  const void* wl;
  const float* bx;  // (nl-1, 4H)
  const void *wq, *wcx, *pw;  // the last two packs; the projector (H, Vp)
  const float* pb;            // (Vp,)
  const int* trie;            // (N, V) or null
  int* tok_hist;              // (T, B, K)
  int* par_hist;              // (T, B, K)
  float* scores;              // (B, K)
  int* lengths;               // (B, K)
  int* refills;               // (B,) or null
  int* minv;                  // (B,) or null
  unsigned char* scratch;     // bl_scratch's regions, zeroed
  int L, B, H, Vp, V, T, nl, input_feed, K, count_lengths;
  int nb;  // batch rows a tile (the plan's)
};

#ifdef DC_PROBES
// the phases' cycles summed over the blocks, then the block count
__device__ unsigned long long bl_prof[DC_NPHASES + 1];
#endif

__device__ __forceinline__ bool bl_frozen(int tok) {
  return tok == PAD || tok == EOS;
}

// RT: float32 rows a thread (DC_FMA_RT); bf16 instances take 1.
template <typename T, int RT>
__global__ void __launch_bounds__(DC_THREADS, 1)
beam_cluster_kernel(BlArgs a, DcPlan p) {
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
  const int K = a.K;
  const bool use_trie = a.trie != nullptr;

  const int cl = (int)blockIdx.x / p.cs;
  const int cb = cl * a.nb;                 // the tile's first batch row
  const int Rb = (a.nb + p.cs - 1) / p.cs;  // batch rows a block owns
  // the tile's real beam rows; each block's own rows are Rb batch rows
  const DcBlock<T> b = dc_block<T>(p, H, cl, max(0, min(a.nb, a.B - cb)) * K,
                                   Rb * K);
  const int nbo = b.nown / K;  // own real batch rows
  const int j0 = b.j0, b0 = b.b0, hs = b.hs, R = b.g.R, ldh = b.g.ldh;
  const int U = p.units, ldf = bl_ldf(U);
  const size_t BK = (size_t)a.B * K;
  const size_t gb0 = (size_t)cb * K + b.ra;  // own row 0's beam row in B*K

  // shared memory: the ring, the float tile (h_top @ W_c[H:], then
  // round_cd(h~)), the cell states (with cres), the per-row words
  // (bl_words), the mbarriers; the row-split phases' q rows, scores,
  // logits and staged context, the projector slice, and the permuted
  // epilogue's float tile and cell-state copy overlay the ring
  T* ring0 = reinterpret_cast<T*>(smem);
  float* ht = reinterpret_cast<float*>(smem + (size_t)p.stages * b.g.stage *
                                                  ESZ);
  float* csm = ht + p.bt * ldh;  // (tile row, layer, unit of the block)
  int* prev = reinterpret_cast<int*>(csm + dc_cbytes(p, nl) / 4);
  int* ppar = prev + p.bt;  // each tile row's parent beam (0..K-1)
  float* oscore = reinterpret_cast<float*>(ppar + p.bt);
  int* onode = reinterpret_cast<int*>(oscore + R);
  int* olen = onode + R;
  float* nsc = reinterpret_cast<float*>(olen + R);
  int* npar = reinterpret_cast<int*>(nsc + R);
  int* ntok = npar + R;
  int* nnode = ntok + R;
  int* nlen = nnode + R;
  int* nval = nlen + R;  // own batch rows
  int* orefill = nval + Rb;
  int* ominv = orefill + Rb;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(prev) +
      dc_round_up(bl_words(p.bt, R, Rb) * 4, 8));
  DcRing<T> ring = {ring0, bars, 0, 0};
  float* qs = reinterpret_cast<float*>(smem);
  float* sc = qs + R * H;
  float* lg = sc + R * a.L;
  // the attention's staged context rows (one a batch row) after them, as
  // many as fit
  const long ring_bytes = (long)p.stages * b.g.stage * ESZ;
  const long cb_off = dc_round_up((long)R * (H + a.L + Vp) * 4, 16);
  T* cbuf = reinterpret_cast<T*>(smem + cb_off);
  const int nst = (int)min((long)Rb, (ring_bytes - cb_off) /
                                         ((long)a.L * H * ESZ));
  // the permuted epilogue: the accumulators (bt x ldf) and one layer's
  // cell states of the block's units (bt x U)
  float* F = reinterpret_cast<float*>(smem);
  float* S = F + p.bt * ldf;

  // global scratch (bl_scratch)
  long off[7];
  bl_scratch(p, ESZ, H, nl, V, off);
  T* xb = reinterpret_cast<T*>(a.scratch + off[0]);
  const size_t plane = (size_t)dc_plane(p, ESZ, H);
  auto attn = [&](int par) { return xb + par * plane; };
  auto hbuf = [&](int l, int par) { return xb + (2 + 2 * l + par) * plane; };
  T* cvb = xb + (2 + 2 * nl) * plane;
  const size_t at = b.atile();
  constexpr int WP = 16 / ESZ;
  const int ld4 = 4 * U + WP, nseg0 = a.input_feed ? 2 : 1;
  const size_t seg4 = (size_t)hs * ld4;
  auto wseg0 = [&](int k) {
    return w0 + ((size_t)b.rank * nseg0 + k) * seg4;
  };
  auto wsegl = [&](int l, int k) {
    return wl + (((size_t)(l - 1) * p.cs + b.rank) * 2 + k) * seg4;
  };
  float* qb = reinterpret_cast<float*>(a.scratch + off[1]);
  float* cb_l2 = reinterpret_cast<float*>(a.scratch + off[2]);
  float* part = reinterpret_cast<float*>(a.scratch + off[3]);
  int* tokb = reinterpret_cast<int*>(a.scratch + off[4]);
  int* parb = reinterpret_cast<int*>(a.scratch + off[5]);

  const DcTiles tl(U, p.rt);
  const DcFma fm(U, RT);
  DcClock clk;

  if (tid == 0) {
    for (int i = 0; i <= DC_MAX_STAGES; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // c of (tile row r, layer l, unit j0 + u)
  auto cell = [&](int r, int l, int u) {
    return p.cres ? csm + ((size_t)r * nl + l) * U + u
                  : cb_l2 + ((size_t)(b0 + r) * nl + l) * H + j0 + u;
  };
  // every beam of a batch row starts from the row's t=1 state: attn, then
  // c_l and h_l of each layer (h and attn rounded into the planes)
  const int nslot = 2 * nl + 1;
  for (int i = tid; i < b.nrows * b.nu; i += DC_THREADS) {
    const int r = i / b.nu, u = i % b.nu, j = j0 + u;
    const float* st = a.init + (size_t)(cb + r / K) * nslot * H + j;
    attn(0)[b.aoff(r, j)] = from_f<T>(st[0]);
    for (int l = 0; l < nl; ++l) {
      *cell(r, l, u) = st[(size_t)(1 + 2 * l) * H];
      hbuf(l, 0)[b.aoff(r, j)] = from_f<T>(st[(size_t)(2 + 2 * l) * H]);
    }
  }
  // the own rows: histories (t = 0 the t=1 picks, later PAD and identity
  // parents, what a final row writes), tokens, parents, scores, nodes,
  // lengths; rows past the batch keep the scratch's zeros (PAD, parent 0)
  for (int i = tid; i < b.nown * T_; i += DC_THREADS) {
    const int t = i / b.nown, r = i % b.nown;
    const size_t g = (size_t)t * BK + gb0 + r;
    a.tok_hist[g] = t == 0 ? a.tok0[gb0 + r] : PAD;
    a.par_hist[g] = r % K;
  }
  for (int r = tid; r < b.nown; r += DC_THREADS) {
    tokb[b0 + b.ra + r] = a.tok0[gb0 + r];
    parb[b0 + b.ra + r] = r % K;
    oscore[r] = a.sc0[gb0 + r];
    onode[r] = use_trie ? a.node0[gb0 + r] : 0;
    olen[r] = 1;
  }
  for (int i = tid; i < nbo; i += DC_THREADS) {
    orefill[i] = 0;
    ominv[i] = K;
  }
  fence_proxy_async();
  cluster_barrier();
  cluster_arrive();  // the tokens and parents of "step 0"

  // the tile row of row r's parent
  auto src = [&](int r) { return r / K * K + ppar[r]; };
  // a layer's accumulators into the float tile F, rows as they stand
  auto store = [&](auto& acc) {
    dc_elems<T, RT, 4>(acc, tl, fm,
                       [&](int r, int q, int u, float& x0, float& x1) {
                         store2<float>(F + r * ldf + q * U + u, x0, x1);
                       });
  };
  // ... and the layer's cell states of the block's units into S, for the
  // epilogue
  auto spill = [&](auto& acc, int l) {
    store(acc);
    for (int i = tid; i < b.nrows * b.nu; i += DC_THREADS) {
      const int r = i / b.nu, u = i % b.nu;
      S[r * U + u] = *cell(r, l, u);
    }
    __syncthreads();
  };
  // the permuted epilogue of layer l: child r's gates from F's row
  // parent(r) (layer 0, + its token's emb_gates row) or r (layers >= 1,
  // + the bias), its cell state from S's row parent(r); new c in place,
  // h into hn.  Unit pairs, neighbouring threads on neighbouring units.
  auto epilogue = [&](int l, T* hn) {
    const int np = b.nu / 2;
    for (int i = tid; i < b.nrows * np; i += DC_THREADS) {
      const int r = i / np, u = 2 * (i % np), j = j0 + u, pr = src(r);
      const float* f = F + (l == 0 ? pr : r) * ldf + u;
      float x[4][2];
      if (l == 0) {
        const T* er = eg + (size_t)prev[r] * G + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) load_row(er + (size_t)q * H, x[q]);
      } else {
        const float* bl = a.bx + (size_t)(l - 1) * G + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) load_row(bl + (size_t)q * H, x[q]);
      }
      float h[2], act[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float c;
        gate_math_parts(f[e] + x[0][e], f[U + e] + x[1][e],
                        f[2 * U + e] + x[2][e], f[3 * U + e] + x[3][e],
                        S[pr * U + u + e], &c, &h[e], act);
        *cell(r, l, u + e) = c;
      }
      store2<T>(hn + b.aoff(r, j), h[0], h[1]);
    }
  };

  bool ended = false;  // the early exit; uniform across the cluster
  for (int t = 1; t < T_; ++t) {
    const int par = (t - 1) & 1, nxt = par ^ 1;
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
      for (int i = tid; i < p.bt; i += DC_THREADS) {
        prev[i] = __ldcg(tokb + b0 + i);
        ppar[i] = __ldcg(parb + b0 + i);
      }
      __syncthreads();
      int live = 0;
      for (int i = tid; i < p.bt; i += DC_THREADS) live |= !bl_frozen(prev[i]);
      clk.tick(DC_READBACK);
      if (!__syncthreads_or(live)) {
        ended = true;
        break;
      }
      spill(acc, 0);
      clk.tick(DC_PERMUTE);
      epilogue(0, hbuf(0, nxt));
      clk.tick(DC_EPILOGUE);
      dc_publish();
    }
    // ---- 2. layers 1..nl-1
    for (int l = 1; l < nl; ++l) {
      DcAcc<T, RT, 4> acc;
      dc_zero(acc);
      dc_product<T, RT, 4>(acc, {hbuf(l, par) + at, wsegl(l, 0), ld4}, b,
                           ring, clk, tl, fm);
      // the own-h half to parent rows, through F
      store(acc);
      __syncthreads();
      dc_elems<T, RT, 4>(acc, tl, fm,
                         [&](int r, int q, int u, float& x0, float& x1) {
                           const float2 v = *reinterpret_cast<const float2*>(
                               F + src(r) * ldf + q * U + u);
                           x0 = v.x;
                           x1 = v.y;
                         });
      clk.tick(DC_PERMUTE);
      cluster_wait();
      clk.tick(DC_BARRIER);
      dc_product<T, RT, 4>(acc, {hbuf(l - 1, nxt) + at, wsegl(l, 1), ld4}, b,
                           ring, clk, tl, fm);
      spill(acc, l);
      clk.tick(DC_PERMUTE);
      epilogue(l, hbuf(l, nxt));
      clk.tick(DC_EPILOGUE);
      dc_publish();
    }
    cluster_wait();
    clk.tick(DC_BARRIER);
    // ---- 3. q = h_top @ W_a and h_top @ W_c[H:]
    dc_query<T, RT>(hbuf(nl - 1, nxt) + at, wq, qb, ht, b, ring, clk, tl, fm);
    // ---- 4. the attention of the own batch rows' beams
    dc_attend_rows<T>(ctx, a.L, a.B, qb, cvb, qs, sc, cbuf, nst, b, ring,
                      (size_t)cb + b.ra / K, K);
    clk.tick(DC_ATTEND);
    dc_publish();
    cluster_wait();
    clk.tick(DC_BARRIER);
    // ---- 5. h~ and the partial logits
    dc_htilde<T, RT>(cvb + at, wcx, attn(nxt), ht, pw, Vp, V, part, b, ring,
                     ring_bytes, clk, tl, fm);
    // ---- 6. the own batch rows: logits, log-softmax, freeze, scores,
    // trie, top-K, finality, the beams' bookkeeping
    dc_logits<T>(part, a.pb, Vp, V, lg, b);
    // each beam's candidates: its score + the frozen log-probs, NEG_BIG
    // where the trie forbids (PAD always valid); a warp a beam row
    for (int r = warp; r < b.nown; r += DC_WARPS) {
      float* x = lg + r * Vp;
      dc_logp_row(x, Vp, bl_frozen(prev[b.ra + r]));
      const int node = onode[r];
      const float s = oscore[r];
      for (int v = lane; v < V; v += 32) {
        const bool ok =
            !use_trie || v == PAD || a.trie[(size_t)node * V + v] >= 0;
        x[v] = ok ? s + x[v] : NEG_BIG;
      }
    }
    __syncthreads();
    // the top-K over K x V with refill: a warp a batch row
    for (int bi = warp; bi < nbo; bi += DC_WARPS) {
      const int nv = beam_topk_warp(lg + bi * K * Vp, Vp, K, V, use_trie,
                                    nsc + bi * K, npar + bi * K,
                                    ntok + bi * K);
      if (lane == 0) nval[bi] = nv;
    }
    __syncthreads();
    clk.tick(DC_TOPK);
    // row finality, then each new beam's node, length and score from its
    // parent, and the histories
    for (int r = tid; r < b.nown; r += DC_THREADS) {
      const int bi = r / K, j = r % K;
      bool live = false;
      for (int k = 0; k < K; ++k)
        live |= !bl_frozen(prev[b.ra + bi * K + k]);
      if (!live) {
        npar[r] = j;
        ntok[r] = PAD;
        nsc[r] = oscore[r];
      }
      const int pj = npar[r], tk = ntok[r], pr = bi * K + pj;
      nnode[r] = !use_trie ? 0
                 : tk == PAD
                     ? onode[pr]
                     : max(a.trie[(size_t)onode[pr] * V + tk], 0);
      nlen[r] = a.count_lengths
                    ? olen[pr] + ((tk != PAD) || !bl_frozen(prev[b.ra + pr]))
                    : olen[r];
      const size_t g = (size_t)t * BK + gb0 + r;
      a.tok_hist[g] = tk;
      a.par_hist[g] = pj;
      if (use_trie && j == 0) {
        if (live && nval[bi] < K) ++orefill[bi];
        ominv[bi] = min(ominv[bi], live ? nval[bi] : K);
      }
    }
    __syncthreads();
    for (int r = tid; r < b.nown; r += DC_THREADS) {
      oscore[r] = nsc[r];
      onode[r] = nnode[r];
      olen[r] = nlen[r];
      tokb[b0 + b.ra + r] = ntok[r];
      parb[b0 + b.ra + r] = npar[r];
    }
    clk.tick(DC_TAIL);
    dc_publish();
  }
  if (!ended) cluster_wait();  // every arrive has its wait
  __syncthreads();
  for (int r = tid; r < b.nown; r += DC_THREADS) {
    a.scores[gb0 + r] = oscore[r];
    a.lengths[gb0 + r] = olen[r];
  }
  for (int i = tid; use_trie && i < nbo; i += DC_THREADS) {
    a.refills[cb + b.ra / K + i] = orefill[i];
    a.minv[cb + b.ra / K + i] = ominv[i];
  }
#ifdef DC_PROBES
  if (tid == 0) {
    for (int i = 0; i < DC_NPHASES; ++i) atomicAdd(&bl_prof[i], dc_prof[i]);
    atomicAdd(&bl_prof[DC_NPHASES], 1ull);
  }
#endif
}

using BlKernel = void (*)(BlArgs, DcPlan);

// The instance for a plan: bf16 one, float32 one per rows a thread.
static BlKernel bl_kernel(int esz, int rt) {
  if (esz == 2) return beam_cluster_kernel<__nv_bfloat16, 1>;
  if (rt == DC_FMA_RT[0]) return beam_cluster_kernel<float, DC_FMA_RT[0]>;
  if (rt == DC_FMA_RT[1]) return beam_cluster_kernel<float, DC_FMA_RT[1]>;
  return beam_cluster_kernel<float, DC_FMA_RT[2]>;
}

// The plan of a launch; false where none fits or the card runs no cluster
// of its size.
static bool bl_launch_plan(int esz, int H, int B, int K, int L, int Vp,
                           int nl, DcPlan* p, int* nb, int* active) {
  int cs, U;
  dc_cluster(H, &cs, &U);
  *active = dc_active(bl_kernel(esz, DC_FMA_RT[2]), esz, cs);
  return *active > 0 && bl_plan(H, B, K, esz, L, Vp, nl, *active, p, nb);
}

static int launch(int esz, BlArgs a, cudaStream_t stream) {
  DcPlan p;
  int active;
  if (a.L < 1 || a.B < 1 || a.T < 1 || a.nl < 1 || a.H < 4 || a.H % 4 ||
      a.V < 1 || a.Vp < a.V || a.K > a.V ||
      !bl_launch_plan(esz, a.H, a.B, a.K, a.L, a.Vp, a.nl, &p, &a.nb,
                      &active))
    return (int)cudaErrorInvalidValue;
  return dc_launch(bl_kernel(esz, p.rt), p, a, stream);
}

}  // namespace aocr

#define AOCR_BEAM_LOOP_ARGS                                                  \
  const void *ctx, const void *init, const void *tok0, const void *sc0,     \
      const void *node0, const void *eg, const void *w0, const void *wl,    \
      const void *bx, const void *wq, const void *wcx, const void *pw,      \
      const void *pb, const void *trie, void *tok_hist, void *par_hist,     \
      void *fsc, void *flen, void *refills, void *minv, void *scratch,      \
      int L, int B, int H, int Vp, int V, int T_, int nl, int input_feed,   \
      int K, int count_lengths, void *stream

static aocr::BlArgs bl_args(AOCR_BEAM_LOOP_ARGS) {
  return {ctx, (const float*)init, (const int*)tok0, (const float*)sc0,
          (const int*)node0, eg, w0, wl, (const float*)bx, wq, wcx, pw,
          (const float*)pb, (const int*)trie, (int*)tok_hist,
          (int*)par_hist, (float*)fsc, (int*)flen, (int*)refills,
          (int*)minv, (unsigned char*)scratch, L, B, H, Vp, V, T_, nl,
          input_feed, K, count_lengths, 0};
}

extern "C" int aocr_beam_loop_f32(AOCR_BEAM_LOOP_ARGS) {
  return aocr::launch(
      4,
      bl_args(ctx, init, tok0, sc0, node0, eg, w0, wl, bx, wq, wcx, pw, pb,
              trie, tok_hist, par_hist, fsc, flen, refills, minv, scratch, L,
              B, H, Vp, V, T_, nl, input_feed, K, count_lengths, stream),
      (cudaStream_t)stream);
}

extern "C" int aocr_beam_loop_bf16(AOCR_BEAM_LOOP_ARGS) {
  return aocr::launch(
      2,
      bl_args(ctx, init, tok0, sc0, node0, eg, w0, wl, bx, wq, wcx, pw, pb,
              trie, tok_hist, par_hist, fsc, flen, refills, minv, scratch, L,
              B, H, Vp, V, T_, nl, input_feed, K, count_lengths, stream),
      (cudaStream_t)stream);
}

// The plan of a launch: out[0..9] = cs, units, bt, rt, kc, stages, cres,
// smem, clusters, nb (as aocr_torch/ops/cuda/beam_loop.py::plan gives them
// for out[10]) and out[10] = the clusters of cs blocks the card runs at
// once (cudaOccupancyMaxActiveClusters).  Returns a CUDA error code.
extern "C" int aocr_beam_loop_plan(int H, int B, int K, int is_f32, int L,
                                   int Vp, int nl, int* out) {
  aocr::DcPlan p;
  int nb, active;
  if (!aocr::bl_launch_plan(is_f32 ? 4 : 2, H, B, K, L, Vp, nl, &p, &nb,
                            &active))
    return (int)cudaErrorInvalidValue;
  const int v[11] = {p.cs,   p.units, p.bt,       p.rt, p.kc,  p.stages,
                     p.cres, p.smem,  p.clusters, nb,   active};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}
