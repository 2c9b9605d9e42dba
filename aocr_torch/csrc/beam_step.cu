// One beam-search step after the LSTM stack: grouped attention, h~, the
// projector, log-softmax, the PAD/EOS freeze, the score add, the optional
// trie plane, and the top-K over the K x V candidates of each batch row,
// with refill.
//
// Replaces aocr/ops/pallas/beam_step.py::fused_beam_tail (pl.pallas_call
// at beam_step.py:185).  Inputs: the packed (B, K*H) top hidden state (row-
// major identical to (B*K, H)), the scan-major (L, B, H) context, prev and
// scores (B, K), and optionally a (B, K*Vp) float32 0/1 validity plane
// gathered from the trie.  Outputs: h~ (B, K*H) float32, new scores,
// parents and tokens (B, K), and with the plane the valid-candidate count
// (B,).
//
// Design (step_cluster.cuh, on decoder_cluster.cuh, as beam_loop.cu's
// step after its LSTM stack): a cluster of cs blocks owns a tile of nb =
// bt / K whole batch rows with all K beams, and each weight element read
// serves the tile's bt beam rows (the first port's kernel, below,
// streamed all the weights through one block a batch row).  The top-K is
// split by batch rows: block s runs beam_tail.cuh's top-K for batch rows
// [s Rb, (s+1) Rb), a warp a row, from its own candidates where its beam
// rows are whole batch rows (K=5 at B=512), else from the tile's,
// exchanged through L2 (bs_exchange; a kernel instance of its own).  Four
// cluster barriers a launch, five with the exchange.
//
// Bound on the H100: as beam_loop.cu's step without the LSTM stack, a
// chain of dependent phases (stream and products, attention, h~ and the
// partial projector, the top-K) over waves of tiles; the weights (6.3 MB
// in bf16 at H=1024) are read once a tile.
//
// The rows route: a shape that no cluster plan takes (more beams than the
// largest tile holds, their row-split scratch past a block's shared
// memory, or H past 16 blocks of DC_MAX_UNITS) runs the first port's
// kernel, one block a batch row (beam_rows_kernel).  The wrapper logs the
// route once per shape.
#include "step_cluster.cuh"

namespace aocr {

// The beam step's instance for a plan, with and without the exchange.
static BsKernel bs_kernel(int esz, int rt, bool x) {
  return x ? bs_kernel_x<true, false>(esz, rt)
           : bs_kernel_x<false, false>(esz, rt);
}

// bs_launch_plan for the beam step's instances
static bool bs_beam_plan(int esz, int H, int B, int K, int L, int Vp,
                         DcPlan* p, int* nb, int* active) {
  return bs_launch_plan(bs_kernel(esz, DC_FMA_RT[2], false), esz, H, B, K,
                        L, Vp, p, nb, active);
}

// ---------------------------------------------------------------- rows

// The first port's kernel: one block owns one batch row and all its K
// beams, which go through attention and the projector in chunks of
// BEAM_BT rows (any K, up to V) on decode_tail.cuh's CUDA-core products,
// each chunk streaming W_a, W_c and the projector from L2; each chunk's
// scored candidates land in a K x V buffer in shared memory, and one warp
// runs the top-K over it.
constexpr int BEAM_BT = 8;  // beam rows of a chunk

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
beam_rows_kernel(const T* __restrict__ ctx,       // (L, B, H)
                 const T* __restrict__ h,         // (B*K, H)
                 const int* __restrict__ prev,    // (B, K)
                 const float* __restrict__ scores,  // (B, K)
                 const T* __restrict__ wa, const T* __restrict__ wc,
                 const T* __restrict__ pw, const float* __restrict__ pb,
                 const float* __restrict__ valid,  // (B, K*Vp) or null
                 float* __restrict__ htilde,      // (B*K, H)
                 float* __restrict__ nsc,         // (B, K)
                 int* __restrict__ par, int* __restrict__ tok,  // (B, K)
                 int* __restrict__ nvalid,        // (B,) or null
                 int L, int B, int H, int Vp, int V, int K) {
  constexpr int BT = BEAM_BT;
  extern __shared__ float rsm[];
  TailSmemT<BT> sm(rsm, H, L, Vp);
  float* tot = sm.delta + BT;          // K x V scored candidates
  float* score = tot + (size_t)K * V;  // K running scores
  float* osc = score + K;              // K: the top-K's scores
  int* opar = reinterpret_cast<int*>(osc + K);
  int* otok = opar + K;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b = blockIdx.x;
  const size_t r0 = (size_t)b * K;  // the row's first beam
  for (int k = tid; k < K; k += nthr) score[k] = scores[r0 + k];

  for (int c0 = 0; c0 < K; c0 += BT) {
    const int nrows = min(BT, K - c0);
    for (int i = tid; i < BT * H; i += nthr) {
      const int r = i / H, j = i % H;
      sm.X[r * 2 * H + H + j] =
          r < nrows ? to_f(h[(r0 + c0 + r) * H + j]) : 0.f;
    }
    if (tid < BT) sm.prev[tid] = tid < nrows ? prev[r0 + c0 + tid] : PAD;
    __syncthreads();
    // every row of the chunk attends over context row b (r / BT == 0)
    attention_htilde(
        ctx, L, B, H, b, nrows, wa, wc, sm,
        [&](int r, int j, float v) { htilde[(r0 + c0 + r) * H + j] = v; },
        BT);
    projector_logp<T>(H, nrows, pw, pb, Vp, sm);
    for (int i = tid; i < nrows * V; i += nthr) {
      const int r = i / V, v = i % V, k = c0 + r;
      const bool ok =
          valid == nullptr || valid[(r0 + k) * Vp + v] > 0.f;
      tot[k * V + v] = ok ? score[k] + sm.P[r * Vp + v] : NEG_BIG;
    }
    __syncthreads();
  }

  if (tid < 32) {
    const int nv =
        beam_topk_warp(tot, V, K, V, valid != nullptr, osc, opar, otok);
    if (tid == 0 && nvalid != nullptr) nvalid[b] = nv;
  }
  __syncthreads();
  for (int k = tid; k < K; k += nthr) {
    nsc[r0 + k] = osc[k];
    par[r0 + k] = opar[k];
    tok[r0 + k] = otok[k];
  }
}

template <typename T>
static int rows_launch(const void* ctx, const void* h, const void* prev,
                  const void* scores, const void* wa, const void* wc,
                  const void* pw, const void* pb, const void* valid,
                  void* htilde, void* nsc, void* par, void* tok, void* nvalid,
                  int L, int B, int H, int Vp, int V, int K,
                  cudaStream_t stream) {
  size_t smem = TailSmemT<BEAM_BT>::bytes(H, L, Vp, K * V + 4 * K);
  cudaError_t e = set_smem((const void*)beam_rows_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  beam_rows_kernel<T><<<B, DEC_THREADS, smem, stream>>>(
      (const T*)ctx, (const T*)h, (const int*)prev, (const float*)scores,
      (const T*)wa, (const T*)wc, (const T*)pw, (const float*)pb,
      (const float*)valid, (float*)htilde, (float*)nsc, (int*)par, (int*)tok,
      (int*)nvalid, L, B, H, Vp, V, K);
  return (int)cudaGetLastError();
}


// The launch: the cluster kernel on the plan's tiles, or the rows kernel
// where no plan fits.  nb: the plan the caller sized the scratch for (0:
// the rows route); a launch of another plan is refused.
static int launch(int esz, BsArgs a, const void* wa, const void* wc,
                  int nb, cudaStream_t stream) {
  DcPlan p;
  int pnb = 0, active;
  if (a.L < 1 || a.B < 1 || a.H < 4 || a.H % 4 || a.V < 1 || a.Vp < a.V ||
      a.K < 1 || a.K > a.V)
    return (int)cudaErrorInvalidValue;
  if (!bs_beam_plan(esz, a.H, a.B, a.K, a.L, a.Vp, &p, &pnb, &active))
    pnb = 0;
  if (pnb != nb) return (int)cudaErrorInvalidValue;
  if (nb > 0) {
    a.nb = nb;
    return dc_launch(bs_kernel(esz, p.rt, bs_exchange(p, a.K)), p, a,
                     stream);
  }
  auto rows = esz == 4 ? rows_launch<float> : rows_launch<__nv_bfloat16>;
  return rows(a.ctx, a.h, a.prev, a.scores, wa, wc, a.pw, a.pb, a.valid,
              a.htilde, a.nsc, a.par, a.tok, a.nvalid, a.L, a.B, a.H, a.Vp,
              a.V, a.K, stream);
}

}  // namespace aocr

#define AOCR_BEAM_STEP_ARGS                                                 \
  const void *ctx, const void *h, const void *prev, const void *scores,    \
      const void *wa, const void *wc, const void *wq, const void *wcx,     \
      const void *pw, const void *pb, const void *valid, void *htilde,     \
      void *nsc, void *par, void *tok, void *nvalid, void *scratch, int L, \
      int B, int H, int Vp, int V, int K, int nb, void *stream

static aocr::BsArgs bs_args(AOCR_BEAM_STEP_ARGS) {
  return {ctx, h, (const int*)prev, (const float*)scores, wq, wcx, pw,
          (const float*)pb, (const float*)valid, (float*)htilde,
          (float*)nsc, (int*)par, (int*)tok, (int*)nvalid,
          (unsigned char*)scratch, L, B, H, Vp, V, K, 0};
}

// wa, wc: the raw weights (the rows route); wq, wcx and scratch: the
// cluster route's packed weights and bs_scratch's bytes.
extern "C" int aocr_beam_step_f32(AOCR_BEAM_STEP_ARGS) {
  return aocr::launch(
      4,
      bs_args(ctx, h, prev, scores, wa, wc, wq, wcx, pw, pb, valid, htilde,
              nsc, par, tok, nvalid, scratch, L, B, H, Vp, V, K, nb, stream),
      wa, wc, nb, (cudaStream_t)stream);
}

extern "C" int aocr_beam_step_bf16(AOCR_BEAM_STEP_ARGS) {
  return aocr::launch(
      2,
      bs_args(ctx, h, prev, scores, wa, wc, wq, wcx, pw, pb, valid, htilde,
              nsc, par, tok, nvalid, scratch, L, B, H, Vp, V, K, nb, stream),
      wa, wc, nb, (cudaStream_t)stream);
}

// The plan of a launch: out[0..9] = cs, units, bt, rt, kc, stages, cres,
// smem, clusters, nb (as aocr_torch/ops/cuda/beam_step.py::plan gives
// them for out[10]; all 0 for the rows route) and out[10] = the clusters
// of cs blocks the card runs at once.  Returns a CUDA error code.
extern "C" int aocr_beam_step_plan(int H, int B, int K, int is_f32, int L,
                                   int Vp, int* out) {
  aocr::DcPlan p = {};
  int nb = 0, active;
  if (!aocr::bs_beam_plan(is_f32 ? 4 : 2, H, B, K, L, Vp, &p, &nb,
                          &active)) {
    p = {};
    nb = 0;
  }
  const int v[11] = {p.cs,   p.units, p.bt,       p.rt, p.kc,  p.stages,
                     p.cres, p.smem,  p.clusters, nb,   active};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}
