// One greedy step after the LSTM stack: attention, h~, projector,
// log-softmax, PAD/EOS freeze, argmax.
//
// Replaces aocr/ops/pallas/decode_step.py::fused_decode_tail (pl.pallas_call
// at decode_step.py:199), with its optional trie plane: a (B, Vp) float32
// 0/1 validity plane that the caller gathers from the transition table;
// invalid log-probs count as -1e30 before the argmax, then the freeze
// (decode_step.py:115-128).
//
// Design: beam_step.cu's cluster step at K = 1 (step_cluster.cuh, on
// decoder_cluster.cuh).  A cluster of cs blocks (16 at H=1024) owns a
// tile of bt batch rows; block s streams its column slices of [W_a |
// W_c[H:]] and W_c[:H] (greedy_loop.py::pack_weights' wq and wc, packed
// once a decode by the caller) from L2 through the ring of bulk copies and
// multiplies them with the tile's rows on the tensor cores in bf16 or the
// CUDA cores in float32, so each weight element read serves the tile's bt
// rows; the attention (q and alpha in float32), the log-softmax, the freeze
// and the argmax (decode_tail.cuh's projector_pick: the plane first, then
// the freeze, ties to the lowest index, an all-NaN row picks PAD) are
// split by rows, a warp a row.  The TPU kernel keeps the weights resident
// across its batch grid; the cluster reads each element once a tile.
//
// Bound on the H100: the 2 H x 3 H weight products of every row (0.049 ms
// of float32 issue at B=512, H=1024) or, in bf16, the weights and the
// context read once (0.010 ms); the launch is a chain of dependent phases
// (stream and products, attention, h~ and the partial projector, the
// pick) over one wave of tiles at B=512.
//
// The rows route: where no cluster plan fits (the card runs no cluster of
// the size, or H past 16 blocks of DC_MAX_UNITS), or where the caller asks
// for it, the first port's kernel runs: one block of 256 threads takes
// DEC_BT = 4 batch rows and streams all the weights through the CUDA cores
// (decode_tail.cuh).  The wrapper logs the route once per shape.
#include "step_cluster.cuh"

namespace aocr {

// ---------------------------------------------------------------- rows

// The first port's kernel: a block of DEC_THREADS takes DEC_BT batch rows
// through decode_tail.cuh's attention_tail.
template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
decode_step_kernel(const T* __restrict__ h,      // (B, H)
                   const T* __restrict__ ctx,    // (L, B, H)
                   const int* __restrict__ prev, // (B,)
                   const T* __restrict__ wa, const T* __restrict__ wc,
                   const T* __restrict__ pw, const float* __restrict__ pb,
                   const float* __restrict__ valid,  // (B, Vp) or null
                   float* __restrict__ htilde,   // (B, H)
                   int* __restrict__ tok, float* __restrict__ delta,  // (B,)
                   int L, int B, int H, int Vp) {
  extern __shared__ float dsm[];
  TailSmem sm(dsm, H, L, Vp);
  const int b0 = blockIdx.x * DEC_BT;
  const int nrows = min(DEC_BT, B - b0);
  for (int i = threadIdx.x; i < DEC_BT * H; i += blockDim.x) {
    const int r = i / H, j = i % H;
    sm.X[r * 2 * H + H + j] =
        r < nrows ? to_f(h[(size_t)(b0 + r) * H + j]) : 0.f;
  }
  if (threadIdx.x < DEC_BT)
    sm.prev[threadIdx.x] = threadIdx.x < nrows ? prev[b0 + threadIdx.x] : PAD;
  __syncthreads();
  attention_tail<T>(
      ctx, L, B, H, b0, nrows, wa, wc, pw, pb, Vp, sm,
      [&](int r, int j, float v) { htilde[(size_t)(b0 + r) * H + j] = v; },
      [&](int r, int v) {
        return valid == nullptr || valid[(size_t)(b0 + r) * Vp + v] > 0.f;
      });
  if (threadIdx.x < nrows) {
    tok[b0 + threadIdx.x] = sm.tok[threadIdx.x];
    delta[b0 + threadIdx.x] = sm.delta[threadIdx.x];
  }
}

template <typename T>
static int rows_launch(const void* h, const void* ctx, const void* prev,
                       const void* wa, const void* wc, const void* pw,
                       const void* pb, const void* valid, void* htilde,
                       void* tok, void* delta, int L, int B, int H, int Vp,
                       cudaStream_t stream) {
  size_t smem = TailSmem::bytes(H, L, Vp, 0);
  cudaError_t e = set_smem((const void*)decode_step_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + DEC_BT - 1) / DEC_BT);
  decode_step_kernel<T><<<grid, DEC_THREADS, smem, stream>>>(
      (const T*)h, (const T*)ctx, (const int*)prev, (const T*)wa,
      (const T*)wc, (const T*)pw, (const float*)pb, (const float*)valid,
      (float*)htilde, (int*)tok, (float*)delta, L, B, H, Vp);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- cluster

// The greedy step's instance for a plan (step_cluster.cuh, K = 1).
static BsKernel ds_kernel(int esz, int rt) {
  return bs_kernel_x<false, true>(esz, rt);
}

// bs_launch_plan at K = 1 for the greedy step's instances
static bool ds_plan(int esz, int H, int B, int L, int Vp, DcPlan* p, int* nb,
                    int* active) {
  return bs_launch_plan(ds_kernel(esz, DC_FMA_RT[2]), esz, H, B, 1, L, Vp,
                        p, nb, active);
}

// The launch: the cluster kernel on the plan's tiles, or the rows kernel
// (nb = 0).  nb: the plan the caller packed the weights and sized the
// scratch for; a cluster launch of another plan is refused.
static int launch(int esz, BsArgs a, const void* wa, const void* wc, int nb,
                  cudaStream_t stream) {
  if (a.L < 1 || a.B < 1 || a.H < 4 || a.H % 4 || a.Vp < 4 || a.Vp % 4 ||
      a.V < 1 || a.V > a.Vp)
    return (int)cudaErrorInvalidValue;
  if (nb > 0) {
    DcPlan p;
    int pnb = 0, active;
    if (!ds_plan(esz, a.H, a.B, a.L, a.Vp, &p, &pnb, &active) || pnb != nb)
      return (int)cudaErrorInvalidValue;
    a.nb = nb;
    return dc_launch(ds_kernel(esz, p.rt), p, a, stream);
  }
  auto rows = esz == 4 ? rows_launch<float> : rows_launch<__nv_bfloat16>;
  return rows(a.h, a.ctx, a.prev, wa, wc, a.pw, a.pb, a.valid, a.htilde,
              a.tok, a.nsc, a.L, a.B, a.H, a.Vp, stream);
}

}  // namespace aocr

#define AOCR_STEP_ARGS                                                     \
  const void *h, const void *ctx, const void *prev, const void *wa,        \
      const void *wc, const void *wq, const void *wcx, const void *pw,     \
      const void *pb, const void *valid, void *htilde, void *tok,          \
      void *delta, void *scratch, int L, int B, int H, int Vp, int V,      \
      int nb, void *stream

static aocr::BsArgs ds_args(AOCR_STEP_ARGS) {
  return {ctx, h, (const int*)prev, nullptr, wq, wcx, pw, (const float*)pb,
          (const float*)valid, (float*)htilde, (float*)delta, nullptr,
          (int*)tok, nullptr, (unsigned char*)scratch, L, B, H, Vp, V, 1, 0};
}

// wa, wc: the raw weights (the rows route); wq, wcx and scratch: the
// cluster route's packed weights (beam_step.py::packed_weights) and
// bs_scratch's bytes; V: the projector's real columns (Vp: all of them).
extern "C" int aocr_decode_step_f32(AOCR_STEP_ARGS) {
  return aocr::launch(4,
                      ds_args(h, ctx, prev, wa, wc, wq, wcx, pw, pb, valid,
                              htilde, tok, delta, scratch, L, B, H, Vp, V,
                              nb, stream),
                      wa, wc, nb, (cudaStream_t)stream);
}

extern "C" int aocr_decode_step_bf16(AOCR_STEP_ARGS) {
  return aocr::launch(2,
                      ds_args(h, ctx, prev, wa, wc, wq, wcx, pw, pb, valid,
                              htilde, tok, delta, scratch, L, B, H, Vp, V,
                              nb, stream),
                      wa, wc, nb, (cudaStream_t)stream);
}

// The plan of a launch: out[0..9] = cs, units, bt, rt, kc, stages, cres,
// smem, clusters, nb (as aocr_torch/ops/cuda/decode_step.py::plan gives
// them for out[10]; all 0 for the rows route) and out[10] = the clusters
// of cs blocks the card runs at once.  Returns a CUDA error code.
extern "C" int aocr_decode_step_plan(int H, int B, int is_f32, int L, int Vp,
                                     int* out) {
  aocr::DcPlan p = {};
  int nb = 0, active;
  if (!aocr::ds_plan(is_f32 ? 4 : 2, H, B, L, Vp, &p, &nb, &active)) {
    p = {};
    nb = 0;
  }
  const int v[11] = {p.cs,   p.units, p.bt,       p.rt, p.kc,  p.stages,
                     p.cres, p.smem,  p.clusters, nb,   active};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}
