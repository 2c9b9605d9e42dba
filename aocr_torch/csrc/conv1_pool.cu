// conv1 (1 -> 64 channels, 3x3 SAME) + bias + ReLU + 2x2/2 max-pool.
//
// Replaces aocr/ops/pallas/conv1_pool.py::_fwd_kernel (pl.pallas_call at
// conv1_pool.py:244).
//
// Bound on the H100: the store of the pooled output (52 MB in bf16 at
// B=512, W=100; the input is 3.3 MB), once the sums are off the CUDA
// cores.  The design keeps the 164 MB pre-pool activation out of device
// memory (the reason the TPU kernel exists): the four pre-pool sums of a
// cell live in registers and only the pooled NHWC output is stored.
//
// bf16: the TPU kernel's product.  An output cell's four pre-pool pixels
// read one 4x4 patch of the zero-padded image, 16 taps, so the cell's 256
// sums (4 pool positions x 64 channels) are its patch times W16, the
// (16, 256) matrix of aocr's _w16 (ops/cuda/conv1_pool.py::w16): one
// K=16 product, the depth of mma.sync.m16n8k16.  A warp takes 16 cells at
// a time (an m16 tile); each lane's A fragment is four 32-bit words of
// the staged image rows (a tap pair 2q, 2q+1 is two neighbouring pixels,
// and each row is staged with one zero column on its left, so the pair is
// an aligned word).  W16's 32 n8 tiles stay in registers as B fragments
// (64 a lane), built by each block from w, ordered so that a lane's four
// accumulators of one channel group are the four pool positions of the
// same (cell, channel): the window max needs no exchange, and since
// rounding is monotone, round(max s) + bias, rounded, then ReLU, equals
// the TPU's max of the four rounded scores (conv1_pool.py:158-171).  The
// tile's 2 KB of output goes through shared memory and out in 16-byte
// stores, 512 contiguous bytes a warp instruction.
//
// float32: the TPU kernel runs HIGHEST precision, and the port keeps the
// first port's arithmetic bit for bit: each sum is the 9 taps in order by
// fused multiply-adds from 0 on the CUDA cores, + the bias, then the max
// and ReLU.  A lane owns 4 channels (36 taps in registers) and one cell at
// a time, its 4x4 patch loaded once for them, and stores them as one
// float4; a warp writes 2 cells (512 contiguous bytes) a store.
//
// Both dtypes run the card's blocks (cf_plan), each on an equal run of
// the batch's pooled cells, staging the zero-padded image rows of its
// pool rows in shared memory (consecutive pool rows share two of their
// four rows; conv1_route.cuh's cb_stage).  Odd widths floor.
#include "cluster_mma.cuh"
#include "conv1_route.cuh"

namespace aocr {

constexpr int CF_THREADS = 256;
constexpr int CF_WARPS = CF_THREADS / 32;
constexpr int CF_MIN_RUN = 16 * CF_WARPS;  // cells: an m16 tile a warp
constexpr int CF_STAGE_MAX = 64 * 1024;    // staged image rows, bytes
constexpr int CF_LDO = 36;  // words of a staged output cell (64 bf16 + 16
                            // bytes, so a warp's stores hit 32 banks)
constexpr int CF_OUT = CF_WARPS * 16 * CF_LDO * 4;  // bf16 output staging

// The bytes of n staged rows of (W + 3) & ~1 elements of esz bytes,
// rounded up to 16 (the bf16 output staging follows them).
__host__ __device__ inline int cf_rows_bytes(int n, int W, int esz) {
  return (n * esz * ((W + 3) & ~1) + 15) & ~15;
}

// The launch plan for B images of H x W, the element size esz and the
// blocks the card holds at once (resident): blocks, each owning ceil or
// floor of the B (H/2) (W/2) cells / blocks, as many as the card holds
// (fewer where runs would drop below CF_MIN_RUN cells; at least one) and
// the fewest more whose staged rows (cb_rows of (W + 3) & ~1 elements)
// fit CF_STAGE_MAX; run: the most cells a block owns; rows: the most rows
// it stages; smem: their bytes (cf_rows_bytes; bf16: and the output
// staging).  False where the rows of one cell's run do not fit.
static bool cf_plan(int B, int H, int W, int esz, int resident, int* blocks,
                    int* run, int* rows, int* smem) {
  const int Ho = H / 2, Wo = W / 2;
  const long cells = (long)B * Ho * Wo, rb = (long)esz * ((W + 3) & ~1);
  if (cells < 1 || resident < 1 || cb_rows(1, B, Ho, Wo) * rb > CF_STAGE_MAX)
    return false;
  auto fits = [&](long n) {
    return cb_rows((cells + n - 1) / n, B, Ho, Wo) * rb <= CF_STAGE_MAX;
  };
  long lo = std::max(1L, std::min((long)resident,
                                  cells / CF_MIN_RUN)),
       hi = cells;
  if (!fits(lo)) {  // the fewest blocks that fit: fits(hi) holds
    while (hi - lo > 1) {
      const long mid = (lo + hi) / 2;
      (fits(mid) ? hi : lo) = mid;
    }
    lo = hi;
  }
  *blocks = (int)lo;
  *run = (int)((cells + lo - 1) / lo);
  *rows = (int)cb_rows(*run, B, Ho, Wo);
  *smem = cf_rows_bytes(*rows, W, esz) + (esz == 2 ? CF_OUT : 0);
  return true;
}

// x (B, H, W); w (64, 9) float32; bias (64,) float32; out (B, H/2, W/2,
// 64).  Block i owns the cells [i C / n, (i + 1) C / n) of the C = B (H/2)
// (W/2) pooled cells.
__global__ void __launch_bounds__(CF_THREADS, 2)
conv1_pool_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int B, int H,
                       int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float ws[CONV1_C * 9];  // the taps, in bf16
  __shared__ __align__(16) float bs[CONV1_C];  // the bias, in bf16
  const int Ho = H / 2, Wo = W / 2, Wh = ((W + 3) & ~1) / 2;
  const long cells = (long)B * Ho * Wo, nb = gridDim.x;
  const long c_lo = blockIdx.x * cells / nb;
  const long c_hi = (blockIdx.x + 1) * cells / nb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int g0 = (int)(c_lo / Wo), g1 = (int)((c_hi - 1) / Wo);
  __nv_bfloat16* img = reinterpret_cast<__nv_bfloat16*>(smem);
  const int nsr = cb_base(g1, g0, Ho) + 4;
  uint32_t* ostage =
      reinterpret_cast<uint32_t*>(smem + cf_rows_bytes(nsr, W, 2));
  for (int i = tid; i < CONV1_C * 9; i += CF_THREADS)
    ws[i] = round_cd<__nv_bfloat16>(w[i]);
  if (tid < CONV1_C) bs[tid] = round_cd<__nv_bfloat16>(bias[tid]);
  cb_stage<CF_WARPS>(x, img, H, W, g0, g1, [](float) {});
  __syncthreads();

  // B fragments: n8 tile (cg, p) is W16's columns p 64 + cg 8 + 0..7
  // (channels cg 8 + 0..7 at pool position p = (pi, pj)); the lane holds
  // column g at taps 2q, 2q+1 (word 0) and 2q+8, 2q+9 (word 1).  Tap
  // k = 4a + b is patch row a, column b: channel c's weight at (a - pi, b -
  // pj), zero off its 3x3 support.
  uint32_t bf[8][4][2];
#pragma unroll
  for (int cg = 0; cg < 8; ++cg)
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 8 * j + 2 * q + h;
          const int ky = (k >> 2) - (p >> 1), kx = (k & 3) - (p & 1);
          v[h] = ky >= 0 && ky < 3 && kx >= 0 && kx < 3
                     ? ws[(cg * 8 + g) * 9 + ky * 3 + kx]
                     : 0.f;
        }
        const __nv_bfloat162 pr = __floats2bfloat162_rn(v[0], v[1]);
        bf[cg][p][j] = *reinterpret_cast<const uint32_t*>(&pr);
      }

  const uint32_t* img32 = reinterpret_cast<const uint32_t*>(img);
  uint32_t* os = ostage + warp * 16 * CF_LDO;
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);
  const long n = c_hi - c_lo;
  for (long t = warp; 16 * t < n; t += CF_WARPS) {
    const long base = c_lo + 16 * t;
    const int m = (int)min(16L, n - 16 * t);  // the tile's real cells
    // A fragments: cells base + g and base + g + 8 (the last real cell
    // for rows past m), patch rows q/2 (word 0, 1) and q/2 + 2 (2, 3),
    // columns 2 (q % 2), + 1
    int wd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long c = base + min(g + 8 * h, m - 1);
      const int gr = (int)(c / Wo), wo = (int)(c - (long)gr * Wo);
      wd[h] = (cb_base(gr, g0, Ho) + (q >> 1)) * Wh + wo + (q & 1);
    }
    const uint32_t a[4] = {img32[wd[0]], img32[wd[1]],
                           img32[wd[0] + 2 * Wh], img32[wd[1] + 2 * Wh]};
#pragma unroll
    for (int cg = 0; cg < 8; ++cg) {
      float acc[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][e] = 0.f;
        mma_bf16(acc[p], a, bf[cg][p][0], bf[cg][p][1]);
      }
      // (cell g: channels 2q, 2q+1; cell g + 8: the same) window maxima
      float mx[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[e] = fmaxf(fmaxf(acc[0][e], acc[1][e]), fmaxf(acc[2][e], acc[3][e]));
      const float2 bc = *reinterpret_cast<const float2*>(bs + cg * 8 + 2 * q);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 s = __bfloat1622float2(
            __floats2bfloat162_rn(mx[2 * h], mx[2 * h + 1]));
        __nv_bfloat162 z = __hmax2(
            __floats2bfloat162_rn(s.x + bc.x, s.y + bc.y), zero2);
        os[(g + 8 * h) * CF_LDO + cg * 4 + q] =
            *reinterpret_cast<const uint32_t*>(&z);
      }
    }
    __syncwarp();
    // the tile's m cells: m x 128 contiguous bytes of out
    uint4* dst = reinterpret_cast<uint4*>(out + (size_t)base * CONV1_C);
    for (int k = lane; k < 8 * m; k += 32)
      dst[k] = *reinterpret_cast<const uint4*>(os + (k >> 3) * CF_LDO +
                                               (k & 7) * 4);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(CF_THREADS, 2)
conv1_pool_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      float* __restrict__ out, int B, int H, int W) {
  extern __shared__ __align__(16) float img[];
  const int Ho = H / 2, Wo = W / 2, Wp = (W + 3) & ~1;
  const long cells = (long)B * Ho * Wo, nb = gridDim.x;
  const long c_lo = blockIdx.x * cells / nb;
  const long c_hi = (blockIdx.x + 1) * cells / nb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // 16 cell slots x 16 groups of 4 channels: a warp's two slots are its
  // half-warps
  const int slot = 2 * warp + (lane >> 4), c0 = 4 * (lane & 15);
  const int g0 = (int)(c_lo / Wo), g1 = (int)((c_hi - 1) / Wo);
  cb_stage<CF_WARPS>(x, img, H, W, g0, g1, [](float) {});
  float wt[4][9], bc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int k = 0; k < 9; ++k) wt[j][k] = w[(c0 + j) * 9 + k];
    bc[j] = bias[c0 + j];
  }
  __syncthreads();
  // the slot's cells c_lo + slot, + 16, ...: column wo of pool row g,
  // whose staged rows start at `base`, kept by increments
  const int gs = (int)((c_lo + slot) / Wo);
  int wo = (int)((c_lo + slot) % Wo), ho = gs % Ho, base = cb_base(gs, g0, Ho);
  float* dst = out + (size_t)(c_lo + slot) * CONV1_C + c0;
  for (int n = (int)(c_hi - c_lo), i = slot; i < n; i += 16) {
    const float* pt = img + base * Wp + 2 * wo;
    float P[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 a = *reinterpret_cast<const float2*>(pt + r * Wp);
      const float2 c = *reinterpret_cast<const float2*>(pt + r * Wp + 2);
      P[r][0] = a.x;
      P[r][1] = a.y;
      P[r][2] = c.x;
      P[r][3] = c.y;
    }
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float m = -INFINITY;
#pragma unroll
      for (int pi = 0; pi < 2; ++pi)
#pragma unroll
        for (int pj = 0; pj < 2; ++pj) {
          float s = 0.f;
#pragma unroll
          for (int ky = 0; ky < 3; ++ky)
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
              s = fmaf(P[pi + ky][pj + kx], wt[j][ky * 3 + kx], s);
          m = fmaxf(m, s + bc[j]);
        }
      o[j] = fmaxf(m, 0.f);
    }
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    dst += 16 * CONV1_C;
    for (wo += 16; wo >= Wo; wo -= Wo) {
      base += 2;
      if (++ho == Ho) {  // the next image's rows: 2 more of padding
        ho = 0;
        base += 2;
      }
    }
  }
}

// The blocks of the dtype's kernel the card holds at once.
static int cf_resident(int esz) {
  static int cache[2] = {0, 0};
  int& n = cache[esz == 4];
  if (n == 0) {
    const void* fn = esz == 4 ? (const void*)conv1_pool_f32_kernel
                              : (const void*)conv1_pool_bf16_kernel;
    const int smem = CF_STAGE_MAX + (esz == 2 ? CF_OUT : 0);
    int dev = 0, sms = 0, per = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        set_smem(fn, smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, fn, CF_THREADS,
                                                      smem) != cudaSuccess)
      return 0;
    n = sms * per;
  }
  return n;
}

static int launch(int esz, const void* x, const void* w, const void* b,
                  void* out, int B, int H, int W, int blocks,
                  cudaStream_t stream) {
  int n, run, rows, smem;
  if (B < 1 || H < 2 || W < 2 ||
      !cf_plan(B, H, W, esz, cf_resident(esz), &n, &run, &rows, &smem) ||
      n != blocks)
    return (int)cudaErrorInvalidValue;
  const void* fn = esz == 4 ? (const void*)conv1_pool_f32_kernel
                            : (const void*)conv1_pool_bf16_kernel;
  cudaError_t e = set_smem(fn, smem);
  if (e != cudaSuccess) return (int)e;
  if (esz == 4)
    conv1_pool_f32_kernel<<<n, CF_THREADS, smem, stream>>>(
        (const float*)x, (const float*)w, (const float*)b, (float*)out, B, H,
        W);
  else
    conv1_pool_bf16_kernel<<<n, CF_THREADS, smem, stream>>>(
        (const __nv_bfloat16*)x, (const float*)w, (const float*)b,
        (__nv_bfloat16*)out, B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace aocr

// blocks: the plan's (aocr_conv1_pool_plan); a launch of another plan is
// refused.
extern "C" int aocr_conv1_pool_f32(const void* x, const void* w,
                                   const void* b, void* out, int B, int H,
                                   int W, int blocks, void* stream) {
  return aocr::launch(4, x, w, b, out, B, H, W, blocks,
                      (cudaStream_t)stream);
}

extern "C" int aocr_conv1_pool_bf16(const void* x, const void* w,
                                    const void* b, void* out, int B, int H,
                                    int W, int blocks, void* stream) {
  return aocr::launch(2, x, w, b, out, B, H, W, blocks,
                      (cudaStream_t)stream);
}

// The plan of a launch: out[0..3] = blocks, run, rows, smem (as
// aocr_torch/ops/cuda/conv1_pool.py::plan gives them for out[4]) and
// out[4] = the blocks the card holds at once.  Returns a CUDA error code.
extern "C" int aocr_conv1_pool_plan(int B, int H, int W, int is_f32,
                                    int* out) {
  const int esz = is_f32 ? 4 : 2, resident = aocr::cf_resident(esz);
  int n, run, rows, smem;
  if (!aocr::cf_plan(B, H, W, esz, resident, &n, &run, &rows, &smem))
    return (int)cudaErrorInvalidValue;
  const int v[5] = {n, run, rows, smem, resident};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}
