// Image cotangent of conv1 (1 -> 64 channels, 3x3 SAME) + bias + ReLU +
// 2x2/2 max-pool, as the 16 taps of each output cell's 4x4 input patch.
//
// Replaces aocr/ops/pallas/conv1_pool.py::_dx_kernel (pl.pallas_call at
// conv1_pool.py:287, the kernel at :217).  For each output cell the kernel
// routes the pooled cotangent dy exactly as conv1_pool_bwd.cu does (the
// shared conv1_route.cuh), then computes the 16 tap values
//   dx16[tap] = sum over (p, c) of W16[tap, p*64 + c] * dcat[p*64 + c],
// where dcat holds the routed cotangent (dy at channel c's winning
// position p, zero elsewhere) and W16[(a, b), p*64 + c] = w[a-pi, b-pj, c],
// the compute-dtype weight that pre-pool pixel (pi, pj) applies to patch
// tap (a, b) (zero outside the 3x3 support), and rounds it to the compute
// dtype (conv1_pool.py:217-225).  Scattering the taps back onto the image
// (the TPU's _unpatch, plain XLA there) is plain PyTorch in
// ops/cuda/conv1_pool_dx.py.
//
// The sum is float32, taken channel by channel (c = 0 .. 63) with
// separately rounded products and sums (__fmul_rn / __fadd_rn): each
// channel adds at most one term to a tap (its winning position's), and
// the plain version adds the channels' terms in the same order, so the
// two agree bit for bit.  A float32 sum in another order (the TPU's dot)
// lands up to tens of bfloat16 steps away where the channels' terms
// cancel.
//
// Bound on the H100: bytes (dy, B x 800 x 64 values at W=100, dominates;
// 16 taps out a cell); the recompute is 36 FMAs a cell and channel, the
// taps 9 more.  One block handles one (image, output row): it
// stages the 4 padded input rows, the weights and the row's dy (rows
// padded to 65 floats, so that threads reading one channel of their own
// cells hit distinct banks) in shared memory; each thread takes whole
// cells, its 4x4 patch and its 16 sums in registers.  The taps are
// written (B, Ho, Wo, 16): a cell's 16 values together.
#include "conv1_route.cuh"

namespace aocr {

constexpr int DX_THREADS = 64;        // threads a block, over the cells
constexpr int DX_LD = CONV1_C + 1;    // a staged dy row, in floats

template <typename T>
__global__ void conv1_pool_dx_kernel(const T* __restrict__ x,   // (B, H, W)
                                     const T* __restrict__ w9,  // (9, 64)
                                     const float* __restrict__ bias,  // (64,)
                                     const T* __restrict__ dy,  // (B,Ho,Wo,64)
                                     T* __restrict__ out,  // (B, Ho, Wo, 16)
                                     int H, int W) {
  extern __shared__ float smem[];
  const int ho = blockIdx.x;
  const int b = blockIdx.y;
  const int Wp = W + 2, Ho = H / 2, Wo = W / 2;
  float* patch = smem;                 // rows 2ho-1 .. 2ho+2, cols -1 .. W
  float* wts = patch + 4 * Wp;         // (64, 9) compute-dtype weights
  float* bcs = wts + CONV1_C * 9;      // (64,) biases rounded to the cd
  float* dys = bcs + CONV1_C;          // (Wo, DX_LD) this row's dy
  const T* xb = x + (size_t)b * H * W;
  for (int i = threadIdx.x; i < 4 * Wp; i += blockDim.x) {
    const int y = 2 * ho - 1 + i / Wp, xc = i % Wp - 1;
    patch[i] = (y >= 0 && y < H && xc >= 0 && xc < W)
                   ? to_f(xb[(size_t)y * W + xc]) : 0.f;
  }
  for (int i = threadIdx.x; i < CONV1_C * 9; i += blockDim.x)
    wts[i] = to_f(w9[(i % 9) * CONV1_C + i / 9]);
  for (int c = threadIdx.x; c < CONV1_C; c += blockDim.x)
    bcs[c] = round_cd<T>(bias[c]);
  const T* dyrow = dy + ((size_t)b * Ho + ho) * Wo * CONV1_C;
  for (int i = threadIdx.x; i < Wo * CONV1_C; i += blockDim.x)
    dys[(i / CONV1_C) * DX_LD + i % CONV1_C] = to_f(dyrow[i]);
  __syncthreads();

  T* orow = out + ((size_t)b * Ho + ho) * Wo * 16;
  for (int wo = threadIdx.x; wo < Wo; wo += blockDim.x) {
    float pt[4][4];  // the cell's 4x4 patch
#pragma unroll
    for (int t = 0; t < 16; ++t)
      pt[t / 4][t % 4] = patch[(t / 4) * Wp + 2 * wo + t % 4];
    float acc[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) acc[t] = 0.f;
    for (int c = 0; c < CONV1_C; ++c) {
      float wt[1][9];
#pragma unroll
      for (int k = 0; k < 9; ++k) wt[0][k] = wts[c * 9 + k];
      const float bc[1] = {bcs[c]};
      int win[1];
      conv1_route_n<T, 1>(pt, wt, bc, win);
      const int p = win[0];
      if (p < 0) continue;  // the ReLU drops the cotangent
      const float g = dys[wo * DX_LD + c];
      // pre-pool pixel (pi, pj) reads patch taps (pi + ky, pj + kx)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (p != q) continue;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const int t = (q / 2 + k / 3) * 4 + q % 2 + k % 3;
          acc[t] = __fadd_rn(acc[t], __fmul_rn(wt[0][k], g));
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 16; ++t)
      orow[(size_t)wo * 16 + t] = from_f<T>(acc[t]);
  }
}

template <typename T>
static int launch(const void* x, const void* w9, const void* b,
                  const void* dy, void* out, int B, int H, int W,
                  cudaStream_t stream) {
  size_t smem = sizeof(float) * (4 * (W + 2) + CONV1_C * 10 +
                                 (W / 2) * DX_LD);
  cudaError_t e = set_smem((const void*)conv1_pool_dx_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H / 2, B);
  conv1_pool_dx_kernel<T><<<grid, DX_THREADS, smem, stream>>>(
      (const T*)x, (const T*)w9, (const float*)b, (const T*)dy, (T*)out, H,
      W);
  return (int)cudaGetLastError();
}

}  // namespace aocr

#define AOCR_CONV1_DX_ARGS                                             \
  const void *x, const void *w9, const void *b, const void *dy,       \
      void *out, int B, int H, int W, void *stream

extern "C" int aocr_conv1_pool_dx_f32(AOCR_CONV1_DX_ARGS) {
  return aocr::launch<float>(x, w9, b, dy, out, B, H, W,
                             (cudaStream_t)stream);
}

extern "C" int aocr_conv1_pool_dx_bf16(AOCR_CONV1_DX_ARGS) {
  return aocr::launch<__nv_bfloat16>(x, w9, b, dy, out, B, H, W,
                                     (cudaStream_t)stream);
}
