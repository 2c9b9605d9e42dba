// conv1 (1 -> 64 channels, 3x3 SAME) + bias + ReLU + 2x2/2 max-pool.
//
// Replaces aocr/ops/pallas/conv1_pool.py::_fwd_kernel (pl.pallas_call at
// conv1_pool.py:244).
//
// Bound on the H100: bytes.  Each output cell costs 4 x 9 = 36 FMAs per
// channel, against 2 or 4 bytes written; at B=512, W=100 the bf16 output
// is 52 MB and the input 3.3 MB, so the kernel is a streaming write.  The
// design keeps the 164 MB pre-pool activation out of device memory (the
// reason the TPU kernel exists): the four pre-pool sums of a cell live in
// registers, and only the pooled NHWC output is stored, 64 neighbouring
// threads writing 64 neighbouring channels.  One block handles one
// (image, output row): it stages the 4 input rows it needs, zero-padded,
// in shared memory; the 9 taps of a thread's channel stay in registers.
//
// Numerics as the TPU kernel (conv1_pool.py:145-171): float32 sum of the
// 9 products, rounded to the compute dtype, plus the bias in the compute
// dtype (rounded), then max over the window and ReLU.  Odd widths floor.
#include "common.cuh"

namespace aocr {

constexpr int C1 = 64;        // conv1 output channels
constexpr int ROWS_Y = 4;     // block = (64 channels, 4 output columns)

template <typename T>
__global__ void conv1_pool_kernel(const T* __restrict__ x,   // (B, H, W)
                                  const T* __restrict__ w9,  // (9, 64)
                                  const float* __restrict__ bias,  // (64,)
                                  T* __restrict__ out,  // (B, H/2, W/2, 64)
                                  int H, int W) {
  extern __shared__ float patch[];  // 4 rows x (W + 2), zero-padded
  const int ho = blockIdx.x;
  const int b = blockIdx.y;
  const int Wp = W + 2;
  const int Ho = H / 2, Wo = W / 2;
  const T* xb = x + (size_t)b * H * W;
  const int tid = threadIdx.y * C1 + threadIdx.x;
  const int nthr = C1 * ROWS_Y;
  // rows 2*ho-1 .. 2*ho+2 of the image, columns -1 .. W
  for (int i = tid; i < 4 * Wp; i += nthr) {
    int rr = i / Wp, cc = i % Wp;
    int y = 2 * ho - 1 + rr, xc = cc - 1;
    patch[i] = (y >= 0 && y < H && xc >= 0 && xc < W)
                   ? to_f(xb[(size_t)y * W + xc]) : 0.f;
  }
  const int c = threadIdx.x;
  float wt[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wt[k] = to_f(w9[k * C1 + c]);
  const float bc = round_cd<T>(bias[c]);
  __syncthreads();

  T* orow = out + ((size_t)b * Ho + ho) * Wo * C1;
  for (int wo = threadIdx.y; wo < Wo; wo += ROWS_Y) {
    float m = -INFINITY;
#pragma unroll
    for (int pi = 0; pi < 2; ++pi)
#pragma unroll
      for (int pj = 0; pj < 2; ++pj) {
        // pre-pool pixel (2*ho+pi, 2*wo+pj): taps at patch rows pi..pi+2,
        // padded columns 2*wo+pj .. 2*wo+pj+2
        float s = 0.f;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            s = fmaf(patch[(pi + ky) * Wp + 2 * wo + pj + kx], wt[ky * 3 + kx],
                     s);
        float z = round_cd<T>(round_cd<T>(s) + bc);
        m = fmaxf(m, z);
      }
    orow[(size_t)wo * C1 + c] = from_f<T>(fmaxf(m, 0.f));
  }
}

template <typename T>
static int launch(const void* x, const void* w9, const void* b, void* out,
                  int B, int H, int W, cudaStream_t stream) {
  size_t smem = sizeof(float) * 4 * (W + 2);
  cudaError_t e = set_smem((const void*)conv1_pool_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H / 2, B), block(C1, ROWS_Y);
  conv1_pool_kernel<T><<<grid, block, smem, stream>>>(
      (const T*)x, (const T*)w9, (const float*)b, (T*)out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace aocr

extern "C" int aocr_conv1_pool_f32(const void* x, const void* w9,
                                   const void* b, void* out, int B, int H,
                                   int W, void* stream) {
  return aocr::launch<float>(x, w9, b, out, B, H, W, (cudaStream_t)stream);
}

extern "C" int aocr_conv1_pool_bf16(const void* x, const void* w9,
                                    const void* b, void* out, int B, int H,
                                    int W, void* stream) {
  return aocr::launch<__nv_bfloat16>(x, w9, b, out, B, H, W,
                                     (cudaStream_t)stream);
}
