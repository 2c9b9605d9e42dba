// Backward of conv1 (1 -> 64 channels, 3x3 SAME) + bias + ReLU + 2x2/2
// max-pool: the weight and bias gradients.
//
// Replaces aocr/ops/pallas/conv1_pool.py::_bwd_kernel (pl.pallas_call at
// conv1_pool.py:266).  The image cotangent is conv1_pool_dx.cu.
//
// For each pooled cell the kernel routes the pooled cotangent dy as
// conv1_route.cuh does (the routing both backward kernels share: the
// four pre-pool scores recomputed as the forward rounds them, the FIRST
// position attaining the window max, nothing unless that max is
// positive), and accumulates dW (64 x 9) and db (64) in float32.
//
// Bound on the H100: the read of dy (B x 800 x 64 values at W=100) and the
// recompute (36 FMAs per cell and channel).  One block handles one image:
// it stages the zero-padded image in shared memory, 64 threads take the
// 64 channels (coalesced dy reads) and 4 thread rows split the cells.
// No atomics: each block writes its (64, 10) partial sums, and a second
// kernel adds the B partials of each output in a fixed order, so the
// result is deterministic.
#include <algorithm>

#include "conv1_route.cuh"

namespace aocr {

constexpr int CB_C = CONV1_C;
constexpr int CB_ROWS = 4;    // thread rows per block
constexpr int CB_OUT = 10;    // 9 weight taps + the bias, per channel

template <typename T>
__global__ void conv1_pool_bwd_kernel(
    const T* __restrict__ x,         // (B, H, W)
    const T* __restrict__ w9,        // (9, 64)
    const float* __restrict__ bias,  // (64,)
    const T* __restrict__ dy,        // (B, H/2, W/2, 64)
    float* __restrict__ part,        // (B, 64, 10)
    int H, int W) {
  extern __shared__ float img[];  // (H + 2) x (W + 2), zero-padded
  const int b = blockIdx.x;
  const int Wp = W + 2, Ho = H / 2, Wo = W / 2;
  const T* xb = x + (size_t)b * H * W;
  const int c = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * CB_C + c, nthr = CB_C * CB_ROWS;
  for (int i = tid; i < (H + 2) * Wp; i += nthr) {
    const int y = i / Wp - 1, xc = i % Wp - 1;
    img[i] = (y >= 0 && y < H && xc >= 0 && xc < W)
                 ? to_f(xb[(size_t)y * W + xc]) : 0.f;
  }
  float wt[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wt[k] = to_f(w9[k * CB_C + c]);
  const float bc = round_cd<T>(bias[c]);
  __syncthreads();

  float dw[9], db = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) dw[k] = 0.f;
  const T* dyb = dy + (size_t)b * Ho * Wo * CB_C;
  for (int cell = ty; cell < Ho * Wo; cell += CB_ROWS) {
    const int ho = cell / Wo, wo = cell % Wo;
    const int p = conv1_route<T>(img + 2 * ho * Wp + 2 * wo, Wp, wt, bc);
    if (p < 0) continue;  // the ReLU drops the cotangent
    const float g = to_f(dyb[(size_t)cell * CB_C + c]);
    const float* pt = img + (2 * ho + p / 2) * Wp + 2 * wo + p % 2;
    db += g;
#pragma unroll
    for (int k = 0; k < 9; ++k)
      dw[k] = fmaf(g, pt[(k / 3) * Wp + k % 3], dw[k]);
  }

  // the 4 thread rows of each channel, summed in row order
  __syncthreads();
  float* red = img;  // CB_ROWS x 64 x 10, reusing the image buffer
  float* mine = red + (ty * CB_C + c) * CB_OUT;
#pragma unroll
  for (int k = 0; k < 9; ++k) mine[k] = dw[k];
  mine[9] = db;
  __syncthreads();
  for (int q = tid; q < CB_C * CB_OUT; q += nthr) {
    float v = 0.f;
    for (int r = 0; r < CB_ROWS; ++r) v += red[r * CB_C * CB_OUT + q];
    part[(size_t)b * CB_C * CB_OUT + q] = v;
  }
}

// out[q] = sum over the B images of part[b][q], in image order
__global__ void conv1_pool_bwd_sum_kernel(const float* __restrict__ part,
                                          float* __restrict__ out, int B) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= CB_C * CB_OUT) return;
  float v = 0.f;
  for (int b = 0; b < B; ++b) v += part[(size_t)b * CB_C * CB_OUT + q];
  out[q] = v;
}

template <typename T>
static int launch(const void* x, const void* w9, const void* b,
                  const void* dy, void* part, void* out, int B, int H, int W,
                  cudaStream_t stream) {
  // the padded image, and the reduction buffer that reuses it
  size_t smem =
      sizeof(float) * std::max((H + 2) * (W + 2), CB_ROWS * CB_C * CB_OUT);
  cudaError_t e = set_smem((const void*)conv1_pool_bwd_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 block(CB_C, CB_ROWS);
  conv1_pool_bwd_kernel<T><<<B, block, smem, stream>>>(
      (const T*)x, (const T*)w9, (const float*)b, (const T*)dy, (float*)part,
      H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  conv1_pool_bwd_sum_kernel<<<(CB_C * CB_OUT + 127) / 128, 128, 0, stream>>>(
      (const float*)part, (float*)out, B);
  return (int)cudaGetLastError();
}

}  // namespace aocr

#define AOCR_CONV1_BWD_ARGS                                            \
  const void *x, const void *w9, const void *b, const void *dy,       \
      void *part, void *out, int B, int H, int W, void *stream

extern "C" int aocr_conv1_pool_bwd_f32(AOCR_CONV1_BWD_ARGS) {
  return aocr::launch<float>(x, w9, b, dy, part, out, B, H, W,
                             (cudaStream_t)stream);
}

extern "C" int aocr_conv1_pool_bwd_bf16(AOCR_CONV1_BWD_ARGS) {
  return aocr::launch<__nv_bfloat16>(x, w9, b, dy, part, out, B, H, W,
                                     (cudaStream_t)stream);
}
