// Backward of z -> max_pool(relu(z)) from the ReLU output y alone: the
// fused ReLU + max-pool backward of the CNN's pools after conv2, conv4 and
// conv6.
//
// Replaces aocr/ops/pallas/pool_bwd.py::relu_pool_bwd (pl.pallas_call at
// pool_bwd.py:117).  dz = dy routed to the FIRST element equal to the
// window max in row-major window order, zero where y == 0.  Masking on the
// output y equals composing the max-pool backward (first max kept, as
// PyTorch's and XLA's) with the ReLU backward (grad where relu(z) > 0):
// an element with y == 0 can only win a window whose max is 0, and there
// both give 0.  The compares run on float images of the stored values, so
// the routing is exact in both dtypes.
//
// Layout: the activations are NCHW tensors in channels_last memory, so
// physically (B, H, W, C).  The kernel reads y and dy and writes dz in that
// layout; no transpose on either side.
//
// Bound on the H100: bytes (y read, dz written, dy read at 1/2 or 1/4 of
// their size; four compares a value).  One thread per pooled element and
// 16-byte vector of channels (8 bf16 or 4 float32), channels fastest, so a
// warp reads and writes 512 contiguous bytes of each window row.
#include "common.cuh"

namespace aocr {

template <typename T> struct Vec16;  // 16 bytes of channels
template <> struct Vec16<float> {
  static constexpr int N = 4;
  using Raw = float4;
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* p,
                                         float (&o)[Vec16<T>::N]) {
  typename Vec16<T>::Raw raw =
      *reinterpret_cast<const typename Vec16<T>::Raw*>(p);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) o[i] = to_f(v[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p,
                                          const float (&o)[Vec16<T>::N]) {
  typename Vec16<T>::Raw raw;
  T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) v[i] = from_f<T>(o[i]);
  *reinterpret_cast<typename Vec16<T>::Raw*>(p) = raw;
}

template <typename T>
__global__ void pool_bwd_kernel(const T* __restrict__ y,   // (B, H, W, C)
                                const T* __restrict__ dy,  // (B, Ho, Wo, C)
                                T* __restrict__ dz,        // (B, H, W, C)
                                long long total, int H, int W, int C, int wh,
                                int ww) {
  constexpr int N = Vec16<T>::N;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int Ho = H / wh, Wo = W / ww, CV = C / N;
  const int cv = (int)(idx % CV);
  long long rest = idx / CV;
  const int wo = (int)(rest % Wo);
  rest /= Wo;
  const int ho = (int)(rest % Ho);
  const long long b = rest / Ho;
  const size_t c0 = (size_t)cv * N;
  auto at = [&](int i, int j) {
    return ((b * H + (long long)ho * wh + i) * W + (long long)wo * ww + j) * C +
           c0;
  };
  float m[N];
#pragma unroll
  for (int k = 0; k < N; ++k) m[k] = -INFINITY;
  for (int i = 0; i < wh; ++i)
    for (int j = 0; j < ww; ++j) {
      float v[N];
      load_vec(y + at(i, j), v);
#pragma unroll
      for (int k = 0; k < N; ++k) m[k] = fmaxf(m[k], v[k]);
    }
  float g[N];
  load_vec(dy + (((size_t)b * Ho + ho) * Wo + wo) * C + c0, g);
  bool taken[N];
#pragma unroll
  for (int k = 0; k < N; ++k) taken[k] = false;
  for (int i = 0; i < wh; ++i)
    for (int j = 0; j < ww; ++j) {
      float v[N], d[N];
      load_vec(y + at(i, j), v);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const bool first = v[k] == m[k] && !taken[k];
        taken[k] = taken[k] || first;
        d[k] = (first && v[k] > 0.f) ? g[k] : 0.f;
      }
      store_vec(dz + at(i, j), d);
    }
}

template <typename T>
static int launch(const void* y, const void* dy, void* dz, int B, int H,
                  int W, int C, int wh, int ww, cudaStream_t stream) {
  const long long total =
      (long long)B * (H / wh) * (W / ww) * (C / Vec16<T>::N);
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  pool_bwd_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      (const T*)y, (const T*)dy, (T*)dz, total, H, W, C, wh, ww);
  return (int)cudaGetLastError();
}

}  // namespace aocr

#define AOCR_POOL_BWD_ARGS                                                \
  const void *y, const void *dy, void *dz, int B, int H, int W, int C,   \
      int wh, int ww, void *stream

extern "C" int aocr_pool_bwd_f32(AOCR_POOL_BWD_ARGS) {
  return aocr::launch<float>(y, dy, dz, B, H, W, C, wh, ww,
                             (cudaStream_t)stream);
}

extern "C" int aocr_pool_bwd_bf16(AOCR_POOL_BWD_ARGS) {
  return aocr::launch<__nv_bfloat16>(y, dy, dz, B, H, W, C, wh, ww,
                                     (cudaStream_t)stream);
}
