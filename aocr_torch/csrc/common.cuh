// Shared device helpers for the aocr_torch kernels.
//
// Every kernel here is templated on the compute dtype T (float or
// __nv_bfloat16).  Matmul operands are T values; products and sums are
// float32, matching the reference's preferred_element_type=float32 (a
// bf16 x bf16 product is exact in float32).  Values that the reference
// casts to the compute dtype before a matmul are rounded with round_cd
// (round to nearest even, as XLA's convert) and kept as float in shared
// memory.
//
// The matmuls are written for CUDA cores, one float FMA per
// multiply-add: the kernels of this first port are right and simple;
// tensor-core (wgmma) tiles are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace aocr {

constexpr int PAD = 0;  // aocr/vocab.py
constexpr int GO = 1;
constexpr int EOS = 2;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the compute dtype, as a float
template <typename T> __device__ __forceinline__ float round_cd(float v) {
  return to_f(from_f<T>(v));
}

// U consecutive values at p (aligned to U elements) as floats
__device__ __forceinline__ void load_row(const float* p, float (&o)[4]) {
  float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load_row(const float* p, float (&o)[2]) {
  float2 v = *reinterpret_cast<const float2*>(p);
  o[0] = v.x; o[1] = v.y;
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&o)[4]) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&o)[2]) {
  float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  o[0] = a.x; o[1] = a.y;
}

// acc[g][u][r] += sum_{k<K} xs[r*ldx + k] * W[k*ldw + g*gstride + col + u]
// for BT rows of xs (shared, float) and G groups of U consecutive columns
// of W (global, row-major).  Every thread of a warp reads the same xs
// word (a broadcast) and neighbouring W words (coalesced).
template <typename T, int BT, int G, int U>
__device__ __forceinline__ void mm_cols(const float* __restrict__ xs, int ldx,
                                        int K, const T* __restrict__ W,
                                        int ldw, int gstride, int col,
                                        float (&acc)[G][U][BT]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float xv[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) xv[r] = xs[r * ldx + k];
    const T* wk = W + (size_t)k * ldw + col;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float w[U];
      load_row(wk + (size_t)g * gstride, w);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < BT; ++r)
          acc[g][u][r] = fmaf(xv[r], w[u], acc[g][u][r]);
    }
  }
}

template <int G, int U, int BT>
__device__ __forceinline__ void zero(float (&acc)[G][U][BT]) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[g][u][r] = 0.f;
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

// The LSTM gate math of aocr/ops/lstm.py::gate_math for one unit:
// gates [i|f|o|g] -> (c', h').
__device__ __forceinline__ void gate_math(float gi, float gf, float go,
                                          float gg, float c_prev, float* c,
                                          float* h) {
  float i = sigmoidf_(gi);
  float f = sigmoidf_(gf);
  float o = sigmoidf_(go);
  float g = tanhf(gg);
  float cn = f * c_prev + i * g;
  *c = cn;
  *h = o * tanhf(cn);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

// (value, index) argmax across a warp; ties go to the lowest index, as
// jnp.argmax
__device__ __forceinline__ void warp_argmax(float* v, int* i) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, *v, s);
    int oi = __shfl_xor_sync(0xffffffffu, *i, s);
    if (ov > *v || (ov == *v && oi < *i)) {
      *v = ov;
      *i = oi;
    }
  }
}

inline cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace aocr
