// Shared helpers of the port's kernels: element conversion, cp.async copies
// and the masking constant of the reference (kernels/ref.py NEG_INF).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float kNegInf = -1e30f;

// dtype codes passed from Python (kernels/_build.py DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One 16-byte load of T, widened to fp32: 4 values of fp32, 8 of bf16.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* src, float* dst) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x;
    dst[1] = x.y;
    dst[2] = x.z;
    dst[3] = x.w;
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* src,
                                              float* dst) {
    const uint4 x = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

// Stage `rows` rows, from row0 on, of a slice whose rows hold DH elements
// `row_stride` apart, into shared memory as fp32 times `scale`, at row
// stride `ld`. Rows at or past `row_limit` are zero. Row starts must be
// 16-byte aligned (the Python wrappers check the base pointers; DH * size
// of T is a multiple of 16).
template <typename T, int DH, int NT>
__device__ __forceinline__ void stage_rows(const T* __restrict__ base,
                                           size_t row_stride, int row0,
                                           int rows, int row_limit,
                                           float* dst, int ld, float scale,
                                           int tid) {
  constexpr int N = Chunk<T>::N;
  constexpr int CPR = DH / N;   // chunks per row
  for (int i = tid; i < rows * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * N;
    float x[N];
    if (row0 + r < row_limit) {
      Chunk<T>::load(base + size_t(row0 + r) * row_stride + c, x);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) dst[r * ld + c + j] = x[j] * scale;
  }
}

// cp.async copies from global to shared memory that bypass registers;
// `valid` false zero-fills the destination and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x, unsigned width) {
  for (unsigned off = width / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x, unsigned width) {
  for (unsigned off = width / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace repro
