// Shared helpers of the geomae_tpu_torch kernels.
//
// Every kernel is a template over its storage type T (float or
// __nv_bfloat16) and accumulates in float.  `round_t<T>` reproduces the
// points where the JAX reference casts an f32 value to the compute dtype,
// so the bf16 kernels round where the TPU kernels round.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace geomae {

// dtype codes shared with the Python wrappers (ops/_cuda.py)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

constexpr int kInt32Max = 0x7fffffff;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// f32 value rounded to T and widened back
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

// first index in the ascending a[0, n) whose value is >= v
__device__ __forceinline__ int lower_bound_i32(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Raise a kernel's dynamic shared-memory cap (above 48 KB a block gets
// shared memory only by opting in); a host call of about a microsecond.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace geomae
