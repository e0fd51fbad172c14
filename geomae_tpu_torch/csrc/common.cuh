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

// 1/sqrt(D) at the head widths the attention kernels take: the f32 value
// nearest it (JAX's 1.0 / head_dim ** 0.5 cast to f32), a power of two at
// D = 1, 4, 16, 64 and 256
template <int D>
struct HeadScale {
  static_assert(D == 1 || D == 2 || D == 3 || D == 4 || D == 6 || D == 8 ||
                    D == 12 || D == 16 || D == 24 || D == 32 || D == 48 ||
                    D == 64 || D == 96 || D == 128 || D == 192 ||
                    D == 256 || D == 384 || D == 512,
                "head widths 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, "
                "128, 192, 256, 384, 512");
  static constexpr float kValue = D == 1     ? 1.0f
                                  : D == 2   ? 0.7071067811865476f
                                  : D == 3   ? 0.5773502691896258f
                                  : D == 4   ? 0.5f
                                  : D == 6   ? 0.4082482904638631f
                                  : D == 8   ? 0.35355339059327376f
                                  : D == 12  ? 0.28867513459481287f
                                  : D == 16  ? 0.25f
                                  : D == 24  ? 0.2041241452319315f
                                  : D == 32  ? 0.17677669529663687f
                                  : D == 48  ? 0.14433756729740643f
                                  : D == 64  ? 0.125f
                                  : D == 96  ? 0.10206207261596575f
                                  : D == 128 ? 0.08838834764831845f
                                  : D == 192 ? 0.07216878364870323f
                                  : D == 256 ? 0.0625f
                                  : D == 384 ? 0.051031036307982884f
                                             : 0.044194173824159216f;
  static_assert(kValue * kValue * D > 0.9999f && kValue * kValue * D < 1.0001f,
                "kValue is 1/sqrt(D)");
};

// The f32 attention kernels' channels of a head that one lane keeps: the
// D channels split over a power of two of lanes (lane_group_sum) of whole
// float4s, 16 channels a lane (all 8 at D = 8), 12 at D = 12, 24, 48, 96,
// 192 and 384 (1, 2, 4, 8, 16 and 32 lanes: 16 would give no whole lane
// at D = 12 and 24, and 3, 6, 12 and 24 lanes at the others); D = 384 and
// 512 take a whole warp.  Below 8 a lane keeps the whole head (never more
// channels than the head has)
__host__ __device__ constexpr int f32_lane_channels(int D) {
  return D < 8 ? D : D % 3 == 0 ? 12 : D < 16 ? D : 16;
}

// Heads one lane of K6 / K7's f32 kernels keeps: one from D = 8 up;
// below, as many whole heads as make 8 channels (D = 1, 2 and 4) or 12
// (D = 3 and 6), so a lane keeps whole float4s and a tile as many tokens
// as at D = 8 or 12 (one head a lane would leave C 512 in 512 heads no
// token a block of 256 threads)
__host__ __device__ constexpr int f32_lane_heads(int D) {
  return D < 8 ? (D % 3 == 0 ? 12 : 8) / D : 1;
}

// v summed over the S adjacent lanes of the calling thread's group (S a
// power of two, 32 the whole warp), the same value on each (the pairwise
// sums commute); the lanes of a group take every branch together, so the
// mask names them
template <int S>
__device__ __forceinline__ float lane_group_sum(float v) {
  static_assert(S > 0 && S <= 32 && (S & (S - 1)) == 0, "a power of two");
  if (S == 1) return v;
  const int lane = threadIdx.x % 32;
  // S % 32 is S wherever the shift is taken; it keeps a shift by 32
  // (undefined) out of the S == 32 instantiation
  const unsigned mask =
      S == 32 ? 0xffffffffu : ((1u << (S % 32)) - 1u) << (lane & ~(S - 1));
#pragma unroll
  for (int o = 1; o < S; o <<= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// Raise a kernel's dynamic shared-memory cap (above 48 KB a block gets
// shared memory only by opting in); a host call of about a microsecond.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The blocks of a persistent grid: as many of the kernel's blocks as
// reside on all of the device's SMs at once (its registers and shared
// memory decide), at most `tiles`, at least 1.  `resident` is the
// caller's cache of that count per device (0: not yet asked), so a launch
// adds no device query after the first.
constexpr int kMaxDevices = 64;

template <typename K>
inline cudaError_t persistent_grid(K kernel, int threads, int smem,
                                   int tiles, int (&resident)[kMaxDevices],
                                   int* blocks) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms, per_sm;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (e != cudaSuccess) return e;
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = tiles < 1 ? 1 : (tiles < resident[dev] ? tiles : resident[dev]);
  return cudaSuccess;
}

// Weight gradients of the backward kernels.  On the TPU the grid runs in
// order and one VMEM accumulator collects a weight gradient across all
// tiles; here blocks run in no order, so each block of a persistent grid
// owns a zero-initialised f32 partial in device memory, adds its tiles'
// products to it in tile order, and sum_partials adds the blocks'
// partials in block order: deterministic, no float atomics.

// The output columns that NT threads own at once when each thread owns a
// column: all N where N < NT, NT where NT divides N, else NT / 2 (N of 384
// over 256 threads), so a warp always owns consecutive columns.
__host__ __device__ constexpr int pass_columns(int N, int NT) {
  return N < NT ? N : N % NT == 0 ? NT : NT / 2;
}

// P[k][n] += sum_{r < R} a[r][k] * d[r][n] for the shared f32 tiles a
// [R][K] and d [R][N].  Thread: column n = n0 + tid % NW for each block
// of NW = pass_columns(N, NT) columns from n0, rows k = tid / NW + (NT /
// NW) * j, so each thread always owns the same entries of P (no other
// thread reads them) and reads a as a warp-wide broadcast.
template <int NT, int R, int K, int N>
__device__ __forceinline__ void accum_outer(const float* __restrict__ a,
                                            const float* __restrict__ d,
                                            float* __restrict__ P) {
  constexpr int NW = pass_columns(N, NT);
  constexpr int RG = NT / NW;
  constexpr int J = 16;
  static_assert(NT % NW == 0 && N % NW == 0 && K % (RG * J) == 0,
                "tile shape");
  for (int n0 = 0; n0 < N; n0 += NW) {
    const int n = n0 + threadIdx.x % NW;
    float dc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) dc[r] = d[r * N + n];
    for (int kk = threadIdx.x / NW; kk < K; kk += RG * J) {
      float acc[J];
#pragma unroll
      for (int j = 0; j < J; ++j) acc[j] = P[(size_t)(kk + RG * j) * N + n];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int j = 0; j < J; ++j)
          acc[j] = fmaf(a[r * K + kk + RG * j], dc[r], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < J; ++j) P[(size_t)(kk + RG * j) * N + n] = acc[j];
    }
  }
}

namespace {

// out[e] = sum over b in order of partial[b][e]
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    int nblocks, int E,
                                    float* __restrict__ out) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < nblocks; ++b) s += partial[(size_t)b * E + e];
    out[e] = s;
  }
}

inline cudaError_t sum_partials(const float* partial, int nblocks, int E,
                                float* out, cudaStream_t stream) {
  sum_partials_kernel<<<(E + 255) / 256, 256, 0, stream>>>(partial, nblocks,
                                                           E, out);
  return cudaGetLastError();
}

}  // namespace

}  // namespace geomae
