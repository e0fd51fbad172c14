// K1 segment_reduce and K2 segment_broadcast over sorted dense segment ids.
//
// Replaces geomae_tpu/ops/pallas_segreduce.py: segment_reduce_pallas (K1,
// with its channel-major twin pallas_segreduce_t.segment_reduce_t) and
// segment_broadcast_pallas (K2, twin segment_broadcast_t).
//
// Contract (the one the voxelizer's point2voxel meets): per batch row the
// ids ascend and are dense ranks; rows with seg >= V (the sentinel of
// invalid points and of capacity overflow) form a suffix.
//
// Bound: memory.  K1 reads [P, C] once and writes [V, C]; K2 reads [P, C]
// and writes [P, C].  The TPU kernels route rows through one-hot matmuls
// because the MXU is the TPU's only fast gather; here a block owns a run
// of whole segments, finds each segment's [start, end) by binary search
// in the sorted ids, and threads walk the channels of one segment's points
// in order.  Neighbouring threads read neighbouring channels of one point,
// so the loads coalesce, and every sum and max is taken in a fixed order:
// results are deterministic, and max is exact in f32 as well as bf16
// (the TPU kept f32 max off its kernel because the MXU truncates it).
// K2 keeps the reduced rows of its segments in shared memory and writes
// them straight back to the segments' points, so the [V, C] table never
// reaches device memory; extra blocks write 0 to the sentinel suffix.
#include "common.cuh"

namespace geomae {
namespace {

enum Op : int { kSum = 0, kMean = 1, kMax = 2 };
constexpr float kNegFill = -3.0e38f;  // empty max rows, as on the TPU
constexpr int kThreads = 256;
constexpr int kZeroBlocks = 64;       // blocks per batch row for the suffix

// bounds[j] = first point of segment s0 + j, for j in [0, nseg]
__device__ __forceinline__ void segment_bounds(const int* seg, int P, int s0,
                                               int nseg, int* bounds) {
  for (int j = threadIdx.x; j <= nseg; j += blockDim.x)
    bounds[j] = lower_bound_i32(seg, P, s0 + j);
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ float reduce_points(const T* x, int C, int c,
                                               int a, int e, int op) {
  if (op == kMax) {
    float m = kNegFill;
    for (int p = a; p < e; ++p) m = fmaxf(m, to_f<T>(x[(size_t)p * C + c]));
    return m;
  }
  float s = 0.f;
  for (int p = a; p < e; ++p) s += to_f<T>(x[(size_t)p * C + c]);
  if (op == kMean && e > a) s /= (float)(e - a);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const T* __restrict__ x, const int* __restrict__ seg,
                      float* __restrict__ out, int P, int C, int V,
                      int segs_per_block, int op) {
  extern __shared__ int bounds[];
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * segs_per_block;
  const int nseg = min(segs_per_block, V - s0);
  const T* xb = x + (size_t)b * P * C;
  segment_bounds(seg + (size_t)b * P, P, s0, nseg, bounds);
  float* ob = out + ((size_t)b * V + s0) * C;
  for (int i = threadIdx.x; i < nseg * C; i += blockDim.x) {
    const int j = i / C, c = i - j * C;
    ob[i] = reduce_points(xb, C, c, bounds[j], bounds[j + 1], op);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_broadcast_kernel(const T* __restrict__ x, const int* __restrict__ seg,
                         T* __restrict__ out, int P, int C, int V,
                         int segs_per_block, int seg_blocks, int op) {
  extern __shared__ int smem[];
  const int b = blockIdx.y;
  const int* sb = seg + (size_t)b * P;
  const T* xb = x + (size_t)b * P * C;
  T* ob = out + (size_t)b * P * C;

  if ((int)blockIdx.x >= seg_blocks) {          // sentinel suffix -> 0
    const size_t start = (size_t)lower_bound_i32(sb, P, V) * C;
    const size_t n = (size_t)P * C - start;
    const size_t step = (size_t)(gridDim.x - seg_blocks) * blockDim.x;
    for (size_t i = (size_t)(blockIdx.x - seg_blocks) * blockDim.x +
                    threadIdx.x; i < n; i += step)
      ob[start + i] = from_f<T>(0.f);
    return;
  }

  const int s0 = blockIdx.x * segs_per_block;
  const int nseg = min(segs_per_block, V - s0);
  int* bounds = smem;
  float* table = reinterpret_cast<float*>(smem + segs_per_block + 1);
  segment_bounds(sb, P, s0, nseg, bounds);
  for (int i = threadIdx.x; i < nseg * C; i += blockDim.x) {
    const int j = i / C, c = i - j * C;
    table[i] = reduce_points(xb, C, c, bounds[j], bounds[j + 1], op);
  }
  __syncthreads();
  const int a0 = bounds[0];
  const int n = (bounds[nseg] - a0) * C;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int p = a0 + i / C, c = i % C;
    ob[(size_t)p * C + c] = from_f<T>(table[(sb[p] - s0) * C + c]);
  }
}

int segs_per_block(int C) { return max(1, min(256, 1024 / C)); }

template <typename T>
cudaError_t launch_reduce(const void* x, const int* seg, float* out, int B,
                          int P, int C, int V, int op, cudaStream_t stream) {
  const int spb = segs_per_block(C);
  const dim3 grid((V + spb - 1) / spb, B);
  segment_reduce_kernel<T><<<grid, kThreads, (spb + 1) * sizeof(int), stream>>>(
      static_cast<const T*>(x), seg, out, P, C, V, spb, op);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_broadcast(const void* x, const int* seg, void* out, int B,
                             int P, int C, int V, int op,
                             cudaStream_t stream) {
  const int spb = segs_per_block(C);
  const int seg_blocks = (V + spb - 1) / spb;
  const dim3 grid(seg_blocks + kZeroBlocks, B);
  const int smem = (spb + 1) * sizeof(int) + spb * C * sizeof(float);
  cudaError_t e = allow_smem(segment_broadcast_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  segment_broadcast_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), seg, static_cast<T*>(out), P, C, V, spb,
      seg_blocks, op);
  return cudaGetLastError();
}

}  // namespace
}  // namespace geomae

extern "C" {

// x [B, P, C] (dtype), seg [B, P] int32 -> out [B, V, C] float32.
// op: 0 sum, 2 max.  Empty rows: 0 (sum) or -3e38 (max).
int geomae_segment_reduce(int dtype, const void* x, const int* seg,
                          float* out, int B, int P, int C, int V, int op,
                          void* stream) {
  using namespace geomae;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_reduce<float>(x, seg, out, B, P, C, V, op, s);
  if (dtype == kBFloat16)
    return launch_reduce<__nv_bfloat16>(x, seg, out, B, P, C, V, op, s);
  return cudaErrorInvalidValue;
}

// x [B, P, C] (dtype), seg [B, P] int32 -> out [B, P, C] (dtype).
// op: 0 sum, 1 mean, 2 max.  Rows with seg >= V give 0.
int geomae_segment_broadcast(int dtype, const void* x, const int* seg,
                             void* out, int B, int P, int C, int V, int op,
                             void* stream) {
  using namespace geomae;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_broadcast<float>(x, seg, out, B, P, C, V, op, s);
  if (dtype == kBFloat16)
    return launch_broadcast<__nv_bfloat16>(x, seg, out, B, P, C, V, op, s);
  return cudaErrorInvalidValue;
}

const char* geomae_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
