// K3 slot_outer_segment_sum and K4 expand_rows: the two kernels of the
// GeoMAE geometric targets.
//
// K3 replaces geomae_tpu/ops/pallas_segreduce.py:slot_outer_segment_sum_
// pallas and its channel-major twin pallas_segreduce_t.slot_outer_segment_
// sum_t (the one the JAX targets call):
//
//   out[b, v, s, c] = sum over points t with seg[b, t] == v and
//                     slot[b, t] == s of vals[b, t, c]
//
// for ascending dense pillar ids seg (points with seg >= V, the invalid
// and capacity-overflow suffix, are dropped) and slots in [0, S).  The TPU
// kernel builds a one-hot outer product per point chunk and routes it
// through the MXU, with an f32 hi/lo split to keep the sums exact.  Here a
// warp owns one pillar: it finds the pillar's point range [a, e) by binary
// search in the sorted ids, loads its points 32 at a time (one point per
// lane, coalesced), and broadcasts them lane by lane with shuffles; lane l
// owns slots l, l + 32, ... and adds each point of its slots in ascending
// point order.  No float atomics, a fixed order: the output is
// deterministic, counts (0/1 payloads) are exact, and the coordinate sums
// differ from any other f32 order by rounding only.  Each pillar's whole
// S x 4 row, zeros included, is written once, 16 bytes a lane: the output
// is never cleared first.
//
// Bound: memory.  At the pretrain step's [4, 262144, 4] -> [4, 20480,
// 128, 4] the output is 168 MB, the inputs 25 MB.
//
// K4 replaces pallas_segreduce.py:expand_rows_pallas:
//
//   out[b, c] = feats[b, r] where key[b, r] == c, 0 for every other c,
//
// with key ascending and unique below n_cells and the sentinel n_cells on
// a suffix of rows.  The TPU kernel routes each chunk of cells through a
// one-hot matmul against a window of rows (hi/lo split for exactness).
// Here a block owns 256 consecutive cells: each thread finds its cell's
// row by binary search in the sorted keys, then the block writes the
// cells' rows (a copy, or zeros) once, coalesced.  A copy: exact.  Row
// n_cells is 0: the JAX contract sums every sentinel row there, and the
// targets' sentinel rows are zero (an empty pillar's moments); the caller
// drops that row.  Bound: memory (33 MB written at the pretrain step).
#include "common.cuh"

namespace geomae {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCellsPerBlock = 256;

template <int SPL>  // slots per lane: S = 32 * SPL
__global__ void __launch_bounds__(kThreads)
slot_outer_kernel(const float4* __restrict__ vals, const int* __restrict__ slot,
                  const int* __restrict__ seg, float4* __restrict__ out,
                  int P, int V) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (v >= V) return;                       // whole warps leave together
  const int* sb = seg + (size_t)b * P;
  int bound = 0;
  if (lane < 2) bound = lower_bound_i32(sb, P, v + lane);
  const int a = __shfl_sync(kFull, bound, 0);
  const int e = __shfl_sync(kFull, bound, 1);
  const float4* vb = vals + (size_t)b * P;
  const int* slb = slot + (size_t)b * P;

  float4 acc[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p0 = a; p0 < e; p0 += 32) {
    const int p = p0 + lane;
    int s = -1;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < e) {
      s = slb[p];
      x = vb[p];
    }
    const int n = min(32, e - p0);
    for (int k = 0; k < n; ++k) {
      const int sk = __shfl_sync(kFull, s, k);
      const float x0 = __shfl_sync(kFull, x.x, k);
      const float x1 = __shfl_sync(kFull, x.y, k);
      const float x2 = __shfl_sync(kFull, x.z, k);
      const float x3 = __shfl_sync(kFull, x.w, k);
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        if (sk == lane + 32 * j) {
          acc[j].x += x0;
          acc[j].y += x1;
          acc[j].z += x2;
          acc[j].w += x3;
        }
      }
    }
  }
  float4* ob = out + ((size_t)b * V + v) * (32 * SPL);
#pragma unroll
  for (int j = 0; j < SPL; ++j) ob[lane + 32 * j] = acc[j];
}

template <int SPL>
cudaError_t launch_slot_outer(const float* vals, const int* slot,
                              const int* seg, float* out, int B, int P, int V,
                              cudaStream_t stream) {
  const dim3 grid((V + kWarps - 1) / kWarps, B);
  slot_outer_kernel<SPL><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(vals), slot, seg,
      reinterpret_cast<float4*>(out), P, V);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads)
expand_rows_kernel(const float* __restrict__ feats, const int* __restrict__ key,
                   float* __restrict__ out, int V, int C, int n_cells) {
  __shared__ int src[kCellsPerBlock];
  const int b = blockIdx.y;
  const int n_out = n_cells + 1;
  const int c0 = blockIdx.x * kCellsPerBlock;
  const int* kb = key + (size_t)b * V;
  for (int t = threadIdx.x; t < kCellsPerBlock; t += blockDim.x) {
    const int c = c0 + t;
    int r = -1;
    if (c < n_cells) {
      const int i = lower_bound_i32(kb, V, c);
      if (i < V && kb[i] == c) r = i;
    }
    src[t] = r;
  }
  __syncthreads();
  const int ncell = min(kCellsPerBlock, n_out - c0);
  const float* fb = feats + (size_t)b * V * C;
  float* ob = out + ((size_t)b * n_out + c0) * C;
  for (int i = threadIdx.x; i < ncell * C; i += blockDim.x) {
    const int j = i / C;
    const int r = src[j];
    ob[i] = r >= 0 ? fb[(size_t)r * C + (i - j * C)] : 0.f;
  }
}

}  // namespace
}  // namespace geomae

extern "C" {

// vals [B, P, 4] f32, slot and seg [B, P] int32 -> out [B, V, S, 4] f32,
// S in {32, 64, 96, 128}.  seg ascending per batch row; points with
// seg >= V are dropped.
int geomae_slot_outer_segment_sum(const float* vals, const int* slot,
                                  const int* seg, float* out, int B, int P,
                                  int V, int num_slots, void* stream) {
  using namespace geomae;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (num_slots) {
    case 32: return launch_slot_outer<1>(vals, slot, seg, out, B, P, V, s);
    case 64: return launch_slot_outer<2>(vals, slot, seg, out, B, P, V, s);
    case 96: return launch_slot_outer<3>(vals, slot, seg, out, B, P, V, s);
    case 128: return launch_slot_outer<4>(vals, slot, seg, out, B, P, V, s);
    default: return cudaErrorInvalidValue;
  }
}

// feats [B, V, C] f32, key [B, V] int32 (ascending, unique below n_cells,
// n_cells on a suffix) -> out [B, n_cells + 1, C] f32; row n_cells is 0.
int geomae_expand_rows(const float* feats, const int* key, float* out, int B,
                       int V, int C, int n_cells, void* stream) {
  using namespace geomae;
  const dim3 grid((n_cells + 1 + kCellsPerBlock - 1) / kCellsPerBlock, B);
  expand_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, key, out, V, C, n_cells);
  return cudaGetLastError();
}

}  // extern "C"
