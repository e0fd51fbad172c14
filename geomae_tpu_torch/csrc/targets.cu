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
// Here a block owns 512 consecutive cells: one round of probes by the
// whole block brackets the run of sorted keys that falls in them, the
// block marks each cell's row, then writes the cells' values (a copy, or
// zeros) once, 16 bytes a thread.  A copy: exact.  Row n_cells is 0: the JAX contract
// sums every sentinel row there, and the targets' sentinel rows are zero
// (an empty pillar's moments); the caller drops that row.  Bound: memory
// (33 MB written at the pretrain step); one pass at the write rate.
#include "common.cuh"

namespace geomae {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSpan = 512;   // output cells a block of K4 owns

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

// A block owns kSpan consecutive output cells [c0, c0 + n) of one batch
// row.  The keys of those cells are one run of the sorted key row: one
// round of kThreads evenly spaced probes (one load deep) brackets it
// within a probe step at each end, the block scans the bracket and marks
// each cell's row in shared memory, then writes the span's n x C values
// once, the row or 0: float4 stores over the span's 16-byte-aligned body,
// scalar stores over its unaligned head and tail (a span starts at
// (b (n_cells + 1) + c0) C values, not a multiple of 4 at C = 13).
__global__ void __launch_bounds__(kThreads)
expand_rows_kernel(const float* __restrict__ feats, const int* __restrict__ key,
                   float* __restrict__ out, int V, int C, int n_cells) {
  __shared__ int src[kSpan];
  const int b = blockIdx.y;
  const int n_out = n_cells + 1;
  const int c0 = blockIdx.x * kSpan;
  const int n = min(kSpan, n_out - c0);
  const int* kb = key + (size_t)b * V;
  for (int j = threadIdx.x; j < n; j += kThreads) src[j] = -1;
  // Probes t s below c0 (or c1) are a prefix of n0 (n1) probes, so the
  // keys in [c0, c1) lie in rows [(n0 - 1) s + 1, n1 s); row n_cells (the
  // sentinel's) takes no key.
  const int c1 = min(c0 + n, n_cells);
  const int s = (V + kThreads - 1) / kThreads, probe = threadIdx.x * s;
  const int kp = probe < V ? kb[probe] : n_cells;
  const int n0 = __syncthreads_count(probe < V && kp < c0);
  const int n1 = __syncthreads_count(probe < V && kp < c1);
  const int lo = n0 ? (n0 - 1) * s + 1 : 0, hi = min(n1 * s, V);
  for (int r = lo + threadIdx.x; r < hi; r += kThreads) {
    const int k = kb[r];
    if (k >= c0 && k < c1) src[k - c0] = r;
  }
  __syncthreads();

  const float* fb = feats + (size_t)b * V * C;
  const size_t f0 = ((size_t)b * n_out + c0) * C;   // the span's first value
  float* ob = out + f0;
  const int len = n * C;
  const int head = min(len, (int)((4 - f0 % 4) % 4));
  const int body = (len - head) / 4;
  auto value = [&](int j, int ch) {
    const int r = src[j];
    return r >= 0 ? fb[(size_t)r * C + ch] : 0.f;
  };
  // Thread t stores the float4s t, t + kThreads, ...: the one at value e
  // starts in cell j at channel ch, advanced without a division per turn.
  const int step = 4 * kThreads, dj = step / C, dch = step - dj * C;
  int e = head + 4 * threadIdx.x;
  int j = e / C, ch = e - j * C;
  for (int i = threadIdx.x; i < body; i += kThreads) {
    float v[4];
    int jj = j, cc = ch;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = value(jj, cc);
      if (++cc == C) {
        cc = 0;
        ++jj;
      }
    }
    *reinterpret_cast<float4*>(ob + e) = make_float4(v[0], v[1], v[2], v[3]);
    e += step;
    j += dj;
    ch += dch;
    if (ch >= C) {
      ch -= C;
      ++j;
    }
  }
  const int rest = len - head - 4 * body;      // the tail, fewer than 4
  if (threadIdx.x < head + rest) {
    const int e = threadIdx.x < head ? threadIdx.x
                                     : head + 4 * body + threadIdx.x - head;
    ob[e] = value(e / C, e % C);
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
  const dim3 grid((n_cells + 1 + kSpan - 1) / kSpan, B);
  expand_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, key, out, V, C, n_cells);
  return cudaGetLastError();
}

}  // extern "C"
