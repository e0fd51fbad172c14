// K8 band attention over already projected q, k, v: forward and backward.
//
// Replaces geomae_tpu/ops/pallas_attention.py: band_attention_pallas
// (_pallas_forward / _fwd_kernel) and its backward _pallas_backward
// (_dq_kernel over query tiles, _dkv_kernel over key tiles).  Over
// window-sorted tokens, per head h of D channels:
//   s_ij  = (q_i . k_j) / sqrt(D)       for j in i's window with key_valid
//   out_i = softmax_j(s_ij) v_j
// Rows with win_id == INT32_MAX (padding) and rows with no visible key
// return exactly 0.  The q/k/v projections happen outside (three Linears
// in models/sst.py), as on the JAX route.
//
// Widths: every kernel is a template over the head width D (1, 2, 4, 8,
// 16, 32, 64 or 128; 3, 6, 12, 24, 48, 96 and 192 at C 384, the one C
// that splits into them; 256 at C 256 and 512; 384 and 512 at C 384 and
// 512, one head) and the row width C (128, 256, 384 or
// 512), so the head count H = C / D, the row stride and every index are
// constants; each C is a translation unit of its own
// (band_attention_c*.cu, compiled in parallel), and the entry points
// (band_attention.cu) pick the unit by C = H D and the instantiation by
// D.  Each kernel stages a fixed number of channels a block, whole heads
// of them, and the grid spans the head groups: the f32 kernels 128
// channels (128 / D heads; 96 at D = 12, 24, 48 and 96; one head above
// 128), the bf16 forward 64 (64 / D heads, at least one; 32 at D = 8, 48
// at D = 12 and 24), the bf16 backward 32 (32 / D heads, at least one: 24
// at D = 12 and 24, 48 to 256 at D of 48 and more).  C enters only as
// the row stride, the head count and the grid's head groups (C / 128 = 3
// or 4 f32 groups at C 384 or 512, 6 or 8 bf16 forward groups, 12 or 16
// bf16 backward groups at D <= 32), so a wider row is more blocks of the
// same kernel.  At the shipped width (8 heads
// of 16) each instantiation is the kernel it was before the widths.
// Where a width needs its own design: at D = 8 the bf16 kernels contract a
// head over 8 channels with mma.sync m16n8k8 (no zero padding to 16) and
// take its one n-tile of 8 in the value products, and at D = 24 over one
// m16n8k16 step and that m16n8k8 tail (3 n-tiles of 8); at D = 12, whose
// bf16 heads start 24 bytes apart (no 16-byte copy or ldmatrix row can
// start there), they copy each head 8 bytes at a time into a 16-channel
// slot of shared memory whose last 4 channels are zero-filled and run D =
// 16's products over the slots: the zeros add exact zeros to S, dP and
// the outputs' unwritten columns 12-15, and the scale stays 1/sqrt(12)
// (a k-step never spans two heads); the f32 kernels give a
// (query, head) D / 16 lanes of 16 channels, one lane at D = 8 (at D =
// 128 one thread would hold 256 floats of q and accumulator, 896 in the
// backward), and at D = 48, 96 and 192 (3, 6 and 12 lanes of 16 are no
// power of two for the shuffle sums, and 128 channels no whole heads) 4,
// 8 and 16 lanes of 12 channels (one and 2 at D = 12 and 24); above D =
// 128 a block takes one head and 16 queries (16 lanes a query, 256
// threads), at D = 384 and 512 8 queries of a whole warp of 12 and 16
// channels a lane; at D = 128 the bf16
// forward runs two blocks an SM (a warp's 16 x 128 f32 output takes 64
// registers a lane), above it one, reading Q's fragments one k-step at a
// time; at D = 96 and 128 the bf16 backward splits each head's output
// columns over two blocks, at D = 192 and 256 over three and four blocks
// of 64 columns with 16-row chunks (two 64-row chunks beside a
// 256-channel tile would stage 405 KB), each block computing the
// scores and dP over all D channels (the three 16 x D accumulators of a
// warp would take 144 to 384 registers a lane); at D = 384 and 512 the
// bf16 forward splits the output columns over two blocks too, and the
// backward runs JAX's two passes, the tile as queries and as keys, in one
// launch (band_attention_bwd_wide_kernel): the four arrays of a tile
// beside two chunks of four would stage 301 and 399 KB.  Below 8 (D = 6,
// 4, 3, 2 and 1: C 384 in 64 and 128 heads, any C in 32 to 512) the bf16
// kernels stage each head into an 8-channel slot whose channels past D
// are zero and run D = 8's products and blocks over the slots
// (stage_slots: 8-, 4-byte or register copies by where a head starts),
// and the f32 kernels give a lane one whole head, 16 heads a block as at
// D = 8, loading it in float4s, float2s or floats.
//
// Bound: with no projection inside, a call moves 4 rows of C values per
// token and computes 4 * C operations per same-window pair forward (10 * C
// backward); at 144-token windows that is far more arithmetic than bytes,
// yet the bytes bound it on this card (0.0259 ms at [4, 20480] forward,
// against 0.0042 ms of tensor-core work).  The TPU kernel streams a fixed
// +-192-token band with an f32 copy of the window ids through
// double-buffered DMA; none of that is carried over.  Each block takes a
// tile of queries, finds the exact key range of the tile's windows in the
// sorted ids (in the bf16 kernels key_range_warp: 32-way searches by one
// warp, three dependent loads where a binary search takes fifteen; the
// f32 kernels keep key_range, binary searches by one thread, for the same
// range), and streams the keys in chunks through shared memory with an
// online softmax, so a window of any size is exact and no key outside the
// tile's windows is read.
//
// bfloat16 forward, on the tensor cores (band_attention_fwd_tc_kernel):
// 64-token tiles of 4 warps x 16 rows, 64 channels a block (4 heads of
// 16), 64-key chunks; S = Q K^T and O += P V on mma.sync m16n8k16, P built
// and masked on the accumulators and rounded into the value product's A
// fragments.  At D = 16: 128 registers (88 bytes spilled), 46,592 bytes
// of shared memory: four blocks an SM.  About a fifth of its bound
// (PERF.md): the products take about 0.15 of its time and the exps 0.11,
// the rest is the per-element masking and online softmax, staging and the
// key range (probe_forwards); 8 heads a block (255 registers) and three
// blocks an SM are slower.  The dtype points below hold but one: P is
// rounded against the running max of the chunks seen so far, then O
// rescales in f32 (band_attention_tiles_plain is this order in plain
// PyTorch).
//
// float32 forward, on the CUDA cores (band_attention_kernel): a block takes
// 32 queries of one 128-channel head group (16 of one head above D =
// 128, 8 above 256) and walks the keys one at a time, chunks of as many
// keys staged in f32; D / 16 adjacent lanes (one at D = 8) own one
// (query, head) pair, 16 channels each, and a warp holds one head, so
// each key row read from shared memory is a broadcast.
//
// Dtype points of _fwd_body: the score accumulates in f32 from the compute
// dtype's q and k and the 1/sqrt(D) scale multiplies the f32 score; the
// probabilities are cast to v's dtype before the value product, f32
// accumulation.  Under grad the forward also writes each (row, head)'s
// log-sum-exp of the scaled scores, lse = m + log(l) (0 where the row sees
// no key); the TPU keeps m and l apart.
//
// Backward, one kernel for _dq_kernel and _dkv_kernel: a tile's tokens
// are queries AND keys, and the block walks the same exact key range.  For
// a tile token i and a chunk token j of its window, with
// p = exp(s - lse) and D = rowsum(dO * out) per (row, head), f32:
//   as query:  ds = p (dO_i . v_j - D_i);  dq_i += ds k_j
//   as key:    dv_i += p dO_j;  ds = p (dO_j . v_i - D_j);  dk_i += ds q_j
// so dk and dv, a scatter across query tiles, are a gather here: complete
// and rounded once per key when the loop ends, no atomics, deterministic.
// D is computed once, by a prologue kernel over every (row, head), as the
// JAX package computes it once (an einsum before its kernels); the
// backward kernels read it with lse and read no row of out.
// Dtype points of _dq_body / _dkv_body: ds and p cast to the compute dtype
// before their products, dq and dk scaled by 1/sqrt(D) after the f32 sum.
// A row whose window holds no valid key contributes and receives 0.
// f32 runs on the CUDA cores (D / 16 lanes per (token, head) of a
// 32-token tile, one at D = 8, 16-token tiles above D = 128, 8-token tiles
// above 256); bf16 on the tensor cores (mma.sync m16n8k16 over 64-token
// tiles and 64-row chunks, 16-row chunks above D = 128, see
// band_attention_bwd_tc_kernel, and band_attention_bwd_wide_kernel above
// D = 256), where each product rounds at the points above and only the
// summation order moves.
#pragma once

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace geomae {

// The kernels of one row width C for one head width D, behind the entry
// points (band_attention.cu): the forward (with the log-sum-exp where lse
// is not null), the backward's D prologue over n = B V H (row, head)
// pairs, and the backward.
struct K8Kernels {
  cudaError_t (*forward)(int dtype, const void* q, const void* k,
                         const void* v, const int* win,
                         const uint8_t* key_valid, void* out, float* lse,
                         int B, int V, cudaStream_t s);
  cudaError_t (*delta)(int dtype, const void* dout, const void* out,
                       const int* win, float* d, int n, cudaStream_t s);
  cudaError_t (*backward)(int dtype, const void* q, const void* k,
                          const void* v, const int* win,
                          const uint8_t* key_valid, const float* lse,
                          const float* delta, const void* dout, void* dq,
                          void* dk, void* dv, int B, int V, cudaStream_t s);
};

// one per row width, each in its translation unit: the kernels of head
// width D, or null for a D the kernels do not take
const K8Kernels* k8_kernels_c128(int D);
const K8Kernels* k8_kernels_c256(int D);
const K8Kernels* k8_kernels_c384(int D);
const K8Kernels* k8_kernels_c512(int D);

namespace {

// A head of D channels: its 1/sqrt(D), and the f32 kernels' layout
template <int D>
struct Head {
  static constexpr float kScale = HeadScale<D>::kValue;
  // the f32 kernels: channels a block stages (whole heads: 128, or 96 at
  // D = 12, 24, 48 and 96, which do not divide 128, one head above 128,
  // 16 heads below 8, as at D = 8), heads a block, lanes a (query, head)
  // (D / 16 of 16 channels, one of 8 at D = 8, D / 12 of 12 at D = 12,
  // 24, 48, 96 and 192, one of the whole head below 8; the lanes' partial
  // dot products summed by shuffles, as in K6's f32 kernels), channels a
  // lane, queries a block (and keys a chunk: the chunk's rows map onto
  // the tile's lanes) and threads.  At D = 192 and 256 a (query, head)
  // takes 16 lanes, so a block takes 16 queries: 256 threads, as at D =
  // 128 (512 would leave a thread 128 registers, and the backward keeps
  // 7 x 16 floats of a head in registers); at D = 384 and 512 a whole
  // warp of 12 and 16 channels a lane, and a block 8 queries, 256
  // threads again
  static constexpr int kW = D > 128 ? D
                            : D < 8 ? 16 * D
                            : D % 3 == 0 ? 96 : 128;
  static constexpr int kGH = kW / D;
  static constexpr int kLC = f32_lane_channels(D);
  static constexpr int kLanes = D / kLC;
  static constexpr int kTQ = D > 256 ? 8 : D > 128 ? 16 : 32;
  static constexpr int kThreads = kTQ * kGH * kLanes;
  static constexpr int kFwdSmemBytes =
      2 * kTQ * kW * sizeof(float) + 2 * kTQ * sizeof(int);
  static constexpr int kBwdSmemBytes =
      4 * kTQ * kW * sizeof(float) + (2 * kTQ + 2 * kTQ * kGH) * sizeof(int);
  static_assert(kGH * D == kW && kLanes * kLC == D &&
                    (kLC % 4 == 0 || D < 8) && kW % 4 == 0,
                "whole heads of whole float4 lanes (below 8 whole heads a "
                "lane); float4 rows");
  static_assert(kThreads <= 512 && kThreads >= kTQ * kGH,
                "a block of whole lane groups");

  // the calling thread's head in the group, query of the tile and lane of
  // its (query, head): a warp is one head of 32 queries where kLanes is 1
  __device__ static int head() { return threadIdx.x / (kTQ * kLanes); }
  __device__ static int query() { return threadIdx.x / kLanes % kTQ; }
  __device__ static int lane() { return threadIdx.x % kLanes; }
};
static_assert(Head<16>::kScale * Head<16>::kScale * 16 == 1.0f, "1/sqrt(D)");
static_assert(Head<16>::kThreads == 256, "the shipped block: 8 heads x 32");
static_assert(Head<48>::kThreads == 256 && Head<96>::kThreads == 256,
              "2 heads of 4 lanes, 1 head of 8 lanes, x 32");
static_assert(Head<192>::kThreads == 256 && Head<256>::kThreads == 256,
              "1 head of 16 lanes x 16");
static_assert(Head<24>::kThreads == 256 && Head<12>::kThreads == 256,
              "4 heads of 2 lanes, 8 heads of 1 lane, x 32");
static_assert(Head<384>::kThreads == 256 && Head<512>::kThreads == 256,
              "1 head of 32 lanes x 8");
static_assert(Head<6>::kThreads == 512 && Head<1>::kThreads == 512 &&
                  Head<8>::kThreads == 512,
              "below 8 D 8's block: 16 heads of 1 lane x 32");

// four consecutive values (16-byte aligned in f32, 8-byte in bf16) as f32
template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Stage rows [r0, r0 + n) of the head group's W channels of src (row
// stride C, src at the group's first channel) into dst ([KC][W], f32);
// rows past n read 0.
template <typename T, int kThreads, int C, int W, int KC>
__device__ __forceinline__ void stage(const T* __restrict__ src, int r0,
                                      int n, float* __restrict__ dst) {
  for (int e = 4 * threadIdx.x; e < KC * W; e += 4 * kThreads) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e / W < n) v = load4<T>(src + (size_t)(r0 + e / W) * C + e % W);
    *reinterpret_cast<float4*>(dst + e) = v;
  }
}

// The D f32 values at p (a lane's channels) into v, in d order: float4
// loads where D is a multiple of 4 (every width of 8 or more, and 4,
// whose heads start 16 bytes apart), float2 at D = 6 and 2 (heads 24 and
// 8 bytes apart), one float at D = 3 and 1.
template <int D>
__device__ __forceinline__ void load_f32(const float* __restrict__ p,
                                         float (&v)[D]) {
  constexpr int kVec = D % 4 == 0 ? 4 : D % 2 == 0 ? 2 : 1;
#pragma unroll
  for (int d = 0; d < D; d += kVec) {
    if constexpr (kVec == 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + d);
      v[d] = u.x, v[d + 1] = u.y, v[d + 2] = u.z, v[d + 3] = u.w;
    } else if constexpr (kVec == 2) {
      const float2 u = *reinterpret_cast<const float2*>(p + d);
      v[d] = u.x, v[d + 1] = u.y;
    } else {
      v[d] = p[d];
    }
  }
}

// One token's head slice (D values) from global memory, as f32.
template <typename T, int D>
__device__ __forceinline__ void load_head(const T* __restrict__ p,
                                          float (&r)[D]) {
  if constexpr (D % 4 != 0) {
    static_assert(std::is_same_v<T, float>, "heads below 8: f32 rows");
    load_f32<D>(p, r);
  } else {
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 v = load4<T>(p + 4 * d4);
      r[4 * d4 + 0] = v.x;
      r[4 * d4 + 1] = v.y;
      r[4 * d4 + 2] = v.z;
      r[4 * d4 + 3] = v.w;
    }
  }
}

template <int D>
__device__ __forceinline__ float dot_head(const float (&a)[D],
                                          const float* __restrict__ b) {
  float s = 0.f;
  if constexpr (D % 4 != 0) {
    float v[D];
    load_f32<D>(b, v);
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(a[d], v[d], s);
  } else {
    const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 v = b4[d4];
      s = fmaf(a[4 * d4 + 0], v.x, s);
      s = fmaf(a[4 * d4 + 1], v.y, s);
      s = fmaf(a[4 * d4 + 2], v.z, s);
      s = fmaf(a[4 * d4 + 3], v.w, s);
    }
  }
  return s;
}

// acc[d] += w * b[d]
template <int D>
__device__ __forceinline__ void axpy_head(float w, const float* __restrict__ b,
                                          float (&acc)[D]) {
  if constexpr (D % 4 != 0) {
    float v[D];
    load_f32<D>(b, v);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(w, v[d], acc[d]);
  } else {
    const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 v = b4[d4];
      acc[4 * d4 + 0] = fmaf(w, v.x, acc[4 * d4 + 0]);
      acc[4 * d4 + 1] = fmaf(w, v.y, acc[4 * d4 + 1]);
      acc[4 * d4 + 2] = fmaf(w, v.z, acc[4 * d4 + 2]);
      acc[4 * d4 + 3] = fmaf(w, v.w, acc[4 * d4 + 3]);
    }
  }
}

// The exact key range [ks, ke) of the windows of the tile's real queries
// [q0, q0 + nq) in one sample's sorted ids wb[0, V); ks == ke for a tile
// of padding only.  Called by one thread.  Only the f32 kernels call it:
// they stay as they were, the parity path; key_range_warp below returns
// the same range faster and serves the bf16 kernels.
__device__ __forceinline__ void key_range(const int* __restrict__ wb, int V,
                                          int q0, int nq, int* range) {
  int ks = 0, ke = 0;
  const int first = wb[q0];
  if (first != kInt32Max) {
    // padding is a suffix: the tile's last real query sits before it
    const int last_q = min(lower_bound_i32(wb, V, kInt32Max), q0 + nq) - 1;
    ks = lower_bound_i32(wb, V, first);
    ke = lower_bound_i32(wb, V, wb[last_q] + 1);
  }
  range[0] = ks;
  range[1] = ke;
}

// The first index in the ascending a[lo, hi) whose value is >= v (hi if
// none), searched by a whole warp: every round its lanes probe 32 evenly
// spaced points of the bracket, so a bracket of 20,480 ids takes three
// dependent loads where a binary search takes fifteen.  Every lane of the
// warp calls it and gets the result.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a,
                                                int lo, int hi, int v) {
  const int lane = threadIdx.x % 32;
  while (hi - lo > 32) {           // the answer lies in [lo, hi]
    const int step = (hi - lo + 31) / 32;
    const int i = lo + lane * step;
    const unsigned ge = __ballot_sync(0xffffffffu, i >= hi || a[i] >= v);
    if (ge == 0) {                 // past the last probe
      lo += 31 * step + 1;
      continue;
    }
    const int f = __ffs(ge) - 1;
    if (f == 0) return lo;
    hi = min(hi, lo + f * step);
    lo += (f - 1) * step + 1;
  }
  const unsigned ge =
      __ballot_sync(0xffffffffu, lo + lane >= hi || a[lo + lane] >= v);
  return ge ? lo + __ffs(ge) - 1 : hi;
}

// key_range searched by a whole warp (warp_lower_bound); its lane 0
// writes the range.
__device__ __forceinline__ void key_range_warp(const int* __restrict__ wb,
                                               int V, int q0, int nq,
                                               int* range) {
  int ks = 0, ke = 0;
  const int first = wb[q0];
  if (first != kInt32Max) {
    int last_q = q0 + nq - 1;      // padding is a suffix
    if (wb[last_q] == kInt32Max)
      last_q = warp_lower_bound(wb, q0 + 1, last_q, kInt32Max) - 1;
    ks = warp_lower_bound(wb, 0, q0, first);
    ke = warp_lower_bound(wb, last_q + 1, V, wb[last_q] + 1);
  }
  if (threadIdx.x % 32 == 0) {
    range[0] = ks;
    range[1] = ke;
  }
}

// Block (query tile, head group of 128 channels, sample).
template <int D, int C>
__global__ void __launch_bounds__(Head<D>::kThreads)
band_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ win,
                      const uint8_t* __restrict__ key_valid,
                      float* __restrict__ out, float* __restrict__ lse,
                      int V) {
  using Hd = Head<D>;
  constexpr int H = C / D;
  constexpr int W = Hd::kW;
  constexpr int TQ = Hd::kTQ, KC = Hd::kTQ;
  extern __shared__ float smem[];
  float* s_k = smem;              // [KC][W] k rows of the head group
  float* s_v = s_k + KC * W;      // [KC][W] v rows
  int* s_win = reinterpret_cast<int*>(s_v + KC * W);   // [KC]
  int* s_kv = s_win + KC;                               // [KC]
  __shared__ int s_range[2];

  const int b = blockIdx.z, h0 = blockIdx.y * Hd::kGH;
  const int q0 = blockIdx.x * TQ;
  const int nq = min(TQ, V - q0);
  const size_t row0 = (size_t)b * V;
  const int* wb = win + row0;
  const uint8_t* kvb = key_valid + row0;
  const float* kb = k + row0 * C + h0 * D;
  const float* vb = v + row0 * C + h0 * D;

  constexpr int LC = Hd::kLC, S = Hd::kLanes;   // channels a lane, lanes
  const int h = Hd::head();         // the group's head, warp-uniform
  const int i = Hd::query();
  const int c = h * D + Hd::lane() * LC;   // the lane's first channel
  const int qi = q0 + i;
  const int my_win = (i < nq) ? wb[qi] : kInt32Max;

  if (threadIdx.x == 0) key_range(wb, V, q0, nq, s_range);
  __syncthreads();
  const int ks = s_range[0], ke = s_range[1];

  float qr[LC];
#pragma unroll
  for (int d = 0; d < LC; ++d) qr[d] = 0.f;
  if (my_win != kInt32Max)
    load_head<float, LC>(q + (row0 + qi) * C + h0 * D + c, qr);

  float m = -INFINITY, l = 0.f, acc[LC];
#pragma unroll
  for (int d = 0; d < LC; ++d) acc[d] = 0.f;

  for (int k0 = ks; k0 < ke; k0 += KC) {
    const int nk = min(KC, ke - k0);
    __syncthreads();   // the previous chunk is consumed
    stage<float, Hd::kThreads, C, W, KC>(kb, k0, nk, s_k);
    stage<float, Hd::kThreads, C, W, KC>(vb, k0, nk, s_v);
    if (threadIdx.x < KC) {
      const int r = threadIdx.x;
      s_win[r] = r < nk ? wb[k0 + r] : kInt32Max;
      s_kv[r] = r < nk ? (int)kvb[k0 + r] : 0;
    }
    __syncthreads();
    if (my_win == kInt32Max) continue;
    for (int j = 0; j < nk; ++j) {
      if (s_win[j] != my_win || !s_kv[j]) continue;
      const float s =
          lane_group_sum<S>(dot_head<LC>(qr, &s_k[j * W + c])) * Hd::kScale;
      const float mn = fmaxf(m, s);
      const float corr = expf(m - mn);
      const float p = expf(s - mn);
      l = l * corr + p;
#pragma unroll
      for (int d = 0; d < LC; ++d) acc[d] *= corr;
      axpy_head<LC>(p, &s_v[j * W + c], acc);
      m = mn;
    }
  }

  if (i < nq) {
    const bool seen = my_win != kInt32Max && l > 0.f;
    const float inv = seen ? 1.f / l : 0.f;
    float* o = out + (row0 + qi) * C + h0 * D + c;
#pragma unroll
    for (int d = 0; d < LC; ++d) o[d] = acc[d] * inv;
    if (lse && Hd::lane() == 0)
      lse[(row0 + qi) * H + h0 + h] = seen ? m + logf(l) : 0.f;
  }
}

template <int D, int C>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int* win, const uint8_t* key_valid, void* out,
                       float* lse, int B, int V, cudaStream_t stream) {
  using Hd = Head<D>;
  static_assert(C % Hd::kW == 0, "whole head groups");
  cudaError_t e = allow_smem(band_attention_kernel<D, C>, Hd::kFwdSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((V + Hd::kTQ - 1) / Hd::kTQ, C / Hd::kW, B);
  band_attention_kernel<D, C>
      <<<grid, Hd::kThreads, Hd::kFwdSmemBytes, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), win, key_valid,
          static_cast<float*>(out), lse, V);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void *q, *k, *v;
  const void* dout;              // the cotangent of the forward's output
  const int* win;
  const uint8_t* key_valid;
  const float* lse;              // [B, V, H] from the forward
  const float* delta;            // [B, V, H] D = rowsum(dO * out)
  void *dq, *dk, *dv;
  int V;
};

// The prologue: D[r, h] = sum_d dO[r, h, d] out[r, h, d] in f32, one
// thread per (row, head), the terms added in d order (a bf16 product is
// exact in f32, as in the JAX einsum with preferred_element_type=f32;
// below D = 8 each product is rounded before its sum, as the plain
// version rounds f32 products and adds them in d order there: the two
// agree bitwise).
// A padding row (win == INT32_MAX) reads nothing and takes D = 0: the
// backward reads D of real rows only.
constexpr int kDeltaThreads = 256;

template <typename T, int D, int C>
__global__ void __launch_bounds__(kDeltaThreads)
band_attention_delta_kernel(const T* __restrict__ dout,
                            const T* __restrict__ out,
                            const int* __restrict__ win,
                            float* __restrict__ delta, int n) {
  constexpr int H = C / D;
  const int i = blockIdx.x * kDeltaThreads + threadIdx.x;
  if (i >= n) return;
  float d = 0.f;
  if (win[i / H] != kInt32Max) {   // four channels at a time, in d order
    if constexpr (D < 8) {         // one at a time, each product rounded
                                   // as the plain version's (exact in bf16)
#pragma unroll
      for (int e = 0; e < D; ++e)
        d = __fadd_rn(d, __fmul_rn(to_f<T>(dout[(size_t)i * D + e]),
                                   to_f<T>(out[(size_t)i * D + e])));
    } else {
#pragma unroll
      for (int e = 0; e < D; e += 4) {
        const float4 g = load4<T>(dout + (size_t)i * D + e);
        const float4 o = load4<T>(out + (size_t)i * D + e);
        d = fmaf(g.x, o.x, d);
        d = fmaf(g.y, o.y, d);
        d = fmaf(g.z, o.z, d);
        d = fmaf(g.w, o.w, d);
      }
    }
  }
  delta[i] = d;
}

template <typename T, int D, int C>
cudaError_t launch_delta(const void* dout, const void* out, const int* win,
                         float* delta, int n, cudaStream_t stream) {
  band_attention_delta_kernel<T, D, C>
      <<<(n + kDeltaThreads - 1) / kDeltaThreads, kDeltaThreads, 0, stream>>>(
          static_cast<const T*>(dout), static_cast<const T*>(out), win, delta,
          n);
  return cudaGetLastError();
}

// f32: the CUDA cores, kLanes threads per (token, head) of a 32-token tile
// of one 128-channel head group, 16 channels each (one thread at D = 8).
template <int D, int C>
__global__ void __launch_bounds__(Head<D>::kThreads)
band_attention_bwd_f32_kernel(BwdArgs p) {
  using T = float;
  using Hd = Head<D>;
  constexpr int W = Hd::kW;
  constexpr int GH = Hd::kGH;
  constexpr int H = C / D;
  constexpr int TQ = Hd::kTQ, KC = Hd::kTQ;
  extern __shared__ float smem[];
  float* s_q = smem;               // [KC][W] q rows of the chunk
  float* s_k = s_q + KC * W;       // [KC][W] k rows
  float* s_v = s_k + KC * W;       // [KC][W] v rows
  float* s_do = s_v + KC * W;      // [KC][W] dO rows
  int* s_win = reinterpret_cast<int*>(s_do + KC * W);   // [KC]
  int* s_kv = s_win + KC;                                // [KC]
  float* s_lse = reinterpret_cast<float*>(s_kv + KC);   // [KC][GH]
  float* s_dd = s_lse + KC * GH;                         // [KC][GH] D
  __shared__ int s_range[2];

  const int b = blockIdx.z, h0 = blockIdx.y * GH;
  const int q0 = blockIdx.x * TQ;
  const int nq = min(TQ, p.V - q0);
  const size_t row0 = (size_t)b * p.V;
  const int* wb = p.win + row0;
  const uint8_t* kvb = p.key_valid + row0;
  const size_t base = row0 * C + h0 * D;
  const T* qb = static_cast<const T*>(p.q) + base;
  const T* kb = static_cast<const T*>(p.k) + base;
  const T* vb = static_cast<const T*>(p.v) + base;
  const T* gb = static_cast<const T*>(p.dout) + base;
  const float* lb = p.lse + row0 * H + h0;
  const float* db = p.delta + row0 * H + h0;

  constexpr int LC = Hd::kLC, S = Hd::kLanes;   // channels a lane, lanes
  const int h = Hd::head();        // the group's head, warp-uniform
  const int i = Hd::query();
  const int c = h * D + Hd::lane() * LC;   // the lane's first channel
  const int qi = q0 + i;
  const int my_win = (i < nq) ? wb[qi] : kInt32Max;
  const bool my_kv = (i < nq) && kvb[qi];

  if (threadIdx.x == 0) key_range(wb, p.V, q0, nq, s_range);
  __syncthreads();
  const int ks = s_range[0], ke = s_range[1];

  // the tile's own q, k, v, dO, D and lse, in registers
  float qr[LC], kr[LC], vr[LC], g[LC], dq[LC], dk[LC], dv[LC];
#pragma unroll
  for (int d = 0; d < LC; ++d) {
    qr[d] = kr[d] = vr[d] = g[d] = 0.f;
    dq[d] = dk[d] = dv[d] = 0.f;
  }
  float lse_i = 0.f, d_i = 0.f;
  if (my_win != kInt32Max) {
    const size_t c0 = (size_t)qi * C + c;
    load_head<T, LC>(qb + c0, qr);
    load_head<T, LC>(kb + c0, kr);
    load_head<T, LC>(vb + c0, vr);
    load_head<T, LC>(gb + c0, g);
    lse_i = lb[(size_t)qi * H + h];
    d_i = db[(size_t)qi * H + h];
  }

  for (int k0 = ks; k0 < ke; k0 += KC) {
    const int nk = min(KC, ke - k0);
    __syncthreads();               // the previous chunk is consumed
    stage<T, Hd::kThreads, C, W, KC>(qb, k0, nk, s_q);
    stage<T, Hd::kThreads, C, W, KC>(kb, k0, nk, s_k);
    stage<T, Hd::kThreads, C, W, KC>(vb, k0, nk, s_v);
    stage<T, Hd::kThreads, C, W, KC>(gb, k0, nk, s_do);
    {  // thread (row r, head hh): D and lse of the chunk's rows; window ids
      const int r = threadIdx.x % KC, hh = threadIdx.x / KC;
      const bool in = r < nk;
      if (Hd::kLanes == 1 || hh < GH) {
        s_dd[r * GH + hh] = in ? db[(size_t)(k0 + r) * H + hh] : 0.f;
        s_lse[r * GH + hh] = in ? lb[(size_t)(k0 + r) * H + hh] : 0.f;
      }
      if (hh == 0) {
        s_win[r] = in ? wb[k0 + r] : kInt32Max;
        s_kv[r] = in ? (int)kvb[k0 + r] : 0;
      }
    }
    __syncthreads();
    if (my_win == kInt32Max) continue;
    for (int j = 0; j < nk; ++j) {
      if (s_win[j] != my_win) continue;
      const float* kj = &s_k[j * W + c];
      const float* vj = &s_v[j * W + c];
      if (s_kv[j]) {             // token i as query, j as key
        const float sc = lane_group_sum<S>(dot_head<LC>(qr, kj)) * Hd::kScale;
        const float dp = lane_group_sum<S>(dot_head<LC>(g, vj));
        const float pr = expf(sc - lse_i);
        axpy_head<LC>(pr * (dp - d_i), kj, dq);
      }
      if (my_kv) {               // token i as key, j as query
        const float* qj = &s_q[j * W + c];
        const float* gj = &s_do[j * W + c];
        const float sc = lane_group_sum<S>(dot_head<LC>(kr, qj)) * Hd::kScale;
        const float dp = lane_group_sum<S>(dot_head<LC>(vr, gj));
        const float pr = expf(sc - s_lse[j * GH + h]);
        axpy_head<LC>(pr, gj, dv);
        axpy_head<LC>(pr * (dp - s_dd[j * GH + h]), qj, dk);
      }
    }
  }

  if (i < nq) {                    // padding rows and padding tiles write 0
    const size_t c0 = base + (size_t)qi * C + c;
    T* oq = static_cast<T*>(p.dq) + c0;
    T* ok = static_cast<T*>(p.dk) + c0;
    T* ov = static_cast<T*>(p.dv) + c0;
#pragma unroll
    for (int d = 0; d < LC; ++d) {
      oq[d] = dq[d] * Hd::kScale;
      ok[d] = dk[d] * Hd::kScale;
      ov[d] = dv[d];
    }
  }
}

template <int D, int C>
cudaError_t launch_bwd_f32(const BwdArgs& args, int B, cudaStream_t stream) {
  using Hd = Head<D>;
  cudaError_t e =
      allow_smem(band_attention_bwd_f32_kernel<D, C>, Hd::kBwdSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((args.V + Hd::kTQ - 1) / Hd::kTQ, C / Hd::kW, B);
  band_attention_bwd_f32_kernel<D, C>
      <<<grid, Hd::kThreads, Hd::kBwdSmemBytes, stream>>>(args);
  return cudaGetLastError();
}

// bf16: the tensor cores.  A block takes a tile of kTile tokens and kHG
// heads; each warp owns 16 of the tile's rows, as queries and as keys, and
// holds their dq, dk and dv for the kHG heads in mma accumulators over the
// tile's whole key range, streamed in chunks of kChunk rows.  Per head and
// 16 chunk rows a warp runs 8 (D / 16) + 6 (D / 8) m16n8k16 products
// (fourteen at D = 16): S = Q K^T and dP = dO V^T (then dq += dS K) with
// the tile as queries, S^T = K Q^T and dP^T = V dO^T (then dv += P^T dO,
// dk += dS^T Q) with the tile as keys.  P and dS are built on the f32
// accumulators, masked per element by the row's and the column's window
// ids and the key's validity, and rounded to bf16 into the next product's
// A fragments (the C layout of m16n8k16 is its A layout), so neither goes
// through shared memory.  At D = 8 the four score products are m16n8k8
// and the three output products one m16n8k16 each; at D = 24 (one head a
// block, rows of 40 bf16) each adds that m16n8k8 step and that n-tile to
// D = 16's, and at D = 12 a block is D = 16's two heads over slots of 16
// channels (BwdTc::kSlot).  At D = 128 a block
// keeps half of each output's columns (kSplit; the grid's y spans the
// halves): it computes S, dP and their transposes over all 128 channels,
// then accumulates its 64 columns of dq, dk and dv, and it reads its A
// fragments from shared memory at each product (held, they would take 128
// registers a lane); 206 KB of staged rows, one block an SM.  D = 96 does
// the same with 48 columns a block (3 k-steps of 16 of the output
// products, 6 n-tiles) and 158 KB.  D = 48 takes one head a block, holds
// its fragments and stages 88 KB: two blocks an SM.  D = 192 and 256 keep
// 64 columns a block (kSplit 3 and 4: 4 k-steps, 8 n-tiles, 96
// accumulator floats a lane) and stream 16-row chunks (kRows), 151 and
// 199 KB: one block an SM of four warps.  (32-token tiles and 32-row
// chunks, the same bytes in two warps, took twice as long on the H100:
// probe_k8_backward --tiles.)
constexpr int kTile = 64;              // tokens a block: queries and keys
constexpr int kChunk = 64;             // keys (and queries) a chunk
constexpr int kTcWarps = kTile / 16;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kNoKey = -kInt32Max - 1; // a column that is no valid key
constexpr int kNoQuery = kNoKey + 1;   // a column past the key range
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kTile == kChunk && kChunk % 16 == 0, "one row loader");

// The bf16 kernels' slots: at D = 12 and below 8 a head is staged into a
// slot of kSlotWidth channels of shared memory (16 at D = 12, 8 below 8)
// whose channels past D are zero, and the products of the slot's width
// (D 16's or D 8's) run over the slots: the zeros add exact zeros to S,
// dP and the outputs' unwritten columns, and the scale stays the head's
// own.  A head's D bf16 channels move in pieces of kSlotPiece bytes, the
// widest cp.async takes that its start allows: 8 at D = 12 and 4 (heads
// 24 and 8 bytes apart), 4 at D = 6 and 2 (12 and 4 bytes apart); at D =
// 3 and 1 the heads start 2 bytes apart, which no cp.async takes, so a
// thread loads its slot's D channels into registers and stores the slot
// whole (kSlotPiece 2).
template <int D>
constexpr bool kSlotted = D == 12 || D < 8;
template <int D>
constexpr int kSlotWidth = D == 12 ? 16 : 8;
template <int D>
constexpr int kSlotPiece = 2 * D % 8 == 0 ? 8 : 2 * D % 4 == 0 ? 4 : 2;

template <int PB>
using SlotPiece = std::conditional_t<
    PB == 8, uint2, std::conditional_t<PB == 4, uint32_t, uint16_t>>;

// Rows [r0, r0 + n) of NS heads of D channels of NA arrays (src(a) + base
// + row * C, a < NA) into slots: dst [NA][R][RS], NS slots of kSlotWidth
// channels a row from its first; rows past n zero-filled (finite: a
// masked product with them stays 0).  Copies go through cp.async but at
// D = 3 and 1 (kSlotPiece), whose stores are plain.
template <int D, int C, int NS, int RS, int R, int NA, int kThreads,
          typename Src>
__device__ __forceinline__ void stage_slots(Src src, size_t base, int r0,
                                            int n, __nv_bfloat16* dst) {
  constexpr int DS = kSlotWidth<D>, PB = kSlotPiece<D>;
  if constexpr (PB >= 4) {
    constexpr int kE = PB / 2;       // channels a piece
    constexpr int kQ = DS / kE;      // pieces a slot
    constexpr int kQD = D / kE;      // of them the head's
    for (int e = threadIdx.x; e < NA * R * NS * kQ; e += kThreads) {
      const int a = e / (R * NS * kQ);
      const int r = (e / (NS * kQ)) % R;
      const int pc = e % (NS * kQ);  // slot pc / kQ, its piece pc % kQ
      const int i = pc % kQ;
      const __nv_bfloat16* from = src(a) + base +
                                  (size_t)(r0 + (r < n ? r : 0)) * C +
                                  (pc / kQ) * D + (i < kQD ? i : 0) * kE;
      __nv_bfloat16* to = dst + (a * R + r) * RS + kE * pc;
      if constexpr (PB == 8) cp_async_8(to, from, r < n && i < kQD);
      else cp_async_4(to, from, r < n && i < kQD);
    }
  } else {
    static_assert(DS == 8, "one 16-byte store a slot");
    for (int e = threadIdx.x; e < NA * R * NS; e += kThreads) {
      const int a = e / (R * NS);
      const int r = (e / NS) % R, h = e % NS;
      uint4 slot = make_uint4(0u, 0u, 0u, 0u);   // 8 bf16 zeros
      if (r < n) {
        const __nv_bfloat16* from =
            src(a) + base + (size_t)(r0 + r) * C + h * D;
        __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&slot);
#pragma unroll
        for (int d = 0; d < D; ++d) v[d] = from[d];
      }
      *reinterpret_cast<uint4*>(dst + (a * R + r) * RS + h * DS) = slot;
    }
  }
}

// The D channels of NS slots of NA arrays' 16 rows from row r0 (src [NA]
// rows of RS bf16) to dst(a) + base + row * C, rows from nt on not
// written; a warp, kSlotPiece bytes a lane a store.
template <int D, int C, int NS, int RS, int NA, typename Dst>
__device__ __forceinline__ void write_slots(const __nv_bfloat16* src,
                                            int src_stride, Dst dst,
                                            size_t base, int r0, int t0,
                                            int nt) {
  constexpr int DS = kSlotWidth<D>, PB = kSlotPiece<D>;
  constexpr int kE = PB / 2;         // channels a piece
  constexpr int kQD = D / kE;        // pieces a head
  constexpr int kQ = kQD * NS;       // pieces a row
  using P = SlotPiece<PB>;
  for (int e = threadIdx.x % 32; e < NA * 16 * kQ; e += 32) {
    const int a = e / (16 * kQ);
    const int r = r0 + (e / kQ) % 16;
    const int pc = e % kQ;           // head pc / kQD, its piece pc % kQD
    if (r >= nt) continue;
    *reinterpret_cast<P*>(dst(a) + base + (size_t)(t0 + r) * C + kE * pc) =
        *reinterpret_cast<const P*>(src + a * src_stride + r * RS +
                                    (pc / kQD) * DS + (pc % kQD) * kE);
  }
}

template <int D>
struct BwdTc {
  // D = 12 and below 8: each head staged into a slot of 16 or 8 channels
  // (kSlotWidth), its last 4 (8 - D) channels 0, and D 16's (D 8's)
  // products run over the slots (kDS channels a head in shared memory,
  // kSW a staged row): 2 heads a block at D = 12, 4 below 8, as D 16's
  // and D 8's blocks
  static constexpr bool kSlot = kSlotted<D>;
  static constexpr int kDS = kSlot ? kSlotWidth<D> : D;
  static constexpr int kHG = kSlot ? 32 / kDS : D < 32 ? 32 / D : 1;
  static constexpr int kCW = kHG * D;       // channels a block stages
  static constexpr int kSW = kHG * kDS;
  // bf16 row stride of the rows: an odd count of 16-byte pieces, so the 8
  // rows of an ldmatrix phase hit distinct banks (D = 24's 3 pieces take
  // two of padding)
  static constexpr int kRS = kSW + (kSW / 8 % 2 ? 2 * kPad : kPad);
  static constexpr int kPieces = kCW / 8;   // 16-byte pieces a staged row
  // blocks a head's output columns: 64 columns a block above D = 128
  // (3 at D = 192, 4 at 256), two halves at D = 96 and 128
  static constexpr int kSplit = D > 128 ? D / 64 : D >= 96 ? 2 : 1;
  static constexpr bool kHold = D <= 64;    // A fragments held in registers
  // rows a chunk: 64, 16 above D = 128, where two chunks of 64 rows
  // beside the tile would stage 405 KB (D = 256)
  static constexpr int kRows = D > 128 ? 16 : kChunk;
  // D = 48 and 64 hold 1.5 and 2 times D = 32's accumulators and
  // fragments and stage 88 and 110 KB: two blocks an SM; D = 96, 128, 192
  // and 256 stage 158, 206, 151 and 199 KB: one
  static constexpr int kMinBlocks = D >= 96 ? 1 : D >= 48 ? 2 : 3;
  static_assert((kSlot || kCW % 8 == 0) && kRS / 8 % 2 == 1,
                "16-byte rows");
  static_assert(kRows % 16 == 0 && kRows <= kChunk,
                "whole s-steps; a thread per chunk row's statistics");

  // The staged rows of q, k, v and dO (in that order) of the tile and of
  // two chunks; per chunk row, (window id, window id or kNoKey without a
  // valid key), and per head (lse * log2 e, D).
  struct Smem {
    __nv_bfloat16 tile[4][kTile * kRS];
    __nv_bfloat16 chunk[2][4][kRows * kRS];
    int2 win[2][kRows];
    float2 stat[2][kHG][kRows];
  };
  static_assert(sizeof(Smem) <= 227 * 1024, "one block an SM");
  static_assert(kMinBlocks * (sizeof(Smem) + 1024) <= 228 * 1024,
                "kMinBlocks blocks in an SM's 228 KB (1 KB reserved a block)");
};
static_assert(BwdTc<16>::kHG == 2 && BwdTc<16>::kCW == 32,
              "the shipped block: 2 heads of 16");
static_assert(BwdTc<48>::kCW == 48 && BwdTc<96>::kCW == 96 &&
                  (BwdTc<96>::kPieces / BwdTc<96>::kSplit) % 2 == 0,
              "D = 48 one head a block; D = 96 one head, 48 output columns "
              "a block, whole k-steps of 16");
static_assert(BwdTc<192>::kPieces / BwdTc<192>::kSplit == 8 &&
                  BwdTc<256>::kPieces / BwdTc<256>::kSplit == 8,
              "D = 192 and 256: 64 output columns a block");
static_assert(BwdTc<24>::kHG == 1 && BwdTc<24>::kRS == 40 &&
                  BwdTc<12>::kHG == 2 && BwdTc<12>::kRS == 40,
              "D = 24 one head a block; D = 12 two heads in slots of 16");
static_assert(BwdTc<6>::kHG == 4 && BwdTc<1>::kRS == BwdTc<8>::kRS,
              "below 8: D 8's block of 4 heads, in slots of 8");

// 2^x on the special-function unit; a result below 2^-126 flushes to 0
// (such a p adds nothing that survives the bf16 rounding of a product)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// cp.async rows [r0, r0 + n) of the block's heads of q, k, v and dO into
// dst [4][R][kRS]; rows past n are zero-filled (finite: a masked
// product of 0 with them stays 0).  At D = 12 and below 8 into the
// heads' slots (stage_slots).
template <int D, int C, int R>
__device__ __forceinline__ void stage_rows(const BwdArgs& p, size_t base,
                                           int r0, int n,
                                           __nv_bfloat16* dst) {
  using K = BwdTc<D>;
  if constexpr (K::kSlot) {
    stage_slots<D, C, K::kHG, K::kRS, R, 4, kTcThreads>(
        [&](int a) {
          return static_cast<const __nv_bfloat16*>(
              a == 0 ? p.q : a == 1 ? p.k : a == 2 ? p.v : p.dout);
        },
        base, r0, n, dst);
  } else {
    for (int e = threadIdx.x; e < 4 * R * K::kPieces; e += kTcThreads) {
      const int a = e / (R * K::kPieces);
      const int r = (e / K::kPieces) % R;
      const int c = (e % K::kPieces) * 8;
      const void* src = a == 0 ? p.q : a == 1 ? p.k : a == 2 ? p.v : p.dout;
      cp_async_16(dst + (a * R + r) * K::kRS + c,
                  static_cast<const __nv_bfloat16*>(src) + base +
                      (size_t)(r0 + (r < n ? r : 0)) * C + c,
                  r < n);
    }
  }
}

template <int D, int C>
__global__ void __launch_bounds__(kTcThreads, BwdTc<D>::kMinBlocks)
band_attention_bwd_tc_kernel(BwdArgs p) {
  using K = BwdTc<D>;
  constexpr int H = C / D;
  constexpr int kHG = K::kHG, kRS = K::kRS, kSplit = K::kSplit;
  constexpr int kChunk = K::kRows;
  constexpr int DS = K::kDS;       // a head's channels in shared memory
  constexpr int KS = DS / 16;      // k-steps of 16 over a head's channels
  constexpr int KT = DS % 16 / 8;  // and one of 8 (m16n8k8) at D = 8, 24
  constexpr int NT = DS / 8;       // n-tiles of 8 over a head's channels
  static_assert(16 * KS + 8 * KT == DS && (KT == 0 || kSplit == 1),
                "the k-steps cover the head; a tail step in unsplit heads");
  constexpr int KH = K::kHold && KS > 0 ? KS : 1;  // A fragments held
  constexpr int KO = (KS + kSplit - 1) / kSplit;   // k-steps a block outputs
  constexpr int NO = NT / kSplit;  // n-tiles a block outputs
  constexpr int kOutPieces = K::kPieces / kSplit;  // 16-byte pieces of them
  constexpr float kScale = Head<D>::kScale;
  constexpr float kScaleLog2e = kScale * kLog2e;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typename K::Smem& sm = *reinterpret_cast<typename K::Smem*>(smem_raw);
  __shared__ int s_range[2];

  const int V = p.V;
  const int b = blockIdx.z, t0 = blockIdx.x * kTile;
  const int h0 = blockIdx.y / kSplit * kHG;
  const int oc = blockIdx.y % kSplit * (D / kSplit);   // first output column
  const int nt = min(kTile, V - t0);
  const size_t row0 = (size_t)b * V;
  const int* wb = p.win + row0;
  const uint8_t* kvb = p.key_valid + row0;
  const float* lb = p.lse + row0 * H + h0;
  const float* db = p.delta + row0 * H + h0;
  const size_t base = row0 * C + h0 * D;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;

  // chunk row k0 + threadIdx.x's window ids and statistics
  int2 cw;
  float2 cs[kHG];
  auto load_cols = [&](int k0) {
    const int r = k0 + threadIdx.x;
    cw = make_int2(kNoQuery, kNoKey);
#pragma unroll
    for (int hh = 0; hh < kHG; ++hh) cs[hh] = make_float2(0.f, 0.f);
    if (r < s_range[1]) {
      const int id = wb[r];
      cw = make_int2(id, kvb[r] ? id : kNoKey);
#pragma unroll
      for (int hh = 0; hh < kHG; ++hh)
        cs[hh] = make_float2(lb[(size_t)r * H + hh] * kLog2e,
                             db[(size_t)r * H + hh]);
    }
  };
  auto store_cols = [&](int buf) {
    sm.win[buf][threadIdx.x] = cw;
#pragma unroll
    for (int hh = 0; hh < kHG; ++hh) sm.stat[buf][hh][threadIdx.x] = cs[hh];
  };

  if (threadIdx.x / 32 == 0) key_range_warp(wb, V, t0, nt, s_range);
  __syncthreads();
  const int ks = s_range[0], ke = s_range[1];
  if (ks < ke) {                   // else a tile of padding: zeros out
    stage_rows<D, C, kTile>(p, base, t0, nt, sm.tile[0]);
    stage_rows<D, C, kChunk>(p, base, ks, min(kChunk, ke - ks),
                             sm.chunk[0][0]);
  }
  cp_async_commit();
  if (threadIdx.x < kChunk) {
    load_cols(ks);
    store_cols(0);
  }

  // the lane's tile rows g and g + 8 of the warp's 16: window id as query
  // (INT32_MAX on padding and past V: matches no key column), window id
  // as key (kNoKey without a valid key), and per head lse * log2 e and D
  int qwin[2], kwin[2];
  float lse_r[kHG][2], d_r[kHG][2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int r = 16 * warp + g + 8 * rh;
    const int id = r < nt ? wb[t0 + r] : kInt32Max;
    qwin[rh] = id;
    kwin[rh] = id != kInt32Max && kvb[t0 + r] ? id : kNoKey;
#pragma unroll
    for (int hh = 0; hh < kHG; ++hh) {
      const bool real = id != kInt32Max;
      lse_r[hh][rh] = real ? lb[(size_t)(t0 + r) * H + hh] * kLog2e
                           : 0.f;
      d_r[hh][rh] = real ? db[(size_t)(t0 + r) * H + hh] : 0.f;
    }
  }

  float dq[kHG][NO][4] = {}, dk[kHG][NO][4] = {}, dv[kHG][NO][4] = {};

  int buf = 0;
  for (int k0 = ks; k0 < ke; k0 += kChunk, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();               // chunk k0 landed; the other buffer is free
    const int k1 = k0 + kChunk;
    if (k1 < ke) {                 // prefetch the next chunk
      stage_rows<D, C, kChunk>(p, base, k1, min(kChunk, ke - k1),
                               sm.chunk[buf ^ 1][0]);
      cp_async_commit();
      if (threadIdx.x < kChunk) load_cols(k1);
    }
    const __nv_bfloat16* cq = sm.chunk[buf][0];
    const __nv_bfloat16* ck = sm.chunk[buf][1];
    const __nv_bfloat16* cv = sm.chunk[buf][2];
    const __nv_bfloat16* cg = sm.chunk[buf][3];
#pragma unroll
    for (int hh = 0; hh < kHG; ++hh) {
      // A fragments of the warp's 16 tile rows of head h0 + hh (q, k, v,
      // dO), one per 16 channels: held over the chunk where kHold, else
      // read at each product; at D = 8 and 24 one more per array, of the
      // last 8 channels
      const int ar = (16 * warp + lane % 16) * kRS + hh * DS;
      uint32_t af[4][KH][4], a8[4][2];
      if constexpr (K::kHold) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            ldmatrix_x4(af[a][kk],
                        sm.tile[a] + ar + 16 * kk + (lane / 16) * 8);
      }
      if constexpr (KT) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
          ldmatrix_x2(a8[a], sm.tile[a] + ar + 16 * KS);
      }
      auto frag = [&](int a, int kk) -> const uint32_t(&)[4] {
        if constexpr (!K::kHold)
          ldmatrix_x4(af[a][0], sm.tile[a] + ar + 16 * kk + (lane / 16) * 8);
        return af[a][K::kHold ? kk : 0];
      };
#pragma unroll 1
      for (int s = 0; s < kChunk / 16; ++s) {
        // B fragments of chunk rows 16 s .. 16 s + 15: as stored (n over
        // rows, k over the head's channels) and transposed (k over rows);
        // those of the last 8 channels at D = 8 and 24 both read rows 16 s
        // + lane % 16
        const int bn = (16 * s + lane % 8 + (lane / 16) * 8) * kRS +
                       hh * DS + ((lane / 8) % 2) * 8;
        const int bt = (16 * s + lane % 8 + ((lane / 8) % 2) * 8) * kRS +
                       hh * DS + (lane / 16) * 8;
        const int b8 = (16 * s + lane % 16) * kRS + hh * DS + 16 * KS;
        // the lane's accumulator columns 16 s + 8 j + 2 t + (0, 1): their
        // window ids and statistics
        int4 wc[2];
        float4 cst[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 16 * s + 8 * j + 2 * t;
          wc[j] = *reinterpret_cast<const int4*>(&sm.win[buf][col]);
          cst[j] = *reinterpret_cast<const float4*>(&sm.stat[buf][hh][col]);
        }

        // the tile as queries, the chunk rows as keys
        float sc[2][4] = {}, dp[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t bk[4], bv[4];
          ldmatrix_x4(bk, ck + bn + 16 * kk);
          ldmatrix_x4(bv, cv + bn + 16 * kk);
          const uint32_t(&aq)[4] = frag(0, kk);
          mma_bf16_16816(sc[0], aq, &bk[0]);
          mma_bf16_16816(sc[1], aq, &bk[2]);
          const uint32_t(&ag)[4] = frag(3, kk);
          mma_bf16_16816(dp[0], ag, &bv[0]);
          mma_bf16_16816(dp[1], ag, &bv[2]);
        }
        if constexpr (KT) {
          uint32_t bk[2], bv[2];
          ldmatrix_x2(bk, ck + b8);
          ldmatrix_x2(bv, cv + b8);
          mma_bf16_1688(sc[0], a8[0], bk[0]);
          mma_bf16_1688(sc[1], a8[0], bk[1]);
          mma_bf16_1688(dp[0], a8[3], bv[0]);
          mma_bf16_1688(dp[1], a8[3], bv[1]);
        }
        uint32_t ads[4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            float ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = e ? wc[j].w : wc[j].y;
              const float pr =
                  qwin[rh] == key
                      ? ex2(fmaf(sc[j][2 * rh + e], kScaleLog2e,
                                   -lse_r[hh][rh]))
                      : 0.f;
              ds[e] = pr * (dp[j][2 * rh + e] - d_r[hh][rh]);
            }
            ads[2 * j + rh] = pack_bf16(ds[0], ds[1]);
          }
#pragma unroll
        for (int dn = 0; dn < KO; ++dn) {
          uint32_t bkt[4];
          ldmatrix_x4_trans(bkt, ck + bt + oc + 16 * dn);
          mma_bf16_16816(dq[hh][2 * dn], ads, &bkt[0]);
          mma_bf16_16816(dq[hh][2 * dn + 1], ads, &bkt[2]);
        }
        if constexpr (KT) {
          uint32_t bkt[2];
          ldmatrix_x2_trans(bkt, ck + b8);
          mma_bf16_16816(dq[hh][2 * KS], ads, bkt);
        }

        // the tile as keys, the chunk rows as queries
        float st[2][4] = {}, dpt[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t bq[4], bg[4];
          ldmatrix_x4(bq, cq + bn + 16 * kk);
          ldmatrix_x4(bg, cg + bn + 16 * kk);
          const uint32_t(&ak)[4] = frag(1, kk);
          mma_bf16_16816(st[0], ak, &bq[0]);
          mma_bf16_16816(st[1], ak, &bq[2]);
          const uint32_t(&av)[4] = frag(2, kk);
          mma_bf16_16816(dpt[0], av, &bg[0]);
          mma_bf16_16816(dpt[1], av, &bg[2]);
        }
        if constexpr (KT) {
          uint32_t bq[2], bg[2];
          ldmatrix_x2(bq, cq + b8);
          ldmatrix_x2(bg, cg + b8);
          mma_bf16_1688(st[0], a8[1], bq[0]);
          mma_bf16_1688(st[1], a8[1], bq[1]);
          mma_bf16_1688(dpt[0], a8[2], bg[0]);
          mma_bf16_1688(dpt[1], a8[2], bg[1]);
        }
        uint32_t ap[4], adst[4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            float pr[2], ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int query = e ? wc[j].z : wc[j].x;
              const float lse_c = e ? cst[j].z : cst[j].x;
              const float d_c = e ? cst[j].w : cst[j].y;
              pr[e] = kwin[rh] == query
                          ? ex2(fmaf(st[j][2 * rh + e], kScaleLog2e,
                                       -lse_c))
                          : 0.f;
              ds[e] = pr[e] * (dpt[j][2 * rh + e] - d_c);
            }
            ap[2 * j + rh] = pack_bf16(pr[0], pr[1]);
            adst[2 * j + rh] = pack_bf16(ds[0], ds[1]);
          }
#pragma unroll
        for (int dn = 0; dn < KO; ++dn) {
          uint32_t bgt[4], bqt[4];
          ldmatrix_x4_trans(bgt, cg + bt + oc + 16 * dn);
          ldmatrix_x4_trans(bqt, cq + bt + oc + 16 * dn);
          mma_bf16_16816(dv[hh][2 * dn], ap, &bgt[0]);
          mma_bf16_16816(dv[hh][2 * dn + 1], ap, &bgt[2]);
          mma_bf16_16816(dk[hh][2 * dn], adst, &bqt[0]);
          mma_bf16_16816(dk[hh][2 * dn + 1], adst, &bqt[2]);
        }
        if constexpr (KT) {
          uint32_t bgt[2], bqt[2];
          ldmatrix_x2_trans(bgt, cg + b8);
          ldmatrix_x2_trans(bqt, cq + b8);
          mma_bf16_16816(dv[hh][2 * KS], ap, bgt);
          mma_bf16_16816(dk[hh][2 * KS], adst, bqt);
        }
      }
    }
    if (k1 < ke && threadIdx.x < kChunk) store_cols(buf ^ 1);
  }

  // dq and dk scaled after the f32 sum, each output rounded once, staged
  // over the warp's own tile rows (no other warp reads them, and no copy
  // into them is in flight), then written 16 bytes a lane; rows past V
  // are not written, padding rows write 0
  __syncwarp();
#pragma unroll
  for (int hh = 0; hh < kHG; ++hh)
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int o =
            (16 * warp + g + 8 * rh) * kRS + hh * DS + oc + 8 * j + 2 * t;
        const int e = 2 * rh;
        *reinterpret_cast<uint32_t*>(sm.tile[0] + o) = pack_bf16(
            dq[hh][j][e] * kScale, dq[hh][j][e + 1] * kScale);
        *reinterpret_cast<uint32_t*>(sm.tile[1] + o) = pack_bf16(
            dk[hh][j][e] * kScale, dk[hh][j][e + 1] * kScale);
        *reinterpret_cast<uint32_t*>(sm.tile[2] + o) =
            pack_bf16(dv[hh][j][e], dv[hh][j][e + 1]);
      }
  __syncwarp();
  if constexpr (K::kSlot) {        // the heads' D columns of their slots
    write_slots<D, C, kHG, kRS, 3>(
        sm.tile[0], kTile * kRS,
        [&](int a) {
          return static_cast<__nv_bfloat16*>(a == 0   ? p.dq
                                             : a == 1 ? p.dk
                                                      : p.dv);
        },
        base, 16 * warp, t0, nt);
  } else {
    for (int e = lane; e < 3 * 16 * kOutPieces; e += 32) {
      const int a = e / (16 * kOutPieces);
      const int r = 16 * warp + (e / kOutPieces) % 16;
      const int c = oc + (e % kOutPieces) * 8;
      if (r >= nt) continue;
      void* dst = a == 0 ? p.dq : a == 1 ? p.dk : p.dv;
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(dst) + base +
                                (size_t)(t0 + r) * C + c) =
          *reinterpret_cast<const uint4*>(sm.tile[a] + r * kRS + c);
    }
  }
}

template <int D, int C>
cudaError_t launch_bwd_tc(const BwdArgs& args, int B, cudaStream_t stream) {
  using K = BwdTc<D>;
  static_assert(C % K::kCW == 0, "whole head groups");
  constexpr int kBytes = sizeof(typename K::Smem);
  cudaError_t e = allow_smem(band_attention_bwd_tc_kernel<D, C>, kBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((args.V + kTile - 1) / kTile, C / K::kCW * K::kSplit, B);
  band_attention_bwd_tc_kernel<D, C>
      <<<grid, kTcThreads, kBytes, stream>>>(args);
  return cudaGetLastError();
}

// bf16 backward at D = 384 and 512 (C 384 or 512 in one head).  The
// kernel above would stage the tile's four arrays beside two chunks of
// four, 301 and 399 KB, past an SM's 227.  This one runs JAX's two
// passes (_dq_kernel, _dkv_kernel) in one launch: of a head's blocks
// over a tile, kSplit take the tile as queries (stage its q and dO rows;
// chunks of k and v; dq += dS K) and kSplit as keys (stage its k and v
// rows; chunks of q and dO; dv += P^T dO, dk += dS^T Q), each pass
// staging two arrays (151 and 200 KB with two buffers of 16-row chunks).
// Both passes run the same two products over all D channels, S and dP
// (S^T and dP^T as keys), then build P and dS on the accumulators as the
// kernel above does, and each block keeps kOW = 128 output columns (64
// registers a lane an output), so a pass's kSplit blocks (3 and 4)
// recompute S and dP each.  The grid's y spans (head, pass, columns).
// Per key dk and dv are still a gather over the key's own tile, and each
// output is rounded once, so the dtype points and the order of each sum
// over chunks stay the kernel above's (band_attention_backward_tiles_plain
// at 64-token tiles and 16-row chunks).
template <int D>
struct BwdWide {
  static constexpr int kRS = D + kPad;      // bf16 row stride, odd pieces
  static constexpr int kPieces = D / 8;     // 16-byte pieces a row
  static constexpr int kOW = 128;           // output columns a block
  static constexpr int kSplit = D / kOW;    // blocks of a pass a head
  static constexpr int kRows = 16;          // rows a chunk
  struct Smem {
    __nv_bfloat16 tile[2][kTile * kRS];     // the tile's two arrays
    __nv_bfloat16 chunk[2][2][kRows * kRS]; // per buffer, the chunk's two
    int win[2][kRows];     // per buffer, a chunk row's window id as key
                           // (queries pass: kNoKey without a valid key)
                           // or as query (keys pass)
    float2 stat[2][kRows]; // (lse log2 e, D) of a chunk row (keys pass)
  };
  static_assert(D % kOW == 0 && kRS / 8 % 2 == 1 &&
                    sizeof(Smem) <= 227 * 1024,
                "whole column blocks; 16-byte rows; one block an SM");
};

template <int D, int C>
__global__ void __launch_bounds__(kTcThreads, 1)
band_attention_bwd_wide_kernel(BwdArgs p) {
  using K = BwdWide<D>;
  using bf = __nv_bfloat16;
  constexpr int H = C / D;
  constexpr int kRS = K::kRS, kRows = K::kRows, kPieces = K::kPieces;
  constexpr int KS = D / 16;       // k-steps of 16 over the head
  constexpr int KO = K::kOW / 16;  // and over the block's output columns
  constexpr int kOutPieces = K::kOW / 8;
  constexpr float kScale = Head<D>::kScale;
  constexpr float kScaleLog2e = kScale * kLog2e;
  static_assert(kRows == 16 && kTcThreads >= kRows, "one s-step a chunk");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typename K::Smem& sm = *reinterpret_cast<typename K::Smem*>(smem_raw);
  __shared__ int s_range[2];

  const int V = p.V;
  const int b = blockIdx.z, t0 = blockIdx.x * kTile;
  const int h = blockIdx.y / (2 * K::kSplit);
  const int part = blockIdx.y % (2 * K::kSplit);
  const bool keys = part >= K::kSplit;      // the pass, block-uniform
  const int oc = part % K::kSplit * K::kOW; // first output column
  const int nt = min(kTile, V - t0);
  const size_t row0 = (size_t)b * V;
  const int* wb = p.win + row0;
  const uint8_t* kvb = p.key_valid + row0;
  const float* lb = p.lse + row0 * H + h;
  const float* db = p.delta + row0 * H + h;
  const size_t base = row0 * C + h * D;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  // the tile's arrays and the chunks': as queries q, dO and k, v; as keys
  // k, v and q, dO
  const bf* tsrc[2] = {static_cast<const bf*>(keys ? p.k : p.q),
                       static_cast<const bf*>(keys ? p.v : p.dout)};
  const bf* csrc[2] = {static_cast<const bf*>(keys ? p.q : p.k),
                       static_cast<const bf*>(keys ? p.dout : p.v)};

  // cp.async rows [r0, r0 + n) of the two arrays src into dst [2][R][kRS],
  // rows past n zero-filled
  auto stage = [&](const bf* const (&src)[2], int r0, int n, int R,
                   bf* dst) {
    for (int e = threadIdx.x; e < 2 * R * kPieces; e += kTcThreads) {
      const int a = e / (R * kPieces);
      const int r = (e / kPieces) % R;
      const int c = (e % kPieces) * 8;
      cp_async_16(dst + (a * R + r) * kRS + c,
                  src[a] + base + (size_t)(r0 + (r < n ? r : 0)) * C + c,
                  r < n);
    }
  };
  // chunk row k0 + threadIdx.x's window id and statistics
  int cw = 0;
  float2 cs = make_float2(0.f, 0.f);
  auto load_cols = [&](int k0) {
    const int r = k0 + threadIdx.x;
    cw = keys ? kNoQuery : kNoKey;
    cs = make_float2(0.f, 0.f);
    if (r < s_range[1]) {
      const int id = wb[r];
      cw = keys || kvb[r] ? id : kNoKey;
      if (keys)
        cs = make_float2(lb[(size_t)r * H] * kLog2e, db[(size_t)r * H]);
    }
  };
  auto store_cols = [&](int buf) {
    sm.win[buf][threadIdx.x] = cw;
    sm.stat[buf][threadIdx.x] = cs;
  };

  if (warp == 0) key_range_warp(wb, V, t0, nt, s_range);
  __syncthreads();
  const int ks = s_range[0], ke = s_range[1];
  if (ks < ke) {                   // else a tile of padding: zeros out
    stage(tsrc, t0, nt, kTile, sm.tile[0]);
    stage(csrc, ks, min(kRows, ke - ks), kRows, sm.chunk[0][0]);
  }
  cp_async_commit();
  if (threadIdx.x < kRows) {
    load_cols(ks);
    store_cols(0);
  }

  // the lane's tile rows g and g + 8 of the warp's 16: the window id they
  // match a column by (as queries: INT32_MAX on padding and past V; as
  // keys: kNoKey without a valid key) and, as queries, lse * log2 e and D
  int rwin[2];
  float lse_r[2] = {0.f, 0.f}, d_r[2] = {0.f, 0.f};
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int r = 16 * warp + g + 8 * rh;
    const int id = r < nt ? wb[t0 + r] : kInt32Max;
    const bool real = id != kInt32Max;
    rwin[rh] = !keys ? id : real && kvb[t0 + r] ? id : kNoKey;
    if (!keys && real) {
      lse_r[rh] = lb[(size_t)(t0 + r) * H] * kLog2e;
      d_r[rh] = db[(size_t)(t0 + r) * H];
    }
  }

  // the block's columns of dq (as queries) or dk (as keys), and dv
  float o0[2 * KO][4] = {}, o1[2 * KO][4] = {};
  const int ar = (16 * warp + lane % 16) * kRS + (lane / 16) * 8;
  const int bn = (lane % 8 + (lane / 16) * 8) * kRS + ((lane / 8) % 2) * 8;
  const int bt = (lane % 8 + ((lane / 8) % 2) * 8) * kRS + (lane / 16) * 8;

  int buf = 0;
  for (int k0 = ks; k0 < ke; k0 += kRows, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();               // chunk k0 landed; the other buffer is free
    const int k1 = k0 + kRows;
    if (k1 < ke) {                 // prefetch the next chunk
      stage(csrc, k1, min(kRows, ke - k1), kRows, sm.chunk[buf ^ 1][0]);
      cp_async_commit();
      if (threadIdx.x < kRows) load_cols(k1);
    }
    const bf* c0 = sm.chunk[buf][0];
    const bf* c1 = sm.chunk[buf][1];
    // the lane's accumulator columns 8 j + 2 t + (0, 1): window ids and,
    // as keys, the statistics
    int2 wc[2];
    float4 cst[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wc[j] = *reinterpret_cast<const int2*>(&sm.win[buf][8 * j + 2 * t]);
      cst[j] = *reinterpret_cast<const float4*>(&sm.stat[buf][8 * j + 2 * t]);
    }
    // S = A0 B0^T and dP = A1 B1^T over all D channels (as keys S^T, dP^T)
    float s0[2][4] = {}, s1[2][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a0[4], a1[4], b0[4], b1[4];
      ldmatrix_x4(a0, sm.tile[0] + ar + 16 * kk);
      ldmatrix_x4(a1, sm.tile[1] + ar + 16 * kk);
      ldmatrix_x4(b0, c0 + bn + 16 * kk);
      ldmatrix_x4(b1, c1 + bn + 16 * kk);
      mma_bf16_16816(s0[0], a0, &b0[0]);
      mma_bf16_16816(s0[1], a0, &b0[2]);
      mma_bf16_16816(s1[0], a1, &b1[0]);
      mma_bf16_16816(s1[1], a1, &b1[2]);
    }
    // P and dS, masked per element, rounded into the A fragments
    uint32_t ap[4], ads[4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float pr[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = e ? wc[j].y : wc[j].x;
          const float lse = keys ? (e ? cst[j].z : cst[j].x) : lse_r[rh];
          const float dd = keys ? (e ? cst[j].w : cst[j].y) : d_r[rh];
          pr[e] = rwin[rh] == col
                      ? ex2(fmaf(s0[j][2 * rh + e], kScaleLog2e, -lse))
                      : 0.f;
          ds[e] = pr[e] * (s1[j][2 * rh + e] - dd);
        }
        ap[2 * j + rh] = pack_bf16(pr[0], pr[1]);
        ads[2 * j + rh] = pack_bf16(ds[0], ds[1]);
      }
    // dq += dS K (as keys dk += dS^T Q), and as keys dv += P^T dO
#pragma unroll
    for (int dn = 0; dn < KO; ++dn) {
      uint32_t bt0[4];
      ldmatrix_x4_trans(bt0, c0 + bt + oc + 16 * dn);
      mma_bf16_16816(o0[2 * dn], ads, &bt0[0]);
      mma_bf16_16816(o0[2 * dn + 1], ads, &bt0[2]);
    }
    if (keys) {
#pragma unroll
      for (int dn = 0; dn < KO; ++dn) {
        uint32_t bt1[4];
        ldmatrix_x4_trans(bt1, c1 + bt + oc + 16 * dn);
        mma_bf16_16816(o1[2 * dn], ap, &bt1[0]);
        mma_bf16_16816(o1[2 * dn + 1], ap, &bt1[2]);
      }
    }
    if (k1 < ke && threadIdx.x < kRows) store_cols(buf ^ 1);
  }

  // dq and dk scaled after the f32 sum, each output rounded once, staged
  // over the warp's own tile rows, then written 16 bytes a lane; rows
  // past V are not written, padding rows write 0
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 2 * KO; ++j)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int o = (16 * warp + g + 8 * rh) * kRS + oc + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(sm.tile[0] + o) = pack_bf16(
          o0[j][2 * rh] * kScale, o0[j][2 * rh + 1] * kScale);
      *reinterpret_cast<uint32_t*>(sm.tile[1] + o) =
          pack_bf16(o1[j][2 * rh], o1[j][2 * rh + 1]);
    }
  __syncwarp();
  const int outs = keys ? 2 : 1;
  for (int e = lane; e < outs * 16 * kOutPieces; e += 32) {
    const int a = e / (16 * kOutPieces);
    const int r = 16 * warp + (e / kOutPieces) % 16;
    const int c = oc + (e % kOutPieces) * 8;
    if (r >= nt) continue;
    void* dst = !keys ? p.dq : a == 0 ? p.dk : p.dv;
    *reinterpret_cast<uint4*>(static_cast<bf*>(dst) + base +
                              (size_t)(t0 + r) * C + c) =
        *reinterpret_cast<const uint4*>(sm.tile[a] + r * kRS + c);
  }
}

template <int D, int C>
cudaError_t launch_bwd_wide(const BwdArgs& args, int B, cudaStream_t stream) {
  using K = BwdWide<D>;
  constexpr int kBytes = sizeof(typename K::Smem);
  cudaError_t e = allow_smem(band_attention_bwd_wide_kernel<D, C>, kBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((args.V + kTile - 1) / kTile, C / D * 2 * K::kSplit, B);
  band_attention_bwd_wide_kernel<D, C>
      <<<grid, kTcThreads, kBytes, stream>>>(args);
  return cudaGetLastError();
}

// bf16 forward on the tensor cores.  A block takes a tile of kTile query
// rows and kFwdHeads heads (64 channels); each warp owns 16 rows and
// keeps, per head, their output accumulator (16 x D in f32), running max
// and sum in registers over the tile's exact key range, streamed in
// chunks of kChunk key rows (the heads' k and v channels, double-buffered
// through cp.async).  Per head and 16 keys a warp runs 2 (D / 16)
// m16n8k16 products for S = Q K^T and D / 8 for O += P V.  S is masked
// per element by one integer compare of the row's window id against the
// column's (kNoKey where the key is not valid or lies past the range) and
// folded into an online softmax per chunk in log2 units: the row's
// running max moves once a chunk, O and the sum rescale in f32, and P =
// 2^(s scale log2 e - max) is rounded to bf16 into the A fragments of the
// value product (the C layout of m16n8k16 is its A layout); the sum adds
// the unrounded P.  A warp skips a chunk whose keys pair none of its
// rows.  One warp finds the tile's key range (key_range_warp).  At D = 8
// S takes 2 m16n8k8 products per head and 16 keys and O += P V one
// m16n8k16, and a block takes 4 heads (32 channels) at four blocks an
// SM: it spills 120 bytes, yet ran 1.18x and 1.31x faster on the
// encoder's tokens than 8 heads a block at three and two blocks (288
// and 108 bytes) and 1.25x faster than 4 heads at two, which spill
// nothing (probe_forwards --width 128,8; PERF.md).  At D = 24 a block
// takes 2 heads (48 channels, rows of 56 bf16), and S and O add D = 8's
// m16n8k8 step and n-tile to D = 16's; at D = 12 it takes 4 heads in
// slots of 16 channels (FwdTc::kSlot), D = 16's block.  At D = 128 (one
// head) a warp's output is 16 x 128 f32, 64 registers a lane beside the
// scores and the Q fragments, so the kernel asks for two blocks an SM (its 87 KB of
// shared memory allow no more) instead of four.  At D = 48 and 96 a block
// takes one head: 3 or 6 k-steps of 16 and 6 or 12 n-tiles of 8, rows of
// 56 or 104 bf16 (16-byte pieces, the 8 rows of an ldmatrix phase on 32
// distinct banks); D = 96 keeps 48 output registers a lane and 67 KB of
// shared memory, three blocks an SM.  At D = 192 and 256 a warp's output
// takes 96 and 128 registers a lane and the rows of 200 and 264 bf16 126
// and 166 KB: one block an SM, with the k-step loop of S outside the
// keys' so that one k-step of Q's A fragments is live at a time
// (kHoldQ; held, the 16 k-steps of D = 256 would take 64 registers); the
// 64-key chunks, and so the points where P is rounded, stay those of
// every other width.  At D = 384 and 512 (C 384 or 512 in one head) a
// warp's output would take 192 and 256 registers a lane and the tile
// beside two buffers of k and v 251 and 333 KB, past an SM's 227: the
// head's output columns split over kSplit = 2 blocks (the grid's y
// spans them), each of which computes S over all D channels (the same
// scores and P in the same order, so the same statistics; the first
// writes lse), keeps the 96 and 128 output registers of D = 192 and 256
// and stages v's columns of its half alone; D = 384 keeps two buffers
// (202 KB), D = 512 one (167 KB: each chunk lands before its products
// start).  The 64-key chunks stay.
constexpr int kFwdChannels = 64;       // channels a block stages
constexpr int kFwdWarps = kTile / 16;
constexpr int kFwdThreads = 32 * kFwdWarps;
static_assert(kFwdThreads >= kChunk, "a thread per chunk row's window id");

template <int D>
struct FwdTc {
  // heads a block: 64 / D, 4 at D = 8, one of 48, 64, 96 or 128 channels
  // at D >= 48 (64 / 48 truncates to one), 2 at D = 24 (48 channels); 4
  // at D = 12, where 64 / 12 = 5 heads (60 channels) would make no whole
  // head groups of C 384: each head in a 16-channel slot of shared memory
  // whose last 4 channels are 0 (kSlot), so a block is D 16's four slots
  // and registers, and D 16's products run over them; below 8 likewise 4
  // heads in slots of 8 channels, D 8's block
  static constexpr bool kSlot = kSlotted<D>;
  static constexpr int kDS = kSlot ? kSlotWidth<D> : D;   // a head's shared
                                                          // channels
  static constexpr int kHeads = D == 8 || kSlot    ? 4
                                : D < kFwdChannels ? kFwdChannels / D
                                                   : 1;
  static constexpr int kRS = kHeads * kDS + kPad; // bf16 row stride
  static constexpr int kPieces = kHeads * D / 8;  // 16-byte pieces a row
  // blocks an SM: D = 96 and 128 keep 48 and 64 f32 output registers a
  // lane, and D = 96's 67 KB of shared memory allow three; D = 192 and
  // 256 keep 96 and 128 and stage 126 and 166 KB: one
  static constexpr int kMinBlocks = D > 128    ? 1
                                    : D == 128 ? 2
                                    : D == 96  ? 3
                                               : 4;
  // Q's A fragments: held over a head's score products (KS of them) up to
  // D = 128; above, one k-step's at a time with the k-step loop outside
  // the keys' (the same sums in the same order), 64 registers fewer at
  // D = 256
  static constexpr bool kHoldQ = D <= 128;
  // blocks a head's output columns span (two at D = 384 and 512), the
  // columns a block outputs and the row stride of its v rows (its columns
  // alone where split), and the buffers of k and v rows: two, one at D =
  // 512, where two would stage 267 KB
  static constexpr int kSplit = D > 256 ? 2 : 1;
  static constexpr int kOW = D / kSplit;
  static constexpr int kVRS = kSplit == 1 ? kRS : kOW + kPad;
  static constexpr int kBufs = D > 384 ? 1 : 2;
  struct Rows {
    __nv_bfloat16 q[kTile * kRS];      // the tile's q rows, then its output
    __nv_bfloat16 kv[2][2][kChunk * kRS];   // per buffer: k rows, v rows
    int win[2][kChunk];                // per buffer: the key's window id
  };                                   // or kNoKey
  struct SplitRows {                   // the same, v of the block's columns
    __nv_bfloat16 q[kTile * kRS];
    __nv_bfloat16 k[kBufs][kChunk * kRS];
    __nv_bfloat16 v[kBufs][kChunk * kVRS];
    int win[2][kChunk];
  };
  using Smem = std::conditional_t<kSplit == 1, Rows, SplitRows>;
  // buffer b's k and v rows
  __device__ static __nv_bfloat16* k_rows(Smem& sm, int b) {
    if constexpr (kSplit == 1) return sm.kv[b][0]; else return sm.k[b];
  }
  __device__ static __nv_bfloat16* v_rows(Smem& sm, int b) {
    if constexpr (kSplit == 1) return sm.kv[b][1]; else return sm.v[b];
  }
  static_assert(kSplit == 1 || (kOW % 16 == 0 && kVRS / 8 % 2 == 1),
                "whole k-steps a block; v rows of odd 16-byte pieces");
  static_assert(sizeof(Smem) <= 227 * 1024, "one block an SM");
};
static_assert(FwdTc<16>::kHeads == 4, "the shipped block: 4 heads of 16");
static_assert(FwdTc<24>::kHeads * 24 == 48 && FwdTc<12>::kRS == FwdTc<16>::kRS,
              "D = 24: 2 heads a block; D = 12: D 16's block of 4 slots");
static_assert(FwdTc<3>::kHeads == 4 && FwdTc<6>::kRS == FwdTc<8>::kRS,
              "below 8: D 8's block of 4 slots");
static_assert(FwdTc<384>::kOW == 192 && FwdTc<512>::kOW == 256 &&
                  FwdTc<384>::kBufs == 2 && FwdTc<512>::kBufs == 1,
              "D = 384 and 512: D 192's and 256's output a block");

template <int D, int C>
__global__ void __launch_bounds__(kFwdThreads, FwdTc<D>::kMinBlocks)
band_attention_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const int* __restrict__ win,
                             const uint8_t* __restrict__ key_valid,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, int V) {
  using K = FwdTc<D>;
  constexpr int H = C / D;
  constexpr int kHeads = K::kHeads, kRS = K::kRS, kPieces = K::kPieces;
  constexpr int DS = K::kDS;       // a head's channels in shared memory
  constexpr int KS = DS / 16;      // k-steps of 16 over a head's channels
  constexpr int KT = DS % 16 / 8;  // and one of 8 (m16n8k8) at D = 8, 24
  constexpr int NT = DS / 8;       // n-tiles of 8 over a head's channels
  constexpr int KO = KS / K::kSplit;   // and of the block's output columns
  constexpr int NO = NT / K::kSplit;
  constexpr int kVRS = K::kVRS;
  constexpr int kOutPieces = kPieces / K::kSplit;
  static_assert(16 * KS + 8 * KT == DS && (KT == 0 || K::kHoldQ) &&
                    (K::kSplit == 1 || (KT == 0 && kHeads == 1)),
                "the k-steps cover the head; split heads alone");
  // the head's own 1/sqrt(D), in slots too (at D = 12 not its slot's 1/4)
  constexpr float kScaleLog2e = Head<D>::kScale * kLog2e;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typename K::Smem& sm = *reinterpret_cast<typename K::Smem*>(smem_raw);
  __shared__ int s_range[2];

  const int b = blockIdx.z, h0 = blockIdx.y / K::kSplit * kHeads;
  const int oc = blockIdx.y % K::kSplit * K::kOW;   // first output column
  const int t0 = blockIdx.x * kTile;
  const int nt = min(kTile, V - t0);
  const size_t row0 = (size_t)b * V;
  const int* wb = win + row0;
  const uint8_t* kvb = key_valid + row0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;

  if (warp == 0) key_range_warp(wb, V, t0, nt, s_range);
  __syncthreads();
  const int ks = s_range[0], ke = s_range[1];

  // rows [r0, r0 + n) of the block's heads of src into dst [kChunk][kRS];
  // rows past n are zero-filled (finite: a masked product with them
  // stays 0); at D = 12 and below 8 into each head's slot (stage_slots)
  auto copy_rows = [&](const __nv_bfloat16* src, int r0, int n,
                       __nv_bfloat16* dst) {
    if constexpr (K::kSlot) {
      stage_slots<D, C, kHeads, kRS, kChunk, 1, kFwdThreads>(
          [&](int) { return src; }, row0 * C + h0 * D, r0, n, dst);
    } else {
      for (int e = threadIdx.x; e < kChunk * kPieces; e += kFwdThreads) {
        const int r = e / kPieces, c = (e % kPieces) * 8;
        cp_async_16(dst + r * kRS + c,
                    src + (row0 + r0 + (r < n ? r : 0)) * C + h0 * D + c,
                    r < n);
      }
    }
  };
  // the v rows: where the head is split, the block's columns alone
  auto copy_v = [&](int r0, int n, __nv_bfloat16* dst) {
    if constexpr (K::kSplit == 1) {
      copy_rows(v, r0, n, dst);
    } else {
      for (int e = threadIdx.x; e < kChunk * kOutPieces; e += kFwdThreads) {
        const int r = e / kOutPieces, c = (e % kOutPieces) * 8;
        cp_async_16(dst + r * kVRS + c,
                    v + (row0 + r0 + (r < n ? r : 0)) * C + h0 * D + oc + c,
                    r < n);
      }
    }
  };
  // key row k0 + threadIdx.x's window id, kNoKey without a valid key
  auto key_win = [&](int k0) {
    const int r = k0 + threadIdx.x;
    return r < ke && kvb[r] ? wb[r] : kNoKey;
  };
  int cw = kNoKey;
  if (ks < ke) {                   // else a tile of padding: zeros out
    copy_rows(q, t0, nt, sm.q);
    copy_rows(k, ks, min(kChunk, ke - ks), K::k_rows(sm, 0));
    copy_v(ks, min(kChunk, ke - ks), K::v_rows(sm, 0));
    if (threadIdx.x < kChunk) sm.win[0][threadIdx.x] = key_win(ks);
  }
  cp_async_commit();

  // the lane's rows g and g + 8 of the warp's 16: window id (INT32_MAX on
  // padding and past V: matches no key)
  int qwin[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int r = 16 * warp + g + 8 * rh;
    qwin[rh] = r < nt ? wb[t0 + r] : kInt32Max;
  }

  // per head: O (channels 8 n + 2 t + (0, 1) of rows g, g + 8), the
  // running max (log2 units) and the lane's part of the sum of P
  float o[kHeads][NO][4] = {}, m[kHeads][2], l[kHeads][2] = {};
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) m[hh][0] = m[hh][1] = -INFINITY;

  int buf = 0;
  for (int k0 = ks; k0 < ke; k0 += kChunk, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();               // chunk k0 landed; the other buffer is free
    const int k1 = k0 + kChunk;
    if (k1 < ke) {                 // prefetch the next chunk
      if constexpr (K::kBufs == 2) {
        copy_rows(k, k1, min(kChunk, ke - k1), K::k_rows(sm, buf ^ 1));
        copy_v(k1, min(kChunk, ke - k1), K::v_rows(sm, buf ^ 1));
        cp_async_commit();
      }
      if (threadIdx.x < kChunk) cw = key_win(k1);
    }
    // bit 4 j + 2 rh + e: row g + 8 rh sees column 8 j + 2 t + e
    uint32_t seen = 0;
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
      const int2 w =
          *reinterpret_cast<const int2*>(&sm.win[buf][8 * j + 2 * t]);
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
        seen |= ((qwin[rh] == w.x ? 1u : 0u) | (qwin[rh] == w.y ? 2u : 0u))
                << (4 * j + 2 * rh);
    }
    if (__any_sync(0xffffffffu, seen != 0)) {
      const __nv_bfloat16* ck = K::k_rows(sm, K::kBufs == 2 ? buf : 0);
      const __nv_bfloat16* cv = K::v_rows(sm, K::kBufs == 2 ? buf : 0);
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
        // rows 16 jj + lane % 16 of the chunk, the last 8 channels at D =
        // 8 and 24: the ldmatrix_x2 rows
        const int r8 = (lane % 16) * kRS + hh * DS + 16 * KS;
        float s[kChunk / 8][4];
        if constexpr (!K::kHoldQ) {   // k-steps outside, keys inside
#pragma unroll
          for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(a, sm.q + (16 * warp + lane % 16) * kRS + hh * DS +
                               16 * kk + (lane / 16) * 8);
#pragma unroll
            for (int jj = 0; jj < kChunk / 16; ++jj) {
              uint32_t bk[4];
              ldmatrix_x4(bk, ck + (16 * jj + lane % 8 + (lane / 16) * 8) *
                                       kRS +
                                  hh * DS + 16 * kk + ((lane / 8) % 2) * 8);
              mma_bf16_16816(s[2 * jj], a, &bk[0]);
              mma_bf16_16816(s[2 * jj + 1], a, &bk[2]);
            }
          }
        } else {
          uint32_t aq[KS > 0 ? KS : 1][4], aq8[2];
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            ldmatrix_x4(aq[kk], sm.q + (16 * warp + lane % 16) * kRS +
                                    hh * DS + 16 * kk + (lane / 16) * 8);
          if constexpr (KT) ldmatrix_x2(aq8, sm.q + 16 * warp * kRS + r8);
#pragma unroll
          for (int jj = 0; jj < kChunk / 16; ++jj) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[2 * jj][e] = s[2 * jj + 1][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
              uint32_t bk[4];
              ldmatrix_x4(bk, ck + (16 * jj + lane % 8 + (lane / 16) * 8) *
                                       kRS +
                                  hh * DS + 16 * kk + ((lane / 8) % 2) * 8);
              mma_bf16_16816(s[2 * jj], aq[kk], &bk[0]);
              mma_bf16_16816(s[2 * jj + 1], aq[kk], &bk[2]);
            }
            if constexpr (KT) {
              uint32_t bk[2];
              ldmatrix_x2(bk, ck + 16 * jj * kRS + r8);
              mma_bf16_1688(s[2 * jj], aq8, bk[0]);
              mma_bf16_1688(s[2 * jj + 1], aq8, bk[1]);
            }
          }
        }
        // the masked scores and the rows' chunk max, in log2 units (the
        // scale is positive: the max of the scaled scores is the scaled
        // max)
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[j][i] = (seen >> (4 * j + i)) & 1u ? s[j][i] : -INFINITY;
            mx[i / 2] = fmaxf(mx[i / 2], s[j][i]);
          }
        float base[2];
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 1));
          mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 2));
          const float mn = fmaxf(m[hh][rh], mx[rh] * kScaleLog2e);
          base[rh] = mn == -INFINITY ? 0.f : mn;   // no key seen yet
          const float corr = ex2(m[hh][rh] - base[rh]);
          m[hh][rh] = mn;
          l[hh][rh] *= corr;
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            o[hh][n][2 * rh] *= corr;
            o[hh][n][2 * rh + 1] *= corr;
          }
        }
#pragma unroll
        for (int jj = 0; jj < kChunk / 16; ++jj) {
          uint32_t ap[4];          // P of keys 16 jj .. 16 jj + 15, bf16
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
            for (int rh = 0; rh < 2; ++rh) {
              const float* sj = s[2 * jj + h2];
              const float p0 = ex2(fmaf(sj[2 * rh], kScaleLog2e, -base[rh]));
              const float p1 =
                  ex2(fmaf(sj[2 * rh + 1], kScaleLog2e, -base[rh]));
              l[hh][rh] += p0 + p1;
              ap[2 * h2 + rh] = pack_bf16(p0, p1);
            }
#pragma unroll
          for (int dn = 0; dn < KO; ++dn) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, cv + (16 * jj + lane % 8 +
                                        ((lane / 8) % 2) * 8) * kVRS +
                                      hh * DS + 16 * dn + (lane / 16) * 8);
            mma_bf16_16816(o[hh][2 * dn], ap, &bv[0]);
            mma_bf16_16816(o[hh][2 * dn + 1], ap, &bv[2]);
          }
          if constexpr (KT) {
            uint32_t bv[2];
            ldmatrix_x2_trans(bv, cv + 16 * jj * kRS + r8);
            mma_bf16_16816(o[hh][2 * KS], ap, bv);
          }
        }
      }
    }
    if (k1 < ke && threadIdx.x < kChunk) sm.win[buf ^ 1][threadIdx.x] = cw;
    if constexpr (K::kBufs == 1) {
      if (k1 < ke) {               // the one buffer is consumed: refill it
        __syncthreads();
        copy_rows(k, k1, min(kChunk, ke - k1), K::k_rows(sm, 0));
        copy_v(k1, min(kChunk, ke - k1), K::v_rows(sm, 0));
        cp_async_commit();
      }
    }
  }

  // O / l rounded once, staged over the warp's own q rows (no other warp
  // reads them, and no copy into them is in flight), then written 16 bytes
  // a lane; lse = max + log l in natural units, 0 where a row sees no key;
  // rows past V are not written
  __syncwarp();
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float sum = l[hh][rh];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hh][rh] = sum;
      const float inv = sum > 0.f ? 1.f / sum : 0.f;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<uint32_t*>(
            sm.q + (16 * warp + g + 8 * rh) * kRS + hh * DS + 8 * n + 2 * t) =
            pack_bf16(o[hh][n][2 * rh] * inv, o[hh][n][2 * rh + 1] * inv);
    }
  if (lse && t == 0 && oc == 0) {  // the rows' heads of the block
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int r = 16 * warp + g + 8 * rh;
      float st[kHeads];
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh)
        st[hh] = l[hh][rh] > 0.f ? m[hh][rh] * kLn2 + logf(l[hh][rh]) : 0.f;
      if (r < nt) {
        float* dst = lse + (row0 + t0 + r) * H + h0;
        if constexpr (kHeads == 4) {   // one 16-byte store
          *reinterpret_cast<float4*>(dst) =
              make_float4(st[0], st[1], st[2], st[3]);
        } else {
          for (int hh = 0; hh < kHeads; ++hh) dst[hh] = st[hh];
        }
      }
    }
  }
  __syncwarp();
  if constexpr (K::kSlot) {        // the heads' D columns of their slots
    write_slots<D, C, kHeads, kRS, 1>(
        sm.q, 0, [&](int) { return out; }, row0 * C + h0 * D, 16 * warp,
        t0, nt);
  } else {                         // the block's columns, from oc
    for (int e = lane; e < 16 * kOutPieces; e += 32) {
      const int r = 16 * warp + e / kOutPieces, c = (e % kOutPieces) * 8;
      if (r >= nt) continue;
      *reinterpret_cast<uint4*>(out + (row0 + t0 + r) * C + h0 * D + oc +
                                c) =
          *reinterpret_cast<const uint4*>(sm.q + r * kRS + c);
    }
  }
}

template <int D, int C>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          const int* win, const uint8_t* key_valid, void* out,
                          float* lse, int B, int V, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  using K = FwdTc<D>;
  static_assert(C % (K::kHeads * D) == 0, "whole head groups");
  constexpr int kBytes = sizeof(typename K::Smem);
  cudaError_t e = allow_smem(band_attention_fwd_tc_kernel<D, C>, kBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((V + kTile - 1) / kTile, C / (K::kHeads * D) * K::kSplit,
                  B);
  band_attention_fwd_tc_kernel<D, C><<<grid, kFwdThreads, kBytes, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), win, key_valid, static_cast<bf*>(out), lse,
      V);
  return cudaGetLastError();
}

// The kernels of one width (head width D, row width C), by dtype.
template <int D, int C>
struct Width {
  static cudaError_t forward(int dtype, const void* q, const void* k,
                             const void* v, const int* win,
                             const uint8_t* key_valid, void* out, float* lse,
                             int B, int V, cudaStream_t s) {
    if (dtype == kFloat32)
      return launch_f32<D, C>(q, k, v, win, key_valid, out, lse, B, V, s);
    if (dtype == kBFloat16)
      return launch_fwd_tc<D, C>(q, k, v, win, key_valid, out, lse, B, V, s);
    return cudaErrorInvalidValue;
  }
  static cudaError_t delta(int dtype, const void* dout, const void* out,
                           const int* win, float* d, int n, cudaStream_t s) {
    if (dtype == kFloat32)
      return launch_delta<float, D, C>(dout, out, win, d, n, s);
    if (dtype == kBFloat16)
      return launch_delta<__nv_bfloat16, D, C>(dout, out, win, d, n, s);
    return cudaErrorInvalidValue;
  }
  static cudaError_t backward(int dtype, const void* q, const void* k,
                              const void* v, const int* win,
                              const uint8_t* key_valid, const float* lse,
                              const float* delta, const void* dout, void* dq,
                              void* dk, void* dv, int B, int V,
                              cudaStream_t s) {
    const BwdArgs args{q,     k,  v,  dout, win, key_valid, lse,
                       delta, dq, dk, dv,   V};
    if (dtype == kFloat32) return launch_bwd_f32<D, C>(args, B, s);
    if (dtype != kBFloat16) return cudaErrorInvalidValue;
    if constexpr (D > 256) return launch_bwd_wide<D, C>(args, B, s);
    else return launch_bwd_tc<D, C>(args, B, s);
  }
  static const K8Kernels& kernels() {
    static const K8Kernels k{forward, delta, backward};
    return k;
  }
};

// The kernels of row width C at head width D, null for a D not taken
// (heads of 3, 6, 12, 24, 48, 96 and 192 only where C splits into them:
// at C 384; heads of 256 at C 256 and 512; one head of 384 or 512 at C
// 384 or 512)
template <int C>
const K8Kernels* k8_kernels_at(int D) {
  if constexpr (C > 256) {
    if (D == C) return &Width<C, C>::kernels();
  }
  if constexpr (C % 3 == 0) {
    if (D == 3) return &Width<3, C>::kernels();
    if (D == 6) return &Width<6, C>::kernels();
    if (D == 12) return &Width<12, C>::kernels();
    if (D == 24) return &Width<24, C>::kernels();
    if (D == 48) return &Width<48, C>::kernels();
    if (D == 96) return &Width<96, C>::kernels();
    if (D == 192) return &Width<192, C>::kernels();
  }
  if constexpr (C % 256 == 0) {
    if (D == 256) return &Width<256, C>::kernels();
  }
  switch (D) {
    case 1: return &Width<1, C>::kernels();
    case 2: return &Width<2, C>::kernels();
    case 4: return &Width<4, C>::kernels();
    case 8: return &Width<8, C>::kernels();
    case 16: return &Width<16, C>::kernels();
    case 32: return &Width<32, C>::kernels();
    case 64: return &Width<64, C>::kernels();
    case 128: return &Width<128, C>::kernels();
    default: return nullptr;
  }
}

}  // namespace
}  // namespace geomae
