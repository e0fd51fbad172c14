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
// Bound: with no projection inside, a call moves 4 rows of C values per
// token and computes 4 * C operations per same-window pair forward (10 * C
// backward); at 144-token windows that is far more arithmetic than bytes.
// The forward runs on the CUDA cores and waits for shared-memory reads of
// the key rows and the exp per pair.  The TPU
// kernel streams a fixed +-192-token band with an f32 copy of the window
// ids through double-buffered DMA; none of that is carried over.  As in
// window_attention.cu a block takes 32 queries, finds the exact key range
// of their windows by binary search in the sorted ids and streams keys in
// chunks of 32 through shared memory with an online softmax, so a window
// of any size is exact and no key outside the tile's windows is read.  One
// thread owns one (query, head) pair; a warp is one head of 32 queries, so
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
// f32 runs on the CUDA cores (a thread per (token, head) of a 32-token
// tile); bf16 on the tensor cores (mma.sync m16n8k16 over 64-token tiles
// and 64-row chunks, see band_attention_bwd_tc_kernel), where each
// product rounds at the points above and only the summation order moves.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace geomae {
namespace {

constexpr int C = 128;       // channels
constexpr int D = 16;        // head width
constexpr int H = C / D;     // heads
constexpr int TQ = 32;       // queries per block
constexpr int KC = 32;       // keys per chunk
constexpr int kThreads = TQ * H;
constexpr float kScale = 0.25f;   // 1/sqrt(D)
static_assert(kScale * kScale * D == 1.0f, "kScale is 1/sqrt(D)");
static_assert(kThreads == 256, "one thread per (query, head)");
static_assert(KC == TQ, "chunk rows map onto the tile's lanes");

constexpr int kFwdSmemBytes = 2 * KC * C * sizeof(float) + 2 * KC * sizeof(int);
constexpr int kBwdSmemBytes = 4 * KC * C * sizeof(float) +
                              (2 * KC + 2 * KC * H) * sizeof(int);

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

// Stage rows [r0, r0 + n) of src ([V][C]) into dst ([KC][C], f32); rows
// past n read 0.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int r0, int n,
                                      float* __restrict__ dst) {
  for (int e = 4 * threadIdx.x; e < KC * C; e += 4 * kThreads) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e / C < n) v = load4<T>(src + (size_t)r0 * C + e);
    *reinterpret_cast<float4*>(dst + e) = v;
  }
}

// One token's head slice (D values) from global memory, as f32.
template <typename T>
__device__ __forceinline__ void load_head(const T* __restrict__ p,
                                          float (&r)[D]) {
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 v = load4<T>(p + 4 * d4);
    r[4 * d4 + 0] = v.x;
    r[4 * d4 + 1] = v.y;
    r[4 * d4 + 2] = v.z;
    r[4 * d4 + 3] = v.w;
  }
}

__device__ __forceinline__ float dot_head(const float (&a)[D],
                                          const float* __restrict__ b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 v = b4[d4];
    s = fmaf(a[4 * d4 + 0], v.x, s);
    s = fmaf(a[4 * d4 + 1], v.y, s);
    s = fmaf(a[4 * d4 + 2], v.z, s);
    s = fmaf(a[4 * d4 + 3], v.w, s);
  }
  return s;
}

// acc[d] += w * b[d]
__device__ __forceinline__ void axpy_head(float w, const float* __restrict__ b,
                                          float (&acc)[D]) {
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

// The exact key range [ks, ke) of the windows of the tile's real queries
// [q0, q0 + nq) in one sample's sorted ids wb[0, V); ks == ke for a tile
// of padding only.  Called by one thread.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ win,
                      const uint8_t* __restrict__ key_valid,
                      T* __restrict__ out, float* __restrict__ lse, int V) {
  extern __shared__ float smem[];
  float* s_k = smem;              // [KC][C] k rows
  float* s_v = s_k + KC * C;      // [KC][C] v rows
  int* s_win = reinterpret_cast<int*>(s_v + KC * C);   // [KC]
  int* s_kv = s_win + KC;                               // [KC]
  __shared__ int s_range[2];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int nq = min(TQ, V - q0);
  const size_t row0 = (size_t)b * V;
  const int* wb = win + row0;
  const uint8_t* kvb = key_valid + row0;
  const T* kb = k + row0 * C;
  const T* vb = v + row0 * C;

  const int h = threadIdx.x / TQ;   // warp-uniform
  const int i = threadIdx.x % TQ;
  const int qi = q0 + i;
  const int my_win = (i < nq) ? wb[qi] : kInt32Max;

  if (threadIdx.x == 0) key_range(wb, V, q0, nq, s_range);
  __syncthreads();
  const int ks = s_range[0], ke = s_range[1];

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = 0.f;
  if (my_win != kInt32Max) load_head<T>(q + (row0 + qi) * C + h * D, qr);

  float m = -INFINITY, l = 0.f, acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int k0 = ks; k0 < ke; k0 += KC) {
    const int nk = min(KC, ke - k0);
    __syncthreads();   // the previous chunk is consumed
    stage<T>(kb, k0, nk, s_k);
    stage<T>(vb, k0, nk, s_v);
    if (threadIdx.x < KC) {
      const int r = threadIdx.x;
      s_win[r] = r < nk ? wb[k0 + r] : kInt32Max;
      s_kv[r] = r < nk ? (int)kvb[k0 + r] : 0;
    }
    __syncthreads();
    if (my_win == kInt32Max) continue;
    for (int j = 0; j < nk; ++j) {
      if (s_win[j] != my_win || !s_kv[j]) continue;
      const float s = dot_head(qr, &s_k[j * C + h * D]) * kScale;
      const float mn = fmaxf(m, s);
      const float corr = expf(m - mn);
      const float p = expf(s - mn);
      l = l * corr + p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
      axpy_head(round_t<T>(p), &s_v[j * C + h * D], acc);
      m = mn;
    }
  }

  if (i < nq) {
    const bool seen = my_win != kInt32Max && l > 0.f;
    const float inv = seen ? 1.f / l : 0.f;
    T* o = out + (row0 + qi) * C + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = from_f<T>(acc[d] * inv);
    if (lse) lse[(row0 + qi) * H + h] = seen ? m + logf(l) : 0.f;
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* win,
                   const uint8_t* key_valid, void* out, float* lse, int B,
                   int V, cudaStream_t stream) {
  cudaError_t e = allow_smem(band_attention_kernel<T>, kFwdSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((V + TQ - 1) / TQ, B);
  band_attention_kernel<T><<<grid, kThreads, kFwdSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), win, key_valid, static_cast<T*>(out), lse, V);
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
// exact in f32, as in the JAX einsum with preferred_element_type=f32).
// A padding row (win == INT32_MAX) reads nothing and takes D = 0: the
// backward reads D of real rows only.
constexpr int kDeltaThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
band_attention_delta_kernel(const T* __restrict__ dout,
                            const T* __restrict__ out,
                            const int* __restrict__ win,
                            float* __restrict__ delta, int n) {
  const int i = blockIdx.x * kDeltaThreads + threadIdx.x;
  if (i >= n) return;
  float d = 0.f;
  if (win[i / H] != kInt32Max) {
    float g[D], o[D];
    load_head<T>(dout + (size_t)i * D, g);
    load_head<T>(out + (size_t)i * D, o);
#pragma unroll
    for (int e = 0; e < D; ++e) d = fmaf(g[e], o[e], d);
  }
  delta[i] = d;
}

template <typename T>
cudaError_t launch_delta(const void* dout, const void* out, const int* win,
                         float* delta, int n, cudaStream_t stream) {
  band_attention_delta_kernel<T>
      <<<(n + kDeltaThreads - 1) / kDeltaThreads, kDeltaThreads, 0, stream>>>(
          static_cast<const T*>(dout), static_cast<const T*>(out), win, delta,
          n);
  return cudaGetLastError();
}

// f32: the CUDA cores, one thread per (token, head) of a 32-token tile.
__global__ void __launch_bounds__(kThreads)
band_attention_bwd_f32_kernel(BwdArgs p) {
  using T = float;
  extern __shared__ float smem[];
  float* s_q = smem;               // [KC][C] q rows of the chunk
  float* s_k = s_q + KC * C;       // [KC][C] k rows
  float* s_v = s_k + KC * C;       // [KC][C] v rows
  float* s_do = s_v + KC * C;      // [KC][C] dO rows
  int* s_win = reinterpret_cast<int*>(s_do + KC * C);   // [KC]
  int* s_kv = s_win + KC;                                // [KC]
  float* s_lse = reinterpret_cast<float*>(s_kv + KC);   // [KC][H]
  float* s_dd = s_lse + KC * H;                          // [KC][H] D
  __shared__ int s_range[2];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int nq = min(TQ, p.V - q0);
  const size_t row0 = (size_t)b * p.V;
  const int* wb = p.win + row0;
  const uint8_t* kvb = p.key_valid + row0;
  const T* qb = static_cast<const T*>(p.q) + row0 * C;
  const T* kb = static_cast<const T*>(p.k) + row0 * C;
  const T* vb = static_cast<const T*>(p.v) + row0 * C;
  const T* gb = static_cast<const T*>(p.dout) + row0 * C;
  const float* lb = p.lse + row0 * H;
  const float* db = p.delta + row0 * H;

  const int h = threadIdx.x / TQ;  // warp-uniform
  const int i = threadIdx.x % TQ;
  const int qi = q0 + i;
  const int my_win = (i < nq) ? wb[qi] : kInt32Max;
  const bool my_kv = (i < nq) && kvb[qi];

  if (threadIdx.x == 0) key_range(wb, p.V, q0, nq, s_range);
  __syncthreads();
  const int ks = s_range[0], ke = s_range[1];

  // the tile's own q, k, v, dO, D and lse, in registers
  float qr[D], kr[D], vr[D], g[D], dq[D], dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = kr[d] = vr[d] = g[d] = 0.f;
    dq[d] = dk[d] = dv[d] = 0.f;
  }
  float lse_i = 0.f, d_i = 0.f;
  if (my_win != kInt32Max) {
    const size_t c0 = (size_t)qi * C + h * D;
    load_head<T>(qb + c0, qr);
    load_head<T>(kb + c0, kr);
    load_head<T>(vb + c0, vr);
    load_head<T>(gb + c0, g);
    lse_i = lb[(size_t)qi * H + h];
    d_i = db[(size_t)qi * H + h];
  }

  for (int k0 = ks; k0 < ke; k0 += KC) {
    const int nk = min(KC, ke - k0);
    __syncthreads();               // the previous chunk is consumed
    stage<T>(qb, k0, nk, s_q);
    stage<T>(kb, k0, nk, s_k);
    stage<T>(vb, k0, nk, s_v);
    stage<T>(gb, k0, nk, s_do);
    {  // thread (row r, head hh): D and lse of the chunk's rows; window ids
      const int r = threadIdx.x % KC, hh = threadIdx.x / KC;
      const bool in = r < nk;
      s_dd[r * H + hh] = in ? db[(size_t)(k0 + r) * H + hh] : 0.f;
      s_lse[r * H + hh] = in ? lb[(size_t)(k0 + r) * H + hh] : 0.f;
      if (hh == 0) {
        s_win[r] = in ? wb[k0 + r] : kInt32Max;
        s_kv[r] = in ? (int)kvb[k0 + r] : 0;
      }
    }
    __syncthreads();
    if (my_win == kInt32Max) continue;
    for (int j = 0; j < nk; ++j) {
      if (s_win[j] != my_win) continue;
      const float* kj = &s_k[j * C + h * D];
      const float* vj = &s_v[j * C + h * D];
      if (s_kv[j]) {             // token i as query, j as key
        const float sc = dot_head(qr, kj) * kScale;
        const float dp = dot_head(g, vj);
        const float pr = expf(sc - lse_i);
        axpy_head(pr * (dp - d_i), kj, dq);
      }
      if (my_kv) {               // token i as key, j as query
        const float* qj = &s_q[j * C + h * D];
        const float* gj = &s_do[j * C + h * D];
        const float sc = dot_head(kr, qj) * kScale;
        const float dp = dot_head(vr, gj);
        const float pr = expf(sc - s_lse[j * H + h]);
        axpy_head(pr, gj, dv);
        axpy_head(pr * (dp - s_dd[j * H + h]), qj, dk);
      }
    }
  }

  if (i < nq) {                    // padding rows and padding tiles write 0
    const size_t c0 = (row0 + qi) * C + h * D;
    T* oq = static_cast<T*>(p.dq) + c0;
    T* ok = static_cast<T*>(p.dk) + c0;
    T* ov = static_cast<T*>(p.dv) + c0;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      oq[d] = dq[d] * kScale;
      ok[d] = dk[d] * kScale;
      ov[d] = dv[d];
    }
  }
}

cudaError_t launch_bwd_f32(const BwdArgs& args, int B, cudaStream_t stream) {
  cudaError_t e = allow_smem(band_attention_bwd_f32_kernel, kBwdSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((args.V + TQ - 1) / TQ, B);
  band_attention_bwd_f32_kernel<<<grid, kThreads, kBwdSmemBytes, stream>>>(
      args);
  return cudaGetLastError();
}

// bf16: the tensor cores.  A block takes a tile of kTile tokens and kHG
// heads; each warp owns 16 of the tile's rows, as queries and as keys, and
// holds their dq, dk and dv for the kHG heads in mma accumulators over the
// tile's whole key range, streamed in chunks of kChunk rows.  Per head and
// 16 chunk rows a warp runs fourteen m16n8k16 products: S = Q K^T and dP =
// dO V^T (then dq += dS K) with the tile as queries, S^T = K Q^T and dP^T
// = V dO^T (then dv += P^T dO, dk += dS^T Q) with the tile as keys.  P and
// dS are built on the f32 accumulators, masked per element by the row's
// and the column's window ids and the key's validity, and rounded to bf16
// into the next product's A fragments (the C layout of m16n8k16 is its A
// layout), so neither goes through shared memory.
constexpr int kTile = 64;              // tokens a block: queries and keys
constexpr int kChunk = 64;             // keys (and queries) a chunk
constexpr int kHG = 2;                 // heads a block
constexpr int kCW = kHG * D;           // channels a block stages
constexpr int kRS = kCW + kPad;        // bf16 row stride of the staged rows
constexpr int kPieces = kCW / 8;       // 16-byte pieces a staged row
constexpr int kTcWarps = kTile / 16;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kNoKey = -kInt32Max - 1; // a column that is no valid key
constexpr int kNoQuery = kNoKey + 1;   // a column past the key range
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kScaleLog2e = kScale * kLog2e;
static_assert(H % kHG == 0 && kCW % 8 == 0, "whole heads, 16-byte rows");
static_assert(kTile == kChunk && kChunk % 16 == 0, "one row loader");

// The staged rows of q, k, v and dO (in that order) of the tile and of two
// chunks; per chunk row, (window id, window id or kNoKey without a valid
// key), and per head (lse * log2 e, D).
struct TcSmem {
  __nv_bfloat16 tile[4][kTile * kRS];
  __nv_bfloat16 chunk[2][4][kChunk * kRS];
  int2 win[2][kChunk];
  float2 stat[2][kHG][kChunk];
};
constexpr int kTcSmemBytes = sizeof(TcSmem);

// 2^x on the special-function unit; a result below 2^-126 flushes to 0
// (such a p adds nothing that survives the bf16 rounding of a product)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// cp.async rows [r0, r0 + n) of the block's heads of q, k, v and dO into
// dst [4][kTile][kRS]; rows past n are zero-filled (finite: a masked
// product of 0 with them stays 0).
__device__ __forceinline__ void stage_rows(const BwdArgs& p, size_t base,
                                           int r0, int n,
                                           __nv_bfloat16* dst) {
  for (int e = threadIdx.x; e < 4 * kTile * kPieces; e += kTcThreads) {
    const int a = e / (kTile * kPieces);
    const int r = (e / kPieces) % kTile;
    const int c = (e % kPieces) * 8;
    const void* src = a == 0 ? p.q : a == 1 ? p.k : a == 2 ? p.v : p.dout;
    cp_async_16(dst + (a * kTile + r) * kRS + c,
                static_cast<const __nv_bfloat16*>(src) + base +
                    (size_t)(r0 + (r < n ? r : 0)) * C + c,
                r < n);
  }
}

__global__ void __launch_bounds__(kTcThreads, 3)
band_attention_bwd_tc_kernel(BwdArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TcSmem& sm = *reinterpret_cast<TcSmem*>(smem_raw);
  __shared__ int s_range[2];

  const int V = p.V;
  const int b = blockIdx.z, h0 = blockIdx.y * kHG, t0 = blockIdx.x * kTile;
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

  if (threadIdx.x == 0) key_range(wb, V, t0, nt, s_range);
  __syncthreads();
  const int ks = s_range[0], ke = s_range[1];
  if (ks < ke) {                   // else a tile of padding: zeros out
    stage_rows(p, base, t0, nt, sm.tile[0]);
    stage_rows(p, base, ks, min(kChunk, ke - ks), sm.chunk[0][0]);
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

  float dq[kHG][2][4] = {}, dk[kHG][2][4] = {}, dv[kHG][2][4] = {};

  int buf = 0;
  for (int k0 = ks; k0 < ke; k0 += kChunk, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();               // chunk k0 landed; the other buffer is free
    const int k1 = k0 + kChunk;
    if (k1 < ke) {                 // prefetch the next chunk
      stage_rows(p, base, k1, min(kChunk, ke - k1), sm.chunk[buf ^ 1][0]);
      cp_async_commit();
      if (threadIdx.x < kChunk) load_cols(k1);
    }
    const __nv_bfloat16* cq = sm.chunk[buf][0];
    const __nv_bfloat16* ck = sm.chunk[buf][1];
    const __nv_bfloat16* cv = sm.chunk[buf][2];
    const __nv_bfloat16* cg = sm.chunk[buf][3];
#pragma unroll
    for (int hh = 0; hh < kHG; ++hh) {
      // A fragments of the warp's 16 tile rows of head h0 + hh
      const int ar = (16 * warp + lane % 16) * kRS + hh * D + (lane / 16) * 8;
      uint32_t aq[4], ak[4], av[4], ag[4];
      ldmatrix_x4(aq, sm.tile[0] + ar);
      ldmatrix_x4(ak, sm.tile[1] + ar);
      ldmatrix_x4(av, sm.tile[2] + ar);
      ldmatrix_x4(ag, sm.tile[3] + ar);
#pragma unroll 1
      for (int s = 0; s < kChunk / 16; ++s) {
        // B fragments of chunk rows 16 s .. 16 s + 15: as stored (n over
        // rows, k over the head's channels) and transposed (k over rows)
        const int bn = (16 * s + lane % 8 + (lane / 16) * 8) * kRS + hh * D +
                       ((lane / 8) % 2) * 8;
        const int bt = (16 * s + lane % 8 + ((lane / 8) % 2) * 8) * kRS +
                       hh * D + (lane / 16) * 8;
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
        uint32_t bk[4], bv[4], bkt[4];
        ldmatrix_x4(bk, ck + bn);
        ldmatrix_x4(bv, cv + bn);
        float sc[2][4] = {}, dp[2][4] = {};
        mma_bf16_16816(sc[0], aq, &bk[0]);
        mma_bf16_16816(sc[1], aq, &bk[2]);
        mma_bf16_16816(dp[0], ag, &bv[0]);
        mma_bf16_16816(dp[1], ag, &bv[2]);
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
        ldmatrix_x4_trans(bkt, ck + bt);
        mma_bf16_16816(dq[hh][0], ads, &bkt[0]);
        mma_bf16_16816(dq[hh][1], ads, &bkt[2]);

        // the tile as keys, the chunk rows as queries
        uint32_t bq[4], bg[4], bgt[4], bqt[4];
        ldmatrix_x4(bq, cq + bn);
        ldmatrix_x4(bg, cg + bn);
        float st[2][4] = {}, dpt[2][4] = {};
        mma_bf16_16816(st[0], ak, &bq[0]);
        mma_bf16_16816(st[1], ak, &bq[2]);
        mma_bf16_16816(dpt[0], av, &bg[0]);
        mma_bf16_16816(dpt[1], av, &bg[2]);
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
        ldmatrix_x4_trans(bgt, cg + bt);
        ldmatrix_x4_trans(bqt, cq + bt);
        mma_bf16_16816(dv[hh][0], ap, &bgt[0]);
        mma_bf16_16816(dv[hh][1], ap, &bgt[2]);
        mma_bf16_16816(dk[hh][0], adst, &bqt[0]);
        mma_bf16_16816(dk[hh][1], adst, &bqt[2]);
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
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int o = (16 * warp + g + 8 * rh) * kRS + hh * D + 8 * j + 2 * t;
        const int e = 2 * rh;
        *reinterpret_cast<uint32_t*>(sm.tile[0] + o) = pack_bf16(
            dq[hh][j][e] * kScale, dq[hh][j][e + 1] * kScale);
        *reinterpret_cast<uint32_t*>(sm.tile[1] + o) = pack_bf16(
            dk[hh][j][e] * kScale, dk[hh][j][e + 1] * kScale);
        *reinterpret_cast<uint32_t*>(sm.tile[2] + o) =
            pack_bf16(dv[hh][j][e], dv[hh][j][e + 1]);
      }
  __syncwarp();
  for (int e = lane; e < 3 * 16 * kPieces; e += 32) {
    const int a = e / (16 * kPieces);
    const int r = 16 * warp + (e / kPieces) % 16;
    const int c = (e % kPieces) * 8;
    if (r >= nt) continue;
    void* dst = a == 0 ? p.dq : a == 1 ? p.dk : p.dv;
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(dst) + base +
                              (size_t)(t0 + r) * C + c) =
        *reinterpret_cast<const uint4*>(sm.tile[a] + r * kRS + c);
  }
}

cudaError_t launch_bwd_tc(const BwdArgs& args, int B, cudaStream_t stream) {
  cudaError_t e = allow_smem(band_attention_bwd_tc_kernel, kTcSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((args.V + kTile - 1) / kTile, H / kHG, B);
  band_attention_bwd_tc_kernel<<<grid, kTcThreads, kTcSmemBytes, stream>>>(
      args);
  return cudaGetLastError();
}

}  // namespace
}  // namespace geomae

extern "C" {

// q, k, v, out [B, V, 128] in dtype (8 heads of 16, heads flattened), each
// 16-byte aligned.  win [B, V] int32 ascending per row (INT32_MAX padding
// suffix); key_valid [B, V] bytes.  lse: null, or f32 [B, V, 8] for the
// per-(row, head) log-sum-exp of the scaled scores (0 where a row sees no
// key).
int geomae_band_attention(int dtype, const void* q, const void* k,
                          const void* v, const int* win,
                          const uint8_t* key_valid, void* out, float* lse,
                          int B, int V, void* stream) {
  using namespace geomae;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(q, k, v, win, key_valid, out, lse, B, V, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, win, key_valid, out, lse, B, V, s);
  return cudaErrorInvalidValue;
}

// The backward's prologue: delta f32 [B, V, 8] = per (row, head) the sum
// over the head's 16 channels of dout * out, both [B, V, 128] in dtype;
// 0 on padding rows (win [B, V] == INT32_MAX).
int geomae_band_attention_delta(int dtype, const void* dout, const void* out,
                                const int* win, float* delta, int B, int V,
                                void* stream) {
  using namespace geomae;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = B * V * H;
  if (dtype == kFloat32)
    return launch_delta<float>(dout, out, win, delta, n, s);
  if (dtype == kBFloat16)
    return launch_delta<__nv_bfloat16>(dout, out, win, delta, n, s);
  return cudaErrorInvalidValue;
}

// Backward of geomae_band_attention: the forward's inputs, its lse, the
// prologue's delta and dout [B, V, 128]; writes dq, dk, dv [B, V, 128] in
// dtype (0 on padding rows).  f32 on the CUDA cores, bf16 on the tensor
// cores.
int geomae_band_attention_bwd(int dtype, const void* q, const void* k,
                              const void* v, const int* win,
                              const uint8_t* key_valid, const float* lse,
                              const float* delta, const void* dout, void* dq,
                              void* dk, void* dv, int B, int V,
                              void* stream) {
  using namespace geomae;
  const BwdArgs args{q, k, v, dout, win, key_valid, lse, delta, dq, dk, dv,
                     V};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_bwd_f32(args, B, s);
  if (dtype == kBFloat16) return launch_bwd_tc(args, B, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
