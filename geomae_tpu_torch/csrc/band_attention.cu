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
// backward), all on the CUDA cores; at 144-token windows that is far
// more arithmetic than bytes, and what the kernel actually waits for is
// shared-memory reads of the key rows and the exp per pair.  The TPU
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
// Backward, one kernel for _dq_kernel and _dkv_kernel: a tile's 32 tokens
// are queries AND keys, and the block walks the same exact key range.  For
// a tile token i and a chunk token j of its window, with
// p = exp(s - lse) and D = rowsum(dO * out) per (row, head), f32:
//   as query:  ds = p (dO_i . v_j - D_i);  dq_i += ds k_j
//   as key:    dv_i += p dO_j;  ds = p (dO_j . v_i - D_j);  dk_i += ds q_j
// so dk and dv, a scatter across query tiles, are a gather here: complete
// and rounded once per key when the loop ends, no atomics, deterministic.
// Dtype points of _dq_body / _dkv_body: ds and p cast to the compute dtype
// before their products, dq and dk scaled by 1/sqrt(D) after the f32 sum.
// A row whose window holds no valid key contributes and receives 0.
#include <math.h>

#include "common.cuh"

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
  const void *out, *dout;        // the forward's output and its cotangent
  const int* win;
  const uint8_t* key_valid;
  const float* lse;              // [B, V, H] from the forward
  void *dq, *dk, *dv;
  int V;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_attention_bwd_kernel(BwdArgs p) {
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
  const T* ob = static_cast<const T*>(p.out) + row0 * C;
  const T* gb = static_cast<const T*>(p.dout) + row0 * C;
  const float* lb = p.lse + row0 * H;

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
    float o[D];
    load_head<T>(qb + c0, qr);
    load_head<T>(kb + c0, kr);
    load_head<T>(vb + c0, vr);
    load_head<T>(gb + c0, g);
    load_head<T>(ob + c0, o);
#pragma unroll
    for (int d = 0; d < D; ++d) d_i = fmaf(g[d], o[d], d_i);
    lse_i = lb[(size_t)qi * H + h];
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
      float dd = 0.f, ls = 0.f;
      if (r < nk) {
        const size_t c0 = (size_t)(k0 + r) * C + hh * D;
        float gg[D], oo[D];
        load_head<T>(gb + c0, gg);
        load_head<T>(ob + c0, oo);
#pragma unroll
        for (int d = 0; d < D; ++d) dd = fmaf(gg[d], oo[d], dd);
        ls = lb[(size_t)(k0 + r) * H + hh];
      }
      s_dd[r * H + hh] = dd;
      s_lse[r * H + hh] = ls;
      if (hh == 0) {
        s_win[r] = r < nk ? wb[k0 + r] : kInt32Max;
        s_kv[r] = r < nk ? (int)kvb[k0 + r] : 0;
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
        axpy_head(round_t<T>(pr * (dp - d_i)), kj, dq);
      }
      if (my_kv) {               // token i as key, j as query
        const float* qj = &s_q[j * C + h * D];
        const float* gj = &s_do[j * C + h * D];
        const float sc = dot_head(kr, qj) * kScale;
        const float dp = dot_head(vr, gj);
        const float pr = expf(sc - s_lse[j * H + h]);
        axpy_head(round_t<T>(pr), gj, dv);
        axpy_head(round_t<T>(pr * (dp - s_dd[j * H + h])), qj, dk);
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
      oq[d] = from_f<T>(dq[d] * kScale);
      ok[d] = from_f<T>(dk[d] * kScale);
      ov[d] = from_f<T>(dv[d]);
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const BwdArgs& args, int B, cudaStream_t stream) {
  cudaError_t e = allow_smem(band_attention_bwd_kernel<T>, kBwdSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((args.V + TQ - 1) / TQ, B);
  band_attention_bwd_kernel<T><<<grid, kThreads, kBwdSmemBytes, stream>>>(
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

// Backward of geomae_band_attention: the forward's inputs, its out and
// lse, and dout [B, V, 128]; writes dq, dk, dv [B, V, 128] in dtype (0 on
// padding rows).
int geomae_band_attention_bwd(int dtype, const void* q, const void* k,
                              const void* v, const int* win,
                              const uint8_t* key_valid, const void* out,
                              const float* lse, const void* dout, void* dq,
                              void* dk, void* dv, int B, int V,
                              void* stream) {
  using namespace geomae;
  const BwdArgs args{q, k, v, out, dout, win, key_valid, lse, dq, dk, dv, V};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_bwd<float>(args, B, s);
  if (dtype == kBFloat16) return launch_bwd<__nv_bfloat16>(args, B, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
