// K6 band_attention_qkv forward: window attention with the q/k/v
// projections computed inside the kernel.
//
// Replaces geomae_tpu/ops/pallas_attention_qkv.py: band_attention_qkv
// (_pallas_forward / _fwd_kernel).  Per token, over window-sorted tokens:
//   q = (x + pos) Wq + bq,  k = (x + pos) Wk + bk,  v = x Wv + bv
//   out_h = softmax(q_h k_h^T / sqrt(D) + mask) v_h   for each head h
// where a key is visible when it lies in the query's window and
// key_valid is set.  Rows with win_id == INT32_MAX (padding) and rows
// with no visible key return exactly 0.
//
// Bound: arithmetic on the CUDA cores.  Per 32-query tile the block
// projects the tile's queries once and the keys of every window the tile
// touches (about 2-5x the tile in keys, since a 12x12 window holds up to
// 144 tokens), 2*C*C FLOPs per projected row, against C bytes per row
// read; scores and the value sum add about 4*C FLOPs per (query, key)
// pair of one window.  The TPU kernel streams a fixed +-192-token band
// around each tile through the MXU; here the block finds the exact key
// range [first token of the first query's window, last token of the last
// query's window) by binary search in the sorted window ids, so no key
// outside the tile's windows is projected and no window size is too big:
// keys stream through shared memory in chunks of 32 with an online
// softmax, which holds any window exactly.  One thread owns one
// (query, head) pair and keeps its q row, running max, sum and 16-wide
// accumulator in registers; a warp is one head of 32 queries, so every
// key row read from shared memory is a broadcast.  The projections keep
// the JAX dtype points: f32 accumulation, then the compute dtype, then
// the bias added in the compute dtype.  Weights are read through the
// read-only cache; the first Hopper step up is wgmma on staged tiles.
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
// 1/sqrt(D), a power of two because D is a power of four: folding it into
// q in the compute dtype is exact, as the JAX kernel does
constexpr float kScale = 0.25f;
static_assert(kScale * kScale * D == 1.0f, "kScale is 1/sqrt(D)");
static_assert(kThreads == 256, "one thread per (query, head)");
static_assert(KC == TQ, "one projection helper for queries and keys");

constexpr int kSmemFloats = 4 * KC * C;
constexpr int kSmemBytes = kSmemFloats * sizeof(float) + 2 * KC * sizeof(int);

// out[r][c] = round_t(round_t(sum_k a[r][k] W[k][c]) + bias[c]) for the 32
// rows of `a` (shared, [32][C]).  Thread: column c, rows r0, r0 + 2, ...
template <typename T>
__device__ __forceinline__ void project(const float* __restrict__ a,
                                        const T* __restrict__ W,
                                        const T* __restrict__ bias,
                                        float* __restrict__ out) {
  constexpr int RG = kThreads / C;   // row groups
  constexpr int RPT = KC / RG;       // rows per thread
  const int c = threadIdx.x % C;
  const int r0 = threadIdx.x / C;
  float acc[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) acc[j] = 0.f;
  for (int k = 0; k < C; k += 4) {
    const float w0 = to_f<T>(W[(k + 0) * C + c]);
    const float w1 = to_f<T>(W[(k + 1) * C + c]);
    const float w2 = to_f<T>(W[(k + 2) * C + c]);
    const float w3 = to_f<T>(W[(k + 3) * C + c]);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(&a[(r0 + RG * j) * C + k]);
      acc[j] = fmaf(v.x, w0, acc[j]);
      acc[j] = fmaf(v.y, w1, acc[j]);
      acc[j] = fmaf(v.z, w2, acc[j]);
      acc[j] = fmaf(v.w, w3, acc[j]);
    }
  }
  const float bc = to_f<T>(bias[c]);
#pragma unroll
  for (int j = 0; j < RPT; ++j)
    out[(r0 + RG * j) * C + c] = round_t<T>(round_t<T>(acc[j]) + bc);
}

// Stage rows [r0, r0 + n) of x into s_x and of round_t(x + pos) into s_xp;
// rows past n read 0.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ x,
                                           const T* __restrict__ pos, int r0,
                                           int n, float* s_x, float* s_xp) {
  for (int i = threadIdx.x; i < KC * C; i += kThreads) {
    const int r = i / C;
    float xv = 0.f, xp = 0.f;
    if (r < n) {
      const size_t g = (size_t)(r0 + r) * C + (i - r * C);
      xv = to_f<T>(x[g]);
      xp = round_t<T>(xv + to_f<T>(pos[g]));
    }
    s_x[i] = xv;
    s_xp[i] = xp;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_attention_qkv_kernel(const T* __restrict__ x, const T* __restrict__ pos,
                          const T* __restrict__ wq, const T* __restrict__ bq,
                          const T* __restrict__ wk, const T* __restrict__ bk,
                          const T* __restrict__ wv, const T* __restrict__ bv,
                          const int* __restrict__ win,
                          const uint8_t* __restrict__ key_valid,
                          T* __restrict__ out, int V) {
  extern __shared__ float smem[];
  float* s_x = smem;              // [KC][C] x rows
  float* s_xp = s_x + KC * C;     // [KC][C] x + pos rows
  float* s_k = s_xp + KC * C;     // [KC][C] k rows (q rows at first)
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
  const T* xb = x + row0 * C;
  const T* pb = pos + row0 * C;
  T* ob = out + row0 * C;

  const int h = threadIdx.x / TQ;   // warp-uniform
  const int i = threadIdx.x % TQ;
  const int qi = q0 + i;
  const int my_win = (i < nq) ? wb[qi] : kInt32Max;

  if (threadIdx.x == 0) {
    int ks = 0, ke = 0;
    const int first = wb[q0];
    if (first != kInt32Max) {
      // padding is a suffix: the tile's last real query sits before it
      const int last_q = min(lower_bound_i32(wb, V, kInt32Max), q0 + nq) - 1;
      ks = lower_bound_i32(wb, V, first);
      ke = lower_bound_i32(wb, V, wb[last_q] + 1);
    }
    s_range[0] = ks;
    s_range[1] = ke;
  }
  __syncthreads();
  const int ks = s_range[0], ke = s_range[1];

  float q[D];
  if (ks < ke) {
    stage_rows<T>(xb, pb, q0, nq, s_x, s_xp);
    __syncthreads();
    project<T>(s_xp, wq, bq, s_k);
    __syncthreads();
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float v = s_k[i * C + h * D + d];
      q[d] = round_t<T>(v * kScale);
    }
  }

  float m = -INFINITY, l = 0.f, acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int k0 = ks; k0 < ke; k0 += KC) {
    const int nk = min(KC, ke - k0);
    __syncthreads();   // the previous chunk (or the q rows) is consumed
    stage_rows<T>(xb, pb, k0, nk, s_x, s_xp);
    if (threadIdx.x < KC) {
      const int r = threadIdx.x;
      s_win[r] = r < nk ? wb[k0 + r] : kInt32Max;
      s_kv[r] = r < nk ? (int)kvb[k0 + r] : 0;
    }
    __syncthreads();
    project<T>(s_xp, wk, bk, s_k);
    project<T>(s_x, wv, bv, s_v);
    __syncthreads();
    if (my_win == kInt32Max) continue;
    for (int j = 0; j < nk; ++j) {
      if (s_win[j] != my_win || !s_kv[j]) continue;
      const float4* kr = reinterpret_cast<const float4*>(&s_k[j * C + h * D]);
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 kk = kr[d4];
        s = fmaf(q[4 * d4 + 0], kk.x, s);
        s = fmaf(q[4 * d4 + 1], kk.y, s);
        s = fmaf(q[4 * d4 + 2], kk.z, s);
        s = fmaf(q[4 * d4 + 3], kk.w, s);
      }
      const float mn = fmaxf(m, s);
      const float corr = expf(m - mn);
      const float p = expf(s - mn);
      l = l * corr + p;
      const float pr = round_t<T>(p);
      const float4* vr = reinterpret_cast<const float4*>(&s_v[j * C + h * D]);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(pr, vv.x, acc[4 * d4 + 0] * corr);
        acc[4 * d4 + 1] = fmaf(pr, vv.y, acc[4 * d4 + 1] * corr);
        acc[4 * d4 + 2] = fmaf(pr, vv.z, acc[4 * d4 + 2] * corr);
        acc[4 * d4 + 3] = fmaf(pr, vv.w, acc[4 * d4 + 3] * corr);
      }
      m = mn;
    }
  }

  if (i < nq) {
    const float inv = (my_win != kInt32Max && l > 0.f) ? 1.f / l : 0.f;
    T* o = ob + (size_t)qi * C + h * D;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = from_f<T>(acc[d] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* pos, const void* wq,
                   const void* bq, const void* wk, const void* bk,
                   const void* wv, const void* bv, const int* win,
                   const uint8_t* key_valid, void* out, int B, int V,
                   cudaStream_t stream) {
  cudaError_t e = allow_smem(band_attention_qkv_kernel<T>, kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((V + TQ - 1) / TQ, B);
  band_attention_qkv_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(pos),
      static_cast<const T*>(wq), static_cast<const T*>(bq),
      static_cast<const T*>(wk), static_cast<const T*>(bk),
      static_cast<const T*>(wv), static_cast<const T*>(bv), win, key_valid,
      static_cast<T*>(out), V);
  return cudaGetLastError();
}

}  // namespace
}  // namespace geomae

extern "C" {

// x, pos, out [B, V, 128]; W [128, 128] (in x out); b [128]; all dtype.
// win [B, V] int32 ascending per row (INT32_MAX padding suffix);
// key_valid [B, V] bytes.  8 heads of 16.
int geomae_band_attention_qkv(int dtype, const void* x, const void* pos,
                              const void* wq, const void* bq, const void* wk,
                              const void* bk, const void* wv, const void* bv,
                              const int* win, const uint8_t* key_valid,
                              void* out, int B, int V, void* stream) {
  using namespace geomae;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(x, pos, wq, bq, wk, bk, wv, bv, win, key_valid, out,
                         B, V, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, pos, wq, bq, wk, bk, wv, bv, win,
                                 key_valid, out, B, V, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
