// K5 post_attention_block forward: out-projection, residual, LayerNorm,
// GELU FFN, residual, LayerNorm, fused per token.
//
// Replaces geomae_tpu/ops/pallas_ffn.py: post_attention_block (_forward /
// _fwd_kernel).  Per token:
//   o  = attn Wo + bo;   xm = LN1(x + o)
//   y  = LN2(xm + gelu(xm W1 + b1) W2 + b2)
// with the dtype points of pallas_ffn._recompute: each matmul accumulates
// in f32 and is cast to the compute dtype before its bias is added in that
// dtype, LayerNorm statistics are f32 with var = E[z^2] - mu^2, eps as
// given, GELU is the exact erf form.  Rows at or past nv[b] (the extent of
// the real tokens) return 0.
//
// Bound: arithmetic on the CUDA cores: 2*(C*C + 2*C*F) FLOPs per token
// against 3*C values moved, so the weights, not the tokens, dominate the
// traffic.  A block takes a tile of 32 tokens and keeps every
// intermediate ([32, C] residuals, the [32, F] hidden) in shared memory,
// so one read of x and attn and one write of y reach device memory, as on
// the TPU.  Wo, W1 and W2 (160 KB in bf16) do not fit beside the tiles in
// a block's 227 KB, so they stream through the read-only cache: each
// thread owns one output column, reads each weight once per tile, and
// reuses it for 16 or 32 token rows held in registers.  The first Hopper
// step up is wgmma with the weights staged in shared memory tiles.
#include <math.h>

#include "common.cuh"

namespace geomae {
namespace {

constexpr int C = 128;       // channels
constexpr int F = 256;       // FFN width
constexpr int TT = 32;       // tokens per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

constexpr int kSmemBytes = (3 * TT * C + TT * F) * sizeof(float);

// acc[j] = sum_k a[row(j)][k] W[k][col] for the tile's rows; a is shared
// [TT][K], W is [K][N].  Thread: column tid % N, rows tid / N + RG * j.
template <typename T, int K, int N>
struct Proj {
  static constexpr int RG = kThreads / N;
  static constexpr int RPT = TT / RG;
  static_assert(kThreads % N == 0 && TT % RG == 0, "tile shape");

  __device__ static int col() { return threadIdx.x % N; }
  __device__ static int row(int j) { return threadIdx.x / N + RG * j; }

  __device__ static void run(const float* __restrict__ a,
                             const T* __restrict__ W, float (&acc)[RPT]) {
    const int c = col();
#pragma unroll
    for (int j = 0; j < RPT; ++j) acc[j] = 0.f;
    for (int k = 0; k < K; k += 4) {
      const float w0 = to_f<T>(W[(k + 0) * N + c]);
      const float w1 = to_f<T>(W[(k + 1) * N + c]);
      const float w2 = to_f<T>(W[(k + 2) * N + c]);
      const float w3 = to_f<T>(W[(k + 3) * N + c]);
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(&a[row(j) * K + k]);
        acc[j] = fmaf(v.x, w0, acc[j]);
        acc[j] = fmaf(v.y, w1, acc[j]);
        acc[j] = fmaf(v.z, w2, acc[j]);
        acc[j] = fmaf(v.w, w3, acc[j]);
      }
    }
  }
};

// In place over the shared [TT][C] tile z: row-wise LayerNorm, f32 stats,
// result rounded to T.  One warp per row, 4 channels per lane.
template <typename T>
__device__ __forceinline__ void layer_norm(float* z, const float* __restrict__ s,
                                           const float* __restrict__ t,
                                           float eps) {
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < TT; r += kWarps) {
    float v[C / 32], sum = 0.f, sq = 0.f;
#pragma unroll
    for (int u = 0; u < C / 32; ++u) {
      v[u] = z[r * C + lane + 32 * u];
      sum += v[u];
      sq += v[u] * v[u];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
    }
    const float mu = sum / C;
    const float rs = 1.f / sqrtf(sq / C - mu * mu + eps);
#pragma unroll
    for (int u = 0; u < C / 32; ++u) {
      const int c = lane + 32 * u;
      z[r * C + c] = round_t<T>((v[u] - mu) * rs * s[c] + t[c]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
post_attention_kernel(const T* __restrict__ x, const T* __restrict__ attn,
                      const T* __restrict__ wo, const T* __restrict__ bo,
                      const float* __restrict__ s1, const float* __restrict__ t1,
                      const T* __restrict__ w1, const T* __restrict__ b1,
                      const T* __restrict__ w2, const T* __restrict__ b2,
                      const float* __restrict__ s2, const float* __restrict__ t2,
                      const int* __restrict__ nv, T* __restrict__ y, int V,
                      float eps) {
  extern __shared__ float smem[];
  float* s_z = smem;             // [TT][C] x, then z2 = xm + o2
  float* s_a = s_z + TT * C;     // [TT][C] attn, then z = x + o, then xm
  float* s_o = s_a + TT * C;     // [TT][C] o, then o2
  float* s_h = s_o + TT * C;     // [TT][F] gelu hidden

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * TT;
  const int nr = min(TT, min(V, nv[b]) - r0);    // real rows in this tile
  const size_t base = ((size_t)b * V + r0) * C;
  const int rows = min(TT, V - r0);
  if (nr <= 0) {
    for (int i = threadIdx.x; i < rows * C; i += kThreads)
      y[base + i] = from_f<T>(0.f);
    return;
  }

  for (int i = threadIdx.x; i < TT * C; i += kThreads) {
    const bool in = i < nr * C;
    s_z[i] = in ? to_f<T>(x[base + i]) : 0.f;
    s_a[i] = in ? to_f<T>(attn[base + i]) : 0.f;
  }
  __syncthreads();

  {  // o = attn Wo + bo;  z = x + o
    using P = Proj<T, C, C>;
    float acc[P::RPT];
    P::run(s_a, wo, acc);
    const int c = P::col();
    const float bc = to_f<T>(bo[c]);
#pragma unroll
    for (int j = 0; j < P::RPT; ++j)
      s_o[P::row(j) * C + c] = round_t<T>(round_t<T>(acc[j]) + bc);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TT * C; i += kThreads)
    s_a[i] = round_t<T>(s_z[i] + s_o[i]);
  __syncthreads();
  layer_norm<T>(s_a, s1, t1, eps);                // s_a = xm
  __syncthreads();

  {  // h = gelu(xm W1 + b1)
    using P = Proj<T, C, F>;
    float acc[P::RPT];
    P::run(s_a, w1, acc);
    const int c = P::col();
    const float bc = to_f<T>(b1[c]);
#pragma unroll
    for (int j = 0; j < P::RPT; ++j) {
      const float a1 = round_t<T>(round_t<T>(acc[j]) + bc);
      const float g = 0.5f * a1 * (1.f + erff(a1 * 0.70710678118654752f));
      s_h[P::row(j) * F + c] = round_t<T>(g);
    }
  }
  __syncthreads();

  {  // o2 = h W2 + b2;  z2 = xm + o2
    using P = Proj<T, F, C>;
    float acc[P::RPT];
    P::run(s_h, w2, acc);
    const int c = P::col();
    const float bc = to_f<T>(b2[c]);
#pragma unroll
    for (int j = 0; j < P::RPT; ++j) {
      const int r = P::row(j);
      const float o2 = round_t<T>(round_t<T>(acc[j]) + bc);
      s_z[r * C + c] = round_t<T>(s_a[r * C + c] + o2);
    }
  }
  __syncthreads();
  layer_norm<T>(s_z, s2, t2, eps);
  __syncthreads();

  for (int i = threadIdx.x; i < rows * C; i += kThreads)
    y[base + i] = from_f<T>(i < nr * C ? s_z[i] : 0.f);
}

template <typename T>
cudaError_t launch(const void* x, const void* attn, const void* wo,
                   const void* bo, const float* s1, const float* t1,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, const float* s2, const float* t2,
                   const int* nv, void* y, int B, int V, float eps,
                   cudaStream_t stream) {
  cudaError_t e = allow_smem(post_attention_kernel<T>, kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((V + TT - 1) / TT, B);
  post_attention_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(attn),
      static_cast<const T*>(wo), static_cast<const T*>(bo), s1, t1,
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), s2, t2, nv,
      static_cast<T*>(y), V, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace geomae

extern "C" {

// x, attn, y [B, V, 128]; wo [128, 128], w1 [128, 256], w2 [256, 128]
// (in x out) and their biases in the compute dtype; LayerNorm scale and
// bias (s1, t1, s2, t2) [128] float32; nv [B] int32.
int geomae_post_attention_block(int dtype, const void* x, const void* attn,
                                const void* wo, const void* bo,
                                const float* s1, const float* t1,
                                const void* w1, const void* b1,
                                const void* w2, const void* b2,
                                const float* s2, const float* t2,
                                const int* nv, void* y, int B, int V,
                                float eps, void* stream) {
  using namespace geomae;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(x, attn, wo, bo, s1, t1, w1, b1, w2, b2, s2, t2, nv,
                         y, B, V, eps, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, attn, wo, bo, s1, t1, w1, b1, w2, b2, s2,
                                 t2, nv, y, B, V, eps, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
