// K5 post_attention_block: out-projection, residual, LayerNorm, GELU FFN,
// residual, LayerNorm, fused per token, forward and backward.
//
// Replaces geomae_tpu/ops/pallas_ffn.py: post_attention_block (_forward /
// _fwd_kernel) and its backward (_backward / _bwd_kernel, math in
// _bwd_body).  Per token:
//   o  = attn Wo + bo;   xm = LN1(x + o)
//   y  = LN2(xm + gelu(xm W1 + b1) W2 + b2)
// with the dtype points of pallas_ffn._recompute: each matmul accumulates
// in f32 and is cast to the compute dtype before its bias is added in that
// dtype, LayerNorm statistics are f32 with var = E[z^2] - mu^2, eps as
// given, GELU is the exact erf form.  Rows at or past nv[b] (the extent of
// the real tokens) return 0.
//
// Forward.  Bound: 2*(C*C + 2*C*F) = 147,456 operations a token against
// 768 bytes moved in bf16 (x and attn read, y written; the weights, 160
// KB, once a call): at [4, 20480] the bytes take 0.0189 ms, the tensor
// cores' share of the operations 0.0136 ms, so bytes bound it.
//
// bfloat16, on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate; mma.cuh): post_attention_fwd_tc_kernel is passes 0-3 of the
// tile pass below, the part that the backward's per-tile pass recomputes,
// through the same device functions (the product pass, the staging, the
// row-wise steps), so the two round at the same points by construction.
// A persistent grid walks 64-token tiles; each block streams the weights
// through a two-buffer cp.async ring and keeps the tile's rows in 109,568
// bytes of shared memory (attn then xm, x then o2, o then a1 and h over
// it); 123 registers: two blocks an SM, so one block's row-wise work
// overlaps the other's products.  It stands at about a tenth of its bound
// (PERF.md): the products take a few per cent of its time, the row-wise
// loops (bias, residual, two LayerNorms with their warp reductions, exact
// GELU) about 0.44 and the weight ring's waits about 0.17
// (probe_forwards); one block an SM with a three-buffer ring is slower.
//
// float32, on the CUDA cores (post_attention_kernel): tensor cores take no
// f32 operand without TF32 rounding.  A block takes a tile of 32 tokens
// and keeps every intermediate ([32, C] residuals, the [32, F] hidden) in
// shared memory, so one read of x and attn and one write of y reach device
// memory, as on the TPU; the weights stream through the read-only cache,
// each thread owning one output column for 16 or 32 token rows held in
// registers.  Bound: the CUDA cores' f32 rate, 0.20 ms at [4, 20480].
//
// Backward: the kernels recompute the forward from x and attn (as the TPU
// kernel does) and back-propagate through both LayerNorms, the FFN and
// the out-projection with the dtype points of _bwd_body (each cotangent
// rounded to the compute dtype where the JAX kernel casts it).  They
// return dx (the cotangent through the LN1 residual, dz1) and dattn per
// token, and the ten parameter gradients in f32.  Rows at or past nv give
// zero dx and dattn and add nothing to the gradients.  The TPU's one
// accumulator over an ordered grid has no counterpart here: gradients are
// per-block or per-chunk f32 partials in device memory, summed in a fixed
// order by a second pass (common.cuh), so two calls agree bitwise.
//
// bfloat16, on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate; mma.cuh): a per-tile pass (post_attention_bwd_tile_kernel:
// 64 tokens, 8 warps, the six products, dx, dattn, the vector gradients
// and the bf16 rows the weight gradients need, xm, da1, h and dz2: 1,536
// bytes a token, each a value JAX also holds in bf16 before its product,
// so storing it is exact), then the weight gradients split over 2,048-token
// chunks (wgrad_kernel).  The tile pass takes 180 registers and 197,120
// bytes of dynamic shared memory, one block per SM; the weight pass 80
// registers and 36,864 bytes.  Bound: the card could do the 6 products in
// 0.04 ms at [4, 20480] (operations); the tile pass stands far above that
// (PERF.md): it issues mma.sync, not wgmma, from one block of 8 warps per
// SM, and its row-wise CUDA-core work (LayerNorms, GELU, their backward)
// between the products is a large share of its time.
//
// float32, on the CUDA cores (post_attention_bwd_kernel): tensor cores
// take no f32 operand without TF32 rounding.  A 32-token tile keeps its
// intermediates in 144 KB of shared memory; a persistent grid of one block
// per SM walks the tiles, each block adds its tiles' outer products to its
// own f32 partial in device memory (L2-resident), and sum_partials adds
// the partials in block order.  Bound: the CUDA cores, about 3x the
// forward's FLOPs plus one partial read and write per tile.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

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

constexpr int CL = C / 32;   // channels per lane in the row-wise passes

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Lane's channels of row r of the shared [TT][C] tile z, normalised:
// xhat = (z - mu) * rs with f32 stats, var = E[z^2] - mu^2.
__device__ __forceinline__ float row_xhat(const float* z, int r, float eps,
                                          float (&xh)[CL]) {
  const int lane = threadIdx.x % 32;
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int u = 0; u < CL; ++u) {
    xh[u] = z[r * C + lane + 32 * u];
    sum += xh[u];
    sq += xh[u] * xh[u];
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mu = sum / C;
  const float rs = 1.f / sqrtf(sq / C - mu * mu + eps);
#pragma unroll
  for (int u = 0; u < CL; ++u) xh[u] = (xh[u] - mu) * rs;
  return rs;
}

// out = LayerNorm(z) row-wise over the shared [TT][C] tile, rounded to T
// (out may be z).  One warp per row, 4 channels per lane.
template <typename T>
__device__ __forceinline__ void layer_norm(const float* z, float* out,
                                           const float* __restrict__ s,
                                           const float* __restrict__ t,
                                           float eps) {
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < TT; r += kWarps) {
    float xh[CL];
    row_xhat(z, r, eps, xh);
#pragma unroll
    for (int u = 0; u < CL; ++u) {
      const int c = lane + 32 * u;
      out[r * C + c] = round_t<T>(xh[u] * s[c] + t[c]);
    }
  }
}

// LayerNorm backward row-wise over the shared tiles (models/norm._ln_bwd):
// dz = round_t(rs * (g - mean(g) - xhat * mean(g * xhat))), g = dy * s,
// written to dz (may be dy or z).  The lane's channels accumulate
// sum(dy * xhat) into ds, sum(dy) into dt and sum(dz) into db (the bias
// gradient of the dense layer that feeds z).
template <typename T>
__device__ __forceinline__ void layer_norm_bwd(const float* z, const float* dy,
                                               float* dz,
                                               const float* __restrict__ s,
                                               float eps, float (&ds)[CL],
                                               float (&dt)[CL],
                                               float (&db)[CL]) {
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < TT; r += kWarps) {
    float xh[CL], d[CL], g[CL], sg = 0.f, sgx = 0.f;
    const float rs = row_xhat(z, r, eps, xh);
#pragma unroll
    for (int u = 0; u < CL; ++u) {
      const int c = lane + 32 * u;
      d[u] = dy[r * C + c];
      g[u] = d[u] * s[c];
      sg += g[u];
      sgx += g[u] * xh[u];
    }
    const float mg = warp_sum(sg) / C;
    const float mgx = warp_sum(sgx) / C;
#pragma unroll
    for (int u = 0; u < CL; ++u) {
      const float v = round_t<T>(rs * (g[u] - mg - xh[u] * mgx));
      dz[r * C + lane + 32 * u] = v;
      ds[u] += d[u] * xh[u];
      dt[u] += d[u];
      db[u] += v;
    }
  }
}

__device__ __forceinline__ float gelu(float a) {
  return 0.5f * a * (1.f + erff(a * 0.70710678118654752f));
}

__device__ __forceinline__ float dgelu(float a) {
  return 0.5f * (1.f + erff(a * 0.70710678118654752f)) +
         a * expf(-0.5f * a * a) * 0.39894228040143268f;
}

__global__ void __launch_bounds__(kThreads)
post_attention_kernel(const float* __restrict__ x,
                      const float* __restrict__ attn,
                      const float* __restrict__ wo,
                      const float* __restrict__ bo,
                      const float* __restrict__ s1, const float* __restrict__ t1,
                      const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ w2,
                      const float* __restrict__ b2,
                      const float* __restrict__ s2, const float* __restrict__ t2,
                      const int* __restrict__ nv, float* __restrict__ y, int V,
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
      y[base + i] = 0.f;
    return;
  }

  for (int i = threadIdx.x; i < TT * C; i += kThreads) {
    const bool in = i < nr * C;
    s_z[i] = in ? x[base + i] : 0.f;
    s_a[i] = in ? attn[base + i] : 0.f;
  }
  __syncthreads();

  {  // o = attn Wo + bo;  z = x + o
    using P = Proj<float, C, C>;
    float acc[P::RPT];
    P::run(s_a, wo, acc);
    const int c = P::col();
    const float bc = bo[c];
#pragma unroll
    for (int j = 0; j < P::RPT; ++j)
      s_o[P::row(j) * C + c] = acc[j] + bc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TT * C; i += kThreads)
    s_a[i] = s_z[i] + s_o[i];
  __syncthreads();
  layer_norm<float>(s_a, s_a, s1, t1, eps);       // s_a = xm
  __syncthreads();

  {  // h = gelu(xm W1 + b1)
    using P = Proj<float, C, F>;
    float acc[P::RPT];
    P::run(s_a, w1, acc);
    const int c = P::col();
    const float bc = b1[c];
#pragma unroll
    for (int j = 0; j < P::RPT; ++j)
      s_h[P::row(j) * F + c] = gelu(acc[j] + bc);
  }
  __syncthreads();

  {  // o2 = h W2 + b2;  z2 = xm + o2
    using P = Proj<float, F, C>;
    float acc[P::RPT];
    P::run(s_h, w2, acc);
    const int c = P::col();
    const float bc = b2[c];
#pragma unroll
    for (int j = 0; j < P::RPT; ++j) {
      const int r = P::row(j);
      s_z[r * C + c] = s_a[r * C + c] + (acc[j] + bc);
    }
  }
  __syncthreads();
  layer_norm<float>(s_z, s_z, s2, t2, eps);
  __syncthreads();

  for (int i = threadIdx.x; i < rows * C; i += kThreads)
    y[base + i] = i < nr * C ? s_z[i] : 0.f;
}

// Parameter gradients, f32, in one buffer (a block's partial and the
// summed result): dWo [C][C], dW1 [C][F], dW2 [F][C], dbo, ds1, dt1 [C],
// db1 [F], db2, ds2, dt2 [C].  ops/ffn.py splits it in this order.
constexpr int kOffW1 = C * C;
constexpr int kOffW2 = kOffW1 + C * F;
constexpr int kOffB1 = kOffW2 + F * C + 3 * C;
constexpr int kGradFloats = kOffB1 + F + 3 * C;
// the six [C] vectors in that order, around db1
__device__ __forceinline__ int vec_offset(int q) {
  return q < 3 ? kOffW2 + F * C + q * C : kOffB1 + F + (q - 3) * C;
}

constexpr int kBwdSmemBytes = (5 * TT * C + 2 * TT * F) * sizeof(float);

struct BwdArgs {
  const void *x, *attn, *dy, *wo, *bo, *w1, *b1, *w2, *b2;
  const void *woT, *w1T, *w2T;     // the weights transposed, for the dx path
  const float *s1, *t1, *s2, *t2;
  const int* nv;
  void *dx, *dattn;
  float* partial;                  // [gridDim.x][kGradFloats], zeroed
  int B, V;
  float eps;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
post_attention_bwd_kernel(BwdArgs p) {
  extern __shared__ float smem[];
  float* s_at = smem;            // [TT][C] attn
  float* s_z = s_at + TT * C;    // [TT][C] x, then z = x + o
  float* s_xm = s_z + TT * C;    // [TT][C] xm = LN1(z)
  float* s_d = s_xm + TT * C;    // [TT][C] dy, then dxm, then dz1 (= dx)
  float* s_z2 = s_d + TT * C;    // [TT][C] z2, then dz2
  float* s_a1 = s_z2 + TT * C;   // [TT][F] a1, then da1
  float* s_h = s_a1 + TT * F;    // [TT][F] h = gelu(a1)

  const T* x = static_cast<const T*>(p.x);
  const T* attn = static_cast<const T*>(p.attn);
  const T* dy = static_cast<const T*>(p.dy);
  const T* bo = static_cast<const T*>(p.bo);
  const T* b1 = static_cast<const T*>(p.b1);
  const T* b2 = static_cast<const T*>(p.b2);
  T* dx = static_cast<T*>(p.dx);
  T* dattn = static_cast<T*>(p.dattn);
  float* P = p.partial + (size_t)blockIdx.x * kGradFloats;

  // per lane: the [C] gradients of its channels over its rows, all tiles
  float ds2[CL] = {}, dt2[CL] = {}, db2[CL] = {};
  float ds1[CL] = {}, dt1[CL] = {}, dbo[CL] = {};
  float db1 = 0.f;               // column threadIdx.x of da1, every row

  const int tiles_per_row = (p.V + TT - 1) / TT;
  for (int tile = blockIdx.x; tile < p.B * tiles_per_row;
       tile += gridDim.x) {
    const int b = tile / tiles_per_row;
    const int r0 = (tile - b * tiles_per_row) * TT;
    const int nr = min(TT, min(p.V, p.nv[b]) - r0);   // real rows
    const int rows = min(TT, p.V - r0);
    const size_t base = ((size_t)b * p.V + r0) * C;
    __syncthreads();             // the previous tile's buffers are consumed
    if (nr <= 0) {
      for (int i = threadIdx.x; i < rows * C; i += kThreads) {
        dx[base + i] = from_f<T>(0.f);
        dattn[base + i] = from_f<T>(0.f);
      }
      continue;
    }
    for (int i = threadIdx.x; i < TT * C; i += kThreads) {
      const bool in = i < nr * C;
      s_z[i] = in ? to_f<T>(x[base + i]) : 0.f;
      s_at[i] = in ? to_f<T>(attn[base + i]) : 0.f;
      s_d[i] = in ? to_f<T>(dy[base + i]) : 0.f;
    }
    __syncthreads();

    // forward recompute: z = x + (attn Wo + bo); xm = LN1(z)
    {
      using Pj = Proj<T, C, C>;
      float acc[Pj::RPT];
      Pj::run(s_at, static_cast<const T*>(p.wo), acc);
      const int c = Pj::col();
      const float bc = to_f<T>(bo[c]);
#pragma unroll
      for (int j = 0; j < Pj::RPT; ++j) {
        const int r = Pj::row(j);
        s_z[r * C + c] = round_t<T>(s_z[r * C + c] +
                                    round_t<T>(round_t<T>(acc[j]) + bc));
      }
    }
    __syncthreads();
    layer_norm<T>(s_z, s_xm, p.s1, p.t1, p.eps);
    __syncthreads();
    {  // a1 = xm W1 + b1; h = gelu(a1)
      using Pj = Proj<T, C, F>;
      float acc[Pj::RPT];
      Pj::run(s_xm, static_cast<const T*>(p.w1), acc);
      const int c = Pj::col();
      const float bc = to_f<T>(b1[c]);
#pragma unroll
      for (int j = 0; j < Pj::RPT; ++j) {
        const float a1 = round_t<T>(round_t<T>(acc[j]) + bc);
        s_a1[Pj::row(j) * F + c] = a1;
        s_h[Pj::row(j) * F + c] = round_t<T>(gelu(a1));
      }
    }
    __syncthreads();
    {  // z2 = xm + (h W2 + b2)
      using Pj = Proj<T, F, C>;
      float acc[Pj::RPT];
      Pj::run(s_h, static_cast<const T*>(p.w2), acc);
      const int c = Pj::col();
      const float bc = to_f<T>(b2[c]);
#pragma unroll
      for (int j = 0; j < Pj::RPT; ++j) {
        const int r = Pj::row(j);
        s_z2[r * C + c] = round_t<T>(s_xm[r * C + c] +
                                     round_t<T>(round_t<T>(acc[j]) + bc));
      }
    }
    __syncthreads();

    // LN2 backward: dz2 over z2 (ds2, dt2, db2 per lane)
    layer_norm_bwd<T>(s_z2, s_d, s_z2, p.s2, p.eps, ds2, dt2, db2);
    __syncthreads();
    accum_outer<kThreads, TT, F, C>(s_h, s_z2, P + kOffW2);
    {  // dh = dz2 W2^T; da1 = dh * gelu'(a1), over a1
      using Pj = Proj<T, C, F>;
      float acc[Pj::RPT];
      Pj::run(s_z2, static_cast<const T*>(p.w2T), acc);
      const int c = Pj::col();
#pragma unroll
      for (int j = 0; j < Pj::RPT; ++j) {
        float* a = &s_a1[Pj::row(j) * F + c];
        const float da = round_t<T>(round_t<T>(acc[j]) * dgelu(*a));
        *a = da;
        db1 += da;
      }
    }
    __syncthreads();
    accum_outer<kThreads, TT, C, F>(s_xm, s_a1, P + kOffW1);
    {  // dxm = dz2 + da1 W1^T, over dy
      using Pj = Proj<T, F, C>;
      float acc[Pj::RPT];
      Pj::run(s_a1, static_cast<const T*>(p.w1T), acc);
      const int c = Pj::col();
#pragma unroll
      for (int j = 0; j < Pj::RPT; ++j) {
        const int r = Pj::row(j);
        s_d[r * C + c] = round_t<T>(s_z2[r * C + c] + round_t<T>(acc[j]));
      }
    }
    __syncthreads();
    // LN1 backward: dz1 over dxm (ds1, dt1, dbo per lane)
    layer_norm_bwd<T>(s_z, s_d, s_d, p.s1, p.eps, ds1, dt1, dbo);
    __syncthreads();
    accum_outer<kThreads, TT, C, C>(s_at, s_d, P);
    {  // dattn = dz1 Wo^T
      using Pj = Proj<T, C, C>;
      float acc[Pj::RPT];
      Pj::run(s_d, static_cast<const T*>(p.woT), acc);
      const int c = Pj::col();
#pragma unroll
      for (int j = 0; j < Pj::RPT; ++j) {
        const int r = Pj::row(j);
        if (r < rows)
          dattn[base + r * C + c] = from_f<T>(r < nr ? acc[j] : 0.f);
      }
    }
    for (int i = threadIdx.x; i < rows * C; i += kThreads)
      dx[base + i] = from_f<T>(i < nr * C ? s_d[i] : 0.f);
  }

  // the [C] gradients: each warp's lanes, summed over the warps in order
  __syncthreads();
  float* red = s_a1;             // [kWarps][6][C]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int u = 0; u < CL; ++u) {
    float* w = red + warp * 6 * C + lane + 32 * u;
    w[0 * C] = dbo[u];
    w[1 * C] = ds1[u];
    w[2 * C] = dt1[u];
    w[3 * C] = db2[u];
    w[4 * C] = ds2[u];
    w[5 * C] = dt2[u];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 6 * C; i += kThreads) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += red[w * 6 * C + i];
    P[vec_offset(i / C) + i % C] = sum;
  }
  static_assert(F == kThreads, "Proj<C, F>: thread t owns column t");
  P[kOffB1 + threadIdx.x] = db1;
}

// ---------------------------------------------------------------------
// bf16 backward on the tensor cores: a per-tile pass (post_attention_
// bwd_tile_kernel) and a weight-gradient pass (wgrad_kernel), both with
// mma.sync m16n8k16 (mma.cuh).

// Weight gradients, split-K over tokens: dWo = attn^T dz1, dW1 = xm^T
// da1, dW2 = h^T dz2, each operand a token-major bf16 [B * V, K] matrix.
// Block (chunk, 64 x 64 output tile, product) reduces kWgChunk rows of
// its chunk in 64-row steps, staged in shared memory by cp.async (double
// buffered, rows at or past nv zero-filled), and writes its f32 tile to
// partial[chunk]; sum_partials adds the chunks in order.  Four warps, each
// a 32 x 32 quarter: the token axis is the reduction axis, so both
// fragments come from ldmatrix .trans.
constexpr int kWgChunk = 2048;        // token rows per chunk
constexpr int kWgStep = 64;           // rows per staged step
constexpr int kWgTile = 64;           // output tile edge
constexpr int kWgThreads = 128;
constexpr int kWgStride = kWgTile + kPad;
constexpr int kWeightFloats = kOffW2 + F * C;   // dWo, dW1, dW2

struct WgradArgs {
  // per product (dWo, dW1, dW2): the [n, M] and the [n, N] operand
  const __nv_bfloat16* a[3];
  const __nv_bfloat16* d[3];
  const int* nv;
  float* partial;                    // [chunks][kWeightFloats]
  int B, V;
};

// whether any row of [r0, r1) of the flattened [B * V] lies before its
// sample's nv (the real rows of a sample are a prefix)
__device__ __forceinline__ bool any_real(const int* nv, int V, int r0,
                                         int r1) {
  for (int b = r0 / V; b * V < r1; ++b)
    if (max(r0 - b * V, 0) < min(nv[b], V)) return true;
  return false;
}

__global__ void __launch_bounds__(kWgThreads) wgrad_kernel(WgradArgs p) {
  __shared__ __align__(16) __nv_bfloat16 s_a[2][kWgStep * kWgStride];
  __shared__ __align__(16) __nv_bfloat16 s_d[2][kWgStep * kWgStride];
  // the product's fields without a dynamic index (which would copy the
  // argument arrays to the stack)
  const int z = blockIdx.z;
  const int M = z == 2 ? F : C, N = z == 1 ? F : C;
  const int off = z == 0 ? 0 : z == 1 ? kOffW1 : kOffW2;
  const int nt = N / kWgTile;
  if ((int)blockIdx.y >= (M / kWgTile) * nt) return;
  const int m0 = (blockIdx.y / nt) * kWgTile, n0 = (blockIdx.y % nt) * kWgTile;
  const __nv_bfloat16* A = z == 0 ? p.a[0] : z == 1 ? p.a[1] : p.a[2];
  const __nv_bfloat16* D = z == 0 ? p.d[0] : z == 1 ? p.d[1] : p.d[2];
  const int rows = p.B * p.V;
  const int c0 = blockIdx.x * kWgChunk;
  const int steps = (min(kWgChunk, rows - c0) + kWgStep - 1) / kWgStep;

  // step s: rows c0 + 64 s .. + 63, columns m0.. of A and n0.. of D; 512
  // 16-byte pieces each, 4 + 4 per thread
  auto load = [&](int s, int buf) {
    for (int i = threadIdx.x; i < kWgStep * 8; i += kWgThreads) {
      const int r = i / 8, c = (i % 8) * 8, gr = c0 + s * kWgStep + r;
      const int b = gr / p.V;
      const bool real = gr < rows && gr - b * p.V < min(p.nv[b], p.V);
      const size_t g = real ? (size_t)gr : 0;
      cp_async_16(&s_a[buf][r * kWgStride + c], A + g * M + m0 + c, real);
      cp_async_16(&s_d[buf][r * kWgStride + c], D + g * N + n0 + c, real);
    }
  };

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  float acc[2][4][4] = {};
  load(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();
    __syncthreads();                 // step s landed; step s - 1 consumed
    if (s + 1 < steps) load(s + 1, (s + 1) & 1);
    cp_async_commit();
    const int r0 = c0 + s * kWgStep;
    if (!any_real(p.nv, p.V, r0, min(r0 + kWgStep, rows))) continue;
    const __nv_bfloat16* sa = s_a[s & 1];
    const __nv_bfloat16* sd = s_d[s & 1];
#pragma unroll
    for (int kk = 0; kk < kWgStep; kk += 16) {
      uint32_t af[2][4], bf[2][4];
      const int q = lane / 8;
#pragma unroll
      for (int i = 0; i < 2; ++i)    // A^T: rows are tokens (k), cols m
        ldmatrix_x4_trans(af[i], sa + (kk + lane % 8 + (q / 2) * 8) * kWgStride
                                      + wm + i * 16 + (q % 2) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)    // D: rows are tokens (k), cols n
        ldmatrix_x4_trans(bf[j], sd + (kk + lane % 8 + (q % 2) * 8) * kWgStride
                                      + wn + j * 16 + (q / 2) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16_16816(acc[i][j], af[i], &bf[j / 2][(j % 2) * 2]);
    }
  }
  cp_async_wait<0>();
  float* out = p.partial + (size_t)blockIdx.x * kWeightFloats + off;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + g + 8 * h;
        const int n = n0 + wn + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(&out[(size_t)m * N + n]) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

// The tensor-core tile pass, shared by the bf16 forward
// (post_attention_fwd_tc_kernel) and the bf16 backward's per-tile pass
// (post_attention_bwd_tile_kernel): a tile of 64 tokens, eight warps.  For
// every product a pair of warps takes 16 rows, each warp 64 of the pass's
// 128 columns, with mma.sync.  The activations that feed a later product
// are bf16 rows in shared memory; the weights stream through a ring of
// k-chunk buffers shared by the block (cp.async, the next chunks in flight
// while one is consumed, across tiles too).  Every product is a pass of N =
// 128 output columns over K = 128 or 256: passes 0-3 are the forward (o =
// attn Wo, a1 = xm W1 in two halves, o2 = h W2; chunks 0-9 of 64 k-rows),
// passes 4-7 the backward's (20 chunks in all).  After a pass the warps
// stage the product, rounded to bf16, in shared memory, and the row-wise
// work (bias, residual, both LayerNorms, GELU, and in the backward their
// derivatives) loops over 8 rows per warp with the lanes across the
// columns.  The forward's row-wise steps are device functions that both
// kernels call (residual_stats, ln_out, bias_gelu), so the backward's
// recompute rounds where the forward does by construction.  A tile's rows
// arrive by cp.async beside the weights, and the vector parameters sit in
// shared memory, so no epilogue waits on device memory.
constexpr int kTT = 64;                       // tokens per tile
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kWarpRows = kTT / kTileWarps;   // rows a warp's row loops take
constexpr int kSC = C + kPad;                 // shared row strides
constexpr int kSF = F + kPad;
constexpr int kKc = 64;                       // k-rows per weight chunk
constexpr int kChunkElems = C * (kKc + kPad); // >= kKc * kSC
constexpr int kTileChunks = 20;               // the backward's stream
constexpr int kFwdChunks = 10;                // the forward's: passes 0-3
constexpr int kRing = 3;                      // the backward's chunk buffers
constexpr int kFwdRing = 2;                   // the forward's
constexpr int kVecFloats = kGradFloats - kWeightFloats;   // 6 C + F
constexpr int kTileSmemBytes =
    (4 * kTT * kSC + 2 * kTT * kSF + kRing * kChunkElems) * 2 +
    kVecFloats * 4 + 2 * kTT * 4;
constexpr int kFwdSmemBytes =
    (2 * kTT * kSC + kTT * kSF + kFwdRing * kChunkElems) * 2 +
    kVecFloats * 4;
static_assert(2 * kFwdSmemBytes <= 227 * 1024, "two forward blocks an SM");
// the vector gradients within kVecFloats (the tail of the grads layout),
// and the vector parameters in the same places
constexpr int kVbo = 0, kVs1 = C, kVt1 = 2 * C, kVb1 = 3 * C,
              kVb2 = 3 * C + F, kVs2 = 4 * C + F, kVt2 = 5 * C + F;

// pass -> its first chunk; the weight it reads, whether as W^T ([N][K]
// as stored) or W ([K][N]), the row stride and the first output column
__constant__ int kPassStart[9] = {0, 2, 4, 6, 10, 12, 14, 18, 20};
static_assert(kFwdChunks == 10, "kPassStart[4]: the forward's chunks");

struct TileArgs {
  const __nv_bfloat16 *x, *attn, *dy, *wo, *bo, *w1, *b1, *w2, *b2;
  const float *s1, *t1, *s2, *t2;
  const int* nv;
  __nv_bfloat16 *dx, *dattn;
  __nv_bfloat16 *xm, *da1, *h, *dz2;   // workspace rows [B * V][K]
  float* vpartial;                     // [gridDim.x][kVecFloats]
  int B, V;
  float eps;
};

struct FwdArgs {
  const __nv_bfloat16 *x, *attn, *wo, *bo, *w1, *b1, *w2, *b2;
  const float *s1, *t1, *s2, *t2;
  const int* nv;
  __nv_bfloat16* y;
  int B, V;
  float eps;
};

struct PassW {
  const __nv_bfloat16* w;
  int ld, n0;
  bool trans;
};

// Args: TileArgs or FwdArgs (the weights wo, w1, w2)
template <class Args>
__device__ __forceinline__ PassW pass_weight(const Args& p, int pass) {
  switch (pass) {
    case 0: return {p.wo, C, 0, false};     // o = attn Wo
    case 1: return {p.w1, F, 0, false};     // a1 = xm W1, two halves
    case 2: return {p.w1, F, C, false};
    case 3: return {p.w2, C, 0, false};     // o2 = h W2
    case 4: return {p.w2, C, 0, true};      // dh = dz2 W2^T, two halves
    case 5: return {p.w2, C, C, true};
    case 6: return {p.w1, F, 0, true};      // da1 W1^T
    default: return {p.wo, C, 0, true};     // dattn = dz1 Wo^T
  }
}

__device__ __forceinline__ int pass_of(int q) {
  int pass = 0;
  while (kPassStart[pass + 1] <= q) ++pass;
  return pass;
}

// chunk q of the tile's stream into buf: W rows k0.. (cols n0..n0+127) or
// W^T's, i.e. W rows n0..n0+127, cols k0..; 1024 16-byte pieces
template <class Args>
__device__ __forceinline__ void load_chunk(const Args& p, int q,
                                           __nv_bfloat16* buf) {
  const int pass = pass_of(q);
  const PassW w = pass_weight(p, pass);
  const int k0 = (q - kPassStart[pass]) * kKc;
  for (int i = threadIdx.x; i < kKc * C / 8; i += kTileThreads) {
    if (w.trans) {
      const int r = i / (kKc / 8), c = (i % (kKc / 8)) * 8;
      cp_async_16(buf + r * (kKc + kPad) + c,
                  w.w + (size_t)(w.n0 + r) * w.ld + k0 + c);
    } else {
      const int r = i / (C / 8), c = (i % (C / 8)) * 8;
      cp_async_16(buf + r * kSC + c, w.w + (size_t)(k0 + r) * w.ld + w.n0 + c);
    }
  }
}

// acc += the warp's 16 rows of A (row stride lda, columns k0..k0+63) times
// the chunk in wb, over the warp's 64 output columns
__device__ __forceinline__ void chunk_product(float (&acc)[8][4],
                                              const __nv_bfloat16* A,
                                              int lda, int k0,
                                              const __nv_bfloat16* wb,
                                              bool trans) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nw = 64 * (warp % 2);             // the warp's columns
#pragma unroll
  for (int kk = 0; kk < kKc; kk += 16) {
    uint32_t af[4];
    ldmatrix_x4(af, A + (16 * (warp / 2) + lane % 16) * lda + k0 + kk +
                        (lane / 16) * 8);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bf[4];
      if (trans)
        ldmatrix_x4(bf, wb + (nw + j * 16 + lane % 8 + (lane / 16) * 8) *
                                 (kKc + kPad) +
                            kk + ((lane / 8) % 2) * 8);
      else
        ldmatrix_x4_trans(bf, wb + (kk + lane % 8 + ((lane / 8) % 2) * 8) *
                                       kSC +
                                  nw + j * 16 + (lane / 16) * 8);
      mma_bf16_16816(acc[2 * j], af, &bf[0]);
      mma_bf16_16816(acc[2 * j + 1], af, &bf[2]);
    }
  }
}

// One product pass of a tile: acc = A (row stride lda) times the pass's
// weight, over its chunks of the stream of kChunks a tile, through the ring
// of Ring buffers at s_w; cnt counts the chunks the block has consumed.
// Each chunk step waits for its chunk (at the tile's first also for the
// tile's rows, committed after the chunks in flight), frees the buffer of
// the chunk before it and prefetches the chunk Ring - 1 ahead, into the
// next tile's stream while the block has one (more_tiles).
template <int Ring, int kChunks, class Args>
__device__ __forceinline__ void product_pass(const Args& p, int pass,
                                             const __nv_bfloat16* A,
                                             int lda, bool more_tiles,
                                             __nv_bfloat16* s_w, int& cnt,
                                             float (&acc)[8][4]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  for (int q = kPassStart[pass]; q < kPassStart[pass + 1]; ++q, ++cnt) {
    if (q == 0) cp_async_wait<0>();
    else cp_async_wait<Ring - 2>();
    __syncthreads();               // chunk q landed; chunk q - 1 consumed
    const int ahead = q + Ring - 1;
    if (ahead < kChunks || more_tiles)
      load_chunk(p, ahead % kChunks,
                 s_w + ((cnt + Ring - 1) % Ring) * kChunkElems);
    cp_async_commit();
    chunk_product(acc, A, lda, (q - kPassStart[pass]) * kKc,
                  s_w + (cnt % Ring) * kChunkElems, pass >= 4);
  }
}

__device__ __forceinline__ float rbf(float v) {
  return round_t<__nv_bfloat16>(v);
}

__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// four consecutive values: bf16 in shared or device memory, f32 in shared
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = unpack_bf16(u.x), hi = unpack_bf16(u.y);
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}
__device__ __forceinline__ void ldf4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}

// The warp's accumulator tile (16 rows x 64 columns: rows 16 (warp / 2)..,
// columns 64 (warp % 2).. of the pass), rounded to bf16 (every consumer of
// a product rounds it first), into dst from column n0; the row-wise
// epilogue then reads the product a row at a time
__device__ __forceinline__ void stage(const float (&acc)[8][4],
                                      __nv_bfloat16* dst, int ld, int n0) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r = 16 * (warp / 2) + lane / 4;
  const int c = n0 + 64 * (warp % 2) + 2 * (lane % 4);
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    st2(dst + r * ld + c + nb * 8, acc[nb][0], acc[nb][1]);
    st2(dst + (r + 8) * ld + c + nb * 8, acc[nb][2], acc[nb][3]);
  }
  __syncthreads();               // the pair's halves, for the row loops
}

// The forward's row-wise steps on the lane's 4 columns of one row (the
// warp's lanes hold the row's 128 columns).  z = x + (o + b), given the
// staged product o in z and rounded at the forward's points, and the f32
// LayerNorm statistics of z over the row: mu, rs = 1 / sqrt(var + eps),
// var = E[z^2] - mu^2.
__device__ __forceinline__ void residual_stats(float (&z)[4],
                                               const float (&x)[4],
                                               const float (&b)[4],
                                               float eps, float& mu,
                                               float& rs) {
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    z[u] = rbf(x[u] + rbf(z[u] + b[u]));
    sum += z[u];
    sq += z[u] * z[u];
  }
  mu = warp_sum(sum) / C;
  rs = 1.f / sqrtf(warp_sum(sq) / C - mu * mu + eps);
}

// y = LayerNorm(z) with its statistics, scale s and bias t, rounded
__device__ __forceinline__ void ln_out(const float (&z)[4], float mu,
                                       float rs, const float (&s)[4],
                                       const float (&t)[4], float (&y)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) y[u] = rbf((z[u] - mu) * rs * s[u] + t[u]);
}

// a1 = a1 + b (given the staged product in a1), h = gelu(a1), 0 where the
// row is not real
__device__ __forceinline__ void bias_gelu(float (&a1)[4], const float (&b)[4],
                                          bool real, float (&h)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    a1[u] = rbf(a1[u] + b[u]);
    h[u] = real ? rbf(gelu(a1[u])) : 0.f;
  }
}

// The vector parameters into s_par (the kV* places) as f32
template <class Args>
__device__ __forceinline__ void load_vector_params(const Args& p,
                                                   float* s_par) {
  for (int i = threadIdx.x; i < C; i += kTileThreads) {
    s_par[kVbo + i] = to_f(p.bo[i]);
    s_par[kVs1 + i] = p.s1[i];
    s_par[kVt1 + i] = p.t1[i];
    s_par[kVb2 + i] = to_f(p.b2[i]);
    s_par[kVs2 + i] = p.s2[i];
    s_par[kVt2 + i] = p.t2[i];
  }
  for (int i = threadIdx.x; i < F; i += kTileThreads)
    s_par[kVb1 + i] = to_f(p.b1[i]);
}

// The bf16 forward: passes 0-3 of the tile pass and their epilogues.  Its
// shared memory (109,568 bytes: attn then xm, x then o2, o then a1 and h
// over it, a two-buffer weight ring, the vector parameters) lets two blocks
// share an SM, so one block's row-wise work overlaps the other's products.
__global__ void __launch_bounds__(kTileThreads, 2)
post_attention_fwd_tc_kernel(FwdArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_x = s_a + kTT * kSC;       // x, then o2 (pass 3)
  __nv_bfloat16* s_h = s_x + kTT * kSC;       // o (pass 0), then a1 and h
  __nv_bfloat16* s_w = s_h + kTT * kSF;       // the weight chunk ring
  float* s_par = reinterpret_cast<float*>(s_w + kFwdRing * kChunkElems);
  // s_a: attn, then xm (over attn, pass 0)

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = 4 * lane;        // the lane's columns in the row loops
  load_vector_params(p, s_par);

  const int tiles_per_row = (p.V + kTT - 1) / kTT;
  const int tiles = p.B * tiles_per_row;
  for (int q = 0; q < kFwdRing - 1; ++q) {      // the stream's first chunks
    if ((int)blockIdx.x < tiles) load_chunk(p, q, s_w + q * kChunkElems);
    cp_async_commit();
  }
  int cnt = 0;                                  // chunks consumed

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_row;
    const int r0 = (tile - b * tiles_per_row) * kTT;
    const int nr = min(kTT, min(p.V, p.nv[b]) - r0);   // real rows
    const int rows = min(kTT, p.V - r0);                // rows inside V
    const size_t row0 = (size_t)b * p.V + r0;
    if (nr <= 0) {                // past nv: zeros; the ring stays as it is
      const uint2 zero = make_uint2(0u, 0u);
      for (int i = threadIdx.x; i < rows * C / 4; i += kTileThreads)
        reinterpret_cast<uint2*>(p.y + row0 * C)[i] = zero;
      continue;
    }
    __syncthreads();              // the previous tile's rows are consumed
    for (int i = threadIdx.x; i < kTT * C / 8; i += kTileThreads) {
      const int r = i / (C / 8), k = (i % (C / 8)) * 8;
      const size_t g = (row0 + (r < nr ? r : 0)) * C + k;
      cp_async_16(s_a + r * kSC + k, p.attn + g, r < nr);
      cp_async_16(s_x + r * kSC + k, p.x + g, r < nr);
    }
    cp_async_commit();
    const bool more = tile + (int)gridDim.x < tiles;

    float acc[8][4];
    float par[3][4];
    // o = attn Wo; z = x + (o + bo); xm = LN1(z), over attn
    product_pass<kFwdRing, kFwdChunks>(p, 0, s_a, kSC, more, s_w, cnt, acc);
    stage(acc, s_h, kSF, 0);
    ldf4(s_par + kVbo + c, par[0]);
    ldf4(s_par + kVs1 + c, par[1]);
    ldf4(s_par + kVt1 + c, par[2]);
#pragma unroll 2
    for (int i = 0; i < kWarpRows; ++i) {
      const int r = kWarpRows * warp + i;
      float z[4], x[4], xm[4], mu, rs;
      ld4(s_h + r * kSF + c, z);
      ld4(s_x + r * kSC + c, x);            // 0 on rows not real
      residual_stats(z, x, par[0], p.eps, mu, rs);
      ln_out(z, mu, rs, par[1], par[2], xm);
      st4(s_a + r * kSC + c, xm);
    }
    // a1 = xm W1 + b1, h = gelu(a1), in two halves of 128 columns
    for (int pass = 1; pass <= 2; ++pass) {
      const int n0 = pass_weight(p, pass).n0;
      product_pass<kFwdRing, kFwdChunks>(p, pass, s_a, kSC, more, s_w, cnt,
                                         acc);
      stage(acc, s_h, kSF, n0);
      ldf4(s_par + kVb1 + n0 + c, par[0]);
#pragma unroll 2
      for (int i = 0; i < kWarpRows; ++i) {
        const int r = kWarpRows * warp + i;
        float a1[4], h[4];
        ld4(s_h + r * kSF + n0 + c, a1);
        bias_gelu(a1, par[0], r < nr, h);
        st4(s_h + r * kSF + n0 + c, h);
      }
    }
    // o2 = h W2; z2 = xm + (o2 + b2); y = LN2(z2), written out
    product_pass<kFwdRing, kFwdChunks>(p, 3, s_h, kSF, more, s_w, cnt, acc);
    stage(acc, s_x, kSC, 0);                  // x was consumed in pass 0
    ldf4(s_par + kVb2 + c, par[0]);
    ldf4(s_par + kVs2 + c, par[1]);
    ldf4(s_par + kVt2 + c, par[2]);
#pragma unroll 2
    for (int i = 0; i < kWarpRows; ++i) {
      const int r = kWarpRows * warp + i;
      float z2[4], xm[4], y[4], mu, rs;
      ld4(s_x + r * kSC + c, z2);
      ld4(s_a + r * kSC + c, xm);
      residual_stats(z2, xm, par[0], p.eps, mu, rs);
      ln_out(z2, mu, rs, par[1], par[2], y);
      if (r >= nr) y[0] = y[1] = y[2] = y[3] = 0.f;
      if (r < rows) st4(p.y + (row0 + r) * C + c, y);
    }
  }
  cp_async_wait<0>();            // chunks prefetched for no tile
}

__global__ void __launch_bounds__(kTileThreads, 1)
post_attention_bwd_tile_kernel(TileArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_b0 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_z = s_b0 + kTT * kSC;      // z = x + o
  __nv_bfloat16* s_dz2 = s_z + kTT * kSC;     // x, then dz2 (pass 3)
  __nv_bfloat16* s_dy = s_dz2 + kTT * kSC;    // dy
  __nv_bfloat16* s_a1 = s_dy + kTT * kSC;     // a1, then da1
  __nv_bfloat16* s_h = s_a1 + kTT * kSF;      // h = gelu(a1)
  __nv_bfloat16* s_w = s_h + kTT * kSF;       // the weight chunk ring
  float* s_par = reinterpret_cast<float*>(s_w + kRing * kChunkElems);
  float* s_stat = s_par + kVecFloats;         // LN1 (mu, rs) per row
  // s_b0: attn, then xm (over attn, pass 0), then dz1 (pass 6)

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = 4 * lane;        // the lane's columns in the row loops
  // the lane's columns of the vector gradients over all its rows: bo, s1,
  // t1, b1 (two halves), b2, s2, t2
  float vs[8][4] = {};
  constexpr int kBo = 0, kS1 = 1, kT1 = 2, kB1 = 3, kB2 = 5, kS2 = 6, kT2 = 7;
  load_vector_params(p, s_par);

  const int tiles_per_row = (p.V + kTT - 1) / kTT;
  const int tiles = p.B * tiles_per_row;
  for (int q = 0; q < kRing - 1; ++q) {         // the stream's first chunks
    if ((int)blockIdx.x < tiles) load_chunk(p, q, s_w + q * kChunkElems);
    cp_async_commit();
  }
  int cnt = 0;                                  // chunks consumed

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_row;
    const int r0 = (tile - b * tiles_per_row) * kTT;
    const int nr = min(kTT, min(p.V, p.nv[b]) - r0);   // real rows
    const int rows = min(kTT, p.V - r0);                // rows inside V
    const size_t row0 = (size_t)b * p.V + r0;
    if (nr <= 0) {                // past nv: zero outputs and workspace
      for (int i = threadIdx.x; i < rows * C; i += kTileThreads) {
        const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
        p.dx[row0 * C + i] = zero;
        p.dattn[row0 * C + i] = zero;
        p.xm[row0 * C + i] = zero;
        p.dz2[row0 * C + i] = zero;
        p.da1[row0 * F + i] = zero;
        p.da1[row0 * F + rows * C + i] = zero;
        p.h[row0 * F + i] = zero;
        p.h[row0 * F + rows * C + i] = zero;
      }
      continue;
    }
    __syncthreads();              // the previous tile's rows are consumed
    for (int i = threadIdx.x; i < kTT * C / 8; i += kTileThreads) {
      const int r = i / (C / 8), k = (i % (C / 8)) * 8;
      const size_t g = (row0 + (r < nr ? r : 0)) * C + k;
      cp_async_16(s_b0 + r * kSC + k, p.attn + g, r < nr);
      cp_async_16(s_dz2 + r * kSC + k, p.x + g, r < nr);
      cp_async_16(s_dy + r * kSC + k, p.dy + g, r < nr);
    }
    cp_async_commit();
    const bool more = tile + (int)gridDim.x < tiles;

    float acc[8][4];
    for (int pass = 0; pass < 8; ++pass) {
      // this pass's A rows: attn, xm, xm, h, dz2, dz2, da1, dz1
      const __nv_bfloat16* A;
      int lda;
      if (pass == 3) { A = s_h; lda = kSF; }
      else if (pass == 6) { A = s_a1; lda = kSF; }
      else if (pass == 4 || pass == 5) { A = s_dz2; lda = kSC; }
      else { A = s_b0; lda = kSC; }
      product_pass<kRing, kTileChunks>(p, pass, A, lda, more, s_w, cnt, acc);

      // ---- the pass's epilogue: the product staged in shared memory, then
      // a loop over the warp's 8 rows with the lanes across 128 columns (4
      // each).  Compact code: fully unrolled epilogues in fragment order
      // were several times slower.
      const int n0 = pass_weight(p, pass).n0;
      float par[3][4];
      if (pass == 0) {          // z = x + (o + bo); xm = LN1(z)
        stage(acc, s_z, kSC, 0);
        ldf4(s_par + kVbo + c, par[0]);
        ldf4(s_par + kVs1 + c, par[1]);
        ldf4(s_par + kVt1 + c, par[2]);
#pragma unroll 2
        for (int i = 0; i < kWarpRows; ++i) {
          const int r = kWarpRows * warp + i;
          float z[4], x[4], xm[4], mu, rs;
          ld4(s_z + r * kSC + c, z);
          ld4(s_dz2 + r * kSC + c, x);          // 0 on rows not real
          residual_stats(z, x, par[0], p.eps, mu, rs);
          st4(s_z + r * kSC + c, z);
          if (lane == 0) {
            s_stat[2 * r] = mu;
            s_stat[2 * r + 1] = rs;
          }
          ln_out(z, mu, rs, par[1], par[2], xm);
          st4(s_b0 + r * kSC + c, xm);           // over attn
          if (r < rows) {
            if (r >= nr) xm[0] = xm[1] = xm[2] = xm[3] = 0.f;
            st4(p.xm + (row0 + r) * C + c, xm);
          }
        }
      } else if (pass <= 2) {   // a1 = xm W1 + b1; h = gelu(a1)
        stage(acc, s_a1, kSF, n0);
        ldf4(s_par + kVb1 + n0 + c, par[0]);
#pragma unroll 2
        for (int i = 0; i < kWarpRows; ++i) {
          const int r = kWarpRows * warp + i;
          float a1[4], h[4];
          ld4(s_a1 + r * kSF + n0 + c, a1);
          bias_gelu(a1, par[0], r < nr, h);
          st4(s_a1 + r * kSF + n0 + c, a1);
          st4(s_h + r * kSF + n0 + c, h);
          if (r < rows) st4(p.h + (row0 + r) * F + n0 + c, h);
        }
      } else if (pass == 3) {   // z2 = xm + (h W2 + b2); LN2 backward
        stage(acc, s_dz2, kSC, 0);              // x was consumed in pass 0
        ldf4(s_par + kVb2 + c, par[0]);
        ldf4(s_par + kVs2 + c, par[1]);
#pragma unroll 2
        for (int i = 0; i < kWarpRows; ++i) {
          const int r = kWarpRows * warp + i;
          float z2[4], xm[4], dy[4], mu, rs;
          ld4(s_dz2 + r * kSC + c, z2);
          ld4(s_b0 + r * kSC + c, xm);
          ld4(s_dy + r * kSC + c, dy);          // 0 on rows not real
          residual_stats(z2, xm, par[0], p.eps, mu, rs);
          float sg = 0.f, sgx = 0.f;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            z2[u] = (z2[u] - mu) * rs;            // xhat
            sg += dy[u] * par[1][u];
            sgx += dy[u] * par[1][u] * z2[u];
          }
          const float mg = warp_sum(sg) / C, mgx = warp_sum(sgx) / C;
          float dz[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            dz[u] = r < nr ? rbf(rs * (dy[u] * par[1][u] - mg - z2[u] * mgx))
                           : 0.f;
            vs[kS2][u] += dy[u] * z2[u];
            vs[kT2][u] += dy[u];
            vs[kB2][u] += dz[u];
          }
          st4(s_dz2 + r * kSC + c, dz);
          if (r < rows) st4(p.dz2 + (row0 + r) * C + c, dz);
        }
      } else if (pass <= 5) {   // da1 = (dz2 W2^T) gelu'(a1), over a1
        stage(acc, s_h, kSF, n0);               // h was consumed in pass 3
#pragma unroll 2
        for (int i = 0; i < kWarpRows; ++i) {
          const int r = kWarpRows * warp + i;
          float dh[4], a1[4];
          ld4(s_h + r * kSF + n0 + c, dh);
          ld4(s_a1 + r * kSF + n0 + c, a1);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            a1[u] = r < nr ? rbf(dh[u] * dgelu(a1[u])) : 0.f;
            if (pass == 4) vs[kB1][u] += a1[u];   // a static index: registers
            else vs[kB1 + 1][u] += a1[u];
          }
          st4(s_a1 + r * kSF + n0 + c, a1);
          if (r < rows) st4(p.da1 + (row0 + r) * F + n0 + c, a1);
        }
      } else if (pass == 6) {   // dxm = dz2 + da1 W1^T; LN1 backward
        stage(acc, s_b0, kSC, 0);               // xm was consumed in pass 3
        ldf4(s_par + kVs1 + c, par[1]);
#pragma unroll 2
        for (int i = 0; i < kWarpRows; ++i) {
          const int r = kWarpRows * warp + i;
          float d[4], dz2[4], z[4];
          ld4(s_b0 + r * kSC + c, d);
          ld4(s_dz2 + r * kSC + c, dz2);
          ld4(s_z + r * kSC + c, z);
          const float mu = s_stat[2 * r], rs = s_stat[2 * r + 1];
          float sg = 0.f, sgx = 0.f;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            d[u] = r < nr ? rbf(dz2[u] + d[u]) : 0.f;   // dxm
            z[u] = (z[u] - mu) * rs;                     // xhat
            sg += d[u] * par[1][u];
            sgx += d[u] * par[1][u] * z[u];
          }
          const float mg = warp_sum(sg) / C, mgx = warp_sum(sgx) / C;
          float dz[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            dz[u] = r < nr ? rbf(rs * (d[u] * par[1][u] - mg - z[u] * mgx))
                           : 0.f;
            vs[kS1][u] += d[u] * z[u];
            vs[kT1][u] += d[u];
            vs[kBo][u] += dz[u];
          }
          st4(s_b0 + r * kSC + c, dz);            // dz1, A of pass 7
          if (r < rows) st4(p.dx + (row0 + r) * C + c, dz);
        }
      } else {                  // dattn = dz1 Wo^T, from the fragments
        const int g = lane / 4, t = lane % 4;
        const int nw = 64 * (warp % 2);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * (warp / 2) + g + 8 * h;
            if (r < rows)
              st2(p.dattn + (row0 + r) * C + nw + nb * 8 + 2 * t,
                  r < nr ? acc[nb][2 * h] : 0.f,
                  r < nr ? acc[nb][2 * h + 1] : 0.f);
          }
      }
    }
  }
  // the warps' column sums, added in warp order (the tiles' rows are
  // consumed: s_a1 onwards holds [kTileWarps][kVecFloats] f32)
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(s_a1) + warp * kVecFloats;
  const int off[8] = {kVbo, kVs1, kVt1, kVb1, kVb1 + C, kVb2, kVs2, kVt2};
#pragma unroll
  for (int v = 0; v < 8; ++v)
#pragma unroll
    for (int u = 0; u < 4; ++u) red[off[v] + c + u] = vs[v][u];
  __syncthreads();
  for (int i = threadIdx.x; i < kVecFloats; i += kTileThreads) {
    float sum = 0.f;
    for (int w = 0; w < kTileWarps; ++w)
      sum += reinterpret_cast<float*>(s_a1)[w * kVecFloats + i];
    p.vpartial[(size_t)blockIdx.x * kVecFloats + i] = sum;
  }
}

cudaError_t launch_f32(const void* x, const void* attn, const void* wo,
                       const void* bo, const float* s1, const float* t1,
                       const void* w1, const void* b1, const void* w2,
                       const void* b2, const float* s2, const float* t2,
                       const int* nv, void* y, int B, int V, float eps,
                       cudaStream_t stream) {
  using f = const float*;
  cudaError_t e = allow_smem(post_attention_kernel, kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((V + TT - 1) / TT, B);
  post_attention_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<f>(x), static_cast<f>(attn), static_cast<f>(wo),
      static_cast<f>(bo), s1, t1, static_cast<f>(w1), static_cast<f>(b1),
      static_cast<f>(w2), static_cast<f>(b2), s2, t2, nv,
      static_cast<float*>(y), V, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const BwdArgs& args, float* grads, int nblocks,
                       cudaStream_t stream) {
  cudaError_t e = allow_smem(post_attention_bwd_kernel<T>, kBwdSmemBytes);
  if (e != cudaSuccess) return e;
  post_attention_bwd_kernel<T><<<nblocks, kThreads, kBwdSmemBytes, stream>>>(
      args);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return sum_partials(args.partial, nblocks, kGradFloats, grads, stream);
}

cudaError_t launch_fwd_tc(const FwdArgs& a, cudaStream_t stream) {
  cudaError_t e = allow_smem(post_attention_fwd_tc_kernel, kFwdSmemBytes);
  if (e != cudaSuccess) return e;
  static int resident[kMaxDevices] = {};
  int blocks;
  e = persistent_grid(post_attention_fwd_tc_kernel, kTileThreads,
                      kFwdSmemBytes, a.B * ((a.V + kTT - 1) / kTT), resident,
                      &blocks);
  if (e != cudaSuccess) return e;
  post_attention_fwd_tc_kernel<<<blocks, kTileThreads, kFwdSmemBytes,
                                 stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_wgrad(const WgradArgs& w, int chunks, float* grads,
                         cudaStream_t stream) {
  const int tiles = (F / kWgTile) * (C / kWgTile);     // the most of the three
  wgrad_kernel<<<dim3(chunks, tiles, 3), kWgThreads, 0, stream>>>(w);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return sum_partials(w.partial, chunks, kWeightFloats, grads, stream);
}

WgradArgs wgrad_args(const void* attn, const void* dx, const void* xm,
                     const void* da1, const void* h, const void* dz2,
                     const int* nv, float* partial, int B, int V) {
  using bf = __nv_bfloat16;
  return WgradArgs{{static_cast<const bf*>(attn), static_cast<const bf*>(xm),
                    static_cast<const bf*>(h)},
                   {static_cast<const bf*>(dx), static_cast<const bf*>(da1),
                    static_cast<const bf*>(dz2)},
                   nv, partial, B, V};
}

cudaError_t launch_bwd_bf16(const TileArgs& t, const WgradArgs& w,
                            int nblocks, int chunks, float* grads,
                            cudaStream_t stream) {
  cudaError_t e = allow_smem(post_attention_bwd_tile_kernel, kTileSmemBytes);
  if (e != cudaSuccess) return e;
  post_attention_bwd_tile_kernel<<<nblocks, kTileThreads, kTileSmemBytes,
                                   stream>>>(t);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_wgrad(w, chunks, grads, stream);
  if (e != cudaSuccess) return e;
  return sum_partials(t.vpartial, nblocks, kVecFloats, grads + kWeightFloats,
                      stream);
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
    return launch_f32(x, attn, wo, bo, s1, t1, w1, b1, w2, b2, s2, t2, nv, y,
                      B, V, eps, s);
  if (dtype != kBFloat16) return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  const FwdArgs a{static_cast<const bf*>(x),  static_cast<const bf*>(attn),
                  static_cast<const bf*>(wo), static_cast<const bf*>(bo),
                  static_cast<const bf*>(w1), static_cast<const bf*>(b1),
                  static_cast<const bf*>(w2), static_cast<const bf*>(b2),
                  s1, t1, s2, t2, nv, static_cast<bf*>(y), B, V, eps};
  return launch_fwd_tc(a, s);
}

// Backward of geomae_post_attention_block.  dy [B, V, 128] and the
// forward's inputs; woT [128, 128], w1T [256, 128], w2T [128, 256] the
// weights transposed (compute dtype).  Writes dx, dattn [B, V, 128]
// (compute dtype) and grads [kGradFloats] f32 (layout above).  partial:
// zeroed f32 [nblocks, kGradFloats]; nblocks is the persistent grid.
int geomae_post_attention_block_bwd(
    int dtype, const void* x, const void* attn, const void* dy,
    const void* wo, const void* bo, const float* s1, const float* t1,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const float* s2, const float* t2, const void* woT, const void* w1T,
    const void* w2T, const int* nv, void* dx, void* dattn, float* partial,
    float* grads, int B, int V, float eps, int nblocks, void* stream) {
  using namespace geomae;
  const BwdArgs args{x,  attn, dy, wo, bo, w1,    b1,      w2, b2, woT, w1T,
                     w2T, s1, t1, s2, t2, nv, dx, dattn, partial, B, V, eps};
  if (dtype != kFloat32) return cudaErrorInvalidValue;  // bf16: below
  return launch_bwd<float>(args, grads, nblocks,
                           static_cast<cudaStream_t>(stream));
}

// The bf16 backward of geomae_post_attention_block on the tensor cores,
// with the arguments and outputs of geomae_post_attention_block_bwd (the
// weights as given, not transposed) and bf16 workspace rows xm [B * V,
// 128], da1 [B * V, 256], h [B * V, 256], dz2 [B * V, 128]; vpartial f32
// [nblocks, 1024] (nblocks: the per-tile pass's persistent grid),
// partial f32 [ceil(B * V / 2048), 81920]; both are written whole.
int geomae_post_attention_block_bwd_bf16(
    const void* x, const void* attn, const void* dy, const void* wo,
    const void* bo, const float* s1, const float* t1, const void* w1,
    const void* b1, const void* w2, const void* b2, const float* s2,
    const float* t2, const int* nv, void* dx, void* dattn, void* xm,
    void* da1, void* h, void* dz2, float* vpartial, float* partial,
    float* grads, int B, int V, float eps, int nblocks, void* stream) {
  using namespace geomae;
  using bf = __nv_bfloat16;
  const TileArgs t{
      static_cast<const bf*>(x),  static_cast<const bf*>(attn),
      static_cast<const bf*>(dy), static_cast<const bf*>(wo),
      static_cast<const bf*>(bo), static_cast<const bf*>(w1),
      static_cast<const bf*>(b1), static_cast<const bf*>(w2),
      static_cast<const bf*>(b2), s1, t1, s2, t2, nv,
      static_cast<bf*>(dx), static_cast<bf*>(dattn), static_cast<bf*>(xm),
      static_cast<bf*>(da1), static_cast<bf*>(h), static_cast<bf*>(dz2),
      vpartial, B, V, eps};
  const int chunks = (B * V + kWgChunk - 1) / kWgChunk;
  return launch_bwd_bf16(
      t, wgrad_args(attn, dx, xm, da1, h, dz2, nv, partial, B, V), nblocks,
      chunks, grads, static_cast<cudaStream_t>(stream));
}

// The weight-gradient pass alone: grads [81920] f32 = (dWo, dW1, dW2) from
// the bf16 rows attn, dx [B * V, 128], xm [.., 128], da1 [.., 256], h
// [.., 256], dz2 [.., 128]; partial f32 [ceil(B * V / 2048), 81920].
int geomae_post_attention_wgrad_bf16(const void* attn, const void* dx,
                                     const void* xm, const void* da1,
                                     const void* h, const void* dz2,
                                     const int* nv, float* partial,
                                     float* grads, int B, int V,
                                     void* stream) {
  using namespace geomae;
  return launch_wgrad(wgrad_args(attn, dx, xm, da1, h, dz2, nv, partial, B, V),
                      (B * V + kWgChunk - 1) / kWgChunk, grads,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
