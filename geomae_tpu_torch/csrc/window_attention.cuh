// K6 band_attention_qkv: window attention with the q/k/v projections
// inside, forward (K6) and backward (K7): the kernels.
//
// Replaces geomae_tpu/ops/pallas_attention_qkv.py: band_attention_qkv
// (_pallas_forward / _fwd_kernel) and its backward, which the JAX package
// computes either in one pass (_pallas_backward_merged) or in two
// (_pallas_backward_split: _dq_kernel, _dkv_kernel).  Per token, over
// window-sorted tokens:
//   q = (x + pos) Wq + bq,  k = (x + pos) Wk + bk,  v = x Wv + bv
//   out_h = softmax(q_h k_h^T / sqrt(D) + mask) v_h   for each head h
// where a key is visible when it lies in the query's window and
// key_valid is set.  Rows with win_id == INT32_MAX (padding) and rows
// with no visible key return exactly 0.  The projections keep the JAX
// dtype points (pallas_attention_qkv._proj): x + pos rounded to the
// compute dtype, f32 accumulation, the product rounded, then the bias
// added in the compute dtype.
//
// Widths: C (channels) of 128, 256, 384 or 512 in heads of D = 1, 2, 4,
// 8, 16, 32, 64 or 128, C 384 in heads of 3, 6, 12, 24, 48, 96 or 192, C
// 256 and 512 in heads of 256, C 384 and 512 in one head, and C 640, 768
// and 1024 in heads of 8, 16, 32, 64 or 128, the widths K8 takes.
// Every kernel is a template over C (the f32 ones over C and D); each C
// is a translation unit of its own
// (window_attention_c*.cu, compiled in parallel; the wide C's table of
// head widths in window_attention_wide.cuh), and the entry points
// (window_attention.cu) pick the unit by C and the instantiation by D.
// At the shipped width (128 in 8 heads of 16) each is the kernel it was
// before the widths.  The scale 1/sqrt(D) is a power of two at D = 1, 4,
// 16, 64 and 256 (D a power of four), and JAX folds it into q there
// (_scale_pow2); at D = 2, 3, 6, 8, 12, 24, 32, 48, 96, 128, 192, 384 and
// 512 it multiplies the f32 score, and dq and dk after their f32 sums.
// Both give the same numbers where the fold is exact, so the kernels below
// keep each JAX dtype point.
//
// bfloat16, on the tensor cores: the projections and the attention are
// separate launches.  The TPU kernel projects each key inside the
// attention, once for every query tile whose band holds it (2-5 times);
// here qkv_project_kernel projects every token once, and K8's bf16
// kernels (csrc/band_attention.cuh, reached through their C entry points)
// run the attention on the projected rows.  Their dtype points are K6's:
// K8 multiplies the f32 score by 1/sqrt(D), which at D = 16 and 64 equals
// K6's score of q folded by that power of two (and at D = 1, 4 and 256),
// and at D = 32 is K6's own point (and D = 2's, 3's, 6's, 12's, 24's,
// 48's, 96's and 192's);
// ds and p are
// rounded before their
// products, dq, dk and dv once,
// dq and dk scaled after the f32 sum.  So qkv_project never folds the
// scale.  The one difference: K8's forward rounds P against the running
// max of each 64-key chunk, the CUDA-core K6 against its running max at
// each key.
//   forward:  qkv_project_kernel, then K8's forward (with lse under grad);
//   backward: qkv_project_kernel again (q, k, v are not kept), K8's D
//             prologue and backward (dq, dk, dv), then
//             qkv_project_dx_kernel (dx = rt(rt(dq Wq^T) + rt(dk Wk^T +
//             dv Wv^T))) and qkv_wgrad_kernel ((x+pos)^T dq, (x+pos)^T dk,
//             x^T dv and the bias sums, split over row chunks, the chunk
//             partials summed in order by sum_partials).
// All products run on mma.sync m16n8k16 (bf16 in, f32 accumulate;
// mma.cuh).  Bound: bytes (the weights stay in shared memory): the
// projections move 10 C bytes a token (x and pos read, q, k, v written),
// their backward's two kernels about 18 C (dq, dk, dv read by both, x and
// pos, dx written); at C 512 their 6 C^2 and 12 C^2 operations a token
// are level with the bytes or above them, and above it the operations
// bound them.  Above C 512 the projections and dx stream their
// contraction (qkv_project_stream_kernel, qkv_project_dx_stream_kernel):
// a slice's weights no longer fit beside a tile.
//
// float32, on the CUDA cores (band_attention_qkv_kernel and
// band_attention_qkv_bwd_kernel, first below): the projections stay
// inside the attention (tensor cores take no f32 operand without TF32
// rounding).  Blocks of 256 threads up to C 256, of C / 2 at C 384 and
// 512 (no tile of whole lane groups fills 256 threads there: C 384 has 24
// lanes a token, 48 at D 8, and 512 threads of up to 255 registers
// overrun the register file), of C / 4 at C 640, 768 and 1024; TQ tokens
// a tile, one lane group a (token, head): TQ = 4096 / C up to C 256, 8 at
// C 384 and 512, 4 above (at D = 8, where a lane keeps a whole head, half
// of that; 6 at C 384 in heads of 12, 24,
// 48, 96, 192 or 384, 32 lanes a token of 12 channels each; 8 at C 512 in
// one head, 32 lanes of 16).  Below 8 one lane keeps several whole heads
// (F32W::HL: 8 channels of heads of 1, 2 or 4, 12 of heads of 3 or 6), so
// a tile holds D = 8's or D = 12's tokens and a lane its float4s, with a
// running max, sum, statistics and D per head.  The projections give each
// thread CPT columns and RPT rows of a chunk: one column up to C 256 (256
// / C row groups), two at C 384 and 512, four above.
//
// f32 forward (K6): per TQ-query tile the block projects the tile's
// queries once and the keys of every window the tile touches (about 2-5x
// the tile in keys, since a 12x12 window holds up to 144 tokens; more at
// the 8-token tiles of C 384 and 512 and the 4-token tiles above), 2*C*C
// FLOPs per projected row; scores and the value sum add about 4*C FLOPs
// per (query, key) pair of one window.  The block finds the exact key
// range [first token of the first query's window, last token of the last
// query's window) by binary search in the sorted window ids, so no key
// outside the tile's windows is projected and no window size is too big:
// keys stream through shared memory in chunks of TQ with an online
// softmax, which holds any window exactly.  A (query, head) pair belongs
// to S = D / 16 adjacent lanes (one at D = 8, D / 12 at D = 12, 24, 48,
// 96, 192 and 384: a power of two, a whole warp at D = 384 and 512), each
// keeping 16 channels (8 at D = 8, 12 at D = 12 to 384) of the q row and
// of the accumulator in
// registers (16 wide, as one thread did at D = 16);
// a score is their partial dot products summed across the S lanes by
// shuffles, so every lane of the group holds the same score.  Under grad
// the forward also writes each (row, head)'s log-sum-exp of the scores,
// lse = m + log(l), for the backward (the TPU keeps m and l).
//
// f32 backward (K7), one kernel for both JAX variants: a block takes a
// tile of TQ tokens, which are queries AND keys, and walks the same exact
// key range as the forward, recomputing q, k and v of each TQ-token
// chunk.  For a tile token i and a chunk token j of its window, with
// p = exp(s - lse) and D = rowsum(dO * O) per (row, head):
//   as query:  ds = p (dO_i . v_j - D_i);  dq_i += ds k_j
//   as key:    dv_j += p dO_i;  ds = p (dO_i . v_j - D_i);  dk_j += ds q_i
// so the key side, a scatter across query tiles on the TPU, is a gather
// here: every key's dk and dv are complete when its tile's loop ends.
// Then dx = dq Wq^T + (dk Wk^T + dv Wv^T) projected inside the kernel, and the
// weight products (x+pos)^T dq, (x+pos)^T dk, x^T dv with the bias sums
// added to a per-block f32 partial (common.cuh), summed in a second pass.
// The lanes of a (token, head) split its channels as in the forward: 16
// (8 at D = 8, 12 at D = 12 to 384) of q, k, v, dO, dq, dk and dv
// each a lane (250-255 registers at the widths of D 16 to 64, one block an
// SM).
#pragma once

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace geomae {

using bf16 = __nv_bfloat16;

// The kernels' arguments, which the entry points (window_attention.cu)
// fill: the f32 backward's, the bf16 projections', their dx kernel's and
// their weight-gradient kernel's.
struct BwdArgs {
  const void *x, *pos, *wq, *bq, *wk, *bk, *wv, *bv;
  const void *wqT, *wkT, *wvT;   // the weights transposed, for dx
  const void *out, *dout;        // the forward's output and its cotangent
  const int* win;
  const uint8_t* key_valid;
  const float* lse;              // [B, V, H] from the forward
  void* dx;
  float* partial;                // [gridDim.x][kGradFloats], zeroed
  int B, V;
};
struct ProjArgs {
  const bf16 *x, *pos, *wq, *bq, *wk, *bk, *wv, *bv;
  const int* win;
  bf16 *q, *k, *v;
  int rows;                              // B * V
};
struct DxArgs {
  const bf16 *wq, *wk, *wv, *dq, *dk, *dv;
  bf16* dx;
  int rows;
};
struct QwArgs {
  const bf16 *x, *pos, *dq, *dk, *dv;
  float* partial;                        // [chunks][3 C C + 3 C]
  int rows;
  int chunk_rows;                        // a multiple of kQwRows
};

// The f32 kernels of one width (C, D): the forward (with the log-sum-exp
// where lse is not null) and the backward (with its partials' sum).
struct QkvF32Kernels {
  cudaError_t (*forward)(const void* x, const void* pos, const void* wq,
                         const void* bq, const void* wk, const void* bk,
                         const void* wv, const void* bv, const int* win,
                         const uint8_t* key_valid, void* out, float* lse,
                         int B, int V, cudaStream_t s);
  cudaError_t (*backward)(const BwdArgs& args, float* grads, int nblocks,
                          cudaStream_t s);
};
// The bf16 projections of one C: q, k, v, and their backward (dx, then
// the weight gradients over `chunks` row chunks and the chunks' sum).
struct QkvProjKernels {
  cudaError_t (*project)(const ProjArgs& a, cudaStream_t s);
  cudaError_t (*backward)(const DxArgs& d, const QwArgs& w, int chunks,
                          float* grads, cudaStream_t s);
};

// one pair per C, each in its translation unit: the f32 kernels of head
// width D (null for a D the kernels do not take) and the projections
const QkvF32Kernels* qkv_f32_c128(int D);
const QkvF32Kernels* qkv_f32_c256(int D);
const QkvF32Kernels* qkv_f32_c384(int D);
const QkvF32Kernels* qkv_f32_c512(int D);
const QkvProjKernels* qkv_proj_c128();
const QkvProjKernels* qkv_proj_c256();
const QkvProjKernels* qkv_proj_c384();
const QkvProjKernels* qkv_proj_c512();

namespace {

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

// The f32 kernels' shapes at C channels in heads of D.
template <int C, int D>
struct F32W {
  // a block: 256 threads up to C 256, C / 2 at 384 and 512, C / 4 at 640,
  // 768 and 1024 (160, 192 and 256: C / 2 threads of up to 255 registers
  // would need 81,600 to 130,560 of an SM's 65,536)
  static constexpr int kThreads = C <= 256 ? 256 : C <= 512 ? C / 2 : C / 4;
  static constexpr int H = C / D;              // heads
  // heads a lane (one; below 8 the whole heads of 8 or 12 channels,
  // common.cuh), channels a lane (16, all 8 at D = 8, 12 at D = 12 to
  // 384; HL whole heads below 8: 8 at D = 1, 2 and 4, 12 at D = 3 and 6)
  // and lanes a (token, head), a power of two (common.cuh)
  static constexpr int HL = f32_lane_heads(D);
  static constexpr int HD = f32_lane_channels(D);   // a lane's of a head
  static constexpr int LC = HL * HD;
  static constexpr int S = D / HD;
  // tokens a tile: 4096 / C up to C 256, 8 at C 384 and 512, 4 at C 640
  // to 1024; half that at D = 8 (and at D = 1, 2 and 4); 6 at D = 12, 24,
  // 48, 96, 192 and 384 (32 lanes a token, as at D = 8 up to C 256; and at
  // D = 3 and 6), 8 at D = 512 (32 lanes)
  static constexpr int TQ = kThreads / (H / HL * S);
  static constexpr int KC = TQ;                // keys a chunk
  // the projections: thread t owns columns t % CW + CW u (u < CPT) and
  // rows t / CW + RG j (j < RPT) of a chunk
  static constexpr int CW = C < kThreads ? C : kThreads;
  static constexpr int CPT = C / CW;           // columns a thread
  static constexpr int RG = kThreads / CW;     // row groups
  static constexpr int RPT = KC / RG;          // rows a thread projects
  // 1/sqrt(D); folded into q (exact: a power of two) where D is a power
  // of four, as JAX folds it, else on the f32 score and after the sums
  static constexpr bool kFold =
      D == 1 || D == 4 || D == 16 || D == 64 || D == 256;
  static constexpr float kScale = HeadScale<D>::kValue;
  static constexpr int kSmemBytes = 4 * KC * C * sizeof(float) +
                                    2 * KC * sizeof(int);
  static constexpr int kBwdSmemBytes = 6 * KC * C * sizeof(float) +
                                       (2 * KC + 2 * KC * H) * sizeof(int);
  // parameter gradients, f32: dWq, dWk, dWv [C][C], dbq, dbk, dbv [C]
  // (ops/attention_qkv.py splits them in this order)
  static constexpr int kGradFloats = 3 * C * C + 3 * C;
  static_assert(H % HL == 0 && H / HL * S * TQ == kThreads &&
                    RG * CW == kThreads && C % CW == 0 && KC % RG == 0 &&
                    S <= 32 && (32 % S) == 0 && S * HD == D &&
                    (HL == 1 || S == 1) && LC % 4 == 0,
                "one lane group per (token, head), or HL heads a lane; "
                "whole rows a group");

  // the calling thread's (first) head h, token i of the tile and channel
  // slice sl
  __device__ static int head() { return threadIdx.x / (S * TQ) * HL; }
  __device__ static int token() { return (threadIdx.x / S) % TQ; }
  __device__ static int slice() { return threadIdx.x % S; }
  // the first channel of the calling thread's slice in a row
  __device__ static int chan() { return head() * D + slice() * LC; }
};

// acc[u][j] += sum_k a[r][k] W[k][c] for the KC rows of `a` (shared,
// [KC][C]).  Thread: columns c = tid % CW + CW * u, rows r = tid / CW +
// RG * j.
template <int C, int D>
__device__ __forceinline__ void matmul_rows(
    const float* __restrict__ a, const float* __restrict__ W,
    float (&acc)[F32W<C, D>::CPT][F32W<C, D>::RPT]) {
  using K = F32W<C, D>;
  const int c = threadIdx.x % K::CW;
  const int r0 = threadIdx.x / K::CW;
  for (int k = 0; k < C; k += 4) {
    float w[K::CPT][4];
#pragma unroll
    for (int u = 0; u < K::CPT; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) w[u][e] = W[(k + e) * C + c + K::CW * u];
#pragma unroll
    for (int j = 0; j < K::RPT; ++j) {
      const float4 v =
          *reinterpret_cast<const float4*>(&a[(r0 + K::RG * j) * C + k]);
#pragma unroll
      for (int u = 0; u < K::CPT; ++u) {
        acc[u][j] = fmaf(v.x, w[u][0], acc[u][j]);
        acc[u][j] = fmaf(v.y, w[u][1], acc[u][j]);
        acc[u][j] = fmaf(v.z, w[u][2], acc[u][j]);
        acc[u][j] = fmaf(v.w, w[u][3], acc[u][j]);
      }
    }
  }
}

// out[r][c] = round_t(round_t(sum_k a[r][k] W[k][c]) + bias[c]) for the KC
// rows of `a`.
template <int C, int D>
__device__ __forceinline__ void project(const float* __restrict__ a,
                                        const float* __restrict__ W,
                                        const float* __restrict__ bias,
                                        float* __restrict__ out) {
  using K = F32W<C, D>;
  const int c = threadIdx.x % K::CW;
  const int r0 = threadIdx.x / K::CW;
  float acc[K::CPT][K::RPT] = {};
  matmul_rows<C, D>(a, W, acc);
#pragma unroll
  for (int u = 0; u < K::CPT; ++u) {
    const int cu = c + K::CW * u;
    const float bc = bias[cu];
#pragma unroll
    for (int j = 0; j < K::RPT; ++j)
      out[(r0 + K::RG * j) * C + cu] = acc[u][j] + bc;
  }
}

// Stage rows [r0, r0 + n) of x into s_x and of round_t(x + pos) into s_xp;
// rows past n read 0.
template <int C, int D>
__device__ __forceinline__ void stage_rows(const float* __restrict__ x,
                                           const float* __restrict__ pos,
                                           int r0, int n, float* s_x,
                                           float* s_xp) {
  using K = F32W<C, D>;
  for (int i = threadIdx.x; i < K::KC * C; i += K::kThreads) {
    const int r = i / C;
    float xv = 0.f, xp = 0.f;
    if (r < n) {
      const size_t g = (size_t)(r0 + r) * C + (i - r * C);
      xv = x[g];
      xp = xv + pos[g];
    }
    s_x[i] = xv;
    s_xp[i] = xp;
  }
}

// [first token of the window of q0, past the last token of the window of
// the tile's last real query), or [0, 0) for a tile of padding only
__device__ __forceinline__ void key_range(const int* wb, int V, int q0,
                                          int nq, int* s_range) {
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
}

template <int C, int D>
__global__ void __launch_bounds__(F32W<C, D>::kThreads)
band_attention_qkv_kernel(const float* __restrict__ x,
                          const float* __restrict__ pos,
                          const float* __restrict__ wq,
                          const float* __restrict__ bq,
                          const float* __restrict__ wk,
                          const float* __restrict__ bk,
                          const float* __restrict__ wv,
                          const float* __restrict__ bv,
                          const int* __restrict__ win,
                          const uint8_t* __restrict__ key_valid,
                          float* __restrict__ out, float* __restrict__ lse,
                          int V) {
  using K = F32W<C, D>;
  constexpr int TQ = K::TQ, KC = K::KC, H = K::H;
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
  const float* xb = x + row0 * C;
  const float* pb = pos + row0 * C;
  float* ob = out + row0 * C;

  const int h = K::head(), i = K::token(), ch = K::chan();
  const int qi = q0 + i;
  const int my_win = (i < nq) ? wb[qi] : kInt32Max;

  key_range(wb, V, q0, nq, s_range);
  __syncthreads();
  const int ks = s_range[0], ke = s_range[1];

  float q[K::LC];
  if (ks < ke) {
    stage_rows<C, D>(xb, pb, q0, nq, s_x, s_xp);
    __syncthreads();
    project<C, D>(s_xp, wq, bq, s_k);
    __syncthreads();
#pragma unroll
    for (int d = 0; d < K::LC; ++d) {
      const float v = s_k[i * C + ch + d];
      q[d] = K::kFold ? v * K::kScale : v;
    }
  }

  // per head of the lane (HL, channels d of head d / HD): running max and
  // sum; the accumulator
  constexpr int HL = K::HL, HD = K::HD;
  float m[HL], l[HL], acc[K::LC];
#pragma unroll
  for (int hl = 0; hl < HL; ++hl) m[hl] = -INFINITY, l[hl] = 0.f;
#pragma unroll
  for (int d = 0; d < K::LC; ++d) acc[d] = 0.f;

  for (int k0 = ks; k0 < ke; k0 += KC) {
    const int nk = min(KC, ke - k0);
    __syncthreads();   // the previous chunk (or the q rows) is consumed
    stage_rows<C, D>(xb, pb, k0, nk, s_x, s_xp);
    if (threadIdx.x < KC) {
      const int r = threadIdx.x;
      s_win[r] = r < nk ? wb[k0 + r] : kInt32Max;
      s_kv[r] = r < nk ? (int)kvb[k0 + r] : 0;
    }
    __syncthreads();
    project<C, D>(s_xp, wk, bk, s_k);
    project<C, D>(s_x, wv, bv, s_v);
    __syncthreads();
    if (my_win == kInt32Max) continue;
    for (int j = 0; j < nk; ++j) {
      if (s_win[j] != my_win || !s_kv[j]) continue;
      const float4* kr = reinterpret_cast<const float4*>(&s_k[j * C + ch]);
      // channel 4 d4 + e of the lane belongs to its head (4 d4 + e) / HD
      float s[HL] = {};
#pragma unroll
      for (int d4 = 0; d4 < K::LC / 4; ++d4) {
        const float4 kk = kr[d4];
        s[4 * d4 / HD] = fmaf(q[4 * d4 + 0], kk.x, s[4 * d4 / HD]);
        s[(4 * d4 + 1) / HD] = fmaf(q[4 * d4 + 1], kk.y, s[(4 * d4 + 1) / HD]);
        s[(4 * d4 + 2) / HD] = fmaf(q[4 * d4 + 2], kk.z, s[(4 * d4 + 2) / HD]);
        s[(4 * d4 + 3) / HD] = fmaf(q[4 * d4 + 3], kk.w, s[(4 * d4 + 3) / HD]);
      }
      float mn[HL], corr[HL], p[HL];
#pragma unroll
      for (int hl = 0; hl < HL; ++hl) {
        s[hl] = lane_group_sum<K::S>(s[hl]);
        if (!K::kFold) s[hl] *= K::kScale;
        mn[hl] = fmaxf(m[hl], s[hl]);
        corr[hl] = expf(m[hl] - mn[hl]);
        p[hl] = expf(s[hl] - mn[hl]);
        l[hl] = l[hl] * corr[hl] + p[hl];
      }
      const float4* vr = reinterpret_cast<const float4*>(&s_v[j * C + ch]);
#pragma unroll
      for (int d4 = 0; d4 < K::LC / 4; ++d4) {
        const float4 vv = vr[d4];
        const int h0 = 4 * d4 / HD, h1 = (4 * d4 + 1) / HD;
        const int h2 = (4 * d4 + 2) / HD, h3 = (4 * d4 + 3) / HD;
        acc[4 * d4 + 0] = fmaf(p[h0], vv.x, acc[4 * d4 + 0] * corr[h0]);
        acc[4 * d4 + 1] = fmaf(p[h1], vv.y, acc[4 * d4 + 1] * corr[h1]);
        acc[4 * d4 + 2] = fmaf(p[h2], vv.z, acc[4 * d4 + 2] * corr[h2]);
        acc[4 * d4 + 3] = fmaf(p[h3], vv.w, acc[4 * d4 + 3] * corr[h3]);
      }
#pragma unroll
      for (int hl = 0; hl < HL; ++hl) m[hl] = mn[hl];
    }
  }

  if (i < nq) {
#pragma unroll
    for (int hl = 0; hl < HL; ++hl) {
      const bool seen = my_win != kInt32Max && l[hl] > 0.f;
      const float inv = seen ? 1.f / l[hl] : 0.f;
      float* o = ob + (size_t)qi * C + ch;
#pragma unroll
      for (int d = hl * HD; d < (hl + 1) * HD; ++d) o[d] = acc[d] * inv;
      if (lse && K::slice() == 0)
        lse[(row0 + qi) * H + h + hl] = seen ? m[hl] + logf(l[hl]) : 0.f;
    }
  }
}

template <int C, int D>
cudaError_t launch(const void* x, const void* pos, const void* wq,
                   const void* bq, const void* wk, const void* bk,
                   const void* wv, const void* bv, const int* win,
                   const uint8_t* key_valid, void* out, float* lse, int B,
                   int V, cudaStream_t stream) {
  using K = F32W<C, D>;
  cudaError_t e = allow_smem(band_attention_qkv_kernel<C, D>, K::kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((V + K::TQ - 1) / K::TQ, B);
  band_attention_qkv_kernel<C, D><<<grid, K::kThreads, K::kSmemBytes,
                                    stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(pos),
      static_cast<const float*>(wq), static_cast<const float*>(bq),
      static_cast<const float*>(wk), static_cast<const float*>(bk),
      static_cast<const float*>(wv), static_cast<const float*>(bv), win,
      key_valid, static_cast<float*>(out), lse, V);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward (K7)
// ---------------------------------------------------------------------------

template <int C, int D>
__global__ void __launch_bounds__(F32W<C, D>::kThreads)
band_attention_qkv_bwd_kernel(BwdArgs p) {
  using K = F32W<C, D>;
  constexpr int TQ = K::TQ, KC = K::KC, H = K::H, RG = K::RG;
  constexpr int kThreads = K::kThreads;
  constexpr float kDkScale = K::kFold ? 1.f : K::kScale;
  extern __shared__ float smem[];
  float* s_x = smem;               // [KC][C] x rows of a chunk or the tile
  float* s_xp = s_x + KC * C;      // [KC][C] x + pos rows
  float* s_q = s_xp + KC * C;      // [KC][C] q (scaled), later dq of the tile
  float* s_k = s_q + KC * C;       // [KC][C] k, later dk
  float* s_v = s_k + KC * C;       // [KC][C] v, later dv
  float* s_do = s_v + KC * C;      // [KC][C] dO rows of the chunk
  int* s_win = reinterpret_cast<int*>(s_do + KC * C);   // [KC]
  int* s_kv = s_win + KC;                                // [KC]
  float* s_lse = reinterpret_cast<float*>(s_kv + KC);   // [KC][H]
  float* s_dd = s_lse + KC * H;                          // [KC][H] D
  __shared__ int s_range[2];

  const float* x = static_cast<const float*>(p.x);
  const float* pos = static_cast<const float*>(p.pos);
  const float* out = static_cast<const float*>(p.out);
  const float* dout = static_cast<const float*>(p.dout);
  float* dx = static_cast<float*>(p.dx);
  const float* wq = static_cast<const float*>(p.wq);
  const float* bq = static_cast<const float*>(p.bq);
  const float* wk = static_cast<const float*>(p.wk);
  const float* bk = static_cast<const float*>(p.bk);
  const float* wv = static_cast<const float*>(p.wv);
  const float* bv = static_cast<const float*>(p.bv);
  float* P = p.partial + (size_t)blockIdx.x * K::kGradFloats;

  const int h = K::head(), i = K::token(), ch = K::chan();
  // dbq, dbk, dbv of columns tid + kThreads u (< C)
  float db[K::CPT][3] = {};

  const int tiles_per_row = (p.V + TQ - 1) / TQ;
  for (int tile = blockIdx.x; tile < p.B * tiles_per_row;
       tile += gridDim.x) {
    const int b = tile / tiles_per_row;
    const int q0 = (tile - b * tiles_per_row) * TQ;
    const int nq = min(TQ, p.V - q0);
    const size_t row0 = (size_t)b * p.V;
    const int* wb = p.win + row0;
    const uint8_t* kvb = p.key_valid + row0;
    const float* xb = x + row0 * C;
    const float* pb = pos + row0 * C;

    __syncthreads();               // the previous tile's buffers are consumed
    key_range(wb, p.V, q0, nq, s_range);
    __syncthreads();
    const int ks = s_range[0], ke = s_range[1];
    if (ks >= ke) {                // padding only: no gradient
      for (int e = threadIdx.x; e < nq * C; e += kThreads)
        dx[(row0 + q0) * C + e] = 0.f;
      continue;
    }

    // the tile's own q, k, v, dO, D and lse, in registers
    const size_t qi = row0 + q0 + i;
    const int my_win = (i < nq) ? wb[q0 + i] : kInt32Max;
    const bool my_kv = (i < nq) && kvb[q0 + i];
    stage_rows<C, D>(xb, pb, q0, nq, s_x, s_xp);
    __syncthreads();
    project<C, D>(s_xp, wq, bq, s_q);
    project<C, D>(s_xp, wk, bk, s_k);
    project<C, D>(s_x, wv, bv, s_v);
    __syncthreads();
    constexpr int HL = K::HL, HD = K::HD;   // heads a lane, their channels
    float q[K::LC], k[K::LC], v[K::LC], g[K::LC];
    float dq[K::LC] = {}, dk[K::LC] = {}, dv[K::LC] = {};
    float lse_i[HL] = {}, d_i[HL] = {};
#pragma unroll
    for (int d = 0; d < K::LC; ++d) {
      const int c = i * C + ch + d;
      q[d] = K::kFold ? s_q[c] * K::kScale : s_q[c];
      k[d] = s_k[c];
      v[d] = s_v[c];
      g[d] = 0.f;
    }
    if (my_win != kInt32Max) {
#pragma unroll
      for (int d = 0; d < K::LC; ++d) {
        g[d] = dout[qi * C + ch + d];
        d_i[d / HD] = fmaf(g[d], out[qi * C + ch + d], d_i[d / HD]);
      }
#pragma unroll
      for (int hl = 0; hl < HL; ++hl) lse_i[hl] = p.lse[qi * H + h + hl];
    }
#pragma unroll
    for (int hl = 0; hl < HL; ++hl) d_i[hl] = lane_group_sum<K::S>(d_i[hl]);

    for (int k0 = ks; k0 < ke; k0 += KC) {
      const int nk = min(KC, ke - k0);
      __syncthreads();             // the previous chunk is consumed
      stage_rows<C, D>(xb, pb, k0, nk, s_x, s_xp);
      // (row r, head hh): dO row, D, lse; window ids
      for (int e = threadIdx.x; e < KC * H; e += kThreads) {
        const int r = e % KC, hh = e / KC;
        float dd = 0.f, l = 0.f;
        float* dst = &s_do[r * C + hh * D];
        if (r < nk) {
          const size_t gi = row0 + k0 + r;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float gv = dout[gi * C + hh * D + d];
            dd = fmaf(gv, out[gi * C + hh * D + d], dd);
            dst[d] = gv;
          }
          l = p.lse[gi * H + hh];
        } else {
#pragma unroll
          for (int d = 0; d < D; ++d) dst[d] = 0.f;
        }
        s_dd[r * H + hh] = dd;
        s_lse[r * H + hh] = l;
        if (hh == 0) {
          s_win[r] = r < nk ? wb[k0 + r] : kInt32Max;
          s_kv[r] = r < nk ? (int)kvb[k0 + r] : 0;
        }
      }
      __syncthreads();
      project<C, D>(s_xp, wq, bq, s_q);
      project<C, D>(s_xp, wk, bk, s_k);
      project<C, D>(s_x, wv, bv, s_v);
      __syncthreads();
      if (K::kFold) {
        for (int e = threadIdx.x; e < KC * C; e += kThreads)
          s_q[e] = s_q[e] * K::kScale;
        __syncthreads();
      }
      if (my_win == kInt32Max) continue;
      for (int j = 0; j < nk; ++j) {
        if (s_win[j] != my_win) continue;
        const float* kj = &s_k[j * C + ch];
        const float* vj = &s_v[j * C + ch];
        if (s_kv[j]) {             // token i as query, j as key
          float sc[HL] = {}, dp[HL] = {}, ds[HL];
#pragma unroll
          for (int d = 0; d < K::LC; ++d) {
            sc[d / HD] = fmaf(q[d], kj[d], sc[d / HD]);
            dp[d / HD] = fmaf(g[d], vj[d], dp[d / HD]);
          }
#pragma unroll
          for (int hl = 0; hl < HL; ++hl) {
            float sh = lane_group_sum<K::S>(sc[hl]);
            const float dh = lane_group_sum<K::S>(dp[hl]);
            if (!K::kFold) sh *= K::kScale;
            const float pr = expf(sh - lse_i[hl]);
            ds[hl] = pr * (dh - d_i[hl]);
          }
#pragma unroll
          for (int d = 0; d < K::LC; ++d)
            dq[d] = fmaf(ds[d / HD], kj[d], dq[d]);
        }
        if (my_kv) {               // token i as key, j as query
          const float* qj = &s_q[j * C + ch];
          const float* gj = &s_do[j * C + ch];
          float sc[HL] = {}, dp[HL] = {}, pr[HL], ds[HL];
#pragma unroll
          for (int d = 0; d < K::LC; ++d) {
            sc[d / HD] = fmaf(qj[d], k[d], sc[d / HD]);
            dp[d / HD] = fmaf(gj[d], v[d], dp[d / HD]);
          }
#pragma unroll
          for (int hl = 0; hl < HL; ++hl) {
            float sh = lane_group_sum<K::S>(sc[hl]);
            const float dh = lane_group_sum<K::S>(dp[hl]);
            if (!K::kFold) sh *= K::kScale;
            pr[hl] = expf(sh - s_lse[j * H + h + hl]);
            ds[hl] = pr[hl] * (dh - s_dd[j * H + h + hl]);
          }
#pragma unroll
          for (int d = 0; d < K::LC; ++d) {
            dv[d] = fmaf(pr[d / HD], gj[d], dv[d]);
            dk[d] = fmaf(ds[d / HD], qj[d], dk[d]);
          }
        }
      }
    }

    // the tile's dq, dk, dv (compute dtype) and its x, x + pos rows
    __syncthreads();
#pragma unroll
    for (int d = 0; d < K::LC; ++d) {
      const int c = i * C + ch + d;
      s_q[c] = dq[d] * K::kScale;
      s_k[c] = dk[d] * kDkScale;
      s_v[c] = dv[d];
    }
    stage_rows<C, D>(xb, pb, q0, nq, s_x, s_xp);
    __syncthreads();
    {  // dx = (dq Wq^T) + (dk Wk^T + dv Wv^T)
      float aq[K::CPT][K::RPT] = {}, akv[K::CPT][K::RPT] = {};
      matmul_rows<C, D>(s_q, static_cast<const float*>(p.wqT), aq);
      matmul_rows<C, D>(s_k, static_cast<const float*>(p.wkT), akv);
      matmul_rows<C, D>(s_v, static_cast<const float*>(p.wvT), akv);
      const int c = threadIdx.x % K::CW;
#pragma unroll
      for (int u = 0; u < K::CPT; ++u)
#pragma unroll
        for (int j = 0; j < K::RPT; ++j) {
          const int r = threadIdx.x / K::CW + RG * j;
          if (r < nq)
            dx[(row0 + q0 + r) * C + c + K::CW * u] = aq[u][j] + akv[u][j];
        }
    }
    accum_outer<kThreads, TQ, C, C>(s_xp, s_q, P);
    accum_outer<kThreads, TQ, C, C>(s_xp, s_k, P + C * C);
    accum_outer<kThreads, TQ, C, C>(s_x, s_v, P + 2 * C * C);
#pragma unroll
    for (int u = 0; u < K::CPT; ++u) {
      const int c = threadIdx.x + kThreads * u;
      if (c < C) {
        for (int r = 0; r < TQ; ++r) {
          db[u][0] += s_q[r * C + c];
          db[u][1] += s_k[r * C + c];
          db[u][2] += s_v[r * C + c];
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < K::CPT; ++u) {
    const int c = threadIdx.x + kThreads * u;
    if (c < C) {
#pragma unroll
      for (int o = 0; o < 3; ++o) P[3 * C * C + o * C + c] = db[u][o];
    }
  }
}

template <int C, int D>
cudaError_t launch_bwd(const BwdArgs& args, float* grads, int nblocks,
                       cudaStream_t stream) {
  using K = F32W<C, D>;
  cudaError_t e =
      allow_smem(band_attention_qkv_bwd_kernel<C, D>, K::kBwdSmemBytes);
  if (e != cudaSuccess) return e;
  band_attention_qkv_bwd_kernel<C, D>
      <<<nblocks, K::kThreads, K::kBwdSmemBytes, stream>>>(args);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return sum_partials(args.partial, nblocks, K::kGradFloats, grads, stream);
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: the projections (K6 forward and K7's
// recompute), dx and the weight gradients (K7)
// ---------------------------------------------------------------------------

// qkv_project_kernel and qkv_project_dx_kernel: a persistent grid, one
// block an SM, each block owning NB output columns of its products (a
// column slice) with the weights they read resident in its shared memory
// for all its tiles, and walking kPT-row tiles (64; 32 at C = 512) of
// the flattened [B * V] rows.  16 warps at C = 128 (NB = 128): warp w
// takes rows 16 (w / (NB / 32)).. and output columns 32 (w % (NB /
// 32)).. of its slice, for
// all three products at once (q, k, v forward; dq Wq^T and dk Wk^T + dv
// Wv^T backward), so an A fragment is loaded once for every product that
// reads it.  The products are staged rounded in shared memory and written
// 16 bytes a lane.  (8 warps of 64 columns, and a ring of weight chunks
// streamed for each tile at two blocks an SM, K5's way, measured slower
// at C = 128: PERF.md.)  At C = 128 a tile's rows arrive by cp.async into
// one of two buffers while the block computes on the other.
// C = 256: the three weights are 3 x 256 x 264 x 2 = 405 KB, past the 227
// KB an SM holds, so a block owns a 64-column slice of the three
// products (8 warps; the grid's blocks take the four slices in turn),
// which keeps the one-pass design: the x and pos rows (or dq, dk and dv)
// of a tile are read once a slice, from L2 after the first, the three
// products share their A fragments, and each token is still projected
// once.  A slice's weights are 110 KB forward (all C rows, NB columns)
// and 101 KB for dx (NB rows of W, all C columns), so one buffer of input
// rows fits beside them, not two: the next tile's rows are staged after
// the products of this one.  (A block a product would keep two buffers
// but read the x rows three times; streaming the weights per tile would
// read 393 KB of weights from L2 for every 64 rows.)
// C = 384 and 512: 64-column slices take 294,656 bytes forward at C 384,
// past the 232,448 a block may hold, so a block owns a 32-column slice (4
// warps of one column group, 12 or 16 slices); at C 512 the slice's
// weights (120 KB forward, 98 KB for dx) and one 64-row tile of two or
// three input rows would still take 271,744 / 304,640 bytes, so its
// tiles are 32 rows (2 warps; 197,504 / 202,240 bytes).  C 384 keeps
// 64-row tiles (208,256 / 230,912 bytes).
constexpr int kWarpCols = 32;            // output columns a warp

template <int C>
struct PW {
  // output columns a block
  static constexpr int NB = C == 128 ? 128 : C == 256 ? 64 : 32;
  static constexpr int kBufs = C == 128 ? 2 : 1;   // input tile buffers
  static constexpr int kPT = C == 512 ? 32 : 64;   // rows a tile
  static constexpr int kSlices = C / NB;
  static constexpr int kColGroups = NB / kWarpCols;
  static constexpr int kThreads = 32 * (kPT / 16) * kColGroups;
  static constexpr int kRS = C + kPad;   // bf16 row stride of C channels
  static constexpr int kOS = NB + kPad;  // bf16 row stride of a slice
  static constexpr int kTileElems = kPT * kRS;
  static constexpr int kOutElems = kPT * kOS;
  static constexpr int kPieces = C / 8;  // 16-byte pieces a row
  static constexpr int kOutPieces = NB / 8;
};

template <int C>
struct ProjSmem {                        // forward
  bf16 w[3][C * PW<C>::kOS];             // Wq, Wk, Wv [in][slice of out]
  bf16 in[PW<C>::kBufs][2][PW<C>::kTileElems];   // per buffer: x, pos rows
  bf16 out[3][PW<C>::kOutElems];         // q, k, v of the tile's slice
  float bias[3][PW<C>::NB];
};
template <int C>
struct DxSmem {                          // backward's dx
  bf16 w[3][PW<C>::NB * PW<C>::kRS];     // the slice's rows of Wq, Wk, Wv
  bf16 in[PW<C>::kBufs][3][PW<C>::kTileElems];   // per buffer: dq, dk, dv
  bf16 out[PW<C>::kOutElems];            // dx of the tile's slice
};
static_assert(sizeof(ProjSmem<128>) <= 227 * 1024 &&
                  sizeof(DxSmem<128>) <= 227 * 1024 &&
                  sizeof(ProjSmem<256>) <= 227 * 1024 &&
                  sizeof(DxSmem<256>) <= 227 * 1024 &&
                  sizeof(ProjSmem<384>) <= 227 * 1024 &&
                  sizeof(DxSmem<384>) <= 227 * 1024 &&
                  sizeof(ProjSmem<512>) <= 227 * 1024 &&
                  sizeof(DxSmem<512>) <= 227 * 1024,
              "one block an SM");

__device__ __forceinline__ float rbf(float v) {
  return round_t<bf16>(v);
}

// two bf16 pairs added in f32 and rounded back: round(a + b), elementwise
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const float2 fa = unpack_bf16(a), fb = unpack_bf16(b);
  return pack_bf16(fa.x + fb.x, fa.y + fb.y);
}

// rows [r0, r0 + kPT) of the [rows][C] tensors s0, s1 (and s2 when N is
// 3) into the N tiles at dst; rows past `rows` are zero-filled
template <int C, int N>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* s0,
                                           const bf16* s1, const bf16* s2,
                                           int r0, int rows) {
  using W = PW<C>;
  for (int e = threadIdx.x; e < N * W::kPT * W::kPieces; e += W::kThreads) {
    const int a = e / (W::kPT * W::kPieces), r = (e / W::kPieces) % W::kPT;
    const int c = (e % W::kPieces) * 8;
    const bool ok = r0 + r < rows;
    const bf16* src = a == 0 ? s0 : a == 1 ? s1 : s2;
    cp_async_16(dst + a * W::kTileElems + r * W::kRS + c,
                src + (size_t)(ok ? r0 + r : 0) * C + c, ok);
  }
}

// the warp's first row and output column (in its slice) in a tile
template <int C>
__device__ __forceinline__ int warp_row() {
  return 16 * (threadIdx.x / 32 / PW<C>::kColGroups);
}
template <int C>
__device__ __forceinline__ int warp_col() {
  return kWarpCols * (threadIdx.x / 32 % PW<C>::kColGroups);
}

// the warp's A fragment (16 rows x 16 k) of a tile at column kk
template <int C>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int kk) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, tile + (warp_row<C>() + lane % 16) * PW<C>::kRS + kk +
                     (lane / 16) * 8);
}

// acc += A (the fragment) times W over the warp's columns and k rows
// kk..kk+15: W as stored [k][n] with row stride kOS (forward, trans) or
// W^T read from W's rows [n][k] with row stride kRS (backward)
template <int C, bool kWT>
__device__ __forceinline__ void mma_w(float (&acc)[kWarpCols / 8][4],
                                      const uint32_t (&a)[4], const bf16* w,
                                      int kk) {
  const int lane = threadIdx.x % 32, nw = warp_col<C>();
#pragma unroll
  for (int j = 0; j < kWarpCols / 16; ++j) {
    uint32_t b[4];
    if (kWT)
      ldmatrix_x4(b, w + (nw + 16 * j + lane % 8 + (lane / 16) * 8) *
                             PW<C>::kRS +
                         kk + ((lane / 8) % 2) * 8);
    else
      ldmatrix_x4_trans(b, w + (kk + lane % 8 + ((lane / 8) % 2) * 8) *
                                   PW<C>::kOS +
                               nw + 16 * j + (lane / 16) * 8);
    mma_bf16_16816(acc[2 * j], a, &b[0]);
    mma_bf16_16816(acc[2 * j + 1], a, &b[2]);
  }
}

// the N staged [kPT][kOS] slice tiles at src, rows below `rows`, to rows
// r0.. and columns n0.. of d0, d1 (and d2 when N is 3), 16 bytes a lane
template <int C, int N>
__device__ __forceinline__ void write_tile(bf16* d0, bf16* d1, bf16* d2,
                                           const bf16* src, int r0, int n0,
                                           int rows) {
  using W = PW<C>;
  for (int e = threadIdx.x; e < N * W::kPT * W::kOutPieces;
       e += W::kThreads) {
    const int a = e / (W::kPT * W::kOutPieces),
              r = (e / W::kOutPieces) % W::kPT;
    const int c = (e % W::kOutPieces) * 8;
    bf16* dst = a == 0 ? d0 : a == 1 ? d1 : d2;
    if (r0 + r < rows)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * C + n0 + c) =
          *reinterpret_cast<const uint4*>(src + a * W::kOutElems +
                                          r * W::kOS + c);
  }
}

// q, k, v [rows][C] of x and pos: per row round(round((x + pos) W) + b)
// (x for v), 0 on padding rows (win == INT32_MAX), which K8 then reads as
// finite values
template <int C>
__global__ void __launch_bounds__(PW<C>::kThreads, 1)
qkv_project_kernel(ProjArgs p) {
  using W = PW<C>;
  constexpr int kPT = W::kPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ProjSmem<C>& sm = *reinterpret_cast<ProjSmem<C>*>(smem_raw);
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r16 = warp_row<C>(), nw = warp_col<C>();
  const int tiles = (p.rows + kPT - 1) / kPT;
  const int n0 = (blockIdx.x % W::kSlices) * W::NB;
  const int first = blockIdx.x / W::kSlices;
  const int stride = gridDim.x / W::kSlices;

  // the slice's columns of the three [C][C] weights (row stride kOS)
  for (int e = threadIdx.x; e < 3 * C * W::kOutPieces; e += W::kThreads) {
    const int m = e / (C * W::kOutPieces), r = (e / W::kOutPieces) % C;
    const int c = (e % W::kOutPieces) * 8;
    const bf16* src = m == 0 ? p.wq : m == 1 ? p.wk : p.wv;
    cp_async_16(&sm.w[m][r * W::kOS + c], src + (size_t)r * C + n0 + c);
  }
  if (first < tiles)
    stage_tile<C, 2>(sm.in[0][0], p.x, p.pos, nullptr, first * kPT, p.rows);
  cp_async_commit();
  for (int e = threadIdx.x; e < 3 * W::NB; e += W::kThreads) {
    const int o = e / W::NB, c = e % W::NB;
    const bf16* b = o == 0 ? p.bq : o == 1 ? p.bk : p.bv;
    sm.bias[o][c] = to_f<bf16>(b[n0 + c]);
  }

  int buf = 0;
  for (int tile = first; tile < tiles; tile += stride) {
    const int r0 = tile * kPT;
    const bool more = tile + stride < tiles;
    cp_async_wait<0>();
    __syncthreads();               // tile landed; the other buffer and the
                                   // output tiles are free
    if constexpr (W::kBufs == 2) if (more) {
      stage_tile<C, 2>(sm.in[buf ^ 1][0], p.x, p.pos, nullptr,
                       r0 + stride * kPT, p.rows);
      cp_async_commit();
    }
    // the lane's rows g, g + 8: real (not padding, not past the end)
    bool real[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int r = r0 + r16 + g + 8 * rh;
      real[rh] = r < p.rows && __ldg(p.win + r) != kInt32Max;
    }
    float acc[3][kWarpCols / 8][4] = {};
    const bf16* xs = sm.in[buf][0];
    const bf16* ps = sm.in[buf][1];
#pragma unroll 2
    for (int kk = 0; kk < C; kk += 16) {
      uint32_t ax[4], axp[4];
      load_a<C>(ax, xs, kk);
      load_a<C>(axp, ps, kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) axp[i] = add_bf16x2(ax[i], axp[i]);
      mma_w<C, false>(acc[0], axp, sm.w[0], kk);
      mma_w<C, false>(acc[1], axp, sm.w[1], kk);
      mma_w<C, false>(acc[2], ax, sm.w[2], kk);
    }
#pragma unroll
    for (int o = 0; o < 3; ++o)
#pragma unroll
      for (int nb = 0; nb < kWarpCols / 8; ++nb) {
        const int c = nw + 8 * nb + 2 * t;
        const float b0 = sm.bias[o][c], b1 = sm.bias[o][c + 1];
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const float* a = &acc[o][nb][2 * rh];
          *reinterpret_cast<uint32_t*>(
              &sm.out[o][(r16 + g + 8 * rh) * W::kOS + c]) =
              real[rh] ? pack_bf16(rbf(a[0]) + b0, rbf(a[1]) + b1) : 0u;
        }
      }
    __syncthreads();
    if constexpr (W::kBufs == 1) if (more) {   // the one buffer is free now
      stage_tile<C, 2>(sm.in[0][0], p.x, p.pos, nullptr, r0 + stride * kPT,
                       p.rows);
      cp_async_commit();
    }
    write_tile<C, 3>(p.q, p.k, p.v, sm.out[0], r0, n0, p.rows);
    if constexpr (W::kBufs == 2) buf ^= 1;
  }
  cp_async_wait<0>();
}

// dx [rows][C] = round(round(dq Wq^T) + round(dk Wk^T + dv Wv^T))
template <int C>
__global__ void __launch_bounds__(PW<C>::kThreads, 1)
qkv_project_dx_kernel(DxArgs p) {
  using W = PW<C>;
  constexpr int kPT = W::kPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DxSmem<C>& sm = *reinterpret_cast<DxSmem<C>*>(smem_raw);
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r16 = warp_row<C>(), nw = warp_col<C>();
  const int tiles = (p.rows + kPT - 1) / kPT;
  const int n0 = (blockIdx.x % W::kSlices) * W::NB;
  const int first = blockIdx.x / W::kSlices;
  const int stride = gridDim.x / W::kSlices;

  // rows n0.. of the three [C][C] weights (row stride kRS)
  for (int e = threadIdx.x; e < 3 * W::NB * W::kPieces; e += W::kThreads) {
    const int m = e / (W::NB * W::kPieces), r = (e / W::kPieces) % W::NB;
    const int c = (e % W::kPieces) * 8;
    const bf16* src = m == 0 ? p.wq : m == 1 ? p.wk : p.wv;
    cp_async_16(&sm.w[m][r * W::kRS + c], src + (size_t)(n0 + r) * C + c);
  }
  if (first < tiles)
    stage_tile<C, 3>(sm.in[0][0], p.dq, p.dk, p.dv, first * kPT, p.rows);
  cp_async_commit();

  int buf = 0;
  for (int tile = first; tile < tiles; tile += stride) {
    const int r0 = tile * kPT;
    const bool more = tile + stride < tiles;
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (W::kBufs == 2) if (more) {
      stage_tile<C, 3>(sm.in[buf ^ 1][0], p.dq, p.dk, p.dv,
                       r0 + stride * kPT, p.rows);
      cp_async_commit();
    }
    float aq[kWarpCols / 8][4] = {}, akv[kWarpCols / 8][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < C; kk += 16) {
      uint32_t a[4];
      load_a<C>(a, sm.in[buf][0], kk);
      mma_w<C, true>(aq, a, sm.w[0], kk);
      load_a<C>(a, sm.in[buf][1], kk);
      mma_w<C, true>(akv, a, sm.w[1], kk);
      load_a<C>(a, sm.in[buf][2], kk);
      mma_w<C, true>(akv, a, sm.w[2], kk);
    }
#pragma unroll
    for (int nb = 0; nb < kWarpCols / 8; ++nb)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int e = 2 * rh;
        *reinterpret_cast<uint32_t*>(
            &sm.out[(r16 + g + 8 * rh) * W::kOS + nw + 8 * nb + 2 * t]) =
            pack_bf16(rbf(aq[nb][e]) + rbf(akv[nb][e]),
                      rbf(aq[nb][e + 1]) + rbf(akv[nb][e + 1]));
      }
    __syncthreads();
    if constexpr (W::kBufs == 1) if (more) {
      stage_tile<C, 3>(sm.in[0][0], p.dq, p.dk, p.dv, r0 + stride * kPT,
                       p.rows);
      cp_async_commit();
    }
    write_tile<C, 1>(p.dx, nullptr, nullptr, sm.out, r0, n0, p.rows);
    if constexpr (W::kBufs == 2) buf ^= 1;
  }
  cp_async_wait<0>();
}

// Weight gradients, split-K over chunks of rows: block (chunk, tile, z)
// adds A^T D over its chunk's rows for product z and one 128 x 128 tile
// of its [C][C] output, A^T D being (x+pos)^T dq (z = 0), (x+pos)^T dk
// (1), x^T dv (2), and for the tiles of the first 128 rows the column
// sums of D (the bias gradient), then writes them into its chunk's
// partial; sum_partials adds the chunks in order.  At C = 256, 384 and
// 512 a product has 4, 9 and 16 tiles, each a block of the grid (the
// chunks shrink as many times, so the grid stays about the card's size,
// ops/attention_qkv.py wgrad_chunk_rows), and a block stages only the
// 128 columns of A and of D its tile reads: its shared memory is the
// same 104 KB at every C, two
// blocks an SM.  Eight warps, warp w takes output rows 32 (w / 2).. and
// columns 64 (w % 2).. of the tile; 64-row steps of A (x and pos, added
// and rounded in the fragments) and D arrive by cp.async,
// double-buffered.  Rows past the end are zero-filled; a padding row adds
// its dq, dk, dv, which K8's backward writes as 0.
constexpr int kQwThreads = 256;
constexpr int kQwRows = 64;              // rows a step
constexpr int kQwTile = 128;             // output rows and columns a block
constexpr int kQwS = kQwTile + kPad;     // bf16 row stride of its columns
constexpr int kQwElems = kQwRows * kQwS;
constexpr int kQwPieces = kQwTile / 8;

struct WgSmem {
  bf16 t[2][3][kQwElems];                // per buffer: x, pos, D rows
  float bsum[4][kQwTile];                // the bias sums' four row groups
};

template <int C>
__global__ void __launch_bounds__(kQwThreads, 2)
qkv_wgrad_kernel(QwArgs p) {
  constexpr int T = C / kQwTile;         // tiles a product has along a side
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WgSmem& sm = *reinterpret_cast<WgSmem*>(smem_raw);
  const int z = blockIdx.x % 3, tile = (blockIdx.x / 3) % (T * T);
  const int chunk = blockIdx.x / (3 * T * T);
  const int m0 = kQwTile * (tile / T), n0 = kQwTile * (tile % T);
  const bool bias = m0 == 0;             // this block adds the bias sums
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4, q = lane / 8;
  const int wm = 32 * (warp / 2), wn = 64 * (warp % 2);
  const bf16* dsrc = z == 0 ? p.dq : z == 1 ? p.dk : p.dv;
  const int c0 = chunk * p.chunk_rows;
  const int steps =
      (min(p.chunk_rows, p.rows - c0) + kQwRows - 1) / kQwRows;
  // bias sums: thread (column pair cp, row group rg) over 16 rows a step
  const int cp = threadIdx.x % 64, rg = threadIdx.x / 64;
  float bs0 = 0.f, bs1 = 0.f;

  // step s's x (and pos for z < 2) and D rows into buffer b: columns
  // m0.. of x and pos, n0.. of D
  auto stage = [&](int s, int b) {
    const int r0 = c0 + s * kQwRows;
    for (int e = threadIdx.x; e < 3 * kQwRows * kQwPieces;
         e += kQwThreads) {
      const int a = e / (kQwRows * kQwPieces),
                r = (e / kQwPieces) % kQwRows;
      const int c = (e % kQwPieces) * 8;
      if (a == 1 && z == 2) continue;    // x^T dv reads no pos
      const bool ok = r0 + r < p.rows;
      const bf16* src = a == 0 ? p.x : a == 1 ? p.pos : dsrc;
      cp_async_16(&sm.t[b][a][r * kQwS + c],
                  src + (size_t)(ok ? r0 + r : 0) * C + (a == 2 ? n0 : m0) +
                      c,
                  ok);
    }
  };

  float acc[2][8][4] = {};
  stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int b = s & 1;
    cp_async_wait<0>();
    __syncthreads();                     // step s landed; step s - 1 consumed
    if (s + 1 < steps) {
      stage(s + 1, b ^ 1);
      cp_async_commit();
    }
    const bf16* sa = sm.t[b][0];
    const bf16* sp = sm.t[b][1];
    const bf16* sd = sm.t[b][2];
#pragma unroll
    for (int kk = 0; kk < kQwRows; kk += 16) {
      uint32_t af[2][4], bf[4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {      // A^T: rows are tokens (k), cols m
        const int o = (kk + lane % 8 + (q / 2) * 8) * kQwS + wm + i * 16 +
                      (q % 2) * 8;
        ldmatrix_x4_trans(af[i], sa + o);
        if (z < 2) {
          uint32_t ap[4];
          ldmatrix_x4_trans(ap, sp + o);
#pragma unroll
          for (int e = 0; e < 4; ++e) af[i][e] = add_bf16x2(af[i][e], ap[e]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)        // D: rows are tokens (k), cols n
        ldmatrix_x4_trans(bf[j], sd + (kk + lane % 8 + (q % 2) * 8) * kQwS +
                                     wn + j * 16 + (q / 2) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mma_bf16_16816(acc[i][j], af[i], &bf[j / 2][(j % 2) * 2]);
    }
    if (bias) {
#pragma unroll 4
      for (int r = 16 * rg; r < 16 * rg + 16; ++r) {
        const float2 d = unpack_bf16(
            *reinterpret_cast<const uint32_t*>(&sd[r * kQwS + 2 * cp]));
        bs0 += d.x;
        bs1 += d.y;
      }
    }
  }
  cp_async_wait<0>();
  float* out = p.partial + (size_t)chunk * (3 * C * C + 3 * C);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + g + 8 * h;
        const int n = n0 + wn + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(&out[z * C * C + m * C + n]) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  if (!bias) return;
  sm.bsum[rg][2 * cp] = bs0;
  sm.bsum[rg][2 * cp + 1] = bs1;
  __syncthreads();
  if (threadIdx.x < kQwTile) {
    const int c = threadIdx.x;
    out[3 * C * C + z * C + n0 + c] =
        ((sm.bsum[0][c] + sm.bsum[1][c]) + sm.bsum[2][c]) + sm.bsum[3][c];
  }
}

// the blocks of a persistent grid over `tiles` row tiles, each tile taken
// once by a block of every column slice: a multiple of kSlices
template <int C, typename Kern>
cudaError_t slice_grid(Kern kernel, int smem, int tiles,
                       int (&resident)[kMaxDevices], int* blocks) {
  constexpr int kSlices = PW<C>::kSlices;
  cudaError_t e = persistent_grid(kernel, PW<C>::kThreads, smem,
                                  tiles * kSlices, resident, blocks);
  if (e == cudaSuccess)
    *blocks = *blocks < kSlices ? kSlices : *blocks - *blocks % kSlices;
  return e;
}

template <int C>
cudaError_t launch_project(const ProjArgs& a, cudaStream_t stream) {
  constexpr int kBytes = sizeof(ProjSmem<C>);
  static int resident[kMaxDevices];      // per device, for this C
  cudaError_t e = allow_smem(qkv_project_kernel<C>, kBytes);
  int blocks;
  if (e == cudaSuccess)
    e = slice_grid<C>(qkv_project_kernel<C>, kBytes,
                      (a.rows + PW<C>::kPT - 1) / PW<C>::kPT, resident,
                      &blocks);
  if (e != cudaSuccess) return e;
  qkv_project_kernel<C><<<blocks, PW<C>::kThreads, kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_project_bwd(const DxArgs& d, const QwArgs& w, int chunks,
                               float* grads, cudaStream_t stream) {
  constexpr int kDxBytes = sizeof(DxSmem<C>), kWgBytes = sizeof(WgSmem);
  constexpr int T = C / kQwTile;
  static int resident[kMaxDevices];      // per device, for this C
  cudaError_t e = allow_smem(qkv_project_dx_kernel<C>, kDxBytes);
  if (e == cudaSuccess) e = allow_smem(qkv_wgrad_kernel<C>, kWgBytes);
  int blocks;
  if (e == cudaSuccess)
    e = slice_grid<C>(qkv_project_dx_kernel<C>, kDxBytes,
                      (d.rows + PW<C>::kPT - 1) / PW<C>::kPT, resident,
                      &blocks);
  if (e != cudaSuccess) return e;
  qkv_project_dx_kernel<C><<<blocks, PW<C>::kThreads, kDxBytes, stream>>>(d);
  if (chunks > 0)
    qkv_wgrad_kernel<C>
        <<<3 * T * T * chunks, kQwThreads, kWgBytes, stream>>>(w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return sum_partials(w.partial, chunks, 3 * C * C + 3 * C, grads, stream);
}

// ---------------------------------------------------------------------------
// C 640, 768 and 1024: the projections and dx with the contraction streamed
// ---------------------------------------------------------------------------

// A resident slice ends at C 640: there 32 columns of the three weights
// and a 32-row tile take 244,608 bytes forward (past the 232,448 a block
// may hold), at C 768 even 16-row tiles 238,208, and at C 1024 the slice's
// weights alone 245,760.  So above C 512 a block owns one kPT-row tile
// and one NB-column slice of the three products (a grid of tiles x
// slices, a tile's slices adjacent, so that they read its rows from L2
// while the whole of the weights stays there), and the contraction
// streams through a two-stage cp.async ring in chunks of KC channels:
// the chunk's columns of the tile's x and pos rows (dq, dk and dv for dx)
// and the matching KC rows of the slice's weight columns (for dx the
// slice's NB weight rows, the chunk's KC columns).  The f32 accumulators
// persist across the chunks and every warp walks k upwards in steps of
// 16, as the resident kernels do, so the sums and the dtype points are
// theirs.  Eight warps (16 rows and 32 columns each, all three products),
// 92,928 bytes forward and 110,592 for dx: two blocks an SM; the ring
// holds the staged output tile once the last chunk is consumed.
template <int C>
struct PS {
  static_assert(C > 512 && C % 128 == 0, "the wide row widths");
  static constexpr int NB = 64;          // output columns a block
  static constexpr int kPT = 64;         // rows a tile
  static constexpr int KC = 64;          // channels a chunk
  static constexpr int kChunks = C / KC;
  static constexpr int kSlices = C / NB;
  static constexpr int kColGroups = NB / kWarpCols;
  static constexpr int kThreads = 32 * (kPT / 16) * kColGroups;
  static constexpr int kAS = KC + kPad;  // bf16 row stride of a chunk
  static constexpr int kOS = NB + kPad;  // bf16 row stride of a slice
  static constexpr int kAElems = kPT * kAS;
  static constexpr int kOutElems = kPT * kOS;
  static constexpr int kChunkPieces = KC / 8;   // 16-byte pieces a row
  static constexpr int kOutPieces = NB / 8;
};

template <int C>
struct ProjStreamSmem {                  // forward
  struct Stage {
    bf16 in[2][PS<C>::kAElems];          // x, pos: the chunk's columns
    bf16 w[3][PS<C>::KC * PS<C>::kOS];   // Wq, Wk, Wv: its rows, the slice
  } ring[2];
  float bias[3][PS<C>::NB];
};
template <int C>
struct DxStreamSmem {                    // backward's dx
  struct Stage {
    bf16 in[3][PS<C>::kAElems];          // dq, dk, dv: the chunk's columns
    bf16 w[3][PS<C>::NB * PS<C>::kAS];   // the slice's rows of Wq, Wk, Wv
  } ring[2];
};
static_assert(sizeof(ProjStreamSmem<1024>) == 92928 &&
                  sizeof(DxStreamSmem<1024>) == 110592 &&
                  3 * PS<1024>::kOutElems * sizeof(bf16) <=
                      sizeof(ProjStreamSmem<1024>::ring),
              "two blocks an SM; the output tile fits the ring");

// acc += A (the warp's fragment, 16 rows x 16 k) times W over the warp's
// output columns nw.. and k rows kk..kk+15 of a staged chunk: W as stored
// [k][n] with row stride kS (kWT false), or W^T read from W's rows [n][k]
// with row stride kS (kWT true)
template <int kS, bool kWT>
__device__ __forceinline__ void mma_chunk(float (&acc)[kWarpCols / 8][4],
                                          const uint32_t (&a)[4],
                                          const bf16* w, int kk, int nw) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kWarpCols / 16; ++j) {
    uint32_t b[4];
    if (kWT)
      ldmatrix_x4(b, w + (nw + 16 * j + lane % 8 + (lane / 16) * 8) * kS +
                         kk + ((lane / 8) % 2) * 8);
    else
      ldmatrix_x4_trans(b, w + (kk + lane % 8 + ((lane / 8) % 2) * 8) * kS +
                               nw + 16 * j + (lane / 16) * 8);
    mma_bf16_16816(acc[2 * j], a, &b[0]);
    mma_bf16_16816(acc[2 * j + 1], a, &b[2]);
  }
}

// the chunk at column k0 of rows r0.. of the [rows][C] tensors s0..s(N-1)
// into the N [kPT][kAS] tiles at dst; rows past `rows` zero-filled
template <int C, int N>
__device__ __forceinline__ void stage_chunk(bf16* dst, const bf16* s0,
                                            const bf16* s1, const bf16* s2,
                                            int r0, int k0, int rows) {
  using S = PS<C>;
  for (int e = threadIdx.x; e < N * S::kPT * S::kChunkPieces;
       e += S::kThreads) {
    const int a = e / (S::kPT * S::kChunkPieces),
              r = (e / S::kChunkPieces) % S::kPT;
    const int c = (e % S::kChunkPieces) * 8;
    const bool ok = r0 + r < rows;
    const bf16* src = a == 0 ? s0 : a == 1 ? s1 : s2;
    cp_async_16(dst + a * S::kAElems + r * S::kAS + c,
                src + (size_t)(ok ? r0 + r : 0) * C + k0 + c, ok);
  }
}

// the N staged [kPT][kOS] slice tiles at src, rows below `rows`, to rows
// r0.. and columns n0.. of d0, d1 (and d2 when N is 3), 16 bytes a lane
template <int C, int N>
__device__ __forceinline__ void write_slice(bf16* d0, bf16* d1, bf16* d2,
                                            const bf16* src, int r0, int n0,
                                            int rows) {
  using S = PS<C>;
  for (int e = threadIdx.x; e < N * S::kPT * S::kOutPieces;
       e += S::kThreads) {
    const int a = e / (S::kPT * S::kOutPieces),
              r = (e / S::kOutPieces) % S::kPT;
    const int c = (e % S::kOutPieces) * 8;
    bf16* dst = a == 0 ? d0 : a == 1 ? d1 : d2;
    if (r0 + r < rows)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * C + n0 + c) =
          *reinterpret_cast<const uint4*>(src + a * S::kOutElems +
                                          r * S::kOS + c);
  }
}

// qkv_project_kernel's function above C 512: q, k, v [rows][C], per row
// round(round((x + pos) W) + b) (x for v), 0 on padding rows
template <int C>
__global__ void __launch_bounds__(PS<C>::kThreads, 2)
qkv_project_stream_kernel(ProjArgs p) {
  using S = PS<C>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ProjStreamSmem<C>& sm = *reinterpret_cast<ProjStreamSmem<C>*>(smem_raw);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int r16 = 16 * (warp / S::kColGroups);
  const int nw = kWarpCols * (warp % S::kColGroups);
  const int n0 = (blockIdx.x % S::kSlices) * S::NB;
  const int r0 = (blockIdx.x / S::kSlices) * S::kPT;

  // chunk c: its columns of x and pos, its KC rows of the slice's weights
  auto stage = [&](int c, int b) {
    const int k0 = c * S::KC;
    stage_chunk<C, 2>(sm.ring[b].in[0], p.x, p.pos, nullptr, r0, k0,
                      p.rows);
    for (int e = threadIdx.x; e < 3 * S::KC * S::kOutPieces;
         e += S::kThreads) {
      const int m = e / (S::KC * S::kOutPieces),
                r = (e / S::kOutPieces) % S::KC;
      const int col = (e % S::kOutPieces) * 8;
      const bf16* src = m == 0 ? p.wq : m == 1 ? p.wk : p.wv;
      cp_async_16(&sm.ring[b].w[m][r * S::kOS + col],
                  src + (size_t)(k0 + r) * C + n0 + col);
    }
    cp_async_commit();
  };
  stage(0, 0);
  for (int e = threadIdx.x; e < 3 * S::NB; e += S::kThreads) {
    const int o = e / S::NB, c = e % S::NB;
    const bf16* b = o == 0 ? p.bq : o == 1 ? p.bk : p.bv;
    sm.bias[o][c] = to_f<bf16>(b[n0 + c]);
  }

  float acc[3][kWarpCols / 8][4] = {};
  for (int c = 0; c < S::kChunks; ++c) {
    const int b = c & 1;
    cp_async_wait<0>();
    __syncthreads();               // chunk c landed; chunk c - 1's stage
                                   // is consumed
    if (c + 1 < S::kChunks) stage(c + 1, b ^ 1);
    const bf16* xs = sm.ring[b].in[0] + (r16 + lane % 16) * S::kAS +
                     (lane / 16) * 8;
    const bf16* ps = xs + S::kAElems;
#pragma unroll
    for (int kk = 0; kk < S::KC; kk += 16) {
      uint32_t ax[4], axp[4];
      ldmatrix_x4(ax, xs + kk);
      ldmatrix_x4(axp, ps + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) axp[i] = add_bf16x2(ax[i], axp[i]);
      mma_chunk<S::kOS, false>(acc[0], axp, sm.ring[b].w[0], kk, nw);
      mma_chunk<S::kOS, false>(acc[1], axp, sm.ring[b].w[1], kk, nw);
      mma_chunk<S::kOS, false>(acc[2], ax, sm.ring[b].w[2], kk, nw);
    }
  }
  // the lane's rows g, g + 8: real (not padding, not past the end)
  bool real[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int r = r0 + r16 + g + 8 * rh;
    real[rh] = r < p.rows && __ldg(p.win + r) != kInt32Max;
  }
  __syncthreads();                 // the ring is consumed: it takes the
                                   // output tile
  bf16* out = sm.ring[0].in[0];
#pragma unroll
  for (int o = 0; o < 3; ++o)
#pragma unroll
    for (int nb = 0; nb < kWarpCols / 8; ++nb) {
      const int c = nw + 8 * nb + 2 * t;
      const float b0 = sm.bias[o][c], b1 = sm.bias[o][c + 1];
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const float* a = &acc[o][nb][2 * rh];
        *reinterpret_cast<uint32_t*>(
            &out[o * S::kOutElems + (r16 + g + 8 * rh) * S::kOS + c]) =
            real[rh] ? pack_bf16(rbf(a[0]) + b0, rbf(a[1]) + b1) : 0u;
      }
    }
  __syncthreads();
  write_slice<C, 3>(p.q, p.k, p.v, out, r0, n0, p.rows);
}

// qkv_project_dx_kernel's function above C 512: dx [rows][C] =
// round(round(dq Wq^T) + round(dk Wk^T + dv Wv^T))
template <int C>
__global__ void __launch_bounds__(PS<C>::kThreads, 2)
qkv_project_dx_stream_kernel(DxArgs p) {
  using S = PS<C>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DxStreamSmem<C>& sm = *reinterpret_cast<DxStreamSmem<C>*>(smem_raw);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int r16 = 16 * (warp / S::kColGroups);
  const int nw = kWarpCols * (warp % S::kColGroups);
  const int n0 = (blockIdx.x % S::kSlices) * S::NB;
  const int r0 = (blockIdx.x / S::kSlices) * S::kPT;

  // chunk c: its columns of dq, dk, dv and of the slice's weight rows
  auto stage = [&](int c, int b) {
    const int k0 = c * S::KC;
    stage_chunk<C, 3>(sm.ring[b].in[0], p.dq, p.dk, p.dv, r0, k0, p.rows);
    for (int e = threadIdx.x; e < 3 * S::NB * S::kChunkPieces;
         e += S::kThreads) {
      const int m = e / (S::NB * S::kChunkPieces),
                r = (e / S::kChunkPieces) % S::NB;
      const int col = (e % S::kChunkPieces) * 8;
      const bf16* src = m == 0 ? p.wq : m == 1 ? p.wk : p.wv;
      cp_async_16(&sm.ring[b].w[m][r * S::kAS + col],
                  src + (size_t)(n0 + r) * C + k0 + col);
    }
    cp_async_commit();
  };
  stage(0, 0);

  float aq[kWarpCols / 8][4] = {}, akv[kWarpCols / 8][4] = {};
  for (int c = 0; c < S::kChunks; ++c) {
    const int b = c & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (c + 1 < S::kChunks) stage(c + 1, b ^ 1);
    const bf16* in = sm.ring[b].in[0] + (r16 + lane % 16) * S::kAS +
                     (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < S::KC; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, in + kk);
      mma_chunk<S::kAS, true>(aq, a, sm.ring[b].w[0], kk, nw);
      ldmatrix_x4(a, in + S::kAElems + kk);
      mma_chunk<S::kAS, true>(akv, a, sm.ring[b].w[1], kk, nw);
      ldmatrix_x4(a, in + 2 * S::kAElems + kk);
      mma_chunk<S::kAS, true>(akv, a, sm.ring[b].w[2], kk, nw);
    }
  }
  __syncthreads();                 // the ring takes the output tile
  bf16* out = sm.ring[0].in[0];
#pragma unroll
  for (int nb = 0; nb < kWarpCols / 8; ++nb)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int e = 2 * rh;
      *reinterpret_cast<uint32_t*>(
          &out[(r16 + g + 8 * rh) * S::kOS + nw + 8 * nb + 2 * t]) =
          pack_bf16(rbf(aq[nb][e]) + rbf(akv[nb][e]),
                    rbf(aq[nb][e + 1]) + rbf(akv[nb][e + 1]));
    }
  __syncthreads();
  write_slice<C, 1>(p.dx, nullptr, nullptr, out, r0, n0, p.rows);
}

// a grid of every (tile, slice) pair, at least one tile
template <int C>
int stream_blocks(int rows) {
  const int tiles = (rows + PS<C>::kPT - 1) / PS<C>::kPT;
  return (tiles > 0 ? tiles : 1) * PS<C>::kSlices;
}

template <int C>
cudaError_t launch_project_stream(const ProjArgs& a, cudaStream_t stream) {
  constexpr int kBytes = sizeof(ProjStreamSmem<C>);
  cudaError_t e = allow_smem(qkv_project_stream_kernel<C>, kBytes);
  if (e != cudaSuccess) return e;
  qkv_project_stream_kernel<C>
      <<<stream_blocks<C>(a.rows), PS<C>::kThreads, kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_project_bwd_stream(const DxArgs& d, const QwArgs& w,
                                      int chunks, float* grads,
                                      cudaStream_t stream) {
  constexpr int kDxBytes = sizeof(DxStreamSmem<C>), kWgBytes = sizeof(WgSmem);
  constexpr int T = C / kQwTile;
  cudaError_t e = allow_smem(qkv_project_dx_stream_kernel<C>, kDxBytes);
  if (e == cudaSuccess) e = allow_smem(qkv_wgrad_kernel<C>, kWgBytes);
  if (e != cudaSuccess) return e;
  qkv_project_dx_stream_kernel<C>
      <<<stream_blocks<C>(d.rows), PS<C>::kThreads, kDxBytes, stream>>>(d);
  if (chunks > 0)
    qkv_wgrad_kernel<C>
        <<<3 * T * T * chunks, kQwThreads, kWgBytes, stream>>>(w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return sum_partials(w.partial, chunks, 3 * C * C + 3 * C, grads, stream);
}

// The tables a translation unit of one C hands the entry points
template <int C>
const QkvF32Kernels* qkv_f32_at(int D) {
  if constexpr (C % 3 == 0) {   // heads of 3 to 192: at C 384 alone
    static const QkvF32Kernels k3{launch<C, 3>, launch_bwd<C, 3>};
    static const QkvF32Kernels k6{launch<C, 6>, launch_bwd<C, 6>};
    static const QkvF32Kernels k12{launch<C, 12>, launch_bwd<C, 12>};
    static const QkvF32Kernels k24{launch<C, 24>, launch_bwd<C, 24>};
    static const QkvF32Kernels k48{launch<C, 48>, launch_bwd<C, 48>};
    static const QkvF32Kernels k96{launch<C, 96>, launch_bwd<C, 96>};
    static const QkvF32Kernels k192{launch<C, 192>, launch_bwd<C, 192>};
    if (D == 3) return &k3;
    if (D == 6) return &k6;
    if (D == 12) return &k12;
    if (D == 24) return &k24;
    if (D == 48) return &k48;
    if (D == 96) return &k96;
    if (D == 192) return &k192;
  }
  if constexpr (C % 256 == 0) {   // heads of 256: at C 256 and 512
    static const QkvF32Kernels k256{launch<C, 256>, launch_bwd<C, 256>};
    if (D == 256) return &k256;
  }
  if constexpr (C > 256) {        // one head of 384 or 512
    static const QkvF32Kernels k1{launch<C, C>, launch_bwd<C, C>};
    if (D == C) return &k1;
  }
  static const QkvF32Kernels k1{launch<C, 1>, launch_bwd<C, 1>};
  static const QkvF32Kernels k2{launch<C, 2>, launch_bwd<C, 2>};
  static const QkvF32Kernels k4{launch<C, 4>, launch_bwd<C, 4>};
  static const QkvF32Kernels k8{launch<C, 8>, launch_bwd<C, 8>};
  static const QkvF32Kernels k16{launch<C, 16>, launch_bwd<C, 16>};
  static const QkvF32Kernels k32{launch<C, 32>, launch_bwd<C, 32>};
  static const QkvF32Kernels k64{launch<C, 64>, launch_bwd<C, 64>};
  static const QkvF32Kernels k128{launch<C, 128>, launch_bwd<C, 128>};
  switch (D) {
    case 1: return &k1;
    case 2: return &k2;
    case 4: return &k4;
    case 8: return &k8;
    case 16: return &k16;
    case 32: return &k32;
    case 64: return &k64;
    case 128: return &k128;
    default: return nullptr;
  }
}

template <int C>
const QkvProjKernels* qkv_proj_at() {
  if constexpr (C > 512) {        // the contraction streamed
    static const QkvProjKernels k{launch_project_stream<C>,
                                  launch_project_bwd_stream<C>};
    return &k;
  } else {
    static const QkvProjKernels k{launch_project<C>, launch_project_bwd<C>};
    return &k;
  }
}

}  // namespace
}  // namespace geomae
