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
// Widths: every kernel is a template over (C, F), the model width and the
// FFN width; Widths<C, F> derives the tiles, chunk streams and buffers
// from them (C a multiple of 128, F a multiple of 128 and at least C).
// The port builds C of 128, 256, 384, 512, 640, 768 and 1024 with F of 1,
// 2, 3 or 4 times C, one translation unit each (post_attention_c*_f*.cu,
// compiled in parallel); post_attention.cu picks one by the widths it is
// given.  The token tile shrinks as the rows widen, so that a block's
// rows fit its shared memory (the bf16 tile pass 64, 32 or 16 tokens, the
// f32 kernels 32, 16, 8 or 4), and the bf16 forward runs two blocks an SM
// where two fit, else one.  Where a tile's rows are too short to hold a
// block's last reduction (the f32 backward at C >= 384, the bf16 tile
// pass at C 512) it goes to the start of the block's shared memory, all
// of it consumed by then, one [C] vector at a time where the whole does
// not fit there.  At (512, 1536), (512, 2048), (640, 1280) and (640,
// 1920) a 16-token tile's two F-wide rows do not fit the tile pass
// (Widths::kOneHiddenRow): it keeps one, parks a1 in the da1 workspace
// and sums db1 in shared memory.  At the other widths of C 640 and more
// but (640, 640) and (768, 768) not even one fits (kNoHiddenRow: 2,432
// to 143,744 bytes over at 16 tokens): the tile pass keeps three C-wide
// rows (dy is read from device memory where LN2's backward needs it) and
// a 128-column pass buffer, and streams the hidden rows through it, one
// 128-column pass of F at a time: a1 = xm W1 + b1 into the buffer, to
// the da1 workspace, h = gelu(a1) over it and to the h workspace, then
// the pass's share of o2 = h W2 (its 128 k-rows) added to f32
// accumulators that each warp holds in registers over all passes (8 C /
// 128 floats a lane, 64 at C 1024); in the backward dh = dz2 W2^T into
// the buffer, da1 = dh gelu'(a1) with a1 read back from the workspace by
// the thread that wrote it, then dxm += da1 W1^T the same way.  The
// weight chunks stream in that order (stream_chunk), and each f32
// accumulator adds its k-rows in the order of the stage order, so the
// kernel rounds where the other widths' kernels round and
// post_attention_block_backward_tile_plain stays its plain twin.  The
// bf16 forward streams the same way at (1024, 3072) and (1024, 4096)
// (kFwdStream), where an F-wide row does not fit beside its tile.
//
// Forward.  Bound at (128, 256): 2*(C*C + 2*C*F) = 147,456 operations a
// token against 768 bytes moved in bf16 (x and attn read, y written; the
// weights, 160 KB, once a call): at [4, 20480] the bytes take 0.0189 ms,
// the tensor cores' share of the operations 0.0136 ms, so bytes bound it.
// At (256, 512) the operations are four times as many a token against
// twice the bytes.
//
// bfloat16, on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate; mma.cuh): post_attention_fwd_tc_kernel is stages 0-2 of the
// tile pass below, the part that the backward's per-tile pass recomputes,
// through the same device functions (the product pass, the staging, the
// row-wise steps), so the two round at the same points by construction.
// A persistent grid walks token tiles; each block streams the weights
// through a two-buffer cp.async ring and keeps the tile's rows in shared
// memory (attn then xm, x then o2, o then a1 and h over it; 109,568 bytes
// at (128, 256)); 102 registers there: two blocks an SM (at every width
// but F = 3 C, whose rows leave room for one), so one block's row-wise
// work overlaps the other's products.  At (128, 256) it stands
// at about a tenth of its bound (PERF.md): the products take a few per
// cent of its time, the row-wise loops (bias, residual, two LayerNorms
// with their warp reductions, exact GELU) about 0.44 and the weight ring's
// waits about 0.17 (probe_forwards); one block an SM with a three-buffer
// ring is slower.
//
// float32, on the CUDA cores (post_attention_kernel): tensor cores take no
// f32 operand without TF32 rounding.  A block takes a tile of TT tokens
// (32; 16 at C = 256 and at (384, 384) / (384, 768) / (512, 512); 8 at
// (384, 1152), (384, 1536) and (512, 1024)) and keeps every intermediate
// ([TT, C] residuals, the [TT, F] hidden) in shared memory, so one read
// of x and attn and one write of y reach device memory, as on the TPU;
// the weights stream through the read-only cache, each thread owning one
// output column of a 256-column block (of a 128-column one where 256 does
// not divide the width, 384 or 1152) for its token rows held in
// registers.  Bound: the CUDA cores' f32 rate, 0.20 ms at [4, 20480] and
// (128, 256).
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
// kTT tokens, 8 warps, the six products, dx, dattn, the vector gradients
// and the bf16 rows the weight gradients need, xm, da1, h and dz2: 2 (2 C
// + 2 F) bytes a token, each a value JAX also holds in bf16 before its
// product, so storing it is exact), then the weight gradients split over
// 2,048-token chunks (wgrad_kernel).  At (128, 256) the tile pass takes
// 180 registers and 197,120 bytes of dynamic shared memory, one block per
// SM; the weight pass 80 registers and 36,864 bytes.  Where a 16-token
// tile's rows of a1 and h do not fit ((512, 1536), (512, 2048)), the pass
// keeps h's row alone: stage kA1 writes the biased a1 to the da1
// workspace (the tile's own rows, each by the thread that reads it back),
// kDH stages dh over h, reads a1 back and writes da1 over dh and over the
// workspace, and kDXM reads da1 from that row; b1's gradient, whose F / 32
// floats a lane would spill, sums the staged da1 rows by column in shared
// memory instead of in registers (189,824 + 6,144 and 208,256 + 8,192
// bytes).  Bound: the card
// could do the 6 products in 0.04 ms at [4, 20480] (operations); the tile
// pass stands far above that (PERF.md): it issues mma.sync, not wgmma,
// from one block of 8 warps per SM, and its row-wise CUDA-core work
// (LayerNorms, GELU, their backward) between the products is a large
// share of its time.
//
// float32, on the CUDA cores (post_attention_bwd_kernel): tensor cores
// take no f32 operand without TF32 rounding.  A TT-token tile keeps its
// intermediates in shared memory (144 KB at (128, 256)); a persistent
// grid of one block per SM walks the tiles, each block adds its tiles'
// outer products to its own f32 partial in device memory (L2-resident at
// (128, 256)), and sum_partials adds the partials in block order.  Bound:
// the CUDA cores, about 3x the forward's FLOPs plus one partial read and
// write per tile.  The partial is C C + 2 C F + 6 C + F floats a block:
// at (512, 1024) 5.3 MB, 694 MB over 132 blocks, far past the L2, read
// and written once a tile of 8 tokens (a parity path, not the bf16 one).
#pragma once

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace geomae {

// Every pointer and size an entry point of K5 passes on, for the kernels
// of one width (K5Kernels).
struct K5Call {
  const void *x, *attn, *dy, *wo, *bo, *w1, *b1, *w2, *b2;
  const void *woT, *w1T, *w2T;     // the weights transposed (f32 backward)
  const float *s1, *t1, *s2, *t2;
  const int* nv;
  void *y, *dx, *dattn;
  void *xm, *da1, *h, *dz2;        // bf16 backward workspace rows
  float *vpartial, *partial, *grads;
  int B, V, nblocks;
  float eps;
  cudaStream_t stream;
};

struct K5Kernels {
  cudaError_t (*forward)(int dtype, const K5Call&);
  cudaError_t (*backward)(const K5Call&);       // f32
  cudaError_t (*backward_bf16)(const K5Call&);
  cudaError_t (*wgrad_bf16)(const K5Call&);
};

// one per width, each in its translation unit
const K5Kernels& k5_kernels_c128_f128();
const K5Kernels& k5_kernels_c128_f256();
const K5Kernels& k5_kernels_c128_f384();
const K5Kernels& k5_kernels_c128_f512();
const K5Kernels& k5_kernels_c256_f256();
const K5Kernels& k5_kernels_c256_f512();
const K5Kernels& k5_kernels_c256_f768();
const K5Kernels& k5_kernels_c256_f1024();
const K5Kernels& k5_kernels_c384_f384();
const K5Kernels& k5_kernels_c384_f768();
const K5Kernels& k5_kernels_c384_f1152();
const K5Kernels& k5_kernels_c384_f1536();
const K5Kernels& k5_kernels_c512_f512();
const K5Kernels& k5_kernels_c512_f1024();
const K5Kernels& k5_kernels_c512_f1536();
const K5Kernels& k5_kernels_c512_f2048();
const K5Kernels& k5_kernels_c640_f640();
const K5Kernels& k5_kernels_c640_f1280();
const K5Kernels& k5_kernels_c640_f1920();
const K5Kernels& k5_kernels_c640_f2560();
const K5Kernels& k5_kernels_c768_f768();
const K5Kernels& k5_kernels_c768_f1536();
const K5Kernels& k5_kernels_c768_f2304();
const K5Kernels& k5_kernels_c768_f3072();
const K5Kernels& k5_kernels_c1024_f1024();
const K5Kernels& k5_kernels_c1024_f2048();
const K5Kernels& k5_kernels_c1024_f3072();
const K5Kernels& k5_kernels_c1024_f4096();

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 227 * 1024;   // dynamic shared memory a block
constexpr int kSmemPerSM = 228 * 1024;  // an SM's, and what a block adds
constexpr int kSmemPerBlock = 1024;     // to its own for the runtime

// bf16 tile pass: every product is a pass of kNP output columns, its
// weight streamed in chunks of kKc k-rows
constexpr int kNP = 128;
constexpr int kKc = 64;
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kNS = kNP + kPad;                 // row stride of a W chunk
constexpr int kChunkElems = kNP * (kKc + kPad); // >= kKc * kNS
constexpr int kRing = 3;                        // the backward's buffers
constexpr int kFwdRing = 2;                     // the forward's
static_assert(kChunkElems >= kKc * kNS, "a chunk holds either layout");

// The stages of the tile pass, in stream order: the forward's o = attn
// Wo, a1 = xm W1, o2 = h W2, then the backward's dh = dz2 W2^T, da1 W1^T
// and dattn = dz1 Wo^T.  A stage of N output columns over K is N / kNP
// passes of K / kKc chunks each.
enum Stage { kO = 0, kA1, kO2, kDH, kDXM, kDATTN };

__host__ __device__ constexpr int stage_n(int C, int F, int s) {
  return s == kA1 || s == kDH ? F : C;
}
__host__ __device__ constexpr int stage_k(int C, int F, int s) {
  return s == kO2 || s == kDXM ? F : C;
}
__host__ __device__ constexpr int stage_start(int C, int F, int s) {
  return s == 0 ? 0
                : stage_start(C, F, s - 1) + (stage_n(C, F, s - 1) / kNP) *
                                                 (stage_k(C, F, s - 1) / kKc);
}

// shared memory of the f32 backward's and of the bf16 tile pass's blocks
// at tt tokens a tile; the tile pass with two F-wide rows a token (a1 and
// h) or with one (h, and db1's f32 sums beside the vector parameters)
__host__ __device__ constexpr int f32_bwd_bytes(int C, int F, int tt) {
  return (5 * tt * C + 2 * tt * F) * 4;
}
__host__ __device__ constexpr int tile_bytes(int C, int F, int tt,
                                             int hidden_rows = 2) {
  return (4 * tt * (C + kPad) + hidden_rows * tt * (F + kPad) +
          kRing * kChunkElems) *
             2 +
         (6 * C + F) * 4 + 2 * tt * 4 + (hidden_rows == 1 ? F * 4 : 0);
}
// the tile pass with no F-wide row (the hidden rows stream through a
// 128-column pass buffer, dy is read from device memory): three C-wide
// rows, the pass buffer, the ring, the vector parameters, LN1's
// statistics and db1's sums
__host__ __device__ constexpr int stream_tile_bytes(int C, int F, int tt) {
  return (3 * tt * (C + kPad) + tt * (kNP + kPad) + kRing * kChunkElems) *
             2 +
         (6 * C + F) * 4 + 2 * tt * 4 + F * 4;
}

template <int C_, int F_>
struct Widths {
  static constexpr int C = C_, F = F_;
  // F >= C: the forward stages o in the F-wide rows of a1 and h, and the
  // weight-gradient grid is sized by dW1's tiles, the most of the three
  static_assert(C % kNP == 0 && F % kNP == 0 && F >= C,
                "C and F multiples of 128, F at least C");

  // --- float32, CUDA cores: the token tile (32, 16, 8 or 4: the most
  // whose backward rows fit) and its shared memory
  static constexpr int TT = f32_bwd_bytes(C, F, 32) <= kMaxSmem   ? 32
                            : f32_bwd_bytes(C, F, 16) <= kMaxSmem ? 16
                            : f32_bwd_bytes(C, F, 8) <= kMaxSmem  ? 8
                                                                  : 4;
  static constexpr int kSmemBytes = (3 * TT * C + TT * F) * 4;
  static constexpr int kBwdSmemBytes = f32_bwd_bytes(C, F, TT);
  static constexpr int CL = C / 32;   // channels per lane, row-wise passes

  // --- the f32 parameter gradients in one buffer (a block's partial and
  // the summed result): dWo [C][C], dW1 [C][F], dW2 [F][C], dbo, ds1, dt1
  // [C], db1 [F], db2, ds2, dt2 [C].  ops/ffn.py splits it in this order.
  static constexpr int kOffW1 = C * C;
  static constexpr int kOffW2 = kOffW1 + C * F;
  static constexpr int kOffB1 = kOffW2 + F * C + 3 * C;
  static constexpr int kGradFloats = kOffB1 + F + 3 * C;
  static constexpr int kWeightFloats = kOffW2 + F * C;   // dWo, dW1, dW2
  static constexpr int kVecFloats = kGradFloats - kWeightFloats;   // 6C + F
  // the vector gradients within kVecFloats (the tail of the grads
  // layout), and the vector parameters in the same places
  static constexpr int kVbo = 0, kVs1 = C, kVt1 = 2 * C, kVb1 = 3 * C,
                       kVb2 = 3 * C + F, kVs2 = 4 * C + F,
                       kVt2 = 5 * C + F;

  // --- bfloat16, tensor cores: the tile pass
  static constexpr int kSC = C + kPad;   // shared row strides
  static constexpr int kSF = F + kPad;
  static constexpr int kSP = kNP + kPad;  // of a 128-column pass buffer
  // one F-wide row a token where two do not fit at 16 tokens ((512,
  // 1536), (512, 2048), (640, 1280), (640, 1920)): a1 waits in the da1
  // workspace, db1 sums in shared memory (the tile pass, below); none
  // where one does not fit either (the other widths of C 640 and more but
  // (640, 640) and (768, 768), which keep both): the hidden rows stream,
  // 128 columns a pass (kNoHiddenRow)
  static constexpr bool kNoHiddenRow = tile_bytes(C, F, 16, 1) > kMaxSmem;
  static constexpr bool kOneHiddenRow =
      !kNoHiddenRow && tile_bytes(C, F, 16) > kMaxSmem;
  static constexpr int kHiddenRows = kNoHiddenRow ? 0 : kOneHiddenRow ? 1 : 2;
  // db1 summed in shared memory by column, not in registers by lane
  static constexpr bool kDb1Shared = kHiddenRows < 2;
  // tokens a tile: 64 where the backward's rows fit, else 32, else 16
  static constexpr int kTT =
      kNoHiddenRow                                    ? 16
      : tile_bytes(C, F, 64, kHiddenRows) <= kMaxSmem ? 64
      : tile_bytes(C, F, 32, kHiddenRows) <= kMaxSmem ? 32
                                                      : 16;
  static constexpr int kTileSmemBytes =
      kNoHiddenRow ? stream_tile_bytes(C, F, kTT)
                   : tile_bytes(C, F, kTT, kHiddenRows);
  // the row stride of the tile pass's h: an F-wide row, or the pass
  // buffer
  static constexpr int kSH = kNoHiddenRow ? kSP : kSF;
  // the forward: an F-wide row (o, then a1 and h) where the tile and two
  // C-wide rows leave room for it, else a C-wide one (o, then each pass's
  // a1 and h in its first 128 columns) with o2 summed over the passes in
  // registers ((1024, 3072), (1024, 4096): kFwdStream)
  static constexpr bool kFwdStream =
      (2 * kTT * kSC + kTT * kSF + kFwdRing * kChunkElems) * 2 +
          kVecFloats * 4 >
      kMaxSmem;
  static constexpr int kSHF = kFwdStream ? kSC : kSF;
  static constexpr int kFwdSmemBytes =
      (2 * kTT * kSC + kTT * kSHF + kFwdRing * kChunkElems) * 2 +
      kVecFloats * 4;
  static constexpr int kWarpRows = kTT / kTileWarps;  // rows a warp's loops
  // a product pass: kTT / 16 row groups of 16 rows, each over the pass's
  // kNP columns in kWCG warps of kWN columns
  static constexpr int kWCG = kTileWarps / (kTT / 16);
  static constexpr int kWN = kNP / kWCG;
  static constexpr int kCG = C / kNP;    // column groups of a C row
  static constexpr int kFG = F / kNP;    // of an F row (and passes of F)
  static_assert(kTT >= 16 && kWN >= 16, "16-row, 16-column warp tiles");
  static_assert(kTileSmemBytes <= kMaxSmem, "one tile-pass block an SM");
  static_assert(!kNoHiddenRow || kTT == 16, "16-token streaming tiles");
  // forward blocks an SM by their shared memory: 2 where two fit, else 1
  static constexpr int kFwdBlocks =
      kSmemPerSM / (kFwdSmemBytes + kSmemPerBlock) >= 2 ? 2 : 1;
  static_assert(kFwdSmemBytes <= kMaxSmem, "one forward block an SM");
  // the last reduction's [kTileWarps][kVecFloats] f32: from s_a1 on where
  // the consumed rows from there hold it (kVecRedInRows), else from the
  // start of the block's shared memory (C 512: every row and the ring are
  // consumed by then; with one hidden row they hold it short of db1's sums)
  static constexpr bool kVecRedInRows =
      kTileWarps * kVecFloats * 4 <=
      (kHiddenRows * kTT * kSF + kRing * kChunkElems) * 2;
  static_assert(kNoHiddenRow ||
                    kTileWarps * kVecFloats * 4 <= kTileSmemBytes,
                "the vector gradients' reduction fits the block's rows");
  // with no hidden row the six [C] gradients reduce one at a time, each
  // [kTileWarps][C] from the start of shared memory, short of db1's sums
  static_assert(!kNoHiddenRow ||
                    kTileWarps * C * 4 <= 3 * kTT * kSC * 2,
                "a [C] gradient's reduction fits the consumed rows");
  static_assert(!kOneHiddenRow ||
                    kTileWarps * kVecFloats * 4 <=
                        (4 * kTT * kSC + kTT * kSF + kRing * kChunkElems) * 2,
                "the reduction leaves db1's sums as they are");
  // the f32 backward's [kWarps][6][C] reduction, then db1's [row
  // groups][F]: over its s_a1 and s_h where they hold it (kF32RedInRows),
  // else from the start of its shared memory (a tile of 8 or 16 tokens
  // at C >= 384: every tile's rows are consumed by then)
  static constexpr int kF32RedFloats =
      kWarps * 6 * C + kThreads / pass_columns(F, kThreads) * F;
  static constexpr bool kF32RedInRows = kF32RedFloats <= 2 * TT * F;
  // where the whole reduction does not fit ((768, 2304), (1024, 2048),
  // (1024, 3072)) the six [C] vectors reduce one at a time, then db1's
  static constexpr bool kF32RedByVector = kF32RedFloats * 4 > kBwdSmemBytes;
  static_assert((kWarps * C + kThreads / pass_columns(F, kThreads) * F) * 4 <=
                    kBwdSmemBytes,
                "f32 reduction fits");

  // each stage's first chunk in a tile's stream, and the stream's length:
  // the forward's (stages kO-kO2) and the backward's
  static constexpr int kStartO = 0, kStartA1 = stage_start(C, F, kA1),
                       kStartO2 = stage_start(C, F, kO2),
                       kStartDH = stage_start(C, F, kDH),
                       kStartDXM = stage_start(C, F, kDXM),
                       kStartDATTN = stage_start(C, F, kDATTN);
  static constexpr int kFwdChunks = kStartDH;
  static constexpr int kTileChunks = stage_start(C, F, kDATTN + 1);
  // the streaming order (kNoHiddenRow's tile pass, kFwdStream's forward):
  // kO, then per 128-column pass of F its a1 chunks (C / kKc) and the o2
  // chunks it feeds (C / kNP column groups of kNP / kKc), then the same
  // for dh and dxm, then kDATTN; every stage starts where it does in the
  // stage order
  static constexpr int kPerF = 2 * (C / kKc);
};
static_assert(Widths<128, 256>::kTT == 64 &&
                  Widths<128, 256>::kTileSmemBytes == 197120 &&
                  Widths<128, 256>::kFwdSmemBytes == 109568 &&
                  Widths<128, 256>::kFwdChunks == 10 &&
                  Widths<128, 256>::kTileChunks == 20 &&
                  Widths<128, 256>::TT == 32,
              "the shipped width's tiles");
static_assert(Widths<128, 256>::kFwdBlocks == 2 &&
                  Widths<128, 384>::kFwdBlocks == 1,
              "two forward blocks an SM where two fit");
// C 128 and 256 reduce where they did; the f32 tile drops to 8 tokens
// where 16 do not fit, and the reductions move where the rows are short
static_assert(Widths<128, 256>::kVecRedInRows &&
                  Widths<128, 256>::kF32RedInRows &&
                  Widths<256, 1024>::kVecRedInRows &&
                  Widths<256, 1024>::kF32RedInRows,
              "the reductions of C 128 and 256 stay in the consumed rows");
static_assert(Widths<384, 384>::kTT == 32 && Widths<384, 384>::TT == 16 &&
                  Widths<384, 1152>::TT == 8 &&
                  Widths<512, 1024>::kTT == 16 &&
                  Widths<512, 1024>::TT == 8 &&
                  !Widths<384, 384>::kF32RedInRows &&
                  !Widths<512, 512>::kVecRedInRows,
              "the tiles and reduction homes of C 384 and 512");
// one hidden row at F 3 C and 4 C of C 512 alone
// at C 640 and more two at (640, 640) and (768, 768), one at (640, 1280)
// and (640, 1920), none elsewhere; the forward streams at (1024, 3072) and
// (1024, 4096) alone; the f32 tile drops to 4 tokens at 7 of the 12
static_assert(Widths<640, 640>::kHiddenRows == 2 &&
                  Widths<768, 768>::kHiddenRows == 2 &&
                  Widths<640, 1280>::kOneHiddenRow &&
                  Widths<640, 1920>::kOneHiddenRow &&
                  Widths<640, 2560>::kNoHiddenRow &&
                  Widths<768, 1536>::kNoHiddenRow &&
                  Widths<1024, 1024>::kNoHiddenRow &&
                  !Widths<1024, 2048>::kFwdStream &&
                  Widths<1024, 3072>::kFwdStream &&
                  Widths<1024, 4096>::kFwdStream &&
                  Widths<1024, 4096>::kTileSmemBytes == 216192 &&
                  Widths<1024, 4096>::kFwdSmemBytes == 176896 &&
                  Widths<640, 1920>::TT == 8 && Widths<640, 2560>::TT == 4 &&
                  Widths<1024, 1024>::TT == 8 &&
                  Widths<1024, 4096>::TT == 4 &&
                  Widths<1024, 2048>::kF32RedByVector &&
                  !Widths<1024, 4096>::kF32RedByVector &&
                  !Widths<512, 2048>::kF32RedByVector,
              "the tiles of C 640, 768 and 1024");
static_assert(!Widths<512, 1024>::kOneHiddenRow &&
                  !Widths<384, 1536>::kOneHiddenRow &&
                  Widths<512, 1536>::kOneHiddenRow &&
                  Widths<512, 2048>::kOneHiddenRow &&
                  Widths<512, 1536>::kTileSmemBytes == 195968 &&
                  Widths<512, 2048>::kTileSmemBytes == 216448 &&
                  Widths<512, 2048>::kTT == 16 && Widths<512, 2048>::TT == 8 &&
                  Widths<512, 2048>::kF32RedInRows,
              "the tiles of (512, 1536) and (512, 2048)");

// acc[j] = sum_k a[row(j)][k] W[k][col(pass)] for the tile's rows; a is
// shared [TT][K], W is [K][N].  Thread: column pass * NW + tid % NW of
// the pass's NW = pass_columns(N, kThreads) columns (N below 256, 256,
// or 128 at N = 384), rows tid / NW + RG * j.
template <typename T, int K, int N, int TT>
struct Proj {
  static constexpr int NW = pass_columns(N, kThreads);
  static constexpr int kPasses = N / NW;
  static constexpr int RG = kThreads / NW;
  static constexpr int RPT = TT / RG;
  static_assert(kThreads % NW == 0 && N % NW == 0 && TT % RG == 0,
                "tile shape");

  __device__ static int col(int pass) {
    return pass * NW + threadIdx.x % NW;
  }
  __device__ static int row(int j) { return threadIdx.x / NW + RG * j; }

  __device__ static void run(const float* __restrict__ a,
                             const T* __restrict__ W, int pass,
                             float (&acc)[RPT]) {
    const int c = col(pass);
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Lane's channels of row r of the shared [TT][C] tile z, normalised:
// xhat = (z - mu) * rs with f32 stats, var = E[z^2] - mu^2.
template <int C>
__device__ __forceinline__ float row_xhat(const float* z, int r, float eps,
                                          float (&xh)[C / 32]) {
  constexpr int CL = C / 32;
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
// (out may be z).  One warp per row, C / 32 channels per lane.
template <typename T, int C, int TT>
__device__ __forceinline__ void layer_norm(const float* z, float* out,
                                           const float* __restrict__ s,
                                           const float* __restrict__ t,
                                           float eps) {
  constexpr int CL = C / 32;
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < TT; r += kWarps) {
    float xh[CL];
    row_xhat<C>(z, r, eps, xh);
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
template <typename T, int C, int TT>
__device__ __forceinline__ void layer_norm_bwd(const float* z, const float* dy,
                                               float* dz,
                                               const float* __restrict__ s,
                                               float eps, float (&ds)[C / 32],
                                               float (&dt)[C / 32],
                                               float (&db)[C / 32]) {
  constexpr int CL = C / 32;
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < TT; r += kWarps) {
    float xh[CL], d[CL], g[CL], sg = 0.f, sgx = 0.f;
    const float rs = row_xhat<C>(z, r, eps, xh);
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

template <int C, int F>
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
  constexpr int TT = Widths<C, F>::TT;
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
    using P = Proj<float, C, C, TT>;
    for (int pass = 0; pass < P::kPasses; ++pass) {
      float acc[P::RPT];
      P::run(s_a, wo, pass, acc);
      const int c = P::col(pass);
      const float bc = bo[c];
#pragma unroll
      for (int j = 0; j < P::RPT; ++j)
        s_o[P::row(j) * C + c] = acc[j] + bc;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TT * C; i += kThreads)
    s_a[i] = s_z[i] + s_o[i];
  __syncthreads();
  layer_norm<float, C, TT>(s_a, s_a, s1, t1, eps);       // s_a = xm
  __syncthreads();

  {  // h = gelu(xm W1 + b1)
    using P = Proj<float, C, F, TT>;
    for (int pass = 0; pass < P::kPasses; ++pass) {
      float acc[P::RPT];
      P::run(s_a, w1, pass, acc);
      const int c = P::col(pass);
      const float bc = b1[c];
#pragma unroll
      for (int j = 0; j < P::RPT; ++j)
        s_h[P::row(j) * F + c] = gelu(acc[j] + bc);
    }
  }
  __syncthreads();

  {  // o2 = h W2 + b2;  z2 = xm + o2
    using P = Proj<float, F, C, TT>;
    for (int pass = 0; pass < P::kPasses; ++pass) {
      float acc[P::RPT];
      P::run(s_h, w2, pass, acc);
      const int c = P::col(pass);
      const float bc = b2[c];
#pragma unroll
      for (int j = 0; j < P::RPT; ++j) {
        const int r = P::row(j);
        s_z[r * C + c] = s_a[r * C + c] + (acc[j] + bc);
      }
    }
  }
  __syncthreads();
  layer_norm<float, C, TT>(s_z, s_z, s2, t2, eps);
  __syncthreads();

  for (int i = threadIdx.x; i < rows * C; i += kThreads)
    y[base + i] = i < nr * C ? s_z[i] : 0.f;
}

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

template <typename T, int C, int F>
__global__ void __launch_bounds__(kThreads)
post_attention_bwd_kernel(BwdArgs p) {
  using Wd = Widths<C, F>;
  constexpr int TT = Wd::TT, CL = Wd::CL;
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
  float* P = p.partial + (size_t)blockIdx.x * Wd::kGradFloats;

  // per lane: the [C] gradients of its channels over its rows, all tiles
  float ds2[CL] = {}, dt2[CL] = {}, db2[CL] = {};
  float ds1[CL] = {}, dt1[CL] = {}, dbo[CL] = {};
  // the da1 columns: thread t owns PF::col(j), over its row group's rows
  using PF = Proj<T, C, F, TT>;
  float db1[PF::kPasses] = {};

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
      using Pj = Proj<T, C, C, TT>;
      for (int pass = 0; pass < Pj::kPasses; ++pass) {
        float acc[Pj::RPT];
        Pj::run(s_at, static_cast<const T*>(p.wo), pass, acc);
        const int c = Pj::col(pass);
        const float bc = to_f<T>(bo[c]);
#pragma unroll
        for (int j = 0; j < Pj::RPT; ++j) {
          const int r = Pj::row(j);
          s_z[r * C + c] = round_t<T>(s_z[r * C + c] +
                                      round_t<T>(round_t<T>(acc[j]) + bc));
        }
      }
    }
    __syncthreads();
    layer_norm<T, C, TT>(s_z, s_xm, p.s1, p.t1, p.eps);
    __syncthreads();
    // a1 = xm W1 + b1; h = gelu(a1)
    for (int pass = 0; pass < PF::kPasses; ++pass) {
      float acc[PF::RPT];
      PF::run(s_xm, static_cast<const T*>(p.w1), pass, acc);
      const int c = PF::col(pass);
      const float bc = to_f<T>(b1[c]);
#pragma unroll
      for (int j = 0; j < PF::RPT; ++j) {
        const float a1 = round_t<T>(round_t<T>(acc[j]) + bc);
        s_a1[PF::row(j) * F + c] = a1;
        s_h[PF::row(j) * F + c] = round_t<T>(gelu(a1));
      }
    }
    __syncthreads();
    {  // z2 = xm + (h W2 + b2)
      using Pj = Proj<T, F, C, TT>;
      for (int pass = 0; pass < Pj::kPasses; ++pass) {
        float acc[Pj::RPT];
        Pj::run(s_h, static_cast<const T*>(p.w2), pass, acc);
        const int c = Pj::col(pass);
        const float bc = to_f<T>(b2[c]);
#pragma unroll
        for (int j = 0; j < Pj::RPT; ++j) {
          const int r = Pj::row(j);
          s_z2[r * C + c] = round_t<T>(s_xm[r * C + c] +
                                       round_t<T>(round_t<T>(acc[j]) + bc));
        }
      }
    }
    __syncthreads();

    // LN2 backward: dz2 over z2 (ds2, dt2, db2 per lane)
    layer_norm_bwd<T, C, TT>(s_z2, s_d, s_z2, p.s2, p.eps, ds2, dt2, db2);
    __syncthreads();
    accum_outer<kThreads, TT, F, C>(s_h, s_z2, P + Wd::kOffW2);
    // dh = dz2 W2^T; da1 = dh * gelu'(a1), over a1
    for (int pass = 0; pass < PF::kPasses; ++pass) {
      float acc[PF::RPT];
      PF::run(s_z2, static_cast<const T*>(p.w2T), pass, acc);
      const int c = PF::col(pass);
#pragma unroll
      for (int j = 0; j < PF::RPT; ++j) {
        float* a = &s_a1[PF::row(j) * F + c];
        const float da = round_t<T>(round_t<T>(acc[j]) * dgelu(*a));
        *a = da;
#pragma unroll
        for (int q = 0; q < PF::kPasses; ++q)   // a static index: registers
          if (q == pass) db1[q] += da;
      }
    }
    __syncthreads();
    accum_outer<kThreads, TT, C, F>(s_xm, s_a1, P + Wd::kOffW1);
    {  // dxm = dz2 + da1 W1^T, over dy
      using Pj = Proj<T, F, C, TT>;
      for (int pass = 0; pass < Pj::kPasses; ++pass) {
        float acc[Pj::RPT];
        Pj::run(s_a1, static_cast<const T*>(p.w1T), pass, acc);
        const int c = Pj::col(pass);
#pragma unroll
        for (int j = 0; j < Pj::RPT; ++j) {
          const int r = Pj::row(j);
          s_d[r * C + c] = round_t<T>(s_z2[r * C + c] + round_t<T>(acc[j]));
        }
      }
    }
    __syncthreads();
    // LN1 backward: dz1 over dxm (ds1, dt1, dbo per lane)
    layer_norm_bwd<T, C, TT>(s_z, s_d, s_d, p.s1, p.eps, ds1, dt1, dbo);
    __syncthreads();
    accum_outer<kThreads, TT, C, C>(s_at, s_d, P);
    {  // dattn = dz1 Wo^T
      using Pj = Proj<T, C, C, TT>;
      for (int pass = 0; pass < Pj::kPasses; ++pass) {
        float acc[Pj::RPT];
        Pj::run(s_d, static_cast<const T*>(p.woT), pass, acc);
        const int c = Pj::col(pass);
#pragma unroll
        for (int j = 0; j < Pj::RPT; ++j) {
          const int r = Pj::row(j);
          if (r < rows)
            dattn[base + r * C + c] = from_f<T>(r < nr ? acc[j] : 0.f);
        }
      }
    }
    for (int i = threadIdx.x; i < rows * C; i += kThreads)
      dx[base + i] = from_f<T>(i < nr * C ? s_d[i] : 0.f);
  }

  // the [C] gradients: each warp's lanes, summed over the warps in order
  __syncthreads();
  float* red = Wd::kF32RedInRows ? s_a1 : smem;   // [kWarps][6][C]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if constexpr (Wd::kF32RedByVector) {   // one [kWarps][C] vector at a time
#pragma unroll
    for (int q = 0; q < 6; ++q) {
#pragma unroll
      for (int u = 0; u < CL; ++u)
        red[warp * C + lane + 32 * u] =
            q == 0 ? dbo[u] : q == 1 ? ds1[u] : q == 2 ? dt1[u]
            : q == 3 ? db2[u] : q == 4 ? ds2[u] : dt2[u];
      __syncthreads();
      for (int i = threadIdx.x; i < C; i += kThreads) {
        float sum = 0.f;
        for (int w = 0; w < kWarps; ++w) sum += red[w * C + i];
        P[(q < 3 ? Wd::kOffW2 + F * C + q * C
                 : Wd::kOffB1 + F + (q - 3) * C) +
          i] = sum;
      }
      __syncthreads();
    }
  } else {
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
      const int q = i / C;
      P[(q < 3 ? Wd::kOffW2 + F * C + q * C
               : Wd::kOffB1 + F + (q - 3) * C) +
        i % C] = sum;
    }
  }
  if constexpr (PF::RG == 1) {   // a thread a column
#pragma unroll
    for (int q = 0; q < PF::kPasses; ++q)
      P[Wd::kOffB1 + PF::col(q)] = db1[q];
  } else {   // F below 256 or 384: the row groups' db1, in group order
    float* rb = red + (Wd::kF32RedByVector ? 0 : kWarps * 6 * C);  // [RG][F]
#pragma unroll
    for (int q = 0; q < PF::kPasses; ++q)
      rb[threadIdx.x / PF::NW * F + PF::col(q)] = db1[q];
    __syncthreads();
    for (int i = threadIdx.x; i < F; i += kThreads) {
      float sum = 0.f;
      for (int g = 0; g < PF::RG; ++g) sum += rb[g * F + i];
      P[Wd::kOffB1 + i] = sum;
    }
  }
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

template <int C, int F>
__global__ void __launch_bounds__(kWgThreads) wgrad_kernel(WgradArgs p) {
  using Wd = Widths<C, F>;
  __shared__ __align__(16) __nv_bfloat16 s_a[2][kWgStep * kWgStride];
  __shared__ __align__(16) __nv_bfloat16 s_d[2][kWgStep * kWgStride];
  // the product's fields without a dynamic index (which would copy the
  // argument arrays to the stack)
  const int z = blockIdx.z;
  const int M = z == 2 ? F : C, N = z == 1 ? F : C;
  const int off = z == 0 ? 0 : z == 1 ? Wd::kOffW1 : Wd::kOffW2;
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
  float* out = p.partial + (size_t)blockIdx.x * Wd::kWeightFloats + off;
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
// (post_attention_bwd_tile_kernel): a tile of kTT tokens, eight warps.  For
// every product the warps split the tile's rows into groups of 16 and the
// pass's 128 columns among the kWCG warps of a group (two warps of 64
// columns at 64 tokens, four of 32 at 32, eight of 16 at 16), with
// mma.sync.  The activations that feed a later product are bf16 rows in
// shared memory; the weights stream through a ring of k-chunk buffers
// shared by the block (cp.async, the next chunks in flight while one is
// consumed, across tiles too).  Every product is a pass of 128 output
// columns over K = C or F, and a stage of N output columns is N / 128 such
// passes: stages kO, kA1 and kO2 are the forward (o = attn Wo, a1 = xm
// W1, o2 = h W2; chunks 0-9 of 64 k-rows at (128, 256)), kDH, kDXM and
// kDATTN the backward's (20 chunks in all there).  After a pass the warps
// stage the product, rounded to bf16, in shared memory, and the row-wise
// work (bias, residual, both LayerNorms, GELU, and in the backward their
// derivatives) loops over kTT / 8 rows per warp with the lanes across the
// columns, 4 of each 128 a lane; the LayerNorms' loops run once all
// passes of their stage are staged.  The forward's row-wise steps are
// device functions that both kernels call (residual_stats, ln_out,
// bias_gelu), so the backward's recompute rounds where the forward does by
// construction.  A tile's rows arrive by cp.async beside the weights, and
// the vector parameters sit in shared memory, so no epilogue waits on
// device memory.

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
  int ld;
  bool trans;
};

// The weight a stage reads, whether as W^T ([N][K] as stored) or W ([K]
// [N]), and its row stride.  Args: TileArgs or FwdArgs (wo, w1, w2).
template <int C, int F, class Args>
__device__ __forceinline__ PassW stage_weight(const Args& p, int stage) {
  switch (stage) {
    case kO: return {p.wo, C, false};     // o = attn Wo
    case kA1: return {p.w1, F, false};    // a1 = xm W1
    case kO2: return {p.w2, C, false};    // o2 = h W2
    case kDH: return {p.w2, C, true};     // dh = dz2 W2^T
    case kDXM: return {p.w1, F, true};    // da1 W1^T
    default: return {p.wo, C, true};      // dattn = dz1 Wo^T
  }
}

// Chunk q of the streaming order (Widths::kPerF): its stage s, output
// columns n0.. and k-rows k0..
template <int C, int F>
__device__ __forceinline__ void stream_chunk(int q, int& s, int& n0,
                                             int& k0) {
  using Wd = Widths<C, F>;
  constexpr int kc = C / kKc, S1 = Wd::kStartA1, S3 = Wd::kStartDH,
                S5 = Wd::kStartDATTN;
  if (q < S1 || q >= S5) {      // kO, kDATTN: C / kNP passes over C
    const int local = q < S1 ? q : q - S5;
    s = q < S1 ? kO : kDATTN;
    n0 = (local / kc) * kNP;
    k0 = (local % kc) * kKc;
    return;
  }
  const bool bwd = q >= S3;
  const int local = q - (bwd ? S3 : S1);
  const int f = local / Wd::kPerF, j = local % Wd::kPerF;
  if (j < kc) {                 // pass f of a1 (dh): F columns over C
    s = bwd ? kDH : kA1;
    n0 = f * kNP;
    k0 = j * kKc;
  } else {                      // o2 (dxm) over pass f's 128 rows of K
    const int i = j - kc;
    s = bwd ? kDXM : kO2;
    n0 = (i / (kNP / kKc)) * kNP;
    k0 = f * kNP + (i % (kNP / kKc)) * kKc;
  }
}

// chunk q of the tile's stream into buf: its stage's weight, the pass's
// W rows k0.. (cols n0..n0+127) or W^T's, i.e. W rows n0..n0+127, cols
// k0..; 1024 16-byte pieces.  kStream: the streaming order, else the
// stage order.
template <int C, int F, bool kStream = false, class Args>
__device__ __forceinline__ void load_chunk(const Args& p, int q,
                                           __nv_bfloat16* buf) {
  using Wd = Widths<C, F>;
  int s, n0, k0;
  if constexpr (kStream) {
    stream_chunk<C, F>(q, s, n0, k0);
  } else {
    constexpr int S1 = Wd::kStartA1, S2 = Wd::kStartO2, S3 = Wd::kStartDH,
                  S4 = Wd::kStartDXM, S5 = Wd::kStartDATTN;
    s = q < S1 ? kO : q < S2 ? kA1 : q < S3 ? kO2
        : q < S4 ? kDH : q < S5 ? kDXM : kDATTN;
    const int start = s == kO ? 0 : s == kA1 ? S1 : s == kO2 ? S2
                      : s == kDH ? S3 : s == kDXM ? S4 : S5;
    const int kc = stage_k(C, F, s) / kKc;    // chunks a pass
    const int local = q - start;
    n0 = (local / kc) * kNP;
    k0 = (local % kc) * kKc;
  }
  const PassW w = stage_weight<C, F>(p, s);
  for (int i = threadIdx.x; i < kKc * kNP / 8; i += kTileThreads) {
    if (w.trans) {
      const int r = i / (kKc / 8), c = (i % (kKc / 8)) * 8;
      cp_async_16(buf + r * (kKc + kPad) + c,
                  w.w + (size_t)(n0 + r) * w.ld + k0 + c);
    } else {
      const int r = i / (kNP / 8), c = (i % (kNP / 8)) * 8;
      cp_async_16(buf + r * kNS + c, w.w + (size_t)(k0 + r) * w.ld + n0 + c);
    }
  }
}

// acc += the warp's 16 rows of A (row stride lda, columns k0..k0+63) times
// the chunk in wb, over the warp's kWN output columns
template <int C, int F>
__device__ __forceinline__ void chunk_product(
    float (&acc)[Widths<C, F>::kWN / 8][4], const __nv_bfloat16* A, int lda,
    int k0, const __nv_bfloat16* wb, bool trans) {
  using Wd = Widths<C, F>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nw = Wd::kWN * (warp % Wd::kWCG);   // the warp's columns
  const int r0 = 16 * (warp / Wd::kWCG);        // and rows
#pragma unroll
  for (int kk = 0; kk < kKc; kk += 16) {
    uint32_t af[4];
    ldmatrix_x4(af, A + (r0 + lane % 16) * lda + k0 + kk + (lane / 16) * 8);
#pragma unroll
    for (int j = 0; j < Wd::kWN / 16; ++j) {
      uint32_t bf[4];
      if (trans)
        ldmatrix_x4(bf, wb + (nw + j * 16 + lane % 8 + (lane / 16) * 8) *
                                 (kKc + kPad) +
                            kk + ((lane / 8) % 2) * 8);
      else
        ldmatrix_x4_trans(bf, wb + (kk + lane % 8 + ((lane / 8) % 2) * 8) *
                                       kNS +
                                  nw + j * 16 + (lane / 16) * 8);
      mma_bf16_16816(acc[2 * j], af, &bf[0]);
      mma_bf16_16816(acc[2 * j + 1], af, &bf[2]);
    }
  }
}

// One product pass of a tile: acc = A (row stride lda) times 128 columns
// of the stage's weight, over chunks [q0, q0 + n) of the stream of
// kChunks a tile, through the ring of Ring buffers at s_w; cnt counts the
// chunks the block has consumed.  Each chunk step waits for its chunk (at
// the tile's first also for the tile's rows, committed after the chunks
// in flight), frees the buffer of the chunk before it and prefetches the
// chunk Ring - 1 ahead, into the next tile's stream while the block has
// one (more_tiles).  kStream: the stream in the streaming order; without
// kZero acc adds the pass to what it holds (o2 and dxm over F's passes).
template <int C, int F, int Ring, int kChunks, bool kStream = false,
          bool kZero = true, class Args>
__device__ __forceinline__ void product_pass(
    const Args& p, int q0, int n, const __nv_bfloat16* A, int lda,
    bool more_tiles, bool trans, __nv_bfloat16* s_w, int& cnt,
    float (&acc)[Widths<C, F>::kWN / 8][4]) {
  if constexpr (kZero) {
#pragma unroll
    for (int nb = 0; nb < Widths<C, F>::kWN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  }
  for (int q = q0; q < q0 + n; ++q, ++cnt) {
    if (q == 0) cp_async_wait<0>();
    else cp_async_wait<Ring - 2>();
    __syncthreads();               // chunk q landed; chunk q - 1 consumed
    const int ahead = q + Ring - 1;
    if (ahead < kChunks || more_tiles)
      load_chunk<C, F, kStream>(p, ahead % kChunks,
                                s_w + ((cnt + Ring - 1) % Ring) * kChunkElems);
    cp_async_commit();
    chunk_product<C, F>(acc, A, lda, (q - q0) * kKc,
                        s_w + (cnt % Ring) * kChunkElems, trans);
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

// G groups of four consecutive values, 128 apart, from (or to) p: a
// lane's columns of a row of G x 128
template <int G, class P>
__device__ __forceinline__ void ld4g(const P* p, float (&v)[G][4]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if constexpr (sizeof(P) == 4) ldf4(p + kNP * g, v[g]);
    else ld4(p + kNP * g, v[g]);
  }
}
template <int G>
__device__ __forceinline__ void st4g(__nv_bfloat16* p,
                                     const float (&v)[G][4]) {
#pragma unroll
  for (int g = 0; g < G; ++g) st4(p + kNP * g, v[g]);
}

// The warp's accumulator tile (16 rows x kWN columns of the pass),
// rounded to bf16 (every consumer of a product rounds it first), into dst
// from column n0; the row-wise epilogue then reads the product a row at a
// time
template <int C, int F>
__device__ __forceinline__ void stage(
    const float (&acc)[Widths<C, F>::kWN / 8][4], __nv_bfloat16* dst, int ld,
    int n0) {
  using Wd = Widths<C, F>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r = 16 * (warp / Wd::kWCG) + lane / 4;
  const int c = n0 + Wd::kWN * (warp % Wd::kWCG) + 2 * (lane % 4);
#pragma unroll
  for (int nb = 0; nb < Wd::kWN / 8; ++nb) {
    st2(dst + r * ld + c + nb * 8, acc[nb][0], acc[nb][1]);
    st2(dst + (r + 8) * ld + c + nb * 8, acc[nb][2], acc[nb][3]);
  }
  __syncthreads();               // the warps' parts, for the row loops
}

// The forward's row-wise steps on the lane's G x 4 columns of one row (the
// warp's lanes hold the row's 128 G columns).  z = x + (o + b), given the
// staged product o in z and rounded at the forward's points, and the f32
// LayerNorm statistics of z over the row: mu, rs = 1 / sqrt(var + eps),
// var = E[z^2] - mu^2.
template <int G>
__device__ __forceinline__ void residual_stats(float (&z)[G][4],
                                               const float (&x)[G][4],
                                               const float (&b)[G][4],
                                               float eps, float& mu,
                                               float& rs) {
  constexpr float kInv = 1.f / (kNP * G);
  float sum = 0.f, sq = 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      z[g][u] = rbf(x[g][u] + rbf(z[g][u] + b[g][u]));
      sum += z[g][u];
      sq += z[g][u] * z[g][u];
    }
  mu = warp_sum(sum) * kInv;
  rs = 1.f / sqrtf(warp_sum(sq) * kInv - mu * mu + eps);
}

// y = LayerNorm(z) with its statistics, scale s and bias t, rounded
template <int G>
__device__ __forceinline__ void ln_out(const float (&z)[G][4], float mu,
                                       float rs, const float (&s)[G][4],
                                       const float (&t)[G][4],
                                       float (&y)[G][4]) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      y[g][u] = rbf((z[g][u] - mu) * rs * s[g][u] + t[g][u]);
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
template <int C, int F, class Args>
__device__ __forceinline__ void load_vector_params(const Args& p,
                                                   float* s_par) {
  using Wd = Widths<C, F>;
  for (int i = threadIdx.x; i < C; i += kTileThreads) {
    s_par[Wd::kVbo + i] = to_f(p.bo[i]);
    s_par[Wd::kVs1 + i] = p.s1[i];
    s_par[Wd::kVt1 + i] = p.t1[i];
    s_par[Wd::kVb2 + i] = to_f(p.b2[i]);
    s_par[Wd::kVs2 + i] = p.s2[i];
    s_par[Wd::kVt2 + i] = p.t2[i];
  }
  for (int i = threadIdx.x; i < F; i += kTileThreads)
    s_par[Wd::kVb1 + i] = to_f(p.b1[i]);
}

// The bf16 forward: stages kO, kA1 and kO2 of the tile pass and their
// epilogues.  Its shared memory (attn then xm, x then o2, o then a1 and h
// over it, a two-buffer weight ring, the vector parameters; 109,568 bytes
// at (128, 256)) lets two blocks share an SM, so one block's row-wise
// work overlaps the other's products; at F = 3 C one block fits
// (kFwdBlocks), and its registers are not held to two blocks' share.
// Where an F-wide row does not fit beside the tile (kFwdStream) s_h is
// C wide: o, then each 128-column pass of F's a1 and h in its first
// columns, whose o2 products follow at once (the streaming order), each
// warp's o2 columns summed over the passes in registers; every sum adds
// its k-rows in the order of the stage order.
template <int C, int F>
__global__ void __launch_bounds__(kTileThreads, Widths<C, F>::kFwdBlocks)
post_attention_fwd_tc_kernel(FwdArgs p) {
  using Wd = Widths<C, F>;
  constexpr int kTT = Wd::kTT, kSC = Wd::kSC, kSH = Wd::kSHF;
  constexpr int G = Wd::kCG, kChunks = Wd::kFwdChunks;
  constexpr bool kStream = Wd::kFwdStream;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_x = s_a + kTT * kSC;       // x, then o2 (stage kO2)
  __nv_bfloat16* s_h = s_x + kTT * kSC;       // o (stage kO), then a1, h
  __nv_bfloat16* s_w = s_h + kTT * kSH;       // the weight chunk ring
  float* s_par = reinterpret_cast<float*>(s_w + kFwdRing * kChunkElems);
  // s_a: attn, then xm (over attn, stage kO)

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = 4 * lane;        // the lane's columns of each 128
  load_vector_params<C, F>(p, s_par);

  const int tiles_per_row = (p.V + kTT - 1) / kTT;
  const int tiles = p.B * tiles_per_row;
  for (int q = 0; q < kFwdRing - 1; ++q) {      // the stream's first chunks
    if ((int)blockIdx.x < tiles)
      load_chunk<C, F, kStream>(p, q, s_w + q * kChunkElems);
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

    float acc[Wd::kWN / 8][4];
    // o = attn Wo; z = x + (o + bo); xm = LN1(z), over attn
    for (int nb = 0; nb < C / kNP; ++nb) {
      product_pass<C, F, kFwdRing, kChunks, kStream>(
          p, Wd::kStartO + nb * (C / kKc), C / kKc, s_a, kSC, more,
          false, s_w, cnt, acc);
      stage<C, F>(acc, s_h, kSH, nb * kNP);
    }
    {
      float par[3][G][4];
      ld4g<G>(s_par + Wd::kVbo + c, par[0]);
      ld4g<G>(s_par + Wd::kVs1 + c, par[1]);
      ld4g<G>(s_par + Wd::kVt1 + c, par[2]);
#pragma unroll 2
      for (int i = 0; i < Wd::kWarpRows; ++i) {
        const int r = Wd::kWarpRows * warp + i;
        float z[G][4], x[G][4], xm[G][4], mu, rs;
        ld4g<G>(s_h + r * kSH + c, z);
        ld4g<G>(s_x + r * kSC + c, x);          // 0 on rows not real
        residual_stats<G>(z, x, par[0], p.eps, mu, rs);
        ln_out<G>(z, mu, rs, par[1], par[2], xm);
        st4g<G>(s_a + r * kSC + c, xm);
      }
    }
    if constexpr (!kStream) {
      // a1 = xm W1 + b1, h = gelu(a1), 128 columns a pass
      for (int nb = 0; nb < F / kNP; ++nb) {
        const int n0 = nb * kNP;
        product_pass<C, F, kFwdRing, kChunks>(
            p, Wd::kStartA1 + nb * (C / kKc), C / kKc, s_a, kSC, more,
            false, s_w, cnt, acc);
        stage<C, F>(acc, s_h, kSH, n0);
        float par[4];
        ldf4(s_par + Wd::kVb1 + n0 + c, par);
#pragma unroll 2
        for (int i = 0; i < Wd::kWarpRows; ++i) {
          const int r = Wd::kWarpRows * warp + i;
          float a1[4], h[4];
          ld4(s_h + r * kSH + n0 + c, a1);
          bias_gelu(a1, par, r < nr, h);
          st4(s_h + r * kSH + n0 + c, h);
        }
      }
      // o2 = h W2; z2 = xm + (o2 + b2); y = LN2(z2), written out
      for (int nb = 0; nb < C / kNP; ++nb) {
        product_pass<C, F, kFwdRing, kChunks>(
            p, Wd::kStartO2 + nb * (F / kKc), F / kKc, s_h, kSH, more,
            false, s_w, cnt, acc);
        stage<C, F>(acc, s_x, kSC, nb * kNP);   // x was consumed in kO
      }
    } else {
      // per 128-column pass of F: a1 = xm W1 + b1, h = gelu(a1) in s_h's
      // first columns, then o2 += h W2 over the pass's 128 k-rows
      float o2[G][Wd::kWN / 8][4] = {};
      for (int f = 0; f < Wd::kFG; ++f) {
        const int n0 = f * kNP, q0 = Wd::kStartA1 + f * Wd::kPerF;
        product_pass<C, F, kFwdRing, kChunks, true>(
            p, q0, C / kKc, s_a, kSC, more, false, s_w, cnt, acc);
        stage<C, F>(acc, s_h, kSH, 0);
        float par[4];
        ldf4(s_par + Wd::kVb1 + n0 + c, par);
#pragma unroll 2
        for (int i = 0; i < Wd::kWarpRows; ++i) {
          const int r = Wd::kWarpRows * warp + i;
          float a1[4], h[4];
          ld4(s_h + r * kSH + c, a1);
          bias_gelu(a1, par, r < nr, h);
          st4(s_h + r * kSH + c, h);
        }
#pragma unroll
        for (int nb = 0; nb < G; ++nb)
          product_pass<C, F, kFwdRing, kChunks, true, false>(
              p, q0 + C / kKc + nb * (kNP / kKc), kNP / kKc, s_h, kSH,
              more, false, s_w, cnt, o2[nb]);
      }
#pragma unroll
      for (int nb = 0; nb < G; ++nb)             // x was consumed in kO
        stage<C, F>(o2[nb], s_x, kSC, nb * kNP);
    }
    {
      float par[3][G][4];
      ld4g<G>(s_par + Wd::kVb2 + c, par[0]);
      ld4g<G>(s_par + Wd::kVs2 + c, par[1]);
      ld4g<G>(s_par + Wd::kVt2 + c, par[2]);
#pragma unroll 2
      for (int i = 0; i < Wd::kWarpRows; ++i) {
        const int r = Wd::kWarpRows * warp + i;
        float z2[G][4], xm[G][4], y[G][4], mu, rs;
        ld4g<G>(s_x + r * kSC + c, z2);
        ld4g<G>(s_a + r * kSC + c, xm);
        residual_stats<G>(z2, xm, par[0], p.eps, mu, rs);
        ln_out<G>(z2, mu, rs, par[1], par[2], y);
        if (r >= nr) {
          for (int g = 0; g < G; ++g)
            y[g][0] = y[g][1] = y[g][2] = y[g][3] = 0.f;
        }
        if (r < rows) st4g<G>(p.y + (row0 + r) * C + c, y);
      }
    }
  }
  cp_async_wait<0>();            // chunks prefetched for no tile
}

template <int C, int F>
__global__ void __launch_bounds__(kTileThreads, 1)
post_attention_bwd_tile_kernel(TileArgs p) {
  using Wd = Widths<C, F>;
  constexpr int kTT = Wd::kTT, kSC = Wd::kSC, kSF = Wd::kSF, kSH = Wd::kSH;
  constexpr int G = Wd::kCG, FG = Wd::kFG, kChunks = Wd::kTileChunks;
  constexpr bool kStream = Wd::kNoHiddenRow;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_b0 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_z = s_b0 + kTT * kSC;      // z = x + o
  __nv_bfloat16* s_dz2 = s_z + kTT * kSC;     // x, then dz2 (stage kO2)
  __nv_bfloat16* s_dy = s_dz2 + kTT * kSC;    // dy (none with kStream)
  __nv_bfloat16* s_a1 = s_dy + (kStream ? 0 : kTT * kSC);  // a1, then da1
  __nv_bfloat16* s_h =                        // h
      s_a1 + (Wd::kHiddenRows == 2 ? kTT * kSF : 0);
  __nv_bfloat16* s_w = s_h + kTT * kSH;       // the weight chunk ring
  float* s_par = reinterpret_cast<float*>(s_w + kRing * kChunkElems);
  float* s_stat = s_par + Wd::kVecFloats;     // LN1 (mu, rs) per row
  // s_b0: attn, then xm (over attn, stage kO), then dz1 (stage kDXM).
  // With one hidden row s_a1 is s_h: h, then dh, then da1 over it; a1
  // waits in p.da1, and s_db1 holds the block's db1 sums, column c by
  // thread c % kTileThreads.  With none (kStream) s_a1 is s_h, a buffer
  // of 128 columns: each pass of F's a1, then h, whose o2 products
  // follow at once, and in the backward each pass's dh, then da1, whose
  // dxm products follow (the streaming order); a1 waits in p.da1, dy is
  // read from device memory, db1 sums by column in s_db1 (column c by
  // thread c % kNP), and o2 and dxm sum over the passes in registers,
  // every sum adding its k-rows in the order of the stage order
  float* s_db1 = s_stat + 2 * kTT;
  if constexpr (Wd::kDb1Shared) {
    for (int i = threadIdx.x; i < F; i += kTileThreads) s_db1[i] = 0.f;
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = 4 * lane;        // the lane's columns of each 128
  // the lane's columns of the vector gradients over all its rows: the six
  // [C] ones (bo, s1, t1, b2, s2, t2) and b1's, 128 columns a pass
  float vs[6][G][4] = {}, vb1[FG][4] = {};
  constexpr int kBo = 0, kS1 = 1, kT1 = 2, kB2 = 3, kS2 = 4, kT2 = 5;
  load_vector_params<C, F>(p, s_par);

  const int tiles_per_row = (p.V + kTT - 1) / kTT;
  const int tiles = p.B * tiles_per_row;
  for (int q = 0; q < kRing - 1; ++q) {         // the stream's first chunks
    if ((int)blockIdx.x < tiles)
      load_chunk<C, F, kStream>(p, q, s_w + q * kChunkElems);
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
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
      for (int i = threadIdx.x; i < rows * C; i += kTileThreads) {
        p.dx[row0 * C + i] = zero;
        p.dattn[row0 * C + i] = zero;
        p.xm[row0 * C + i] = zero;
        p.dz2[row0 * C + i] = zero;
      }
      for (int i = threadIdx.x; i < rows * F; i += kTileThreads) {
        p.da1[row0 * F + i] = zero;
        p.h[row0 * F + i] = zero;
      }
      continue;
    }
    __syncthreads();              // the previous tile's rows are consumed
    for (int i = threadIdx.x; i < kTT * C / 8; i += kTileThreads) {
      const int r = i / (C / 8), k = (i % (C / 8)) * 8;
      const size_t g = (row0 + (r < nr ? r : 0)) * C + k;
      cp_async_16(s_b0 + r * kSC + k, p.attn + g, r < nr);
      cp_async_16(s_dz2 + r * kSC + k, p.x + g, r < nr);
      if constexpr (!kStream)
        cp_async_16(s_dy + r * kSC + k, p.dy + g, r < nr);
    }
    cp_async_commit();
    const bool more = tile + (int)gridDim.x < tiles;
    // each stage's passes, then its epilogue: the product staged in shared
    // memory, then a loop over the warp's rows with the lanes across the
    // columns (4 of each 128).  Compact code: fully unrolled epilogues in
    // fragment order were several times slower.
    float acc[Wd::kWN / 8][4];

    // kO: z = x + (o + bo); xm = LN1(z)
    for (int nb = 0; nb < C / kNP; ++nb) {
      product_pass<C, F, kRing, kChunks, kStream>(
          p, Wd::kStartO + nb * (C / kKc), C / kKc, s_b0, kSC, more,
          false, s_w, cnt, acc);
      stage<C, F>(acc, s_z, kSC, nb * kNP);
    }
    {
      float par[3][G][4];
      ld4g<G>(s_par + Wd::kVbo + c, par[0]);
      ld4g<G>(s_par + Wd::kVs1 + c, par[1]);
      ld4g<G>(s_par + Wd::kVt1 + c, par[2]);
#pragma unroll 2
      for (int i = 0; i < Wd::kWarpRows; ++i) {
        const int r = Wd::kWarpRows * warp + i;
        float z[G][4], x[G][4], xm[G][4], mu, rs;
        ld4g<G>(s_z + r * kSC + c, z);
        ld4g<G>(s_dz2 + r * kSC + c, x);        // 0 on rows not real
        residual_stats<G>(z, x, par[0], p.eps, mu, rs);
        st4g<G>(s_z + r * kSC + c, z);
        if (lane == 0) {
          s_stat[2 * r] = mu;
          s_stat[2 * r + 1] = rs;
        }
        ln_out<G>(z, mu, rs, par[1], par[2], xm);
        st4g<G>(s_b0 + r * kSC + c, xm);         // over attn
        if (r < rows) {
          if (r >= nr) {
            for (int g = 0; g < G; ++g)
              xm[g][0] = xm[g][1] = xm[g][2] = xm[g][3] = 0.f;
          }
          st4g<G>(p.xm + (row0 + r) * C + c, xm);
        }
      }
    }
    if constexpr (!kStream) {
      // kA1: a1 = xm W1 + b1; h = gelu(a1), 128 columns a pass
      for (int nb = 0; nb < FG; ++nb) {
        const int n0 = nb * kNP;
        product_pass<C, F, kRing, kChunks>(
            p, Wd::kStartA1 + nb * (C / kKc), C / kKc, s_b0, kSC, more,
            false, s_w, cnt, acc);
        stage<C, F>(acc, s_a1, kSF, n0);
        float par[4];
        ldf4(s_par + Wd::kVb1 + n0 + c, par);
#pragma unroll 2
        for (int i = 0; i < Wd::kWarpRows; ++i) {
          const int r = Wd::kWarpRows * warp + i;
          float a1[4], h[4];
          ld4(s_a1 + r * kSF + n0 + c, a1);
          bias_gelu(a1, par, r < nr, h);
          if constexpr (Wd::kOneHiddenRow) {   // a1 waits for kDH in p.da1
            if (r < rows) st4(p.da1 + (row0 + r) * F + n0 + c, a1);
          } else {
            st4(s_a1 + r * kSF + n0 + c, a1);
          }
          st4(s_h + r * kSF + n0 + c, h);
          if (r < rows) st4(p.h + (row0 + r) * F + n0 + c, h);
        }
      }
      // kO2: z2 = xm + (h W2 + b2); LN2 backward
      for (int nb = 0; nb < C / kNP; ++nb) {
        product_pass<C, F, kRing, kChunks>(
            p, Wd::kStartO2 + nb * (F / kKc), F / kKc, s_h, kSF, more,
            false, s_w, cnt, acc);
        stage<C, F>(acc, s_dz2, kSC, nb * kNP);   // x was consumed in kO
      }
    } else {
      // per 128-column pass of F: a1 = xm W1 + b1 (to p.da1), h =
      // gelu(a1) (to p.h), then o2 += h W2 over the pass's 128 k-rows
      float o2[G][Wd::kWN / 8][4] = {};
      for (int f = 0; f < FG; ++f) {
        const int n0 = f * kNP, q0 = Wd::kStartA1 + f * Wd::kPerF;
        product_pass<C, F, kRing, kChunks, true>(
            p, q0, C / kKc, s_b0, kSC, more, false, s_w, cnt, acc);
        stage<C, F>(acc, s_h, kSH, 0);
        float par[4];
        ldf4(s_par + Wd::kVb1 + n0 + c, par);
#pragma unroll 2
        for (int i = 0; i < Wd::kWarpRows; ++i) {
          const int r = Wd::kWarpRows * warp + i;
          float a1[4], h[4];
          ld4(s_h + r * kSH + c, a1);
          bias_gelu(a1, par, r < nr, h);
          if (r < rows) {   // a1 waits for kDH, read back by this thread
            st4(p.da1 + (row0 + r) * F + n0 + c, a1);
            st4(p.h + (row0 + r) * F + n0 + c, h);
          }
          st4(s_h + r * kSH + c, h);
        }
#pragma unroll
        for (int nb = 0; nb < G; ++nb)
          product_pass<C, F, kRing, kChunks, true, false>(
              p, q0 + C / kKc + nb * (kNP / kKc), kNP / kKc, s_h, kSH,
              more, false, s_w, cnt, o2[nb]);
      }
#pragma unroll
      for (int nb = 0; nb < G; ++nb)             // x was consumed in kO
        stage<C, F>(o2[nb], s_dz2, kSC, nb * kNP);
    }
    {
      constexpr float kInv = 1.f / C;
      float par[2][G][4];
      ld4g<G>(s_par + Wd::kVb2 + c, par[0]);
      ld4g<G>(s_par + Wd::kVs2 + c, par[1]);
#pragma unroll 2
      for (int i = 0; i < Wd::kWarpRows; ++i) {
        const int r = Wd::kWarpRows * warp + i;
        float z2[G][4], xm[G][4], dy[G][4], mu, rs;
        ld4g<G>(s_dz2 + r * kSC + c, z2);
        ld4g<G>(s_b0 + r * kSC + c, xm);
        if constexpr (kStream) {                // 0 on rows not real
          for (int g = 0; g < G; ++g)
            dy[g][0] = dy[g][1] = dy[g][2] = dy[g][3] = 0.f;
          if (r < nr) ld4g<G>(p.dy + (row0 + r) * C + c, dy);
        } else {
          ld4g<G>(s_dy + r * kSC + c, dy);      // 0 on rows not real
        }
        residual_stats<G>(z2, xm, par[0], p.eps, mu, rs);
        float sg = 0.f, sgx = 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            z2[g][u] = (z2[g][u] - mu) * rs;        // xhat
            sg += dy[g][u] * par[1][g][u];
            sgx += dy[g][u] * par[1][g][u] * z2[g][u];
          }
        const float mg = warp_sum(sg) * kInv, mgx = warp_sum(sgx) * kInv;
        float dz[G][4];
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            dz[g][u] = r < nr ? rbf(rs * (dy[g][u] * par[1][g][u] - mg -
                                          z2[g][u] * mgx))
                              : 0.f;
            vs[kS2][g][u] += dy[g][u] * z2[g][u];
            vs[kT2][g][u] += dy[g][u];
            vs[kB2][g][u] += dz[g][u];
          }
        st4g<G>(s_dz2 + r * kSC + c, dz);
        if (r < rows) st4g<G>(p.dz2 + (row0 + r) * C + c, dz);
      }
    }
    if constexpr (!kStream) {
      // kDH: da1 = (dz2 W2^T) gelu'(a1), over a1, 128 columns a pass
      for (int nb = 0; nb < FG; ++nb) {
        const int n0 = nb * kNP;
        product_pass<C, F, kRing, kChunks>(
            p, Wd::kStartDH + nb * (C / kKc), C / kKc, s_dz2, kSC, more,
            true, s_w, cnt, acc);
        stage<C, F>(acc, s_h, kSF, n0);           // h was consumed in kO2
#pragma unroll 2
        for (int i = 0; i < Wd::kWarpRows; ++i) {
          const int r = Wd::kWarpRows * warp + i;
          float dh[4], a1[4];
          ld4(s_h + r * kSF + n0 + c, dh);
          if constexpr (Wd::kOneHiddenRow) {   // kA1's store, this thread's
            a1[0] = a1[1] = a1[2] = a1[3] = 0.f;
            if (r < nr) ld4(p.da1 + (row0 + r) * F + n0 + c, a1);
          } else {
            ld4(s_a1 + r * kSF + n0 + c, a1);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            a1[u] = r < nr ? rbf(dh[u] * dgelu(a1[u])) : 0.f;
            if constexpr (!Wd::kOneHiddenRow) {
#pragma unroll
              for (int j = 0; j < FG; ++j)   // a static index: registers
                if (j == nb) vb1[j][u] += a1[u];
            }
          }
          st4(s_a1 + r * kSF + n0 + c, a1);
          if (r < rows) st4(p.da1 + (row0 + r) * F + n0 + c, a1);
        }
      }
      if constexpr (Wd::kOneHiddenRow) {   // db1 += the tile's da1 columns
        __syncthreads();
        for (int i = threadIdx.x; i < F; i += kTileThreads) {
          float sum = 0.f;
          for (int r = 0; r < kTT; ++r) sum += to_f(s_a1[r * kSF + i]);
          s_db1[i] += sum;
        }
      }
      // kDXM: dxm = dz2 + da1 W1^T; LN1 backward
      for (int nb = 0; nb < C / kNP; ++nb) {
        product_pass<C, F, kRing, kChunks>(
            p, Wd::kStartDXM + nb * (F / kKc), F / kKc, s_a1, kSF, more,
            true, s_w, cnt, acc);
        stage<C, F>(acc, s_b0, kSC, nb * kNP);    // xm was consumed in kO2
      }
    } else {
      // per 128-column pass of F: da1 = (dz2 W2^T) gelu'(a1), a1 read
      // back from p.da1 and da1 written over it, db1 += its columns, then
      // dxm += da1 W1^T over the pass's 128 k-rows
      float dxm[G][Wd::kWN / 8][4] = {};
      for (int f = 0; f < FG; ++f) {
        const int n0 = f * kNP, q0 = Wd::kStartDH + f * Wd::kPerF;
        product_pass<C, F, kRing, kChunks, true>(
            p, q0, C / kKc, s_dz2, kSC, more, true, s_w, cnt, acc);
        stage<C, F>(acc, s_h, kSH, 0);
#pragma unroll 2
        for (int i = 0; i < Wd::kWarpRows; ++i) {
          const int r = Wd::kWarpRows * warp + i;
          float dh[4], a1[4] = {};
          ld4(s_h + r * kSH + c, dh);
          if (r < nr) ld4(p.da1 + (row0 + r) * F + n0 + c, a1);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            a1[u] = r < nr ? rbf(dh[u] * dgelu(a1[u])) : 0.f;
          st4(s_h + r * kSH + c, a1);
          if (r < rows) st4(p.da1 + (row0 + r) * F + n0 + c, a1);
        }
        __syncthreads();
        if (threadIdx.x < kNP) {   // db1 += the tile's da1 columns
          float sum = 0.f;
          for (int r = 0; r < kTT; ++r)
            sum += to_f(s_h[r * kSH + threadIdx.x]);
          s_db1[n0 + threadIdx.x] += sum;
        }
#pragma unroll
        for (int nb = 0; nb < G; ++nb)
          product_pass<C, F, kRing, kChunks, true, false>(
              p, q0 + C / kKc + nb * (kNP / kKc), kNP / kKc, s_h, kSH,
              more, true, s_w, cnt, dxm[nb]);
      }
#pragma unroll
      for (int nb = 0; nb < G; ++nb)             // xm was consumed in kO2
        stage<C, F>(dxm[nb], s_b0, kSC, nb * kNP);
    }
    {
      constexpr float kInv = 1.f / C;
      float s1[G][4];
      ld4g<G>(s_par + Wd::kVs1 + c, s1);
#pragma unroll 2
      for (int i = 0; i < Wd::kWarpRows; ++i) {
        const int r = Wd::kWarpRows * warp + i;
        float d[G][4], dz2[G][4], z[G][4];
        ld4g<G>(s_b0 + r * kSC + c, d);
        ld4g<G>(s_dz2 + r * kSC + c, dz2);
        ld4g<G>(s_z + r * kSC + c, z);
        const float mu = s_stat[2 * r], rs = s_stat[2 * r + 1];
        float sg = 0.f, sgx = 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            d[g][u] = r < nr ? rbf(dz2[g][u] + d[g][u]) : 0.f;   // dxm
            z[g][u] = (z[g][u] - mu) * rs;                        // xhat
            sg += d[g][u] * s1[g][u];
            sgx += d[g][u] * s1[g][u] * z[g][u];
          }
        const float mg = warp_sum(sg) * kInv, mgx = warp_sum(sgx) * kInv;
        float dz[G][4];
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            dz[g][u] = r < nr ? rbf(rs * (d[g][u] * s1[g][u] - mg -
                                          z[g][u] * mgx))
                              : 0.f;
            vs[kS1][g][u] += d[g][u] * z[g][u];
            vs[kT1][g][u] += d[g][u];
            vs[kBo][g][u] += dz[g][u];
          }
        st4g<G>(s_b0 + r * kSC + c, dz);         // dz1, A of kDATTN
        if (r < rows) st4g<G>(p.dx + (row0 + r) * C + c, dz);
      }
    }
    // kDATTN: dattn = dz1 Wo^T, from the fragments
    for (int nb = 0; nb < C / kNP; ++nb) {
      product_pass<C, F, kRing, kChunks, kStream>(
          p, Wd::kStartDATTN + nb * (C / kKc), C / kKc, s_b0, kSC,
          more, true, s_w, cnt, acc);
      const int g = lane / 4, t = lane % 4;
      const int nw = nb * kNP + Wd::kWN * (warp % Wd::kWCG);
#pragma unroll
      for (int j = 0; j < Wd::kWN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * (warp / Wd::kWCG) + g + 8 * h;
          if (r < rows)
            st2(p.dattn + (row0 + r) * C + nw + j * 8 + 2 * t,
                r < nr ? acc[j][2 * h] : 0.f,
                r < nr ? acc[j][2 * h + 1] : 0.f);
        }
    }
  }
  // the warps' column sums, added in warp order (the tiles' rows are
  // consumed: s_a1 onwards, or at C 512 the block's whole shared memory,
  // holds [kTileWarps][kVecFloats] f32)
  cp_async_wait<0>();
  __syncthreads();
  const int off[6] = {Wd::kVbo, Wd::kVs1, Wd::kVt1,
                      Wd::kVb2, Wd::kVs2, Wd::kVt2};
  if constexpr (kStream) {   // one [kTileWarps][C] vector at a time
    float* s_red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
    for (int v = 0; v < 6; ++v) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          s_red[warp * C + kNP * g + c + u] = vs[v][g][u];
      __syncthreads();
      for (int i = threadIdx.x; i < C; i += kTileThreads) {
        float sum = 0.f;
        for (int w = 0; w < kTileWarps; ++w) sum += s_red[w * C + i];
        p.vpartial[(size_t)blockIdx.x * Wd::kVecFloats + off[v] + i] = sum;
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < F; i += kTileThreads)   // db1 as it is
      p.vpartial[(size_t)blockIdx.x * Wd::kVecFloats + Wd::kVb1 + i] =
          s_db1[i];
    return;
  }
  float* s_red = Wd::kVecRedInRows ? reinterpret_cast<float*>(s_a1)
                                   : reinterpret_cast<float*>(smem_raw);
  float* red = s_red + warp * Wd::kVecFloats;
#pragma unroll
  for (int v = 0; v < 6; ++v)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int u = 0; u < 4; ++u) red[off[v] + kNP * g + c + u] = vs[v][g][u];
  if constexpr (!Wd::kDb1Shared) {
#pragma unroll
    for (int j = 0; j < FG; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u) red[Wd::kVb1 + kNP * j + c + u] = vb1[j][u];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Wd::kVecFloats; i += kTileThreads) {
    if constexpr (Wd::kDb1Shared) {   // db1: the block's sums as they are
      if (i >= Wd::kVb1 && i < Wd::kVb1 + F) {
        p.vpartial[(size_t)blockIdx.x * Wd::kVecFloats + i] =
            s_db1[i - Wd::kVb1];
        continue;
      }
    }
    float sum = 0.f;
    for (int w = 0; w < kTileWarps; ++w)
      sum += s_red[w * Wd::kVecFloats + i];
    p.vpartial[(size_t)blockIdx.x * Wd::kVecFloats + i] = sum;
  }
}

// The kernels of one width behind the entry points (post_attention.cu).
template <int C, int F>
struct K5 {
  using Wd = Widths<C, F>;

  static cudaError_t forward_f32(const K5Call& a) {
    using f = const float*;
    cudaError_t e = allow_smem(post_attention_kernel<C, F>, Wd::kSmemBytes);
    if (e != cudaSuccess) return e;
    const dim3 grid((a.V + Wd::TT - 1) / Wd::TT, a.B);
    post_attention_kernel<C, F>
        <<<grid, kThreads, Wd::kSmemBytes, a.stream>>>(
            static_cast<f>(a.x), static_cast<f>(a.attn), static_cast<f>(a.wo),
            static_cast<f>(a.bo), a.s1, a.t1, static_cast<f>(a.w1),
            static_cast<f>(a.b1), static_cast<f>(a.w2), static_cast<f>(a.b2),
            a.s2, a.t2, a.nv, static_cast<float*>(a.y), a.V, a.eps);
    return cudaGetLastError();
  }

  static cudaError_t forward_bf16(const K5Call& a) {
    using bf = __nv_bfloat16;
    const FwdArgs f{static_cast<const bf*>(a.x),  static_cast<const bf*>(a.attn),
                    static_cast<const bf*>(a.wo), static_cast<const bf*>(a.bo),
                    static_cast<const bf*>(a.w1), static_cast<const bf*>(a.b1),
                    static_cast<const bf*>(a.w2), static_cast<const bf*>(a.b2),
                    a.s1, a.t1, a.s2, a.t2, a.nv, static_cast<bf*>(a.y),
                    a.B, a.V, a.eps};
    cudaError_t e =
        allow_smem(post_attention_fwd_tc_kernel<C, F>, Wd::kFwdSmemBytes);
    if (e != cudaSuccess) return e;
    static int resident[kMaxDevices] = {};
    int blocks;
    e = persistent_grid(post_attention_fwd_tc_kernel<C, F>, kTileThreads,
                        Wd::kFwdSmemBytes,
                        a.B * ((a.V + Wd::kTT - 1) / Wd::kTT), resident,
                        &blocks);
    if (e != cudaSuccess) return e;
    post_attention_fwd_tc_kernel<C, F>
        <<<blocks, kTileThreads, Wd::kFwdSmemBytes, a.stream>>>(f);
    return cudaGetLastError();
  }

  static cudaError_t forward(int dtype, const K5Call& a) {
    if (dtype == kFloat32) return forward_f32(a);
    if (dtype == kBFloat16) return forward_bf16(a);
    return cudaErrorInvalidValue;
  }

  static cudaError_t backward(const K5Call& a) {
    const BwdArgs args{a.x,   a.attn, a.dy, a.wo, a.bo, a.w1,  a.b1,
                       a.w2,  a.b2,   a.woT, a.w1T, a.w2T, a.s1, a.t1,
                       a.s2,  a.t2,   a.nv, a.dx,  a.dattn, a.partial,
                       a.B,   a.V,    a.eps};
    cudaError_t e = allow_smem(post_attention_bwd_kernel<float, C, F>,
                               Wd::kBwdSmemBytes);
    if (e != cudaSuccess) return e;
    post_attention_bwd_kernel<float, C, F>
        <<<a.nblocks, kThreads, Wd::kBwdSmemBytes, a.stream>>>(args);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    return sum_partials(a.partial, a.nblocks, Wd::kGradFloats, a.grads,
                        a.stream);
  }

  static WgradArgs wgrad_args(const K5Call& a) {
    using bf = const __nv_bfloat16*;
    return WgradArgs{{static_cast<bf>(a.attn), static_cast<bf>(a.xm),
                      static_cast<bf>(a.h)},
                     {static_cast<bf>(a.dx), static_cast<bf>(a.da1),
                      static_cast<bf>(a.dz2)},
                     a.nv, a.partial, a.B, a.V};
  }

  static cudaError_t wgrad_bf16(const K5Call& a) {
    const int chunks = (a.B * a.V + kWgChunk - 1) / kWgChunk;
    const int tiles = (F / kWgTile) * (C / kWgTile);   // the most of the 3
    wgrad_kernel<C, F>
        <<<dim3(chunks, tiles, 3), kWgThreads, 0, a.stream>>>(wgrad_args(a));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    return sum_partials(a.partial, chunks, Wd::kWeightFloats, a.grads,
                        a.stream);
  }

  static cudaError_t backward_bf16(const K5Call& a) {
    using bf = __nv_bfloat16;
    const TileArgs t{
        static_cast<const bf*>(a.x),  static_cast<const bf*>(a.attn),
        static_cast<const bf*>(a.dy), static_cast<const bf*>(a.wo),
        static_cast<const bf*>(a.bo), static_cast<const bf*>(a.w1),
        static_cast<const bf*>(a.b1), static_cast<const bf*>(a.w2),
        static_cast<const bf*>(a.b2), a.s1, a.t1, a.s2, a.t2, a.nv,
        static_cast<bf*>(a.dx), static_cast<bf*>(a.dattn),
        static_cast<bf*>(a.xm), static_cast<bf*>(a.da1),
        static_cast<bf*>(a.h), static_cast<bf*>(a.dz2), a.vpartial, a.B, a.V,
        a.eps};
    cudaError_t e = allow_smem(post_attention_bwd_tile_kernel<C, F>,
                               Wd::kTileSmemBytes);
    if (e != cudaSuccess) return e;
    post_attention_bwd_tile_kernel<C, F>
        <<<a.nblocks, kTileThreads, Wd::kTileSmemBytes, a.stream>>>(t);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = wgrad_bf16(a);
    if (e != cudaSuccess) return e;
    return sum_partials(a.vpartial, a.nblocks, Wd::kVecFloats,
                        a.grads + Wd::kWeightFloats, a.stream);
  }

  static const K5Kernels& kernels() {
    static const K5Kernels k{forward, backward, backward_bf16, wgrad_bf16};
    return k;
  }
};

}  // namespace
}  // namespace geomae
