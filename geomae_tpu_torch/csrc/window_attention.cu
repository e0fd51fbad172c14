// K6 band_attention_qkv and K7, its backward: the C entry points.  The
// kernels and their design notes are in window_attention.cuh; each C
// (128, 256, 384, 512, 640, 768, 1024) is a translation unit of its own
// (window_attention_c*.cu), and an entry point hands its arguments to the
// kernels of the width it is given, or returns cudaErrorInvalidValue for
// any other.
#include "window_attention_wide.cuh"

namespace {

// the f32 kernels of C channels in H heads, or null
const geomae::QkvF32Kernels* f32_kernels(int C, int H) {
  using namespace geomae;
  if (H <= 0 || C % H != 0) return nullptr;
  switch (C) {
    case 128: return qkv_f32_c128(C / H);
    case 256: return qkv_f32_c256(C / H);
    case 384: return qkv_f32_c384(C / H);
    case 512: return qkv_f32_c512(C / H);
    case 640: return qkv_f32_c640(C / H);
    case 768: return qkv_f32_c768(C / H);
    case 1024: return qkv_f32_c1024(C / H);
    default: return nullptr;
  }
}

// the bf16 projections of C channels, or null
const geomae::QkvProjKernels* proj_kernels(int C) {
  using namespace geomae;
  switch (C) {
    case 128: return qkv_proj_c128();
    case 256: return qkv_proj_c256();
    case 384: return qkv_proj_c384();
    case 512: return qkv_proj_c512();
    case 640: return qkv_proj_c640();
    case 768: return qkv_proj_c768();
    case 1024: return qkv_proj_c1024();
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// x, pos, out [B, V, C]; W [C, C] (in x out); b [C]; all dtype; C of 128,
// 256, 384 or 512 in H heads of 1, 2, 4, 8, 16, 32, 64 or 128, C 384 in
// heads of 3, 6, 12, 24, 48, 96 or 192, C 256 or 512 in heads of 256, C
// 384 or 512 in one head, or C 640, 768 or 1024 in heads of 8, 16, 32, 64
// or 128.  win [B, V] int32 ascending per row
// (INT32_MAX padding suffix); key_valid [B, V] bytes.  lse: null, or f32
// [B, V, H] for the per-(row, head) log-sum-exp of the scores (0 where a
// row sees no key).
int geomae_band_attention_qkv(int dtype, const void* x, const void* pos,
                              const void* wq, const void* bq, const void* wk,
                              const void* bk, const void* wv, const void* bv,
                              const int* win, const uint8_t* key_valid,
                              void* out, float* lse, int B, int V, int C,
                              int H, void* stream) {
  const geomae::QkvF32Kernels* kn = f32_kernels(C, H);
  if (dtype != geomae::kFloat32 || kn == nullptr)
    return cudaErrorInvalidValue;   // bf16: qkv_project, then K8
  return kn->forward(x, pos, wq, bq, wk, bk, wv, bv, win, key_valid, out,
                     lse, B, V, static_cast<cudaStream_t>(stream));
}

// Backward of geomae_band_attention_qkv.  The forward's inputs, its out
// and lse, dout [B, V, C]; wqT, wkT, wvT the weights transposed.  Writes
// dx [B, V, C] (dtype) and grads [3 C C + 3 C] f32 (dWq, dWk, dWv, dbq,
// dbk, dbv).  partial: zeroed f32 [nblocks, len(grads)]; nblocks is the
// persistent grid.
int geomae_band_attention_qkv_bwd(
    int dtype, const void* x, const void* pos, const void* wq, const void* bq,
    const void* wk, const void* bk, const void* wv, const void* bv,
    const void* wqT, const void* wkT, const void* wvT, const int* win,
    const uint8_t* key_valid, const void* out, const float* lse,
    const void* dout, void* dx, float* partial, float* grads, int B, int V,
    int C, int H, int nblocks, void* stream) {
  const geomae::BwdArgs args{x,   pos,  wq,  bq,  wk,  bk,        wv,  bv,
                             wqT, wkT,  wvT, out, dout, win, key_valid, lse,
                             dx,  partial, B, V};
  const geomae::QkvF32Kernels* kn = f32_kernels(C, H);
  if (dtype != geomae::kFloat32 || kn == nullptr)
    return cudaErrorInvalidValue;   // bf16: K8's backward between the
                                    // projections' kernels
  return kn->backward(args, grads, nblocks,
                      static_cast<cudaStream_t>(stream));
}

// bf16 projections of K6 on the tensor cores: x, pos, q, k, v [B, V, C],
// C of 128, 256, 384, 512, 640, 768 or 1024; W [C, C] (in x out); b [C];
// win [B, V] int32.  Per row q = round(round((x + pos) Wq) + bq), k likewise with
// Wk, v from x with Wv, x + pos rounded first; 0 on padding rows (win ==
// INT32_MAX).
int geomae_qkv_project(const void* x, const void* pos, const void* wq,
                       const void* bq, const void* wk, const void* bk,
                       const void* wv, const void* bv, const int* win,
                       void* q, void* k, void* v, int B, int V, int C,
                       void* stream) {
  using namespace geomae;
  using bf = __nv_bfloat16;
  const QkvProjKernels* kn = proj_kernels(C);
  if (kn == nullptr) return cudaErrorInvalidValue;
  const ProjArgs a{static_cast<const bf*>(x),  static_cast<const bf*>(pos),
                   static_cast<const bf*>(wq), static_cast<const bf*>(bq),
                   static_cast<const bf*>(wk), static_cast<const bf*>(bk),
                   static_cast<const bf*>(wv), static_cast<const bf*>(bv),
                   win,
                   static_cast<bf*>(q),        static_cast<bf*>(k),
                   static_cast<bf*>(v),        B * V};
  return kn->project(a, static_cast<cudaStream_t>(stream));
}

// Backward of the bf16 projections for the cotangents dq, dk, dv [B, V,
// C] of q, k, v: dx [B, V, C] = round(round(dq Wq^T) + round(dk Wk^T +
// dv Wv^T)), and grads [3 C C + 3 C] f32 (dWq, dWk, dWv, dbq, dbk, dbv) =
// ((x+pos)^T dq, (x+pos)^T dk, x^T dv, the column sums of dq, dk, dv)
// over every row; C of 128, 256, 384, 512, 640, 768 or 1024.  The weight
// gradients split the rows into chunks of chunk_rows (a multiple of 64);
// partial: f32 [chunks, len(grads)], chunks = ceil(B * V / chunk_rows).
int geomae_qkv_project_bwd(const void* x, const void* pos, const void* wq,
                           const void* wk, const void* wv, const void* dq,
                           const void* dk, const void* dv, void* dx,
                           float* partial, float* grads, int B, int V, int C,
                           int chunk_rows, int chunks, void* stream) {
  using namespace geomae;
  using bf = __nv_bfloat16;
  const QkvProjKernels* kn = proj_kernels(C);
  const int rows = B * V;
  if (kn == nullptr || chunk_rows <= 0 || chunk_rows % 64 != 0 ||
      chunks != (rows + chunk_rows - 1) / chunk_rows)
    return cudaErrorInvalidValue;
  const DxArgs d{static_cast<const bf*>(wq), static_cast<const bf*>(wk),
                 static_cast<const bf*>(wv), static_cast<const bf*>(dq),
                 static_cast<const bf*>(dk), static_cast<const bf*>(dv),
                 static_cast<bf*>(dx),       rows};
  const QwArgs w{static_cast<const bf*>(x),  static_cast<const bf*>(pos),
                 static_cast<const bf*>(dq), static_cast<const bf*>(dk),
                 static_cast<const bf*>(dv), partial, rows, chunk_rows};
  return kn->backward(d, w, chunks, grads,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
