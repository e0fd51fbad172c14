// K5 post_attention_block: the C entry points.  The kernels and their
// design notes are in post_attention.cuh; each width (C, F) the port
// builds is a translation unit of its own (post_attention_c*_f*.cu), and
// an entry point hands its arguments to the kernels of the width it is
// given, or returns cudaErrorInvalidValue for any other.
#include "post_attention.cuh"

namespace {

const geomae::K5Kernels* k5_kernels(int C, int F) {
  using namespace geomae;
  if (C == 128 && F == 128) return &k5_kernels_c128_f128();
  if (C == 128 && F == 256) return &k5_kernels_c128_f256();
  if (C == 128 && F == 384) return &k5_kernels_c128_f384();
  if (C == 128 && F == 512) return &k5_kernels_c128_f512();
  if (C == 256 && F == 256) return &k5_kernels_c256_f256();
  if (C == 256 && F == 512) return &k5_kernels_c256_f512();
  if (C == 256 && F == 768) return &k5_kernels_c256_f768();
  if (C == 256 && F == 1024) return &k5_kernels_c256_f1024();
  if (C == 384 && F == 384) return &k5_kernels_c384_f384();
  if (C == 384 && F == 768) return &k5_kernels_c384_f768();
  if (C == 384 && F == 1152) return &k5_kernels_c384_f1152();
  if (C == 384 && F == 1536) return &k5_kernels_c384_f1536();
  if (C == 512 && F == 512) return &k5_kernels_c512_f512();
  if (C == 512 && F == 1024) return &k5_kernels_c512_f1024();
  if (C == 512 && F == 1536) return &k5_kernels_c512_f1536();
  if (C == 512 && F == 2048) return &k5_kernels_c512_f2048();
  if (C == 640 && F == 640) return &k5_kernels_c640_f640();
  if (C == 640 && F == 1280) return &k5_kernels_c640_f1280();
  if (C == 640 && F == 1920) return &k5_kernels_c640_f1920();
  if (C == 640 && F == 2560) return &k5_kernels_c640_f2560();
  if (C == 768 && F == 768) return &k5_kernels_c768_f768();
  if (C == 768 && F == 1536) return &k5_kernels_c768_f1536();
  if (C == 768 && F == 2304) return &k5_kernels_c768_f2304();
  if (C == 768 && F == 3072) return &k5_kernels_c768_f3072();
  if (C == 1024 && F == 1024) return &k5_kernels_c1024_f1024();
  if (C == 1024 && F == 2048) return &k5_kernels_c1024_f2048();
  if (C == 1024 && F == 3072) return &k5_kernels_c1024_f3072();
  if (C == 1024 && F == 4096) return &k5_kernels_c1024_f4096();
  return nullptr;
}

}  // namespace

extern "C" {

// x, attn, y [B, V, C]; wo [C, C], w1 [C, F], w2 [F, C] (in x out) and
// their biases in the compute dtype; LayerNorm scale and bias (s1, t1,
// s2, t2) [C] float32; nv [B] int32.
int geomae_post_attention_block(int dtype, const void* x, const void* attn,
                                const void* wo, const void* bo,
                                const float* s1, const float* t1,
                                const void* w1, const void* b1,
                                const void* w2, const void* b2,
                                const float* s2, const float* t2,
                                const int* nv, void* y, int B, int V, int C,
                                int F, float eps, void* stream) {
  const geomae::K5Kernels* k = k5_kernels(C, F);
  if (k == nullptr) return cudaErrorInvalidValue;
  geomae::K5Call a{};
  a.x = x, a.attn = attn, a.wo = wo, a.bo = bo, a.w1 = w1, a.b1 = b1;
  a.w2 = w2, a.b2 = b2, a.s1 = s1, a.t1 = t1, a.s2 = s2, a.t2 = t2;
  a.nv = nv, a.y = y, a.B = B, a.V = V, a.eps = eps;
  a.stream = static_cast<cudaStream_t>(stream);
  return k->forward(dtype, a);
}

// Backward of geomae_post_attention_block, float32.  dy [B, V, C] and the
// forward's inputs; woT [C, C], w1T [F, C], w2T [C, F] the weights
// transposed.  Writes dx, dattn [B, V, C] and grads [C C + 2 C F + 6 C +
// F] f32 (the layout of Widths in post_attention.cuh).  partial: zeroed
// f32 [nblocks, grads' size]; nblocks is the persistent grid.
int geomae_post_attention_block_bwd(
    int dtype, const void* x, const void* attn, const void* dy,
    const void* wo, const void* bo, const float* s1, const float* t1,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const float* s2, const float* t2, const void* woT, const void* w1T,
    const void* w2T, const int* nv, void* dx, void* dattn, float* partial,
    float* grads, int B, int V, int C, int F, float eps, int nblocks,
    void* stream) {
  const geomae::K5Kernels* k = k5_kernels(C, F);
  if (k == nullptr || dtype != geomae::kFloat32)   // bf16: below
    return cudaErrorInvalidValue;
  geomae::K5Call a{};
  a.x = x, a.attn = attn, a.dy = dy, a.wo = wo, a.bo = bo, a.w1 = w1;
  a.b1 = b1, a.w2 = w2, a.b2 = b2, a.woT = woT, a.w1T = w1T, a.w2T = w2T;
  a.s1 = s1, a.t1 = t1, a.s2 = s2, a.t2 = t2, a.nv = nv, a.dx = dx;
  a.dattn = dattn, a.partial = partial, a.grads = grads;
  a.B = B, a.V = V, a.nblocks = nblocks, a.eps = eps;
  a.stream = static_cast<cudaStream_t>(stream);
  return k->backward(a);
}

// The bf16 backward of geomae_post_attention_block on the tensor cores,
// with the arguments and outputs of geomae_post_attention_block_bwd (the
// weights as given, not transposed) and bf16 workspace rows xm [B * V,
// C], da1 [B * V, F], h [B * V, F], dz2 [B * V, C]; vpartial f32
// [nblocks, 6 C + F] (nblocks: the per-tile pass's persistent grid),
// partial f32 [ceil(B * V / 2048), C C + 2 C F]; both are written whole.
int geomae_post_attention_block_bwd_bf16(
    const void* x, const void* attn, const void* dy, const void* wo,
    const void* bo, const float* s1, const float* t1, const void* w1,
    const void* b1, const void* w2, const void* b2, const float* s2,
    const float* t2, const int* nv, void* dx, void* dattn, void* xm,
    void* da1, void* h, void* dz2, float* vpartial, float* partial,
    float* grads, int B, int V, int C, int F, float eps, int nblocks,
    void* stream) {
  const geomae::K5Kernels* k = k5_kernels(C, F);
  if (k == nullptr) return cudaErrorInvalidValue;
  geomae::K5Call a{};
  a.x = x, a.attn = attn, a.dy = dy, a.wo = wo, a.bo = bo, a.w1 = w1;
  a.b1 = b1, a.w2 = w2, a.b2 = b2, a.s1 = s1, a.t1 = t1, a.s2 = s2;
  a.t2 = t2, a.nv = nv, a.dx = dx, a.dattn = dattn, a.xm = xm, a.da1 = da1;
  a.h = h, a.dz2 = dz2, a.vpartial = vpartial, a.partial = partial;
  a.grads = grads, a.B = B, a.V = V, a.nblocks = nblocks, a.eps = eps;
  a.stream = static_cast<cudaStream_t>(stream);
  return k->backward_bf16(a);
}

// The weight-gradient pass alone: grads [C C + 2 C F] f32 = (dWo, dW1,
// dW2) from the bf16 rows attn, dx [B * V, C], xm [.., C], da1 [.., F], h
// [.., F], dz2 [.., C]; partial f32 [ceil(B * V / 2048), C C + 2 C F].
int geomae_post_attention_wgrad_bf16(const void* attn, const void* dx,
                                     const void* xm, const void* da1,
                                     const void* h, const void* dz2,
                                     const int* nv, float* partial,
                                     float* grads, int B, int V, int C,
                                     int F, void* stream) {
  const geomae::K5Kernels* k = k5_kernels(C, F);
  if (k == nullptr) return cudaErrorInvalidValue;
  geomae::K5Call a{};
  a.attn = attn, a.nv = nv, a.partial = partial, a.grads = grads;
  a.dx = const_cast<void*>(dx), a.xm = const_cast<void*>(xm);   // read only
  a.da1 = const_cast<void*>(da1), a.h = const_cast<void*>(h);
  a.dz2 = const_cast<void*>(dz2), a.B = B, a.V = V;
  a.stream = static_cast<cudaStream_t>(stream);
  return k->wgrad_bf16(a);
}

}  // extern "C"
