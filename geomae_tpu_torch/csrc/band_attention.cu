// K8 band attention: the C entry points.  The kernels and their design
// notes are in band_attention.cuh; each row width C = H D the port builds
// (128, 256, 384, 512, 640, 768, 1024) is a translation unit of its own
// (band_attention_c*.cu), and an entry point hands its arguments to the
// kernels of the width it is given, or returns cudaErrorInvalidValue for
// any other.
#include "band_attention_wide.cuh"

namespace {

const geomae::K8Kernels* k8_kernels(int H, int D) {
  using namespace geomae;
  if (H <= 0 || D <= 0) return nullptr;
  switch ((long)H * D) {
    case 128: return k8_kernels_c128(D);
    case 256: return k8_kernels_c256(D);
    case 384: return k8_kernels_c384(D);
    case 512: return k8_kernels_c512(D);
    case 640: return k8_kernels_c640(D);
    case 768: return k8_kernels_c768(D);
    case 1024: return k8_kernels_c1024(D);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// q, k, v, out [B, V, H * D] in dtype (H heads of D in {1, 2, 4, 8, 16,
// 32, 64, 128}, H * D of 128, 256, 384 or 512, or of D in {3, 6, 12, 24,
// 48, 96, 192} at H * D = 384, or of D 256 at H * D = 256 or 512, or of
// D = H * D = 384 or 512, or of D in {8, 16, 32, 64, 128} at H * D = 640,
// 768 or 1024; heads flattened), each 16-byte aligned.  win
// [B, V] int32 ascending per row (INT32_MAX padding suffix); key_valid
// [B, V] bytes.  lse: null, or f32 [B, V, H] for the per-(row, head)
// log-sum-exp of the scaled scores (0 where a row sees no key).
int geomae_band_attention(int dtype, const void* q, const void* k,
                          const void* v, const int* win,
                          const uint8_t* key_valid, void* out, float* lse,
                          int B, int V, int H, int D, void* stream) {
  const geomae::K8Kernels* kn = k8_kernels(H, D);
  if (kn == nullptr) return cudaErrorInvalidValue;
  return kn->forward(dtype, q, k, v, win, key_valid, out, lse, B, V,
                     static_cast<cudaStream_t>(stream));
}

// The backward's prologue: delta f32 [B, V, H] = per (row, head) the sum
// over the head's D channels of dout * out, both [B, V, H * D] in dtype;
// 0 on padding rows (win [B, V] == INT32_MAX).
int geomae_band_attention_delta(int dtype, const void* dout, const void* out,
                                const int* win, float* delta, int B, int V,
                                int H, int D, void* stream) {
  const geomae::K8Kernels* kn = k8_kernels(H, D);
  if (kn == nullptr) return cudaErrorInvalidValue;
  return kn->delta(dtype, dout, out, win, delta, B * V * H,
                   static_cast<cudaStream_t>(stream));
}

// Backward of geomae_band_attention: the forward's inputs, its lse, the
// prologue's delta and dout [B, V, H * D]; writes dq, dk, dv [B, V, H *
// D] in dtype (0 on padding rows).  f32 on the CUDA cores, bf16 on the
// tensor cores.
int geomae_band_attention_bwd(int dtype, const void* q, const void* k,
                              const void* v, const int* win,
                              const uint8_t* key_valid, const float* lse,
                              const float* delta, const void* dout, void* dq,
                              void* dk, void* dv, int B, int V, int H, int D,
                              void* stream) {
  const geomae::K8Kernels* kn = k8_kernels(H, D);
  if (kn == nullptr) return cudaErrorInvalidValue;
  return kn->backward(dtype, q, k, v, win, key_valid, lse, delta, dout, dq,
                      dk, dv, B, V, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
