// K6 / K7's kernels at C = 384 (the f32 kernels in heads of 1, 2, 3, 4, 6, 8,
// 12, 16, 24, 32, 48, 64, 96, 128, 192 and 384 channels, the bf16 projections),
// one translation unit, so that the widths compile in parallel; the kernels are
// in window_attention.cuh, the entry points in window_attention.cu.
#include "window_attention.cuh"

namespace geomae {

const QkvF32Kernels* qkv_f32_c384(int D) { return qkv_f32_at<384>(D); }
const QkvProjKernels* qkv_proj_c384() { return qkv_proj_at<384>(); }

}  // namespace geomae
