// K6 / K7's kernels at C = 1024 (the f32 kernels in heads of 8, 16, 32, 64
// and 128 channels: 128, 64, 32, 16 and 8 heads; the bf16 projections), one
// translation unit, so that the widths compile in parallel; the kernels
// are in window_attention.cuh, the wide widths' table in
// window_attention_wide.cuh, the entry points in window_attention.cu.
#include "window_attention_wide.cuh"

namespace geomae {

const QkvF32Kernels* qkv_f32_c1024(int D) { return qkv_f32_wide<1024>(D); }
const QkvProjKernels* qkv_proj_c1024() { return qkv_proj_at<1024>(); }

}  // namespace geomae
