// K6 / K7's kernels at C = 768 (the f32 kernels in heads of 8, 16, 32, 64
// and 128 channels: 96, 48, 24, 12 and 6 heads; the bf16 projections), one
// translation unit, so that the widths compile in parallel; the kernels
// are in window_attention.cuh, the wide widths' table in
// window_attention_wide.cuh, the entry points in window_attention.cu.
#include "window_attention_wide.cuh"

namespace geomae {

const QkvF32Kernels* qkv_f32_c768(int D) { return qkv_f32_wide<768>(D); }
const QkvProjKernels* qkv_proj_c768() { return qkv_proj_at<768>(); }

}  // namespace geomae
