// K6 / K7's kernels at C = 640 (the f32 kernels in heads of 8, 16, 32, 64
// and 128 channels: 80, 40, 20, 10 and 5 heads; the bf16 projections), one
// translation unit, so that the widths compile in parallel; the kernels
// are in window_attention.cuh, the wide widths' table in
// window_attention_wide.cuh, the entry points in window_attention.cu.
#include "window_attention_wide.cuh"

namespace geomae {

const QkvF32Kernels* qkv_f32_c640(int D) { return qkv_f32_wide<640>(D); }
const QkvProjKernels* qkv_proj_c640() { return qkv_proj_at<640>(); }

}  // namespace geomae
