// K6 / K7's kernels at C = 512 (the f32 kernels in heads of 1, 2, 4, 8, 16, 32,
// 64, 128, 256 and 512 channels, the bf16 projections), one translation unit,
// so that the widths compile in parallel; the kernels are in
// window_attention.cuh, the entry points in window_attention.cu.
#include "window_attention.cuh"

namespace geomae {

const QkvF32Kernels* qkv_f32_c512(int D) { return qkv_f32_at<512>(D); }
const QkvProjKernels* qkv_proj_c512() { return qkv_proj_at<512>(); }

}  // namespace geomae
