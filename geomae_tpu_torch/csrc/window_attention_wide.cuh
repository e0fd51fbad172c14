// K6 / K7's f32 kernels and the bf16 projections at the row widths above
// 512: C 640, 768 and 1024, the f32 kernels in heads of 8, 16, 32, 64 and
// 128 channels, one translation unit a C (window_attention_c640.cu,
// _c768.cu, _c1024.cu).  The kernels are window_attention.cuh's: the f32
// ones at C / 4 threads a block (F32W), the projections with their
// contraction streamed (qkv_project_stream_kernel,
// qkv_project_dx_stream_kernel; the weight gradients' kernel tiles any
// C).  Only heads of 8 to 128 are built at these C (qkv_f32_at's table
// would build heads of 1, 2 and 4, of 3 to 192 at 768 and of 256 and C),
// so that each unit builds the five widths K8 takes there and no width
// without a test is reachable.  Kept apart from window_attention.cuh's
// tables, as band_attention_wide.cuh is from band_attention.cuh.
#pragma once

#include "window_attention.cuh"

namespace geomae {

// one pair per wide C, each in its translation unit
const QkvF32Kernels* qkv_f32_c640(int D);
const QkvF32Kernels* qkv_f32_c768(int D);
const QkvF32Kernels* qkv_f32_c1024(int D);
const QkvProjKernels* qkv_proj_c640();
const QkvProjKernels* qkv_proj_c768();
const QkvProjKernels* qkv_proj_c1024();

namespace {

// The f32 kernels of row width C (above 512) at head width D, null for a
// D not taken
template <int C>
const QkvF32Kernels* qkv_f32_wide(int D) {
  static_assert(C > 512 && C % 128 == 0, "the wide row widths");
  static const QkvF32Kernels k8{launch<C, 8>, launch_bwd<C, 8>};
  static const QkvF32Kernels k16{launch<C, 16>, launch_bwd<C, 16>};
  static const QkvF32Kernels k32{launch<C, 32>, launch_bwd<C, 32>};
  static const QkvF32Kernels k64{launch<C, 64>, launch_bwd<C, 64>};
  static const QkvF32Kernels k128{launch<C, 128>, launch_bwd<C, 128>};
  switch (D) {
    case 8: return &k8;
    case 16: return &k16;
    case 32: return &k32;
    case 64: return &k64;
    case 128: return &k128;
    default: return nullptr;
  }
}

}  // namespace
}  // namespace geomae
