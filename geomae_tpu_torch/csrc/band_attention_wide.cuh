// K8 at the row widths above 512: C 640, 768 and 1024 in heads of 8, 16,
// 32, 64 and 128 channels, one translation unit a C
// (band_attention_c640.cu, _c768.cu, _c1024.cu).  The kernels are
// band_attention.cuh's, as they are at C 512: C enters them only as the
// row stride, the head count and the grid's head groups (5, 6 or 8 f32
// groups of 128 channels, twice as many bf16 forward groups, more bf16
// backward blocks), so a wider row is more blocks of the same kernels.
// Only heads of 8 to 128 are built at these C, so that each unit builds
// five widths and no width without a test is reachable.  Kept apart from
// band_attention.cuh, so that the units of C 128 to 512 compile from the
// sources they did.
#pragma once

#include "band_attention.cuh"

namespace geomae {

// one per wide C, each in its translation unit
const K8Kernels* k8_kernels_c640(int D);
const K8Kernels* k8_kernels_c768(int D);
const K8Kernels* k8_kernels_c1024(int D);

namespace {

// The kernels of row width C (above 512) at head width D, null for a D
// not taken
template <int C>
const K8Kernels* k8_kernels_wide(int D) {
  static_assert(C > 512 && C % 128 == 0, "the wide row widths");
  switch (D) {
    case 8: return &Width<8, C>::kernels();
    case 16: return &Width<16, C>::kernels();
    case 32: return &Width<32, C>::kernels();
    case 64: return &Width<64, C>::kernels();
    case 128: return &Width<128, C>::kernels();
    default: return nullptr;
  }
}

}  // namespace
}  // namespace geomae
