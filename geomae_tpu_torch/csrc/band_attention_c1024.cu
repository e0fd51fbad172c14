// K8's kernels at C = 1024 (heads of 8, 16, 32, 64 and 128 channels: 128,
// 64, 32, 16 and 8 heads), one translation unit, so that the row
// widths compile in parallel; the kernels are in band_attention.cuh,
// the wide widths' dispatch in band_attention_wide.cuh, the entry
// points in band_attention.cu.
#include "band_attention_wide.cuh"

namespace geomae {

const K8Kernels* k8_kernels_c1024(int D) { return k8_kernels_wide<1024>(D); }

}  // namespace geomae
