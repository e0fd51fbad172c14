// K8's kernels at C = 128 (heads of 1, 2, 4, 8, 16, 32, 64 and 128 channels),
// one translation unit, so that the row widths compile in parallel; the kernels
// are in band_attention.cuh, the entry points in band_attention.cu.
#include "band_attention.cuh"

namespace geomae {

const K8Kernels* k8_kernels_c128(int D) { return k8_kernels_at<128>(D); }

}  // namespace geomae
