// K8's kernels at C = 384 (heads of 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64,
// 96, 128, 192 and 384 channels; 3, 6, 12, 24, 48, 96, 192 and 384 at this C
// alone), one translation unit, so that the row widths compile in parallel; the
// kernels are in band_attention.cuh, the entry points in band_attention.cu.
#include "band_attention.cuh"

namespace geomae {

const K8Kernels* k8_kernels_c384(int D) { return k8_kernels_at<384>(D); }

}  // namespace geomae
