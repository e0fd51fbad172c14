// K8's kernels at C = 512 (heads of 1, 2, 4, 8, 16, 32, 64, 128, 256 and 512
// channels; 512 at this C alone), one translation unit, so that the row widths
// compile in parallel; the kernels are in band_attention.cuh, the entry points
// in band_attention.cu.
#include "band_attention.cuh"

namespace geomae {

const K8Kernels* k8_kernels_c512(int D) { return k8_kernels_at<512>(D); }

}  // namespace geomae
