// K5's kernels at C = 256, F = 256, one translation unit, so that the
// widths compile in parallel; the kernels are in post_attention.cuh, the
// entry points in post_attention.cu.
#include "post_attention.cuh"

namespace geomae {

const K5Kernels& k5_kernels_c256_f256() { return K5<256, 256>::kernels(); }

}  // namespace geomae
