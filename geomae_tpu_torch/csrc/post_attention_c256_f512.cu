// K5's kernels at C = 256, F = 512, one translation unit, so that the
// widths compile in parallel; the kernels are in post_attention.cuh, the
// entry points in post_attention.cu.
#include "post_attention.cuh"

namespace geomae {

const K5Kernels& k5_kernels_c256_f512() { return K5<256, 512>::kernels(); }

}  // namespace geomae
