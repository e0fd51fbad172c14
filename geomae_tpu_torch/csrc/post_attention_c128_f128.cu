// K5's kernels at C = 128, F = 128, one translation unit, so that the
// widths compile in parallel; the kernels are in post_attention.cuh, the
// entry points in post_attention.cu.
#include "post_attention.cuh"

namespace geomae {

const K5Kernels& k5_kernels_c128_f128() { return K5<128, 128>::kernels(); }

}  // namespace geomae
