// K5's kernels at C = 1024, F = 2048, one translation unit, so that the
// widths compile in parallel; the kernels are in post_attention.cuh, the
// entry points in post_attention.cu.
#include "post_attention.cuh"

namespace geomae {

const K5Kernels& k5_kernels_c1024_f2048() { return K5<1024, 2048>::kernels(); }

}  // namespace geomae
