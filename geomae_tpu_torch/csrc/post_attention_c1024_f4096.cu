// K5's kernels at C = 1024, F = 4096, one translation unit, so that the
// widths compile in parallel; the kernels are in post_attention.cuh, the
// entry points in post_attention.cu.
#include "post_attention.cuh"

namespace geomae {

const K5Kernels& k5_kernels_c1024_f4096() { return K5<1024, 4096>::kernels(); }

}  // namespace geomae
