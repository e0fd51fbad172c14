// K5's kernels at C = 640, F = 2560, one translation unit, so that the
// widths compile in parallel; the kernels are in post_attention.cuh, the
// entry points in post_attention.cu.
#include "post_attention.cuh"

namespace geomae {

const K5Kernels& k5_kernels_c640_f2560() { return K5<640, 2560>::kernels(); }

}  // namespace geomae
