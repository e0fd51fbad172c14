// K5's kernels at C = 640, F = 1920, one translation unit, so that the
// widths compile in parallel; the kernels are in post_attention.cuh, the
// entry points in post_attention.cu.
#include "post_attention.cuh"

namespace geomae {

const K5Kernels& k5_kernels_c640_f1920() { return K5<640, 1920>::kernels(); }

}  // namespace geomae
