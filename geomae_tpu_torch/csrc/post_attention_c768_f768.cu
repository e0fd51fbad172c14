// K5's kernels at C = 768, F = 768, one translation unit, so that the
// widths compile in parallel; the kernels are in post_attention.cuh, the
// entry points in post_attention.cu.
#include "post_attention.cuh"

namespace geomae {

const K5Kernels& k5_kernels_c768_f768() { return K5<768, 768>::kernels(); }

}  // namespace geomae
