// K5's kernels at C = 512, F = 1536, one translation unit, so that the
// widths compile in parallel; the kernels are in post_attention.cuh, the
// entry points in post_attention.cu.
#include "post_attention.cuh"

namespace geomae {

const K5Kernels& k5_kernels_c512_f1536() { return K5<512, 1536>::kernels(); }

}  // namespace geomae
