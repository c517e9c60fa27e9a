// Kernel 7, mode 0 (bf16 activations and weights, gathered with cp.async):
// the main loop of conv_mainloop.cuh at the tiles of CONV_RING_BM rows (64 or
// 128; the build compiles this file once for each), with kernel 7's epilogue.
// See conv.cu.

#include "conv_backbone.cuh"

namespace conv_backbone {

template <>
cudaError_t launch_bf16<CONV_RING_BM>(const void* x, const void* w,
        const conv_ring::Geom& g, int bn,
        const BackboneEpilogue<float>& epi, cudaStream_t stream) {
    return conv_ring::launch_rows<conv_ring::A_ASYNC_BF16, CONV_RING_BM>(
        x, w, g, bn, epi, stream);
}

}  // namespace conv_backbone
