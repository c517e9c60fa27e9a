// Kernel 7, mode 1 (int8 weights; bf16 activations quantized by the
// producers):
// the main loop of conv_mainloop.cuh at the tiles of CONV_RING_BM rows (64 or
// 128; the build compiles this file once for each), with kernel 7's epilogue.
// See conv.cu.

#include "conv_backbone.cuh"

namespace conv_backbone {

template <>
cudaError_t launch_quant_bf16<CONV_RING_BM>(const void* x, const void* w,
        const conv_ring::Geom& g, int bn,
        const BackboneEpilogue<int>& epi, cudaStream_t stream) {
    return conv_ring::launch_rows<conv_ring::A_QUANT_BF16, CONV_RING_BM>(
        x, w, g, bn, epi, stream);
}

}  // namespace conv_backbone
