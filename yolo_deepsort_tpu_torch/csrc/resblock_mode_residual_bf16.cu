// Kernel 9, the bf16 block's 3x3 conv (bf16 mid by cp.async) with the
// shortcut add:
// the main loop of conv_mainloop.cuh at the tiles of CONV_RING_BM rows (64 or
// 128; the build compiles this file once for each), with kernel 9's epilogue.
// See resblock.cu.

#include "resblock_chain.cuh"

namespace resblock {

template <>
cudaError_t launch_residual_bf16<CONV_RING_BM>(const void* x, const void* w,
        const conv_ring::Geom& g, int bn, const ResidualEpilogue<float>& epi,
        cudaStream_t stream) {
    return conv_ring::launch_rows<conv_ring::A_ASYNC_BF16, CONV_RING_BM>(
        x, w, g, bn, epi, stream);
}

}  // namespace resblock
