// Kernel 7, mode 0 with a residual block's tail (an identity shortcut,
// the block's bf16 input):
// the main loop of conv_mainloop.cuh at the tiles of CONV_RING_BM rows (64 or
// 128; the build compiles this file once for each), with the shortcut
// epilogue of conv_backbone.cuh. See conv.cu.

#include "conv_backbone.cuh"

namespace conv_backbone {

template <>
cudaError_t launch_res<__nv_bfloat16, CONV_RING_BM>(const void* x, const void* w,
        const conv_ring::Geom& g, int bn,
        const ShortcutEpilogue<__nv_bfloat16>& epi, cudaStream_t stream) {
    return conv_ring::launch_rows<conv_ring::A_ASYNC_BF16, CONV_RING_BM>(
        x, w, g, bn, epi, stream);
}

}  // namespace conv_backbone
