// Kernel 8, f32 out: the main loop of conv_mainloop.cuh at
// the tiles of CONV_RING_BM rows (64 or 128; the build compiles this file once
// for each), with kernel 8's epilogue. See conv_int8.cu.

#include "conv_reid.cuh"

namespace conv_reid {

template <>
cudaError_t run<false, CONV_RING_BM>(const void* x, const void* w,
        const conv_ring::Geom& g, int bn,
        const ReidEpilogue<false>& epi, cudaStream_t stream) {
    return conv_ring::launch_rows<conv_ring::A_ASYNC_S8, CONV_RING_BM>(
        x, w, g, bn, epi, stream);
}

}  // namespace conv_reid
