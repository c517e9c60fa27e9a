// Kernel 8's epilogue and the launcher of its two output types, shared by
// conv_int8.cu (the C entry) and conv_int8_out_*.cu. Each output type
// instantiates the main loop of conv_mainloop.cuh at four tiles; a
// translation unit per type and tile height lets the build compile them side
// by side.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_mainloop.cuh"

namespace conv_reid {

__device__ __forceinline__ float code(unsigned int word, int byte) {
    return (float)(signed char)((word >> (8 * byte)) & 0xffu);
}

__device__ __forceinline__ unsigned int requant(float y, float oinv) {
    float q = fminf(fmaxf(rintf(__fmul_rn(y, oinv)), -127.0f), 127.0f);
    return (unsigned int)(unsigned char)(signed char)(int)q;
}

// OUT_INT8: requantized int8 out, else f32
template <bool OUT_INT8>
struct ReidEpilogue {  // the name tells kernel 8 in a profile
    using Acc = int;
    static constexpr int NV = 16;
    const float* scale;
    const float* bias;
    const signed char* res;
    void* out;
    float res_scale, oinv;
    int co, relu;

    struct Cols {
        float scale[16], bias[16];
    };
    using Pre = uint4;  // the residual's 16 codes

    __device__ __forceinline__ Cols load_cols(int col) const {
        Cols c;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
            const float4 s4 =
                __ldg(reinterpret_cast<const float4*>(scale + col) + g);
            const float4 b4 =
                __ldg(reinterpret_cast<const float4*>(bias + col) + g);
            c.scale[4 * g] = s4.x; c.scale[4 * g + 1] = s4.y;
            c.scale[4 * g + 2] = s4.z; c.scale[4 * g + 3] = s4.w;
            c.bias[4 * g] = b4.x; c.bias[4 * g + 1] = b4.y;
            c.bias[4 * g + 2] = b4.z; c.bias[4 * g + 3] = b4.w;
        }
        return c;
    }

    __device__ __forceinline__ Pre prefetch(int m, int col) const {
        if (res == nullptr) return make_uint4(0u, 0u, 0u, 0u);
        return __ldg(reinterpret_cast<const uint4*>(
            res + (long long)m * co + col));
    }

    __device__ __forceinline__ void store(int m, int col, const int (&v)[16],
                                          const Cols& c, const Pre& rv) const {
        const long long o = (long long)m * co + col;
        const unsigned int rw[4] = {rv.x, rv.y, rv.z, rv.w};
        float y[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
            float t = __fmul_rn((float)v[e], c.scale[e]);
            t = __fadd_rn(t, c.bias[e]);
            if (res != nullptr)
                t = __fadd_rn(t, __fmul_rn(code(rw[e >> 2], e & 3),
                                           res_scale));
            y[e] = relu ? fmaxf(t, 0.0f) : t;
        }
        if constexpr (OUT_INT8) {
            unsigned int q[4];
#pragma unroll
            for (int g = 0; g < 4; ++g)
                q[g] = requant(y[4 * g], oinv)
                       | (requant(y[4 * g + 1], oinv) << 8)
                       | (requant(y[4 * g + 2], oinv) << 16)
                       | (requant(y[4 * g + 3], oinv) << 24);
            *reinterpret_cast<uint4*>(static_cast<signed char*>(out) + o) =
                make_uint4(q[0], q[1], q[2], q[3]);
        } else {
            float4* dst =
                reinterpret_cast<float4*>(static_cast<float*>(out) + o);
#pragma unroll
            for (int g = 0; g < 4; ++g)
                dst[g] = make_float4(y[4 * g], y[4 * g + 1], y[4 * g + 2],
                                     y[4 * g + 3]);
        }
    }
};

// Defined for int8 codes and for f32 and for BM = 64 and 128 rows a tile,
// each in a translation unit of its own: conv_int8_out_*.cu, compiled once
// per CONV_RING_BM.
template <bool OUT_INT8, int BM>
cudaError_t run(const void* x, const void* w, const conv_ring::Geom& g,
                int bn, const ReidEpilogue<OUT_INT8>& epi,
                cudaStream_t stream);
#define CONV_REID_RUN(OUT, BM)                                              \
    template <>                                                             \
    cudaError_t run<OUT, BM>(const void*, const void*,                      \
                             const conv_ring::Geom&, int,                   \
                             const ReidEpilogue<OUT>&, cudaStream_t);
CONV_REID_RUN(true, 64)
CONV_REID_RUN(true, 128)
CONV_REID_RUN(false, 64)
CONV_REID_RUN(false, 128)
#undef CONV_REID_RUN

}  // namespace conv_reid
