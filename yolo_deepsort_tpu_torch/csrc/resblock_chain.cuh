// Kernel 9's epilogues and the launchers of its three new modes, shared by
// resblock.cu (the C entry) and resblock_mode_*.cu. Each mode instantiates
// the main loop of conv_mainloop.cuh at four tiles; a translation unit per
// mode and tile height lets the build compile them side by side. The bf16
// chain's 1x1 conv is kernel 7's mode 0 as it is (conv_backbone.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_backbone.cuh"

namespace resblock {

using conv_backbone::activate;

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// The 3x3 conv of a block with the shortcut add:
//     y = bf16(act(f32(acc) [* scale[c]] + bias[c]))
//     out = bf16(f32(y) + f32(x))
// A: float sums (bf16 mode) or int sums (W8A8, which scale). x, the block's
// input, is the residual: its 8 values of a row are fetched ahead of the
// drain.
template <typename A>
struct ResidualEpilogue {  // the name tells kernel 9 in a profile
    using Acc = A;
    static constexpr int NV = 8;
    const float* bias;
    const float* scale;
    const __nv_bfloat16* res;
    __nv_bfloat16* out;
    int co, act;

    struct Cols {
        float bias[8], scale[8];
    };
    using Pre = uint4;  // the shortcut's 8 bf16 values

    __device__ __forceinline__ Cols load_cols(int col) const {
        Cols c;
#pragma unroll
        for (int g = 0; g < 2; ++g) {
            const float4 b4 =
                __ldg(reinterpret_cast<const float4*>(bias + col) + g);
            c.bias[4 * g] = b4.x; c.bias[4 * g + 1] = b4.y;
            c.bias[4 * g + 2] = b4.z; c.bias[4 * g + 3] = b4.w;
            if constexpr (conv_ring::IsInt<A>::value) {
                const float4 s4 =
                    __ldg(reinterpret_cast<const float4*>(scale + col) + g);
                c.scale[4 * g] = s4.x; c.scale[4 * g + 1] = s4.y;
                c.scale[4 * g + 2] = s4.z; c.scale[4 * g + 3] = s4.w;
            }
        }
        return c;
    }

    // x was written by an earlier launch: the read-only path is coherent
    __device__ __forceinline__ Pre prefetch(int m, int col) const {
        return __ldg(reinterpret_cast<const uint4*>(
            res + (long long)m * co + col));
    }

    __device__ __forceinline__ void store(int m, int col, const A (&v)[8],
                                          const Cols& c,
                                          const Pre& rv) const {
        const unsigned int rw[4] = {rv.x, rv.y, rv.z, rv.w};
        unsigned int h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            float y = (float)v[e];
            if constexpr (conv_ring::IsInt<A>::value)
                y = __fmul_rn(y, c.scale[e]);
            y = round_bf16(activate(__fadd_rn(y, c.bias[e]), act));
            const float x = (e & 1) ? conv_ring::bf16_hi(rw[e >> 1])
                                    : conv_ring::bf16_lo(rw[e >> 1]);
            h[e] = __bfloat16_as_ushort(__float2bfloat16_rn(__fadd_rn(y, x)));
        }
        *reinterpret_cast<uint4*>(out + (long long)m * co + col) = make_uint4(
            h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
            h[6] | (h[7] << 16));
    }
};

// The 1x1 conv of a W8A8 block, which writes `mid` as the int8 codes the
// 3x3 conv reads:
//     m = bf16(act(f32(acc) * scale[c] + bias[c]))
//     code = clip(rint(f32(m) * xinv), -127, 127)      (ties to even)
// the same values as rounding mid to bf16 and quantizing it on the way
// into the next conv.
struct CodesEpilogue {  // the name tells kernel 9 in a profile
    using Acc = int;
    static constexpr int NV = 16;
    const float* bias;
    const float* scale;
    signed char* out;
    int co, act;
    float xinv;  // 1 / the 3x3 conv's activation scale

    struct Cols {
        float bias[16], scale[16];
    };
    struct Pre {};  // nothing to fetch per row

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

    __device__ __forceinline__ Pre prefetch(int, int) const { return Pre{}; }

    __device__ __forceinline__ void store(int m, int col, const int (&v)[16],
                                          const Cols& c, const Pre&) const {
        unsigned int q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 16; ++e) {
            float y = __fmul_rn((float)v[e], c.scale[e]);
            y = round_bf16(activate(__fadd_rn(y, c.bias[e]), act));
            const float r =
                fminf(fmaxf(rintf(__fmul_rn(y, xinv)), -127.0f), 127.0f);
            q[e >> 2] |= (unsigned int)(unsigned char)(signed char)(int)r
                         << (8 * (e & 3));
        }
        *reinterpret_cast<uint4*>(out + (long long)m * co + col) =
            make_uint4(q[0], q[1], q[2], q[3]);
    }
};

// One per mode and BM (64 or 128 rows a tile), each defined in a translation
// unit of its own (resblock_mode_*.cu, compiled once per tile height):
//   residual_bf16  3x3, bf16 mid by cp.async, ResidualEpilogue<float>
//   codes          1x1, bf16 state quantized by the producers, CodesEpilogue
//   residual_s8    3x3, int8 mid codes by cp.async, ResidualEpilogue<int>
template <int BM>
cudaError_t launch_residual_bf16(const void* x, const void* w,
                                 const conv_ring::Geom& g, int bn,
                                 const ResidualEpilogue<float>& epi,
                                 cudaStream_t stream);
template <int BM>
cudaError_t launch_codes(const void* x, const void* w,
                         const conv_ring::Geom& g, int bn,
                         const CodesEpilogue& epi, cudaStream_t stream);
template <int BM>
cudaError_t launch_residual_s8(const void* x, const void* w,
                               const conv_ring::Geom& g, int bn,
                               const ResidualEpilogue<int>& epi,
                               cudaStream_t stream);
#define RESBLOCK_LAUNCH(NAME, EPI, BM)                                      \
    template <>                                                             \
    cudaError_t NAME<BM>(const void*, const void*, const conv_ring::Geom&,  \
                         int, const EPI&, cudaStream_t);
RESBLOCK_LAUNCH(launch_residual_bf16, ResidualEpilogue<float>, 64)
RESBLOCK_LAUNCH(launch_residual_bf16, ResidualEpilogue<float>, 128)
RESBLOCK_LAUNCH(launch_codes, CodesEpilogue, 64)
RESBLOCK_LAUNCH(launch_codes, CodesEpilogue, 128)
RESBLOCK_LAUNCH(launch_residual_s8, ResidualEpilogue<int>, 64)
RESBLOCK_LAUNCH(launch_residual_s8, ResidualEpilogue<int>, 128)
#undef RESBLOCK_LAUNCH

}  // namespace resblock
