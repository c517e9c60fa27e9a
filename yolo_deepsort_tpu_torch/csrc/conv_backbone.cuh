// Kernel 7's epilogues and the launchers of its three modes and of the bf16
// mode's residual form, shared by conv.cu (the C entry) and conv_mode_*.cu.
// Each mode instantiates the main loop of conv_mainloop.cuh at four tiles; a
// translation unit per mode (and shortcut type) and tile height lets the
// build compile them side by side.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_mainloop.cuh"

namespace conv_backbone {

// ReLU and ELU are the ReID nets' (deep/model.py and original_model.py)
enum Act { ACT_LINEAR = 0, ACT_LEAKY = 1, ACT_MISH = 2, ACT_RELU = 3,
           ACT_ELU = 4 };

__device__ __forceinline__ float activate(float y, int act) {
    if (act == ACT_LEAKY) return y > 0.0f ? y : 0.1f * y;
    if (act == ACT_MISH) {
        // y tanh(log(1 + e^y)) = y n / (n + 2), n = e^y (e^y + 2): one
        // exponential and one division, each step rounded as written (the
        // unit builds with --fmad=false; the fmas of the division are
        // explicit). The division is the approximate reciprocal and one
        // Newton step on the quotient, within a fraction of an ulp of
        // __fdiv_rn, whose slow path would be a call in every
        // instantiation. No branch: above 20 tanh(softplus(y)) rounds to 1
        // in f32, and past ~44.3 n overflows (the quotient is NaN there),
        // so y itself is selected. Within 8 f32 ulps of float64 mish for
        // y >= -80 (tests/test_torch_port_mish_form.py).
        const float e = expf(y);
        const float n = __fmul_rn(e, __fadd_rn(e, 2.0f));
        const float d = __fadd_rn(n, 2.0f), yn = __fmul_rn(y, n);
        float r;
        asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
        const float q = __fmul_rn(yn, r);
        const float m = __fmaf_rn(__fmaf_rn(-d, q, yn), r, q);
        return y > 20.0f ? y : m;
    }
    if (act == ACT_RELU) return y > 0.0f ? y : 0.0f;
    if (act == ACT_ELU) return y > 0.0f ? y : expm1f(y);
    return y;
}

// A: float sums (bf16 mode) or int sums (the int8 modes, which scale)
template <typename A>
struct BackboneEpilogue {  // the name tells kernel 7 in a profile
    using Acc = A;
    static constexpr int NV = 8;
    const float* bias;
    const float* scale;
    void* out;   // bf16 NHWC, or f32 NHWC where f32_out
    int co, act;
    bool f32_out;  // bf16 mode only: act(sum + bias) unrounded, for a
                   // caller that adds a shortcut in f32 before it rounds

    struct Cols {
        float bias[8], scale[8];
    };
    struct Pre {};  // nothing to fetch per row

    __device__ __forceinline__ Cols load_cols(int col) const {
        Cols c;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const bool ok = col + e < co;  // Co = 255: the last column
            c.bias[e] = ok ? __ldg(bias + col + e) : 0.0f;
            if constexpr (conv_ring::IsInt<A>::value)
                c.scale[e] = ok ? __ldg(scale + col + e) : 0.0f;
            else
                c.scale[e] = 1.0f;
        }
        return c;
    }

    __device__ __forceinline__ Pre prefetch(int, int) const { return Pre{}; }

    __device__ __forceinline__ void store(int m, int col, const A (&v)[8],
                                          const Cols& c, const Pre&) const {
        float y[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            y[e] = (float)v[e];
            if constexpr (conv_ring::IsInt<A>::value) y[e] = y[e] * c.scale[e];
            y[e] = activate(y[e] + c.bias[e], act);
        }
        if (f32_out) {
            float* dst = static_cast<float*>(out) + (long long)m * co + col;
            if ((co % 8) == 0) {
                reinterpret_cast<float4*>(dst)[0] =
                    make_float4(y[0], y[1], y[2], y[3]);
                reinterpret_cast<float4*>(dst)[1] =
                    make_float4(y[4], y[5], y[6], y[7]);
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    if (col + e < co) dst[e] = y[e];
            }
            return;
        }
        unsigned short h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
            h[e] = __bfloat16_as_ushort(__float2bfloat16_rn(y[e]));
        __nv_bfloat16* dst =
            static_cast<__nv_bfloat16*>(out) + (long long)m * co + col;
        if ((co % 8) == 0) {
            uint4 u;
            u.x = h[0] | ((unsigned int)h[1] << 16);
            u.y = h[2] | ((unsigned int)h[3] << 16);
            u.z = h[4] | ((unsigned int)h[5] << 16);
            u.w = h[6] | ((unsigned int)h[7] << 16);
            *reinterpret_cast<uint4*>(dst) = u;
        } else {
            unsigned short* d16 = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
            for (int e = 0; e < 8; ++e)
                if (col + e < co) d16[e] = h[e];
        }
    }
};


// The bf16 mode with a residual block's tail: bf16(act((sum + bias) +
// shortcut)), each step in f32 and in that order, rounded once, the sum the
// f32-output form gives for the same plan. R is the shortcut's type: bf16
// (an identity shortcut, the block's input) or float (a projection conv's
// f32 output). The shortcut's 8 columns of a row are fetched ahead of the
// drain (prefetch). Co must be a multiple of 8 (16- and 32-byte loads and
// one 16-byte store).
template <typename R>
struct ShortcutEpilogue {  // the name tells kernel 7's residual form
    using Acc = float;
    static constexpr int NV = 8;
    static constexpr int WORDS = sizeof(R) / 2;  // 16-byte words of 8 R
    const float* bias;
    const R* res;  // (M, Co) NHWC
    void* out;     // bf16 NHWC
    int co, act;

    struct Cols {
        float bias[8];
    };
    struct Pre {
        uint4 u[WORDS];
    };

    __device__ __forceinline__ Cols load_cols(int col) const {
        Cols c;
#pragma unroll
        for (int e = 0; e < 8; ++e) c.bias[e] = __ldg(bias + col + e);
        return c;
    }

    __device__ __forceinline__ Pre prefetch(int m, int col) const {
        const uint4* src =
            reinterpret_cast<const uint4*>(res + (long long)m * co + col);
        Pre p;
#pragma unroll
        for (int i = 0; i < WORDS; ++i) p.u[i] = __ldg(src + i);
        return p;
    }

    __device__ __forceinline__ void store(int m, int col, const float (&v)[8],
                                          const Cols& c, const Pre& p) const {
        float r[8];
        if constexpr (WORDS == 1) {
            const unsigned int w[4] = {p.u[0].x, p.u[0].y, p.u[0].z,
                                       p.u[0].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {  // element 2 e is the low half
                r[2 * e] = __uint_as_float(w[e] << 16);
                r[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
            }
        } else {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                r[4 * i] = __uint_as_float(p.u[i].x);
                r[4 * i + 1] = __uint_as_float(p.u[i].y);
                r[4 * i + 2] = __uint_as_float(p.u[i].z);
                r[4 * i + 3] = __uint_as_float(p.u[i].w);
            }
        }
        unsigned short h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const float y = activate((v[e] + c.bias[e]) + r[e], act);
            h[e] = __bfloat16_as_ushort(__float2bfloat16_rn(y));
        }
        uint4 u;
        u.x = h[0] | ((unsigned int)h[1] << 16);
        u.y = h[2] | ((unsigned int)h[3] << 16);
        u.z = h[4] | ((unsigned int)h[5] << 16);
        u.w = h[6] | ((unsigned int)h[7] << 16);
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out)
                                  + (long long)m * co + col) = u;
    }
};

// One per mode and BM (64 or 128 rows a tile), each defined in a translation
// unit of its own: conv_mode_*.cu, compiled once per CONV_RING_BM.
template <int BM>
cudaError_t launch_bf16(const void* x, const void* w,
                        const conv_ring::Geom& g, int bn,
                        const BackboneEpilogue<float>& epi,
                        cudaStream_t stream);
template <int BM>
cudaError_t launch_quant_bf16(const void* x, const void* w,
                              const conv_ring::Geom& g, int bn,
                              const BackboneEpilogue<int>& epi,
                              cudaStream_t stream);
template <int BM>
cudaError_t launch_quant_f32(const void* x, const void* w,
                             const conv_ring::Geom& g, int bn,
                             const BackboneEpilogue<int>& epi,
                             cudaStream_t stream);
#define CONV_BACKBONE_LAUNCH(NAME, ACC, BM)                                 \
    template <>                                                             \
    cudaError_t NAME<BM>(const void*, const void*, const conv_ring::Geom&,  \
                         int, const BackboneEpilogue<ACC>&, cudaStream_t);
CONV_BACKBONE_LAUNCH(launch_bf16, float, 64)
CONV_BACKBONE_LAUNCH(launch_bf16, float, 128)
CONV_BACKBONE_LAUNCH(launch_quant_bf16, int, 64)
CONV_BACKBONE_LAUNCH(launch_quant_bf16, int, 128)
CONV_BACKBONE_LAUNCH(launch_quant_f32, int, 64)
CONV_BACKBONE_LAUNCH(launch_quant_f32, int, 128)
#undef CONV_BACKBONE_LAUNCH

// The bf16 mode with the residual tail, one per shortcut type and BM:
// conv_mode_res_bf16.cu and conv_mode_res_f32.cu.
template <typename R, int BM>
cudaError_t launch_res(const void* x, const void* w, const conv_ring::Geom& g,
                       int bn, const ShortcutEpilogue<R>& epi,
                       cudaStream_t stream);
#define CONV_BACKBONE_RES(R, BM)                                            \
    template <>                                                             \
    cudaError_t launch_res<R, BM>(const void*, const void*,                 \
                                  const conv_ring::Geom&, int,              \
                                  const ShortcutEpilogue<R>&, cudaStream_t);
CONV_BACKBONE_RES(__nv_bfloat16, 64)
CONV_BACKBONE_RES(__nv_bfloat16, 128)
CONV_BACKBONE_RES(float, 64)
CONV_BACKBONE_RES(float, 128)
#undef CONV_BACKBONE_RES

}  // namespace conv_backbone
