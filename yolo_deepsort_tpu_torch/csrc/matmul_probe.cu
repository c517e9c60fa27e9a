// Kernel 10: the matrix product of the int8 capability probe, (M, K) x
// (K, N) on the tensor cores:
//
//   bf16: bf16 x bf16 -> f32 sums -> bf16
//   int8: int8 x int8 -> int32 sums -> clip(floor(acc / (8 K)), -127, 127)
//         -> int8   (the probe's renormalisation; FLOOR division, as
//         Python's and jnp's `//` on negative sums, not C's truncation)
//
// Replaces the TPU kernel tools/int8_probe.py pl_kernel, whose grid walks
// 512-row tiles of M with K and N whole in VMEM. Here the product is a 1x1
// conv of the main loop the conv kernels share (conv_mainloop.cuh): rows M
// (as M images of one pixel), depth K, columns N, the weights packed once to
// K-major (N, ldw) rows by the caller (integer wgmma reads both operands
// K-major only; the TPU kernel, too, holds its w resident across the
// probe's calls). A producer warpgroup streams the A and B tiles into a
// ring of shared-memory stages with cp.async, consumer warpgroups run wgmma
// (m64nNk16 bf16 or m64nNk32 s8) on the stages that have landed, and the
// tile plan (BM x BN, stages, split) comes from Python
// (ops/conv_plan.py plan_conv_tiles). This file adds only the epilogue: a
// thread keeps 8 (bf16) or 16 (int8) consecutive columns of a row and
// stores them as one 16-byte vector.
//
// At the probe's shape, (32768, 256) x (256, 256), the product does 128
// operations per byte moved: bound by bytes on the H100 in both types (the
// bf16 ridge is at 295).
//
// The build compiles this file once per tile height (CONV_RING_BM = 64 and
// 128). The planner's rule, which decides every shape of the probe (none is
// in its table), gives 64 x 64, 64 x 128 or 128 x 128 tiles, never
// 128 x 256: only those three are instantiated, each in both types. The C
// entry is compiled with the 64-row half.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_mainloop.cuh"

namespace probe {

template <typename A>
struct ProbeEpilogue;

template <>
struct ProbeEpilogue<float> {  // bf16 out
    using Acc = float;
    static constexpr int NV = 8;
    __nv_bfloat16* out;
    int n;

    struct Cols {};
    struct Pre {};
    __device__ __forceinline__ Cols load_cols(int) const { return Cols{}; }
    __device__ __forceinline__ Pre prefetch(int, int) const { return Pre{}; }

    __device__ __forceinline__ void store(int m, int col, const float (&v)[8],
                                          const Cols&, const Pre&) const {
        unsigned int h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
            h[e] = __bfloat16_as_ushort(__float2bfloat16_rn(v[e]));
        *reinterpret_cast<uint4*>(out + (long long)m * n + col) = make_uint4(
            h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
            h[6] | (h[7] << 16));
    }
};

template <>
struct ProbeEpilogue<int> {  // int8 out
    using Acc = int;
    static constexpr int NV = 16;
    signed char* out;
    int n;
    conv_ring::FastDiv by_div;  // by 8 K, a multiply and a shift

    struct Cols {};
    struct Pre {};
    __device__ __forceinline__ Cols load_cols(int) const { return Cols{}; }
    __device__ __forceinline__ Pre prefetch(int, int) const { return Pre{}; }

    __device__ __forceinline__ void store(int m, int col, const int (&v)[16],
                                          const Cols&, const Pre&) const {
        unsigned int q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 16; ++e) {
            // floor(a / d) = -ceil(-a / d) = -((d - 1 - a) / d) for a < 0;
            // both dividends lie in [0, 2^31) (checked at the entry)
            const int a = v[e];
            int f = a >= 0 ? by_div.div(a)
                           : -by_div.div((int)by_div.d - 1 - a);
            f = f < -127 ? -127 : (f > 127 ? 127 : f);
            q[e >> 2] |= (unsigned int)(unsigned char)(signed char)f
                         << (8 * (e & 3));
        }
        *reinterpret_cast<uint4*>(out + (long long)m * n + col) =
            make_uint4(q[0], q[1], q[2], q[3]);
    }
};

// One per type and tile height, defined below for CONV_RING_BM.
template <int BM, typename A>
cudaError_t run(const void* x, const void* w, const conv_ring::Geom& g,
                int bn, const ProbeEpilogue<A>& epi, cudaStream_t stream);
template <>
cudaError_t run<64, float>(const void*, const void*, const conv_ring::Geom&,
                           int, const ProbeEpilogue<float>&, cudaStream_t);
template <>
cudaError_t run<64, int>(const void*, const void*, const conv_ring::Geom&,
                         int, const ProbeEpilogue<int>&, cudaStream_t);
template <>
cudaError_t run<128, float>(const void*, const void*, const conv_ring::Geom&,
                            int, const ProbeEpilogue<float>&, cudaStream_t);
template <>
cudaError_t run<128, int>(const void*, const void*, const conv_ring::Geom&,
                          int, const ProbeEpilogue<int>&, cudaStream_t);

template <int AMODE, typename A>
cudaError_t launch(const void* x, const void* w, const conv_ring::Geom& g,
                   int bn, const ProbeEpilogue<A>& epi, cudaStream_t stream) {
    if (g.stages < 2 || g.stages > 16 || g.split < 1 || g.split > 8
        || g.split > g.steps)
        return cudaErrorInvalidValue;
    using Epi = ProbeEpilogue<A>;
#if CONV_RING_BM == 64
    if (bn == 64)
        return conv_ring::launch_tile<AMODE, 64, 64, Epi>(x, w, g, epi,
                                                          stream);
    if (bn == 128)
        return conv_ring::launch_tile<AMODE, 64, 128, Epi>(x, w, g, epi,
                                                           stream);
#else
    if (bn == 128)
        return conv_ring::launch_tile<AMODE, 128, 128, Epi>(x, w, g, epi,
                                                            stream);
#endif
    return cudaErrorInvalidValue;
}

template <>
cudaError_t run<CONV_RING_BM, float>(const void* x, const void* w,
        const conv_ring::Geom& g, int bn, const ProbeEpilogue<float>& epi,
        cudaStream_t stream) {
    return launch<conv_ring::A_ASYNC_BF16>(x, w, g, bn, epi, stream);
}

template <>
cudaError_t run<CONV_RING_BM, int>(const void* x, const void* w,
        const conv_ring::Geom& g, int bn, const ProbeEpilogue<int>& epi,
        cudaStream_t stream) {
    return launch<conv_ring::A_ASYNC_S8>(x, w, g, bn, epi, stream);
}

}  // namespace probe

#if CONV_RING_BM == 64
// x (M, K) row-major; w (N, ldw), the (K, N) weights packed K-major (row j
// holds column j of w, zero up to the pitch ldw); out (M, N); all bf16
// (int8_mode 0) or all int8 (int8_mode 1). bm, bn, stages, split: the tile
// plan, with (bm, bn) one of 64 x 64, 64 x 128, 128 x 128. K and N must be
// multiples of 16, every pointer 16-byte aligned, M * K below 2^31 and
// 16392 K below 2^31 (|sum| <= 128^2 K, plus 8 K for the floor).
extern "C" int ydt_matmul_probe(const void* x, const void* w, void* out,
                                int m, int k, int n, int ldw, int int8_mode,
                                int bm, int bn, int stages, int split,
                                void* stream) {
    const int es = int8_mode ? 1 : 2;
    const uintptr_t ptrs = (uintptr_t)x | (uintptr_t)w | (uintptr_t)out;
    if (m <= 0 || k <= 0 || n <= 0 || (k % 16) != 0 || (n % 16) != 0
        || (ptrs & 15) != 0 || ldw < k || (ldw * es) % 16 != 0
        || (long long)m * k >= (1ll << 31) || 16392ll * k >= (1ll << 31)
        || (bm != 64 && bm != 128))
        return (int)cudaErrorInvalidValue;
    const conv_ring::Geom g = conv_ring::make_geom(
        m, 1, 1, k, 1, 1, n, 1, 1, 0, ldw, stages, split, 0.0f, es);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool tall = bm == 128;
    cudaError_t err;
    if (int8_mode) {
        conv_ring::FastDiv by_div;
        by_div.init((uint32_t)(8 * k));
        const probe::ProbeEpilogue<int> epi{static_cast<signed char*>(out),
                                            n, by_div};
        err = tall ? probe::run<128, int>(x, w, g, bn, epi, st)
                   : probe::run<64, int>(x, w, g, bn, epi, st);
    } else {
        const probe::ProbeEpilogue<float> epi{
            static_cast<__nv_bfloat16*>(out), n};
        err = tall ? probe::run<128, float>(x, w, g, bn, epi, st)
                   : probe::run<64, float>(x, w, g, bn, epi, st);
    }
    return (int)err;
}
#endif
