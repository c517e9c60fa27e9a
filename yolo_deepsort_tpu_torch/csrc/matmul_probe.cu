// Kernel 10: the tiled matrix product of the int8 capability probe,
// (M, K) x (K, N) on the tensor cores:
//
//   bf16: bf16 x bf16 -> f32 sums -> bf16
//   int8: int8 x int8 -> int32 sums -> clip(floor(acc / (8 K)), -127, 127)
//         -> int8   (the probe's renormalisation; FLOOR division, as
//         Python's and jnp's `//` on negative sums, not C's truncation)
//
// Replaces the TPU kernel tools/int8_probe.py pl_kernel, whose grid walks
// 512-row tiles of M with K and N whole in VMEM. Here a block owns a
// 128 x 128 output tile and walks K in steps of 32: the A and B tiles go
// through registers into one shared-memory buffer (two barriers per step)
// while the tensor cores work on the previous step, eight warps of 32 rows x
// 64 columns keep their accumulators in registers. At the probe's shape,
// (32768, 256) x (256, 256), the product does 128 operations per byte moved:
// bound by bytes on the H100 in both modes (the bf16 ridge is at 295). It
// is a probe of the tensor cores through wmma, the route the port's conv
// kernels take; it is not a tuned GEMM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;
constexpr int KP = BK / 16, NP = BN / 16;

template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
    static constexpr int LDP = 24;  // panel row pitch in elements (48 bytes)
    using Acc = float;
};
template <>
struct Elem<signed char> {
    static constexpr int LDP = 32;  // 32 bytes
    using Acc = int;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
              T* __restrict__ out, int m_total, int k_total, int n_total) {
    using Acc = typename Elem<T>::Acc;
    constexpr int LDP = Elem<T>::LDP;
    constexpr bool INT8 = sizeof(T) == 1;
    constexpr int VE = 16 / (int)sizeof(T);  // elements per 16-byte vector
    constexpr int B_GPR = BN / VE;
    constexpr int B_IT = BK * B_GPR / THREADS;

    __shared__ __align__(128) unsigned char a_raw[KP * BM * LDP * sizeof(T)];
    __shared__ __align__(128) unsigned char b_raw[NP * BK * LDP * sizeof(T)];
    __shared__ __align__(128) Acc c_s[8 * 256];
    T* a_s = reinterpret_cast<T*>(a_raw);
    T* b_s = reinterpret_cast<T*>(b_raw);

    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    const int wm = warp & 3, wn = warp >> 2;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int iters = k_total / BK;

    // a thread gathers 8 depth elements of two rows per step
    const int a_grp = t & 3;
    bool a_ok[2];
    const T* a_ptr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int m = m0 + (t >> 2) + i * 64;
        a_ok[i] = m < m_total;
        a_ptr[i] = x + (long long)(a_ok[i] ? m : 0) * k_total + a_grp * 8;
    }

    uint4 a_reg[2];
    uint4 b_reg[B_IT];

    auto load_tiles = [&](int it) {
        const int k0 = it * BK;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            a_reg[i] = make_uint4(0u, 0u, 0u, 0u);
            if (a_ok[i]) {
                if constexpr (INT8) {
                    const uint2 v = __ldg(reinterpret_cast<const uint2*>(
                        a_ptr[i] + k0));
                    a_reg[i].x = v.x;
                    a_reg[i].y = v.y;
                } else {
                    a_reg[i] = __ldg(reinterpret_cast<const uint4*>(
                        a_ptr[i] + k0));
                }
            }
        }
#pragma unroll
        for (int i = 0; i < B_IT; ++i) {
            const int idx = t + i * THREADS;
            const int kk = idx / B_GPR, gg = idx - kk * B_GPR;
            b_reg[i] = __ldg(reinterpret_cast<const uint4*>(
                w + (long long)(k0 + kk) * n_total + n0 + gg * VE));
        }
    };

    auto store_tiles = [&]() {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int r = (t >> 2) + i * 64;
            T* p = a_s + ((a_grp >> 1) * BM + r) * LDP + (a_grp & 1) * 8;
            if constexpr (INT8)
                *reinterpret_cast<uint2*>(p) = make_uint2(a_reg[i].x,
                                                          a_reg[i].y);
            else
                *reinterpret_cast<uint4*>(p) = a_reg[i];
        }
#pragma unroll
        for (int i = 0; i < B_IT; ++i) {
            const int idx = t + i * THREADS;
            const int kk = idx / B_GPR, gg = idx - kk * B_GPR;
            const int np = (gg * VE) >> 4, off = (gg * VE) & 15;
            *reinterpret_cast<uint4*>(b_s + (np * BK + kk) * LDP + off) =
                b_reg[i];
        }
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], (Acc)0);

    load_tiles(0);
    for (int it = 0; it < iters; ++it) {
        __syncthreads();  // the previous step's fragments have been read
        store_tiles();
        __syncthreads();
        if (it + 1 < iters) load_tiles(it + 1);
#pragma unroll
        for (int kp = 0; kp < KP; ++kp) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>
                af[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(
                    af[i], a_s + (kp * BM + wm * 32 + i * 16) * LDP, LDP);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major>
                    bf;
                wmma::load_matrix_sync(
                    bf, b_s + ((wn * 4 + j) * BK + kp * 16) * LDP, LDP);
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    wmma::mma_sync(acc[i][j], af[i], bf, acc[i][j]);
            }
        }
    }

    // epilogue through a per-warp scratch tile: a lane handles 8 consecutive
    // columns of one row
    Acc* cw = c_s + warp * 256;
    const int er = lane >> 1, ec = (lane & 1) * 8;
    const int div = 8 * k_total;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            wmma::store_matrix_sync(cw, acc[i][j], 16, wmma::mem_row_major);
            __syncwarp();
            const int m = m0 + wm * 32 + i * 16 + er;
            const int col = n0 + wn * 64 + j * 16 + ec;
            if (m < m_total) {
                T* dst = out + (long long)m * n_total + col;
                if constexpr (INT8) {
                    unsigned int q[8];
#pragma unroll
                    for (int e = 0; e < 8; ++e) {
                        const int a = cw[er * 16 + ec + e];
                        int f = a / div;  // truncates toward zero
                        if (a % div != 0 && a < 0) --f;  // floor (div > 0)
                        f = f < -127 ? -127 : (f > 127 ? 127 : f);
                        q[e] = (unsigned int)(unsigned char)(signed char)f;
                    }
                    uint2 v;
                    v.x = q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24);
                    v.y = q[4] | (q[5] << 8) | (q[6] << 16) | (q[7] << 24);
                    *reinterpret_cast<uint2*>(dst) = v;
                } else {
                    unsigned int h[8];
#pragma unroll
                    for (int e = 0; e < 8; ++e)
                        h[e] = __bfloat16_as_ushort(
                            __float2bfloat16_rn(cw[er * 16 + ec + e]));
                    uint4 v;
                    v.x = h[0] | (h[1] << 16);
                    v.y = h[2] | (h[3] << 16);
                    v.z = h[4] | (h[5] << 16);
                    v.w = h[6] | (h[7] << 16);
                    *reinterpret_cast<uint4*>(dst) = v;
                }
            }
            __syncwarp();
        }
    }
}

}  // namespace

// x (M, K), w (K, N), out (M, N), all bf16 (int8_mode 0) or all int8
// (int8_mode 1), row-major. K must be a multiple of 32 and N of 128.
extern "C" int ydt_matmul_probe(const void* x, const void* w, void* out,
                                int m, int k, int n, int int8_mode,
                                void* stream) {
    if (m <= 0 || k <= 0 || n <= 0 || (k % BK) != 0 || (n % BN) != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((m + BM - 1) / BM, n / BN);
    if (int8_mode)
        matmul_kernel<signed char><<<grid, THREADS, 0, st>>>(
            static_cast<const signed char*>(x),
            static_cast<const signed char*>(w),
            static_cast<signed char*>(out), m, k, n);
    else
        matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(w),
            static_cast<__nv_bfloat16*>(out), m, k, n);
    return (int)cudaGetLastError();
}
