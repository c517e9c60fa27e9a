// Kernel 7: backbone convolution + bias + activation as an implicit GEMM on
// the tensor cores (bf16 x bf16 -> f32, or int8 x int8 -> int32).
//
// Replaces the TPU kernel yolo_deepsort_tpu/ops/pallas_conv.py _conv_kernel
// (conv_mxu_bf16 / conv_mxu_int8). The TPU design keeps whole padded feature
// maps resident in VMEM, strips over H and phase-splits stride 2 outside the
// kernel; none of that carries over. Here the conv is one matrix product:
//
//   rows     M = N * Ho * Wo   (one output pixel each)
//   columns  Co
//   depth    k * k * Ci, walked tap by tap and, inside a tap, in chunks of
//            BK input channels
//
// A block owns one BM x BN output tile. Per depth step its 256 threads gather
// the BM x BK activation tile (zero where the tap falls into the padding, past
// the last row, or past Ci) and the BK x BN weight tile (zero past Co) into
// registers while the tensor cores work on the previous step's tiles in
// shared memory, then store them to shared memory: one buffer, two barriers
// per step. Stride 2 is index arithmetic (iy = oy * stride - pad + dy); there
// is no padded copy, no phase plane and no pre-decimated input. int8 mode
// quantizes the activations between the register load and the shared-memory
// store: clip(rint(f32(x) * xinv), -127, 127), ties to even.
//
// Shared memory holds both tiles as panels of 16 depth elements (A) or 16
// columns (B), each row padded so that every wmma fragment pointer is 32-byte
// aligned for both element sizes. Eight warps split the tile (32 rows x 64 or
// 32 columns each) and keep their accumulators in registers. The epilogue
// passes each 16 x 16 accumulator fragment through a per-warp scratch tile,
// applies (int8: * scale[c]) + bias[c] and the activation in f32, and writes
// bf16 NHWC: 16-byte stores when Co is a multiple of 8, masked 2-byte stores
// otherwise (Co = 255, the yolo heads). Weight rows are read with 16-byte
// loads when Co allows and element by element otherwise.
//
// Bound on the H100 by operations: at the backbone's shapes the product does
// 400-2300 operations per byte moved. This first version feeds the tensor
// cores through wmma from a single shared-memory buffer; wgmma, TMA and a
// multi-stage ring are what a faster version would add.
//
// Built with --fmad=false: the f32 epilogue rounds as the plain PyTorch
// version does (a multiply, then an add), so int8 mode, whose int32 sums are
// exact, equals its plain version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BN = 128;       // output columns per block
constexpr int BK = 32;        // input channels per depth step
constexpr int THREADS = 256;  // 8 warps
constexpr int KP = BK / 16;   // A panels (16 depth elements each)
constexpr int NP = BN / 16;   // B panels (16 columns each)

enum Act { ACT_LINEAR = 0, ACT_LEAKY = 1, ACT_MISH = 2 };

template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
    static constexpr int LDP = 24;  // panel row pitch in elements (48 bytes)
    using Acc = float;
    using Raw = unsigned short;
};
template <>
struct Elem<signed char> {
    static constexpr int LDP = 32;  // 32 bytes
    using Acc = int;
    using Raw = unsigned char;
};

__device__ __forceinline__ float bf16_lo(unsigned int w) {
    return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned int w) {
    return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ unsigned int quant8(float v, float xinv) {
    float q = fminf(fmaxf(rintf(v * xinv), -127.0f), 127.0f);
    return (unsigned int)(unsigned char)(signed char)(int)q;
}

__device__ __forceinline__ unsigned int quant8x4(float a, float b, float c,
                                                 float d, float xinv) {
    return quant8(a, xinv) | (quant8(b, xinv) << 8) | (quant8(c, xinv) << 16)
           | (quant8(d, xinv) << 24);
}

__device__ __forceinline__ float activate(float y, int act) {
    if (act == ACT_LEAKY) return y > 0.0f ? y : 0.1f * y;
    if (act == ACT_MISH) {
        float sp = fmaxf(y, 0.0f) + log1pf(expf(-fabsf(y)));  // softplus
        return y * tanhf(sp);
    }
    return y;
}

// T: element type of the product (bf16 or int8); XT: type of the activations
// in device memory (bf16, or float in int8 mode); BM: output rows per block.
template <typename T, typename XT, int BM>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const XT* __restrict__ x, const T* __restrict__ w,
            const float* __restrict__ bias, const float* __restrict__ scale,
            float xinv, __nv_bfloat16* __restrict__ out, int n_img, int hi,
            int wi, int ci, int ho, int wo, int co, int k, int stride,
            int pad, int act) {
    using Acc = typename Elem<T>::Acc;
    using Raw = typename Elem<T>::Raw;
    constexpr int LDP = Elem<T>::LDP;
    constexpr bool INT8 = sizeof(T) == 1;
    constexpr int VE = 16 / (int)sizeof(T);   // elements per 16-byte vector
    constexpr int XV = (int)sizeof(XT) / 2;   // 16-byte vectors per 8 x values
    constexpr int A_IT = BM / 64;             // 8-value groups per thread
    constexpr int B_GPR = BN / VE;            // vectors per weight-tile row
    constexpr int B_IT = BK * B_GPR / THREADS;
    constexpr int WARPS_M = BM / 32;
    constexpr int WARPS_N = 8 / WARPS_M;
    constexpr int WC = BN / WARPS_N;          // columns per warp
    constexpr int FN = WC / 16;

    __shared__ __align__(128) unsigned char a_raw[KP * BM * LDP * sizeof(T)];
    __shared__ __align__(128) unsigned char b_raw[NP * BK * LDP * sizeof(T)];
    __shared__ __align__(128) Acc c_s[8 * 256];
    T* a_s = reinterpret_cast<T*>(a_raw);
    T* b_s = reinterpret_cast<T*>(b_raw);

    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    const int wm = warp % WARPS_M, wn = warp / WARPS_M;
    const int m_total = n_img * ho * wo;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int chunks = (ci + BK - 1) / BK;
    const int iters = k * k * chunks;
    const bool w_vec = (co % VE) == 0;
    const Raw* w_raw = reinterpret_cast<const Raw*>(w);

    // the rows of the activation tile this thread gathers
    const int a_grp = t & 3;  // which 8 of the step's 32 channels
    int a_iy0[A_IT], a_ix0[A_IT];
    long long a_base[A_IT];
    bool a_ok[A_IT];
#pragma unroll
    for (int i = 0; i < A_IT; ++i) {
        const int m = m0 + (t >> 2) + i * 64;
        a_ok[i] = m < m_total;
        const int mm = a_ok[i] ? m : 0;
        const int img = mm / (ho * wo);
        const int rem = mm - img * (ho * wo);
        const int oy = rem / wo, ox = rem - oy * wo;
        a_iy0[i] = oy * stride - pad;
        a_ix0[i] = ox * stride - pad;
        a_base[i] = (long long)img * hi * wi * ci;
    }

    uint4 a_reg[A_IT][XV];
    uint4 b_reg[B_IT];

    auto load_tiles = [&](int it) {
        const int tap = it / chunks;
        const int c0 = (it - tap * chunks) * BK;
        const int dy = tap / k, dx = tap - dy * k;
        const int c = c0 + a_grp * 8;
#pragma unroll
        for (int i = 0; i < A_IT; ++i) {
            const int iy = a_iy0[i] + dy, ix = a_ix0[i] + dx;
            const bool ok = a_ok[i] && iy >= 0 && iy < hi && ix >= 0
                            && ix < wi && c < ci;
            if (ok) {
                const uint4* p = reinterpret_cast<const uint4*>(
                    x + a_base[i] + ((long long)iy * wi + ix) * ci + c);
#pragma unroll
                for (int v = 0; v < XV; ++v) a_reg[i][v] = __ldg(p + v);
            } else {
#pragma unroll
                for (int v = 0; v < XV; ++v)
                    a_reg[i][v] = make_uint4(0u, 0u, 0u, 0u);
            }
        }
#pragma unroll
        for (int i = 0; i < B_IT; ++i) {
            const int idx = t + i * THREADS;
            const int kk = idx / B_GPR, g = idx - kk * B_GPR;
            const int col = n0 + g * VE;
            const long long row = (long long)tap * ci + c0 + kk;
            if (c0 + kk >= ci || col >= co) {
                b_reg[i] = make_uint4(0u, 0u, 0u, 0u);
            } else if (w_vec) {
                b_reg[i] = __ldg(reinterpret_cast<const uint4*>(
                    w_raw + row * co + col));
            } else {
                // rows of w are not 16-byte aligned (Co = 255): element by
                // element, zero past the last column
                __align__(16) Raw tmp[VE];
#pragma unroll
                for (int e = 0; e < VE; ++e)
                    tmp[e] = (col + e < co) ? w_raw[row * co + col + e]
                                            : (Raw)0;
                b_reg[i] = *reinterpret_cast<const uint4*>(tmp);
            }
        }
    };

    auto store_tiles = [&]() {
#pragma unroll
        for (int i = 0; i < A_IT; ++i) {
            const int r = (t >> 2) + i * 64;
            T* dst = a_s + ((a_grp >> 1) * BM + r) * LDP + (a_grp & 1) * 8;
            if constexpr (!INT8) {
                *reinterpret_cast<uint4*>(dst) = a_reg[i][0];
            } else {
                uint2 q;
                if constexpr (XV == 1) {  // bf16 activations
                    const uint4 v = a_reg[i][0];
                    q.x = quant8x4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y),
                                   bf16_hi(v.y), xinv);
                    q.y = quant8x4(bf16_lo(v.z), bf16_hi(v.z), bf16_lo(v.w),
                                   bf16_hi(v.w), xinv);
                } else {  // float activations
                    const uint4 u = a_reg[i][0], v = a_reg[i][XV - 1];
                    q.x = quant8x4(__uint_as_float(u.x), __uint_as_float(u.y),
                                   __uint_as_float(u.z), __uint_as_float(u.w),
                                   xinv);
                    q.y = quant8x4(__uint_as_float(v.x), __uint_as_float(v.y),
                                   __uint_as_float(v.z), __uint_as_float(v.w),
                                   xinv);
                }
                *reinterpret_cast<uint2*>(dst) = q;
            }
        }
#pragma unroll
        for (int i = 0; i < B_IT; ++i) {
            const int idx = t + i * THREADS;
            const int kk = idx / B_GPR, g = idx - kk * B_GPR;
            const int np = (g * VE) >> 4, off = (g * VE) & 15;
            *reinterpret_cast<uint4*>(b_s + (np * BK + kk) * LDP + off) =
                b_reg[i];
        }
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[2][FN];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], (Acc)0);

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
            for (int j = 0; j < FN; ++j) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major>
                    bf;
                wmma::load_matrix_sync(
                    bf, b_s + (((wn * WC) >> 4) + j) * BK * LDP
                            + kp * 16 * LDP, LDP);
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    wmma::mma_sync(acc[i][j], af[i], bf, acc[i][j]);
            }
        }
    }

    // epilogue: fragment -> per-warp scratch -> scale, bias, activation ->
    // bf16. A lane handles 8 consecutive columns of one row.
    Acc* cw = c_s + warp * 256;
    const int er = lane >> 1, ec = (lane & 1) * 8;
    const bool o_vec = (co % 8) == 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < FN; ++j) {
            wmma::store_matrix_sync(cw, acc[i][j], 16, wmma::mem_row_major);
            __syncwarp();
            const int m = m0 + wm * 32 + i * 16 + er;
            const int col = n0 + wn * WC + j * 16 + ec;
            if (m < m_total && col < co) {
                unsigned short h[8];
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const int c = col + e;
                    float y = 0.0f;
                    if (c < co) {
                        y = (float)cw[er * 16 + ec + e];
                        if constexpr (INT8) y = y * __ldg(scale + c);
                        y = activate(y + __ldg(bias + c), act);
                    }
                    h[e] = __bfloat16_as_ushort(__float2bfloat16_rn(y));
                }
                __nv_bfloat16* dst = out + (long long)m * co + col;
                if (o_vec) {
                    uint4 v;
                    v.x = h[0] | ((unsigned int)h[1] << 16);
                    v.y = h[2] | ((unsigned int)h[3] << 16);
                    v.z = h[4] | ((unsigned int)h[5] << 16);
                    v.w = h[6] | ((unsigned int)h[7] << 16);
                    *reinterpret_cast<uint4*>(dst) = v;
                } else {
                    unsigned short* d16 =
                        reinterpret_cast<unsigned short*>(dst);
#pragma unroll
                    for (int e = 0; e < 8; ++e)
                        if (col + e < co) d16[e] = h[e];
                }
            }
            __syncwarp();
        }
    }
}

template <typename T, typename XT>
cudaError_t launch(const void* x, const void* w, const float* bias,
                   const float* scale, float xinv, void* out, int n, int hi,
                   int wi, int ci, int ho, int wo, int co, int k, int stride,
                   int pad, int act, cudaStream_t stream) {
    const int m = n * ho * wo;
    const int col_tiles = (co + BN - 1) / BN;
    // 128-row tiles when they still give every SM two blocks, else 64
    const bool big = ((m + 127) / 128) * col_tiles >= 2 * 132;
    const XT* xp = static_cast<const XT*>(x);
    const T* wp = static_cast<const T*>(w);
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
    if (big) {
        dim3 grid((m + 127) / 128, col_tiles);
        conv_kernel<T, XT, 128><<<grid, THREADS, 0, stream>>>(
            xp, wp, bias, scale, xinv, op, n, hi, wi, ci, ho, wo, co, k,
            stride, pad, act);
    } else {
        dim3 grid((m + 63) / 64, col_tiles);
        conv_kernel<T, XT, 64><<<grid, THREADS, 0, stream>>>(
            xp, wp, bias, scale, xinv, op, n, hi, wi, ci, ho, wo, co, k,
            stride, pad, act);
    }
    return cudaGetLastError();
}

}  // namespace

// mode 0: bf16 x (N, Hi, Wi, Ci), bf16 w (k*k*Ci, Co); mode 1: int8 w, bf16 x
// quantized in the tile load; mode 2: int8 w, float x. bias (Co,) f32; scale
// (Co,) f32 and xinv in the int8 modes; out (N, Ho, Wo, Co) bf16. Ci must be
// a multiple of 8 (16-byte gathers of activation rows).
extern "C" int ydt_conv(const void* x, const void* w, const void* bias,
                        const void* scale, float xinv, void* out, int n,
                        int hi, int wi, int ci, int ho, int wo, int co, int k,
                        int stride, int pad, int act, int mode,
                        void* stream) {
    if (n <= 0 || ci <= 0 || co <= 0 || ho <= 0 || wo <= 0 || (ci % 8) != 0
        || (k != 1 && k != 3) || mode < 0 || mode > 2)
        return (int)cudaErrorInvalidValue;
    const float* b = static_cast<const float*>(bias);
    const float* s = static_cast<const float*>(scale);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (mode == 0)
        err = launch<__nv_bfloat16, __nv_bfloat16>(
            x, w, b, s, xinv, out, n, hi, wi, ci, ho, wo, co, k, stride, pad,
            act, st);
    else if (mode == 1)
        err = launch<signed char, __nv_bfloat16>(
            x, w, b, s, xinv, out, n, hi, wi, ci, ho, wo, co, k, stride, pad,
            act, st);
    else
        err = launch<signed char, float>(
            x, w, b, s, xinv, out, n, hi, wi, ci, ho, wo, co, k, stride, pad,
            act, st);
    return (int)err;
}
