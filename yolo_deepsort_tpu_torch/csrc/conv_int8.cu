// Kernel 8: fused W8A8 convolution of the int8-resident ReID embed, as an
// implicit GEMM on the tensor cores (int8 x int8 -> int32).
//
// Replaces the TPU kernels yolo_deepsort_tpu/ops/pallas_conv_int8.py
// _conv_kernel_3x3 and _conv_kernel_1x1 (conv_int8). The TPU wrapper pads the
// input, splits stride-2 inputs into four parity planes and pre-decimates for
// the 1x1 conv, and its grid walks groups of crops; none of that carries
// over. Here one launch computes the conv as one matrix product:
//
//   rows     M = N * Ho * Wo   (one output pixel each)
//   columns  Co
//   depth    k * k * Ci, walked tap by tap and, inside a tap, in steps of
//            BK = 64 input channels
//
// A block owns one BM x 128 output tile. Per depth step its 256 threads
// gather the BM x 64 activation tile (16 bytes = 16 channels per thread and
// row; zero where the tap falls into the padding, past the last row or past
// Ci) and the 64 x 128 weight tile into registers while the tensor cores
// work on the previous step's tiles in shared memory, then store them: one
// buffer, two barriers per step. Stride 2 and the halo are index arithmetic
// (iy = oy * stride - pad + dy). Activations arrive as int8: nothing is
// quantized in the tile load.
//
// Shared memory holds both tiles as panels of 16 depth elements (A) or 16
// columns (B) with 32-byte row pitch, so every wmma fragment pointer is
// 32-byte aligned (the layout of conv.cu's int8 mode). Eight warps split the
// tile and keep their int32 accumulators in registers.
//
// The epilogue is the contract. Accumulator fragments go through a per-warp
// scratch tile (which reuses the tile buffers); a lane then owns 16
// consecutive columns of one row:
//     y = f32(acc) * scale[c]; y = y + bias[c];
//     y = y + f32(res) * res_scale      (with a residual)
//     y = max(y, 0)                     (with relu)
//     int8(clip(rint(y * oinv), -127, 127))   or   y as f32
// every step rounded to f32 (explicit __fmul_rn / __fadd_rn, and the file is
// built with --fmad=false), so the int8 codes equal the plain PyTorch
// version's bit for bit: int32 sums are exact. The residual is read and the
// int8 result written as 16-byte vectors along Co.
//
// Bound on the H100 by operations at the 3x3 layers and by bytes at the 1x1
// shortcuts. This first version feeds the tensor cores through wmma (s8,
// 16x16x16) from a single shared-memory buffer; mma m16n8k32 or wgmma, TMA
// and a multi-stage ring are what a faster version would add.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BN = 128;       // output columns per block
constexpr int BK = 64;        // input channels per depth step
constexpr int THREADS = 256;  // 8 warps
constexpr int KP = BK / 16;   // A panels (16 depth elements each)
constexpr int NP = BN / 16;   // B panels (16 columns each)
constexpr int LDP = 32;       // panel row pitch in bytes

__device__ __forceinline__ float code(unsigned int word, int byte) {
    return (float)(signed char)((word >> (8 * byte)) & 0xffu);
}

__device__ __forceinline__ unsigned int requant(float y, float oinv) {
    float q = fminf(fmaxf(rintf(__fmul_rn(y, oinv)), -127.0f), 127.0f);
    return (unsigned int)(unsigned char)(signed char)(int)q;
}

// BM: output rows per block; OUT_INT8: requantized int8 out, else f32.
template <int BM, bool OUT_INT8>
__global__ void __launch_bounds__(THREADS)
conv_int8_kernel(const signed char* __restrict__ x,
                 const signed char* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const signed char* __restrict__ res, float res_scale,
                 float oinv, void* __restrict__ out, int n_img, int hi,
                 int wi, int ci, int ho, int wo, int co, int k, int stride,
                 int pad, int relu) {
    constexpr int A_IT = BM / 64;   // 16-channel groups per thread
    constexpr int B_GPR = BN / 16;  // 16-byte vectors per weight-tile row
    constexpr int B_IT = BK * B_GPR / THREADS;
    constexpr int WARPS_M = BM / 32;
    constexpr int WARPS_N = 8 / WARPS_M;
    constexpr int WC = BN / WARPS_N;  // columns per warp
    constexpr int FN = WC / 16;
    constexpr int A_BYTES = KP * BM * LDP;
    constexpr int B_BYTES = NP * BK * LDP;
    static_assert(FN % 2 == 0, "the epilogue takes fragments in pairs");
    static_assert(A_BYTES + B_BYTES >= 8 * 16 * 32 * 4,
                  "the epilogue scratch reuses the tile buffers");

    __shared__ __align__(128) unsigned char smem[A_BYTES + B_BYTES];
    signed char* a_s = reinterpret_cast<signed char*>(smem);
    signed char* b_s = reinterpret_cast<signed char*>(smem + A_BYTES);

    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    const int wm = warp % WARPS_M, wn = warp / WARPS_M;
    const int m_total = n_img * ho * wo;
    const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
    const int chunks = (ci + BK - 1) / BK;
    const int iters = k * k * chunks;

    // the rows of the activation tile this thread gathers
    const int a_grp = t & 3;  // which 16 of the step's 64 channels
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

    uint4 a_reg[A_IT];
    uint4 b_reg[B_IT];

    auto load_tiles = [&](int it) {
        const int tap = it / chunks;
        const int c0 = (it - tap * chunks) * BK;
        const int dy = tap / k, dx = tap - dy * k;
        const int c = c0 + a_grp * 16;
#pragma unroll
        for (int i = 0; i < A_IT; ++i) {
            const int iy = a_iy0[i] + dy, ix = a_ix0[i] + dx;
            const bool ok = a_ok[i] && iy >= 0 && iy < hi && ix >= 0
                            && ix < wi && c < ci;
            a_reg[i] = ok ? __ldg(reinterpret_cast<const uint4*>(
                                x + a_base[i]
                                + ((long long)iy * wi + ix) * ci + c))
                          : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int i = 0; i < B_IT; ++i) {
            const int idx = t + i * THREADS;
            const int kk = idx / B_GPR, g = idx - kk * B_GPR;
            const int col = n0 + g * 16;
            const long long row = (long long)tap * ci + c0 + kk;
            b_reg[i] = (c0 + kk < ci && col < co)
                           ? __ldg(reinterpret_cast<const uint4*>(
                                 w + row * co + col))
                           : make_uint4(0u, 0u, 0u, 0u);
        }
    };

    auto store_tiles = [&]() {
#pragma unroll
        for (int i = 0; i < A_IT; ++i) {
            const int r = (t >> 2) + i * 64;
            *reinterpret_cast<uint4*>(a_s + (a_grp * BM + r) * LDP) =
                a_reg[i];
        }
#pragma unroll
        for (int i = 0; i < B_IT; ++i) {
            const int idx = t + i * THREADS;
            const int kk = idx / B_GPR, g = idx - kk * B_GPR;
            *reinterpret_cast<uint4*>(b_s + (g * BK + kk) * LDP) = b_reg[i];
        }
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][FN];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

    load_tiles(0);
    for (int it = 0; it < iters; ++it) {
        __syncthreads();  // the previous step's fragments have been read
        store_tiles();
        __syncthreads();
        if (it + 1 < iters) load_tiles(it + 1);
#pragma unroll
        for (int kp = 0; kp < KP; ++kp) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                           wmma::row_major> af[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(
                    af[i], a_s + (kp * BM + wm * 32 + i * 16) * LDP, LDP);
#pragma unroll
            for (int j = 0; j < FN; ++j) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                               wmma::row_major> bf;
                wmma::load_matrix_sync(
                    bf, b_s + ((((wn * WC) >> 4) + j) * BK + kp * 16) * LDP,
                    LDP);
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    wmma::mma_sync(acc[i][j], af[i], bf, acc[i][j]);
            }
        }
    }

    // epilogue: two fragments -> a 16 x 32 per-warp scratch tile (in the
    // tile buffers, which every warp has finished reading) -> the f32 chain.
    // A lane handles 16 consecutive columns of one row.
    __syncthreads();
    int* cw = reinterpret_cast<int*>(smem) + warp * (16 * 32);
    const int er = lane >> 1, ec = (lane & 1) * 16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < FN; j += 2) {
            wmma::store_matrix_sync(cw, acc[i][j], 32, wmma::mem_row_major);
            wmma::store_matrix_sync(cw + 16, acc[i][j + 1], 32,
                                    wmma::mem_row_major);
            __syncwarp();
            const int m = m0 + wm * 32 + i * 16 + er;
            const int col = n0 + wn * WC + j * 16 + ec;
            if (m < m_total && col < co) {
                const long long o = (long long)m * co + col;
                uint4 rv = make_uint4(0u, 0u, 0u, 0u);
                if (res != nullptr)
                    rv = __ldg(reinterpret_cast<const uint4*>(res + o));
                const unsigned int rw[4] = {rv.x, rv.y, rv.z, rv.w};
                float y[16];
#pragma unroll
                for (int e = 0; e < 16; ++e) {
                    float v = __fmul_rn((float)cw[er * 32 + ec + e],
                                        __ldg(scale + col + e));
                    v = __fadd_rn(v, __ldg(bias + col + e));
                    if (res != nullptr)
                        v = __fadd_rn(v, __fmul_rn(code(rw[e >> 2], e & 3),
                                                   res_scale));
                    y[e] = relu ? fmaxf(v, 0.0f) : v;
                }
                if constexpr (OUT_INT8) {
                    unsigned int q[4];
#pragma unroll
                    for (int g = 0; g < 4; ++g)
                        q[g] = requant(y[4 * g], oinv)
                               | (requant(y[4 * g + 1], oinv) << 8)
                               | (requant(y[4 * g + 2], oinv) << 16)
                               | (requant(y[4 * g + 3], oinv) << 24);
                    *reinterpret_cast<uint4*>(
                        static_cast<signed char*>(out) + o) =
                        make_uint4(q[0], q[1], q[2], q[3]);
                } else {
                    float4* dst = reinterpret_cast<float4*>(
                        static_cast<float*>(out) + o);
#pragma unroll
                    for (int g = 0; g < 4; ++g)
                        dst[g] = make_float4(y[4 * g], y[4 * g + 1],
                                             y[4 * g + 2], y[4 * g + 3]);
                }
            }
            __syncwarp();
        }
    }
}

template <bool OUT_INT8>
cudaError_t launch(const signed char* x, const signed char* w,
                   const float* scale, const float* bias,
                   const signed char* res, float res_scale, float oinv,
                   void* out, int n, int hi, int wi, int ci, int ho, int wo,
                   int co, int k, int stride, int pad, int relu,
                   cudaStream_t stream) {
    const int m = n * ho * wo;
    const int col_tiles = (co + BN - 1) / BN;
    // 128-row tiles when they still give every SM two blocks, else 64
    if (((m + 127) / 128) * col_tiles >= 2 * 132) {
        dim3 grid((m + 127) / 128, col_tiles);
        conv_int8_kernel<128, OUT_INT8><<<grid, THREADS, 0, stream>>>(
            x, w, scale, bias, res, res_scale, oinv, out, n, hi, wi, ci, ho,
            wo, co, k, stride, pad, relu);
    } else {
        dim3 grid((m + 63) / 64, col_tiles);
        conv_int8_kernel<64, OUT_INT8><<<grid, THREADS, 0, stream>>>(
            x, w, scale, bias, res, res_scale, oinv, out, n, hi, wi, ci, ho,
            wo, co, k, stride, pad, relu);
    }
    return cudaGetLastError();
}

}  // namespace

// x (N, Hi, Wi, Ci) int8; w (k*k*Ci, Co) int8, tap-major; scale, bias (Co,)
// f32; res (N, Ho, Wo, Co) int8 or null, with res_scale; oinv the requant
// factor; out (N, Ho, Wo, Co) int8 (out_int8) or f32. Ci and Co must be
// multiples of 16 and every pointer 16-byte aligned (16-byte gathers and
// stores).
extern "C" int ydt_conv_int8(const void* x, const void* w, const void* scale,
                             const void* bias, const void* res,
                             float res_scale, float oinv, void* out, int n,
                             int hi, int wi, int ci, int ho, int wo, int co,
                             int k, int stride, int pad, int relu,
                             int out_int8, void* stream) {
    const uintptr_t ptrs = (uintptr_t)x | (uintptr_t)w | (uintptr_t)scale
                           | (uintptr_t)bias | (uintptr_t)res
                           | (uintptr_t)out;
    if (n <= 0 || ci <= 0 || co <= 0 || ho <= 0 || wo <= 0 || (ci % 16) != 0
        || (co % 16) != 0 || (k != 1 && k != 3) || (ptrs & 15) != 0)
        return (int)cudaErrorInvalidValue;
    const signed char* xp = static_cast<const signed char*>(x);
    const signed char* wp = static_cast<const signed char*>(w);
    const float* sp = static_cast<const float*>(scale);
    const float* bp = static_cast<const float*>(bias);
    const signed char* rp = static_cast<const signed char*>(res);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err =
        out_int8 ? launch<true>(xp, wp, sp, bp, rp, res_scale, oinv, out, n,
                                hi, wi, ci, ho, wo, co, k, stride, pad, relu,
                                st)
                 : launch<false>(xp, wp, sp, bp, rp, res_scale, oinv, out, n,
                                 hi, wi, ci, ho, wo, co, k, stride, pad, relu,
                                 st);
    return (int)err;
}
