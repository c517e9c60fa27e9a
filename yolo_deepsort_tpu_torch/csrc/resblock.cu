// Kernel 9: a chain of darknet residual blocks
//
//   x -> 1x1 conv (Ci -> Cm) + bias + act -> 3x3 conv (Cm -> Ci, pad 1)
//     + bias + act -> + x
//
// fused so that the intermediate `mid` never leaves the chip, on the tensor
// cores (bf16 x bf16 -> f32, or W8A8: int8 x int8 -> int32).
//
// Replaces the TPU kernel yolo_deepsort_tpu/ops/pallas_resblock.py
// _chain_kernel. That kernel gives one program whole frames: x, the chain
// state and the padded mid sit in 10-13 MB of VMEM. An SM has 227 KB, so none
// of that carries over. Here:
//
// * One work item is a strip of `th` full-width rows of one frame (and, when
//   strips alone cannot fill the card, one group of the 3x3 conv's output
//   columns: `csplit` groups, each recomputing the strip's mid). Persistent
//   blocks walk over the items.
// * For an item the block first computes mid for the strip plus one halo row
//   above and below and one zero column left and right -- the 1x1 conv needs
//   no halo of its own, so the halo costs recomputed 1x1 work and no exchange
//   -- into shared memory (bf16, or int8 quantized once at the write), zero
//   where the halo falls outside the map. mid is stored by padded position
//   p = row * (W + 2) + column, in panels of 16 channels, so a 3x3 tap is a
//   constant shift of p: sixteen consecutive positions at a shifted base are
//   one wmma A fragment, read straight from mid (32-byte aligned for any p).
//   Positions in the two pad columns produce rows that are never stored.
// * Both convs are 128 x 128 GEMM tiles over 32-channel depth steps, weights
//   (and, for the 1x1 conv, activations gathered from device memory) staged
//   through one shared-memory buffer with two barriers per step, eight warps
//   of 32 rows x 64 columns, accumulators in registers. The 3x3 epilogue adds
//   bias, activates, rounds to bf16, adds the shortcut (the strip's own rows
//   of the block's input) in bf16 and stores NHWC.
// * The chain state between blocks lives in device memory, in two buffers
//   used in turn (the output and one scratch buffer, so that the last block
//   writes the output): a block's halo rows were written by other thread
//   blocks in the block before, so the state can be neither in place nor
//   on chip. One cooperative launch runs the whole chain with a grid-wide
//   barrier between blocks; the state stays in the L2 cache at batch 8.
//   Activations are read with ld.global.cg (L2), never through the
//   non-coherent path: they were written by other SMs in this launch.
//
// Bound on the H100 by operations (2 * H * W * 10 * Ci * Cm per block and
// frame against x read and out written once). This first version feeds the
// tensor cores through wmma from a single staging buffer at one block per
// SM; wgmma, TMA and a copy ring are what a faster version would add.
//
// Built with --fmad=false, and the int8 epilogue is written with __fmul_rn /
// __fadd_rn: int32 sums are exact, so W8A8 mode with a leaky activation
// equals its plain PyTorch version bit for bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace cgroups = cooperative_groups;
using namespace nvcuda;

namespace {

constexpr int BM = 128;       // positions per GEMM tile
constexpr int BN = 128;       // output columns per GEMM tile
constexpr int BK = 32;        // channels per depth step
constexpr int THREADS = 256;  // 8 warps, 4 (rows) x 2 (columns)
constexpr int KP = BK / 16;   // A panels (16 depth elements each)
constexpr int NP = BN / 16;   // B panels (16 columns each)
constexpr int MAX_SMEM = 232448;  // bytes a block can use on sm_90

enum Act { ACT_LINEAR = 0, ACT_LEAKY = 1, ACT_MISH = 2 };

template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
    static constexpr int LDP = 24;   // staging panel row pitch (48 bytes)
    static constexpr int MIDP = 16;  // mid panel row pitch (32 bytes)
    using Acc = float;
};
template <>
struct Elem<signed char> {
    static constexpr int LDP = 32;   // 32 bytes
    static constexpr int MIDP = 32;  // 32 bytes, 16 used
    using Acc = int;
};

template <typename T>
struct Stage {
    static constexpr int A_BYTES = KP * BM * Elem<T>::LDP * (int)sizeof(T);
    static constexpr int B_BYTES = NP * BK * Elem<T>::LDP * (int)sizeof(T);
    static constexpr int C_BYTES = 8 * 256 * 4;
    static constexpr int BYTES = A_BYTES + B_BYTES + C_BYTES;
};

struct Params {
    const __nv_bfloat16* x;  // (N, H, W, Ci)
    __nv_bfloat16* out;      // (N, H, W, Ci)
    __nv_bfloat16* tmp;      // (N, H, W, Ci) scratch, unused when nblk == 1
    const void* w1;          // (nblk, Ci, Cm)
    const void* w2;          // (nblk, 9 * Cm, Ci)
    const float* b1;         // (nblk, Cm)
    const float* b2;         // (nblk, Ci)
    const float* s1;         // (nblk, Cm), int8 mode
    const float* s2;         // (nblk, Ci), int8 mode
    const float* xinv;       // (nblk, 2), int8 mode
    int n, h, w, ci, cm, nblk, act, th, csplit, npos;
};

struct Geo {
    int h, w, wp, ci, cm, th, npos, y0;
};

__device__ __forceinline__ float bf16_lo(unsigned int v) {
    return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned int v) {
    return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ unsigned int bf16_bits(float v) {
    return (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ unsigned int quant8(float v, float xinv) {
    float q = fminf(fmaxf(rintf(__fmul_rn(v, xinv)), -127.0f), 127.0f);
    return (unsigned int)(unsigned char)(signed char)(int)q;
}

__device__ __forceinline__ unsigned int quant8x4(float a, float b, float c,
                                                 float d, float xinv) {
    return quant8(a, xinv) | (quant8(b, xinv) << 8) | (quant8(c, xinv) << 16)
           | (quant8(d, xinv) << 24);
}

__device__ __forceinline__ float activate(float y, int act) {
    if (act == ACT_LEAKY) return y > 0.0f ? y : __fmul_rn(0.1f, y);
    if (act == ACT_MISH) {
        float sp = fmaxf(y, 0.0f) + log1pf(expf(-fabsf(y)));  // softplus
        return y * tanhf(sp);
    }
    return y;
}

// One 128 x 128 GEMM tile. FROM_MID false: the 1x1 conv. Rows are the padded
// positions m0.. of the strip, A is gathered from the block's input `src`
// (one frame), depth Ci, columns n0.. of Cm; the epilogue writes mid. FROM_MID
// true: the 3x3 conv. Rows are the positions m0.. of the strip's output, A
// fragments come straight from mid at the tap's shift, depth 9 * Cm, columns
// n0.. of Ci; the epilogue adds the shortcut from `src` and stores to `dst`.
template <typename T, bool FROM_MID>
__device__ __forceinline__ void gemm_tile(
        const Geo& g, const __nv_bfloat16* src, __nv_bfloat16* dst, T* mid,
        const T* __restrict__ wmat, int taps, int cdepth, int ncols, int m0,
        int n0, const float* __restrict__ bias,
        const float* __restrict__ scale, float xinv_in, float xinv_mid,
        int act, T* a_s, T* b_s, typename Elem<T>::Acc* c_s) {
    using Acc = typename Elem<T>::Acc;
    constexpr int LDP = Elem<T>::LDP;
    constexpr int MIDP = Elem<T>::MIDP;
    constexpr bool INT8 = sizeof(T) == 1;
    constexpr int VE = 16 / (int)sizeof(T);  // elements per 16-byte vector
    constexpr int B_GPR = BN / VE;           // vectors per weight-tile row
    constexpr int B_IT = BK * B_GPR / THREADS;

    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    const int wm = warp & 3, wn = warp >> 2;
    const int chunks = cdepth / BK;
    const int iters = taps * chunks;
    const int m1 = (g.th + 2) * g.wp;  // positions of the padded strip

    // 1x1 conv: the two positions whose 8 channels this thread gathers
    const int a_grp = t & 3;
    long long a_off[2] = {0, 0};
    bool a_ok[2] = {false, false};
    if constexpr (!FROM_MID) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int m = m0 + (t >> 2) + i * 64;
            const int yy = m / g.wp, xx = m - yy * g.wp;
            const int py = g.y0 - 1 + yy, px = xx - 1;
            a_ok[i] = m < m1 && py >= 0 && py < g.h && px >= 0 && px < g.w;
            a_off[i] = a_ok[i] ? ((long long)py * g.w + px) * g.ci : 0;
        }
    }

    uint4 a_reg[2];
    uint4 b_reg[B_IT];

    auto load_tiles = [&](int it) {
        const int tap = it / chunks;
        const int c0 = (it - tap * chunks) * BK;
        if constexpr (!FROM_MID) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                if (a_ok[i])
                    a_reg[i] = __ldcg(reinterpret_cast<const uint4*>(
                        src + a_off[i] + c0 + a_grp * 8));
                else
                    a_reg[i] = make_uint4(0u, 0u, 0u, 0u);
            }
        }
#pragma unroll
        for (int i = 0; i < B_IT; ++i) {
            const int idx = t + i * THREADS;
            const int kk = idx / B_GPR, gg = idx - kk * B_GPR;
            const long long row = (long long)tap * cdepth + c0 + kk;
            b_reg[i] = __ldg(reinterpret_cast<const uint4*>(
                wmat + row * ncols + n0 + gg * VE));
        }
    };

    auto store_tiles = [&]() {
        if constexpr (!FROM_MID) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int r = (t >> 2) + i * 64;
                T* p = a_s + ((a_grp >> 1) * BM + r) * LDP + (a_grp & 1) * 8;
                const uint4 v = a_reg[i];
                if constexpr (!INT8) {
                    *reinterpret_cast<uint4*>(p) = v;
                } else {
                    uint2 q;
                    q.x = quant8x4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y),
                                   bf16_hi(v.y), xinv_in);
                    q.y = quant8x4(bf16_lo(v.z), bf16_hi(v.z), bf16_lo(v.w),
                                   bf16_hi(v.w), xinv_in);
                    *reinterpret_cast<uint2*>(p) = q;
                }
            }
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
        int shift = 0, cpan = 0;
        if constexpr (FROM_MID) {
            const int tap = it / chunks;
            const int dy = tap / 3;
            shift = dy * g.wp + (tap - dy * 3);
            cpan = ((it - tap * chunks) * BK) >> 4;
        }
#pragma unroll
        for (int kp = 0; kp < KP; ++kp) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major>
                af[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                if constexpr (FROM_MID) {
                    const T* ap = mid + ((size_t)(cpan + kp) * g.npos + m0
                                         + wm * 32 + i * 16 + shift) * MIDP;
                    wmma::load_matrix_sync(af[i], ap, MIDP);
                } else {
                    wmma::load_matrix_sync(
                        af[i], a_s + (kp * BM + wm * 32 + i * 16) * LDP, LDP);
                }
            }
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

    // epilogue: fragment -> per-warp scratch -> (scale,) bias, activation ->
    // bf16. A lane handles 8 consecutive columns of one position.
    Acc* cw = c_s + warp * 256;
    const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            wmma::store_matrix_sync(cw, acc[i][j], 16, wmma::mem_row_major);
            __syncwarp();
            const int m = m0 + wm * 32 + i * 16 + er;
            const int col = n0 + wn * 64 + j * 16 + ec;
            float y[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                float v = (float)cw[er * 16 + ec + e];
                if constexpr (INT8) v = __fmul_rn(v, __ldg(scale + col + e));
                y[e] = activate(__fadd_rn(v, __ldg(bias + col + e)), act);
            }
            if constexpr (!FROM_MID) {
                if (m < m1) {
                    const int yy = m / g.wp, xx = m - yy * g.wp;
                    const int py = g.y0 - 1 + yy, px = xx - 1;
                    const bool inside = py >= 0 && py < g.h && px >= 0
                                        && px < g.w;
                    unsigned int hb[8];
#pragma unroll
                    for (int e = 0; e < 8; ++e)
                        hb[e] = inside ? bf16_bits(y[e]) : 0u;
                    T* mp = mid + ((size_t)(col >> 4) * g.npos + m) * MIDP
                            + (col & 15);
                    if constexpr (!INT8) {
                        uint4 v;
                        v.x = hb[0] | (hb[1] << 16);
                        v.y = hb[2] | (hb[3] << 16);
                        v.z = hb[4] | (hb[5] << 16);
                        v.w = hb[6] | (hb[7] << 16);
                        *reinterpret_cast<uint4*>(mp) = v;
                    } else {
                        // mid is quantized once, here, from its bf16 value
                        uint2 q;
                        q.x = quant8x4(bf16_lo(hb[0]),
                                       bf16_lo(hb[1]),
                                       bf16_lo(hb[2]),
                                       bf16_lo(hb[3]), xinv_mid);
                        q.y = quant8x4(bf16_lo(hb[4]),
                                       bf16_lo(hb[5]),
                                       bf16_lo(hb[6]),
                                       bf16_lo(hb[7]), xinv_mid);
                        *reinterpret_cast<uint2*>(mp) = q;
                    }
                }
            } else {
                const int yq = m / g.wp, xq = m - yq * g.wp;
                const int py = g.y0 + yq;
                if (yq < g.th && xq < g.w && py < g.h) {
                    const long long off = ((long long)py * g.w + xq) * g.ci
                                          + col;
                    const uint4 sc = __ldcg(
                        reinterpret_cast<const uint4*>(src + off));
                    const unsigned int s[4] = {sc.x, sc.y, sc.z, sc.w};
                    unsigned int o[4];
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        // the shortcut add is a bf16 add: both operands are
                        // bf16 values, the f32 sum is rounded to bf16 once
                        const float lo = __fadd_rn(
                            bf16_lo(bf16_bits(y[2 * e])), bf16_lo(s[e]));
                        const float hi = __fadd_rn(
                            bf16_lo(bf16_bits(y[2 * e + 1])), bf16_hi(s[e]));
                        o[e] = bf16_bits(lo) | (bf16_bits(hi) << 16);
                    }
                    *reinterpret_cast<uint4*>(dst + off) =
                        make_uint4(o[0], o[1], o[2], o[3]);
                }
            }
            __syncwarp();
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) chain_kernel(Params p) {
    using Acc = typename Elem<T>::Acc;
    constexpr bool INT8 = sizeof(T) == 1;
    extern __shared__ __align__(128) unsigned char smem[];
    T* a_s = reinterpret_cast<T*>(smem);
    T* b_s = reinterpret_cast<T*>(smem + Stage<T>::A_BYTES);
    Acc* c_s = reinterpret_cast<Acc*>(smem + Stage<T>::A_BYTES
                                      + Stage<T>::B_BYTES);
    T* mid = reinterpret_cast<T*>(smem + Stage<T>::BYTES);

    cgroups::grid_group grid = cgroups::this_grid();
    Geo g;
    g.h = p.h; g.w = p.w; g.wp = p.w + 2; g.ci = p.ci; g.cm = p.cm;
    g.th = p.th; g.npos = p.npos; g.y0 = 0;
    const int strips = (p.h + p.th - 1) / p.th;
    const int items = p.n * strips * p.csplit;
    const int col_tiles = p.ci / BN / p.csplit;  // 3x3 column tiles per item
    const int m1 = (p.th + 2) * g.wp, m2 = p.th * g.wp;
    const size_t frame = (size_t)p.h * p.w * p.ci;

    for (int blk = 0; blk < p.nblk; ++blk) {
        // the state alternates between out and tmp so that the last block
        // writes out
        const __nv_bfloat16* src =
            blk == 0 ? p.x : (((p.nblk - blk) & 1) == 0 ? p.out : p.tmp);
        __nv_bfloat16* dst = ((p.nblk - 1 - blk) & 1) == 0 ? p.out : p.tmp;
        const T* w1 = static_cast<const T*>(p.w1) + (size_t)blk * p.ci * p.cm;
        const T* w2 = static_cast<const T*>(p.w2)
                      + (size_t)blk * 9 * p.cm * p.ci;
        const float* b1 = p.b1 + (size_t)blk * p.cm;
        const float* b2 = p.b2 + (size_t)blk * p.ci;
        const float* s1 = INT8 ? p.s1 + (size_t)blk * p.cm : nullptr;
        const float* s2 = INT8 ? p.s2 + (size_t)blk * p.ci : nullptr;
        const float xi1 = INT8 ? __ldg(p.xinv + 2 * blk) : 0.0f;
        const float xi2 = INT8 ? __ldg(p.xinv + 2 * blk + 1) : 0.0f;

        for (int item = blockIdx.x; item < items; item += gridDim.x) {
            const int grp = item % p.csplit;
            const int rest = item / p.csplit;
            const int strip = rest % strips, img = rest / strips;
            g.y0 = strip * p.th;
            const __nv_bfloat16* s_img = src + (size_t)img * frame;
            __nv_bfloat16* d_img = dst + (size_t)img * frame;
            __syncthreads();  // the previous item's taps have been read
            for (int m0 = 0; m0 < m1; m0 += BM)
                for (int n0 = 0; n0 < p.cm; n0 += BN)
                    gemm_tile<T, false>(g, s_img, d_img, mid, w1, 1, p.ci,
                                        p.cm, m0, n0, b1, s1, xi1, xi2, p.act,
                                        a_s, b_s, c_s);
            __syncthreads();  // mid is complete
            for (int m0 = 0; m0 < m2; m0 += BM)
                for (int c = 0; c < col_tiles; ++c)
                    gemm_tile<T, true>(g, s_img, d_img, mid, w2, 9, p.cm,
                                       p.ci, m0, (grp * col_tiles + c) * BN,
                                       b2, s2, 0.0f, 0.0f, p.act, a_s, b_s,
                                       c_s);
        }
        // block blk + 1 reads halo rows that other thread blocks wrote
        if (blk + 1 < p.nblk) grid.sync();
    }
}

template <typename T>
cudaError_t launch(Params p, cudaStream_t stream) {
    const int wp = p.w + 2;
    const int m1 = (p.th + 2) * wp, m2 = p.th * wp;
    const int passes2 = (m2 + BM - 1) / BM;
    // the last tile's taps read up to two rows and two columns past it
    int need = passes2 * BM + 2 * wp + 2;
    if (need < m1) need = m1;
    p.npos = (need + 15) & ~15;
    const size_t smem = (size_t)Stage<T>::BYTES + (size_t)p.npos * p.cm * 2;
    if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
    auto kern = chain_kernel<T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, THREADS, smem)) != cudaSuccess)
        return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    // every block must be resident, or the barrier between blocks deadlocks
    const int strips = (p.h + p.th - 1) / p.th;
    const long long items = (long long)p.n * strips * p.csplit;
    long long grid = (long long)per_sm * sms;
    if (grid > items) grid = items;
    void* args[] = {&p};
    return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                       dim3((unsigned)grid), dim3(THREADS),
                                       args, smem, stream);
}

}  // namespace

// x, out, tmp (N, H, W, Ci) bf16 (tmp: scratch, may be null when nblk == 1);
// w1 (nblk, Ci, Cm) and w2 (nblk, 9 * Cm, Ci) bf16, or int8 when int8_mode;
// b1 (nblk, Cm), b2 (nblk, Ci) f32; int8 mode adds s1 (nblk, Cm), s2 (nblk,
// Ci) and xinv (nblk, 2) f32. th: rows per strip; csplit: groups of the 3x3
// conv's output columns (divides Ci / 128). Ci and Cm must be multiples of
// 128.
extern "C" int ydt_resblock_chain(const void* x, void* out, void* tmp,
                                  const void* w1, const void* w2,
                                  const void* b1, const void* b2,
                                  const void* s1, const void* s2,
                                  const void* xinv, int n, int h, int w,
                                  int ci, int cm, int nblk, int act, int th,
                                  int csplit, int int8_mode, void* stream) {
    if (n <= 0 || h <= 0 || w <= 0 || nblk <= 0 || th <= 0 || csplit <= 0
        || ci <= 0 || cm <= 0 || (ci % BN) != 0 || (cm % BN) != 0
        || ((ci / BN) % csplit) != 0 || (nblk > 1 && tmp == nullptr)
        || (int8_mode && (s1 == nullptr || s2 == nullptr || xinv == nullptr)))
        return (int)cudaErrorInvalidValue;
    Params p;
    p.x = static_cast<const __nv_bfloat16*>(x);
    p.out = static_cast<__nv_bfloat16*>(out);
    p.tmp = static_cast<__nv_bfloat16*>(tmp);
    p.w1 = w1; p.w2 = w2;
    p.b1 = static_cast<const float*>(b1);
    p.b2 = static_cast<const float*>(b2);
    p.s1 = static_cast<const float*>(s1);
    p.s2 = static_cast<const float*>(s2);
    p.xinv = static_cast<const float*>(xinv);
    p.n = n; p.h = h; p.w = w; p.ci = ci; p.cm = cm; p.nblk = nblk;
    p.act = act; p.th = th; p.csplit = csplit; p.npos = 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = int8_mode ? launch<signed char>(p, st)
                                : launch<__nv_bfloat16>(p, st);
    return (int)err;
}
