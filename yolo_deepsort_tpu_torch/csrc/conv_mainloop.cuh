// The main loop shared by the two implicit-GEMM conv kernels, conv.cu
// (kernel 7) and conv_int8.cu (kernel 8), written for Hopper:
//
//   rows     M = N * Ho * Wo   (one output pixel each)
//   columns  Co
//   depth    k * k * Ci, flat over taps and channels, walked in steps of
//            128 bytes (64 bf16 or 128 int8 values). A 16-byte piece of a
//            step never straddles a tap (Ci is a multiple of 8 bf16 / 16 int8
//            values), so each piece finds its own tap and channel and a step
//            may end one tap and begin the next: no work is spent on padding
//            a short Ci up to a full step.
//
// A thread block owns one BM x BN output tile at a time (64 x 64, 64 x 128,
// 128 x 128 or 128 x 256) and is split into roles that never meet at a
// block-wide barrier in the loop:
//
//   * One producer warpgroup (128 threads) keeps a ring of `stages` tile
//     pairs in dynamic shared memory full. The A tile (BM rows x 128 bytes)
//     is an im2col gather: 16-byte cp.async copies, zero-filled (src-size 0)
//     where the tap falls into the padding, past the last row or past the
//     depth. The B tile (BN rows x 128 bytes) comes from weights packed once
//     to K-major (Co, ldw) rows, by the same copies. Both tiles are stored in
//     the 128-byte swizzled K-major layout that wgmma descriptors read: the
//     16-byte piece j of row r lands at r * 128 + ((j ^ (r & 7)) * 16).
//     Completion is signalled on the stage's "full" mbarrier
//     (cp.async.mbarrier.arrive.noinc). In the quantizing modes (kernel 7
//     with int8 weights) an asynchronous copy cannot quantize, so there the
//     producers load activations into registers, quantize, store the swizzled
//     piece with st.shared, fence the async proxy and arrive; they still run
//     as many stages ahead as the ring has.
//   * One consumer warpgroup per 64 rows waits on "full", starts four
//     wgmma.mma_async (m64nBNk16 bf16 -> f32, or m64nBNk32 s8 -> s32) per
//     step, commits, and releases the previous stage on its "empty" mbarrier
//     once wgmma.wait_group says the group that read it has retired.
//
// The launch gives no more blocks than the card holds at once (two to an SM
// of the small tiles, 64 rows by up to 128 columns; one of the others): a
// block walks its share of the tiles, and while its consumers stage and drain
// one tile's accumulators, its producers are already filling the ring for
// the next. What bounds the loop on this card is the gather through L2, not
// the tensor cores (the producers spend their time starting copies, the
// consumers waiting for full stages), so the loads must not wait for an
// epilogue.
//
// The depth can be split over a thread-block cluster (1, 1, split): each
// block of the cluster sums its share of the steps, all park their
// accumulators in their own shared memory, and after one
// cluster barrier the blocks share the epilogue, each reading the partial
// sums of all through distributed shared memory. No partial sum reaches
// device memory and the epilogue stays fused. int32 sums are exact in any
// order; f32 sums change their order once more.
//
// The epilogue is the including file's: a functor called with NV consecutive
// columns of one row, summed, which applies its own arithmetic and stores
// 16-byte vectors along Co.
//
// Everything here is inline PTX; nothing is included but the runtime.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace conv_ring {

constexpr int STEP_BYTES = 128;   // depth bytes per ring stage and row
constexpr int PRODUCERS = 128;    // one warpgroup
constexpr int MAX_SMEM = 232448;  // 227 KB, the most a block can be given
constexpr int STAGE_PAD = 32;     // bytes added to a staged row (banks)

// How the A tile reaches shared memory and what it holds.
enum AMode {
    A_ASYNC_BF16 = 0,  // bf16 activations, cp.async
    A_ASYNC_S8 = 1,    // int8 activations, cp.async
    A_QUANT_BF16 = 2,  // bf16 activations quantized to int8 in registers
    A_QUANT_F32 = 3,   // f32 activations quantized to int8 in registers
};

// Division by a divisor fixed at launch: a multiply and a shift in place
// of the integer divide that each producer thread would otherwise run per
// depth step and per row. Exact for 0 <= n < 2^31.
struct FastDiv {
    uint32_t d, mul, shr;
    __host__ void init(uint32_t divisor) {
        d = divisor;
        mul = 0;
        shr = 0;
        if (divisor > 1) {
            uint32_t lg = 0;
            while ((1ull << lg) < divisor) ++lg;
            const uint32_t p = 31 + lg;
            mul = (uint32_t)(((1ull << p) + divisor - 1) / divisor);
            shr = p - 32;
        }
    }
    __device__ __forceinline__ int div(int n) const {
        return d > 1 ? (int)(__umulhi((uint32_t)n, mul) >> shr) : n;
    }
};

struct Geom {
    int n_img, hi, wi, ci, ho, wo, co, k, stride, pad;
    FastDiv by_ci, by_wo, by_howo;
    int ldw;      // row pitch of the packed weights, in elements
    int m_total;  // n_img * ho * wo
    int depth;    // k * k * ci, in elements
    int steps;    // ceil(depth bytes / 128)
    int stages, split;
    float xinv;   // the quantizing modes' 1 / activation scale
};

// ---------------------------------------------------------------- PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

// returns once the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n"
        :: "r"(bar), "r"(parity) : "memory");
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// arrive on the barrier once this thread's earlier cp.async have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

// the same shared-memory offset in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(r) : "r"(addr), "r"(rank));
    return r;
}

// 16 bytes = four accumulators (float or int) from another block's (or this
// block's) shared memory, from this block's, and 8 bytes to this block's
template <typename Acc>
__device__ __forceinline__ void ld_cluster16(uint32_t addr, Acc* v) {
    uint32_t a, b, c, d;
    asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a), "=r"(b), "=r"(c), "=r"(d) : "r"(addr) : "memory");
    v[0] = *reinterpret_cast<Acc*>(&a);
    v[1] = *reinterpret_cast<Acc*>(&b);
    v[2] = *reinterpret_cast<Acc*>(&c);
    v[3] = *reinterpret_cast<Acc*>(&d);
}

template <typename Acc>
__device__ __forceinline__ void ld_shared16(uint32_t addr, Acc* v) {
    uint32_t a, b, c, d;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a), "=r"(b), "=r"(c), "=r"(d) : "r"(addr) : "memory");
    v[0] = *reinterpret_cast<Acc*>(&a);
    v[1] = *reinterpret_cast<Acc*>(&b);
    v[2] = *reinterpret_cast<Acc*>(&c);
    v[3] = *reinterpret_cast<Acc*>(&d);
}

template <typename Acc>
__device__ __forceinline__ void st_shared8(uint32_t addr, Acc x, Acc y) {
    asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n"
                 :: "r"(addr), "r"(*reinterpret_cast<uint32_t*>(&x)),
                    "r"(*reinterpret_cast<uint32_t*>(&y)) : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle: start address, leading offset (unused in this layout) 1, stride
// between 8-row groups 1024 bytes, layout type 1. A 32-byte slice of depth
// further along is the same descriptor + 2 (the address field counts 16
// bytes).
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16)
           | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma.mma_async of one 64 x N x 32-byte slice: D (registers) += A B, both
// operands K-major in shared memory behind descriptors. One wrapper per
// width and type: the instruction names every accumulator register.

__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t a,
                                               uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t a,
                                                uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t a,
                                                uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a,
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t a,
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p;\n}\n"
        :
          "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
          "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
          "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
          "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
          "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
          "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
          "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "l"(a), "l"(b), "r"(1));
}

template <typename A> struct IsInt { static constexpr bool value = false; };
template <> struct IsInt<int> { static constexpr bool value = true; };

// Pins the accumulators where the compiler has them: nothing that writes or
// reads them (the zeroing before a tile, the staging after it) may move
// across this into the wgmma of a pipeline stage, which would serialize them.
template <int N>
__device__ __forceinline__ void fence_accumulators(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_accumulators(int (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

template <int BN, typename Acc>
__device__ __forceinline__ void mma_step(Acc (&d)[BN / 2], uint64_t a,
                                         uint64_t b) {
    if constexpr (IsInt<Acc>::value) {
        if constexpr (BN == 64) wgmma_s8_n64(d, a, b);
        else if constexpr (BN == 128) wgmma_s8_n128(d, a, b);
        else wgmma_s8_n256(d, a, b);
    } else {
        if constexpr (BN == 64) wgmma_bf16_n64(d, a, b);
        else if constexpr (BN == 128) wgmma_bf16_n128(d, a, b);
        else wgmma_bf16_n256(d, a, b);
    }
}

// tap / k for k = 1 or 3 and any tap a step can name (a step past the depth
// names taps up to k * k + a few; those pieces are zero-filled anyway)
__device__ __forceinline__ int tap_row(int tap, int k) {
    return k == 1 ? tap : (tap * 11) >> 5;
}

// ------------------------------------------------------- quantization ----

__device__ __forceinline__ float bf16_lo(unsigned int w) {
    return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned int w) {
    return __uint_as_float(w & 0xffff0000u);
}

// clip(rint(v * xinv), -127, 127), ties to even, as one byte
__device__ __forceinline__ unsigned int quant8(float v, float xinv) {
    float q = fminf(fmaxf(rintf(v * xinv), -127.0f), 127.0f);
    return (unsigned int)(unsigned char)(signed char)(int)q;
}

__device__ __forceinline__ unsigned int quant8x4(float a, float b, float c,
                                                 float d, float xinv) {
    return quant8(a, xinv) | (quant8(b, xinv) << 8) | (quant8(c, xinv) << 16)
           | (quant8(d, xinv) << 24);
}

// ------------------------------------------------------------ sizes ------

template <int BM, int BN>
struct Tile {
    static constexpr int CONSUMERS = BM / 64 * 128;
    static constexpr int THREADS = CONSUMERS + PRODUCERS;
    static constexpr int STAGE_BYTES = (BM + BN) * STEP_BYTES;
    // The accumulators are staged beside the ring, not in it: a block walks
    // several tiles, and its producers fill the ring for the next tile while
    // its consumers still drain the last. At most 128 columns are staged at
    // a time, so a 256-wide tile drains in two passes and leaves the ring
    // three stages.
    static constexpr int STAGED_COLS = BN < 128 ? BN : 128;
    static constexpr int PITCH = STAGED_COLS * 4 + STAGE_PAD;  // a staged row
    static constexpr int STAGING_BYTES = BM * PITCH;
    // Two blocks share an SM where the tile leaves them the registers: one
    // consumer warpgroup (BM = 64) with at most 64 accumulators a thread (BN
    // <= 128). A 128-row tile has three warpgroups, and the compiler holds
    // every one of them to the launch bound whatever setmaxnreg hands over
    // later: 80 registers would not hold a 64-wide accumulator.
    static constexpr int BLOCKS_PER_SM = (BM == 64 && BN <= 128) ? 2 : 1;
};

// ------------------------------------------------------------ kernel -----

// Where the 16-byte chunk c of a staged row lies in it. A draining thread
// reads 2 or 4 consecutive chunks and its neighbours the next ones, which,
// stored in order, would meet in the same banks 2 or 4 at a time: chunks are
// exchanged inside each group of four by the two bits above.
__device__ __forceinline__ int staged_chunk(int c) {
    return c ^ ((c >> 3) & 3);
}

// The second half of the epilogue: the staged accumulators (of every block
// of the cluster, summed) -> epi. WORKERS threads share a tile of BM rows by
// BN staged columns; thread te of them keeps one group of NV columns and
// walks down ROWS rows, so what the epilogue needs per column (bias, scales)
// is loaded once. What it needs per row from device memory is fetched for
// all its rows before the barrier that ends the staging (drain_prefetch);
// the rows then go U at a time, every load of a batch started before the
// first store.
template <int BM, int BN, int WORKERS, class Epi>
struct Drain {
    using Acc = typename Epi::Acc;
    static constexpr int NV = Epi::NV;
    static constexpr int PITCH = BN * 4 + STAGE_PAD;
    static constexpr int GROUPS = BN / NV;        // column groups per row
    static constexpr int RPP = WORKERS / GROUPS;  // rows per pass
    static constexpr int ROWS = BM / RPP;         // rows per thread
    static constexpr int U = 32 / NV;             // rows per batch
    static_assert(WORKERS % GROUPS == 0 && BM % RPP == 0 && ROWS % U == 0,
                  "tile");

    int cg, col, first, stride, m0;
    typename Epi::Pre pre[ROWS];

    __device__ __forceinline__ Drain(int te, int rank, int split, int m0_,
                                     int n0, const Geom& g, const Epi& epi)
        : cg(te % GROUPS), col(n0 + cg * NV),
          first(te / GROUPS + rank * RPP), stride(RPP * split), m0(m0_) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
            const int row = first + i * stride;
            if (col < g.co && row < BM && m0 + row < g.m_total)
                pre[i] = epi.prefetch(m0 + row, col);
        }
    }

    __device__ __forceinline__ void run(uint32_t staging, int split,
                                        const Geom& g, const Epi& epi) const {
        if (col >= g.co) return;
        const typename Epi::Cols cols = epi.load_cols(col);
        const int c0 = cg * (NV / 4);  // this thread's first chunk
        const int swz = staged_chunk(c0) ^ c0;
#pragma unroll
        for (int i0 = 0; i0 < ROWS; i0 += U) {
            if (first + i0 * stride >= BM) break;
            Acc v[U][NV];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int row = first + (i0 + u) * stride;
                if (row >= BM || m0 + row >= g.m_total) continue;
                const uint32_t at = staging + row * PITCH;
                if (split == 1) {
#pragma unroll
                    for (int e = 0; e < NV / 4; ++e)
                        ld_shared16(at + 16 * ((c0 + e) ^ swz), &v[u][4 * e]);
                } else {
#pragma unroll
                    for (int e = 0; e < NV; ++e) v[u][e] = Acc(0);
                    for (int r = 0; r < split; ++r) {
                        const uint32_t src = map_to_rank(at, (uint32_t)r);
#pragma unroll
                        for (int e = 0; e < NV / 4; ++e) {
                            Acc part[4];
                            ld_cluster16(src + 16 * ((c0 + e) ^ swz), part);
#pragma unroll
                            for (int k = 0; k < 4; ++k)
                                v[u][4 * e + k] += part[k];
                        }
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int row = first + (i0 + u) * stride;
                if (row >= BM || m0 + row >= g.m_total) continue;
                epi.store(m0 + row, col, v[u], cols, pre[i0 + u]);
            }
        }
    }
};

// Epi: the including file's epilogue. `Acc` (float or int), `NV` (8 or 16
// columns per call), and, all __device__ const:
//   Cols load_cols(int col)         what columns col .. col + NV - 1 need
//                                   (bias, scales), loaded once per thread;
//   Pre prefetch(int m, int col)    what row m needs from device memory (a
//                                   residual), started ahead of the drain;
//   void store(int m, int col, const Acc (&v)[NV], const Cols&, const Pre&)
//                                   the arithmetic and the store.
// Called for rows m < m_total and col < co (col a multiple of NV).
//
// The grid: blockIdx.x walks the output tiles (row tiles fastest), a block
// taking tile blockIdx.x, then + gridDim.x, ...: one tile each, or several
// where the launch gives fewer blocks than tiles (it does where no split);
// blockIdx.z is the block's place in the cluster that shares a tile's depth.
// The ring and its barrier phases run on from one tile into the next.
template <int AMODE, int BM, int BN, class Epi>
__global__ void __launch_bounds__(Tile<BM, BN>::THREADS,
                                  Tile<BM, BN>::BLOCKS_PER_SM)
conv_ring_kernel(const void* __restrict__ xv, const void* __restrict__ wv,
                 const Geom g, const Epi epi) {
    using T = Tile<BM, BN>;
    constexpr bool QUANT = AMODE == A_QUANT_BF16 || AMODE == A_QUANT_F32;
    constexpr bool S8 = AMODE != A_ASYNC_BF16;
    using Acc = typename Epi::Acc;
    static_assert(S8 == IsInt<Acc>::value, "accumulator type");
    constexpr int ES = S8 ? 1 : 2;        // bytes per product element
    constexpr int KE = STEP_BYTES / ES;   // elements per step
    constexpr int VE = 16 / ES;           // elements per 16-byte piece
    constexpr int NCW = T::CONSUMERS / 32;
    constexpr int AR = BM / 16, BR = BN / 16;  // rows per producer thread
    constexpr int SC = T::STAGED_COLS, PASSES = BN / SC;
    // registers: the producers hand theirs to the consumers (two consumer
    // warpgroups only: with one, 256 threads have enough each anyway)
    constexpr int PROD_REGS = QUANT ? 80 : 56;
    constexpr int CONS_REGS = QUANT ? 208 : 224;

    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t ring = (raw + 1023u) & ~1023u;
    const int stages = g.stages;
    const uint32_t staging = ring + stages * T::STAGE_BYTES;
    const uint32_t bars = staging + T::STAGING_BYTES;
    // full[i] = bars + 8 i, empty[i] = bars + 8 (stages + i)

    if ((int)threadIdx.x < 2 * stages) {  // one barrier a thread
        mbar_init(bars + 8 * threadIdx.x,
                  (int)threadIdx.x < stages ? PRODUCERS * (QUANT ? 2 : 1)
                                            : T::CONSUMERS);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5;
    const int tiles_m = (g.m_total + BM - 1) / BM;
    const int tiles = tiles_m * ((g.co + BN - 1) / BN);
    const int split = g.split;
    const uint32_t rank = split > 1 ? cluster_rank() : 0u;
    const int s_begin = split > 1 ? g.steps * (int)rank / split : 0;
    const int s_end = split > 1 ? g.steps * ((int)rank + 1) / split : g.steps;

    if (warp >= NCW) {
        // ================================ producer ======================
        if constexpr (BM == 128)
            asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                         :: "n"(PROD_REGS));
        const int p = threadIdx.x - T::CONSUMERS;
        const int j = p & 7, rb = p >> 3;
        const uint32_t off = rb * STEP_BYTES + ((j ^ (rb & 7)) << 4);
        const unsigned char* xb = static_cast<const unsigned char*>(xv);
        const unsigned char* wb = static_cast<const unsigned char*>(wv);
        int stage = 0;
        uint32_t phase = 1;  // the ring starts empty

        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int tn = tile / tiles_m;
        const int m0 = (tile - tn * tiles_m) * BM, n0 = tn * BN;
        // The producers are one warp to a scheduler, so what they execute per
        // step is what bounds the ring's fill rate: everything a row needs
        // is worked out once per tile, here, and a step costs a row an AND,
        // an add and the copy.
        // weights: row n0 + rb + 16 i of the packed matrix, the first
        // b_rows of them inside Co
        const int b_rows = min(BR, max(0, (g.co - n0 - rb + 15) >> 4));
        const unsigned char* w_row = wb + (long long)(n0 + rb) * g.ldw * ES;
        const long long w_skip = (long long)16 * g.ldw * ES;
        auto load_b = [&](int s, uint32_t b_s) {
            const int d = s * KE + j * VE;  // this piece's depth element
            const bool d_ok = d < g.ldw;
            const unsigned char* src = w_row + (long long)d * ES;
#pragma unroll
            for (int i = 0; i < BR; ++i) {
                const bool ok = d_ok && i < b_rows;
                cp_async16(b_s + i * 16 * STEP_BYTES,
                           ok ? src + i * w_skip : wb, ok ? 16u : 0u);
            }
        };
        // the ring starts empty and the weights need no row arithmetic:
        // the first tile's first stages are under way before the rows are
        // worked out
        const int ahead =
            tile == (int)blockIdx.x ? min(stages, s_end - s_begin) : 0;
        for (int q = 0; q < ahead; ++q)
            load_b(s_begin + q,
                   ring + q * T::STAGE_BYTES + BM * STEP_BYTES + off);

        // activations: per row the element offset of tap (0, 0), channel 0
        // (it may lie outside the image) and one bit per tap that lies
        // inside; a row past the last has none
        int offs[AR];
        uint32_t taps[AR];
#pragma unroll
        for (int i = 0; i < AR; ++i) {
            const int m = m0 + rb + 16 * i;
            offs[i] = 0;
            taps[i] = 0u;
            if (m < g.m_total) {
                const int img = g.by_howo.div(m);
                const int rem = m - img * (g.ho * g.wo);
                const int oy = g.by_wo.div(rem), ox = rem - oy * g.wo;
                const int iy = oy * g.stride - g.pad;
                const int ix = ox * g.stride - g.pad;
                offs[i] = ((img * g.hi + iy) * g.wi + ix) * g.ci;
                for (int dy = 0; dy < g.k; ++dy)
                    for (int dx = 0; dx < g.k; ++dx)
                        if (iy + dy >= 0 && iy + dy < g.hi && ix + dx >= 0
                            && ix + dx < g.wi)
                            taps[i] |= 1u << (dy * g.k + dx);
            }
        }
        // what one 8- or 16-value piece at depth element d reads: the bit of
        // its tap (none past the depth) and its offset from a row's offs
        auto piece = [&](int d, uint32_t& bit, int& rel) {
            const int tap = g.by_ci.div(d);
            const int dy = tap_row(tap, g.k), dx = tap - dy * g.k;
            bit = d < g.depth ? 1u << tap : 0u;
            rel = (dy * g.wi + dx) * g.ci + (d - tap * g.ci);
        };

        for (int s = s_begin; s < s_end; ++s) {
            mbar_wait(bars + 8 * (stages + stage), phase);
            const uint32_t a_s = ring + stage * T::STAGE_BYTES + off;
            const uint32_t full = bars + 8 * stage;
            const int d = s * KE + j * VE;  // this piece's depth element
            if (s - s_begin >= ahead) load_b(s, a_s + BM * STEP_BYTES);

            if constexpr (!QUANT) {
                uint32_t bit;
                int rel;
                piece(d, bit, rel);
#pragma unroll
                for (int i = 0; i < AR; ++i) {
                    const bool ok = (taps[i] & bit) != 0u;
                    cp_async16(a_s + i * 16 * STEP_BYTES,
                               xb + (long long)(ok ? offs[i] + rel : 0) * ES,
                               ok ? 16u : 0u);
                }
                cp_async_arrive(full);
            } else {
                cp_async_arrive(full);
                // 16 int8 values = two groups of 8 activations, each with
                // its own tap (Ci is a multiple of 8 only)
                constexpr int XB = AMODE == A_QUANT_BF16 ? 2 : 4;
                constexpr int XV = XB / 2;  // 16-byte loads per 8 values
                uint32_t bith[2];
                int relh[2];
#pragma unroll
                for (int h = 0; h < 2; ++h) piece(d + 8 * h, bith[h], relh[h]);
                constexpr int RB = 2;  // rows in flight per thread
#pragma unroll
                for (int i0 = 0; i0 < AR; i0 += RB) {
                    uint4 v[RB][2][XV];
#pragma unroll
                    for (int r = 0; r < RB; ++r)
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const bool ok = (taps[i0 + r] & bith[h]) != 0u;
                            const uint4* src = reinterpret_cast<const uint4*>(
                                xb + (long long)(offs[i0 + r] + relh[h]) * XB);
#pragma unroll
                            for (int e = 0; e < XV; ++e)
                                v[r][h][e] = ok ? __ldg(src + e)
                                                : make_uint4(0u, 0u, 0u, 0u);
                        }
#pragma unroll
                    for (int r = 0; r < RB; ++r) {
                        unsigned int q[4];
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            if constexpr (AMODE == A_QUANT_BF16) {
                                const uint4 u = v[r][h][0];
                                q[2 * h] = quant8x4(
                                    bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y),
                                    bf16_hi(u.y), g.xinv);
                                q[2 * h + 1] = quant8x4(
                                    bf16_lo(u.z), bf16_hi(u.z), bf16_lo(u.w),
                                    bf16_hi(u.w), g.xinv);
                            } else {
                                const uint4 u = v[r][h][0];
                                const uint4 w2 = v[r][h][XV - 1];
                                q[2 * h] = quant8x4(
                                    __uint_as_float(u.x), __uint_as_float(u.y),
                                    __uint_as_float(u.z), __uint_as_float(u.w),
                                    g.xinv);
                                q[2 * h + 1] = quant8x4(
                                    __uint_as_float(w2.x),
                                    __uint_as_float(w2.y),
                                    __uint_as_float(w2.z),
                                    __uint_as_float(w2.w), g.xinv);
                            }
                        }
                        asm volatile(
                            "st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                            :: "r"(a_s + (i0 + r) * 16 * STEP_BYTES),
                               "r"(q[0]), "r"(q[1]), "r"(q[2]), "r"(q[3])
                            : "memory");
                    }
                }
                fence_proxy_async();  // st.shared before the wgmma reads
                mbar_arrive(full);
            }
            if (++stage == stages) {
                stage = 0;
                phase ^= 1u;
            }
        }
        }  // tiles
        // a split block has one tile; its consumers meet the cluster's at
        // two barriers per drained pass, and every thread has to be there
        if (split > 1)
            for (int h = 0; h < 2 * PASSES; ++h) cluster_sync();
    } else {
        // ================================ consumers =====================
        if constexpr (BM == 128)
            asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                         :: "n"(CONS_REGS));
        const int t = threadIdx.x, lane = t & 31;
        const int wg = warp >> 2;
        int stage = 0, prev = 0;
        uint32_t phase = 0;

        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int tn = tile / tiles_m;
        const int m0 = (tile - tn * tiles_m) * BM, n0 = tn * BN;
        Acc acc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = Acc(0);
        fence_accumulators(acc);

        for (int s = s_begin; s < s_end; ++s) {
            mbar_wait(bars + 8 * stage, phase);
            fence_proxy_async();  // the copies were generic-proxy writes
            const uint32_t a_s = ring + stage * T::STAGE_BYTES;
            const uint64_t da = tile_desc(a_s + wg * 64 * STEP_BYTES);
            const uint64_t db = tile_desc(a_s + BM * STEP_BYTES);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < STEP_BYTES / 32; ++kk)
                mma_step<BN, Acc>(acc, da + 2 * kk, db + 2 * kk);
            wgmma_commit();
            if (s > s_begin) {
                wgmma_wait<1>();  // the previous step's group has retired
                mbar_arrive(bars + 8 * (stages + prev));
            }
            prev = stage;
            if (++stage == stages) {
                stage = 0;
                phase ^= 1u;
            }
        }
        wgmma_wait<0>();
        fence_accumulators(acc);
        mbar_arrive(bars + 8 * (stages + prev));  // the tile's last stage

        // ---- epilogue: accumulators -> staging -> epi, SC columns a pass
        const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
        const uint32_t dst = staging + row * T::PITCH + (lane & 1) * 8;
#pragma unroll
        for (int pass = 0; pass < PASSES; ++pass) {
            // every consumer has finished draining what was staged before
            named_bar_sync(1, T::CONSUMERS);
            // wgmma's accumulator layout: register 4 q + 2 h + e of a thread
            // is row 16 w + lane / 4 + 8 h, column 8 q + 2 (lane % 4) + e:
            // 8 bytes of chunk 2 q + (lane % 4) / 2
#pragma unroll
            for (int q = 0; q < SC / 8; ++q) {
                const int a = 4 * (pass * (SC / 8) + q);
                const uint32_t at =
                    dst + 16 * staged_chunk(2 * q + ((lane >> 1) & 1));
                st_shared8(at, acc[a], acc[a + 1]);
                st_shared8(at + 8 * T::PITCH, acc[a + 2], acc[a + 3]);
            }
            Drain<BM, SC, T::CONSUMERS, Epi> drain(t, (int)rank, split, m0,
                                                   n0 + pass * SC, g, epi);
            if (split > 1) cluster_sync();
            else named_bar_sync(2, T::CONSUMERS);
            drain.run(staging, split, g, epi);
            // no block may leave, or stage again, while another still reads
            // its shared memory
            if (split > 1) cluster_sync();
        }
        }  // tiles
    }
}

// ------------------------------------------------------------ launch -----

template <int AMODE, int BM, int BN, class Epi>
cudaError_t launch_tile(const void* x, const void* w, const Geom& g,
                        const Epi& epi, cudaStream_t stream) {
    using T = Tile<BM, BN>;
    auto kern = conv_ring_kernel<AMODE, BM, BN, Epi>;
    // 1024 bytes to align the ring, the ring, the staging, two barriers a
    // stage
    const int smem = 1024 + g.stages * T::STAGE_BYTES + T::STAGING_BYTES
                     + 16 * g.stages;
    if (smem > MAX_SMEM) return cudaErrorInvalidValue;
    // Asked once per device and kernel: the shared-memory attribute belongs
    // to the device's copy of the kernel, and a process may launch on
    // several. slots = the blocks the card holds at once (0: not asked yet;
    // two threads that both find 0 write the same value).
    constexpr int MAX_DEVICES = 64;
    static int slots[MAX_DEVICES] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (slots[device] == 0) {
        int sms = 0;
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         device);
        if (err != cudaSuccess) return err;
        slots[device] = sms * T::BLOCKS_PER_SM;
    }
    int blocks = ((g.m_total + BM - 1) / BM) * ((g.co + BN - 1) / BN);
    // no split: no more blocks than the card holds at once, each walks its
    // tiles
    if (g.split == 1) blocks = min(blocks, slots[device]);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks, 1, g.split);
    cfg.blockDim = dim3(T::THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = g.split;
    cfg.attrs = attr;
    cfg.numAttrs = g.split > 1 ? 1 : 0;
    return cudaLaunchKernelEx(&cfg, kern, x, w, g, epi);
}

// The tile plan arrives from Python (ops/conv_plan.py plan_conv_tiles). The
// tiles are BM x BM and BM x 2 BM for BM = 64 and 128; the tiles of one BM
// are instantiated together, so that a mode's two halves can be compiled side
// by side (the build compiles each conv_mode_*.cu and conv_int8_out_*.cu once
// per BM).
template <int AMODE, int BM, class Epi>
cudaError_t launch_rows(const void* x, const void* w, const Geom& g, int bn,
                        const Epi& epi, cudaStream_t stream) {
    if (g.stages < 2 || g.stages > 16 || g.split < 1 || g.split > 8
        || g.split > g.steps)
        return cudaErrorInvalidValue;
    if (bn == BM)
        return launch_tile<AMODE, BM, BM, Epi>(x, w, g, epi, stream);
    if (bn == 2 * BM)
        return launch_tile<AMODE, BM, 2 * BM, Epi>(x, w, g, epi, stream);
    return cudaErrorInvalidValue;
}

// the geometry both C entries fill in; elem_bytes of the product's operands
inline Geom make_geom(int n, int hi, int wi, int ci, int ho, int wo, int co,
                      int k, int stride, int pad, int ldw, int stages,
                      int split, float xinv, int elem_bytes) {
    Geom g;
    g.n_img = n; g.hi = hi; g.wi = wi; g.ci = ci; g.ho = ho; g.wo = wo;
    g.co = co; g.k = k; g.stride = stride; g.pad = pad; g.ldw = ldw;
    g.m_total = n * ho * wo;
    g.depth = k * k * ci;
    g.steps = (g.depth * elem_bytes + STEP_BYTES - 1) / STEP_BYTES;
    g.stages = stages; g.split = split; g.xinv = xinv;
    g.by_ci.init(ci);
    g.by_wo.init(wo);
    g.by_howo.init(ho * wo);
    return g;
}

}  // namespace conv_ring
