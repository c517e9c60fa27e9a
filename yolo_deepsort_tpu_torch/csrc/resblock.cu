// Kernel 9: a chain of darknet residual blocks
//
//   x -> 1x1 conv (Ci -> Cm) + bias + act -> 3x3 conv (Cm -> Ci, pad 1)
//     + bias + act -> + x
//
// on the tensor cores (bf16 x bf16 -> f32, or W8A8: int8 x int8 -> int32).
//
// Replaces the TPU kernel yolo_deepsort_tpu/ops/pallas_resblock.py
// _chain_kernel. That kernel gives one program whole frames: x, the chain
// state and the padded mid sit in 10-13 MB of VMEM. An SM has 227 KB, so
// none of that carries over. Here each block of the chain is two launches
// of the implicit-GEMM main loop that kernels 7 and 8 share
// (conv_mainloop.cuh: a ring of shared-memory stages filled by a producer
// warpgroup with cp.async, wgmma consumer warpgroups, the tile plan from
// Python), both from this ONE C entry, on the caller's stream:
//
// * the 1x1 conv writes `mid` (N, H, W, Cm) to device memory. In bf16 mode
//   with kernel 7's own epilogue (bias, activation, bf16); in W8A8 mode the
//   producers quantize the bf16 chain state with the block's first scale and
//   the epilogue (CodesEpilogue) writes mid as the int8 codes the 3x3 conv
//   reads, quantized once with the second scale;
// * the 3x3 conv reads mid by cp.async (bf16, or int8 codes: nothing is
//   quantized on its way in) and its epilogue (ResidualEpilogue) adds bias,
//   activates, rounds to bf16, adds the block's input (fetched per row
//   ahead of the drain) and rounds again: the shortcut costs no pass of its
//   own.
//
// mid leaves the SM but not the L2 cache: one block's mid is at most
// 8 x 52 x 52 x 128 x 2 bytes = 5.5 MB at batch 8 (22 MB at 32) against the
// H100's 50 MB. The chain state lives in two device buffers used in turn
// (the output and one scratch buffer, chosen so that the last block writes
// the output); no block reads the buffer it writes. Every launch is an
// ordinary one: the chain captures into a CUDA graph.
//
// Bound on the H100 by operations at the 3x3 convs (2 * H * W * 9 * Ci * Cm
// per block and frame) and by bytes at the 1x1 convs; the tile plans are
// ops/conv_plan.py plan_conv_tiles' for each layer's shape, which at
// yolov3-416 are kernel 7's timed shape classes.
//
// Built with --fmad=false, and the epilogues are written with __fmul_rn /
// __fadd_rn: int32 sums are exact, so W8A8 mode with a leaky activation
// equals its plain PyTorch version bit for bit. The mode instantiations are
// compiled in translation units of their own (resblock_mode_*.cu, and
// kernel 7's conv_mode_bf16.cu for the bf16 1x1 conv).

#include "resblock_chain.cuh"

// the launcher of tile height bm (64 or 128)
#define RESBLOCK_BY_BM(FN, bm, ...) \
    ((bm) == 128 ? FN<128>(__VA_ARGS__) : FN<64>(__VA_ARGS__))

// x, out, tmp (N, H, W, Ci) bf16: the chain's input, its output and a
// scratch state (null when nblk is 1); mid (N, H, W, Cm) bf16 or, in int8
// mode, int8. w1 (nblk, Cm, ldw1) and w2 (nblk, Ci, ldw2), bf16 or int8:
// each block's 1x1 and 3x3 weights packed K-major (ops/conv_plan.py
// pack_conv_weights). b1 (nblk, Cm), b2 (nblk, Ci) f32; int8 mode adds s1
// (nblk, Cm), s2 (nblk, Ci) f32 on the card and xinv (nblk, 2) f32 IN HOST
// MEMORY (read here, handed to the kernels by value). bm*, bn*, stages*,
// split*: the tile plans of the 1x1 (1) and the 3x3 (2) conv. Ci and Cm
// must be multiples of 128 and N * H * W * max(Ci, Cm) below 2^31.
// *launched (host memory) is set to the kernels this call launched.
extern "C" int ydt_resblock_chain(
    const void* x, void* out, void* tmp, void* mid, const void* w1,
    const void* w2, const void* b1, const void* b2, const void* s1,
    const void* s2, const void* xinv, int n, int h, int w, int ci, int cm,
    int nblk, int act, int ldw1, int ldw2, int bm1, int bn1, int stages1,
    int split1, int bm2, int bn2, int stages2, int split2, int int8_mode,
    int* launched, void* stream) {
    if (launched == nullptr) return (int)cudaErrorInvalidValue;
    *launched = 0;
    const int es = int8_mode ? 1 : 2;
    const long long elems = (long long)n * h * w * (ci > cm ? ci : cm);
    if (n <= 0 || h <= 0 || w <= 0 || nblk <= 0 || ci <= 0 || cm <= 0
        || (ci % 128) != 0 || (cm % 128) != 0 || elems >= (1ll << 31)
        || (nblk > 1 && tmp == nullptr) || mid == nullptr
        || ldw1 < ci || ldw2 < 9 * cm || (ldw1 * es) % 16 != 0
        || (ldw2 * es) % 16 != 0 || (bm1 != 64 && bm1 != 128)
        || (bm2 != 64 && bm2 != 128)
        || (int8_mode && (s1 == nullptr || s2 == nullptr || xinv == nullptr)))
        return (int)cudaErrorInvalidValue;
    using namespace resblock;
    const float* bias1 = static_cast<const float*>(b1);
    const float* bias2 = static_cast<const float*>(b2);
    const float* scale1 = static_cast<const float*>(s1);
    const float* scale2 = static_cast<const float*>(s2);
    const float* xi = static_cast<const float*>(xinv);
    const unsigned char* w1b = static_cast<const unsigned char*>(w1);
    const unsigned char* w2b = static_cast<const unsigned char*>(w2);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(x);
    for (int b = 0; b < nblk; ++b) {
        // the last block writes out, the one before it tmp, and so on
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(
            ((nblk - 1 - b) & 1) ? tmp : out);
        const conv_ring::Geom g1 = conv_ring::make_geom(
            n, h, w, ci, h, w, cm, 1, 1, 0, ldw1, stages1, split1,
            int8_mode ? xi[2 * b] : 0.0f, es);
        const conv_ring::Geom g2 = conv_ring::make_geom(
            n, h, w, cm, h, w, ci, 3, 1, 1, ldw2, stages2, split2, 0.0f, es);
        const void* wa = w1b + (long long)b * cm * ldw1 * es;
        const void* wb = w2b + (long long)b * ci * ldw2 * es;
        cudaError_t err;
        if (int8_mode) {
            const CodesEpilogue e1{bias1 + (long long)b * cm,
                                   scale1 + (long long)b * cm,
                                   static_cast<signed char*>(mid), cm, act,
                                   xi[2 * b + 1]};
            err = RESBLOCK_BY_BM(launch_codes, bm1, src, wa, g1, bn1, e1, st);
            if (err != cudaSuccess) return (int)err;
            ++*launched;
            const ResidualEpilogue<int> e2{bias2 + (long long)b * ci,
                                           scale2 + (long long)b * ci, src,
                                           dst, ci, act};
            err = RESBLOCK_BY_BM(launch_residual_s8, bm2, mid, wb, g2, bn2,
                                 e2, st);
        } else {
            const conv_backbone::BackboneEpilogue<float> e1{
                bias1 + (long long)b * cm, nullptr,
                static_cast<__nv_bfloat16*>(mid), cm, act, false};
            err = RESBLOCK_BY_BM(conv_backbone::launch_bf16, bm1, src, wa, g1,
                                 bn1, e1, st);
            if (err != cudaSuccess) return (int)err;
            ++*launched;
            const ResidualEpilogue<float> e2{bias2 + (long long)b * ci,
                                             nullptr, src, dst, ci, act};
            err = RESBLOCK_BY_BM(launch_residual_bf16, bm2, mid, wb, g2, bn2,
                                 e2, st);
        }
        if (err != cudaSuccess) return (int)err;
        ++*launched;
        src = dst;
    }
    return (int)cudaSuccess;
}
