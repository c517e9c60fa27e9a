// Kernel 8: fused W8A8 convolution of the int8-resident ReID embed, as an
// implicit GEMM on the tensor cores (int8 x int8 -> int32).
//
// Replaces the TPU kernels yolo_deepsort_tpu/ops/pallas_conv_int8.py
// _conv_kernel_3x3 and _conv_kernel_1x1 (conv_int8). The TPU wrapper pads the
// input, splits stride-2 inputs into four parity planes and pre-decimates for
// the 1x1 conv, and its grid walks groups of crops; none of that carries
// over. Here one launch computes the conv as one matrix product (rows
// N * Ho * Wo, columns Co, depth k * k * Ci flat over taps and channels);
// stride 2 and the halo are index arithmetic in the gather (iy = oy * stride
// - pad + dy), and activations arrive as int8: nothing is quantized on the
// way in.
//
// Bound on the H100 by operations at the 3x3 layers (290-2300 per byte
// moved) and by bytes at the 1x1 shortcuts. What the design does about it is
// in conv_mainloop.cuh, the main loop this file shares with conv.cu: a ring
// of 128-byte-deep tile pairs in dynamic shared memory, filled by a producer
// warpgroup with zero-filling cp.async and handed over through mbarriers to
// consumer warpgroups that start wgmma m64nNk32 (s8 x s8 -> s32, 32 deep:
// twice what the older mma path took per instruction); no block-wide barrier
// in the loop; tile shape, ring depth and a split of the depth over a
// thread-block cluster are planned per shape in Python
// (ops/conv_plan.py). The weights are packed once to K-major (Co, ldw)
// rows: integer wgmma takes both operands K-major only.
//
// The epilogue (conv_reid.cuh) is the contract and this kernel's own. A
// thread keeps 16 columns, loads their scale and bias once, and the main
// loop hands it those columns of one row after another as int32 sums (the
// residual's 16 codes fetched a few rows ahead):
//     y = f32(acc) * scale[c]; y = y + bias[c];
//     y = y + f32(res) * res_scale      (with a residual)
//     y = max(y, 0)                     (with relu)
//     int8(clip(rint(y * oinv), -127, 127))   or   y as f32
// every step rounded to f32 (explicit __fmul_rn / __fadd_rn, and the file is
// built with --fmad=false), so the int8 codes equal the plain PyTorch
// version's bit for bit: int32 sums are exact in any order, split or not.
// The residual is read and the int8 result written as 16-byte vectors along
// Co. Each output type's instantiations of the main loop are compiled in
// translation units of their own (conv_int8_out_*.cu, once per tile height);
// this file holds the C entry.

#include "conv_reid.cuh"

// x (N, Hi, Wi, Ci) int8; w (Co, ldw) int8, the weights packed K-major: row
// co holds its k * k * Ci values tap-major, zero up to the pitch ldw (a
// multiple of 16); scale, bias (Co,) f32; res (N, Ho, Wo, Co) int8 or null,
// with res_scale; oinv the requant factor; out (N, Ho, Wo, Co) int8
// (out_int8) or f32. bm, bn, stages, split: the tile plan. Ci and Co must be
// multiples of 16 and every pointer 16-byte aligned (16-byte copies and
// stores).
extern "C" int ydt_conv_int8(const void* x, const void* w, const void* scale,
                             const void* bias, const void* res,
                             float res_scale, float oinv, void* out, int n,
                             int hi, int wi, int ci, int ho, int wo, int co,
                             int k, int stride, int pad, int relu,
                             int out_int8, int ldw, int bm, int bn,
                             int stages, int split, void* stream) {
    const uintptr_t ptrs = (uintptr_t)x | (uintptr_t)w | (uintptr_t)scale
                           | (uintptr_t)bias | (uintptr_t)res
                           | (uintptr_t)out;
    if (n <= 0 || ci <= 0 || co <= 0 || ho <= 0 || wo <= 0 || (ci % 16) != 0
        || (co % 16) != 0 || (k != 1 && k != 3) || (ptrs & 15) != 0
        || ldw < k * k * ci || (ldw % 16) != 0 || (bm != 64 && bm != 128))
        return (int)cudaErrorInvalidValue;
    const conv_ring::Geom g = conv_ring::make_geom(
        n, hi, wi, ci, ho, wo, co, k, stride, pad, ldw, stages, split, 0.0f,
        1);
    const float* sp = static_cast<const float*>(scale);
    const float* bp = static_cast<const float*>(bias);
    const signed char* rp = static_cast<const signed char*>(res);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool tall = bm == 128;
    const conv_reid::ReidEpilogue<true> codes{sp, bp, rp, out, res_scale,
                                              oinv, co, relu};
    const conv_reid::ReidEpilogue<false> f32{sp, bp, rp, out, res_scale,
                                             oinv, co, relu};
    using conv_reid::run;
    cudaError_t err;
    if (out_int8)
        err = tall ? run<true, 128>(x, w, g, bn, codes, st)
                   : run<true, 64>(x, w, g, bn, codes, st);
    else
        err = tall ? run<false, 128>(x, w, g, bn, f32, st)
                   : run<false, 64>(x, w, g, bn, f32, st);
    return (int)err;
}
