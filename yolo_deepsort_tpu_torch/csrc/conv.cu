// Kernel 7: backbone convolution + bias + activation as an implicit GEMM on
// the tensor cores (bf16 x bf16 -> f32, or int8 x int8 -> int32).
//
// Replaces the TPU kernel yolo_deepsort_tpu/ops/pallas_conv.py _conv_kernel
// (conv_mxu_bf16 / conv_mxu_int8). The TPU design keeps whole padded feature
// maps resident in VMEM, strips over H and phase-splits stride 2 outside the
// kernel; none of that carries over. Here the conv is one matrix product
// (rows N * Ho * Wo, columns Co, depth k * k * Ci flat over taps and
// channels); stride 2 is index arithmetic in the gather (iy = oy * stride -
// pad + dy): no padded copy, no phase plane, no pre-decimated input.
//
// Bound on the H100 by operations: at the backbone's 3x3 shapes the product
// does 400-2300 operations per byte moved (the 1x1 shapes are bound by
// bytes). What the design does about it is in conv_mainloop.cuh, the main
// loop this file shares with conv_int8.cu: a ring of 128-byte-deep tile
// pairs in dynamic shared memory, filled by a producer warpgroup and handed
// over through mbarriers to consumer warpgroups that start wgmma (m64nNk16
// bf16 -> f32, m64nNk32 s8 -> s32); no block-wide barrier in the loop; tile
// shape, ring depth and a split of the depth over a thread-block cluster are
// planned per shape in Python (ops/conv_plan.py). The weights are packed
// once to K-major (Co, ldw) rows, in both types. Which path each mode's
// activation tile takes:
//   mode 0 (bf16 x, bf16 w): zero-filling cp.async, 16 bytes = 8 channels;
//   mode 1 (bf16 x, int8 w) and mode 2 (f32 x, int8 w): an asynchronous copy
//     cannot quantize, so the producers load 16 channels into registers,
//     quantize clip(rint(f32(x) * xinv), -127, 127), ties to even, and store
//     the swizzled 16-byte piece themselves (a pixel is quantized once per
//     tap that reads it, as it always was). The weight tile is cp.async in
//     every mode.
// Each mode's instantiations of the main loop are compiled in translation
// units of their own (conv_mode_*.cu, once per tile height); this file holds
// the C entry.
//
// The epilogue (conv_backbone.cuh) is this kernel's own. A thread keeps 8
// columns, loads their bias (and scale) once, and the main loop hands it
// those columns of one row after another, summed; it applies (int8: *
// scale[c]) + bias[c] and the activation in f32 and writes bf16 NHWC: one
// 16-byte store when Co is a multiple of 8, masked 2-byte stores otherwise
// (Co = 255, the yolo heads). Mode 3 is mode 0 with an f32 output: the
// same epilogue without the rounding, two 16-byte stores (the ReID blocks'
// second conv and projection shortcut, whose sum with the shortcut rounds
// once, as the reference's does). Modes 4 and 5 are mode 0 with a residual
// block's whole tail in its epilogue (ShortcutEpilogue): the shortcut's 8
// columns of a row, fetched ahead of the drain, are added to sum + bias in
// f32, then the activation, one rounding and one 16-byte bf16 store; mode 4
// reads a bf16 shortcut (an identity block's input), mode 5 an f32 one (a
// projection conv's mode-3 output). The sums are those of mode 3 for the
// same plan, so the block's output is the one the f32 form and a framework
// tail give, without the f32 map's round trips through memory.
// Activations: linear, leaky, mish (the detectors), ReLU and ELU (the ReID
// nets).
//
// Built with --fmad=false: the f32 epilogue rounds as the plain PyTorch
// version does (a multiply, then an add), so the int8 modes, whose int32
// sums are exact in any order, equal their plain version bit for bit.

#include "conv_backbone.cuh"

// mode 0: bf16 x (N, Hi, Wi, Ci), bf16 w; mode 1: int8 w, bf16 x quantized on
// the way in; mode 2: int8 w, float x; mode 3: mode 0 with f32 out; modes 4
// and 5: mode 0 with the shortcut res (N, Ho, Wo, Co) added before the
// activation, bf16 in mode 4, f32 in mode 5 (Co a multiple of 8; res is
// NULL in the other modes). w (Co,
// ldw) is the weights packed K-major: row co holds its k * k * Ci values
// tap-major, zero up to the pitch ldw (16 bytes' worth of elements divide
// it). bias (Co,) f32; scale (Co,) f32 and xinv in the int8 modes; out (N,
// Ho, Wo, Co) bf16 (f32 in mode 3); act 0-4 (linear, leaky, mish, ReLU,
// ELU). bm, bn,
// stages, split: the tile plan. Ci must be a multiple of 8 (16-byte gathers
// of activation rows).
extern "C" int ydt_conv(const void* x, const void* w, const void* bias,
                        const void* scale, const void* res, float xinv,
                        void* out, int n, int hi, int wi, int ci, int ho,
                        int wo, int co, int k, int stride, int pad, int act,
                        int mode, int ldw, int bm, int bn, int stages,
                        int split, void* stream) {
    const bool f32_out = mode == 3;
    const int res_mode = (mode == 4 || mode == 5) ? mode : 0;
    if (res_mode && (res == nullptr || (co % 8) != 0))
        return (int)cudaErrorInvalidValue;
    if (f32_out || res_mode) mode = 0;
    const int es = mode == 0 ? 2 : 1;
    if (n <= 0 || ci <= 0 || co <= 0 || ho <= 0 || wo <= 0 || (ci % 8) != 0
        || (k != 1 && k != 3) || mode < 0 || mode > 2 || act < 0 || act > 4
        || ldw < k * k * ci
        || (ldw * es) % 16 != 0 || (bm != 64 && bm != 128))
        return (int)cudaErrorInvalidValue;
    const conv_ring::Geom g = conv_ring::make_geom(
        n, hi, wi, ci, ho, wo, co, k, stride, pad, ldw, stages, split, xinv,
        es);
    const float* b = static_cast<const float*>(bias);
    const float* s = static_cast<const float*>(scale);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    using namespace conv_backbone;
    const bool tall = bm == 128;
    const BackboneEpilogue<float> ef{b, s, out, co, act, f32_out};
    const BackboneEpilogue<int> ei{b, s, out, co, act, false};
    cudaError_t err;
    if (res_mode == 4) {
        const ShortcutEpilogue<__nv_bfloat16> er{
            b, static_cast<const __nv_bfloat16*>(res), out, co, act};
        err = tall ? launch_res<__nv_bfloat16, 128>(x, w, g, bn, er, st)
                   : launch_res<__nv_bfloat16, 64>(x, w, g, bn, er, st);
    } else if (res_mode == 5) {
        const ShortcutEpilogue<float> er{
            b, static_cast<const float*>(res), out, co, act};
        err = tall ? launch_res<float, 128>(x, w, g, bn, er, st)
                   : launch_res<float, 64>(x, w, g, bn, er, st);
    } else if (mode == 0)
        err = tall ? launch_bf16<128>(x, w, g, bn, ef, st)
                   : launch_bf16<64>(x, w, g, bn, ef, st);
    else if (mode == 1)
        err = tall ? launch_quant_bf16<128>(x, w, g, bn, ei, st)
                   : launch_quant_bf16<64>(x, w, g, bn, ei, st);
    else
        err = tall ? launch_quant_f32<128>(x, w, g, bn, ei, st)
                   : launch_quant_f32<64>(x, w, g, bn, ei, st);
    return (int)err;
}
