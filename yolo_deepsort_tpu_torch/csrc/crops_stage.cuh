// The staged main loop of the crop family: windowed ReID crop-resample-
// normalize for Hopper, in three instantiations (csrc/crops.cu):
//
//   Order::kPlanar       kernel 2, the TPU kernel's rounding order: Y pass
//                        first with /255 folded into the bf16 Y weights, the
//                        Y-resampled values rounded to bf16, X pass, then
//                        x * f32(1/std) - f32(mean/std). Both passes run in
//                        registers, from the four staged taps of each value.
//   Order::kInterleaved  kernel 6: the same function and rounding points;
//                        its Y pass first writes every tap column of a row
//                        to shared memory as RGB-interleaved bf16 lanes (the
//                        TPU kernel's interleaved window), its X pass reads
//                        them after a barrier. Equal to kernel 2 bit for bit.
//   Order::kDense        the dense (XLA) order of ops/crops.py
//                        crop_and_normalize: X pass first (on both source
//                        rows), rounded to bf16, Y pass, then
//                        ((x / 255) - mean) / std as three IEEE operations,
//                        in registers as kernel 2; with the whole frame as
//                        the window it is the reference's value on both
//                        branches of the K=1 step's window guard.
//
// Tap math (``tap_weights``): half-pixel centres, coordinates clamped to the
// integer crop, a tap outside the (win_h, win_w) window weighs 0, the two
// weights renormalized and rounded to bf16. A bilinear row has two non-zero
// weights and a bf16 x bf16 (or bf16 x byte) product is exact in f32, so
// each pass is one f32 rounding of a two-term sum in any order: the plain
// versions' dense contractions round the same way. Built with --fmad=false.
//
// Bound on the H100: bytes. A box writes 128 x 64 x 3 f32 (96 KB) and reads
// at most the pixels inside it. Design:
//   * grid: one block per (box, strip of output rows); the strip height is
//     a constant of each instantiation (CROPS_STRIP_*, below);
//   * a strip's source rows are the ones its Y taps name (two per output
//     row), de-duplicated into a sorted list by one warp with two ballots;
//     rows between them are never read (a box taller than 256 px shares no
//     row between two output rows);
//   * sub-strips of 8 output rows (at most 16 source rows) go through a ring
//     of kStages shared-memory stages: the rows of sub-strip q + 2 are in
//     flight while sub-strip q is computed, one bulk copy a row
//     (cp.async.bulk, the copy engine), issued by one lane each and landing
//     on the stage's mbarrier, one block barrier a sub-strip (two in K6).
//     Per-thread 16-byte cp.async copies spent ~a quarter of a block's life
//     issuing them (clock64 stamps: CROPS_STAMPS, tools/crops_phases.py);
//   * a row is staged as its byte run from the first to the last X tap,
//     aligned down to 16 bytes (a per-row shift) and rounded up to 16; bytes
//     outside the frame buffer's 16-byte aligned span are loaded by the
//     issuing lane. A run longer than a staged row (a box wider than ~200
//     px: downsampled in X) is gathered instead: the 128 tap columns'
//     pixels, 3 bytes each, loaded by the threads;
//   * each thread writes two float4 of a sub-strip's contiguous run of the
//     NHWC crop (8 x 768 bytes), at fixed lanes whose tap offsets and X
//     weights it holds in registers for the whole block;
//   * the inner loop converts in integer and FP32 instructions (byte ->
//     f32, bf16 bits) and rounds two values to bf16 in one packed
//     conversion.
// At the served shape kernel 2 runs at 1.7x its bound (the bytes of the
// pixels inside its boxes), kernel 6 at 2.5x (its intermediate's round trip
// through shared memory). The dense entry, held to the bytes of the pixels
// its taps weigh, runs at ~2.6x on the same boxes and ~4x on a mix with a
// full-frame and a wide box per frame: the 2x target is missed. What holds
// it back: its two IEEE divisions a value (a sub-strip computes in ~1.2x
// kernel 2's cycles, with registers for one block fewer per SM), and on
// the mix the gathered boxes, whose 128 tap columns are loaded 3 bytes at
// a time and whose blocks finish last. A block's set-up (taps, row list,
// first copies) is a quarter of its life (PERF.md, tools/crops_phases.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace crop_stage {

constexpr int kCropH = 128;
constexpr int kCropW = 64;
constexpr int kThreads = 192;  // 4 output rows x 48 float4 stores
constexpr int kMinBlocks = 5;   // blocks an SM holds (shared memory);
                                // the dense order's IEEE divisions take the
                                // registers of one block fewer
constexpr int kSub = 8;                 // output rows a ring stage serves
constexpr int kStageRows = 2 * kSub;    // distinct source rows it holds
constexpr int kStages = 3;
constexpr int kPitch = 640;             // bytes of one staged row
constexpr int kSlots = 2 * kCropW;      // the two tap columns of each x
constexpr int kRowFloats = kCropW * 3;  // one NHWC output row
constexpr int kMaxStrip = kCropH;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads - kCropW >= kMaxStrip, "Y and X taps in one pass");

enum class Order { kPlanar, kInterleaved, kDense };

// Output rows per block of each instantiation (8, 16, 32, 64 or 128; 128 /
// it blocks per box): the fastest of `tools/conv_clocks.py --kernels
// strips` at the served shape, 8 x 40 boxes, which builds this file once per
// height with the three defined (the dense order's IEEE divisions make its
// blocks slower to start and finish: it wants more of them).
#ifndef CROPS_STRIP_PLANAR
#define CROPS_STRIP_PLANAR 64
#endif
#ifndef CROPS_STRIP_INTERLEAVED
#define CROPS_STRIP_INTERLEAVED 64
#endif
#ifndef CROPS_STRIP_DENSE
#define CROPS_STRIP_DENSE 32
#endif
template <Order kOrder>
__host__ __device__ constexpr int strip_rows_of() {
  return kOrder == Order::kPlanar        ? CROPS_STRIP_PLANAR
         : kOrder == Order::kInterleaved ? CROPS_STRIP_INTERLEAVED
                                         : CROPS_STRIP_DENSE;
}

// Built with CROPS_STAMPS defined (tools/crops_phases.py), thread 0 of every
// block records the SM clock at each phase boundary, and its SM, in
// kStampSlots slots: 0 start, 1 taps, 2 row list and set-up, 3 first
// copies, 4 end, 5 the SM, 6 + 2q sub-strip q's rows landed, 7 + 2q its
// values stored. Without it the stamps compile to nothing.
#ifdef CROPS_STAMPS
constexpr int kStampSlots = 6 + 2 * (kMaxStrip / kSub);
constexpr int kStampBlocks = 1 << 15;
__device__ long long g_stamps[kStampBlocks * kStampSlots];
__device__ __forceinline__ long long sm_id() {
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}
#define CROPS_STAMP(slot, value)                                        \
  if (threadIdx.x == 0 && blockIdx.x < crop_stage::kStampBlocks)        \
    crop_stage::g_stamps[(long long)blockIdx.x * crop_stage::kStampSlots \
                         + (slot)] = (value)
#else
#define CROPS_STAMP(slot, value)
#endif

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 1/std and mean/std of the ImageNet normalization, rounded like the
// reference package's Python-double constants (the Pallas order)
__device__ __forceinline__ float inv_std(int c) {
  return c == 0 ? (float)(1.0 / (double)0.229f)
                : (c == 1 ? (float)(1.0 / (double)0.224f)
                          : (float)(1.0 / (double)0.225f));
}
__device__ __forceinline__ float mean_over_std(int c) {
  return c == 0 ? (float)((double)0.485f * (1.0 / (double)0.229f))
                : (c == 1 ? (float)((double)0.456f * (1.0 / (double)0.224f))
                          : (float)((double)0.406f * (1.0 / (double)0.225f)));
}
// the f32 constants of ops/crops.py REID_MEAN / REID_STD (the dense order)
__device__ __forceinline__ float reid_mean(int c) {
  return c == 0 ? 0.485f : (c == 1 ? 0.456f : 0.406f);
}
__device__ __forceinline__ float reid_std(int c) {
  return c == 0 ? 0.229f : (c == 1 ? 0.224f : 0.225f);
}

// bf16(a / s / post_scale) of a tap weight a, its partner b and their sum
// s = max(a + b, 1e-6): a zero weight and a lone tap (s = a, a / a = 1) take
// no division, which sends a zero numerator to its slow path; each gives
// the quotient the divisions give.
__device__ __forceinline__ float tap_quotient(float a, float b, float s,
                                              float post_scale) {
  if (a == 0.0f) return 0.0f;
  if (b == 0.0f && a >= 1e-6f) return bf16_round(1.0f / post_scale);
  return bf16_round(a / s / post_scale);
}

// Two-tap bilinear weights of output position `o` of `n_out`, exactly the
// f32 op sequence of _interp_matrix (Pallas `interp`): the window-relative
// first tap index and both weights (0 when the tap leaves the window).
__device__ __forceinline__ void tap_weights(int o, int n_out, float start,
                                            float end, int origin, int win,
                                            float post_scale, int* k0rel,
                                            float* w0, float* w1) {
  float r = (float)o;
  float coords = start + (r + 0.5f) / (float)n_out * (end - start) - 0.5f;
  float hi = fmaxf(end - 1.0f, start);
  coords = fminf(fmaxf(coords, start), hi);
  float kf = floorf(coords);
  float k0 = kf, k1 = kf + 1.0f;
  float a0 = fminf(fmaxf(1.0f - fabsf(coords - k0), 0.0f), 1.0f);
  float a1 = fminf(fmaxf(1.0f - fabsf(coords - k1), 0.0f), 1.0f);
  int i0 = (int)k0 - origin;
  bool in0 = i0 >= 0 && i0 < win;
  bool in1 = i0 + 1 >= 0 && i0 + 1 < win;
  a0 = in0 ? a0 : 0.0f;
  a1 = in1 ? a1 : 0.0f;
  float s = fmaxf(a0 + a1, 1e-6f);
  *k0rel = i0;
  *w0 = tap_quotient(a0, a1, s, post_scale);
  *w1 = tap_quotient(a1, a0, s, post_scale);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
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
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// a bulk copy (the copy engine) of `bytes` (a multiple of 16, both ends
// 16-byte aligned) global -> shared, completing on the barrier
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The inner loops' conversions in integer and FP32 instructions, which
// retire four times as many results per clock as the conversion unit. All
// exact. A byte as a float: 2^23 + b has b in its low mantissa bits.
__device__ __forceinline__ float byte_to_float(uint32_t b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | b), 8388608.0f);
}
// f32 -> bf16 bits, round to nearest even (finite x, as every value here)
__device__ __forceinline__ uint16_t to_bf16_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}
__device__ __forceinline__ float from_bf16_bits(uint32_t v) {
  return __uint_as_float(v << 16);
}
// a and b rounded to bf16 (nearest even) in one packed conversion
__device__ __forceinline__ void bf16_round2(float a, float b, float* ra,
                                            float* rb) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  *ra = __low2float(r);
  *rb = __high2float(r);
}

struct Smem {
  uint8_t stage[kStages][kStageRows][kPitch];
  // the interleaved variant's first-pass intermediate, bf16 bits,
  // [yy][slot * 3 + c] (8 x 384)
  uint16_t inter[kSub * kSlots * 3];
  int shift[kStages][kStageRows];  // per staged row: run start & 15
  int list[2 * kMaxStrip];         // the strip's source rows, ascending
  int i0[kMaxStrip], i1[kMaxStrip];  // list index of each row's two taps
  int ky[kMaxStrip];
  float wy0[kMaxStrip], wy1[kMaxStrip];
  int kx[kCropW];
  float wx0[kCropW], wx1[kCropW];
  int soff[kSlots];  // byte offset of each tap column in a staged row
  uint64_t full[kStages];  // a stage's rows have landed (one phase a fill)
};

// The box's geometry as every thread of a block holds it.
struct BoxGeom {
  const uint8_t* frame;  // the box's frame
  const uint8_t* lo;     // the frame buffer, for the edge test
  const uint8_t* hi;     // one past it
  int w, oy, ox, win_w, c_lo, nl;
  bool run;  // stage byte runs (else gather the tap columns)
};

// Fill ring stage q % kStages with sub-strip q's source rows and arrive on
// its barrier. A staged run: one bulk copy a row, issued by lane j of warp 0
// (the bytes that would leave the frame buffer by plain loads); a gathered
// box: the 128 tap columns' pixels of each row, row j by warp j mod kWarps.
__device__ __forceinline__ void stage_rows(Smem& sm, const BoxGeom& g, int q,
                                           int warp, int lane) {
  const int st = q % kStages;
  const int lo = sm.i0[q * kSub];
  const int cnt = sm.i1[q * kSub + kSub - 1] - lo + 1;
  const uint32_t bar = smem_u32(&sm.full[st]);
  if (g.run) {
    if (warp != 0) return;
    const uint8_t* src = nullptr;
    const uint8_t *a = nullptr, *b = nullptr;
    uint32_t bytes = 0;
    if (lane < cnt) {
      const uint8_t* p = g.frame
          + ((long long)(g.oy + sm.list[lo + lane]) * g.w + g.ox + g.c_lo) * 3;
      const int sh = (int)((uintptr_t)p & 15);
      sm.shift[st][lane] = sh;
      src = p - sh;
      const uint8_t* end = src + ((sh + g.nl + 15) & ~15);
      // the 16-byte aligned part inside the frame buffer
      a = (const uint8_t*)(((uintptr_t)g.lo + 15) & ~(uintptr_t)15);
      b = (const uint8_t*)((uintptr_t)g.hi & ~(uintptr_t)15);
      a = src > a ? src : a;
      b = end < b ? end : b;
      bytes = b > a ? (uint32_t)(b - a) : 0u;
      for (const uint8_t* t = src; t < end; ++t) {  // the ragged ends
        if (bytes != 0 && t == a) t = b;
        if (t >= end) break;
        sm.stage[st][lane][t - src] = (t >= g.lo && t < g.hi) ? *t : 0;
      }
    }
    uint32_t total = bytes;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      total += __shfl_xor_sync(0xffffffffu, total, o);
    if (lane == 0) mbar_arrive_tx(bar, total);
    __syncwarp();
    if (bytes != 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_copy(&sm.stage[st][lane][a - src], a, bytes, bar);
    }
  } else {
    for (int j = warp; j < cnt; j += kWarps) {
      const long long row = (long long)(g.oy + sm.list[lo + j]) * g.w + g.ox;
      if (lane == 0) sm.shift[st][j] = 0;
      for (int t = lane; t < kSlots; t += 32) {
        const int col = clampi(sm.kx[t >> 1] + (t & 1), 0, g.win_w - 1);
        const uint8_t* src = g.frame + (row + col) * 3;
        uint8_t* dst = &sm.stage[st][j][t * 3];
        dst[0] = __ldg(src);
        dst[1] = __ldg(src + 1);
        dst[2] = __ldg(src + 2);
      }
    }
    if (warp == 0 && lane == 0) mbar_arrive_tx(bar, 0);
  }
}

template <Order kOrder>
__global__ void __launch_bounds__(kThreads, kOrder == Order::kDense
                                                ? kMinBlocks - 1
                                                : kMinBlocks)
crops_stage_kernel(const uint8_t* __restrict__ frames,
                   const float* __restrict__ boxes, float* __restrict__ out,
                   int d, int h, int w, int win_h, int win_w,
                   long long total_bytes) {
  __shared__ __align__(16) Smem sm;
  CROPS_STAMP(0, clock64());
  CROPS_STAMP(5, sm_id());
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(smem_u32(&sm.full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  constexpr bool kDense = kOrder == Order::kDense;
  constexpr float kYScale = kDense ? 1.0f : 255.0f;
  constexpr int strip_rows = strip_rows_of<kOrder>();
  static_assert(strip_rows >= kSub && strip_rows <= kMaxStrip
                    && (strip_rows & (strip_rows - 1)) == 0,
                "a strip is 8, 16, 32, 64 or 128 rows");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_strips = kCropH / strip_rows;
  const int box = blockIdx.x / n_strips;  // flat (frame, box)
  const int y_base = (blockIdx.x - box * n_strips) * strip_rows;
  const int bi = box / d;
  const float4 bx = reinterpret_cast<const float4*>(boxes)[box];
  // crop_window_bounds: truncate to int, clip, at least one pixel
  const int x1 = min(max((int)bx.x, 0), w - 1);
  const int y1 = min(max((int)bx.y, 0), h - 1);
  const int x2 = min(max((int)bx.z, x1 + 1), w);
  const int y2 = min(max((int)bx.w, y1 + 1), h);
  const int oy = min(max(y1, 0), h - win_h);
  const int ox = min(max(x1, 0), w - win_w);

  // The staged run of a row spans the first to the last X tap (the taps
  // grow with x); every thread finds it from those two taps alone.
  int k_first, k_last;
  float unused0, unused1;
  tap_weights(0, kCropW, (float)x1, (float)x2, ox, win_w, 1.0f, &k_first,
              &unused0, &unused1);
  tap_weights(kCropW - 1, kCropW, (float)x1, (float)x2, ox, win_w, 1.0f,
              &k_last, &unused0, &unused1);
  BoxGeom g;
  g.frame = frames + (long long)bi * h * w * 3;
  g.lo = frames;
  g.hi = frames + total_bytes;
  g.w = w;
  g.oy = oy;
  g.ox = ox;
  g.win_w = win_w;
  g.c_lo = clampi(k_first, 0, win_w - 1);
  g.nl = (clampi(k_last + 1, 0, win_w - 1) - g.c_lo + 1) * 3;
  g.run = g.nl + 15 <= kPitch;

  // the strip's Y taps; the X taps and each tap column's byte offset in a
  // staged row
  if (tid < strip_rows) {
    tap_weights(y_base + tid, kCropH, (float)y1, (float)y2, oy, win_h,
                kYScale, &sm.ky[tid], &sm.wy0[tid], &sm.wy1[tid]);
  } else if (tid >= kThreads - kCropW) {
    const int x = tid - (kThreads - kCropW);
    int k;
    tap_weights(x, kCropW, (float)x1, (float)x2, ox, win_w, 1.0f, &k,
                &sm.wx0[x], &sm.wx1[x]);
    sm.kx[x] = k;
    const int c0 = clampi(k, 0, win_w - 1), c1 = clampi(k + 1, 0, win_w - 1);
    sm.soff[2 * x] = g.run ? (c0 - g.c_lo) * 3 : 2 * x * 3;
    sm.soff[2 * x + 1] = g.run ? (c1 - g.c_lo) * 3 : (2 * x + 1) * 3;
  }
  __syncthreads();
  CROPS_STAMP(1, clock64());
  if (warp == 0) {
    // The strip's source rows: r0 = ky, r1 = ky + 1 (clamped into the
    // window; a tap outside it weighs 0) of every output row, in the order
    // r0(0), r1(0), r0(1), ... Both grow with y and r1 <= r0 + 1, so a value
    // is new exactly when it exceeds the last one; an old r0 is the last
    // entry or the one before it, an old r1 the last.
    const unsigned lt = (1u << lane) - 1u;
    int base = 0, prev1 = -1;
    for (int y0 = 0; y0 < strip_rows; y0 += 32) {
      const int y = y0 + lane;
      const bool live = y < strip_rows;
      const int k = live ? sm.ky[y] : 0;
      const int r0 = clampi(k, 0, win_h - 1);
      const int r1 = clampi(k + 1, 0, win_h - 1);
      int p1 = __shfl_up_sync(0xffffffffu, r1, 1);
      if (lane == 0) p1 = prev1;
      const bool n0 = live && r0 > p1;
      const bool n1 = live && r1 > max(r0, p1);
      const unsigned b0 = __ballot_sync(0xffffffffu, n0);
      const unsigned b1 = __ballot_sync(0xffffffffu, n1);
      const int pre = base + __popc(b0 & lt) + __popc(b1 & lt);
      const int j0 = n0 ? pre : (r0 == p1 ? pre - 1 : pre - 2);
      const int j1 = pre + (n0 ? 1 : 0) - (n1 ? 0 : 1);  // old: the last
      if (live) {
        if (n0) sm.list[j0] = r0;
        if (n1) sm.list[j1] = r1;
        sm.i0[y] = j0;
        sm.i1[y] = j1;
      }
      base += __popc(b0) + __popc(b1);
      prev1 = __shfl_sync(0xffffffffu, r1, 31);
    }
  }

  // Each thread's fixed place, hoisted out of the loop: the float4 at lane
  // 4 * g2 of rows yy2 and yy2 + kSub / 2 of every sub-strip, its four
  // values (x, c) reading the tap columns at byte offsets offa / offb of a
  // staged row. The interleaved variant's first pass: lanes tid and
  // tid + kThreads (slot * 3 + c) of every row.
  constexpr int kPerRow = kRowFloats / 4;  // float4 stores per output row
  const int yy2 = tid / kPerRow, g2 = tid % kPerRow;
  int offa[4], offb[4];
  float wxa[4], wxb[4], ka[4], kb[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int l = 4 * g2 + e, x = l / 3, c = l - 3 * x;
    offa[e] = sm.soff[2 * x] + c;
    offb[e] = sm.soff[2 * x + 1] + c;
    wxa[e] = sm.wx0[x];
    wxb[e] = sm.wx1[x];
    ka[e] = kDense ? reid_mean(c) : inv_std(c);
    kb[e] = kDense ? reid_std(c) : mean_over_std(c);
  }
  int off1[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int l = tid + h2 * kThreads;
    off1[h2] = sm.soff[l / 3] + l % 3;
  }
  __syncthreads();
  CROPS_STAMP(2, clock64());
  constexpr int nsub = strip_rows / kSub;
  for (int q = 0; q < kStages - 1 && q < nsub; ++q)  // the first copies
    stage_rows(sm, g, q, warp, lane);
  CROPS_STAMP(3, clock64());

  // The ring: sub-strips 0 and 1 are in flight; in iteration q, once q has
  // landed and every thread is past the barrier (so done with q - 1's
  // stage), the copies of q + 2 go into that stage.
  float* o_strip = out + (long long)box * kCropH * kRowFloats
                   + (long long)y_base * kRowFloats;
  for (int q = 0; q < nsub; ++q) {
    const int st = q % kStages;
    mbar_wait(smem_u32(&sm.full[st]), (q / kStages) & 1);  // q has landed
    __syncthreads();
    CROPS_STAMP(6 + 2 * q, clock64());
    if (q + kStages - 1 < nsub) stage_rows(sm, g, q + kStages - 1, warp, lane);
    const int lo = sm.i0[q * kSub];
    const uint8_t* sbase = &sm.stage[st][0][0];

    if (kOrder == Order::kInterleaved) {
      // 1. Y pass of every tap column into bf16 rows of interleaved lanes
#pragma unroll 2
      for (int yy = 0; yy < kSub; ++yy) {
        const int y = q * kSub + yy;
        const int j0 = sm.i0[y] - lo, j1 = sm.i1[y] - lo;
        const uint8_t* ra = sbase + j0 * kPitch + sm.shift[st][j0];
        const uint8_t* rb = sbase + j1 * kPitch + sm.shift[st][j1];
        const float ya = sm.wy0[y], yb = sm.wy1[y];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          sm.inter[yy * kSlots * 3 + tid + h2 * kThreads] = to_bf16_bits(
              __fadd_rn(__fmul_rn(ya, byte_to_float(ra[off1[h2]])),
                        __fmul_rn(yb, byte_to_float(rb[off1[h2]]))));
      }
      __syncthreads();
    }

#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int yy = yy2 + h2 * (kSub / 2);
      const int y = q * kSub + yy;
      float v[4];
      if (kOrder == Order::kInterleaved) {
        // 2. X pass from the interleaved lanes
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int l = 4 * g2 + e, x = l / 3, c = l - 3 * x;
          const uint16_t* row = &sm.inter[yy * kSlots * 3 + 6 * x + c];
          const float crop =
              __fadd_rn(__fmul_rn(from_bf16_bits(row[0]), wxa[e]),
                        __fmul_rn(from_bf16_bits(row[3]), wxb[e]));
          v[e] = __fsub_rn(__fmul_rn(crop, ka[e]), kb[e]);
        }
      } else {
        // both passes in registers from the four taps of each value
        const int j0 = sm.i0[y] - lo, j1 = sm.i1[y] - lo;
        const uint8_t* ra = sbase + j0 * kPitch + sm.shift[st][j0];
        const uint8_t* rb = sbase + j1 * kPitch + sm.shift[st][j1];
        const float ya = sm.wy0[y], yb = sm.wy1[y];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p00 = byte_to_float(ra[offa[e]]);
          const float p01 = byte_to_float(ra[offb[e]]);
          const float p10 = byte_to_float(rb[offa[e]]);
          const float p11 = byte_to_float(rb[offb[e]]);
          if (kDense) {
            // X pass on both source rows, then Y
            float u0, u1;
            bf16_round2(
                __fadd_rn(__fmul_rn(wxa[e], p00), __fmul_rn(wxb[e], p01)),
                __fadd_rn(__fmul_rn(wxa[e], p10), __fmul_rn(wxb[e], p11)),
                &u0, &u1);
            const float crop =
                __fadd_rn(__fmul_rn(ya, u0), __fmul_rn(yb, u1));
            v[e] = __fdiv_rn(__fsub_rn(__fdiv_rn(crop, 255.0f), ka[e]),
                             kb[e]);
          } else {
            // Y pass at both tap columns, then X
            float t0, t1;
            bf16_round2(__fadd_rn(__fmul_rn(ya, p00), __fmul_rn(yb, p10)),
                        __fadd_rn(__fmul_rn(ya, p01), __fmul_rn(yb, p11)),
                        &t0, &t1);
            const float crop =
                __fadd_rn(__fmul_rn(t0, wxa[e]), __fmul_rn(t1, wxb[e]));
            v[e] = __fsub_rn(__fmul_rn(crop, ka[e]), kb[e]);
          }
        }
      }
      reinterpret_cast<float4*>(o_strip + (long long)y * kRowFloats)[g2] =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    CROPS_STAMP(7 + 2 * q, clock64());
  }
#ifdef CROPS_STAMPS
  __syncthreads();  // the block's end: every thread's stores issued
#endif
  CROPS_STAMP(4, clock64());
}

// Launch one instantiation over b x d boxes; returns the cudaError_t.
template <Order kOrder>
int launch_crops(const void* frames, const void* boxes, void* out, int b,
                 int d, int h, int w, int win_h, int win_w, void* stream) {
  if (b * d == 0) return 0;
  if (win_h < 1 || win_w < 1 || win_h > h || win_w > w)
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)b * d * (kCropH / strip_rows_of<kOrder>());
  crops_stage_kernel<kOrder><<<(unsigned)blocks, kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)boxes, (float*)out, d, h, w,
      win_h, win_w, (long long)b * h * w * 3);
  return (int)cudaGetLastError();
}

}  // namespace crop_stage
