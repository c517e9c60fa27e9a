// Windowed ReID crop-resample-normalize for Hopper.
//
// Replaces the TPU kernel yolo_deepsort_tpu/ops/pallas_crops.py
// (_pallas_crops_planar, kernel body `kernel`, via
// pallas_crop_and_normalize_batch). Per (frame, box) -- one thread block
// here -- it builds the bilinear Y and X weights from the box's integer
// crop bounds in ABSOLUTE frame coordinates (ops/crops.py _interp_matrix:
// half-pixel centres, coords clamped to [start, end-1], taps outside the
// (win_h, win_w) source window weigh 0, rows normalized by their weight
// sum; /255 folded into the Y weights), resamples Y then X, and applies
// the ImageNet affine, writing the (128, 64, 3) crop NHWC.
//
// Rounding points are the TPU kernel's: bf16 weights and bf16 pixels, f32
// sums, the Y-resampled row rounded to bf16 before the X-resample. Each
// output takes exactly two taps per axis (a bilinear row has at most two
// non-zero weights), and bf16 x bf16 products are exact in f32, so the
// product form written here rounds exactly like the dense matmul form of the
// plain PyTorch version (crops_kernel.py) whatever the summation order.
//
// Not carried over from the TPU: the H%8 / W%128 frame gate, the 128-aligned
// window origins and the padding of the box count to crops_per_program. The
// window origin is clip(x1, 0, w - win_w) as in crop_and_normalize_windowed.
//
// Bound on the H100: bytes written. Each box writes 128*64*3*4 = 96 KB of
// f32 crop and reads at most a (win_h, win_w, 3) uint8 window through L1/L2
// (4 taps per output pixel); the arithmetic is ~30 flops per output value.
// The design keeps the weights in shared memory (built once per block) and
// never stages the window or the Y-resampled rows in device memory.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCropH = 128;
constexpr int kCropW = 64;
constexpr int kThreads = 256;

// 1/std and mean/std of the ImageNet normalization, rounded like the
// reference package's Python-double constants
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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two-tap bilinear weights of output position `o` of `n_out`, exactly the
// f32 op sequence of _interp_matrix (Pallas `interp`): the window-relative
// first tap index and both weights (0 when the tap leaves the window).
__device__ void tap_weights(int o, int n_out, float start, float end,
                            int origin, int win, float post_scale, int* k0rel,
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
  *w0 = bf16_round(a0 / s / post_scale);
  *w1 = bf16_round(a1 / s / post_scale);
}

__global__ void __launch_bounds__(kThreads)
crops_kernel(const uint8_t* __restrict__ frames,
             const float* __restrict__ boxes, float* __restrict__ out, int d,
             int h, int w, int win_h, int win_w) {
  __shared__ int ky[kCropH];
  __shared__ float wy0[kCropH], wy1[kCropH];
  __shared__ int kx[kCropW];
  __shared__ float wx0[kCropW], wx1[kCropW];

  const int box = blockIdx.x;  // flat (frame, box)
  const int bi = box / d;
  const float* bx = boxes + (long long)box * 4;
  // crop_window_bounds: truncate to int, clip, at least one pixel
  int x1 = min(max((int)bx[0], 0), w - 1);
  int y1 = min(max((int)bx[1], 0), h - 1);
  int x2 = min(max((int)bx[2], x1 + 1), w);
  int y2 = min(max((int)bx[3], y1 + 1), h);
  int oy = min(max(y1, 0), h - win_h);
  int ox = min(max(x1, 0), w - win_w);

  for (int i = threadIdx.x; i < kCropH + kCropW; i += blockDim.x) {
    if (i < kCropH) {
      tap_weights(i, kCropH, (float)y1, (float)y2, oy, win_h, 255.0f, &ky[i],
                  &wy0[i], &wy1[i]);
    } else {
      int j = i - kCropH;
      tap_weights(j, kCropW, (float)x1, (float)x2, ox, win_w, 1.0f, &kx[j],
                  &wx0[j], &wx1[j]);
    }
  }
  __syncthreads();

  const uint8_t* f = frames + (long long)bi * h * w * 3;
  float* o = out + (long long)box * kCropH * kCropW * 3;
  for (int p = threadIdx.x; p < kCropH * kCropW; p += blockDim.x) {
    int y = p / kCropW, x = p % kCropW;
    int ry = ky[y], rx = kx[x];
    float a0 = wy0[y], a1 = wy1[y], b0 = wx0[x], b1 = wx1[x];
    // absolute frame rows/cols of the taps (clamped reads; a tap outside
    // the window has weight 0 and never contributes)
    int r0 = min(max(oy + ry, 0), h - 1), r1 = min(max(oy + ry + 1, 0), h - 1);
    int c0 = min(max(ox + rx, 0), w - 1), c1 = min(max(ox + rx + 1, 0), w - 1);
    const uint8_t* p00 = f + ((long long)r0 * w + c0) * 3;
    const uint8_t* p01 = f + ((long long)r0 * w + c1) * 3;
    const uint8_t* p10 = f + ((long long)r1 * w + c0) * 3;
    const uint8_t* p11 = f + ((long long)r1 * w + c1) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // Y-resample at source columns c0 and c1, rounded to bf16
      float row0 = bf16_round(__fadd_rn(__fmul_rn(a0, (float)p00[c]),
                                        __fmul_rn(a1, (float)p10[c])));
      float row1 = bf16_round(__fadd_rn(__fmul_rn(a0, (float)p01[c]),
                                        __fmul_rn(a1, (float)p11[c])));
      // X-resample, f32 sum
      float crop = __fadd_rn(__fmul_rn(row0, b0), __fmul_rn(row1, b1));
      o[(long long)p * 3 + c] =
          __fsub_rn(__fmul_rn(crop, inv_std(c)), mean_over_std(c));
    }
  }
}

// ---------------------------------------------------------------------------
// The interleaved-RGB variant (kernel 6). Replaces the TPU kernel
// yolo_deepsort_tpu/ops/pallas_crops.py _pallas_crops_interleaved (kernel
// body `kernel`). Same function and the same rounding points as the kernel
// above, so the two are equal bit for bit; what defines the variant is that
// the box's source window is STAGED: its rows are contiguous runs of
// interleaved RGB bytes in the (B, H, W*3) frame, copied into shared memory
// with 16-byte asynchronous copies (cp.async), then resampled in Y into bf16
// rows held in shared memory, then in X on the interleaved lanes, writing the
// NHWC crop with coalesced stores. The TPU kernel's channel-blocked
// (ww*3, 64*3) X weight matrix, which feeds its matrix unit, is not carried
// over: a bilinear row has two taps that are not zero, and only those are
// read.
//
// A (320, 192) window is 184,320 bytes, so a block works in strips of
// `rows_out` output rows: it stages only the source rows the strip's taps
// touch and, of each row, the columns between the first and the last X tap.
// A strip whose rows span more than the staging buffer holds (a box taller
// than the window: a masked row of the serving path) is cut shorter; one
// output row needs two source rows, which always fit. Global addresses are
// aligned down to 16 bytes, each row keeps its own shift; a 16-byte chunk
// that would leave the frame buffer is copied byte by byte.
//
// Bound on the H100 by the f32 crop bytes written, as the kernel above.

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads)
crops_interleaved_kernel(const uint8_t* __restrict__ frames,
                         const float* __restrict__ boxes,
                         float* __restrict__ out, int d, int h, int w,
                         int win_h, int win_w, int rows_out, int cap_rows,
                         int pitch, long long total_bytes) {
  __shared__ int ky[kCropH];
  __shared__ float wy0[kCropH], wy1[kCropH];
  __shared__ int kx[kCropW];
  __shared__ float wx0[kCropW], wx1[kCropW];
  extern __shared__ __align__(16) unsigned char dyn[];
  // staged rows | Y-resampled bf16 rows | per-row byte shift
  const int lanes_max = win_w * 3;
  uint8_t* stage = dyn;
  __nv_bfloat16* yrow =
      reinterpret_cast<__nv_bfloat16*>(dyn + (size_t)cap_rows * pitch);
  int* rsh = reinterpret_cast<int*>(
      dyn + (size_t)cap_rows * pitch
      + (((size_t)rows_out * lanes_max * 2 + 15) / 16) * 16);

  const int box = blockIdx.x;  // flat (frame, box)
  const int bi = box / d;
  const float* bx = boxes + (long long)box * 4;
  int x1 = min(max((int)bx[0], 0), w - 1);
  int y1 = min(max((int)bx[1], 0), h - 1);
  int x2 = min(max((int)bx[2], x1 + 1), w);
  int y2 = min(max((int)bx[3], y1 + 1), h);
  int oy = min(max(y1, 0), h - win_h);
  int ox = min(max(x1, 0), w - win_w);

  for (int i = threadIdx.x; i < kCropH + kCropW; i += blockDim.x) {
    if (i < kCropH) {
      tap_weights(i, kCropH, (float)y1, (float)y2, oy, win_h, 255.0f, &ky[i],
                  &wy0[i], &wy1[i]);
    } else {
      int j = i - kCropH;
      tap_weights(j, kCropW, (float)x1, (float)x2, ox, win_w, 1.0f, &kx[j],
                  &wx0[j], &wx1[j]);
    }
  }
  __syncthreads();

  // the staged columns: first to last X tap (the taps grow with x); a tap
  // outside the window weighs 0 and reads the nearest staged value instead
  const int c_lo = clampi(kx[0], 0, win_w - 1);
  const int c_hi = clampi(kx[kCropW - 1] + 1, 0, win_w - 1);
  const int nl = (c_hi - c_lo + 1) * 3;  // staged interleaved lanes
  const int cpr = pitch / 16;            // 16-byte chunks per staged row
  const uint8_t* frames_end = frames + total_bytes;
  float* o = out + (long long)box * kCropH * kCropW * 3;

  int y = 0;
  while (y < kCropH) {
    int n = min(rows_out, kCropH - y);
    const int r_lo = clampi(ky[y], 0, win_h - 1);
    int r_hi = clampi(ky[y + n - 1] + 1, 0, win_h - 1);
    while (n > 1 && r_hi - r_lo + 1 > cap_rows) {
      --n;
      r_hi = clampi(ky[y + n - 1] + 1, 0, win_h - 1);
    }
    const int nrows = r_hi - r_lo + 1;

    // 1. stage the rows' byte runs
    for (int i = threadIdx.x; i < nrows * cpr; i += blockDim.x) {
      const int rr = i / cpr, j = i - rr * cpr;
      const uint8_t* p =
          frames + (((long long)bi * h + oy + r_lo + rr) * w + ox + c_lo) * 3;
      const int sh = (int)((uintptr_t)p & 15);
      if (j == 0) rsh[rr] = sh;
      if (j * 16 < sh + nl) {
        const uint8_t* src = p - sh + j * 16;
        uint8_t* dst = stage + (size_t)rr * pitch + j * 16;
        if (src >= frames && src + 16 <= frames_end) {
          __pipeline_memcpy_async(dst, src, 16);
        } else {
          for (int b = 0; b < 16; ++b)
            dst[b] = (src + b >= frames && src + b < frames_end) ? src[b]
                                                                 : (uint8_t)0;
        }
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    // 2. Y-resample the staged lanes into bf16 rows
    for (int i = threadIdx.x; i < n * nl; i += blockDim.x) {
      const int yy = i / nl, l = i - yy * nl;
      const int ry = ky[y + yy];
      const int r0 = clampi(ry, 0, win_h - 1) - r_lo;
      const int r1 = clampi(ry + 1, 0, win_h - 1) - r_lo;
      const float p0 = (float)stage[(size_t)r0 * pitch + rsh[r0] + l];
      const float p1 = (float)stage[(size_t)r1 * pitch + rsh[r1] + l];
      yrow[yy * lanes_max + l] = __float2bfloat16_rn(__fadd_rn(
          __fmul_rn(wy0[y + yy], p0), __fmul_rn(wy1[y + yy], p1)));
    }
    __syncthreads();

    // 3. X-resample on the interleaved lanes, ImageNet affine, NHWC store
    for (int i = threadIdx.x; i < n * kCropW * 3; i += blockDim.x) {
      const int yy = i / (kCropW * 3), q = i - yy * (kCropW * 3);
      const int x = q / 3, c = q - x * 3;
      const int j0 = clampi(kx[x], 0, win_w - 1) - c_lo;
      const int j1 = clampi(kx[x] + 1, 0, win_w - 1) - c_lo;
      const float row0 = __bfloat162float(yrow[yy * lanes_max + j0 * 3 + c]);
      const float row1 = __bfloat162float(yrow[yy * lanes_max + j1 * 3 + c]);
      const float crop =
          __fadd_rn(__fmul_rn(row0, wx0[x]), __fmul_rn(row1, wx1[x]));
      o[(long long)(y + yy) * kCropW * 3 + q] =
          __fsub_rn(__fmul_rn(crop, inv_std(c)), mean_over_std(c));
    }
    __syncthreads();  // the next strip overwrites both buffers
    y += n;
  }
}

}  // namespace

extern "C" int ydt_crops(const void* frames, const void* boxes, void* out,
                         int b, int d, int h, int w, int win_h, int win_w,
                         void* stream) {
  if (b * d == 0) return 0;
  crops_kernel<<<b * d, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)boxes, (float*)out, d, h, w, win_h,
      win_w);
  return (int)cudaGetLastError();
}

// The interleaved variant: same arguments and result. Strips of 8 output
// rows where the staging buffers fit 48 KB of shared memory, fewer otherwise.
extern "C" int ydt_crops_interleaved(const void* frames, const void* boxes,
                                     void* out, int b, int d, int h, int w,
                                     int win_h, int win_w, void* stream) {
  if (b * d == 0) return 0;
  const int pitch = ((win_w * 3 + 15 + 15) / 16) * 16;
  int rows_out = 8, cap_rows = 0;
  size_t smem = 0;
  for (;; rows_out /= 2) {
    cap_rows = (rows_out * win_h + kCropH - 1) / kCropH + 2;
    if (rows_out == 1) cap_rows = 2;
    smem = (size_t)cap_rows * pitch
           + (((size_t)rows_out * win_w * 3 * 2 + 15) / 16) * 16
           + (size_t)cap_rows * sizeof(int);
    if (smem <= 40 * 1024 || rows_out == 1) break;
  }
  if (smem > 40 * 1024) return (int)cudaErrorInvalidValue;
  crops_interleaved_kernel<<<b * d, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)boxes, (float*)out, d, h, w, win_h,
      win_w, rows_out, cap_rows, pitch, (long long)b * h * w * 3);
  return (int)cudaGetLastError();
}
