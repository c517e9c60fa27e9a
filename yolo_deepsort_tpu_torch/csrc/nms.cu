// Class-aware batched NMS with weighted-box merging, and the Malisiewicz ROI
// NMS of the facades, for Hopper.
//
// Replaces no Pallas kernel: the reference leaves both to XLA inside its
// jitted stages (yolo_deepsort_tpu/ops/nms.py `_nms_single`, a lax.top_k and
// a lax.while_loop, vmapped over images; `roi_nms_mask`, a lax.fori_loop).
// The port's plain versions (ops/nms.py `batched_nms_with_stats_plain`,
// `roi_nms_mask_plain`) are a host loop of ~10 launches a greedy step; here
// each function is one C entry.
//
// ydt_nms, two launches:
//  A. nms_keys_kernel, grid (row tiles, images): one warp a row reads the
//     (5 + C)-wide row once, coalesced, takes obj and the class max with its
//     first index (torch's max / argmax: NaN above every number, ties to the
//     lower class), and writes one 64-bit key -- the score's order-preserving
//     bits high, ~row low -- and each tile's count of rows over the image's
//     threshold. Descending keys are torch.sort(descending, stable) order:
//     NaN first, then by score, ties to the lower row.
//  B. nms_select_kernel, one block of 1024 threads an image: radix-selects
//     the k-th largest key (8-bit digits, most significant first, stopping
//     at the digit that settles it), compacts the k winners into shared
//     memory and bitonic-sorts them, gathers their rows (boxes to xyxy, obj,
//     class max and index again), then runs the greedy loop on shared
//     memory: a block-wide "first alive" reduction, one IoU a thread against
//     the top row only (no K x K matrix), and a block reduction of the five
//     merge sums. The loop stops when nothing is alive, as the reference's
//     while_loop does; the rows after it are zero with the mask false.
//
// Bound on the H100: bytes. A reads pred once (N x B x (5 + C) x 4 bytes,
// 115.8 MB at 32 x 10647 x 85); every other access is to the keys (8 bytes a
// row, L2-resident) or to the k winners' rows. The greedy loop is a latency
// chain of two barriers a step.
//
// Exactness: the keep set, its order, the mask, the saturation counters and
// the obj / cls_conf / cls columns equal the plain version's bit for bit:
// the IoU is ops/boxes.py iou_xyxy's expression in its order (eps 1e-16,
// NaN-propagating max / min / clamp as torch's), built with --fmad=false.
// Only the merge sums run in another order. Every one of the k rows takes
// part in them with weight 0 unless suppressed, as in the plain version, so
// a non-finite box anywhere in the top k turns the merge NaN there too.
//
// ydt_roi_nms: one block of up to 1024 threads. Each masked box takes its
// rank in stable (-score, index) order (torch.argsort of the plain version:
// NaN last); then a sequential loop over the ranks, one barrier a step: a
// kept box removes the later masked boxes it overlaps by more than
// max_overlap, the overlap computed as written there (+1 extents, divided by
// the candidate's own area).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmpty = 0x7fffffff;  // no class column seen yet
constexpr int kKeyThreads = 256;    // launch A: 8 warps
constexpr int kRowsPerTile = 64;    // launch A: rows of one block
constexpr int kSelectThreads = 1024;  // launch B: one block an image
constexpr int kMaxK = 1024;         // candidates one block holds
constexpr int kMaxRoi = 1024;

// Order-preserving code of a float: a larger float gets a larger code; -0
// and +0 share one; every NaN gets the largest (above +inf).
__device__ __forceinline__ unsigned ordered_bits(float f) {
  if (f != f) return 0xffffffffu;
  if (f == 0.0f) return 0x80000000u;
  unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long sort_key(float score, int row) {
  return ((unsigned long long)ordered_bits(score) << 32) | (unsigned)(~row);
}

// (a, ia) ranks above (b, ib) in torch's max / argmax order: NaN above every
// number (the lower index among NaNs), else the larger value, ties to the
// lower index; an empty slot ranks below everything.
__device__ __forceinline__ bool ranks_above(float a, int ia, float b, int ib) {
  if (ib == kEmpty) return ia != kEmpty;
  if (ia == kEmpty) return false;
  bool an = a != a, bn = b != b;
  if (an != bn) return an;
  if (!an && a != b) return a > b;
  return ia < ib;
}

// torch.maximum / torch.minimum / clamp(min=0): a NaN operand gives NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float clamp0(float x) { return x < 0.0f ? 0.0f : x; }

struct Row {
  float head[5];  // cx, cy, w, h, obj
  float conf;     // class max
  int cls;        // its first index
};

// One warp reads one (5 + C)-wide row; every lane gets the result.
__device__ __forceinline__ Row scan_row(const float* __restrict__ row,
                                        int ncols, int lane) {
  float best = 0.0f, head = 0.0f;
  int bi = kEmpty;
  for (int col = lane; col < ncols; col += 32) {
    float v = row[col];
    if (col < 5) head = v;
    else if (ranks_above(v, col - 5, best, bi)) {
      best = v;
      bi = col - 5;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(kFull, best, off);
    int oi = __shfl_xor_sync(kFull, bi, off);
    if (ranks_above(ov, oi, best, bi)) {
      best = ov;
      bi = oi;
    }
  }
  Row r;
#pragma unroll
  for (int c = 0; c < 5; ++c) r.head[c] = __shfl_sync(kFull, head, c);
  r.conf = best;
  r.cls = bi;
  return r;
}

__global__ void __launch_bounds__(kKeyThreads)
nms_keys_kernel(const float* __restrict__ pred, const float* __restrict__ thr,
                float thr_scalar, unsigned long long* __restrict__ keys,
                int* __restrict__ tile_valid, int nb, int ncols) {
  const int n = blockIdx.y, tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float t = thr != nullptr ? thr[n] : thr_scalar;
  const int end = min((tile + 1) * kRowsPerTile, nb);
  int valid = 0;
  for (int r = tile * kRowsPerTile + warp; r < end; r += kKeyThreads / 32) {
    Row row = scan_row(pred + ((long long)n * nb + r) * ncols, ncols, lane);
    float obj = row.head[4];
    bool ok = obj >= t;
    float score = ok ? obj * row.conf : -1.0f;
    if (lane == 0) keys[(long long)n * nb + r] = sort_key(score, r);
    valid += ok;
  }
  __shared__ int s_valid[kKeyThreads / 32];
  if (lane == 0) s_valid[warp] = valid;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kKeyThreads / 32; ++w) sum += s_valid[w];
    tile_valid[n * gridDim.x + tile] = sum;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kSelectThreads)
nms_select_kernel(const float* __restrict__ pred,
                  const unsigned long long* __restrict__ keys,
                  const int* __restrict__ tile_valid, int ntiles,
                  float* __restrict__ dets, uint8_t* __restrict__ mask,
                  int* __restrict__ sat, int nb, int ncols, int k,
                  int max_dets, float nms_thres) {
  __shared__ unsigned long long s_key[kMaxK];
  __shared__ float s_x1[kMaxK], s_y1[kMaxK], s_x2[kMaxK], s_y2[kMaxK];
  __shared__ float s_obj[kMaxK], s_conf[kMaxK], s_cls[kMaxK];
  __shared__ unsigned s_hist[256];
  __shared__ int s_first[kSelectThreads / 32];
  __shared__ float s_part[kSelectThreads / 32][5];
  __shared__ int s_nvalid, s_count, s_digit, s_rem, s_exact;

  const int n = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned long long* ikeys = keys + (long long)n * nb;

  if (tid == 0) {
    s_nvalid = 0;
    s_count = 0;
  }
  __syncthreads();
  int part = 0;
  for (int t = tid; t < ntiles; t += kSelectThreads)
    part += tile_valid[n * ntiles + t];
  if (part) atomicAdd(&s_nvalid, part);

  // radix select of the k-th largest key: the winners are the keys whose
  // bits from `cut` up are at least the prefix's (all of them when k == nb)
  unsigned long long prefix = 0, pmask = 0;
  int cut = 0, rem = k;
  const bool take_all = k >= nb;
  if (!take_all) {
    for (int shift = 56; shift >= 0; shift -= 8) {
      if (tid < 256) s_hist[tid] = 0;
      __syncthreads();
      for (int base = 0; base < nb; base += kSelectThreads) {
        int i = base + tid;
        bool in = false;
        unsigned d = 0;
        if (i < nb) {
          unsigned long long key = ikeys[i];
          in = (key & pmask) == prefix;
          d = (unsigned)(key >> shift) & 255u;
        }
        unsigned active = __ballot_sync(kFull, in);
        if (in) {
          unsigned peers = __match_any_sync(active, d);
          if (lane == __ffs(peers) - 1) atomicAdd(&s_hist[d], __popc(peers));
        }
      }
      __syncthreads();
      if (warp == 0) {
        // lane l holds bins 255 - 8l down to 248 - 8l: an exclusive scan
        // over lanes counts the keys in higher bins
        unsigned c[8], sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          c[j] = s_hist[255 - 8 * lane - j];
          sum += c[j];
        }
        unsigned incl = sum;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          unsigned o = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += o;
        }
        unsigned before = incl - sum;
        if (before < (unsigned)rem && (unsigned)rem <= incl) {
          for (int j = 0; j < 8; ++j) {
            if ((unsigned)rem <= before + c[j]) {
              s_digit = 255 - 8 * lane - j;
              s_rem = rem - (int)before;
              s_exact = before + c[j] == (unsigned)rem;
              break;
            }
            before += c[j];
          }
        }
      }
      __syncthreads();
      prefix |= (unsigned long long)s_digit << shift;
      pmask |= 0xffULL << shift;
      rem = s_rem;
      cut = shift;
      if (s_exact) break;  // every key of the digit's bin is a winner
    }
  }

  // compact the k winners into shared memory, in no order
  for (int base = 0; base < nb; base += kSelectThreads) {
    int i = base + tid;
    bool win = false;
    unsigned long long key = 0;
    if (i < nb) {
      key = ikeys[i];
      win = take_all || (key >> cut) >= (prefix >> cut);
    }
    unsigned ballot = __ballot_sync(kFull, win);
    int slot = 0;
    if (lane == 0 && ballot) slot = atomicAdd(&s_count, __popc(ballot));
    slot = __shfl_sync(kFull, slot, 0);
    if (win) s_key[slot + __popc(ballot & ((1u << lane) - 1u))] = key;
  }
  int p2 = 1;
  while (p2 < k) p2 <<= 1;
  __syncthreads();
  for (int i = k + tid; i < p2; i += kSelectThreads) s_key[i] = 0;  // below any key

  // bitonic sort, descending
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      int i = tid, j = tid ^ stride;
      if (i < p2 && j > i) {
        unsigned long long a = s_key[i], b = s_key[j];
        bool desc = (i & size) == 0;
        if (desc ? a < b : a > b) {
          s_key[i] = b;
          s_key[j] = a;
        }
      }
    }
  }
  __syncthreads();

  // gather the winners' rows, a warp a row
  for (int p = warp; p < k; p += kSelectThreads / 32) {
    int r = (int)(~(unsigned)s_key[p]);
    Row row = scan_row(pred + ((long long)n * nb + r) * ncols, ncols, lane);
    if (lane == 0) {
      float cx = row.head[0], cy = row.head[1], w = row.head[2],
            h = row.head[3];
      s_x1[p] = cx - w / 2.0f;
      s_y1[p] = cy - h / 2.0f;
      s_x2[p] = cx + w / 2.0f;
      s_y2[p] = cy + h / 2.0f;
      s_obj[p] = row.head[4];
      s_conf[p] = row.conf;
      s_cls[p] = (float)row.cls;
    }
  }
  __syncthreads();

  // thread j holds sorted candidate j; alive = its score > 0 (not NaN)
  const int j = tid;
  bool alive = false;
  float x1 = 0.0f, y1 = 0.0f, x2 = 0.0f, y2 = 0.0f, ob = 0.0f, cl = 0.0f;
  if (j < k) {
    unsigned hi = (unsigned)(s_key[j] >> 32);
    alive = hi > 0x80000000u && hi != 0xffffffffu;
    x1 = s_x1[j];
    y1 = s_y1[j];
    x2 = s_x2[j];
    y2 = s_y2[j];
    ob = s_obj[j];
    cl = s_cls[j];
  }
  const float area_b = (x2 - x1) * (y2 - y1);
  float* out = dets + (long long)n * max_dets * 7;
  int i = 0;
  for (; i < max_dets; ++i) {
    unsigned b = __ballot_sync(kFull, alive);
    if (lane == 0) s_first[warp] = b ? warp * 32 + __ffs(b) - 1 : kEmpty;
    __syncthreads();
    int top = kEmpty;
#pragma unroll
    for (int w = 0; w < kSelectThreads / 32; ++w) top = min(top, s_first[w]);
    if (top == kEmpty) break;  // the same for every thread
    bool inv = false;
    if (alive && cl == s_cls[top]) {
      float tx1 = s_x1[top], ty1 = s_y1[top], tx2 = s_x2[top],
            ty2 = s_y2[top];
      float ix1 = max_nan(tx1, x1), iy1 = max_nan(ty1, y1);
      float ix2 = min_nan(tx2, x2), iy2 = min_nan(ty2, y2);
      float inter = clamp0(ix2 - ix1) * clamp0(iy2 - iy1);
      float area_a = (tx2 - tx1) * (ty2 - ty1);
      float iou = inter / (area_a + area_b - inter + 1e-16f);
      inv = iou > nms_thres;
    }
    float wgt = inv ? ob : 0.0f;
    float v[5] = {wgt, wgt * x1, wgt * y1, wgt * x2, wgt * y2};
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      v[c] = warp_sum(v[c]);
      if (lane == 0) s_part[warp][c] = v[c];
    }
    __syncthreads();
    if (warp == 0) {
      float a[5];
#pragma unroll
      for (int c = 0; c < 5; ++c) a[c] = warp_sum(s_part[lane][c]);
      if (lane == 0) {
        float den = a[0] < 1e-20f ? 1e-20f : a[0];  // NaN stays NaN
        float* o = out + (long long)i * 7;
        o[0] = a[1] / den;
        o[1] = a[2] / den;
        o[2] = a[3] / den;
        o[3] = a[4] / den;
        o[4] = s_obj[top];
        o[5] = s_conf[top];
        o[6] = s_cls[top];
        mask[(long long)n * max_dets + i] = 1;
      }
    }
    alive = alive && !inv;
  }
  const int leftover = __syncthreads_count(alive);
  for (int e = i * 7 + tid; e < max_dets * 7; e += kSelectThreads) out[e] = 0.0f;
  for (int e = i + tid; e < max_dets; e += kSelectThreads)
    mask[(long long)n * max_dets + e] = 0;
  if (tid == 0) {
    sat[2 * n] = max(s_nvalid - k, 0);
    sat[2 * n + 1] = leftover;
  }
}

__global__ void __launch_bounds__(kMaxRoi)
roi_nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
               const uint8_t* __restrict__ mask, uint8_t* __restrict__ keep,
               int d, float max_overlap) {
  __shared__ float s_x1[kMaxRoi], s_y1[kMaxRoi], s_x2[kMaxRoi], s_y2[kMaxRoi];
  __shared__ unsigned long long s_key[kMaxRoi];
  __shared__ int s_order[kMaxRoi];
  __shared__ uint8_t s_keep[kMaxRoi];
  const int i = threadIdx.x;
  bool m = false;
  float x1 = 0.0f, y1 = 0.0f, x2 = 0.0f, y2 = 0.0f, area = 1.0f;
  if (i < d) {
    x1 = boxes[4 * i];
    y1 = boxes[4 * i + 1];
    x2 = boxes[4 * i + 2] + boxes[4 * i];
    y2 = boxes[4 * i + 3] + boxes[4 * i + 1];
    area = (x2 - x1 + 1.0f) * (y2 - y1 + 1.0f);
    m = mask[i] != 0;
    s_x1[i] = x1;
    s_y1[i] = y1;
    s_x2[i] = x2;
    s_y2[i] = y2;
    s_keep[i] = m;
    // ascending (-score, index), NaN last; unmasked boxes are never ranked
    s_key[i] = m ? (((unsigned long long)ordered_bits(-scores[i]) << 32)
                    | (unsigned)i)
                 : ~0ULL;
  }
  __syncthreads();
  int rank = 0;
  if (m) {
    const unsigned long long mine = s_key[i];
    for (int j = 0; j < d; ++j) rank += s_key[j] < mine;
    s_order[rank] = i;
  }
  const int count = __syncthreads_count(m);
  for (int p = 0; p < count; ++p) {
    const int top = s_order[p];
    if (s_keep[top] && m && rank > p) {
      float w = clamp0(min_nan(s_x2[top], x2) - max_nan(s_x1[top], x1) + 1.0f);
      float h = clamp0(min_nan(s_y2[top], y2) - max_nan(s_y1[top], y1) + 1.0f);
      if ((w * h) / area > max_overlap) s_keep[i] = 0;
    }
    __syncthreads();
  }
  if (i < d) keep[i] = s_keep[i];
}

}  // namespace

extern "C" int ydt_nms(const void* pred, const void* thr, float thr_scalar,
                       void* keys, void* tile_valid, void* dets, void* mask,
                       void* sat, int n, int nb, int ncols, int k,
                       int max_dets, float nms_thres, void* stream) {
  if (n < 1 || n > 65535 || nb < 1 || ncols < 6 || k < 1 || k > kMaxK ||
      k > nb || max_dets < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ntiles = (nb + kRowsPerTile - 1) / kRowsPerTile;
  nms_keys_kernel<<<dim3(ntiles, n), kKeyThreads, 0, s>>>(
      (const float*)pred, (const float*)thr, thr_scalar,
      (unsigned long long*)keys, (int*)tile_valid, nb, ncols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_select_kernel<<<n, kSelectThreads, 0, s>>>(
      (const float*)pred, (const unsigned long long*)keys,
      (const int*)tile_valid, ntiles, (float*)dets, (uint8_t*)mask,
      (int*)sat, nb, ncols, k, max_dets, nms_thres);
  return (int)cudaGetLastError();
}

extern "C" int ydt_roi_nms(const void* boxes, const void* scores,
                           const void* mask, void* keep, int d,
                           float max_overlap, void* stream) {
  if (d < 1 || d > kMaxRoi) return (int)cudaErrorInvalidValue;
  const int threads = (d + 31) / 32 * 32;
  roi_nms_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (const float*)boxes, (const float*)scores, (const uint8_t*)mask,
      (uint8_t*)keep, d, max_overlap);
  return (int)cudaGetLastError();
}
