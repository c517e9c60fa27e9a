// Fused DeepSORT tracker step for Hopper: one block of 256 threads per
// stream.
//
// Replaces the TPU kernel yolo_deepsort_tpu/tracking/tracker_pallas.py
// (_tracker_kernel, via _kernel_batched and tracker_step_fused_batched).
// Per stream, in one launch for all streams:
//   prologue (the reference's framework side before its kernel): detections
//   to xyah, the min_confidence mask, cascade levels, the two stable
//   level-major orders and the active-row counts ->
//   KF predict (F P F^T + Q) -> project + unrolled 4x4 Cholesky ->
//   Mahalanobis gate at chi2_4 = 9.4877 -> stage A: gated-cosine JV cascade
//   in level order -> stage B: IoU JV over tentative and once-missed rows,
//   stage A's real columns vetoed -> KF update of matched rows ->
//   lifecycle -> new-id allocation by rank pairing -> next_id.
// The appearance einsum against the gallery, the gallery scatter and the
// emitted rows stay in PyTorch (tracking/tracker_kernel.py), as the first
// two stayed in XLA.
//
// Bound on the H100: latency. The two JV sweeps are chains of dependent
// steps, (rows + Dijkstra steps) x one warp step; the rest is ~100 KFLOP a
// stream. The design keeps everything around the chains off them:
//   * the inputs (appearance costs, detections, the state's int fields and
//     means) arrive in shared memory by cp.async; each track's covariance
//     comes straight from device memory into its thread's registers;
//   * the prologue builds levels, both stable orders (one exact-rank pass)
//     and the counts on the block;
//   * thread t predicts, projects and factors track t and leaves the
//     predicted mean and covariance, S and its Cholesky factor in shared
//     memory (the covariance at a stride of 65 floats: no bank conflicts),
//     so no register holds them across the solves;
//   * the stage-A costs (gated cosine + Mahalanobis) are spread over the
//     (track, detection) pairs of all threads, consecutive threads on
//     consecutive detections, into a shared-memory block; a row that is not
//     confirmed costs kBig without its distances;
//   * warp-specialised: warp 0 solves stage A (jv_stage.cuh, no block
//     barrier inside) while warps 1-7 build stage B's IoU block, which does
//     not depend on A (A enters B only as the column veto); one barrier,
//     then warp 0 solves stage B;
//   * KF update, lifecycle and the rank-paired id allocation stay
//     block-parallel; the outputs leave in 16-byte stores.
// Where the three (T, D) blocks do not fit in shared memory (T = D = 256),
// the appearance costs are read from device memory and the two stage
// blocks go to a device scratch; the same code reads them there. The TPU
// grid was sequential over streams; here streams are independent blocks,
// and the TPU's padding rules are dropped.
//
// Rounding: built with --fmad=false (see kernels/build.py); KF, Cholesky,
// xyah and IoU expressions keep the plain version's operation order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "jv_stage.cuh"

namespace {

using ydt::Carve;
using ydt::round16;

constexpr int kThreads = 256;
constexpr int kFree = 0, kTentative = 1, kConfirmed = 2;
constexpr float kChi2 = 9.4877f;
constexpr float kSP = (float)(1.0 / 20);   // kalman _STD_W_POS
constexpr float kSV = (float)(1.0 / 160);  // kalman _STD_W_VEL
constexpr float kSP2 = (float)(2 * (1.0 / 20));
constexpr float kSV10 = (float)(10 * (1.0 / 160));
constexpr float kHFloor = 1e-2f;
constexpr float kQ2 = (float)(1e-2 * 1e-2);   // (1e-2)**2
constexpr float kQ6 = (float)(1e-5 * 1e-5);   // (1e-5)**2
constexpr float kR2 = (float)(1e-1 * 1e-1);   // (1e-1)**2
constexpr int kTrk = 32;  // floats per track in shared memory (see below)
// a track's predicted covariance in shared memory: 64 floats at a stride
// of 65, so that the threads of a warp (one track each) hit distinct banks
constexpr int kCovStride = 65;

__device__ __forceinline__ float gsqrt(float x) {
  return sqrtf(fmaxf(x, 1e-20f));
}

// a / b, rounded to nearest as the plain version divides, for a finite b.
// A zero numerator (off-diagonal covariances of a new track, boxes that do
// not overlap) takes a multiply, which gives the same signed zero, instead
// of the division's slow path: that path cost the KF update half its time.
__device__ __forceinline__ float div_rn(float a, float b) {
  float q;
  if (a == 0.0f)
    q = a * b;
  else
    q = a / b;
  return q;
}

// Shared-memory bytes of one stream; must match the kernel's carving.
__host__ __device__ inline size_t smem_bytes(int t, int d, bool staged) {
  const size_t T = t, D = d, NC = T + D;
  size_t b = staged ? 3 * round16(T * D * 4) : 0;  // app, stage A, B
  b += round16(D * 16) * 2 + round16(D * 4) + round16(D);  // dets, mask
  b += 5 * round16(T * 4) + round16(T * 32) + round16(T * kTrk * 4);
  b += 2 * round16(T);                                    // row flags
  b += 6 * round16(T * 4) + 2 * round16(NC * 4);          // JV
  b += 2 * round16(T * 4) + 2 * round16(D * 4);           // match, scans
  b += round16(T * kCovStride * 4);                       // predicted cov
  return b;
}

// Inclusive prefix sum of buf[0..n) in place (n <= blockDim.x).
__device__ void block_inclusive_scan(int* buf, int n) {
  for (int off = 1; off < n; off <<= 1) {
    int add = 0;
    if (threadIdx.x < n && threadIdx.x >= off) add = buf[threadIdx.x - off];
    __syncthreads();
    if (threadIdx.x < n) buf[threadIdx.x] += add;
    __syncthreads();
  }
}

__device__ __forceinline__ void load_cov(const float* p, float cov[64]) {
  if (((uintptr_t)p & 15) == 0) {
    const float4* p4 = (const float4*)p;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float4 q = p4[i];
      cov[4 * i] = q.x;
      cov[4 * i + 1] = q.y;
      cov[4 * i + 2] = q.z;
      cov[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) cov[i] = p[i];
  }
}

// KF predict of one track (inactive tracks keep their state); Q uses the
// pre-step height.
__device__ __forceinline__ void kf_predict(const float mean[8],
                                           const float cov[64], bool active,
                                           float mean_p[8], float cov_p[64]) {
  const float h_q = fmaxf(mean[3], kHFloor);
  const float qp = kSP * h_q, qv = kSV * h_q;
  const float q[8] = {qp * qp, qp * qp, kQ2, qp * qp,
                      qv * qv, qv * qv, kQ6, qv * qv};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int l = 8 * i + j;
      float v = cov[l];
      v = v + (j < 4 ? cov[l + 4] : 0.0f);
      v = v + (i < 4 ? cov[l + 32] : 0.0f);
      v = v + ((i < 4 && j < 4) ? cov[l + 36] : 0.0f);
      if (i == j) v = v + q[i];
      cov_p[l] = active ? v : cov[l];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mean_p[i] = active ? mean[i] + mean[i + 4] : mean[i];
    mean_p[i + 4] = mean[i + 4];
  }
}

// Solve L L^T x = b (_cho_solve4); L = (l00, l10, l20, l30, l11, l21, l31,
// l22, l32, l33).
__device__ __forceinline__ void cho_solve4(const float* L, const float b[4],
                                           float x[4]) {
  const float l00 = L[0], l10 = L[1], l20 = L[2], l30 = L[3], l11 = L[4],
              l21 = L[5], l31 = L[6], l22 = L[7], l32 = L[8], l33 = L[9];
  float y0 = div_rn(b[0], l00);
  float y1 = div_rn(b[1] - l10 * y0, l11);
  float y2 = div_rn(b[2] - l20 * y0 - l21 * y1, l22);
  float y3 = div_rn(b[3] - l30 * y0 - l31 * y1 - l32 * y2, l33);
  x[3] = div_rn(y3, l33);
  x[2] = div_rn(y2 - l32 * x[3], l22);
  x[1] = div_rn(y1 - l21 * x[2] - l31 * x[3], l11);
  x[0] = div_rn(y0 - l10 * x[1] - l20 * x[2] - l30 * x[3], l00);
}

// f(track, det) for every pair, by n threads (this one is u): thread
// (g, j) takes detection j of tracks g, g + G, ... (G = n / D), so that
// consecutive threads take consecutive detections; with more detections
// than threads, thread u takes detections u, u + n, ... of every track.
template <typename F>
__device__ __forceinline__ void for_pairs(int T, int D, int u, int n, F f) {
  if (D <= 0) return;
  if (D <= n) {
    const int G = n / D, j = u % D, g = u / D;
    if (g < G)
      for (int tr = g; tr < T; tr += G) f(tr, j);
  } else {
    for (int j = u; j < D; j += n)
      for (int tr = 0; tr < T; ++tr) f(tr, j);
  }
}

// Per-track floats in shared memory (kTrk): [0, 8) predicted mean; [8, 18)
// Cholesky factor of S (cho_solve4's order); [18, 28) S (s00, s10, s20,
// s30, s11, s21, s31, s22, s32, s33); [28, 32) the IoU box tx, ty, tw, h.
constexpr int kL = 8, kS = 18, kBox = 28;

template <int SLOTS, bool kShared>
__global__ void __launch_bounds__(kThreads)
tracker_kernel(const float* __restrict__ app,        // (S, T, D)
               const float* __restrict__ det_tlwh,   // (S, D, 4)
               const float* __restrict__ det_conf,   // (S, D)
               const unsigned char* __restrict__ det_mask,  // (S, D)
               const int* __restrict__ st_state,     // (S, T) each
               const int* __restrict__ st_hits, const int* __restrict__ st_age,
               const int* __restrict__ st_tsu, const int* __restrict__ st_id,
               const float* __restrict__ mean_in,    // (S, T, 8)
               const float* __restrict__ cov_in,     // (S, T, 64)
               const int* __restrict__ next_id_in,   // (S,)
               float* __restrict__ mean_out, float* __restrict__ cov_out,
               int* __restrict__ ints_out,     // (7, S, T)
               int* __restrict__ next_id_out,  // (S,)
               float* scratch,  // (2, S, T, D) stage costs when not staged
               int t_tracks, int d_dets, float max_dist, float max_iou,
               int max_age, int n_init, float min_conf) {
  constexpr bool staged = kShared;
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = t_tracks, D = d_dets, NC = T + D, S = gridDim.x;
  const int s = blockIdx.x;
  const int tid = threadIdx.x;

  // ---- carve shared memory (smem_bytes above mirrors this)
  Carve cv{smem};
  float* sh_app = staged ? cv.take<float>((size_t)T * D) : nullptr;
  float* cost_a = staged ? cv.take<float>((size_t)T * D) : nullptr;
  float* cost_b = staged ? cv.take<float>((size_t)T * D) : nullptr;
  float* tlwh = cv.take<float>((size_t)D * 4);
  float* xyah = cv.take<float>((size_t)D * 4);
  float* conf = cv.take<float>(D);
  unsigned char* dmask = cv.take<unsigned char>(D);
  int* sh_state = cv.take<int>(T);
  int* sh_hits = cv.take<int>(T);
  int* sh_age = cv.take<int>(T);
  int* sh_tsu = cv.take<int>(T);
  int* sh_id = cv.take<int>(T);
  float* sh_mean = cv.take<float>((size_t)T * 8);
  float* trk = cv.take<float>((size_t)T * kTrk);
  unsigned char* a_row = cv.take<unsigned char>(T);  // confirmed
  unsigned char* b_row = cv.take<unsigned char>(T);  // stage-B candidate
  int* lv_a = cv.take<int>(T);
  int* lv_b = cv.take<int>(T);
  int* order_a = cv.take<int>(T);
  int* order_b = cv.take<int>(T);
  int* assign_a = cv.take<int>(T);
  int* assign_b = cv.take<int>(T);
  int* owner_a = cv.take<int>(NC);
  int* owner_b = cv.take<int>(NC);
  int* match_det = cv.take<int>(T);
  int* scan_t = cv.take<int>(T);
  int* scan_d = cv.take<int>(D);
  int* rank_to_det = cv.take<int>(D);
  float* sh_covp = cv.take<float>((size_t)T * kCovStride);

  const long long st_off = (long long)s * T;
  const float* app_s = staged ? sh_app : app + st_off * D;
  if (!staged) {
    cost_a = scratch + st_off * D;
    cost_b = scratch + ((long long)S + s) * T * D;
  }

  // ---- stage the inputs (cp.async); each thread's covariance meanwhile
  if (staged) ydt::stage_words(sh_app, app + st_off * D, T * D);
  ydt::stage_words(tlwh, det_tlwh + (long long)s * D * 4, D * 4);
  ydt::stage_words(conf, det_conf + (long long)s * D, D);
  ydt::stage_words(sh_state, st_state + st_off, T);
  ydt::stage_words(sh_hits, st_hits + st_off, T);
  ydt::stage_words(sh_age, st_age + st_off, T);
  ydt::stage_words(sh_tsu, st_tsu + st_off, T);
  ydt::stage_words(sh_id, st_id + st_off, T);
  ydt::stage_words(sh_mean, mean_in + st_off * 8, T * 8);
  const bool own_track = tid < T;
  const int t = own_track ? tid : 0;
  float cov[64];
  if (own_track) load_cov(cov_in + (st_off + t) * 64, cov);
  ydt::cp_async_wait_all();
  __syncthreads();

  // ---- prologue: detections, levels
  for (int j = tid; j < D; j += blockDim.x) {
    const float x = tlwh[4 * j], y = tlwh[4 * j + 1], w = tlwh[4 * j + 2],
                h = tlwh[4 * j + 3];
    xyah[4 * j] = x + div_rn(w, 2.0f);
    xyah[4 * j + 1] = y + div_rn(h, 2.0f);
    xyah[4 * j + 2] = h > 0.0f ? div_rn(w, h) : 0.0f;
    xyah[4 * j + 3] = h;
    dmask[j] = det_mask[(long long)s * D + j] != 0 && conf[j] > min_conf;
  }
  int st0 = 0, tsu0 = 0;
  bool active = false, confirmed = false, tentative = false, rows_b = false;
  if (own_track) {
    st0 = sh_state[t];
    tsu0 = sh_tsu[t];
    active = st0 > kFree;
    confirmed = st0 == kConfirmed;
    tentative = st0 == kTentative;
    rows_b = tentative || (confirmed && tsu0 == 0);  // tsu after predict 1
    a_row[t] = confirmed;
    b_row[t] = rows_b;
    lv_a[t] = confirmed ? tsu0 : ydt::kLevelInactive;
    lv_b[t] = rows_b ? 0 : ydt::kLevelInactive;
    match_det[t] = -1;
  }
  const int tsu1 = tsu0 + (active ? 1 : 0);
  const int n_a = __syncthreads_count(own_track && confirmed);
  const int n_b = __syncthreads_count(own_track && rows_b);
  ydt::stable_order2(lv_a, lv_b, T, order_a, order_b);

  // ---- per track: predict, project, factor (thread t = track t)
  if (own_track) {
    float mean[8], mean_p[8], cov_p[64];
#pragma unroll
    for (int i = 0; i < 8; ++i) mean[i] = sh_mean[8 * t + i];
    kf_predict(mean, cov, active, mean_p, cov_p);
    const float h_p = fmaxf(mean_p[3], kHFloor);
    const float rp = kSP * h_p;
    const float s00 = cov_p[0] + rp * rp, s10 = cov_p[8],
                s11 = cov_p[9] + rp * rp, s20 = cov_p[16], s21 = cov_p[17],
                s22 = cov_p[18] + kR2, s30 = cov_p[24], s31 = cov_p[25],
                s32 = cov_p[26], s33 = cov_p[27] + rp * rp;
    const float l00 = gsqrt(s00);
    const float l10 = div_rn(s10, l00), l20 = div_rn(s20, l00),
                l30 = div_rn(s30, l00);
    const float l11 = gsqrt(s11 - l10 * l10);
    const float l21 = div_rn(s21 - l20 * l10, l11);
    const float l31 = div_rn(s31 - l30 * l10, l11);
    const float l22 = gsqrt(s22 - l20 * l20 - l21 * l21);
    const float l32 = div_rn(s32 - l30 * l20 - l31 * l21, l22);
    const float l33 = gsqrt(s33 - l30 * l30 - l31 * l31 - l32 * l32);
    float* tk = trk + t * kTrk;
#pragma unroll
    for (int i = 0; i < 8; ++i) tk[i] = mean_p[i];
    const float lf[10] = {l00, l10, l20, l30, l11, l21, l31, l22, l32, l33};
    const float sf[10] = {s00, s10, s20, s30, s11, s21, s31, s22, s32, s33};
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      tk[kL + i] = lf[i];
      tk[kS + i] = sf[i];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) sh_covp[t * kCovStride + i] = cov_p[i];
    const float tw = mean_p[2] * h_p;
    tk[kBox] = mean_p[0] - tw * 0.5f;
    tk[kBox + 1] = mean_p[1] - h_p * 0.5f;
    tk[kBox + 2] = tw;
    tk[kBox + 3] = h_p;
    // stage-B eligibility of the row: a candidate seen at most once ago
    b_row[t] = rows_b && tsu1 <= 1;
  }
  __syncthreads();

  // ---- stage A costs: gated cosine. Thread (g, j) prices detection j for
  // tracks g, g + G, ...: consecutive threads on consecutive detections;
  // rows that are not confirmed cost kBig without a Mahalanobis distance
  for_pairs(T, D, tid, blockDim.x, [&](int tr, int j) {
    float cost = ydt::kBig;
    if (a_row[tr]) {
      const float* tk = trk + tr * kTrk;
      const float* L = tk + kL;
      const float* z = xyah + 4 * j;
      const float d0 = z[0] - tk[0], d1 = z[1] - tk[1];
      const float d2 = z[2] - tk[2], d3 = z[3] - tk[3];
      const float y0 = div_rn(d0, L[0]);
      const float y1 = div_rn(d1 - L[1] * y0, L[4]);
      const float y2 = div_rn(d2 - L[2] * y0 - L[5] * y1, L[7]);
      const float y3 = div_rn(d3 - L[3] * y0 - L[6] * y1 - L[8] * y2, L[9]);
      const float maha = y0 * y0 + y1 * y1 + y2 * y2 + y3 * y3;
      const float a = app_s[tr * D + j];
      if (dmask[j] && a <= max_dist && maha <= kChi2) cost = a;
    }
    cost_a[tr * D + j] = cost;
  });
  __syncthreads();

  if (tid < 32) {
    // ---- warp 0: stage A, the cascade in level order
    const ydt::JVStage st{cost_a, T, D, INFINITY, max_dist + 2e-5f, order_a,
                          lv_a, n_a, nullptr, nullptr, nullptr};
    ydt::jv_warp_stage<SLOTS, kShared>(st, assign_a, owner_a, nullptr);
  } else {
    // ---- warps 1-7 meanwhile: stage B costs, IoU over candidate rows
    // (thread (g, j) as above; rows that are no candidate cost kBig)
    for_pairs(T, D, tid - 32, blockDim.x - 32, [&](int tr, int j) {
      float cost = ydt::kBig;
      if (b_row[tr]) {
        const float* box = trk + tr * kTrk + kBox;
        const float tx = box[0], ty = box[1], tw = box[2], h_p = box[3];
        const float* dt = tlwh + 4 * j;
        const float dtx = dt[0], dty = dt[1], dtw = dt[2], dth = dt[3];
        const float ix =
            fmaxf(fminf(tx + tw, dtx + dtw) - fmaxf(tx, dtx), 0.0f);
        const float iy =
            fmaxf(fminf(ty + h_p, dty + dth) - fmaxf(ty, dty), 0.0f);
        const float inter = ix * iy;
        const float denom = tw * h_p + dtw * dth - inter;
        const float iou = denom > 0.0f ? div_rn(inter, denom) : 0.0f;
        const float iou_cost = 1.0f - iou;
        if (dmask[j] && iou_cost <= max_iou) cost = iou_cost;
      }
      cost_b[tr * D + j] = cost;
    });
  }
  __syncthreads();

  if (tid < 32) {
    // ---- warp 0: stage B, one level; A's real columns vetoed, rows that
    // took a real column in A skipped
    const ydt::JVStage st{cost_b, T, D, INFINITY, max_iou + 2e-5f, order_b,
                          lv_b, n_b, nullptr, owner_a, assign_a};
    ydt::jv_warp_stage<SLOTS, kShared>(st, assign_b, owner_b, nullptr);
  }
  __syncthreads();

  // ---- combined match: owner of each real column, stage A first
  for (int j = tid; j < D; j += blockDim.x) {
    const int own = owner_a[j] >= 0 ? owner_a[j] : owner_b[j];
    if (own >= 0) match_det[own] = j;
    scan_d[j] = (dmask[j] && own < 0) ? 1 : 0;  // unmatched dets
  }
  __syncthreads();

  // ---- lifecycle
  int st1 = 0, tid1 = 0, hits1 = 0, tsu2 = 0;
  bool matched = false;
  if (own_track) {
    matched = match_det[t] >= 0;
    hits1 = sh_hits[t] + (matched ? 1 : 0);
    tsu2 = matched ? 0 : tsu1;
    st1 = (matched && tentative && hits1 >= n_init) ? kConfirmed : st0;
    const bool deleted =
        active && !matched && (tentative || tsu2 > max_age);
    st1 = deleted ? kFree : st1;
    tid1 = deleted ? 0 : sh_id[t];
    scan_t[t] = st1 == kFree ? 1 : 0;
  }
  __syncthreads();

  // ---- initiate: pair the r-th unmatched det with the r-th free slot
  block_inclusive_scan(scan_d, D);
  block_inclusive_scan(scan_t, T);
  const int n_unmatched = D > 0 ? scan_d[D - 1] : 0;
  for (int j = tid; j < D; j += blockDim.x) {
    const bool um = scan_d[j] - (j > 0 ? scan_d[j - 1] : 0) > 0;
    if (um) rank_to_det[scan_d[j] - 1] = j;
  }
  const int next_id = next_id_in[s];
  if (tid == 0) {
    const int n_free = T > 0 ? scan_t[T - 1] : 0;
    next_id_out[s] = next_id + (n_free < n_unmatched ? n_free : n_unmatched);
  }
  __syncthreads();
  if (!own_track) return;

  const bool is_free = st1 == kFree;
  const int frank0 = scan_t[t] - 1;
  const bool is_new = is_free && frank0 < n_unmatched;
  const int det_for_slot = is_new ? rank_to_det[frank0] : -1;
  const int mdet = matched ? match_det[t] : (is_new ? det_for_slot : -1);

  // the predicted state, from shared memory
  const float* tk = trk + t * kTrk;
  float mean_f[8], cov_f[64];
#pragma unroll
  for (int i = 0; i < 8; ++i) mean_f[i] = tk[i];
#pragma unroll
  for (int i = 0; i < 64; ++i) cov_f[i] = sh_covp[t * kCovStride + i];

  if (matched) {
    // KF update: gain = P H^T S^-1 through the Cholesky factor
    const float* mz = xyah + mdet * 4;
    const float* L = tk + kL;
    float inno[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) inno[k] = mz[k] - tk[k];
    float gain[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float b4[4] = {cov_f[8 * i + 0], cov_f[8 * i + 1],
                           cov_f[8 * i + 2], cov_f[8 * i + 3]};
      cho_solve4(L, b4, gain[i]);
    }
    const float* Sv = tk + kS;
    const float sf[4][4] = {{Sv[0], Sv[1], Sv[2], Sv[3]},
                            {Sv[1], Sv[4], Sv[5], Sv[6]},
                            {Sv[2], Sv[5], Sv[7], Sv[8]},
                            {Sv[3], Sv[6], Sv[8], Sv[9]}};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = acc + gain[i][k] * inno[k];
      mean_f[i] = tk[i] + acc;
    }
    float m_ik[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc = acc + gain[i][q] * sf[q][k];
        m_ik[i][k] = acc;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc = acc + m_ik[i][k] * gain[j][k];
        cov_f[8 * i + j] = cov_f[8 * i + j] - acc;
      }
    }
  } else if (is_new) {
    // KF initiate from the new detection
    const float* mz = xyah + mdet * 4;
    const float h_n = fmaxf(mz[3], kHFloor);
    const float ip = kSP2 * h_n, iv = kSV10 * h_n;
    const float dg[8] = {ip * ip, ip * ip, kQ2, ip * ip,
                         iv * iv, iv * iv, kQ6, iv * iv};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mean_f[i] = mz[i];
      mean_f[i + 4] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) cov_f[8 * i + j] = i == j ? dg[i] : 0.0f;
    }
  }

  float* mo = mean_out + (st_off + t) * 8;
  float* co = cov_out + (st_off + t) * 64;
  if ((((uintptr_t)mo | (uintptr_t)co) & 15) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ((float4*)mo)[i] = make_float4(mean_f[4 * i], mean_f[4 * i + 1],
                                     mean_f[4 * i + 2], mean_f[4 * i + 3]);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      ((float4*)co)[i] = make_float4(cov_f[4 * i], cov_f[4 * i + 1],
                                     cov_f[4 * i + 2], cov_f[4 * i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) mo[i] = mean_f[i];
#pragma unroll
    for (int i = 0; i < 64; ++i) co[i] = cov_f[i];
  }
  // planar int fields: field f of (s, t) at f * S * T + s * T + t
  const long long plane = (long long)S * T;
  int* io = ints_out + st_off + t;
  io[0] = is_new ? kTentative : st1;
  io[plane] = is_new ? 1 : hits1;
  io[2 * plane] = is_new ? 1 : sh_age[t] + (active ? 1 : 0);
  io[3 * plane] = is_new ? 0 : tsu2;
  io[4 * plane] = is_new ? next_id + frank0 : tid1;
  io[5 * plane] = matched ? match_det[t] : -1;
  io[6 * plane] = det_for_slot;
}

template <int SLOTS, bool kShared>
cudaError_t launch_as(const void* const* p, void* scratch, int s, int t,
                      int d, float max_dist, float max_iou, int max_age,
                      int n_init, float min_conf, int device, int limit,
                      size_t bytes, cudaStream_t stream) {
  static int done[ydt::kMaxDevices] = {};
  if (!done[device]) {  // once per device, before any graph capture
    const cudaError_t e = cudaFuncSetAttribute(
        tracker_kernel<SLOTS, kShared>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (e != cudaSuccess) return e;
    done[device] = 1;
  }
  tracker_kernel<SLOTS, kShared><<<s, kThreads, bytes, stream>>>(
      (const float*)p[0], (const float*)p[1], (const float*)p[2],
      (const unsigned char*)p[3], (const int*)p[4], (const int*)p[5],
      (const int*)p[6], (const int*)p[7], (const int*)p[8],
      (const float*)p[9], (const float*)p[10], (const int*)p[11],
      (float*)p[12], (float*)p[13], (int*)p[14], (int*)p[15],
      (float*)scratch, t, d, max_dist, max_iou, max_age, n_init, min_conf);
  return cudaGetLastError();
}

template <int SLOTS>
cudaError_t launch(const void* const* p, void* scratch, int s, int t, int d,
                   float max_dist, float max_iou, int max_age, int n_init,
                   float min_conf, int* staged, cudaStream_t stream) {
  int device = 0, limit = 0;
  const cudaError_t e = ydt::optin_limit(&device, &limit);
  if (e != cudaSuccess) return e;
  size_t bytes = smem_bytes(t, d, true);
  *staged = bytes <= (size_t)limit;
  if (*staged)
    return launch_as<SLOTS, true>(p, scratch, s, t, d, max_dist, max_iou,
                                  max_age, n_init, min_conf, device, limit,
                                  bytes, stream);
  bytes = smem_bytes(t, d, false);
  if (bytes > (size_t)limit || scratch == nullptr)
    return cudaErrorInvalidValue;
  return launch_as<SLOTS, false>(p, scratch, s, t, d, max_dist, max_iou,
                                 max_age, n_init, min_conf, device, limit,
                                 bytes, stream);
}

}  // namespace

// Pointers in order: app, det_tlwh, det_conf, det_mask (uint8), state,
// hits, age, time_since_update, track_id (int32, (S, T) each), mean, cov,
// next_id; mean_out, cov_out, ints_out (7, S, T), next_id_out. `scratch`
// holds 2 * S * T * D floats, used where the stage blocks do not fit in
// shared memory; *staged (host int) reports which layout ran.
extern "C" int ydt_tracker_step(
    const void* app, const void* det_tlwh, const void* det_conf,
    const void* det_mask, const void* state, const void* hits,
    const void* age, const void* tsu, const void* track_id,
    const void* mean_in, const void* cov_in, const void* next_id,
    void* mean_out, void* cov_out, void* ints_out, void* next_id_out,
    void* scratch, int s, int t, int d, float max_dist, float max_iou,
    int max_age, int n_init, float min_conf, int* staged, void* stream) {
  *staged = 0;
  if (s == 0 || t == 0) return 0;
  const void* p[16] = {app,     det_tlwh, det_conf, det_mask,
                       state,   hits,     age,      tsu,
                       track_id, mean_in, cov_in,   next_id,
                       mean_out, cov_out, ints_out, next_id_out};
  const auto st = (cudaStream_t)stream;
  switch (ydt::jv_slots_for(t + d)) {
    case 4:
      return (int)launch<4>(p, scratch, s, t, d, max_dist, max_iou, max_age,
                            n_init, min_conf, staged, st);
    case 6:
      return (int)launch<6>(p, scratch, s, t, d, max_dist, max_iou, max_age,
                            n_init, min_conf, staged, st);
    case 8:
      return (int)launch<8>(p, scratch, s, t, d, max_dist, max_iou, max_age,
                            n_init, min_conf, staged, st);
    case 16:
      return (int)launch<16>(p, scratch, s, t, d, max_dist, max_iou, max_age,
                             n_init, min_conf, staged, st);
    default:
      return (int)cudaErrorInvalidValue;  // t, d <= 256: NC <= 512
  }
}
