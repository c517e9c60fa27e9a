// JV assignment kernels for Hopper: one block per stream, one warp solves.
//
// Replaces two TPU kernels of yolo_deepsort_tpu/ops/assignment_pallas.py:
//   K4  _jv_kernel (via _solve_batched): one matching-cascade sweep;
//   K5  _two_stage_kernel (via _solve_two_batched_c): DeepSORT's two-stage
//       match in one launch -- the gated-cosine cascade (stage A), then the
//       IoU match (stage B) over the candidate rows that took no real column
//       in A, with the real columns A took vetoed.
// Both are launch wrappers over the warp stage runner ydt::jv_warp_stage
// (jv_stage.cuh), which the fused tracker kernel (tracker.cu) also runs.
//
// Inputs are the compact problem, not the augmented matrix: the raw (R, C)
// costs, the cascade levels, the row and column masks and the per-stream
// threshold. The block does what the reference's _prep does in XLA: the
// 128 threads stage the costs into shared memory with cp.async, build the
// masked levels and the stable level-major order (an exact rank per row),
// and count the active rows; then warp 0 runs the stage(s) with
// eligibility (row & column & cost <= maxd) and the private dummies at
// maxd + 2e-5 applied as columns are read, and writes the real column per
// row (or -1) -- the framework's unpadding, folded in. No (R, C + R)
// tensor exists anywhere.
//
// Bound on the H100: latency, (rows + Dijkstra steps) x one dependent warp
// step (see jv_stage.cuh); S streams occupy S SMs. Where the cost block of
// a stream does not fit in shared memory next to the rest, the runner reads
// it from device memory through the same code.
//
// Rounding: built with --fmad=false (kernels/build.py) so the reduced costs
// (mu + c2 - c2_jmin, v + d - mu_star) round as in the plain version.

#include <cuda_runtime.h>

#include "jv_stage.cuh"

namespace {

using ydt::Carve;
using ydt::round16;

constexpr int kThreads = 128;  // four warps stage the inputs; warp 0 solves

// Shared-memory bytes of one stream: `stages` staged cost blocks (when
// `staged`), then per stage levels, order, assignment (R ints) and column
// owners (C + R ints) and a row mask (R bytes), a column mask (C bytes),
// and the runner's lane columns. Must match the kernels' carving.
__host__ __device__ inline size_t smem_bytes(int r, int c, int stages,
                                             bool staged, int slots) {
  const int nc = c + r;
  size_t b = staged ? stages * round16((size_t)r * c * 4) : 0;
  b += stages * (3 * round16((size_t)r * 4) + round16((size_t)nc * 4) +
                 round16((size_t)r));
  b += round16((size_t)c);
  b += round16(ydt::jv_lane_smem_bytes(slots, nc));
  return b;
}

__device__ __forceinline__ float threshold(const float* maxd, int stride,
                                           float value) {
  return maxd != nullptr ? maxd[blockIdx.x * stride] : value;
}

template <int SLOTS, bool kShared>
__global__ void __launch_bounds__(kThreads)
jv_cascade_kernel(const float* __restrict__ cost,        // (S, R, C)
                  const int* __restrict__ levels_in,      // (S, R)
                  const unsigned char* __restrict__ row_mask,  // (S, R)
                  const unsigned char* __restrict__ col_mask,  // (S, C)
                  const float* __restrict__ maxd, int maxd_stride,
                  float maxd_value,
                  int* __restrict__ out,  // (S, R) real column or -1
                  int r, int c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, nc = c + r;
  Carve cv{smem};
  float* sh_cost = kShared ? cv.take<float>((size_t)r * c) : nullptr;
  int* lv = cv.take<int>(r);
  int* order = cv.take<int>(r);
  int* assign = cv.take<int>(r);
  int* owner = cv.take<int>(nc);
  unsigned char* rmask = cv.take<unsigned char>(r);
  unsigned char* cmask = cv.take<unsigned char>(c);
  void* lane_cols = cv.take<unsigned char>(ydt::jv_lane_smem_bytes(SLOTS, nc));

  const float* src = cost + (long long)s * r * c;
  if (kShared) ydt::stage_words(sh_cost, src, r * c);
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    const bool on = row_mask[(long long)s * r + i] != 0;
    rmask[i] = on;
    lv[i] = on ? levels_in[(long long)s * r + i] : ydt::kLevelInactive;
  }
  for (int j = threadIdx.x; j < c; j += blockDim.x)
    cmask[j] = col_mask[(long long)s * c + j] != 0;
  ydt::cp_async_wait_all();
  __syncthreads();
  ydt::stable_order(lv, r, order);
  const int n_active = ydt::block_count(rmask, r);  // also a block barrier
  if (threadIdx.x >= 32) return;

  const float md = threshold(maxd, maxd_stride, maxd_value);
  const ydt::JVStage st{kShared ? sh_cost : src, r, c, md, md + 2e-5f,
                        order, lv, n_active, cmask, nullptr, nullptr};
  ydt::jv_warp_stage<SLOTS, kShared>(st, assign, owner, lane_cols);
  for (int i = threadIdx.x; i < r; i += 32) {
    const int a = assign[i];
    out[(long long)s * r + i] = (a >= 0 && a < c && rmask[i]) ? a : -1;
  }
}

template <int SLOTS, bool kShared>
__global__ void __launch_bounds__(kThreads)
jv_two_stage_kernel(const float* __restrict__ cost_a,  // (S, R, C)
                    const int* __restrict__ levels_a,  // (S, R)
                    const unsigned char* __restrict__ rows_a,  // (S, R)
                    const unsigned char* __restrict__ cols,    // (S, C)
                    const float* __restrict__ maxd_a, int stride_a,
                    float value_a,
                    const float* __restrict__ cost_b,  // (S, R, C)
                    const unsigned char* __restrict__ rows_b,  // (S, R)
                    const float* __restrict__ maxd_b, int stride_b,
                    float value_b,
                    int* __restrict__ out_a,  // (S, R) real column or -1
                    int* __restrict__ out_b,  // (S, R)
                    int r, int c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, nc = c + r;
  Carve cv{smem};
  float* sh_a = kShared ? cv.take<float>((size_t)r * c) : nullptr;
  float* sh_b = kShared ? cv.take<float>((size_t)r * c) : nullptr;
  int* lv_a = cv.take<int>(r);
  int* order_a = cv.take<int>(r);
  int* assign_a = cv.take<int>(r);
  int* owner_a = cv.take<int>(nc);
  unsigned char* rmask_a = cv.take<unsigned char>(r);
  int* lv_b = cv.take<int>(r);
  int* order_b = cv.take<int>(r);
  int* assign_b = cv.take<int>(r);
  int* owner_b = cv.take<int>(nc);
  unsigned char* rmask_b = cv.take<unsigned char>(r);
  unsigned char* cmask = cv.take<unsigned char>(c);
  void* lane_cols = cv.take<unsigned char>(ydt::jv_lane_smem_bytes(SLOTS, nc));

  const long long off = (long long)s * r * c;
  if (kShared) {
    ydt::stage_words(sh_a, cost_a + off, r * c);
    ydt::stage_words(sh_b, cost_b + off, r * c);
  }
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    const long long k = (long long)s * r + i;
    const bool on_a = rows_a[k] != 0, on_b = rows_b[k] != 0;
    rmask_a[i] = on_a;
    rmask_b[i] = on_b;
    lv_a[i] = on_a ? levels_a[k] : ydt::kLevelInactive;
    lv_b[i] = on_b ? 0 : ydt::kLevelInactive;  // stage B: one level
  }
  for (int j = threadIdx.x; j < c; j += blockDim.x)
    cmask[j] = cols[(long long)s * c + j] != 0;
  ydt::cp_async_wait_all();
  __syncthreads();
  ydt::stable_order2(lv_a, lv_b, r, order_a, order_b);
  const int n_a = ydt::block_count(rmask_a, r);  // also block barriers
  const int n_b = ydt::block_count(rmask_b, r);
  if (threadIdx.x >= 32) return;

  const float md_a = threshold(maxd_a, stride_a, value_a);
  const float md_b = threshold(maxd_b, stride_b, value_b);
  const ydt::JVStage st_a{kShared ? sh_a : cost_a + off, r, c, md_a,
                          md_a + 2e-5f, order_a, lv_a, n_a, cmask, nullptr,
                          nullptr};
  ydt::jv_warp_stage<SLOTS, kShared>(st_a, assign_a, owner_a, lane_cols);
  // stage B: real columns matched in A are vetoed, the private dummies stay
  // open; rows that took a real column in A are skipped
  const ydt::JVStage st_b{kShared ? sh_b : cost_b + off, r, c, md_b,
                          md_b + 2e-5f, order_b, lv_b, n_b, cmask, owner_a,
                          assign_a};
  ydt::jv_warp_stage<SLOTS, kShared>(st_b, assign_b, owner_b, lane_cols);
  for (int i = threadIdx.x; i < r; i += 32) {
    const long long k = (long long)s * r + i;
    const int a = assign_a[i], b = assign_b[i];
    out_a[k] = (a >= 0 && a < c && rmask_a[i]) ? a : -1;
    out_b[k] = (b >= 0 && b < c && rmask_b[i]) ? b : -1;
  }
}

// Raise a kernel's dynamic shared-memory limit to the device's opt-in
// maximum, once per device (the first call precedes any graph capture).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int device, int limit, int* done) {
  if (done[device]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (e == cudaSuccess) done[device] = 1;
  return e;
}

// Choose staged / unstaged for `stages` cost blocks; error if even the
// unstaged layout does not fit.
cudaError_t plan_smem(int r, int c, int stages, int slots, int limit,
                      size_t* bytes, int* staged) {
  const size_t full = smem_bytes(r, c, stages, true, slots);
  const size_t bare = smem_bytes(r, c, stages, false, slots);
  if (full <= (size_t)limit) {
    *bytes = full;
    *staged = 1;
  } else if (bare <= (size_t)limit) {
    *bytes = bare;
    *staged = 0;
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <int SLOTS, bool kShared>
cudaError_t launch_cascade_as(const float* cost, const int* levels,
                              const unsigned char* rows,
                              const unsigned char* cols, const float* maxd,
                              int stride, float value, int* out, int s, int r,
                              int c, int device, int limit, size_t bytes,
                              cudaStream_t stream) {
  static int done[ydt::kMaxDevices] = {};
  cudaError_t e =
      allow_smem(jv_cascade_kernel<SLOTS, kShared>, device, limit, done);
  if (e != cudaSuccess) return e;
  jv_cascade_kernel<SLOTS, kShared><<<s, kThreads, bytes, stream>>>(
      cost, levels, rows, cols, maxd, stride, value, out, r, c);
  return cudaGetLastError();
}

template <int SLOTS>
cudaError_t launch_cascade(const float* cost, const int* levels,
                           const unsigned char* rows,
                           const unsigned char* cols, const float* maxd,
                           int stride, float value, int* out, int s, int r,
                           int c, int* staged, cudaStream_t stream) {
  int device = 0, limit = 0;
  size_t bytes = 0;
  cudaError_t e = ydt::optin_limit(&device, &limit);
  if (e == cudaSuccess) e = plan_smem(r, c, 1, SLOTS, limit, &bytes, staged);
  if (e != cudaSuccess) return e;
  return *staged ? launch_cascade_as<SLOTS, true>(
                       cost, levels, rows, cols, maxd, stride, value, out, s,
                       r, c, device, limit, bytes, stream)
                 : launch_cascade_as<SLOTS, false>(
                       cost, levels, rows, cols, maxd, stride, value, out, s,
                       r, c, device, limit, bytes, stream);
}

template <int SLOTS, bool kShared>
cudaError_t launch_two_stage_as(
    const float* cost_a, const int* levels_a, const unsigned char* rows_a,
    const unsigned char* cols, const float* maxd_a, int stride_a,
    float value_a, const float* cost_b, const unsigned char* rows_b,
    const float* maxd_b, int stride_b, float value_b, int* out_a, int* out_b,
    int s, int r, int c, int device, int limit, size_t bytes,
    cudaStream_t stream) {
  static int done[ydt::kMaxDevices] = {};
  cudaError_t e =
      allow_smem(jv_two_stage_kernel<SLOTS, kShared>, device, limit, done);
  if (e != cudaSuccess) return e;
  jv_two_stage_kernel<SLOTS, kShared><<<s, kThreads, bytes, stream>>>(
      cost_a, levels_a, rows_a, cols, maxd_a, stride_a, value_a, cost_b,
      rows_b, maxd_b, stride_b, value_b, out_a, out_b, r, c);
  return cudaGetLastError();
}

template <int SLOTS>
cudaError_t launch_two_stage(const float* cost_a, const int* levels_a,
                             const unsigned char* rows_a,
                             const unsigned char* cols, const float* maxd_a,
                             int stride_a, float value_a, const float* cost_b,
                             const unsigned char* rows_b, const float* maxd_b,
                             int stride_b, float value_b, int* out_a,
                             int* out_b, int s, int r, int c, int* staged,
                             cudaStream_t stream) {
  int device = 0, limit = 0;
  size_t bytes = 0;
  cudaError_t e = ydt::optin_limit(&device, &limit);
  if (e == cudaSuccess) e = plan_smem(r, c, 2, SLOTS, limit, &bytes, staged);
  if (e != cudaSuccess) return e;
  return *staged
             ? launch_two_stage_as<SLOTS, true>(
                   cost_a, levels_a, rows_a, cols, maxd_a, stride_a, value_a,
                   cost_b, rows_b, maxd_b, stride_b, value_b, out_a, out_b, s,
                   r, c, device, limit, bytes, stream)
             : launch_two_stage_as<SLOTS, false>(
                   cost_a, levels_a, rows_a, cols, maxd_a, stride_a, value_a,
                   cost_b, rows_b, maxd_b, stride_b, value_b, out_a, out_b, s,
                   r, c, device, limit, bytes, stream);
}

}  // namespace

// maxd: a per-stream (S,) float pointer read at blockIdx.x * stride (stride
// 0 for one value on the device), or null and the value `maxd_value`.
// *staged (host int) reports whether the costs were staged in shared memory.
extern "C" int ydt_jv_cascade(const void* cost, const void* levels,
                              const void* row_mask, const void* col_mask,
                              const void* maxd, int maxd_stride,
                              float maxd_value, void* out, int s, int r,
                              int c, int* staged, void* stream) {
  *staged = 0;
  if (s == 0 || r == 0) return 0;
  const auto f = (const float*)cost;
  const auto lv = (const int*)levels;
  const auto rm = (const unsigned char*)row_mask;
  const auto cm = (const unsigned char*)col_mask;
  const auto md = (const float*)maxd;
  const auto st = (cudaStream_t)stream;
  switch (ydt::jv_slots_for(c + r)) {
    case 4:
      return (int)launch_cascade<4>(f, lv, rm, cm, md, maxd_stride,
                                    maxd_value, (int*)out, s, r, c, staged,
                                    st);
    case 6:
      return (int)launch_cascade<6>(f, lv, rm, cm, md, maxd_stride,
                                    maxd_value, (int*)out, s, r, c, staged,
                                    st);
    case 8:
      return (int)launch_cascade<8>(f, lv, rm, cm, md, maxd_stride,
                                    maxd_value, (int*)out, s, r, c, staged,
                                    st);
    case 16:
      return (int)launch_cascade<16>(f, lv, rm, cm, md, maxd_stride,
                                     maxd_value, (int*)out, s, r, c, staged,
                                     st);
    default:
      return (int)launch_cascade<0>(f, lv, rm, cm, md, maxd_stride,
                                    maxd_value, (int*)out, s, r, c, staged,
                                    st);
  }
}

extern "C" int ydt_jv_two_stage(const void* cost_a, const void* levels_a,
                                const void* rows_a, const void* cols,
                                const void* maxd_a, int stride_a,
                                float value_a, const void* cost_b,
                                const void* rows_b, const void* maxd_b,
                                int stride_b, float value_b, void* out_a,
                                void* out_b, int s, int r, int c, int* staged,
                                void* stream) {
  *staged = 0;
  if (s == 0 || r == 0) return 0;
  const auto fa = (const float*)cost_a;
  const auto fb = (const float*)cost_b;
  const auto lv = (const int*)levels_a;
  const auto ra = (const unsigned char*)rows_a;
  const auto rb = (const unsigned char*)rows_b;
  const auto cm = (const unsigned char*)cols;
  const auto ma = (const float*)maxd_a;
  const auto mb = (const float*)maxd_b;
  const auto st = (cudaStream_t)stream;
  switch (ydt::jv_slots_for(c + r)) {
    case 4:
      return (int)launch_two_stage<4>(fa, lv, ra, cm, ma, stride_a, value_a,
                                      fb, rb, mb, stride_b, value_b,
                                      (int*)out_a, (int*)out_b, s, r, c,
                                      staged, st);
    case 6:
      return (int)launch_two_stage<6>(fa, lv, ra, cm, ma, stride_a, value_a,
                                      fb, rb, mb, stride_b, value_b,
                                      (int*)out_a, (int*)out_b, s, r, c,
                                      staged, st);
    case 8:
      return (int)launch_two_stage<8>(fa, lv, ra, cm, ma, stride_a, value_a,
                                      fb, rb, mb, stride_b, value_b,
                                      (int*)out_a, (int*)out_b, s, r, c,
                                      staged, st);
    case 16:
      return (int)launch_two_stage<16>(fa, lv, ra, cm, ma, stride_a, value_a,
                                       fb, rb, mb, stride_b, value_b,
                                       (int*)out_a, (int*)out_b, s, r, c,
                                       staged, st);
    default:
      return (int)launch_two_stage<0>(fa, lv, ra, cm, ma, stride_a, value_a,
                                      fb, rb, mb, stride_b, value_b,
                                      (int*)out_a, (int*)out_b, s, r, c,
                                      staged, st);
  }
}
