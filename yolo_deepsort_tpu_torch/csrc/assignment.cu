// JV assignment kernels for Hopper: one thread block per stream.
//
// Replaces two TPU kernels of yolo_deepsort_tpu/ops/assignment_pallas.py:
//   K4  _jv_kernel (via _solve_batched): one matching-cascade sweep over a
//       prepared augmented cost;
//   K5  _two_stage_kernel (via _solve_two_batched_c): DeepSORT's two-stage
//       match in one launch -- the gated-cosine cascade (stage A), then the
//       IoU match (stage B) over the candidate rows that took no real column
//       in A, with the real columns A took vetoed.
// Both are thin wrappers over the stage runner ydt::jv_run_stage
// (jv_stage.cuh), which the fused tracker kernel (tracker.cu) also runs.
// The augmented cost, the level-major order and the active-row counts are
// built by framework ops before the launch (ops/assignment_kernel.py), as
// the reference builds them in XLA (_prep).
//
// Layout: the augmented (R, NC) cost of a stream, NC = C + R (real columns,
// then one private dummy per row), stays in device memory; it is read row
// by row and is L2-resident at tracker sizes (128 x 192 f32 = 96 KB). Shared
// memory holds the JV vectors (five NC-long vectors and 66 reduction words),
// the per-stage column owners and row assignments, and the stream's order
// and levels: about 10 KB at R = 128, NC = 192. The TPU's (8, 128) padding
// of R and NC is dropped.
//
// Bound on the H100: latency. Each augmentation is a sequential chain of
// block-wide (value, index) min-reductions, one per Dijkstra step, so a
// block runs one stream's solve at the pace of its __syncthreads chain and
// S streams occupy S SMs. The block has one thread per column (rounded up
// to a warp, at most 1024), so each step's relaxation is a single pass.
//
// Rounding: built with --fmad=false (kernels/build.py) so the reduced costs
// (mu + c2 - c2_jmin, v + d - mu_star) round as in the plain version.

#include <cuda_runtime.h>

#include "jv_stage.cuh"

namespace {

// Carve the JV scratch out of dynamic shared memory; returns the first int
// after it.
__device__ inline int* carve_scratch(float* smem, int nc, ydt::JVScratch* js) {
  js->v = smem;
  js->d = js->v + nc;
  js->red_v = js->d + nc;  // 33
  int* ip = (int*)(js->red_v + 33);
  js->pred = ip;
  js->todo = js->pred + nc;
  js->owner_level = js->todo + nc;
  js->red_i = js->owner_level + nc;  // 33
  return js->red_i + 33;
}

__host__ __device__ inline size_t scratch_bytes(int nc) {
  return ((size_t)2 * nc + 33) * sizeof(float) +
         ((size_t)3 * nc + 33) * sizeof(int);
}

__global__ void jv_cascade_kernel(const float* __restrict__ aug,     // (S, R, NC)
                                  const int* __restrict__ order,     // (S, R)
                                  const int* __restrict__ levels,    // (S, R)
                                  const int* __restrict__ n_active,  // (S,)
                                  int* __restrict__ out,             // (S, R)
                                  int r, int nc) {
  extern __shared__ float smem[];
  const int s = blockIdx.x;
  ydt::JVScratch js;
  int* col_owner = carve_scratch(smem, nc, &js);  // nc
  int* assign = col_owner + nc;                   // r
  int* sh_order = assign + r;                     // r
  int* sh_levels = sh_order + r;                  // r
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    sh_order[i] = order[(long long)s * r + i];
    sh_levels[i] = levels[(long long)s * r + i];
  }
  __syncthreads();
  ydt::jv_run_stage(aug + (long long)s * r * nc, r, nc, sh_order, sh_levels,
                    n_active[s], nullptr, nullptr, 0, assign, col_owner, js);
  for (int i = threadIdx.x; i < r; i += blockDim.x)
    out[(long long)s * r + i] = assign[i];
}

__global__ void jv_two_stage_kernel(const float* __restrict__ aug_a,  // (S, R, NC)
                                    const int* __restrict__ order_a,  // (S, R)
                                    const int* __restrict__ levels_a,  // (S, R)
                                    const float* __restrict__ aug_b,  // (S, R, NC)
                                    const int* __restrict__ order_b,  // (S, R)
                                    const int* __restrict__ n2,  // (S, 2) [n_a, n_b]
                                    int* __restrict__ out_a,     // (S, R)
                                    int* __restrict__ out_b,     // (S, R)
                                    int r, int nc, int c_real) {
  extern __shared__ float smem[];
  const int s = blockIdx.x;
  ydt::JVScratch js;
  int* owner_a = carve_scratch(smem, nc, &js);  // nc
  int* owner_b = owner_a + nc;                  // nc
  int* veto = owner_b + nc;                     // nc
  int* assign_a = veto + nc;                    // r
  int* assign_b = assign_a + r;                 // r
  int* sh_order_a = assign_b + r;               // r
  int* sh_levels_a = sh_order_a + r;            // r
  int* sh_order_b = sh_levels_a + r;            // r
  int* zero_lv = sh_order_b + r;                // r
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    sh_order_a[i] = order_a[(long long)s * r + i];
    sh_levels_a[i] = levels_a[(long long)s * r + i];
    sh_order_b[i] = order_b[(long long)s * r + i];
    zero_lv[i] = 0;
  }
  __syncthreads();

  ydt::jv_run_stage(aug_a + (long long)s * r * nc, r, nc, sh_order_a,
                    sh_levels_a, n2[2 * s], nullptr, nullptr, c_real, assign_a,
                    owner_a, js);

  // real columns matched in stage A are ineligible in stage B; the private
  // dummies (j >= c_real) stay open so stage-B rows can go unmatched
  for (int j = threadIdx.x; j < nc; j += blockDim.x)
    veto[j] = (owner_a[j] >= 0 && j < c_real) ? 1 : 0;
  __syncthreads();

  // stage B: one level; rows that took a real column in A are skipped
  ydt::jv_run_stage(aug_b + (long long)s * r * nc, r, nc, sh_order_b, zero_lv,
                    n2[2 * s + 1], veto, assign_a, c_real, assign_b, owner_b,
                    js);
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    out_a[(long long)s * r + i] = assign_a[i];
    out_b[(long long)s * r + i] = assign_b[i];
  }
}

// One thread per column, rounded up to a warp; the stage runner needs a
// multiple of 32 and at most 1024.
int threads_for(int nc) {
  int t = ((nc + 31) / 32) * 32;
  if (t < 32) t = 32;
  if (t > 1024) t = 1024;
  return t;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" int ydt_jv_cascade(const void* aug, const void* order,
                              const void* levels, const void* n_active,
                              void* out, int s, int r, int nc, void* stream) {
  if (s == 0 || r == 0) return 0;
  const size_t smem = scratch_bytes(nc) + ((size_t)nc + 3 * (size_t)r) * 4;
  cudaError_t e = allow_smem(jv_cascade_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  jv_cascade_kernel<<<s, threads_for(nc), smem, (cudaStream_t)stream>>>(
      (const float*)aug, (const int*)order, (const int*)levels,
      (const int*)n_active, (int*)out, r, nc);
  return (int)cudaGetLastError();
}

extern "C" int ydt_jv_two_stage(const void* aug_a, const void* order_a,
                                const void* levels_a, const void* aug_b,
                                const void* order_b, const void* n2,
                                void* out_a, void* out_b, int s, int r, int nc,
                                int c_real, void* stream) {
  if (s == 0 || r == 0) return 0;
  const size_t smem =
      scratch_bytes(nc) + (3 * (size_t)nc + 6 * (size_t)r) * 4;
  cudaError_t e = allow_smem(jv_two_stage_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  jv_two_stage_kernel<<<s, threads_for(nc), smem, (cudaStream_t)stream>>>(
      (const float*)aug_a, (const int*)order_a, (const int*)levels_a,
      (const float*)aug_b, (const int*)order_b, (const int*)n2, (int*)out_a,
      (int*)out_b, r, nc, c_real);
  return (int)cudaGetLastError();
}
