// One stage of the Jonker-Volgenant matching cascade, run by ONE thread
// block (a __device__ port of the stage runner _make_stage_runner in
// yolo_deepsort_tpu/ops/assignment_pallas.py; algorithm contract in
// yolo_deepsort_tpu/ops/assignment.py).
//
// Successive shortest augmenting paths over an augmented (R, NC) cost that
// lives in device memory (L2-resident at tracker sizes: 128 x 192 f32 =
// 96 KB): real columns, then one private dummy column per row. Rows are
// processed in `order` (level-major); a column owned by a row of a lower
// level is frozen for the current row. Each Dijkstra step is a block-wide
// (value, index) min-reduction with LOWEST-INDEX tie-break followed by a
// relaxation of every column through the owner of the chosen one; the
// augment walk is sequential (thread 0). Float arithmetic keeps the
// reference's operation order (`mu + c2 - c2_jmin`, `v + d - mu_star`) and
// must be compiled without FMA contraction (--fmad=false), so that a column
// priced at the 1e9 "ineligible" sentinel compares exactly as it does in
// the plain version.
//
// The vectors over columns are owned by thread j % blockDim.x, so each
// column is written by one thread only; the block needs blockDim.x to be a
// multiple of 32 and at most 1024.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace ydt {

constexpr float kBig = 1e9f;
constexpr int kLevelInactive = 1 << 30;

struct JVScratch {
  float* v;          // [nc] column duals
  float* d;          // [nc] tentative distances
  int* pred;         // [nc] predecessor row of each column
  int* todo;         // [nc] 1 = not yet scanned
  int* owner_level;  // [nc] level of the row owning each column
  float* red_v;      // [33] reduction scratch
  int* red_i;        // [33]
};

// (value, index) minimum over the block, lowest index on ties; every thread
// receives the result.
__device__ inline void block_argmin(float val, int idx, const JVScratch& s,
                                    float* out_v, int* out_i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, val, off);
    int oi = __shfl_down_sync(0xffffffffu, idx, off);
    if (ov < val || (ov == val && oi < idx)) {
      val = ov;
      idx = oi;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s.red_v[warp] = val;
    s.red_i[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    val = lane < nw ? s.red_v[lane] : INFINITY;
    idx = lane < nw ? s.red_i[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_down_sync(0xffffffffu, val, off);
      int oi = __shfl_down_sync(0xffffffffu, idx, off);
      if (ov < val || (ov == val && oi < idx)) {
        val = ov;
        idx = oi;
      }
    }
    if (lane == 0) {
      s.red_v[32] = val;
      s.red_i[32] = idx;
    }
  }
  __syncthreads();
  *out_v = s.red_v[32];
  *out_i = s.red_i[32];
}

// Cost of (row i, column j) for the row being augmented: frozen or vetoed
// columns are ineligible.
__device__ __forceinline__ float jv_cost(const float* aug, int nc, int i,
                                         int j, int my_level,
                                         const int* owner_level,
                                         const int* col_veto) {
  if (owner_level[j] < my_level) return kBig;
  if (col_veto != nullptr && col_veto[j] > 0) return kBig;
  return aug[(long long)i * nc + j];
}

// One cascade sweep. Outputs row_assign[r] (augmented column per row, -1
// unmatched) and col_owner[nc] (row per column, -1 free).
//   col_veto     optional [nc]: nonzero = column ineligible (stage B: real
//                columns taken by stage A)
//   skip_assign  optional [r]: rows whose skip_assign lies in [0, c_real)
//                stay unmatched (stage B: rows that took a real column in A)
// Inline: several translation units include this header (tracker.cu,
// assignment.cu) and are linked into one library.
__device__ inline void jv_run_stage(const float* aug, int r, int nc,
                             const int* order, const int* levels,
                             int n_active, const int* col_veto,
                             const int* skip_assign, int c_real,
                             int* row_assign, int* col_owner,
                             const JVScratch& s) {
  for (int j = threadIdx.x; j < nc; j += blockDim.x) {
    col_owner[j] = -1;
    s.owner_level[j] = kLevelInactive;
    s.v[j] = 0.0f;
  }
  for (int i = threadIdx.x; i < r; i += blockDim.x) row_assign[i] = -1;
  __syncthreads();

  for (int k = 0; k < n_active; ++k) {
    const int row = order[k];
    if (skip_assign != nullptr) {
      const int a = skip_assign[row];
      if (a >= 0 && a < c_real) continue;  // uniform over the block
    }
    const int my_level = levels[row];
    for (int j = threadIdx.x; j < nc; j += blockDim.x) {
      s.d[j] = jv_cost(aug, nc, row, j, my_level, s.owner_level, col_veto) -
               s.v[j];
      s.pred[j] = row;
      s.todo[j] = 1;
    }
    __syncthreads();

    int j_star = -1;
    for (int iter = 0; iter < nc && j_star < 0; ++iter) {
      float best = INFINITY;
      int best_j = INT_MAX;
      for (int j = threadIdx.x; j < nc; j += blockDim.x) {
        const float dj = s.todo[j] ? s.d[j] : kBig;
        if (dj < best) {  // ascending j: keeps the lowest index on ties
          best = dj;
          best_j = j;
        }
      }
      float mu;
      int j_min;
      block_argmin(best, best_j, s, &mu, &j_min);
      const int owner = col_owner[j_min];
      const bool is_free = owner < 0;
      if (!is_free) {
        const int i2 = owner;
        const float c2_jmin =
            jv_cost(aug, nc, i2, j_min, my_level, s.owner_level, col_veto) -
            s.v[j_min];
        for (int j = threadIdx.x; j < nc; j += blockDim.x) {
          if (j == j_min || !s.todo[j]) continue;
          const float c2 =
              jv_cost(aug, nc, i2, j, my_level, s.owner_level, col_veto) -
              s.v[j];
          const float alt = mu + c2 - c2_jmin;
          if (alt < s.d[j]) {
            s.d[j] = alt;
            s.pred[j] = i2;
          }
        }
      } else {
        j_star = j_min;
      }
      if (threadIdx.x == j_min % blockDim.x) s.todo[j_min] = 0;
      __syncthreads();
    }
    if (j_star < 0) continue;  // unreachable: the row's dummy is always free

    // dual update on scanned columns keeps reduced costs feasible
    const float mu_star = s.d[j_star];
    for (int j = threadIdx.x; j < nc; j += blockDim.x) {
      if (!s.todo[j]) s.v[j] = s.v[j] + s.d[j] - mu_star;
    }
    __syncthreads();
    if (threadIdx.x == 0) {  // augment along the predecessor chain
      int j = j_star;
      for (int guard = 0; guard <= r; ++guard) {
        const int i2 = s.pred[j];
        const int prev_j = row_assign[i2];
        col_owner[j] = i2;
        s.owner_level[j] = levels[i2];
        row_assign[i2] = j;
        if (i2 == row) break;
        j = prev_j;
      }
    }
    __syncthreads();
  }
}

}  // namespace ydt
