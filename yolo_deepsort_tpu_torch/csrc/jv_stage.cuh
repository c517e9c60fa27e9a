// One stage of the Jonker-Volgenant matching cascade, solved by ONE warp
// (the algorithm of yolo_deepsort_tpu/ops/assignment.py; the TPU ran it as
// the stage runner _make_stage_runner of ops/assignment_pallas.py).
//
// Successive shortest augmenting paths over an augmented (R, C + R) cost:
// the real (R, C) block, then one private dummy column per row. Rows are
// processed in `order` (level-major); a column owned by a row of a lower
// level is frozen for the current row.
//
// Bound on the H100: latency. Almost every row finds a free column in its
// first Dijkstra step, so a stage costs (rows + steps) x the latency of one
// dependent step, not bytes or FLOPs, and one warp issues those steps with
// nothing to hide their latency. The design keeps each step short:
//   * one warp per stream and no block-wide barrier in the row loop: column
//     j belongs to lane j % 32, slot j / 32; each lane keeps d, v, the
//     column's gate (owner level, or INT_MIN when ineligible) and the
//     predecessor of its slots in registers, the todo and eligible flags as
//     bit masks (SLOTS = 4, 6, 8 or 16 per lane, NC <= 512), or, for a
//     larger NC, in lane-major shared memory (SLOTS = 0: column j at index
//     j, so a warp's accesses never share a bank);
//   * a Dijkstra step is a tree over the lane's slots (strict <, the lower
//     column kept on ties), then two warp reductions (redux.sync) on the
//     value's order key: the least value, then the least column among the
//     lanes that hold it; every lane receives both, and the minimum itself
//     comes back from the key, not a shuffle;
//   * no divergent branch inside a step: every lane prices every slot with
//     selects; only a slot wholly past the real columns skips its load, a
//     test that is the same for the whole warp;
//   * the real block is read from shared memory where the caller staged it
//     (ld.shared) and from device memory, through the same code, where it
//     does not fit; the dummy block is never stored: column C + i costs
//     `dummy` for row i and kBig for every other row;
//   * eligibility (column mask, veto by an earlier stage, cost <= maxd) is
//     applied as a column is read, so the caller stages the raw costs;
//   * the next row, its level and its skip entry are loaded a row ahead.
// The augment walk runs on the whole warp (its length is one column for
// almost every row, which then takes no load at all); the lane owning a
// column writes its state.
//
// Float arithmetic keeps the reference's operation order (`mu + c2 -
// c2_jmin`, `v + d - mu_star`) and must be compiled without FMA contraction
// (--fmad=false), so that a column priced at the 1e9 "ineligible" sentinel
// compares exactly as it does in the plain version. Argmin ties go to the
// lowest column index; -0 ties with +0, as a float compare has it.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace ydt {

constexpr float kBig = 1e9f;
constexpr int kLevelInactive = 1 << 30;
constexpr unsigned kFullMask = 0xffffffffu;

// One stage as the runner reads it. Pointers marked "shared" point to the
// block's shared memory.
struct JVStage {
  const float* real;  // (r, c) real costs, row-major, shared or device memory
  int r, c;           // rows, real columns; the stage has c + r columns
  float maxd;         // a real cost above it is ineligible (INFINITY: none)
  float dummy;        // the price of row i's own dummy column c + i
  const int* order;   // (r) rows in processing order (shared)
  const int* levels;  // (r) cascade level of each row (shared)
  int n_active;       // rows of `order` to process
  const unsigned char* col_ok;  // optional (c): 0 = real column ineligible
  const int* veto_owner;   // optional (c): >= 0 = taken by an earlier stage
  const int* skip_assign;  // optional (r): rows whose entry lies in [0, c)
                           // stay unmatched (they matched in an earlier stage)
};

// Bytes of shared memory the runner needs besides the caller's arrays: the
// lane columns of SLOTS = 0, lane-major.
__host__ __device__ inline size_t jv_lane_smem_bytes(int slots, int nc) {
  if (slots > 0) return 0;
  const size_t cols = (size_t)32 * ((nc + 31) / 32);
  return cols * (4 * sizeof(float) + 2);  // d, v, gate, pred; todo, ok
}

// Per-lane column state, SLOTS columns per lane in registers: d, v, the
// column's gate (the owner's level, or INT_MIN for an ineligible real
// column) and the predecessor per slot, the todo and eligible flags as bit
// masks (bit s = slot s). A slot index that is warp-uniform but not a
// compile-time constant is selected, never used as an index (an indexed
// register array would go to local memory).
template <int SLOTS>
struct LaneCols {
  float d[SLOTS], v[SLOTS];
  int gate[SLOTS], pred[SLOTS];
  unsigned todo = 0u, ok = 0u;
  __device__ __forceinline__ LaneCols(void*, int, int) {}
  __device__ __forceinline__ int slots() const { return SLOTS; }
  __device__ __forceinline__ float& D(int s) { return d[s]; }
  __device__ __forceinline__ float& V(int s) { return v[s]; }
  __device__ __forceinline__ int& GATE(int s) { return gate[s]; }
  __device__ __forceinline__ int& PRED(int s) { return pred[s]; }
  __device__ __forceinline__ bool todo_of(int s) const {
    return (todo >> s) & 1u;
  }
  __device__ __forceinline__ void set_todo(int s, bool x) {
    todo = x ? todo | (1u << s) : todo & ~(1u << s);
  }
  __device__ __forceinline__ void clear_todo_at(int s) { todo &= ~(1u << s); }
  // every live slot (j < nc) still to scan: one move for the whole mask
  __device__ __forceinline__ void set_todo_live(int lane, int nc) {
    todo = 0u;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) todo |= (32 * s + lane < nc) << s;
  }
  __device__ __forceinline__ bool ok_of(int s) const { return (ok >> s) & 1u; }
  __device__ __forceinline__ void set_ok(int s, bool x) {
    ok = x ? ok | (1u << s) : ok & ~(1u << s);
  }
  __device__ __forceinline__ int pred_at(int s) const {
    int out = pred[0];
#pragma unroll
    for (int k = 1; k < SLOTS; ++k) out = k == s ? pred[k] : out;
    return out;
  }
  __device__ __forceinline__ void set_gate_at(int s, int x) {
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) gate[k] = k == s ? x : gate[k];
  }
};

// Any number of slots: the same state lane-major in shared memory (column
// j at index j of each array).
template <>
struct LaneCols<0> {
  float *d, *v;
  int *gate, *pred;
  unsigned char *todo, *ok;
  int n, lane;
  __device__ __forceinline__ LaneCols(void* smem, int nslots, int lane_)
      : n(nslots), lane(lane_) {
    const int m = 32 * nslots;
    d = (float*)smem;
    v = d + m;
    gate = (int*)(v + m);
    pred = gate + m;
    todo = (unsigned char*)(pred + m);
    ok = todo + m;
  }
  __device__ __forceinline__ int slots() const { return n; }
  __device__ __forceinline__ float& D(int s) { return d[32 * s + lane]; }
  __device__ __forceinline__ float& V(int s) { return v[32 * s + lane]; }
  __device__ __forceinline__ int& GATE(int s) { return gate[32 * s + lane]; }
  __device__ __forceinline__ int& PRED(int s) { return pred[32 * s + lane]; }
  __device__ __forceinline__ bool todo_of(int s) const {
    return todo[32 * s + lane];
  }
  __device__ __forceinline__ void set_todo(int s, bool x) {
    todo[32 * s + lane] = x;
  }
  __device__ __forceinline__ void clear_todo_at(int s) {
    todo[32 * s + lane] = 0;
  }
  __device__ __forceinline__ void set_todo_live(int, int nc) {
    for (int s = 0; s < n; ++s) todo[32 * s + lane] = 32 * s + lane < nc;
  }
  __device__ __forceinline__ bool ok_of(int s) const {
    return ok[32 * s + lane];
  }
  __device__ __forceinline__ void set_ok(int s, bool x) {
    ok[32 * s + lane] = x;
  }
  __device__ __forceinline__ int pred_at(int s) const {
    return pred[32 * s + lane];
  }
  __device__ __forceinline__ void set_gate_at(int s, int x) {
    gate[32 * s + lane] = x;
  }
};

// A float's bits as an unsigned key with the float order (-0 as +0), and
// back (a -0 comes back as +0, which no compare tells apart).
__device__ __forceinline__ unsigned order_key(float f) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// One entry of the real block: a shared-memory load where the caller
// staged the block (kShared), a generic one where it lies in device memory.
template <bool kShared>
__device__ __forceinline__ float load_cost(const float* p) {
  if constexpr (kShared) {
    float x;
    asm("ld.shared.f32 %0, [%1];"
        : "=f"(x)
        : "r"((unsigned)__cvta_generic_to_shared(p)));
    return x;
  } else {
    return *p;
  }
}

// Cost of (row i, column j = 32 s + lane) for the row being augmented (level
// my_level), row_p pointing at row i of the real block; `gate` is the
// column's owner level, or INT_MIN for an ineligible real column: frozen,
// vetoed and ineligible columns cost kBig. A slot wholly past the real
// columns loads nothing (the test is uniform over the warp); otherwise
// selects only, so the warp never diverges and the loads of a row's slots
// are in flight together.
template <bool kShared>
__device__ __forceinline__ float jv_cost(const JVStage& st,
                                         const float* row_p, int i, int s,
                                         int lane, int gate, int my_level) {
  const int j = 32 * s + lane;
  const float dummy = (j - st.c == i) ? st.dummy : kBig;
  float cost = dummy;
  if (32 * s < st.c) {
    const int c_last = st.c - 1;
    const float x = load_cost<kShared>(row_p + (j < c_last ? j : c_last));
    const float real = x <= st.maxd ? x : kBig;
    cost = j < st.c ? real : dummy;
  }
  return gate < my_level ? kBig : cost;
}

// A lane's candidate of a Dijkstra step: its least (value, column), the
// lowest column on ties, with that column's v and gate.
struct Cand {
  float val;
  unsigned j;
  float v;
  int gate;
};

__device__ __forceinline__ Cand pick(const Cand& a, const Cand& b) {
  const bool t = b.val < a.val;  // a holds the lower columns: ties keep a
  return {t ? b.val : a.val, t ? b.j : a.j, t ? b.v : a.v,
          t ? b.gate : a.gate};
}

// The lane's candidate: d of a column still to scan, kBig of a scanned one
// (as the plain version's argmin sees them), +inf past the last column.
template <int SLOTS>
__device__ __forceinline__ Cand lane_candidate(LaneCols<SLOTS>& cols,
                                               int lane, int nc) {
  auto cand = [&](int s) -> Cand {
    const int j = 32 * s + lane;
    const float dj = cols.todo_of(s) ? cols.D(s) : j < nc ? kBig : INFINITY;
    return {dj, (unsigned)j, cols.V(s), cols.GATE(s)};
  };
  if constexpr (SLOTS > 0) {  // a tree: log2(SLOTS) dependent compares
    Cand c[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) c[s] = cand(s);
#pragma unroll
    for (int w = 1; w < SLOTS; w *= 2) {
#pragma unroll
      for (int s = 0; s + w < SLOTS; s += 2 * w) c[s] = pick(c[s], c[s + w]);
    }
    return c[0];
  } else {
    Cand best = cand(0);
    for (int s = 1; s < cols.slots(); ++s) best = pick(best, cand(s));
    return best;
  }
}

// One cascade sweep by the calling warp (all 32 lanes, warp-uniform
// control flow). Leaves row_assign[r] (augmented column per row, -1
// unmatched) and col_owner[c + r] (row per column, -1 free), both shared.
// SLOTS > 0 needs c + r <= 32 * SLOTS; SLOTS = 0 needs
// jv_lane_smem_bytes(0, c + r) bytes at lane_smem. kShared: st.real points
// to shared memory.
template <int SLOTS, bool kShared>
__device__ void jv_warp_stage(const JVStage& st, int* row_assign,
                              int* col_owner, void* lane_smem) {
  const int lane = threadIdx.x & 31;
  const int nc = st.c + st.r;
  LaneCols<SLOTS> cols(lane_smem, (nc + 31) / 32, lane);
#pragma unroll
  for (int s = 0; s < cols.slots(); ++s) {
    const int j = 32 * s + lane;
    bool ok = j < nc;
    if (j < st.c) {
      if (st.col_ok != nullptr) ok = st.col_ok[j] != 0;
      if (st.veto_owner != nullptr) ok = ok && st.veto_owner[j] < 0;
    }
    cols.V(s) = 0.0f;
    cols.GATE(s) = ok ? kLevelInactive : INT_MIN;
    cols.PRED(s) = -1;
    cols.D(s) = 0.0f;
    cols.set_todo(s, false);
    cols.set_ok(s, ok);
  }
  for (int j = lane; j < nc; j += 32) col_owner[j] = -1;
  for (int i = lane; i < st.r; i += 32) row_assign[i] = -1;
  __syncwarp();

  // the next row, its level and its skip entry are loaded a row ahead
  const int n = st.n_active;
  int next_row = n > 0 ? st.order[0] : 0;
  int next_level = st.levels[next_row];
  int next_skip = st.skip_assign != nullptr ? st.skip_assign[next_row] : -1;
  for (int k = 0; k < n; ++k) {
    const int row = next_row, my_level = next_level, skip = next_skip;
    next_row = st.order[k + 1 < n ? k + 1 : k];
    next_level = st.levels[next_row];
    if (st.skip_assign != nullptr) next_skip = st.skip_assign[next_row];
    if (skip >= 0 && skip < st.c) continue;  // uniform over the warp

    const float* row_p = st.real + (long long)row * st.c;
#pragma unroll
    for (int s = 0; s < cols.slots(); ++s) {
      cols.D(s) = jv_cost<kShared>(st, row_p, row, s, lane, cols.GATE(s),
                                   my_level) - cols.V(s);
      cols.PRED(s) = row;
    }
    cols.set_todo_live(lane, nc);

    int j_star = -1;
    float mu = 0.0f;
    for (int iter = 0; iter < nc && j_star < 0; ++iter) {
      const Cand best = lane_candidate(cols, lane, nc);
      const unsigned key = order_key(best.val);
      const unsigned kmin = __reduce_min_sync(kFullMask, key);
      const int j_min =
          (int)__reduce_min_sync(kFullMask, key == kmin ? best.j : ~0u);
      const int l_min = j_min & 31;
      mu = key_value(kmin);
      const int owner = col_owner[j_min];
      if (lane == l_min) cols.clear_todo_at(j_min >> 5);
      if (owner < 0) {
        j_star = j_min;
        break;
      }
      // relax every column still to scan through the owner's row
      const float v_min = __shfl_sync(kFullMask, best.v, l_min);
      const int gate_min = __shfl_sync(kFullMask, best.gate, l_min);
      const float* own_p = st.real + (long long)owner * st.c;
      const float c2_jmin =
          jv_cost<kShared>(st, own_p, owner, j_min >> 5, l_min, gate_min,
                           my_level) - v_min;
#pragma unroll
      for (int s = 0; s < cols.slots(); ++s) {
        const float c2 = jv_cost<kShared>(st, own_p, owner, s, lane,
                                          cols.GATE(s), my_level) -
                         cols.V(s);
        const float alt = mu + c2 - c2_jmin;
        const bool upd = cols.todo_of(s) && alt < cols.D(s);
        cols.D(s) = upd ? alt : cols.D(s);
        cols.PRED(s) = upd ? owner : cols.PRED(s);
      }
    }
    if (j_star < 0) continue;  // unreachable: the row's dummy is always free

    // dual update on scanned columns keeps reduced costs feasible; mu_star
    // is d of the free column just found, the last step's minimum
    const float mu_star = mu;
#pragma unroll
    for (int s = 0; s < cols.slots(); ++s) {
      const bool scanned = 32 * s + lane < nc && !cols.todo_of(s);
      const float nv = cols.V(s) + cols.D(s) - mu_star;
      cols.V(s) = scanned ? nv : cols.V(s);
    }
    // augment along the predecessor chain, the whole warp in step (for
    // almost every row the chain is the free column alone)
    int j = j_star;
    int i2 = __shfl_sync(kFullMask, cols.pred_at(j >> 5), j & 31);
    for (int guard = 0; guard <= st.r; ++guard) {
      const bool last = i2 == row;
      const int prev_j = last ? -1 : row_assign[i2];
      const int lvl2 = last ? my_level : st.levels[i2];
      if (!last) __syncwarp();  // every lane has read row_assign[i2]
      if (lane == (j & 31)) {
        col_owner[j] = i2;
        cols.set_gate_at(j >> 5, cols.ok_of(j >> 5) ? lvl2 : INT_MIN);
        row_assign[i2] = j;
      }
      if (last) break;
      __syncwarp();
      j = prev_j;
      i2 = __shfl_sync(kFullMask, cols.pred_at(j >> 5), j & 31);
    }
    __syncwarp();  // the new owners are seen by every lane
  }
}

// ---- helpers shared by the kernels that run the stage

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Consecutive 16-byte aligned pieces of dynamic shared memory.
struct Carve {
  unsigned char* p;
  template <typename T>
  __device__ T* take(size_t n) {
    T* out = (T*)p;
    p += round16(n * sizeof(T));
    return out;
  }
};

constexpr int kMaxDevices = 16;

// The current device and the largest dynamic shared memory a block may opt
// in to there.
inline cudaError_t optin_limit(int* device, int* limit) {
  cudaError_t e = cudaGetDevice(device);
  if (e != cudaSuccess) return e;
  if (*device < 0 || *device >= kMaxDevices) return cudaErrorInvalidDevice;
  return cudaDeviceGetAttribute(
      limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, *device);
}

// Copy n 4-byte words from device to shared memory with all threads of the
// block: 16-byte cp.async where both ends are 16-byte aligned, 4-byte ones
// elsewhere. The caller commits and waits (cp_async_wait_all).
__device__ inline void stage_words(void* dst, const void* src, int n) {
  const unsigned sdst = (unsigned)__cvta_generic_to_shared(dst);
  const char* gsrc = (const char*)src;
  int start = 0;
  if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       sdst + 16u * i),
                   "l"(gsrc + 16ll * i));
    start = 4 * n4;
  }
  for (int i = start + threadIdx.x; i < n; i += blockDim.x)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     sdst + 4u * i),
                 "l"(gsrc + 4ll * i));
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// order[rank_i] = i with rank_i = #{k : (lv_k, k) < (lv_i, i)}: the stable
// ascending sort of torch.argsort(stable=True), by the whole block.
__device__ inline void stable_order(const int* lv, int r, int* order) {
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    const int li = lv[i];
    int rank = 0;
#pragma unroll 4
    for (int k = 0; k < r; ++k) {
      const int lk = lv[k];
      rank += (lk < li || (lk == li && k < i)) ? 1 : 0;
    }
    order[rank] = i;
  }
}

// stable_order of two level vectors in one pass.
__device__ inline void stable_order2(const int* lv_a, const int* lv_b, int r,
                                     int* order_a, int* order_b) {
  for (int i = threadIdx.x; i < r; i += blockDim.x) {
    const int la = lv_a[i], lb = lv_b[i];
    int rank_a = 0, rank_b = 0;
#pragma unroll 4
    for (int k = 0; k < r; ++k) {
      const int ka = lv_a[k], kb = lv_b[k];
      rank_a += (ka < la || (ka == la && k < i)) ? 1 : 0;
      rank_b += (kb < lb || (kb == lb && k < i)) ? 1 : 0;
    }
    order_a[rank_a] = i;
    order_b[rank_b] = i;
  }
}

// Number of i < n with flag(i) != 0, on every thread of the block.
__device__ inline int block_count(const unsigned char* flag, int n) {
  int total = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + (int)threadIdx.x;
    total += __syncthreads_count(i < n && flag[i] != 0);
  }
  return total;
}

// The slot count the runner is instantiated with for nc columns: 4, 6, 8
// or 16 per lane in registers, 0 (lane-major shared memory) above 512.
__host__ __device__ inline int jv_slots_for(int nc) {
  return nc <= 128 ? 4 : nc <= 192 ? 6 : nc <= 256 ? 8 : nc <= 512 ? 16 : 0;
}

}  // namespace ydt
