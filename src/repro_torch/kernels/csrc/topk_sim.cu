// Top-k similarity graph for Hopper (sm_90a): topk_sim.
//
// Replaces the TPU kernel
//   src/repro/kernels/topk_sim.py::topk_sim_pallas
// and computes what it computes: for every row i of x (n, d) fp32, the k
// largest similarities
//
//   s_ij = d_max - sqrt(max((sq_i + sq_j) - 2 * <x_i, x_j>, 0))
//
// over all columns j (itself included), vals (n, k) fp32 descending with
// their columns idx (n, k) int32, ties to the lower column (lax.top_k's
// stable order), for any 1 <= k <= n.  It builds the sparse engine's k-NN
// graph (core/engines/sparse.py::topk_graph) without the dense (n, n)
// matrix.
//
// What bounds it on an H100: 2*n^2*d fp32 operations on the CUDA cores (the
// inputs are O(n*d) bytes, the output O(n*k)).  At the Covtype-shaped
// class 0 (n = 223,780, d = 54) that is 5.41 TFLOP, 80.7 ms at 67 TFLOP/s.
// In issue slots a pair costs ~66 at d = 54 (1.125 a dim for the product
// with its shared loads, ~5 for the epilogue, the filter and the merge),
// ~98 ms at 1,980 MHz.  IEEE fp32 FMAs, no TF32 (index parity with the
// reference).
//
// Design: resident rows, streamed columns.
//   * Blocks run in no order, so each CTA owns ROWS = 88 rows and walks
//     every column tile of COLS = 128 in ascending order itself: this loop
//     takes the place of the Pallas grid's sequential column axis.
//   * The rows stay resident: the CTA stages its 88 rows once (row-major,
//     zero-padded to a multiple of 4 dims) and keeps their sq in registers.
//   * The column tiles stream through an NS = 4 stage ring on full/empty
//     mbarriers (mbarrier_ring.cuh), filled by a producer warp.  A full tile
//     at d = 2 mod 4, d <= DCAP, with aligned operands is one contiguous
//     range of x plus one of sq: two bulk copies from one lane, landing at
//     pitch d.  Other d, the ragged last tile and unaligned operands are
//     staged by the producer warp's own loads at a pitch of 2 mod 4,
//     zero-filled past n and d.  Past DCAP = 64 dims each stage carries a
//     KC = 64 chunk of the columns and the matching chunk of the rows.
//   * Eleven consumer warps each own 8 rows; lane l owns columns l, l + 32,
//     l + 64 and l + 96 of a tile.  Per 4 dims a thread reads 8 float4 of
//     rows (broadcast) and 8 float2 of columns (conflict-free: the pitch is
//     2 mod 4) for 128 FMAs, summed per pair in one fmaf chain from 0 over
//     the dims in ascending order.  A stage goes back through its `empty`
//     mbarrier, with no CTA-wide barrier inside the walk.  One CTA an SM:
//     with the register lists a thread takes 168 registers, and a
//     scheduler's register file holds 3 such warps (12 warps: 11 consumers
//     and the producer).
//   * Epilogue and filter: d2 = (sq_i + sq_j) - 2 dot for each pair, held
//     against a per-row bound (d2_bound) that every d2 whose similarity
//     beats the row's k-th value lies under.  Only a candidate takes the
//     root (the correctly rounded branch-free ring::sqrt_rn) and its exact
//     similarity decides; most tiles pass 32 compares and 8 ballots a warp.
//   * Merge: a row's candidates of a tile sit in its warp's registers, 32
//     columns per register in ascending order, so the warp merges its rows
//     right after its epilogue while the other warps compute.  A column
//     enters a row's list above position k only if its value is strictly
//     greater than the current k-th value (which starts at -inf, so any
//     column enters a list that is not yet full).  Columns arrive in
//     ascending order and an entry goes after every entry >= it, so equal
//     values keep ascending columns: lax.top_k's tie rule without any index
//     compare.  An insertion (about k*(1 + ln(n/k)) per row on shuffled
//     data) costs a few ballots and shuffles.
//   * Two list routes, chosen by k.  k <= 128: each row's list lives in the
//     registers of its warp, lane l holding positions l*KPL .. l*KPL+KPL-1
//     (KPL = ceil(k/32)); a candidate not above the k-th value sorts into
//     the slots past k - 1, which are never read, so it needs no compare of
//     its own.  k > 128: each row's list is its own row of the outputs
//     vals/idx, sorted descending over the entries filled so far; an
//     insertion finds its place by ballots over 32 entries at a time from
//     the filled end and shifts the entries below it down by one.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mbarrier_ring.cuh"

namespace {

using namespace ring;

constexpr int WARPS = 11;        // consumer warps: 12 with the producer, 3 a scheduler
constexpr int THREADS = 32 * (WARPS + 1);  // + one producer warp
constexpr int TN = 8;            // rows per warp
constexpr int TM = 4;            // columns per lane: lane + 32 j
constexpr int ROWS = WARPS * TN; // resident rows per CTA
constexpr int COLS = 128;        // columns per streamed tile
constexpr int NS = 4;            // ring stages
constexpr int DCAP = 64;         // widest d kept resident
constexpr int KC = 64;           // chunk width past DCAP
constexpr int REG_K = 32 * 4;    // largest k of the register lists
constexpr unsigned FULL = 0xffffffffu;

static_assert(COLS == 32 * TM, "32 lanes x TM columns cover the tile");

// Shared-memory plan (floats), sized on the host by the same function.
struct Plan {
  bool resident;    // d <= DCAP: rows staged once, one pass over d
  int cp;           // column pitch in a stage: 2 mod 4
  int rp;           // row pitch: a multiple of 4
  int nch;          // d chunks per column tile
  int kfull;        // dims walked in float4 steps per stage
  int rows_floats;  // resident rows (0 when chunked)
  int stage_floats;
  __host__ __device__ Plan(int d) {
    resident = d <= DCAP;
    if (resident) {
      cp = d + (6 - d % 4) % 4;  // the smallest pitch >= d that is 2 mod 4
      rp = cp + 2;
      nch = 1;
      kfull = cp - 2;            // then one float2 step over the last 2 dims
      rows_floats = ROWS * rp;
      stage_floats = COLS * cp + COLS;
    } else {
      cp = KC + 2;
      rp = KC;
      nch = (d + KC - 1) / KC;
      kfull = KC;
      rows_floats = 0;
      stage_floats = COLS * cp + COLS + ROWS * rp;
    }
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * ((size_t)rows_floats + (size_t)NS * stage_floats) + 16 * NS;
  }
};

// Insert (v, c) into the warp's register list (lane-major, KPL per lane).
template <int KPL>
__device__ __forceinline__ void insert(float (&lv)[KPL], int (&li)[KPL],
                                       float v, int c, int lane) {
  int p = 0;  // entries >= v stay ahead of v
#pragma unroll
  for (int j = 0; j < KPL; ++j) p += __popc(__ballot_sync(FULL, lv[j] >= v));
  const float pv = __shfl_up_sync(FULL, lv[KPL - 1], 1);
  const int pi = __shfl_up_sync(FULL, li[KPL - 1], 1);
#pragma unroll
  for (int j = KPL - 1; j >= 0; --j) {
    const int q = lane * KPL + j;
    const float prev_v = j > 0 ? lv[j > 0 ? j - 1 : 0] : pv;
    const int prev_i = j > 0 ? li[j > 0 ? j - 1 : 0] : pi;
    if (q > p) {
      lv[j] = prev_v;
      li[j] = prev_i;
    } else if (q == p) {
      lv[j] = v;
      li[j] = c;
    }
  }
}

// The value at register-list position k - 1, broadcast to the warp.
template <int KPL>
__device__ __forceinline__ float kth(const float (&lv)[KPL], int kslot,
                                     int klane) {
  float t = lv[0];
#pragma unroll
  for (int j = 1; j < KPL; ++j)
    if (j == kslot) t = lv[j];
  return __shfl_sync(FULL, t, klane);
}

// Insert (v, c) into a row list held in memory: entries [0, cnt) sorted
// descending, v greater than the k-th value (so it lands above position k).
// Returns the new k-th value (-inf while the list is not full).
__device__ __forceinline__ float insert_mem(float* lv, int* li, int k, int& cnt, float v,
                                            int c, int lane) {
  int p = cnt;  // the entries < v are a suffix of [0, cnt)
  for (int top = cnt - 1; top >= 0; top -= 32) {
    const int q = top - lane;
    const unsigned below = __ballot_sync(FULL, q >= 0 && lv[q] < v);
    p -= __popc(below);
    if (below != FULL) break;
  }
  const int e = min(cnt, k - 1);  // entries [p, e) move down one place
  for (int top = e - 1; top >= p; top -= 32) {
    const int src = top - lane;
    const bool act = src >= p;
    float sv = 0.f;
    int si = 0;
    if (act) {
      sv = lv[src];
      si = li[src];
    }
    __syncwarp();
    if (act) {
      lv[src + 1] = sv;
      li[src + 1] = si;
    }
    __syncwarp();
  }
  if (lane == 0) {
    lv[p] = v;
    li[p] = c;
  }
  cnt = min(cnt + 1, k);
  __syncwarp();
  return cnt == k ? lv[k - 1] : -INFINITY;
}

// Every d2 whose similarity dmax - sqrt_rn(max(d2, 0)) exceeds thr is <= the
// returned bound: the pre-filter of the merge, slack far above rounding
// (+inf for thr = -inf).  Only the exact similarity decides an entry.
__device__ __forceinline__ float d2_bound(float thr, float dmax) {
  const float s =
      ((dmax - thr) + (fabsf(thr) + fabsf(dmax)) * 0x1p-20f + 1e-30f) * (1.f + 0x1p-18f);
  return s * s * (1.f + 0x1p-18f);
}

// KPL > 0: register lists (k <= 32 * KPL); KPL == 0: lists in vals/idx.
template <int KPL>
__global__ void __launch_bounds__(THREADS, 1)
    topk_sim_kernel(const float* __restrict__ x, const float* __restrict__ sq,
                    const float* __restrict__ dmax_p, float* __restrict__ vals,
                    int* __restrict__ idx, int n, int d, int k, int bulk) {
  extern __shared__ __align__(16) float smem[];
  const Plan plan(d);
  float* rows = smem;                                  // [ROWS][rp], resident
  float* stages = rows + plan.rows_floats;             // NS x stage
  const uint32_t full0 = smem_u32(stages + NS * plan.stage_floats);
  const uint32_t empty0 = full0 + 8 * NS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * ROWS;
  const int items = (n + COLS - 1) / COLS * plan.nch;

  if (tid == 0) ring_init(full0, empty0, NS, 32, WARPS);
  if (plan.resident) {  // the rows, once, zero past n and d
    for (int t = tid; t < ROWS * plan.rp; t += THREADS) {
      const int rr = t / plan.rp, kk = t % plan.rp;
      const int r = r0 + rr;
      rows[t] = (r < n && kk < d) ? x[(size_t)r * d + kk] : 0.f;
    }
  }
  __syncthreads();

  if (warp == WARPS) {
    // ---- producer warp: fill the ring -------------------------------------
    for (int it = 0; it < items; ++it) {
      const int s = it % NS, c0 = it / plan.nch * COLS, k0 = it % plan.nch * KC;
      mbar_wait(empty0 + 8 * s, ((it / NS) & 1) ^ 1);
      float* cs = stages + s * plan.stage_floats;  // [COLS][cp]
      float* sc = cs + COLS * plan.cp;             // [COLS]
      float* rs = sc + COLS;                       // [ROWS][rp], chunked
      const uint32_t full = full0 + 8 * s;
      if (bulk && c0 + COLS <= n) {
        if (lane == 0) {
          mbar_expect_tx(full, sizeof(float) * (COLS * d + COLS));
          bulk_copy(cs, x + (size_t)c0 * d, sizeof(float) * COLS * d, full);
          bulk_copy(sc, sq + c0, sizeof(float) * COLS, full);
        } else {
          mbar_arrive(full);
        }
        continue;
      }
      const int kw = plan.resident ? plan.cp : KC;  // dims staged per column
      for (int t = lane; t < COLS * kw; t += 32) {
        const int cc = t / kw, kk = t % kw;
        const int c = c0 + cc, kd = k0 + kk;
        cs[cc * plan.cp + kk] = (c < n && kd < d) ? x[(size_t)c * d + kd] : 0.f;
      }
      for (int cc = lane; cc < COLS; cc += 32) sc[cc] = c0 + cc < n ? sq[c0 + cc] : 0.f;
      if (!plan.resident) {
        for (int t = lane; t < ROWS * KC; t += 32) {
          const int rr = t / KC, kk = t % KC;
          const int r = r0 + rr, kd = k0 + kk;
          rs[rr * plan.rp + kk] = (r < n && kd < d) ? x[(size_t)r * d + kd] : 0.f;
        }
      }
      mbar_arrive(full);  // release: this lane's stores are visible first
    }
    return;
  }

  // ---- consumer warps -------------------------------------------------------
  constexpr int KA = KPL > 0 ? KPL : 1;
  const float dmax = *dmax_p;
  const int wr = r0 + warp * TN;  // this warp's first row
  float sx[TN];
#pragma unroll
  for (int i = 0; i < TN; ++i) sx[i] = wr + i < n ? sq[wr + i] : 0.f;
  float bnd[TN];  // d2 bound of a candidate: +inf until the list is full
  float lv[TN][KA];
  int li[TN][KA];
  int cnt[TN];
#pragma unroll
  for (int i = 0; i < TN; ++i) {
    bnd[i] = wr + i < n ? INFINITY : -INFINITY;  // rows past n take nothing
    cnt[i] = 0;
#pragma unroll
    for (int j = 0; j < KA; ++j) {
      lv[i][j] = -INFINITY;
      li[i][j] = 0;
    }
  }
  const int kslot = KPL > 0 ? (k - 1) % KA : 0;
  const int klane = KPL > 0 ? (k - 1) / KA : 0;

  float acc[TN][TM];
  for (int it = 0; it < items; ++it) {
    const int s = it % NS, ch = it % plan.nch;
    mbar_wait(full0 + 8 * s, (it / NS) & 1);
    const float* cs = stages + s * plan.stage_floats;
    const float* cr = cs + lane * plan.cp;  // column lane; lane + 32 j at + 32 j cp
    const float* xr = (plan.resident ? rows : cs + COLS * plan.cp + COLS) + warp * TN * plan.rp;
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < TN; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
    }
#pragma unroll 2
    for (int k4 = 0; k4 < plan.kfull; k4 += 4) {
      float2 ca[TM], cb[TM];
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        ca[j] = *reinterpret_cast<const float2*>(cr + 32 * j * plan.cp + k4);
        cb[j] = *reinterpret_cast<const float2*>(cr + 32 * j * plan.cp + k4 + 2);
      }
#pragma unroll
      for (int i = 0; i < TN; ++i) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + i * plan.rp + k4);
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          acc[i][j] = fmaf(xv.x, ca[j].x, acc[i][j]);
          acc[i][j] = fmaf(xv.y, ca[j].y, acc[i][j]);
          acc[i][j] = fmaf(xv.z, cb[j].x, acc[i][j]);
          acc[i][j] = fmaf(xv.w, cb[j].y, acc[i][j]);
        }
      }
    }
    if (plan.resident) {  // the last 2 dims of the pitch
      const int k2 = plan.kfull;
      float2 ca[TM];
#pragma unroll
      for (int j = 0; j < TM; ++j)
        ca[j] = *reinterpret_cast<const float2*>(cr + 32 * j * plan.cp + k2);
#pragma unroll
      for (int i = 0; i < TN; ++i) {
        const float2 xv = *reinterpret_cast<const float2*>(xr + i * plan.rp + k2);
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          acc[i][j] = fmaf(xv.x, ca[j].x, acc[i][j]);
          acc[i][j] = fmaf(xv.y, ca[j].y, acc[i][j]);
        }
      }
    }
    if (ch != plan.nch - 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      continue;
    }
    const int c0 = it / plan.nch * COLS;
    float sy[TM];
#pragma unroll
    for (int j = 0; j < TM; ++j) sy[j] = cs[COLS * plan.cp + lane + 32 * j];
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);

    // epilogue: d2 = (sx + sy) - 2 dot in place of the dot products; NaN
    // past n (never a candidate)
#pragma unroll
    for (int i = 0; i < TN; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(-2.f, acc[i][j], sx[i] + sy[j]);
    if (c0 + COLS > n) {
#pragma unroll
      for (int j = 0; j < TM; ++j)
        if (c0 + lane + 32 * j >= n)
#pragma unroll
          for (int i = 0; i < TN; ++i) acc[i][j] = __int_as_float(0x7fffffff);
    }
    // rows with a candidate: a column whose d2 is within the row's bound
    unsigned hit = 0;
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      bool h = false;
#pragma unroll
      for (int j = 0; j < TM; ++j) h |= acc[i][j] <= bnd[i];
      hit |= (__ballot_sync(FULL, h) != 0u) << i;
    }

    // merge: row by row, 32 columns a step in ascending order, the exact
    // similarity of each candidate into the list
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      if (!((hit >> i) & 1u)) continue;  // warp-uniform
      const size_t base = (size_t)(wr + i) * k;
#pragma unroll 1
      for (int q = 0; q < TM; ++q) {
        const float d2 = q == 0 ? acc[i][0] : q == 1 ? acc[i][1] : q == 2 ? acc[i][2] : acc[i][3];
        const bool cand = d2 <= bnd[i];
        unsigned mask = __ballot_sync(FULL, cand);
        if (mask == 0u) continue;
        const float sv = cand ? dmax - sqrt_rn(fmaxf(d2, 0.f)) : -INFINITY;
        float thr;
        if constexpr (KPL > 0) {
          // A candidate not above the k-th value lands past position k - 1,
          // in slots that are never read: no compare needed per candidate.
          while (mask) {
            const int b = __ffs(mask) - 1;
            mask &= mask - 1;
            insert<KPL>(lv[i], li[i], __shfl_sync(FULL, sv, b), c0 + 32 * q + b, lane);
          }
          thr = kth<KPL>(lv[i], kslot, klane);
        } else {
          thr = cnt[i] == k ? vals[base + k - 1] : -INFINITY;
          while (mask) {
            const int b = __ffs(mask) - 1;
            mask &= mask - 1;
            const float v = __shfl_sync(FULL, sv, b);
            if (v > thr)
              thr = insert_mem(vals + base, idx + base, k, cnt[i], v, c0 + 32 * q + b, lane);
          }
        }
        bnd[i] = d2_bound(thr, dmax);
      }
    }
  }

  if constexpr (KPL > 0) {
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      const int r = wr + i;
      if (r >= n) break;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int q = lane * KPL + j;
        if (q < k) {
          vals[(size_t)r * k + q] = lv[i][j];
          idx[(size_t)r * k + q] = li[i][j];
        }
      }
    }
  }
}

template <int KPL>
int launch(const void* x, const void* sq, const void* dmax, void* vals, void* idx, int n,
           int d, int k, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;  // the default dynamic shared-memory cap
  const size_t smem = Plan(d).bytes();
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        topk_sim_kernel<KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const int bulk = d % 4 == 2 && d <= DCAP && aligned16(x) && aligned16(sq);
  topk_sim_kernel<KPL><<<(n + ROWS - 1) / ROWS, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(sq),
      static_cast<const float*>(dmax), static_cast<float*>(vals), static_cast<int*>(idx), n,
      d, k, bulk);
  return static_cast<int>(cudaGetLastError());
}

template <int KPL>
int occupancy(int d, int* regs, int* ctas) {
  const size_t smem = Plan(d).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      topk_sim_kernel<KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, topk_sim_kernel<KPL>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, topk_sim_kernel<KPL>, THREADS,
                                                        smem);
  if (err == cudaSuccess) *regs = attr.numRegs;
  return (int)err;
}

// The list route of k: KPL = ceil(k / 32) registers a lane, 0 for k > 128.
int route(int k) { return k > REG_K ? 0 : (k + 31) / 32; }

}  // namespace

extern "C" {

int topk_sim_f32(const void* x, const void* sq, const void* dmax, void* vals,
                 void* idx, int n, int d, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || d < 1 || k < 1 || k > n) return static_cast<int>(cudaErrorInvalidValue);
  switch (route(k)) {
    case 1: return launch<1>(x, sq, dmax, vals, idx, n, d, k, s);
    case 2: return launch<2>(x, sq, dmax, vals, idx, n, d, k, s);
    case 3: return launch<3>(x, sq, dmax, vals, idx, n, d, k, s);
    case 4: return launch<4>(x, sq, dmax, vals, idx, n, d, k, s);
    default: return launch<0>(x, sq, dmax, vals, idx, n, d, k, s);
  }
}

// Registers per thread and CTAs per SM of the kernel that (d, k) launches.
int topk_sim_occupancy(int d, int k, int* regs, int* ctas) {
  switch (route(k)) {
    case 1: return occupancy<1>(d, regs, ctas);
    case 2: return occupancy<2>(d, regs, ctas);
    case 3: return occupancy<3>(d, regs, ctas);
    case 4: return occupancy<4>(d, regs, ctas);
    default: return occupancy<0>(d, regs, ctas);
  }
}

}  // extern "C"
