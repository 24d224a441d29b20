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
// stable order).  It builds the sparse engine's k-NN graph
// (core/engines/sparse.py::topk_graph) without the dense (n, n) matrix.
//
// What bounds it on an H100: 2*n^2*d fp32 operations on the CUDA cores (the
// inputs are O(n*d) bytes, the output O(n*k)).  At the Covtype-shaped
// class 0 (n = 223,780, d = 54) that is 5.41 TFLOP, 80.7 ms at 67 TFLOP/s.
// IEEE fp32 FMAs, no TF32 (index parity with the reference).
//
// Design:
//   * Blocks run in no order, so each CTA owns 64 rows and walks every
//     column tile of 128 in ascending order itself: this loop takes the
//     place of the Pallas grid's sequential column axis.
//   * The similarity tile comes from dot_tile.cuh (a warp owns 8 whole
//     rows) and is parked in shared memory; the warp that computed a row
//     also merges it, so the merge needs only __syncwarp.
//   * Each row's running top list lives in the registers of its warp: lane
//     l holds positions l*KPL .. l*KPL+KPL-1 (KPL = ceil(k/32) <= 4), sorted
//     descending.  A column enters only if its value is strictly greater
//     than the current k-th value (which starts at -inf, so any column
//     enters a list that is not yet full).  Columns arrive in ascending
//     order and an entry goes after every entry >= it, so equal values keep
//     ascending columns: lax.top_k's tie rule without any index compare.
//     A candidate costs one compare; an insertion (about k*(1 + ln(n/k))
//     per row on shuffled data) costs KPL ballots and one shuffle.  This
//     replaces the Pallas kernel's k-pass selection sort over every tile
//     (O(k*n^2) compares).
//   * Ragged n and d are masked in the kernel (columns past n read -inf and
//     never enter); k <= 128, checked by the wrapper.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dot_tile.cuh"

namespace {

using namespace dot_tile;

constexpr int SPAD = 4;  // keeps the float4 tile rows 16-byte aligned

// Insert (v, c) into the warp's sorted list (lane-major, KPL per lane).
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

// The value at list position k - 1, broadcast to the warp.
template <int KPL>
__device__ __forceinline__ float kth(const float (&lv)[KPL], int kslot,
                                     int klane) {
  float t = lv[0];
#pragma unroll
  for (int j = 1; j < KPL; ++j)
    if (j == kslot) t = lv[j];
  return __shfl_sync(FULL, t, klane);
}

template <int KPL>
__global__ void __launch_bounds__(THREADS)
    topk_sim_kernel(const float* __restrict__ x, const float* __restrict__ sq,
                    const float* __restrict__ dmax_p,
                    float* __restrict__ vals, int* __restrict__ idx, int n,
                    int d, int k) {
  __shared__ __align__(16) Stage sm;
  __shared__ __align__(16) float st[ROWS][COLS + SPAD];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * ROWS;
  const int wr = warp * TN;  // this warp's first row within the tile
  const float dmax = *dmax_p;
  const int kslot = (k - 1) % KPL;
  const int klane = (k - 1) / KPL;

  float sx[TN];
#pragma unroll
  for (int i = 0; i < TN; ++i) {
    const int r = r0 + wr + i;
    sx[i] = r < n ? sq[r] : 0.f;
  }
  float lv[TN][KPL];
  int li[TN][KPL];
  float thr[TN];
#pragma unroll
  for (int i = 0; i < TN; ++i) {
    thr[i] = -INFINITY;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      lv[i][j] = -INFINITY;
      li[i][j] = 0;
    }
  }

  for (int c0 = 0; c0 < n; c0 += COLS) {
    float acc[TN][TM];
    compute(x, n, x, n, d, r0, c0, sm, acc);
    const int cb = c0 + lane * TM;
    float sy[TM];
#pragma unroll
    for (int j = 0; j < TM; ++j) sy[j] = cb + j < n ? sq[cb + j] : 0.f;
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      float v[TM];
#pragma unroll
      for (int j = 0; j < TM; ++j)
        v[j] = cb + j < n ? dmax - dist(sx[i], sy[j], acc[i][j]) : -INFINITY;
      *reinterpret_cast<float4*>(&st[wr + i][lane * TM]) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      for (int q = 0; q < COLS / 32; ++q) {
        const int cq = c0 + q * 32;
        if (cq >= n) break;  // warp-uniform
        const float sv = st[wr + i][q * 32 + lane];
        unsigned mask = __ballot_sync(FULL, sv > thr[i]);
        while (mask) {
          const int b = __ffs(mask) - 1;
          mask &= mask - 1;
          const float v = __shfl_sync(FULL, sv, b);
          if (v > thr[i]) {  // the list may have risen past it
            insert<KPL>(lv[i], li[i], v, cq + b, lane);
            thr[i] = kth<KPL>(lv[i], kslot, klane);
          }
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < TN; ++i) {
    const int r = r0 + wr + i;
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

template <int KPL>
int launch(const void* x, const void* sq, const void* dmax, void* vals,
           void* idx, int n, int d, int k, cudaStream_t stream) {
  topk_sim_kernel<KPL><<<(n + ROWS - 1) / ROWS, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(sq),
      static_cast<const float*>(dmax), static_cast<float*>(vals),
      static_cast<int*>(idx), n, d, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest k the kernel takes (the wrapper raises above it).
int topk_sim_max_k() { return 32 * 4; }

int topk_sim_f32(const void* x, const void* sq, const void* dmax, void* vals,
                 void* idx, int n, int d, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 128 || k > n) return static_cast<int>(cudaErrorInvalidValue);
  switch ((k + 31) / 32) {
    case 1: return launch<1>(x, sq, dmax, vals, idx, n, d, k, s);
    case 2: return launch<2>(x, sq, dmax, vals, idx, n, d, k, s);
    case 3: return launch<3>(x, sq, dmax, vals, idx, n, d, k, s);
    default: return launch<4>(x, sq, dmax, vals, idx, n, d, k, s);
  }
}

}  // extern "C"
