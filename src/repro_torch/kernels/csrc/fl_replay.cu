// Sequential facility-location replay for Hopper (sm_90a): fl_replay.
//
// Replaces the TPU kernel
//   src/repro/kernels/fl_gains.py::fl_replay_pallas
// and computes what it computes: the candidates e (m, d) are replayed in
// row order against the pool x (n, d), fp32, with
//
//   s_it  = dmax - sqrt(max((sqx_i + sqe_t) - 2 * <x_i, e_t>, 0))
//           (-1e30 where valid_t == 0: no gain, no cover, never wins)
//   gain_t = sum_i relu(s_it - cur_i),  then cur_i = max(cur_i, s_it)
//
// starting from cur = cur0, and each row's best candidate (value, position),
// strict > so the earliest position wins ties (jnp.argmax's rule).  It is the
// streaming finalize (core/engines/streaming.py::streaming_result_blocked):
// the gain sequence of a known pick order plus the gamma assignment, without
// the (n, m) similarity matrix.
//
// What bounds it on an H100: 2*n*m*d fp32 operations on the CUDA cores (the
// inputs are O((n + m) * d) bytes).  At the coreset service's finalize
// (n = 65,536, m = 1,024, d = 2,048) that is 2.75e11 operations, 4.1 ms at
// 67 TFLOP/s.  IEEE fp32 FMAs, no TF32 (index parity with the reference).
//
// Design:
//   * The running max is per row, so rows are independent.  Each CTA owns
//     64 rows and walks the candidate tiles of 128 in order; the tile of
//     similarities comes from dot_tile.cuh and is parked in shared memory.
//   * One thread per row then walks the tile column by column, keeping cur
//     and the row's best (value, position) in registers, and overwrites
//     each similarity with its gain term.  128 threads sum the tile's 64
//     gain terms per column in a fixed order and write this row block's
//     partial gain per candidate to part (row_blocks, m); the wrapper sums
//     part over axis 0.  No atomics: two runs are bit-identical.
//   * Dead candidate columns (valid == 0) and columns past m carry -1e30;
//     rows past n start at cur = +inf, so they add nothing and are not
//     written.  Ragged n, m and d are masked in the kernel.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dot_tile.cuh"

namespace {

using namespace dot_tile;

constexpr float DEAD = -1e30f;

__global__ void __launch_bounds__(THREADS)
    fl_replay_kernel(const float* __restrict__ x, const float* __restrict__ e,
                     const float* __restrict__ sqx,
                     const float* __restrict__ sqe,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ dmax_p,
                     const float* __restrict__ cur0,
                     float* __restrict__ part, float* __restrict__ cur_out,
                     float* __restrict__ bv_out, int* __restrict__ bi_out,
                     int n, int m, int d) {
  __shared__ __align__(16) Stage sm;
  __shared__ float st[ROWS][COLS + 1];  // pitch 129: conflict-free walk

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * ROWS;
  const float dmax = *dmax_p;

  float sx[TN];
#pragma unroll
  for (int i = 0; i < TN; ++i) {
    const int r = r0 + warp * TN + i;
    sx[i] = r < n ? sqx[r] : 0.f;
  }
  // row state of the walking thread (tid < ROWS owns row r0 + tid)
  const int rw = r0 + tid;
  float cur = (tid < ROWS && rw < n) ? cur0[rw] : INFINITY;
  float bv = DEAD;
  int bi = 0;

  for (int c0 = 0; c0 < m; c0 += COLS) {
    float acc[TN][TM];
    compute(x, n, e, m, d, r0, c0, sm, acc);
    const int cb = c0 + lane * TM;
    float se[TM];
    bool live[TM];
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      live[j] = cb + j < m && valid[cb + j] != 0;
      se[j] = cb + j < m ? sqe[cb + j] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TN; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j)
        st[warp * TN + i][lane * TM + j] =
            live[j] ? dmax - dist(sx[i], se[j], acc[i][j]) : DEAD;
    __syncthreads();

    const int cols = min(COLS, m - c0);
    if (tid < ROWS) {
      for (int t = 0; t < cols; ++t) {
        const float s = st[tid][t];
        st[tid][t] = fmaxf(s - cur, 0.f);
        cur = fmaxf(cur, s);
        if (s > bv) {
          bv = s;
          bi = c0 + t;
        }
      }
    }
    __syncthreads();
    if (tid < cols) {
      float g = 0.f;
      for (int r = 0; r < ROWS; ++r) g += st[r][tid];
      part[(size_t)blockIdx.x * m + c0 + tid] = g;
    }
    __syncthreads();
  }

  if (tid < ROWS && rw < n) {
    cur_out[rw] = cur;
    bv_out[rw] = bv;
    bi_out[rw] = bi;
  }
}

}  // namespace

extern "C" {

// Pool rows per CTA: the caller sizes part as (ceil(n / rows), m).
int fl_replay_block_rows() { return ROWS; }

int fl_replay_f32(const void* x, const void* e, const void* sqx,
                  const void* sqe, const void* valid, const void* dmax,
                  const void* cur0, void* part, void* cur, void* bv, void* bi,
                  int n, int m, int d, void* stream) {
  fl_replay_kernel<<<(n + ROWS - 1) / ROWS, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(e),
      static_cast<const float*>(sqx), static_cast<const float*>(sqe),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(dmax),
      static_cast<const float*>(cur0), static_cast<float*>(part),
      static_cast<float*>(cur), static_cast<float*>(bv),
      static_cast<int*>(bi), n, m, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
