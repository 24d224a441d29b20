// Pairwise Euclidean distances for Hopper (sm_90a): pairwise_l2.
//
// Replaces the TPU kernel
//   src/repro/kernels/pairwise_l2.py::pairwise_l2_pallas
// and computes what it computes:
//
//   out[i, j] = sqrt(max((sqx_i + sqy_j) - 2 * <x_i, y_j>, 0))
//
// for x (n, d), y (m, d) fp32, sqx / sqy the fp32 squared row norms.  In the
// port it is the sparse engine's exact gamma assignment
// (core/engines/sparse.py::_blocked_assignment: distances of a block of
// pool rows to every selected medoid, then a min per row).
//
// What bounds it on an H100: 2*n*m*d fp32 operations on the CUDA cores
// against 4*n*m bytes of output.  At the Covtype-shaped class-0 assignment
// (223,780 x 22,378 x 54) that is 5.41e11 operations (8.1 ms at 67 TFLOP/s)
// and 20.0 GB written (6.0 ms at 3.35 TB/s): near the ridge, operations
// first.  IEEE fp32 FMAs, no TF32 (index parity with the reference).
//
// Design: one CTA per (64 x 128) output tile (dot_tile.cuh: 8 warps, each
// thread 8 rows x 4 columns, the feature dim staged in chunks of 8), then
// the norm epilogue straight from registers.  A warp owns 8 whole rows of
// the tile, so each row's 128 outputs leave as one 512-byte float4 store
// per warp when m is a multiple of 4 (scalar stores otherwise).  Ragged n,
// m and d are masked in the kernel; no padding by the caller.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dot_tile.cuh"

namespace {

using namespace dot_tile;

__global__ void __launch_bounds__(THREADS)
    pairwise_l2_kernel(const float* __restrict__ x,
                       const float* __restrict__ y,
                       const float* __restrict__ sqx,
                       const float* __restrict__ sqy,
                       float* __restrict__ out, int n, int m, int d) {
  __shared__ __align__(16) Stage sm;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int r0 = blockIdx.y * ROWS;
  const int c0 = blockIdx.x * COLS;

  float acc[TN][TM];
  compute(x, n, y, m, d, r0, c0, sm, acc);

  const int cb = c0 + tx * TM;
  float sy[TM];
#pragma unroll
  for (int j = 0; j < TM; ++j) sy[j] = cb + j < m ? sqy[cb + j] : 0.f;
  const bool vec = (m % 4 == 0) && (cb + TM <= m);
#pragma unroll
  for (int i = 0; i < TN; ++i) {
    const int r = r0 + ty * TN + i;
    if (r >= n) break;
    const float sx = sqx[r];
    float v[TM];
#pragma unroll
    for (int j = 0; j < TM; ++j) v[j] = dist(sx, sy[j], acc[i][j]);
    float* row = out + (size_t)r * m;
    if (vec) {
      *reinterpret_cast<float4*>(row + cb) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < TM; ++j)
        if (cb + j < m) row[cb + j] = v[j];
    }
  }
}

}  // namespace

extern "C" {

int pairwise_l2_f32(const void* x, const void* y, const void* sqx,
                    const void* sqy, void* out, int n, int m, int d,
                    void* stream) {
  const dim3 grid((m + COLS - 1) / COLS, (n + ROWS - 1) / ROWS);
  pairwise_l2_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(sqx), static_cast<const float*>(sqy),
      static_cast<float*>(out), n, m, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
