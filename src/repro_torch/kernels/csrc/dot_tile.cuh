// One CTA's (64 x 128) tile of fp32 dot products, shared by pairwise_l2.cu,
// topk_sim.cu and fl_replay.cu.
//
//   acc[i][j] = <x[r0 + ty*TN + i, :], y[c0 + tx*TM + j, :]>
//
// for the thread with tx = lane (columns tx*TM .. tx*TM+3) and ty = warp
// (rows ty*TN .. ty*TN+7): each warp owns 8 whole rows of the tile.  The
// feature dim is walked in DK-wide chunks staged through shared memory and
// summed in ascending order with IEEE fp32 FMAs (no TF32: index parity with
// the reference needs fp32 products, as in fl_gains.cu).  Rows, columns and
// dims past the operands' ends read as 0; the caller masks the epilogue.
#pragma once

#include <cuda_runtime.h>

namespace dot_tile {

constexpr int ROWS = 64;      // x rows per CTA
constexpr int COLS = 128;     // y rows (tile columns) per CTA
constexpr int DK = 8;         // feature dims per staged chunk
constexpr int THREADS = 256;  // 8 warps
constexpr int TN = 8;         // rows per thread (a warp's rows)
constexpr int TM = 4;         // columns per thread
constexpr int PAD = 4;        // keeps the transposed stores bank-conflict free
constexpr unsigned FULL = 0xffffffffu;

static_assert(COLS == 32 * TM, "32 lanes x TM columns cover the tile");
static_assert(ROWS == (THREADS / 32) * TN, "8 warps x TN rows cover the tile");

struct Stage {
  float xs[DK][ROWS + PAD];
  float ys[DK][COLS + PAD];
};

__device__ __forceinline__ void compute(const float* __restrict__ x, int nx,
                                        const float* __restrict__ y, int ny,
                                        int d, int r0, int c0, Stage& sm,
                                        float (&acc)[TN][TM]) {
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
#pragma unroll
  for (int i = 0; i < TN; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += DK) {
    for (int t = tid; t < ROWS * DK; t += THREADS) {
      const int rr = t / DK, kk = t % DK;
      const int r = r0 + rr, k = k0 + kk;
      sm.xs[kk][rr] = (r < nx && k < d) ? x[(size_t)r * d + k] : 0.f;
    }
    for (int t = tid; t < COLS * DK; t += THREADS) {
      const int cc = t / DK, kk = t % DK;
      const int c = c0 + cc, k = k0 + kk;
      sm.ys[kk][cc] = (c < ny && k < d) ? y[(size_t)c * d + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      const float4 yv = *reinterpret_cast<const float4*>(&sm.ys[kk][tx * TM]);
      const float4 xa = *reinterpret_cast<const float4*>(&sm.xs[kk][ty * TN]);
      const float4 xb =
          *reinterpret_cast<const float4*>(&sm.xs[kk][ty * TN + 4]);
      const float xv[TN] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float yvv[TM] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int i = 0; i < TN; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(xv[i], yvv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The reference's distance: sqrt(max((sq_x + sq_y) - 2 * dot, 0)).
__device__ __forceinline__ float dist(float sqx, float sqy, float dot) {
  return sqrtf(fmaxf((sqx + sqy) - 2.f * dot, 0.f));
}

}  // namespace dot_tile
