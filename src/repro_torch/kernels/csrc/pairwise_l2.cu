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
// against 4*n*m bytes of output.  At one Covtype-shaped class-0 assignment
// block (11,995 x 22,378 x 54) that is 2.9e10 operations with the epilogue
// (0.449 ms at 67 TFLOP/s) and 1.07 GB written (0.32 ms at 3.35 TB/s): near
// the ridge, so the stores have to overlap the FMAs.  IEEE fp32 FMAs, no
// TF32 (index parity with the reference).
//
// Design: persistent CTAs, resident rows, streamed columns.
//   * Work items are (row block of ROWS = 88, column tile of COLS = 256),
//     in row-block-major order.  The grid is as many CTAs as the card holds
//     at once (one an SM); CTA b walks the contiguous items
//     [b*N/G, (b+1)*N/G), so the load is balanced within one item and a CTA
//     changes row block once or twice.
//   * Eleven consumer warps each own 8 rows of the row block.  A warp keeps
//     its rows' x in its own slice of shared memory, dim-major ([dim][8]:
//     a dim's 8 values are two broadcast 128-bit loads), restaged when the
//     row block changes, and their sqx in registers.  With the producer
//     that is 12 warps, one CTA an SM at 168 registers a thread (a 13th
//     warp would cap them at 128 and spill).
//   * Column (medoid) tiles stream through an NS = 3 stage ring on
//     full/empty mbarriers (mbarrier_ring.cuh), filled by a producer warp.
//     At d = 2 mod 4, d <= DCAP, with aligned operands a full tile is two
//     bulk copies (its 256 rows of y at pitch d, and their sqy).  Other d,
//     the ragged last tile and unaligned operands are staged by the
//     producer's own loads at a pitch of 2 mod 4, zero-filled past m and d.
//     Past DCAP dims each stage carries a KC = 32 dim chunk of the columns,
//     and each warp restages the matching chunk of its rows.
//   * Lane l owns columns l + 32 j (j < 8) of a tile, so a thread computes
//     8 x 8 pairs: per 2 dims, 8 float2 column loads (conflict-free at a
//     pitch of 2 mod 4) and 4 broadcast float4 row loads for 128 FMAs.  Each
//     pair is one fmaf chain from 0 over the dims in ascending order (zero
//     padding adds nothing): the order that keeps the distances bitwise
//     equal across versions of this kernel (chip_variants.py --l2-baseline).
//   * Epilogue straight from registers, the reference's expression with
//     the correctly rounded branch-free root (ring::sqrt_rn, bitwise sqrtf):
//     for each row and j a warp stores 32 consecutive floats (128 bytes)
//     with st.global.cs.  A stage is released before the epilogue, and while
//     one warp stores the other warps compute: the stores overlap the FMAs.
//   * Ragged n, m and d are masked in the kernel; no padding by the caller.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier_ring.cuh"

namespace {

using namespace ring;

constexpr int WARPS = 11;                   // consumer warps: 12 with the producer
constexpr int THREADS = 32 * (WARPS + 1);   // + one producer warp
constexpr int TN = 8;                       // rows per warp (a multiple of 4)
constexpr int TM = 8;                       // columns per lane: lane + 32 j
constexpr int ROWS = WARPS * TN;            // rows per item
constexpr int COLS = 32 * TM;               // columns per item
constexpr int NS = 3;                       // ring stages
constexpr int DCAP = 58;                    // widest d in one pass
constexpr int KC = 32;                      // chunk width past DCAP

// Shared-memory plan (floats), sized on the host by the same function.
struct Plan {
  bool resident;  // d <= DCAP: one pass over d, rows staged once a row block
  int cp;         // column pitch in a stage: 2 mod 4
  int kw;         // dims a pass walks (even; zero past d)
  int nch;        // passes over d per item
  int xw;         // dims of a warp's row slice
  int stage_floats;
  __host__ __device__ Plan(int d) {
    resident = d <= DCAP;
    if (resident) {
      cp = d + (6 - d % 4) % 4;  // the smallest pitch >= d that is 2 mod 4
      kw = d + (d & 1);
      nch = 1;
      xw = cp;
    } else {
      cp = KC + 2;
      kw = KC;
      nch = (d + KC - 1) / KC;
      xw = KC;
    }
    stage_floats = COLS * cp + COLS;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * ((size_t)NS * stage_floats + (size_t)WARPS * TN * xw) + 16 * NS;
  }
};

// This warp's TN rows of x, dims [k0, k0 + xw), into xs as [dim][TN], zero
// past n and d.
__device__ __forceinline__ void stage_rows(float* xs, const float* __restrict__ x, int r0,
                                           int n, int d, int k0, int xw, int lane) {
  __syncwarp();  // every lane is done with the previous rows
  for (int t = lane; t < TN * xw; t += 32) {
    const int i = t / xw, kk = t % xw;
    const int r = r0 + i, k = k0 + kk;
    xs[kk * TN + i] = (r < n && k < d) ? x[(size_t)r * d + k] : 0.f;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS, 1)
    pairwise_l2_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       const float* __restrict__ sqx, const float* __restrict__ sqy,
                       float* __restrict__ out, int n, int m, int d, int bulk) {
  extern __shared__ __align__(16) float smem[];
  const Plan plan(d);
  float* stages = smem;                                      // NS x [COLS][cp] + [COLS]
  float* xrows = stages + NS * plan.stage_floats;            // WARPS x [xw][TN]
  const uint32_t full0 = smem_u32(xrows + WARPS * TN * plan.xw);
  const uint32_t empty0 = full0 + 8 * NS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ntc = (m + COLS - 1) / COLS;
  const long long total = (long long)((n + ROWS - 1) / ROWS) * ntc;
  const long long t_begin = total * blockIdx.x / gridDim.x;
  const long long t_end = total * (blockIdx.x + 1) / gridDim.x;

  if (tid == 0) ring_init(full0, empty0, NS, 32, WARPS);
  __syncthreads();

  if (warp == WARPS) {
    // ---- producer warp: fill the ring ---------------------------------------
    long long it = 0;
    for (long long t = t_begin; t < t_end; ++t) {
      const int c0 = (int)(t % ntc) * COLS;
      for (int ch = 0; ch < plan.nch; ++ch, ++it) {
        const int s = (int)(it % NS);
        mbar_wait(empty0 + 8 * s, (uint32_t)((it / NS) & 1) ^ 1u);
        float* cs = stages + s * plan.stage_floats;  // [COLS][cp]
        float* sc = cs + COLS * plan.cp;             // [COLS]
        const uint32_t full = full0 + 8 * s;
        if (bulk && c0 + COLS <= m) {
          if (lane == 0) {
            mbar_expect_tx(full, sizeof(float) * (COLS * d + COLS));
            bulk_copy(cs, y + (size_t)c0 * d, sizeof(float) * COLS * d, full);
            bulk_copy(sc, sqy + c0, sizeof(float) * COLS, full);
          } else {
            mbar_arrive(full);
          }
          continue;
        }
        const int k0 = ch * KC;
        const int cw = plan.resident ? plan.cp : KC;  // dims staged per column
        for (int t2 = lane; t2 < COLS * cw; t2 += 32) {
          const int cc = t2 / cw, kk = t2 % cw;
          const int c = c0 + cc, k = k0 + kk;
          cs[cc * plan.cp + kk] = (c < m && k < d) ? y[(size_t)c * d + k] : 0.f;
        }
        if (ch == plan.nch - 1)
          for (int cc = lane; cc < COLS; cc += 32) sc[cc] = c0 + cc < m ? sqy[c0 + cc] : 0.f;
        mbar_arrive(full);  // release: this lane's stores are visible first
      }
    }
    return;
  }

  // ---- consumer warps -------------------------------------------------------
  float* xs = xrows + warp * TN * plan.xw;  // this warp's rows, [xw][TN]
  float sx[TN];
  float acc[TN][TM];
  int cur_rb = -1;
  long long it = 0;
  for (long long t = t_begin; t < t_end; ++t) {
    const int rb = (int)(t / ntc);
    const int c0 = (int)(t % ntc) * COLS;
    const int r0 = rb * ROWS + warp * TN;  // this warp's first row
    if (rb != cur_rb) {
      cur_rb = rb;
#pragma unroll
      for (int i = 0; i < TN; ++i) sx[i] = r0 + i < n ? sqx[r0 + i] : 0.f;
      if (plan.resident) stage_rows(xs, x, r0, n, d, 0, plan.xw, lane);
    }
#pragma unroll
    for (int i = 0; i < TN; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
    float sy[TM];
    for (int ch = 0; ch < plan.nch; ++ch, ++it) {
      const int s = (int)(it % NS);
      if (!plan.resident) stage_rows(xs, x, r0, n, d, ch * KC, KC, lane);
      mbar_wait(full0 + 8 * s, (uint32_t)((it / NS) & 1));
      const float* cs = stages + s * plan.stage_floats;
      const float* cr = cs + lane * plan.cp;  // column lane; lane + 32 j at + 32 j cp
#pragma unroll 2
      for (int k = 0; k < plan.kw; k += 2) {
        float2 cv[TM];
#pragma unroll
        for (int j = 0; j < TM; ++j)
          cv[j] = *reinterpret_cast<const float2*>(cr + 32 * j * plan.cp + k);
        float x0[TN], x1[TN];  // rows' dims k and k + 1 (broadcast loads)
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          const float4 a = *reinterpret_cast<const float4*>(xs + k * TN + 4 * q);
          const float4 b = *reinterpret_cast<const float4*>(xs + (k + 1) * TN + 4 * q);
          x0[4 * q] = a.x, x0[4 * q + 1] = a.y, x0[4 * q + 2] = a.z, x0[4 * q + 3] = a.w;
          x1[4 * q] = b.x, x1[4 * q + 1] = b.y, x1[4 * q + 2] = b.z, x1[4 * q + 3] = b.w;
        }
#pragma unroll
        for (int i = 0; i < TN; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(x0[i], cv[j].x, acc[i][j]);
#pragma unroll
        for (int i = 0; i < TN; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(x1[i], cv[j].y, acc[i][j]);
      }
      if (ch == plan.nch - 1) {
#pragma unroll
        for (int j = 0; j < TM; ++j) sy[j] = cs[COLS * plan.cp + lane + 32 * j];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: the reference's distance, 128-byte streaming stores
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      const int r = r0 + i;
      if (r >= n) break;
      float* orow = out + (size_t)r * m + c0 + lane;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const float v = sqrt_rn(fmaxf((sx[i] + sy[j]) - 2.f * acc[i][j], 0.f));
        if (c0 + lane + 32 * j < m) __stcs(orow + 32 * j, v);
      }
    }
  }
}

// CTAs the card holds at once, and the shared memory of the kernel at d.
cudaError_t grid_size(int d, int* ctas, size_t* smem) {
  static int sms = 0;
  *smem = Plan(d).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      pairwise_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (err != cudaSuccess) return err;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pairwise_l2_kernel, THREADS,
                                                      *smem);
  *ctas = sms * per_sm;
  return err;
}

}  // namespace

extern "C" {

int pairwise_l2_f32(const void* x, const void* y, const void* sqx,
                    const void* sqy, void* out, int n, int m, int d,
                    void* stream) {
  if (n < 1 || m < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0;
  size_t smem = 0;
  const cudaError_t err = grid_size(d, &ctas, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ctas < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long items = (long long)((n + ROWS - 1) / ROWS) * ((m + COLS - 1) / COLS);
  const int grid = (int)(items < ctas ? items : ctas);
  const int bulk = d % 4 == 2 && d <= DCAP && aligned16(y) && aligned16(sqy);
  pairwise_l2_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(sqx), static_cast<const float*>(sqy),
      static_cast<float*>(out), n, m, d, bulk);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and CTAs per SM of the kernel at d.
int pairwise_l2_occupancy(int d, int* regs, int* ctas) {
  const size_t smem = Plan(d).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      pairwise_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, pairwise_l2_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, pairwise_l2_kernel, THREADS,
                                                        smem);
  if (err == cudaSuccess) *regs = attr.numRegs;
  return (int)err;
}

}  // extern "C"
