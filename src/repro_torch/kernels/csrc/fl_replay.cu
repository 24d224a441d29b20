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
// 67 TFLOP/s; the product tile sets the pace (the walk below is ~1% of a
// tile's instructions).  In issue slots a pair costs ~2,240 at d = 2,048
// (1.08 a dim for the product with its shared loads, ~26 for the epilogue,
// the walk and the column sums), 4.5 ms at 1,980 MHz.  IEEE fp32 FMAs, no
// TF32 (index parity with the reference).
//
// Design: a pipelined fp32 product tile.
//   * The running max is per row, so rows are independent.  Each CTA owns
//     ROWS = 128 pool rows and walks the candidate tiles of COLS = 128 in
//     order.
//   * Both operands stream through an NS = 4 stage ring of KC = 32-dim
//     chunks (128 rows and 128 candidates a stage) on full/empty mbarriers
//     (mbarrier_ring.cuh).  A producer warp fills it with two tensor-map
//     boxes (cp.async.bulk.tensor, the TMA unit) a stage when d % 4 == 0 and
//     the operands are aligned: the TMA unit zero-fills rows past n,
//     candidates past m and dims past d, and lays each 128-byte row out in
//     the 128-byte swizzle.  Otherwise the producer stages the chunk into the
//     same layout with its own loads.  The loads of later chunks overlap the
//     FMAs of this one, and the K loop has no CTA-wide barrier.
//   * Eight consumer warps each own 16 rows; lane l owns candidates l,
//     l + 32, l + 64 and l + 96.  Per 4 dims a thread reads 16 float4 of
//     rows (broadcast) and 4 float4 of candidates (conflict-free: the
//     swizzle puts the same 4 dims of 8 consecutive candidates in 8
//     different 16-byte bank groups) for 256 FMAs, summed per pair in one
//     fmaf chain from 0 over the dims in ascending order.
//   * After the last chunk of a candidate tile the similarities (with the
//     branch-free correctly rounded root, ring::sqrt_rn) are parked in
//     shared memory.  One thread per row then walks the tile column by
//     column, keeping cur and the row's best (value, position) in
//     registers, and overwrites each similarity with its gain term.  Each
//     64-row half of the CTA sums its gain terms per column in row order
//     and writes its own row of part (ceil(n / 64), m); the wrapper sums
//     part over axis 0.  No atomics: two runs are bit-identical.
//   * Dead candidate columns (valid == 0) and columns past m carry -1e30;
//     rows past n start at cur = +inf, so they add nothing and are not
//     written.  Ragged n, m and d are handled in the kernel.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "mbarrier_ring.cuh"

namespace {

using namespace ring;

constexpr int ROWS = 128;        // pool rows per CTA
constexpr int PART = 64;         // pool rows per row of part
constexpr int COLS = 128;        // candidates per tile
constexpr int WARPS = 8;         // consumer warps
constexpr int THREADS = 32 * (WARPS + 1);  // + one producer warp
constexpr int TN = 16;           // rows per warp
constexpr int TM = 4;            // candidates per lane: lane + 32 j
constexpr int KC = 32;           // dims per ring stage: one 128-byte swizzled row
constexpr int NS = 4;            // ring stages
constexpr int SP = COLS + 1;     // walk tile pitch: conflict-free row walk
constexpr float DEAD = -1e30f;

static_assert(COLS == 32 * TM, "32 lanes x TM candidates cover the tile");
static_assert(ROWS == WARPS * TN, "8 warps x TN rows cover the row block");
static_assert(ROWS == 2 * PART && 2 * COLS == 32 * WARPS, "two halves, a column a thread");

constexpr int BOX_FLOATS = ROWS * KC;        // one operand's box (= COLS * KC)
constexpr int STAGE_FLOATS = 2 * BOX_FLOATS;  // rows, then candidates
constexpr size_t SMEM_BYTES = 1024 +         // room to align the stages to 1 KB
    sizeof(float) * ((size_t)NS * STAGE_FLOATS + ROWS * SP + ROWS) + 16 * NS;

// A 2-D box of a tensor map (coordinates: inner c0, outer c1) to shared
// dst, completing on bar; elements out of bounds land as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a row-major (rows, cols) fp32 matrix (cols % 4 == 0, 16-byte
// aligned), boxes of 32 columns x box_rows rows with the 128-byte swizzle:
// element (r, c) of a box lands at float r * 32 + ((c / 4) ^ (r % 8)) * 4 +
// c % 4 of a 1024-byte-aligned destination.
bool f32_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Float offset of dims 4c .. 4c+3 of row r in a swizzled box.
__device__ __forceinline__ int swz(int r, int c) { return r * KC + ((c ^ (r & 7)) << 2); }

__global__ void __launch_bounds__(THREADS, 1)
    fl_replay_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_e,
                     const float* __restrict__ x, const float* __restrict__ e,
                     const float* __restrict__ sqx,
                     const float* __restrict__ sqe,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ dmax_p,
                     const float* __restrict__ cur0,
                     float* __restrict__ part, float* __restrict__ cur_out,
                     float* __restrict__ bv_out, int* __restrict__ bi_out,
                     int n, int m, int d, int tma) {
  extern __shared__ __align__(16) float smem_raw[];
  // the swizzled boxes need 1024-byte-aligned stages
  float* stages = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023) / 4;
  float* st = stages + NS * STAGE_FLOATS;  // [ROWS][SP] similarities, then gain terms
  float* sxs = st + ROWS * SP;             // [ROWS] sqx of the CTA's rows
  const uint32_t full0 = smem_u32(sxs + ROWS);
  const uint32_t empty0 = full0 + 8 * NS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * ROWS;
  const int nch = (d + KC - 1) / KC;
  const int items = (m + COLS - 1) / COLS * nch;

  if (tid == 0) ring_init(full0, empty0, NS, 32, WARPS);
  for (int t = tid; t < ROWS; t += THREADS) sxs[t] = r0 + t < n ? sqx[r0 + t] : 0.f;
  __syncthreads();

  if (warp == WARPS) {
    // ---- producer warp: fill the ring -------------------------------------
    for (int it = 0; it < items; ++it) {
      const int s = it % NS, c0 = it / nch * COLS, k0 = it % nch * KC;
      mbar_wait(empty0 + 8 * s, ((it / NS) & 1) ^ 1);
      float* xs = stages + s * STAGE_FLOATS;
      float* es = xs + BOX_FLOATS;
      const uint32_t full = full0 + 8 * s;
      if (tma) {
        if (lane == 0) {
          mbar_expect_tx(full, sizeof(float) * STAGE_FLOATS);
          tma_load_2d(xs, &tm_x, full, k0, r0);
          tma_load_2d(es, &tm_e, full, k0, c0);
        } else {
          mbar_arrive(full);
        }
        continue;
      }
      for (int t = lane; t < ROWS * (KC / 4); t += 32) {
        const int rr = t / (KC / 4), c = t % (KC / 4);
        float* dst = xs + swz(rr, c);
        for (int kk = 0; kk < 4; ++kk) {
          const int r = r0 + rr, kd = k0 + 4 * c + kk;
          dst[kk] = (r < n && kd < d) ? x[(size_t)r * d + kd] : 0.f;
        }
      }
      for (int t = lane; t < COLS * (KC / 4); t += 32) {
        const int cc = t / (KC / 4), c = t % (KC / 4);
        float* dst = es + swz(cc, c);
        for (int kk = 0; kk < 4; ++kk) {
          const int g = c0 + cc, kd = k0 + 4 * c + kk;
          dst[kk] = (g < m && kd < d) ? e[(size_t)g * d + kd] : 0.f;
        }
      }
      mbar_arrive(full);  // release: this lane's stores are visible first
    }
    return;
  }

  // ---- consumer warps -------------------------------------------------------
  const float dmax = *dmax_p;
  // row state of the walking thread (tid < ROWS owns row r0 + tid)
  const int rw = r0 + tid;
  float cur = (tid < ROWS && rw < n) ? cur0[rw] : INFINITY;
  float bv = DEAD;
  int bi = 0;

  float acc[TN][TM];
  for (int it = 0; it < items; ++it) {
    const int s = it % NS, ch = it % nch;
    mbar_wait(full0 + 8 * s, (it / NS) & 1);
    const float* xr = stages + s * STAGE_FLOATS + warp * TN * KC;  // this warp's rows
    const float* er = stages + s * STAGE_FLOATS + BOX_FLOATS + lane * KC;  // candidate lane
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < TN; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < KC / 4; ++c) {
      const int ec = (c ^ (lane & 7)) << 2;  // swizzled: (lane + 32 j) % 8 == lane % 8
      float4 ev[TM];
#pragma unroll
      for (int j = 0; j < TM; ++j)
        ev[j] = *reinterpret_cast<const float4*>(er + 32 * j * KC + ec);
#pragma unroll
      for (int i = 0; i < TN; ++i) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + swz(i, c));  // (16 w + i) % 8 == i % 8
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          acc[i][j] = fmaf(xv.x, ev[j].x, acc[i][j]);
          acc[i][j] = fmaf(xv.y, ev[j].y, acc[i][j]);
          acc[i][j] = fmaf(xv.z, ev[j].z, acc[i][j]);
          acc[i][j] = fmaf(xv.w, ev[j].w, acc[i][j]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    if (ch != nch - 1) continue;

    // the tile's similarities, parked for the walk
    const int c0 = it / nch * COLS;
    float se[TM];
    bool live[TM];
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int c = c0 + lane + 32 * j;
      live[j] = c < m && valid[c] != 0;
      se[j] = c < m ? sqe[c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      const float sxi = sxs[warp * TN + i];
#pragma unroll
      for (int j = 0; j < TM; ++j)
        st[(warp * TN + i) * SP + lane + 32 * j] =
            live[j] ? dmax - sqrt_rn(fmaxf(fmaf(-2.f, acc[i][j], sxi + se[j]), 0.f)) : DEAD;
    }
    consumers_sync(32 * WARPS);

    const int cols = min(COLS, m - c0);
    if (tid < ROWS) {
      float* row = st + tid * SP;
      for (int t = 0; t < cols; ++t) {
        const float sv = row[t];
        row[t] = fmaxf(sv - cur, 0.f);
        cur = fmaxf(cur, sv);
        if (sv > bv) {
          bv = sv;
          bi = c0 + t;
        }
      }
    }
    consumers_sync(32 * WARPS);
    {
      const int h = tid / COLS, c = tid % COLS;  // half h sums rows 64h .. 64h + 63
      if (c < cols && r0 + PART * h < n) {
        float g = 0.f;
        for (int r = 0; r < PART; ++r) g += st[(PART * h + r) * SP + c];
        part[(size_t)(blockIdx.x * 2 + h) * m + c0 + c] = g;
      }
    }
    consumers_sync(32 * WARPS);  // st is free for the next tile
  }

  if (tid < ROWS && rw < n) {
    cur_out[rw] = cur;
    bv_out[rw] = bv;
    bi_out[rw] = bi;
  }
}

bool smem_set = false;

int set_smem() {
  if (smem_set) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      fl_replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  smem_set = err == cudaSuccess;
  return (int)err;
}

}  // namespace

extern "C" {

// Pool rows per row of part: the caller sizes part as (ceil(n / rows), m).
int fl_replay_block_rows() { return PART; }

// A failed tensor-map encode returns cudaErrorInvalidValue.
int fl_replay_f32(const void* x, const void* e, const void* sqx,
                  const void* sqe, const void* valid, const void* dmax,
                  const void* cur0, void* part, void* cur, void* bv, void* bi,
                  int n, int m, int d, void* stream) {
  if (const int err = set_smem()) return err;
  const int tma = d % 4 == 0 && aligned16(x) && aligned16(e);
  CUtensorMap tm_x, tm_e;
  memset(&tm_x, 0, sizeof(tm_x));
  memset(&tm_e, 0, sizeof(tm_e));
  if (tma && !(f32_map(&tm_x, x, n, d, ROWS) && f32_map(&tm_e, e, m, d, COLS)))
    return (int)cudaErrorInvalidValue;
  fl_replay_kernel<<<(n + ROWS - 1) / ROWS, THREADS, SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_e, static_cast<const float*>(x), static_cast<const float*>(e),
      static_cast<const float*>(sqx), static_cast<const float*>(sqe),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(dmax),
      static_cast<const float*>(cur0), static_cast<float*>(part),
      static_cast<float*>(cur), static_cast<float*>(bv),
      static_cast<int*>(bi), n, m, d, tma);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and CTAs per SM of the kernel.
int fl_replay_occupancy(int* regs, int* ctas) {
  cudaError_t err = (cudaError_t)set_smem();
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fl_replay_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fl_replay_kernel, THREADS,
                                                        SMEM_BYTES);
  if (err == cudaSuccess) *regs = attr.numRegs;
  return (int)err;
}

}  // extern "C"
