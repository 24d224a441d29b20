// Fused CRAIG gradient proxy for token streams, written by hand for Hopper
// (sm_90a).  Replaces the TPU kernel repro/kernels/ce_proxy.py::ce_proxy_pallas.
//
// For each token t with hidden state h_t (D,), label y_t and the vocab-major
// unembedding W (V, D):
//
//     g_t = softmax(h_t Wᵀ) W − W[y_t]          (T, D) fp32
//
// without the (T, V) logits in device memory: the vocab is walked in blocks
// with an online max and sum in fp32 (columns at or past valid_v count as
// −∞).  The reference's one-hot product for the label column becomes a
// gather of W[y_t] in the compute dtype, which is the same value.  Ragged T,
// V and D are masked here; no caller pads.  p is rounded to the compute
// dtype before its product and the sum l stays fp32, as the reference
// computes them.
//
// bf16 (the main path), D ≤ 2048: flash-attention's structure with the head
// dim split over a thread-block cluster.
//   * Layout.  A cluster of C = ceil(D / 256) CTAs (≤ 8) owns BT = 128
//     tokens; CTA rank r owns output columns [256r, 256r + 256) and reads
//     only that column slice of h and W.  Its h slice (128 × 256 bf16,
//     64 KB) stays in shared memory; W's slice of each vocab block (64 rows ×
//     256, 32 KB) streams through a 3-stage ring.  Both are filled by TMA
//     (cp.async.bulk.tensor on 2-D tensor maps with 128-byte swizzle, zero
//     fill out of bounds for ragged T, V and D), signalled by mbarriers.  The
//     grid is (C, ceil(T / 128)), launched with cudaLaunchKernelEx and the
//     cluster-dimension attribute.
//   * Per vocab block j, in each CTA (two consumer warpgroups, 64 tokens
//     each):
//       1. the partial logits S_r = h[:, slice_r] · W_v[:, slice_r]ᵀ (128 × 64
//          fp32) with wgmma.mma_async m64n64k16 from shared memory, stored
//          to this CTA's shared memory;
//       2. cluster barrier; a reduce-scatter: CTA r finalizes tokens
//          [r·R, r·R + R), R = ceil(128 / C), loading the C partials from
//          distributed shared memory (all loads in flight together) and
//          summing them in rank order 0..C−1 (two runs are bit-identical),
//          updating the online max m and sum l (fp32) and rounding p to
//          bf16; it all-gathers p (bf16, 128 × 64) and the rescale factor c
//          into every CTA of the cluster;
//       3. while that gather completes (the second cluster barrier's arrive
//          and wait), the logits of block j + 1 are already issued;
//       4. acc = acc·c + P · W_v[:, slice_r] with wgmma m64n256k16, P read
//          from shared memory into registers as the A operand (its plain
//          stores then need no proxy fence) and the same W tile read as an
//          MN-major B operand.  Each consumer warpgroup holds 64 tokens ×
//          256 columns in fp32 registers (128 a thread).  P and c are read
//          before the next block's first barrier, so this product runs while
//          that barrier completes.
//     After the accumulate of block j − 1 both warpgroups meet at a named
//     barrier and one elected thread refills that stage with block j + 2.
//     There is no separate producer warp: the barriers already tell when a
//     stage is free.
//   * Epilogue: out = acc / l − W[y].
//   * W traffic: ceil(T / 128) · V · D elements through L2 (20 GB at T =
//     4,096, D = 2048, V = 151,936), against T/16 · V · D for a 16-token CTA.
//   * D % 8 ≠ 0 (TMA needs 16-byte row strides) or an unaligned base: the
//     same kernel stages h and W synchronously into the same swizzled layout
//     (all 256 threads, then a proxy fence and a named barrier).
//   * The tensor maps come from cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint(ByVersion): no -lcuda at build time.
//   Wider D is refused until a ported config needs it (ROADMAP.md queue 2,
//   "ce_proxy at D > 2048").
//
// fp32 (parity runs only, not redesigned): the accumulator in shared memory,
// at most 2048 columns per CTA (D split over blockIdx.y, logits recomputed
// per split), 16 tokens per CTA, IEEE fp32 FMAs on the CUDA cores (TF32
// would break parity with the reference).  It is slower than the plain
// twin's cuBLAS fp32 GEMMs.
//
// Bound on this card: operations, 4·T·V·D (5.1 TFLOP at T = 4,096, D = 2048,
// V = 151,936: 5.2 ms in bf16 at 989 TFLOP/s, 76 ms in fp32 at 67 TFLOP/s).
// The bf16 kernel does not reach it: each vocab block is a chain of
// latencies across the cluster (a cluster barrier, the distributed-shared-
// memory reduce-scatter, a second barrier), 2 · ceil(V / 64) barriers per
// cluster; the two products run inside the barriers' windows.
// chip_variants.py --ablate times each part.
//
// C entries return cudaGetLastError() after the launch (or the failing
// runtime or driver status before it).
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef unsigned short u16;  // bf16 bits, moved without conversion

constexpr int BT = 16;         // tokens per CTA
constexpr int BV = 128;        // vocab columns per block
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int DS_MAX = 2048;   // output columns per CTA
constexpr int KC32 = 64;       // K / column chunk of the fp32 kernel
constexpr int KP32 = KC32 + 1; // padded row of the fp32 W tile (no bank conflicts)

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// rows × kc tile of a row-major (n_rows, n_cols) fp32 matrix into dst (row
// stride ld ≥ kc), zero outside the matrix.
__device__ inline void load_tile_f32(float* dst, const float* __restrict__ src, int row0,
                                     int n_rows, int col0, int n_cols, int rows, int kc,
                                     int ld) {
  for (int i = threadIdx.x; i < rows * kc; i += THREADS) {
    const int r = i / kc, c = i % kc;
    const int gr = row0 + r, gc = col0 + c;
    dst[r * ld + c] = (gr < n_rows && gc < n_cols) ? src[(size_t)gr * n_cols + gc] : 0.f;
  }
}

// Online softmax over one vocab block: each warp takes rows warp, warp+8.
// Updates m, l; writes the rescale factor c and p = exp(z − m_new).
__device__ inline void softmax_block(const float* z_s, float* p_s, float* m_s, float* l_s,
                                     float* c_s, int v0, int valid_v) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BT; r += WARPS) {
    float z[BV / 32];
    bool ok[BV / 32];
    float zmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < BV / 32; ++i) {
      const int j = lane + 32 * i;
      ok[i] = v0 + j < valid_v;
      z[i] = z_s[r * BV + j];
      if (ok[i]) zmax = fmaxf(zmax, z[i]);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) zmax = fmaxf(zmax, __shfl_xor_sync(0xffffffffu, zmax, o));
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, zmax);
    const float corr = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < BV / 32; ++i) {
      const float p = ok[i] ? expf(z[i] - m_new) : 0.f;
      sum += p;
      p_s[r * BV + lane + 32 * i] = p;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    __syncwarp();
    if (lane == 0) {
      m_s[r] = m_new;
      l_s[r] = l_s[r] * corr + sum;
      c_s[r] = corr;
    }
  }
}

// out[t, d0 + c] = acc / l − W[y_t, d0 + c]  (W[y] as fp32; 0 for y outside [0, V))
template <typename LoadW>
__device__ inline void epilogue(const float* acc_s, const float* l_s, const int* __restrict__ y,
                                float* __restrict__ out, int t0, int T, int d0, int dn, int DS,
                                int D, int V, LoadW load_w) {
  for (int i = threadIdx.x; i < BT * dn; i += THREADS) {
    const int r = i / dn, c = i % dn, t = t0 + r;
    if (t >= T) continue;
    const int yy = y[t];
    const float wy = (yy >= 0 && yy < V) ? load_w((size_t)yy * D + d0 + c) : 0.f;
    out[(size_t)t * D + d0 + c] = acc_s[r * DS + c] / l_s[r] - wy;
  }
}

__device__ inline void init_state(float* acc_s, int n_acc, float* m_s, float* l_s) {
  for (int i = threadIdx.x; i < n_acc; i += THREADS) acc_s[i] = 0.f;
  if (threadIdx.x < BT) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }
}

size_t smem_f32(int DS) {
  return sizeof(float) * (BT * DS + BV * KP32 + BT * KC32 + 2 * BT * BV + 3 * BT);
}

__global__ void __launch_bounds__(THREADS)
ce_proxy_f32_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const int* __restrict__ y, float* __restrict__ out, int T, int D, int V,
                    int valid_v, int DS) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc_s = reinterpret_cast<float*>(smem);  // BT × DS
  float* w_s = acc_s + BT * DS;                   // BV × KP32
  float* h_s = w_s + BV * KP32;                   // BT × KC32
  float* z_s = h_s + BT * KC32;                   // BT × BV
  float* p_s = z_s + BT * BV;                     // BT × BV
  float* m_s = p_s + BT * BV;
  float* l_s = m_s + BT;
  float* c_s = l_s + BT;

  const int t0 = blockIdx.x * BT;
  const int d0 = blockIdx.y * DS;
  const int dn = imin(DS, D - d0);
  const int dk = round_up(D, KC32);
  const int dnk = round_up(dn, KC32);

  init_state(acc_s, BT * DS, m_s, l_s);
  __syncthreads();

  for (int v0 = 0; v0 < V; v0 += BV) {
    // 1. thread owns vocab column j and tokens 8·tg .. 8·tg + 7
    const int j = threadIdx.x & (BV - 1), tg = threadIdx.x / BV;
    float zr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) zr[i] = 0.f;
    for (int k0 = 0; k0 < dk; k0 += KC32) {
      load_tile_f32(w_s, w, v0, V, k0, D, BV, KC32, KP32);
      load_tile_f32(h_s, h, t0, T, k0, D, BT, KC32, KC32);
      __syncthreads();
      for (int k = 0; k < KC32; ++k) {
        const float wv = w_s[j * KP32 + k];
#pragma unroll
        for (int i = 0; i < 8; ++i) zr[i] = fmaf(h_s[(tg * 8 + i) * KC32 + k], wv, zr[i]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) z_s[(tg * 8 + i) * BV + j] = zr[i];
    __syncthreads();

    // 2. online softmax
    softmax_block(z_s, p_s, m_s, l_s, c_s, v0, valid_v);
    __syncthreads();

    // 3. thread owns column n of the chunk and tokens 4·tg2 .. 4·tg2 + 3;
    //    the rescale by c folds into the load of acc
    const int n = threadIdx.x & (KC32 - 1), tg2 = threadIdx.x / KC32;
    for (int n0 = 0; n0 < dnk; n0 += KC32) {
      load_tile_f32(w_s, w, v0, V, d0 + n0, D, BV, KC32, KP32);
      __syncthreads();
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tg2 * 4 + i;
        a[i] = acc_s[r * DS + n0 + n] * c_s[r];
      }
      for (int jj = 0; jj < BV; ++jj) {
        const float wv = w_s[jj * KP32 + n];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = fmaf(p_s[(tg2 * 4 + i) * BV + jj], wv, a[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc_s[(tg2 * 4 + i) * DS + n0 + n] = a[i];
      __syncthreads();
    }
  }
  epilogue(acc_s, l_s, y, out, t0, T, d0, dn, DS, D, V, [&](size_t i) { return w[i]; });
}

// ---------------------------------------------------------------------------
// bf16, D ≤ CL_DMAX: the cluster kernel (see the header).
constexpr int CL_DMAX = 2048;     // 8 CTAs × 256 columns
constexpr int CL_DS = 256;        // output columns per CTA
constexpr int CL_BT = 128;        // tokens per cluster
constexpr int CL_BV = 64;         // vocab rows per block
constexpr int CL_STAGES = 3;      // W ring depth
constexpr int CL_THREADS = 256;   // two consumer warpgroups
constexpr int CL_PANEL = 64;      // columns per 128-byte swizzle panel
constexpr int CL_PANELS = CL_DS / CL_PANEL;
constexpr int CL_SP = CL_BV + 8;  // padded row of the fp32 partial logits
// Shared-memory layout (bytes from a 1024-aligned base; swizzled tiles need it).
constexpr int CL_H_PANEL = CL_BT * 128;          // 128 rows × 64 bf16
constexpr int CL_W_PANEL = CL_BV * 128;          // 64 rows × 64 bf16
constexpr int CL_W_STAGE = CL_PANELS * CL_W_PANEL;
constexpr int OFF_H = 0;
constexpr int OFF_W = OFF_H + CL_PANELS * CL_H_PANEL;
constexpr int OFF_P = OFF_W + CL_STAGES * CL_W_STAGE;
constexpr int CL_PP = CL_BV + 8;  // padded row of P (bf16): conflict-free fragment loads
constexpr int OFF_S = OFF_P + CL_BT * CL_PP * 2;
constexpr int OFF_STAT = OFF_S + CL_BT * CL_SP * 4;
constexpr int OFF_BAR = OFF_STAT + 4 * CL_BT * 4;  // corr, l (gathered), m, l (own rows)
constexpr int CL_SMEM = OFF_BAR + 8 * (CL_STAGES + 1) + 1024;  // + alignment slack

__device__ __forceinline__ void wgmma_m64n64_kk(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256_rs_mn(float (&d)[128], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// Byte offset of bf16 element (row, col) in a tile stored as 64-column panels
// of `rows` rows × 128 bytes with the 128-byte swizzle (16-byte chunk c of row
// r at chunk c ^ (r & 7)), as TMA writes it.
__device__ __forceinline__ uint32_t sw128_off(int row, int col, int rows) {
  const int panel = col >> 6, c = col & 63;
  return panel * rows * 128 + row * 128 + ((((c >> 3) ^ row) & 7) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
// A phase that never completes (a fault) traps after ~2^34 cycles (~10 s)
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// The same shared address in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void st_cluster_u2(uint32_t addr, uint32_t a, uint32_t b) {
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n" ::"r"(addr), "r"(a), "r"(b)
               : "memory");
}
__device__ __forceinline__ void st_cluster_f32(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CL_THREADS) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// rows × 256 column slice [col0, col0 + 256) of a row-major (n_rows, D) bf16
// matrix into the swizzled panels at dst, zero outside it: the synchronous
// route (all consumer threads), followed by a proxy fence so that wgmma sees
// it.
__device__ inline void stage_sync(uint8_t* dst, const u16* __restrict__ src, int row0,
                                  int n_rows, int col0, int D, int rows) {
  for (int i = threadIdx.x; i < rows * CL_DS; i += CL_THREADS) {
    const int r = i / CL_DS, c = i % CL_DS;
    const int gr = row0 + r, gc = col0 + c;
    const u16 v = (gr < n_rows && gc < D) ? src[(size_t)gr * D + gc] : (u16)0;
    *reinterpret_cast<u16*>(dst + sw128_off(r, c, rows)) = v;
  }
  fence_proxy_async();
}

// Block `blk` of W's column slice into ring stage `st` (bar: its mbarrier).
__device__ inline void load_w(uint8_t* base, const CUtensorMap* tm_w, const u16* __restrict__ w,
                              int blk, int st, uint32_t bar, int col0, int D, int V, bool tma) {
  uint8_t* dst = base + OFF_W + st * CL_W_STAGE;
  if (tma) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, CL_W_STAGE);
#pragma unroll
      for (int p = 0; p < CL_PANELS; ++p)
        tma_load_2d(smem_u32(dst + p * CL_W_PANEL), tm_w, bar, col0 + p * CL_PANEL,
                    blk * CL_BV);
    }
  } else {
    stage_sync(dst, w, blk * CL_BV, V, col0, D, CL_BV);
    consumers_sync();
    if (threadIdx.x == 0) mbar_arrive(bar);
  }
  __syncwarp();
}

// Issue this warpgroup's partial logits of one vocab block: 64 tokens ×
// 64 vocab rows over the CTA's 256 columns (16 k-steps), into sacc.
__device__ __forceinline__ void logits(float (&sacc)[32], uint32_t h_wg, uint32_t w_st) {
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < CL_PANELS; ++p) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint64_t da = sw128_desc(h_wg + p * CL_H_PANEL + 32 * k, 16, 1024);
      const uint64_t db = sw128_desc(w_st + p * CL_W_PANEL + 32 * k, 16, 1024);
      wgmma_m64n64_kk(sacc, da, db, (p | k) != 0);
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(CL_THREADS, 1)
ce_proxy_bf16_cluster_kernel(const __grid_constant__ CUtensorMap tm_h,
                             const __grid_constant__ CUtensorMap tm_w,
                             const u16* __restrict__ h, const u16* __restrict__ w,
                             const int* __restrict__ y, float* __restrict__ out, int T, int D,
                             int V, int valid_v, int use_tma) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* spart = reinterpret_cast<float*>(base + OFF_S);  // CL_BT × CL_SP
  float* corr_s = reinterpret_cast<float*>(base + OFF_STAT);
  float* lsum_s = corr_s + CL_BT;  // l of every row, gathered at the end
  float* m_own = lsum_s + CL_BT;   // online max of the rows this CTA finalizes
  float* l_own = m_own + CL_BT;    // online sum of the same rows
  const uint32_t bar0 = smem_u32(base + OFF_BAR);  // W stages, then h
  const uint32_t hbar = bar0 + 8 * CL_STAGES;

  const bool tma = use_tma != 0;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;               // consumer warpgroup: tokens 64·wg ..
  const int wq = (tid >> 5) & 3;         // warp in the warpgroup: 16 rows each
  const int lane = tid & 31;
  const uint32_t rank = cluster_rank();
  const uint32_t C = cluster_size();
  const int col0 = (int)rank * CL_DS;
  const int t0 = blockIdx.y * CL_BT;
  const int nv = (valid_v + CL_BV - 1) / CL_BV;  // blocks past valid_v add nothing
  const int R = (CL_BT + (int)C - 1) / (int)C;   // rows finalized per CTA
  const int rlo = imin((int)rank * R, CL_BT);
  const int nrows = imin(R, CL_BT - rlo);

  if (tid == 0) {
    for (int s = 0; s < CL_STAGES; ++s) mbar_init(bar0 + 8 * s, 1);
    mbar_init(hbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < CL_BT) {
    m_own[tid] = -INFINITY;
    l_own[tid] = 0.f;
  }
  __syncthreads();

  // h slice and the first CL_STAGES blocks of W
  if (tma) {
    if (tid == 0) {
      mbar_expect_tx(hbar, CL_PANELS * CL_H_PANEL);
#pragma unroll
      for (int p = 0; p < CL_PANELS; ++p)
        tma_load_2d(smem_u32(base + OFF_H + p * CL_H_PANEL), &tm_h, hbar, col0 + p * CL_PANEL,
                    t0);
    }
    __syncwarp();
  } else {
    stage_sync(base + OFF_H, h, t0, T, col0, D, CL_BT);
    consumers_sync();
    if (tid == 0) mbar_arrive(hbar);
  }
  for (int b = 0; b < CL_STAGES && b < nv; ++b)
    load_w(base, &tm_w, w, b, b, bar0 + 8 * b, col0, D, V, tma);

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float sacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
  // this thread's accumulator rows (within the CTA's 128 tokens)
  const int row_lo = wg * 64 + wq * 16 + (lane >> 2);
  const int row_hi = row_lo + 8;
  const uint32_t h_wg = smem_u32(base + OFF_H) + wg * 64 * 128;
  const u16* p_s = reinterpret_cast<const u16*>(base + OFF_P);  // CL_BT × CL_PP
  const uint32_t p_cl = smem_u32(base + OFF_P);
  const uint32_t w0 = smem_u32(base + OFF_W);
  mbar_wait(hbar, 0);
  mbar_wait(bar0, 0);
  logits(sacc, h_wg, w0);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // P (bf16, the A operand of the accumulate) and c of the previous block,
  // read from shared memory into registers before the cluster moves on
  uint32_t a[4][4];
  float c_lo = 0.f, c_hi = 0.f;
  auto read_p = [&]() {
    const int pc = 2 * (lane & 3);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[k][0] = *reinterpret_cast<const uint32_t*>(p_s + row_lo * CL_PP + 16 * k + pc);
      a[k][1] = *reinterpret_cast<const uint32_t*>(p_s + row_hi * CL_PP + 16 * k + pc);
      a[k][2] = *reinterpret_cast<const uint32_t*>(p_s + row_lo * CL_PP + 16 * k + pc + 8);
      a[k][3] = *reinterpret_cast<const uint32_t*>(p_s + row_hi * CL_PP + 16 * k + pc + 8);
    }
    c_lo = corr_s[row_lo];
    c_hi = corr_s[row_hi];
  };
  // acc = acc·c + P · W_v over this CTA's 256 columns (W_v in stage `ws`)
  auto accumulate = [&](int ws) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[4 * i] *= c_lo;
      acc[4 * i + 1] *= c_lo;
      acc[4 * i + 2] *= c_hi;
      acc[4 * i + 3] *= c_hi;
    }
    wgmma_fence();
    const uint32_t w_st = w0 + ws * CL_W_STAGE;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // MN-major B: 16 vocab rows per k-step; LBO steps a 64-column panel,
      // SBO eight vocab rows
      const uint64_t db = sw128_desc(w_st + k * 16 * 128, CL_W_PANEL, 1024);
      wgmma_m64n256_rs_mn(acc, a[k], db, 1);
    }
    wgmma_commit_wait();
  };

  for (int j = 0; j < nv; ++j) {
    // 1. this CTA's partial logits of block j (computed in sacc) to spart
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 8 * i + 2 * (lane & 3);
      *reinterpret_cast<float2*>(&spart[row_lo * CL_SP + c]) =
          make_float2(sacc[4 * i], sacc[4 * i + 1]);
      *reinterpret_cast<float2*>(&spart[row_hi * CL_SP + c]) =
          make_float2(sacc[4 * i + 2], sacc[4 * i + 3]);
    }
    if (j >= 1) read_p();
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    // while the partials are gathered: block j − 1's accumulate, then refill
    // its W stage with block j + 2
    if (j >= 1) {
      const int sb = (j - 1) % CL_STAGES;
      accumulate(sb);
      if (j - 1 + CL_STAGES < nv) {
        consumers_sync();  // both warpgroups are done with the stage
        load_w(base, &tm_w, w, j - 1 + CL_STAGES, sb, bar0 + 8 * sb, col0, D, V, tma);
      }
    }
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

    // 2. reduce-scatter: this CTA's rows, 16 threads a row, 4 columns each
    {
      const int v0 = j * CL_BV;
      const int iters = (nrows * 16 + CL_THREADS - 1) / CL_THREADS;
      for (int it = 0; it < iters; ++it) {
        const int idx = it * CL_THREADS + tid;
        const int rl = idx >> 4, q = idx & 15;
        const bool active = rl < nrows;
        const int row = rlo + (active ? rl : 0);
        const uint32_t src = smem_u32(&spart[row * CL_SP + 4 * q]);
        float4 part[8];  // all loads in flight, then summed in rank order
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (k < (int)C) part[k] = ld_cluster_f4(map_rank(src, k));
        float4 z = part[0];
#pragma unroll
        for (int k = 1; k < 8; ++k) {
          if (k < (int)C) {
            z.x += part[k].x; z.y += part[k].y; z.z += part[k].z; z.w += part[k].w;
          }
        }
        const int v = v0 + 4 * q;
        const bool ok0 = v < valid_v, ok1 = v + 1 < valid_v, ok2 = v + 2 < valid_v,
                   ok3 = v + 3 < valid_v;
        float zmax = fmaxf(fmaxf(ok0 ? z.x : -INFINITY, ok1 ? z.y : -INFINITY),
                           fmaxf(ok2 ? z.z : -INFINITY, ok3 ? z.w : -INFINITY));
#pragma unroll
        for (int o = 8; o; o >>= 1) zmax = fmaxf(zmax, __shfl_xor_sync(0xffffffffu, zmax, o));
        const float m_old = m_own[row];
        const float m_new = fmaxf(m_old, zmax);
        const float c = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
        const float p0 = ok0 ? expf(z.x - m_new) : 0.f;
        const float p1 = ok1 ? expf(z.y - m_new) : 0.f;
        const float p2 = ok2 ? expf(z.z - m_new) : 0.f;
        const float p3 = ok3 ? expf(z.w - m_new) : 0.f;
        float sum = (p0 + p1) + (p2 + p3);
#pragma unroll
        for (int o = 8; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (active) {
          const uint32_t pa = p_cl + 2 * (row * CL_PP + 4 * q);
          const uint32_t lo = pack_bf16x2(p0, p1), hi = pack_bf16x2(p2, p3);
          const uint32_t ca = smem_u32(&corr_s[row]);
          for (uint32_t k = 0; k < C; ++k) {
            st_cluster_u2(map_rank(pa, k), lo, hi);
            if (q == 0) st_cluster_f32(map_rank(ca, k), c);
          }
          if (q == 0) {
            m_own[row] = m_new;
            l_own[row] = l_own[row] * c + sum;
          }
        }
      }
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    // while P and c are gathered: the next block's logits
    if (j + 1 < nv) {
      const int sn = (j + 1) % CL_STAGES;
      mbar_wait(bar0 + 8 * sn, ((j + 1) / CL_STAGES) & 1);
      logits(sacc, h_wg, w0 + sn * CL_W_STAGE);
    }
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  read_p();  // the last block's accumulate
  accumulate((nv - 1) % CL_STAGES);

  // gather l, then out = acc / l − W[y] on this CTA's columns
  for (int rl = tid; rl < nrows; rl += CL_THREADS) {
    const int row = rlo + rl;
    const uint32_t la = smem_u32(&lsum_s[row]);
    for (uint32_t k = 0; k < C; ++k) st_cluster_f32(map_rank(la, k), l_own[row]);
  }
  cluster_sync();
  const __nv_bfloat16* wbf = reinterpret_cast<const __nv_bfloat16*>(w);
  const bool pair = (D & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_hi : row_lo;
    const int t = t0 + row;
    if (t >= T) continue;
    const int yy = y[t];
    const bool yok = yy >= 0 && yy < V;
    const float l = lsum_s[row];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = col0 + 8 * i + 2 * (lane & 3);
      const float a0 = acc[4 * i + 2 * half], a1 = acc[4 * i + 2 * half + 1];
      if (col >= D) continue;
      const float w0 = yok ? __bfloat162float(wbf[(size_t)yy * D + col]) : 0.f;
      float* o = out + (size_t)t * D + col;
      if (pair) {  // col is even and D is even: both columns exist
        const float w1 = yok ? __bfloat162float(wbf[(size_t)yy * D + col + 1]) : 0.f;
        *reinterpret_cast<float2*>(o) = make_float2(a0 / l - w0, a1 / l - w1);
      } else {
        o[0] = a0 / l - w0;
        if (col + 1 < D) {
          const float w1 = yok ? __bfloat162float(wbf[(size_t)yy * D + col + 1]) : 0.f;
          o[1] = a1 / l - w1;
        }
      }
    }
  }
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

// Tensor map of a row-major (rows, D) bf16 matrix, boxes of 64 columns ×
// box_rows rows, 128-byte swizzle, zero fill out of bounds.
bool bf16_map(CUtensorMap* map, const void* ptr, int rows, int D, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)CL_PANEL, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// h (T, D), w (V, D) bf16; y (T,) int32; out (T, D) fp32; 1 ≤ valid_v ≤ V.
// D ≤ CL_DMAX (wider D returns cudaErrorInvalidValue; the Python wrapper
// refuses it first).  A failed tensor-map encode returns
// cudaErrorInvalidValue too.
int ce_proxy_bf16(const void* h, const void* w, const void* y, void* out, int T, int D,
                  int V, int valid_v, void* stream) {
  if (D > CL_DMAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ce_proxy_bf16_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, CL_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tma = (D % 8 == 0) && aligned16(h) && aligned16(w);
  CUtensorMap tm_h, tm_w;
  memset(&tm_h, 0, sizeof(tm_h));
  memset(&tm_w, 0, sizeof(tm_w));
  if (tma && !(bf16_map(&tm_h, h, T, D, CL_BT) && bf16_map(&tm_w, w, V, D, CL_BV)))
    return (int)cudaErrorInvalidValue;
  const unsigned C = (unsigned)((D + CL_DS - 1) / CL_DS);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (unsigned)((T + CL_BT - 1) / CL_BT), 1);
  cfg.blockDim = dim3(CL_THREADS, 1, 1);
  cfg.dynamicSmemBytes = CL_SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ce_proxy_bf16_cluster_kernel, tm_h, tm_w, (const u16*)h,
                           (const u16*)w, (const int*)y, (float*)out, T, D, V, valid_v, tma);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The same with fp32 h and w.
int ce_proxy_f32(const void* h, const void* w, const void* y, void* out, int T, int D,
                 int V, int valid_v, void* stream) {
  const int DS = imin(round_up(D, KC32), DS_MAX);
  const size_t smem = smem_f32(DS);
  cudaError_t err = cudaFuncSetAttribute(
      ce_proxy_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BT - 1) / BT, (D + DS - 1) / DS);
  ce_proxy_f32_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)h, (const float*)w, (const int*)y, (float*)out, T, D, V, valid_v, DS);
  return (int)cudaGetLastError();
}

}  // extern "C"
