// Fused CRAIG gradient proxy for token streams, written by hand for Hopper
// (sm_90a).  Replaces the TPU kernel repro/kernels/ce_proxy.py::ce_proxy_pallas.
//
// For each token t with hidden state h_t (D,), label y_t and the vocab-major
// unembedding W (V, D):
//
//     g_t = softmax(h_t Wᵀ) W − W[y_t]          (T, D) fp32
//
// without the (T, V) logits in device memory: the vocab is walked in blocks
// of BV columns with an online max and sum in fp32 (columns at or past
// valid_v count as −∞).  The reference's one-hot product for the label
// column becomes a gather of W[y_t] in the compute dtype, which is the same
// value.  Ragged T, V and D are masked here; no caller pads.
//
// Design.  The TPU kernel carries two (128, D) fp32 accumulators in VMEM
// across its vocab grid (2 MB at D = 2048); an SM has 227 KB of shared
// memory.  Here a CTA owns BT = 16 tokens, and per vocab block computes
//   1. z = h · W_vᵀ,
//   2. the online softmax of z: running max m, sum l, rescale factor c and
//      p = exp(z − m) (columns at or past valid_v give p = 0),
//   3. acc = acc·c + p · W_v,
// and finally out = acc / l − W[y].  Two kernels:
//   * bf16, D ≤ 2048 (the main path): the (16, D) accumulator in registers,
//     spread over 8 warps (mma.sync m16n8k16, whose documented fragment
//     layout lets each thread rescale its own rows); h and a double buffer
//     of 16-row W blocks (cp.async) in shared memory; W read once per 16
//     tokens.  See ce_proxy_bf16_mma_kernel.  Wider D is refused until a
//     ported config needs it (ROADMAP.md queue 2, "ce_proxy at D > 2048").
//   * fp32: the accumulator in shared memory, at most 2048 columns per
//     CTA (D split over blockIdx.y, logits recomputed per split), with IEEE
//     fp32 FMAs on the CUDA cores (TF32 would break parity with the
//     reference).  It is for parity runs and is slower than the plain
//     twin's cuBLAS fp32 GEMMs.
// p is rounded to the compute dtype before its product and the sum l stays
// fp32, as the reference computes them.
//
// Bound on this card: operations, 4·T·V·D (5.1 TFLOP at T = 4,096,
// D = 2048, V = 151,936: 5.2 ms in bf16 at 989 TFLOP/s, 76 ms in fp32 at
// 67 TFLOP/s).  Both kernels are further limited by the 16-token block:
// every CTA reads all of W, (T/16)·V·D elements through L2 in all.
//
// C entries return cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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
// bf16, D ≤ MMA_DMAX: the accumulator in registers.
//
// Each warp owns 256 output columns of the 16 tokens: 32 m16n8 fp32 tiles,
// 128 registers a thread, rescaled row by row (the mma.sync fragment layout
// says which rows a thread holds).  Shared memory then holds h (16 × D) and
// two vocab blocks of W (16 rows × D each): the next block streams in with
// cp.async while the current one is used, and each W element is read once
// per 16 tokens.  Per block of 16 vocab rows:
//   1. z (16 × 16) = h · W_vᵀ, the K = D reduction split over the 8 warps
//      (mma.sync m16n8k16, fp32 accumulation), partials summed in a fixed
//      order;
//   2. online softmax, one thread per (token, vocab) entry;
//   3. acc = acc·c + p · W_v on every warp's columns.
constexpr int MMA_DMAX = 2048;  // 8 warps × 256 columns
constexpr int MMA_BV = 16;      // vocab rows per block
constexpr int MMA_TILES = MMA_DMAX / WARPS / 8;  // n8 tiles per warp

__device__ inline unsigned pack2(u16 lo, u16 hi) {
  return (unsigned)lo | ((unsigned)hi << 16);
}

__device__ inline void mma_bf16(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// rows × dp tile of a row-major (n_rows, D) bf16 matrix into dst (row
// stride ld), zero outside it.  vec: 16-byte cp.async (D % 8 == 0, aligned
// base; chunks outside the matrix zero-fill), else synchronous scalar copies.
__device__ inline void stage_rows(u16* dst, const u16* __restrict__ src, int row0, int n_rows,
                                  int D, int dp, int rows, int ld, bool vec) {
  if (vec) {
    const int cpr = dp / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < rows * cpr; i += THREADS) {
      const int r = i / cpr, c = (i % cpr) * 8;
      const int gr = row0 + r;
      const bool in = gr < n_rows && c < D;
      const u16* g = in ? src + (size_t)gr * D + c : src;
      const unsigned s = (unsigned)__cvta_generic_to_shared(dst + r * ld + c);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(g),
                   "r"(in ? 16 : 0));
    }
  } else {
    for (int i = threadIdx.x; i < rows * dp; i += THREADS) {
      const int r = i / dp, c = i % dp;
      const int gr = row0 + r;
      dst[r * ld + c] = (gr < n_rows && c < D) ? src[(size_t)gr * D + c] : (u16)0;
    }
  }
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ inline void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

size_t smem_bf16_mma(int ld) {
  return sizeof(u16) * (size_t)(BT + 2 * MMA_BV) * ld +
         sizeof(float) * WARPS * BT * MMA_BV + sizeof(u16) * BT * (MMA_BV + 8) +
         sizeof(float) * 3 * BT;
}

__global__ void __launch_bounds__(THREADS, 1)
ce_proxy_bf16_mma_kernel(const u16* __restrict__ h, const u16* __restrict__ w,
                         const int* __restrict__ y, float* __restrict__ out, int T, int D,
                         int V, int valid_v, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int dp = round_up(D, 16);
  const int ld = dp + 8;  // padded rows: conflict-free fragment loads
  u16* h_s = reinterpret_cast<u16*>(smem);        // BT × ld
  u16* w_s = h_s + BT * ld;                        // 2 × MMA_BV × ld
  float* zpart = reinterpret_cast<float*>(w_s + 2 * MMA_BV * ld);  // WARPS × BT × BV
  u16* p_s = reinterpret_cast<u16*>(zpart + WARPS * BT * MMA_BV);  // BT × (BV + 8)
  float* m_s = reinterpret_cast<float*>(p_s + BT * (MMA_BV + 8));
  float* l_s = m_s + BT;
  float* c_s = l_s + BT;
  constexpr int PLD = MMA_BV + 8;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int t0 = blockIdx.x * BT;
  const bool v = vec != 0;

  float acc[MMA_TILES][4];
#pragma unroll
  for (int j = 0; j < MMA_TILES; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  if (threadIdx.x < BT) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }
  stage_rows(h_s, h, t0, T, D, dp, BT, ld, v);
  stage_rows(w_s, w, 0, V, D, dp, MMA_BV, ld, v);
  cp_async_commit();

  const int nk = dp / 16;
  int buf = 0;
  for (int v0 = 0; v0 < V; v0 += MMA_BV, buf ^= 1) {
    if (v0 + MMA_BV < V)
      stage_rows(w_s + (buf ^ 1) * MMA_BV * ld, w, v0 + MMA_BV, V, D, dp, MMA_BV, ld, v);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const u16* wb = w_s + buf * MMA_BV * ld;

    // 1. partial z over this warp's k-steps
    float zc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int s = warp; s < nk; s += WARPS) {
      const int k = s * 16 + tq * 2;
      const unsigned a0 = *reinterpret_cast<const unsigned*>(h_s + g * ld + k);
      const unsigned a1 = *reinterpret_cast<const unsigned*>(h_s + (g + 8) * ld + k);
      const unsigned a2 = *reinterpret_cast<const unsigned*>(h_s + g * ld + k + 8);
      const unsigned a3 = *reinterpret_cast<const unsigned*>(h_s + (g + 8) * ld + k + 8);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const u16* wr = wb + (n * 8 + g) * ld + k;
        mma_bf16(zc[n], a0, a1, a2, a3, *reinterpret_cast<const unsigned*>(wr),
                 *reinterpret_cast<const unsigned*>(wr + 8));
      }
    }
    float* zp = zpart + warp * BT * MMA_BV;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      zp[g * MMA_BV + n * 8 + tq * 2] = zc[n][0];
      zp[g * MMA_BV + n * 8 + tq * 2 + 1] = zc[n][1];
      zp[(g + 8) * MMA_BV + n * 8 + tq * 2] = zc[n][2];
      zp[(g + 8) * MMA_BV + n * 8 + tq * 2 + 1] = zc[n][3];
    }
    __syncthreads();

    // 2. online softmax: thread (r, c), 16 lanes per row
    {
      const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
      float z = 0.f;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) z += zpart[q * BT * MMA_BV + r * MMA_BV + c];
      const bool ok = v0 + c < valid_v;
      const float m_old = m_s[r];
      float zmax = ok ? z : -INFINITY;
#pragma unroll
      for (int o = 8; o; o >>= 1) zmax = fmaxf(zmax, __shfl_xor_sync(0xffffffffu, zmax, o));
      const float m_new = fmaxf(m_old, zmax);
      const float corr = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
      const float p = ok ? expf(z - m_new) : 0.f;
      p_s[r * PLD + c] = __bfloat16_as_ushort(__float2bfloat16(p));
      float sum = p;
#pragma unroll
      for (int o = 8; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (c == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // 3. acc = acc·c + p · W_v on this warp's 256 columns
    {
      const float c_lo = c_s[g], c_hi = c_s[g + 8];
      const unsigned a0 = *reinterpret_cast<const unsigned*>(p_s + g * PLD + tq * 2);
      const unsigned a1 = *reinterpret_cast<const unsigned*>(p_s + (g + 8) * PLD + tq * 2);
      const unsigned a2 = *reinterpret_cast<const unsigned*>(p_s + g * PLD + tq * 2 + 8);
      const unsigned a3 = *reinterpret_cast<const unsigned*>(p_s + (g + 8) * PLD + tq * 2 + 8);
      const u16* r0 = wb + (tq * 2) * ld;
#pragma unroll
      for (int j = 0; j < MMA_TILES; ++j) {
        const int n = warp * (MMA_TILES * 8) + j * 8 + g;
        if (warp * (MMA_TILES * 8) + j * 8 < dp) {
          acc[j][0] *= c_lo; acc[j][1] *= c_lo; acc[j][2] *= c_hi; acc[j][3] *= c_hi;
          const unsigned b0 = pack2(r0[n], r0[ld + n]);
          const unsigned b1 = pack2(r0[8 * ld + n], r0[9 * ld + n]);
          mma_bf16(acc[j], a0, a1, a2, a3, b0, b1);
        }
      }
    }
    __syncthreads();
  }

  // out = acc / l − W[y] on the columns this thread holds
  const __nv_bfloat16* wbf = reinterpret_cast<const __nv_bfloat16*>(w);
#pragma unroll
  for (int j = 0; j < MMA_TILES; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + (e >> 1) * 8;
      const int col = warp * (MMA_TILES * 8) + j * 8 + tq * 2 + (e & 1);
      const int t = t0 + r;
      if (t < T && col < D) {
        const int yy = y[t];
        const float wy =
            (yy >= 0 && yy < V) ? __bfloat162float(wbf[(size_t)yy * D + col]) : 0.f;
        out[(size_t)t * D + col] = acc[j][e] / l_s[r] - wy;
      }
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// h (T, D), w (V, D) bf16; y (T,) int32; out (T, D) fp32; 1 ≤ valid_v ≤ V.
// D ≤ MMA_DMAX (wider D returns cudaErrorInvalidValue; the Python wrapper
// refuses it first).
int ce_proxy_bf16(const void* h, const void* w, const void* y, void* out, int T, int D,
                  int V, int valid_v, void* stream) {
  if (D > MMA_DMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bf16_mma(round_up(D, 16) + 8);
  cudaError_t err = cudaFuncSetAttribute(
      ce_proxy_bf16_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = (D % 8 == 0) && aligned16(h) && aligned16(w);
  ce_proxy_bf16_mma_kernel<<<(T + BT - 1) / BT, THREADS, smem, (cudaStream_t)stream>>>(
      (const u16*)h, (const u16*)w, (const int*)y, (float*)out, T, D, V, valid_v, vec);
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
