// AdamW over every leaf of a parameter dict for Hopper (sm_90a):
// adamw_sq_norm and adamw_update.
//
// Replaces no TPU kernel: the reference (src/repro/optim/optimizers.py::adamw)
// leaves its elementwise update to XLA, which fuses each leaf's tree_map into
// one pass.  Run eagerly, the port's loop (the plain twin,
// kernels/adamw.py::adamw_update_torch) launched about eleven elementwise
// kernels a leaf and three more for the clip, each reading and writing whole
// fp32 leaves, and allocated two full-size temporaries (m / bc1, v / bc2) a
// leaf.  These two kernels compute the same step:
//
//   sq      = sum over leaves of sum(g * g)                   (adamw_sq_norm)
//   scale   = min(clip / (sqrt(sq) + 1e-9), 1)                 (clip set)
//   g       = g * scale
//   m       = b1 * m + (1 - b1) * g
//   v       = b2 * v + (1 - b2) * g * g
//   delta   = (m / bc1) / (sqrt(v / bc2) + eps)  [+ wd * p]
//   p       = p - lr * delta                                   (adamw_update)
//
// in fp32, each operation rounded on its own in the twin's order (no
// contraction into FMAs), with bc1 and bc2 computed on the host as the twin
// computes them.  The gradients are read, never written.
//
// What bounds it on an H100: bytes.  The update reads g, p, m, v and writes
// p, m, v: 28 bytes a parameter; the norm reads g once more: 4.  At
// qwen2-7b cut to 8 layers (2.954 B fp32 parameters) that is 82.7 GB and
// 11.8 GB, 24.7 ms and 3.5 ms at 3.35 TB/s.  No operation count comes near.
//
// Design: one launch a pass over all leaves, each element touched once.
//   * The leaves are cut into chunks of 64 Ki elements (the wrapper's chunk
//     list, (leaf, start, stop) int64 triples, built once a leaf-shape
//     signature and kept on the device).  A grid of a few CTAs an SM walks
//     the list, CTA b taking chunks b, b + grid, ...; a chunk is one leaf's
//     contiguous range, so the CTA reads its leaf's pointers once.
//   * The leaves' pointers change every step (fresh gradients), so each
//     launch carries them by value: up to MAX_LEAVES leaves in a
//     __grid_constant__ table (16 KB for the update's four pointers a leaf,
//     read in place from the parameter bank with a CTA-uniform index).  A
//     wrapper with more leaves launches once for each MAX_LEAVES of them.
//   * 16-byte loads and stores (float4) where all of a leaf's pointers are
//     16-byte aligned (chunk starts are multiples of 64 Ki elements); a
//     scalar loop for a leaf's ragged tail and for unaligned leaves.  The
//     update loads UNROLL float4 of each array before it stores any, so a
//     thread keeps 4 * UNROLL 16-byte loads in flight.  The gradients are loaded
//     with the streaming hint (read once), p, m and v stored with it (read
//     next step, long after L2 has turned over).
//   * The norm's sums: each thread sums a chunk's squares in four fp32
//     lanes, adds the chunk's sum to its own total, and the CTA reduces its
//     threads in a fixed tree into one fp32 partial a CTA.  The update
//     kernel's CTAs each sum the partials in the same fixed order, so every
//     CTA gets the same scale, run after run: no atomics, no finishing
//     launch, no host sync.  On a mesh the wrapper sums each sharded group's
//     partials across ranks first (an all-reduce of the partials vector).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12010
#error "adamw.cu passes its leaf table as a kernel parameter of 16 KB: CUDA 12.1 or newer"
#endif

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 2;  // float4 of each array a thread loads before it stores
constexpr int MAX_LEAVES = 512;  // kernels/adamw.py::MAX_LEAVES

struct GradTable {
  const float* g[MAX_LEAVES];
};

struct LeafTable {
  float* p[MAX_LEAVES];
  float* m[MAX_LEAVES];
  float* v[MAX_LEAVES];
  const float* g[MAX_LEAVES];
};

struct Hyper {
  float lr, b1, omb1, b2, omb2, bc1, bc2, eps, wd, clip;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// The CTA's sum of x in a fixed tree; the result in every thread.
__device__ __forceinline__ float block_sum(float x, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float t = lane < WARPS ? scratch[lane] : 0.0f;
  t = warp_sum(t);
  if (threadIdx.x == 0) scratch[WARPS] = t;
  __syncthreads();
  return scratch[WARPS];
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15u) == 0;
}

__global__ void __launch_bounds__(THREADS)
sq_norm_kernel(const __grid_constant__ GradTable t, const long long* __restrict__ chunks,
               int n_chunks, float* __restrict__ partials) {
  __shared__ float scratch[WARPS + 1];
  float total = 0.0f;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const long long leaf = chunks[3 * c], start = chunks[3 * c + 1], stop = chunks[3 * c + 2];
    const float* g = t.g[leaf];
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    long long tail = start;
    if (aligned16(g)) {
      const float4* g4 = reinterpret_cast<const float4*>(g + start);
      const int nv = static_cast<int>((stop - start) >> 2);
#pragma unroll 4
      for (int j = threadIdx.x; j < nv; j += THREADS) {
        const float4 x = __ldcs(g4 + j);
        s0 = __fmaf_rn(x.x, x.x, s0);
        s1 = __fmaf_rn(x.y, x.y, s1);
        s2 = __fmaf_rn(x.z, x.z, s2);
        s3 = __fmaf_rn(x.w, x.w, s3);
      }
      tail = start + 4LL * nv;
    }
    for (long long i = tail + threadIdx.x; i < stop; i += THREADS) {
      const float x = g[i];
      s0 = __fmaf_rn(x, x, s0);
    }
    total += (s0 + s1) + (s2 + s3);
  }
  total = block_sum(total, scratch);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// One element of the step, each operation rounded on its own.
__device__ __forceinline__ void step(float& p, float& m, float& v, float g, const Hyper& h,
                                     float scale, bool clipping) {
  if (clipping) g = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(h.omb2, g), g));
  float d = __fdiv_rn(__fdiv_rn(m, h.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps));
  if (h.wd != 0.0f) d = __fadd_rn(d, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(d, h.lr));
}

__device__ __forceinline__ void step4(float4& p, float4& m, float4& v, const float4& g,
                                      const Hyper& h, float scale, bool clipping) {
  step(p.x, m.x, v.x, g.x, h, scale, clipping);
  step(p.y, m.y, v.y, g.y, h, scale, clipping);
  step(p.z, m.z, v.z, g.z, h, scale, clipping);
  step(p.w, m.w, v.w, g.w, h, scale, clipping);
}

__global__ void __launch_bounds__(THREADS)
update_kernel(const __grid_constant__ LeafTable t, const long long* __restrict__ chunks,
              int n_chunks, const float* __restrict__ partials, int n_partials,
              const Hyper h) {
  __shared__ float scratch[WARPS + 1];
  const bool clipping = partials != nullptr;
  float scale = 1.0f;
  if (clipping) {  // every CTA sums the partials in the same order
    float s = 0.0f;
    for (int i = threadIdx.x; i < n_partials; i += THREADS) s += partials[i];
    const float norm = __fsqrt_rn(block_sum(s, scratch));
    const float x = __fdiv_rn(h.clip, __fadd_rn(norm, 1e-9f));
    scale = x > 1.0f ? 1.0f : x;  // clamp(max=1): a NaN stays NaN
  }
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const long long leaf = chunks[3 * c], start = chunks[3 * c + 1], stop = chunks[3 * c + 2];
    float* p = t.p[leaf];
    float* m = t.m[leaf];
    float* v = t.v[leaf];
    const float* g = t.g[leaf];
    long long tail = start;
    if (aligned16(p) && aligned16(m) && aligned16(v) && aligned16(g)) {
      float4* p4 = reinterpret_cast<float4*>(p + start);
      float4* m4 = reinterpret_cast<float4*>(m + start);
      float4* v4 = reinterpret_cast<float4*>(v + start);
      const float4* g4 = reinterpret_cast<const float4*>(g + start);
      const int nv = static_cast<int>((stop - start) >> 2);
      for (int j = threadIdx.x; j < nv; j += UNROLL * THREADS) {
        float4 pu[UNROLL], mu[UNROLL], vu[UNROLL], gu[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {  // every load before any store
          const int k = j + u * THREADS;
          if (k < nv) {
            pu[u] = p4[k];
            mu[u] = m4[k];
            vu[u] = v4[k];
            gu[u] = __ldcs(g4 + k);
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int k = j + u * THREADS;
          if (k < nv) {
            step4(pu[u], mu[u], vu[u], gu[u], h, scale, clipping);
            __stcs(p4 + k, pu[u]);
            __stcs(m4 + k, mu[u]);
            __stcs(v4 + k, vu[u]);
          }
        }
      }
      tail = start + 4LL * nv;
    }
    for (long long i = tail + threadIdx.x; i < stop; i += THREADS) {
      float pi = p[i], mi = m[i], vi = v[i];
      step(pi, mi, vi, g[i], h, scale, clipping);
      p[i] = pi;
      m[i] = mi;
      v[i] = vi;
    }
  }
}

// CTAs of the update kernel the current device holds at once.
cudaError_t update_grid(int* ctas) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev] > 0) {
    *ctas = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, update_kernel, THREADS, 0);
  if (err != cudaSuccess) return err;
  *ctas = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) cached[dev] = *ctas;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The leaves one launch carries.
int adamw_max_leaves() { return MAX_LEAVES; }

// Sums of squares of the gradients: grid fp32 partials, one a CTA.
// ptrs: host array of n_leaves gradient pointers; chunks: device
// (n_chunks, 3) int64 (leaf, start, stop), leaf < n_leaves.
int adamw_sq_norm_f32(const void* ptrs, int n_leaves, const void* chunks, int n_chunks,
                      void* partials, int grid, void* stream) {
  if (n_leaves < 0 || n_leaves > MAX_LEAVES || n_chunks < 0 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  GradTable t;
  memset(&t, 0, sizeof(t));
  memcpy(t.g, ptrs, sizeof(void*) * n_leaves);
  sq_norm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const long long*>(chunks), n_chunks, static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}

// The step over n_leaves leaves.  ptrs: host array of 4 * n_leaves
// pointers, p of every leaf, then m, v and g; partials: n_partials fp32
// sums of squares to clip by, or null for no clip; omb1 and omb2 are 1 - b1
// and 1 - b2 as the host rounds them (in double, then to fp32).
int adamw_update_f32(const void* ptrs, int n_leaves, const void* chunks, int n_chunks,
                     const void* partials, int n_partials, float lr, float b1, float omb1,
                     float b2, float omb2, float bc1, float bc2, float eps, float wd, float clip,
                     void* stream) {
  if (n_leaves < 0 || n_leaves > MAX_LEAVES || n_chunks < 0 || n_partials < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0;
  const cudaError_t err = update_grid(&ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  LeafTable t;
  memset(&t, 0, sizeof(t));
  void* const* in = static_cast<void* const*>(ptrs);
  memcpy(t.p, in, sizeof(void*) * n_leaves);
  memcpy(t.m, in + n_leaves, sizeof(void*) * n_leaves);
  memcpy(t.v, in + 2 * n_leaves, sizeof(void*) * n_leaves);
  memcpy(t.g, in + 3 * n_leaves, sizeof(void*) * n_leaves);
  const Hyper h{lr, b1, omb1, b2, omb2, bc1, bc2, eps, wd, clip};
  const int grid = n_chunks < ctas ? (n_chunks > 0 ? n_chunks : 1) : ctas;
  update_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const long long*>(chunks), n_chunks,
      static_cast<const float*>(partials), n_partials, h);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
