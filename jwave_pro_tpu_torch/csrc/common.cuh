// Shared pieces of the MODWT kernels: tap struct, dtype load/store, circular
// indexing, shrinkage and the launch helper.  Kernels allocate nothing; each C entry
// point launches on the caller's stream and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define JW_MAX_TAPS 64
#define JW_THREADS 512

enum JwDtype { JW_F32 = 0, JW_BF16 = 1 };

// Filter taps passed by value as a kernel argument (512 bytes of the 4 KB
// parameter space), so concurrent launches with different wavelets never
// share state.  Each block copies them into shared memory once.
struct JwTaps {
  float g[JW_MAX_TAPS];
  float h[JW_MAX_TAPS];
};

static inline JwTaps jw_make_taps(const float* g, const float* h, int m) {
  JwTaps t;
  for (int k = 0; k < JW_MAX_TAPS; ++k) {
    t.g[k] = k < m ? g[k] : 0.f;
    t.h[k] = k < m ? h[k] : 0.f;
  }
  return t;
}

__device__ __forceinline__ float jw_load(const float* p) { return *p; }
__device__ __forceinline__ float jw_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void jw_store(float* p, float v) { *p = v; }
// round-to-nearest-even, as torch's float32 -> bfloat16 cast
__device__ __forceinline__ void jw_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// p mod n for any p: the modulo only runs for the wrap-around positions
// (tile windows at the signal's ends, or a halo longer than the signal).
__device__ __forceinline__ long long jw_index(long long p, long long n) {
  if (p >= 0 && p < n) return p;
  const long long r = p % n;
  return r < 0 ? r + n : r;
}

// sign(w) * max(|w| - t, 0) (soft) or w * 1[|w| > t] (hard), as
// ops/denoise.py's soft_threshold / hard_threshold.
__device__ __forceinline__ float jw_shrink(float w, float t, int hard) {
  if (hard) return fabsf(w) > t ? w : 0.f;
  const float a = fmaxf(fabsf(w) - t, 0.f);
  return w > 0.f ? a : (w < 0.f ? -a : 0.f);
}

__device__ __forceinline__ void jw_stage_taps(const JwTaps& taps, float* sg,
                                              float* sh, int m) {
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    sg[k] = taps.g[k];
    sh[k] = taps.h[k];
  }
}

// Sum of one float per thread over the block, in a fixed order (warp
// shuffles, then the warps' sums in warp order), so a result never depends
// on scheduling.  The sum is valid in thread 0.  `scratch` holds
// JW_THREADS / 32 floats.  Every thread must call it: it synchronises the
// block, which also makes every shared-memory write before it visible.
__device__ __forceinline__ float jw_block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += scratch[w];
  __syncthreads();
  return s;
}

// Lift the 48 KB default cap on dynamic shared memory, launch, and report
// a refused launch (too much shared memory, bad grid), which would
// otherwise never run and never show up in torch.cuda.synchronize().
template <typename Kernel, typename... Args>
static int jw_launch(Kernel kernel, long long blocks, int smem,
                     cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, JW_THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}
