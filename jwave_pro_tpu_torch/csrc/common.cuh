// Shared pieces of the MODWT kernels: tap struct, dtype load/store, circular
// indexing and the launch helper.  Kernels allocate nothing; each C entry
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

__device__ __forceinline__ void jw_stage_taps(const JwTaps& taps, float* sg,
                                              float* sh, int m) {
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    sg[k] = taps.g[k];
    sh[k] = taps.h[k];
  }
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
