// Fused MODWT wavelet variance for Hopper (sm_90a).
//
// Replaces jwave_pro_tpu/kernels/variance_pallas.py _var_kernel: the
// forward cascade of jw_modwt_fwd_kernel (csrc/modwt.cu) with each level's
// sum of squares over the block's outputs in place of the stores, so the
// coefficients never reach device memory.
//
// What bounds it on the H100: with one read per sample and no stores, the
// device-memory floor is ~1/(L+2) of the forward kernel's; what is left is
// the cascade itself, 2·M shared-memory loads and 2·M FMAs per sample and
// level.  The design keeps the forward kernel's window (T outputs plus the
// exact halo, read as x[p mod N], so any N runs) and adds one block-wide
// sum per level.
//
// Reduction across blocks: the TPU kernel accumulated across its sequential
// grid axis in a resident output block; CUDA blocks run in no order.  Each
// block writes its tile's sums to partial[level][row][tile], and the wrapper
// adds the tiles up with torch.  No atomics: the statistic does not depend
// on the order the blocks ran in.

#include "common.cuh"

// Block (row, tile): window x[row, (s - H + i) mod N], i in [0, T + H), as
// in jw_modwt_fwd_kernel.  Outputs at window indices [H, H + valid) count,
// valid = min(T, N - s): positions past N never do.
template <typename T>
__global__ void __launch_bounds__(JW_THREADS)
jw_modwt_var_kernel(const T* __restrict__ x, float* __restrict__ partial,
                    int batch, int n, int level, int m, int tile, int halo,
                    int ntiles, JwTaps taps) {
  extern __shared__ float smem[];
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  float* red = smem + 2 * JW_MAX_TAPS;  // JW_THREADS / 32 warp sums
  const int width = tile + halo;
  float* a = red + JW_THREADS / 32;
  float* b = a + width;

  const int row = blockIdx.x / ntiles;
  const int tix = blockIdx.x - row * ntiles;
  const long long s = (long long)tix * tile;
  const long long base = s - halo;
  const long long rest = (long long)n - s;  // >= 1
  const int end = halo + (rest < tile ? (int)rest : tile);
  const T* xr = x + (size_t)row * n;
  const size_t plane = (size_t)batch * ntiles;  // partial is (L+1, B, tiles)
  float* out = partial + (size_t)row * ntiles + tix;

  jw_stage_taps(taps, sg, sh, m);
  for (int i = threadIdx.x; i < width; i += blockDim.x)
    a[i] = jw_load(xr + jw_index(base + i, n));
  __syncthreads();

  int lo = 0;
  for (int j = 1; j <= level; ++j) {
    const int d = 1 << (j - 1);
    lo += (m - 1) * d;
    float acc = 0.f;
    for (int i = lo + threadIdx.x; i < width; i += blockDim.x) {
      float v = 0.f, w = 0.f;
      for (int k = 0; k < m; ++k) {
        const float t = a[i - k * d];
        v = fmaf(sg[k], t, v);
        w = fmaf(sh[k], t, w);
      }
      b[i] = v;
      if (i >= halo && i < end) acc = fmaf(w, w, acc);
    }
    // its barriers also complete this level's V row before the next reads it
    const float tot = jw_block_sum(acc, red);
    if (threadIdx.x == 0) out[(size_t)(j - 1) * plane] = tot;
    float* t = a;
    a = b;
    b = t;
  }
  float acc = 0.f;
  for (int i = halo + threadIdx.x; i < end; i += blockDim.x)
    acc = fmaf(a[i], a[i], acc);
  const float tot = jw_block_sum(acc, red);
  if (threadIdx.x == 0) out[(size_t)level * plane] = tot;
}

extern "C" {

// x (B, N) of `dtype` -> partial (L+1, B, ceil(N / tile)) float32 sums of
// W_1² .. W_L², V_L² per tile; contiguous, on `device`.
int jw_modwt_var(const void* x, float* partial, int batch, int n, int level,
                 const float* g, const float* h, int m, int tile, int halo,
                 int smem, int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int ntiles = (n + tile - 1) / tile;
  const long long blocks = (long long)ntiles * batch;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch(jw_modwt_var_kernel<__nv_bfloat16>, blocks, smem, st,
                     (const __nv_bfloat16*)x, partial, batch, n, level, m,
                     tile, halo, ntiles, taps);
  return jw_launch(jw_modwt_var_kernel<float>, blocks, smem, st,
                   (const float*)x, partial, batch, n, level, m, tile, halo,
                   ntiles, taps);
}

}  // extern "C"
