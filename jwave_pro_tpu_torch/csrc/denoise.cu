// Fused MODWT denoise kernel for Hopper (sm_90a): forward -> shrink ->
// inverse in one pass.
//
// Replaces jwave_pro_tpu/kernels/denoise_pallas.py _denoise_kernel.
//
// What bounds it on the H100: device-memory traffic, 1 read + 1 write per
// sample, against 2(L+2) passes for the two-kernel round trip — the
// coefficients never leave shared memory.  The price is shared memory:
// (L+2) rows of T + 2H floats per block, about 70 KB at T = 2048, Db4, L = 5,
// which needs the dynamic shared-memory attribute and caps the blocks per SM.
//
// Window of a block: [s - H, s + T + H) mod N.  The analysis chain loses
// (M-1)*2^(j-1) valid samples on the left per level, the synthesis chain the
// same on the right, so [H, H + T) — the output tile — stays exact.

#include "common.cuh"

template <typename T>
__global__ void __launch_bounds__(JW_THREADS)
jw_denoise_kernel(const T* __restrict__ x, const float* __restrict__ thr,
                  T* __restrict__ out, int n, int level, int m, int tile,
                  int halo, int ntiles, int hard, JwTaps taps) {
  extern __shared__ float smem[];
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  const int width = tile + 2 * halo;
  float* va = smem + 2 * JW_MAX_TAPS;
  float* vb = va + width;
  float* wrows = vb + width;  // W_1..W_L, shrunk, one row of `width` each

  const int row = blockIdx.x / ntiles;
  const long long s = (long long)(blockIdx.x - row * ntiles) * tile;
  const long long base = s - halo;
  const T* xr = x + (size_t)row * n;
  const float t = thr[row];

  jw_stage_taps(taps, sg, sh, m);
  for (int i = threadIdx.x; i < width; i += blockDim.x)
    va[i] = jw_load(xr + jw_index(base + i, n));
  __syncthreads();

  // Analysis: V_j, W_j valid on [lo, width).
  int lo = 0;
  for (int j = 1; j <= level; ++j) {
    const int d = 1 << (j - 1);
    lo += (m - 1) * d;
    float* wj = wrows + (size_t)(j - 1) * width;
    for (int i = lo + threadIdx.x; i < width; i += blockDim.x) {
      float v = 0.f, w = 0.f;
      for (int k = 0; k < m; ++k) {
        const float u = va[i - k * d];
        v = fmaf(sg[k], u, v);
        w = fmaf(sh[k], u, w);
      }
      vb[i] = v;
      wj[i] = jw_shrink(w, t, hard);
    }
    __syncthreads();
    float* tmp = va;
    va = vb;
    vb = tmp;
  }

  // Synthesis: V_{j-1} valid on [halo, hi); lo == halo here.
  int hi = width;
  for (int j = level; j >= 1; --j) {
    const int d = 1 << (j - 1);
    hi -= (m - 1) * d;
    const float* wj = wrows + (size_t)(j - 1) * width;
    for (int i = halo + threadIdx.x; i < hi; i += blockDim.x) {
      float acc = 0.f;
      for (int k = 0; k < m; ++k)
        acc += sg[k] * va[i + k * d] + sh[k] * wj[i + k * d];
      vb[i] = acc;
    }
    __syncthreads();
    float* tmp = va;
    va = vb;
    vb = tmp;
  }

  T* dst = out + (size_t)row * n;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const long long p = s + i;
    if (p < n) jw_store(dst + p, va[halo + i]);
  }
}

extern "C" {

// x (B, N) and thr (B,) float32 -> out (B, N); x/out of `dtype`.
int jw_modwt_denoise(const void* x, const float* thr, void* out, int batch,
                     int n, int level, const float* g, const float* h, int m,
                     int tile, int halo, int smem, int hard, int dtype,
                     int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int ntiles = (n + tile - 1) / tile;
  const long long blocks = (long long)ntiles * batch;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch(jw_denoise_kernel<__nv_bfloat16>, blocks, smem, st,
                     (const __nv_bfloat16*)x, thr, (__nv_bfloat16*)out, n,
                     level, m, tile, halo, ntiles, hard, taps);
  return jw_launch(jw_denoise_kernel<float>, blocks, smem, st,
                   (const float*)x, thr, (float*)out, n, level, m, tile, halo,
                   ntiles, hard, taps);
}

}  // extern "C"
