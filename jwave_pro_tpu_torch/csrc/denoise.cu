// Fused MODWT denoise kernel for Hopper (sm_90a): forward -> shrink ->
// inverse in one pass.
//
// Replaces jwave_pro_tpu/kernels/denoise_pallas.py _denoise_kernel.
//
// It moves 1 read + 1 write per sample, against 2(L+2) passes for the
// two-kernel round trip -- the coefficients never leave shared memory -- so
// what bounds it on the H100 is the cascade: 2M FMAs an output and level,
// analysis and synthesis alike, and the shared-memory accesses that feed
// them.  The price of the fusion is shared memory: (L+2) rows of T + 2H
// floats per block, about 70 KB at T = 2048, Db4, L = 5, which needs the
// dynamic shared-memory attribute and caps the blocks per SM.
//
// Window of a block: [s - H, s + T + H) mod N.  The analysis chain loses
// (M-1)*2^(j-1) valid samples on the left per level, the synthesis chain the
// same on the right, so [H, H + T) -- the output tile -- stays exact.
//
// Both chains are register chains (common.cuh), with the kernel templated
// on M = 2, 8, 16 so the taps are parameter-bank FFMA operands (a
// runtime-M instantiation, taps in shared memory, covers the others):
// the analysis through jw_level_pair, one fmaf chain over k ascending
// from 0.f for each of v and w, so every analysis value -- and every hard
// threshold decision -- is bitwise that of the one-output-a-thread loop;
// the synthesis through jw_level_adjoint.  Of the 2M FMAs an output and
// level, the taps were two shared loads each and the window a third (3M
// accesses an analysis output, 4M a synthesis one); in chains of R the
// window costs R + M - 1 loads a row for R outputs.

#include "common.cuh"

#define JW_DENOISE_R 5  // outputs in a register chain (odd: distinct banks)
#define JW_DENOISE_THREADS 256  // a block; three blocks an SM at Db4 L5

// Block (row, tile): window x[row, (s - H + i) mod N], i in [0, end),
// end = min(T, N - s) + 2H.  Shared memory: the taps, two V rows
// (ping-pong) and the shrunk W_1..W_L, each row T + 2H floats.
template <typename T, int MT>
__global__ void __launch_bounds__(JW_DENOISE_THREADS, 4)
jw_denoise_kernel(const T* __restrict__ x, const float* __restrict__ thr,
                  T* __restrict__ out, int n, int level, int m_run, int tile,
                  int halo, int ntiles, int hard, JwTaps taps) {
  extern __shared__ float smem[];
  const int m = MT > 0 ? MT : m_run;
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  const int width = tile + 2 * halo;
  float* va = smem + 2 * JW_MAX_TAPS;
  float* vb = va + width;
  float* wrows = vb + width;  // W_1..W_L, shrunk, one row of `width` each

  const int row = blockIdx.x / ntiles;
  const long long s = (long long)(blockIdx.x - row * ntiles) * tile;
  const long long rest = (long long)n - s;  // >= 1
  const int count = rest < tile ? (int)rest : tile;
  const int end = count + 2 * halo;
  const float t = thr[row];

  if (MT == 0) jw_stage_taps(taps, sg, sh, m);
  jw_load_window(x + (size_t)row * n, s - halo, n, va, end);
  __syncthreads();

  // Analysis: V_j, W_j valid on [lo, end).
  int lo = 0;
  for (int j = 1; j <= level; ++j) {
    lo += (m - 1) << (j - 1);
    float* wj = wrows + (size_t)(j - 1) * width;
    jw_level_pair<MT, JW_DENOISE_R>(va, lo, end, j - 1, m, taps, sg, sh,
                                    [&](int i, float v, float w) {
                                      vb[i] = v;
                                      wj[i] = jw_shrink(w, t, hard);
                                    });
    __syncthreads();
    float* tmp = va;
    va = vb;
    vb = tmp;
  }

  // Synthesis: V_{j-1} valid on [halo, hi); lo == halo here.
  int hi = end;
  for (int j = level; j >= 1; --j) {
    hi -= (m - 1) << (j - 1);
    const float* wj = wrows + (size_t)(j - 1) * width;
    jw_level_adjoint<MT, JW_DENOISE_R>(va, wj, halo, hi, j - 1, m, taps, sg,
                                       sh, [&](int i, float y) { vb[i] = y; });
    __syncthreads();
    float* tmp = va;
    va = vb;
    vb = tmp;
  }

  T* dst = out + (size_t)row * n + s;
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    jw_store(dst + i, va[halo + i]);
}

extern "C" {

// x (B, N) and thr (B,) float32 -> out (B, N); x/out of `dtype`.
// halo: (m - 1)(2^level - 1); smem: the bytes of the wrapper's plan
// (smem_bytes(level, m, 'denoise')): the taps and level + 2 rows of
// tile + 2 halo.
int jw_modwt_denoise(const void* x, const float* thr, void* out, int batch,
                     int n, int level, const float* g, const float* h, int m,
                     int tile, int halo, int smem, int hard, int dtype,
                     int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (tile < 1 || level < 1 || m < 1 || m > JW_MAX_TAPS ||
      halo != (m - 1) * ((1 << level) - 1) ||
      smem != (int)sizeof(float) *
                  (2 * JW_MAX_TAPS + (level + 2) * (tile + 2 * halo)))
    return (int)cudaErrorInvalidValue;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int ntiles = (n + tile - 1) / tile;
  const long long blocks = (long long)ntiles * batch;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch_threads(
        JW_PICK_M(jw_denoise_kernel, __nv_bfloat16, m), blocks,
        JW_DENOISE_THREADS, smem, st, (const __nv_bfloat16*)x, thr,
        (__nv_bfloat16*)out, n, level, m, tile, halo, ntiles, hard, taps);
  return jw_launch_threads(JW_PICK_M(jw_denoise_kernel, float, m), blocks,
                           JW_DENOISE_THREADS, smem, st, (const float*)x, thr,
                           (float*)out, n, level, m, tile, halo, ntiles, hard,
                           taps);
}

}  // extern "C"
