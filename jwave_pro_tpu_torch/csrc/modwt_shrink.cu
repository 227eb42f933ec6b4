// The shrinking inverse (#3s, the denoise's shrink inside #3): modwt.cu's
// inverse body with every detail row shrunk as it loads, in a source of
// its own: the build compiles each source in its own nvcc process, all at
// once, so the kernel's 16 instantiations (f32/bf16 x M = 2, 8, 16, any M
// x soft, hard) compile beside modwt.cu's 24 and not after them.

#include "modwt_inv.cuh"

// The inverse of shrunk detail rows: the denoise's shrink and inverse in
// one pass over the forward's coefficients.
template <typename T, int MT, int SHRINK>
__global__ void __launch_bounds__(JW_INV_THREADS, 4)
jw_modwt_inv_shrink_kernel(const T* __restrict__ c, T* __restrict__ out,
                           int batch, int n, int level, int m_run, int tile,
                           int halo, int ntiles, JwTaps taps,
                           const T* __restrict__ thr, float value, int ls,
                           int rs) {
  jw_modwt_inv_body<T, MT, SHRINK>(c, out, batch, n, level, m_run, tile,
                                   halo, ntiles, taps, thr, value, ls, rs);
}

// jw_modwt_inv_shrink_kernel for filter length m, on JW_PICK_M's rule.
template <typename T, int SHRINK>
static auto jw_pick_inv_shrink(int m) {
  return m == 8    ? jw_modwt_inv_shrink_kernel<T, 8, SHRINK>
         : m == 2  ? jw_modwt_inv_shrink_kernel<T, 2, SHRINK>
         : m == 16 ? jw_modwt_inv_shrink_kernel<T, 16, SHRINK>
                   : jw_modwt_inv_shrink_kernel<T, 0, SHRINK>;
}

extern "C" {

// The same inverse with every detail row W_j (row j - 1 of c, j = 1..L)
// shrunk as it loads (hard: the hard rule, else soft) by its threshold for
// row b, thr[(j - 1) ls + b rs] (thr of `dtype`, on `device`), or `value`
// for every row where thr is null.  V_L is read as it is.
int jw_modwt_inv_shrink(const void* c, const void* thr, float value, int ls,
                        int rs, int hard, void* out, int batch, int n,
                        int level, const float* g, const float* h, int m,
                        int tile, int halo, int smem, int dtype, int device,
                        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (tile < 1 || level < 1 || m < 1 || m > JW_MAX_TAPS ||
      halo != (m - 1) * ((1 << level) - 1) ||
      smem != (int)sizeof(float) * (2 * JW_MAX_TAPS + 3 * (tile + halo)))
    return (int)cudaErrorInvalidValue;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int ntiles = (n + tile - 1) / tile;
  const long long blocks = (long long)ntiles * batch;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16) {
    auto* k = hard ? jw_pick_inv_shrink<__nv_bfloat16, JW_HARD>(m)
                   : jw_pick_inv_shrink<__nv_bfloat16, JW_SOFT>(m);
    return jw_launch_threads(k, blocks, JW_INV_THREADS, smem, st,
                             (const __nv_bfloat16*)c, (__nv_bfloat16*)out,
                             batch, n, level, m, tile, halo, ntiles, taps,
                             (const __nv_bfloat16*)thr, value, ls, rs);
  }
  auto* k = hard ? jw_pick_inv_shrink<float, JW_HARD>(m)
                 : jw_pick_inv_shrink<float, JW_SOFT>(m);
  return jw_launch_threads(k, blocks, JW_INV_THREADS, smem, st,
                           (const float*)c, (float*)out, batch, n, level, m,
                           tile, halo, ntiles, taps, (const float*)thr,
                           value, ls, rs);
}

}  // extern "C"
