// The 2D shrinking inverse (#10s, the 2D denoise's shrink inside #10):
// modwt2.cu's inverse body with every detail band shrunk as it loads, in a
// source of its own: the build compiles each source in its own nvcc
// process, all at once, so the kernel's 16 instantiations (f32/bf16 x M =
// 2, 8, 16, any M x soft, hard) compile beside modwt2.cu's and not after
// them.  Replaces no Pallas kernel: the JAX package's 2D denoise shrinks in
// XLA before its inverse kernel.

#include "modwt2_inv.cuh"

// The inverse of shrunk detail bands: the 2D denoise's shrink and inverse
// in one pass over the forward's coefficients.  Its work and memory are
// #10's, plus three shrinks a pixel and level where it stores the bands to
// the G-row buffer.
template <typename T, int MT, int SHRINK>
__global__ void __launch_bounds__(JW_THREADS, 1)
jw_modwt2_inv_shrink_kernel(const T* __restrict__ c, T* __restrict__ out,
                            int batch, int rows, int cols, int level,
                            int m_run, int w, int grp, int tc, int run,
                            JwTaps taps, const T* __restrict__ thr,
                            float value, int ls, int rs) {
  jw_modwt2_inv_body<T, MT, SHRINK>(c, out, batch, rows, cols, level, m_run,
                                    w, grp, tc, run, taps, thr, value, ls,
                                    rs);
}

// jw_modwt2_inv_shrink_kernel for filter length m: M = 8, 2, 16 as template
// constants, any other M at run time.
template <typename T, int SHRINK>
static auto jw_pick_inv2_shrink(int m) {
  return m == 8    ? jw_modwt2_inv_shrink_kernel<T, 8, SHRINK>
         : m == 2  ? jw_modwt2_inv_shrink_kernel<T, 2, SHRINK>
         : m == 16 ? jw_modwt2_inv_shrink_kernel<T, 16, SHRINK>
                   : jw_modwt2_inv_shrink_kernel<T, 0, SHRINK>;
}

extern "C" {

// jw_modwt2_inv with every detail band shrunk as it loads (hard: the hard
// rule, else soft): band k of level j (row 3 (j - 1) + k of c) of image b
// by thr[(3 (j - 1) + k) ls + b rs] (thr of `dtype`, on `device`), or by
// `value` for every band and image where thr is null.  LL_L is read as it
// is.  The launch arguments are jw_modwt2_inv's, the shared memory too:
// the thresholds of levels 1 .. L-1 sit in the taps' unused tail, which
// the transforms' gate, (m - 1)(2^L - 1) <= 131, leaves long enough.
int jw_modwt2_inv_shrink(const void* c, const void* thr, float value, int ls,
                         int rs, int hard, void* out, int grid, int batch,
                         int rows, int cols, int level, const float* g,
                         const float* h, int m, int w, int grp, int tc,
                         int run, int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!jw2d_strip_ok(grid, w, grp, tc, run, (m - 1) * ((1 << level) - 1)) ||
      m + 3 * (level - 1) > JW_MAX_TAPS)
    return (int)cudaErrorInvalidValue;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int smem = (int)sizeof(float) * jw2t_smem_floats(1, w, grp, level, m);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16) {
    auto* k = hard ? jw_pick_inv2_shrink<__nv_bfloat16, JW_HARD>(m)
                   : jw_pick_inv2_shrink<__nv_bfloat16, JW_SOFT>(m);
    return jw_launch(k, grid, smem, st, (const __nv_bfloat16*)c,
                     (__nv_bfloat16*)out, batch, rows, cols, level, m, w, grp,
                     tc, run, taps, (const __nv_bfloat16*)thr, value, ls, rs);
  }
  auto* k = hard ? jw_pick_inv2_shrink<float, JW_HARD>(m)
                 : jw_pick_inv2_shrink<float, JW_SOFT>(m);
  return jw_launch(k, grid, smem, st, (const float*)c, (float*)out, batch,
                   rows, cols, level, m, w, grp, tc, run, taps,
                   (const float*)thr, value, ls, rs);
}

}  // extern "C"
