// Fused 2D MODWT kernels for Hopper (sm_90a): forward, inverse, and the
// single-pass forward -> shrink -> inverse denoise.
//
// Replace jwave_pro_tpu/kernels/modwt2_pallas.py _fwd2_kernel, _inv2_kernel
// and _denoise2_kernel.
//
// What bounds them on the H100: the cascade's shared-memory traffic — per
// window pixel and level, the column pass makes M loads and 2M fused
// multiply-adds, the row pass 2M loads and 4M — inflated by the recompute of
// the overlapping windows, (T+H)^2 / T^2 (3.1 at Db4 L3, T = 64), and by one
// resident block per SM when the three windows take most of the 227 KB.
// Device memory sees one read of the input and one write per band (forward),
// the mirror image (inverse), or one read and one write of the image plus
// the scratch traffic of the shrunk bands (denoise).
//
// Layout: a block owns a T x T output tile and a square window of side
// T + H (transforms) or T + 2H (denoise), H = (M-1)(2^L - 1), read as
// x[b, p mod R, q mod C] — no padded copy, any R and C, halo larger than the
// image included.  The 32 lanes of a warp walk 32 consecutive columns of one
// window row, the warps walk rows: shared-memory loads are conflict-free in
// both passes (the row pass reads a row stride apart across taps, never
// across lanes), device-memory loads and stores coalesce along the last axis.
// Three f32 windows live in shared memory: the running LL (overwritten in
// place by the next level's, which only reads the column pass) and the
// column pass's cl (g along columns) and ch (h along columns).
//
// Band letters (row, col), as ops/modwt2d.py: LH = g@rows of ch, HL =
// h@rows of cl, HH = h@rows of ch, LL = g@rows of cl; bands (LH, HL, HH) per
// level, LL_L last.

#include "common.cuh"

#define JW_WARPS (JW_THREADS / 32)

// Block -> (image, tile row, tile column); blocks < 2^31 by the wrapper.
struct JwTile2 {
  int b;
  long long r, c;  // top-left output pixel of the tile
};

__device__ __forceinline__ JwTile2 jw_tile2(long long t, int ntr, int ntc,
                                            int tile) {
  const long long per_image = (long long)ntr * ntc;
  JwTile2 tl;
  tl.b = (int)(t / per_image);
  const long long rem = t - (long long)tl.b * per_image;
  tl.r = (rem / ntc) * tile;
  tl.c = (rem % ntc) * tile;
  return tl;
}

// win[i][q] = src[(r0 + i) mod rows][(c0 + q) mod cols], i, q in [0, w).
template <typename T>
__device__ __forceinline__ void jw_load_window(const T* src, float* win,
                                               int w, long long r0,
                                               long long c0, int rows,
                                               int cols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < w; i += JW_WARPS) {
    const T* row = src + (size_t)jw_index(r0 + i, rows) * cols;
    for (int q = lane; q < w; q += 32)
      win[i * w + q] = jw_load(row + jw_index(c0 + q, cols));
  }
}

// Column pass of level d: cl, ch on rows [rlo, w), columns [lo, w), from
// ll valid on columns [lo - (M-1)d, w).  Forward convolution: reads left.
__device__ __forceinline__ void jw_col_pass(const float* ll, float* cl,
                                            float* ch, const float* sg,
                                            const float* sh, int m, int d,
                                            int w, int rlo, int lo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = rlo + warp; i < w; i += JW_WARPS) {
    const float* src = ll + i * w;
    for (int q = lo + lane; q < w; q += 32) {
      float a = 0.f, e = 0.f;
      for (int k = 0; k < m; ++k) {
        const float u = src[q - k * d];
        a = fmaf(sg[k], u, a);
        e = fmaf(sh[k], u, e);
      }
      cl[i * w + q] = a;
      ch[i * w + q] = e;
    }
  }
}

// Row pass of one window pixel: (LL, HL, LH, HH) from cl, ch above it.
struct JwQuad {
  float ll, hl, lh, hh;
};

__device__ __forceinline__ JwQuad jw_row_taps(const float* cl, const float* ch,
                                              const float* sg,
                                              const float* sh, int m, int d,
                                              int w, int i, int q) {
  JwQuad o = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < m; ++k) {
    const int at = (i - k * d) * w + q;
    const float a = cl[at], e = ch[at];
    o.ll = fmaf(sg[k], a, o.ll);
    o.hl = fmaf(sh[k], a, o.hl);
    o.lh = fmaf(sg[k], e, o.lh);
    o.hh = fmaf(sh[k], e, o.hh);
  }
  return o;
}

// Column adjoint of level d: ll[i][q] = sum_k g cl[i][q+kd] + h ch[i][q+kd]
// on rows [rlo, rhi), columns [clo, chi).  Reads right.
__device__ __forceinline__ void jw_col_adjoint(float* ll, const float* cl,
                                               const float* ch,
                                               const float* sg,
                                               const float* sh, int m, int d,
                                               int w, int rlo, int rhi,
                                               int clo, int chi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = rlo + warp; i < rhi; i += JW_WARPS) {
    const float* a = cl + i * w;
    const float* e = ch + i * w;
    for (int q = clo + lane; q < chi; q += 32) {
      float acc = 0.f;
      for (int k = 0; k < m; ++k)
        acc += fmaf(sh[k], e[q + k * d], sg[k] * a[q + k * d]);
      ll[i * w + q] = acc;
    }
  }
}

// Forward.  Block window: rows/columns [tile origin - H, + T), LL valid on
// [lo, w)^2 after each level, lo growing by (M-1)d; window index H is the
// tile's first output pixel.
template <typename T>
__global__ void __launch_bounds__(JW_THREADS)
jw_modwt2_fwd_kernel(const T* __restrict__ x, T* __restrict__ out, int batch,
                     int rows, int cols, int level, int m, int tile, int halo,
                     int ntr, int ntc, JwTaps taps) {
  extern __shared__ float smem[];
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  const int w = tile + halo;
  float* ll = smem + 2 * JW_MAX_TAPS;
  float* cl = ll + w * w;
  float* ch = cl + w * w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const JwTile2 tl = jw_tile2(blockIdx.x, ntr, ntc, tile);
  const long long r0 = tl.r - halo, c0 = tl.c - halo;
  const size_t img = (size_t)rows * cols;
  const size_t plane = (size_t)batch * img;

  jw_stage_taps(taps, sg, sh, m);
  jw_load_window(x + (size_t)tl.b * img, ll, w, r0, c0, rows, cols);
  __syncthreads();

  int lo = 0;
  for (int j = 1; j <= level; ++j) {
    const int d = 1 << (j - 1);
    const int rlo = lo;
    lo += (m - 1) * d;
    jw_col_pass(ll, cl, ch, sg, sh, m, d, w, rlo, lo);
    __syncthreads();
    T* lh = out + (size_t)(3 * (j - 1)) * plane + (size_t)tl.b * img;
    for (int i = lo + warp; i < w; i += JW_WARPS) {
      const long long p = r0 + i;
      const bool store_row = i >= halo && p < rows;
      for (int q = lo + lane; q < w; q += 32) {
        const JwQuad o = jw_row_taps(cl, ch, sg, sh, m, d, w, i, q);
        ll[i * w + q] = o.ll;
        const long long s = c0 + q;
        if (store_row && q >= halo && s < cols) {
          const size_t off = (size_t)p * cols + s;
          jw_store(lh + off, o.lh);
          jw_store(lh + plane + off, o.hl);
          jw_store(lh + 2 * plane + off, o.hh);
        }
      }
    }
    __syncthreads();
  }
  T* dst = out + (size_t)(3 * level) * plane + (size_t)tl.b * img;
  for (int i = halo + warp; i < w; i += JW_WARPS) {
    const long long p = r0 + i;
    if (p >= rows) break;
    for (int q = halo + lane; q < w; q += 32) {
      const long long s = c0 + q;
      if (s < cols) jw_store(dst + (size_t)p * cols + s, ll[i * w + q]);
    }
  }
}

// Inverse.  Block window: rows/columns [tile origin, + T + H); LL valid on
// [0, len)^2, len shrinking by (M-1)d a level.  The three detail bands of
// the current level are read from device memory (through L1) in the row
// adjoint; LL, cl and ch stay in shared memory.
template <typename T>
__global__ void __launch_bounds__(JW_THREADS)
jw_modwt2_inv_kernel(const T* __restrict__ c, T* __restrict__ out, int batch,
                     int rows, int cols, int level, int m, int tile, int halo,
                     int ntr, int ntc, JwTaps taps) {
  extern __shared__ float smem[];
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  const int w = tile + halo;
  float* ll = smem + 2 * JW_MAX_TAPS;
  float* cl = ll + w * w;
  float* ch = cl + w * w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const JwTile2 tl = jw_tile2(blockIdx.x, ntr, ntc, tile);
  const long long r0 = tl.r, c0 = tl.c;
  const size_t img = (size_t)rows * cols;
  const size_t plane = (size_t)batch * img;

  jw_stage_taps(taps, sg, sh, m);
  jw_load_window(c + (size_t)(3 * level) * plane + (size_t)tl.b * img, ll, w,
                 r0, c0, rows, cols);
  __syncthreads();

  int len = w;
  for (int j = level; j >= 1; --j) {
    const int d = 1 << (j - 1);
    const int nlen = len - (m - 1) * d;
    const T* lh = c + (size_t)(3 * (j - 1)) * plane + (size_t)tl.b * img;
    const T* hl = lh + plane;
    const T* hh = lh + 2 * plane;
    // undo the row pass: cl from (LL, HL), ch from (LH, HH)
    for (int i = warp; i < nlen; i += JW_WARPS) {
      for (int q = lane; q < len; q += 32) {
        const size_t col = (size_t)jw_index(c0 + q, cols);
        float a = 0.f, e = 0.f;
        for (int k = 0; k < m; ++k) {
          const int ii = i + k * d;
          const size_t off = (size_t)jw_index(r0 + ii, rows) * cols + col;
          a += fmaf(sh[k], jw_load(hl + off), sg[k] * ll[ii * w + q]);
          e += fmaf(sh[k], jw_load(hh + off), sg[k] * jw_load(lh + off));
        }
        cl[i * w + q] = a;
        ch[i * w + q] = e;
      }
    }
    __syncthreads();
    // undo the column pass
    jw_col_adjoint(ll, cl, ch, sg, sh, m, d, w, 0, nlen, 0, nlen);
    __syncthreads();
    len = nlen;
  }
  T* dst = out + (size_t)tl.b * img;
  for (int i = warp; i < tile; i += JW_WARPS) {
    const long long p = r0 + i;
    if (p >= rows) break;
    for (int q = lane; q < tile; q += 32) {
      const long long s = c0 + q;
      if (s < cols) jw_store(dst + (size_t)p * cols + s, ll[i * w + q]);
    }
  }
}

// Denoise.  Block window: rows/columns [tile origin - H, + T + H), side
// w = T + 2H.  Analysis as the forward (LL valid on [lo, w)^2); the shrunk
// detail bands of level j go to this block's scratch, only on the region
// [H, H + T + lo_j)^2 the synthesis reads back; synthesis as the inverse on
// [H, hi)^2, hi shrinking from w to H + T, the output tile.  Blocks loop over
// the tiles (grid = resident blocks), so the scratch is grid x 3L x w^2 f32.
template <typename T>
__global__ void __launch_bounds__(JW_THREADS)
jw_modwt2_denoise_kernel(const T* __restrict__ x, const float* __restrict__ thr,
                         T* __restrict__ out, float* scratch,
                         int batch, int rows, int cols, int level, int m,
                         int tile, int halo, int ntr, int ntc, int hard,
                         JwTaps taps) {
  extern __shared__ float smem[];
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  const int w = tile + 2 * halo;
  const size_t ww = (size_t)w * w;
  float* ll = smem + 2 * JW_MAX_TAPS;
  float* cl = ll + ww;
  float* ch = cl + ww;
  float* scr = scratch + (size_t)blockIdx.x * 3 * level * ww;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t img = (size_t)rows * cols;
  const long long ntiles = (long long)batch * ntr * ntc;

  jw_stage_taps(taps, sg, sh, m);
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const JwTile2 tl = jw_tile2(t, ntr, ntc, tile);
    const long long r0 = tl.r - halo, c0 = tl.c - halo;
    const float th = thr[tl.b];
    jw_load_window(x + (size_t)tl.b * img, ll, w, r0, c0, rows, cols);
    __syncthreads();

    // analysis
    int lo = 0;
    for (int j = 1; j <= level; ++j) {
      const int d = 1 << (j - 1);
      const int rlo = lo;
      lo += (m - 1) * d;
      jw_col_pass(ll, cl, ch, sg, sh, m, d, w, rlo, lo);
      __syncthreads();
      const int need = halo + tile + lo;  // synthesis reads [halo, need)
      float* band = scr + (size_t)(3 * (j - 1)) * ww;
      for (int i = lo + warp; i < w; i += JW_WARPS) {
        const bool keep_row = i >= halo && i < need;
        for (int q = lo + lane; q < w; q += 32) {
          const JwQuad o = jw_row_taps(cl, ch, sg, sh, m, d, w, i, q);
          ll[i * w + q] = o.ll;
          if (keep_row && q >= halo && q < need) {
            const size_t at = (size_t)i * w + q;
            band[at] = jw_shrink(o.lh, th, hard);
            band[ww + at] = jw_shrink(o.hl, th, hard);
            band[2 * ww + at] = jw_shrink(o.hh, th, hard);
          }
        }
      }
      __syncthreads();
    }

    // synthesis: LL_L valid on [halo, w)
    int hi = w;
    for (int j = level; j >= 1; --j) {
      const int d = 1 << (j - 1);
      const int nhi = hi - (m - 1) * d;
      const float* lh = scr + (size_t)(3 * (j - 1)) * ww;
      const float* hl = lh + ww;
      const float* hh = lh + 2 * ww;
      for (int i = halo + warp; i < nhi; i += JW_WARPS) {
        for (int q = halo + lane; q < hi; q += 32) {
          float a = 0.f, e = 0.f;
          for (int k = 0; k < m; ++k) {
            const int at = (i + k * d) * w + q;
            a += fmaf(sh[k], hl[at], sg[k] * ll[at]);
            e += fmaf(sh[k], hh[at], sg[k] * lh[at]);
          }
          cl[i * w + q] = a;
          ch[i * w + q] = e;
        }
      }
      __syncthreads();
      jw_col_adjoint(ll, cl, ch, sg, sh, m, d, w, halo, nhi, halo, nhi);
      __syncthreads();
      hi = nhi;
    }

    T* dst = out + (size_t)tl.b * img;
    for (int i = warp; i < tile; i += JW_WARPS) {
      const long long p = tl.r + i;
      if (p >= rows) break;
      for (int q = lane; q < tile; q += 32) {
        const long long s = tl.c + q;
        if (s < cols)
          jw_store(dst + (size_t)p * cols + s, ll[(halo + i) * w + halo + q]);
      }
    }
    __syncthreads();  // the next tile's window overwrites ll
  }
}

extern "C" {

// x (B, R, C) -> out (3L+1, B, R, C), both of `dtype`, contiguous.
int jw_modwt2_fwd(const void* x, void* out, int batch, int rows, int cols,
                  int level, const float* g, const float* h, int m, int tile,
                  int halo, int smem, int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int ntr = (rows + tile - 1) / tile, ntc = (cols + tile - 1) / tile;
  const long long blocks = (long long)batch * ntr * ntc;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch(jw_modwt2_fwd_kernel<__nv_bfloat16>, blocks, smem, st,
                     (const __nv_bfloat16*)x, (__nv_bfloat16*)out, batch,
                     rows, cols, level, m, tile, halo, ntr, ntc, taps);
  return jw_launch(jw_modwt2_fwd_kernel<float>, blocks, smem, st,
                   (const float*)x, (float*)out, batch, rows, cols, level, m,
                   tile, halo, ntr, ntc, taps);
}

// c (3L+1, B, R, C) -> out (B, R, C), both of `dtype`, contiguous.
int jw_modwt2_inv(const void* c, void* out, int batch, int rows, int cols,
                  int level, const float* g, const float* h, int m, int tile,
                  int halo, int smem, int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int ntr = (rows + tile - 1) / tile, ntc = (cols + tile - 1) / tile;
  const long long blocks = (long long)batch * ntr * ntc;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch(jw_modwt2_inv_kernel<__nv_bfloat16>, blocks, smem, st,
                     (const __nv_bfloat16*)c, (__nv_bfloat16*)out, batch,
                     rows, cols, level, m, tile, halo, ntr, ntc, taps);
  return jw_launch(jw_modwt2_inv_kernel<float>, blocks, smem, st,
                   (const float*)c, (float*)out, batch, rows, cols, level, m,
                   tile, halo, ntr, ntc, taps);
}

// Blocks of the denoise kernel resident on the whole card at `smem` bytes.
int jw_modwt2_denoise_blocks(int smem, int dtype, int device, int* blocks) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, sms = 0;
  if (dtype == JW_BF16) {
    auto kernel = jw_modwt2_denoise_kernel<__nv_bfloat16>;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        JW_THREADS, smem);
  } else {
    auto kernel = jw_modwt2_denoise_kernel<float>;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        JW_THREADS, smem);
  }
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *blocks = per_sm * sms;
  return (int)e;
}

// x (B, R, C) and thr (B,) float32 -> out (B, R, C); x/out of `dtype`.
// scratch: grid x 3L x w x w float32, w = tile + 2 halo.
int jw_modwt2_denoise(const void* x, const float* thr, void* out,
                      float* scratch, int grid, int batch, int rows, int cols,
                      int level, const float* g, const float* h, int m,
                      int tile, int halo, int smem, int hard, int dtype,
                      int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int ntr = (rows + tile - 1) / tile, ntc = (cols + tile - 1) / tile;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch(jw_modwt2_denoise_kernel<__nv_bfloat16>, grid, smem, st,
                     (const __nv_bfloat16*)x, thr, (__nv_bfloat16*)out,
                     scratch, batch, rows, cols, level, m, tile, halo, ntr,
                     ntc, hard, taps);
  return jw_launch(jw_modwt2_denoise_kernel<float>, grid, smem, st,
                   (const float*)x, thr, (float*)out, scratch, batch, rows,
                   cols, level, m, tile, halo, ntr, ntc, hard, taps);
}

}  // extern "C"
