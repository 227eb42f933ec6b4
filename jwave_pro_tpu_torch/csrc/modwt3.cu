// Fused 3D MODWT kernels for Hopper (sm_90a): forward and inverse.
//
// Replace jwave_pro_tpu/kernels/modwt3_pallas.py _fwd3_kernel and
// _inv3_kernel.
//
// What bounds them on the H100: the cascade's shared-memory traffic.  Per
// window voxel and level the forward makes 9M shared loads and 14M fused
// multiply-adds (the column pass M loads for the (g, h) pair, four row
// passes and four depth passes of one quadrant each); the inverse the same
// count, plus 7M loads of the level's detail bands from device memory
// (through L1) in its depth adjoints.  The windows overlap, so each output
// voxel is computed wd wr 32 / (Td Tr Tc) times over (2.5 at Db4 level 1,
// 9.7 at level 2), and the three windows take up to 226 KB of the 227 KB:
// one resident block of 16 warps per SM.  Device memory sees, per level,
// one read of LLL_{j-1} and one write per band and of LLL_j (forward), the
// mirror image (inverse).
//
// Levels: a 3D window pays its halo on three axes, so a window reaching back
// the whole cascade's halo H = (M-1)(2^L - 1) leaves no tile (Db4 L2: H = 21
// in a 24 x 25 x 32 window).  One cooperative launch therefore runs the
// levels in turn with a grid-wide barrier between them; level j's window
// reaches back only h_j = (M-1) 2^(j-1), and LLL_j goes through an f32
// scratch volume in device memory (min(L-1, 2) volumes, ping-pong).  The
// grid is the card's resident blocks; each block loops over the level's
// tiles.
//
// Layout: at level j a block owns a Td x Tr x Tc output tile and a window
// of (Td + h) x (Tr + h) x 32 voxels, Tc = 32 - h, the tile chosen per level
// by the wrapper (kernels/modwt3_cuda.py, tile3d): the window is one warp
// wide along C, so lane q of every warp owns window column q, device loads
// and stores coalesce along the last axis and shared-memory loads are
// conflict-free (the row and depth passes read a whole row or plane apart
// across taps, never across lanes).  The window is read as
// x[b, p mod D, q mod R, s mod C] — no padded copy, no tile plan over
// (D, R, C) — so any volume runs, halo larger than an axis included.
//
// Three f32 windows live in shared memory:
//   forward: the column pass turns LLL_{j-1} (window a) into cl (b) and ch
//   (c); each row-pass quadrant is built in a and consumed at once by its
//   depth pass, which writes its two octants straight to device memory.
//   inverse: each depth-adjoint quadrant is built in b and added into its
//   row adjoint at once, cl in a and ch in c, so no two quadrants are ever
//   live; the column adjoint writes LLL_{j-1} into b.
//
// Octant letters (depth, row, col), as ops/modwt2d.py: per level bands
// (LLH, LHL, LHH, HLL, HLH, HHL, HHH), then LLL_L last.

#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

#define JW_WARPS (JW_THREADS / 32)
#define JW3_WC 32          // window extent along C: one warp's lanes
#define JW3_MAX_LEVELS 8

// Each level's tile depth and rows (its columns are 32 - h_j).
struct JwPlan3 {
  int td[JW3_MAX_LEVELS];
  int tr[JW3_MAX_LEVELS];
};

// Tile t of a level -> (volume, tile origin).
struct JwTile3 {
  int b;
  long long d, r, c;
};

__device__ __forceinline__ JwTile3 jw_tile3(long long t, int ntd, int ntr,
                                            int ntc, int td, int tr,
                                            int tc) {
  const long long per_plane = (long long)ntr * ntc;
  const long long per_vol = (long long)ntd * per_plane;
  JwTile3 tl;
  tl.b = (int)(t / per_vol);
  long long rem = t - (long long)tl.b * per_vol;
  tl.d = (rem / per_plane) * td;
  rem %= per_plane;
  tl.r = (rem / ntc) * tr;
  tl.c = (rem % ntc) * tc;
  return tl;
}

// The window's view of one volume: origin (d0, r0, c0), extents wd x wr x
// 32, sizes D x R x C.  Window voxel (i, j, q) sits at shared index
// (i wr + j) 32 + q and reads volume voxel (d0+i, r0+j, c0+q) mod (D, R, C).
struct JwWin3 {
  long long d0, r0, c0;
  int wd, wr;
  int D, R, C;

  __device__ __forceinline__ size_t row_offset(int i, int j) const {
    return ((size_t)jw_index(d0 + i, D) * R + jw_index(r0 + j, R)) * C;
  }
};

template <typename T>
__device__ __forceinline__ void jw3_load(const T* src, float* win,
                                         const JwWin3& w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t col = (size_t)jw_index(w.c0 + lane, w.C);
  for (int t = warp; t < w.wd * w.wr; t += JW_WARPS) {
    const int i = t / w.wr, j = t - i * w.wr;
    win[t * JW3_WC + lane] = jw_load(src + w.row_offset(i, j) + col);
  }
}

// ---------------------------------------------------------------------------
// Forward passes.  Each reads below (toward the window origin): an output at
// index p needs p - k dil, k < M.  `lo` is the first valid index of the
// source on every axis, `nlo` = lo + (M-1) dil that of the result.

// Column pass: cl, ch on d, r in [lo, w), q in [nlo, 32).
__device__ __forceinline__ void jw3_col_pass(const float* src, float* cl,
                                             float* ch, const float* sg,
                                             const float* sh, int m, int dil,
                                             int wd, int wr, int lo,
                                             int nlo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nr = wr - lo;
  if (lane < nlo) return;
  for (int t = warp; t < (wd - lo) * nr; t += JW_WARPS) {
    const int i = lo + t / nr, j = lo + t % nr;
    const int at = (i * wr + j) * JW3_WC + lane;
    float a = 0.f, e = 0.f;
    for (int k = 0; k < m; ++k) {
      const float u = src[at - k * dil];
      a = fmaf(sg[k], u, a);
      e = fmaf(sh[k], u, e);
    }
    cl[at] = a;
    ch[at] = e;
  }
}

// Row pass with one filter f: dst on d in [lo, w), r and q in [nlo, w).
__device__ __forceinline__ void jw3_row_pass(const float* src, float* dst,
                                             const float* f, int m, int dil,
                                             int wd, int wr, int lo,
                                             int nlo) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nr = wr - nlo;
  const int step = dil * JW3_WC;
  if (lane < nlo) return;
  for (int t = warp; t < (wd - lo) * nr; t += JW_WARPS) {
    const int i = lo + t / nr, j = nlo + t % nr;
    const int at = (i * wr + j) * JW3_WC + lane;
    float a = 0.f;
    for (int k = 0; k < m; ++k) a = fmaf(f[k], src[at - k * step], a);
    dst[at] = a;
  }
}

// Depth pass of one quadrant q on d, r, q in [h, w): its g output goes to
// device band `band_g`, its h output to `band_h`, only at the tile's
// interior (window index >= h on every axis, inside the volume).  The
// bands point at this volume's first voxel.
template <typename G, typename T>
__device__ __forceinline__ void jw3_depth_pass(const float* quad, G* band_g,
                                               T* band_h, const float* sg,
                                               const float* sh, int m,
                                               int dil, const JwWin3& w,
                                               int h) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long s = w.c0 + lane;
  if (lane < h || s >= w.C) return;
  const int nr = w.wr - h;
  const int step = dil * w.wr * JW3_WC;
  for (int t = warp; t < (w.wd - h) * nr; t += JW_WARPS) {
    const int i = h + t / nr, j = h + t % nr;
    const long long p = w.d0 + i, q = w.r0 + j;
    if (p >= w.D || q >= w.R) continue;
    const int at = (i * w.wr + j) * JW3_WC + lane;
    float a = 0.f, e = 0.f;
    for (int k = 0; k < m; ++k) {
      const float u = quad[at - k * step];
      a = fmaf(sg[k], u, a);
      e = fmaf(sh[k], u, e);
    }
    const size_t off = ((size_t)p * w.R + q) * w.C + s;
    jw_store(band_g + off, a);
    jw_store(band_h + off, e);
  }
}

// Forward.  One cooperative launch runs the levels in turn, a grid-wide
// barrier between them: level j reads LLL_{j-1} (the input, or the f32
// scratch), every block loops over that level's tiles, and writes the seven
// octants and LLL_j (to the scratch, or to the output's last band at the
// last level).  The window of level j reaches back its own halo
// h = (M-1) 2^(j-1) only, not the whole cascade's.  Output (7L+1, B, D, R,
// C); scratch min(L-1, 2) f32 volumes (B, D, R, C), LLL_j in slot (j-1)&1.
template <typename T>
__global__ void __launch_bounds__(JW_THREADS)
jw_modwt3_fwd_kernel(const T* __restrict__ x, T* __restrict__ out,
                     float* __restrict__ scratch, int batch, int D, int R,
                     int C, int level, int m, JwPlan3 plan, JwTaps taps) {
  extern __shared__ float smem[];
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  float* a = smem + 2 * JW_MAX_TAPS;
  const size_t vol = (size_t)D * R * C;
  const size_t plane = (size_t)batch * vol;
  jw_stage_taps(taps, sg, sh, m);

  for (int j = 1; j <= level; ++j) {
    const int dil = 1 << (j - 1), h = (m - 1) * dil;
    const int td = plan.td[j - 1], tr = plan.tr[j - 1], tc = JW3_WC - h;
    const int ntd = (D + td - 1) / td, ntr = (R + tr - 1) / tr,
              ntc = (C + tc - 1) / tc;
    const long long ntiles = (long long)batch * ntd * ntr * ntc;
    const float* src = scratch + (size_t)((j - 2) & 1) * plane;
    float* next = scratch + (size_t)((j - 1) & 1) * plane;
    const int win = (td + h) * (tr + h) * JW3_WC;
    float* b = a + win;
    float* c = b + win;
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const JwTile3 tl = jw_tile3(t, ntd, ntr, ntc, td, tr, tc);
      const JwWin3 w = {tl.d - h, tl.r - h, tl.c - h, td + h, tr + h, D, R,
                        C};
      const size_t at = (size_t)tl.b * vol;
      T* lvl = out + (size_t)(7 * (j - 1)) * plane + at;
      if (j == 1)
        jw3_load(x + at, a, w);
      else
        jw3_load(src + at, a, w);
      __syncthreads();
      jw3_col_pass(a, b, c, sg, sh, m, dil, w.wd, w.wr, 0, h);
      __syncthreads();
      // HL quadrant (h along rows of cl) -> LHL, HHL
      jw3_row_pass(b, a, sh, m, dil, w.wd, w.wr, 0, h);
      __syncthreads();
      jw3_depth_pass(a, lvl + plane, lvl + 5 * plane, sg, sh, m, dil, w, h);
      __syncthreads();
      // LH quadrant (g along rows of ch) -> LLH, HLH
      jw3_row_pass(c, a, sg, m, dil, w.wd, w.wr, 0, h);
      __syncthreads();
      jw3_depth_pass(a, lvl, lvl + 4 * plane, sg, sh, m, dil, w, h);
      __syncthreads();
      // HH quadrant -> LHH, HHH
      jw3_row_pass(c, a, sh, m, dil, w.wd, w.wr, 0, h);
      __syncthreads();
      jw3_depth_pass(a, lvl + 2 * plane, lvl + 6 * plane, sg, sh, m, dil, w,
                     h);
      __syncthreads();
      // LL quadrant -> LLL_j, HLL
      jw3_row_pass(b, a, sg, m, dil, w.wd, w.wr, 0, h);
      __syncthreads();
      if (j == level)
        jw3_depth_pass(a, out + (size_t)(7 * level) * plane + at,
                       lvl + 3 * plane, sg, sh, m, dil, w, h);
      else
        jw3_depth_pass(a, next + at, lvl + 3 * plane, sg, sh, m, dil, w, h);
      __syncthreads();  // the next tile's window overwrites a
    }
    if (j < level) cg::this_grid().sync();
  }
}

// ---------------------------------------------------------------------------
// Inverse passes.  Each reads above (away from the window origin): an
// output at index p needs p + k dil.  A pass computes d in [0, dhi),
// r in [0, rhi), q in [0, qhi).

// Depth adjoint: dst = sum_k g (src, or band_g)[i + k dil] + h band_h[...];
// src is a window, the bands point at this volume's first voxel.
template <typename T>
__device__ __forceinline__ void jw3_depth_adjoint(
    float* dst, const float* src, const T* band_g, const T* band_h,
    const float* sg, const float* sh, int m, int dil, const JwWin3& w,
    int dhi, int rhi, int qhi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane >= qhi) return;
  const size_t col = (size_t)jw_index(w.c0 + lane, w.C);
  const size_t rc = (size_t)w.R * w.C;
  const int step = dil * w.wr * JW3_WC;
  for (int t = warp; t < dhi * rhi; t += JW_WARPS) {
    const int i = t / rhi, j = t - i * rhi;
    const int at = (i * w.wr + j) * JW3_WC + lane;
    const size_t rq = (size_t)jw_index(w.r0 + j, w.R) * w.C + col;
    float acc = 0.f;
    for (int k = 0; k < m; ++k) {
      const size_t off = (size_t)jw_index(w.d0 + i + k * dil, w.D) * rc + rq;
      const float u = src ? src[at + k * step] : jw_load(band_g + off);
      acc += fmaf(sh[k], jw_load(band_h + off), sg[k] * u);
    }
    dst[at] = acc;
  }
}

// Row adjoint with one filter f: dst (= or +=) sum_k f src[r + k dil].
__device__ __forceinline__ void jw3_row_adjoint(float* dst, const float* src,
                                                const float* f, int m,
                                                int dil, int wr, int dhi,
                                                int rhi, int qhi, bool add) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane >= qhi) return;
  const int step = dil * JW3_WC;
  for (int t = warp; t < dhi * rhi; t += JW_WARPS) {
    const int i = t / rhi, j = t - i * rhi;
    const int at = (i * wr + j) * JW3_WC + lane;
    float acc = add ? dst[at] : 0.f;
    for (int k = 0; k < m; ++k) acc = fmaf(f[k], src[at + k * step], acc);
    dst[at] = acc;
  }
}

// Column adjoint: dst = sum_k g cl[q + k dil] + h ch[q + k dil].
__device__ __forceinline__ void jw3_col_adjoint(float* dst, const float* cl,
                                                const float* ch,
                                                const float* sg,
                                                const float* sh, int m,
                                                int dil, int wr, int dhi,
                                                int rhi, int qhi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane >= qhi) return;
  for (int t = warp; t < dhi * rhi; t += JW_WARPS) {
    const int i = t / rhi, j = t - i * rhi;
    const int at = (i * wr + j) * JW3_WC + lane;
    float acc = 0.f;
    for (int k = 0; k < m; ++k)
      acc += fmaf(sh[k], ch[at + k * dil], sg[k] * cl[at + k * dil]);
    dst[at] = acc;
  }
}

// Inverse.  One cooperative launch runs the levels from L down to 1, a
// grid-wide barrier between them: level j reads LLL_j (the input's last
// band, or the f32 scratch) into a window whose origin is the tile's, reads
// the level's seven detail bands from device memory in the depth adjoints,
// and writes LLL_{j-1} (to the scratch, or to the output at level 1).
// Input (7L+1, B, D, R, C), output (B, D, R, C); LLL_{j-1} in scratch slot
// (L-j)&1.
template <typename T>
__global__ void __launch_bounds__(JW_THREADS)
jw_modwt3_inv_kernel(const T* __restrict__ cf, T* __restrict__ out,
                     float* __restrict__ scratch, int batch, int D, int R,
                     int C, int level, int m, JwPlan3 plan, JwTaps taps) {
  extern __shared__ float smem[];
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  float* a = smem + 2 * JW_MAX_TAPS;
  const size_t vol = (size_t)D * R * C;
  const size_t plane = (size_t)batch * vol;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  jw_stage_taps(taps, sg, sh, m);

  for (int j = level; j >= 1; --j) {
    const int dil = 1 << (j - 1), h = (m - 1) * dil;
    const int td = plan.td[j - 1], tr = plan.tr[j - 1], tc = JW3_WC - h;
    const int ntd = (D + td - 1) / td, ntr = (R + tr - 1) / tr,
              ntc = (C + tc - 1) / tc;
    const long long ntiles = (long long)batch * ntd * ntr * ntc;
    const float* src = scratch + (size_t)((level - j - 1) & 1) * plane;
    float* next = scratch + (size_t)((level - j) & 1) * plane;
    const int win = (td + h) * (tr + h) * JW3_WC;
    float* b = a + win;
    float* c = b + win;
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const JwTile3 tl = jw_tile3(t, ntd, ntr, ntc, td, tr, tc);
      const JwWin3 w = {tl.d, tl.r, tl.c, td + h, tr + h, D, R, C};
      const size_t at = (size_t)tl.b * vol;
      const T* lvl = cf + (size_t)(7 * (j - 1)) * plane + at;
      if (j == level)
        jw3_load(cf + (size_t)(7 * level) * plane + at, a, w);
      else
        jw3_load(src + at, a, w);
      __syncthreads();
      const int dhi = td, rhi = tr;  // w - h: the rows the next pass keeps
      // cl = row adjoint of the LL quadrant, from (LLL, HLL) ...
      jw3_depth_adjoint<T>(b, a, nullptr, lvl + 3 * plane, sg, sh, m, dil, w,
                           dhi, w.wr, JW3_WC);
      __syncthreads();
      jw3_row_adjoint(a, b, sg, m, dil, w.wr, dhi, rhi, JW3_WC, false);
      __syncthreads();
      // ... plus that of the HL quadrant, from (LHL, HHL)
      jw3_depth_adjoint<T>(b, nullptr, lvl + plane, lvl + 5 * plane, sg, sh,
                           m, dil, w, dhi, w.wr, JW3_WC);
      __syncthreads();
      jw3_row_adjoint(a, b, sh, m, dil, w.wr, dhi, rhi, JW3_WC, true);
      __syncthreads();
      // ch from the LH (LLH, HLH) and HH (LHH, HHH) quadrants
      jw3_depth_adjoint<T>(b, nullptr, lvl, lvl + 4 * plane, sg, sh, m, dil,
                           w, dhi, w.wr, JW3_WC);
      __syncthreads();
      jw3_row_adjoint(c, b, sg, m, dil, w.wr, dhi, rhi, JW3_WC, false);
      __syncthreads();
      jw3_depth_adjoint<T>(b, nullptr, lvl + 2 * plane, lvl + 6 * plane, sg,
                           sh, m, dil, w, dhi, w.wr, JW3_WC);
      __syncthreads();
      jw3_row_adjoint(c, b, sh, m, dil, w.wr, dhi, rhi, JW3_WC, true);
      __syncthreads();
      jw3_col_adjoint(b, a, c, sg, sh, m, dil, w.wr, dhi, rhi, tc);
      __syncthreads();
      // store the tile of LLL_{j-1}
      const long long s = w.c0 + lane;
      if (lane < tc && s < C) {
        for (int u = warp; u < td * tr; u += JW_WARPS) {
          const int i = u / tr, r = u - i * tr;
          const long long p = w.d0 + i, q = w.r0 + r;
          if (p >= D || q >= R) continue;
          const size_t off = at + ((size_t)p * R + q) * C + s;
          const float v = b[(i * w.wr + r) * JW3_WC + lane];
          if (j == 1)
            jw_store(out + off, v);
          else
            next[off] = v;
        }
      }
      __syncthreads();  // the next tile's window overwrites a and b
    }
    if (j > 1) cg::this_grid().sync();
  }
}

// Launch `kernel` cooperatively with as many blocks as the card holds at
// once (at most `tiles`, the largest level's tile count), so the grid-wide
// barrier between levels is legal.
template <typename T>
static int jw3_launch(void (*kernel)(const T*, T*, float*, int, int, int, int,
                                     int, int, JwPlan3, JwTaps),
                      const void* in, void* out, float* scratch, int batch,
                      int D, int R, int C, int level, int m, const float* g,
                      const float* h, const int* td, const int* tr,
                      long long tiles, int smem, int device,
                      cudaStream_t stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      JW_THREADS, smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long grid = (long long)per_sm * sms;
  if (tiles < grid) grid = tiles;
  JwPlan3 plan;
  for (int k = 0; k < JW3_MAX_LEVELS; ++k) {
    plan.td[k] = k < level ? td[k] : 1;
    plan.tr[k] = k < level ? tr[k] : 1;
  }
  JwTaps taps = jw_make_taps(g, h, m);
  const T* x = (const T*)in;
  T* y = (T*)out;
  void* args[] = {(void*)&x,     (void*)&y, (void*)&scratch, (void*)&batch,
                  (void*)&D,     (void*)&R, (void*)&C,       (void*)&level,
                  (void*)&m,     (void*)&plan, (void*)&taps};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)grid),
                                  dim3(JW_THREADS), args, (size_t)smem,
                                  stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" {

// x (B, D, R, C) -> out (7L+1, B, D, R, C), both of `dtype`, contiguous;
// scratch min(L-1, 2) x (B, D, R, C) float32; td/tr: each level's tile.
int jw_modwt3_fwd(const void* x, void* out, float* scratch, int batch, int D,
                  int R, int C, int level, const float* g, const float* h,
                  int m, const int* td, const int* tr, long long tiles,
                  int smem, int dtype, int device, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw3_launch<__nv_bfloat16>(jw_modwt3_fwd_kernel<__nv_bfloat16>, x,
                                     out, scratch, batch, D, R, C, level, m,
                                     g, h, td, tr, tiles, smem, device, st);
  return jw3_launch<float>(jw_modwt3_fwd_kernel<float>, x, out, scratch,
                           batch, D, R, C, level, m, g, h, td, tr, tiles,
                           smem, device, st);
}

// c (7L+1, B, D, R, C) -> out (B, D, R, C), both of `dtype`, contiguous;
// scratch and tiles as the forward.
int jw_modwt3_inv(const void* c, void* out, float* scratch, int batch, int D,
                  int R, int C, int level, const float* g, const float* h,
                  int m, const int* td, const int* tr, long long tiles,
                  int smem, int dtype, int device, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw3_launch<__nv_bfloat16>(jw_modwt3_inv_kernel<__nv_bfloat16>, c,
                                     out, scratch, batch, D, R, C, level, m,
                                     g, h, td, tr, tiles, smem, device, st);
  return jw3_launch<float>(jw_modwt3_inv_kernel<float>, c, out, scratch,
                           batch, D, R, C, level, m, g, h, td, tr, tiles,
                           smem, device, st);
}

}  // extern "C"
