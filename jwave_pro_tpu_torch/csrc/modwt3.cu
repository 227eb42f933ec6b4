// Fused 3D MODWT kernels for Hopper (sm_90a): forward and inverse.
//
// Replace jwave_pro_tpu/kernels/modwt3_pallas.py _fwd3_kernel and
// _inv3_kernel.
//
// Forward.  What bounds it on the H100: the cascade's shared-memory
// traffic.  Per window voxel and level it makes 9M shared loads and 14M
// fused multiply-adds (the column pass M loads for the (g, h) pair, four
// row passes and four depth passes of one quadrant each).  The windows
// overlap, so each output voxel is computed wd wr 32 / (Td Tr Tc) times
// over (2.5 at Db4 level 1, 9.7 at level 2), and the three windows take up
// to 226 KB of the 227 KB: one resident block of 16 warps per SM.  Device
// memory sees, per level, one read of LLL_{j-1} and one write per band and
// of LLL_j.
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
// (D, R, C) — so any volume runs, halo larger than an axis included.  Three
// f32 windows live in shared memory: the column pass turns LLL_{j-1}
// (window a) into cl (b) and ch (c); each row-pass quadrant is built in a
// and consumed at once by its depth pass, which writes its two octants
// straight to device memory.
//
// Inverse.  One launch per level, in stream order (LLL_{j-1} through the
// same f32 scratch), each block marching along depth over a 16 x 32 column
// of the volume: every band voxel is read from device memory once, plus
// the in-plane halo of its (16 + h) x (32 + h) patch (mostly from L2);
// depth is never recomputed, only the M - 1 planes that fill the ring at
// each depth run's start and residue (h / dc extra in-plane work).  What
// bounds it on the H100: shared-memory loads, 2M ((16 + h) / 4 + 2 + 1)
// per output voxel and level (the column, row and depth adjoints; 168 at
// Db4 level 2),
// and the latency of each plane's patch loads, which a second resident
// block hides (the block takes up to 164 KB at h = 20, 91 KB at Db4
// level 2, where two fit an SM).
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
// Inverse: one launch per level, each block marching along depth.
//
// The per-axis adjoints commute, so level j's adjoint cascade is reordered
// as LLL_{j-1}[p] = sum_k g[k] Q_L[p + k dil] + h[k] Q_H[p + k dil] along
// depth, where Q_z is the in-plane adjoint (columns, then rows) of the four
// bands whose depth letter is z (Q_L takes LLL_j, LLH, LHL, LHH; Q_H the
// H bands).  A block owns a 16 x 32 (rows x columns) column of the volume
// and a run of dc depth planes; it computes each Q plane once, from eight
// (16 + h) x (32 + h) band patches staged in shared memory, and keeps the
// last M planes of Q_L and Q_H in a shared ring.  The output planes of one
// residue p mod dil need only the Q planes of that residue, so the block
// walks the residues in turn: M - 1 Q planes fill the ring, then every
// further Q plane completes one output plane.  Planes, rows and columns
// are read mod (D, R, C), so any volume runs (halo larger than an axis
// included) and a run that crosses the volume's end wraps.

#define JW3I_TR 16   // tile rows
#define JW3I_TC 32   // tile columns: one warp's lanes
#define JW3I_NL 4    // patch voxels per thread and band: (16+h)(32+h) <= 2048
static_assert(JW_WARPS == JW3I_TR, "the depth adjoint gives each warp a row");
// tap k of g and h: a parameter-bank constant when M is a template constant
#define JW3I_G(k) (MT > 0 ? taps.g[k] : sg[k])
#define JW3I_H(k) (MT > 0 ? taps.h[k] : sh[k])

// Shared floats of one level's block: the taps, eight band patches, the
// four column adjoints and the two rings of M planes.
static inline int jw3i_smem_floats(int h, int m) {
  const int pr = JW3I_TR + h, pc = JW3I_TC + h;
  return 2 * JW_MAX_TAPS + 8 * pr * pc + 4 * pr * JW3I_TC +
         2 * m * JW3I_TR * JW3I_TC;
}

// Level j: LLL_j (`lll`, B volumes) and the level's seven detail bands
// (`bands`, `plane` elements apart, in the order LLH .. HHH) -> LLL_{j-1}
// (`dst`).  T: the bands' type; TL, TO: LLL_j's and LLL_{j-1}'s (the f32
// scratch between levels).  MT: the filter length when it is a compile-time
// constant (Haar, Db4, Symlet 8: the tap loops unroll and the taps are read
// from the parameter bank, not shared memory), 0 for any other M.  Grid:
// B x ceil(D / dc) runs x ceil(R / 16) x ceil(C / 32) tiles, columns
// fastest.
template <typename T, typename TL, typename TO, int MT>
__global__ void __launch_bounds__(JW_THREADS, 2)
jw_modwt3_inv_level(const TL* __restrict__ lll, const T* __restrict__ bands,
                    TO* __restrict__ dst, int batch, int D, int R, int C,
                    int m_run, int dil, int dc, JwTaps taps) {
  extern __shared__ float smem[];
  const int m = MT > 0 ? MT : m_run;
  const int h = (m - 1) * dil;
  const int pr = JW3I_TR + h, pc = JW3I_TC + h, area = pr * pc;
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  float* patch = smem + 2 * JW_MAX_TAPS;        // 8 x pr x pc
  float* cs = patch + 8 * area;                 // 4 x pr x 32
  float* ring = cs + 4 * pr * JW3I_TC;          // 2 x m x 16 x 32
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  jw_stage_taps(taps, sg, sh, m);

  long long t = blockIdx.x;
  const int ntc = (C + JW3I_TC - 1) / JW3I_TC;
  const int ntr = (R + JW3I_TR - 1) / JW3I_TR;
  const int nruns = (D + dc - 1) / dc;
  const int c0 = (int)(t % ntc) * JW3I_TC;
  t /= ntc;
  const int r0 = (int)(t % ntr) * JW3I_TR;
  t /= ntr;
  const int d0 = (int)(t % nruns) * dc;
  const int b = (int)(t / nruns);
  const int dend = min(d0 + dc, D);
  const size_t rc = (size_t)R * C, vol = (size_t)D * rc;
  const size_t plane = (size_t)batch * vol;

  // this thread's patch voxels: the same offsets in every band and plane
  size_t off[JW3I_NL];
#pragma unroll
  for (int u = 0; u < JW3I_NL; ++u) {
    const int idx = threadIdx.x + u * JW_THREADS;
    const int i = idx / pc, q = idx - i * pc;
    off[u] = idx < area ? (size_t)jw_index(r0 + i, R) * C + jw_index(c0 + q, C)
                        : 0;
  }
  const bool writes = r0 + warp < R && c0 + lane < C;  // output row warp

  for (int rho = 0; rho < dil; ++rho) {
    const int p0 = d0 + rho;  // this residue's first output plane
    if (p0 >= dend) break;
    const int nt = (dend - p0 + dil - 1) / dil;
    for (int s = 0; s < nt + m - 1; ++s) {
      const long long pp = p0 + (long long)s * dil;  // the Q plane
      const size_t at = (size_t)b * vol + (size_t)jw_index(pp, D) * rc;
      // stage the eight band patches of plane pp (the previous plane's
      // column pass, the last reader of `patch`, is behind a barrier)
#pragma unroll
      for (int u = 0; u < JW3I_NL; ++u) {
        const int idx = threadIdx.x + u * JW_THREADS;
        if (idx < area) {
          float v[8];
          v[0] = jw_load(lll + at + off[u]);
#pragma unroll
          for (int k = 1; k < 8; ++k)
            v[k] = jw_load(bands + (size_t)(k - 1) * plane + at + off[u]);
#pragma unroll
          for (int k = 0; k < 8; ++k) patch[k * area + idx] = v[k];
        }
      }
      __syncthreads();
      // column adjoint: cs[zr][i][c] = sum_k g patch[2 zr][i][c + k dil]
      //                                     + h patch[2 zr + 1][i][c + k dil]
      // for zr = (depth letter, row letter), i < pr, c < 32
      for (int it = warp; it < 4 * pr; it += JW_WARPS) {
        const int zr = it / pr, i = it - zr * pr;
        const float* lo = patch + 2 * zr * area + i * pc + lane;
        const float* hi = lo + area;
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < m; ++k)
          acc = fmaf(JW3I_G(k), lo[k * dil], fmaf(JW3I_H(k), hi[k * dil], acc));
        cs[it * JW3I_TC + lane] = acc;
      }
      __syncthreads();
      // row adjoint into the ring: Q_z[r][c] = sum_k g cs[2z][r + k dil][c]
      //                                          + h cs[2z + 1][r + k dil][c]
      const int slot = s % m;
      for (int it = warp; it < 2 * JW3I_TR; it += JW_WARPS) {
        const int z = it / JW3I_TR, r = it - z * JW3I_TR;
        const float* lo = cs + (2 * z * pr + r) * JW3I_TC + lane;
        const float* hi = lo + pr * JW3I_TC;
        const int step = dil * JW3I_TC;
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < m; ++k)
          acc = fmaf(JW3I_G(k), lo[k * step],
                     fmaf(JW3I_H(k), hi[k * step], acc));
        ring[((z * m + slot) * JW3I_TR + r) * JW3I_TC + lane] = acc;
      }
      __syncthreads();
      // depth adjoint: with the ring full, Q plane pp completes output
      // plane pp - h from ring slots (s - m + 1 .. s) mod m
      if (s >= m - 1 && writes) {
        const float* ql = ring + warp * JW3I_TC + lane;
        const float* qh = ql + m * JW3I_TR * JW3I_TC;
        int sl = (s + 1) % m;  // = (s - m + 1) mod m
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < m; ++k) {
          const int o = sl * JW3I_TR * JW3I_TC;
          acc = fmaf(JW3I_G(k), ql[o], fmaf(JW3I_H(k), qh[o], acc));
          sl = sl + 1 == m ? 0 : sl + 1;
        }
        const long long p = pp - h;
        jw_store(dst + (size_t)b * vol + (size_t)p * rc +
                     (size_t)(r0 + warp) * C + c0 + lane,
                 acc);
      }
      // two barriers (after the next plane's staging and after its column
      // pass) separate this read from the row pass that overwrites the slot
    }
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

// Launch level j of the inverse on LLL_j `lll` into `dst`.
template <typename T, typename TL, typename TO>
static int jw3_inv_level(const TL* lll, const T* bands, TO* dst, int batch,
                         int D, int R, int C, int m, int dil, int dc,
                         const JwTaps& taps, cudaStream_t st) {
  auto kernel = m == 8    ? jw_modwt3_inv_level<T, TL, TO, 8>
                : m == 2  ? jw_modwt3_inv_level<T, TL, TO, 2>
                : m == 16 ? jw_modwt3_inv_level<T, TL, TO, 16>
                          : jw_modwt3_inv_level<T, TL, TO, 0>;
  const int hl = (m - 1) * dil;
  if ((JW3I_TR + hl) * (JW3I_TC + hl) > JW3I_NL * JW_THREADS || dc < 1)
    return (int)cudaErrorInvalidValue;
  const long long grid = (long long)batch * ((D + dc - 1) / dc) *
                         ((R + JW3I_TR - 1) / JW3I_TR) *
                         ((C + JW3I_TC - 1) / JW3I_TC);
  if (grid >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
  return jw_launch(kernel, grid,
                   (int)sizeof(float) * jw3i_smem_floats(hl, m), st, lll,
                   bands, dst, batch, D, R, C, m, dil, dc, taps);
}

// The levels from L down to 1, one launch each, in stream order: level j
// reads LLL_j (the input's last band, or the f32 scratch slot (L-j-1)&1)
// and writes LLL_{j-1} (scratch slot (L-j)&1, or the output at level 1).
template <typename T>
static int jw3_inv_run(const T* cf, T* out, float* scratch, int batch, int D,
                       int R, int C, int level, int m, const JwTaps& taps,
                       const int* dc, cudaStream_t st) {
  const size_t plane = (size_t)batch * D * R * C;
  int code = 0;
  for (int j = level; j >= 1 && code == 0; --j) {
    const int dil = 1 << (j - 1);
    const T* bands = cf + (size_t)(7 * (j - 1)) * plane;
    float* next = scratch + (size_t)((level - j) & 1) * plane;
    const float* prev = scratch + (size_t)((level - j - 1) & 1) * plane;
    const T* top = cf + (size_t)(7 * level) * plane;
    if (j == level && j == 1)
      code = jw3_inv_level(top, bands, out, batch, D, R, C, m, dil,
                           dc[j - 1], taps, st);
    else if (j == level)
      code = jw3_inv_level(top, bands, next, batch, D, R, C, m, dil,
                           dc[j - 1], taps, st);
    else if (j == 1)
      code = jw3_inv_level(prev, bands, out, batch, D, R, C, m, dil,
                           dc[j - 1], taps, st);
    else
      code = jw3_inv_level(prev, bands, next, batch, D, R, C, m, dil,
                           dc[j - 1], taps, st);
  }
  return code;
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
// scratch min(L-1, 2) x (B, D, R, C) float32; dc: each level's depth run.
int jw_modwt3_inv(const void* c, void* out, float* scratch, int batch, int D,
                  int R, int C, int level, const float* g, const float* h,
                  int m, const int* dc, int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw3_inv_run((const __nv_bfloat16*)c, (__nv_bfloat16*)out, scratch,
                       batch, D, R, C, level, m, jw_make_taps(g, h, m), dc,
                       st);
  return jw3_inv_run((const float*)c, (float*)out, scratch, batch, D, R, C,
                     level, m, jw_make_taps(g, h, m), dc, st);
}

}  // extern "C"
