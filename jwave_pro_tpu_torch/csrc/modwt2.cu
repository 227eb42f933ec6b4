// Fused 2D MODWT kernels for Hopper (sm_90a): forward, inverse, and the
// single-pass forward -> shrink -> inverse denoise.
//
// Replace jwave_pro_tpu/kernels/modwt2_pallas.py _fwd2_kernel, _inv2_kernel
// and _denoise2_kernel.
//
// The transforms.  What bounds them on the H100: the cascade's shared-memory
// traffic — per window pixel and level, the column pass makes M loads and
// 2M fused multiply-adds, the row pass 2M loads and 4M — inflated by the
// recompute of the overlapping windows, (T+H)^2 / T^2 (3.1 at Db4 L3,
// T = 64), and by one resident block per SM when the three windows take
// most of the 227 KB.  Device memory sees one read of the input and one
// write per band (forward), or the mirror image (inverse).
//
// Layout: a block owns a T x T output tile and a square window of side
// T + H, H = (M-1)(2^L - 1), read as x[b, p mod R, q mod C] — no padded
// copy, any R and C, halo larger than the image included (the denoise's
// strips, below, read the image the same way).  The 32 lanes of a warp
// walk 32 consecutive columns of one window row, the warps walk rows: shared-memory loads are conflict-free in
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

// Denoise: forward -> shrink every detail band by its image's threshold ->
// inverse, LL kept, in one launch; each block marches down a strip of the
// image.
//
// What bounds it on the H100: the cascade's shared loads, about 10M a
// window pixel and level (the row and column passes, the detail column
// adjoints, the two row adjoints and the column adjoint), times the strip's
// column halo W / Tc (1.6 at Db4 L3), and a barrier after each of the 5L
// stages of a step; device memory sees one read and one write of the image
// (0.60 ms of f32 operations bound it at (16, 2048^2) Db4 L3).
//
// Layout: a block owns the output columns [c0 + H, c0 + H + Tc) of one
// image and a run of rows [ra, rb); its window is W = Tc + 2H columns from
// c0, read mod C, H = (M-1)(2^L - 1).  It marches down the rows from ra - H
// to rb + H (read mod R), G rows a step.  Each warp owns one row of the step
// and 32 window columns, the same in every stage (G x 16/G warps, W <= 512/G
// columns), so no stage divides to find its work.  Rows are never
// recomputed.  The row and column filters commute and the synthesis is
// linear, so level j (d = 2^(j-1), p = (M-1) d) keeps four rings of p + G
// rows in shared memory:
//
// * A_j, rows of LL_{j-1}: the row pass (g, h down the rows) reads p rows
//   back; the column pass of its two outputs gives LL_j (into A_{j+1}, or
//   Z_L) and the three detail rows, which are shrunk at once;
// * P_j, Q_j: the shrunk details' column adjoints, P = h' LH, Q = g' HL +
//   h' HH ('  the adjoint: it reads right); level j's detail part of the
//   reconstruction, E_j = g' P + h' Q down the rows, reads p rows ahead;
// * Z_j, the reconstruction's LL_j (Z_L = LL_L): Z_{j-1} = g' g' Z_j + E_j.
//
// E_j is complete p_j rows after its details, Z_j S_{j+1} = sum_{i>j} p_i
// rows later (42, 28 and 0 at Db4 L3), so E_j waits S_{j+1} rows in a
// block-private delay ring of S_{j+1} + G rows in device memory
// (L2-resident: the grid is the card's resident blocks).  The next step's
// input rows are loaded into registers while the step runs.  Column
// validity shrinks per stage (the analysis reads left, the synthesis
// right); rows before a run's warm-up read ring rows not yet filled, which
// no valid output uses.

// Shared floats of one denoise block at window width w and G rows a step:
// the taps, five buffers of G rows and four rings of p_j + G rows a level.
static inline int jw2d_smem_floats(int w, int grp, int level, int m) {
  const int halo = (m - 1) * ((1 << level) - 1);
  return 2 * JW_MAX_TAPS + w * (5 * grp + 4 * (halo + level * grp));
}

// Rows of a block's delay rings: S_{j+1} + G for j < L.
__host__ __device__ inline int jw2d_delay_rows(int grp, int level, int m) {
  return (level - 1) * (((m - 1) << level) + grp) -
         (m - 1) * ((1 << level) - 2);
}

// tap k of g and h: a parameter-bank constant when M is a template constant
#define JW2D_G(k) (MT > 0 ? taps.g[k] : sg[k])
#define JW2D_H(k) (MT > 0 ? taps.h[k] : sh[k])

// x (B, R, C), thr (B,) -> out (B, R, C).  Work items: B x ceil(R / run)
// runs x ceil(C / tc) strips, strips fastest; blocks loop over them (grid =
// resident blocks), so the delay rings (`scratch`, grid x delay rows x w
// f32) stay in L2.  MT: the filter length when it is a compile-time
// constant, 0 for any other M.  One block an SM (the rings take the 227
// KB): the explicit minimum of one lets ptxas use up to 128 registers,
// where it held M = 16 to 64 and spilled.
template <typename T, int MT>
__global__ void __launch_bounds__(JW_THREADS, 1)
jw_modwt2_denoise_kernel(const T* __restrict__ x, const float* __restrict__ thr,
                         T* __restrict__ out, float* __restrict__ scratch,
                         int batch, int rows, int cols, int level, int m_run,
                         int w, int grp, int tc, int run, int hard,
                         JwTaps taps) {
  extern __shared__ float smem[];
  const int m = MT > 0 ? MT : m_run;
  const int halo = (m - 1) * ((1 << level) - 1);
  const int gw = grp * w;
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  // G x w buffers: the row pass's two outputs, the three shrunk detail
  // rows; the synthesis reuses blh (E_L) and bhl (the row adjoint of Z_j)
  float* rl = smem + 2 * JW_MAX_TAPS;
  float* rh = rl + gw;
  float* blh = rh + gw;
  float* bhl = blh + gw;
  float* bhh = bhl + gw;
  float* rings = bhh + gw;  // per level: A_j, P_j, Q_j, Z_j
  jw_stage_taps(taps, sg, sh, m);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncw = JW_WARPS / grp;
  const int g = warp / ncw;                    // this warp's row of a step
  const int q = (warp - g * ncw) * 32 + lane;  // and this lane's column
  const bool on = q < w;
  const int gq = g * w + q;

  const int nstrips = (cols + tc - 1) / tc;
  const int nruns = (rows + run - 1) / run;
  const long long items = (long long)batch * nruns * nstrips;
  const size_t img = (size_t)rows * cols;
  const int dep1 = m - 1 + grp;  // A_1's rows
  float* delay =
      scratch + (size_t)blockIdx.x * jw2d_delay_rows(grp, level, m) * w;

  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int strip = (int)(it % nstrips);
    const long long rest = it / nstrips;
    const int ra = (int)(rest % nruns) * run;
    const int b = (int)(rest / nruns);
    const int rb = min(ra + run, rows);
    const long long c0 = (long long)strip * tc - halo;  // window column 0
    const float th = thr[b];
    const T* xb = x + (size_t)b * img;
    T* ob = out + (size_t)b * img;
    const int rbase = ra - 2 * halo;  // ring slot of row y: (y - rbase) % depth
    const size_t xcol = on ? (size_t)jw_index(c0 + q, cols) : 0;

    // the first step's input rows into A_1 (the previous item's last
    // reader of the rings is behind its last barrier)
    if (on)
      rings[((ra - halo + g - rbase) % dep1) * w + q] =
          jw_load(xb + (size_t)jw_index(ra - halo + g, rows) * cols + xcol);
    __syncthreads();

    for (int t = ra - halo; t < rb + halo; t += grp) {
      // the next step's input rows, stored once level 1's row pass has
      // read the slots they take
      const float nxt =
          on ? jw_load(xb + (size_t)jw_index(t + grp + g, rows) * cols + xcol)
             : 0.f;

      // analysis: rows t .. t + G - 1 of every level
      for (int j = 1; j <= level; ++j) {
        const int d = 1 << (j - 1), p = (m - 1) * d, dep = p + grp;
        const int lo = (m - 1) * (2 * d - 1);  // LL_j valid on [lo, w)
        const int suf = (m - 1) * ((1 << level) - d);  // sum_{i>=j} p_i
        float* A = rings + 4 * w * ((m - 1) * (d - 1) + (j - 1) * grp);
        float* P = A + dep * w;
        float* Q = P + dep * w;
        float* Z = Q + dep * w;
        // ring slots of row t + g: level j's rings, A_{j+1} (2p + G rows)
        const int s0 = (t + g - rbase) % dep;
        const int sn = (t + g - rbase) % (2 * p + grp);
        const int at = s0 * w + q;
        // row pass: rl/rh[g][q] = sum_k g/h[k] LL_{j-1}[t + g - k d][q]
        if (on) {
          float a = 0.f, e = 0.f;
#pragma unroll
          for (int k = 0; k < m; ++k) {
            int sk = s0 - k * d;
            sk += sk < 0 ? dep : 0;
            const float v = A[sk * w + q];
            a = fmaf(JW2D_G(k), v, a);
            e = fmaf(JW2D_H(k), v, e);
          }
          rl[gq] = a;
          rh[gq] = e;
        }
        __syncthreads();
        // column pass from columns q - k d: LL_j, and LH, HL, HH shrunk
        if (on && q >= lo) {
          float ll = 0.f, lhv = 0.f, hlv = 0.f, hhv = 0.f;
#pragma unroll
          for (int k = 0; k < m; ++k) {
            const float u = rl[gq - k * d], v = rh[gq - k * d];
            ll = fmaf(JW2D_G(k), u, ll);
            lhv = fmaf(JW2D_H(k), u, lhv);
            hlv = fmaf(JW2D_G(k), v, hlv);
            hhv = fmaf(JW2D_H(k), v, hhv);
          }
          if (j < level)
            A[4 * dep * w + sn * w + q] = ll;  // A_{j+1}
          else
            Z[at] = ll;  // Z_L = LL_L
          blh[gq] = jw_shrink(lhv, th, hard);
          bhl[gq] = jw_shrink(hlv, th, hard);
          bhh[gq] = jw_shrink(hhv, th, hard);
        }
        if (j == 1 && on)
          rings[((t + grp + g - rbase) % dep1) * w + q] = nxt;
        __syncthreads();
        // the details' column adjoints, on the columns E_j is needed
        if (q >= halo && q < w - suf) {
          float pv = 0.f, qv = 0.f;
#pragma unroll
          for (int k = 0; k < m; ++k) {
            pv = fmaf(JW2D_H(k), blh[gq + k * d], pv);
            qv = fmaf(JW2D_G(k), bhl[gq + k * d],
                      fmaf(JW2D_H(k), bhh[gq + k * d], qv));
          }
          P[at] = pv;
          Q[at] = qv;
        }
        __syncthreads();
      }

      // synthesis: E_j rows t - p_j .., Z_{j-1} rows t - sum_{i>=j} p_i ..
      for (int j = level; j >= 1; --j) {
        const int d = 1 << (j - 1), p = (m - 1) * d, dep = p + grp;
        const int suf = (m - 1) * ((1 << level) - d);  // sum_{i>=j} p_i
        const int sd = suf - p;                          // S_{j+1}
        const float* P =
            rings + 4 * w * ((m - 1) * (d - 1) + (j - 1) * grp) + dep * w;
        const float* Q = P + dep * w;
        const float* Z = Q + dep * w;
        const int ye = t - p + g, yz = t - suf + g;
        const int ddep = sd + grp;
        float* dr = delay + (size_t)w * ((j - 1) * (((m - 1) << level) + grp) -
                                         (m - 1) * (2 * d - 2));
        // ring slots: rows ye and yz in level j's rings and the delay ring
        const int se = (ye - rbase) % dep, sz = (yz - rbase) % dep;
        const size_t de = (size_t)((ye - rbase) % ddep) * w + q;
        const size_t dz = (size_t)((yz - rbase) % ddep) * w + q;
        const bool out_col = q >= halo && q < w - suf;
        // E_j of row yz was stored S_{j+1} rows ago: when that is an earlier
        // step, its load overlaps the row adjoints below
        const bool early = j < level && sd >= grp;
        const float ez = early && out_col ? dr[dz] : 0.f;
        // E_j = g' P + h' Q down the rows (into its delay ring, or blh at
        // j = L); bhl = g' Z_j down the rows
        if (out_col) {
          float e = 0.f;
#pragma unroll
          for (int k = 0; k < m; ++k) {
            int sk = se + k * d;
            sk -= sk >= dep ? dep : 0;
            e = fmaf(JW2D_G(k), P[sk * w + q],
                     fmaf(JW2D_H(k), Q[sk * w + q], e));
          }
          if (j < level)
            dr[de] = e;
          else
            blh[gq] = e;
        }
        if (q >= halo && q < w - sd) {
          float u = 0.f;
#pragma unroll
          for (int k = 0; k < m; ++k) {
            int sk = sz + k * d;
            sk -= sk >= dep ? dep : 0;
            u = fmaf(JW2D_G(k), Z[sk * w + q], u);
          }
          bhl[gq] = u;
        }
        __syncthreads();
        // Z_{j-1} = g' bhl along the columns + E_j, on [H, w - suf)
        if (out_col) {
          float v = j == level ? blh[gq] : early ? ez : dr[dz];
#pragma unroll
          for (int k = 0; k < m; ++k) v = fmaf(JW2D_G(k), bhl[gq + k * d], v);
          if (j > 1) {
            const int dprev = (m - 1) * (d >> 1) + grp;
            float* zprev = rings + 4 * w * ((m - 1) * ((d >> 1) - 1) +
                                            (j - 2) * grp) + 3 * dprev * w;
            zprev[((yz - rbase) % dprev) * w + q] = v;
          } else if (yz >= ra && yz < rb && q < halo + tc) {
            const long long col = c0 + q;
            if (col < cols) jw_store(ob + (size_t)yz * cols + col, v);
          }
        }
        __syncthreads();
      }
    }
  }
}

template <typename T>
static void (*jw2d_pick(int m))(const T*, const float*, T*, float*, int, int,
                                 int, int, int, int, int, int, int, int,
                                 JwTaps) {
  return m == 8    ? jw_modwt2_denoise_kernel<T, 8>
         : m == 2  ? jw_modwt2_denoise_kernel<T, 2>
         : m == 16 ? jw_modwt2_denoise_kernel<T, 16>
                   : jw_modwt2_denoise_kernel<T, 0>;
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

// Blocks of the denoise kernel for filter length m resident on the whole
// card at `smem` bytes.
int jw_modwt2_denoise_blocks(int smem, int m, int dtype, int device,
                             int* blocks) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, sms = 0;
  if (dtype == JW_BF16) {
    auto kernel = jw2d_pick<__nv_bfloat16>(m);
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        JW_THREADS, smem);
  } else {
    auto kernel = jw2d_pick<float>(m);
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
// w: window columns (tc + 2 halo, at most 32 x 16 / grp), grp: rows a step
// (a divisor of 16), run: rows a work item; scratch: grid x jw2d_delay_rows
// x w float32.
int jw_modwt2_denoise(const void* x, const float* thr, void* out,
                      float* scratch, int grid, int batch, int rows, int cols,
                      int level, const float* g, const float* h, int m, int w,
                      int grp, int tc, int run, int hard, int dtype,
                      int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int halo = (m - 1) * ((1 << level) - 1);
  if (grp < 1 || JW_WARPS % grp || w > 32 * (JW_WARPS / grp) || tc < 1 ||
      run < 1 || w != tc + 2 * halo)
    return (int)cudaErrorInvalidValue;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int smem = (int)sizeof(float) * jw2d_smem_floats(w, grp, level, m);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch(jw2d_pick<__nv_bfloat16>(m), grid, smem, st,
                     (const __nv_bfloat16*)x, thr, (__nv_bfloat16*)out,
                     scratch, batch, rows, cols, level, m, w, grp, tc, run,
                     hard, taps);
  return jw_launch(jw2d_pick<float>(m), grid, smem, st, (const float*)x, thr,
                   (float*)out, scratch, batch, rows, cols, level, m, w, grp,
                   tc, run, hard, taps);
}

}  // extern "C"
