// The strip layout's shared pieces and the 2D inverse's body (#10), shared
// by modwt2.cu's jw_modwt2_inv_kernel and modwt2_shrink.cu's
// jw_modwt2_inv_shrink_kernel (#10s), which shrinks the detail bands as it
// loads them.  modwt2.cu's head describes the strip layout.
#pragma once

#include "common.cuh"
#include "shrink.cuh"

#define JW_WARPS (JW_THREADS / 32)

// tap k of g and h: a parameter-bank constant when M is a template constant
#define JW2D_G(k) (MT > 0 ? taps.g[k] : sg[k])
#define JW2D_H(k) (MT > 0 ? taps.h[k] : sh[k])

// A strip kernel's work item: image b, rows [ra, rb), strip `strip`.  Items:
// B x ceil(R / run) runs x nstrips strips, strips fastest.
struct JwStrip {
  int b, ra, rb, strip;
};

__device__ __forceinline__ JwStrip jw_strip(long long it, int nstrips,
                                            int nruns, int run, int rows) {
  JwStrip s;
  s.strip = (int)(it % nstrips);
  const long long rest = it / nstrips;
  s.ra = (int)(rest % nruns) * run;
  s.b = (int)(rest / nruns);
  s.rb = min(s.ra + run, rows);
  return s;
}

// (z, LH, HL, HH) at one pixel, p pointing at LH: a level's bands are a
// plane apart.
template <typename T>
__device__ __forceinline__ float4 jw_bands(const T* p, size_t plane,
                                           float z) {
  return make_float4(z, jw_load(p), jw_load(p + plane),
                     jw_load(p + 2 * plane));
}

// (z, LH, HL, HH) with the three details shrunk by t[0], t[1], t[2]; z (the
// reconstruction's row, or LL_L) kept.
template <typename T, int SHRINK>
__device__ __forceinline__ float4 jw_cut_bands(float4 b, const float* t) {
  return make_float4(b.x, JwCut<T, SHRINK>{t[0]}(b.y),
                     JwCut<T, SHRINK>{t[1]}(b.z), JwCut<T, SHRINK>{t[2]}(b.w));
}

// Shared floats of one transform block at window width w and G rows a step:
// the taps, then the forward's G rows of (g, h) row-pass pairs and a ring of
// p_j + G rows of LL_{j-1} a level, or the inverse's G rows of (Z, LH, HL,
// HH) quadruples and a ring of p_j + G rows of (U_j, V_j) pairs a level.
static inline int jw2t_smem_floats(int inverse, int w, int grp, int level,
                                   int m) {
  const int rings = (m - 1) * ((1 << level) - 1) + level * grp;
  return 2 * JW_MAX_TAPS +
         w * (inverse ? 4 * grp + 2 * rings : 2 * grp + rings);
}

// Whether a strip launch's shape arguments fit the kernels' warp layout:
// G a divisor of 16, W <= 32 x 16 / G, W = tc + reach (H for the
// transforms, 2H for the denoise).
static inline bool jw2d_strip_ok(int grid, int w, int grp, int tc, int run,
                                 int reach) {
  return grid >= 1 && grp >= 1 && JW_WARPS % grp == 0 &&
         w <= 32 * (JW_WARPS / grp) && tc >= 1 && run >= 1 &&
         w == tc + reach;
}

// Inverse.  The window is W = Tc + H columns from the strip's first output
// column; the synthesis reads right and down.  The JAX inverse runs cl =
// g'_r LL + h'_r HL, ch = g'_r LH + h'_r HH, LL_{j-1} = g'_c cl + h'_c ch
// (' the adjoint, _r down the rows, _c along the columns); the row and
// column filters commute, so level j keeps two rings, not four:
//
// * stage A: U_j = g'_c Z_j + h'_c LH_j and V_j = g'_c HL_j + h'_c HH_j
//   along the columns of one row (Z_L = LL_L), into a ring of p_j + G rows
//   of (U_j, V_j) pairs;
// * stage B: Z_{j-1} = g'_r U_j + h'_r V_j down the rows, p_j rows ahead.
//
// At step t, Z_j comes out at row t - S_{j+1}, so level j's three detail
// rows are read from device memory at that row, each once, with Z_j's row
// beside them in a G-row buffer of (Z, LH, HL, HH) quadruples: there is no
// delay ring.  Each thread loads the bands it stores with its Z_{j-1} one
// stage early (at level 1, the next step's level L and LL_L).  The output
// Z_0 is row t - H; columns shrink by p_j a level, from the right.  One
// block an SM at Db4 L3 (the rings take 221 KB), so up to 128 registers:
// held to 64 for two blocks of half the width, it ran slower.
//
// SHRINK (JW_SOFT, JW_HARD): the three detail values of each quadruple are
// shrunk where it is stored to the G-row buffer -- at an item's opening
// load, beside each Z_{j-1}, and the next step's level L -- never LL_L,
// band k of level j by thr[(3 (j - 1) + k) ls + b rs] for image b, or
// `value` where thr is null.  An item loads its image's 3L thresholds
// once: level L's into registers, levels 1 .. L-1's into the taps' unused
// tail of shared memory (sh[m + i]; (M-1)(2^L - 1) <= 131 leaves room for
// them).  The loads beside Z_{j-1} stay in flight through the level's two
// stages: each is shrunk at its store.  With JW_KEEP the body compiles to
// the kernel it was before the shrink existed.
template <typename T, int MT, int SHRINK>
__device__ __forceinline__ void jw_modwt2_inv_body(
    const T* __restrict__ c, T* __restrict__ out, int batch, int rows,
    int cols, int level, int m_run, int w, int grp, int tc, int run,
    const JwTaps& taps, const T* __restrict__ thr, float value, int ls,
    int rs) {
  extern __shared__ float smem[];
  const int m = MT > 0 ? MT : m_run;
  const int halo = (m - 1) * ((1 << level) - 1);
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  float4* zb = reinterpret_cast<float4*>(smem + 2 * JW_MAX_TAPS);
  float2* rings =
      reinterpret_cast<float2*>(smem + 2 * JW_MAX_TAPS + 4 * grp * w);
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
  const size_t plane = (size_t)batch * img;

  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const JwStrip s = jw_strip(it, nstrips, nruns, run, rows);
    const long long c0 = (long long)s.strip * tc;  // window column 0
    const size_t col = on ? (size_t)jw_index(c0 + q, cols) : 0;
    // this column of the image's first band, and of level L's LH
    const T* cb = c + (size_t)s.b * img + col;
    const T* top = cb + (size_t)(3 * (level - 1)) * plane;
    T* ob = out + (size_t)s.b * img + (c0 + q);
    const int base = s.ra - halo;  // ring slot of row y: (y - base) % depth
    const bool out_col = on && q < tc && c0 + q < cols;

    // the image's thresholds: level L's, and levels 1 .. L-1's beside the
    // taps (the previous item's last reader of them is behind its last
    // barrier)
    [[maybe_unused]] float tl[3];
    if constexpr (SHRINK != JW_KEEP) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        tl[k] = thr ? jw_load(thr + (size_t)(3 * (level - 1) + k) * ls +
                              (size_t)s.b * rs)
                    : value;
      if ((int)threadIdx.x < 3 * (level - 1))
        sh[m + threadIdx.x] =
            thr ? jw_load(thr + (size_t)threadIdx.x * ls + (size_t)s.b * rs)
                : value;
    }

    // level L's bands and LL_L at the first step's rows (the previous
    // item's last reader of the buffer is behind its last barrier)
    if (on) {
      const T* pt = top + (size_t)jw_index(s.ra + g, rows) * cols;
      float4 b = jw_bands(pt, plane, jw_load(pt + 3 * plane));
      if constexpr (SHRINK != JW_KEEP) b = jw_cut_bands<T, SHRINK>(b, tl);
      zb[gq] = b;
    }
    __syncthreads();

    for (int t = s.ra; t < s.rb + halo; t += grp) {
      for (int j = level; j >= 1; --j) {
        const int d = 1 << (j - 1), p = (m - 1) * d, dep = p + grp;
        const int sj1 = (m - 1) * ((1 << level) - 2 * d);  // S_{j+1}
        const int sj = sj1 + p;                             // S_j
        float2* uv = rings + (size_t)w * ((m - 1) * (d - 1) + (j - 1) * grp);
        const bool live = on && q < w - sj;  // U_j, V_j and Z_{j-1} valid
        // the bands stored beside Z_{j-1}: level j-1's at row t - S_j + g,
        // or at level 1 the next step's level L and LL_L
        float4 nb = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j > 1 && live) {
          nb = jw_bands(cb + (size_t)(3 * (j - 2)) * plane +
                            (size_t)jw_index(t - sj + g, rows) * cols,
                        plane, 0.f);
        } else if (j == 1 && on) {
          const T* pt = top + (size_t)jw_index(t + grp + g, rows) * cols;
          nb = jw_bands(pt, plane, jw_load(pt + 3 * plane));
        }
        const int sw = (t - sj1 + g - base) % dep;  // row t - S_{j+1} + g
        // stage A: U_j, V_j along the columns, from columns q + k d
        if (live) {
          float u = 0.f, v = 0.f;
#pragma unroll
          for (int k = 0; k < m; ++k) {
            const float4 a = zb[gq + k * d];
            u = fmaf(JW2D_G(k), a.x, fmaf(JW2D_H(k), a.y, u));
            v = fmaf(JW2D_G(k), a.z, fmaf(JW2D_H(k), a.w, v));
          }
          uv[sw * w + q] = make_float2(u, v);
        }
        __syncthreads();
        // stage B: Z_{j-1} of row t - S_j + g, from rows + k d
        if (live) {
          const int dw = d * w, span = dep * w;
          int o = (sw - p) * w;
          o += o < 0 ? span : 0;
          float z = 0.f;
#pragma unroll
          for (int k = 0; k < m; ++k) {
            const float2 a = uv[o + q];
            z = fmaf(JW2D_G(k), a.x, fmaf(JW2D_H(k), a.y, z));
            o += dw;
            o -= o >= span ? span : 0;
          }
          if (j > 1) {
            nb.x = z;
            if constexpr (SHRINK != JW_KEEP)
              nb = jw_cut_bands<T, SHRINK>(nb, sh + m + 3 * (j - 2));
            zb[gq] = nb;
          } else {
            const int y = t - halo + g;
            if (out_col && y >= s.ra && y < s.rb)
              jw_store(ob + (size_t)y * cols, z);
          }
        }
        if (j == 1 && on) {
          if constexpr (SHRINK != JW_KEEP) nb = jw_cut_bands<T, SHRINK>(nb, tl);
          zb[gq] = nb;
        }
        __syncthreads();
      }
    }
  }
}
