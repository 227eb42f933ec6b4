// Fused 2D MODWT kernels for Hopper (sm_90a): forward, inverse, and the
// single-pass forward -> shrink -> inverse denoise.  Every block marches a
// strip of columns of one image down the rows.
//
// Replace jwave_pro_tpu/kernels/modwt2_pallas.py _fwd2_kernel (:192),
// _inv2_kernel (:314) and _denoise2_kernel (:460).
//
// Band letters (row, col), as ops/modwt2d.py: LH = g@rows h@cols, HL =
// h@rows g@cols, HH = h@rows h@cols, LL = g@rows g@cols; bands (LH, HL, HH)
// per level, LL_L last.  H = (M-1)(2^L - 1); level j (d = 2^(j-1)) reaches
// p_j = (M-1) d rows or columns; S_j = sum_{i>=j} p_i (S_1 = H).
//
// The strip layout, shared by the three kernels: a block owns a strip of Tc
// output columns of one image and a run of rows [ra, rb).  Its window is W
// columns read mod C (Tc + H for the transforms, Tc + 2H for the denoise),
// and it marches down the rows (read mod R), G rows a step.  Each warp owns
// one row of the step and 32 window columns, the same in every stage
// (G x 16/G warps, W <= 512/G columns), so no stage divides to find its
// work.  Every stage keeps only the rows its taps reach, in rings in shared
// memory: rows are never recomputed, except the warm-up where a strip is
// split into row runs to fill the card, and columns by W / Tc.  Device
// loads and stores coalesce along C; any R and C run, a halo larger than
// the image included.
//
// The transforms.  What bounds them on the H100: shared-memory traffic --
// per output pixel and level, 3M floats (forward) or 6M (inverse), times
// the column recompute W / Tc (1.1 at Db4 L3), at 128 bytes a clock an SM
// -- and device memory: one read of the input and one write of each band
// (forward), or the mirror image (inverse), 0.88 ms at (16, 2048^2) Db4
// L3.  The design loads each device row once, coalesced; packs the values
// one tap reads into one vector load (float2, float4); takes the taps from
// the parameter bank when M is a template constant; and wraps ring slots
// by a conditional add, with one modulo a level and step.  The inverse's
// body and the layout's shared pieces live in modwt2_inv.cuh, which the
// shrinking inverse (#10s, modwt2_shrink.cu) includes too.

#include "modwt2_inv.cuh"

// the kernel instantiated for filter length m: M = 8, 2, 16 as template
// constants, any other M at run time
#define JW2D_PICK(kernel, T, m)                              \
  ((m) == 8 ? kernel<T, 8>                                   \
            : (m) == 2 ? kernel<T, 2>                        \
                       : (m) == 16 ? kernel<T, 16> : kernel<T, 0>)

// Forward.  The window is W = Tc + H columns from H before the strip's
// first output column; the analysis reads left and up.  At step t every
// level computes rows y = t + g (g < G) -- there is no lag between levels:
//
// * the row pass: (g, h) down the rows of LL_{j-1}, from its ring A_j of
//   p_j + G rows (A_1 holds the input), into a G-row buffer of pairs;
// * the column pass of those pairs (reading left): LL_j, into A_{j+1} or
//   the output's last band, and LH_j, HL_j, HH_j, stored at once.
//
// The march starts H rows above the run (the warm-up); LL_j is valid on
// window columns [(M-1)(2^j - 1), W), the stored ones [H, W).  The next
// step's input row is loaded into a register while the step runs.  Two
// blocks an SM at Db4 L3 (111 KB each), hence at most 64 registers.
template <typename T, int MT>
__global__ void __launch_bounds__(JW_THREADS, 2)
jw_modwt2_fwd_kernel(const T* __restrict__ x, T* __restrict__ out, int batch,
                     int rows, int cols, int level, int m_run, int w, int grp,
                     int tc, int run, JwTaps taps) {
  extern __shared__ float smem[];
  const int m = MT > 0 ? MT : m_run;
  const int halo = (m - 1) * ((1 << level) - 1);
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  float2* rp = reinterpret_cast<float2*>(smem + 2 * JW_MAX_TAPS);
  float* rings = smem + 2 * JW_MAX_TAPS + 2 * grp * w;  // A_1, A_2, ...
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
  const int dep1 = m - 1 + grp;  // A_1's rows

  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const JwStrip s = jw_strip(it, nstrips, nruns, run, rows);
    const long long c0 = (long long)s.strip * tc - halo;  // window column 0
    const T* xb = x + (size_t)s.b * img;
    const int base = s.ra - halo;  // ring slot of row y: (y - base) % depth
    const size_t xcol = on ? (size_t)jw_index(c0 + q, cols) : 0;
    const bool out_col = on && q >= halo && c0 + q < cols;
    // this lane's output column of the image's first band
    T* ob = out + (size_t)s.b * img + (out_col ? c0 + q : 0);

    // the first step's input rows into A_1 (the previous item's last
    // reader of the rings is behind its last barrier)
    if (on)
      rings[g * w + q] =
          jw_load(xb + (size_t)jw_index(base + g, rows) * cols + xcol);
    __syncthreads();

    for (int t = base; t < s.rb; t += grp) {
      const int y = t + g;
      const bool store = out_col && y >= s.ra && y < s.rb;
      // the next step's input row, stored once level 1's row pass has read
      // the slot it takes
      const float nxt =
          on ? jw_load(xb + (size_t)jw_index(y + grp, rows) * cols + xcol)
             : 0.f;
      float* A = rings;
      int sa = (y - base) % dep1;  // slot of row y in A_j
      for (int j = 1; j <= level; ++j) {
        const int d = 1 << (j - 1), dep = (m - 1) * d + grp;
        const int lo = (m - 1) * (d - 1);  // LL_{j-1} valid on [lo, w)
        float* an = A + dep * w;           // A_{j+1}, 2 dep - G rows
        // row pass: (g, h) of LL_{j-1} rows y - k d
        if (on && q >= lo) {
          const int dw = d * w, span = dep * w;
          int o = sa * w;
          float a = 0.f, e = 0.f;
#pragma unroll
          for (int k = 0; k < m; ++k) {
            const float v = A[o + q];
            a = fmaf(JW2D_G(k), v, a);
            e = fmaf(JW2D_H(k), v, e);
            o -= dw;
            o += o < 0 ? span : 0;
          }
          rp[gq] = make_float2(a, e);
        }
        const int sn = j < level ? (y - base) % (2 * dep - grp) : 0;
        __syncthreads();
        // column pass from columns q - k d: LL_j and the three details
        if (on && q >= lo + (m - 1) * d) {
          float ll = 0.f, lh = 0.f, hl = 0.f, hh = 0.f;
#pragma unroll
          for (int k = 0; k < m; ++k) {
            const float2 u = rp[gq - k * d];
            ll = fmaf(JW2D_G(k), u.x, ll);
            lh = fmaf(JW2D_H(k), u.x, lh);
            hl = fmaf(JW2D_G(k), u.y, hl);
            hh = fmaf(JW2D_H(k), u.y, hh);
          }
          if (j < level) an[sn * w + q] = ll;
          if (store) {
            T* o = ob + (size_t)(3 * (j - 1)) * plane + (size_t)y * cols;
            jw_store(o, lh);
            jw_store(o + plane, hl);
            jw_store(o + 2 * plane, hh);
            if (j == level) jw_store(o + 3 * plane, ll);
          }
        }
        if (j == 1 && on) {
          int sx = sa + grp;
          sx -= sx >= dep1 ? dep1 : 0;
          rings[sx * w + q] = nxt;
        }
        __syncthreads();
        A = an;
        sa = sn;
      }
    }
  }
}

// Inverse: modwt2_inv.cuh's body with the detail bands read as they are.
template <typename T, int MT>
__global__ void __launch_bounds__(JW_THREADS, 1)
jw_modwt2_inv_kernel(const T* __restrict__ c, T* __restrict__ out, int batch,
                     int rows, int cols, int level, int m_run, int w, int grp,
                     int tc, int run, JwTaps taps) {
  jw_modwt2_inv_body<T, MT, JW_KEEP>(c, out, batch, rows, cols, level, m_run,
                                     w, grp, tc, run, taps, nullptr, 0.f, 0,
                                     0);
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

template <typename Kernel>
static cudaError_t jw2d_per_sm(Kernel kernel, int smem, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      JW_THREADS, smem);
  return e;
}

extern "C" {

// x (B, R, C) -> out (3L+1, B, R, C), both of `dtype`, contiguous.  w:
// window columns (tc + halo), grp: rows a step, run: rows a work item,
// grid: blocks (each loops over the work items).
int jw_modwt2_fwd(const void* x, void* out, int grid, int batch, int rows,
                  int cols, int level, const float* g, const float* h, int m,
                  int w, int grp, int tc, int run, int dtype, int device,
                  void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!jw2d_strip_ok(grid, w, grp, tc, run, (m - 1) * ((1 << level) - 1)))
    return (int)cudaErrorInvalidValue;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int smem = (int)sizeof(float) * jw2t_smem_floats(0, w, grp, level, m);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch(JW2D_PICK(jw_modwt2_fwd_kernel, __nv_bfloat16, m), grid,
                     smem, st, (const __nv_bfloat16*)x, (__nv_bfloat16*)out,
                     batch, rows, cols, level, m, w, grp, tc, run, taps);
  return jw_launch(JW2D_PICK(jw_modwt2_fwd_kernel, float, m), grid, smem, st,
                   (const float*)x, (float*)out, batch, rows, cols, level, m,
                   w, grp, tc, run, taps);
}

// c (3L+1, B, R, C) -> out (B, R, C), both of `dtype`, contiguous;
// arguments as jw_modwt2_fwd.
int jw_modwt2_inv(const void* c, void* out, int grid, int batch, int rows,
                  int cols, int level, const float* g, const float* h, int m,
                  int w, int grp, int tc, int run, int dtype, int device,
                  void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (!jw2d_strip_ok(grid, w, grp, tc, run, (m - 1) * ((1 << level) - 1)))
    return (int)cudaErrorInvalidValue;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int smem = (int)sizeof(float) * jw2t_smem_floats(1, w, grp, level, m);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch(JW2D_PICK(jw_modwt2_inv_kernel, __nv_bfloat16, m), grid,
                     smem, st, (const __nv_bfloat16*)c, (__nv_bfloat16*)out,
                     batch, rows, cols, level, m, w, grp, tc, run, taps);
  return jw_launch(JW2D_PICK(jw_modwt2_inv_kernel, float, m), grid, smem, st,
                   (const float*)c, (float*)out, batch, rows, cols, level, m,
                   w, grp, tc, run, taps);
}

// Blocks of 2D kernel `kind` (0 forward, 1 inverse, 2 denoise) for filter
// length m resident on the whole card at `smem` bytes.
int jw_modwt2_blocks(int kind, int smem, int m, int dtype, int device,
                     int* blocks) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, sms = 0;
  const bool bf = dtype == JW_BF16;
  if (kind == 0)
    e = bf ? jw2d_per_sm(JW2D_PICK(jw_modwt2_fwd_kernel, __nv_bfloat16, m),
                         smem, &per_sm)
           : jw2d_per_sm(JW2D_PICK(jw_modwt2_fwd_kernel, float, m), smem,
                         &per_sm);
  else if (kind == 1)
    e = bf ? jw2d_per_sm(JW2D_PICK(jw_modwt2_inv_kernel, __nv_bfloat16, m),
                         smem, &per_sm)
           : jw2d_per_sm(JW2D_PICK(jw_modwt2_inv_kernel, float, m), smem,
                         &per_sm);
  else
    e = bf ? jw2d_per_sm(
                 JW2D_PICK(jw_modwt2_denoise_kernel, __nv_bfloat16, m), smem,
                 &per_sm)
           : jw2d_per_sm(JW2D_PICK(jw_modwt2_denoise_kernel, float, m), smem,
                         &per_sm);
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
  if (!jw2d_strip_ok(grid, w, grp, tc, run, 2 * halo))
    return (int)cudaErrorInvalidValue;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int smem = (int)sizeof(float) * jw2d_smem_floats(w, grp, level, m);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch(JW2D_PICK(jw_modwt2_denoise_kernel, __nv_bfloat16, m),
                     grid, smem, st, (const __nv_bfloat16*)x, thr,
                     (__nv_bfloat16*)out, scratch, batch, rows, cols, level,
                     m, w, grp, tc, run, hard, taps);
  return jw_launch(JW2D_PICK(jw_modwt2_denoise_kernel, float, m), grid, smem,
                   st, (const float*)x, thr, (float*)out, scratch, batch,
                   rows, cols, level, m, w, grp, tc, run, hard, taps);
}

}  // extern "C"
