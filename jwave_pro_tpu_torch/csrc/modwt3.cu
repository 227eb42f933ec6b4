// Fused 3D MODWT kernels for Hopper (sm_90a): forward and inverse.
//
// Replace jwave_pro_tpu/kernels/modwt3_pallas.py _fwd3_kernel and
// _inv3_kernel.
//
// Both run the levels in turn, one launch a level, in stream order: a 3D
// window that reached back the whole cascade's halo H = (M-1)(2^L - 1)
// would pay it on three axes (Db4 L2: H = 21, a 24 x 25 x 32 window for a
// 3 x 4 x 11 tile), so LLL between levels goes through an f32 scratch
// volume in device memory (min(L-1, 2) volumes, ping-pong) and level j's
// block reaches back only h_j = (M-1) 2^(j-1).  Planes, rows and columns
// are read mod (D, R, C): no padded copy, any volume, halo larger than an
// axis included, and a depth run that crosses the volume's end wraps.
//
// Forward.  What bounds it on the H100: device memory (per level one read
// of LLL_{j-1} and eight writes, the seven octants and LLL_j; 1.28 ms at
// (4, 256^3) Db4 L2) and the cascade's shared loads.  A block owns a
// Tr x 32 (rows x columns) column of the volume and marches along a run of
// depth planes: for each input plane it stages a (Tr + h) x (32 + h) patch,
// runs the column pass on (Tr + h) x 32 and the row pass on Tr x 32, and
// pushes the four quadrant planes into rings of M planes; each new plane then
// completes one output plane, whose depth pass writes two octants of each
// quadrant.  Columns are never recomputed, rows only in the column pass
// ((Tr + h) / Tr), depth only where a run or residue starts (M - 1 planes).
// Shared loads an output voxel and level: M (Tr + h) / Tr + 2M + 4M, about
// 60 at Db4 level 2, every lane busy; two blocks fit an SM at Db4 (79 KB).
//
// Inverse.  Each block marches along depth over a 16 x 32 column of the
// volume: every band voxel is read from device memory once, plus the
// in-plane halo of its (16 + h) x (32 + h) patch (mostly from L2); depth is
// never recomputed, only the M - 1 planes that fill the ring at each depth
// run's start and residue (h / dc extra in-plane work).  What bounds it on
// the H100: shared-memory loads, 2M ((16 + h) / 4 + 2 + 1) per output voxel
// and level (the column, row and depth adjoints; 168 at Db4 level 2), and
// the latency of each plane's patch loads, which a second resident block
// hides (the block takes up to 164 KB at h = 20, 91 KB at Db4 level 2, where
// two fit an SM).
//
// Octant letters (depth, row, col), as ops/modwt2d.py: per level bands
// (LLH, LHL, LHH, HLL, HLH, HHL, HHH), then LLL_L last.

#include "common.cuh"

#define JW_WARPS (JW_THREADS / 32)
// tap k of g and h: a parameter-bank constant when M is a template constant
#define JW3_G(k) (MT > 0 ? taps.g[k] : sg[k])
#define JW3_H(k) (MT > 0 ? taps.h[k] : sh[k])
// the dispatch over the specialised filter lengths (Haar, Db4, Symlet 8)
#define JW3_PICK(kern, ...)                                  \
  (m == 8    ? kern<__VA_ARGS__, 8>                          \
   : m == 2  ? kern<__VA_ARGS__, 2>                          \
   : m == 16 ? kern<__VA_ARGS__, 16>                         \
             : kern<__VA_ARGS__, 0>)

// ---------------------------------------------------------------------------
// Forward: one launch per level, each block marching along depth.
//
// Level j reads LLL_{j-1} (`src`: the input, or the f32 scratch) and writes
// the level's seven octants (`bands`, `plane` elements apart, in the order
// LLH .. HHH) and LLL_j (`lll`: the scratch, or the output's last band).
// The forward convolution reads below on every axis: output p needs input
// p - k dil, k < M.  A block owns rows [r0, r0 + Tr) and columns
// [c0, c0 + 32) and a run of dc depth planes; the output planes of one
// residue mod dil need only the input planes of that residue, so the block
// walks the residues in turn.  For each input plane it stages the patch of
// rows r0 - h .. r0 + Tr and columns c0 - h .. c0 + 32, runs the column pass
// (cl, ch on (Tr + h) x 32) and the row pass (the quadrants LL, HL, LH, HH,
// letters (row, col), on Tr x 32) into ring slot s mod M; from the M-th
// plane on, the depth pass of each quadrant over slots s, s - 1, ..,
// s - M + 1 writes the output plane the new input plane sits on.  MT: the
// filter length when it is a compile-time constant, 0 for any other M.
// Grid: B x ceil(D / dc) runs x ceil(R / Tr) x ceil(C / 32), columns fastest.

#define JW3F_TC 32   // block columns: one warp's lanes

// Shared floats of one forward block: the taps, the patch, cl and ch, and
// the four quadrant rings of M planes.
static inline int jw3f_smem_floats(int h, int m, int tr) {
  const int pr = tr + h;
  return 2 * JW_MAX_TAPS + pr * (JW3F_TC + h) + 2 * pr * JW3F_TC +
         4 * m * tr * JW3F_TC;
}

template <typename TI, typename T, typename TL, int MT>
__global__ void __launch_bounds__(JW_THREADS, MT > 0 ? 2 : 1)
jw_modwt3_fwd_level(const TI* __restrict__ src, T* __restrict__ bands,
                    TL* __restrict__ lll, int batch, int D, int R, int C,
                    int m_run, int dil, int tr, int dc, JwTaps taps) {
  extern __shared__ float smem[];
  const int m = MT > 0 ? MT : m_run;
  const int h = (m - 1) * dil;
  const int pr = tr + h, pc = JW3F_TC + h;
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  float* patch = smem + 2 * JW_MAX_TAPS;   // pr x pc
  float* cl = patch + pr * pc;             // pr x 32
  float* ch = cl + pr * JW3F_TC;           // pr x 32
  float* ring = ch + pr * JW3F_TC;         // 4 quadrants x m x tr x 32
  const int qsz = m * tr * JW3F_TC;        // one quadrant's ring
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  jw_stage_taps(taps, sg, sh, m);

  long long t = blockIdx.x;
  const int ntc = (C + JW3F_TC - 1) / JW3F_TC;
  const int ntr = (R + tr - 1) / tr;
  const int nruns = (D + dc - 1) / dc;
  const int c0 = (int)(t % ntc) * JW3F_TC;
  t /= ntc;
  const int r0 = (int)(t % ntr) * tr;
  t /= ntr;
  const int d0 = (int)(t % nruns) * dc;
  const int b = (int)(t / nruns);
  const int dend = min(d0 + dc, D);
  const size_t rc = (size_t)R * C, vol = (size_t)D * rc;
  const size_t plane = (size_t)batch * vol;
  // this lane's patch columns: q = lane and q = lane + 32 (pc <= 64)
  const bool two = lane + JW3F_TC < pc;
  const size_t col0 = (size_t)jw_index(c0 - h + lane, C);
  const size_t col1 = two ? (size_t)jw_index(c0 - h + lane + JW3F_TC, C) : 0;
  const bool col_out = c0 + lane < C;

  for (int rho = 0; rho < dil; ++rho) {
    const int p0 = d0 + rho;  // this residue's first output plane
    if (p0 >= dend) break;
    const int nt = (dend - p0 + dil - 1) / dil;
    for (int s = 0; s < nt + m - 1; ++s) {
      const long long pp = p0 + (long long)(s - (m - 1)) * dil;  // input
      const TI* in = src + (size_t)b * vol + (size_t)jw_index(pp, D) * rc;
      // stage the patch (the previous plane's column pass, the last reader
      // of `patch`, is behind a barrier): warps walk rows, lanes columns
      for (int i = warp; i < pr; i += JW_WARPS) {
        const TI* row = in + (size_t)jw_index(r0 - h + i, R) * C;
        patch[i * pc + lane] = jw_load(row + col0);
        if (two) patch[i * pc + lane + JW3F_TC] = jw_load(row + col1);
      }
      __syncthreads();
      // column pass: cl/ch[i][c] = sum_k g/h[k] patch[i][c + h - k dil]
      for (int i = warp; i < pr; i += JW_WARPS) {
        const float* u = patch + i * pc + lane + h;
        float a = 0.f, e = 0.f;
#pragma unroll
        for (int k = 0; k < m; ++k) {
          const float v = u[-k * dil];
          a = fmaf(JW3_G(k), v, a);
          e = fmaf(JW3_H(k), v, e);
        }
        cl[i * JW3F_TC + lane] = a;
        ch[i * JW3F_TC + lane] = e;
      }
      __syncthreads();
      // row pass into ring slot s mod M: quadrant[r][c] from rows
      // r + h - k dil of cl (LL, HL) and ch (LH, HH)
      const int slot = s % m;
      const int step = dil * JW3F_TC;
      for (int r = warp; r < tr; r += JW_WARPS) {
        const float* a = cl + (r + h) * JW3F_TC + lane;
        const float* e = ch + (r + h) * JW3F_TC + lane;
        float ll = 0.f, hl = 0.f, lh = 0.f, hh = 0.f;
#pragma unroll
        for (int k = 0; k < m; ++k) {
          const float u = a[-k * step], v = e[-k * step];
          ll = fmaf(JW3_G(k), u, ll);
          hl = fmaf(JW3_H(k), u, hl);
          lh = fmaf(JW3_G(k), v, lh);
          hh = fmaf(JW3_H(k), v, hh);
        }
        float* o = ring + (slot * tr + r) * JW3F_TC + lane;
        o[0] = ll;
        o[qsz] = hl;
        o[2 * qsz] = lh;
        o[3 * qsz] = hh;
      }
      __syncthreads();
      // depth pass: with the rings full, input plane pp completes output
      // plane pp from slots (s - k) mod M, k < M; two barriers (after the
      // next plane's staging and column pass) separate these reads from
      // the row pass that overwrites the oldest slot
      if (s < m - 1 || !col_out) continue;
      const size_t at = (size_t)b * vol + (size_t)pp * rc + c0 + lane;
      for (int r = warp; r < tr && r0 + r < R; r += JW_WARPS) {
        const float* q = ring + r * JW3F_TC + lane;
        float lll_g = 0.f, hll = 0.f, lhl = 0.f, hhl = 0.f;
        float llh = 0.f, hlh = 0.f, lhh = 0.f, hhh = 0.f;
        int sl = slot;
#pragma unroll
        for (int k = 0; k < m; ++k) {
          const float* o = q + sl * tr * JW3F_TC;
          const float gk = JW3_G(k), hk = JW3_H(k);
          const float ll = o[0], hl = o[qsz], lh = o[2 * qsz],
                      hh = o[3 * qsz];
          lll_g = fmaf(gk, ll, lll_g);
          hll = fmaf(hk, ll, hll);
          lhl = fmaf(gk, hl, lhl);
          hhl = fmaf(hk, hl, hhl);
          llh = fmaf(gk, lh, llh);
          hlh = fmaf(hk, lh, hlh);
          lhh = fmaf(gk, hh, lhh);
          hhh = fmaf(hk, hh, hhh);
          sl = sl == 0 ? m - 1 : sl - 1;
        }
        const size_t off = at + (size_t)(r0 + r) * C;
        jw_store(bands + off, llh);
        jw_store(bands + plane + off, lhl);
        jw_store(bands + 2 * plane + off, lhh);
        jw_store(bands + 3 * plane + off, hll);
        jw_store(bands + 4 * plane + off, hlh);
        jw_store(bands + 5 * plane + off, hhl);
        jw_store(bands + 6 * plane + off, hhh);
        jw_store(lll + off, lll_g);
      }
    }
  }
}

// Launch level j of the forward on LLL_{j-1} `src`.
template <typename TI, typename T, typename TL>
static int jw3_fwd_level(const TI* src, T* bands, TL* lll, int batch, int D,
                         int R, int C, int m, int dil, int tr, int dc,
                         const JwTaps& taps, cudaStream_t st) {
  auto kernel = JW3_PICK(jw_modwt3_fwd_level, TI, T, TL);
  const int hl = (m - 1) * dil;
  if (hl > JW3F_TC || tr < 1 || dc < 1) return (int)cudaErrorInvalidValue;
  const long long grid = (long long)batch * ((D + dc - 1) / dc) *
                         ((R + tr - 1) / tr) *
                         ((C + JW3F_TC - 1) / JW3F_TC);
  if (grid >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
  return jw_launch(kernel, grid,
                   (int)sizeof(float) * jw3f_smem_floats(hl, m, tr), st, src,
                   bands, lll, batch, D, R, C, m, dil, tr, dc, taps);
}

// The levels from 1 to L, one launch each, in stream order: level j reads
// LLL_{j-1} (the input, or scratch slot (j-2)&1) and writes LLL_j (scratch
// slot (j-1)&1, or the output's last band at level L).
template <typename T>
static int jw3_fwd_run(const T* x, T* out, float* scratch, int batch, int D,
                       int R, int C, int level, int m, const JwTaps& taps,
                       const int* tr, const int* dc, cudaStream_t st) {
  const size_t plane = (size_t)batch * D * R * C;
  T* top = out + (size_t)(7 * level) * plane;
  int code = 0;
  for (int j = 1; j <= level && code == 0; ++j) {
    const int dil = 1 << (j - 1);
    T* bands = out + (size_t)(7 * (j - 1)) * plane;
    float* next = scratch + (size_t)((j - 1) & 1) * plane;
    const float* prev = scratch + (size_t)((j - 2) & 1) * plane;
    if (j == 1 && j == level)
      code = jw3_fwd_level(x, bands, top, batch, D, R, C, m, dil, tr[0],
                           dc[0], taps, st);
    else if (j == 1)
      code = jw3_fwd_level(x, bands, next, batch, D, R, C, m, dil, tr[0],
                           dc[0], taps, st);
    else if (j == level)
      code = jw3_fwd_level(prev, bands, top, batch, D, R, C, m, dil,
                           tr[j - 1], dc[j - 1], taps, st);
    else
      code = jw3_fwd_level(prev, bands, next, batch, D, R, C, m, dil,
                           tr[j - 1], dc[j - 1], taps, st);
  }
  return code;
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
          acc = fmaf(JW3_G(k), lo[k * dil], fmaf(JW3_H(k), hi[k * dil], acc));
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
          acc = fmaf(JW3_G(k), lo[k * step],
                     fmaf(JW3_H(k), hi[k * step], acc));
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
          acc = fmaf(JW3_G(k), ql[o], fmaf(JW3_H(k), qh[o], acc));
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

// Launch level j of the inverse on LLL_j `lll` into `dst`.
template <typename T, typename TL, typename TO>
static int jw3_inv_level(const TL* lll, const T* bands, TO* dst, int batch,
                         int D, int R, int C, int m, int dil, int dc,
                         const JwTaps& taps, cudaStream_t st) {
  auto kernel = JW3_PICK(jw_modwt3_inv_level, T, TL, TO);
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
// scratch min(L-1, 2) x (B, D, R, C) float32; tr, dc: each level's block
// rows and depth run.
int jw_modwt3_fwd(const void* x, void* out, float* scratch, int batch, int D,
                  int R, int C, int level, const float* g, const float* h,
                  int m, const int* tr, const int* dc, int dtype, int device,
                  void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw3_fwd_run((const __nv_bfloat16*)x, (__nv_bfloat16*)out, scratch,
                       batch, D, R, C, level, m, jw_make_taps(g, h, m), tr,
                       dc, st);
  return jw3_fwd_run((const float*)x, (float*)out, scratch, batch, D, R, C,
                     level, m, jw_make_taps(g, h, m), tr, dc, st);
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
