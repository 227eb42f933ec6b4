// The 1D inverse's body (#3), shared by modwt.cu's jw_modwt_inv_kernel and
// modwt_shrink.cu's jw_modwt_inv_shrink_kernel, which shrinks the detail
// rows as it loads them.
#pragma once

#include "common.cuh"
#include "shrink.cuh"

#define JW_INV_R 7  // outputs in a register chain (odd: distinct banks)
#define JW_INV_THREADS 256  // a block; four an SM at 4096-sample tiles
// next W row elements a thread holds in flight: 17 a thread of 256 cover
// 4352 samples (Db4 L5's rows at 4096-sample tiles); 9 at M = 16, whose
// chains leave fewer of the 64 registers
#define JW_INV_PREFETCH 17
#define JW_INV_PREFETCH_M16 9

// Block (row, tile): window [s, s + end) mod N, end = min(T, N - s) + H.
// Shared memory: the taps, two V rows (ping-pong) and one W row, each of
// T + H floats.  Level j turns V_j, W_j (valid on [0, len)) into V_{j-1}
// on [0, len - (M-1) 2^(j-1)) through jw_level_adjoint's register chains.
// While it computes, each thread has its share of the next level's W row
// in flight to registers (P loads a thread; the rest of a longer row --
// past 4352 samples, or 2304 at M = 16 -- loads after the level, batched),
// stored to the W row once the level's last read of it is done: at Db4 L5
// no block waits on device memory between levels, only at the start.
//
// SHRINK (JW_SOFT, JW_HARD): each W_j value is shrunk where it is stored
// to the W row -- the opening window of W_L, the prefetched registers,
// the batched rest of a longer row; never V_L -- by W_j's threshold for
// this row, thr[(j - 1) ls + row rs], or `value` where thr is null.  The
// prefetched values are shrunk at their store, after the level, so no
// load waits on its own shrink.  With JW_KEEP the body compiles to the
// kernel it was before the shrink existed.
template <typename T, int MT, int SHRINK>
__device__ __forceinline__ void jw_modwt_inv_body(
    const T* __restrict__ c, T* __restrict__ out, int batch, int n,
    int level, int m_run, int tile, int halo, int ntiles,
    const JwTaps& taps, const T* __restrict__ thr, float value, int ls,
    int rs) {
  extern __shared__ float smem[];
  const int m = MT > 0 ? MT : m_run;
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  float* v = smem + 2 * JW_MAX_TAPS;
  float* vn = v + tile + halo;
  float* w = vn + tile + halo;

  const int row = blockIdx.x / ntiles;
  const long long s = (long long)(blockIdx.x - row * ntiles) * tile;
  const long long rest = (long long)n - s;  // >= 1
  const int count = rest < tile ? (int)rest : tile;
  const size_t plane = (size_t)batch * n;
  const T* crow = c + (size_t)row * n;
  // W_j's map for this row: its shrink, or JwKeep
  using Cut = std::conditional_t<SHRINK == JW_KEEP, JwKeep, JwCut<T, SHRINK>>;
  auto cut = [&](int j) {
    if constexpr (SHRINK == JW_KEEP) {
      return Cut();
    } else {
      return Cut{thr ? jw_load(thr + (size_t)(j - 1) * ls + (size_t)row * rs)
                     : value};
    }
  };

  if (MT == 0) jw_stage_taps(taps, sg, sh, m);
  int len = count + halo;  // V_j and W_j valid on [0, len)
  jw_load_window(crow + (size_t)level * plane, s, n, v, len);
  jw_load_window(crow + (size_t)(level - 1) * plane, s, n, w, len,
                 cut(level));
  __syncthreads();

  constexpr int P = MT == 16 ? JW_INV_PREFETCH_M16 : JW_INV_PREFETCH;
  for (int j = level; j >= 1; --j) {
    const int next = len - ((m - 1) << (j - 1));  // V_{j-1} on [0, next)
    // W_{j-1}'s row, needed on [0, next), in flight while the level runs
    const T* wsrc = crow + (size_t)(j > 1 ? j - 2 : 0) * plane;
    float pre[P];
    Cut map;
    if (j > 1) {
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int i = threadIdx.x + u * (int)blockDim.x;
        pre[u] = i < next ? jw_load(wsrc + jw_index(s + i, n)) : 0.f;
      }
      map = cut(j - 1);
    }
    jw_level_adjoint<MT, JW_INV_R>(v, w, 0, next, j - 1, m, taps, sg, sh,
                                   [&](int i, float y) { vn[i] = y; });
    __syncthreads();  // V_{j-1} complete; the level's reads of W_j done
    if (j > 1) {
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int i = threadIdx.x + u * (int)blockDim.x;
        if (i < next) w[i] = map(pre[u]);
      }
      const int held = P * (int)blockDim.x;
      if (next > held)
        jw_load_window(wsrc, s + held, n, w + held, next - held, map);
      __syncthreads();
    }
    float* t = v;
    v = vn;
    vn = t;
    len = next;
  }
  T* dst = out + (size_t)row * n + s;
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    jw_store(dst + i, v[i]);
}
