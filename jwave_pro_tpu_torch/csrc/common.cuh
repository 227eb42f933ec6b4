// Shared pieces of the MODWT kernels: tap struct, dtype load/store, circular
// indexing, shrinkage and the launch helper.  Kernels allocate nothing; each C entry
// point launches on the caller's stream and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#define JW_MAX_TAPS 64
#define JW_THREADS 512

enum JwDtype { JW_F32 = 0, JW_BF16 = 1 };

// Filter taps passed by value as a kernel argument (512 bytes of the 4 KB
// parameter space), so concurrent launches with different wavelets never
// share state.  A kernel templated on M reads them from the parameter bank
// as FFMA operands; the others copy them into shared memory once.
struct JwTaps {
  float g[JW_MAX_TAPS];
  float h[JW_MAX_TAPS];
};

static inline JwTaps jw_make_taps(const float* g, const float* h, int m) {
  JwTaps t;
  for (int k = 0; k < JW_MAX_TAPS; ++k) {
    t.g[k] = k < m ? g[k] : 0.f;
    t.h[k] = k < m ? h[k] : 0.f;
  }
  return t;
}

__device__ __forceinline__ float jw_load(const float* p) { return *p; }
__device__ __forceinline__ float jw_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void jw_store(float* p, float v) { *p = v; }
// round-to-nearest-even, as torch's float32 -> bfloat16 cast
__device__ __forceinline__ void jw_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// p mod n for any p: the modulo only runs for the wrap-around positions
// (tile windows at the signal's ends, or a halo longer than the signal).
__device__ __forceinline__ long long jw_index(long long p, long long n) {
  if (p >= 0 && p < n) return p;
  const long long r = p % n;
  return r < 0 ? r + n : r;
}

// sign(w) * max(|w| - t, 0) (soft) or w * 1[|w| > t] (hard), as
// ops/denoise.py's soft_threshold / hard_threshold.
__device__ __forceinline__ float jw_shrink(float w, float t, int hard) {
  if (hard) return fabsf(w) > t ? w : 0.f;
  const float a = fmaxf(fabsf(w) - t, 0.f);
  return w > 0.f ? a : (w < 0.f ? -a : 0.f);
}

__device__ __forceinline__ void jw_stage_taps(const JwTaps& taps, float* sg,
                                              float* sh, int m) {
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    sg[k] = taps.g[k];
    sh[k] = taps.h[k];
  }
}

// What jw_load_window stores by default: each value as loaded.
struct JwKeep {
  __device__ __forceinline__ float operator()(float v) const { return v; }
};

// dst[i] = map(x[(base + i) mod n]) for i in [0, count): each thread
// issues JW_LOAD_BATCH device loads before it stores any, so a block waits
// for device memory once a batch, not once an element (a loop that stores
// each load before the next waits for every one of them in turn).  map
// runs at the store, once the batch has arrived.
#define JW_LOAD_BATCH 8
template <typename T, typename Map = JwKeep>
__device__ __forceinline__ void jw_load_window(const T* __restrict__ x,
                                               long long base, int n,
                                               float* dst, int count,
                                               Map map = Map()) {
  for (int i0 = threadIdx.x; i0 < count; i0 += JW_LOAD_BATCH * blockDim.x) {
    float t[JW_LOAD_BATCH];
#pragma unroll
    for (int u = 0; u < JW_LOAD_BATCH; ++u) {
      const int i = i0 + u * (int)blockDim.x;
      t[u] = i < count ? jw_load(x + jw_index(base + i, n)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < JW_LOAD_BATCH; ++u) {
      const int i = i0 + u * (int)blockDim.x;
      if (i < count) dst[i] = map(t[u]);
    }
  }
}

// Sum over the warp in a fixed shuffle tree; valid in lane 0.
__device__ __forceinline__ float jw_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// One register chain of an à-trous pair level: outputs i0 + r d, r < R,
// each v = sum_k g[k] par[i - k d] and w likewise with h, handed to
// emit(i, v, w).  The R outputs share M - 1 of their M window reads, so
// R + M - 1 shared loads serve them.  Each output is one fmaf chain over k
// ascending from 0.f, the order of the unblocked loops, so every value is
// bitwise the same as theirs.  D: the dilation when it is a compile-time
// constant (each load then takes an immediate offset), 0 for d at run
// time.  Only chains whose R outputs all lie below the level's end come
// here, so no load or output needs a guard.
template <int MT, int R, int D, typename Emit>
__device__ __forceinline__ void jw_chain(const float* par, int i0, int d_run,
                                         const JwTaps& taps, Emit& emit) {
  const int d = D > 0 ? D : d_run;
  const float* p = par + i0;
  float v[R], w[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = w[r] = 0.f;
  // window reads from the top down: output r meets tap k = r - u in
  // ascending order
#pragma unroll
  for (int u = R - 1; u > -MT; --u) {
    const float t = p[u * d];
#pragma unroll
    for (int k = 0; k < MT; ++k) {
      if (u + k >= 0 && u + k < R) {
        v[u + k] = fmaf(taps.g[k], t, v[u + k]);
        w[u + k] = fmaf(taps.h[k], t, w[u + k]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) emit(i0 + r * d, v[r], w[r]);
}

// No per-warp step: the chains of a level run as one block-strided loop.
struct JwNoStep {
  __device__ __forceinline__ void operator()() const {}
};

// Whether a Step runs a level's chains warp by warp (any but JwNoStep).
template <typename Step>
constexpr bool jw_stepped =
    !std::is_same<std::remove_reference_t<Step>, JwNoStep>::value;

// The chains of one level at dilation d = 2^s (D as in jw_chain): chain c
// starts at lo + (c >> s) R d + (c & (d - 1)), so with R odd the 32 lanes of
// a warp (consecutive c) read 32 distinct banks at every dilation.  A
// chain that crosses `end` (at most d a level) computes its outputs below
// it one at a time, in the same fmaf order.  With a stepped Step the loop
// runs warp by warp: every lane of a warp takes the same number of turns
// (a lane past the last chain computes nothing) and calls step() after
// each, when the warp's 32 chains of the turn are emitted.  jw_level_pair's
// runtime-M branch writes the same turn loop out again: one helper taking
// the chain's body as a lambda compiled the variance, select and denoise
// kernels, which pass no step, to other SASS than this loop's.
template <int MT, int R, int D, typename Emit, typename Step>
__device__ __forceinline__ void jw_level_chains(const float* par, int lo,
                                                int end, int s,
                                                const JwTaps& taps,
                                                Emit& emit, Step& step) {
  constexpr bool stepped = jw_stepped<Step>;
  const int d = 1 << s;
  const int chains = ((end - lo + R * d - 1) / (R * d)) << s;
  const int lane = stepped ? threadIdx.x & 31 : 0;
  for (int c = threadIdx.x; c - lane < chains; c += blockDim.x) {
    if (!stepped || c < chains) {
      const int i0 = lo + (c >> s) * R * d + (c & (d - 1));
      if (i0 + (R - 1) * d < end) {
        jw_chain<MT, R, D>(par, i0, d, taps, emit);
      } else {
        for (int i = i0; i < end; i += d) {
          float v = 0.f, w = 0.f;
#pragma unroll
          for (int k = 0; k < MT; ++k) {
            const float t = par[i - k * d];
            v = fmaf(taps.g[k], t, v);
            w = fmaf(taps.h[k], t, w);
          }
          emit(i, v, w);
        }
      }
    }
    if constexpr (stepped) step();
  }
}

// One level of an à-trous pair cascade: every output window index i in
// [lo, end) gets v = sum_k g[k] par[i - k d] and w = sum_k h[k] par[i - k d]
// at d = 2^s, handed to emit(i, v, w).  MT: the filter length when it is a
// compile-time constant (taps then come from the parameter bank, the loops
// unroll and each thread computes register chains of R outputs, with the
// dilation a compile-time constant for s <= 4); 0 for any other M (taps
// from shared memory, one output at a time on the same map and turns, in
// the same fmaf order).  step: as in jw_level_chains (a kernel that stages
// a warp's outputs passes one; the others leave it out).
template <int MT, int R, typename Emit, typename Step = JwNoStep>
__device__ __forceinline__ void jw_level_pair(const float* par, int lo,
                                              int end, int s, int m,
                                              const JwTaps& taps,
                                              const float* sg,
                                              const float* sh, Emit&& emit,
                                              Step&& step = Step()) {
  if (end <= lo) return;
  if constexpr (MT > 0) {
    switch (s) {
      case 0: return
          jw_level_chains<MT, R, 1>(par, lo, end, s, taps, emit, step);
      case 1: return
          jw_level_chains<MT, R, 2>(par, lo, end, s, taps, emit, step);
      case 2: return
          jw_level_chains<MT, R, 4>(par, lo, end, s, taps, emit, step);
      case 3: return
          jw_level_chains<MT, R, 8>(par, lo, end, s, taps, emit, step);
      case 4: return
          jw_level_chains<MT, R, 16>(par, lo, end, s, taps, emit, step);
      default: return
          jw_level_chains<MT, R, 0>(par, lo, end, s, taps, emit, step);
    }
  } else {
    constexpr bool stepped = jw_stepped<Step>;
    const int d = 1 << s;
    const int chains = ((end - lo + R * d - 1) / (R * d)) << s;
    const int lane = stepped ? threadIdx.x & 31 : 0;
    for (int c = threadIdx.x; c - lane < chains; c += blockDim.x) {
      if (!stepped || c < chains) {
        const int i0 = lo + (c >> s) * R * d + (c & (d - 1));
        for (int i = i0; i < i0 + R * d && i < end; i += d) {
          float v = 0.f, w = 0.f;
          for (int k = 0; k < m; ++k) {
            const float t = par[i - k * d];
            v = fmaf(sg[k], t, v);
            w = fmaf(sh[k], t, w);
          }
          emit(i, v, w);
        }
      }
      if constexpr (stepped) step();
    }
  }
}

// One register chain of an adjoint (synthesis) level, the transpose of
// jw_chain: outputs i0 + r d, r < R, each
//   y = sum_k g[k] v[i + k d] + h[k] w[i + k d],
// handed to emit(i, y).  The R outputs share R + M - 1 reads of each row.
// fmaf order of every output, fixed: k ascending from 0.f, the V term
// before the W term of each k -- y = fmaf(h[k], w, fmaf(g[k], v, y)).  The
// rows are read at i0 + u d for u = 0, 1, ..., R + M - 2, so output r
// meets tap k = u - r in ascending order.  D as in jw_chain.  Only chains
// whose R outputs all lie below the level's end come here; their reads
// reach at most (R + M - 2) d past i0, inside the rows' valid part, so
// nothing needs a guard.
template <int MT, int R, int D, typename Emit>
__device__ __forceinline__ void jw_adjoint_chain(const float* v,
                                                 const float* w, int i0,
                                                 int d_run,
                                                 const JwTaps& taps,
                                                 Emit& emit) {
  const int d = D > 0 ? D : d_run;
  const float* pv = v + i0;
  const float* pw = w + i0;
  float y[R];
#pragma unroll
  for (int r = 0; r < R; ++r) y[r] = 0.f;
#pragma unroll
  for (int u = 0; u < R + MT - 1; ++u) {
    const float a = pv[u * d], b = pw[u * d];
#pragma unroll
    for (int k = 0; k < MT; ++k) {
      if (u - k >= 0 && u - k < R) {
        y[u - k] = fmaf(taps.g[k], a, y[u - k]);
        y[u - k] = fmaf(taps.h[k], b, y[u - k]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) emit(i0 + r * d, y[r]);
}

// The adjoint chains of one level, on jw_level_chains' map (chain c starts
// at lo + (c >> s) R d + (c & (d - 1)); R odd, so a warp's loads hit 32
// banks).  A chain that crosses `end` computes its outputs below it one
// at a time, in the same fmaf order.
template <int MT, int R, int D, typename Emit>
__device__ __forceinline__ void jw_adjoint_chains(const float* v,
                                                  const float* w, int lo,
                                                  int end, int s,
                                                  const JwTaps& taps,
                                                  Emit& emit) {
  const int d = 1 << s;
  const int chains = ((end - lo + R * d - 1) / (R * d)) << s;
  for (int c = threadIdx.x; c < chains; c += blockDim.x) {
    const int i0 = lo + (c >> s) * R * d + (c & (d - 1));
    if (i0 + (R - 1) * d < end) {
      jw_adjoint_chain<MT, R, D>(v, w, i0, d, taps, emit);
      continue;
    }
    for (int i = i0; i < end; i += d) {
      float y = 0.f;
#pragma unroll
      for (int k = 0; k < MT; ++k) {
        y = fmaf(taps.g[k], v[i + k * d], y);
        y = fmaf(taps.h[k], w[i + k * d], y);
      }
      emit(i, y);
    }
  }
}

// One level of an adjoint (synthesis) cascade: every output window index i
// in [lo, end) gets y = sum_k g[k] v[i + k d] + h[k] w[i + k d] at d = 2^s,
// handed to emit(i, y); v and w must be valid on [lo, end + (M - 1) d).
// MT as in jw_level_pair: a compile-time M takes the taps from the
// parameter bank in register chains of R outputs (the dilation a
// compile-time constant for s <= 4); MT = 0 takes any M from shared
// memory, one output at a time on the same map, in the same fmaf order.
template <int MT, int R, typename Emit>
__device__ __forceinline__ void jw_level_adjoint(const float* v,
                                                 const float* w, int lo,
                                                 int end, int s, int m,
                                                 const JwTaps& taps,
                                                 const float* sg,
                                                 const float* sh,
                                                 Emit&& emit) {
  if (end <= lo) return;
  if constexpr (MT > 0) {
    switch (s) {
      case 0: return jw_adjoint_chains<MT, R, 1>(v, w, lo, end, s, taps, emit);
      case 1: return jw_adjoint_chains<MT, R, 2>(v, w, lo, end, s, taps, emit);
      case 2: return jw_adjoint_chains<MT, R, 4>(v, w, lo, end, s, taps, emit);
      case 3: return jw_adjoint_chains<MT, R, 8>(v, w, lo, end, s, taps, emit);
      case 4:
        return jw_adjoint_chains<MT, R, 16>(v, w, lo, end, s, taps, emit);
      default:
        return jw_adjoint_chains<MT, R, 0>(v, w, lo, end, s, taps, emit);
    }
  } else {
    const int d = 1 << s;
    const int chains = ((end - lo + R * d - 1) / (R * d)) << s;
    for (int c = threadIdx.x; c < chains; c += blockDim.x) {
      const int i0 = lo + (c >> s) * R * d + (c & (d - 1));
      for (int i = i0; i < i0 + R * d && i < end; i += d) {
        float y = 0.f;
        for (int k = 0; k < m; ++k) {
          y = fmaf(sg[k], v[i + k * d], y);
          y = fmaf(sh[k], w[i + k * d], y);
        }
        emit(i, y);
      }
    }
  }
}

// The kernel instantiated for filter length m: M = 8, 2, 16 as template
// constants, any other M at run time.
#define JW_PICK_M(kernel, T, m)                              \
  ((m) == 8 ? kernel<T, 8>                                   \
            : (m) == 2 ? kernel<T, 2>                        \
                       : (m) == 16 ? kernel<T, 16> : kernel<T, 0>)

// Lift the 48 KB default cap on dynamic shared memory, launch `threads` a
// block, and report a refused launch (too much shared memory, bad grid),
// which would otherwise never run and never show up in
// torch.cuda.synchronize().
template <typename Kernel, typename... Args>
static int jw_launch_threads(Kernel kernel, long long blocks, int threads,
                             int smem, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The same, JW_THREADS a block.
template <typename Kernel, typename... Args>
static int jw_launch(Kernel kernel, long long blocks, int smem,
                     cudaStream_t stream, Args... args) {
  return jw_launch_threads(kernel, blocks, JW_THREADS, smem, stream, args...);
}
