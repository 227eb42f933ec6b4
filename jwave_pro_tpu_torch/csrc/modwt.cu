// Fused multi-level MODWT kernels for Hopper (sm_90a).
//
// Forward: replaces jwave_pro_tpu/kernels/modwt_pallas.py _forward_kernel
// (batched (B, N)) and _forward_kernel_flat (the 1D (N,) contract, which on
// this card is simply B = 1).  Inverse: replaces _inverse_kernel.
//
// What bounds them on the H100: device-memory traffic.  The forward moves
// 1 read + (L+1) writes per sample against 4*M*L flops; the inverse
// (L+1) reads + 1 write.  The design keeps the whole level chain of one tile
// in shared memory, so every sample crosses device memory exactly once per
// row, and reads each tile's circular context x[(p) mod N] directly — no
// padded copy of the signal, no tile-size plan over N, any N.
//
// Window of a block: T outputs plus the exact halo H = (M-1)(2^L - 1).
// Level j reads the previous level at shifts k*2^(j-1); its valid region
// shrinks by (M-1)*2^(j-1) on the side the shifts read from (the left for
// the forward convolution, the right for the adjoint).  Both compute a
// level only below the tile's last valid sample (min(T, N - s)), so a
// ragged last tile or a halo longer than N costs its own length.
//
// The forward stores L + 1 rows for each row it reads, so its stores are
// most of its bytes and must stay coalesced.  Reading both taps and the
// window from shared memory for every FMA pair (3M accesses an output and
// level) made it bound by shared-memory instructions instead.  So it is
// templated on M = 2, 8, 16 (taps from the parameter bank, with a
// runtime-M instantiation for the others) and computes each level in
// jw_level_pair's register chains (R + M - 1 window reads serve R outputs;
// each output one fmaf chain over k ascending from 0.f, bitwise the
// values of the one-output-a-thread loop it replaced).  A chain's outputs
// lie d apart and a warp's lanes R d apart, so W_j emitted straight from
// the chains would scatter each warp store over ~R times the sectors.  For
// d < 32 a warp's 32 chains of one turn cover 32 R consecutive window
// indices: each lane drops its W values into the warp's slice of shared
// memory and the warp stores the slice as consecutive addresses (at the
// last level V_L too, from the V row the warp itself wrote).  For d >= 32
// the lanes already hold consecutive indices and store straight.
//
// The inverse reads L + 1 rows per output against 2M FMAs per output and
// level.  It is templated on M like the forward, computes each level in
// jw_level_adjoint's register chains (R + M - 1 reads of each row serve R
// outputs), and has the next level's W row in flight while a level runs.
// Its second instantiation shrinks every detail row as it loads it, so a
// denoise reads the forward's coefficients as they lie: no shrunk copy of
// the L detail rows is written and read again, and no stack is rebuilt
// (modwt_inv.cuh holds the body both share; the shrinking kernel and its
// entry point are in modwt_shrink.cu).

#include "common.cuh"
#include "modwt_inv.cuh"

#define JW_FWD_R 9  // outputs in a forward register chain (odd: distinct banks)
#define JW_FWD_THREADS 256  // a block; four an SM at 4096-sample tiles
// floats of W staging a block: 32 R a warp
#define JW_FWD_SLICE (JW_FWD_THREADS * JW_FWD_R)

// Block (row, tile): window x[row, (s - H + i) mod N], i in [0, end),
// end = H + min(T, N - s).  Level j's V_j and W_j cover [(M-1)(2^j - 1),
// end); outputs at [H, end) are stored.  Shared memory: the taps, one
// slice of 32 R floats a warp (W_j staged for the warp's stores), and two
// V rows of T + H floats (ping-pong).
//
// CTX: the row is one shard of a longer signal, and the H samples before
// its position 0 are row `row` of ctx (rows, H), not the row's own end:
// position p < 0 of the window reads ctx[row, H + p].  Only the first
// tiles of a row (s < H) read ctx; no window wraps.  Without CTX the body
// compiles to the kernel it was before ctx existed.
template <typename T, int MT, bool CTX>
__device__ __forceinline__ void jw_modwt_fwd_body(
    const T* __restrict__ x, const T* __restrict__ ctx, T* __restrict__ out,
    int batch, int n, int level, int m_run, int tile, int halo, int ntiles,
    const JwTaps& taps) {
  extern __shared__ float smem[];
  const int m = MT > 0 ? MT : m_run;
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  const int lane = threadIdx.x & 31;
  float* slice = smem + 2 * JW_MAX_TAPS + (threadIdx.x >> 5) * 32 * JW_FWD_R;
  float* a = smem + 2 * JW_MAX_TAPS + JW_FWD_SLICE;
  float* b = a + tile + halo;

  const int row = blockIdx.x / ntiles;
  const long long s = (long long)(blockIdx.x - row * ntiles) * tile;
  const long long rest = (long long)n - s;  // >= 1
  const int end = halo + (rest < tile ? (int)rest : tile);
  const long long plane = (long long)batch * n;
  // window index i <-> position s - H + i of the row: out row r's element
  const long long first_p = (long long)row * n + s - halo;
  auto dst = [&](int r, int i) { return out + (r * plane + first_p + i); };

  if (MT == 0) jw_stage_taps(taps, sg, sh, m);
  if (CTX && s < halo) {
    // window [0, from_ctx) is ctx[row, s + i]; the rest x[row, 0 ...)
    const int from_ctx = halo - (int)s;
    jw_load_window(ctx + (size_t)row * halo + s, 0, halo, a, from_ctx);
    jw_load_window(x + (size_t)row * n, 0, n, a + from_ctx, end - from_ctx);
  } else {
    jw_load_window(x + (size_t)row * n, s - halo, n, a, end);
  }
  __syncthreads();

  int lo = 0;  // first valid index of the current V in the window
  for (int j = 1; j <= level; ++j) {
    const int sj = j - 1;
    lo += (m - 1) << sj;
    const bool last = j == level;
    const bool staged = sj < 5;  // d < 32
    // the window index of the warp's first output in this turn: its 32
    // chains start at lo + c0 R (c0 = the turn's first chain, a multiple
    // of 32 and of d)
    int first = lo + (threadIdx.x & ~31) * JW_FWD_R;
    jw_level_pair<MT, JW_FWD_R>(
        a, lo, end, sj, m, taps, sg, sh,
        [&](int i, float v, float w) {
          b[i] = v;
          if (staged) {
            slice[i - first] = w;
          } else if (i >= halo) {
            jw_store(dst(sj, i), w);
            if (last) jw_store(dst(level, i), v);
          }
        },
        [&]() {
          if (staged) {
            __syncwarp();
#pragma unroll
            for (int k = 0; k < JW_FWD_R; ++k) {
              const int i = first + k * 32 + lane;
              if (i >= halo && i < end) {
                jw_store(dst(sj, i), slice[k * 32 + lane]);
                if (last) jw_store(dst(level, i), b[i]);
              }
            }
            __syncwarp();  // the slice is read before the next turn's emits
          }
          first += (int)blockDim.x * JW_FWD_R;
        });
    if (last) break;
    __syncthreads();  // V_j complete before the next level reads it
    float* t = a;
    a = b;
    b = t;
  }
}

template <typename T, int MT>
__global__ void __launch_bounds__(JW_FWD_THREADS, 4)
jw_modwt_fwd_kernel(const T* __restrict__ x, T* __restrict__ out, int batch,
                    int n, int level, int m_run, int tile, int halo,
                    int ntiles, JwTaps taps) {
  jw_modwt_fwd_body<T, MT, false>(x, nullptr, out, batch, n, level, m_run,
                                  tile, halo, ntiles, taps);
}

// The forward of one shard: the window's left context from ctx (rows, H).
template <typename T, int MT>
__global__ void __launch_bounds__(JW_FWD_THREADS, 4)
jw_modwt_fwd_ctx_kernel(const T* __restrict__ x, const T* __restrict__ ctx,
                        T* __restrict__ out, int batch, int n, int level,
                        int m_run, int tile, int halo, int ntiles,
                        JwTaps taps) {
  jw_modwt_fwd_body<T, MT, true>(x, ctx, out, batch, n, level, m_run, tile,
                                 halo, ntiles, taps);
}

// The inverse (#3): modwt_inv.cuh's body, every row as it lies.
template <typename T, int MT>
__global__ void __launch_bounds__(JW_INV_THREADS, 4)
jw_modwt_inv_kernel(const T* __restrict__ c, T* __restrict__ out, int batch,
                    int n, int level, int m_run, int tile, int halo,
                    int ntiles, JwTaps taps) {
  jw_modwt_inv_body<T, MT, JW_KEEP>(c, out, batch, n, level, m_run, tile,
                                    halo, ntiles, taps, nullptr, 0.f, 0, 0);
}

extern "C" {

const char* jw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (B, N) -> out (L+1, B, N), both of `dtype`, contiguous, on `device`.
// halo: (m - 1)(2^level - 1); smem: the bytes of the wrapper's plan
// (smem_bytes(level, m, 'fwd')): the taps, the warps' W slices and two
// rows of tile + halo.
int jw_modwt_fwd(const void* x, void* out, int batch, int n, int level,
                 const float* g, const float* h, int m, int tile, int halo,
                 int smem, int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (tile < 1 || level < 1 || m < 1 || m > JW_MAX_TAPS ||
      halo != (m - 1) * ((1 << level) - 1) ||
      smem != (int)sizeof(float) * (2 * JW_MAX_TAPS + JW_FWD_SLICE +
                                    2 * (tile + halo)))
    return (int)cudaErrorInvalidValue;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int ntiles = (n + tile - 1) / tile;
  const long long blocks = (long long)ntiles * batch;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch_threads(
        JW_PICK_M(jw_modwt_fwd_kernel, __nv_bfloat16, m), blocks,
        JW_FWD_THREADS, smem, st, (const __nv_bfloat16*)x,
        (__nv_bfloat16*)out, batch, n, level, m, tile, halo, ntiles, taps);
  return jw_launch_threads(JW_PICK_M(jw_modwt_fwd_kernel, float, m), blocks,
                           JW_FWD_THREADS, smem, st, (const float*)x,
                           (float*)out, batch, n, level, m, tile, halo,
                           ntiles, taps);
}

// The same for one shard of each row: ctx (B, halo) holds the halo samples
// before each row's position 0 (the left neighbour's last ones), which
// take the place of the row's wrapped end.
int jw_modwt_fwd_ctx(const void* x, const void* ctx, void* out, int batch,
                     int n, int level, const float* g, const float* h, int m,
                     int tile, int halo, int smem, int dtype, int device,
                     void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (tile < 1 || level < 1 || m < 1 || m > JW_MAX_TAPS ||
      halo != (m - 1) * ((1 << level) - 1) ||
      smem != (int)sizeof(float) * (2 * JW_MAX_TAPS + JW_FWD_SLICE +
                                    2 * (tile + halo)))
    return (int)cudaErrorInvalidValue;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int ntiles = (n + tile - 1) / tile;
  const long long blocks = (long long)ntiles * batch;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch_threads(
        JW_PICK_M(jw_modwt_fwd_ctx_kernel, __nv_bfloat16, m), blocks,
        JW_FWD_THREADS, smem, st, (const __nv_bfloat16*)x,
        (const __nv_bfloat16*)ctx, (__nv_bfloat16*)out, batch, n, level, m,
        tile, halo, ntiles, taps);
  return jw_launch_threads(JW_PICK_M(jw_modwt_fwd_ctx_kernel, float, m),
                           blocks, JW_FWD_THREADS, smem, st, (const float*)x,
                           (const float*)ctx, (float*)out, batch, n, level,
                           m, tile, halo, ntiles, taps);
}

// c (L+1, B, N) -> out (B, N), both of `dtype`, contiguous, on `device`.
// halo: (m - 1)(2^level - 1); smem: the bytes of the wrapper's plan
// (smem_bytes(level, m, 'inv')): the taps and three rows of tile + halo.
int jw_modwt_inv(const void* c, void* out, int batch, int n, int level,
                 const float* g, const float* h, int m, int tile, int halo,
                 int smem, int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (tile < 1 || level < 1 || m < 1 || m > JW_MAX_TAPS ||
      halo != (m - 1) * ((1 << level) - 1) ||
      smem != (int)sizeof(float) * (2 * JW_MAX_TAPS + 3 * (tile + halo)))
    return (int)cudaErrorInvalidValue;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int ntiles = (n + tile - 1) / tile;
  const long long blocks = (long long)ntiles * batch;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch_threads(
        JW_PICK_M(jw_modwt_inv_kernel, __nv_bfloat16, m), blocks,
        JW_INV_THREADS, smem, st, (const __nv_bfloat16*)c,
        (__nv_bfloat16*)out, batch, n, level, m, tile, halo, ntiles, taps);
  return jw_launch_threads(JW_PICK_M(jw_modwt_inv_kernel, float, m), blocks,
                           JW_INV_THREADS, smem, st, (const float*)c,
                           (float*)out, batch, n, level, m, tile, halo,
                           ntiles, taps);
}

}  // extern "C"
