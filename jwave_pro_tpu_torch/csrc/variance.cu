// Fused MODWT wavelet variance for Hopper (sm_90a).
//
// Replaces jwave_pro_tpu/kernels/variance_pallas.py _var_kernel: the
// forward cascade of jw_modwt_fwd_kernel (csrc/modwt.cu) with each level's
// sum of squares over the block's outputs in place of the stores, so the
// coefficients never reach device memory, and the sums over the tiles
// finished inside the launch: the result is the (L+1, B) means.
//
// What bounds it on the H100: one read per sample and no stores, so not
// device memory but the cascade -- 2M FMAs per sample and level, and the
// shared-memory accesses that feed them.  Read from shared memory for
// every FMA pair, the window and both taps (3M accesses an output and
// level) leave it bound by shared-memory instructions.  So the kernel:
//
// * takes the taps from the parameter bank (templated on M = 2, 8, 16,
//   with a runtime-M fallback), so they are FFMA operands, not loads;
// * computes each thread's outputs in register chains of JW_VAR_R, d apart
//   (jw_level_pair): R + M - 1 window loads and R stores of the V row serve
//   R outputs (2.8 accesses an output at Db4), on distinct banks, with no
//   guard and a compile-time dilation (immediate load offsets) in every
//   chain that ends below the level's end;
// * sums each level's w² over the warp with shuffles into a per-(level,
//   warp) shared slot, so a level costs one barrier (the V row's
//   ping-pong), and the slots are added once, at the end, in warp order;
// * finishes the sum over a row's tiles inside the launch: each block
//   writes its tile's sums, and the row's last block to finish (an atomic
//   ticket after __threadfence) adds them in tile order and writes the
//   means.  Every sum runs in a fixed order, so the result does not depend
//   on block scheduling: two launches are bitwise equal.
//
// The ticket counter: one unsigned int per row, zero between launches --
// the last block of a row resets its ticket.  The wrapper keeps one
// counter buffer per (device, stream): launches on one stream run in
// order, so they never share a ticket, and two streams never share one.
//
// The window: T outputs plus the exact halo, read as x[p mod N], so any N
// runs; each level computes only window indices below the tile's last
// valid one, `end` (a halo longer than N costs its own length, not T).

#include "common.cuh"

#define JW_VAR_R 9  // outputs in a register chain (odd: distinct banks)
#define JW_WARPS (JW_THREADS / 32)

// Block (row, tile): window x[row, (s - H + i) mod N], i in [0, end),
// end = H + min(T, N - s).  Level j's V_j and W_j cover [(M-1)(2^j - 1),
// end); outputs at [H, end) count.  Shared memory: the taps, (L+1) x 16
// warp sums, and two V rows of T + H floats.  partial: (L+1, B, tiles)
// float32 scratch; ticket: B unsigned ints, zero on entry and on exit;
// out: (L+1, B) float32 means.
template <typename T, int MT>
__global__ void __launch_bounds__(JW_THREADS, 2)
jw_modwt_var_kernel(const T* __restrict__ x, float* __restrict__ partial,
                    unsigned* __restrict__ ticket, float* __restrict__ out,
                    int batch, int n, int level, int m_run, int tile,
                    int ntiles, JwTaps taps) {
  extern __shared__ float smem[];
  const int m = MT > 0 ? MT : m_run;
  const int halo = (m - 1) * ((1 << level) - 1);
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  float* slots = smem + 2 * JW_MAX_TAPS;  // [level][warp]
  float* a = slots + (level + 1) * JW_WARPS;
  float* b = a + tile + halo;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const int row = blockIdx.x / ntiles;
  const int tix = blockIdx.x - row * ntiles;
  const long long s = (long long)tix * tile;
  const long long base = s - halo;
  const long long rest = (long long)n - s;  // >= 1
  const int end = halo + (rest < tile ? (int)rest : tile);
  const T* xr = x + (size_t)row * n;

  if (MT == 0) jw_stage_taps(taps, sg, sh, m);
  jw_load_window(xr, base, n, a, end);
  __syncthreads();

  int lo = 0;
  for (int j = 1; j <= level; ++j) {
    lo += (m - 1) << (j - 1);
    float ww = 0.f, vv = 0.f;
    if (j < level) {  // V_j for the next level; W_j counts from H on
      jw_level_pair<MT, JW_VAR_R>(a, lo, end, j - 1, m, taps, sg, sh,
                                  [&](int i, float v, float w) {
                                    b[i] = v;
                                    if (i >= halo) ww = fmaf(w, w, ww);
                                  });
    } else {  // lo = H: W_L and V_L count, nothing is stored
      jw_level_pair<MT, JW_VAR_R>(a, lo, end, j - 1, m, taps, sg, sh,
                                  [&](int, float v, float w) {
                                    ww = fmaf(w, w, ww);
                                    vv = fmaf(v, v, vv);
                                  });
      vv = jw_warp_sum(vv);
      if (lane == 0) slots[level * JW_WARPS + warp] = vv;
    }
    ww = jw_warp_sum(ww);
    if (lane == 0) slots[(j - 1) * JW_WARPS + warp] = ww;
    // the V row is complete before the next level reads it; after the
    // last level, every slot is
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }

  // the tile's sums, the warps' slots added in warp order
  const size_t plane = (size_t)batch * ntiles;
  for (int l = threadIdx.x; l <= level; l += blockDim.x) {
    float sum = 0.f;
    for (int w = 0; w < JW_WARPS; ++w) sum += slots[l * JW_WARPS + w];
    partial[(size_t)l * plane + (size_t)row * ntiles + tix] = sum;
    __threadfence();  // visible to the row's last block before the ticket
  }
  __syncthreads();
  // the slots are free now and hold the flag (no static shared memory)
  int* last_block = reinterpret_cast<int*>(slots);
  if (threadIdx.x == 0)
    *last_block = atomicAdd(ticket + row, 1u) == (unsigned)(ntiles - 1);
  __syncthreads();
  if (!*last_block) return;

  // the row's last block: each warp adds one level's tiles, lane by lane in
  // tile order, then across the lanes in a fixed shuffle tree
  __threadfence();
  for (int l = warp; l <= level; l += JW_WARPS) {
    const float* p = partial + (size_t)l * plane + (size_t)row * ntiles;
    float sum = 0.f;
    for (int t = lane; t < ntiles; t += 32) sum += __ldcg(p + t);
    sum = jw_warp_sum(sum);
    if (lane == 0) out[(size_t)l * batch + row] = sum / (float)n;
  }
  if (threadIdx.x == 0) ticket[row] = 0u;
}

extern "C" {

// x (B, N) of `dtype` -> out (L+1, B) float32 means of W_1² .. W_L², V_L²;
// partial: (L+1, B, ceil(N / tile)) float32 scratch; ticket: B unsigned
// ints, all zero (and zero again when the launch ends); contiguous, on
// `device`.  smem: the bytes of the wrapper's plan (var_plan).
int jw_modwt_var(const void* x, float* partial, unsigned* ticket, float* out,
                 int batch, int n, int level, const float* g, const float* h,
                 int m, int tile, int smem, int dtype, int device,
                 void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int halo = (m - 1) * ((1 << level) - 1);
  if (tile < 1 || level < 1 ||
      smem != (int)sizeof(float) * (2 * JW_MAX_TAPS + (level + 1) * JW_WARPS +
                                    2 * (tile + halo)))
    return (int)cudaErrorInvalidValue;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int ntiles = (n + tile - 1) / tile;
  const long long blocks = (long long)ntiles * batch;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch(JW_PICK_M(jw_modwt_var_kernel, __nv_bfloat16, m), blocks,
                     smem, st, (const __nv_bfloat16*)x, partial, ticket, out,
                     batch, n, level, m, tile, ntiles, taps);
  return jw_launch(JW_PICK_M(jw_modwt_var_kernel, float, m), blocks, smem, st,
                   (const float*)x, partial, ticket, out, batch, n, level, m,
                   tile, ntiles, taps);
}

}  // extern "C"
