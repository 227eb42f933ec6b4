// Fused MODWPT (shift-invariant packet tree) kernels for Hopper (sm_90a).
//
// Forward: replaces jwave_pro_tpu/kernels/modwpt_pallas.py _forward_kernel,
// all 2^L sequency-ordered leaves of the packet tree.  Select: replaces
// _select_kernel, the same cascade with a per-node arg-max of |w| in place
// of the stores (matching pursuit's select stage).  Inverse: replaces
// _inverse_kernel, the packet tree's adjoint.
//
// What bounds them on the H100: the forward writes 2^L rows per sample it
// reads (device-memory traffic, as the MODWT forward); the inverse mirrors
// it; the select writes nothing per sample, so the cascade and its
// shared-memory accesses bound it, and at matching pursuit's sizes the
// walk's latency (its design is described at the kernel).  Shared memory
// is the design constraint: done breadth-first, as on the TPU, a block
// would keep 3·2^(L-1) node rows, and Db4 L4 would no longer fit a block
// at any useful tile.  So each block walks its tile's tree depth-first and keeps
// only the rows of the current root-to-leaf path, the two children of each
// level: 2L - 1 rows forward, 2L inverse.  Leaves go straight to device
// memory (forward) or come straight from it (inverse), at their sequency
// index.  Every node is still computed once per block.
//
// Sequency order (ops/modwpt.py): the natural child c = 2p + b (b = 0 for
// the g̃ branch, 1 for h̃) of the node with sequency index p has sequency
// index c ^ ((c >> 1) & 1) = 2p + (b ^ (p & 1)).
//
// Window of a block: T outputs plus the exact halo H = (M-1)(2^L - 1), read
// as x[(p) mod N], so any N runs, halo longer than N included.  The forward
// valid region of a level-j node starts at (M-1)(2^j - 1); the inverse one
// ends (M-1)(2^L - 2^j) before the window's end.

#include "common.cuh"

#define JW_SELECT_R 5  // outputs in a register chain (odd: distinct banks)
#define JW_WARPS (JW_THREADS / 32)

// Both children of `par` at dilation d, over window indices [lo, width):
// cg[i] = sum_k g[k] par[i - k d], ch likewise with h.
__device__ __forceinline__ void jw_packet_pair(const float* par, float* cg,
                                               float* ch, int lo, int width,
                                               int d, int m, const float* sg,
                                               const float* sh) {
  for (int i = lo + threadIdx.x; i < width; i += blockDim.x) {
    float v = 0.f, w = 0.f;
    for (int k = 0; k < m; ++k) {
      const float t = par[i - k * d];
      v = fmaf(sg[k], t, v);
      w = fmaf(sh[k], t, w);
    }
    cg[i] = v;
    ch[i] = w;
  }
}

// Sequency index of the level-(level-1) node that path q reaches: bit
// (level-1-j) of q is the branch taken at level j (0: g̃, 1: h̃).
__device__ __forceinline__ int jw_path_seq(int q, int level) {
  int p = 0;
  for (int j = 1; j < level; ++j) {
    const int b = (q >> (level - 1 - j)) & 1;
    p = 2 * p + (b ^ (p & 1));
  }
  return p;
}

// The forward cascade of one block, depth-first.  rows[0] holds the input
// window (loaded and synchronised by the caller); row(j, b), 1 <= j < L,
// holds the b-branch child of the path's level-(j-1) node.  For each
// leaf-parent q in turn, only the levels below the branch that changed from
// q - 1 are recomputed.  The leaves of each leaf-parent go to `sink`:
// begin(seq_g, seq_h), leaf(i, w_g, w_h) for each window index i >= H,
// end() (called by every thread; it may synchronise).
template <typename Sink>
__device__ void jw_packet_forward(float* rows, int width, int level, int m,
                                  int halo, const float* sg, const float* sh,
                                  Sink& sink) {
  auto row = [&](int j, int b) {
    return j == 0 ? rows : rows + (size_t)(2 * j - 1 + b) * width;
  };
  for (int q = 0; q < (1 << (level - 1)); ++q) {
    const int j0 = q == 0 ? 0 : level - __ffs(q);  // its branch bit turned 1
    int lo = (m - 1) * ((1 << j0) - 1);
    for (int j = j0 + 1; j < level; ++j) {
      const int d = 1 << (j - 1);
      lo += (m - 1) * d;
      const int bp = j == 1 ? 0 : (q >> (level - j)) & 1;
      jw_packet_pair(row(j - 1, bp), row(j, 0), row(j, 1), lo, width, d, m,
                     sg, sh);
      __syncthreads();
    }
    const float* par = row(level - 1, level == 1 ? 0 : q & 1);
    const int p = jw_path_seq(q, level);
    const int d = 1 << (level - 1);
    sink.begin(2 * p + (p & 1), 2 * p + 1 - (p & 1));
    for (int i = halo + threadIdx.x; i < width; i += blockDim.x) {
      float v = 0.f, w = 0.f;
      for (int k = 0; k < m; ++k) {
        const float t = par[i - k * d];
        v = fmaf(sg[k], t, v);
        w = fmaf(sh[k], t, w);
      }
      sink.leaf(i, v, w);
    }
    sink.end();
    __syncthreads();  // the next path may overwrite these rows
  }
}

// Leaf sink of the forward kernel: store each leaf at its sequency row.
template <typename T>
struct JwLeafStore {
  T* out;
  size_t plane, rowoff;  // B·N, row·N
  long long base;        // signal position of window index 0
  int n;
  T* dg;
  T* dh;
  __device__ void begin(int seq_g, int seq_h) {
    dg = out + (size_t)seq_g * plane + rowoff;
    dh = out + (size_t)seq_h * plane + rowoff;
  }
  __device__ void leaf(int i, float v, float w) {
    const long long p = base + i;
    if (p < n) {
      jw_store(dg + p, v);
      jw_store(dh + p, w);
    }
  }
  __device__ void end() {}
};

// One candidate of the select's arg-max as a 64-bit key: the bits of |w|
// (a non-negative float orders as its bits), then 0x7fffffff - position
// (on equal |w| the smaller position wins), then the sign bit of w.  The
// largest key is the first maximum of |w| whatever order the keys meet in,
// and w comes back exactly.  0 is below every candidate.
__device__ __forceinline__ unsigned long long jw_key(float w, int pos) {
  return ((unsigned long long)__float_as_uint(fabsf(w)) << 32) |
         ((unsigned)(0x7fffffff - pos) << 1) | (__float_as_uint(w) >> 31);
}

__device__ __forceinline__ unsigned long long jw_key_max(
    unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

// The largest key over the warp, valid in lane 0.
__device__ __forceinline__ unsigned long long jw_warp_max(
    unsigned long long k) {
  for (int o = 16; o > 0; o >>= 1)
    k = jw_key_max(k, __shfl_down_sync(0xffffffffu, k, o));
  return k;
}

// Block (row, tile): window x[row, (s - H + i) mod N], i in [0, T + H).
template <typename T>
__global__ void __launch_bounds__(JW_THREADS)
jw_modwpt_fwd_kernel(const T* __restrict__ x, T* __restrict__ out, int batch,
                     int n, int level, int m, int tile, int halo, int ntiles,
                     JwTaps taps) {
  extern __shared__ float smem[];
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  float* rows = smem + 2 * JW_MAX_TAPS;
  const int width = tile + halo;
  const int row = blockIdx.x / ntiles;
  const long long base = (long long)(blockIdx.x - row * ntiles) * tile - halo;
  const T* xr = x + (size_t)row * n;

  jw_stage_taps(taps, sg, sh, m);
  for (int i = threadIdx.x; i < width; i += blockDim.x)
    rows[i] = jw_load(xr + jw_index(base + i, n));
  __syncthreads();

  JwLeafStore<T> sink;
  sink.out = out;
  sink.plane = (size_t)batch * n;
  sink.rowoff = (size_t)row * n;
  sink.base = base;
  sink.n = n;
  jw_packet_forward(rows, width, level, m, halo, sg, sh, sink);
}

// Select.  The forward kernel's depth-first walk, with each level's pair
// of rows computed by jw_level_pair: register chains of JW_SELECT_R
// outputs a thread, taps from the parameter bank where M is a template
// constant.  Every node is the forward's fmaf chain (k ascending from 0.f,
// v and w apart), so positions and values equal the arg-max over
// jw_modwpt_fwd_kernel's output bit for bit.  Rows are computed only up to
// the tile's last valid window index, `end`.
//
// Per leaf pair, each thread keeps the largest key (jw_key) of each leaf;
// a shuffle stage reduces each warp, a second one (warps 0 and 1, one leaf
// each) the 16 warps' slots, which alternate between two sets by q's
// parity so the next path need not wait for them.  The tile's best key per
// leaf goes to partial[seq][row][tile], and the row's last block to finish
// (an atomic ticket after __threadfence, reset to 0 by that block) takes
// the largest over the row's tiles and writes out[k][seq][row] (k: |w|,
// position bits, w): one launch, as the TPU kernel's running max across
// its sequential tile axis.
//
// Tile and threads: 512 threads and a 4096 tile, so (8, 65536) at Db4 L3
// is 16 tiles, 128 blocks, one an SM, each level at most two chains a
// thread.  The walk is latency-bound at that size: a tile of one chain a
// thread (R·512 − H = 2511: 216 blocks, two on most SMs) fills more of
// the card but ran slower on the H100, and a smaller tile also pays the
// halo (49 at Db4 L3) more often.  The wrapper's plan (select_plan) cuts T
// where the 2L - 1 rows would not fit.
template <typename T, int MT>
__global__ void __launch_bounds__(JW_THREADS, 2)
jw_modwpt_select_kernel(const T* __restrict__ x,
                        unsigned long long* __restrict__ partial,
                        unsigned* __restrict__ ticket,
                        float* __restrict__ out, int batch, int n, int level,
                        int m_run, int tile, int ntiles, JwTaps taps) {
  extern __shared__ float smem[];
  const int m = MT > 0 ? MT : m_run;
  const int halo = (m - 1) * ((1 << level) - 1);
  const int width = tile + halo;
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  // key slots [set][leaf][warp]
  unsigned long long* slots =
      reinterpret_cast<unsigned long long*>(smem + 2 * JW_MAX_TAPS);
  float* rows = smem + 2 * JW_MAX_TAPS + 8 * JW_WARPS;
  auto row_of = [&](int j, int b) {
    return j == 0 ? rows : rows + (size_t)(2 * j - 1 + b) * width;
  };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nodes = 1 << level;

  const int row = blockIdx.x / ntiles;
  const int tix = blockIdx.x - row * ntiles;
  const long long s = (long long)tix * tile;
  const long long base = s - halo;
  const long long rest = (long long)n - s;  // >= 1
  const int end = halo + (rest < tile ? (int)rest : tile);
  const T* xr = x + (size_t)row * n;
  const size_t plane = (size_t)batch * ntiles;  // partial (2^L, B, tiles)

  if (MT == 0) jw_stage_taps(taps, sg, sh, m);
  jw_load_window(xr, base, n, rows, end);
  __syncthreads();

  for (int q = 0; q < (1 << (level - 1)); ++q) {
    // the levels below the branch that changed from q - 1
    const int j0 = q == 0 ? 0 : level - __ffs(q);
    int lo = (m - 1) * ((1 << j0) - 1);
    for (int j = j0 + 1; j < level; ++j) {
      lo += (m - 1) << (j - 1);
      const int bp = j == 1 ? 0 : (q >> (level - j)) & 1;
      float* cg = row_of(j, 0);
      float* ch = row_of(j, 1);
      jw_level_pair<MT, JW_SELECT_R>(row_of(j - 1, bp), lo, end, j - 1, m,
                                     taps, sg, sh,
                                     [&](int i, float v, float w) {
                                       cg[i] = v;
                                       ch[i] = w;
                                     });
      __syncthreads();
    }
    // the leaf pair: each thread's largest key of both leaves
    unsigned long long kg = 0, kh = 0;
    jw_level_pair<MT, JW_SELECT_R>(
        row_of(level - 1, level == 1 ? 0 : q & 1), halo, end, level - 1, m,
        taps, sg, sh, [&](int i, float wg, float wh) {
          const int pos = (int)(base + i);
          kg = jw_key_max(kg, jw_key(wg, pos));
          kh = jw_key_max(kh, jw_key(wh, pos));
        });
    kg = jw_warp_max(kg);
    kh = jw_warp_max(kh);
    unsigned long long* set = slots + (q & 1) * 2 * JW_WARPS;
    if (lane == 0) {
      set[warp] = kg;
      set[JW_WARPS + warp] = kh;
    }
    // also: every read of this path's rows is done
    __syncthreads();
    if (warp < 2) {  // warp c merges leaf c's 16 slots
      unsigned long long k =
          jw_warp_max(lane < JW_WARPS ? set[warp * JW_WARPS + lane] : 0ull);
      if (lane == 0) {
        const int ps = jw_path_seq(q, level);
        const int seq = warp == 0 ? 2 * ps + (ps & 1) : 2 * ps + 1 - (ps & 1);
        partial[(size_t)seq * plane + (size_t)row * ntiles + tix] = k;
      }
    }
  }
  // the tile's keys visible to the row's last block before the ticket
  if (warp < 2 && lane == 0) __threadfence();
  __syncthreads();
  // the slots are free now and hold the flag (no static shared memory, so
  // the plan may give the rows all of the 227 KB)
  int* last_block = reinterpret_cast<int*>(slots);
  if (threadIdx.x == 0)
    *last_block = atomicAdd(ticket + row, 1u) == (unsigned)(ntiles - 1);
  __syncthreads();
  if (!*last_block) return;

  // the row's last block: each warp takes one leaf's largest key
  __threadfence();
  const size_t oplane = (size_t)batch * nodes;  // out (3, 2^L, B)
  for (int leaf = warp; leaf < nodes; leaf += JW_WARPS) {
    const unsigned long long* p =
        partial + (size_t)leaf * plane + (size_t)row * ntiles;
    unsigned long long k = 0;
    for (int t = lane; t < ntiles; t += 32) k = jw_key_max(k, __ldcg(p + t));
    k = jw_warp_max(k);
    if (lane == 0) {
      const size_t o = (size_t)leaf * batch + row;
      const float a = __uint_as_float((unsigned)(k >> 32));
      out[o] = a;
      reinterpret_cast<int*>(out)[oplane + o] =
          0x7fffffff - (int)((unsigned)k >> 1);
      out[2 * oplane + o] = (k & 1) ? -a : a;
    }
  }
  if (threadIdx.x == 0) ticket[row] = 0u;
}

// One adjoint level: parent[i] = sum_k g[k] cg[i + k d] + h[k] ch[i + k d].
__device__ __forceinline__ float jw_packet_adjoint(const float* cg,
                                                   const float* ch, int i,
                                                   int d, int m,
                                                   const float* sg,
                                                   const float* sh) {
  float acc = 0.f;
  for (int k = 0; k < m; ++k) acc += sg[k] * cg[i + k * d] + sh[k] * ch[i + k * d];
  return acc;
}

// Block (row, tile): window [s, s + T + H) mod N of every leaf.  Post-order:
// for each leaf-parent q, its two leaves are staged into the leaf rows and
// combined into row(L-1, b); whenever a node that is an h̃ child is done, both
// children of its parent are ready and the walk climbs, until a g̃ child or
// the root (written to memory) is reached.
template <typename T>
__global__ void __launch_bounds__(JW_THREADS)
jw_modwpt_inv_kernel(const T* __restrict__ c, T* __restrict__ out, int batch,
                     int n, int level, int m, int tile, int halo, int ntiles,
                     JwTaps taps) {
  extern __shared__ float smem[];
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  const int width = tile + halo;
  float* leaf_g = smem + 2 * JW_MAX_TAPS;
  float* leaf_h = leaf_g + width;
  auto node = [&](int j, int b) {  // row(j, b), 1 <= j < L
    return leaf_h + (size_t)(2 * j - 1 + b) * width;
  };
  const int row = blockIdx.x / ntiles;
  const long long s = (long long)(blockIdx.x - row * ntiles) * tile;
  const size_t plane = (size_t)batch * n;
  T* dst = out + (size_t)row * n;

  jw_stage_taps(taps, sg, sh, m);
  for (int q = 0; q < (1 << (level - 1)); ++q) {
    const int p = jw_path_seq(q, level);
    const T* src_g = c + (size_t)(2 * p + (p & 1)) * plane + (size_t)row * n;
    const T* src_h = c + (size_t)(2 * p + 1 - (p & 1)) * plane + (size_t)row * n;
    for (int i = threadIdx.x; i < width; i += blockDim.x) {
      const long long idx = jw_index(s + i, n);
      leaf_g[i] = jw_load(src_g + idx);
      leaf_h[i] = jw_load(src_h + idx);
    }
    __syncthreads();
    // climb: level j's pair (cg, ch) -> the level-(j-1) node on the path
    const float* cg = leaf_g;
    const float* ch = leaf_h;
    int len = width;  // valid length of the level-j rows
    for (int j = level; j >= 1; --j) {
      const int d = 1 << (j - 1);
      len -= (m - 1) * d;
      if (j == 1) {
        for (int i = threadIdx.x; i < tile; i += blockDim.x) {
          const long long pp = s + i;
          if (pp < n) jw_store(dst + pp, jw_packet_adjoint(cg, ch, i, d, m, sg, sh));
        }
        __syncthreads();
        break;
      }
      const int b = (q >> (level - j)) & 1;  // branch of the level-(j-1) node
      float* par = node(j - 1, b);
      for (int i = threadIdx.x; i < len; i += blockDim.x)
        par[i] = jw_packet_adjoint(cg, ch, i, d, m, sg, sh);
      __syncthreads();
      if (!b) break;  // a g̃ child: its h̃ sibling comes with a later q
      cg = node(j - 1, 0);
      ch = node(j - 1, 1);
    }
  }
}

extern "C" {

// x (B, N) -> out (2^L, B, N), both of `dtype`, contiguous, on `device`.
int jw_modwpt_fwd(const void* x, void* out, int batch, int n, int level,
                  const float* g, const float* h, int m, int tile, int halo,
                  int smem, int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int ntiles = (n + tile - 1) / tile;
  const long long blocks = (long long)ntiles * batch;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch(jw_modwpt_fwd_kernel<__nv_bfloat16>, blocks, smem, st,
                     (const __nv_bfloat16*)x, (__nv_bfloat16*)out, batch, n,
                     level, m, tile, halo, ntiles, taps);
  return jw_launch(jw_modwpt_fwd_kernel<float>, blocks, smem, st,
                   (const float*)x, (float*)out, batch, n, level, m, tile,
                   halo, ntiles, taps);
}

// x (B, N) of `dtype` -> out (3, 2^L, B) float32: per leaf (sequency
// order) and row the largest |w|, its first position (int32 bits) and w.
// partial: (2^L, B, ceil(N / tile)) 64-bit scratch; ticket: B unsigned
// ints, all zero (and zero again when the launch ends).  smem: the bytes of
// the wrapper's plan (select_plan).
int jw_modwpt_select(const void* x, unsigned long long* partial,
                     unsigned* ticket,
                     float* out, int batch, int n, int level, const float* g,
                     const float* h, int m, int tile, int smem, int dtype,
                     int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int halo = (m - 1) * ((1 << level) - 1);
  if (tile < 1 || level < 1 ||
      smem != (int)sizeof(float) * (2 * JW_MAX_TAPS + 8 * JW_WARPS +
                                    (2 * level - 1) * (tile + halo)))
    return (int)cudaErrorInvalidValue;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int ntiles = (n + tile - 1) / tile;
  const long long blocks = (long long)ntiles * batch;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch(JW_PICK_M(jw_modwpt_select_kernel, __nv_bfloat16, m),
                     blocks, smem, st, (const __nv_bfloat16*)x, partial,
                     ticket, out, batch, n, level, m, tile, ntiles, taps);
  return jw_launch(JW_PICK_M(jw_modwpt_select_kernel, float, m), blocks, smem,
                   st, (const float*)x, partial, ticket, out, batch, n, level,
                   m, tile, ntiles, taps);
}

// c (2^L, B, N) -> out (B, N), both of `dtype`, contiguous, on `device`.
int jw_modwpt_inv(const void* c, void* out, int batch, int n, int level,
                  const float* g, const float* h, int m, int tile, int halo,
                  int smem, int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int ntiles = (n + tile - 1) / tile;
  const long long blocks = (long long)ntiles * batch;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch(jw_modwpt_inv_kernel<__nv_bfloat16>, blocks, smem, st,
                     (const __nv_bfloat16*)c, (__nv_bfloat16*)out, batch, n,
                     level, m, tile, halo, ntiles, taps);
  return jw_launch(jw_modwpt_inv_kernel<float>, blocks, smem, st,
                   (const float*)c, (float*)out, batch, n, level, m, tile,
                   halo, ntiles, taps);
}

}  // extern "C"
