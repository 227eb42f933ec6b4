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
// level: 2L - 1 rows forward, 2L inverse.  Leaves go to device memory
// (forward) or come from it (inverse), at their sequency index.  Every node
// is still computed once per block.
//
// All three are templated on M = 2, 8, 16 (taps from the parameter bank,
// with a runtime-M instantiation for the others) and compute every level in
// register chains: jw_level_pair (forward, select) and jw_level_adjoint
// (inverse), R + M - 1 shared reads serving R outputs.  The forward's
// leaves are most of its bytes, and a chain's outputs lie d apart, so at
// the leaf dilation d = 2^(L-1) < 32 a warp's lanes would store R d floats
// apart: the warp drops both leaves of its turn into its slice of shared
// memory and stores them as consecutive addresses (as jw_modwt_fwd_kernel
// stores W_j).  The inverse reads both leaves of a pair with batched loads
// and writes the root through a shared row, so its stores stay coalesced.
//
// Sequency order (ops/modwpt.py): the natural child c = 2p + b (b = 0 for
// the g̃ branch, 1 for h̃) of the node with sequency index p has sequency
// index c ^ ((c >> 1) & 1) = 2p + (b ^ (p & 1)).
//
// Window of a block: T outputs plus the exact halo H = (M-1)(2^L - 1), read
// as x[(p) mod N], so any N runs, halo longer than N included.  The forward
// valid region of a level-j node starts at (M-1)(2^j - 1); the inverse one
// ends (M-1)(2^L - 2^j) before the window's end.  Every level is computed
// only up to the tile's last valid sample (min(T, N - s)).

#include "common.cuh"

#define JW_SELECT_R 5  // outputs in a register chain (odd: distinct banks)
#define JW_WARPS (JW_THREADS / 32)
#define JW_PFWD_R 5  // the forward's chains (odd: distinct banks)
#define JW_PFWD_THREADS 256  // a block; four an SM at Db4 L3
// floats of leaf staging a block: both leaves of 32 chains a warp
#define JW_PFWD_SLICE (JW_PFWD_THREADS * 2 * JW_PFWD_R)
#define JW_PINV_R 5  // the inverse's chains (odd: distinct banks)
#define JW_PINV_THREADS 256
// elements of each of the next path's two leaf rows a thread holds in
// flight while the current path climbs: 9 a thread of 256 cover 2304
// samples (Db4 L3's rows at 2048-sample tiles); fewer at M = 16, whose
// chains leave fewer of the 64 registers
#define JW_PINV_PREFETCH 9
#define JW_PINV_PREFETCH_M16 4

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

// The depth-first walk of one block's tile.  rows[0] holds the input
// window on [0, end) (loaded and synchronised by the caller); row(j, b),
// 1 <= j < L, holds the b-branch child of the path's level-(j-1) node, each
// level computed by jw_level_pair in chains of R outputs.  For each
// leaf-parent q in turn, only the levels below the branch that changed from
// q - 1 are recomputed; then leaf(q, parent row) computes the leaf pair and
// synchronises before the next path overwrites the rows.
template <int MT, int R, typename Leaf>
__device__ __forceinline__ void jw_packet_walk(float* rows, int width,
                                               int end, int level, int m,
                                               const JwTaps& taps,
                                               const float* sg,
                                               const float* sh, Leaf&& leaf) {
  auto row_of = [&](int j, int b) {
    return j == 0 ? rows : rows + (size_t)(2 * j - 1 + b) * width;
  };
  for (int q = 0; q < (1 << (level - 1)); ++q) {
    // the levels below the branch that changed from q - 1
    const int j0 = q == 0 ? 0 : level - __ffs(q);
    int lo = (m - 1) * ((1 << j0) - 1);
    for (int j = j0 + 1; j < level; ++j) {
      lo += (m - 1) << (j - 1);
      const int bp = j == 1 ? 0 : (q >> (level - j)) & 1;
      float* cg = row_of(j, 0);
      float* ch = row_of(j, 1);
      jw_level_pair<MT, R>(row_of(j - 1, bp), lo, end, j - 1, m, taps, sg,
                           sh, [&](int i, float v, float w) {
                             cg[i] = v;
                             ch[i] = w;
                           });
      __syncthreads();
    }
    leaf(q, row_of(level - 1, level == 1 ? 0 : q & 1));
  }
}

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

// Block (row, tile): window x[row, (s - H + i) mod N], i in [0, end),
// end = H + min(T, N - s); the leaves' outputs at [H, end) are stored.
// Shared memory: the taps, one slice of 2 x 32 R floats a warp (both
// leaves of the warp's chains in a turn) and the walk's 2L - 1 rows of
// T + H floats.  At the leaf dilation d < 32 the chains run warp by warp
// (jw_level_pair's step hook): a warp's 32 chains of a turn cover 32 R
// consecutive window indices, dropped into its slice and stored from there
// as consecutive addresses; at d >= 32 the lanes already hold consecutive
// indices and store straight from the chains.  Every leaf value is one
// fmaf chain over k ascending from 0.f, v and w apart, so the select's
// nodes equal these bit for bit.
template <typename T, int MT>
__global__ void __launch_bounds__(JW_PFWD_THREADS, 4)
jw_modwpt_fwd_kernel(const T* __restrict__ x, T* __restrict__ out, int batch,
                     int n, int level, int m_run, int tile, int halo,
                     int ntiles, JwTaps taps) {
  extern __shared__ float smem[];
  const int m = MT > 0 ? MT : m_run;
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  const int lane = threadIdx.x & 31;
  float* slice_g = smem + 2 * JW_MAX_TAPS + (threadIdx.x >> 5) * 64 * JW_PFWD_R;
  float* slice_h = slice_g + 32 * JW_PFWD_R;
  float* rows = smem + 2 * JW_MAX_TAPS + JW_PFWD_SLICE;

  const int row = blockIdx.x / ntiles;
  const long long s = (long long)(blockIdx.x - row * ntiles) * tile;
  const long long rest = (long long)n - s;  // >= 1
  const int end = halo + (rest < tile ? (int)rest : tile);
  const long long plane = (long long)batch * n;
  // window index i <-> position s - H + i of the row
  const long long first_p = (long long)row * n + s - halo;
  const int sl = level - 1;    // the leaves' dilation 2^sl
  const bool staged = sl < 5;  // d < 32

  if (MT == 0) jw_stage_taps(taps, sg, sh, m);
  jw_load_window(x + (size_t)row * n, s - halo, n, rows, end);
  __syncthreads();

  jw_packet_walk<MT, JW_PFWD_R>(
      rows, tile + halo, end, level, m, taps, sg, sh,
      [&](int q, const float* par) {
        const int p = jw_path_seq(q, level);
        T* dg = out + ((2 * p + (p & 1)) * plane + first_p);
        T* dh = out + ((2 * p + 1 - (p & 1)) * plane + first_p);
        // the window index of the warp's first output in this turn
        int first = halo + (threadIdx.x & ~31) * JW_PFWD_R;
        jw_level_pair<MT, JW_PFWD_R>(
            par, halo, end, sl, m, taps, sg, sh,
            [&](int i, float v, float w) {
              if (staged) {
                slice_g[i - first] = v;
                slice_h[i - first] = w;
              } else {
                jw_store(dg + i, v);
                jw_store(dh + i, w);
              }
            },
            [&]() {
              if (staged) {
                __syncwarp();
#pragma unroll
                for (int k = 0; k < JW_PFWD_R; ++k) {
                  const int i = first + k * 32 + lane;
                  if (i < end) {
                    jw_store(dg + i, slice_g[k * 32 + lane]);
                    jw_store(dh + i, slice_h[k * 32 + lane]);
                  }
                }
                __syncwarp();  // the slice is read before the next emits
              }
              first += (int)blockDim.x * JW_PFWD_R;
            });
        __syncthreads();  // the next path may overwrite these rows
      });
}

// Select.  The forward kernel's depth-first walk (jw_packet_walk), in
// register chains of JW_SELECT_R outputs a thread, taps from the parameter
// bank where M is a template constant.  Every node is the forward's fmaf chain (k ascending from 0.f,
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
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  // key slots [set][leaf][warp]
  unsigned long long* slots =
      reinterpret_cast<unsigned long long*>(smem + 2 * JW_MAX_TAPS);
  float* rows = smem + 2 * JW_MAX_TAPS + 8 * JW_WARPS;
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

  jw_packet_walk<MT, JW_SELECT_R>(
      rows, tile + halo, end, level, m, taps, sg, sh,
      [&](int q, const float* par) {
        // the leaf pair: each thread's largest key of both leaves
        unsigned long long kg = 0, kh = 0;
        jw_level_pair<MT, JW_SELECT_R>(
            par, halo, end, level - 1, m, taps, sg, sh,
            [&](int i, float wg, float wh) {
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
          unsigned long long k = jw_warp_max(
              lane < JW_WARPS ? set[warp * JW_WARPS + lane] : 0ull);
          if (lane == 0) {
            const int ps = jw_path_seq(q, level);
            const int seq =
                warp == 0 ? 2 * ps + (ps & 1) : 2 * ps + 1 - (ps & 1);
            partial[(size_t)seq * plane + (size_t)row * ntiles + tix] = k;
          }
        }
      });
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

// da[i] = a[(base + i) mod n], db[i] = b[(base + i) mod n] for i in
// [0, count): jw_load_window over two rows at once, each thread issuing
// 2 JW_LOAD_BATCH device loads before it stores any.
template <typename T>
__device__ __forceinline__ void jw_load_window_pair(
    const T* __restrict__ a, const T* __restrict__ b, long long base, int n,
    float* da, float* db, int count) {
  for (int i0 = threadIdx.x; i0 < count; i0 += JW_LOAD_BATCH * blockDim.x) {
    float ta[JW_LOAD_BATCH], tb[JW_LOAD_BATCH];
#pragma unroll
    for (int u = 0; u < JW_LOAD_BATCH; ++u) {
      const int i = i0 + u * (int)blockDim.x;
      ta[u] = tb[u] = 0.f;
      if (i < count) {
        const int p = (int)jw_index(base + i, n);
        ta[u] = jw_load(a + p);
        tb[u] = jw_load(b + p);
      }
    }
#pragma unroll
    for (int u = 0; u < JW_LOAD_BATCH; ++u) {
      const int i = i0 + u * (int)blockDim.x;
      if (i < count) {
        da[i] = ta[u];
        db[i] = tb[u];
      }
    }
  }
}

// Block (row, tile): window [s, s + count + H) mod N of every leaf, count =
// min(T, N - s).  Post-order: for each leaf-parent q, its two leaves are
// loaded into the leaf rows and combined into row(L-1, b); whenever a node
// that is an h̃ child is done, both children of its parent are ready and the
// walk climbs, until a g̃ child or the root is reached.  Each climb is
// jw_level_adjoint's register chains of JW_PINV_R outputs: parent[i] =
// sum_k g[k] cg[i + k d] + h[k] ch[i + k d], k ascending from 0.f, the g̃
// term before the h̃ term.  While a path climbs, each thread has its share
// of the next path's two leaf rows in flight to registers (P elements of
// each; the rest of a longer row loads batched after the climb's first
// level), stored to the leaf rows once that level has read them.  Shared
// memory: the taps and 2L rows of T + H floats (three at L = 1).  The root
// is written to a shared row -- the g̃ leaf row, whose last read was the
// last path's first climb, or at L = 1 a third row -- and stored from there
// as consecutive addresses (from the chains, a warp's lanes would be R
// floats apart).
template <typename T, int MT>
__global__ void __launch_bounds__(JW_PINV_THREADS, 4)
jw_modwpt_inv_kernel(const T* __restrict__ c, T* __restrict__ out, int batch,
                     int n, int level, int m_run, int tile, int halo,
                     int ntiles, JwTaps taps) {
  extern __shared__ float smem[];
  const int m = MT > 0 ? MT : m_run;
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  const int width = tile + halo;
  float* leaf_g = smem + 2 * JW_MAX_TAPS;
  float* leaf_h = leaf_g + width;
  auto node = [&](int j, int b) {  // row(j, b), 1 <= j < L
    return leaf_h + (size_t)(2 * j - 1 + b) * width;
  };
  float* root = level > 1 ? leaf_g : leaf_h + width;
  const int row = blockIdx.x / ntiles;
  const long long s = (long long)(blockIdx.x - row * ntiles) * tile;
  const long long rest = (long long)n - s;  // >= 1
  const int count = rest < tile ? (int)rest : tile;
  const size_t plane = (size_t)batch * n;
  const T* crow = c + (size_t)row * n;

  if (MT == 0) jw_stage_taps(taps, sg, sh, m);
  const int paths = 1 << (level - 1);
  const int len0 = count + halo;  // the leaves' valid length
  auto src = [&](int q, int b) {   // leaf b (0: g̃, 1: h̃) of path q
    const int p = jw_path_seq(q, level);
    return crow + (size_t)(2 * p + (b ^ (p & 1))) * plane;
  };
  constexpr int P = MT == 16 ? JW_PINV_PREFETCH_M16 : JW_PINV_PREFETCH;
  for (int q = 0; q < paths; ++q) {
    if (P == 0 || q == 0) {
      jw_load_window_pair(src(q, 0), src(q, 1), s, n, leaf_g, leaf_h, len0);
      __syncthreads();
    }
    // the next path's leaves in flight to registers while this one climbs,
    // stored once the climb's first level has read the leaf rows
    const bool ahead = P > 0 && q + 1 < paths;
    float pg[P > 0 ? P : 1], ph[P > 0 ? P : 1];
    if (ahead) {
      const T* ag = src(q + 1, 0);
      const T* ah = src(q + 1, 1);
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int i = threadIdx.x + u * (int)blockDim.x;
        pg[u] = ph[u] = 0.f;
        if (i < len0) {
          const int pi = (int)jw_index(s + i, n);
          pg[u] = jw_load(ag + pi);
          ph[u] = jw_load(ah + pi);
        }
      }
    }
    // climb: level j's pair (cg, ch) -> the level-(j-1) node on the path
    const float* cg = leaf_g;
    const float* ch = leaf_h;
    int len = len0;  // valid length of the level-j rows
    for (int j = level; j >= 1; --j) {
      len -= (m - 1) << (j - 1);
      const int b = (q >> (level - j)) & 1;  // branch of the level-(j-1) node
      float* par = j == 1 ? root : node(j - 1, b);
      jw_level_adjoint<MT, JW_PINV_R>(cg, ch, 0, len, j - 1, m, taps, sg, sh,
                                      [&](int i, float y) { par[i] = y; });
      __syncthreads();
      if (ahead && j == level) {
#pragma unroll
        for (int u = 0; u < P; ++u) {
          const int i = threadIdx.x + u * (int)blockDim.x;
          if (i < len0) {
            leaf_g[i] = pg[u];
            leaf_h[i] = ph[u];
          }
        }
        const int held = P * (int)blockDim.x;
        if (len0 > held)
          jw_load_window_pair(src(q + 1, 0), src(q + 1, 1), s + held, n,
                              leaf_g + held, leaf_h + held, len0 - held);
      }
      if (j == 1) {
        T* dst = out + (size_t)row * n + s;
        for (int i = threadIdx.x; i < count; i += blockDim.x)
          jw_store(dst + i, root[i]);
      }
      if (!b) break;  // a g̃ child (or the root): its h̃ sibling comes later
      cg = node(j - 1, 0);
      ch = node(j - 1, 1);
    }
    if (ahead) __syncthreads();  // the next path's leaves before it reads them
  }
}

extern "C" {

// x (B, N) -> out (2^L, B, N), both of `dtype`, contiguous, on `device`.
// halo: (m - 1)(2^level - 1); smem: the bytes of the wrapper's plan
// (smem_bytes(level, m, 'pfwd')): the taps, the warps' leaf slices and
// 2 level - 1 rows of tile + halo.
int jw_modwpt_fwd(const void* x, void* out, int batch, int n, int level,
                  const float* g, const float* h, int m, int tile, int halo,
                  int smem, int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (tile < 1 || level < 1 || m < 1 || m > JW_MAX_TAPS ||
      halo != (m - 1) * ((1 << level) - 1) ||
      smem != (int)sizeof(float) * (2 * JW_MAX_TAPS + JW_PFWD_SLICE +
                                    (2 * level - 1) * (tile + halo)))
    return (int)cudaErrorInvalidValue;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int ntiles = (n + tile - 1) / tile;
  const long long blocks = (long long)ntiles * batch;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch_threads(
        JW_PICK_M(jw_modwpt_fwd_kernel, __nv_bfloat16, m), blocks,
        JW_PFWD_THREADS, smem, st, (const __nv_bfloat16*)x,
        (__nv_bfloat16*)out, batch, n, level, m, tile, halo, ntiles, taps);
  return jw_launch_threads(JW_PICK_M(jw_modwpt_fwd_kernel, float, m), blocks,
                           JW_PFWD_THREADS, smem, st, (const float*)x,
                           (float*)out, batch, n, level, m, tile, halo,
                           ntiles, taps);
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
// halo: (m - 1)(2^level - 1); smem: the bytes of the wrapper's plan
// (smem_bytes(level, m, 'pinv')): the taps and 2 level rows of tile + halo
// (three at level 1).
int jw_modwpt_inv(const void* c, void* out, int batch, int n, int level,
                  const float* g, const float* h, int m, int tile, int halo,
                  int smem, int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (tile < 1 || level < 1 || m < 1 || m > JW_MAX_TAPS ||
      halo != (m - 1) * ((1 << level) - 1) ||
      smem != (int)sizeof(float) * (2 * JW_MAX_TAPS +
                                    (2 * level + (level == 1)) *
                                        (tile + halo)))
    return (int)cudaErrorInvalidValue;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int ntiles = (n + tile - 1) / tile;
  const long long blocks = (long long)ntiles * batch;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch_threads(
        JW_PICK_M(jw_modwpt_inv_kernel, __nv_bfloat16, m), blocks,
        JW_PINV_THREADS, smem, st, (const __nv_bfloat16*)c,
        (__nv_bfloat16*)out, batch, n, level, m, tile, halo, ntiles, taps);
  return jw_launch_threads(JW_PICK_M(jw_modwpt_inv_kernel, float, m), blocks,
                           JW_PINV_THREADS, smem, st, (const float*)c,
                           (float*)out, batch, n, level, m, tile, halo,
                           ntiles, taps);
}

}  // extern "C"
