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
// it; the select writes nothing per sample and is bound by the cascade's
// shared-memory loads (2·M per node and sample).  Shared memory is the
// design constraint: done breadth-first, as on the TPU, a block would keep
// 3·2^(L-1) node rows, and Db4 L4 would no longer fit a block at any
// useful tile.  So each block walks its tile's tree depth-first and keeps
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

#include <climits>

#include "common.cuh"

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

// Keep (a, v, p) or take (a2, v2, p2): the larger |w| wins, a tie goes to
// the smaller position, so any reduction order picks the same element.
__device__ __forceinline__ void jw_best_merge(float& a, float& v, int& p,
                                              float a2, float v2, int p2) {
  if (a2 > a || (a2 == a && p2 < p)) {
    a = a2;
    v = v2;
    p = p2;
  }
}

__device__ __forceinline__ void jw_warp_best(float& a, float& v, int& p) {
  for (int o = 16; o > 0; o >>= 1) {
    const float a2 = __shfl_down_sync(0xffffffffu, a, o);
    const float v2 = __shfl_down_sync(0xffffffffu, v, o);
    const int p2 = __shfl_down_sync(0xffffffffu, p, o);
    jw_best_merge(a, v, p, a2, v2, p2);
  }
}

// Leaf sink of the select kernel: each thread keeps the best |w| of both
// leaves over its positions (visited in increasing order, so a strict > keeps
// the first of equal values); end() reduces them over the block and thread 0
// writes the tile's (|w|, w, position) per leaf.
struct JwLeafSelect {
  float* absmax;
  float* value;
  int* pos;
  size_t plane, off;  // B·tiles, row·tiles + tile
  long long base;
  int n;
  float* scratch;  // 6 · JW_THREADS / 32 words
  int seq[2];
  float a[2], v[2];
  int p[2];
  __device__ void begin(int seq_g, int seq_h) {
    seq[0] = seq_g;
    seq[1] = seq_h;
    for (int c = 0; c < 2; ++c) {
      a[c] = -1.f;
      v[c] = 0.f;
      p[c] = INT_MAX;
    }
  }
  __device__ void leaf(int i, float wg, float wh) {
    const long long q = base + i;
    if (q >= n) return;
    const float ag = fabsf(wg), ah = fabsf(wh);
    if (ag > a[0]) {
      a[0] = ag;
      v[0] = wg;
      p[0] = (int)q;
    }
    if (ah > a[1]) {
      a[1] = ah;
      v[1] = wh;
      p[1] = (int)q;
    }
  }
  __device__ void end() {
    constexpr int nw = JW_THREADS / 32;
    float* sa = scratch;
    float* sv = scratch + 2 * nw;
    int* sp = (int*)(scratch + 4 * nw);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int c = 0; c < 2; ++c) {
      jw_warp_best(a[c], v[c], p[c]);
      if (lane == 0) {
        sa[c * nw + warp] = a[c];
        sv[c * nw + warp] = v[c];
        sp[c * nw + warp] = p[c];
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int c = 0; c < 2; ++c) {
        float ba = sa[c * nw], bv = sv[c * nw];
        int bp = sp[c * nw];
        for (int w = 1; w < nw; ++w)
          jw_best_merge(ba, bv, bp, sa[c * nw + w], sv[c * nw + w],
                        sp[c * nw + w]);
        const size_t o = (size_t)seq[c] * plane + off;
        absmax[o] = ba;
        value[o] = bv;
        pos[o] = bp;
      }
    }
  }
};

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

// Block (row, tile): the forward kernel's cascade; per leaf, the tile's best
// (|w|, w, position) goes to [seq][row][tile] of the three partial arrays.
template <typename T>
__global__ void __launch_bounds__(JW_THREADS)
jw_modwpt_select_kernel(const T* __restrict__ x, float* __restrict__ absmax,
                        float* __restrict__ value, int* __restrict__ pos,
                        int batch, int n, int level, int m, int tile,
                        int halo, int ntiles, JwTaps taps) {
  extern __shared__ float smem[];
  float* sg = smem;
  float* sh = smem + JW_MAX_TAPS;
  float* scratch = smem + 2 * JW_MAX_TAPS;
  float* rows = scratch + 6 * (JW_THREADS / 32);
  const int width = tile + halo;
  const int row = blockIdx.x / ntiles;
  const int tix = blockIdx.x - row * ntiles;
  const long long base = (long long)tix * tile - halo;
  const T* xr = x + (size_t)row * n;

  jw_stage_taps(taps, sg, sh, m);
  for (int i = threadIdx.x; i < width; i += blockDim.x)
    rows[i] = jw_load(xr + jw_index(base + i, n));
  __syncthreads();

  JwLeafSelect sink;
  sink.absmax = absmax;
  sink.value = value;
  sink.pos = pos;
  sink.plane = (size_t)batch * ntiles;
  sink.off = (size_t)row * ntiles + tix;
  sink.base = base;
  sink.n = n;
  sink.scratch = scratch;
  jw_packet_forward(rows, width, level, m, halo, sg, sh, sink);
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

// x (B, N) of `dtype` -> absmax, value (float32) and pos (int32), each
// (2^L, B, ceil(N / tile)): per leaf and tile, the best |w| and its w and
// signal position.
int jw_modwpt_select(const void* x, float* absmax, float* value, int* pos,
                     int batch, int n, int level, const float* g,
                     const float* h, int m, int tile, int halo, int smem,
                     int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const JwTaps taps = jw_make_taps(g, h, m);
  const int ntiles = (n + tile - 1) / tile;
  const long long blocks = (long long)ntiles * batch;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == JW_BF16)
    return jw_launch(jw_modwpt_select_kernel<__nv_bfloat16>, blocks, smem, st,
                     (const __nv_bfloat16*)x, absmax, value, pos, batch, n,
                     level, m, tile, halo, ntiles, taps);
  return jw_launch(jw_modwpt_select_kernel<float>, blocks, smem, st,
                   (const float*)x, absmax, value, pos, batch, n, level, m,
                   tile, halo, ntiles, taps);
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
