// Exact per-row median of float32 rows by radix select, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package takes the denoise threshold's
// median with jnp.median, which sorts.  The exact selection it models is the
// JAX package's median_select (jwave_pro_tpu/ops/financial.py): the k-th
// order key, and for an even count the second middle from the tie count
// or, where the middles split, the smallest key above the first.  The port
// took this median with torch.sort of the whole row, index arrays and all,
// only to read two values of it.
//
// The result is bitwise the sort's (ops/denoise.py:_sort_median): the
// midpoint (lo + hi) * 0.5 in float32 for every count (lo == hi for an odd
// one), NaN (0x7fc00000) for a row that holds a NaN.  Signed zeros aside:
// order keys put -0 below +0, as median_select does, where the sort treats
// them as equal and may return either at the middle.  Over |x| no -0 exists.
//
// What bounds it on the H100: device memory.  Each pass reads the row once
// and does a compare and at most one shared-memory atomic per element; the
// floor is one read of the rows.  So the kernel:
//
// * maps each float to its order key (sign set for positives, all bits
//   flipped for negatives, so unsigned order is float order), with |x|
//   folded into the load where the flag asks, and takes the key's digits
//   from the top, 11/11/10 bits: three passes, each a 2048-bin histogram
//   in shared memory of the keys whose higher digits equal the row's
//   prefix so far;
// * finds the NaN flag in the first pass and both middles in the same
//   passes.  Where they split, the first middle is the last key of its
//   bucket and the second the smallest key above that bucket, taken as a
//   maximum of complements in the next pass (or read off the histogram in
//   the last);
// * splits each row over `parts` blocks, enough to fill the SMs at 16 rows;
//   each flushes its histogram into the row's scratch with atomics, and the
//   row's last block to finish (an atomic ticket after __threadfence, as
//   in variance.cu) scans it, writes the row's next prefix and residual
//   rank, and leaves the scratch and its ticket zero.  So a call is three
//   launches with no host synchronisation and no memset; with one block a
//   row (many or short rows) the block runs all three passes in one launch
//   and needs no scratch;
// * reads with 16-byte loads, two in flight a thread and four blocks of
//   512 threads an SM (31 registers a thread): each pass is a stream of
//   loads, and what holds it below the bandwidth is the bytes in flight
//   (unrolling four or eight loads deep cost registers, hence blocks an
//   SM, and was slower); and walks the blocks in reverse order in the
//   middle pass, so that it starts on what the first pass left in L2.

#include "common.cuh"

#define JW_MED_BINS 2048
#define JW_MED_PASSES 3
#define JW_MED_UNROLL 2  // float4 loads in flight a thread
// a row of the scratch: the bins, the NaN count, the largest complement
#define JW_MED_SLOTS (JW_MED_BINS + 2)
#define JW_MED_WARPS (JW_THREADS / 32)

// a row's state between passes: the first middle's key prefix (the digits
// found so far), its rank among the keys under that prefix, the second
// middle's mode and its aux (PENDING: the top key of the first middle's
// bucket; DONE: the second middle's key), and the NaN flag
enum JwMedMode { JW_MED_SAME = 0, JW_MED_PENDING = 1, JW_MED_DONE = 2 };
struct JwMedState {
  unsigned prefix, rank, mode, aux, has_nan;
};

template <int ABS>
__device__ __forceinline__ unsigned jw_med_key(float v) {
  const unsigned u = __float_as_uint(v);
  if (ABS) return u | 0x80000000u;  // |v| with the key's sign bit
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float jw_med_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// digits of pass p: bits [shift, shift + width) of the key
__device__ __forceinline__ int jw_med_shift(int p) {
  return p == 0 ? 21 : (p == 1 ? 10 : 0);
}
__device__ __forceinline__ int jw_med_width(int p) { return p == 2 ? 10 : 11; }

// x (rows, n) float32, contiguous.  Block b of the launch takes part
// b mod parts of row b / parts (b counted from the end in pass 1 of a
// multi-block row).  Runs passes [p0, p1).  state: (rows, 5) unsigned,
// written by a pass's last block for the next; scratch: (rows, SLOTS) and
// ticket (rows) unsigned, zero on entry and on exit, only read where
// parts > 1.  out: (rows,) float32, written in the last pass.
template <int ABS>
__global__ void __launch_bounds__(JW_THREADS, 4)
jw_median_kernel(const float* __restrict__ x, JwMedState* __restrict__ state,
                 unsigned* __restrict__ scratch, unsigned* __restrict__ ticket,
                 float* __restrict__ out, int n, int parts, int p0, int p1) {
  __shared__ unsigned hist[JW_MED_BINS];
  __shared__ unsigned warp_sums[JW_MED_WARPS];
  __shared__ JwMedState st;
  __shared__ unsigned nan_count, big, b1, below1, b2;
  __shared__ int last_block;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const int blk = (p0 == 1) ? (int)gridDim.x - 1 - (int)blockIdx.x
                            : (int)blockIdx.x;
  const int row = blk / parts;
  const int part = blk - row * parts;
  const float* xr = x + (size_t)row * n;
  // the row's 16-byte-aligned body, split over the parts; the few
  // elements before and after it go to part 0
  const int head =
      min(n, (int)(((16u - ((unsigned)(size_t)xr & 15u)) & 15u) >> 2));
  const long long nvec = (long long)(n - head) >> 2;
  const int rest = n - head - (int)(nvec << 2);
  const float4* xv = reinterpret_cast<const float4*>(xr + head);
  const long long v0 = nvec * part / parts;
  const long long v1 = nvec * (part + 1) / parts;
  const unsigned k1 = (unsigned)(n - 1) >> 1;
  const unsigned d = (n & 1) ? 0u : 1u;  // rank of the second middle - k1

  for (int p = p0; p < p1; ++p) {
    const int s = jw_med_shift(p), w = jw_med_width(p);
    for (int i = threadIdx.x; i < JW_MED_BINS; i += blockDim.x) hist[i] = 0u;
    if (threadIdx.x == 0) {
      if (p == 0) {
        st = JwMedState{0u, k1, JW_MED_SAME, 0u, 0u};
      } else if (p == p0) {  // the previous launch's; else this block's
        const unsigned* sp = reinterpret_cast<const unsigned*>(state + row);
        st = JwMedState{__ldcg(sp), __ldcg(sp + 1), __ldcg(sp + 2),
                        __ldcg(sp + 3), __ldcg(sp + 4)};
      }
      nan_count = 0u;
      big = 0u;
    }
    __syncthreads();

    const unsigned prefix = st.prefix, lim = st.aux;
    const bool pending = st.mode == JW_MED_PENDING;
    const int hs = s + w;  // 32 in pass 0, where every key counts
    const unsigned mask = (1u << w) - 1u;
    unsigned saw_nan = 0u, top = 0u;  // top: the largest ~key above lim
    auto count = [&](float v) {
      const unsigned k = jw_med_key<ABS>(v);
      if (p == 0) {
        saw_nan |= (unsigned)(v != v);
        atomicAdd(&hist[k >> 21], 1u);
      } else if ((k >> hs) == prefix) {
        atomicAdd(&hist[(k >> s) & mask], 1u);
      }
      if (pending && k > lim) top = max(top, ~k);
    };

    for (long long i = v0 + threadIdx.x; i < v1;
         i += JW_MED_UNROLL * (long long)blockDim.x) {
      float4 t[JW_MED_UNROLL];
#pragma unroll
      for (int u = 0; u < JW_MED_UNROLL; ++u) {
        const long long j = i + u * (long long)blockDim.x;
        if (j < v1) t[u] = xv[j];
      }
#pragma unroll
      for (int u = 0; u < JW_MED_UNROLL; ++u) {
        if (i + u * (long long)blockDim.x < v1) {
          count(t[u].x);
          count(t[u].y);
          count(t[u].z);
          count(t[u].w);
        }
      }
    }
    if (part == 0) {
      if ((int)threadIdx.x < head) count(xr[threadIdx.x]);
      else if ((int)threadIdx.x < head + rest)
        count(xr[head + (nvec << 2) + (threadIdx.x - head)]);
    }
    saw_nan = __reduce_or_sync(0xffffffffu, saw_nan);
    top = __reduce_max_sync(0xffffffffu, top);
    if (lane == 0) {
      if (saw_nan) atomicAdd(&nan_count, 1u);
      if (top) atomicMax(&big, top);
    }
    __syncthreads();

    if (parts > 1) {
      // flush into the row's scratch; the row's last block takes the sums
      unsigned* sr = scratch + (size_t)row * JW_MED_SLOTS;
      for (int i = threadIdx.x; i < JW_MED_BINS; i += blockDim.x)
        if (hist[i]) atomicAdd(sr + i, hist[i]);
      if (threadIdx.x == 0) {
        if (nan_count) atomicAdd(sr + JW_MED_BINS, nan_count);
        if (big) atomicMax(sr + JW_MED_BINS + 1, big);
      }
      __threadfence();  // visible to the row's last block before the ticket
      __syncthreads();
      if (threadIdx.x == 0)
        last_block = atomicAdd(ticket + row, 1u) == (unsigned)(parts - 1);
      __syncthreads();
      if (!last_block) return;
      __threadfence();
      for (int i = threadIdx.x; i < JW_MED_BINS; i += blockDim.x) {
        hist[i] = __ldcg(sr + i);
        sr[i] = 0u;
      }
      if (threadIdx.x == 0) {
        nan_count = __ldcg(sr + JW_MED_BINS);
        big = __ldcg(sr + JW_MED_BINS + 1);
        sr[JW_MED_BINS] = sr[JW_MED_BINS + 1] = 0u;
        ticket[row] = 0u;
      }
      __syncthreads();
    }

    // the buckets of ranks q1 = rank and, while the middles share a bucket,
    // q2 = rank + d: each thread holds 4 consecutive bins; an exclusive
    // scan of the threads' sums finds the thread whose bins hold each rank
    const unsigned q1 = st.rank, q2 = st.rank + d;
    const bool find2 = st.mode == JW_MED_SAME;
    const int per = JW_MED_BINS / JW_THREADS;
    unsigned c[JW_MED_BINS / JW_THREADS], sum = 0u;
#pragma unroll
    for (int j = 0; j < per; ++j) {
      c[j] = hist[threadIdx.x * per + j];
      sum += c[j];
    }
    unsigned incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    unsigned base = 0u;
    for (int j = 0; j < warp; ++j) base += warp_sums[j];
    unsigned below = base + incl - sum;
#pragma unroll
    for (int j = 0; j < per; ++j) {
      const unsigned bin = threadIdx.x * per + j;
      if (q1 >= below && q1 - below < c[j]) {
        b1 = bin;
        below1 = below;
      }
      if (find2 && q2 >= below && q2 - below < c[j]) b2 = bin;
      below += c[j];
    }
    __syncthreads();

    if (threadIdx.x == 0) {
      JwMedState nx = st;
      nx.prefix = (st.prefix << w) | b1;
      nx.rank = st.rank - below1;
      if (p == 0) nx.has_nan = nan_count != 0u;
      if (st.mode == JW_MED_PENDING) {
        nx.mode = JW_MED_DONE;
        nx.aux = ~big;  // the smallest key above the first middle's bucket
      } else if (st.mode == JW_MED_SAME && d && b2 != b1) {
        if (s == 0) {  // the last digit: the bucket is the key
          nx.mode = JW_MED_DONE;
          nx.aux = (st.prefix << w) | b2;
        } else {
          nx.mode = JW_MED_PENDING;
          nx.aux = (nx.prefix << s) | ((1u << s) - 1u);
        }
      }
      if (p == JW_MED_PASSES - 1) {
        const float lo = jw_med_value(nx.prefix);
        const float hi = jw_med_value(nx.mode == JW_MED_DONE ? nx.aux
                                                             : nx.prefix);
        out[row] = nx.has_nan ? __uint_as_float(0x7fc00000u)
                          : __fmul_rn(__fadd_rn(lo, hi), 0.5f);
      } else if (p + 1 == p1) {
        state[row] = nx;  // for the next launch
      }
      st = nx;  // every thread has read st: the barrier above
    }
    __syncthreads();  // the next pass zeroes hist and reads st
  }
}

extern "C" {

// x (rows, n) float32, contiguous, on `device` -> out (rows,) float32
// medians of x's rows (of |x| for absolute != 0).  state: rows x 5
// unsigned of scratch; scratch (rows x (2048 + 2)) and ticket (rows)
// unsigned, all zero, and zero again when the call ends (read only for
// parts > 1).  parts: blocks a row.  Three launches for parts > 1, one
// otherwise; nothing synchronises.
int jw_median(const float* x, void* state, unsigned* scratch,
              unsigned* ticket, float* out, int rows, int n, int parts,
              int absolute, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (rows < 1 || n < 1 || parts < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)rows * parts;
  cudaStream_t st = (cudaStream_t)stream;
  auto kernel = absolute ? jw_median_kernel<1> : jw_median_kernel<0>;
  JwMedState* s = (JwMedState*)state;
  if (parts == 1)
    return jw_launch(kernel, blocks, 0, st, x, s, scratch, ticket, out, n,
                     parts, 0, JW_MED_PASSES);
  for (int p = 0; p < JW_MED_PASSES; ++p) {
    const int code = jw_launch(kernel, blocks, 0, st, x, s, scratch, ticket,
                               out, n, parts, p, p + 1);
    if (code) return code;
  }
  return 0;
}

}  // extern "C"
