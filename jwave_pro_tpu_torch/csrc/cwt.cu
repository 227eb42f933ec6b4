// Fused CWT kernel for Hopper (sm_90a): the per-scale product of the signal
// spectrum with the wavelet multipliers, then the length-P inverse FFT, in
// one pass.
//
// Replaces jwave_pro_tpu/kernels/cwt_pallas.py _kernel.  The TPU kernel
// computed the inverse DFT as two stages of matrix products in a 3-pass
// bf16 split, because Mosaic offered no f32 matrix unit path; here the same
// function is an f32 inverse FFT: c[t] = (1/P) sum_k X[b, k] M[s, k]
// e^{+2 pi i k t / P}, t < n.
//
// What bounds it on the H100: device memory for the output — (B, S, n)
// complex64, or float32 when M is Hermitian in k (real-even psi-hat), is
// most of the bytes; the inputs (B, P) and (S, P) complex64 are read once
// per row, mostly from L2.  The FFT's 5 P log2 P flops a row are a small
// share of the card's f32 rate, so the design keeps the row in registers
// and touches shared memory as little as it can.
//
// Design: a row of P points is held by P/E threads, E = 8..32 complex
// values each, and transformed in two or three Stockham passes (natural
// order in and out, no bit reversal), one per factor of P: 16384 = 32 32 16,
// 8192 = 32 16 16, 4096 = 16 16 16, 2048 = 16 16 8, 1024 = 32 32,
// 512 = 32 16, 256 = 16 16, 128 = 16 8, 64 = 8 8.  Each factor is an
// R-point DFT done in registers (radix-2 butterflies, fully unrolled over
// template constants, so every register-array index is known to the
// compiler and nothing goes to the stack); between passes the row goes
// through shared memory once (at most 2 exchanges a row, 4 barriers).  The
// shared row is padded by one complex value every R1 (the first radix), so
// the first pass's stride-R1 writes and every later unit-stride access are
// free of bank conflicts.  The first pass reads X[b, k] M[s, k] straight
// from device memory (the product is fused, never stored); the last pass
// writes its outputs straight to the output, cropped to t < n and scaled by
// 1/P, complex64 or the real part only, with streaming stores (__stcs) so
// the output does not push X and M out of L2.  Twiddles come from a table
// e^{2 pi i t / P}, t < P, computed once per P on the host (float64, rounded
// once) and read through the read-only cache, two values a group and pass
// (w and w^4; the other powers are products of them).  Blocks are
// persistent: as many as the card holds at once, each looping over its
// rows, so one row's output stores drain while the next row's loads are in
// flight.  A block holds one row at P = 16384 (512 threads, 135 KB), else
// 256 threads and 256 E / P rows.

#include "common.cuh"

__device__ __forceinline__ float2 jw_cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 jw_cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 jw_csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__host__ __device__ constexpr int jw_log2(int x) {
  return x <= 1 ? 0 : 1 + jw_log2(x / 2);
}
// q < 2^bits with its bits reversed, bits <= 5; one arithmetic expression,
// so a constant q folds to a constant index (a recursive form leaves the
// index to run time and sends the register array to the stack).
__host__ __device__ constexpr int jw_bitrev(int q, int bits) {
  return (((q & 1) << 4) | ((q & 2) << 2) | (q & 4) | ((q & 8) >> 2) |
          ((q & 16) >> 4)) >> (5 - bits);
}
__host__ __device__ constexpr int jw_max3(int a, int b, int c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// e^{+2 pi i m / 32}, m < 16 (float64 values rounded once)
__device__ __forceinline__ float2 jw_w32(int m) {
  switch (m) {
    case 1: return make_float2(9.807852804e-01f, 1.950903220e-01f);
    case 2: return make_float2(9.238795325e-01f, 3.826834324e-01f);
    case 3: return make_float2(8.314696123e-01f, 5.555702330e-01f);
    case 4: return make_float2(7.071067812e-01f, 7.071067812e-01f);
    case 5: return make_float2(5.555702330e-01f, 8.314696123e-01f);
    case 6: return make_float2(3.826834324e-01f, 9.238795325e-01f);
    case 7: return make_float2(1.950903220e-01f, 9.807852804e-01f);
    case 9: return make_float2(-1.950903220e-01f, 9.807852804e-01f);
    case 10: return make_float2(-3.826834324e-01f, 9.238795325e-01f);
    case 11: return make_float2(-5.555702330e-01f, 8.314696123e-01f);
    case 12: return make_float2(-7.071067812e-01f, 7.071067812e-01f);
    case 13: return make_float2(-8.314696123e-01f, 5.555702330e-01f);
    case 14: return make_float2(-9.238795325e-01f, 3.826834324e-01f);
    case 15: return make_float2(-9.807852804e-01f, 1.950903220e-01f);
    default: return make_float2(1.f, 0.f);
  }
}

// v e^{+2 pi i m / 32}; m is a compile-time constant once the caller's
// loops are unrolled, so the branches and the table fold away.
__device__ __forceinline__ float2 jw_rot32(float2 v, int m) {
  if (m == 0) return v;
  if (m == 8) return make_float2(-v.y, v.x);
  return jw_cmul(v, jw_w32(m));
}

// In-register R-point inverse DFT (R a power of two, 2..32) of v[0, R):
// radix-2 decimation in frequency, one template level per butterfly span S
// (R/2, R/4, .. 1), so every loop has constant bounds and unrolls fully.
// The result is in bit-reversed order: X[jw_bitrev(q)] = v[q].
template <int R, int S>
struct JwDif {
  static __device__ __forceinline__ void run(float2* v) {
#pragma unroll
    for (int i = 0; i < R; i += 2 * S) {
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const float2 a = v[i + j], b = v[i + j + S];
        v[i + j] = jw_cadd(a, b);
        v[i + j + S] = jw_rot32(jw_csub(a, b), j * (16 / S));
      }
    }
    JwDif<R, S / 2>::run(v);
  }
};
template <int R>
struct JwDif<R, 0> {
  static __device__ __forceinline__ void run(float2*) {}
};

template <int R>
__device__ __forceinline__ void jw_dft(float2* v) {
  JwDif<R, R / 2>::run(v);
}

// A Stockham pass of radix R after the passes whose radices multiply to NS:
// the thread's groups are g = lt + u TR (u < E/R); group g holds
// v_q = in[g + q P/R], which is twiddled by w^q, w = W^k, k = g mod NS,
// W = e^{2 pi i / (NS R)}, and transformed; output q of the group belongs
// at (g - k) R + k + q NS.  Two table reads a group, w and w^4; the other
// powers are products of w, w^2, w^3 and (w^4)^j, at most 8 roundings
// from the table's values (a read per power would cost as many loads as
// the row itself and 2(R-1) registers).
template <int P, int R, int NS, int E, int TR>
__device__ __forceinline__ void jw_pass(float2* v, const float2* tw, int lt) {
  constexpr int STEP = P / (NS * R);  // W = e^{2 pi i STEP / P}
#pragma unroll
  for (int u = 0; u < E / R; ++u) {
    if (NS > 1) {
      const int k = (lt + u * TR) % NS;
      const float2 w1 = __ldg(tw + k * STEP);
      const float2 w2 = jw_cmul(w1, w1), w3 = jw_cmul(w2, w1);
      const float2 w4 = R > 4 ? __ldg(tw + 4 * k * STEP) : w1;
      float2 hi = w4;  // (w^4)^(q/4)
#pragma unroll
      for (int q = 1; q < R; ++q) {
        if (q > 4 && (q & 3) == 0) hi = jw_cmul(hi, w4);
        const int lo = q & 3;
        const float2 wl = lo == 1 ? w1 : (lo == 2 ? w2 : w3);
        const float2 w = q < 4 ? wl : (lo == 0 ? hi : jw_cmul(hi, wl));
        v[u * R + q] = jw_cmul(v[u * R + q], w);
      }
    }
    jw_dft<R>(v + u * R);
  }
}

// Shared-memory index of row position i: one pad slot every 2^SH values.
template <int SH>
__device__ __forceinline__ int jw_pad(int i) {
  return i + (i >> SH);
}

// The pass's inputs from the shared row: v[u R + q] = in[g + q P/R].
template <int P, int R, int E, int TR, int SH>
__device__ __forceinline__ void jw_pass_load(float2* v, const float2* buf,
                                             int lt) {
#pragma unroll
  for (int u = 0; u < E / R; ++u)
#pragma unroll
    for (int q = 0; q < R; ++q)
      v[u * R + q] = buf[jw_pad<SH>(lt + u * TR + q * (P / R))];
}

// The pass's outputs into the shared row, undoing the bit-reversed order.
template <int P, int R, int NS, int E, int TR, int SH>
__device__ __forceinline__ void jw_pass_store(const float2* v, float2* buf,
                                              int lt) {
  constexpr int LR = jw_log2(R);
#pragma unroll
  for (int u = 0; u < E / R; ++u) {
    const int g = lt + u * TR, k = g % NS;
    const int base = (g - k) * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q)
      buf[jw_pad<SH>(base + q * NS)] = v[u * R + jw_bitrev(q, LR)];
  }
}

// The last pass (NS R = P): output q of group g is c[t], t = g + q P/R.
template <int P, int R, int E, int TR>
__device__ __forceinline__ void jw_pass_out(const float2* v, void* out,
                                            long long row, int n, int is_real,
                                            int lt, bool live) {
  constexpr int LR = jw_log2(R);
  if (!live) return;
  const float scale = 1.f / (float)P;
  const size_t at = (size_t)row * n;
#pragma unroll
  for (int u = 0; u < E / R; ++u)
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int t = lt + u * TR + q * (P / R);
      if (t >= n) continue;
      const float2 c = v[u * R + jw_bitrev(q, LR)];
      if (is_real)
        __stcs((float*)out + at + t, c.x * scale);
      else
        __stcs((float2*)out + at + t, make_float2(c.x * scale, c.y * scale));
    }
}

// P = R1 R2 R3 (R3 = 1: two passes); T threads a block.
template <int P, int R1, int R2, int R3, int T>
__global__ void __launch_bounds__(T)
jw_cwt_ifft_kernel(const float2* __restrict__ x,
                   const float2* __restrict__ mult,
                   const float2* __restrict__ tw, void* __restrict__ out,
                   long long rows, int S, int n, int is_real) {
  constexpr int E = jw_max3(R1, R2, R3);  // complex values a thread
  constexpr int TR = P / E;               // threads a row
  constexpr int ROWS = T / TR;            // rows a block
  constexpr int SH = jw_log2(R1);
  constexpr int LEN = P + (P >> SH);      // a padded row in shared memory
  static_assert(ROWS >= 1 && ROWS * TR == T, "bad CWT plan");
  extern __shared__ float2 jw_fft_buf[];
  const int lt = threadIdx.x % TR;
  float2* buf = jw_fft_buf + (threadIdx.x / TR) * LEN;
  for (long long row0 = (long long)blockIdx.x * ROWS; row0 < rows;
       row0 += (long long)gridDim.x * ROWS) {
    const long long row = row0 + threadIdx.x / TR;
    const bool live = row < rows;
    const long long src = live ? row : rows - 1;  // a dead row loads, never stores
    const float2* xr = x + (size_t)(src / S) * P;
    const float2* mr = mult + (size_t)(src % S) * P;
    float2 v[E];
#pragma unroll
    for (int u = 0; u < E / R1; ++u)
#pragma unroll
      for (int q = 0; q < R1; ++q) {
        const int k = lt + u * TR + q * (P / R1);
        v[u * R1 + q] = jw_cmul(__ldg(xr + k), __ldg(mr + k));
      }
    jw_pass<P, R1, 1, E, TR>(v, tw, lt);
    __syncthreads();  // the previous row's last shared reads are done
    jw_pass_store<P, R1, 1, E, TR, SH>(v, buf, lt);
    __syncthreads();
    jw_pass_load<P, R2, E, TR, SH>(v, buf, lt);
    jw_pass<P, R2, R1, E, TR>(v, tw, lt);
    if constexpr (R3 > 1) {
      __syncthreads();  // every read of this pass before any write
      jw_pass_store<P, R2, R1, E, TR, SH>(v, buf, lt);
      __syncthreads();
      jw_pass_load<P, R3, E, TR, SH>(v, buf, lt);
      jw_pass<P, R3, R1 * R2, E, TR>(v, tw, lt);
      jw_pass_out<P, R3, E, TR>(v, out, row, n, is_real, lt, live);
    } else {
      jw_pass_out<P, R2, E, TR>(v, out, row, n, is_real, lt, live);
    }
  }
}

// Persistent launch: as many blocks as the card holds at once, at most one
// per group of rows.
template <int P, int R1, int R2, int R3, int T>
static int jw_cwt_launch(const float2* x, const float2* mult,
                         const float2* tw, void* out, long long rows, int S,
                         int n, int is_real, int device, cudaStream_t st) {
  constexpr int E = jw_max3(R1, R2, R3);
  constexpr int ROWS = T / (P / E);
  constexpr int LEN = P + (P >> jw_log2(R1));
  const int smem = (int)sizeof(float2) * ROWS * LEN;
  auto kernel = jw_cwt_ifft_kernel<P, R1, R2, R3, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T,
                                                      smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long blocks = (rows + ROWS - 1) / ROWS;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  kernel<<<(unsigned)blocks, T, smem, st>>>(x, mult, tw, out, rows, S, n,
                                            is_real);
  return (int)cudaGetLastError();
}

extern "C" {

// x (B, P) and mult (S, P) complex64, tw (P,) complex64 = e^{2 pi i t / P}
// -> out (B, S, n) complex64, or float32 (the real part) when is_real; P a
// power of two in [64, 16384], n <= P.
int jw_cwt_ifft(const void* x, const void* mult, const void* tw, void* out,
                int batch, int S, int P, int n, int is_real, int device,
                void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)batch * S;
  const float2* xf = (const float2*)x;
  const float2* mf = (const float2*)mult;
  const float2* tf = (const float2*)tw;
  cudaStream_t st = (cudaStream_t)stream;
  switch (P) {
    case 64:
      return jw_cwt_launch<64, 8, 8, 1, 256>(xf, mf, tf, out, rows, S, n,
                                             is_real, device, st);
    case 128:
      return jw_cwt_launch<128, 16, 8, 1, 256>(xf, mf, tf, out, rows, S, n,
                                               is_real, device, st);
    case 256:
      return jw_cwt_launch<256, 16, 16, 1, 256>(xf, mf, tf, out, rows, S, n,
                                                is_real, device, st);
    case 512:
      return jw_cwt_launch<512, 32, 16, 1, 256>(xf, mf, tf, out, rows, S, n,
                                                is_real, device, st);
    case 1024:
      return jw_cwt_launch<1024, 32, 32, 1, 256>(xf, mf, tf, out, rows, S, n,
                                                 is_real, device, st);
    case 2048:
      return jw_cwt_launch<2048, 16, 16, 8, 256>(xf, mf, tf, out, rows, S, n,
                                                 is_real, device, st);
    case 4096:
      return jw_cwt_launch<4096, 16, 16, 16, 256>(xf, mf, tf, out, rows, S,
                                                  n, is_real, device, st);
    case 8192:
      return jw_cwt_launch<8192, 32, 16, 16, 256>(xf, mf, tf, out, rows, S,
                                                  n, is_real, device, st);
    case 16384:
      return jw_cwt_launch<16384, 32, 32, 16, 512>(xf, mf, tf, out, rows, S,
                                                   n, is_real, device, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
