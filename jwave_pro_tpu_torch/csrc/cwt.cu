// Fused CWT kernel for Hopper (sm_90a): the per-scale product of the signal
// spectrum with the wavelet multipliers, then the length-P inverse FFT, in
// one pass.
//
// Replaces jwave_pro_tpu/kernels/cwt_pallas.py _kernel.  The TPU kernel
// computed the inverse DFT as two stages of matrix products in a 3-pass
// bf16 split, because Mosaic offered no f32 matrix unit path; here the same
// function is a shared-memory f32 inverse FFT: c[t] = (1/P) sum_k X[b, k]
// M[s, k] e^{+2 pi i k t / P}, t < n.
//
// What bounds it on the H100: device memory for the output — (B, S, n)
// complex64, or float32 when M is Hermitian in k (real-even psi-hat), is
// most of the bytes; the inputs (B, P) and (S, P) complex64 are read once
// per row from L2.  The FFT does 5 P log2 P flops a row in shared memory:
// log4 P passes (one radix-2 pass first when log2 P is odd) that each read
// and write the row once.
//
// Design: one block of 512 threads per row (b, s), or per P/4096 rows when
// P < 4096, so a block always holds 4096..16384 complex values.  The passes
// are Stockham (self-sorting: natural order in and out, no bit reversal),
// done in place: each thread loads its E/R radix-R groups into registers,
// the block synchronises, and the thread writes them back, so one P-point
// row (128 KB at P = 16384) plus a quarter-wave twiddle table (32 KB) fit
// the 227 KB.  The first pass reads X[b, k] M[s, k] straight from device
// memory (the product is fused, never stored); the last pass writes its
// results straight into the output, cropped to t < n and scaled by 1/P,
// complex64 interleaved or, for a real-output wavelet, the real part only.
// Twiddles: e^{2 pi i t / P} for t < P/4 by sincospif (full precision),
// once per block; a radix-4 group squares and multiplies its w1 for w2, w3.

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

// One in-place Stockham pass of radix R over the block's rows (row r of
// the block at buf + r P).  Group j of a row reads v_q = in[j + q P/R],
// multiplies by e^{2 pi i q k / (Ns R)} (k = j mod Ns), takes the R-point
// inverse DFT and writes out[(j - k) R + k + q Ns].  `first`: the inputs
// are X[b, k] M[s, k] from device memory; `last`: the outputs go to `out`.
template <int R, int E>
__device__ __forceinline__ void jw_fft_pass(
    float2* buf, const float2* tw, const float2* __restrict__ x,
    const float2* __restrict__ mult, void* out, int P, int Ns, int S,
    long long row0, int rows, int n, int is_real, bool first, bool last) {
  constexpr int G = E / R;  // groups per thread
  const int quarter = P / R;
  float2 v[G][R];
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int g = threadIdx.x + u * JW_THREADS;
    const int r = g / quarter, j = g - r * quarter;
    if (r >= rows) continue;
    if (first) {
      const long long row = row0 + r;
      const float2* xr = x + (size_t)(row / S) * P;
      const float2* mr = mult + (size_t)(row % S) * P;
#pragma unroll
      for (int q = 0; q < R; ++q)
        v[u][q] = jw_cmul(__ldg(xr + j + q * quarter),
                          __ldg(mr + j + q * quarter));
    } else {
#pragma unroll
      for (int q = 0; q < R; ++q) v[u][q] = buf[r * P + j + q * quarter];
    }
    if (R == 4) {
      if (Ns > 1) {
        const int k = j & (Ns - 1);
        const float2 w1 = tw[k * (P / (4 * Ns))];
        const float2 w2 = jw_cmul(w1, w1);
        const float2 w3 = jw_cmul(w1, w2);
        v[u][1] = jw_cmul(v[u][1], w1);
        v[u][2] = jw_cmul(v[u][2], w2);
        v[u][3] = jw_cmul(v[u][3], w3);
      }
      const float2 b0 = jw_cadd(v[u][0], v[u][2]);
      const float2 b1 = jw_csub(v[u][0], v[u][2]);
      const float2 b2 = jw_cadd(v[u][1], v[u][3]);
      const float2 d = jw_csub(v[u][1], v[u][3]);
      const float2 b3 = make_float2(-d.y, d.x);  // +i (a1 - a3)
      v[u][0] = jw_cadd(b0, b2);
      v[u][1] = jw_cadd(b1, b3);
      v[u][2] = jw_csub(b0, b2);
      v[u][3] = jw_csub(b1, b3);
    } else {  // radix 2, only ever the first pass (Ns = 1: no twiddle)
      const float2 a = v[u][0];
      v[u][0] = jw_cadd(a, v[u][1]);
      v[u][1] = jw_csub(a, v[u][1]);
    }
  }
  __syncthreads();  // every read of this pass before any write
  const float scale = 1.f / (float)P;
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int g = threadIdx.x + u * JW_THREADS;
    const int r = g / quarter, j = g - r * quarter;
    if (r >= rows) continue;
    const int k = j & (Ns - 1);
    const int base = (j - k) * R + k;
    if (last) {  // Ns = P / R: base = j, outputs t = j + q Ns
      const size_t at = (size_t)(row0 + r) * n;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int t = base + q * Ns;
        if (t >= n) continue;
        if (is_real)
          ((float*)out)[at + t] = v[u][q].x * scale;
        else
          ((float2*)out)[at + t] =
              make_float2(v[u][q].x * scale, v[u][q].y * scale);
      }
    } else {
#pragma unroll
      for (int q = 0; q < R; ++q) buf[r * P + base + q * Ns] = v[u][q];
    }
  }
  __syncthreads();
}

// E complex values per thread: a block holds E x 512 / P rows.
template <int E>
__global__ void __launch_bounds__(JW_THREADS)
jw_cwt_ifft_kernel(const float2* __restrict__ x,
                   const float2* __restrict__ mult, void* __restrict__ out,
                   int batch, int S, int P, int n, int is_real) {
  extern __shared__ float2 jw_fft_smem[];
  float2* tw = jw_fft_smem;     // e^{2 pi i t / P}, t < P/4
  float2* buf = tw + P / 4;     // the block's rows
  const int rpb = E * JW_THREADS / P;
  const long long row0 = (long long)blockIdx.x * rpb;
  const long long left = (long long)batch * S - row0;
  const int rows = left < rpb ? (int)left : rpb;
  for (int t = threadIdx.x; t < P / 4; t += JW_THREADS) {
    float s, c;
    sincospif(2.f * (float)t / (float)P, &s, &c);
    tw[t] = make_float2(c, s);
  }
  __syncthreads();
  const int logp = __ffs(P) - 1;
  const int passes = (logp + 1) / 2;
  int p = 0, ns = 1;
  if (logp & 1) {
    jw_fft_pass<2, E>(buf, tw, x, mult, out, P, 1, S, row0, rows, n,
                      is_real, true, passes == 1);
    p = 1;
    ns = 2;
  }
  for (; p < passes; ++p, ns *= 4)
    jw_fft_pass<4, E>(buf, tw, x, mult, out, P, ns, S, row0, rows, n,
                      is_real, p == 0, p == passes - 1);
}

extern "C" {

// x (B, P) and mult (S, P) complex64 -> out (B, S, n) complex64, or float32
// (the real part) when is_real; P a power of two in [64, 16384], n <= P.
int jw_cwt_ifft(const void* x, const void* mult, void* out, int batch, int S,
                int P, int n, int is_real, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int E = P >= 16384 ? 32 : (P >= 8192 ? 16 : 8);
  const int rpb = E * JW_THREADS / P;
  const long long blocks = ((long long)batch * S + rpb - 1) / rpb;
  const int smem = (int)sizeof(float2) * (P / 4 + rpb * P);
  cudaStream_t st = (cudaStream_t)stream;
  const float2* xf = (const float2*)x;
  const float2* mf = (const float2*)mult;
  if (E == 32)
    return jw_launch(jw_cwt_ifft_kernel<32>, blocks, smem, st, xf, mf, out,
                     batch, S, P, n, is_real);
  if (E == 16)
    return jw_launch(jw_cwt_ifft_kernel<16>, blocks, smem, st, xf, mf, out,
                     batch, S, P, n, is_real);
  return jw_launch(jw_cwt_ifft_kernel<8>, blocks, smem, st, xf, mf, out,
                   batch, S, P, n, is_real);
}

}  // extern "C"
