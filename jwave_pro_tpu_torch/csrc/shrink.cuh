// The denoise's shrink as the inverses that read it apply it: the 1D
// inverse (modwt_inv.cuh, #3s) and the 2D inverse (modwt2_inv.cuh, #10s)
// shrink each detail value as they load it.  Not common.cuh's jw_shrink,
// the fused denoisers' rule, which rounds nothing.
#pragma once

#include "common.cuh"

// How an inverse treats the detail values it loads: as they are (#3,
// #10), or shrunk by ops/denoise.py's soft or hard rule.
enum JwShrink { JW_KEEP = 0, JW_SOFT = 1, JW_HARD = 2 };

// A detail value w shrunk by t as torch computes _shrunk on the card, bit
// for bit: soft sign(w) * clamp_min(|w| - t, 0), with sign(0) = sign(NaN)
// = 0, clamp_min passing NaN on and the difference rounded to T first
// (torch's bfloat16 subtraction rounds its result; sign and clamp are
// exact); hard |w| > t ? w : 0.  sign(w) * a is copysign(a, w) where w is
// neither 0 nor NaN (-1 times +0 is -0), and a real 0 * a elsewhere (NaN
// where a is NaN or inf): fewer instructions a value than a product with
// a computed sign.
template <typename T, int SHRINK>
struct JwCut {
  float t;
  __device__ __forceinline__ float operator()(float w) const {
    if (SHRINK == JW_HARD) return fabsf(w) > t ? w : 0.f;
    float a = fabsf(w) - t;
    if (std::is_same<T, __nv_bfloat16>::value)
      a = __bfloat162float(__float2bfloat16_rn(a));
    a = a <= 0.f ? 0.f : a;
    return fabsf(w) > 0.f ? copysignf(a, w) : 0.f * a;
  }
};
