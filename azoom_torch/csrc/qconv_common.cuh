// What the two int8 3x3 conv kernels (csrc/qconv_kernel.cu on wgmma,
// csrc/qconv_mma_kernel.cu on mma.sync) must do alike bit for bit: the
// activation quantisation and the float32 epilogue. Every int8 code of the
// next layer is a rounding of this output, so the two kernels share the
// code, not a description of it.
//
// s1 = act_scale * w_scale and b1 = conv bias dequantise; mean, mul =
// gamma / sqrt(var + eps) and beta are the inference BatchNorm (0, 1, 0 for
// a bare conv). The epilogue keeps the reference's order of float32
// operations (QConv's dequant, then flax's BatchNorm) instead of folding it
// into one affine: a one-ulp difference here flips codes, and over the 21
// convs of the mask net the flips compound (tests/test_torch_tpufpu.py: a
// folded affine moves the bundled net's mask by 5e-2 against the reference,
// this order by 2e-7). The quantisation is clip(rint(IEEE v / s)),
// round-half-to-even as jnp.round; never build with --use_fast_math.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace azt {

// clip(rint(v / s), -127, 127) with the IEEE quotient, without paying for a
// division per element: y = v * (1/s) is within ~1 ulp of v / s, i.e. within
// 1.6e-5 for |y| < 128, so rint(y) = rint(v / s) unless y lies within 1e-4
// of a half-integer; only then (about 1 element in 10^4) is the division
// done. Beyond |y| >= 128 the clip decides either way.
__device__ __forceinline__ uint32_t quant1(float v, float s, float rs) {
  float y = v * rs;
  if (fabsf(y) < 128.f && fabsf(fabsf(y - truncf(y)) - 0.5f) < 1e-4f) y = v / s;
  const float q = fminf(fmaxf(rintf(y), -127.f), 127.f);
  return (uint32_t)((int)q & 0xff);
}

__device__ __forceinline__ uint32_t quant4(float4 v, float s, float rs) {
  return quant1(v.x, s, rs) | (quant1(v.y, s, rs) << 8) | (quant1(v.z, s, rs) << 16) |
         (quant1(v.w, s, rs) << 24);
}

// The same four codes without the conversion unit and with one test for the
// rare case: rounding by adding 1.5 * 2^23, whose sum holds rint(y) in its
// low mantissa bits (round-half-to-even, as rintf), so the int8 code is the
// sum's low byte. y is clipped to [-127, 127] first, which commutes with
// rounding. If any of the four lies within 1e-4 of a half-integer, all four
// are redone from the IEEE quotient.
__device__ __forceinline__ uint32_t quant4_magic(float4 v, float s, float rs) {
  constexpr float kMagic = 12582912.f;
  const float in[4] = {v.x, v.y, v.z, v.w};
  float biased[4];
  bool near_tie = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float y = fminf(fmaxf(in[i] * rs, -127.f), 127.f);
    biased[i] = __fadd_rn(y, kMagic);
    near_tie |= fabsf(__fsub_rn(y, __fsub_rn(biased[i], kMagic))) > 0.4999f;
  }
  if (near_tie) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      biased[i] = __fadd_rn(fminf(fmaxf(in[i] / s, -127.f), 127.f), kMagic);
  }
  const uint32_t lo = __byte_perm(__float_as_uint(biased[0]), __float_as_uint(biased[1]), 0x0040);
  const uint32_t hi = __byte_perm(__float_as_uint(biased[2]), __float_as_uint(biased[3]), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// Dequant, then the inference BatchNorm, in the reference's order of float32
// operations: ((acc * s1 + b1) - mean) * mul + beta. The intrinsics keep the
// compiler from contracting it into FMAs.
__device__ __forceinline__ float dequant_bn(int acc, float s1, float b1, float mean, float mul,
                                            float beta) {
  const float y = __fadd_rn(__fmul_rn((float)acc, s1), b1);
  return __fadd_rn(__fmul_rn(__fsub_rn(y, mean), mul), beta);
}

// Then the residual (residual + y, in that order) and the ReLU.
__device__ __forceinline__ float res_relu(float y, float r, bool has_res, bool relu) {
  if (has_res) y = __fadd_rn(r, y);
  return relu ? fmaxf(y, 0.f) : y;
}

}  // namespace azt
