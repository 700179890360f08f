// The int8 nets' dynamic activation scales without a pass of their own:
// each launch that produces an activation (csrc/qconv_kernel.cu,
// csrc/qconv_mma_kernel.cu, csrc/convt_kernel.cu) writes its output's
// per-element maxima max|y[b]| as it stores y, and the conv that reads it
// forms the reference QConv's scale max / 127 + 1e-30 from them.
//
// The maxima travel as the bits of non-negative floats, which order as
// unsigned integers: a maximum is an integer max, and atomicMax on the bits
// is one across blocks, exact and independent of order, so the result is
// torch.linalg.vector_norm(y, inf) per element bit for bit. |y| is y's bits
// without the sign, so -0 is +0, and a NaN stays above every number, as
// torch's reduction keeps it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace azt {

__device__ __forceinline__ uint32_t abs_bits(float y) { return __float_as_uint(y) & 0x7fffffffu; }

__device__ __forceinline__ uint32_t abs_bits4(float4 y) {
  return max(max(abs_bits(y.x), abs_bits(y.y)), max(abs_bits(y.z), abs_bits(y.w)));
}

// The reference QConv's dynamic scale of element b from the maxima of its
// input (x, and x2 at a concat, else null): max / 127 + 1e-30 in IEEE float32,
// the bits of kernels/qconv_kernel.py's dynamic_act_scale on the card.
__device__ __forceinline__ float scale_of_max(const float* x_max, const float* x2_max, long b) {
  uint32_t m = __float_as_uint(__ldg(x_max + b));
  if (x2_max) m = max(m, __float_as_uint(__ldg(x2_max + b)));
  return __fadd_rn(__fdiv_rn(__uint_as_float(m), 127.f), 1e-30f);
}

// A warp's maximum of ``bits`` (every lane calls it) into out_max[b], one
// atomic; zero, the buffer's start, needs none.
__device__ __forceinline__ void warp_max_out(uint32_t bits, float* out_max, long b) {
  bits = __reduce_max_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0 && bits) atomicMax(reinterpret_cast<unsigned*>(out_max) + b, bits);
}

}  // namespace azt
