// The float32 FMA rate a kernel can reach on this card: every thread runs 64
// independent FMA chains on registers (an 8 x 8 outer product, as a GEMM's
// inner loop does, without its shared-memory reads) and 8 more to vary its
// operands. All three operands of every FMA are registers known only at run
// time (b comes from the argument s), as a GEMM's are: a compile-time b
// lets the compiler fold constants into the instructions. For
// kernels/bench.py (mode fp32_peak) only; no wrapper uses it.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256, 2) fp32_peak_kernel(float* out, int iters, float s) {
  float a[8], b[8], acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = threadIdx.x * 1e-3f + i;
    b[i] = s * i;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = __fmaf_rn(a[i], 0.999f, 1e-6f);
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += acc[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

// out: blocks * 256 floats. Each thread does 72 * iters FMAs. Returns cudaGetLastError().
extern "C" int azt_fp32_peak(void* out, int blocks, int iters, float s, void* stream) {
  fp32_peak_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>((float*)out, iters, s);
  return (int)cudaGetLastError();
}
