// The TPUFPU's time upsampling, a (1, 2)-stride ConvTranspose, as a float32
// matrix product summed in a fixed order, on Hopper (sm_90a).
//
// Replaces: no Pallas kernel. On the TPU this layer is an XLA op
// (azoom/models/unet.py:_up_time, flax nn.ConvTranspose). It has a kernel
// here for a numerical reason: the next layer quantises its output to int8,
// so a one-ulp difference flips activation codes, and a library GEMM sums in
// an order of its own choosing (cuBLAS differs from the CPU's MKL in most
// elements). This kernel sums each output as one FMA chain in K order,
//   acc = fma(x[p, k], W[k, c], acc) for k = 0 .. K-1, then out = acc + bias,
// which is the order of the reference's float32 product on the CPU, so the
// card, the plain version and the reference give the same bits.
//
// out (P, 2*Cout) = x (P, K) @ W (K, 2*Cout) + bias, with W = [W1 | W0];
// (P, 2*Cout) is (B, F, T, 2, Cout), i.e. (B, F, 2T, Cout) with no copy.
//
// What bounds it: at the mask net's shapes it is a small GEMM (K <= 256,
// 2*Cout <= 256, P up to 1.06M rows at batch 128): 17 GFMA over the three
// layers, compute-bound on the float32 pipes (no tensor cores: their sums
// round differently). Design: a block stages 32 rows of x in shared memory;
// each thread owns one output column and 32 accumulators, reads W[k, c]
// once per k (coalesced across the block) and x four K-steps at a time as a
// float4 that shared memory broadcasts to the warp.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 32;      // rows of x per block
constexpr int kThreads = 256;  // output columns per block

__global__ void __launch_bounds__(kThreads) convt_kernel(
    const float* __restrict__ x, const float* __restrict__ W, const float* __restrict__ bias,
    float* __restrict__ out, long P, int K, int N2, int Cout) {
  extern __shared__ __align__(16) float xs[];  // kRows x K
  const long p0 = (long)blockIdx.x * kRows;
  const int rows = (int)min((long)kRows, P - p0);
  for (int i = threadIdx.x; i < kRows * K; i += kThreads) {
    const int r = i / K;
    xs[i] = r < rows ? x[(p0 + r) * K + (i - r * K)] : 0.f;
  }
  __syncthreads();
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= N2) return;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int k = 0; k < K; k += 4) {  // K % 4 == 0; the chain stays in K order
    const float w0 = W[(long)k * N2 + c], w1 = W[(long)(k + 1) * N2 + c];
    const float w2 = W[(long)(k + 2) * N2 + c], w3 = W[(long)(k + 3) * N2 + c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(xs + r * K + k);  // a broadcast
      float a = __fmaf_rn(v.x, w0, acc[r]);
      a = __fmaf_rn(v.y, w1, a);
      a = __fmaf_rn(v.z, w2, a);
      acc[r] = __fmaf_rn(v.w, w3, a);
    }
  }
  const float b = bias[c % Cout];
  for (int r = 0; r < rows; ++r) out[(p0 + r) * N2 + c] = __fadd_rn(acc[r], b);
}

}  // namespace

// x (P, K) f32 with K % 4 == 0; W (K, N2) f32 with N2 = 2 * Cout; bias (Cout,) f32;
// out (P, N2) f32. Returns cudaGetLastError().
extern "C" int azt_convt1x2(const void* x, const void* W, const void* bias, void* out,
                            long P, int K, int N2, int Cout, void* stream) {
  const int smem = kRows * K * (int)sizeof(float);
  if (smem > 48 * 1024) {  // dynamic shared memory above 48 KB must be opted into
    const cudaError_t e = cudaFuncSetAttribute(
        convt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((P + kRows - 1) / kRows), (N2 + kThreads - 1) / kThreads);
  convt_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)W, (const float*)bias, (float*)out, P, K, N2, Cout);
  return (int)cudaGetLastError();
}
