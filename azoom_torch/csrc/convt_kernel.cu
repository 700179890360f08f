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
// card, the plain version and the reference give the same bits. No tensor
// cores (TF32 rounds its inputs), no split-K, no tree sums, no fast math.
//
// out (P, 2*Cout) = x (P, K) @ W (K, 2*Cout) + bias, with W = [W1 | W0];
// (P, 2*Cout) is (B, F, T, 2, Cout), i.e. (B, F, 2T, Cout) with no copy.
//
// What bounds it: at the mask net's shapes it is a small GEMM (K <= 256,
// 2*Cout <= 256, P up to 528k rows at batch 128): 17.3 GFMA over the three
// layers, bound by the float32 pipes (0.52 ms at 67 TFLOP/s), the bytes
// (0.95 GB) close behind at K = 64. Design: a register-tiled SGEMM that keeps
// each output's chain. A block owns a 96-row x 128-column tile of out; each
// of its 128 threads owns 12 rows x 8 columns (96 accumulators). K is walked
// in chunks of 16 through a 3-stage cp.async ring in shared memory, x stored
// k-major (transposed on the way in, rows padded to 100 floats) and W as it
// is, so per k a thread reads three float4 of x (a broadcast across the 16
// threads that share its rows) and two float4 of W for 96 FMAs. Shared
// memory returns 128 bytes a clock to an SM that does 128 FMAs a clock: an
// 8 x 8 thread tile reads 1 byte per FMA and is held at its pace, 12 x 8
// reads 0.83. Every accumulator still takes k = 0 .. K-1 in order, so the
// bits are those of a plain loop. Three blocks fit on an SM (<= 168
// registers, 43,776 bytes of shared memory each), so one block's epilogue
// runs under the others' FMAs. The chunk's 16 steps are unrolled by 2, not
// fully: fully unrolled the kernel ran a few percent slower. The grid is
// one-dimensional with the column tiles of a row tile adjacent, so both
// column tiles of a wide layer read x while it is in L2.

#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 96;          // rows of x and out per block
constexpr int kTileN = 128;         // columns of W and out per block
constexpr int kChunk = 16;          // K per stage of the ring
constexpr int kStages = 3;
constexpr int kThreads = 128;       // 8 x 16 threads of 12 x 8 outputs
constexpr int kXStride = kTileM + 4;  // floats per k of the transposed x tile
constexpr int kStageFloats = kChunk * (kXStride + kTileN);
constexpr int kSmemBytes = kStages * kStageFloats * (int)sizeof(float);
static_assert(kSmemBytes <= 48 * 1024, "more dynamic shared memory would need an opt-in");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// src_bytes < size fills the rest with zeros (0: a row or column past the edge).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kThreads, 3) convt_kernel(
    const float* __restrict__ x, const float* __restrict__ W, const float* __restrict__ bias,
    float* __restrict__ out, long P, int K, int N2, int Cout) {
  extern __shared__ __align__(16) float smem[];  // kStages x {xs[kChunk][kXStride], ws[kChunk][kTileN]}
  const int tiles_n = (N2 + kTileN - 1) / kTileN;
  const long p0 = (long)(blockIdx.x / tiles_n) * kTileM;
  const int n0 = (int)(blockIdx.x % tiles_n) * kTileN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // columns tx*4, 64 + tx*4; rows 32 i + ty*4, i < 3
  const int chunks = (K + kChunk - 1) / kChunk;

  // Stage chunk c: x as 12 single floats a thread, written transposed; W as 4 float4.
  auto load = [&](int c) {
    float* xs = smem + (c % kStages) * kStageFloats;
    float* ws = xs + kChunk * kXStride;
    const int k0 = c * kChunk;
    const int kk = tid & (kChunk - 1);
#pragma unroll
    for (int j = 0; j < kTileM * kChunk / kThreads; ++j) {
      const int r = tid / kChunk + j * (kThreads / kChunk);
      const bool ok = p0 + r < P && k0 + kk < K;
      cp_async4(xs + kk * kXStride + r, ok ? x + (p0 + r) * K + k0 + kk : x, ok ? 4 : 0);
    }
#pragma unroll
    for (int j = 0; j < kChunk * kTileN / 4 / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int k = i / (kTileN / 4), c4 = (i % (kTileN / 4)) * 4;
      const bool ok = k0 + k < K && n0 + c4 < N2;
      cp_async16(ws + k * kTileN + c4, ok ? W + (long)(k0 + k) * N2 + n0 + c4 : W, ok ? 16 : 0);
    }
  };

  float acc[12][8];
#pragma unroll
  for (int i = 0; i < 12; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // One step of every chain: k = k0 + kk.
  auto step = [&](const float* xs, const float* ws, int kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(xs + kk * kXStride + ty * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(xs + kk * kXStride + 32 + ty * 4);
    const float4 a2 = *reinterpret_cast<const float4*>(xs + kk * kXStride + 64 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(ws + kk * kTileN + tx * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(ws + kk * kTileN + 64 + tx * 4);
    const float a[12] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w,
                         a2.x, a2.y, a2.z, a2.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 12; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load(s);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and chunk c - 1's stage is free
    if (c + kStages - 1 < chunks) load(c + kStages - 1);
    cp_async_commit();
    const float* xs = smem + (c % kStages) * kStageFloats;
    const float* ws = xs + kChunk * kXStride;
    const int kn = min(kChunk, K - c * kChunk);
    if (kn == kChunk) {
#pragma unroll 2
      for (int kk = 0; kk < kChunk; ++kk) step(xs, ws, kk);
    } else {  // the last chunk when K % 16 != 0
      for (int kk = 0; kk < kn; ++kk) step(xs, ws, kk);
    }
  }

  // Epilogue: + bias, 16-byte stores; columns come in whole float4 (N2 % 4 == 0).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = n0 + h * 64 + tx * 4;
    if (c >= N2) continue;
    float bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bias[(c + j) % Cout];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      const long p = p0 + (i >> 2) * 32 + ty * 4 + (i & 3);
      if (p >= P) continue;
      const float* a = acc[i] + h * 4;
      *reinterpret_cast<float4*>(out + p * N2 + c) =
          make_float4(__fadd_rn(a[0], bv[0]), __fadd_rn(a[1], bv[1]), __fadd_rn(a[2], bv[2]),
                      __fadd_rn(a[3], bv[3]));
    }
  }
}

}  // namespace

// x (P, K) f32 with K % 4 == 0; W (K, N2) f32 with N2 = 2 * Cout, N2 % 4 == 0;
// bias (Cout,) f32; out (P, N2) f32; all 16-byte aligned. ``blocks`` and
// ``smem`` are kernels/convt_kernel.py:plan's, checked here against the
// kernel's own (cudaErrorInvalidValue if they differ). Returns cudaGetLastError().
extern "C" int azt_convt1x2(const void* x, const void* W, const void* bias, void* out, long P,
                            int K, int N2, int Cout, long blocks, int smem, void* stream) {
  const long want = (P + kTileM - 1) / kTileM * ((N2 + kTileN - 1) / kTileN);
  if (P <= 0 || K <= 0 || K % 4 || N2 % 4 || N2 != 2 * Cout || blocks != want ||
      smem != kSmemBytes || want > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  convt_kernel<<<(unsigned)blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)W, (const float*)bias, (float*)out, P, K, N2, Cout);
  return (int)cudaGetLastError();
}
