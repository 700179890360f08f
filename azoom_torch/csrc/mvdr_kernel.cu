// Fused masked MVDR for a 2-mic STFT, on Hopper (sm_90a).
//
// Replaces: azoom/pallas/mvdr_kernel.py:_kernel (reached through
// mvdr_pallas_raw / masked_mvdr_pallas), plus the high-pass zeroing and the
// floored target-mask gain that masked_mvdr_pallas applies after the kernel.
//
// Per (stream b, bin f) row of Y (B, 2, F, T) complex64:
//   R00, R11, R01 = sum_t m[t] * y y^H / (sum_t m[t] + 1e-6), + sigma on the diagonal
//   x  = adj(R) d / det(R)
//   w  = x * conj(d^H x) / (|d^H x|^2 + 1e-10)
//   S  = (w^H y) * max(target_mask, floor)   (or 0 below the high-pass cutoff)
//
// What bounds it: memory. Each element of Y, the masks and S is touched once
// by the algorithm, and the arithmetic is ~40 flops per (row, t); at the
// serving shape (128 x 513 rows, T = 64) it moves ~135 MB for ~0.2 GFLOP.
// Design: one warp per row. Lanes stride over T, so a warp's loads of one
// row are contiguous (float2 per lane); the five covariance sums are reduced
// with warp shuffles and the 2x2 solve runs redundantly in every lane's
// registers, with no shared memory and no block-wide barrier. The second
// pass over T for the apply re-reads the row (1 KB of Y per row), which the
// L1 still holds, so device memory sees each byte once.

#include <cuda_runtime.h>

namespace {

constexpr float kEpsNorm = 1e-6f;   // covariance normalisation guard
constexpr float kEpsDen = 1e-10f;   // distortionless denominator guard
constexpr int kThreads = 256;       // 8 rows (warps) per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads) masked_mvdr_kernel(
    const float2* __restrict__ Y, const float* __restrict__ nmask,
    const float* __restrict__ tmask, const float2* __restrict__ d,
    const float* __restrict__ sigma_f, float sigma, const float* __restrict__ freqs,
    float hp_cutoff, float mask_floor, float2* __restrict__ S, int B, int F, int T) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);  // b * F + f
  if (row >= (long)B * F) return;
  const long b = row / F;
  const int f = (int)(row - b * F);
  const float2* y0 = Y + ((2 * b) * F + f) * (long)T;
  const float2* y1 = Y + ((2 * b + 1) * F + f) * (long)T;
  const float* m = nmask + row * T;
  float2* s = S + row * T;

  if (freqs[f] < hp_cutoff) {  // bins below the cutoff stay zero
    for (int t = lane; t < T; t += 32) s[t] = make_float2(0.f, 0.f);
    return;
  }

  float sm = 0.f, r00 = 0.f, r11 = 0.f, r01r = 0.f, r01i = 0.f;
  for (int t = lane; t < T; t += 32) {
    const float2 a = y0[t], c = y1[t];
    const float w = m[t];
    sm += w;
    r00 += w * (a.x * a.x + a.y * a.y);
    r11 += w * (c.x * c.x + c.y * c.y);
    r01r += w * (a.x * c.x + a.y * c.y);
    r01i += w * (a.y * c.x - a.x * c.y);
  }
  const float norm = warp_sum(sm) + kEpsNorm;
  const float sg = sigma_f ? sigma_f[f] : sigma;
  const float R00 = warp_sum(r00) / norm + sg;
  const float R11 = warp_sum(r11) / norm + sg;
  const float R01r = warp_sum(r01r) / norm;
  const float R01i = warp_sum(r01i) / norm;
  const float det = R00 * R11 - (R01r * R01r + R01i * R01i);

  const float2 e0 = d[2 * f], e1 = d[2 * f + 1];
  // x = adj(R) d / det, adj(R) = [[R11, -R01], [-conj(R01), R00]]
  const float x0r = (R11 * e0.x - (R01r * e1.x - R01i * e1.y)) / det;
  const float x0i = (R11 * e0.y - (R01r * e1.y + R01i * e1.x)) / det;
  const float x1r = (R00 * e1.x - (R01r * e0.x + R01i * e0.y)) / det;
  const float x1i = (R00 * e1.y + (R01i * e0.x - R01r * e0.y)) / det;
  // den = d^H x; w = x * conj(den) / |den|^2
  const float denr = e0.x * x0r + e0.y * x0i + e1.x * x1r + e1.y * x1i;
  const float deni = e0.x * x0i - e0.y * x0r + e1.x * x1i - e1.y * x1r;
  const float dd = denr * denr + deni * deni + kEpsDen;
  const float w0r = (x0r * denr + x0i * deni) / dd;
  const float w0i = (x0i * denr - x0r * deni) / dd;
  const float w1r = (x1r * denr + x1i * deni) / dd;
  const float w1i = (x1i * denr - x1r * deni) / dd;

  const float* g = tmask ? tmask + row * T : nullptr;
  for (int t = lane; t < T; t += 32) {
    const float2 a = y0[t], c = y1[t];
    // S = conj(w0) y0 + conj(w1) y1
    float sr = w0r * a.x + w0i * a.y + w1r * c.x + w1i * c.y;
    float si = w0r * a.y - w0i * a.x + w1r * c.y - w1i * c.x;
    if (g) {
      const float gain = mask_floor > 0.f ? fmaxf(g[t], mask_floor) : g[t];
      sr *= gain;
      si *= gain;
    }
    s[t] = make_float2(sr, si);
  }
}

}  // namespace

// Y (B, 2, F, T) complex64; nmask (B, F, T) f32; tmask (B, F, T) f32 or null;
// d (F, 2) complex64; sigma_f (F,) f32 or null (then the scalar sigma);
// freqs (F,) f32; S (B, F, T) complex64. Returns cudaGetLastError().
extern "C" int azt_masked_mvdr(const void* Y, const void* nmask, const void* tmask,
                               const void* d, const void* sigma_f, float sigma,
                               const void* freqs, float hp_cutoff, float mask_floor,
                               void* S, int B, int F, int T, void* stream) {
  const long rows = (long)B * F;
  const long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  masked_mvdr_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)Y, (const float*)nmask, (const float*)tmask, (const float2*)d,
      (const float*)sigma_f, sigma, (const float*)freqs, hp_cutoff, mask_floor,
      (float2*)S, B, F, T);
  return (int)cudaGetLastError();
}
