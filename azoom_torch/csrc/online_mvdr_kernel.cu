// Recursive (online) masked MVDR for a 2-mic STFT, on Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The reference runs this recursion as an XLA
// lax.scan over STFT frames (azoom/stream/online.py:61-81, and the one-hop
// step of azoom/stream/lowlat.py:54-96); the port runs it as this kernel,
// one launch for a whole clip (T frames) or for one hop (T = 1).
//
// Per (stream b, bin f) row, with the state (R_sum, w_sum) read before frame
// 0 and written back after frame T-1, for t = 0 .. T-1:
//   R_sum = forget R_sum + m_t y_t y_t^H,  w_sum = forget w_sum + m_t
//   R = R_sum / (w_sum + eps) + sigma I
//   x = adj(R) d / det(R),  w = x / (d^H x + 1e-10),  s_t = w^H y_t
//   s_t *= max(g_t, floor) (with a target mask g), and s_t = 0 below the
//   high-pass cutoff (the state is updated there all the same).
//
// What bounds it: neither bytes nor operations. Y, the masks and S move
// 32 bytes per (row, t) (a 60 s clip: 31 MB, ~9 us at 3.35 TB/s) for ~90
// flops, but frame t needs frame t-1's state, so a row is one thread's
// sequential loop, and one stream has only 513 rows: 17 warps for 132 SMs,
// one warp on an SM with nothing to hide its latencies behind. The
// loop-carried chain is one FMA per state entry and frame (the chain's
// floor: T x 4 cycles); the rest of a frame (its loads, three reciprocals,
// the solve) depends on that frame alone. What limits the kernel is that
// per-frame latency of one thread.
//
// Design: one thread per row, 32 threads per block (one warp per SM while
// there are fewer rows than 132 warps); the state lives in registers across
// the loop, which is unrolled so the compiler can interleave the
// independent work of neighbouring frames. A row's loads are strided by T
// across the warp's lanes; each 32-byte sector a lane fetches serves its
// next three frames from L1. (Staging tiles of 32 frames through shared
// memory with coalesced loads gained 7 % at one stream and 27-31 % at 128,
// measured; not kept.) The divisions are SFU reciprocals and products,
// within 2 ulp each (the plain version divides; they agree to ~5e-7 of
// the output's peak). The arithmetic per frame is the same code whatever T
// is, so T launches of one frame, each carrying the state through device
// memory (float32 both ways), give the bits of one launch over T frames.

#include <cuda_runtime.h>

namespace {

constexpr float kEpsDen = 1e-10f;  // distortionless denominator guard
constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads) online_mvdr_kernel(
    const float2* __restrict__ Y, const float* __restrict__ nmask,
    const float* __restrict__ tmask, const float2* __restrict__ d, float sigma,
    const float* __restrict__ freqs, float hp_cutoff, float forget, float eps, float mask_floor,
    float2* __restrict__ R_state, float* __restrict__ w_state, float2* __restrict__ S, int B,
    int F, int T) {
  const long row = (long)blockIdx.x * kThreads + threadIdx.x;  // b * F + f
  if (row >= (long)B * F) return;
  const long b = row / F;
  const int f = (int)(row - b * F);
  const float2* y0 = Y + ((2 * b) * F + f) * (long)T;
  const float2* y1 = Y + ((2 * b + 1) * F + f) * (long)T;
  const float* m = nmask + row * T;
  const float* g = tmask ? tmask + row * T : nullptr;
  float2* s = S + row * T;
  float2* Rp = R_state + row * 4;  // (2, 2) row-major: R00, R01, R10, R11

  float r00 = Rp[0].x, r01r = Rp[1].x, r01i = Rp[1].y, r11 = Rp[3].x;
  float ws = w_state[row];
  const bool pass = freqs[f] >= hp_cutoff;
  const float2 e0 = d[2 * f], e1 = d[2 * f + 1];

#pragma unroll 4
  for (int t = 0; t < T; ++t) {
    const float2 a = y0[t], c = y1[t];
    const float mt = m[t];
    // y y^H: [0, 0] = |y0|^2, [1, 1] = |y1|^2, [0, 1] = y0 conj(y1)
    r00 = forget * r00 + mt * (a.x * a.x + a.y * a.y);
    r11 = forget * r11 + mt * (c.x * c.x + c.y * c.y);
    r01r = forget * r01r + mt * (a.x * c.x + a.y * c.y);
    r01i = forget * r01i + mt * (a.y * c.x - a.x * c.y);
    ws = forget * ws + mt;
    if (!pass) {
      s[t] = make_float2(0.f, 0.f);
      continue;
    }
    // One reciprocal per divisor (the SFU's, within 2 ulp), then products.
    // Twelve IEEE divisions (each a branchy sequence of its own, in three
    // dependent stages) set the time of a frame: 1.02 us against 0.43 with
    // these at (2, 513, 1875) (kernels.bench online_mvdr --against, PERF.md).
    const float inorm = __fdividef(1.0f, ws + eps);
    const float R00 = r00 * inorm + sigma;
    const float R11 = r11 * inorm + sigma;
    const float R01r = r01r * inorm;
    const float R01i = r01i * inorm;
    const float idet = __fdividef(1.0f, R00 * R11 - (R01r * R01r + R01i * R01i));
    // x = adj(R) d / det, adj(R) = [[R11, -R01], [-conj(R01), R00]]
    const float x0r = (R11 * e0.x - (R01r * e1.x - R01i * e1.y)) * idet;
    const float x0i = (R11 * e0.y - (R01r * e1.y + R01i * e1.x)) * idet;
    const float x1r = (R00 * e1.x - (R01r * e0.x + R01i * e0.y)) * idet;
    const float x1i = (R00 * e1.y + (R01i * e0.x - R01r * e0.y)) * idet;
    // z = d^H x + 1e-10; w = x / z = x conj(z) / |z|^2
    const float zr = e0.x * x0r + e0.y * x0i + e1.x * x1r + e1.y * x1i + kEpsDen;
    const float zi = e0.x * x0i - e0.y * x0r + e1.x * x1i - e1.y * x1r;
    const float izz = __fdividef(1.0f, zr * zr + zi * zi);
    const float w0r = (x0r * zr + x0i * zi) * izz;
    const float w0i = (x0i * zr - x0r * zi) * izz;
    const float w1r = (x1r * zr + x1i * zi) * izz;
    const float w1i = (x1i * zr - x1r * zi) * izz;
    // s = conj(w0) y0 + conj(w1) y1
    float sr = w0r * a.x + w0i * a.y + w1r * c.x + w1i * c.y;
    float si = w0r * a.y - w0i * a.x + w1r * c.y - w1i * c.x;
    if (g) {
      const float gain = mask_floor > 0.f ? fmaxf(g[t], mask_floor) : g[t];
      sr *= gain;
      si *= gain;
    }
    s[t] = make_float2(sr, si);
  }
  Rp[0] = make_float2(r00, 0.f);
  Rp[1] = make_float2(r01r, r01i);
  Rp[2] = make_float2(r01r, -r01i);
  Rp[3] = make_float2(r11, 0.f);
  w_state[row] = ws;
}

}  // namespace

// Y (B, 2, F, T) complex64; nmask (B, F, T) f32; tmask (B, F, T) f32 or null;
// d (F, 2) complex64; freqs (F,) f32; R_state (B, F, 2, 2) complex64 and
// w_state (B, F) f32, read and written back; S (B, F, T) complex64. Returns
// cudaGetLastError().
extern "C" int azt_online_mvdr(const void* Y, const void* nmask, const void* tmask,
                               const void* d, float sigma, const void* freqs, float hp_cutoff,
                               float forget, float eps, float mask_floor, void* R_state,
                               void* w_state, void* S, int B, int F, int T, void* stream) {
  const long rows = (long)B * F;
  const long blocks = (rows + kThreads - 1) / kThreads;
  online_mvdr_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)Y, (const float*)nmask, (const float*)tmask, (const float2*)d, sigma,
      (const float*)freqs, hp_cutoff, forget, eps, mask_floor, (float2*)R_state,
      (float*)w_state, (float2*)S, B, F, T);
  return (int)cudaGetLastError();
}
