// Recursive (online) masked MVDR for an STFT of M = 3 .. 8 mics, on Hopper
// (sm_90a): the M-general instance beside the 2-mic online_mvdr_kernel.cu.
//
// Replaces: no Pallas kernel. The reference runs this recursion as an XLA
// lax.scan over STFT frames (azoom/stream/online.py:61-81, and the one-hop
// step of azoom/stream/lowlat.py), M-general through the unrolled Cholesky
// of azoom/beam/linalgmm.py; the port runs it as this kernel, one launch for
// a whole clip (T frames) or for one hop (T = 1).
//
// Per (stream b, bin f) row, with the state (R_sum, w_sum) read before frame
// 0 and written back after frame T-1, for t = 0 .. T-1:
//   R_sum = forget R_sum + m_t y_t y_t^H,  w_sum = forget w_sum + m_t
//   R = R_sum / (w_sum + eps) + sigma I
//   x = R^-1 d by the Cholesky R = L L^H (pivots clamped at 1e-7 x the
//   largest diagonal entry + 1e-30) and forward and back substitution,
//   w = x / (d^H x + 1e-10),  s_t = w^H y_t
//   s_t *= max(g_t, floor) (with a target mask g), and s_t = 0 below the
//   high-pass cutoff (the state is updated there all the same).
//
// What bounds it: the frame-to-frame chain, as at M = 2. Y, the masks and S
// move (8 M + 16) bytes per (row, t), a few hundred flops a frame at M = 4
// (~1,000 at M = 8: the O(M^3) factorization), and frame t needs frame
// t-1's state.
//
// Design (the shape of the first 2-mic kernel; speed is later work): one
// thread per row, the state in registers across frames: the lower triangle
// of R_sum (M (M + 1) / 2 complex, the diagonal's imaginary part zero) and
// w_sum; the Cholesky factor and the substitutions unrolled over M at
// compile time, expression for expression as beam/linalgmm.py, so nothing
// of a frame leaves the registers but S. The upper triangle goes back to
// device memory as the conjugate of the lower. One launch over T frames and
// T launches of one frame, the state carried through device memory in
// float32 both ways, run the same code per frame and give the same bits.
// Divisions are IEEE (no reciprocal approximations), so the kernel agrees
// with the plain version to float32 rounding. M = 8 keeps ~200 floats
// live; above 8 the registers run out (the wrapper refuses M > 8).

#include <cuda_runtime.h>

namespace {

constexpr float kEpsDen = 1e-10f;   // distortionless denominator guard
constexpr float kPivotEps = 1e-7f;  // relative Cholesky pivot clamp (linalgmm's default)
constexpr int kThreads = 64;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {  // a b
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {  // a conj(b)
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

template <int M>
__global__ void __launch_bounds__(kThreads) online_mvdr_m_kernel(
    const float2* __restrict__ Y, const float* __restrict__ nmask,
    const float* __restrict__ tmask, const float2* __restrict__ d, float sigma,
    const float* __restrict__ freqs, float hp_cutoff, float forget, float eps, float mask_floor,
    float2* __restrict__ R_state, float* __restrict__ w_state, float2* __restrict__ S, int B,
    int F, int T) {
  constexpr int kTri = M * (M + 1) / 2;  // lower triangle, row-major: (i, j) at i (i + 1) / 2 + j
  const long row = (long)blockIdx.x * kThreads + threadIdx.x;  // b * F + f
  if (row >= (long)B * F) return;
  const long b = row / F;
  const int f = (int)(row - b * F);
  const float2* y = Y + ((long)M * b * F + f) * T;  // channel m at y + m * F * T
  const long ch = (long)F * T;
  const float* m = nmask + row * T;
  const float* g = tmask ? tmask + row * T : nullptr;
  float2* s = S + row * T;
  float2* Rp = R_state + row * (M * M);  // (M, M) row-major

  float2 r[kTri];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) r[i * (i + 1) / 2 + j] = Rp[i * M + j];
  }
#pragma unroll
  for (int i = 0; i < M; ++i) r[i * (i + 1) / 2 + i].y = 0.f;
  float ws = w_state[row];
  float2 e[M];
#pragma unroll
  for (int i = 0; i < M; ++i) e[i] = d[f * M + i];
  const bool pass = freqs[f] >= hp_cutoff;

  for (int t = 0; t < T; ++t) {
    float2 yv[M];
#pragma unroll
    for (int i = 0; i < M; ++i) yv[i] = y[i * ch + t];
    const float mt = m[t];
    // R_sum = forget R_sum + m_t y y^H (the lower triangle), w_sum likewise
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        const float2 o = cmulc(yv[i], yv[j]);
        float2& q = r[i * (i + 1) / 2 + j];
        q.x = forget * q.x + o.x * mt;
        q.y = i == j ? 0.f : forget * q.y + o.y * mt;
      }
    }
    ws = forget * ws + mt;
    if (!pass) {
      s[t] = make_float2(0.f, 0.f);
      continue;
    }
    // R = R_sum / (w_sum + eps) + sigma I, factored as L L^H (linalgmm.cholesky_small)
    const float den = ws + eps;
    float diag_max = r[0].x / den + sigma;
#pragma unroll
    for (int j = 1; j < M; ++j) diag_max = fmaxf(diag_max, r[j * (j + 1) / 2 + j].x / den + sigma);
    const float floor = kPivotEps * diag_max + 1e-30f;
    float2 L[kTri];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      float sj = r[j * (j + 1) / 2 + j].x / den + sigma;
#pragma unroll
      for (int k = 0; k < j; ++k) {
        const float2 l = L[j * (j + 1) / 2 + k];
        sj = sj - (l.x * l.x + l.y * l.y);
      }
      const float piv = sqrtf(fmaxf(sj, floor));
      L[j * (j + 1) / 2 + j] = make_float2(piv, 0.f);
#pragma unroll
      for (int i = j + 1; i < M; ++i) {
        const float2 q = r[i * (i + 1) / 2 + j];
        float2 tt = make_float2(q.x / den, q.y / den);
#pragma unroll
        for (int k = 0; k < j; ++k) tt = csub(tt, cmulc(L[i * (i + 1) / 2 + k], L[j * (j + 1) / 2 + k]));
        L[i * (i + 1) / 2 + j] = make_float2(tt.x / piv, tt.y / piv);
      }
    }
    // L v = d, then L^H x = v (v is overwritten by x)
    float2 x[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      float2 acc = e[i];
#pragma unroll
      for (int k = 0; k < i; ++k) acc = csub(acc, cmul(L[i * (i + 1) / 2 + k], x[k]));
      const float p = L[i * (i + 1) / 2 + i].x;
      x[i] = make_float2(acc.x / p, acc.y / p);
    }
#pragma unroll
    for (int i = M - 1; i >= 0; --i) {
      float2 acc = x[i];
#pragma unroll
      for (int k = i + 1; k < M; ++k) {
        const float2 l = L[k * (k + 1) / 2 + i];  // conj(L[k][i]) x[k]
        acc = csub(acc, cmul(make_float2(l.x, -l.y), x[k]));
      }
      const float p = L[i * (i + 1) / 2 + i].x;
      x[i] = make_float2(acc.x / p, acc.y / p);
    }
    // z = d^H x + 1e-10; w = x / z = x conj(z) / |z|^2; s = w^H y
    float2 z = make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float2 p = cmulc(x[i], e[i]);  // conj(e) x
      z.x += p.x;
      z.y += p.y;
    }
    z.x += kEpsDen;
    const float izz = 1.0f / (z.x * z.x + z.y * z.y);
    float sr = 0.f, si = 0.f;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float2 w = make_float2((x[i].x * z.x + x[i].y * z.y) * izz,
                                   (x[i].y * z.x - x[i].x * z.y) * izz);
      const float2 p = cmulc(yv[i], w);  // conj(w) y
      sr += p.x;
      si += p.y;
    }
    if (g) {
      const float gain = mask_floor > 0.f ? fmaxf(g[t], mask_floor) : g[t];
      sr *= gain;
      si *= gain;
    }
    s[t] = make_float2(sr, si);
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const float2 q = r[i * (i + 1) / 2 + j];
      Rp[i * M + j] = q;
      if (j < i) Rp[j * M + i] = make_float2(q.x, -q.y);
    }
  }
  w_state[row] = ws;
}

template <int M>
int launch(const void* Y, const void* nmask, const void* tmask, const void* d, float sigma,
           const void* freqs, float hp_cutoff, float forget, float eps, float mask_floor,
           void* R_state, void* w_state, void* S, int B, int F, int T, void* stream) {
  const long rows = (long)B * F;
  online_mvdr_m_kernel<M><<<(unsigned)((rows + kThreads - 1) / kThreads), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const float2*)Y, (const float*)nmask, (const float*)tmask, (const float2*)d, sigma,
      (const float*)freqs, hp_cutoff, forget, eps, mask_floor, (float2*)R_state,
      (float*)w_state, (float2*)S, B, F, T);
  return (int)cudaGetLastError();
}

}  // namespace

// M in 3 .. 8; Y (B, M, F, T) complex64; nmask (B, F, T) f32; tmask (B, F, T)
// f32 or null; d (F, M) complex64; freqs (F,) f32; R_state (B, F, M, M)
// complex64 and w_state (B, F) f32, read and written back; S (B, F, T)
// complex64. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// another M.
extern "C" int azt_online_mvdr_m(int M, const void* Y, const void* nmask, const void* tmask,
                                 const void* d, float sigma, const void* freqs, float hp_cutoff,
                                 float forget, float eps, float mask_floor, void* R_state,
                                 void* w_state, void* S, int B, int F, int T, void* stream) {
#define AZT_CASE(K)                                                                         \
  case K:                                                                                   \
    return launch<K>(Y, nmask, tmask, d, sigma, freqs, hp_cutoff, forget, eps, mask_floor, \
                     R_state, w_state, S, B, F, T, stream);
  switch (M) {
    AZT_CASE(3)
    AZT_CASE(4)
    AZT_CASE(5)
    AZT_CASE(6)
    AZT_CASE(7)
    AZT_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef AZT_CASE
}
