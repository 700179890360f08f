// Fused hybrid hard-null beamformer for a 2-mic STFT, on Hopper (sm_90a).
//
// Replaces: azoom/pallas/nullsteer_kernel.py:_kernel (reached through
// hard_null_pallas / hybrid_hard_null_pallas), plus the mic-0 bypass below
// lowfreq_bypass_hz and the post-filter multiply that the learned pipeline
// applies after it.
//
// It computes the XLA function azoom.beam.nullsteer.hybrid_hard_null_beamform
// at M = 2, not the Pallas kernel's arithmetic. The Pallas kernel floors the
// squared norm of the unnormalised eigenvector candidate, the phase and
// |det|^2 at an absolute 1e-10 (nullsteer_kernel.py:59, 62, 79). A speech-level
// covariance is ~1e-5, so there the eigenvector is not unit length, the cond
// test reads "ill-conditioned" and the row falls back to delay-and-sum: the
// gate depends on the input's scale. The XLA function judges degeneracy
// relative to the matrix scale (eigh_2x2_hermitian's rel_tol); so does this
// kernel, and its output is scale-covariant.
//
// Per (stream b, bin f) row of Y (B, 2, F, T) complex64:
//   mi = 1 - target_mask (float32, as the reference), R = sum_t mi y y^H / (sum_t mi + 1e-6)
//   v  = principal eigenvector of R (closed form, e-basis when isotropic),
//        rotated so v[0] is real-positive
//   C  = [d, v]; w = solution of C^H w = [1, 0] (Cramer, det + 1e-10)
//   cond(C) > cond_thr or non-finite -> w = d / 2 (per component where w is non-finite)
//   S  = (w^H y) rounded to complex64, times post_mask; bins below the bypass
//        frequency: S = y0 * post_mask
//
// What bounds it: bytes. Each element of Y (16 B), the target mask (4 B), the
// post-filter mask (4 B) and S (8 B) is touched once by the algorithm; the
// arithmetic is ~30 flops per element and ~150 per row. At the serving shape
// (128 x 513 rows, T = 64) that is ~134 MB, 0.040 ms at 3.35 TB/s.
// Design: one warp per row, as csrc/mvdr_kernel.cu. Lanes stride over T so a
// warp's loads are contiguous; the five covariance sums are reduced with
// warp shuffles; the closed form runs redundantly in every lane's registers;
// the apply re-reads the row from L1. The sums and the closed form are in
// float64: the kernel stays bound by bytes, and the card and the float64
// plain version (kernels/nullsteer_kernel.py:hard_null_plain) then disagree
// on the cond gate only for rows within ~1e-12 of the threshold.

#include <cuda_runtime.h>

namespace {

constexpr double kEpsNorm = 1e-6;   // masked_covariance normalisation guard
constexpr double kEps = 1e-10;      // hard_null_weights: phase and Cramer guards
constexpr double kEigEps = 1e-12;   // eigh_2x2_hermitian / cond_2x2 floors
constexpr double kRelTol = 1e-6;    // eigh_2x2_hermitian degeneracy, relative to scale
constexpr int kThreads = 256;       // 8 rows (warps) per block

struct Cx {
  double re, im;
};

__device__ __forceinline__ Cx cmul(Cx a, Cx b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
__device__ __forceinline__ Cx cconj(Cx a) { return {a.re, -a.im}; }

// a / b with Smith's scaling (numpy's and c10::complex's algorithm).
__device__ __forceinline__ Cx cdiv(Cx a, Cx b) {
  if (fabs(b.re) >= fabs(b.im)) {
    const double rat = b.im / b.re, scl = 1.0 / (b.re + b.im * rat);
    return {(a.re + a.im * rat) * scl, (a.im - a.re * rat) * scl};
  }
  const double rat = b.re / b.im, scl = 1.0 / (b.im + b.re * rat);
  return {(a.re * rat + a.im) * scl, (a.im * rat - a.re) * scl};
}

__device__ __forceinline__ bool cfinite(Cx a) { return isfinite(a.re) && isfinite(a.im); }

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads) hard_null_kernel(
    const float2* __restrict__ Y, const float* __restrict__ tmask,
    const float* __restrict__ post, const float2* __restrict__ dvec,
    const float* __restrict__ freqs, double cond_thr, float bypass_hz,
    float2* __restrict__ S, int B, int F, int T) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);  // b * F + f
  if (row >= (long)B * F) return;
  const long b = row / F;
  const int f = (int)(row - b * F);
  const float2* y0 = Y + ((2 * b) * F + f) * (long)T;
  const float2* y1 = Y + ((2 * b + 1) * F + f) * (long)T;
  const float* m = tmask + row * T;
  const float* g = post ? post + row * T : nullptr;
  float2* s = S + row * T;

  if (freqs[f] < bypass_hz) {  // mic 0 passes through
    for (int t = lane; t < T; t += 32) {
      float2 a = y0[t];
      if (g) {
        a.x *= g[t];
        a.y *= g[t];
      }
      s[t] = a;
    }
    return;
  }

  // 1. Interference covariance.
  double sm = 0.0, r00 = 0.0, r11 = 0.0, r01r = 0.0, r01i = 0.0;
  for (int t = lane; t < T; t += 32) {
    const float2 a = y0[t], c = y1[t];
    const double w = (double)(1.0f - m[t]);
    const double ar = a.x, ai = a.y, cr = c.x, ci = c.y;
    sm += w;
    r00 += w * (ar * ar + ai * ai);
    r11 += w * (cr * cr + ci * ci);
    r01r += w * (ar * cr + ai * ci);
    r01i += w * (ai * cr - ar * ci);
  }
  const double norm = warp_sum(sm) + kEpsNorm;
  const double R00 = warp_sum(r00) / norm, R11 = warp_sum(r11) / norm;
  const double br = warp_sum(r01r) / norm, bi = warp_sum(r01i) / norm;

  // 2. Principal eigenvector (eigh_2x2_hermitian's eigvecs[:, -1]).
  const double half_tr = 0.5 * (R00 + R11), half_diff = 0.5 * (R00 - R11);
  const double b2 = br * br + bi * bi;
  const double radius = sqrt(half_diff * half_diff + b2);
  const double lam = half_tr + radius;
  const double lim = kRelTol * (fabs(half_tr) + radius + kEigEps);
  Cx v0, v1;
  if (radius < lim) {  // isotropic: the e-basis, principal vector e1
    v0 = {0.0, 0.0};
    v1 = {1.0, 0.0};
  } else {
    const double la = lam - R00, lc = lam - R11;
    const double n1 = b2 + la * la, n2 = lc * lc + b2;
    Cx u0, u1;  // the longer of (b, lam - a) and (lam - c, conj(b))
    double nsq;
    if (n1 >= n2) {
      u0 = {br, bi};
      u1 = {la, 0.0};
      nsq = n1;
    } else {
      u0 = {lc, 0.0};
      u1 = {br, -bi};
      nsq = n2;
    }
    if (nsq < lim * lim) {
      v0 = {1.0, 0.0};
      v1 = {0.0, 0.0};
    } else {
      const double n = sqrt(fmax(nsq, kEigEps * kEigEps));
      v0 = {u0.re / n, u0.im / n};
      v1 = {u1.re / n, u1.im / n};
    }
  }
  {  // v[0] real-positive
    const double k = hypot(v0.re, v0.im) + kEps;
    const Cx ph = cconj({v0.re / k, v0.im / k});
    v0 = cmul(v0, ph);
    v1 = cmul(v1, ph);
  }

  // 3. C = [d, v]; C^H w = [1, 0] by Cramer: w = [conj(v1), -conj(v0)] / det.
  const float2 df0 = dvec[2 * f], df1 = dvec[2 * f + 1];
  const Cx d0 = {df0.x, df0.y}, d1 = {df1.x, df1.y};
  const Cx p = cmul(cconj(d0), cconj(v1)), q = cmul(cconj(d1), cconj(v0));
  const Cx det = {p.re - q.re + kEps, p.im - q.im};
  Cx w0 = cdiv(cconj(v1), det);
  Cx w1 = cdiv({-v0.re, v0.im}, det);

  // 4. cond(C) from the eigenvalues of C^H C; the gate and the finiteness guard.
  const double g00 = d0.re * d0.re + d0.im * d0.im + d1.re * d1.re + d1.im * d1.im;
  const double g11 = v0.re * v0.re + v0.im * v0.im + v1.re * v1.re + v1.im * v1.im;
  const Cx g01a = cmul(cconj(d0), v0), g01b = cmul(cconj(d1), v1);
  const double g01r = g01a.re + g01b.re, g01i = g01a.im + g01b.im;
  const double ght = 0.5 * (g00 + g11), ghd = 0.5 * (g00 - g11);
  const double grad = sqrt(ghd * ghd + (g01r * g01r + g01i * g01i));
  const double s_max = sqrt(fmax(ght + grad, 0.0));
  const double s_min = sqrt(fmax(ght - grad, 0.0));
  const double cond = s_max / fmax(s_min, kEigEps);
  const Cx das0 = {0.5 * d0.re, 0.5 * d0.im}, das1 = {0.5 * d1.re, 0.5 * d1.im};
  if (!isfinite(cond) || cond > cond_thr) {
    w0 = das0;
    w1 = das1;
  }
  if (!cfinite(w0)) w0 = das0;
  if (!cfinite(w1)) w1 = das1;

  // 5. S = conj(w0) y0 + conj(w1) y1, rounded once, times the post-filter.
  for (int t = lane; t < T; t += 32) {
    const float2 a = y0[t], c = y1[t];
    const double ar = a.x, ai = a.y, cr = c.x, ci = c.y;
    float sr = (float)(w0.re * ar + w0.im * ai + (w1.re * cr + w1.im * ci));
    float si = (float)(w0.re * ai - w0.im * ar + (w1.re * ci - w1.im * cr));
    if (g) {
      sr *= g[t];
      si *= g[t];
    }
    s[t] = make_float2(sr, si);
  }
}

}  // namespace

// Y (B, 2, F, T) complex64; tmask (B, F, T) f32 (covariance weights are
// 1 - tmask); post (B, F, T) f32 or null; d (F, 2) complex64, phase-
// normalised; freqs (F,) f32; S (B, F, T) complex64. Returns cudaGetLastError().
extern "C" int azt_hard_null(const void* Y, const void* tmask, const void* post,
                             const void* d, const void* freqs, double cond_thr,
                             float bypass_hz, void* S, int B, int F, int T, void* stream) {
  const long rows = (long)B * F;
  const long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  hard_null_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)Y, (const float*)tmask, (const float*)post, (const float2*)d,
      (const float*)freqs, cond_thr, bypass_hz, (float2*)S, B, F, T);
  return (int)cudaGetLastError();
}
