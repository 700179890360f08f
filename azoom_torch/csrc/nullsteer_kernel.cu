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
// post-filter mask (4 B) and S (8 B) is touched once by the algorithm. At the
// serving shape (128 x 513 rows, T = 64) that is ~134 MB, 0.040 ms at
// 3.35 TB/s. The sums and the closed form are in float64, so the card and
// the float64 plain version (kernels/nullsteer_kernel.py:hard_null_plain)
// disagree on the cond gate only for rows within ~1e-12 of the threshold.
// The closed form is ~350 float64 instructions, 2 cycles each per warp on the
// H100's 64 float64 lanes per SM: run by all 32 lanes of a warp per row, it
// alone took as long as the bytes (0.046 ms at the serving shape).
//
// Design: a warp takes a group of kGroup = 4 consecutive rows. Lane l takes
// frames t = l, l + 32, ... of each row, as a warp per row would, loads the
// group's rows together and keeps 5 float64 partial sums per row, in t
// order. A reduce-scatter over the xor offsets 16 and 8, then a butterfly
// over 4, 2 and 1, leaves row r's five totals in lanes 8r .. 8r + 7: each
// addition pairs the same two operands, in the same order, as a butterfly
// per row, so the totals are bit for bit a warp_sum's, with 15 float64
// shuffles per row instead of 50. Each lane then runs the closed form for its
// row: a warp instruction serves 4 rows, not 1. The weights come back by
// shuffles and the apply pass reads the frames again, from L1. Occupancy is
// what the bytes need: the kernel is held to 96 registers (5 blocks of 4
// warps an SM); with 4 blocks (128 registers) it took 0.075 ms, not 0.059,
// and groups of 8 rows need more registers still.
//
// Steering per chunk: the tracked pipeline steers each chunk of a clip at its
// own bearing (azoom/pipelines/tracked.py vmaps the beamformer over chunks).
// Row (b, f) reads its steering vector at dvec + b * d_bstride + 2 f; a stride
// of 0 shares one (F, 2) vector over the batch, so the shared launch does the
// same arithmetic, bit for bit, as the kernel before the stride was added.
// Per chunk it adds B * F * 16 bytes.
//
// -DAZT_HARD_NULL_FIXED_WEIGHTS (kernels/bench.py only) replaces the closed
// form by the delay-and-sum weights: what the kernel costs without it.

#include <cuda_runtime.h>

namespace {

constexpr double kEpsNorm = 1e-6;   // masked_covariance normalisation guard
constexpr double kEps = 1e-10;      // hard_null_weights: phase and Cramer guards
constexpr double kEigEps = 1e-12;   // eigh_2x2_hermitian / cond_2x2 floors
constexpr double kRelTol = 1e-6;    // eigh_2x2_hermitian degeneracy, relative to scale
constexpr int kGroup = 4;           // rows per warp
constexpr int kScatterSteps = 2;    // log2(kGroup)
constexpr int kLanes = 32 / kGroup;  // lanes that hold each row's totals
static_assert(kGroup == 1 << kScatterSteps && kGroup <= 32, "kGroup: a power of two up to 32");
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

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

// The closed form: weights of one row from its normalised covariance
// [[R00, b], [conj(b), R11]], b = br + i bi, and its steering vector d.
__device__ __forceinline__ void hard_null_weights(double R00, double R11, double br, double bi,
                                                  Cx d0, Cx d1, double cond_thr, Cx& w0, Cx& w1) {
#ifdef AZT_HARD_NULL_FIXED_WEIGHTS
  w0 = {0.5 * d0.re + 0.0 * (R00 + R11 + br + bi), 0.5 * d0.im};
  w1 = {0.5 * d1.re, 0.5 * d1.im};
#else
  // 1. Principal eigenvector (eigh_2x2_hermitian's eigvecs[:, -1]).
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

  // 2. C = [d, v]; C^H w = [1, 0] by Cramer: w = [conj(v1), -conj(v0)] / det.
  const Cx p = cmul(cconj(d0), cconj(v1)), q = cmul(cconj(d1), cconj(v0));
  const Cx det = {p.re - q.re + kEps, p.im - q.im};
  w0 = cdiv(cconj(v1), det);
  w1 = cdiv({-v0.re, v0.im}, det);

  // 3. cond(C) from the eigenvalues of C^H C; the gate and the finiteness guard.
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
#endif
}

__global__ void __launch_bounds__(kThreads, 5) hard_null_kernel(
    const float2* __restrict__ Y, const float* __restrict__ tmask,
    const float* __restrict__ post, const float2* __restrict__ dvec, long d_bstride,
    const float* __restrict__ freqs, double cond_thr, float bypass_hz,
    float2* __restrict__ S, int B, int F, int T) {
  const int lane = threadIdx.x & 31;
  const long rows = (long)B * F, plane = (long)F * T;
  const long row0 = ((long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kGroup;  // rows are b * F + f
  if (row0 >= rows) return;
  const int n = (int)min((long)kGroup, rows - row0);
  const long b0 = row0 / F;
  const int f0 = (int)(row0 - b0 * F);
  const float2* y0[kGroup];  // row r: stream b0 + (f0 + r) / F, bin (f0 + r) % F; y1 a plane on
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    const int fr = f0 + min(r, n - 1);
    y0[r] = Y + ((2 * (b0 + fr / F)) * F + fr % F) * (long)T;
  }

  // 1. Partial sums of the interference covariance, in t order per lane; the
  // group's rows load together.
  double v[kGroup][5];
#pragma unroll
  for (int r = 0; r < kGroup; ++r)
#pragma unroll
    for (int q = 0; q < 5; ++q) v[r][q] = 0.0;
  for (int t = lane; t < T; t += 32) {
    float2 a[kGroup], c[kGroup];
    float m[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      if (r >= n) break;
      a[r] = y0[r][t];
      c[r] = y0[r][plane + t];
      m[r] = tmask[(row0 + r) * T + t];
    }
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      if (r >= n) break;
      const double w = (double)(1.0f - m[r]);
      const double ar = a[r].x, ai = a[r].y, cr = c[r].x, ci = c[r].y;
      v[r][0] += w;
      v[r][1] += w * (ar * ar + ai * ai);
      v[r][2] += w * (cr * cr + ci * ci);
      v[r][3] += w * (ar * cr + ai * ci);
      v[r][4] += w * (ai * cr - ar * ci);
    }
  }

  // 2. Reduce-scatter: at offset off a lane keeps the half of its rows whose
  // bit off it has and adds its partner's partial of the same rows; then a
  // butterfly over the offsets left. Row r's totals end in lanes r * kLanes ..
  // r * kLanes + kLanes - 1.
#pragma unroll
  for (int step = 0; step < kScatterSteps; ++step) {
    const int half = kGroup >> (step + 1), off = 16 >> step;
    const bool upper = lane & off;
#pragma unroll
    for (int r = 0; r < half; ++r)
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        const double keep = upper ? v[r + half][q] : v[r][q];
        const double send = upper ? v[r][q] : v[r + half][q];
        v[r][q] = keep + __shfl_xor_sync(kFull, send, off);
      }
  }
#pragma unroll
  for (int off = kLanes / 2; off >= 1; off >>= 1)
#pragma unroll
    for (int q = 0; q < 5; ++q) v[0][q] += __shfl_xor_sync(kFull, v[0][q], off);

  // 3. The closed form, once per lane for row lane / kLanes (rows >= n: row n - 1).
  Cx w0, w1;
  {
    const int fr = f0 + min(lane / kLanes, n - 1);
    const int f = fr % F;
    const double norm = v[0][0] + kEpsNorm;
    const double R00 = v[0][1] / norm, R11 = v[0][2] / norm;
    const double br = v[0][3] / norm, bi = v[0][4] / norm;
    const float2* db = dvec + (b0 + fr / F) * d_bstride;
    const float2 df0 = db[2 * f], df1 = db[2 * f + 1];
    hard_null_weights(R00, R11, br, bi, {df0.x, df0.y}, {df1.x, df1.y}, cond_thr, w0, w1);
  }
  double w[kGroup][4];
  bool bypass[kGroup];
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    w[r][0] = __shfl_sync(kFull, w0.re, r * kLanes);
    w[r][1] = __shfl_sync(kFull, w0.im, r * kLanes);
    w[r][2] = __shfl_sync(kFull, w1.re, r * kLanes);
    w[r][3] = __shfl_sync(kFull, w1.im, r * kLanes);
    bypass[r] = freqs[(f0 + min(r, n - 1)) % F] < bypass_hz;
  }

  // 4. S = conj(w0) y0 + conj(w1) y1, rounded once, times the post-filter;
  // below the bypass frequency S = y0 times the post-filter. The frames are
  // read again, from L1.
  for (int t = lane; t < T; t += 32) {
    float2 a[kGroup], c[kGroup];
    float g[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      if (r >= n) break;
      a[r] = y0[r][t];
      c[r] = y0[r][plane + t];
      g[r] = post ? post[(row0 + r) * T + t] : 1.0f;
    }
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      if (r >= n) break;
      float2 s;
      if (bypass[r]) {  // mic 0 passes through
        s = a[r];
        if (post) {
          s.x *= g[r];
          s.y *= g[r];
        }
      } else {
        const double ar = a[r].x, ai = a[r].y, cr = c[r].x, ci = c[r].y;
        float sr = (float)(w[r][0] * ar + w[r][1] * ai + (w[r][2] * cr + w[r][3] * ci));
        float si = (float)(w[r][0] * ai - w[r][1] * ar + (w[r][2] * ci - w[r][3] * cr));
        if (post) {
          sr *= g[r];
          si *= g[r];
        }
        s = make_float2(sr, si);
      }
      S[(row0 + r) * T + t] = s;
    }
  }
}

}  // namespace

// Y (B, 2, F, T) complex64; tmask (B, F, T) f32 (covariance weights are
// 1 - tmask); post (B, F, T) f32 or null; d complex64, phase-normalised,
// stream b's (F, 2) at d + b * d_bstride complex elements (0: shared); freqs
// (F,) f32; S (B, F, T) complex64. Returns cudaGetLastError().
extern "C" int azt_hard_null(const void* Y, const void* tmask, const void* post,
                             const void* d, long d_bstride, const void* freqs,
                             double cond_thr, float bypass_hz, void* S, int B, int F, int T,
                             void* stream) {
  const long groups = ((long)B * F + kGroup - 1) / kGroup;
  const long blocks = (groups + kWarps - 1) / kWarps;
  hard_null_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)Y, (const float*)tmask, (const float*)post, (const float2*)d, d_bstride,
      (const float*)freqs, cond_thr, bypass_hz, (float2*)S, B, F, T);
  return (int)cudaGetLastError();
}
