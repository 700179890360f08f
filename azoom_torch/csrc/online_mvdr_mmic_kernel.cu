// Recursive (online) masked MVDR for an STFT of M >= 3 mics, on Hopper
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
// What bounds it: at M <= 8 the bytes (Y, the masks and S: (8 M + 16) bytes
// per (row, t)), at M = 16 .. 32 the Cholesky's ~8 M^3 / 6 flops per (row,
// t), and at every M the frame-to-frame chain. Only the state update is
// loop-carried: M (M + 1) / 2 complex entries of the lower triangle and
// w_sum, each one independent FMA a frame. Frame t's factor, solves and
// output read frame t's state and nothing later. The first kernel ran both
// in one thread per row with IEEE divisions: 9 blocks of 64 threads for one
// stream's 513 rows, 2.5 us a frame of one thread's latency at M = 4.
//
// Design: the solves leave the chain, as in online_mvdr_kernel.cu, and a
// block owns few rows so that one stream fills the card (4 rows at M <= 8:
// 129 blocks for 513 bins; 1 row above). A block walks the frames in tiles
// (128 frames up to 4 mics, 64 up to 8, 16 above; fewer where the shared
// memory runs out):
//   - every warp copies runs of Y's M channels and of both masks into a ring
//     of kBuf tiles in shared memory (cp.async, a lane a frame), two tiles
//     ahead;
//   - the chain warps run the recursion over tile k + 1: one lane per state
//     entry (up to kMaxEntries entries a lane at large M; w_sum's lane runs
//     the same code), the entry in a register, its roundings spelled out;
//     each frame's state goes to a slot in shared memory (the lower triangle
//     as float2, then w_sum: an odd count of float2, so 32 slots in a row
//     lie in distinct banks);
//   - the solver warps meanwhile take tile k's (row, frame) slots. At M <= 8
//     one thread a slot: the slot into registers and the factor and the
//     substitutions unrolled over M at compile time, as the first kernel; a
//     solve is a long dependent chain, so the tile is as long as the slots'
//     shared memory and the registers allow (16 solver warps up to 4 mics, 8
//     above). At M > 8 a group of lanes a slot (16 lanes up to M = 16, a warp
//     above; M known at run time): lane l owns rows l, l + G of L and factors
//     in place in the slot, column by column; each entry's k-sum keeps
//     beam/linalgmm.py's order; the substitutions run column by column, the
//     pivots broadcast by shuffles.
// Divisions: one SFU reciprocal for w_sum + eps and one reciprocal square
// root per pivot, then products (the plain version divides; they agree to
// ~1e-6 of the output's peak); w = x / (d^H x + 1e-10) by the plain
// version's scaled complex division (cdiv), which stays finite where |d^H
// x|^2 would overflow float32. The state has none.
// Short clips at M <= 8 (a hop: T = 1) take one thread a row, the state in
// registers, as the first kernel: a tile's copies and barriers would cost
// more than they save. Both paths run the same per-frame code (accumulate,
// solve_frame), and at M > 8 a short clip takes one tile of its own length,
// so T launches of one frame, the state carried through device memory in
// float32, give the bits of one launch over T frames.
// The largest M is what one block's shared memory holds at the smallest
// tile of a row: two tiles of 8 slots of (M (M + 1) / 2 + 1) float2 and
// three input tiles, M = 57 on an H100 (227 KB a block). Above it the entry
// returns kTooLarge and azt_online_mvdr_m_smem says why.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr float kEpsDen = 1e-10f;   // distortionless denominator guard
constexpr float kPivotEps = 1e-7f;  // relative Cholesky pivot clamp (linalgmm's default)
constexpr int kBuf = 3;             // input tiles in shared memory: two fetched ahead
constexpr int kGroup = 8;           // frames a chain lane loads into registers at a time
constexpr int kMaxEntries = 6;      // state entries of one chain lane (M > 8)
constexpr int kMaxChainThreads = 320;
constexpr int kMinTile = 8;         // the smallest tile the plan takes (short clips aside)
constexpr int kDirectFrames = 2;    // M <= 8: clips shorter than this take one thread a row
constexpr int kRowsThreads = 64;
constexpr int kMaxSolverWarps = 16;  // M > 8
constexpr int kDynamicThreads = 832;  // M > 8: at most 10 chain and 16 solver warps
constexpr int kTooLarge = -1;       // M's plan exceeds one block's shared memory

// M <= 8: the tile (frames) and threads of a block. 128 frames of 4 rows
// (16 solver warps) up to 4 mics, 64 (8 warps) above: a solve is a long
// dependent chain, so a scheduler needs several solver warps to stay busy,
// as many as the registers and the shared memory of the slots allow.
__host__ __device__ constexpr int static_tile(int M) { return M <= 4 ? 128 : 64; }
__host__ __device__ constexpr int static_threads(int M) { return M <= 4 ? 576 : 416; }

struct Plan {
  int R;      // rows of a block
  int TT;     // frames of a tile
  int TTP;    // a channel's stride in an input tile (odd: channels in distinct banks)
  int K;      // entries of the lower triangle
  int n2;     // float2 of a state slot (odd)
  int ct;     // chain threads
  int ept;    // entries a chain thread carries
  int cw;     // chain warps
  int sw;     // solver warps
  int group;  // lanes of a solve (1 at M <= 8)
  size_t smem;
};

__host__ __device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

Plan make_plan(int M, int T, int tile) {
  Plan p;
  p.K = tri(M);
  p.n2 = (p.K + 1) | 1;
  p.R = M <= 8 ? 4 : 1;
  p.group = M <= 8 ? 1 : (M <= 16 ? 16 : 32);  // lanes of a solve
  p.TT = T < tile ? T : tile;
  p.TTP = p.TT | 1;
  const int entries = p.R * (p.K + 1);
  p.ept = (entries + kMaxChainThreads - 1) / kMaxChainThreads;
  p.ct = (entries + p.ept - 1) / p.ept;
  p.cw = (p.ct + 31) / 32;
  const int solves = p.R * p.TT, per_warp = 32 / p.group;
  p.sw = (solves + per_warp - 1) / per_warp;
  if (p.sw > kMaxSolverWarps) p.sw = kMaxSolverWarps;
  p.smem = sizeof(float2) * ((size_t)2 * p.R * p.TT * p.n2 + (size_t)kBuf * p.R * M * p.TTP +
                             (size_t)p.R * M) +
           sizeof(long) * (size_t)p.R + sizeof(float) * (size_t)2 * kBuf * p.R * p.TT +
           sizeof(int) * (size_t)p.R;
  return p;
}

int smem_limit() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return v;
}

// The plan for a clip of T frames: the largest tile of M's default whose
// shared memory fits, halving down to kMinTile.
Plan plan_for(int M, int T, int limit) {
  int tile = M <= 8 ? static_tile(M) : (M <= 16 ? 32 : 16);  // M > 8: 16 solver warps
  Plan p = make_plan(M, T, tile);
  while (p.smem > (size_t)limit && tile > kMinTile) {
    tile /= 2;
    p = make_plan(M, T, tile);
  }
  return p;
}

bool fits(int M, int limit) {
  const Plan p = make_plan(M, kMinTile, kMinTile);
  return p.smem <= (size_t)limit && p.ept <= kMaxEntries;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {  // a b
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {  // a conj(b)
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// x / z as c10::complex divides (Smith's scaled division, the plain
// version's): |z|^2 is never formed, so a |z| above ~1.8e19 (the clamped
// pivots of a near-singular frame) still gives a finite quotient. z's
// factors are taken once a frame: rat its smaller part over its larger,
// scl one over (the larger + the smaller rat).
struct CDiv {
  float rat, scl;
  bool re;  // |z.x| >= |z.y|
};

__device__ __forceinline__ CDiv cdiv_of(float2 z) {
  CDiv c;
  c.re = fabsf(z.x) >= fabsf(z.y);
  c.rat = c.re ? z.y / z.x : z.x / z.y;
  c.scl = 1.0f / (c.re ? z.x + z.y * c.rat : z.y + z.x * c.rat);
  return c;
}

__device__ __forceinline__ float2 cdiv(float2 a, const CDiv& c) {
  return c.re ? make_float2((a.x + a.y * c.rat) * c.scl, (a.y - a.x * c.rat) * c.scl)
              : make_float2((a.x * c.rat + a.y) * c.scl, (a.y * c.rat - a.x) * c.scl);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// One frame's output at M <= 8 from that frame's state r (the lower
// triangle, row-major; factored in place) and w_sum: w^H y for steering e.
template <int M>
__device__ __forceinline__ float2 solve_frame(float2 (&r)[M * (M + 1) / 2], float ws,
                                              const float2 (&yv)[M], const float2 (&e)[M],
                                              float sigma, float eps) {
  // R = R_sum / (w_sum + eps) + sigma I, factored as L L^H (linalgmm.cholesky_small);
  // the diagonal of L keeps its reciprocal
  const float rden = __fdividef(1.0f, ws + eps);
  float diag_max = r[0].x * rden + sigma;
#pragma unroll
  for (int j = 1; j < M; ++j) diag_max = fmaxf(diag_max, r[tri(j) + j].x * rden + sigma);
  const float floor = kPivotEps * diag_max + 1e-30f;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float sj = r[tri(j) + j].x * rden + sigma;
#pragma unroll
    for (int k = 0; k < j; ++k) {
      const float2 l = r[tri(j) + k];
      sj = sj - (l.x * l.x + l.y * l.y);
    }
    const float rp = rsqrtf(fmaxf(sj, floor));
    r[tri(j) + j] = make_float2(rp, 0.f);
#pragma unroll
    for (int i = j + 1; i < M; ++i) {
      const float2 q = r[tri(i) + j];
      float2 tt = make_float2(q.x * rden, q.y * rden);
#pragma unroll
      for (int k = 0; k < j; ++k) tt = csub(tt, cmulc(r[tri(i) + k], r[tri(j) + k]));
      r[tri(i) + j] = make_float2(tt.x * rp, tt.y * rp);
    }
  }
  // L v = d, then L^H x = v (v is overwritten by x)
  float2 x[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float2 acc = e[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc = csub(acc, cmul(r[tri(i) + k], x[k]));
    const float rp = r[tri(i) + i].x;
    x[i] = make_float2(acc.x * rp, acc.y * rp);
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    float2 acc = x[i];
#pragma unroll
    for (int k = i + 1; k < M; ++k) {
      const float2 l = r[tri(k) + i];  // conj(L[k][i]) x[k]
      acc = csub(acc, cmul(make_float2(l.x, -l.y), x[k]));
    }
    const float rp = r[tri(i) + i].x;
    x[i] = make_float2(acc.x * rp, acc.y * rp);
  }
  // z = d^H x + 1e-10; w = x / z (cdiv); s = w^H y
  float2 z = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float2 p = cmulc(x[i], e[i]);  // conj(e) x
    z.x += p.x;
    z.y += p.y;
  }
  z.x += kEpsDen;
  const CDiv cz = cdiv_of(z);
  float sr = 0.f, si = 0.f;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float2 w = cdiv(x[i], cz);
    const float2 p = cmulc(yv[i], w);  // conj(w) y
    sr += p.x;
    si += p.y;
  }
  return make_float2(sr, si);
}

// The recursion's step for one entry of the lower triangle (the direct and
// the tiled path share it): R_sum = forget R_sum + m_t y y^H, (a, c) = (y_i,
// y_j); the diagonal stays real. The roundings are spelled out, so both
// paths round alike: each product, then fma(forget, q, o m_t), the form
// the first kernel's source reads as (its compiler contracted some entries
// otherwise: PERF.md counts the state elements that differ from it).
__device__ __forceinline__ float2 accumulate(float2 q, float2 a, float2 c, float mt,
                                             float forget, bool diag) {
  const float ox = __fmaf_rn(a.x, c.x, __fmul_rn(a.y, c.y));
  const float oy = __fmaf_rn(a.y, c.x, -__fmul_rn(a.x, c.y));
  q.x = __fmaf_rn(forget, q.x, __fmul_rn(ox, mt));
  q.y = diag ? 0.f : __fmaf_rn(forget, q.y, __fmul_rn(oy, mt));
  return q;
}

// w_sum = forget w_sum + m_t, as the first kernel rounds it.
__device__ __forceinline__ float accumulate_w(float ws, float mt, float forget) {
  return __fmaf_rn(forget, ws, mt);
}

// One solve at M > 8 by a group of G lanes (lane l owns rows l + G q of L, q
// < NQ): L is the slot (the frame's state, factored in place), e the row's
// steering vector, y its frame (channel m at y[m * ystride]). Returns w^H y
// on every lane of the group; writes to L only where ``have``. Column j
// (linalgmm.cholesky_small): rows i >= j take R[i][j] less sum_k<j L[i][k]
// conj(L[j][k]) in k's order (the diagonal's real part: s - (l.x l.x + l.y
// l.y)); row j's lane broadcasts the pivot; rows i > j store L[i][j] over
// R[i][j]. The diagonal is never stored: each lane keeps its rows'
// reciprocal pivots. Then L v = d by columns (row k's lane finishes v_k and
// broadcasts it, rows i > k take L[i][k] v_k off, in k's order) and L^H x =
// v from the last row.
template <int NQ>
__device__ __forceinline__ float2 solve_group_slot(float2* L, int M, int K, int G, int gl,
                                                   bool have, const float2* e, const float2* y,
                                                   int ystride, float sigma, float eps) {
  const float2 zero = make_float2(0.f, 0.f);
  int ii[NQ], bb[NQ];  // the lane's rows, where they start in the slot
  bool own[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    ii[q] = gl + G * q;
    own[q] = ii[q] < M;
    bb[q] = tri(ii[q]);
  }
  const float rden = __fdividef(1.0f, L[K].x + eps);
  float dm = -FLT_MAX;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    if (own[q]) dm = fmaxf(dm, L[bb[q] + ii[q]].x * rden + sigma);
  for (int o = G / 2; o > 0; o >>= 1) dm = fmaxf(dm, __shfl_xor_sync(~0u, dm, o, G));
  const float floor = kPivotEps * dm + 1e-30f;
  float rp[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) rp[q] = 0.f;
  for (int j = 0; j < M; ++j) {
    bool act[NQ];
    float2 acc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      act[q] = own[q] && ii[q] >= j;
      const float2 v = act[q] ? L[bb[q] + j] : zero;
      acc[q] = ii[q] == j ? make_float2(v.x * rden + sigma, 0.f) : make_float2(v.x * rden, v.y * rden);
    }
    const float2* lj = L + tri(j);
    int kk = 0;
    for (; kk + 2 <= j; kk += 2) {  // two steps' loads first
      const float2 c0 = lj[kk], c1 = lj[kk + 1];
      float2 x0[NQ], x1[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        x0[q] = act[q] ? L[bb[q] + kk] : zero;
        x1[q] = act[q] ? L[bb[q] + kk + 1] : zero;
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        acc[q] = csub(acc[q], cmulc(x0[q], c0));
        acc[q] = csub(acc[q], cmulc(x1[q], c1));
      }
    }
    if (kk < j) {
      const float2 c0 = lj[kk];
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[q] = csub(acc[q], cmulc(act[q] ? L[bb[q] + kk] : zero, c0));
    }
    float sj = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      if (ii[q] == j) sj = acc[q].x;
    const float rpj = rsqrtf(fmaxf(__shfl_sync(~0u, sj, j % G, G), floor));
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      if (ii[q] == j) rp[q] = rpj;
      if (have && act[q] && ii[q] > j) L[bb[q] + j] = make_float2(acc[q].x * rpj, acc[q].y * rpj);
    }
    __syncwarp();  // column j is in before row j + 1 is read
  }
  float2 v[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) v[q] = own[q] ? e[ii[q]] : zero;
  for (int kk = 0; kk < M; ++kk) {
    float2 l[NQ], vk = zero;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      l[q] = own[q] && ii[q] > kk ? L[bb[q] + kk] : zero;
      if (ii[q] == kk) vk = make_float2(v[q].x * rp[q], v[q].y * rp[q]);
    }
    vk.x = __shfl_sync(~0u, vk.x, kk % G, G);
    vk.y = __shfl_sync(~0u, vk.y, kk % G, G);
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      v[q] = ii[q] == kk ? vk : (ii[q] > kk ? csub(v[q], cmul(l[q], vk)) : v[q]);
  }
  for (int kk = M - 1; kk >= 0; --kk) {
    const float2* lk = L + tri(kk);  // conj(L[k][i]) x_k for rows i < k
    float2 l[NQ], xk = zero;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      l[q] = own[q] && ii[q] < kk ? lk[ii[q]] : zero;
      if (ii[q] == kk) xk = make_float2(v[q].x * rp[q], v[q].y * rp[q]);
    }
    xk.x = __shfl_sync(~0u, xk.x, kk % G, G);
    xk.y = __shfl_sync(~0u, xk.y, kk % G, G);
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      v[q] = ii[q] == kk ? xk
                         : (ii[q] < kk ? csub(v[q], cmul(make_float2(l[q].x, -l[q].y), xk)) : v[q]);
  }
  // z = d^H x + 1e-10; w = x / z (cdiv); s = w^H y
  float2 z = zero;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (own[q]) {
      const float2 pz = cmulc(v[q], e[ii[q]]);  // conj(e) x
      z.x += pz.x;
      z.y += pz.y;
    }
  }
  for (int o = G / 2; o > 0; o >>= 1) {
    z.x += __shfl_xor_sync(~0u, z.x, o, G);
    z.y += __shfl_xor_sync(~0u, z.y, o, G);
  }
  z.x += kEpsDen;
  const CDiv cz = cdiv_of(z);
  float2 sv = zero;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (own[q]) {
      const float2 w = cdiv(v[q], cz);
      const float2 ps = cmulc(y[ii[q] * ystride], w);  // conj(w) y
      sv.x += ps.x;
      sv.y += ps.y;
    }
  }
  for (int o = G / 2; o > 0; o >>= 1) {
    sv.x += __shfl_xor_sync(~0u, sv.x, o, G);
    sv.y += __shfl_xor_sync(~0u, sv.y, o, G);
  }
  return sv;
}

// Short clips at M <= 8 (a hop: T = 1): one thread a row runs the recursion
// and the solve of each frame, the state in registers, as the first kernel,
// in the tiles' per-frame code (accumulate, solve_frame), so both paths give
// the same bits.
template <int M>
__global__ void __launch_bounds__(kRowsThreads) online_mvdr_m_rows_kernel(
    const float2* __restrict__ Y, const float* __restrict__ nmask,
    const float* __restrict__ tmask, const float2* __restrict__ d, float sigma,
    const float* __restrict__ freqs, float hp_cutoff, float forget, float eps, float mask_floor,
    float2* __restrict__ R_state, float* __restrict__ w_state, float2* __restrict__ S, int B,
    int F, int T) {
  constexpr int kTri = M * (M + 1) / 2;
  const long row = (long)blockIdx.x * kRowsThreads + threadIdx.x;  // b * F + f
  if (row >= (long)B * F) return;
  const long b = row / F;
  const int f = (int)(row - b * F);
  const float2* y = Y + ((long)M * b * F + f) * T;  // channel m at y + m * F * T
  const long ch = (long)F * T;
  float2* Rp = R_state + row * (M * M);  // (M, M) row-major
  float2 r[kTri];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) r[tri(i) + j] = Rp[i * M + j];
    r[tri(i) + i].y = 0.f;
  }
  float ws = w_state[row];
  float2 e[M];
#pragma unroll
  for (int i = 0; i < M; ++i) e[i] = d[f * M + i];
  const bool pass = freqs[f] >= hp_cutoff;
  for (int t = 0; t < T; ++t) {
    float2 yv[M];
#pragma unroll
    for (int i = 0; i < M; ++i) yv[i] = y[i * ch + t];
    const float mt = nmask[row * T + t];
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) r[tri(i) + j] = accumulate(r[tri(i) + j], yv[i], yv[j], mt,
                                                                forget, i == j);
    }
    ws = accumulate_w(ws, mt, forget);
    float2* s = S + row * T + t;
    if (!pass) {
      *s = make_float2(0.f, 0.f);
      continue;
    }
    float2 rr[kTri];
#pragma unroll
    for (int i = 0; i < kTri; ++i) rr[i] = r[i];
    float2 out = solve_frame<M>(rr, ws, yv, e, sigma, eps);
    if (tmask) {
      const float gt = tmask[row * T + t];
      const float gain = mask_floor > 0.f ? fmaxf(gt, mask_floor) : gt;
      out.x *= gain;
      out.y *= gain;
    }
    *s = out;
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const float2 q = r[tri(i) + j];
      Rp[i * M + j] = q;
      if (j < i) Rp[j * M + i] = make_float2(q.x, -q.y);
    }
  }
  w_state[row] = ws;
}

// The tiled kernel. MS = M (3 .. 8) at compile time, or 0: M taken at run
// time (M > 8).
template <int MS>
__global__ void __launch_bounds__(MS > 0 ? static_threads(MS) : kDynamicThreads)
    online_mvdr_m_kernel(const float2* __restrict__ Y, const float* __restrict__ nmask,
                         const float* __restrict__ tmask, const float2* __restrict__ d,
                         float sigma, const float* __restrict__ freqs, float hp_cutoff,
                         float forget, float eps, float mask_floor, float2* __restrict__ R_state,
                         float* __restrict__ w_state, float2* __restrict__ S, int B, int F,
                         int T, int m_run, Plan p) {
  const int M = MS > 0 ? MS : m_run;
  constexpr int kEntries = MS > 0 ? 1 : kMaxEntries;  // M <= 8: R (K + 1) <= 148 lanes
  constexpr int kChainGroup = MS > 0 ? kGroup : kGroup / 2;  // M > 8: the solves bound it
  extern __shared__ __align__(16) unsigned char smem[];
  float2* states = reinterpret_cast<float2*>(smem);  // 2 x (R x TT slots of n2)
  float2* ytile = states + 2 * p.R * p.TT * p.n2;     // kBuf x R x M x TTP
  float2* d_s = ytile + kBuf * p.R * M * p.TTP;       // R x M
  long* y_at = reinterpret_cast<long*>(d_s + p.R * M);  // R: a row's channel 0 in Y
  float* mtile = reinterpret_cast<float*>(y_at + p.R);  // kBuf x R x TT
  float* gtile = mtile + kBuf * p.R * p.TT;              // kBuf x R x TT
  int* keep = reinterpret_cast<int*>(gtile + kBuf * p.R * p.TT);  // R

  const long rows = (long)B * F;
  const long row0 = (long)blockIdx.x * p.R;
  const int n_tiles = (T + p.TT - 1) / p.TT;
  const int tid = threadIdx.x, nwarps = blockDim.x >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int slots = p.R * p.TT;
  const long ch = (long)F * T;  // a channel's stride in Y

  // Per row: where its channel 0 starts in Y, its steering vector and
  // whether it passes the high-pass (read after the first barrier below).
  for (int r = tid; r < p.R; r += blockDim.x) {
    const long row = row0 + r, b = row / F;
    y_at[r] = row < rows ? (b * M * F + (row - b * F)) * (long)T : -1;
    keep[r] = row < rows && freqs[row % F] >= hp_cutoff;
  }
  for (int idx = tid; idx < p.R * M; idx += blockDim.x) {
    const long row = row0 + idx / M;
    if (row < rows) d_s[idx] = d[(row % F) * M + idx % M];
  }
  __syncthreads();

  // Tile k of the block's rows into ring buffer k % kBuf: a warp a run (R x M
  // runs of Y, then R of each mask), a lane a frame; frames past T and rows
  // past B * F are left as they are (nobody reads them).
  auto fetch = [&](int k) {
    if (k < n_tiles) {
      const int t0 = k * p.TT, nt = min(p.TT, T - t0), buf = k % kBuf;
      const int y_runs = p.R * M, runs = y_runs + 2 * p.R;
      for (int run = warp; run < runs; run += nwarps) {
        if (run < y_runs) {
          const int r = run / M, m = run - r * M;
          if (y_at[r] < 0) continue;
          const float2* src = Y + y_at[r] + m * ch + t0;
          float2* dst = ytile + ((buf * p.R + r) * M + m) * p.TTP;
          for (int t = lane; t < nt; t += 32) cp_async8(dst + t, src + t);
        } else {
          const int r = (run - y_runs) % p.R;
          const bool target = run - y_runs >= p.R;
          const long row = row0 + r;
          if (row >= rows || (target && !tmask)) continue;
          const float* src = (target ? tmask : nmask) + row * T + t0;
          float* dst = (target ? gtile : mtile) + (buf * p.R + r) * p.TT;
          for (int t = lane; t < nt; t += 32) cp_async4(dst + t, src + t);
        }
      }
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
  fetch(0);
  fetch(1);

  // The chain lanes' entries: flat index tid + u * ct over the block's R x
  // (K + 1) entries, row-major: (i, j) of the lower triangle at i (i + 1) / 2
  // + j, then w_sum at K. code = r << 20 | i << 10 | j (i = 1023: w_sum), -1
  // for none; q the entry.
  int code[kEntries];
  float2 q[kEntries];
#pragma unroll
  for (int u = 0; u < kEntries; ++u) {
    code[u] = -1;
    q[u] = make_float2(0.f, 0.f);
    const int flat = tid + u * p.ct;
    if (tid < p.ct && u < p.ept && flat < p.R * (p.K + 1)) {
      const int r = flat / (p.K + 1), e = flat - r * (p.K + 1);
      const long row = row0 + r;
      if (row < rows) {
        if (e == p.K) {
          code[u] = r << 20 | 1023 << 10;
          q[u].x = w_state[row];
        } else {
          int i = (int)((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
          while (tri(i + 1) <= e) ++i;
          while (tri(i) > e) --i;
          const int j = e - tri(i);
          code[u] = r << 20 | i << 10 | j;
          float2 v = R_state[row * M * M + i * M + j];
          if (i == j) v.y = 0.f;
          q[u] = v;
        }
      }
    }
  }

  // The recursion over tile k. A group's inputs are loaded into registers
  // first (the slot stores might alias the next frame's loads, which would
  // then wait for them).
  auto chain = [&](int k) {
#ifdef AZT_OMVDR_NO_CHAIN  // a diagnostic build: the solves alone (kernels.bench --roles)
    return;
#endif
    if (tid >= p.ct || k >= n_tiles) return;
    const int buf = k % kBuf, nt = min(p.TT, T - k * p.TT);
    float2* st = states + (k & 1) * slots * p.n2;
#pragma unroll
    for (int u = 0; u < kEntries; ++u) {
      if (code[u] < 0) continue;
      // every lane runs the same code: w_sum's lane reads channel 0 and drops it
      const int r = code[u] >> 20, i = (code[u] >> 10) & 1023, j = code[u] & 1023;
      const bool wsum = i == 1023, diag = i == j;
      const float* mm = mtile + (buf * p.R + r) * p.TT;
      float2* out = st + r * p.TT * p.n2 + (wsum ? p.K : tri(i) + j);
      const float2* yi = ytile + ((buf * p.R + r) * M + (wsum ? 0 : i)) * p.TTP;
      const float2* yj = ytile + ((buf * p.R + r) * M + (wsum ? 0 : j)) * p.TTP;
      float2 qq = q[u];
      for (int t0 = 0; t0 < nt; t0 += kChainGroup) {
        const int n = min(kChainGroup, nt - t0);
        float2 a[kChainGroup], c[kChainGroup];
        float mt[kChainGroup];
#pragma unroll
        for (int g = 0; g < kChainGroup; ++g) {
          if (g < n) {
            a[g] = yi[t0 + g], c[g] = yj[t0 + g];
            mt[g] = mm[t0 + g];
          }
        }
#pragma unroll
        for (int g = 0; g < kChainGroup; ++g) {
          if (g < n) {
            const float2 e = accumulate(qq, a[g], c[g], mt[g], forget, diag);
            qq = wsum ? make_float2(accumulate_w(qq.x, mt[g], forget), 0.f) : e;
            out[(t0 + g) * p.n2] = qq;
          }
        }
      }
      q[u] = qq;
    }
  };

  // The gain of slot (r, t) of tile buffer buf.
  auto gain_of = [&](int buf, int r, int t) {
    const float gt = gtile[(buf * p.R + r) * p.TT + t];
    return mask_floor > 0.f ? fmaxf(gt, mask_floor) : gt;
  };

  // The solves of tile k, M <= 8: one thread a slot.
  auto solve_static = [&](int k) {
#ifdef AZT_OMVDR_NO_SOLVE  // a diagnostic build: the chain alone (kernels.bench --roles)
    return;
#endif
    if constexpr (MS > 0) {
      const int buf = k % kBuf;
      const float2* st = states + (k & 1) * slots * p.n2;
      for (int pr = tid - 32 * p.cw; pr < slots; pr += 32 * p.sw) {
        const int r = pr / p.TT, t = pr - r * p.TT, ft = k * p.TT + t;
        const long row = row0 + r;
        if (row >= rows || ft >= T) continue;
        float2* s = S + row * T + ft;
        if (!keep[r]) {
          *s = make_float2(0.f, 0.f);
          continue;
        }
        const float2* slot = st + pr * p.n2;
        float2 rr[MS * (MS + 1) / 2], yv[MS], e[MS];
#pragma unroll
        for (int i = 0; i < MS * (MS + 1) / 2; ++i) rr[i] = slot[i];
        const float ws = slot[MS * (MS + 1) / 2].x;
#pragma unroll
        for (int i = 0; i < MS; ++i) {
          yv[i] = ytile[((buf * p.R + r) * MS + i) * p.TTP + t];
          e[i] = d_s[r * MS + i];
        }
        float2 out = solve_frame<MS>(rr, ws, yv, e, sigma, eps);
        if (tmask) {
          const float gain = gain_of(buf, r, t);
          out.x *= gain;
          out.y *= gain;
        }
        *s = out;
      }
    }
  };

  // The solves of tile k, M > 8: a group of G lanes a slot, factored in place
  // (solve_group_slot; one row of L a lane up to M = G, two above).
  auto solve_group = [&](int k) {
#ifdef AZT_OMVDR_NO_SOLVE
    return;
#endif
    if constexpr (MS == 0) {
      const int G = p.group, per_warp = 32 / G, gl = lane % G;
      const int buf = k % kBuf;
      float2* st = states + (k & 1) * slots * p.n2;
      for (int base = (warp - p.cw) * per_warp; base < slots; base += p.sw * per_warp) {
        const int pr = base + lane / G;
        const bool have = pr < slots;  // this group owns slot pr
        const int r = have ? pr / p.TT : 0, t = have ? pr - r * p.TT : 0;
        const long row = row0 + r;
        const int ft = k * p.TT + t;
        float2* L = st + (have ? pr : 0) * p.n2;
        const float2* y = ytile + (buf * p.R + r) * M * p.TTP + t;
        float2 sv = M <= G ? solve_group_slot<1>(L, M, p.K, G, gl, have, d_s + r * M, y, p.TTP,
                                                 sigma, eps)
                           : solve_group_slot<2>(L, M, p.K, G, gl, have, d_s + r * M, y, p.TTP,
                                                 sigma, eps);
        if (have && row < rows && ft < T && gl == 0) {
          if (!keep[r]) {
            sv = make_float2(0.f, 0.f);
          } else if (tmask) {
            const float gain = gain_of(buf, r, t);
            sv.x *= gain;
            sv.y *= gain;
          }
          S[row * T + ft] = sv;
        }
        __syncwarp();
      }
    }
  };

  cp_async_wait1();  // tile 0 is in
  __syncthreads();
  chain(0);
  __syncthreads();
  for (int k = 0; k < n_tiles; ++k) {
    fetch(k + 2);      // into the buffer of tile k - 1, which nobody reads any more
    cp_async_wait1();  // tile k + 1 is in
    __syncthreads();
    if (warp < p.cw) {
      chain(k + 1);
    } else if constexpr (MS > 0) {
      solve_static(k);
    } else {
      solve_group(k);
    }
    __syncthreads();  // tile k's buffers and slots are free
  }
#pragma unroll
  for (int u = 0; u < kEntries; ++u) {
    if (code[u] < 0) continue;
    const long row = row0 + (code[u] >> 20);
    const int i = (code[u] >> 10) & 1023, j = code[u] & 1023;
    if (i == 1023) {
      w_state[row] = q[u].x;
    } else {
      float2* Rp = R_state + row * M * M;  // (M, M) row-major
      Rp[i * M + j] = q[u];
      if (j < i) Rp[j * M + i] = make_float2(q[u].x, -q[u].y);
    }
  }
}

template <int MS>
int launch(int M, const void* Y, const void* nmask, const void* tmask, const void* d,
           float sigma, const void* freqs, float hp_cutoff, float forget, float eps,
           float mask_floor, void* R_state, void* w_state, void* S, int B, int F, int T,
           void* stream) {
  const long rows = (long)B * F;
  if constexpr (MS > 0) {
    if (T < kDirectFrames) {
      online_mvdr_m_rows_kernel<MS><<<(unsigned)((rows + kRowsThreads - 1) / kRowsThreads),
                                      kRowsThreads, 0, (cudaStream_t)stream>>>(
          (const float2*)Y, (const float*)nmask, (const float*)tmask, (const float2*)d, sigma,
          (const float*)freqs, hp_cutoff, forget, eps, mask_floor, (float2*)R_state,
          (float*)w_state, (float2*)S, B, F, T);
      return (int)cudaGetLastError();
    }
  }
  const int limit = smem_limit();
  if (!fits(M, limit)) return kTooLarge;
  const Plan p = plan_for(M, T, limit);
  // dynamic shared memory above 48 KB must be opted into, once per device
  static bool raised[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        online_mvdr_m_kernel<MS>, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  online_mvdr_m_kernel<MS><<<(unsigned)((rows + p.R - 1) / p.R), 32 * (p.cw + p.sw), p.smem,
                             (cudaStream_t)stream>>>(
      (const float2*)Y, (const float*)nmask, (const float*)tmask, (const float2*)d, sigma,
      (const float*)freqs, hp_cutoff, forget, eps, mask_floor, (float2*)R_state,
      (float*)w_state, (float2*)S, B, F, T, M, p);
  return (int)cudaGetLastError();
}

}  // namespace

// M >= 3 (up to what one block's shared memory holds: azt_online_mvdr_m_smem);
// Y (B, M, F, T) complex64; nmask (B, F, T) f32; tmask (B, F, T) f32 or
// null; d (F, M) complex64; freqs (F,) f32; R_state (B, F, M, M) complex64
// and w_state (B, F) f32, read and written back; S (B, F, T) complex64.
// Returns cudaGetLastError(), cudaErrorInvalidValue for M < 3, or kTooLarge
// (-1) when M's plan exceeds the shared memory of one block.
extern "C" int azt_online_mvdr_m(int M, const void* Y, const void* nmask, const void* tmask,
                                 const void* d, float sigma, const void* freqs, float hp_cutoff,
                                 float forget, float eps, float mask_floor, void* R_state,
                                 void* w_state, void* S, int B, int F, int T, void* stream) {
#define AZT_CASE(K)                                                                            \
  case K:                                                                                      \
    return launch<K>(M, Y, nmask, tmask, d, sigma, freqs, hp_cutoff, forget, eps, mask_floor, \
                     R_state, w_state, S, B, F, T, stream);
  switch (M) {
    AZT_CASE(3)
    AZT_CASE(4)
    AZT_CASE(5)
    AZT_CASE(6)
    AZT_CASE(7)
    AZT_CASE(8)
    default:
      if (M < 3) return (int)cudaErrorInvalidValue;
      return launch<0>(M, Y, nmask, tmask, d, sigma, freqs, hp_cutoff, forget, eps, mask_floor,
                       R_state, w_state, S, B, F, T, stream);
  }
#undef AZT_CASE
}

// The shared memory M mics need at the smallest tile of one row (the
// kernel's limit, whatever T); *limit gets the current device's limit for
// one block. (The chain lanes carry every M whose tiles fit: M < 64.)
extern "C" long azt_online_mvdr_m_smem(int M, long* limit) {
  *limit = smem_limit();
  return (long)make_plan(M, kMinTile, kMinTile).smem;
}
