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
// flops, but frame t needs frame t-1's state. The loop-carried chain is
// small: five independent FMAs a frame (R00, R11, Re R01, Im R01, w_sum),
// each fma(state, forget, m_t * (...)). The rest of a frame (its loads,
// three reciprocals, the 2x2 solve, the gain, the store) reads that frame's
// state and nothing later. The first kernel ran both in one thread per row,
// 17 warps for one stream's 513 rows, ~0.41 us a frame of one thread's
// latency.
//
// Design: the solves leave the chain. A block owns kRows rows (of any
// streams) and walks the frames in tiles of kTile:
//   - every thread copies tiles of Y's two channels and both masks into a
//     ring of kRing buffers in shared memory (cp.async, a warp per row and
//     32 frames, coalesced), three tiles ahead;
//   - warp 0, the chain warp, runs the recursion over tile i + 1, one lane
//     per row, the state in registers, and writes each frame's state (five
//     floats) to shared memory;
//   - warps 1 .. 7 meanwhile take the (row, frame) pairs of tile i, run the
//     solve, high-pass zeroing and floored gain on the state of that frame,
//     and write S, a row's 32 frames by a warp.
// Clips shorter than kDirectFrames (a hop is one frame) have no chain worth
// splitting: the tiles' copies, barriers and trips through shared memory
// cost more than they save, so one thread per row runs both, as the first
// kernel did.
// Every frame's arithmetic is the first kernel's source, expression for
// expression (accumulate and beamform below; the compiler contracts
// a * b + c * d to fma(a, b, c * d) in both), so the paths and the first
// kernel give the same bits, and T launches of one frame, each carrying the
// state through device memory (float32 both ways), give the bits of one
// launch over T frames. The divisions are SFU reciprocals and products,
// within 2 ulp each (the plain version divides; they agree to ~5e-7 of the
// output's peak).

#include <cuda_runtime.h>

namespace {

constexpr float kEpsDen = 1e-10f;  // distortionless denominator guard
constexpr int kRows = 16;          // rows of a block: the chain warp's lanes 0 .. 15
constexpr int kTile = 32;          // frames of a tile
constexpr int kRing = 4;           // tiles of input in shared memory
constexpr int kWarps = 8;          // the chain warp and seven solver warps
constexpr int kGroup = 8;          // frames the chain warp loads into registers at a time
constexpr int kDirectFrames = 12;  // clips shorter than this take one thread per row
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = kTile + 1;    // a tile's row: a frame of 16 rows lies in distinct banks

struct Tile {
  float2 y0[kRows][kPad], y1[kRows][kPad];  // Y's two channels
  float m[kRows][kPad], g[kRows][kPad];     // noise and target masks
};

struct States {  // the state after each frame of a tile: r00, r11, Re r01, Im r01, w_sum
  float q[5][kTile][kRows + 1];
};

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One frame of the recursion: the state (r00, r11, Re r01, Im r01, w_sum)
// takes frame (a, c) = (y0, y1) at noise-mask weight mt.
__device__ __forceinline__ void accumulate(float& r00, float& r11, float& r01r, float& r01i,
                                           float& ws, float2 a, float2 c, float mt,
                                           float forget) {
  // y y^H: [0, 0] = |y0|^2, [1, 1] = |y1|^2, [0, 1] = y0 conj(y1)
  r00 = forget * r00 + mt * (a.x * a.x + a.y * a.y);
  r11 = forget * r11 + mt * (c.x * c.x + c.y * c.y);
  r01r = forget * r01r + mt * (a.x * c.x + a.y * c.y);
  r01i = forget * r01i + mt * (a.y * c.x - a.x * c.y);
  ws = forget * ws + mt;
}

// One frame's output from that frame's state: w^H y with w the MVDR weights
// of R = R_sum / (w_sum + eps) + sigma I for steering (e0, e1), times the gain.
__device__ __forceinline__ float2 beamform(float r00, float r11, float r01r, float r01i, float ws,
                                           float2 a, float2 c, float2 e0, float2 e1, float sigma,
                                           float eps, float gain, bool has_gain) {
  // One reciprocal per divisor (the SFU's, within 2 ulp), then products.
  // Twelve IEEE divisions (each a branchy sequence of its own, in three
  // dependent stages) set the time of a frame in the first kernel: 1.02 us
  // against 0.43 with these at (2, 513, 1875) (kernels.bench online_mvdr
  // --against, PERF.md).
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
  if (has_gain) {
    sr *= gain;
    si *= gain;
  }
  return make_float2(sr, si);
}

// Short clips (a hop: T = 1) gain nothing from taking the solves off the
// chain and pay for the tiles' round trips through shared memory: one
// thread per row runs both, as the first kernel did, in the same code.
constexpr int kRowsThreads = 32;

__global__ void __launch_bounds__(kRowsThreads) online_mvdr_rows_kernel(
    const float2* __restrict__ Y, const float* __restrict__ nmask,
    const float* __restrict__ tmask, const float2* __restrict__ d, float sigma,
    const float* __restrict__ freqs, float hp_cutoff, float forget, float eps, float mask_floor,
    float2* __restrict__ R_state, float* __restrict__ w_state, float2* __restrict__ S, int B,
    int F, int T) {
  const long row = (long)blockIdx.x * kRowsThreads + threadIdx.x;  // b * F + f
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
    accumulate(r00, r11, r01r, r01i, ws, a, c, m[t], forget);
    if (!pass) {
      s[t] = make_float2(0.f, 0.f);
      continue;
    }
    const float gain = g ? (mask_floor > 0.f ? fmaxf(g[t], mask_floor) : g[t]) : 1.f;
    s[t] = beamform(r00, r11, r01r, r01i, ws, a, c, e0, e1, sigma, eps, gain, g != nullptr);
  }
  Rp[0] = make_float2(r00, 0.f);
  Rp[1] = make_float2(r01r, r01i);
  Rp[2] = make_float2(r01r, -r01i);
  Rp[3] = make_float2(r11, 0.f);
  w_state[row] = ws;
}

__global__ void __launch_bounds__(kThreads) online_mvdr_kernel(
    const float2* __restrict__ Y, const float* __restrict__ nmask,
    const float* __restrict__ tmask, const float2* __restrict__ d, float sigma,
    const float* __restrict__ freqs, float hp_cutoff, float forget, float eps, float mask_floor,
    float2* __restrict__ R_state, float* __restrict__ w_state, float2* __restrict__ S, int B,
    int F, int T) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile* tiles = reinterpret_cast<Tile*>(smem);                         // kRing
  States* states = reinterpret_cast<States*>(smem + kRing * sizeof(Tile));  // 2
  const long rows = (long)B * F;
  const long row0 = (long)blockIdx.x * kRows;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // A thread copies frame lane of rows warp + kWarps * j of every tile:
  // where those rows start in Y (channel 0; channel 1 is F * T further) and
  // in the masks, -1 past the last row.
  constexpr int kCopies = kRows / kWarps;
  long y_at[kCopies], m_at[kCopies];
#pragma unroll
  for (int j = 0; j < kCopies; ++j) {
    const long row = row0 + warp + kWarps * j, b = row / F;
    y_at[j] = row < rows ? ((2 * b) * F + (row - b * F)) * (long)T : -1;
    m_at[j] = row * T;
  }
  const long ch1 = (long)F * T;
  // Tile k of the block's rows into ring buffer k % kRing; frames past T
  // and rows past B * F are left as they are (nobody reads them).
  auto fetch = [&](int k) {
    const int ft = k * kTile + lane;
    if (k < n_tiles && ft < T) {
      Tile& tl = tiles[k % kRing];
#pragma unroll
      for (int j = 0; j < kCopies; ++j) {
        const int r = warp + kWarps * j;
        if (y_at[j] >= 0) {
          cp_async8(&tl.y0[r][lane], Y + y_at[j] + ft);
          cp_async8(&tl.y1[r][lane], Y + y_at[j] + ch1 + ft);
          cp_async4(&tl.m[r][lane], nmask + m_at[j] + ft);
          if (tmask) cp_async4(&tl.g[r][lane], tmask + m_at[j] + ft);
        }
      }
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  };
  fetch(0);
  fetch(1);
  fetch(2);

  // Per row, for the solves: its steering vector and whether it passes the
  // high-pass (read after the first barrier below).
  __shared__ float2 d_s[kRows][2];
  __shared__ bool keep[kRows];
  if (threadIdx.x < kRows && row0 + threadIdx.x < rows) {
    const int f = (int)((row0 + threadIdx.x) % F);
    d_s[threadIdx.x][0] = d[2 * f];
    d_s[threadIdx.x][1] = d[2 * f + 1];
    keep[threadIdx.x] = freqs[f] >= hp_cutoff;
  }

  // The chain warp's state: lane r holds row row0 + r.
  const long my_row = row0 + lane;
  const bool chain_lane = warp == 0 && lane < kRows && my_row < rows;
  float r00 = 0.f, r01r = 0.f, r01i = 0.f, r11 = 0.f, ws = 0.f;
  if (chain_lane) {
    const float2* Rp = R_state + my_row * 4;  // (2, 2) row-major: R00, R01, R10, R11
    r00 = Rp[0].x, r01r = Rp[1].x, r01i = Rp[1].y, r11 = Rp[3].x;
    ws = w_state[my_row];
  }
  // The recursion over tile k, in the first kernel's expressions. A group's
  // inputs are loaded into registers first (the state stores might alias
  // the next frame's loads, which would then wait for them), and a whole
  // group runs without a branch, so the compiler interleaves its frames.
  auto chain = [&](int k) {
    if (!chain_lane || k >= n_tiles) return;
    const Tile& tl = tiles[k % kRing];
    States& st = states[k & 1];
    const int nt = min(kTile, T - k * kTile);
    for (int t0 = 0; t0 < nt; t0 += kGroup) {
      float2 a[kGroup], c[kGroup];
      float m[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        a[j] = tl.y0[lane][t0 + j], c[j] = tl.y1[lane][t0 + j];
        m[j] = tl.m[lane][t0 + j];
      }
      auto step = [&](int j) {
        accumulate(r00, r11, r01r, r01i, ws, a[j], c[j], m[j], forget);
        st.q[0][t0 + j][lane] = r00;
        st.q[1][t0 + j][lane] = r11;
        st.q[2][t0 + j][lane] = r01r;
        st.q[3][t0 + j][lane] = r01i;
        st.q[4][t0 + j][lane] = ws;
      };
      if (t0 + kGroup <= nt) {
#pragma unroll
        for (int j = 0; j < kGroup; ++j) step(j);
      } else {
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          if (j < nt - t0) step(j);
      }
    }
  };

  cp_async_wait<2>();  // tile 0 is in
  __syncthreads();
  chain(0);
  __syncthreads();
  for (int i = 0; i < n_tiles; ++i) {
    fetch(i + 3);        // into the buffer of tile i - 1, which nobody reads any more
    cp_async_wait<2>();  // tile i + 1 is in
    __syncthreads();
    if (warp == 0) {
      chain(i + 1);
    } else {
      // ---- the solves of tile i: warps 1..7, a row's 32 frames a warp ----
      const Tile& tl = tiles[i % kRing];
      const States& st = states[i & 1];
      for (int pr = threadIdx.x - 32; pr < kRows * kTile; pr += kThreads - 32) {
        const int r = pr / kTile, t = pr - r * kTile, ft = i * kTile + t;
        const long row = row0 + r;
        if (row >= rows || ft >= T) continue;
        float2* s = S + row * T;
        if (!keep[r]) {
          s[ft] = make_float2(0.f, 0.f);
          continue;
        }
        const float gt = tl.g[r][t];
        const float gain = tmask ? (mask_floor > 0.f ? fmaxf(gt, mask_floor) : gt) : 1.f;
        s[ft] = beamform(st.q[0][t][r], st.q[1][t][r], st.q[2][t][r], st.q[3][t][r],
                         st.q[4][t][r], tl.y0[r][t], tl.y1[r][t], d_s[r][0], d_s[r][1], sigma,
                         eps, gain, tmask != nullptr);
      }
    }
    __syncthreads();  // tile i's buffers and states are free
  }
  if (chain_lane) {
    float2* Rp = R_state + my_row * 4;
    Rp[0] = make_float2(r00, 0.f);
    Rp[1] = make_float2(r01r, r01i);
    Rp[2] = make_float2(r01r, -r01i);
    Rp[3] = make_float2(r11, 0.f);
    w_state[my_row] = ws;
  }
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
  if (T < kDirectFrames) {
    online_mvdr_rows_kernel<<<(unsigned)((rows + kRowsThreads - 1) / kRowsThreads), kRowsThreads,
                              0, (cudaStream_t)stream>>>(
        (const float2*)Y, (const float*)nmask, (const float*)tmask, (const float2*)d, sigma,
        (const float*)freqs, hp_cutoff, forget, eps, mask_floor, (float2*)R_state,
        (float*)w_state, (float2*)S, B, F, T);
    return (int)cudaGetLastError();
  }
  const long blocks = (rows + kRows - 1) / kRows;
  constexpr int smem = kRing * sizeof(Tile) + 2 * sizeof(States);
  static bool raised = false;
  if (!raised) {  // dynamic shared memory above 48 KB must be opted into
    const cudaError_t e = cudaFuncSetAttribute(
        online_mvdr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  online_mvdr_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float2*)Y, (const float*)nmask, (const float*)tmask, (const float2*)d, sigma,
      (const float*)freqs, hp_cutoff, forget, eps, mask_floor, (float2*)R_state,
      (float*)w_state, (float2*)S, B, F, T);
  return (int)cudaGetLastError();
}
