// Int8 SAME 3x3 convolution with a fused dequant / BatchNorm / residual /
// ReLU epilogue, on Hopper (sm_90a). Channels-last float32 in and out.
//
// Replaces: azoom/pallas/qconv_kernel.py:_kernel (reached through
// qconv3x3_pallas), and with it the int8 convs of azoom/models/unet.py:QConv
// that the TPUFPU mask net runs (PyTorch has no int8 convolution on CUDA).
//
//   x_q = clip(rint(x / act_scale), -127, 127)        (int8, in-kernel)
//   acc = sum_{dy,dx,c} x_q[f+dy-1, t+dx-1, c] * w_q[n, (3*dy+dx)*Cin + c]   (exact int32)
//   y   = ((acc * s1[n] + b1[n]) - mean[n]) * mul[n] + beta[n]  (+ residual) (ReLU)
//
// The quantisation and the epilogue's float32 operations are
// csrc/qconv_common.cuh; never build with --use_fast_math. Its dynamic mode
// (a compile-time variant, Dyn) is csrc/qconv_kernel.cu's: the block forms
// its element's scale from the input's maxima, and may raise out_max to the
// maxima of what it stores (a warp's maximum, one atomicMax).
//
// This is the port's first conv kernel (mma.sync m16n8k32, ldmatrix, two
// cp.async weight buffers). csrc/qconv_kernel.cu (wgmma, TMA-fed weights,
// persistent warp-specialised blocks) has replaced it at every conv the
// bundled nets run at 48, 64 and 80 frames: its wgmma route at 1.3 to 2.2
// times this kernel's speed, its split route (Cout = 512, Cin = 512,
// 256 -> 256 at 6 frames) at 2.2 to 4.3 times, its narrow route (the stems
// of Cin 2, 4 and 16 and Cout = 32) at 1.4 to 1.9 times (H100 80GB HBM3,
// kernels/bench.py qconv); and its any-width instances at the widths of nets
// trained at another --base (Cout of 24, 48, 96, 384, 1024; Cin of 48, 80,
// 1024, 2048, ...; kernels/bench.py qconv --nets fpu_b48,deepfpu_b64,...).
// This one is kept, chosen by shape alone (kernels/qconv_kernel.py:plan),
// for the shapes none of that kernel's instances reads or fits: an input
// whose channels are not a multiple of 4 (Cin of 1, 3, 5, ...; but a stem of
// 2) or a concat whose halves are not; a halo of Ck % 128 != 0 channels too
// large for two buffers beside two weight stages (320 channels on 8-frame
// tiles); one-frame planes at large Cin on that kernel's 512- and 256-pixel
// tiles (Cout <= 64). And as the reference every instance of
// csrc/qconv_kernel.cu is held against bit for bit (kernels/bench.py,
// tests/test_torch_cuda.py, chip_smoke.py, ``_kernel="mma"``): same
// quotient, same codes, same epilogue (csrc/qconv_common.cuh), with the
// older quantiser.
//
// What bounds it: activation bytes, as in csrc/qconv_kernel.cu; it reaches a
// quarter of the memory rate at the widths it was written for. Design:
// implicit GEMM, M = output pixels, N = Cout, K = 9 * Cin in tap-major
// order. Any Cin is computed as Ck = ceil(Cin / 16) * 16 channels, those
// beyond Cin zero codes in the halo and zero weights in the packed rows, so
// the int32 sums are the same. A block of 8 warps owns a tile of
// 256 * 64 / NB pixels (FR rows of F by TW frames) and a slice of NB output
// channels (NB = 32, 64, 128 or 256, the least that holds Cout, or 256 with
// ceil(Cout / 256) slices on the grid's third axis; NB = 512 at Cout = 512,
// the bundled widths' one slice), so each input element
// is read from device memory and quantised about once a slice ((FR+2)/FR
// halo overlap), not once per channel block. The quantised halo ((FR+2) x
// (TW+2) pixels x Cp int8) stays in shared memory; the 9 taps are address
// offsets into it, so im2col never exists in memory. Where the halo of all
// Ck channels and the weight buffers do not fit, the halo is made in parts
// of Cp channels (a multiple of 16) in turn, each part's K walked (tap-major
// within the part: the weight columns tap * Ck + [c0, c0 + Cp), contiguous
// 16-byte pieces) while the int32 accumulators stay in registers. Weights
// stream through two shared buffers in K chunks of 128 (cp.async, the next
// chunk's copy overlapping this chunk's products; rows at or beyond Cout and
// columns beyond the part zero-filled): every block streams its slice's
// rows. Warps split the tile (NB / 64) ways along N and the rest along M;
// each owns 32 pixels x 64 channels (MI = 2 m16 by NJ = 8 n8 tiles; at
// NB = 32, 64 x 32: MI = 4, NJ = 4) of int32 accumulators in registers,
// loads its fragments with ldmatrix (rows padded by 16 bytes so the 8 rows
// of each 8x16-byte matrix hit distinct banks where Cp is a multiple of
// 128) and runs mma.sync m16n8k32 s8. The epilogue masks the columns at or
// beyond Cout (scalar loads and stores where Cout is odd). A block's phases
// (halo, products, epilogue) run in turn; two blocks per SM overlap them.

#include "qconv_common.cuh"

namespace {

using azt::abs_bits;
using azt::dequant_bn;
using azt::dynamic_s1;
using azt::quant4;
using azt::res_relu;
using azt::scale_of_max;
using azt::warp_max_out;

constexpr int kThreads = 256;    // 8 warps
constexpr int kKC = 128;         // K bytes of weights staged per chunk
constexpr int kWRow = kKC + 16;  // padded shared-memory row of a staged weight chunk

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// src_bytes 0 fills the 16 bytes with zeros (a row at or beyond Cout, a
// column beyond the part).
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, int src_bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(src_bytes));
}

// Four 8x16-byte matrices; lane L supplies the address of row L % 8 of
// matrix L / 8, and receives word (L % 4) of row (L / 4) of each matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem_row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A warp's tile: MI m16 tiles of pixels by NJ n8 tiles of channels; Dyn the dynamic mode.
template <int MI, int NJ, bool Dyn>
__global__ void __launch_bounds__(kThreads, 2) qconv3x3_mma_kernel(
    const float* __restrict__ x, const float* __restrict__ x2, const int8_t* __restrict__ w,
    const float* __restrict__ epi, const float* __restrict__ res, float* __restrict__ out,
    const float* __restrict__ x_max, const float* __restrict__ x2_max, float* out_max,
    float act_scale, int relu, int F, int T, int Ck, int Cin1, int Cin2, int Cout, int Kpad,
    int NB, int Cp, int TW, int FR, int n_ttiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HW = TW + 2;
  const int CpP = Cp + 16;  // pixel stride of the halo; the 16 pad bytes stay zero
  unsigned char* halo = smem;
  unsigned char* wbuf = smem + (FR + 2) * HW * CpP;  // 2 buffers of NB rows of kWRow bytes
  const long b = blockIdx.y;
  const int n0 = blockIdx.z * NB;  // this block's slice of output channels
  const float s = Dyn ? scale_of_max(x_max, x2_max, b) : act_scale;
  const int f0 = (blockIdx.x / n_ttiles) * FR;
  const int t0 = (blockIdx.x % n_ttiles) * TW;

  // 1. Quantised input halo of channels [c0, c0 + Cp) -> shared memory (zeros
  //    outside the plane and at channels >= Cin1 + Cin2). Channels [0, Cin1)
  //    come from x, [Cin1, Cin1 + Cin2) from x2: the decoder's channel concat
  //    is read in place, never materialised. Each thread takes 4 channels of
  //    a pixel, one float4 where they lie in one input whose channels are a
  //    multiple of 4, else one by one; consecutive threads take consecutive
  //    channels, then pixels, so the loads are coalesced.
  const int Cr = Cin1 + Cin2;
  const bool vec1 = (Cin1 & 3) == 0, vec2 = vec1 && (Cin2 & 3) == 0;
  auto load_halo = [&](int c0) {
    uint32_t* halo32 = reinterpret_cast<uint32_t*>(halo);
    const int cpp4 = CpP >> 2, cp4 = Cp >> 2;
    const int n_pix = (FR + 2) * HW;
    const bool pow2 = (cp4 & (cp4 - 1)) == 0;
    const int sh = __ffs(cp4) - 1;
    const float rs = 1.f / s;
    for (int i = threadIdx.x; i < n_pix * cp4; i += kThreads) {
      const int pix = pow2 ? i >> sh : i / cp4;
      const int c4 = i - pix * cp4;
      const int ch = c0 + 4 * c4;
      const int hr = pix / HW;
      const int f = f0 - 1 + hr;
      const int t = t0 - 1 + (pix - hr * HW);
      uint32_t q = 0;
      if (ch < Cr && f >= 0 && f < F && t >= 0 && t < T) {
        const long at = (b * F + f) * T + t;
        float4 v;
        if (vec1 && ch + 4 <= Cin1) {
          v = *reinterpret_cast<const float4*>(x + at * Cin1 + ch);
        } else if (vec2 && ch >= Cin1 && ch + 4 <= Cr) {
          v = *reinterpret_cast<const float4*>(x2 + at * Cin2 + (ch - Cin1));
        } else {  // a group across the inputs' boundary or their end, or a half of odd width
          float e[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = ch + j;
            e[j] = c < Cin1 ? x[at * Cin1 + c] : c < Cr ? x2[at * Cin2 + (c - Cin1)] : 0.f;
          }
          v = make_float4(e[0], e[1], e[2], e[3]);
        }
        q = quant4(v, s, rs);
      }
      halo32[pix * cpp4 + c4] = q;
    }
    for (int i = threadIdx.x; i < n_pix * 4; i += kThreads)  // the 16 pad bytes
      halo32[(i >> 2) * cpp4 + cp4 + (i & 3)] = 0;
  };

  // 2. Implicit GEMM on the tensor cores.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int WN = NB / (8 * NJ);  // warps along N (1, 2, 4 or 8)
  const int wn = warp % WN, wm = warp / WN;
  const int nbase = wn * 8 * NJ;
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: this lane's matrix and row
  // A (pixels x K): matrices 0..3 = rows 0-7 / 8-15 of the m-tile, K bytes 0-15 / 16-31
  int arow[MI];  // halo byte offset of tap (0, 0) for this lane's row in each m-tile
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int p = wm * 16 * MI + mi * 16 + (mat & 1) * 8 + mrow;
    arow[mi] = ((p / TW) * HW + (p % TW)) * CpP;
  }
  const int akhalf = (mat >> 1) * 16;
  // B (channels x K): matrices 0..3 = K bytes 0-15 / 16-31 of n-tile 2jp, then of 2jp+1
  const int bn = nbase + (mat >> 1) * 8 + mrow;
  const int bkhalf = (mat & 1) * 16;

  int acc[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][j][r] = 0;

  // K is walked part by part, each part's 9 * Cp columns (padded to Kp, a
  // multiple of 32) in chunks of 128. Weights stream through two shared
  // buffers: the copy of chunk c + 1 (cp.async, no registers) overlaps the
  // products of chunk c.
  const int Kc = 9 * Cp;                       // K of one part
  const int Kp = (Kc + 31) & ~31;
  const int cpp = (Kp + kKC - 1) / kKC;        // chunks per part
  const int n_chunks = ((Ck + Cp - 1) / Cp) * cpp;
  const int wbuf_bytes = NB * kWRow;
  auto stage = [&](int c) {
    unsigned char* dst = wbuf + (c & 1) * wbuf_bytes;
    const int part = c / cpp;
    const int kc0 = (c - part * cpp) * kKC, kcn = min(kKC, Kp - kc0);
    for (int i = threadIdx.x; i < NB * (kKC / 16); i += kThreads) {
      const int n = i / (kKC / 16), v = i % (kKC / 16);  // 16-byte vector v of row n
      if (v * 16 >= kcn) continue;
      const int k = kc0 + v * 16, tap = k / Cp;          // k within the part
      const int ch = part * Cp + (k - tap * Cp);
      const bool ok = n0 + n < Cout && tap < 9 && ch < Ck;
      cp_async16(dst + n * kWRow + v * 16, ok ? w + (long)(n0 + n) * Kpad + tap * Ck + ch : w,
                 ok ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(0);
  for (int c = 0; c < n_chunks; ++c) {
    const int part = c / cpp, kc0 = (c - part * cpp) * kKC;
    // every warp is done with the previous part's halo (the barrier ending chunk c - 1)
    if (kc0 == 0) load_halo(part * Cp);
    if (c + 1 < n_chunks) {
      stage(c + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);  // chunk c has landed
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // chunk c (and, at a part's first chunk, its halo) visible to all warps
    const unsigned char* wb = wbuf + (c & 1) * wbuf_bytes;
    const int kcn = min(kKC, Kp - kc0);
    for (int ks = 0; ks < kcn; ks += 32) {
      // K bytes [k, k + 16) of this lane's A row lie in one tap (Cp % 16 == 0)
      const int k = kc0 + ks + akhalf;
      int aoff = Cp;  // K beyond 9 * Cp: the zero pad bytes of the row
      if (k < Kc) {
        const int tap = k / Cp;
        aoff = ((tap / 3) * HW + tap % 3) * CpP + (k - tap * Cp);
      }
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) ldmatrix_x4(a[mi], halo + arow[mi] + aoff);
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, wb + (bn + jp * 16) * kWRow + ks + bkhalf);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_s8(acc[mi][2 * jp], a[mi], bfr[0], bfr[1]);
          mma_s8(acc[mi][2 * jp + 1], a[mi], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer c & 1 (and the halo) before they are refilled
  }

  // 3. Fused epilogue: dequant, BatchNorm, residual, ReLU; columns >= Cout masked.
  const int g = lane >> 2, tg = lane & 3;
  const bool even = (Cout & 1) == 0;  // float2 loads and stores at (n, n + 1)
  uint32_t out_bits = 0;  // Dyn: the largest |y| this thread stores, as bits
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = wm * 16 * MI + mi * 16 + h * 8 + g;
      const int f = f0 + p / TW;
      const int t = t0 + p % TW;
      if (f >= F || t >= T) continue;
      const long pix = (b * F + f) * T + t;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + nbase + j * 8 + tg * 2;
        if (n >= Cout) continue;
        if (even) {
          float2 e[5];  // s1, b1, mean, mul, beta at channels n, n + 1
#pragma unroll
          for (int r = 0; r < 5; ++r) e[r] = *reinterpret_cast<const float2*>(epi + r * Cout + n);
          if constexpr (Dyn) e[0] = dynamic_s1(s, e[0]);
          float y0 = dequant_bn(acc[mi][j][2 * h], e[0].x, e[1].x, e[2].x, e[3].x, e[4].x);
          float y1 = dequant_bn(acc[mi][j][2 * h + 1], e[0].y, e[1].y, e[2].y, e[3].y, e[4].y);
          float2 r = make_float2(0.f, 0.f);
          if (res) r = *reinterpret_cast<const float2*>(res + pix * Cout + n);
          y0 = res_relu(y0, r.x, res != nullptr, relu);
          y1 = res_relu(y1, r.y, res != nullptr, relu);
          *reinterpret_cast<float2*>(out + pix * Cout + n) = make_float2(y0, y1);
          if constexpr (Dyn) out_bits = max(out_bits, max(abs_bits(y0), abs_bits(y1)));
        } else {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int nu = n + u;
            if (nu >= Cout) break;
            float s1 = epi[nu];
            if constexpr (Dyn) s1 = __fmul_rn(s, s1);
            float y = dequant_bn(acc[mi][j][2 * h + u], s1, epi[Cout + nu], epi[2 * Cout + nu],
                                 epi[3 * Cout + nu], epi[4 * Cout + nu]);
            y = res_relu(y, res ? res[pix * Cout + nu] : 0.f, res != nullptr, relu);
            out[pix * Cout + nu] = y;
            if constexpr (Dyn) out_bits = max(out_bits, abs_bits(y));
          }
        }
      }
    }
  if constexpr (Dyn) {
    if (out_max) warp_max_out(out_bits, out_max, b);
  }
}

}  // namespace

// x (B, F, T, Cin1) f32 and x2 (B, F, T, Cin - Cin1) f32 or null: the input
// is their channel concat (any Cin1 >= 1 and any second half), or x alone
// (Cin1 = Cin). The kernel computes Ck = ceil(Cin / 16) * 16 channels, the
// ones beyond Cin zero codes. w (Cout, Kpad) int8, K index (3*dy+dx)*Ck + c,
// zero at c >= Cin and beyond 9*Ck; epi (5, Cout) f32 rows s1, b1, mean,
// mul, beta; res (B, F, T, Cout) f32 or null; out (B, F, T, Cout) f32;
// x_max, x2_max and out_max (B,) device float32 or null, the dynamic mode
// as csrc/qconv_kernel.cu's azt_qconv3x3 takes them. ``tile_w`` (frames of
// a tile, a power of two), ``part_channels`` (Cp, the halo's channels a
// part, a multiple of 16), ``slice_n`` (NB: 32, 64, 128, 512 at Cout = 512,
// or 256 with ceil(Cout / 256) slices) and ``smem`` are kernels/qconv_kernel.py:plan's,
// checked here against the kernel's own. Returns cudaGetLastError() (or the
// error of raising the shared-memory limit), cudaErrorInvalidValue for
// arguments it does not take.
namespace {

template <int MI, int NJ, bool Dyn>
int launch(const void* x, const void* x2, const void* w, const void* epi, const void* res,
           void* out, const void* x_max, const void* x2_max, void* out_max, float act_scale,
           int relu, int B, int F, int T, int Ck, int Cin1, int Cin2, int Cout, int Kpad, int NB,
           int Cp, int TW, int smem, cudaStream_t stream) {
  const int m_tile = 16 * MI * (8 / (NB / (8 * NJ)));  // pixels per block
  const int FR = m_tile / TW;
  if (TW > m_tile || (TW & (TW - 1)) ||
      smem != (FR + 2) * (TW + 2) * (Cp + 16) + 2 * NB * kWRow)
    return (int)cudaErrorInvalidValue;
  const int n_ttiles = (T + TW - 1) / TW;
  const int n_ftiles = (F + FR - 1) / FR;
  if (smem > 48 * 1024) {  // dynamic shared memory above 48 KB must be opted into
    const cudaError_t e = cudaFuncSetAttribute(
        qconv3x3_mma_kernel<MI, NJ, Dyn>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_ftiles * n_ttiles, B, (Cout + NB - 1) / NB);
  qconv3x3_mma_kernel<MI, NJ, Dyn><<<grid, kThreads, smem, stream>>>(
      (const float*)x, (const float*)x2, (const int8_t*)w, (const float*)epi,
      (const float*)res, (float*)out, (const float*)x_max, (const float*)x2_max,
      (float*)out_max, act_scale, relu, F, T, Ck, Cin1, Cin2, Cout, Kpad, NB, Cp, TW, FR,
      n_ttiles);
  return (int)cudaGetLastError();
}

// The tile of the slice width in the launch's mode: dynamic when it reads maxima.
template <int MI, int NJ>
int launch_tile(const void* x, const void* x2, const void* w, const void* epi, const void* res,
                void* out, const void* x_max, const void* x2_max, void* out_max,
                float act_scale, int relu, int B, int F, int T, int Ck, int Cin1, int Cin2,
                int Cout, int Kpad, int NB, int Cp, int TW, int smem, cudaStream_t stream) {
  return (x_max ? launch<MI, NJ, true> : launch<MI, NJ, false>)(
      x, x2, w, epi, res, out, x_max, x2_max, out_max, act_scale, relu, B, F, T, Ck, Cin1, Cin2,
      Cout, Kpad, NB, Cp, TW, smem, stream);
}

}  // namespace

extern "C" int azt_qconv3x3_mma(const void* x, const void* x2, const void* w, const void* epi,
                                const void* res, void* out, const void* x_max,
                                const void* x2_max, void* out_max, float act_scale, int relu,
                                int B, int F, int T, int Cin, int Cin1, int Cout, int Kpad,
                                int tile_w, int part_channels, int slice_n, int smem,
                                void* stream) {
  const int Ck = (Cin + 15) / 16 * 16, Cin2 = Cin - Cin1;
  const bool maxima_ok =
      x_max ? (x2_max != nullptr) == (x2 != nullptr) : x2_max == nullptr && out_max == nullptr;
  const bool slice_ok = slice_n == 256 || (slice_n == 512 && Cout == 512) ||
                        ((slice_n == 32 || slice_n == 64 || slice_n == 128) && Cout <= slice_n);
  if (B < 1 || F < 1 || T < 1 || Cin < 1 || Cin1 < 1 || Cin1 > Cin ||
      (x2 == nullptr) != (Cin2 == 0) || Cout < 1 || !slice_ok || part_channels < 16 ||
      part_channels % 16 || part_channels > Ck || Kpad % 32 || Kpad < 9 * Ck || !maxima_ok)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (slice_n == 32)
    return launch_tile<4, 4>(x, x2, w, epi, res, out, x_max, x2_max, out_max, act_scale, relu, B,
                             F, T, Ck, Cin1, Cin2, Cout, Kpad, slice_n, part_channels, tile_w,
                             smem, st);
  return launch_tile<2, 8>(x, x2, w, epi, res, out, x_max, x2_max, out_max, act_scale, relu, B,
                           F, T, Ck, Cin1, Cin2, Cout, Kpad, slice_n, part_channels, tile_w, smem,
                           st);
}
