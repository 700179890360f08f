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
// csrc/qconv_common.cuh; never build with --use_fast_math.
//
// This is the port's first conv kernel (mma.sync m16n8k32, ldmatrix, two
// cp.async weight buffers). csrc/qconv_kernel.cu (wgmma, TMA-fed weights,
// persistent warp-specialised blocks) has replaced it wherever the mask nets
// spend their time: its first instance at 1.3 to 2.2 times, its split
// instance (Cout = 512, Cin = 512, 256 -> 256 at 6 frames) at 2.2 to 4.3
// times this kernel's speed (H100 80GB HBM3, kernels/bench.py qconv). This
// one is kept, chosen by shape alone
// (kernels/qconv_kernel.py:plan), for
//   - Cin % 32 != 0, the TPUFPU nets' 16-channel stem among them (K = 144: a
//     32-byte wgmma K step would straddle two taps of the halo), and the
//     stems of the unfolded nets, Cin = 2 (logmag_ipd) or 4 (physics): the
//     halo load zero-extends them to 16 channels (x2 null, Cin1 < Cin), and
//     their packed weights are zero there, so the int32 sums are the same;
//   - Cout = 32, the first and last levels of the base-32 nets
//     (FreqPreservingUNet, DeepFPU): a warp owns 64 pixels x 32 channels;
//   - the shapes neither wgmma instance fits (Cout of 64 or 128 whose two
//     halos leave no room for three weight stages, and one-frame planes at
//     large Cin; no bundled net runs them);
// and as the reference both wgmma instances are held against bit for bit
// (kernels/bench.py, tests/test_torch_cuda.py, chip_smoke.py): same
// quotient, same codes, same epilogue (csrc/qconv_common.cuh), with the
// older quantiser.
//
// What bounds it: activation bytes, as in csrc/qconv_kernel.cu; it reaches a
// quarter of the memory rate. Design: implicit GEMM, M = output pixels,
// N = Cout, K = 9 * Cin in tap-major order. A block of 8 warps owns a tile of
// 256 / (Cout / 64) pixels (FR rows of F by TW frames) and ALL Cout output
// channels, so each input element is read from device memory and quantised
// about once ((FR+2)/FR halo overlap), not once per channel block. The
// quantised halo ((FR+2) x (TW+2) pixels x Cin int8) stays in shared memory;
// the 9 taps are address offsets into it, so im2col never exists in memory.
// Weights stream through two shared buffers in K chunks of 128 (cp.async,
// the next chunk's copy overlapping this chunk's products): every block
// streams the whole matrix. Warps split the tile (Cout / 64) ways along N
// and the rest along M; each owns 32 pixels x 64 channels (MI = 2 m16 by
// NJ = 8 n8 tiles; at Cout = 32, 64 x 32: MI = 4, NJ = 4) of int32
// accumulators in registers, loads its fragments with ldmatrix (rows padded
// by 16 bytes so the 8 rows of each 8x16-byte matrix hit distinct banks) and
// runs mma.sync m16n8k32 s8. A block's phases (halo, products, epilogue)
// run in turn; two blocks per SM overlap them.

#include "qconv_common.cuh"

namespace {

using azt::dequant_bn;
using azt::quant4;
using azt::res_relu;

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

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

// Four 8x16-byte matrices; lane L supplies the address of row L % 8 of
// matrix L / 8, and receives word (L % 4) of row (L / 4) of each matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(smem_row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A warp's tile: MI m16 tiles of pixels by NJ n8 tiles of channels.
template <int MI, int NJ>
__global__ void __launch_bounds__(kThreads, 2) qconv3x3_mma_kernel(
    const float* __restrict__ x, const float* __restrict__ x2, const int8_t* __restrict__ w,
    const float* __restrict__ epi, const float* __restrict__ res, float* __restrict__ out,
    float act_scale, int relu, int F, int T, int Cin, int Cin1, int Cout, int Kpad, int TW,
    int FR, int n_ttiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HW = TW + 2;
  const int CinP = Cin + 16;  // pixel stride of the halo; the 16 pad bytes stay zero
  unsigned char* halo = smem;
  unsigned char* wbuf = smem + (FR + 2) * HW * CinP;  // 2 buffers of Cout rows of kWRow bytes
  const long b = blockIdx.y;
  const int f0 = (blockIdx.x / n_ttiles) * FR;
  const int t0 = (blockIdx.x % n_ttiles) * TW;

  // 1. Quantised input halo -> shared memory (zeros outside the plane).
  //    Channels [0, Cin1) come from x, [Cin1, Cin) from x2: the decoder's
  //    channel concat is read in place, never materialised. Without x2 they
  //    are zeros (a stem of Cin1 = 2 or 4 channels, Cin = 16). Each thread
  //    takes 4 channels (one float4) of a pixel; consecutive threads take
  //    consecutive channels, then pixels, so the loads are coalesced.
  {
    uint32_t* halo32 = reinterpret_cast<uint32_t*>(halo);
    const int cinp4 = CinP >> 2, cin4 = Cin >> 2, cin14 = Cin1 >> 2;
    const int n_pix = (FR + 2) * HW;
    const bool pow2 = (cin4 & (cin4 - 1)) == 0;
    const int sh = __ffs(cin4) - 1;
    const float rs = 1.f / act_scale;
    for (int i = threadIdx.x; i < n_pix * cin4; i += kThreads) {
      const int pix = pow2 ? i >> sh : i / cin4;
      const int c4 = i - pix * cin4;
      const int hr = pix / HW;
      const int f = f0 - 1 + hr;
      const int t = t0 - 1 + (pix - hr * HW);
      uint32_t q = 0;
      if (f >= 0 && f < F && t >= 0 && t < T) {
        const long at = (b * F + f) * T + t;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c4 < cin14) {
          v = *reinterpret_cast<const float4*>(x + at * Cin1 + 4 * c4);
        } else if (x2) {
          v = *reinterpret_cast<const float4*>(x2 + at * (Cin - Cin1) + 4 * (c4 - cin14));
        } else if (4 * c4 < Cin1) {  // Cin1 = 2: the group's last two channels are zeros
          const float* src = x + at * Cin1 + 4 * c4;
          v.x = src[0];
          if (4 * c4 + 1 < Cin1) v.y = src[1];
          if (4 * c4 + 2 < Cin1) v.z = src[2];
        }
        q = quant4(v, act_scale, rs);
      }
      halo32[pix * cinp4 + c4] = q;
    }
    for (int i = threadIdx.x; i < n_pix * 4; i += kThreads)  // the 16 pad bytes
      halo32[(i >> 2) * cinp4 + cin4 + (i & 3)] = 0;
  }

  // 2. Implicit GEMM on the tensor cores.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int WN = Cout / (8 * NJ);  // warps along N (1, 2, 4 or 8)
  const int wn = warp % WN, wm = warp / WN;
  const int nbase = wn * 8 * NJ;
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: this lane's matrix and row
  // A (pixels x K): matrices 0..3 = rows 0-7 / 8-15 of the m-tile, K bytes 0-15 / 16-31
  int arow[MI];  // halo byte offset of tap (0, 0) for this lane's row in each m-tile
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int p = wm * 16 * MI + mi * 16 + (mat & 1) * 8 + mrow;
    arow[mi] = ((p / TW) * HW + (p % TW)) * CinP;
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

  // Weights stream in K chunks through two shared buffers: the copy of
  // chunk c + 1 (cp.async, no registers) overlaps the products of chunk c.
  const int K = 9 * Cin;
  const int n_chunks = (Kpad + kKC - 1) / kKC;
  const int wbuf_bytes = Cout * kWRow;
  auto stage = [&](int c) {
    unsigned char* dst = wbuf + (c & 1) * wbuf_bytes;
    const int kc0 = c * kKC, kcn = min(kKC, Kpad - kc0);
    for (int i = threadIdx.x; i < Cout * (kKC / 16); i += kThreads) {
      const int n = i / (kKC / 16), v = i % (kKC / 16);  // 16-byte vector v of row n
      if (v * 16 < kcn) cp_async16(dst + n * kWRow + v * 16, w + (long)n * Kpad + kc0 + v * 16);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(0);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      stage(c + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);  // chunk c has landed
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // chunk c (and, the first time, the halo) visible to all warps
    const unsigned char* wb = wbuf + (c & 1) * wbuf_bytes;
    const int kc0 = c * kKC, kcn = min(kKC, Kpad - kc0);
    for (int ks = 0; ks < kcn; ks += 32) {
      // K bytes [k, k + 16) of this lane's A row lie in one tap (Cin % 16 == 0)
      const int k = kc0 + ks + akhalf;
      int aoff = Cin;  // K beyond 9 * Cin: the zero pad bytes of the row
      if (k < K) {
        const int tap = k / Cin;
        aoff = ((tap / 3) * HW + tap % 3) * CinP + (k - tap * Cin);
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
    __syncthreads();  // every warp is done with buffer c & 1 before chunk c + 2 lands there
  }

  // 3. Fused epilogue: dequant, BatchNorm, residual, ReLU.
  const int g = lane >> 2, tg = lane & 3;
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
        const int n = nbase + j * 8 + tg * 2;
        float2 e[5];  // s1, b1, mean, mul, beta at channels n, n + 1
#pragma unroll
        for (int r = 0; r < 5; ++r) e[r] = *reinterpret_cast<const float2*>(epi + r * Cout + n);
        float y0 = dequant_bn(acc[mi][j][2 * h], e[0].x, e[1].x, e[2].x, e[3].x, e[4].x);
        float y1 = dequant_bn(acc[mi][j][2 * h + 1], e[0].y, e[1].y, e[2].y, e[3].y, e[4].y);
        float2 r = make_float2(0.f, 0.f);
        if (res) r = *reinterpret_cast<const float2*>(res + pix * Cout + n);
        y0 = res_relu(y0, r.x, res != nullptr, relu);
        y1 = res_relu(y1, r.y, res != nullptr, relu);
        *reinterpret_cast<float2*>(out + pix * Cout + n) = make_float2(y0, y1);
      }
    }
}

}  // namespace

// x (B, F, T, Cin1) f32 and x2 (B, F, T, Cin - Cin1) f32 or null: the input
// is their channel concat, or without x2 x's channels then zeros up to Cin
// (a stem: Cin1 of 2 or 4, Cin = 16). w (Cout, Kpad) int8, K index
// (3*dy+dx)*Cin + c, zero beyond 9*Cin; epi (5, Cout) f32 rows s1, b1, mean,
// mul, beta; res (B, F, T, Cout) f32 or null; out (B, F, T, Cout) f32. Needs
// Cin % 16 == 0, Cin1 % 4 == 0 with x2 (Cin1 of 2, 4 or Cin without),
// Cout in {32, 64, 128, 256, 512}, Kpad % 32 == 0. Returns cudaGetLastError()
// (or the error of raising the shared-memory limit), cudaErrorInvalidValue
// for another shape.
namespace {

template <int MI, int NJ>
int launch(const void* x, const void* x2, const void* w, const void* epi, const void* res,
           void* out, float act_scale, int relu, int B, int F, int T, int Cin, int Cin1,
           int Cout, int Kpad, cudaStream_t stream) {
  const int m_tile = 16 * MI * (8 / (Cout / (8 * NJ)));  // pixels per block
  int TW = 1;  // frames per tile: the largest power of two <= min(T, m_tile)
  while (TW * 2 <= T && TW * 2 <= m_tile) TW *= 2;
  const int FR = m_tile / TW;
  const int n_ttiles = (T + TW - 1) / TW;
  const int n_ftiles = (F + FR - 1) / FR;
  const int smem = (FR + 2) * (TW + 2) * (Cin + 16) + 2 * Cout * kWRow;
  if (smem > 48 * 1024) {  // dynamic shared memory above 48 KB must be opted into
    const cudaError_t e = cudaFuncSetAttribute(
        qconv3x3_mma_kernel<MI, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_ftiles * n_ttiles, B);
  qconv3x3_mma_kernel<MI, NJ><<<grid, kThreads, smem, stream>>>(
      (const float*)x, (const float*)x2, (const int8_t*)w, (const float*)epi,
      (const float*)res, (float*)out, act_scale, relu, F, T, Cin, Cin1, Cout, Kpad, TW, FR,
      n_ttiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int azt_qconv3x3_mma(const void* x, const void* x2, const void* w, const void* epi,
                            const void* res, void* out, float act_scale,
                            int relu, int B, int F, int T, int Cin, int Cin1, int Cout,
                            int Kpad, void* stream) {
  const bool stem = x2 == nullptr && Cin1 < Cin;
  if (Cin % 16 || Cin1 < 1 || Cin1 > Cin || (stem && Cin1 != 2 && Cin1 != 4) ||
      (x2 != nullptr && Cin1 % 4) || Kpad % 32 || Kpad < 9 * Cin ||
      (Cout != 32 && Cout != 64 && Cout != 128 && Cout != 256 && Cout != 512))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (Cout == 32)
    return launch<4, 4>(x, x2, w, epi, res, out, act_scale, relu, B, F, T, Cin, Cin1, Cout,
                        Kpad, st);
  return launch<2, 8>(x, x2, w, epi, res, out, act_scale, relu, B, F, T, Cin, Cin1, Cout,
                      Kpad, st);
}
