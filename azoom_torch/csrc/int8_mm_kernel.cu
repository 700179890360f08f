// Int8 matrix product with exact int32 accumulation, on Hopper (sm_90a):
//
//   out[m, n] = sum_k x[m, k] * w[k, n]     x (M, K) int8, w (K, N) int8, both row-major
//
// Replaces: the pallas_mm kernels of the three int8 microbenchmarks,
// scripts/microbench_pallas_mm.py:35 (full-K and K-blocked variants),
// scripts/microbench_int8.py:53 and scripts/microbench_int8b.py:41, which
// all compute this function at the TPUFPU im2col shapes.
//
// What bounds it: operations. At (21504, 4608, 512) it does 1.01e11 int8
// operations (0.051 ms at 1,979 TOP/s) against 145 MB (0.043 ms at
// 3.35 TB/s). Design, the inner loop of csrc/qconv_kernel.cu: a block of 8
// warps owns a BM x BN output tile (128 x 128, or 256 x 64 when N is not a
// multiple of 128) and walks K in chunks of 64 bytes through two shared
// buffers. A's chunk is copied with cp.async (16 bytes a thread, the next
// chunk's copy overlapping this chunk's products). w is row-major along N,
// but the B fragment of mma.sync wants 4 consecutive K bytes per column, and
// ldmatrix transposes only 16-bit elements; so each thread loads an 8 x 4
// byte block of w (8 K rows, one 32-bit word each) into registers while the
// current chunk computes, transposes it with byte permutes and stores it as
// four 8-byte pieces of (N, K) rows; the 16 threads of each store phase cover
// two rows' 64 bytes, so the stores hit distinct banks. Rows in shared memory
// are padded by 16 bytes so the 8 rows of each ldmatrix hit distinct banks.
// Each warp holds 32 x 64 int32 accumulators and issues mma.sync m16n8k32
// s8. wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // 8 warps
constexpr int kBK = 64;           // K bytes per chunk
constexpr int kRow = kBK + 16;    // padded shared-memory row (bytes)

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

// 4 words r[i] = bytes (k + i, n .. n + 3) -> o[j] = bytes (k .. k + 3, n + j).
__device__ __forceinline__ void transpose4x4(const uint32_t* r, uint32_t (&o)[4]) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140), lo23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362), hi23 = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(lo01, lo23, 0x5410);
  o[1] = __byte_perm(lo01, lo23, 0x7632);
  o[2] = __byte_perm(hi01, hi23, 0x5410);
  o[3] = __byte_perm(hi01, hi23, 0x7632);
}

// WN = BN / 64 warps along N, 8 / WN along M; BM = 32 * 8 / WN.
template <int WN>
__global__ void __launch_bounds__(kThreads) int8_mm_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, int32_t* __restrict__ out,
    int M, int N, int K) {
  constexpr int BN = 64 * WN, BM = 32 * (8 / WN);
  constexpr int kAStage = BM * kRow, kBStage = BN * kRow;
  constexpr int kBUnits = (kBK / 8) * (BN / 4);  // 8 x 4-byte blocks of w per chunk
  static_assert(kBUnits <= kThreads, "one block of w per thread at most");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* As = smem;                  // 2 stages of BM rows (K bytes)
  unsigned char* Bs = smem + 2 * kAStage;    // 2 stages of BN rows (K bytes)
  const long m0 = (long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int n_chunks = K / kBK;

  auto stage_a = [&](int c) {
    unsigned char* dst = As + (c & 1) * kAStage;
    for (int i = threadIdx.x; i < BM * (kBK / 16); i += kThreads) {
      const int r = i / (kBK / 16), v = i % (kBK / 16);
      cp_async16(dst + r * kRow + v * 16, x + (m0 + r) * K + (long)c * kBK + v * 16);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // This thread's block of w: K rows 8 * bkq .. + 7 of the chunk, columns
  // 4 * bnq .. + 3 of the tile.
  const bool b_active = threadIdx.x < kBUnits;
  const int bkq = threadIdx.x % 8, bnq = threadIdx.x / 8;
  uint32_t breg[8];
  auto load_b = [&](int c) {
    if (!b_active) return;
    const int8_t* src = w + ((long)c * kBK + 8 * bkq) * N + n0 + 4 * bnq;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      breg[r] = __ldg(reinterpret_cast<const uint32_t*>(src + (long)r * N));
  };
  auto store_b = [&](int c) {
    if (!b_active) return;
    unsigned char* dst = Bs + (c & 1) * kBStage + 4 * bnq * kRow + 8 * bkq;
    uint32_t lo[4], hi[4];
    transpose4x4(breg, lo);
    transpose4x4(breg + 4, hi);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint2*>(dst + j * kRow) = make_uint2(lo[j], hi[j]);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp % WN, wm = warp / WN;
  const int mat = lane >> 3, mrow = lane & 7;
  // A: matrices 0..3 = rows 0-7 / 8-15 of the m-tile, K bytes 0-15 / 16-31
  const int arow0 = (wm * 32 + (mat & 1) * 8 + mrow) * kRow + (mat >> 1) * 16;
  // B: matrices 0..3 = K bytes 0-15 / 16-31 of n-tile 2jp, then of 2jp + 1
  const int brow0 = (wn * 64 + (mat >> 1) * 8 + mrow) * kRow + (mat & 1) * 16;

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][j][r] = 0;

  stage_a(0);
  load_b(0);
  store_b(0);
  for (int c = 0; c < n_chunks; ++c) {
    const bool more = c + 1 < n_chunks;
    if (more) {
      stage_a(c + 1);
      load_b(c + 1);  // in flight while chunk c computes
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // chunk c visible to all warps
    const unsigned char* a_s = As + (c & 1) * kAStage;
    const unsigned char* b_s = Bs + (c & 1) * kBStage;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[2][4];
      ldmatrix_x4(a[0], a_s + arow0 + ks);
      ldmatrix_x4(a[1], a_s + arow0 + 16 * kRow + ks);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bfr[4];
        ldmatrix_x4(bfr, b_s + brow0 + jp * 16 * kRow + ks);
        mma_s8(acc[0][2 * jp], a[0], bfr[0], bfr[1]);
        mma_s8(acc[1][2 * jp], a[1], bfr[0], bfr[1]);
        mma_s8(acc[0][2 * jp + 1], a[0], bfr[2], bfr[3]);
        mma_s8(acc[1][2 * jp + 1], a[1], bfr[2], bfr[3]);
      }
    }
    // Buffer (c + 1) & 1 was last read in chunk c - 1, behind the barrier
    // that ended it, so chunk c + 1's w can go there now.
    if (more) store_b(c + 1);
    __syncthreads();
  }

  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long m = m0 + wm * 32 + mi * 16 + h * 8 + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + wn * 64 + j * 8 + tg * 2;
        *reinterpret_cast<int2*>(out + m * N + n) =
            make_int2(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
      }
    }
}

template <int WN>
int launch(const void* x, const void* w, void* out, int M, int N, int K, cudaStream_t stream) {
  constexpr int BN = 64 * WN, BM = 32 * (8 / WN);
  const int smem = 2 * (BM + BN) * kRow;
  if (smem > 48 * 1024) {  // dynamic shared memory above 48 KB must be opted into
    const cudaError_t e = cudaFuncSetAttribute(
        int8_mm_kernel<WN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(N / BN, M / BM);
  int8_mm_kernel<WN><<<grid, kThreads, smem, stream>>>(
      (const int8_t*)x, (const int8_t*)w, (int32_t*)out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) int8, w (K, N) int8, out (M, N) int32, all row-major and
// 16-byte aligned. Needs K % 64 == 0 and either N % 128 == 0 and M % 128 == 0,
// or N % 64 == 0 and M % 256 == 0 (the wrapper checks). Returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
extern "C" int azt_int8_mm(const void* x, const void* w, void* out, int M, int N, int K,
                           void* stream) {
  if (N % 128 == 0) return launch<2>(x, w, out, M, N, K, (cudaStream_t)stream);
  return launch<1>(x, w, out, M, N, K, (cudaStream_t)stream);
}
