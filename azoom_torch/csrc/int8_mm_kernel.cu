// Int8 matrix product with exact int32 accumulation, on Hopper (sm_90a):
//
//   out[m, n] = sum_k x[m, k] * w[k, n]     x (M, K) int8, w (K, N) int8, both row-major
//
// Replaces: the pallas_mm kernels of the three int8 microbenchmarks,
// scripts/microbench_pallas_mm.py:35 (full-K and K-blocked variants),
// scripts/microbench_int8.py:53 and scripts/microbench_int8b.py:41, which
// all compute this function at the TPUFPU im2col shapes.
//
// What bounds it: at K = 4608, N = 512 operations (1.01e11 at M = 21504:
// 0.051 ms at 1,979 TOP/s against 145 MB, 0.043 ms at 3.35 TB/s); at the
// other seven shapes the bytes, most of them the 4 * M * N of int32 output.
// Short of either roofline sits the road from L2 to shared memory: a 128 x
// 256 tile does 170 operations for each operand byte it stages, so the
// tensor cores' peak would need 11.6 TB/s of it.
//
// Design, on the shared mainloop of csrc/wgmma_s8.cuh:
//   - w is N-major and int8 wgmma reads K-major operands only, so a pre-pass
//     kernel writes w^T (N, K) once per product into scratch of the
//     wrapper's (K * N bytes, at most 2.4 MB here against M * K = 99 MB).
//     The earlier kernel transposed every K chunk again in every block.
//   - TMA loads x and w^T as 128-row and BN-row boxes of 128 K bytes, in the
//     128-byte swizzle, into a ring of 4 to 8 stages guarded by full / empty
//     mbarriers. One producer thread starts the loads; the two consumer
//     warpgroups each own 64 rows of the 128 x BN tile (BN = 256, 128 or 64,
//     the widest that divides N) and run wgmma m64nBNk32 s8 with both
//     operands read from shared memory through descriptors, one group of
//     products in flight while the next stage is awaited.
//   - One persistent block per SM walks the tiles (N tiles of one M block
//     are neighbours, so x comes from device memory once); the producer runs
//     ahead into the next tile's stages while the consumers store the int32
//     tile, so stores overlap loads. M = 16384, N = 64 is 128 tiles, one
//     wave on 128 of the 132 SMs.

#include "wgmma_s8.cuh"

namespace {

using namespace azt;

constexpr int kBM = 128;                 // rows of an output tile: 64 per consumer warpgroup
constexpr int kConsumers = 256;          // threads 0..255: two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kSmemLimit = 232448;       // bytes a block may have on sm_90

__host__ __device__ constexpr int stages_for(int bn) {       // the ring takes what fits, up to 8 stages
  const int fit = (kSmemLimit - kTileAlign - 256) / ((kBM + bn) * kSwizzleRow);
  return fit > 8 ? 8 : fit;
}

// w (K, N) -> wt (N, K), 64 x 64 bytes per block through shared memory.
__global__ void __launch_bounds__(256) transpose_kernel(const uint8_t* __restrict__ w,
                                                        uint8_t* __restrict__ wt, int K, int N) {
  __shared__ __align__(4) uint8_t tile[64][68];  // [n][k]
  const int k0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  for (int i = threadIdx.x; i < 64 * 16; i += 256) {
    const int k = i >> 4, n4 = i & 15;
    const uint32_t v = *reinterpret_cast<const uint32_t*>(w + (long)(k0 + k) * N + n0 + 4 * n4);
#pragma unroll
    for (int b = 0; b < 4; ++b) tile[4 * n4 + b][k] = (uint8_t)(v >> (8 * b));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * 16; i += 256) {
    const int n = i >> 4, k4 = i & 15;
    *reinterpret_cast<uint32_t*>(wt + (long)(n0 + n) * K + k0 + 4 * k4) =
        *reinterpret_cast<const uint32_t*>(&tile[n][4 * k4]);
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1) int8_mm_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_wt,
    int32_t* __restrict__ out, int M, int N, int K) {
  constexpr int S = stages_for(BN);
  constexpr int kAStage = kBM * kSwizzleRow, kBStage = BN * kSwizzleRow;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles start on 1024-byte boundaries
  unsigned char* smem = smem_raw + ((kTileAlign - (smem_u32(smem_raw) & (kTileAlign - 1))) &
                                    (kTileAlign - 1));
  unsigned char* As = smem;                // S stages of 128 rows x 128 K bytes
  unsigned char* Bs = smem + S * kAStage;  // S stages of BN rows x 128 K bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + S * kBStage);
  uint64_t* empty = full + S;

  const int n_ntiles = N / BN;
  const int n_tiles = (M / kBM) * n_ntiles;
  const int n_chunks = (K + kSwizzleRow - 1) / kSwizzleRow;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);    // the producer's arrive; the TMA unit adds the bytes
      mbar_init(empty + s, 8);   // one lane of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer warpgroup: one thread keeps the ring full -----------------
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      int s = 0, parity = 1;  // a fresh stage is empty: the first waits pass at once
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile / n_ntiles) * kBM, n0 = (tile % n_ntiles) * BN;
        for (int c = 0; c < n_chunks; ++c) {
          mbar_wait(empty + s, parity);
          mbar_arrive_expect_tx(full + s, kAStage + kBStage);
          tma_load_2d(As + s * kAStage, &map_x, full + s, c * kSwizzleRow, m0);
          tma_load_2d(Bs + s * kBStage, &map_wt, full + s, c * kSwizzleRow, n0);
          if (++s == S) { s = 0; parity ^= 1; }
        }
      }
    }
  } else {
    // ---- consumer warpgroups ------------------------------------------------
    reg_alloc<232>();
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, tg = lane & 3;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int s = 0, parity = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long m0 = (long)(tile / n_ntiles) * kBM + wg * 64;
      const int n0 = (tile % n_ntiles) * BN;
      int prev = -1;  // the stage whose products may still be running
      for (int c = 0; c < n_chunks; ++c) {
        mbar_wait(full + s, parity);
        const uint64_t da = wgmma_desc(smem_u32(As + s * kAStage + wg * 64 * kSwizzleRow));
        const uint64_t db = wgmma_desc(smem_u32(Bs + s * kBStage));
        const int steps = min(kSwizzleRow, K - c * kSwizzleRow) / kWgmmaK;
        acc_fence(acc);
        wgmma_fence();
        for (int j = 0; j < steps; ++j)  // + 2: 32 bytes along K, in 16-byte units
          Wgmma<BN>::ss(acc, da + 2 * j, db + 2 * j, (c | j) != 0);
        wgmma_commit();
        if (prev >= 0) {  // chunk c - 1 is done: its stage goes back to the producer
          wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + prev);
        }
        prev = s;
        if (++s == S) { s = 0; parity ^= 1; }
      }
      wgmma_wait<0>();
      acc_fence(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + prev);
      // this thread's rows m, m + 8 and column pairs 8j + 2tg of the tile
      int32_t* o = out + (m0 + warp * 16 + g) * N + n0 + 2 * tg;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        *reinterpret_cast<int2*>(o + 8 * j) = make_int2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<int2*>(o + 8 * (long)N + 8 * j) = make_int2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

template <int BN>
int launch(const void* x, const void* wt, void* out, int M, int N, int K, cudaStream_t stream) {
  constexpr int S = stages_for(BN);
  constexpr int smem = kTileAlign + S * (kBM + BN) * kSwizzleRow + 2 * S * 8;
  static_assert(S >= 4 && smem <= kSmemLimit, "the ring must fit with at least 4 stages");
  static bool raised = false;
  if (!raised) {  // dynamic shared memory above 48 KB must be opted into, once
    const cudaError_t e = cudaFuncSetAttribute(
        int8_mm_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  CUtensorMap map_x, map_wt;
  int rc = cached_tensor_map_s8(&map_x, x, M, K, kBM);
  if (rc == 0) rc = cached_tensor_map_s8(&map_wt, wt, N, K, BN);
  if (rc != 0) return rc;
  const int n_tiles = (M / kBM) * (N / BN);
  const int grid = n_tiles < sm_count() ? n_tiles : sm_count();
  int8_mm_kernel<BN><<<grid, kThreads, smem, stream>>>(map_x, map_wt, (int32_t*)out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) int8, w (K, N) int8, out (M, N) int32, wt K * N bytes of scratch
// (receives w^T), all row-major and 16-byte aligned. Needs M % 128 == 0,
// K % 64 == 0 and N % 64 == 0 (the wrapper checks). Two launches on the
// stream: the transpose of w, then the product. Returns 0, a cudaError_t, or
// 1000 + the CUresult of building a tensor map.
extern "C" int azt_int8_mm(const void* x, const void* w, void* wt, void* out, int M, int N,
                           int K, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  transpose_kernel<<<dim3(N / 64, K / 64), 256, 0, st>>>((const uint8_t*)w, (uint8_t*)wt, K, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (N % 256 == 0) return launch<256>(x, wt, out, M, N, K, st);
  if (N % 128 == 0) return launch<128>(x, wt, out, M, N, K, st);
  return launch<64>(x, wt, out, M, N, K, st);
}
