// Hopper (sm_90a) building blocks shared by the port's int8 tensor-core
// kernels, csrc/int8_mm_kernel.cu and csrc/qconv_kernel.cu: the PTX wrappers
// both need and nothing more.
//
//   - mbarrier: init, arrive, arrive with expected bytes, wait on a phase parity;
//   - TMA: a 2-D tiled tensor map (host side, with a small cache) and
//     cp.async.bulk.tensor loads that complete on an mbarrier;
//   - wgmma: fence / commit_group / wait_group, the shared-memory matrix
//     descriptor of a K-major tile in the 128-byte swizzle, and
//     wgmma.mma_async m64n{64,128,256}k32 s32 += s8 * s8 with B from shared
//     memory and A from shared memory (ss) or registers (rs), and
//     m64n32k32 with A from registers;
//   - setmaxnreg, so the producer warpgroup can hand registers to the consumers.
//
// Int8 wgmma takes both operands K-major only: a tile is rows of 128 K bytes
// (one swizzle row), row r at byte r * 128, its 16-byte chunk c stored at
// chunk c ^ (r % 8). That is what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B
// of a box {128 bytes, rows} writes, if the tile starts on a 1024-byte
// boundary; 8-row groups then lie 1024 bytes apart (the descriptor's stride
// byte offset), and a K step of 32 bytes inside the row is an advance of the
// descriptor's start address by 32 bytes.
//
// Fragment layouts (PTX ISA, wgmma m64nNk32 with 8-bit operands), for warp w
// of the warpgroup and lane = 4 * g + tg:
//   A in registers:  a[0] = row 16w+g, K bytes 4tg..4tg+3;  a[1] = row 16w+g+8, same bytes;
//                    a[2], a[3] = the same rows, K bytes 16+4tg..;
//                    (ldmatrix.x4 of matrices {rows 0-7, 8-15} x {bytes 0-15, 16-31} gives it);
//   D:               d[4j], d[4j+1] = row 16w+g, columns 8j+2tg, 8j+2tg+1;
//                    d[4j+2], d[4j+3] = row 16w+g+8, the same columns.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace azt {

constexpr int kSwizzleRow = 128;    // K bytes per row of a swizzled tile
constexpr int kTileAlign = 1024;    // alignment of a swizzled tile in shared memory
constexpr int kWgmmaK = 32;         // K bytes of one wgmma s8 instruction

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
}

// After the inits, before any thread or the TMA unit uses the barriers.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Whether the barrier's phase differs from `parity`: a fresh barrier is in
// phase 0, so parity 1 passes at once and parity 0 waits for the first
// completion.
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Spins until the phase differs from `parity`. No legitimate wait of these
// kernels lasts a second, so after kWatchdogCycles the kernel traps: a
// protocol error surfaces as a CUDA error at the next synchronise instead
// of a hung device.
constexpr long long kWatchdogCycles = 4000000000LL;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWatchdogCycles) __trap();
}

// ---- TMA --------------------------------------------------------------------

// Box {c0 .. c0 + box0, c1 .. c1 + box1} of the mapped tensor -> shared
// memory; `bar` receives the box's bytes (zeros where the box leaves the
// tensor count as well). One thread starts it.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Tensor map of a row-major int8 matrix (rows x cols, `cols` contiguous, a
// multiple of 16) read in boxes of box_rows x 128 bytes with the 128-byte
// swizzle; out-of-range bytes read as zero. cuTensorMapEncodeTiled is a
// function of libcuda: it is looked up through the runtime
// (cudaGetDriverEntryPoint), so nothing links against libcuda. Returns 0 or
// a cudaError_t / 1000 + CUresult.
inline int make_tensor_map_s8(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                              uint32_t box_rows) {
  typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorSymbolNotFound;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols};  // bytes between rows
  const cuuint32_t box[2] = {(cuuint32_t)kSwizzleRow, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

// The same map from a small table (behind a mutex) keyed by (base, rows, cols,
// box_rows), which is all a map depends on: a layer's weights keep their
// address, so their map is encoded once, not once per call.
inline int cached_tensor_map_s8(CUtensorMap* map, const void* base, uint64_t rows,
                                uint64_t cols, uint32_t box_rows) {
  struct Entry {
    const void* base = nullptr;
    uint64_t rows = 0, cols = 0;
    uint32_t box_rows = 0;
    alignas(64) CUtensorMap map;
  };
  constexpr int kEntries = 256;
  static Entry table[kEntries];
  static std::mutex guard;
  const std::lock_guard<std::mutex> lock(guard);
  Entry& e = table[(((uintptr_t)base >> 8) ^ ((uintptr_t)base >> 16) ^ box_rows) % kEntries];
  if (e.base != base || e.rows != rows || e.cols != cols || e.box_rows != box_rows) {
    e.base = nullptr;
    const int rc = make_tensor_map_s8(&e.map, base, rows, cols, box_rows);
    if (rc != 0) return rc;
    e.base = base, e.rows = rows, e.cols = cols, e.box_rows = box_rows;
  }
  *map = e.map;  // a copy: a later lookup may reuse the entry
  return 0;
}

// Streaming multiprocessors of the current device: the grid of a persistent kernel.
inline int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// ---- wgmma ------------------------------------------------------------------

// Before the first wgmma, and whenever registers it reads or accumulates
// into were written by other instructions.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Until at most `Pending` committed groups are still running.
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulators across the
// asynchronous products around it.
template <int N>
__device__ __forceinline__ void acc_fence(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Matrix descriptor of a K-major tile in the 128-byte swizzle that starts at
// shared-memory address `addr` (1024-byte aligned, plus a K offset of 0, 32,
// 64 or 96 bytes): start address and the 1024-byte stride between 8-row
// groups in 16-byte units, layout type 1 (128-byte swizzle) in bits 62-63.
// The leading byte offset is not used by swizzled K-major tiles (set to 1).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(kTileAlign >> 4) << 32) | ((uint64_t)1 << 62);
}

#define AZT_ACC8(d, i)                                                                    \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])
#define AZT_ACC32(d, i) AZT_ACC8(d, i), AZT_ACC8(d, i + 8), AZT_ACC8(d, i + 16), AZT_ACC8(d, i + 24)

// Wgmma<N>::ss / ::rs: D (64 x N int32, N / 2 registers a thread) = A (64 x
// 32) * B (N x 32)^T + (scale_d ? D : 0), executed by all four warps of a
// warpgroup. Inline PTX has no register ranges, so every accumulator is
// listed.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void rs(int (&d)[16], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n}\n"
        : AZT_ACC8(d, 0), AZT_ACC8(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void ss(int (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : AZT_ACC32(d, 0)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
  __device__ __forceinline__ static void rs(int (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : AZT_ACC32(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void ss(int (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : AZT_ACC32(d, 0), AZT_ACC32(d, 32)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
  __device__ __forceinline__ static void rs(int (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n}\n"
        : AZT_ACC32(d, 0), AZT_ACC32(d, 32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void ss(int (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p;\n}\n"
        : AZT_ACC32(d, 0), AZT_ACC32(d, 32), AZT_ACC32(d, 64), AZT_ACC32(d, 96)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
  __device__ __forceinline__ static void rs(int (&d)[128], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p;\n}\n"
        : AZT_ACC32(d, 0), AZT_ACC32(d, 32), AZT_ACC32(d, 64), AZT_ACC32(d, 96)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};
#undef AZT_ACC32
#undef AZT_ACC8

// ---- registers between warpgroups ------------------------------------------

// All four warps of a warpgroup execute these together; the kernel's roles
// must sit in one if / else that never reconverges, or ptxas ignores them.
template <int Regs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Regs));
}

template <int Regs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Regs));
}

}  // namespace azt
