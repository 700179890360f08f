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
// The quantisation and the epilogue's float32 operations, in the reference's
// order, are csrc/qconv_common.cuh, shared with the mma.sync kernel this one
// replaced (csrc/qconv_mma_kernel.cu), so the two agree bit for bit. Never
// build with --use_fast_math.
//
// What bounds it: at the mask net's shapes (129 folded-frequency rows,
// T = 64..8, Cin = 64..256, batch 128) every layer is bound by its float32
// activation bytes (Cin = Cout = 64 at T = 64: 541 MB against 77 GOP; even
// 256 -> 256 at T = 8: 271 MB, 0.081 ms, against 156 GOP, 0.079 ms). The
// mma.sync kernel reached a quarter of the memory rate and a tenth of the
// tensor rate: a block loaded, multiplied and stored in turn, and every
// block pulled the layer's whole weight matrix from L2 for its 64 to 256
// pixels.
//
// Design: implicit GEMM (M = output pixels, N = Cout, K = 9 * Cin tap-major)
// in persistent, warp-specialised blocks, one per SM: two consumer
// warpgroups and 8 producer warps (4 at Cout = 256, see PW below).
//   - A block takes a contiguous run of tiles, walking down the frequency
//     rows of one stream. Producers read the next tile's float32 rows (both
//     inputs of a channel concat in place), quantise them and write the int8
//     halo into the second of two halo buffers, while the consumers work on
//     the first. The two halo rows a tile shares with the one above are
//     copied from that tile's halo, so every input row is read from device
//     memory and quantised once. Each thread keeps two batches of 6 float4
//     loads in flight. The nine taps are address offsets into the halo;
//     im2col never exists.
//   - Weights come by TMA in the 128-byte swizzle. Packed weights
//     (Cout, 9 * Cin) are K-major already, which is what wgmma's B wants.
//     Where all of them fit beside the halos they are loaded once per block
//     and stay (14 of the net's 21 convs); else K chunks of 128 bytes stream
//     through a ring of 3 or more stages, once per tile of 128 pixels, fed
//     by a producer warp of its own (the ring wants a chunk every few
//     hundred cycles). The host-side plan (kernels/qconv_kernel.py:plan)
//     decides which, and the ring's depth; the tensor map is cached per layer.
//   - Two consumer warpgroups own 64 * MI pixels each and all Cout channels:
//     wgmma m64nCoutk32 s8, B through a shared-memory descriptor, A from
//     registers by ldmatrix out of the halo (pixels padded by 16 bytes, so
//     the eight rows of a matrix hit distinct banks). A from registers, not
//     through a descriptor: a descriptor wants the 8-pixel groups of a
//     64-row tile at one stride, which the halo gives only when a tile is
//     one row of 64 frames or rows of 8, and it would want the halo swizzled
//     per 128 channels; ldmatrix takes any tile shape and any Cin % 32 == 0.
//   - Epilogue: the five epilogue rows sit in shared memory; each warp
//     stages 16 pixels x 32 channels at a time through its own patch of
//     shared memory and writes (and reads the residual, which the block asked
//     L2 for when the tile began) 16 bytes a lane, 128 contiguous bytes per
//     pixel. It overlaps the producers' next halo.
// The split route (template Split, Cout of 256 or 512 on N = 256): the
// shapes above leave the mma.sync kernel's 32-pixel tiles, which streamed the
// whole weight matrix from L2 for every 32 pixels (2.36 MB a tile at
// 512 -> 512). Three things kept them off this kernel, and the split instance
// answers each:
//   - Cout = 512 would want 256 accumulators a thread: the block walks the
//     output channels in n_slices slices of 256 (128 accumulators, as at
//     Cout = 256), with the epilogue after each; one halo serves both slices
//     when it holds all channels, and the weights stream once per slice.
//   - At Cin = 512 two halos of all channels leave no room for three weight
//     stages: the halo is made in n_parts parts of Cs channels (Cs a multiple
//     of 128), and K is walked part by part, tap-major inside a part (the
//     TMA coordinate of a chunk is tap * Cin + part * Cs + ...). The int32
//     sums are exact, so their order does not change a bit. Each part is a
//     halo unit of its own in the double buffer, so the producers make the
//     next part while the consumers multiply this one; odd slices walk the
//     parts backwards, so a slice begins on the unit the last one ended with.
//   What bounds it (the clocks build): the halo producers, which read a
//   tile's input once per slice when it comes in parts; the consumers wait
//   for halos for up to ~45 % of a tile at 512 -> 512.
//   - At 6 frames a 4-wide tile's halos are 13 % larger than an 8-wide
//     tile's: the plan takes the tile width that pads the frames least
//     (8 for 6 frames, its last two columns masked as at any ragged edge).
// Cin % 32 != 0 (the net's 16-channel stem), Cout = 32 and the shapes that
// neither instance fits stay on the mma.sync kernel; the wrapper picks by
// shape (kernels/qconv_kernel.py:plan).
//
// Built with -DAZT_QCONV_CLOCKS (kernels/bench.py clocks), block 0 also sums
// the cycles its first consumer thread and first producer thread spend
// waiting and working, per tile: the profilers that read stall reasons do
// not run everywhere, and which role is critical is the first question.

#include "qconv_common.cuh"
#include "wgmma_s8.cuh"

namespace {

using namespace azt;

// Threads 0..255 are the two consumer warpgroups; PW producer warps follow. A
// block starts with 65,536 registers over its threads, and ptxas holds the
// whole kernel to that count whatever setmaxnreg grants later: 168 at 384
// threads (PW = 4), which the 128 accumulators of Cout = 256 need; 128 at
// 512 threads (PW = 8) for Cout <= 128, where more producers are worth more.
constexpr int kConsumers = 256;
constexpr int kStageRow = 40;          // floats per staged output row: 32 channels + 8 of padding
constexpr int kStageBytes = 8 * 16 * kStageRow * 4;  // 16 rows for each consumer warp
constexpr int kMaxStages = 18;         // K chunks of Cin = 256
constexpr int kBarBytes = (2 * kMaxStages + 4) * 8;
constexpr int kSmemLimit = 232448;     // bytes a block may have on sm_90

struct Params {
  const float* x;
  const float* x2;
  const float* epi;
  const float* res;
  float* out;
  float act_scale;
  int relu;
  int F, T, Cin, Cin1;
  int Cout;                           // channels of out, res and epi: n_slices * N
  int Cs, n_parts;                    // channels of a halo part (Split; else Cin), Cin / Cs
  int n_slices;                       // slices of N output channels (Split; else 1)
  int tw_log2;                        // a tile is 2^tw_log2 frames by (128 * MI) >> tw_log2 rows
  int n_ttiles, n_ftiles, n_tiles;
  int n_chunks;                       // K chunks of 128 bytes of one part
  int stages;                         // weight ring; == n_chunks: the weights stay (not Split)
  uint32_t magic_hw, magic_c4;        // ceil(2^32 / (TW + 2)), ceil(2^32 / (Cs / 4))
#ifdef AZT_QCONV_CLOCKS
  // cycles of block 0: consumer waiting for a halo, in the products, in the epilogue;
  // producer waiting for a buffer, loading and quantising; tiles
  long long* clocks;
#endif
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// One producer thread's batch of U float4s of the halo.
template <int U>
struct HaloBatch {
  float4 v[U];
  int first;  // item (float4 of the halo) of v[0]; v[u] is item first + u * n_halo
};

template <int N, int MI, int PW, bool Split>
__global__ void __launch_bounds__(kConsumers + 32 * PW, 1) qconv_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_w, const Params p) {
  constexpr int kThreads = kConsumers + 32 * PW;
  constexpr int U = 6;                      // float4 loads per batch; two batches in flight
  constexpr int kMTile = 128 * MI;          // pixels of a tile
  constexpr int kWStage = N * kSwizzleRow;  // bytes of one K chunk of the weights
  constexpr int G = N == 256 ? 2 : 4;       // K steps per group of products
  const int TW = 1 << p.tw_log2, HW = TW + 2;
  const int FR = kMTile >> p.tw_log2;
  // What the split route varies; constants of the other instances.
  const int Cs = Split ? p.Cs : p.Cin;      // channels of a halo part
  const int Cout = Split ? p.Cout : N;
  const int n_parts = Split ? p.n_parts : 1, n_slices = Split ? p.n_slices : 1;
  // Halo units a tile takes: one halo of all channels serves every slice;
  // in parts, odd slices walk the parts backwards, so a slice's first part
  // is the unit the slice before it ended with.
  const int units = n_parts == 1 ? 1 : n_slices * (n_parts - 1) + 1;
  const int CinP = Cs + 16;                 // pixel stride of the halo
  const int halo_bytes = (FR + 2) * HW * CinP;
  const bool resident = !Split && p.stages == p.n_chunks;  // the split route's weights stream
  // The producer warps make the halos; one of them only feeds the weight ring, if there is one.
  const int n_halo = resident ? 32 * PW : 32 * (PW - 1);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kTileAlign - (smem_u32(smem_raw) & (kTileAlign - 1))) &
                                    (kTileAlign - 1));
  unsigned char* wbuf = smem;                              // stages x (N rows x 128 K bytes)
  unsigned char* halo0 = wbuf + p.stages * kWStage;        // two int8 halos
  unsigned char* stage0 = halo0 + 2 * halo_bytes;          // the consumers' output patches
  float* epi_s = reinterpret_cast<float*>(stage0 + kStageBytes);  // (5, Cout)
  uint64_t* w_full = reinterpret_cast<uint64_t*>(epi_s + 5 * Cout);
  uint64_t* w_empty = w_full + kMaxStages;
  uint64_t* h_full = w_empty + kMaxStages;
  uint64_t* h_empty = h_full + 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(w_full + s, 1);    // the weight warp's arrive; the TMA unit adds the bytes
      mbar_init(w_empty + s, 8);   // one lane of each consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(h_full + b, n_halo);
      mbar_init(h_empty + b, 8);
    }
    mbar_init_fence();
  }
  for (int i = threadIdx.x; i < 5 * Cout; i += kThreads) epi_s[i] = p.epi[i];
  __syncthreads();

  // A block takes a contiguous run of tiles, in the order (stream, frame
  // tile, row tile): the next tile is mostly the one below, whose first two
  // halo rows are this tile's last two.
  const int tiles_per_b = p.n_ftiles * p.n_ttiles;
  const int tile_begin = (int)((long)blockIdx.x * p.n_tiles / gridDim.x);
  const int tile_end = (int)((long)(blockIdx.x + 1) * p.n_tiles / gridDim.x);

  if (threadIdx.x >= kConsumers) {
    // ======================= producers =======================================
    reg_dealloc<(PW == 8 ? 96 : 104)>();
    const int ptid = threadIdx.x - kConsumers;
    // ---- the weights, by TMA ------------------------------------------------------
    // Weights that stay are requested once, by the first halo thread. A ring
    // needs a chunk every few hundred cycles, more often than a thread that
    // also makes halos comes by: it gets producer warp 0 to itself.
    if (!resident && ptid < 32) {
      if (ptid == 0) {
        int s = 0, parity = 1;  // a fresh stage is empty
        const int cpt = Cs / kSwizzleRow;  // chunks per tap of a part (n_parts > 1)
        for (int tile = tile_begin; tile < tile_end; ++tile)
          for (int ns = 0; ns < n_slices; ++ns)
            for (int part = 0; part < n_parts; ++part)
              for (int c = 0; c < p.n_chunks; ++c) {
                mbar_wait(w_empty + s, parity);
                mbar_arrive_expect_tx(w_full + s, kWStage);
                // K byte of the chunk: contiguous with one part, else tap-major in the part
                const int pt = ns & 1 ? n_parts - 1 - part : part;
                const int k = n_parts == 1
                                  ? c * kSwizzleRow
                                  : (c / cpt) * p.Cin + pt * Cs + (c % cpt) * kSwizzleRow;
                tma_load_2d(wbuf + s * kWStage, &map_w, w_full + s, k, ns * N);
                if (++s == p.stages) { s = 0; parity ^= 1; }
              }
      }
    } else {
      const int htid = resident ? ptid : ptid - 32;
      if (resident && htid == 0) {
        for (int c = 0; c < p.n_chunks; ++c) {
          mbar_arrive_expect_tx(w_full + c, kWStage);
          tma_load_2d(wbuf + c * kWStage, &map_w, w_full + c, c * kSwizzleRow, 0);
        }
      }
      // ---- the quantised halo -------------------------------------------------
      const int cs4 = Cs >> 2, cin14 = p.Cin1 >> 2, cinp4 = CinP >> 2;
      const int n_items = (FR + 2) * HW * cs4;  // float4s of a halo
      const float rs = 1.f / p.act_scale;
      // the part of a tile's halo unit: 0, 1, .., n_parts - 1, n_parts - 2, .., 0
      auto part_of = [&](int unit) {
        const int bounce = unit % (2 * n_parts - 2 + (n_parts == 1));
        return bounce < n_parts ? bounce : 2 * n_parts - 2 - bounce;
      };
      int it = 0;  // halo units made
      for (int tile = tile_begin; tile < tile_end; ++tile)
      for (int unit = 0; unit < units; ++unit, ++it) {
        const int b = tile / tiles_per_b, rem = tile - b * tiles_per_b;
        const int ft = rem % p.n_ftiles;
        const int f0 = ft * FR - 1, t0 = (rem / p.n_ftiles) * TW - 1;
        const int c4_0 = part_of(unit) * cs4;  // first float4 of this part's channels
        const int buf = it & 1;
        uint32_t* halo32 = reinterpret_cast<uint32_t*>(halo0 + buf * halo_bytes);
#ifdef AZT_QCONV_CLOCKS
        const long long tp0 = clock64();
#endif
        mbar_wait(h_empty + buf, ((it >> 1) & 1) ^ 1);
        // Every halo thread is done with the previous unit (whose halo the
        // slower ones may still be copying from) before any writes into it.
        if (it > 0) mbar_wait(h_full + (buf ^ 1), ((it - 1) >> 1) & 1);
        // Below the block's previous tile, whose halo holds all channels:
        // halo rows 0 and 1 are that halo's rows FR and FR + 1.
        const bool below = units == 1 && it > 0 && ft > 0;
        if (below) {
          const uint4* src = reinterpret_cast<const uint4*>(halo0 + (buf ^ 1) * halo_bytes +
                                                            FR * HW * CinP);
          uint4* dst = reinterpret_cast<uint4*>(halo32);
          for (int j = htid; j < 2 * HW * (CinP >> 4); j += n_halo) dst[j] = src[j];
        }
        const int item0 = below ? 2 * HW * cs4 : 0;
#ifdef AZT_QCONV_CLOCKS
        const long long tp1 = clock64();
#endif
        // Batch k + 1 is loaded before batch k is quantised, so loads stay in flight.
        auto load = [&](HaloBatch<U>& bt, int first) {
          bt.first = first;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = first + u * n_halo;
            const int pix = __umulhi(i, p.magic_c4);   // i / cs4
            const int c4 = c4_0 + i - pix * cs4;
            const int hr = __umulhi(pix, p.magic_hw);  // pix / HW
            const int f = f0 + hr, t = t0 + (pix - hr * HW);
            bt.v[u] = make_float4(0.f, 0.f, 0.f, 0.f);  // outside the plane: zeros
            if (i < n_items && f >= 0 && f < p.F && t >= 0 && t < p.T) {
              const long at = ((long)b * p.F + f) * p.T + t;
              const float* src = c4 < cin14 ? p.x + at * p.Cin1 + 4 * c4
                                            : p.x2 + at * (p.Cin - p.Cin1) + 4 * (c4 - cin14);
              bt.v[u] = __ldg(reinterpret_cast<const float4*>(src));
            }
          }
        };
        auto store = [&](const HaloBatch<U>& bt) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = bt.first + u * n_halo;
            const int pix = __umulhi(i, p.magic_c4);
            if (i < n_items)
              halo32[pix * cinp4 + (i - pix * cs4)] = quant4_magic(bt.v[u], p.act_scale, rs);
          }
        };
        HaloBatch<U> b0, b1;
        load(b0, item0 + htid);
        for (int base = item0 + htid; base < n_items; base += 2 * n_halo * U) {
          load(b1, base + n_halo * U);
          store(b0);
          load(b0, base + 2 * n_halo * U);
          store(b1);
        }
#ifdef AZT_QCONV_CLOCKS
        if (blockIdx.x == 0 && htid == 0) {
          p.clocks[3] += tp1 - tp0;
          p.clocks[4] += clock64() - tp1;
        }
#endif
        mbar_arrive(h_full + buf);
      }
    }
  } else {
    // ======================= consumers =======================================
    reg_alloc<(PW == 8 ? 160 : 200)>();
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: this lane's matrix and row
    // First pixel of this warp's 16 rows in each of its MI 64-row subtiles.
    int row0[MI];
    // A (pixels x K): matrices 0..3 = rows 0-7 / 8-15, K bytes 0-15 / 16-31.
    uint32_t arow[MI];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      row0[mi] = (wg * MI + mi) * 64 + warp * 16;
      const int px = row0[mi] + (mat & 1) * 8 + mrow;
      arow[mi] = ((px >> p.tw_log2) * HW + (px & (TW - 1))) * CinP + (mat >> 1) * 16;
    }
    float* st = reinterpret_cast<float*>(stage0) + (threadIdx.x >> 5) * 16 * kStageRow;
    const int n_ksteps = 9 * Cs / kWgmmaK;  // of one part

    int acc[MI][N / 2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[mi][i] = 0;

    int ws = 0, wparity = 0;  // the weight ring, when it streams
    int it = 0;               // halo units taken
    for (int tile = tile_begin; tile < tile_end; ++tile) {
      const int b = tile / tiles_per_b, rem = tile - b * tiles_per_b;
      const int f0 = (rem % p.n_ftiles) * FR, t0 = (rem / p.n_ftiles) * TW;
#ifdef AZT_QCONV_CLOCKS
      long long t_wait = 0, t_prod = 0, t_epi = 0;
#endif

      // Ask L2 for the tile's residual now; the epilogue's reads then find it there.
      if (p.res) {
        const int tl = t0, th = min(p.T, t0 + TW), fh = min(p.F, f0 + FR);
        const int lines = ((th - tl) * Cout * 4 + 127) >> 7;  // 128-byte lines of a row
        for (int j = threadIdx.x; j < (fh - f0) * lines; j += kConsumers) {
          const int r = j / lines;
          const char* a =
              reinterpret_cast<const char*>(p.res + (((long)b * p.F + f0 + r) * p.T + tl) * Cout) +
              128 * (j - r * lines);
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a));
        }
      }

      for (int ns = 0; ns < n_slices; ++ns) {
        int ks = 0;  // K step of the slice: 32 channels of one tap of one part
        for (int part = 0; part < n_parts; ++part) {
          // A halo unit of its own for each part, but for the one a slice
          // shares with the next; one for all slices when it holds all channels.
          const bool fresh = n_parts == 1 ? ns == 0 : ns == 0 || part > 0;
          const int buf = it & 1;
          const uint32_t halo = smem_u32(halo0 + buf * halo_bytes);
#ifdef AZT_QCONV_CLOCKS
          const long long tc0 = clock64();
#endif
          if (fresh) mbar_wait(h_full + buf, (it >> 1) & 1);
#ifdef AZT_QCONV_CLOCKS
          const long long tc1 = clock64();
          t_wait += tc1 - tc0;
#endif

          // ---- products -----------------------------------------------------------
          int c0 = 0, dx = 0, tap_off = 0;  // channel offset, and the tap's offset in the halo
          for (int c = 0; c < p.n_chunks; ++c) {
            const int s = resident ? c : ws;
            mbar_wait(w_full + s, resident ? 0 : wparity);
            const uint64_t db = wgmma_desc(smem_u32(wbuf + s * kWStage));
            const int steps = min(4, n_ksteps - 4 * c);
            for (int j0 = 0; j0 < steps; j0 += G) {
              uint32_t a[MI][G][4];
#pragma unroll
              for (int j = 0; j < G; ++j) {
                if (j0 + j < steps) {
#pragma unroll
                  for (int mi = 0; mi < MI; ++mi)
                    ldmatrix_x4(a[mi][j], halo + arow[mi] + tap_off + c0);
                  c0 += kWgmmaK;
                  if (c0 == Cs) {  // on to the next tap: (dy, dx + 1), or (dy + 1, 0)
                    c0 = 0;
                    tap_off += CinP;
                    if (++dx == 3) { dx = 0; tap_off += (HW - 3) * CinP; }
                  }
                }
              }
#pragma unroll
              for (int mi = 0; mi < MI; ++mi) acc_fence(acc[mi]);
              wgmma_fence();
#pragma unroll
              for (int j = 0; j < G; ++j) {
                if (j0 + j < steps) {
#pragma unroll
                  for (int mi = 0; mi < MI; ++mi)
                    Wgmma<N>::rs(acc[mi], a[mi][j], db + 2 * (j0 + j), ks != 0);
                  ++ks;
                }
              }
              wgmma_commit();
              wgmma_wait<0>();
            }
            if (!resident) {  // this warp is done with the stage
              __syncwarp();
              if (lane == 0) mbar_arrive(w_empty + s);
              if (++ws == p.stages) { ws = 0; wparity ^= 1; }
            }
          }
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) acc_fence(acc[mi]);
          if (ns == n_slices - 1 || (n_parts > 1 && part < n_parts - 1)) {  // its last use
            __syncwarp();
            if (lane == 0) mbar_arrive(h_empty + buf);  // the producers may refill this halo
            ++it;
          }
#ifdef AZT_QCONV_CLOCKS
          t_prod += clock64() - tc1;
#endif
        }
#ifdef AZT_QCONV_CLOCKS
        const long long tc2 = clock64();
#endif

        // ---- epilogue: output channels nb .. nb + N - 1 -------------------------------
        const int nb = ns * N;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          // Reading back, lane L takes channels 4 * (L % 8) .. + 3 of rows L / 8 + 4 * q.
          long obase[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int px = row0[mi] + (lane >> 3) + 4 * q;
            const int f = f0 + (px >> p.tw_log2), t = t0 + (px & (TW - 1));
            obase[q] = f < p.F && t < p.T
                           ? (((long)b * p.F + f) * p.T + t) * Cout + nb + 4 * (lane & 7) : -1;
          }
#pragma unroll
          for (int slab = 0; slab < N / 32; ++slab) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int j = slab * 4 + jj, n = 8 * j + 2 * tg;
              float2 e[5];  // s1, b1, mean, mul, beta at channels nb + n, nb + n + 1
#pragma unroll
              for (int k = 0; k < 5; ++k)
                e[k] = *reinterpret_cast<const float2*>(epi_s + k * Cout + nb + n);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float y0 =
                    dequant_bn(acc[mi][4 * j + 2 * h], e[0].x, e[1].x, e[2].x, e[3].x, e[4].x);
                const float y1 =
                    dequant_bn(acc[mi][4 * j + 2 * h + 1], e[0].y, e[1].y, e[2].y, e[3].y, e[4].y);
                *reinterpret_cast<float2*>(st + (g + 8 * h) * kStageRow + 8 * jj + 2 * tg) =
                    make_float2(y0, y1);
              }
            }
            float4 r[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              r[q] = make_float4(0.f, 0.f, 0.f, 0.f);
              if (p.res && obase[q] >= 0)
                r[q] = __ldg(reinterpret_cast<const float4*>(p.res + obase[q] + slab * 32));
            }
            __syncwarp();
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float4 y = *reinterpret_cast<const float4*>(
                  st + ((lane >> 3) + 4 * q) * kStageRow + 4 * (lane & 7));
              if (obase[q] >= 0) {
                y.x = res_relu(y.x, r[q].x, p.res != nullptr, p.relu);
                y.y = res_relu(y.y, r[q].y, p.res != nullptr, p.relu);
                y.z = res_relu(y.z, r[q].z, p.res != nullptr, p.relu);
                y.w = res_relu(y.w, r[q].w, p.res != nullptr, p.relu);
                *reinterpret_cast<float4*>(p.out + obase[q] + slab * 32) = y;
              }
            }
            __syncwarp();  // the patch is free for the next slab
          }
        }
#ifdef AZT_QCONV_CLOCKS
        t_epi += clock64() - tc2;
#endif
      }
#ifdef AZT_QCONV_CLOCKS
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        p.clocks[0] += t_wait;
        p.clocks[1] += t_prod;
        p.clocks[2] += t_epi;
        p.clocks[5] += 1;
      }
#endif
    }
  }
}

#ifdef AZT_QCONV_CLOCKS
long long* clocks_buffer() {
  static long long* buf = nullptr;
  if (!buf) cudaMalloc(&buf, 6 * sizeof(long long));
  return buf;
}
#endif

template <int N, int MI, int PW, bool Split>
int launch(const Params& p, const void* w, int smem, int tile_w, cudaStream_t stream) {
  const int fr = (128 * MI) / tile_w;
  const int need = kTileAlign + p.stages * N * kSwizzleRow +
                   2 * (fr + 2) * (tile_w + 2) * (p.Cs + 16) + kStageBytes + 5 * p.Cout * 4 +
                   kBarBytes;
  if (need != smem || smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  static int raised = 0;
  if (smem > raised) {  // dynamic shared memory above 48 KB must be opted into
    const cudaError_t e = cudaFuncSetAttribute(
        qconv_wgmma_kernel<N, MI, PW, Split>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    raised = smem;
  }
  CUtensorMap map_w;  // encoded once per layer: the table is keyed by the weights' address
  const int rc = cached_tensor_map_s8(&map_w, w, p.Cout, 9 * (uint64_t)p.Cin, N);
  if (rc != 0) return rc;
  const int grid = p.n_tiles < sm_count() ? p.n_tiles : sm_count();
  qconv_wgmma_kernel<N, MI, PW, Split><<<grid, kConsumers + 32 * PW, smem, stream>>>(map_w, p);
  return (int)cudaGetLastError();
}

// The parameters both entry points share; Cs == Cin and one slice unless split.
Params make_params(const void* x, const void* x2, const void* epi, const void* res, void* out,
                   float act_scale, int relu, int B, int F, int T, int Cin, int Cin1, int Cout,
                   int m_tile, int tw_log2, int Cs, int n_slices, int stages) {
  const int tile_w = 1 << tw_log2;
  Params p;
  p.x = (const float*)x, p.x2 = (const float*)x2, p.epi = (const float*)epi;
  p.res = (const float*)res, p.out = (float*)out;
  p.act_scale = act_scale, p.relu = relu;
  p.F = F, p.T = T, p.Cin = Cin, p.Cin1 = Cin1;
  p.Cout = Cout, p.Cs = Cs, p.n_parts = Cin / Cs, p.n_slices = n_slices;
  p.tw_log2 = tw_log2;
  p.n_ttiles = (T + tile_w - 1) / tile_w;
  p.n_ftiles = (F + m_tile / tile_w - 1) / (m_tile / tile_w);
  p.n_tiles = B * p.n_ftiles * p.n_ttiles;
  p.n_chunks = (9 * Cs + kSwizzleRow - 1) / kSwizzleRow;
  p.stages = stages;
  p.magic_hw = (uint32_t)(((1ull << 32) + tile_w + 1) / (tile_w + 2));
  p.magic_c4 = (uint32_t)(((1ull << 32) + Cs / 4 - 1) / (Cs / 4));
#ifdef AZT_QCONV_CLOCKS
  p.clocks = clocks_buffer();
#endif
  return p;
}

int log2_of(int tile_w) {  // -1 unless a power of two
  int l = 0;
  while ((1 << l) < tile_w) ++l;
  return (1 << l) == tile_w ? l : -1;
}

}  // namespace

// x (B, F, T, Cin1) f32 and x2 (B, F, T, Cin - Cin1) f32 or null (then
// Cin1 == Cin): the input is their channel concat. w (Cout, 9 * Cin) int8, K
// index (3*dy+dx)*Cin + c; epi (5, Cout) f32 rows s1, b1, mean, mul, beta;
// res (B, F, T, Cout) f32 or null; out (B, F, T, Cout) f32. Needs
// Cin % 32 == 0, Cin1 % 4 == 0 and Cout in {64, 128, 256}. tile_w (frames of
// a tile, a power of two up to 64), stages (of the weight ring; the number of
// 128-byte K chunks means the weights stay in shared memory) and smem (bytes
// of shared memory) come from the wrapper's plan; smem is checked against
// this file's own sum. A tile is 256 pixels at Cout = 64, else 128. Returns
// 0, a cudaError_t, or 1000 + the CUresult of building the tensor map.
extern "C" int azt_qconv3x3(const void* x, const void* x2, const void* w, const void* epi,
                            const void* res, void* out, float act_scale, int relu, int B, int F,
                            int T, int Cin, int Cin1, int Cout, int tile_w, int stages, int smem,
                            void* stream) {
  const int m_tile = Cout == 64 ? 256 : 128;
  const int tw_log2 = log2_of(tile_w);
  const int n_chunks = (9 * Cin + kSwizzleRow - 1) / kSwizzleRow;
  if (Cin % 32 || Cin1 % 4 || (Cout != 64 && Cout != 128 && Cout != 256) || tw_log2 < 0 ||
      tile_w > 64 || tile_w > m_tile || stages < 1 || stages > n_chunks || stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(x, x2, epi, res, out, act_scale, relu, B, F, T, Cin, Cin1, Cout,
                               m_tile, tw_log2, Cin, 1, stages);
  cudaStream_t st = (cudaStream_t)stream;
#ifdef AZT_QCONV_CLOCKS
  cudaMemsetAsync(p.clocks, 0, 6 * sizeof(long long), st);
#endif
  if (Cout == 64) return launch<64, 2, 8, false>(p, w, smem, tile_w, st);
  if (Cout == 128) return launch<128, 1, 8, false>(p, w, smem, tile_w, st);
  return launch<256, 1, 4, false>(p, w, smem, tile_w, st);
}

// The split route: the same operands with Cout of 256 or 512, walked in
// Cout / 256 slices of 256 output channels and Cin / part_channels halo parts
// (part_channels == Cin, or a multiple of 128 that divides it). Tiles of 128
// pixels; stages of the weight ring, which always streams; the other
// arguments and the return value as azt_qconv3x3.
extern "C" int azt_qconv3x3_split(const void* x, const void* x2, const void* w, const void* epi,
                                  const void* res, void* out, float act_scale, int relu, int B,
                                  int F, int T, int Cin, int Cin1, int Cout, int tile_w,
                                  int part_channels, int stages, int smem, void* stream) {
  const int Cs = part_channels;
  const int tw_log2 = log2_of(tile_w);
  if (Cin % 32 || Cin1 % 4 || (Cout != 256 && Cout != 512) || tw_log2 < 0 || tile_w > 64 ||
      Cs < 32 || Cs % 32 || Cin % Cs || (Cs != Cin && Cs % kSwizzleRow) || stages < 1 ||
      stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(x, x2, epi, res, out, act_scale, relu, B, F, T, Cin, Cin1, Cout,
                               128, tw_log2, Cs, Cout / 256, stages);
  cudaStream_t st = (cudaStream_t)stream;
#ifdef AZT_QCONV_CLOCKS
  cudaMemsetAsync(p.clocks, 0, 6 * sizeof(long long), st);
#endif
  return launch<256, 1, 4, true>(p, w, smem, tile_w, st);
}

#ifdef AZT_QCONV_CLOCKS
// The six sums of the last launch (see Params::clocks), after it has ended.
extern "C" int azt_qconv3x3_clocks(long long* out) {
  const cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpy(out, clocks_buffer(), 6 * sizeof(long long), cudaMemcpyDeviceToHost);
}
#endif
