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
// act_scale is a static scale passed by value, or (the dynamic mode of the
// reference's QConv, a compile-time variant of every instance) comes from
// the input's per-element maxima max|x[b]| in device memory (and max|x2[b]|
// at a concat), which the launches that produced x and x2 wrote in their
// epilogues (csrc/act_max.cuh): a tile of element b forms
// scale = max / 127 + 1e-30 itself, quantises with it as with a static
// scale of that value, and forms s1[n] = scale * w_scale[n] from epi's row
// 0, which then holds the weight scales. A dynamic launch may write its own
// output's maxima into out_max: each consumer warp takes the maximum of the
// |y| it stores in a tile (one element's: a tile never spans two) and adds
// it with one atomicMax. The static instances compile as they did.
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
// warpgroups and 8 producer warps (4 at Cout = 256, see PW below), all of
// which make halos.
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
//     through a ring of 2 or more stages, once per tile of 128 pixels. The
//     consumers feed the ring themselves: each consumer warp counts itself
//     done with a stage in a shared-memory counter, and the eighth asks TMA
//     for the chunk `stages` chunks later into it at once. A warp of the
//     ring's own would wait for an empty stage most of a tile while the halo
//     producers are the critical role (one of 4 producer warps at Cout =
//     256). The host-side plan (kernels/qconv_kernel.py:plan) decides
//     which, and the ring's depth; the tensor map is cached per layer.
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
//     L2 for when the tile began, and L1 for a slab ahead) 16 bytes a lane,
//     128 contiguous bytes per pixel. It overlaps the producers' next halo.
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
//     halo unit of its own in a buffer of its own, made once a tile and kept
//     for every slice, which walk the parts in the same order: the producers
//     make the next part while the consumers multiply this one, and the next
//     tile's first part while the last slice runs. The plan takes the fewest
//     parts whose n_parts buffers leave room for two weight stages (4 units a
//     tile at 512 -> 512 on 4 frames); shapes where none does (Cin = 512 on
//     64-frame tiles, Cin >= 1024) go to the any-width instances below.
//   - At 6 frames a 4-wide tile's halos are 13 % larger than an 8-wide
//     tile's: the plan takes the tile width that pads the frames least
//     (8 for 6 frames, its last two columns masked as at any ragged edge).
// The narrow route (the stems and Cout = 32; "narrow" in the wrapper's plan):
// the TPUFPU nets' 16-channel stem, the unfolded nets' stems of 2 or 4
// channels and every Cout = 32 conv of the base-32 nets ran on the mma.sync
// kernel at 2.5-3.6 times their byte bound. Three things kept them off this
// kernel, and the instances answer each:
//   - N = 32: instances on wgmma m64n32k32 (16 accumulators a thread per
//     64 rows) with MI = 4, tiles of 512 pixels; their weights (at most
//     32 x 576 bytes on the nets) always stay.
//   - 16-channel taps (K = 144, packed to 160 with zeros; template flag
//     Tap16, at N = 32 and 64): a 32-byte K step holds two taps, and the
//     lanes whose ldmatrix rows are K bytes 16-31 point at the next tap; the
//     fifth step's second half reads tap 8's pad bytes against zero weights.
//     The tensor map reads the packed rows of 160 bytes; the second chunk's
//     bytes past them are TMA's zero fill.
//   - stems of Cin1 = 2 or 4 channels (x2 null, Cin = 16; Tap16 instances
//     only): a producer item is one pixel, a float2 or float4 of x,
//     quantised into the pixel's first four codes; the other 12 channels of
//     both halos are zeroed once.
//   The flag keeps the other instances' loops as they were: a per-lane tap
//   walk and a stem test per item cost the split route 7-10 % and the
//   large-Cin wgmma shapes 3-6 % when every instance carried them (H100
//   80GB HBM3, kernels/bench.py qconv).
//   What bounds it (the clocks build): the halo producers at Cin of 32 and
//   64; at the stems the consumers, whose products and epilogue (128 or 256
//   bytes written a pixel against 8 to 64 read) run in turn.
// The any-width instances (template flag AnyWidth, entry azt_qconv3x3_any;
// kernels/qconv_kernel.py's plans with "wide"): the convs of nets trained at
// another --base (Cout of 24, 48, 96, 192, 384, 1024; Cin of 48, 80, 1024,
// 2048, ...) and the bundled widths that the routes above do not fit ran on
// the mma.sync kernel at 6-16.5 times their bound (its 64-pixel tiles each
// streamed a 256-channel slice's whole weight matrix from L2, and quantised
// the halo again for every slice, in turn with the products). Three things
// kept them off this kernel, and the instances answer each:
//   - Cout not one of 32, 64, 128, 256, 512: Cout runs on the least N of 32,
//     64, 128 and 256 that holds it, or in ceil(Cout / 256) slices of 256
//     (the split walk, the last slice partial). The tensor map's rows are
//     Cout, so TMA fills the weight rows at or beyond Cout with zeros; the
//     epilogue rows in shared memory are zero past Cout; the epilogue stores
//     (and reads the residual and takes the maxima) only below Cout, 16
//     bytes a lane where a slab of 32 channels is whole and Cout % 4 == 0,
//     else channel by channel.
//   - Taps of 16 * odd channels (kernel_cin(Cin) % 32 == 16: 48, 80, ...):
//     each lane walks its own 16 K bytes of a step, so the lanes of bytes
//     16-31 may point into the next tap (Tap16's walk, for any multiple of
//     16); the packed rows keep the one layout of every route, K index
//     tap * kernel_cin(Cin) + c. The halo pixel is padded by 32 bytes there,
//     so its stride stays an odd number of 16-byte units. Channels past the
//     input's (kernel_cin's padding) are zero codes; a stem of 2 channels
//     loads float2 pixels.
//   - Halo parts that cannot all stay beside two weight stages (1024 ->
//     1024 at 4 frames, 1024 -> 512 at a concat at 8, 2048 -> 1024): the
//     parts go through two buffers in (slice, part) order, made again for
//     every slice (p.remade), the producers making the next part while the
//     consumers multiply this one; that replaces the mma.sync kernel's
//     re-quantisation per slice on 64-pixel tiles with the same on 128-pixel
//     tiles, made beside the tensor cores. Parts that fit stay for every
//     slice as on the split route, in any number up to 8 (3 at 384 -> 384).
//   The flag keeps the other instances as they were: each new behaviour sits
//   behind it (kernels/bench.py sass --against DIR compares their SASS with
//   an earlier tree's).
// The shapes no instance fits or reads (Cin1 not a multiple of 4 but a stem
// of 2, halves of a concat that are not, a halo of kernel_cin(Cin) % 128 != 0
// channels too large for two buffers, one-frame planes at large Cin on the
// 512- and 256-pixel tiles) stay on the mma.sync kernel; the wrapper picks
// by shape (kernels/qconv_kernel.py:plan).
//
// What bounds the streaming instances now (the clocks build, NVIDIA H100
// 80GB HBM3 at 700 W, kernels/bench.py clocks --nets 256x256x8,512x512x4):
// the consumers. At 256 -> 256 on 8 frames a tile takes them ~42 k cycles
// of products (the wgmma work alone is 18.4 k; ~35 k in an earlier form of
// this file whose only differences here were constant-folded bookkeeping),
// ~8 k of epilogue and ~5 k waiting for a halo, while the producers load
// and quantise a halo in ~41 k; at 512 -> 512 on 4 frames 144 k of
// products (73.7 k of wgmma work) against ~101 k for the four parts. A
// consumer waits for a weight stage ~5 % of a tile. Tried on the same card and not kept: the weights multicast to
// clusters of 2 or 4 blocks (15-55 % slower: a stage is empty only when
// every block of the cluster is done with it, which couples the blocks'
// halo producers); the float32 halo by TMA through a staging ring in shared
// memory (its stages came out of the weight ring; 30-60 % slower, the
// quantisers waiting on each box); the next group's ldmatrix issued before
// wgmma_wait<1> on a second fragment set (2-5 % faster with the producer
// warp of its own, 8-16 % slower once every producer warp made halos).
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
// 512 threads (PW = 8) for Cout <= 128, where more producers are worth more
// (Cout = 32: 4 x 16 accumulators, A fragments of 2 K steps at a time).
constexpr int kConsumers = 256;
constexpr int kStageRow = 40;          // floats per staged output row: 32 channels + 8 of padding
constexpr int kStageBytes = 8 * 16 * kStageRow * 4;  // 16 rows for each consumer warp
constexpr int kMaxStages = 18;         // K chunks of Cin = 256
constexpr int kMaxParts = 8;           // halo parts of a split tile, each in a buffer of its own
// The barriers: a full barrier and a count for each weight stage, a full and
// an empty barrier for kMaxParts halo buffers, whatever an instance uses (a
// block sized to each instance's buffers measured the same on an NVIDIA H100
// 80GB HBM3 at 700 W, kernels/bench.py qconv --against).
constexpr int kBarBytes = (2 * kMaxStages + 2 * kMaxParts) * 8;
constexpr int kSmemLimit = 232448;     // bytes a block may have on sm_90
constexpr int kClockSlots = 7;         // sums of the clocks build (Params::clocks)

struct Params {
  const float* x;
  const float* x2;
  const float* epi;
  const float* res;
  float* out;
  const float* x_max;                 // (B,) max|x[b]|: the dynamic mode (Dyn), else null
  const float* x2_max;                // (B,) max|x2[b]| at a concat, or null
  float* out_max;                     // (B,) max|out[b]| to raise by atomicMax (Dyn), or null
  float act_scale;                    // the static activation scale (not Dyn)
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
  int Cr;                             // channels of [x, x2] (AnyWidth: Cin is kernel_cin of it)
  int remade;                         // AnyWidth: parts made again for every slice, in two buffers
#ifdef AZT_QCONV_CLOCKS
  // cycles of block 0 (kClockSlots sums): consumer waiting for a halo, in the
  // products (its waits for weights included), in the epilogue; producer waiting
  // for a buffer, loading and quantising; tiles; the consumer waiting for a
  // full weight stage
  long long* clocks;
#endif
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A lane's walk over taps of any multiple of 16 channels (AnyWidth): it reads
// its own 16 K bytes of each 32-byte step, which may lie in the next tap when
// a tap is 16 * odd channels: channel c of tap `tap` (column dx), whose
// offset in the halo is off. Past tap 8 (the packed rows' zero padding) it
// stays at tap 8.
struct TapWalk {
  int c, tap, dx, off;
  __device__ __forceinline__ void advance(int bytes, int Cs, int HW, int CinP) {
    for (c += bytes; c >= Cs; c -= Cs) {
      if (tap == 8) continue;
      ++tap;
      if (++dx == 3) {
        dx = 0;
        off += (HW - 2) * CinP;
      } else {
        off += CinP;
      }
    }
  }
};

// One producer thread's batch of U float4s of the halo.
template <int U>
struct HaloBatch {
  float4 v[U];
  int first;  // item (float4 of the halo) of v[0]; v[u] is item first + u * n_halo
};

template <int N, int MI, int PW, bool Split, bool Tap16, bool Dyn, bool AnyWidth>
__global__ void __launch_bounds__(kConsumers + 32 * PW, 1) qconv_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_w, const Params p) {
  constexpr int kThreads = kConsumers + 32 * PW;
  constexpr int U = 6;                      // float4 loads per batch; two batches in flight
  constexpr int kMTile = 128 * MI;          // pixels of a tile
  constexpr int kWStage = N * kSwizzleRow;  // bytes of one K chunk of the weights
  constexpr int G = N == 256 || MI == 4 ? 2 : 4;  // K steps per group of products
  constexpr bool Sliced = Split || AnyWidth;      // slices and parts from the launch
  const int TW = 1 << p.tw_log2, HW = TW + 2;
  const int FR = kMTile >> p.tw_log2;
  // What the split route varies; constants of the other instances.
  const int Cs = Sliced ? p.Cs : Tap16 ? 16 : p.Cin;  // channels of a halo part
  const int Cout = Sliced ? p.Cout : N;
  const int n_parts = Sliced ? p.n_parts : 1, n_slices = Sliced ? p.n_slices : 1;
  // A tile's halo units: its n_parts parts, each made once and kept for
  // every slice. Two buffers, taken in turn by the tiles, hold a halo of all
  // channels; parts take a buffer each (n_parts, a power of two but with
  // AnyWidth). AnyWidth with p.remade: the parts are made again for every
  // slice, n_slices * n_parts units a tile through two buffers.
  const bool remade = AnyWidth && p.remade;
  const int units = remade ? n_slices * n_parts : n_parts;
  const int nbuf = n_parts == 1 || remade ? 2 : n_parts;
  auto buf_of = [&](int unit) { return AnyWidth ? unit % nbuf : unit & (nbuf - 1); };
  // Pixel stride of the halo: an odd number of 16-byte units, so the eight
  // rows of an ldmatrix hit distinct banks (taps of 16 * odd channels pad 32).
  const int CinP = Cs + (AnyWidth && (Cs & 31) ? 32 : 16);
  const int halo_bytes = (FR + 2) * HW * CinP;
  // The epilogue rows' stride in shared memory: AnyWidth pads them with
  // zeros from Cout to its slices' n_slices * N channels.
  const int CoutE = AnyWidth ? n_slices * N : Cout;
  // A stem: Cin1 = 2 or 4 channels of x, zero-extended to Cin = 16.
  const bool stem = Tap16 && p.x2 == nullptr && p.Cin1 < p.Cin;
  // Weights that stay; the split route's and a sliced or parted AnyWidth's stream.
  const bool resident = AnyWidth ? n_slices * n_parts == 1 && p.stages == p.n_chunks
                                 : !Split && p.stages == p.n_chunks;
  const int n_halo = 32 * PW;  // the producer warps make the halos

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((kTileAlign - (smem_u32(smem_raw) & (kTileAlign - 1))) &
                                    (kTileAlign - 1));
  unsigned char* wbuf = smem;                              // stages x (N rows x 128 K bytes)
  unsigned char* halo0 = wbuf + p.stages * kWStage;        // nbuf int8 halos
  unsigned char* stage0 = halo0 + nbuf * halo_bytes;       // the consumers' output patches
  float* epi_s = reinterpret_cast<float*>(stage0 + kStageBytes);  // (5, CoutE)
  uint64_t* w_full = reinterpret_cast<uint64_t*>(epi_s + 5 * CoutE);
  int* w_done = reinterpret_cast<int*>(w_full + kMaxStages);  // consumer warps done with a stage
  uint64_t* h_full = w_full + 2 * kMaxStages;
  uint64_t* h_empty = h_full + kMaxParts;

  // The weights, by TMA. Weights that stay are requested once, by the
  // first producer thread. A ring is fed by its consumers: the last consumer
  // warp done with a stage (w_done counts them) asks for the chunk that
  // comes `stages` chunks later, at once, so no thread waits to feed it and
  // every producer warp makes halos.
  const int tile_begin = (int)((long)blockIdx.x * p.n_tiles / gridDim.x);
  const int tile_end = (int)((long)(blockIdx.x + 1) * p.n_tiles / gridDim.x);
  const int chunks_per_tile = n_slices * n_parts * p.n_chunks;
  const int n_wchunks = (tile_end - tile_begin) * chunks_per_tile;  // the ring's, of this block
  // Chunk (ns, part, c) of a tile into a stage.
  auto load_chunk = [&](int stage, int ns, int part, int c) {
    // K byte of the chunk: contiguous with one part, else tap-major in the part
    const int cpt = Cs / kSwizzleRow;
    const int k = n_parts == 1 ? c * kSwizzleRow
                               : (c / cpt) * p.Cin + part * Cs + (c % cpt) * kSwizzleRow;
    mbar_arrive_expect_tx(w_full + stage, kWStage);
    tma_load_2d(wbuf + stage * kWStage, &map_w, w_full + stage, k, ns * N);
  };
  // A chunk's place in its tile, (ns, part, c), and on to the next chunk.
  struct ChunkAt {
    int ns, part, c;
  };
  auto next_chunk = [&](ChunkAt& at) {
    if (++at.c == p.n_chunks) {
      at.c = 0;
      if (++at.part == n_parts) {
        at.part = 0;
        if (++at.ns == n_slices) at.ns = 0;
      }
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(w_full + s, 1);    // one arrive with the bytes; the TMA unit adds them
      w_done[s] = 0;
    }
    for (int b = 0; b < nbuf; ++b) {
      mbar_init(h_full + b, n_halo);
      mbar_init(h_empty + b, 8);
    }
    mbar_init_fence();
    if (!resident) {
      ChunkAt at = {0, 0, 0};
      for (int q = 0; q < p.stages && q < n_wchunks; ++q, next_chunk(at))
        load_chunk(q, at.ns, at.part, at.c);
    }
  }
  if constexpr (AnyWidth) {
    for (int i = threadIdx.x; i < 5 * CoutE; i += kThreads) {
      const int k = i / CoutE, n = i - k * CoutE;
      epi_s[i] = n < Cout ? p.epi[k * Cout + n] : 0.f;
    }
  } else {
    for (int i = threadIdx.x; i < 5 * Cout; i += kThreads) epi_s[i] = p.epi[i];
  }
  if (stem)  // channels Cin1 .. 15 of every halo pixel stay zero codes
    for (int i = threadIdx.x; i < 2 * halo_bytes / 16; i += kThreads)
      reinterpret_cast<uint4*>(halo0)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // A block takes a contiguous run of tiles, in the order (stream, frame
  // tile, row tile): the next tile is mostly the one below, whose first two
  // halo rows are this tile's last two.
  const int tiles_per_b = p.n_ftiles * p.n_ttiles;

  if (threadIdx.x >= kConsumers) {
    // ======================= producers =======================================
    reg_dealloc<(PW == 8 ? 96 : 104)>();
    const int ptid = threadIdx.x - kConsumers;
    {
      const int htid = ptid;
      if (resident && htid == 0) {
        for (int c = 0; c < p.n_chunks; ++c) {
          mbar_arrive_expect_tx(w_full + c, kWStage);
          tma_load_2d(wbuf + c * kWStage, &map_w, w_full + c, c * kSwizzleRow, 0);
        }
      }
      // ---- the quantised halo -------------------------------------------------
      // An item is a float4 of a pixel's channels, or a stem's whole pixel.
      const int cs4 = Cs >> 2, cin14 = p.Cin1 >> 2, cinp4 = CinP >> 2;
      const int ipp = stem ? 1 : cs4;           // items per halo pixel
      const int n_items = (FR + 2) * HW * ipp;
      float s = p.act_scale, rs = 1.f / s;
      int b_s = -1;  // Dyn: the element whose scale s is
      int it = 0;  // halo units made
      for (int tile = tile_begin; tile < tile_end; ++tile)
      for (int u = 0; u < units; ++u, ++it) {
        const int part = AnyWidth ? u % n_parts : u;  // unit u of a tile: (slice, part)
        const int b = tile / tiles_per_b, rem = tile - b * tiles_per_b;
        if (Dyn && b != b_s) s = scale_of_max(p.x_max, p.x2_max, b), rs = 1.f / s, b_s = b;
        const int ft = rem % p.n_ftiles;
        const int f0 = ft * FR - 1, t0 = (rem / p.n_ftiles) * TW - 1;
        const int c4_0 = part * cs4;  // first float4 of this part's channels
        const int buf = buf_of(it);
        uint32_t* halo32 = reinterpret_cast<uint32_t*>(halo0 + buf * halo_bytes);
#ifdef AZT_QCONV_CLOCKS
        const long long tp0 = clock64();
#endif
        mbar_wait(h_empty + buf, (((unsigned)it / nbuf) & 1) ^ 1);
        // Every halo thread is done with the previous unit (whose halo the
        // slower ones may still be copying from) before any writes into it.
        if (it > 0) mbar_wait(h_full + buf_of(it - 1), ((unsigned)(it - 1) / nbuf) & 1);
        // Below the block's previous tile, whose halo holds all channels:
        // halo rows 0 and 1 are that halo's rows FR and FR + 1.
        const bool below = units == 1 && it > 0 && ft > 0;
        if (below) {
          const uint4* src = reinterpret_cast<const uint4*>(halo0 + (buf ^ 1) * halo_bytes +
                                                            FR * HW * CinP);
          uint4* dst = reinterpret_cast<uint4*>(halo32);
          for (int j = htid; j < 2 * HW * (CinP >> 4); j += n_halo) dst[j] = src[j];
        }
        const int item0 = below ? 2 * HW * ipp : 0;
#ifdef AZT_QCONV_CLOCKS
        const long long tp1 = clock64();
#endif
        // Batch k + 1 is loaded before batch k is quantised, so loads stay in flight.
        auto load = [&](HaloBatch<U>& bt, int first) {
          bt.first = first;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = first + u * n_halo;
            const int pix = stem ? i : __umulhi(i, p.magic_c4);  // i / ipp
            const int c4 = c4_0 + i - pix * ipp;
            const int hr = __umulhi(pix, p.magic_hw);  // pix / HW
            const int f = f0 + hr, t = t0 + (pix - hr * HW);
            bt.v[u] = make_float4(0.f, 0.f, 0.f, 0.f);  // outside the plane: zeros
            if (i < n_items && f >= 0 && f < p.F && t >= 0 && t < p.T) {
              const long at = ((long)b * p.F + f) * p.T + t;
              if constexpr (AnyWidth) {
                // channels Cr .. Cin - 1 (kernel_cin's padding) stay zero codes
                const int ch = 4 * c4;
                if (ch < p.Cin1) {
                  if (p.Cin1 == 2) {  // a stem of 2 channels: float2 pixels
                    const float2 v2 = __ldg(reinterpret_cast<const float2*>(p.x + at * 2));
                    bt.v[u].x = v2.x, bt.v[u].y = v2.y;
                  } else {
                    bt.v[u] = __ldg(reinterpret_cast<const float4*>(p.x + at * p.Cin1 + ch));
                  }
                } else if (ch < p.Cr) {
                  bt.v[u] = __ldg(reinterpret_cast<const float4*>(
                      p.x2 + at * (p.Cr - p.Cin1) + (ch - p.Cin1)));
                }
              } else if (stem && p.Cin1 == 2) {  // the float4's last two channels stay zeros
                const float2 v2 = __ldg(reinterpret_cast<const float2*>(p.x + at * 2));
                bt.v[u].x = v2.x, bt.v[u].y = v2.y;
              } else {
                const float* src = c4 < cin14 ? p.x + at * p.Cin1 + 4 * c4
                                              : p.x2 + at * (p.Cin - p.Cin1) + 4 * (c4 - cin14);
                bt.v[u] = __ldg(reinterpret_cast<const float4*>(src));
              }
            }
          }
        };
        auto store = [&](const HaloBatch<U>& bt) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int i = bt.first + u * n_halo;
            const int pix = stem ? i : __umulhi(i, p.magic_c4);
            if (i < n_items)
              halo32[pix * cinp4 + (i - pix * ipp)] = quant4_magic(bt.v[u], s, rs);
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
    // A (pixels x K): matrices 0..3 = rows 0-7 / 8-15, K bytes 0-15 / 16-31
    // (of one tap; with Tap16 the lanes of bytes 16-31 are a tap ahead, below).
    uint32_t arow[MI];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      row0[mi] = (wg * MI + mi) * 64 + warp * 16;
      const int px = row0[mi] + (mat & 1) * 8 + mrow;
      arow[mi] = ((px >> p.tw_log2) * HW + (px & (TW - 1))) * CinP;
      if (!Tap16 && !AnyWidth) arow[mi] += (mat >> 1) * 16;
    }
    float* st = reinterpret_cast<float*>(stage0) + (threadIdx.x >> 5) * 16 * kStageRow;
    const int n_ksteps = (9 * Cs + kWgmmaK - 1) / kWgmmaK;  // of one part

    int acc[MI][N / 2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[mi][i] = 0;

    int ws = 0, wparity = 0;  // the weight ring, when it streams
    int wq = 0;               // chunks of the ring taken
    // The chunk that a release asks for next: `stages` chunks ahead (every
    // warp walks it, whichever turns out to be the eighth).
    ChunkAt ahead = {0, 0, 0};
    for (int q = 0; q < p.stages; ++q) next_chunk(ahead);
    int it = 0;               // halo units taken
    float sb = 0.f;           // Dyn: the s1 factor, the scale of element b_s
    int b_s = -1;
    for (int tile = tile_begin; tile < tile_end; ++tile) {
      const int b = tile / tiles_per_b, rem = tile - b * tiles_per_b;
      const int f0 = (rem % p.n_ftiles) * FR, t0 = (rem / p.n_ftiles) * TW;
      if (Dyn && b != b_s) sb = scale_of_max(p.x_max, p.x2_max, b), b_s = b;
      uint32_t out_bits = 0;  // Dyn: the largest |y| this thread stores in the tile, as bits
#ifdef AZT_QCONV_CLOCKS
      long long t_wait = 0, t_prod = 0, t_epi = 0, t_full = 0;
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
          // Each part's unit is made once a tile and serves every slice (with
          // remade: once for each slice).
          const int unit_no = remade ? it + ns * n_parts + part : it + part;
          const int buf = buf_of(unit_no);
          const uint32_t halo = smem_u32(halo0 + buf * halo_bytes);
#ifdef AZT_QCONV_CLOCKS
          const long long tc0 = clock64();
#endif
          if (remade || ns == 0) mbar_wait(h_full + buf, ((unsigned)unit_no / nbuf) & 1);
#ifdef AZT_QCONV_CLOCKS
          const long long tc1 = clock64();
          t_wait += tc1 - tc0;
#endif

          // ---- products -----------------------------------------------------------
          int c0 = 0, dx = 0, tap_off = 0;  // channel offset, and the tap's offset in the halo
          // AnyWidth: this lane's walk over taps of any multiple of 16 channels.
          TapWalk walk{};
          if constexpr (AnyWidth) walk.advance((mat >> 1) * 16, Cs, HW, CinP);
          // This warp is done with chunk q in `stage`: the eighth to say so
          // asks for chunk q + stages into it.
          auto release = [&](int stage, int q) {
            __syncwarp();
            if (lane == 0) {
              __threadfence_block();
              if (atomicAdd(w_done + stage, 1) % 8 == 7 && q + p.stages < n_wchunks)
                load_chunk(stage, ahead.ns, ahead.part, ahead.c);
            }
            next_chunk(ahead);
          };
          for (int c = 0; c < p.n_chunks; ++c) {
            const int s = resident ? c : ws;
#ifdef AZT_QCONV_CLOCKS
            const long long tf0 = clock64();
#endif
            mbar_wait(w_full + s, resident ? 0 : wparity);
#ifdef AZT_QCONV_CLOCKS
            t_full += clock64() - tf0;
#endif
            const int q = wq;
            if (!resident) {
              ++wq;
              if (++ws == p.stages) { ws = 0; wparity ^= 1; }
            }
            const uint64_t db = wgmma_desc(smem_u32(wbuf + s * kWStage));
            const int steps = min(4, n_ksteps - 4 * c);
            for (int j0 = 0; j0 < steps; j0 += G) {
              uint32_t a[MI][G][4];
#pragma unroll
              for (int j = 0; j < G; ++j) {
                if (j0 + j < steps) {
                  if constexpr (AnyWidth) {
#pragma unroll
                    for (int mi = 0; mi < MI; ++mi)
                      ldmatrix_x4(a[mi][j], halo + arow[mi] + walk.off + walk.c);
                    walk.advance(kWgmmaK, Cs, HW, CinP);
                  } else {
                    if (Tap16) {
                      // step 4c + j0 + j holds taps 2k and 2k + 1, this lane's the
                      // second if it loads K bytes 16-31; past tap 8 (the weights'
                      // zero padding) it reads tap 8's pad bytes
                      const int t = 2 * (4 * c + j0 + j) + (mat >> 1);
                      tap_off = t > 8 ? (2 * HW + 2) * CinP + 16 : ((t / 3) * HW + t % 3) * CinP;
                    }
#pragma unroll
                    for (int mi = 0; mi < MI; ++mi)
                      ldmatrix_x4(a[mi][j], halo + arow[mi] + tap_off + c0);
                    if (!Tap16) {
                      c0 += kWgmmaK;
                      if (c0 == Cs) {  // on to the next tap: (dy, dx + 1), or (dy + 1, 0)
                        c0 = 0;
                        tap_off += CinP;
                        if (++dx == 3) { dx = 0; tap_off += (HW - 3) * CinP; }
                      }
                    }
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
            if (!resident) release(s, q);  // this warp is done with the stage
          }
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) acc_fence(acc[mi]);
          if constexpr (AnyWidth) {
            if (remade || ns == n_slices - 1) {  // its last use
              __syncwarp();
              if (lane == 0) mbar_arrive(h_empty + buf);
            }
            if (ns == n_slices - 1 && part == n_parts - 1) it += units;
          } else if (ns == n_slices - 1) {  // its last use
            __syncwarp();
            if (lane == 0) mbar_arrive(h_empty + buf);  // the producers may refill this halo
            if (part == n_parts - 1) it += n_parts;     // the tile's units are taken
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
          // This lane's first channel of a slab, and (AnyWidth) whether the
          // slab's 32 channels are all below Cout, as 16-byte vectors.
          const int lane_ch = nb + 4 * (lane & 7);
          auto whole = [&](int slab) {
            return !AnyWidth || (nb + slab * 32 + 32 <= Cout && (Cout & 3) == 0);
          };
          // The residual comes from L2 (asked for when the tile began) into
          // L1 a slab ahead, while the slab before it is dequantised.
          auto residual_to_l1 = [&](int slab) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (obase[q] >= 0 && (!AnyWidth || lane_ch + slab * 32 < Cout))
                asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p.res + obase[q] + slab * 32));
          };
          if (p.res) residual_to_l1(0);
#pragma unroll
          for (int slab = 0; slab < N / 32; ++slab) {
            if constexpr (AnyWidth) {
              if (nb + slab * 32 >= Cout) break;  // the slice's channels past Cout
            }
            if (p.res && slab + 1 < N / 32) residual_to_l1(slab + 1);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int j = slab * 4 + jj, n = 8 * j + 2 * tg;
              float2 e[5];  // s1, b1, mean, mul, beta at channels nb + n, nb + n + 1
#pragma unroll
              for (int k = 0; k < 5; ++k)
                e[k] = *reinterpret_cast<const float2*>(epi_s + k * CoutE + nb + n);
              if constexpr (Dyn) e[0] = dynamic_s1(sb, e[0]);
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
              if (p.res && obase[q] >= 0) {
                if (whole(slab)) {
                  r[q] = __ldg(reinterpret_cast<const float4*>(p.res + obase[q] + slab * 32));
                } else if constexpr (AnyWidth) {  // channel by channel, those below Cout
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    if (lane_ch + slab * 32 + e < Cout)
                      (&r[q].x)[e] = __ldg(p.res + obase[q] + slab * 32 + e);
                }
              }
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
                if (whole(slab)) {
                  *reinterpret_cast<float4*>(p.out + obase[q] + slab * 32) = y;
                  if constexpr (Dyn) out_bits = max(out_bits, abs_bits4(y));
                } else if constexpr (AnyWidth) {
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    if (lane_ch + slab * 32 + e < Cout) {
                      p.out[obase[q] + slab * 32 + e] = (&y.x)[e];
                      if constexpr (Dyn) out_bits = max(out_bits, abs_bits((&y.x)[e]));
                    }
                  }
                }
              }
            }
            __syncwarp();  // the patch is free for the next slab
          }
        }
#ifdef AZT_QCONV_CLOCKS
        t_epi += clock64() - tc2;
#endif
      }
      if constexpr (Dyn) {
        if (p.out_max) warp_max_out(out_bits, p.out_max, b);
      }
#ifdef AZT_QCONV_CLOCKS
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        p.clocks[0] += t_wait;
        p.clocks[1] += t_prod;
        p.clocks[2] += t_epi;
        p.clocks[5] += 1;
        p.clocks[6] += t_full;
      }
#endif
    }
  }
}

#ifdef AZT_QCONV_CLOCKS
long long* clocks_buffer() {
  static long long* buf = nullptr;
  if (!buf) cudaMalloc(&buf, kClockSlots * sizeof(long long));
  return buf;
}
#endif

template <int N, int MI, int PW, bool Split, bool Tap16, bool Dyn, bool AnyWidth>
int launch_mode(const Params& p, const void* w, int smem, int tile_w, cudaStream_t stream) {
  const int fr = (128 * MI) / tile_w;
  const int nbuf = p.n_parts == 1 || p.remade ? 2 : p.n_parts;  // halo buffers
  const int cinp = p.Cs + (AnyWidth && p.Cs % 32 ? 32 : 16);    // a halo pixel's bytes
  // the epilogue rows: n_slices * N = Cout but where AnyWidth pads them
  const int need = kTileAlign + p.stages * N * kSwizzleRow + nbuf * (fr + 2) * (tile_w + 2) * cinp +
                   kStageBytes + 5 * p.n_slices * N * 4 + kBarBytes;
  if (need != smem || smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  static int raised = 0;
  if (smem > raised) {  // dynamic shared memory above 48 KB must be opted into
    const cudaError_t e = cudaFuncSetAttribute(
        qconv_wgmma_kernel<N, MI, PW, Split, Tap16, Dyn, AnyWidth>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    raised = smem;
  }
  CUtensorMap map_w;  // encoded once per layer: the table is keyed by the weights' address
  const uint64_t kpad = (9 * (uint64_t)p.Cin + 31) / 32 * 32;  // packed row: 160 bytes at Cin = 16
  const int rc = cached_tensor_map_s8(&map_w, w, p.Cout, kpad, N);
  if (rc != 0) return rc;
  const int grid = p.n_tiles < sm_count() ? p.n_tiles : sm_count();
  qconv_wgmma_kernel<N, MI, PW, Split, Tap16, Dyn, AnyWidth>
      <<<grid, kConsumers + 32 * PW, smem, stream>>>(map_w, p);
  return (int)cudaGetLastError();
}

// The instance of a shape in the launch's mode: dynamic when it reads maxima.
template <int N, int MI, int PW, bool Split, bool Tap16 = false, bool AnyWidth = false>
int launch(const Params& p, const void* w, int smem, int tile_w, cudaStream_t stream) {
  return p.x_max
             ? launch_mode<N, MI, PW, Split, Tap16, true, AnyWidth>(p, w, smem, tile_w, stream)
             : launch_mode<N, MI, PW, Split, Tap16, false, AnyWidth>(p, w, smem, tile_w, stream);
}

// The parameters both entry points share; Cs == Cin and one slice unless split.
Params make_params(const void* x, const void* x2, const void* epi, const void* res, void* out,
                   const void* x_max, const void* x2_max, void* out_max, float act_scale,
                   int relu, int B, int F, int T, int Cin, int Cin1, int Cout, int m_tile,
                   int tw_log2, int Cs, int n_slices, int stages) {
  const int tile_w = 1 << tw_log2;
  Params p;
  p.x = (const float*)x, p.x2 = (const float*)x2, p.epi = (const float*)epi;
  p.res = (const float*)res, p.out = (float*)out;
  p.x_max = (const float*)x_max, p.x2_max = (const float*)x2_max, p.out_max = (float*)out_max;
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
  p.Cr = Cin, p.remade = 0;
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

// Maxima only in the dynamic mode, and there x2's exactly with x2.
bool maxima_ok(const void* x2, const void* x_max, const void* x2_max, const void* out_max) {
  return x_max ? (x2_max != nullptr) == (x2 != nullptr) : x2_max == nullptr && out_max == nullptr;
}

}  // namespace

// x (B, F, T, Cin1) f32 and x2 (B, F, T, Cin - Cin1) f32 or null: the input
// is their channel concat, or without x2 x's channels then zeros up to Cin (a
// stem: Cin1 of 2 or 4, Cin = 16). w (Cout, Kpad) int8, K index
// (3*dy+dx)*Cin + c, Kpad = 9 * Cin rounded up to 32 (zeros beyond 9 * Cin);
// epi (5, Cout) f32 rows s1, b1, mean, mul, beta; res (B, F, T, Cout) f32 or
// null; out (B, F, T, Cout) f32. x_max (B,) device float32, max|x[b]|, or
// null: the dynamic mode, whose scale is max(x_max[b], x2_max[b]) / 127 +
// 1e-30 in place of act_scale (epi's row 0 then the weight scales); x2_max
// max|x2[b]| with x2 (the dynamic mode), else null; out_max (B,) device
// float32 or null, which a dynamic launch raises to max|out[b]| (start it at
// zeros).
// Needs Cin % 32 == 0 with Cout in {32, 64, 128, 256}, or Cin = 16 with Cout
// in {32, 64}; Cin1 % 4 == 0 but for a stem. tile_w (frames of a tile, a
// power of two up to 64), stages (of the weight ring; the number of 128-byte
// K chunks means the weights stay in shared memory) and smem (bytes of shared memory) come from the wrapper's
// plan; smem is checked against this file's own sum. A tile is 512 pixels
// at Cout = 32, 256 at 64, else 128. Returns 0, a cudaError_t, or 1000 + the
// CUresult of building the tensor map.
extern "C" int azt_qconv3x3(const void* x, const void* x2, const void* w, const void* epi,
                            const void* res, void* out, const void* x_max, const void* x2_max,
                            void* out_max, float act_scale, int relu, int B, int F, int T,
                            int Cin, int Cin1, int Cout, int tile_w, int stages, int smem,
                            void* stream) {
  const int m_tile = Cout == 32 ? 512 : Cout == 64 ? 256 : 128;
  const int tw_log2 = log2_of(tile_w);
  const int n_chunks = (9 * Cin + kSwizzleRow - 1) / kSwizzleRow;
  const bool stem = x2 == nullptr && Cin1 < Cin;
  const bool cin_ok = Cin % 32 == 0 || (Cin == 16 && Cout <= 64);
  const bool cin1_ok = stem ? Cin == 16 && (Cin1 == 2 || Cin1 == 4)
                            : Cin1 > 0 && Cin1 <= Cin && Cin1 % 4 == 0;
  if (!cin_ok || !cin1_ok || (Cout != 32 && Cout != 64 && Cout != 128 && Cout != 256) ||
      tw_log2 < 0 || tile_w > 64 || stages < 1 || stages > n_chunks || stages > kMaxStages ||
      !maxima_ok(x2, x_max, x2_max, out_max))
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(x, x2, epi, res, out, x_max, x2_max, out_max, act_scale, relu, B,
                               F, T, Cin, Cin1, Cout, m_tile, tw_log2, Cin, 1, stages);
  cudaStream_t st = (cudaStream_t)stream;
#ifdef AZT_QCONV_CLOCKS
  cudaMemsetAsync(p.clocks, 0, kClockSlots * sizeof(long long), st);
#endif
  if (Cin == 16)  // 16-channel taps
    return Cout == 32 ? launch<32, 4, 8, false, true>(p, w, smem, tile_w, st)
                      : launch<64, 2, 8, false, true>(p, w, smem, tile_w, st);
  if (Cout == 32) return launch<32, 4, 8, false>(p, w, smem, tile_w, st);
  if (Cout == 64) return launch<64, 2, 8, false>(p, w, smem, tile_w, st);
  if (Cout == 128) return launch<128, 1, 8, false>(p, w, smem, tile_w, st);
  return launch<256, 1, 4, false>(p, w, smem, tile_w, st);
}

// The split route: the same operands with Cout of 256 or 512, walked in
// Cout / 256 slices of 256 output channels and Cin / part_channels halo parts
// (part_channels == Cin, or a multiple of 128 that divides it into 2, 4 or 8
// parts, each made once a tile in a buffer of its own). Tiles of 128 pixels;
// stages of the weight ring, which always streams; the other arguments and
// the return value as azt_qconv3x3.
extern "C" int azt_qconv3x3_split(const void* x, const void* x2, const void* w, const void* epi,
                                  const void* res, void* out, const void* x_max,
                                  const void* x2_max, void* out_max, float act_scale, int relu,
                                  int B, int F, int T, int Cin, int Cin1, int Cout, int tile_w,
                                  int part_channels, int stages, int smem, void* stream) {
  const int Cs = part_channels;
  const int tw_log2 = log2_of(tile_w);
  if (Cin % 32 || Cin1 % 4 || (Cout != 256 && Cout != 512) || tw_log2 < 0 || tile_w > 64 ||
      Cs < 32 || Cs % 32 || Cin % Cs || (Cs != Cin && Cs % kSwizzleRow) ||
      Cin / Cs > kMaxParts || (Cin / Cs & (Cin / Cs - 1)) || stages < 1 || stages > kMaxStages ||
      !maxima_ok(x2, x_max, x2_max, out_max))
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(x, x2, epi, res, out, x_max, x2_max, out_max, act_scale, relu, B,
                               F, T, Cin, Cin1, Cout, 128, tw_log2, Cs, Cout / 256, stages);
  cudaStream_t st = (cudaStream_t)stream;
#ifdef AZT_QCONV_CLOCKS
  cudaMemsetAsync(p.clocks, 0, kClockSlots * sizeof(long long), st);
#endif
  return launch<256, 1, 4, true>(p, w, smem, tile_w, st);
}

// Any width (kernels/qconv_kernel.py's plans with "wide"): the same operands
// at any Cin and Cout. Cin is computed as Ck = ceil(Cin / 16) * 16 channels
// (w's K index (3*dy+dx)*Ck + c, Kpad = 9 * Ck rounded up to 32), those past
// Cin zero codes, with taps of any multiple of 16 channels; x alone with Cin1
// = Cin a multiple of 4 or 2 (a stem), or a concat of halves that are
// multiples of 4. Cout on the least N of 32, 64, 128 and 256 that holds it,
// else in ceil(Cout / 256) slices of 256, the columns at or beyond Cout
// masked. The halo in Ck / part_channels parts (all Ck channels, or a
// multiple of 128 that divides Ck): each made once a tile in a buffer of its
// own (remade 0; at most 8 parts), or again for every slice through two
// buffers (remade 1). A tile is 512 pixels at N = 32, 256 at 64, else 128.
// tile_w, stages and smem come from the plan as for azt_qconv3x3 (one part and
// one slice with stages == the part's K chunks: the weights stay); the other
// arguments and the return value as azt_qconv3x3.
extern "C" int azt_qconv3x3_any(const void* x, const void* x2, const void* w, const void* epi,
                                const void* res, void* out, const void* x_max,
                                const void* x2_max, void* out_max, float act_scale, int relu,
                                int B, int F, int T, int Cin, int Cin1, int Cout, int tile_w,
                                int part_channels, int remade, int stages, int smem,
                                void* stream) {
  const int Ck = (Cin + 15) / 16 * 16, Cs = part_channels;
  const int N = Cout <= 32 ? 32 : Cout <= 64 ? 64 : Cout <= 128 ? 128 : 256;
  const int n_slices = (Cout + N - 1) / N, n_parts = Cs > 0 ? Ck / Cs : 0;
  const int tw_log2 = log2_of(tile_w);
  const bool halves_ok = x2 ? Cin1 > 0 && Cin1 < Cin && Cin1 % 4 == 0 && (Cin - Cin1) % 4 == 0
                            : Cin1 == Cin && (Cin % 4 == 0 || Cin == 2);
  if (B < 1 || F < 1 || T < 1 || Cout < 1 || !halves_ok || tw_log2 < 0 || tile_w > 64 ||
      Cs < 16 || Cs % 16 || Ck % Cs || (n_parts > 1 && Cs % kSwizzleRow) ||
      (!remade && n_parts > kMaxParts) || stages < 1 || stages > kMaxStages ||
      !maxima_ok(x2, x_max, x2_max, out_max))
    return (int)cudaErrorInvalidValue;
  Params p = make_params(x, x2, epi, res, out, x_max, x2_max, out_max, act_scale, relu, B, F, T,
                         Ck, Cin1, Cout, N == 32 ? 512 : N == 64 ? 256 : 128, tw_log2, Cs,
                         n_slices, stages);
  p.Cr = Cin, p.remade = remade != 0;
  if (n_slices * n_parts == 1 && stages > p.n_chunks) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#ifdef AZT_QCONV_CLOCKS
  cudaMemsetAsync(p.clocks, 0, kClockSlots * sizeof(long long), st);
#endif
  if (N == 32) return launch<32, 4, 8, false, false, true>(p, w, smem, tile_w, st);
  if (N == 64) return launch<64, 2, 8, false, false, true>(p, w, smem, tile_w, st);
  if (N == 128) return launch<128, 1, 8, false, false, true>(p, w, smem, tile_w, st);
  return launch<256, 1, 4, false, false, true>(p, w, smem, tile_w, st);
}

#ifdef AZT_QCONV_CLOCKS
// The kClockSlots sums of the last launch (see Params::clocks), after it has ended.
extern "C" int azt_qconv3x3_clocks(long long* out) {
  const cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpy(out, clocks_buffer(), kClockSlots * sizeof(long long),
                         cudaMemcpyDeviceToHost);
}
#endif
