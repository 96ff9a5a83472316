// K1's conv stage on Hopper's own machinery (sm_90a), in both storage
// dtypes: TMA loads into a ring of shared-memory stages, mbarriers, one
// producer warp, and consumer warpgroups that multiply with wgmma.
//
// Replaces the products of the Pallas TPU kernel
// timbre_trap_tpu/ops/fused_level.py `_level_kernel` (launched by
// `_pallas_fwd_call`); ops/fused_level.py `banded_conv` sends every CUDA
// stage here, bfloat16 and float32 alike.
//
//   tt_band_conv_wgmma  y[64g + r, t] = epi(sum_dt sum_k W_g,dt[r, k] *
//                       x[s_g + k, t + dt]), bf16 operands, float32
//                       accumulators; epilogue: float32 bias, ELU as
//                       exp(min(v, 0)) - 1 (exp by the hardware's ex2),
//                       residual add, bf16 store.
//   tt_band_conv_wgmma_f32  the same function in float32 storage, products
//                       float32-accurate as 3xTF32 (lo*hi + hi*lo + hi*hi
//                       of operands split into a TF32 hi, rounded to
//                       nearest with ties away, and the float32 remainder
//                       lo); epilogue: float32 bias, ELU with IEEE expf,
//                       residual add, float32 store.
//
// Both walk a conv's band pattern of P 128-row blocks (ops/packed_conv.py
// `ConvBlocks.period`): sub-tile g takes weight sub-tile g % n_w (n_w = 2P)
// and its bias, and reads x from row (g / n_w) * col_adv - margin + its
// band's start. P is 1 for every stage whose output frequencies fit a
// block and repeat block by block; 2 at model complexity 4, where a
// frequency's 256 channels span two blocks or a stride-2 transposed conv
// to 128 channels repeats every two; a dense map is one pattern of all
// its blocks, col_adv 0.
//
// The float32 stage's design. TF32 wgmma reads a shared-memory operand
// K-major only (the transpose bits are for 16-bit types), and x has its
// frames contiguous, so the kernel computes the transposed tile, y^T (frames
// x rows) = x^T W^T, with m64n64k8 wgmmas: A = x^T from registers, each
// thread loading its fragment from the staged x box with 32-bit shared loads
// at the tap's frame offset (a shift dt is an address offset, with no
// alignment rule) and splitting it into hi and lo; B = the band weights,
// whose rows already lie K-major, split into their hi and lo planes once per
// conv by the wrapper (ops/packed_conv.py `ConvBlocks.band_tf32_operands`)
// and loaded by TMA in 64-byte-swizzled boxes of 64 rows x 16 columns (16
// float32 columns are one 64-byte swizzle atom and one fresh sum; 128-byte
// boxes of 32 would double a stage, and the SM would hold one CTA, which
// measured slower). x comes by a 3-D tensor map (T_pad, r_in, B), unswizzled
// boxes of 152 frames from t0 - 8 x 16 band rows: the hardware zero-fills
// the margin, the rows past r_in and the frames outside [0, T_pad), and rows
// of 152 floats put a fragment load's 32 lanes in 32 banks. One stage (x box
// plus every tap's two weight boxes) serves every tap of its 16 band rows; a
// ring of 2 stages with full and empty mbarriers, one producer thread
// running ahead into the next tile, two consumer warpgroups (frames 0-63 and
// 64-127 of a 128-frame x 64-row tile), an epilogue warp, persistent CTAs,
// two an SM (the ring and a 32-KB epilogue buffer are all the shared memory
// a CTA takes; 96 registers a thread). The tensor cores round their float32
// sums toward zero, so each (chunk, tap) product, 16 band rows (6 wgmmas),
// goes into fresh accumulators (scale-d 0 on its first) and reaches the
// running sum by an IEEE add, chunk by chunk and tap by tap, with no
// atomics, so a run is deterministic.
//
// The float32 epilogue (bias, the ELU's IEEE expf, the residual, the store)
// took half of a chain's time when the consumers read the residual from
// global memory and stored from the registers: both warpgroups of a CTA,
// and its twin on the SM, sat in it at once while the tensor cores idled.
// So where T % 4 == 0 (TMA's 16-byte global strides) it runs by TMA. One
// thread of the epilogue warp loads the tile's residual, 4 boxes of 64 rows
// x 32 frames (128-byte swizzled, so a warp's 8 frames x 4 rows meet 32
// banks), into the epilogue buffer while the tile's products run; each
// consumer adds the bias, applies the ELU and adds the residual from the
// buffer, in the order of the register epilogue, writes the result back in
// place and goes straight on to the next tile's products; the same thread
// then stores the tile by TMA (the hardware clips the rows past r_out and
// the frames past T) and, box by box as the store has read it, loads the
// next tile's residual. The producer's loads never wait on the epilogue's
// copies (the producer itself issuing them measured slower). Every main-path
// T (chunks of 1024 frames, 9-s crops of 3072) takes it; elsewhere the
// epilogue runs from the registers: in the transposed tile the lanes of a
// warp hold 8 consecutive frames of each of 4 rows, so each warp store moves
// whole 32-byte sectors. What bounds the
// stage: three TF32 products at half the bf16 rate put its products above
// the card's bytes-per-flop line, but the mainloop waits for each (chunk,
// tap) product before the IEEE add, so it is bound by that latency, and the
// epilogue's arithmetic (the ELU above all) still runs while the tensor
// cores wait. Staging the sums in shared memory for 16-byte stores from the
// consumers' threads, one epilogue warp doing the arithmetic and global
// loads, one CTA an SM with a deeper ring, or an L2 prefetch of the residual
// were slower (tools/k1_f32_ablation.py). The wrapper pads x with zero
// frames to a multiple of 4 where T % 4 != 0.
//
// The bf16 stage's design. An output tile is one 64-row sub-tile g (its
// band: start s_g, L columns, ops/packed_conv.py `_sub_tile_bands`) x 128
// frames t0.. of one item; CTAs are persistent, two an SM, each walking
// tiles g-fastest. x comes by a 3-D TMA tensor map, dims (T, r_in, B): the
// hardware zero-fills rows above 0 (the margin) or past r_in and frames
// outside [0, T), so every box lands whole (a 2-D map over B * r_in rows
// would read the next item's rows at the margin instead of zeros). Its boxes
// are 64 band rows x 64 frames, 128-byte swizzled: a wgmma B operand with
// frames contiguous (MN-major, the transpose bit set). TMA takes a box's
// innermost (frame) coordinate only in whole 16 bytes, 8 bf16 frames (an odd
// one faults), so a tap dt = 8q + r (0 <= r < 8) reads its boxes at frame t0
// + 8q, 136 frames (two 64-frame boxes and an unswizzled 8-frame one): its
// products go into their own float32 accumulators, whose column n is output
// frame t0 + n - r, and once the tap's chunks are summed they are added into
// the tile's, shifted by r frames across the lanes of a quad (warp shuffles;
// none for r = 0). The band weights W_g,dt (64 x width, K contiguous) come
// by a second map, 64 columns a box, 128-byte swizzled: the K-major A
// operand. One pipeline stage is one (tap, chunk of 64 band rows): 25 KB; a
// ring of kStages stages with full and empty mbarriers, fed by one producer
// thread that runs ahead into the next tile, drained by the consumer
// warpgroup with m64n64k16 wgmmas (and an m64n8k16 for the 8 extra frames
// where r > 0). The sums run in a fixed order, tap, then chunk, then k16
// step, from zero, with no atomics: a run is deterministic.
//
// The bf16 epilogue (bias, the ELU's exp, the residual, the rounding and
// the store) took 43 % of a chain's time when the consumers staged the
// sums in shared memory and then read the residual and stored y from their
// threads, while the tensor cores idled (tools/k1_bf16_ablation.py). So
// where T % 8 == 0 (TMA's 16-byte global strides) the kernel runs it by
// TMA, band_wgmma_kernel<true>, with an epilogue warp and two tile buffers
// (64 rows x 128 frames bf16, two 128-byte swizzled boxes of 64 frames,
// 16 KB each) in place of the 33-KB staging tile: one thread of that warp
// loads tile k's residual boxes into buffer k % 2 while tile k - 1's
// products run; the consumers, after tile k's last tap, add the bias,
// apply the ELU and add the residual from the buffer, in store_tile's
// operations and order (the same bits), write the bf16 pairs back in place
// and go straight on to tile k + 1's products; the same thread then stores
// the tile by TMA (the hardware clips the rows past r_out and the frames
// past T). Every main-path T (chunks of 1024 frames, 9-s crops of 3072)
// takes it. Elsewhere band_wgmma_kernel<false> stages the tile's float32
// sums in shared memory, and each thread then reads the residual and
// writes y 8 frames of a row at a time (16 bytes where T % 8 == 0 and res
// and y are 16-byte aligned).
//
// TMA wants 16-byte global strides: x's rows are T bf16 long, so the wrapper
// hands a copy padded with zero frames to a multiple of 8 where T % 8 != 0
// (zeros are what the edge fill gives); the residual and y keep T. A tensor
// map depends on its base and dims only, so the encoded maps are kept in a
// small cache.
//
// What bounds it: with the zeros skipped a stage needs 2 * n_dt * 64 * L
// flops per sub-tile and frame against ~2 bytes per row and frame in and
// out, near the card's bytes-per-flop line, so a forward chain is bound by
// its bytes. The per-tap boxes read x n_dt times, from L2 after the first,
// and the weights once per tile. On the card neither bandwidth sets the pace
// yet: leaving the weight boxes out or changing the ring's depth left the
// mainloop's time unchanged, while halving the number of stages (64-row
// chunks) shortened it, so a stage's fixed latency does (the mainloop alone
// is two thirds of a chain with the TMA epilogue); the residual's load and
// the store now run under the products, and what is left of the epilogue,
// the ELU's exp above all, still runs while the tensor cores wait. TMA
// moves every operand without registers or address arithmetic in the
// consumer.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kSub = 64;                         // rows of a sub-tile (wgmma M)
constexpr int kTileT = 128;                      // output frames per CTA
constexpr int kBoxT = 64;                        // frames per swizzled x box: 128 bytes
constexpr int kEdgeT = 8;                        // frames of the unswizzled edge box
constexpr int kKc = 64;                          // band rows per stage
constexpr int kSteps = kKc / 16;                 // k16 steps per stage
constexpr int kStages = 3;
constexpr int kInFlight = 1;                     // wgmma groups in flight per consumer
constexpr int kXBox = kBoxT * kKc * 2;           // 8192 bytes
constexpr int kWBox = kSub * kKc * 2;            // 8192 bytes
constexpr int kEdgeBox = kEdgeT * kKc * 2;       // 1024 bytes
constexpr int kWOff = 2 * kXBox;                 // stage layout: x, x, W, edge
constexpr int kEdgeOff = kWOff + kWBox;
constexpr int kStageBytes = kEdgeOff + kEdgeBox; // 25600 bytes, 1024-aligned stages
constexpr int kConsumers = 128;                  // one warpgroup
constexpr int kOutPitch = kTileT + 4;            // float32 output staging rows
constexpr int kOutBytes = kSub * kOutPitch * 4;  // 33792 bytes
constexpr int kEpiBox = kSub * kBoxT * 2;        // an epilogue box: 8192 bytes
constexpr int kEpiTile = 2 * kEpiBox;            // a tile's epilogue buffer
// Threads and shared memory of each epilogue: the staged one, the consumers
// and a producer warp, the ring and the float32 staging tile; the TMA one
// (kTma), an epilogue warp and two tile buffers more, no staging tile.
template <bool kTma>
constexpr int kThreads = kConsumers + (kTma ? 64 : 32);
template <bool kTma>
constexpr int kSmem = kStages * kStageBytes + (kTma ? 2 * kEpiTile : kOutBytes) +
                      1024;   // + alignment slack
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed;
// the warp leaves converged, as the wgmma that follow require.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
  __syncwarp();
}

// One TMA box of a 3-D tensor map into shared memory, completing on `bar`.
// The innermost coordinate must be a whole 16 bytes.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One TMA store of a shared-memory box into a 3-D tensor map (the hardware
// clips what lies outside the tensor), in this thread's bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk groups have not yet read
// their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until this thread's bulk stores have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), layout (0: none, 1: 128-byte
// swizzle). Each operand here spans one swizzle atom (or one core matrix)
// along its contiguous dimension, so only the offset between its 8-row
// groups matters (of M for the K-major A, of K for the MN-major B); it is
// given as both offsets.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t group_bytes,
                                              uint32_t layout) {
  const uint64_t off = (group_bytes >> 4) & 0x3FFF;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (off << 16) | (off << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, K-major, descriptor a) * B (16 x 64, MN-major, b).
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d += A (64 x 16, K-major, a) * B (16 x 8, MN-major, b).
__device__ __forceinline__ void wgmma_64x8x16(float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ int tap_of(const int (&v)[3], int tap) {
  return tap == 0 ? v[0] : (tap == 1 ? v[1] : v[2]);   // no runtime index into the arguments
}

struct WgmmaArgs {
  const float* bias;   // (n_w * 64,): the band pattern's
  const bf16* res;     // (B, r_out, T) or null
  bf16* out;           // (B, r_out, T)
  int r_out, t_len, n_dt, n_sub, n_tiles_t, n_tiles;
  int off[3], shift[3];   // per tap: box frame offset (a multiple of 8), shift
  int col_adv, margin, n_w, act, vec;
  int kb0, kl0, nc0, kb1, kl1, nc1;
};

// One output tile: sub-tile g (the fastest index) x kTileT frames t0.. of
// item b, its band, its weight sub-tile g % n_w (the band pattern spans n_w
// sub-tiles, 2 a 128-row block of the period) and the input row of its
// band column 0.
struct Tile {
  int t0, g, b, kl, nc, wsub, row0;
  __device__ __forceinline__ Tile(const WgmmaArgs& a, int tile) {
    g = tile % a.n_sub;
    const int rest = tile / a.n_sub;
    t0 = (rest % a.n_tiles_t) * kTileT;
    b = rest / a.n_tiles_t;
    const int s = g & 1;
    kl = s ? a.kl1 : a.kl0;
    nc = s ? a.nc1 : a.nc0;
    // A pattern of one block (every stage but a period-P conv's and a
    // dense map's of several blocks) takes a shift and a mask: a division
    // here, in the consumers' path between tiles, cost the chain 2 %.
    int q;
    if (a.n_w == 2) {
      wsub = s;
      q = g >> 1;
    } else {
      wsub = g % a.n_w;
      q = g / a.n_w;
    }
    row0 = q * a.col_adv - a.margin + (s ? a.kb1 : a.kb0);
  }
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Accumulator column n of group G (8 columns a group, 17 groups: two
// m64n64 tiles and the m64n8 edge) for row half i, element e.
__device__ __forceinline__ float acc_at(const float (&a0)[32], const float (&a1)[32],
                                        const float (&a2)[4], int G, int i, int e) {
  return G < 8 ? a0[4 * G + 2 * i + e] : (G < 16 ? a1[4 * (G - 8) + 2 * i + e] : a2[2 * i + e]);
}

// out[o] += acc[o + r] for the 128 output columns o of this thread's rows:
// column o of group j lives in lane 4 * (lane / 4) + (o % 8) / 2 as element
// o % 2, so a shift by r moves values between the lanes of a quad.
__device__ __forceinline__ void add_shifted(float (&o0)[32], float (&o1)[32],
                                            const float (&a0)[32], const float (&a1)[32],
                                            const float (&a2)[4], int r, int lane) {
  if (r == 0) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      o0[k] += a0[k];
      o1[k] += a1[k];
    }
    return;
  }
  const int q = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = 2 * q + e + r;                       // source column within the group
      const int src = (lane & ~3) | ((s & 7) >> 1);
      const bool carry = s >= 8;                         // ... or the next group's
      const bool odd = (r & 1) != 0;
      float v[17];
#pragma unroll
      for (int G = 0; G < 17; ++G) {
        const float mine = odd ? acc_at(a0, a1, a2, G, i, e ^ 1) : acc_at(a0, a1, a2, G, i, e);
        v[G] = __shfl_sync(0xffffffffu, mine, src);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o0[4 * j + 2 * i + e] += carry ? v[j + 1] : v[j];
        o1[4 * j + 2 * i + e] += carry ? v[j + 9] : v[j + 8];
      }
    }
  }
}

// A ring of kN pipeline stages of kBytes in shared memory and its
// barriers; the producer and the consumers each walk it with their own
// (stage, phase).
template <int kN, int kBytes>
struct RingOf {
  uint32_t base;    // 1024-byte aligned shared address of stage 0
  uint64_t* full;   // TMA bytes landed
  uint64_t* empty;  // consumers done with the stage
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ uint32_t at() const { return base + stage * kBytes; }
  __device__ __forceinline__ void advance() {
    if (++stage == kN) {
      stage = 0;
      phase ^= 1u;
    }
  }
};
typedef RingOf<kStages, kStageBytes> Ring;

// Producer: the TMA loads of one tile, tap by tap, chunk by chunk.
__device__ __forceinline__ void produce_tile(const WgmmaArgs& a, const Tile& tl,
                                             const CUtensorMap* xmap, const CUtensorMap* emap,
                                             const CUtensorMap* wmap, Ring& ring) {
  for (int tap = 0; tap < a.n_dt; ++tap) {
    const int f0 = tl.t0 + tap_of(a.off, tap);
    const bool edge = tap_of(a.shift, tap) != 0;
    for (int c = 0; c < tl.nc; ++c) {
      mbar_wait(smem_u32(&ring.empty[ring.stage]), ring.phase ^ 1u);
      const uint32_t bar = smem_u32(&ring.full[ring.stage]);
      const uint32_t sb = ring.at();
      const int row = tl.row0 + c * kKc;
      mbar_expect_tx(bar, 2 * kXBox + kWBox + (edge ? kEdgeBox : 0));
      tma_load_3d(sb, xmap, bar, f0, row, tl.b);
      tma_load_3d(sb + kXBox, xmap, bar, f0 + kBoxT, row, tl.b);
      tma_load_3d(sb + kWOff, wmap, bar, c * kKc, 0, tl.wsub * a.n_dt + tap);
      if (edge) tma_load_3d(sb + kEdgeOff, emap, bar, f0 + 2 * kBoxT, row, tl.b);
      ring.advance();
    }
  }
}

// Consumers: one tile's sums into o0, o1 (output columns 0-63, 64-127),
// tap by tap. Thread (warp w, lane l) holds rows 16w + l/4 + 8i (i = 0, 1)
// and, in group G (8 columns), columns 8G + 2(l%4) + e (e = 0, 1):
// register 4G + 2i + e of an m64n64 tile, 2i + e of the m64n8 edge.
__device__ __forceinline__ void consume_tile(const WgmmaArgs& a, const Tile& tl, Ring& ring,
                                             int lane, float (&o0)[32], float (&o1)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    o0[k] = 0.f;
    o1[k] = 0.f;
  }
  for (int tap = 0; tap < a.n_dt; ++tap) {
    const int r = tap_of(a.shift, tap);
    float a0[32], a1[32], a2[4];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      a0[k] = 0.f;
      a1[k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) a2[k] = 0.f;
    fence_acc(a0);
    fence_acc(a1);
    fence_acc(a2);
    for (int c = 0; c < tl.nc; ++c) {
      const int ksteps = min(kSteps, (tl.kl - c * kKc) / 16);
      mbar_wait(smem_u32(&ring.full[ring.stage]), ring.phase);
      const uint32_t sb = ring.at();
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        if (ks < ksteps) {
          // A: 64 rows x 16 columns at column 16ks of the 128-byte-swizzled
          // weight box (8-row groups 1024 bytes apart). B: band rows 16ks..
          // of each x box, frames contiguous: 128-byte swizzled (8-row
          // groups 1024 bytes apart) or, for the edge box, unswizzled 8 x 8
          // core matrices (128 bytes apart).
          const uint64_t da = smem_desc(sb + kWOff + 32 * ks, 1024, 1);
          wgmma_64x64x16(a0, da, smem_desc(sb + 2048 * ks, 1024, 1));
          wgmma_64x64x16(a1, da, smem_desc(sb + kXBox + 2048 * ks, 1024, 1));
          if (r != 0) wgmma_64x8x16(a2, da, smem_desc(sb + kEdgeOff + 256 * ks, 128, 0));
        }
      }
      wgmma_commit();
      // With kInFlight groups still running, the stage kInFlight back is
      // done: hand its buffers back.
      wgmma_wait<kInFlight>();
      fence_acc(a0);
      fence_acc(a1);
      fence_acc(a2);
      if (c >= kInFlight && lane == 0)
        mbar_arrive(smem_u32(&ring.empty[(ring.stage + kStages - kInFlight) % kStages]));
      ring.advance();
    }
    wgmma_wait<0>();
    fence_acc(a0);
    fence_acc(a1);
    fence_acc(a2);
    if (lane == 0)
      for (int k = min(tl.nc, kInFlight); k > 0; --k)
        mbar_arrive(smem_u32(&ring.empty[(ring.stage + kStages - k) % kStages]));
    add_shifted(o0, o1, a0, a1, a2, r, lane);
  }
}

// Consumers: bias, ELU, residual and the bf16 store of one tile. The
// float32 sums pass through shared memory (`stg`, kSub x kOutPitch) so
// that each thread then reads and writes 8 consecutive frames of a row:
// 16-byte residual loads and stores (vec: T % 8 == 0 and 16-byte aligned
// res and y), a warp covering two whole 256-byte rows.
__device__ __forceinline__ void store_tile(const WgmmaArgs& a, const Tile& tl, float* stg,
                                           int warp, int lane, const float (&o0)[32],
                                           const float (&o1)[32]) {
  consumer_sync();   // the previous tile's reads of stg are done
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 16 * warp + (lane >> 2) + 8 * i;
        const int col = kBoxT * h + 8 * j + 2 * (lane & 3);
        const int k = 4 * j + 2 * i;
        *reinterpret_cast<float2*>(stg + row * kOutPitch + col) =
            h ? make_float2(o1[k], o1[k + 1]) : make_float2(o0[k], o0[k + 1]);
      }
  consumer_sync();
  // Thread tid takes rows tid / 16 + 8m (m < 8), frames 8 (tid % 16)..:
  // every load of its eight items first, then the arithmetic and stores,
  // so that their latencies overlap.
  constexpr int kItems = kSub * kTileT / 8 / kConsumers;   // 8
  const int tid = 32 * warp + lane;
  const int col = 8 * (tid % (kTileT / 8));
  const int t = tl.t0 + col;
  const size_t out_base = (size_t)tl.b * a.r_out * a.t_len;
  const unsigned short* rs = reinterpret_cast<const unsigned short*>(a.res);
  unsigned short* ys = reinterpret_cast<unsigned short*>(a.out);
  float v[kItems][8], bias[kItems];
  uint32_t rw[kItems][4];
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int row = tid / (kTileT / 8) + 8 * m;
    const int orow = tl.g * kSub + row;
    const bool ok = orow < a.r_out && t < a.t_len;
    const size_t o = out_base + (size_t)orow * a.t_len + t;
    bias[m] = ok ? __ldg(a.bias + tl.wsub * kSub + row) : 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) rw[m][w] = 0u;
    if (ok && rs != nullptr) {
      if (a.vec) {
        const uint4 r4 = __ldg(reinterpret_cast<const uint4*>(rs + o));
        rw[m][0] = r4.x;
        rw[m][1] = r4.y;
        rw[m][2] = r4.z;
        rw[m][3] = r4.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (t + e < a.t_len)
            rw[m][e / 2] |= static_cast<uint32_t>(__ldg(rs + o + e)) << (16 * (e & 1));
      }
    }
    const float4 lo = *reinterpret_cast<const float4*>(stg + row * kOutPitch + col);
    const float4 hi = *reinterpret_cast<const float4*>(stg + row * kOutPitch + col + 4);
    v[m][0] = lo.x;
    v[m][1] = lo.y;
    v[m][2] = lo.z;
    v[m][3] = lo.w;
    v[m][4] = hi.x;
    v[m][5] = hi.y;
    v[m][6] = hi.z;
    v[m][7] = hi.w;
  }
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int orow = tl.g * kSub + tid / (kTileT / 8) + 8 * m;
    if (orow >= a.r_out || t >= a.t_len) continue;
    uint32_t yw[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      float x2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = v[m][2 * w + e] + bias[m];
        if (a.act) x = x > 0.f ? x : __expf(fminf(x, 0.f)) - 1.f;
        // The residual's bf16 bits as float32 (0 without one).
        x += __uint_as_float(e ? (rw[m][w] & 0xFFFF0000u) : (rw[m][w] << 16));
        x2[e] = x;
      }
      const __nv_bfloat162 pr = __floats2bfloat162_rn(x2[0], x2[1]);
      yw[w] = *reinterpret_cast<const uint32_t*>(&pr);
    }
    const size_t o = out_base + (size_t)orow * a.t_len + t;
    if (a.vec) {
      *reinterpret_cast<uint4*>(ys + o) = make_uint4(yw[0], yw[1], yw[2], yw[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (t + e < a.t_len) ys[o + e] = static_cast<unsigned short>(yw[e / 2] >> (16 * (e & 1)));
    }
  }
}

// The TMA epilogue's two buffers and their barriers: tile k of a CTA is
// finished in buffer k % 2; its `full` completes when the tile's
// residual boxes have landed (or, without a residual, when the epilogue
// warp has handed the buffer over), its `done` when every consumer warp has
// written the tile's results into it.
struct Epi {
  uint32_t base;        // 1024-byte aligned shared address of buffer 0
  unsigned char* ptr;   // the same, generic
  uint64_t* full;       // [2]
  uint64_t* done;       // [2]
};

// The epilogue warp's thread (TMA epilogue), tile after tile of the CTA:
// tile k's residual boxes into buffer k % 2 once the store of tile k - 2,
// the buffer's last, has read it (without a residual a bare arrival), so
// the load runs under tile k - 1's products; then, once the consumers have
// written tile k - 1 into its buffer, that tile's store by TMA, one bulk
// group a tile (the hardware clips the rows past r_out and the frames past
// T; a box wholly past T is not stored). It runs beside the producer, so
// neither waits on the other's copies.
__device__ __forceinline__ void epilogue_copies(const WgmmaArgs& a, const CUtensorMap* rmap,
                                                const CUtensorMap* ymap, const Epi& epi) {
  for (int tile = blockIdx.x, k = 0;; tile += gridDim.x, ++k) {
    if (tile < a.n_tiles) {
      const Tile tl(a, tile);
      const uint32_t bar = smem_u32(&epi.full[k & 1]);
      const uint32_t buf = epi.base + (k & 1) * kEpiTile;
      bulk_wait_read<0>();
      if (a.res == nullptr) {
        mbar_arrive(bar);
      } else {
        mbar_expect_tx(bar, kEpiTile);
        for (int h = 0; h < 2; ++h)
          tma_load_3d(buf + h * kEpiBox, rmap, bar, tl.t0 + kBoxT * h, tl.g * kSub, tl.b);
      }
    }
    if (k > 0) {
      const Tile pt(a, tile - static_cast<int>(gridDim.x));
      const int kp = k - 1;
      mbar_wait(smem_u32(&epi.done[kp & 1]), (kp >> 1) & 1);
      for (int h = 0; h < 2; ++h)
        if (pt.t0 + kBoxT * h < a.t_len)
          tma_store_3d(ymap, epi.base + (kp & 1) * kEpiTile + h * kEpiBox, pt.t0 + kBoxT * h,
                       pt.g * kSub, pt.b);
      bulk_commit();
    }
    if (tile >= a.n_tiles) break;
  }
  bulk_wait();
}

// Consumers, TMA epilogue: bias, ELU and residual of one tile (the CTA's
// k-th) from the registers into its epilogue buffer, in store_tile's
// operations and order, so the bits are the same. Box h holds the tile's
// frames 64h..; row n of a box is 128 bytes, its 16-byte chunk c at c ^ (n
// % 8) (the 128-byte swizzle). Each thread's accumulator pair, 2 frames of
// one row, is one 32-bit word: it reads the residual's pair there and
// writes the result's in its place; a warp's 8 rows x 4 words meet 32
// banks. Every residual word is read before any result is written (the
// compiler cannot tell the swizzled addresses apart, so interleaved it
// would keep each read behind the last write), then the arithmetic and the
// writes. Once its warp's results are in, the warp goes on to the next
// tile's products.
__device__ __forceinline__ void finish_tile_tma(const WgmmaArgs& a, const Tile& tl,
                                                const Epi& epi, int k, int warp, int lane,
                                                const float (&o0)[32], const float (&o1)[32]) {
  float bias[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = 16 * warp + (lane >> 2) + 8 * i;
    const int orow = tl.g * kSub + row;
    bias[i] = orow < a.r_out ? __ldg(a.bias + tl.wsub * kSub + row) : 0.f;
  }
  // Word (h, j, i) of this thread: row 16 warp + lane / 4 + 8 i of box h,
  // chunk j ^ (lane / 4), bytes 4 (lane % 4)..
  unsigned char* mine = epi.ptr + (k & 1) * kEpiTile + (16 * warp + (lane >> 2)) * 128 +
                        4 * (lane & 3);
  const int sw = lane >> 2;
  mbar_wait(smem_u32(&epi.full[k & 1]), (k >> 1) & 1);
  uint32_t rw[2][8][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        rw[h][j][i] = a.res != nullptr ? *reinterpret_cast<const uint32_t*>(
                                             mine + h * kEpiBox + i * 1024 + ((j ^ sw) << 4))
                                       : 0u;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = (h ? o1[4 * j + 2 * i + e] : o0[4 * j + 2 * i + e]) + bias[i];
          if (a.act) x = x > 0.f ? x : __expf(fminf(x, 0.f)) - 1.f;
          // The residual's bf16 bits as float32 (0 without one).
          x += __uint_as_float(e ? (rw[h][j][i] & 0xFFFF0000u) : (rw[h][j][i] << 16));
          x2[e] = x;
        }
        const __nv_bfloat162 pr = __floats2bfloat162_rn(x2[0], x2[1]);
        *reinterpret_cast<uint32_t*>(mine + h * kEpiBox + i * 1024 + ((j ^ sw) << 4)) =
            *reinterpret_cast<const uint32_t*>(&pr);
      }
  // The results, written by this warp's threads, for the TMA's reads.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_arrive(smem_u32(&epi.done[k & 1]));
}

// Persistent: CTA k walks tiles k, k + gridDim.x, ...; the producer runs
// ahead into the next tile while the consumers finish the last one. With
// the TMA epilogue (kTma) the residual comes in by rmap and y goes out by
// ymap, both moved by one thread of an epilogue warp, through two tile
// buffers; else the consumers stage the sums in shared memory and read the
// residual and write y themselves (store_tile), and the two maps are not
// read.
template <bool kTma>
__global__ void __launch_bounds__(kThreads<kTma>, 2)
    band_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap emap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap rmap,
                      const __grid_constant__ CUtensorMap ymap, const WgmmaArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ __align__(8) uint64_t epi_bars[4];   // full, done
  // The swizzled boxes want 1024-byte aligned stages and epilogue boxes;
  // the epilogue buffers (or the output staging tile) follow the ring.
  const uint32_t pad = ((smem_u32(smem_raw) + 1023u) & ~1023u) - smem_u32(smem_raw);
  Ring ring{smem_u32(smem_raw) + pad, full, empty};
  const Epi epi{smem_u32(smem_raw) + pad + kStages * kStageBytes,
                smem_raw + pad + kStages * kStageBytes, &epi_bars[0], &epi_bars[2]};
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&empty[i]), kConsumers / 32);
    }
    if (kTma)
      for (int i = 0; i < 2; ++i) {
        mbar_init(smem_u32(&epi.full[i]), 1);
        mbar_init(smem_u32(&epi.done[i]), kConsumers / 32);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    if (lane == 0)
      for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x)
        produce_tile(a, Tile(a, tile), &xmap, &emap, &wmap, ring);
    return;
  }
  if (kTma && warp == kConsumers / 32 + 1) {
    if (lane == 0) epilogue_copies(a, &rmap, &ymap, epi);
    return;
  }
  for (int tile = blockIdx.x, k = 0; tile < a.n_tiles; tile += gridDim.x, ++k) {
    const Tile tl(a, tile);
    float o0[32], o1[32];
    consume_tile(a, tl, ring, lane, o0, o1);
    if constexpr (kTma)
      finish_tile_tma(a, tl, epi, k, warp, lane, o0, o1);
    else
      store_tile(a, tl, reinterpret_cast<float*>(epi.ptr), warp, lane, o0, o1);
  }
}

// ------------------------------------------------------------------ //
// K1 stage in float32: TMA-fed TF32 wgmma, split-TF32 (3xTF32)         //
// ------------------------------------------------------------------ //

// The float32 stage's tiles. An output tile is one 64-row sub-tile x
// kTileF frames; its transpose, frames x rows, is two m64n64 wgmma tiles,
// one a consumer warpgroup. A pipeline stage is one chunk of kKcF band
// rows: the x box (kKcF rows x kBoxF frames from t0 - kHaloF, unswizzled,
// rows of 152 floats) and the hi and lo planes of every tap's band
// weights (64 rows x kKcF columns each, 64-byte swizzled), 34,816 bytes.
// kStagesF of them and the epilogue buffer (the output tile as four boxes
// of 64 rows x kEpiBoxT frames, 128-byte swizzled, 32 KB) are all the
// shared memory a CTA takes, so two CTAs fit an SM.
constexpr int kTileF = 128;
constexpr int kHaloF = 8;                          // |dt| <= 8
constexpr int kBoxF = kTileF + 3 * kHaloF;         // 152 frames: 24 mod 32 banks
constexpr int kKcF = 16;                           // band rows per stage and fresh sum
constexpr int kStagesF = 2;
constexpr int kWBoxF = kSub * kKcF * 4;            // 4096 bytes
constexpr int kXOffF = 3 * 2 * kWBoxF;             // stage layout: W hi, lo per tap, then x
constexpr int kXBoxF = kKcF * kBoxF * 4;           // 9728 bytes
constexpr int kStageBytesF = 34816;                // kXOffF + kXBoxF, 1024-aligned
constexpr int kEpiBoxT = 32;                       // frames per epilogue box: 128 bytes
constexpr int kEpiBoxes = kTileF / kEpiBoxT;       // 4, two a consumer warpgroup
constexpr int kEpiBoxBytes = kSub * kEpiBoxT * 4;  // 8192 bytes
constexpr int kEpiOffF = kStagesF * kStageBytesF;  // the epilogue buffer follows the ring
constexpr int kConsumersF = 256;                   // two warpgroups
constexpr int kThreadsF = kConsumersF + 64;        // + the producer and epilogue warps
constexpr int kSmemF = kEpiOffF + kEpiBoxes * kEpiBoxBytes + 1024;
static_assert(kXOffF + kXBoxF <= kStageBytesF && kStageBytesF % 1024 == 0, "stage layout");

typedef RingOf<kStagesF, kStageBytesF> RingF;

// x = hi + lo: hi rounded to TF32 (nearest, ties away, as band_mma.cu's
// split_tf32), lo the float32 remainder, of which the tensor cores keep the
// TF32 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d = A (64 x 8, registers) * B (8 x 64, K-major, descriptor b), tf32
// operands, into fresh float32 accumulators (scale-d 0).
__device__ __forceinline__ void wgmma_tf32_first(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]),
        "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]),
        "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),
        "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

// d += A (64 x 8, registers) * B (8 x 64, K-major, descriptor b), tf32.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

struct WgmmaF32Args {
  const float* bias;   // (n_w * 64,): the band pattern's
  const float* res;    // (B, r_out, T) or null
  float* out;          // (B, r_out, T)
  int r_out, t_len, n_dt, n_sub, n_tiles_t, n_tiles;
  int dt[3];
  int col_adv, margin, n_w, act;
  int kb0, kl0, kb1, kl1;
  int tma_epi;         // 1: the residual and y move by TMA (T % 4 == 0)
};

// The epilogue buffer and its barriers: `full` completes when a tile's
// residual boxes have landed (or, without a residual, when the epilogue
// warp has handed the buffer over), `done` when every consumer warp has
// written the tile's results into it.
struct EpiF {
  uint32_t base;       // 1024-byte aligned shared address of box 0
  float* ptr;          // the same, generic
  uint64_t* full;
  uint64_t* done;
};

// One output tile: sub-tile g (the fastest index) x kTileF frames t0.. of
// item b, its band length, its weight sub-tile g % n_w (as Tile's) and the
// input row of its band column 0.
struct TileF {
  int t0, g, b, kl, wsub, row0;
  __device__ __forceinline__ TileF(const WgmmaF32Args& a, int tile) {
    g = tile % a.n_sub;
    const int rest = tile / a.n_sub;
    t0 = (rest % a.n_tiles_t) * kTileF;
    b = rest / a.n_tiles_t;
    const int s = g & 1;
    kl = s ? a.kl1 : a.kl0;
    wsub = g % a.n_w;
    row0 = (g / a.n_w) * a.col_adv - a.margin + (s ? a.kb1 : a.kb0);
  }
};

// Producer: the TMA loads of one tile, chunk by chunk: every tap's hi and
// lo weight boxes (plane (wsub * n_dt + tap) * 2 + lo), then the x box.
__device__ __forceinline__ void produce_tile_f32(const WgmmaF32Args& a, const TileF& tl,
                                                 const CUtensorMap* xmap,
                                                 const CUtensorMap* wmap, RingF& ring) {
  const uint32_t bytes = kXBoxF + a.n_dt * 2 * kWBoxF;
  for (int c = 0; c < tl.kl / kKcF; ++c) {
    mbar_wait(smem_u32(&ring.empty[ring.stage]), ring.phase ^ 1u);
    const uint32_t bar = smem_u32(&ring.full[ring.stage]);
    const uint32_t sb = ring.at();
    mbar_expect_tx(bar, bytes);
    for (int p = 0; p < 2 * a.n_dt; ++p)
      tma_load_3d(sb + p * kWBoxF, wmap, bar, c * kKcF, 0, tl.wsub * a.n_dt * 2 + p);
    tma_load_3d(sb + kXOffF, xmap, bar, tl.t0 - kHaloF, tl.row0 + c * kKcF, tl.b);
    ring.advance();
  }
}

// The epilogue warp (TMA epilogue), tile after tile of the CTA: once the
// consumers have written tile k - 1's results into the epilogue buffer, its
// store by TMA, a bulk group a box (the hardware clips the rows past r_out
// and the frames past T; a box wholly past T is not stored); as each box's
// store has read it, tile k's residual box into it, or without a residual
// a bare arrival once all four are read. It runs beside the producer, so
// neither waits on the other's copies.
__device__ __forceinline__ void epilogue_copies_f32(const WgmmaF32Args& a,
                                                    const CUtensorMap* rmap,
                                                    const CUtensorMap* ymap, const EpiF& epi) {
  const uint32_t bar = smem_u32(epi.full);
  for (int tile = blockIdx.x, k = 0;; tile += gridDim.x, ++k) {
    if (k > 0) {
      const TileF pt(a, tile - static_cast<int>(gridDim.x));
      mbar_wait(smem_u32(epi.done), (k - 1) & 1);
      for (int bx = 0; bx < kEpiBoxes; ++bx) {
        if (pt.t0 + kEpiBoxT * bx < a.t_len)
          tma_store_3d(ymap, epi.base + bx * kEpiBoxBytes, pt.t0 + kEpiBoxT * bx, pt.g * kSub,
                       pt.b);
        bulk_commit();
      }
    }
    if (tile >= a.n_tiles) break;
    const TileF tl(a, tile);
    if (a.res == nullptr) {
      bulk_wait_read<0>();
      mbar_arrive(bar);
      continue;
    }
    mbar_expect_tx(bar, kEpiBoxes * kEpiBoxBytes);
#pragma unroll
    for (int bx = 0; bx < kEpiBoxes; ++bx) {
      if (bx == 0) bulk_wait_read<3>();
      if (bx == 1) bulk_wait_read<2>();
      if (bx == 2) bulk_wait_read<1>();
      if (bx == 3) bulk_wait_read<0>();
      tma_load_3d(epi.base + bx * kEpiBoxBytes, rmap, bar, tl.t0 + kEpiBoxT * bx, tl.g * kSub,
                  tl.b);
    }
  }
  bulk_wait();
}

// Consumers: one tile's sums. Warpgroup q takes frames 64q.. of the tile;
// thread (warp w of it, lane l) holds the transposed tile's rows (frames)
// 64q + 16w + l/4 + 8i and, in group j (8 columns, output rows), columns
// 8j + 2(l%4) + e: register 4j + 2i + e. Its A fragment of a k8 step is
// x at band rows k + l%4 (+4) and those frames (+8), shifted by dt:
// 32-bit shared loads at any offset. Each (chunk, tap) product goes into
// fresh accumulators and is added into the running sum `run` by IEEE adds,
// chunk by chunk, tap by tap.
__device__ __forceinline__ void consume_tile_f32(const WgmmaF32Args& a, const TileF& tl,
                                                 RingF& ring, const unsigned char* ring_ptr,
                                                 int q, int w, int lane, float (&run)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) run[k] = 0.f;
  const int m = 64 * q + 16 * w + (lane >> 2) + kHaloF;
  const int kq = lane & 3;
  for (int c = 0; c < tl.kl / kKcF; ++c) {
    mbar_wait(smem_u32(&ring.full[ring.stage]), ring.phase);
    const uint32_t sb = ring.at();
    const float* xs = reinterpret_cast<const float*>(ring_ptr + ring.stage * kStageBytesF +
                                                     kXOffF);
    for (int tap = 0; tap < a.n_dt; ++tap) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const float* xp = xs + (8 * ks + kq) * kBoxF + m + tap_of(a.dt, tap);
        split_tf32(xp[0], ah[ks][0], al[ks][0]);
        split_tf32(xp[8], ah[ks][1], al[ks][1]);
        split_tf32(xp[4 * kBoxF], ah[ks][2], al[ks][2]);
        split_tf32(xp[4 * kBoxF + 8], ah[ks][3], al[ks][3]);
      }
      // B: the tap's hi and lo planes, 64 rows x 16 columns, 64-byte
      // swizzled (8-row groups 512 bytes apart); k8 step ks at 32 ks bytes.
      const uint32_t wh = sb + 2 * tap * kWBoxF;
      const uint32_t wl = wh + kWBoxF;
      float p[32];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        // Small terms first: lo * hi, hi * lo, then hi * hi.
        if (ks == 0) {
          wgmma_tf32_first(p, al[ks], smem_desc(wh + 32 * ks, 512, 2));
        } else {
          wgmma_tf32(p, al[ks], smem_desc(wh + 32 * ks, 512, 2));
        }
        wgmma_tf32(p, ah[ks], smem_desc(wl + 32 * ks, 512, 2));
        wgmma_tf32(p, ah[ks], smem_desc(wh + 32 * ks, 512, 2));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(p);
#pragma unroll
      for (int k = 0; k < 32; ++k) run[k] += p[k];
    }
    // Every wgmma reading the stage has completed: hand it back.
    if (lane == 0) mbar_arrive(smem_u32(&ring.empty[ring.stage]));
    ring.advance();
  }
}

// Consumers: bias, ELU (IEEE expf), residual and the float32 store of one
// tile, from the registers: a warp's store instruction writes 8
// consecutive frames (32 bytes) of each of 4 rows, whole sectors.
__device__ __forceinline__ void store_tile_f32(const WgmmaF32Args& a, const TileF& tl, int q,
                                               int w, int lane, const float (&run)[32]) {
  const size_t out_base = (size_t)tl.b * a.r_out * a.t_len;
  const int f0 = tl.t0 + 64 * q + 16 * w + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float v[2][2], r[2][2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + 2 * (lane & 3) + e;
      const int orow = tl.g * kSub + n;
      const float bias = orow < a.r_out ? __ldg(a.bias + tl.wsub * kSub + n) : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int f = f0 + 8 * i;
        const bool ok = orow < a.r_out && f < a.t_len;
        v[e][i] = run[4 * j + 2 * i + e] + bias;
        r[e][i] = ok && a.res != nullptr ? __ldg(a.res + out_base + (size_t)orow * a.t_len + f)
                                         : 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int orow = tl.g * kSub + 8 * j + 2 * (lane & 3) + e;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int f = f0 + 8 * i;
        if (orow >= a.r_out || f >= a.t_len) continue;
        float x = v[e][i];
        if (a.act) x = x > 0.f ? x : expf(fminf(x, 0.f)) - 1.f;
        a.out[out_base + (size_t)orow * a.t_len + f] = x + r[e][i];
      }
    }
  }
}

// Consumers, TMA epilogue: bias, ELU (IEEE expf) and the residual of one
// tile (the CTA's k-th) in the epilogue buffer, for the epilogue warp's store.
// Warpgroup q's half of the tile, frames 64q.., is boxes 2q and 2q + 1;
// row n of a box is 128 bytes, its 16-byte chunk c at c ^ (n % 8) (the
// 128-byte swizzle), so a warp's access, 8 frames x 4 rows, meets 32
// banks. Each thread reads the residual where it writes the result; once
// its warp's results are in, the warp goes on to the next tile's products.
__device__ __forceinline__ void finish_tile_f32_tma(const WgmmaF32Args& a, const TileF& tl,
                                                    const EpiF& epi, int k, int q, int w,
                                                    int lane, const float (&run)[32]) {
  float bias[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + 2 * (lane & 3) + e;
      const int orow = tl.g * kSub + n;
      bias[j][e] = orow < a.r_out ? __ldg(a.bias + tl.wsub * kSub + n) : 0.f;
    }
  mbar_wait(smem_u32(epi.full), k & 1);
  float* box = epi.ptr + (2 * q + (w >> 1)) * (kEpiBoxBytes / 4);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + 2 * (lane & 3) + e;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int f = 16 * (w & 1) + 8 * i + (lane >> 2);
        float* p = box + n * kEpiBoxT + ((((f >> 2) ^ (n & 7)) << 2) | (f & 3));
        float x = run[4 * j + 2 * i + e] + bias[j][e];
        if (a.act) x = x > 0.f ? x : expf(fminf(x, 0.f)) - 1.f;
        *p = x + (a.res != nullptr ? *p : 0.f);
      }
    }
  // The results, written by this warp's threads, for the TMA's reads.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_arrive(smem_u32(epi.done));
}

// Persistent: CTA k walks tiles k, k + gridDim.x, ...; the producer runs
// ahead into the next tile while the consumers finish the last one. With
// the TMA epilogue (a.tma_epi) the residual comes in by rmap and y goes out
// by ymap, both moved by one thread of the epilogue warp; else the epilogue
// runs from the registers, that warp does nothing and the two maps are not
// read.
__global__ void __launch_bounds__(kThreadsF, 2)
    band_wgmma_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          const __grid_constant__ CUtensorMap rmap,
                          const __grid_constant__ CUtensorMap ymap, const WgmmaF32Args a) {
  extern __shared__ __align__(16) unsigned char smem_f32[];
  __shared__ __align__(8) uint64_t full[kStagesF];
  __shared__ __align__(8) uint64_t empty[kStagesF];
  __shared__ __align__(8) uint64_t epi_bars[2];   // full, done
  // The swizzled boxes want 1024-byte aligned stages and epilogue boxes.
  const uint32_t pad = ((smem_u32(smem_f32) + 1023u) & ~1023u) - smem_u32(smem_f32);
  RingF ring{smem_u32(smem_f32) + pad, full, empty};
  const EpiF epi{smem_u32(smem_f32) + pad + kEpiOffF,
                 reinterpret_cast<float*>(smem_f32 + pad + kEpiOffF), &epi_bars[0],
                 &epi_bars[1]};
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStagesF; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&empty[i]), kConsumersF / 32);
    }
    mbar_init(smem_u32(epi.full), 1);
    mbar_init(smem_u32(epi.done), kConsumersF / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumersF / 32) {
    if (lane == 0)
      for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x)
        produce_tile_f32(a, TileF(a, tile), &xmap, &wmap, ring);
    return;
  }
  if (warp == kConsumersF / 32 + 1) {
    if (lane == 0 && a.tma_epi) epilogue_copies_f32(a, &rmap, &ymap, epi);
    return;
  }
  for (int tile = blockIdx.x, k = 0; tile < a.n_tiles; tile += gridDim.x, ++k) {
    const TileF tl(a, tile);
    float run[32];
    consume_tile_f32(a, tl, ring, smem_f32 + pad, warp >> 2, warp & 3, lane, run);
    if (a.tma_epi)
      finish_tile_f32_tma(a, tl, epi, k, warp >> 2, warp & 3, lane, run);
    else
      store_tile_f32(a, tl, warp >> 2, warp & 3, lane, run);
  }
}

// cuTensorMapEncodeTiled, a driver-API function, reached through the
// runtime so that the library links no libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D bf16 or float32 tensor map: dims (d0, d1, d2) innermost first, d0
// contiguous, boxes of (b0, b1, 1), zero fill outside the tensor.
int encode_3d(EncodeTiled enc, CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
              uint64_t d2, uint32_t b0, uint32_t b1, CUtensorMapSwizzle swizzle, bool f32) {
  const uint64_t size = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * size, d0 * d1 * size};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = enc(map, type, 3, const_cast<void*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -100 - static_cast<int>(r);
}

// A map depends on nothing but its base, dims, box and swizzle, so a map
// made once serves every later launch with the same ones (the caching
// allocator hands the same activation buffers out again, the band weights
// stay put): a cache keeps the host's encoding off all but the first
// launch on a buffer. It is emptied when it reaches kMaxMaps.
struct MapKey {
  const void* base;
  uint64_t d0, d1, d2;
  uint32_t b0, b1;
  int swizzle;
  bool f32 = false;
  bool operator==(const MapKey& o) const {
    return base == o.base && d0 == o.d0 && d1 == o.d1 && d2 == o.d2 && b0 == o.b0 &&
           b1 == o.b1 && swizzle == o.swizzle && f32 == o.f32;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = reinterpret_cast<uint64_t>(k.base);
    for (const uint64_t v :
         {k.d0, k.d1, k.d2, (uint64_t)k.b0 << 32 | k.b1, (uint64_t)k.swizzle << 1 | k.f32})
      h = (h ^ v) * 0x100000001b3ull;
    return static_cast<size_t>(h);
  }
};

int cached_map(EncodeTiled enc, CUtensorMap* map, const MapKey& k) {
  constexpr size_t kMaxMaps = 4096;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  const auto hit = maps.find(k);
  if (hit != maps.end()) {
    *map = hit->second;
    return 0;
  }
  const int rc = encode_3d(enc, map, k.base, k.d0, k.d1, k.d2, k.b0, k.b1,
                           static_cast<CUtensorMapSwizzle>(k.swizzle), k.f32);
  if (rc != 0) return rc;
  if (maps.size() >= kMaxMaps) maps.clear();
  maps.emplace(k, *map);
  return 0;
}

// One launch of band_wgmma_kernel<kTma> on a persistent grid: as many CTAs
// as device dev holds at once (found, with the shared-memory opt-in, on its
// first launch there), or as many as there are tiles.
template <bool kTma>
int launch_wgmma(int dev, const CUtensorMap& xmap, const CUtensorMap& emap,
                 const CUtensorMap& wmap, const CUtensorMap& rmap, const CUtensorMap& ymap,
                 const WgmmaArgs& a, cudaStream_t stream) {
  constexpr int threads = kThreads<kTma>, smem = kSmem<kTma>;
  static int resident[kMaxDevices] = {};
  if (resident[dev] == 0) {
    cudaError_t e = cudaFuncSetAttribute(band_wgmma_kernel<kTma>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, band_wgmma_kernel<kTma>, threads,
                                                        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (sms * per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = sms * per_sm;
  }
  const int grid = a.n_tiles < resident[dev] ? a.n_tiles : resident[dev];
  band_wgmma_kernel<kTma><<<grid, threads, smem, stream>>>(xmap, emap, wmap, rmap, ymap, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 stage, bf16 storage, TMA-fed wgmma. x: (B, r_in, t_pad) bf16, t_pad
// a multiple of 8 and >= T, zeros past T, 16-byte aligned; w: band
// weights (n_w, n_dt, 64, width) bf16, width a multiple of 32; bias
// float32; res (or null) and y: (B, r_out, T) bf16, 16-byte aligned for
// the TMA epilogue. plan: the integers ops/fused_level.py `band_tma_plan`
// fixes for a stage and T, in this order: T, t_pad, n_dt, per tap (box
// offset, shift) x 3 (dt = box offset + shift, the offset a multiple of 8
// frames, 0 <= shift < 8), col_adv, margin, width, n_w (the band
// pattern's weight sub-tiles), (start,
// length, chunks of 64) of the band of even and of odd sub-tiles, then the
// epilogue: 1 (T % 8 == 0) for the TMA epilogue, 0 for the staged one.
// Returns cudaGetLastError() of the launch, or a negative code when the
// tensor maps cannot be made (-1: no encode entry point; -100 - CUresult).
extern "C" int tt_band_conv_wgmma(const void* x, const void* w, const void* bias,
                                  const void* res, void* y, int batch, int r_in, int r_out,
                                  int act, const int* plan, void* stream) {
  const int t_len = plan[0], t_pad = plan[1], n_dt = plan[2];
  const int width = plan[11], n_w = plan[12];
  const int tma_epi = plan[19];
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -1;
  CUtensorMap xmap, emap, wmap, rmap = {}, ymap = {};
  const uint64_t rows = r_in, items = batch, wsubs = (uint64_t)n_w * n_dt;
  int rc = cached_map(enc, &xmap, {x, (uint64_t)t_pad, rows, items, kBoxT, kKc,
                                   CU_TENSOR_MAP_SWIZZLE_128B});
  if (rc == 0)
    rc = cached_map(enc, &emap, {x, (uint64_t)t_pad, rows, items, kEdgeT, kKc,
                                 CU_TENSOR_MAP_SWIZZLE_NONE});
  if (rc == 0)
    rc = cached_map(enc, &wmap, {w, (uint64_t)width, kSub, wsubs, kKc, kSub,
                                 CU_TENSOR_MAP_SWIZZLE_128B});
  // The TMA epilogue's maps: the output tile's boxes in y and in the residual.
  if (rc == 0 && tma_epi)
    rc = cached_map(enc, &ymap, {y, (uint64_t)t_len, (uint64_t)r_out, items, kBoxT, kSub,
                                 CU_TENSOR_MAP_SWIZZLE_128B});
  if (rc == 0 && tma_epi && res != nullptr)
    rc = cached_map(enc, &rmap, {res, (uint64_t)t_len, (uint64_t)r_out, items, kBoxT, kSub,
                                 CU_TENSOR_MAP_SWIZZLE_128B});
  if (rc != 0) return rc;

  WgmmaArgs a = {};
  a.bias = static_cast<const float*>(bias);
  a.res = static_cast<const bf16*>(res);
  a.out = static_cast<bf16*>(y);
  a.r_out = r_out;
  a.t_len = t_len;
  a.n_dt = n_dt;
  a.n_sub = (r_out + kSub - 1) / kSub;
  a.n_tiles_t = (t_len + kTileT - 1) / kTileT;
  a.n_tiles = a.n_sub * a.n_tiles_t * batch;
  for (int i = 0; i < 3; ++i) {
    a.off[i] = plan[3 + 2 * i];
    a.shift[i] = plan[4 + 2 * i];
  }
  a.col_adv = plan[9];
  a.margin = plan[10];
  a.n_w = n_w;
  a.act = act;
  // The staged epilogue's 16-byte residual loads and stores.
  a.vec = t_len % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(res) % 16 == 0;
  a.kb0 = plan[13];
  a.kl0 = plan[14];
  a.nc0 = plan[15];
  a.kb1 = plan[16];
  a.kl1 = plan[17];
  a.nc1 = plan[18];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tma_epi ? launch_wgmma<true>(dev, xmap, emap, wmap, rmap, ymap, a, s)
                 : launch_wgmma<false>(dev, xmap, emap, wmap, rmap, ymap, a, s);
}

// K1 stage, float32 storage, TMA-fed TF32 wgmma with split-TF32 products.
// x: (B, r_in, t_pad) float32, t_pad a multiple of 4 and >= T, zeros past
// T, 16-byte aligned; w: the band weights' TF32 planes (n_w, n_dt, 2, 64,
// width) float32 (plane 0 hi, rounded to TF32 nearest with ties away; 1
// lo, the remainder), width a multiple of 32; bias float32; res (or null)
// and y: (B, r_out, T) float32, 16-byte aligned for the TMA epilogue.
// plan: the integers ops/fused_level.py `band_tma_plan_f32` fixes for a
// stage and T, in this order: T, t_pad, n_dt, dt x 3, col_adv, margin,
// width, n_w (as tt_band_conv_wgmma's), (start, length) of the band of
// even and of odd sub-tiles (lengths multiples of 16), then the epilogue:
// 1 (T % 4 == 0)
// for the TMA epilogue, 0 for the one from the registers. Returns
// cudaGetLastError() of the launch, or a negative code when the tensor maps
// cannot be made (-1: no encode entry point; -100 - CUresult).
extern "C" int tt_band_conv_wgmma_f32(const void* x, const void* w, const void* bias,
                                      const void* res, void* y, int batch, int r_in, int r_out,
                                      int act, const int* plan, void* stream) {
  const int t_len = plan[0], t_pad = plan[1], n_dt = plan[2];
  const int width = plan[8], n_w = plan[9];
  // Per device: the shared-memory opt-in, and how many CTAs the card
  // holds at once (the persistent grid).
  static int resident[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    e = cudaFuncSetAttribute(band_wgmma_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemF);
    int sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, band_wgmma_f32_kernel,
                                                        kThreadsF, kSmemF);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (sms * per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = sms * per_sm;
  }
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -1;
  const int tma_epi = plan[14];
  CUtensorMap xmap, wmap, rmap = {}, ymap = {};
  int rc = cached_map(enc, &xmap, {x, (uint64_t)t_pad, (uint64_t)r_in, (uint64_t)batch, kBoxF,
                                   kKcF, CU_TENSOR_MAP_SWIZZLE_NONE, true});
  if (rc == 0)
    rc = cached_map(enc, &wmap, {w, (uint64_t)width, kSub, (uint64_t)n_w * n_dt * 2, kKcF, kSub,
                                 CU_TENSOR_MAP_SWIZZLE_64B, true});
  // The epilogue's maps: the output tile's boxes in y and in the residual.
  if (rc == 0 && tma_epi)
    rc = cached_map(enc, &ymap, {y, (uint64_t)t_len, (uint64_t)r_out, (uint64_t)batch, kEpiBoxT,
                                 kSub, CU_TENSOR_MAP_SWIZZLE_128B, true});
  if (rc == 0 && tma_epi && res != nullptr)
    rc = cached_map(enc, &rmap, {res, (uint64_t)t_len, (uint64_t)r_out, (uint64_t)batch,
                                 kEpiBoxT, kSub, CU_TENSOR_MAP_SWIZZLE_128B, true});
  if (rc != 0) return rc;

  WgmmaF32Args a = {};
  a.bias = static_cast<const float*>(bias);
  a.res = static_cast<const float*>(res);
  a.out = static_cast<float*>(y);
  a.r_out = r_out;
  a.t_len = t_len;
  a.n_dt = n_dt;
  a.n_sub = (r_out + kSub - 1) / kSub;
  a.n_tiles_t = (t_len + kTileF - 1) / kTileF;
  a.n_tiles = a.n_sub * a.n_tiles_t * batch;
  for (int i = 0; i < 3; ++i) a.dt[i] = plan[3 + i];
  a.col_adv = plan[6];
  a.margin = plan[7];
  a.n_w = n_w;
  a.act = act;
  a.kb0 = plan[10];
  a.kl0 = plan[11];
  a.kb1 = plan[12];
  a.kl1 = plan[13];
  a.tma_epi = tma_epi;
  const int grid = a.n_tiles < resident[dev] ? a.n_tiles : resident[dev];
  band_wgmma_f32_kernel<<<grid, kThreadsF, kSmemF, static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, rmap, ymap, a);
  return static_cast<int>(cudaGetLastError());
}
