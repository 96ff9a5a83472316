// Band-tiled tensor-core products of the level backward (kernel K3: dX and
// dW), bf16 and float32, for Hopper (sm_90a).
//
// Replaces the products of the Pallas TPU kernel
// timbre_trap_tpu/ops/fused_level.py `_level_bwd_kernel` (launched by
// `_pallas_bwd_call`; both storage dtypes); the wrappers in
// ops/fused_level.py (`banded_conv_dx`, `banded_conv_dw`) pick the entry
// point by dtype. The forward stage (K1), which the backward recomputes, is
// band_wgmma.cu's; K3's ELU' seed, an elementwise pass, is in
// banded_conv_bwd.cu.
//
// The banded blocks are mostly structural zeros: an output row of a conv
// reads n_df * c_in of a block's K input rows. Each 64-row half of a
// 128-row block (a sub-tile) therefore carries its band, the first block
// column it reads and how many, rounded out to 16 (ops/packed_conv.py
// `_sub_tile_bands`, from the static tap map). Every product here runs over
// a sub-tile's band only, with mma.sync and float32 accumulators: m16n8k16
// on bf16 operands fed by ldmatrix, m16n8k8 on tf32 operands fed by 32-bit
// shared-memory loads.
//
//   tt_band_conv_dx  dX: y[64g + r, t] = epi(sum_dt sum_k W_g,dt[r, k] *
//                      c[s_g + k, t + dt]) over the adjoint's bands, s_g
//                      the input row of band column 0 of sub-tile g, the
//                      float32 cotangent c rounded to bf16 while it is
//                      staged; epilogue: + residual cotangent, keep that
//                      value (raw), * ELU' from stored outputs (1 where
//                      y > 0, else y + 1, y = s1 - s2).
//   tt_band_conv_dw  dW: dW_dt[r, k] = sum_{b,j,t} dZ[b, R j + r, t] *
//                      x[b, j*col_adv - margin + k, t + dt] on band entries
//                      only (zeros elsewhere), R = 128 P the rows of the
//                      conv's band pattern (P blocks, its period), dBias[r]
//                      from the float32 dZ. Fixed slices of the (b, j, 64
//                      frames) chunks, per-slice partials, a second pass
//                      that sums them as a fixed pairwise tree: the same
//                      bits every run.
//   tt_band_conv_dx_f32, tt_band_conv_dw_f32  dX and dW in float32
//                      storage: the same grids, bands and epilogues, the
//                      products as 3xTF32 (m16n8k8; each operand split
//                      into TF32 hi + lo, hi*hi + hi*lo + lo*hi in
//                      float32), the f32-accurate product that the JAX
//                      package's precision="highest" asks for.
//
// Design. A time tap shifts the frames by dt (|dt| <= 8), which breaks the
// 16-byte row alignment ldmatrix needs if the shifted operand is stored with
// frames contiguous. So the operand that carries the shift is staged
// TRANSPOSED: frames are its shared-memory rows, and a tap is a row offset.
// dX's cotangent is read from global memory 8 frames x 2 rows at a time
// (16-byte loads where the rows are 16-byte aligned, element loads at
// ragged edges), packed into bf16 pairs and stored as cs[frame][k]; all
// taps of a k chunk read that one tile. dW stages dZ the same way (as
// zs[frame][r], ldmatrix.trans gives the A fragments) and x untransposed.
// Loads for the next k chunk are in flight while the current one is
// multiplied (two buffers, register staging; weights by cp.async). The
// float32 routes need no transposition: their fragments are 32-bit loads,
// which take any address, so every operand is staged as it lies in memory
// (a tap is a column offset) and every tile moves by cp.async with zero
// fill at the edges: dX with four chunks in flight, dW with two.
//
// What bounds it: with the zeros skipped, a product needs ~2 * n_dt * 64 * L
// flops per sub-tile and frame (L the band, 48-256) against a few bytes per
// row and frame in and out, near the card's bytes-per-flop line in bf16; in
// float32 the three TF32 passes at half the bf16 rate put dX and dW well
// above that line, bound by the tensor cores. The tensor cores round their
// float32 sums toward zero, so no float32 route keeps a long running sum in
// the MMA accumulators: each short product goes into fresh accumulators and
// reaches the running sum by an IEEE add.
//
// The dX kernels' bool template argument is always true and selects
// nothing: it keeps their names as the benchmark's K3 kernel patterns read
// them (portbench/kernels/k3: band_product_kernel<..., true, ...> and
// band_tf32_kernel<true>).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kSub = 64;                     // rows of a sub-tile
constexpr int kHalo = 8;                     // frames staged per side: |dt| <= 8
constexpr int kThreads = 256;                // 8 warps
// dX: a CTA computes one sub-tile x kTileT frames, kKc band columns per
// pipeline stage; warp (wm, wn) owns rows 32wm.. and frames 32wn...
constexpr int kTileT = 128;
constexpr int kKc = 32;
constexpr int kXRows = kTileT + 2 * kHalo;   // 144 staged frames
constexpr int kPitch = kKc + 8;              // 80-byte rows: conflict-free ldmatrix
constexpr int kXItems = (kKc / 2) * (kXRows / 8);   // (row pair, 8 frames) items
constexpr int kXSlots = (kXItems + kThreads - 1) / kThreads;
constexpr int kDxSmem = (2 * kXRows * kPitch + 2 * 3 * kSub * kPitch) * 2;
// dW: a CTA sums a 64-row x kDwN-column band tile of every tap over the
// kDwT-frame chunks of its slice; warp (wm, wn) owns rows 16wm.., columns
// 32wn...
constexpr int kDwT = 64;
constexpr int kDwN = 64;
constexpr int kZRows = kDwT + 2 * kHalo;     // 80 staged frames of dZ
constexpr int kZPitch = kSub + 8;            // 144-byte rows
constexpr int kXdPitch = kDwT + 8;
constexpr int kZItems = (kSub / 2) * (kZRows / 8);  // 320
constexpr int kZSlots = (kZItems + kThreads - 1) / kThreads;
constexpr int kXdItems = kDwN * (kDwT / 8);          // 512
constexpr int kXdSlots = kXdItems / kThreads;

constexpr int kMaxDevices = 64;

// The dynamic shared-memory opt-in of `kernel` holds for the device that
// was current when it was set: set it once per device (`set`, one flag a
// device, kept by the caller for its kernel).
template <typename Kernel>
int smem_opt_in(Kernel kernel, int bytes, bool (&set)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!set[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    set[dev] = true;
  }
  return 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(const void* p, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Frames [t, t + 8) of one bf16 row, zero outside [0, t_len) and for a null
// row (a row outside the tensor).
__device__ __forceinline__ uint4 load8(const bf16* row, int t, int t_len, bool aligned) {
  if (row == nullptr) return make_uint4(0u, 0u, 0u, 0u);
  if (aligned && t >= 0 && t + 8 <= t_len) return __ldg(reinterpret_cast<const uint4*>(row + t));
  const unsigned short* p = reinterpret_cast<const unsigned short*>(row);
  uint32_t h[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) h[m] = (t + m >= 0 && t + m < t_len) ? p[t + m] : 0u;
  return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                    h[6] | (h[7] << 16));
}

// The same for a float32 row: two float4 (frames t..t+3, t+4..t+7).
__device__ __forceinline__ void load8(const float* row, int t, int t_len, bool aligned,
                                      float4& lo, float4& hi) {
  if (row == nullptr) {
    lo = hi = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  if (aligned && t >= 0 && t + 8 <= t_len) {
    lo = __ldg(reinterpret_cast<const float4*>(row + t));
    hi = __ldg(reinterpret_cast<const float4*>(row + t + 4));
    return;
  }
  float v[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) v[m] = (t + m >= 0 && t + m < t_len) ? row[t + m] : 0.f;
  lo = make_float4(v[0], v[1], v[2], v[3]);
  hi = make_float4(v[4], v[5], v[6], v[7]);
}

// Eight frames of two adjacent float32 rows (a: row k, b: row k + 1) as
// loaded; words() gives, per frame, the pair (x[k], x[k + 1]) rounded to
// bf16 as one 32-bit word, the layout of a row of a transposed tile.
struct RowPair {
  float4 a0, a1, b0, b1;
  __device__ __forceinline__ void load(const float* ra, const float* rb, int t, int t_len,
                                       bool aligned) {
    load8(ra, t, t_len, aligned, a0, a1);
    load8(rb, t, t_len, aligned, b0, b1);
  }
  __device__ __forceinline__ void words(uint32_t (&w)[8]) const {
    w[0] = pack_bf16(a0.x, b0.x);
    w[1] = pack_bf16(a0.y, b0.y);
    w[2] = pack_bf16(a0.z, b0.z);
    w[3] = pack_bf16(a0.w, b0.w);
    w[4] = pack_bf16(a1.x, b1.x);
    w[5] = pack_bf16(a1.y, b1.y);
    w[6] = pack_bf16(a1.z, b1.z);
    w[7] = pack_bf16(a1.w, b1.w);
  }
  __device__ __forceinline__ float sum_a() const {
    return ((a0.x + a0.y) + (a0.z + a0.w)) + ((a1.x + a1.y) + (a1.z + a1.w));
  }
  __device__ __forceinline__ float sum_b() const {
    return ((b0.x + b0.y) + (b0.z + b0.w)) + ((b1.x + b1.y) + (b1.z + b1.w));
  }
};

__device__ __forceinline__ int tap_shift(int di, int dt0, int dt1, int dt2) {
  return di == 0 ? dt0 : (di == 1 ? dt1 : dt2);
}

// ------------------------------------------------------------------ //
// K3 dX: one sub-tile x 128 frames per CTA                                 //
// ------------------------------------------------------------------ //

// bias and act are the forward stage's fields, which dX leaves at null and
// 0: the struct keeps the layout the two shared because, without them,
// ptxas allocates the dX mainloop otherwise and dX measured 5 % slower on
// the card (bf16 3.49 -> 3.66 ms, float32 4.65 -> 4.88 ms a recipe encoder
// level 1 backward). n_w is the adjoint's band pattern in sub-tiles (2 a
// 128-row block of its period): sub-tile g takes weight sub-tile g % n_w
// and reads from input row (g / n_w) * col_adv - margin + its band start.
struct BandArgs {
  const void* src;     // (B, r_in, T) float32 cotangent
  const void* w;       // (n_w, n_dt, 64, width) adjoint band weights, bf16 or float32
  const float* bias;
  const void* res;     // (B, r_out, T) float32 residual cotangent, or null
  const void* s1;      // stored output for ELU', at the storage type
  const void* s2;      // stored item input subtracted from s1
  float* raw;          // the value before ELU'
  void* out;           // (B, r_out, T)
  int r_in, r_out, t_len, n_dt, dt0, dt1, dt2;
  int col_adv, margin, width, n_w, act, aligned;
  int kb0, kl0, kb1, kl1;
};

// Writes the float32 values of frames col, col + 1 of one output row.
template <typename TO>
__device__ __forceinline__ void store_pair(TO* out, size_t o, int col, int t_len, float v0,
                                           float v1);
template <>
__device__ __forceinline__ void store_pair<float>(float* out, size_t o, int col, int t_len,
                                                  float v0, float v1) {
  if ((t_len & 1) == 0 && col + 1 < t_len) {
    *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
  } else {
    if (col < t_len) out[o] = v0;
    if (col + 1 < t_len) out[o + 1] = v1;
  }
}
template <>
__device__ __forceinline__ void store_pair<bf16>(bf16* out, size_t o, int col, int t_len,
                                                 float v0, float v1) {
  if ((t_len & 1) == 0 && col + 1 < t_len) {
    *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < t_len) out[o] = __float2bfloat16_rn(v0);
    if (col + 1 < t_len) out[o + 1] = __float2bfloat16_rn(v1);
  }
}

__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const bf16* p) { return to_f32(__ldg(p)); }

// The dX epilogue of a warp's 32-row x 32-frame accumulator tile (rows
// 32wm.., frames 32wn.. of sub-tile g; the accumulator layout of both
// m16n8k16 and m16n8k8): + the float32 residual cotangent, raw, x ELU'
// from the stored tensors s1, s2 of type TSt.
template <typename TO, typename TSt>
__device__ __forceinline__ void dx_epilogue(const BandArgs& a, const float (&acc)[2][4][4],
                                            int g, int t0, int b, int wm, int wn, int lane) {
  const size_t out_base = (size_t)b * a.r_out * a.t_len;
  TO* out = static_cast<TO*>(a.out);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row_l = 32 * wm + 16 * mi + (lane >> 2) + 8 * h;
      const int orow = g * kSub + row_l;
      if (orow >= a.r_out) continue;
      const size_t row_o = out_base + (size_t)orow * a.t_len;
      // Every load of the row's 8 outputs (read-only path) before its
      // stores, which the compiler cannot prove apart from them: one round
      // trip to memory a row, not one an output.
      float add[4][2], yarg[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = t0 + 32 * wn + 8 * ni + 2 * (lane & 3) + e;
          const bool ok = col < a.t_len;
          add[ni][e] = 0.f;
          yarg[ni][e] = 1.f;
          if (ok && a.res != nullptr) add[ni][e] = ldg_f32(static_cast<const float*>(a.res) + row_o + col);
          if (ok && a.s1 != nullptr) {
            float y = ldg_f32(static_cast<const TSt*>(a.s1) + row_o + col);
            if (a.s2 != nullptr) y -= ldg_f32(static_cast<const TSt*>(a.s2) + row_o + col);
            yarg[ni][e] = y;
          }
        }
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = t0 + 32 * wn + 8 * ni + 2 * (lane & 3);
        if (col >= a.t_len) continue;
        const size_t o = row_o + col;
        float v[2] = {acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] += add[ni][e];
          if (a.raw != nullptr && col + e < a.t_len) a.raw[o + e] = v[e];
          if (a.s1 != nullptr) v[e] *= yarg[ni][e] > 0.f ? 1.f : yarg[ni][e] + 1.f;
        }
        store_pair<TO>(out, o, col, a.t_len, v[0], v[1]);
      }
    }
  }
}

// bf16 dX, the output at TO (float32, or bf16 for the level's input
// gradient): two CTAs an SM, as the float32 staged chunk's registers allow.
template <typename TO, bool kNameTag = true>
__global__ void __launch_bounds__(kThreads, 2) band_product_kernel(const BandArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);       // [2][kXRows][kPitch]
  bf16* ws = xs + 2 * kXRows * kPitch;                 // [2][3][kSub][kPitch]

  const int t0 = blockIdx.x * kTileT;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int s = g & 1;
  const int kb = s ? a.kb1 : a.kb0;
  const int kl = s ? a.kl1 : a.kl0;
  const int row0 = (g / a.n_w) * a.col_adv - a.margin + kb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;
  const int wn = warp >> 1;
  const bool aligned = a.aligned != 0;

  const float* src = static_cast<const float*>(a.src) + (size_t)b * a.r_in * a.t_len;
  const int wsub = g % a.n_w;
  const bf16* wsrc = static_cast<const bf16*>(a.w) + (size_t)wsub * a.n_dt * kSub * a.width;
  const int n_chunks = (kl + kKc - 1) / kKc;

  RowPair st[kXSlots];
  auto load_x = [&](int c) {
#pragma unroll
    for (int i = 0; i < kXSlots; ++i) {
      const int item = tid + i * kThreads;
      if (item < kXItems) {
        const int kp = item % (kKc / 2);
        const int tc = item / (kKc / 2);
        const int r = row0 + c * kKc + 2 * kp;
        const float* ra = (r >= 0 && r < a.r_in) ? src + (size_t)r * a.t_len : nullptr;
        const float* rb = (r + 1 >= 0 && r + 1 < a.r_in) ? src + (size_t)(r + 1) * a.t_len : nullptr;
        st[i].load(ra, rb, t0 - kHalo + 8 * tc, a.t_len, aligned);
      }
    }
  };
  auto store_x = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kXSlots; ++i) {
      const int item = tid + i * kThreads;
      if (item < kXItems) {
        const int kp = item % (kKc / 2);
        const int tc = item / (kKc / 2);
        uint32_t w[8];
        st[i].words(w);
        bf16* base = xs + ((size_t)buf * kXRows + 8 * tc) * kPitch + 2 * kp;
#pragma unroll
        for (int m = 0; m < 8; ++m) *reinterpret_cast<uint32_t*>(base + m * kPitch) = w[m];
      }
    }
  };
  auto load_w = [&](int c, int buf) {
    const int pieces = a.n_dt * kSub * (kKc / 8);
    for (int p = tid; p < pieces; p += kThreads) {
      const int tap = p / (kSub * (kKc / 8));
      const int rem = p % (kSub * (kKc / 8));
      const int r = rem / (kKc / 8);
      const int q = rem % (kKc / 8);
      cp_async16(ws + (((size_t)buf * 3 + tap) * kSub + r) * kPitch + 8 * q,
                 wsrc + ((size_t)tap * kSub + r) * a.width + c * kKc + 8 * q);
    }
    cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  load_x(0);
  load_w(0, 0);
  store_x(0);
  cp_async_wait_all();
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    const bool more = c + 1 < n_chunks;
    if (more) {
      load_x(c + 1);
      load_w(c + 1, buf ^ 1);
    }
    const int ksteps = min(2, (kl - c * kKc) / 16);
    const bf16* xb = xs + (size_t)buf * kXRows * kPitch;
#pragma unroll
    for (int tap = 0; tap < 3; ++tap) {
      if (tap < a.n_dt) {
        const int dt = tap_shift(tap, a.dt0, a.dt1, a.dt2);
        const bf16* wb = ws + ((size_t)buf * 3 + tap) * kSub * kPitch;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          if (ks < ksteps) {
            uint32_t af[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              ldsm_x4(wb + (32 * wm + 16 * mi + (lane & 15)) * kPitch + 16 * ks + 8 * (lane >> 4),
                      af[mi][0], af[mi][1], af[mi][2], af[mi][3]);
            uint32_t bfr[4][2];
#pragma unroll
            for (int nj = 0; nj < 2; ++nj) {
              const int n = 32 * wn + 16 * nj + (lane & 7) + 8 * (lane >> 4);
              ldsm_x4(xb + (n + kHalo + dt) * kPitch + 16 * ks + 8 * ((lane >> 3) & 1),
                      bfr[2 * nj][0], bfr[2 * nj][1], bfr[2 * nj + 1][0], bfr[2 * nj + 1][1]);
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
          }
        }
      }
    }
    if (more) store_x(buf ^ 1);
    cp_async_wait_all();
    __syncthreads();
  }
  dx_epilogue<TO, bf16>(a, acc, g, t0, b, wm, wn, lane);
}

template <typename TO>
int launch_band_product(const BandArgs& a, int batch, cudaStream_t st) {
  const auto kernel = band_product_kernel<TO>;
  static bool configured[kMaxDevices] = {};
  const int rc = smem_opt_in(kernel, kDxSmem, configured);
  if (rc != 0) return rc;
  const dim3 grid((a.t_len + kTileT - 1) / kTileT, (a.r_out + kSub - 1) / kSub, batch);
  kernel<<<grid, kThreads, kDxSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ //
// K3 dX in float32: split-TF32 (3xTF32) products                           //
// ------------------------------------------------------------------ //

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo. mma.sync ignores the low 13 bits of a .tf32 register, so hi
// is rounded explicitly (nearest, ties away) and lo is the remainder from
// the rounded hi, x - hi, exact in float32 and at most 2^-11 |x|. The
// tensor cores then drop lo's own low bits: an error of at most 2^-21 |x|,
// of either sign since lo's sign is x - hi's, measured on the card at the
// IEEE float32 level (tools/f32_accuracy.py); rounding lo as well was
// slower on the card for no gain there.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a (16x8, row) * b (8x8, col), tf32 operands, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b, the same product into fresh accumulators.
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// cp.async of 16 (4) bytes that writes zeros instead where !valid (src is
// then not read, but must be a valid address).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The float32 dX tiles: kKcF band columns a pipeline stage, kStagesF
// stages in flight. c is staged as it lies in memory, xs[k][frame] (frames
// t0 - 8 .. t0 + 136): a 32-bit fragment load needs no alignment, so a tap
// is a column offset and every load is a cp.async straight into shared
// memory, with no register staging. Rows of kXPitchF = 152 floats (24 mod
// 32 banks) and kWPitchF = 20 put a fragment load's 32 lanes in 32 banks.
// 100,352 bytes of shared memory: 2 CTAs an SM, as the registers allow.
constexpr int kKcF = 16;
constexpr int kStagesF = 4;
constexpr int kXPitchF = kXRows + 8;
constexpr int kWPitchF = kKcF + 4;
constexpr int kXStageF = kKcF * kXPitchF;
constexpr int kWStageF = 3 * kSub * kWPitchF;
constexpr int kTf32Smem = kStagesF * (kXStageF + kWStageF) * 4;

// band_product_kernel for float32 storage: the same grid, bands and
// epilogue; it reads the cotangent as it lies and the ELU' operands s1, s2
// in float32.
// The products run on the tensor cores as 3xTF32: each
// float32 fragment element splits into hi + lo after its shared-memory
// load and every m16n8k8 step computes lo*hi + hi*lo + hi*hi in float32
// (the dropped lo*lo and the truncation of lo are ~2^-21 of a product).
// The tensor cores round their float32 sums toward zero, so a running sum
// kept in the MMA accumulators drifts toward zero by up to half an ulp an
// MMA (~1e-5 relative over a 1984-column band); each tap's 16-column
// chunk therefore goes into fresh accumulators (6 MMAs) and reaches the
// running sum by an IEEE (round-to-nearest) add, which keeps the error at
// float32 level (one add per 8 columns was slower for no gain there).
// Fragments are 32-bit shared-memory loads (ldmatrix moves 16-bit
// elements).
template <bool kNameTag = true>
__global__ void __launch_bounds__(kThreads, 2) band_tf32_kernel(const BandArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);      // [kStagesF][kKcF][kXPitchF]
  float* ws = xs + kStagesF * kXStageF;                // [kStagesF][3][kSub][kWPitchF]

  const int t0 = blockIdx.x * kTileT;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int s = g & 1;
  const int kb = s ? a.kb1 : a.kb0;
  const int kl = s ? a.kl1 : a.kl0;
  const int row0 = (g / a.n_w) * a.col_adv - a.margin + kb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1;
  const int wn = warp >> 1;
  const int gq = lane >> 2;
  const int tq = lane & 3;

  const float* src = static_cast<const float*>(a.src) + (size_t)b * a.r_in * a.t_len;
  const int wsub = g % a.n_w;
  const float* wsrc = static_cast<const float*>(a.w) + (size_t)wsub * a.n_dt * kSub * a.width;
  const int n_chunks = kl / kKcF;  // bands are multiples of 16 columns

  // Chunk c (band columns 16c..16c + 15) into stage st: zeros outside the
  // input's rows and frames. Aligned rows (T % 4 == 0) move in 16-byte
  // pieces, each wholly inside or outside [0, T); others element by element.
  auto load_chunk = [&](int c, int st) {
    float* xd = xs + st * kXStageF;
    const int r0 = row0 + c * kKcF;
    if (a.aligned) {
      for (int p = tid; p < kKcF * (kXRows / 4); p += kThreads) {
        const int kk = p / (kXRows / 4);
        const int f = 4 * (p % (kXRows / 4));
        const int r = r0 + kk;
        const int t = t0 - kHalo + f;
        const bool ok = r >= 0 && r < a.r_in && t >= 0 && t < a.t_len;
        cp_async16_zfill(xd + kk * kXPitchF + f, ok ? src + (size_t)r * a.t_len + t : src, ok);
      }
    } else {
      for (int p = tid; p < kKcF * kXRows; p += kThreads) {
        const int kk = p / kXRows;
        const int f = p % kXRows;
        const int r = r0 + kk;
        const int t = t0 - kHalo + f;
        const bool ok = r >= 0 && r < a.r_in && t >= 0 && t < a.t_len;
        cp_async4_zfill(xd + kk * kXPitchF + f, ok ? src + (size_t)r * a.t_len + t : src, ok);
      }
    }
    float* wd = ws + st * kWStageF;
    for (int p = tid; p < a.n_dt * kSub * (kKcF / 4); p += kThreads) {
      const int tr = p / (kKcF / 4);  // tap * kSub + row
      const int q = p % (kKcF / 4);
      cp_async16(wd + tr * kWPitchF + 4 * q, wsrc + (size_t)tr * a.width + c * kKcF + 4 * q);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#pragma unroll
  for (int c = 0; c < kStagesF - 1; ++c) {
    if (c < n_chunks) load_chunk(c, c);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStagesF - 2>();  // chunk c has landed
    __syncthreads();                // and every warp is done with chunk c - 1
    if (c + kStagesF - 1 < n_chunks) load_chunk(c + kStagesF - 1, (c + kStagesF - 1) % kStagesF);
    cp_async_commit();
    const float* xb = xs + (c % kStagesF) * kXStageF;
    const float* wst = ws + (c % kStagesF) * kWStageF;
#pragma unroll
    for (int tap = 0; tap < 3; ++tap) {
      if (tap < a.n_dt) {
        const int dt = tap_shift(tap, a.dt0, a.dt1, a.dt2);
        const float* wb = wst + tap * kSub * kWPitchF;
        // The tap's 16-column product (two m16n8k8 steps, small terms
        // first) in fresh accumulators, then one IEEE add into the running
        // sum.
        float p[2][4][4];
#pragma unroll
        for (int ks = 0; ks < kKcF / 8; ++ks) {
          // A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3
          // (g + 8, t + 4); B (8 x 8): b0 (k t, frame g), b1 (k t + 4).
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const float* x0 = xb + (8 * ks + tq) * kXPitchF + 32 * wn + 8 * ni + gq + kHalo + dt;
            split_tf32(x0[0], bh[ni][0], bl[ni][0]);
            split_tf32(x0[4 * kXPitchF], bh[ni][1], bl[ni][1]);
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            uint32_t ah[4], al[4];
            const float* w0 = wb + (32 * wm + 16 * mi + gq) * kWPitchF + 8 * ks + tq;
            split_tf32(w0[0], ah[0], al[0]);
            split_tf32(w0[8 * kWPitchF], ah[1], al[1]);
            split_tf32(w0[4], ah[2], al[2]);
            split_tf32(w0[8 * kWPitchF + 4], ah[3], al[3]);
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              if (ks == 0) {
                mma_tf32_first(p[mi][ni], al, bh[ni]);
              } else {
                mma_tf32(p[mi][ni], al, bh[ni]);
              }
            }
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma_tf32(p[mi][ni], ah, bl[ni]);
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma_tf32(p[mi][ni], ah, bh[ni]);
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] += p[mi][ni][e];
      }
    }
  }
  cp_async_wait<0>();
  dx_epilogue<float, float>(a, acc, g, t0, b, wm, wn, lane);
}

int launch_band_tf32(const BandArgs& a, int batch, cudaStream_t st) {
  const auto kernel = band_tf32_kernel<>;
  static bool configured[kMaxDevices] = {};
  const int rc = smem_opt_in(kernel, kTf32Smem, configured);
  if (rc != 0) return rc;
  const dim3 grid((a.t_len + kTileT - 1) / kTileT, (a.r_out + kSub - 1) / kSub, batch);
  kernel<<<grid, kThreads, kTf32Smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ //
// K3 dW: band tiles, per-slice partials, fixed-order reduction         //
// ------------------------------------------------------------------ //

struct DwArgs {
  const float* dz;     // (B, r_out, T) float32 cotangent of the conv's output
  const void* x;       // (B, r_in, T) the conv's input, bf16 or float32
  float* part;         // (n_slices, n_dt, rows, k) partial dW (band entries)
  float* part_bias;    // (n_slices, rows) partial dBias
  int batch, r_in, r_out, t_len, n_dt, dt0, dt1, dt2;
  int k, col_adv, margin, n_blocks, n_slices, aligned;
  int kb0, kl0, kb1, kl1;
  int rows;            // rows of the band pattern: 128 a block of the period
};

// Grid (n column tiles, rows / 64 sub-tiles of the pattern, n_slices).
// Slice sl sums the chunks [Q*sl/S, Q*(sl+1)/S) of the Q = B * n_blocks *
// ceil(T / 64) chunks of (batch, pattern, 64 frames), in order
// (n_blocks counts patterns of `rows` output rows).
__global__ void __launch_bounds__(kThreads, 2) band_dw_partial_kernel(const DwArgs a) {
  // bf16 tiles, declared as their 16-bit words.
  __shared__ __align__(16) uint16_t zs[2][kZRows][kZPitch];
  __shared__ __align__(16) uint16_t xs[2][kDwN][kXdPitch];
  __shared__ float bred[kZRows / 8][kSub];

  const int s = blockIdx.y;
  const int sl = blockIdx.z;
  const int kb = (s & 1) ? a.kb1 : a.kb0;
  const int kl = (s & 1) ? a.kl1 : a.kl0;
  const int n0 = blockIdx.x * kDwN;
  if (n0 >= kl) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const bool aligned = a.aligned != 0;

  const int n_tc = (a.t_len + kDwT - 1) / kDwT;
  const long long n_chunks = (long long)a.batch * a.n_blocks * n_tc;
  const long long q_begin = n_chunks * sl / a.n_slices;
  const long long q_end = n_chunks * (sl + 1) / a.n_slices;

  RowPair zst[kZSlots];
  uint4 xst[kXdSlots];
  float bsum[kZSlots][2];
#pragma unroll
  for (int i = 0; i < kZSlots; ++i) bsum[i][0] = bsum[i][1] = 0.f;

  auto load = [&](long long q) {
    const int tcn = (int)(q % n_tc);
    const long long bj = q / n_tc;
    const int j = (int)(bj % a.n_blocks);
    const int b = (int)(bj / a.n_blocks);
    const int tc0 = tcn * kDwT;
    const float* dz = a.dz + (size_t)b * a.r_out * a.t_len;
#pragma unroll
    for (int i = 0; i < kZSlots; ++i) {
      const int item = tid + i * kThreads;
      if (item < kZItems) {
        const int rp = item % (kSub / 2);
        const int tz = item / (kSub / 2);
        const int r = j * a.rows + s * kSub + 2 * rp;
        const float* ra = r < a.r_out ? dz + (size_t)r * a.t_len : nullptr;
        const float* rb = r + 1 < a.r_out ? dz + (size_t)(r + 1) * a.t_len : nullptr;
        zst[i].load(ra, rb, tc0 - kHalo + 8 * tz, a.t_len, aligned);
      }
    }
    const bf16* x = static_cast<const bf16*>(a.x) + (size_t)b * a.r_in * a.t_len;
    const int xrow0 = j * a.col_adv - a.margin + kb + n0;
#pragma unroll
    for (int i = 0; i < kXdSlots; ++i) {
      const int item = tid + i * kThreads;
      const int r = xrow0 + item / (kDwT / 8);
      const bf16* row = (r >= 0 && r < a.r_in) ? x + (size_t)r * a.t_len : nullptr;
      xst[i] = load8(row, tc0 + 8 * (item % (kDwT / 8)), a.t_len, aligned);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kZSlots; ++i) {
      const int item = tid + i * kThreads;
      if (item < kZItems) {
        const int rp = item % (kSub / 2);
        const int tz = item / (kSub / 2);
        uint32_t w[8];
        zst[i].words(w);
#pragma unroll
        for (int m = 0; m < 8; ++m)
          *reinterpret_cast<uint32_t*>(&zs[buf][8 * tz + m][2 * rp]) = w[m];
        // dBias counts each frame once: the chunk's own 64, not the halo.
        if (tz >= 1 && tz <= kDwT / 8) {
          bsum[i][0] += zst[i].sum_a();
          bsum[i][1] += zst[i].sum_b();
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kXdSlots; ++i) {
      const int item = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&xs[buf][item / (kDwT / 8)][8 * (item % (kDwT / 8))]) = xst[i];
    }
  };

  float acc[3][4][4];
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tap][ni][e] = 0.f;

  if (q_begin < q_end) {
    load(q_begin);
    store(0);
  }
  __syncthreads();
  for (long long q = q_begin; q < q_end; ++q) {
    const int buf = (int)((q - q_begin) & 1);
    const bool more = q + 1 < q_end;
    if (more) load(q + 1);
#pragma unroll
    for (int ks = 0; ks < kDwT / 16; ++ks) {
      uint32_t bfr[4][2];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int n = 32 * wn + 16 * nj + (lane & 7) + 8 * (lane >> 4);
        ldsm_x4(&xs[buf][n][16 * ks + 8 * ((lane >> 3) & 1)], bfr[2 * nj][0], bfr[2 * nj][1],
                bfr[2 * nj + 1][0], bfr[2 * nj + 1][1]);
      }
#pragma unroll
      for (int tap = 0; tap < 3; ++tap) {
        if (tap < a.n_dt) {
          const int dt = tap_shift(tap, a.dt0, a.dt1, a.dt2);
          uint32_t af[4];
          const int tz = 16 * ks + kHalo - dt + (lane & 7) + 8 * (lane >> 4);
          ldsm_x4_trans(&zs[buf][tz][16 * wm + 8 * ((lane >> 3) & 1)], af[0], af[1], af[2],
                        af[3]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[tap][ni], af, bfr[ni][0], bfr[ni][1]);
        }
      }
    }
    if (more) store(buf ^ 1);
    __syncthreads();
  }

  float* part = a.part + (size_t)sl * a.n_dt * a.rows * a.k;
#pragma unroll
  for (int tap = 0; tap < 3; ++tap) {
    if (tap >= a.n_dt) continue;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = s * kSub + 16 * wm + (lane >> 2) + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = n0 + 32 * wn + 8 * ni + 2 * (lane & 3) + e;
          const int col = kb + cl;
          if (cl < kl && col < a.k)
            part[((size_t)tap * a.rows + r) * a.k + col] = acc[tap][ni][2 * h + e];
        }
      }
    }
  }
  if (blockIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kZSlots; ++i) {
      const int item = tid + i * kThreads;
      if (item < kZItems) {
        const int rp = item % (kSub / 2);
        const int tz = item / (kSub / 2);
        bred[tz][2 * rp] = bsum[i][0];
        bred[tz][2 * rp + 1] = bsum[i][1];
      }
    }
    __syncthreads();
    if (tid < kSub) {
      float v = 0.f;
      for (int tz = 1; tz <= kDwT / 8; ++tz) v += bred[tz][tid];
      a.part_bias[(size_t)sl * a.rows + s * kSub + tid] = v;
    }
  }
}

// The float32 dW tiles: dZ staged as it lies, zs[r][frame] over the chunk's
// 64 frames and 8 on each side (a tap is a column offset), x as
// xs[col][frame]; rows of 84 and 68 floats (4 mod 8 words) put a fragment
// load's 32 lanes in 32 banks. Two chunks in flight, 77,824 bytes of
// shared memory: 2 CTAs an SM.
constexpr int kZPitchF = kZRows + 4;
constexpr int kXdPitchF = kDwT + 4;
constexpr int kStagesDw = 2;
constexpr int kZStageF = kSub * kZPitchF;
constexpr int kXdStageF = kDwN * kXdPitchF;
constexpr int kDwTf32Smem = kStagesDw * (kZStageF + kXdStageF) * 4;

// band_dw_partial_kernel for float32 storage: the same grid, slices, chunk
// order and outputs, the products as 3xTF32 m16n8k8 (A = dZ rows x frames,
// B = frames x band columns, both split into hi + lo after their
// shared-memory load). A dW entry sums B * n_blocks * T products (~2e5 at
// the recipe), so each (chunk, tap) product, 64 frames, goes into fresh
// accumulators and reaches the tap's running sum by one IEEE add. dBias:
// the CTAs of column tile 0 sum the float32 dZ of each chunk's own 64
// frames from shared memory, each thread 16 frames of one row in order
// into a fresh sum that it adds into its running sum (one add a chunk into
// the long sum, not one a frame), the four quarters of a row added in a
// fixed order at the end.
__global__ void __launch_bounds__(kThreads, 2) band_dw_tf32_kernel(const DwArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* zs = reinterpret_cast<float*>(smem_raw);      // [kStagesDw][kSub][kZPitchF]
  float* xs = zs + kStagesDw * kZStageF;               // [kStagesDw][kDwN][kXdPitchF]

  const int s = blockIdx.y;
  const int sl = blockIdx.z;
  const int kb = (s & 1) ? a.kb1 : a.kb0;
  const int kl = (s & 1) ? a.kl1 : a.kl0;
  const int n0 = blockIdx.x * kDwN;
  if (n0 >= kl) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const bool bias_cta = blockIdx.x == 0;

  const int n_tc = (a.t_len + kDwT - 1) / kDwT;
  const long long n_chunks = (long long)a.batch * a.n_blocks * n_tc;
  const long long q_begin = n_chunks * sl / a.n_slices;
  const long long q_end = n_chunks * (sl + 1) / a.n_slices;

  // Chunk q into stage st: zeros outside the tensors' rows and frames.
  // Aligned rows (T % 4 == 0) move in 16-byte pieces, each wholly inside
  // or outside [0, T); others element by element.
  auto load_chunk = [&](long long q, int st) {
    const int tc0 = (int)(q % n_tc) * kDwT;
    const long long bj = q / n_tc;
    const int j = (int)(bj % a.n_blocks);
    const int b = (int)(bj / a.n_blocks);
    const float* dz = a.dz + (size_t)b * a.r_out * a.t_len;
    const float* x = static_cast<const float*>(a.x) + (size_t)b * a.r_in * a.t_len;
    const int zrow0 = j * a.rows + s * kSub;
    const int xrow0 = j * a.col_adv - a.margin + kb + n0;
    float* zd = zs + st * kZStageF;
    float* xd = xs + st * kXdStageF;
    if (a.aligned) {
      for (int p = tid; p < kSub * (kZRows / 4); p += kThreads) {
        const int r = p / (kZRows / 4);
        const int f = 4 * (p % (kZRows / 4));
        const int row = zrow0 + r;
        const int t = tc0 - kHalo + f;
        const bool ok = row < a.r_out && t >= 0 && t < a.t_len;
        cp_async16_zfill(zd + r * kZPitchF + f, ok ? dz + (size_t)row * a.t_len + t : dz, ok);
      }
      for (int p = tid; p < kDwN * (kDwT / 4); p += kThreads) {
        const int n = p / (kDwT / 4);
        const int f = 4 * (p % (kDwT / 4));
        const int row = xrow0 + n;
        const int t = tc0 + f;
        const bool ok = row >= 0 && row < a.r_in && t < a.t_len;
        cp_async16_zfill(xd + n * kXdPitchF + f, ok ? x + (size_t)row * a.t_len + t : x, ok);
      }
    } else {
      for (int p = tid; p < kSub * kZRows; p += kThreads) {
        const int r = p / kZRows;
        const int f = p % kZRows;
        const int row = zrow0 + r;
        const int t = tc0 - kHalo + f;
        const bool ok = row < a.r_out && t >= 0 && t < a.t_len;
        cp_async4_zfill(zd + r * kZPitchF + f, ok ? dz + (size_t)row * a.t_len + t : dz, ok);
      }
      for (int p = tid; p < kDwN * kDwT; p += kThreads) {
        const int n = p / kDwT;
        const int f = p % kDwT;
        const int row = xrow0 + n;
        const int t = tc0 + f;
        const bool ok = row >= 0 && row < a.r_in && t < a.t_len;
        cp_async4_zfill(xd + n * kXdPitchF + f, ok ? x + (size_t)row * a.t_len + t : x, ok);
      }
    }
  };

  float acc[3][4][4];
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tap][ni][e] = 0.f;
  float bsum = 0.f;

#pragma unroll
  for (int c = 0; c < kStagesDw - 1; ++c) {
    if (q_begin + c < q_end) load_chunk(q_begin + c, c);
    cp_async_commit();
  }
  for (long long q = q_begin; q < q_end; ++q) {
    const int i = (int)(q - q_begin);
    cp_async_wait<kStagesDw - 2>();  // chunk q has landed
    __syncthreads();                 // and every warp is done with chunk q - 1
    if (q + kStagesDw - 1 < q_end) load_chunk(q + kStagesDw - 1, (i + kStagesDw - 1) % kStagesDw);
    cp_async_commit();
    const float* zb = zs + (i % kStagesDw) * kZStageF;
    const float* xb = xs + (i % kStagesDw) * kXdStageF;
    if (bias_cta) {
      const float* zr = zb + (tid >> 2) * kZPitchF + kHalo + 16 * (tid & 3);
      float c = 0.f;
#pragma unroll
      for (int f = 0; f < 16; ++f) c += zr[f];
      bsum += c;
    }
#pragma unroll
    for (int tap = 0; tap < 3; ++tap) {
      if (tap < a.n_dt) {
        const int dt = tap_shift(tap, a.dt0, a.dt1, a.dt2);
        // The tap's 64-frame product (8 m16n8k8 steps, small terms first
        // in each) in fresh accumulators, then one IEEE add into the
        // running sum. A (16 x 8): a0 (row g, frame t), a1 (g + 8, t), a2
        // (g, t + 4), a3 (g + 8, t + 4), dZ read at frame - dt; B (8 x 8):
        // b0 (frame t, column g), b1 (frame t + 4, column g).
        float p[4][4];
#pragma unroll
        for (int ks = 0; ks < kDwT / 8; ++ks) {
          uint32_t ah[4], al[4];
          const float* z0 = zb + (16 * wm + gq) * kZPitchF + 8 * ks + tq + kHalo - dt;
          split_tf32(z0[0], ah[0], al[0]);
          split_tf32(z0[8 * kZPitchF], ah[1], al[1]);
          split_tf32(z0[4], ah[2], al[2]);
          split_tf32(z0[8 * kZPitchF + 4], ah[3], al[3]);
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const float* x0 = xb + (32 * wn + 8 * ni + gq) * kXdPitchF + 8 * ks + tq;
            split_tf32(x0[0], bh[ni][0], bl[ni][0]);
            split_tf32(x0[4], bh[ni][1], bl[ni][1]);
          }
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            if (ks == 0) {
              mma_tf32_first(p[ni], al, bh[ni]);
            } else {
              mma_tf32(p[ni], al, bh[ni]);
            }
          }
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_tf32(p[ni], ah, bl[ni]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_tf32(p[ni], ah, bh[ni]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[tap][ni][e] += p[ni][e];
      }
    }
  }
  cp_async_wait<0>();

  float* part = a.part + (size_t)sl * a.n_dt * a.rows * a.k;
#pragma unroll
  for (int tap = 0; tap < 3; ++tap) {
    if (tap >= a.n_dt) continue;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = s * kSub + 16 * wm + gq + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = n0 + 32 * wn + 8 * ni + 2 * tq + e;
          const int col = kb + cl;
          if (cl < kl && col < a.k)
            part[((size_t)tap * a.rows + r) * a.k + col] = acc[tap][ni][2 * h + e];
        }
      }
    }
  }
  if (bias_cta) {
    // Lanes 4r' .. 4r' + 3 hold the quarters of row tid >> 2.
    const int base = lane & ~3;
    const float v = ((__shfl_sync(0xffffffffu, bsum, base) +
                      __shfl_sync(0xffffffffu, bsum, base + 1)) +
                     __shfl_sync(0xffffffffu, bsum, base + 2)) +
                    __shfl_sync(0xffffffffu, bsum, base + 3);
    if (tq == 0) a.part_bias[(size_t)sl * a.rows + s * kSub + (tid >> 2)] = v;
  }
}

// Sum of p[0], p[stride], ..., p[(n - 1) * stride] as a fixed pairwise
// tree: a binary counter merges two partial sums of equal size as soon as
// both exist, so the rounding error grows with log2(n) instead of n and
// every run adds in the same order. Whole groups of 8 are loaded together
// (8 loads in flight, not one) and summed as the counter would sum them,
// ((v0 + v1) + (v2 + v3)) + ((v4 + v5) + (v6 + v7)). n < 2^16 (at most
// 528 slices).
__device__ __forceinline__ float pairwise_sum(const float* p, size_t stride, int n) {
  float part[16];
  int size[16];
  int top = 0;
  auto push = [&](float v, int c) {
    while (top > 0 && size[top - 1] == c) {
      v = part[--top] + v;
      c <<= 1;
    }
    part[top] = v;
    size[top] = c;
    ++top;
  };
  int i = 0;
  for (; i + 8 <= n; i += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = p[(size_t)(i + j) * stride];
    push(((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7])), 8);
  }
  for (; i < n; ++i) push(p[(size_t)i * stride], 1);
  float v = part[--top];
  while (top > 0) v = part[--top] + v;
  return v;
}

// dw[i] = the pairwise sum over slices of part[s][i] on band entries, 0
// elsewhere; then dBias the same way (rows: the band pattern's).
__global__ void band_dw_reduce_kernel(const float* part, const float* part_bias, float* dw,
                                      float* db, int n_slices, int n_w, int k, int rows,
                                      int kb0, int kl0, int kb1, int kl1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_w) {
    const int col = i % k;
    const bool odd = ((i / k) % rows / kSub) & 1;
    const int kb = odd ? kb1 : kb0;
    const int kl = odd ? kl1 : kl0;
    dw[i] = col >= kb && col < kb + kl ? pairwise_sum(part + i, n_w, n_slices) : 0.f;
  } else if (i < n_w + rows) {
    const int r = i - n_w;
    db[r] = pairwise_sum(part_bias + r, rows, n_slices);
  }
}

BandArgs dx_args(const void* c, const void* w, const void* res, const void* s1, const void* s2,
                 void* raw, void* out, int r_in, int r_out, int t_len, int n_dt, int dt0,
                 int dt1, int dt2, int col_adv, int margin, int width, int n_w, int kb0,
                 int kl0, int kb1, int kl1, int aligned) {
  BandArgs a = {};
  a.src = c;
  a.w = w;
  a.res = res;
  a.s1 = s1;
  a.s2 = s2;
  a.raw = static_cast<float*>(raw);
  a.out = out;
  a.r_in = r_in;
  a.r_out = r_out;
  a.t_len = t_len;
  a.n_dt = n_dt;
  a.dt0 = dt0;
  a.dt1 = dt1;
  a.dt2 = dt2;
  a.col_adv = col_adv;
  a.margin = margin;
  a.width = width;
  a.n_w = n_w;
  a.aligned = aligned;
  a.kb0 = kb0;
  a.kl0 = kl0;
  a.kb1 = kb1;
  a.kl1 = kl1;
  return a;
}

DwArgs dw_args(const void* dz, const void* x, void* part, void* part_bias, int batch, int r_in,
               int r_out, int t_len, int n_dt, int dt0, int dt1, int dt2, int k, int col_adv,
               int margin, int period, int kb0, int kl0, int kb1, int kl1, int n_slices,
               int aligned) {
  DwArgs a = {};
  a.dz = static_cast<const float*>(dz);
  a.x = x;
  a.part = static_cast<float*>(part);
  a.part_bias = static_cast<float*>(part_bias);
  a.batch = batch;
  a.r_in = r_in;
  a.r_out = r_out;
  a.t_len = t_len;
  a.n_dt = n_dt;
  a.dt0 = dt0;
  a.dt1 = dt1;
  a.dt2 = dt2;
  a.k = k;
  a.col_adv = col_adv;
  a.margin = margin;
  a.rows = 128 * period;
  a.n_blocks = (r_out + a.rows - 1) / a.rows;
  a.n_slices = n_slices;
  a.aligned = aligned;
  a.kb0 = kb0;
  a.kl0 = kl0;
  a.kb1 = kb1;
  a.kl1 = kl1;
  return a;
}

// The fixed-order second pass of both dW routes, after the partials.
int launch_dw_reduce(const DwArgs& a, void* dw, void* db, cudaStream_t st) {
  const int n_w = a.n_dt * a.rows * a.k;
  band_dw_reduce_kernel<<<(n_w + a.rows + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.part, a.part_bias, static_cast<float*>(dw), static_cast<float*>(db), a.n_slices, n_w,
      a.k, a.rows, a.kb0, a.kl0, a.kb1, a.kl1);
  return static_cast<int>(cudaGetLastError());
}

// Grid of the dW partial kernels: (column tiles of the longer band, the
// pattern's sub-tiles, n_slices).
dim3 dw_grid(const DwArgs& a) {
  const int kl_max = a.kl0 > a.kl1 ? a.kl0 : a.kl1;
  return dim3((kl_max + kDwN - 1) / kDwN, a.rows / kSub, a.n_slices);
}

}  // namespace

// K3 dX, bf16 storage: c (B, r_in, T) float32 cotangent; w the adjoint's
// band weights; res (float32), s1, s2 (bf16), raw (float32) (B, r_out, T)
// or null; out float32 when out_f32, else bf16.
extern "C" int tt_band_conv_dx(const void* c, const void* w, const void* res, const void* s1,
                               const void* s2, void* raw, void* out, int out_f32, int batch,
                               int r_in, int r_out, int t_len, int n_dt, int dt0, int dt1,
                               int dt2, int col_adv, int margin, int width, int n_w, int kb0,
                               int kl0, int kb1, int kl1, int aligned, void* stream) {
  const BandArgs a = dx_args(c, w, res, s1, s2, raw, out, r_in, r_out, t_len, n_dt, dt0, dt1,
                             dt2, col_adv, margin, width, n_w, kb0, kl0, kb1, kl1, aligned);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_f32) return launch_band_product<float>(a, batch, st);
  return launch_band_product<bf16>(a, batch, st);
}

// K3 dX, float32 storage, split-TF32 products: w the adjoint's band
// weights in float32; s1, s2 float32; out float32; otherwise as
// tt_band_conv_dx (aligned: T % 4 == 0 and an aligned base).
extern "C" int tt_band_conv_dx_f32(const void* c, const void* w, const void* res,
                                   const void* s1, const void* s2, void* raw, void* out,
                                   int batch, int r_in, int r_out, int t_len, int n_dt, int dt0,
                                   int dt1, int dt2, int col_adv, int margin, int width,
                                   int n_w, int kb0, int kl0, int kb1, int kl1, int aligned,
                                   void* stream) {
  const BandArgs a = dx_args(c, w, res, s1, s2, raw, out, r_in, r_out, t_len, n_dt, dt0, dt1,
                             dt2, col_adv, margin, width, n_w, kb0, kl0, kb1, kl1, aligned);
  return launch_band_tf32(a, batch, static_cast<cudaStream_t>(stream));
}

// K3 dW and dBias, bf16 storage: dz (B, r_out, T) float32, x (B, r_in, T)
// bf16; the conv's band pattern spans `period` 128-row blocks, rows = 128 *
// period; part (n_slices, n_dt, rows, k) and part_bias (n_slices, rows)
// float32 scratch; dw (n_dt, rows, k) and db (rows,) float32.
extern "C" int tt_band_conv_dw(const void* dz, const void* x, void* part, void* part_bias,
                               void* dw, void* db, int batch, int r_in, int r_out, int t_len,
                               int n_dt, int dt0, int dt1, int dt2, int k, int col_adv,
                               int margin, int period, int kb0, int kl0, int kb1, int kl1,
                               int n_slices, int aligned, void* stream) {
  const DwArgs a = dw_args(dz, x, part, part_bias, batch, r_in, r_out, t_len, n_dt, dt0, dt1,
                           dt2, k, col_adv, margin, period, kb0, kl0, kb1, kl1, n_slices,
                           aligned);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  band_dw_partial_kernel<<<dw_grid(a), kThreads, 0, st>>>(a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_dw_reduce(a, dw, db, st);
}

// K3 dW and dBias, float32 storage, split-TF32 products: x float32;
// otherwise as tt_band_conv_dw (aligned: T % 4 == 0 and aligned bases).
extern "C" int tt_band_conv_dw_f32(const void* dz, const void* x, void* part, void* part_bias,
                                   void* dw, void* db, int batch, int r_in, int r_out,
                                   int t_len, int n_dt, int dt0, int dt1, int dt2, int k,
                                   int col_adv, int margin, int period, int kb0, int kl0,
                                   int kb1, int kl1, int n_slices, int aligned, void* stream) {
  static bool configured[kMaxDevices] = {};
  const int rc = smem_opt_in(band_dw_tf32_kernel, kDwTf32Smem, configured);
  if (rc != 0) return rc;
  const DwArgs a = dw_args(dz, x, part, part_bias, batch, r_in, r_out, t_len, n_dt, dt0, dt1,
                           dt2, k, col_adv, margin, period, kb0, kl0, kb1, kl1, n_slices,
                           aligned);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  band_dw_tf32_kernel<<<dw_grid(a), kThreads, kDwTf32Smem, st>>>(a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_dw_reduce(a, dw, db, st);
}
