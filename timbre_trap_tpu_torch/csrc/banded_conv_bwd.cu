// Level backward (K3) on the packed f-major layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel timbre_trap_tpu/ops/fused_level.py
// `_level_bwd_kernel` (launched by `_pallas_bwd_call`, wrapped as a custom
// VJP by `make_fused_level_train`). The Pallas kernel runs a whole level's
// VJP per time tile inside one 100 MB VMEM budget: it recomputes the
// forward, walks the items in reverse, and carries the dW/dBias sums in
// accumulators that persist across its sequential grid. An SM has 227 KB
// and CUDA blocks run in no order, so here the backward runs stage by stage
// on exact (B, R, T) tensors in device memory, as K1 (banded_conv.cu) does
// for the forward; the wrapper (ops/fused_level.py:level_backward)
// recomputes the level through K1, keeps each item's input and each
// residual block's conv1 activation, and orders these launches:
//
//   tt_elu_backward   the cotangent of the level's last item:
//                       out = f32(dy) * ELU'(s1 - s2),  raw = f32(dy)
//   tt_banded_conv_dx the adjoint banded product of a float32 cotangent with
//                     a conv's adjoint blocks (the K1 indexing, zero reads
//                     outside [0, r_in) and [0, T)); the cotangent is rounded
//                     to the storage type for the product and accumulated in
//                     float32. Epilogue: + the residual cotangent, keep that
//                     value (raw), times ELU' rebuilt from stored outputs
//                     (1 where y > 0, else y + 1, y = s1 - s2).
//   tt_banded_conv_dw dW_dt[r, k] = sum_{b,j,t} dZ[b, 128j + r, t] *
//                                   x[b, j*col_adv - margin + k, t + dt]
//                     and dBias[r] = sum_{b,j,t} dZ[b, 128j + r, t], with
//                     storage-type operands and float32 sums (dBias from the
//                     float32 cotangent). Pass 1: each CTA sums one slice of
//                     the (b, j, t) chunks into its own partial; pass 2 adds
//                     the partials in a fixed order. No float atomics, so dW
//                     and dBias are the same bits from run to run. The
//                     Pallas kernel's dw_mask/col_ok masking has nothing to
//                     do: no column outside [0, T) exists here.
//
// What bounds it: dX and dW are banded matrix products of ~2 * 128 * K flops
// per output block column and tap, as the forward, so they are bound by
// arithmetic; this first version uses the same plain FFMA tiling as K1 (an
// 8 x 4 register tile per thread, KC x 128 and KC x 64 shared tiles) and
// computes the banded blocks' structural zeros. Tensor cores (wgmma), TMA
// and skipping the zeros are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockRows = 128;
constexpr int kTileT = 64;
constexpr int kKc = 32;
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kRowsPerThread = 8;
constexpr int kColsPerThread = 4;
// dW: a CTA owns a 128 x kTileK tile of one tap's dW and sums it over the
// frame columns of its slice, kTc at a time. The shared tiles are padded by
// 4 floats per row: it keeps the float4 reads aligned and spreads the
// transposing stores over 8 banks.
constexpr int kTileK = 64;
constexpr int kTc = 32;
constexpr int kPadR = kBlockRows + 4;
constexpr int kPadK = kTileK + 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A float32 value rounded to the storage type and widened back.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

// ELU'(z) from y = ELU(z): 1 where y > 0, else exp(z) = y + 1.
__device__ __forceinline__ float elu_grad_from_out(float y) { return y > 0.f ? 1.f : y + 1.f; }

struct DxArgs {
  const float* c;     // (B, r_in, T) float32 cotangent
  const void* w;      // (n_dt, k, 128) adjoint blocks, storage type
  const float* res;   // (B, r_out, T) float32 residual cotangent, or null
  const void* s1;     // (B, r_out, T) stored output for ELU', or null
  const void* s2;     // (B, r_out, T) stored item input subtracted from s1, or null
  float* raw;         // (B, r_out, T) the value before ELU', or null
  void* out;          // (B, r_out, T) float32 or storage type
  int r_in, r_out, t_len;
  int n_dt, dt0, dt1, dt2;
  int k, col_adv, margin;
};

template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads)
banded_conv_dx_kernel(const DxArgs a) {
  __shared__ __align__(16) float ws[kKc][kBlockRows];
  __shared__ __align__(16) float xs[kKc][kTileT];

  const int t0 = blockIdx.x * kTileT;
  const int j = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const float* c = a.c + (size_t)b * a.r_in * a.t_len;
  const T* w = static_cast<const T*>(a.w);
  const int in_row0 = j * a.col_adv - a.margin;

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) acc[i][q] = 0.f;

  for (int di = 0; di < a.n_dt; ++di) {
    const int dt = di == 0 ? a.dt0 : (di == 1 ? a.dt1 : a.dt2);
    const T* wd = w + (size_t)di * a.k * kBlockRows;
    for (int k0 = 0; k0 < a.k; k0 += kKc) {
      for (int i = tid; i < kKc * kBlockRows; i += kThreads) {
        const int kk = i / kBlockRows;
        const int r = i % kBlockRows;
        const int kg = k0 + kk;
        ws[kk][r] = kg < a.k ? to_f32(wd[(size_t)kg * kBlockRows + r]) : 0.f;
      }
      for (int i = tid; i < kKc * kTileT; i += kThreads) {
        const int kk = i / kTileT;
        const int q = i % kTileT;
        const int row = in_row0 + k0 + kk;
        const int col = t0 + q + dt;
        float v = 0.f;
        if (k0 + kk < a.k && row >= 0 && row < a.r_in && col >= 0 && col < a.t_len)
          v = round_to<T>(c[(size_t)row * a.t_len + col]);
        xs[kk][q] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKc; ++kk) {
        const float4 w0 = *reinterpret_cast<const float4*>(&ws[kk][ty * kRowsPerThread]);
        const float4 w1 = *reinterpret_cast<const float4*>(&ws[kk][ty * kRowsPerThread + 4]);
        const float4 xv = *reinterpret_cast<const float4*>(&xs[kk][tx * kColsPerThread]);
        const float wr[kRowsPerThread] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        const float xc[kColsPerThread] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int q = 0; q < kColsPerThread; ++q)
            acc[i][q] = fmaf(wr[i], xc[q], acc[i][q]);
      }
      __syncthreads();
    }
  }

  const size_t out_base = (size_t)b * a.r_out * a.t_len;
  const T* s1 = static_cast<const T*>(a.s1);
  const T* s2 = static_cast<const T*>(a.s2);
  TO* out = static_cast<TO*>(a.out);
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = j * kBlockRows + ty * kRowsPerThread + i;
    if (row >= a.r_out) continue;
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) {
      const int col = t0 + tx * kColsPerThread + q;
      if (col >= a.t_len) continue;
      const size_t o = out_base + (size_t)row * a.t_len + col;
      float v = acc[i][q];
      if (a.res != nullptr) v += a.res[o];
      if (a.raw != nullptr) a.raw[o] = v;
      if (s1 != nullptr) {
        float y = to_f32(s1[o]);
        if (s2 != nullptr) y -= to_f32(s2[o]);
        v *= elu_grad_from_out(y);
      }
      out[o] = from_f32<TO>(v);
    }
  }
}

struct DwArgs {
  const float* dz;    // (B, r_out, T) float32 cotangent of the conv's output
  const void* x;      // (B, r_in, T) the conv's input, storage type
  float* part;        // (n_slices, n_dt, 128, k) partial dW
  float* part_bias;   // (n_slices, 128) partial dBias
  int batch, r_in, r_out, t_len;
  int n_dt, dt0, dt1, dt2;
  int k, col_adv, margin, n_blocks, n_slices;
};

// Grid (ceil(k / kTileK), n_dt, n_slices). Slice s sums the chunks
// [Q*s/S, Q*(s+1)/S) of the Q = B * n_blocks * ceil(T / kTc) chunks of
// (batch, output block, kTc frame columns), in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
banded_conv_dw_partial_kernel(const DwArgs a) {
  __shared__ __align__(16) float zs[kTc][kPadR];
  __shared__ __align__(16) float xs[kTc][kPadK];

  const int k0 = blockIdx.x * kTileK;
  const int di = blockIdx.y;
  const int s = blockIdx.z;
  const int dt = di == 0 ? a.dt0 : (di == 1 ? a.dt1 : a.dt2);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const int n_tc = (a.t_len + kTc - 1) / kTc;
  const long long n_chunks = (long long)a.batch * a.n_blocks * n_tc;
  const long long q_begin = n_chunks * s / a.n_slices;
  const long long q_end = n_chunks * (s + 1) / a.n_slices;
  const T* x_all = static_cast<const T*>(a.x);

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) acc[i][q] = 0.f;
  // Row sums for dBias: this thread loads rows warp + 8m of every chunk.
  float bsum[kBlockRows / 8];
#pragma unroll
  for (int m = 0; m < kBlockRows / 8; ++m) bsum[m] = 0.f;

  for (long long q = q_begin; q < q_end; ++q) {
    const int tc = (int)(q % n_tc);
    const long long bj = q / n_tc;
    const int j = (int)(bj % a.n_blocks);
    const int b = (int)(bj / a.n_blocks);
    const int col = tc * kTc + lane;
    const float* dz = a.dz + (size_t)b * a.r_out * a.t_len;
    const T* x = x_all + (size_t)b * a.r_in * a.t_len;
#pragma unroll
    for (int m = 0; m < kBlockRows / 8; ++m) {
      const int r = warp + 8 * m;
      const int row = j * kBlockRows + r;
      float v = 0.f;
      if (row < a.r_out && col < a.t_len) v = dz[(size_t)row * a.t_len + col];
      bsum[m] += v;
      zs[lane][r] = round_to<T>(v);
    }
    const int in_row0 = j * a.col_adv - a.margin + k0;
    const int xcol = col + dt;
#pragma unroll
    for (int m = 0; m < kTileK / 8; ++m) {
      const int kk = warp + 8 * m;
      const int row = in_row0 + kk;
      float v = 0.f;
      if (k0 + kk < a.k && row >= 0 && row < a.r_in && col < a.t_len && xcol >= 0 &&
          xcol < a.t_len)
        v = to_f32(x[(size_t)row * a.t_len + xcol]);
      xs[lane][kk] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int tt = 0; tt < kTc; ++tt) {
      const float4 z0 = *reinterpret_cast<const float4*>(&zs[tt][ty * kRowsPerThread]);
      const float4 z1 = *reinterpret_cast<const float4*>(&zs[tt][ty * kRowsPerThread + 4]);
      const float4 xv = *reinterpret_cast<const float4*>(&xs[tt][tx * kColsPerThread]);
      const float zr[kRowsPerThread] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
      const float xc[kColsPerThread] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int q2 = 0; q2 < kColsPerThread; ++q2)
          acc[i][q2] = fmaf(zr[i], xc[q2], acc[i][q2]);
    }
    __syncthreads();
  }

  float* part = a.part + ((size_t)s * a.n_dt + di) * kBlockRows * a.k;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty * kRowsPerThread + i;
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) {
      const int kc = k0 + tx * kColsPerThread + q;
      if (kc < a.k) part[(size_t)r * a.k + kc] = acc[i][q];
    }
  }
  if (blockIdx.x == 0 && di == 0) {
#pragma unroll
    for (int m = 0; m < kBlockRows / 8; ++m) {
      float v = bsum[m];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) a.part_bias[(size_t)s * kBlockRows + warp + 8 * m] = v;
    }
  }
}

// dw[i] = sum over slices, in slice order, of part[s][i]; then the same
// for dBias.
__global__ void banded_conv_dw_reduce_kernel(const float* part, const float* part_bias,
                                             float* dw, float* db, int n_slices, int n_w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_w) {
    float v = 0.f;
    for (int s = 0; s < n_slices; ++s) v += part[(size_t)s * n_w + i];
    dw[i] = v;
  } else if (i < n_w + kBlockRows) {
    const int r = i - n_w;
    float v = 0.f;
    for (int s = 0; s < n_slices; ++s) v += part_bias[(size_t)s * kBlockRows + r];
    db[r] = v;
  }
}

template <typename T>
__global__ void elu_backward_kernel(const T* dy, const T* s1, const T* s2, float* raw,
                                    float* out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float v = to_f32(dy[i]);
    if (raw != nullptr) raw[i] = v;
    if (s1 != nullptr) {
      float y = to_f32(s1[i]);
      if (s2 != nullptr) y -= to_f32(s2[i]);
      v *= elu_grad_from_out(y);
    }
    out[i] = v;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the storage type of the weights, of s1
// and s2, and of `out` unless out_f32). Each entry point returns
// cudaGetLastError() after its launches.
extern "C" int tt_banded_conv_dx(const void* c, const void* w, const void* res,
                                 const void* s1, const void* s2, void* raw, void* out,
                                 int dtype, int out_f32, int batch, int r_in, int r_out,
                                 int t_len, int n_dt, int dt0, int dt1, int dt2, int k,
                                 int col_adv, int margin, void* stream) {
  DxArgs a;
  a.c = static_cast<const float*>(c);
  a.w = w;
  a.res = static_cast<const float*>(res);
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
  a.k = k;
  a.col_adv = col_adv;
  a.margin = margin;
  const dim3 grid((t_len + kTileT - 1) / kTileT, (r_out + kBlockRows - 1) / kBlockRows, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && out_f32)
    banded_conv_dx_kernel<__nv_bfloat16, float><<<grid, kThreads, 0, st>>>(a);
  else if (dtype == 1)
    banded_conv_dx_kernel<__nv_bfloat16, __nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  else
    banded_conv_dx_kernel<float, float><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// part: (n_slices, n_dt, 128, k) and part_bias: (n_slices, 128) float32
// scratch; dw: (n_dt, 128, k) and db: (128,) float32.
extern "C" int tt_banded_conv_dw(const void* dz, const void* x, void* part, void* part_bias,
                                 void* dw, void* db, int dtype, int batch, int r_in,
                                 int r_out, int t_len, int n_dt, int dt0, int dt1, int dt2,
                                 int k, int col_adv, int margin, int n_slices, void* stream) {
  DwArgs a;
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
  a.n_blocks = (r_out + kBlockRows - 1) / kBlockRows;
  a.n_slices = n_slices;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((k + kTileK - 1) / kTileK, n_dt, n_slices);
  if (dtype == 1)
    banded_conv_dw_partial_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  else
    banded_conv_dw_partial_kernel<float><<<grid, kThreads, 0, st>>>(a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n_w = n_dt * kBlockRows * k;
  const int n_out = n_w + kBlockRows;
  banded_conv_dw_reduce_kernel<<<(n_out + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      a.part, a.part_bias, static_cast<float*>(dw), static_cast<float*>(db), n_slices, n_w);
  return static_cast<int>(cudaGetLastError());
}

// dy, s1, s2: storage type; raw, out: float32; n elements each.
extern "C" int tt_elu_backward(const void* dy, const void* s1, const void* s2, void* raw,
                               void* out, int dtype, long long n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  if (dtype == 1)
    elu_backward_kernel<__nv_bfloat16><<<(int)blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(s1),
        static_cast<const __nv_bfloat16*>(s2), static_cast<float*>(raw),
        static_cast<float*>(out), n);
  else
    elu_backward_kernel<float><<<(int)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(dy), static_cast<const float*>(s1),
        static_cast<const float*>(s2), static_cast<float*>(raw), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
