// Banded conv stage on the packed f-major layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel timbre_trap_tpu/ops/fused_level.py
// `_level_kernel` (launched by `_pallas_fwd_call`). The Pallas kernel runs a
// whole chain of conv items per time tile inside one 100 MB VMEM budget; an
// SM has 227 KB, so here every conv stage is one launch (the wrapper loops
// over the chain's items) and the intermediates stay in device memory / L2
// at their exact (B, R, T) shape.
//
// One stage computes, for each 128-row output block j and column t,
//
//   y[j*128 + r, t] = epi( bias[r] + sum_dt sum_k W_dt[k, r] * x[j*col_adv - margin + k, t + dt] )
//
// where reads at a row outside [0, r_in) or a column outside [0, T) return 0.
// That is the SAME/VALID semantics of the zero-margined slab of the Pallas
// kernel, with no padded copy; and since no column outside [0, T) is ever
// stored, the Pallas kernel's `col_ok` re-zeroing between items has nothing
// left to do. The epilogue adds the bias (the repeating 128-row pattern, or
// the full per-block vector of a dense bridge item), applies ELU written as
// the JAX package writes it, exp(min(v, 0)) - 1, and for the second conv of
// a residual item adds the item's input rows. Dense bridge items
// (`per_block`) use col_adv = 0 and give every output block its own weight
// slice.
//
// Weights arrive transposed, W[dt][k][rows] (rows fastest), so a CTA's
// 128-row weight slice for one input row is contiguous. This is the float32
// route (IEEE fp32 with plain FFMA, no TF32); bfloat16 storage runs the
// band-tiled tensor-core kernel of band_mma.cu. What bounds it: the stage
// is a banded matrix product of ~2·n_dt·128·K flops per output block
// column, far above the card's bytes-per-flop line, so it is bound by
// arithmetic; it stages a KC x 128 weight tile and a KC x 64 input tile
// through shared memory and keeps an 8 x 4 register tile per thread.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockRows = 128;
constexpr int kTileT = 64;
constexpr int kKc = 32;
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kRowsPerThread = 8;
constexpr int kColsPerThread = 4;

struct StageArgs {
  const float* x;     // (B, r_in, T)
  const float* w;     // (n_dt, k, w_rows)
  const float* bias;  // (128,) or (w_rows,) when per_block
  const float* res;   // (B, r_out, T) or null
  float* y;           // (B, r_out, T)
  int r_in, r_out, t_len;
  int n_dt, dt0, dt1, dt2;
  int k, col_adv, margin, w_rows, per_block, act;
};

__global__ void __launch_bounds__(kThreads)
banded_conv_kernel(const StageArgs a) {
  __shared__ __align__(16) float ws[kKc][kBlockRows];
  __shared__ __align__(16) float xs[kKc][kTileT];

  const int t0 = blockIdx.x * kTileT;
  const int j = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const float* x = a.x + (size_t)b * a.r_in * a.t_len;
  const float* w = a.w;
  const int w_row0 = a.per_block ? j * kBlockRows : 0;
  const int in_row0 = j * a.col_adv - a.margin;

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[i][c] = 0.f;

  for (int di = 0; di < a.n_dt; ++di) {
    const int dt = di == 0 ? a.dt0 : (di == 1 ? a.dt1 : a.dt2);
    const float* wd = w + (size_t)di * a.k * a.w_rows + w_row0;
    for (int k0 = 0; k0 < a.k; k0 += kKc) {
      for (int i = tid; i < kKc * kBlockRows; i += kThreads) {
        const int kk = i / kBlockRows;
        const int r = i % kBlockRows;
        const int kg = k0 + kk;
        ws[kk][r] = kg < a.k ? wd[(size_t)kg * a.w_rows + r] : 0.f;
      }
      for (int i = tid; i < kKc * kTileT; i += kThreads) {
        const int kk = i / kTileT;
        const int c = i % kTileT;
        const int row = in_row0 + k0 + kk;
        const int col = t0 + c + dt;
        float v = 0.f;
        if (k0 + kk < a.k && row >= 0 && row < a.r_in && col >= 0 && col < a.t_len)
          v = x[(size_t)row * a.t_len + col];
        xs[kk][c] = v;
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
          for (int c = 0; c < kColsPerThread; ++c)
            acc[i][c] = fmaf(wr[i], xc[c], acc[i][c]);
      }
      __syncthreads();
    }
  }

  const size_t out_base = (size_t)b * a.r_out * a.t_len;
  const float* res = a.res;
  float* y = a.y;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty * kRowsPerThread + i;
    const int row = j * kBlockRows + r;
    if (row >= a.r_out) continue;
    const float bias = a.bias[a.per_block ? row : r];
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const int col = t0 + tx * kColsPerThread + c;
      if (col >= a.t_len) continue;
      const size_t o = out_base + (size_t)row * a.t_len + col;
      float v = acc[i][c] + bias;
      if (a.act) v = v > 0.f ? v : expf(fminf(v, 0.f)) - 1.f;
      if (res != nullptr) v += res[o];
      y[o] = v;
    }
  }
}

}  // namespace

// All tensors float32. Returns cudaGetLastError() of the launch.
extern "C" int tt_banded_conv(const void* x, const void* w, const void* bias,
                              const void* res, void* y, int batch,
                              int r_in, int r_out, int t_len, int n_dt,
                              int dt0, int dt1, int dt2, int k, int col_adv,
                              int margin, int w_rows, int per_block, int act,
                              void* stream) {
  StageArgs a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.res = static_cast<const float*>(res);
  a.y = static_cast<float*>(y);
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
  a.w_rows = w_rows;
  a.per_block = per_block;
  a.act = act;
  const dim3 grid((t_len + kTileT - 1) / kTileT, (r_out + kBlockRows - 1) / kBlockRows, batch);
  banded_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
