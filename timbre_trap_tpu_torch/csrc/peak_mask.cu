// Peak mask of transcription activations, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel timbre_trap_tpu/ops/pallas_kernels.py
// `_kernel` (launched by `peak_mask_pallas`, chosen by ops/peaks.py
// `peak_mask`). One pass with a +-1 row stencil over (B, F, T) float32
// activations: a value is kept where it is a strict vertical local maximum
// (greater than the rows above and below, with zero past the edges), and
// the mask is `kept >= t`, as uint8. The semantics are those of the
// XLA/numpy composition threshold(filter_non_peaks(a), t): a non-peak
// counts as 0, so for t <= 0 it is marked 1, where the Pallas kernel marks
// it 0.
//
// What bounds it: 4 bytes read and 1 byte written per element and a few
// compares, so memory alone; the bound is 5 bytes per element at the card's
// memory rate. The design moves each byte once, in wide operations:
//
// - Tiles. A CTA owns a strip of kThreads * 4 frames and a run of kRun rows
//   of one batch item; grid (frame strips, row runs, batch), so no thread
//   divides a 64-bit index. Each thread walks down its 4 frames of the run,
//   keeping the rows above, at and below the current one in registers: every
//   element is loaded once, plus one halo row at each end of the run (which
//   the neighbouring run also loads, so mostly from L2).
// - Wide memory operations. A float4 load a row where the rows are 16-byte
//   aligned (T and the strides multiples of 4, an aligned base), element
//   loads at the ragged tail; one 32-bit store of 4 mask bytes a row where
//   aligned.
// - Latency. The walk is unrolled by kAhead rows: the loads of the next
//   kAhead rows are issued together before any of them is used.
// - Strides. Planes and rows are read at the caller's strides, so a frame
//   slice of a longer tensor (transcribe trims its concatenated pieces)
//   needs no copy first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // a strip of 512 frames
constexpr int kRun = 32;       // rows per CTA
constexpr int kAhead = 4;      // rows in flight per thread

// Frames [t, t + 4) of one row, zero past t_len.
__device__ __forceinline__ float4 load4(const float* row, int t, int t_len, bool vec) {
  if (vec && t + 4 <= t_len) return __ldcs(reinterpret_cast<const float4*>(row + t));
  float v[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) v[m] = t + m < t_len ? __ldcs(row + t + m) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t keep(float v, float up, float down, float thresh) {
  const float kept = (v > up && v > down) ? v : 0.f;
  return kept >= thresh ? 1u : 0u;
}

__global__ void __launch_bounds__(kThreads) peak_mask_kernel(const float* __restrict__ x,
                                                            uint8_t* __restrict__ out,
                                                            int n_rows, int t_len,
                                                            long long plane_stride,
                                                            long long row_stride,
                                                            float thresh, int vec_in) {
  const int t = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (t >= t_len) return;
  const int f0 = blockIdx.y * kRun;
  const int f1 = min(f0 + kRun, n_rows);
  const float* xb = x + (size_t)blockIdx.z * plane_stride;
  uint8_t* ob = out + (size_t)blockIdx.z * n_rows * t_len;
  const bool vec = vec_in != 0;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 up = f0 > 0 ? load4(xb + (size_t)(f0 - 1) * row_stride, t, t_len, vec) : zero;
  float4 cur = load4(xb + (size_t)f0 * row_stride, t, t_len, vec);
  for (int f = f0; f < f1; f += kAhead) {
    // Rows f + 1 .. f + kAhead: the rows below the next kAhead outputs, up
    // to the run's lower halo row f1 (zero past the last row).
    float4 nx[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int r = f + 1 + u;
      nx[u] = (r <= f1 && r < n_rows) ? load4(xb + (size_t)r * row_stride, t, t_len, vec) : zero;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (f + u < f1) {
        const float4 dn = nx[u];
        const uint32_t m0 = keep(cur.x, up.x, dn.x, thresh);
        const uint32_t m1 = keep(cur.y, up.y, dn.y, thresh);
        const uint32_t m2 = keep(cur.z, up.z, dn.z, thresh);
        const uint32_t m3 = keep(cur.w, up.w, dn.w, thresh);
        uint8_t* o = ob + (size_t)(f + u) * t_len + t;
        if (vec && t + 4 <= t_len) {
          *reinterpret_cast<uint32_t*>(o) = m0 | (m1 << 8) | (m2 << 16) | (m3 << 24);
        } else {
          o[0] = (uint8_t)m0;
          if (t + 1 < t_len) o[1] = (uint8_t)m1;
          if (t + 2 < t_len) o[2] = (uint8_t)m2;
          if (t + 3 < t_len) o[3] = (uint8_t)m3;
        }
        up = cur;
        cur = dn;
      }
    }
  }
}

}  // namespace

// x: (batch, n_rows, t_len) float32, frames contiguous, planes and rows
// plane_stride and row_stride elements apart (a frame slice of a longer
// tensor needs no copy); out: (batch, n_rows, t_len) uint8, contiguous.
// aligned: every row of x and of out starts 16- and 4-byte aligned
// (t_len and both strides % 4 == 0 and aligned bases). batch <= 65535.
// Returns cudaGetLastError() of the launch.
extern "C" int tt_peak_mask(const void* x, void* out, int batch, int n_rows, int t_len,
                            long long plane_stride, long long row_stride, float thresh,
                            int aligned, void* stream) {
  const dim3 grid((t_len + 4 * kThreads - 1) / (4 * kThreads), (n_rows + kRun - 1) / kRun,
                  batch);
  peak_mask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint8_t*>(out), n_rows, t_len, plane_stride,
      row_stride, thresh, aligned);
  return static_cast<int>(cudaGetLastError());
}
