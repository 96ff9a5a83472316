// The ELU' seed of the level backward (K3) on the packed f-major layout,
// for Hopper (sm_90a).
//
// Part of the replacement of the Pallas TPU kernel
// timbre_trap_tpu/ops/fused_level.py `_level_bwd_kernel` (launched by
// `_pallas_bwd_call`, wrapped as a custom VJP by `make_fused_level_train`).
// The Pallas kernel runs a whole level's VJP per time tile inside one
// 100 MB VMEM budget: it recomputes the forward, walks the items in
// reverse, and carries the dW/dBias sums in accumulators that persist
// across its sequential grid. An SM has 227 KB and CUDA blocks run in no
// order, so here the backward runs stage by stage on exact (B, R, T)
// tensors in device memory; the wrapper (ops/fused_level.py:level_backward)
// recomputes the level through K1, keeps each item's input and each
// residual block's conv1 activation, and orders the launches. The dX and
// dW products, in both storage dtypes, are the band-tiled tensor-core
// kernels of band_mma.cu; this file holds the one elementwise pass that
// starts a level's backward, for both dtypes:
//
//   tt_elu_backward   the cotangent of the level's last item:
//                       out = f32(dy) * ELU'(s1 - s2),  raw = f32(dy)
//                     with ELU' rebuilt from stored outputs (1 where
//                     y > 0, else y + 1, y = s1 - s2).
//
// What bounds it: one multiply an element against 2-4 bytes read per input
// and 4 written per output, so it is bound by its bytes; a grid-stride loop
// over at most 16 CTAs an SM, neighbouring threads on neighbouring
// elements, reads each input once and writes each output once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// ELU'(z) from y = ELU(z): 1 where y > 0, else exp(z) = y + 1.
__device__ __forceinline__ float elu_grad_from_out(float y) { return y > 0.f ? 1.f : y + 1.f; }

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

// dy, s1, s2: storage type, dtype 0 = float32, 1 = bfloat16; raw, out:
// float32; n elements each. Returns cudaGetLastError() after the launch.
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
