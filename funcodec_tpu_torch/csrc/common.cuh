// Device helpers shared by the SEANet kernels (conv1d_s1*.cu, resblock_tgn*.cu,
// tgn_norm.cu).
//
// - Elem<T>: fp32 <-> storage-type conversion (bf16 rounds to nearest even).
// - pad_index: the streamable conv's reflect / replicate / zero pad as index
//   arithmetic, so no pad buffer is materialised.
// - act_fn: the activations a fused conv may apply on load, in fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace funcodec {

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) { return __float2bfloat16_rn(v); }
};

enum PadMode { PAD_REFLECT = 0, PAD_REPLICATE = 1, PAD_ZERO = 2 };
enum Act { ACT_NONE = 0, ACT_ELU = 1, ACT_RELU = 2, ACT_GELU = 3 };

// Source index of padded position p (p may lie in [-left, T + right)), or
// -1 for a zero pad value. Reflect mirrors without repeating the edge sample;
// the wrappers guarantee T > max(left, right), so one reflection suffices.
__device__ __forceinline__ int pad_index(int p, int T, int mode) {
  if (p >= 0 && p < T) return p;
  if (mode == PAD_REFLECT) return p < 0 ? -p : 2 * (T - 1) - p;
  if (mode == PAD_REPLICATE) return p < 0 ? 0 : T - 1;
  return -1;
}

// ELU(alpha=1) as the JAX kernels write it: exp(min(x, 0)) - 1 below zero.
__device__ __forceinline__ float elu(float v) { return v > 0.0f ? v : expf(fminf(v, 0.0f)) - 1.0f; }

__device__ __forceinline__ float act_fn(float v, int act) {
  switch (act) {
    case ACT_ELU:
      return elu(v);
    case ACT_RELU:
      return fmaxf(v, 0.0f);
    case ACT_GELU: {  // tanh approximation (jax.nn.gelu's default)
      const float k = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * v * (1.0f + tanhf(k * (v + 0.044715f * v * v * v)));
    }
    default:
      return v;
  }
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

}  // namespace funcodec
