// Device helpers shared by the SEANet kernels (conv1d_s1.cu, resblock_tgn.cu).
//
// - Elem<T>: fp32 <-> storage-type conversion (bf16 rounds to nearest even).
// - pad_index: the streamable conv's reflect / replicate / zero pad as index
//   arithmetic, so no pad buffer is materialised.
// - act_fn: the activations a fused conv may apply on load, in fp32.
// - for_window / stage_window: a tile of x with its halo, pad values and
//   activation applied, copied once into shared memory.
// - TcAcc: a block-level GEMM tile Out[M][N] = sum A[M][Kd] . B[Kd][N] on the
//   tensor cores (nvcuda::wmma bf16 fragments, 16x16x16, fp32 accumulators
//   held in registers across the Kd chunks).
// - block_sum2: a block-wide fp64 sum of two values.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
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

// fp32 value rounded through the storage type (identity for fp32)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return Elem<T>::to_f(Elem<T>::from_f(v));
}

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

// Calls store(c, w, v) for c < rows, w < width with v = x[c][pad_index(p0 + w)]
// in fp32, or zero where p0 + w lies outside [p_lo, p_hi) (past the halo of
// the ragged last tile) or in a zero pad. Row c of x starts at xc + c * T_.
// A warp takes a row and its lanes neighbouring time steps; a window of
// fewer rows than warps is spread over all threads instead.
template <typename T, typename Store>
__device__ __forceinline__ void for_window(int rows, int width, const T* __restrict__ xc, int T_, int p0,
                                           int p_lo, int p_hi, int pad_mode, Store store) {
  auto value = [&](const T* xr, int w) {
    const int p = p0 + w;
    if (p < p_lo || p >= p_hi) return 0.0f;
    const int src = pad_index(p, T_, pad_mode);
    return src >= 0 ? Elem<T>::to_f(xr[src]) : 0.0f;
  };
  const int n_warps = blockDim.x / 32;
  if (rows < n_warps) {
    for (int i = threadIdx.x; i < rows * width; i += blockDim.x)
      store(i / width, i % width, value(xc + (size_t)(i / width) * T_, i % width));
    return;
  }
  for (int c = threadIdx.x / 32; c < rows; c += n_warps) {
    const T* xr = xc + (size_t)c * T_;
#pragma unroll 4
    for (int w = threadIdx.x % 32; w < width; w += 32) store(c, w, value(xr, w));
  }
}

// win[c][w] = round(act(x[c][pad_index(p0 + w)])): the window with its halo,
// pad values and activation applied (see for_window).
template <typename T>
__device__ __forceinline__ void stage_window(T* win, int ldw, int rows, int width, const T* __restrict__ xc,
                                             int T_, int p0, int p_lo, int p_hi, int pad_mode, int act) {
  for_window(rows, width, xc, T_, p0, p_lo, p_hi, pad_mode,
             [&](int c, int w, float v) { win[c * ldw + w] = Elem<T>::from_f(act_fn(v, act)); });
}

// The tensor-core GEMM tile. The M x N output is cut into 16 x 16
// fragments; warp w owns fragments w, w + n_warps, ... (at most FPW of
// them), whose fp32 accumulators stay in registers across mma() calls.
// Operands are bf16 in shared memory, row-major, 32-byte aligned, with
// leading dimensions that are multiples of 8; A must be readable for
// round_up(M, 16) rows, A's columns and B's rows zero from Kd up to
// round_up(Kd, 16), and N % 16 == 0. The caller guarantees that the tile
// has at most FPW * n_warps fragments.
template <int FPW>
struct TcAcc {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[FPW];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < FPW; ++i) nvcuda::wmma::fill_fragment(f[i], 0.0f);
  }

  __device__ __forceinline__ void mma(const __nv_bfloat16* a, int lda, const __nv_bfloat16* b, int ldb,
                                      int M, int Kd, int N) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32, n_warps = blockDim.x / 32;
    const int nf = N / 16, n_frag = (M + 15) / 16 * nf, kf = (Kd + 15) / 16;
#pragma unroll
    for (int i = 0; i < FPW; ++i) {
      const int id = warp + i * n_warps;
      if (id < n_frag) {
        const int m0 = (id / nf) * 16, n0 = (id % nf) * 16;
        for (int k = 0; k < kf; ++k) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, a + m0 * lda + k * 16, lda);
          wmma::load_matrix_sync(fb, b + k * 16 * ldb + n0, ldb);
          wmma::mma_sync(f[i], fa, fb, f[i]);
        }
      }
    }
  }

  // out[m][n] = the accumulators (ldo a multiple of 4, out 32-byte aligned)
  __device__ __forceinline__ void store(float* out, int ldo, int M, int N) {
    const int warp = threadIdx.x / 32, n_warps = blockDim.x / 32;
    const int nf = N / 16, n_frag = (M + 15) / 16 * nf;
#pragma unroll
    for (int i = 0; i < FPW; ++i) {
      const int id = warp + i * n_warps;
      if (id < n_frag) {
        const int m0 = (id / nf) * 16, n0 = (id % nf) * 16;
        nvcuda::wmma::store_matrix_sync(out + m0 * ldo + n0, f[i], ldo, nvcuda::wmma::mem_row_major);
      }
    }
  }
};

// Sum of (a, b) over the block, in fp64; the result is valid in thread 0.
// `red` holds 2 * (blockDim.x / 32) doubles.
__device__ __forceinline__ void block_sum2(double& a, double& b, double* red) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) {
    red[2 * warp] = a;
    red[2 * warp + 1] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < n_warps; ++w) {
      a += red[2 * w];
      b += red[2 * w + 1];
    }
  }
}

}  // namespace funcodec
