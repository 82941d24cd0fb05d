// time_group_norm of the SEANet convs outside the residual blocks:
// GroupNorm(1, C) over a sample's channels and every spatial axis,
// y = (x - mean) * rsqrt(var + 1e-5) * gamma[c] + beta[c], in two kernels.
//
// It replaces no TPU kernel: the JAX package's _apply_post_norm
// (funcodec_tpu/ops/conv.py) is plain XLA. It was added because the chain it
// replaces in the port (x.float(), the affine cast to fp32, ATen's group norm,
// .to(x's type)) took ~20 ms of a 70 ms serving batch on the H100: ATen's
// statistics kernel runs one block per (sample, group), 64 blocks on 132 SMs
// each walking a 3 M-element row alone, at ~10 % of HBM bandwidth.
//
// What bounds it: bytes. x is read twice (statistics, apply) and y written
// once, 6 bytes an element in bf16 (12 in fp32); the arithmetic is a few
// operations an element.
//
// The design puts thousands of blocks on the card for every call:
//
// - tgn_stats: a grid of (tile, sample), a tile TILE consecutive elements of
//   the sample's contiguous C * S row (S = T for 1D, F * T for 2D). Each
//   thread holds 64 elements in registers (16-byte loads, read-only, not
//   allocated in L1) and takes its mean and M2 in fp32 by the corrected two
//   passes (with c = sum (x - m) around the fp32 mean m: M2 = sum (x - m)^2 -
//   c^2 / n, the mean m + c / n in fp64); the block combines its
//   threads' (n, mean, M2) in fp64 around the tile's mean in a fixed order,
//   and writes the tile's (mean, M2) to part[sample][tile]. No atomics: the
//   result is the same from run to run. Taking deviations from a local mean
//   keeps a row whose mean is large against its spread exact, as a Welford
//   update does.
// - tgn_apply: a grid of (tile, sample) over the output row. Each thread
//   first issues its loads; meanwhile warp 0 combines the sample's partials
//   (at most a few hundred, in L2) in a fixed order into mean and
//   rstd = 1 / sqrt(M2 / n + 1e-5) in fp64, and the block forms
//   A = rstd * gamma, D = beta - mean * rstd * gamma for the channels its tile
//   spans (fp64, stored as fp32; gamma and beta read in their own type). Then
//   y = fma(x, A[c], D[c]) in fp32, rounded once to x's type, 16-byte stores.
// - A transposed conv's trim: the statistics are over the whole output, as
//   the reference normalises before unpad1d_time; the apply writes only the
//   kept window [left, S - right) of each channel into a contiguous
//   (B, C, S - left - right) tensor. Its reads are then not 16-byte aligned
//   (S is odd, or left is): a thread loads the two aligned vectors around its
//   eight elements and funnel-shifts them into place.
// - Rows whose length is not a whole number of 16-byte vectors (or
//   misaligned pointers) take the same kernels with scalar loads.
//
// ops/tgn_kernel.time_group_norm_reference is the plain version.

#include <algorithm>

#include "common.cuh"

namespace {

using funcodec::Elem;

constexpr int THREADS = 256;
constexpr int PER_THREAD = 64;              // elements a thread takes in a tile
constexpr int TILE = THREADS * PER_THREAD;  // 16,384: a tile of the statistics and of the apply
constexpr int MAX_TABLE = 4096;             // channels an apply tile may span ((A, D) in shared memory)
constexpr double EPS = 1e-5;

// The 16-byte vector of a storage type: N elements in four 32-bit words.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ float get(const uint4& v, int i) {
    return __uint_as_float(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
  }
  static __device__ __forceinline__ uint4 from(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ float get(const uint4& v, int i) {
    const uint32_t w = i < 2 ? v.x : i < 4 ? v.y : i < 6 ? v.z : v.w;
    return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);  // bf16 -> fp32 is exact
  }
  static __device__ __forceinline__ uint32_t pair(float lo, float hi) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  static __device__ __forceinline__ uint4 from(const float (&f)[N]) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]), pair(f[6], f[7]));
  }
};

__device__ __forceinline__ uint4 load_once(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// Sum over the block in a fixed order, returned to every thread.
__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = red[0];
  for (int w = 1; w < THREADS / 32; ++w) s += red[w];
  return s;
}

// Sum over a warp; the xor butterfly adds in the same order on every lane.
__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Elements of statistics tile i of a row.
__device__ __forceinline__ double tile_count(int i, long long row) {
  return (double)min((long long)TILE, row - (long long)i * TILE);
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(THREADS) tgn_stats_kernel(const T* __restrict__ x, long long row,
                                                            double* __restrict__ part, int n_part) {
  __shared__ double red[THREADS / 32];
  const int tile = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long long e0 = (long long)tile * TILE;
  const int n = (int)min((long long)TILE, row - e0);
  const T* xt = x + b * row + e0;

  float sum = 0.0f, mean = 0.0f, c = 0.0f, q = 0.0f;
  int cnt = 0;
  if constexpr (VECTOR) {
    constexpr int N = Vec<T>::N, NV = PER_THREAD / N;
    uint4 v[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if ((tid + j * THREADS) * N < n) v[j] = load_once(xt + (tid + j * THREADS) * N);
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if ((tid + j * THREADS) * N < n) {
#pragma unroll
        for (int i = 0; i < N; ++i) sum += Vec<T>::get(v[j], i);
        cnt += N;
      }
    mean = cnt ? sum / cnt : 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if ((tid + j * THREADS) * N < n) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float d = Vec<T>::get(v[j], i) - mean;
          c += d;
          q = fmaf(d, d, q);
        }
      }
  } else {
    float v[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      v[j] = tid + j * THREADS < n ? Elem<T>::to_f(xt[tid + j * THREADS]) : 0.0f;
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      if (tid + j * THREADS < n) {
        sum += v[j];
        ++cnt;
      }
    mean = cnt ? sum / cnt : 0.0f;
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      if (tid + j * THREADS < n) {
        const float d = v[j] - mean;
        c += d;
        q = fmaf(d, d, q);
      }
  }
  // the thread's M2 and its mean, both corrected by c, the deviations' sum
  const float m2 = cnt ? fmaxf(q - c * c / cnt, 0.0f) : 0.0f;
  const double mean_t = cnt ? (double)mean + (double)c / cnt : 0.0;

  // the tile's mean, then its M2 around it: sum of M2_t + n_t (mean_t - mean)^2
  const double tile_mean = block_sum((double)cnt * mean_t, red) / n;
  const double dm = mean_t - tile_mean;
  const double tile_m2 = block_sum((double)m2 + (double)cnt * dm * dm, red);
  if (tid == 0) {
    part[((size_t)b * n_part + tile) * 2] = tile_mean;
    part[((size_t)b * n_part + tile) * 2 + 1] = tile_m2;
  }
}

__device__ __forceinline__ double param(const void* p, int c, int bf16) {
  return bf16 ? (double)__bfloat162float(static_cast<const __nv_bfloat16*>(p)[c]) : (double)static_cast<const float*>(p)[c];
}

// Elements [k, k + N) of the 32-byte pair (lo, hi), k = SH / sizeof(T).
template <int SH>
__device__ __forceinline__ uint4 funnel(const uint4& lo, const uint4& hi) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  constexpr int q = SH / 4, r = SH % 4;
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = r == 0 ? w[q + j] : __funnelshift_r(w[q + j], w[q + j + 1], 8 * r);
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ uint4 shifted(const uint4& lo, const uint4& hi, int bytes) {
  switch (bytes) {
    case 2: return funnel<2>(lo, hi);
    case 4: return funnel<4>(lo, hi);
    case 6: return funnel<6>(lo, hi);
    case 8: return funnel<8>(lo, hi);
    case 10: return funnel<10>(lo, hi);
    case 12: return funnel<12>(lo, hi);
    case 14: return funnel<14>(lo, hi);
    default: return lo;
  }
}

// MODE 0: scalar loads and stores; 1: 16-byte vectors, the input aligned
// with the output; 2: 16-byte stores, each read from two aligned vectors.
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS) tgn_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                                                            const double* __restrict__ part, int n_part,
                                                            const void* __restrict__ gamma,
                                                            const void* __restrict__ beta, int param_bf16, int C,
                                                            int S, int S_out, int left) {
  extern __shared__ float2 table[];  // (A, D) of channels c_lo, c_lo + 1, ...
  __shared__ double stat[2];
  constexpr int N = MODE == 0 ? 1 : Vec<T>::N, NV = PER_THREAD / N;
  const int tile = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long long row = (long long)C * S, row_out = (long long)C * S_out;
  const int o0 = tile * TILE;
  const int n = (int)min((long long)TILE, row_out - o0);
  const T* xb = x + b * row;

  // 1. this thread's loads, in flight while the statistics are combined
  uint4 lo[MODE == 0 ? 1 : NV], hi[MODE == 2 ? NV : 1];
  float s[MODE == 0 ? PER_THREAD : 1];
  int sh[MODE == 2 ? NV : 1];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int o = o0 + (tid + j * THREADS) * N;
    if (o >= o0 + n) continue;
    const int c = o / S_out;
    const long long i = (long long)c * S + left + (o - c * S_out);
    if constexpr (MODE == 0) {
      s[j] = Elem<T>::to_f(xb[i]);
    } else if constexpr (MODE == 1) {
      lo[j] = __ldg(reinterpret_cast<const uint4*>(xb + i));
    } else {
      const long long g = b * row + i, a = g & ~(long long)(N - 1);  // the aligned vector at or before g
      sh[j] = (int)(g - a) * (int)sizeof(T);
      lo[j] = __ldg(reinterpret_cast<const uint4*>(x + a));
      hi[j] = sh[j] ? __ldg(reinterpret_cast<const uint4*>(x + a + N)) : lo[j];
    }
  }

  // 2. the sample's mean and rstd from its statistics tiles, in a fixed order
  if (tid < 32) {
    const double* pb = part + (size_t)b * n_part * 2;
    double acc = 0.0;
    for (int i = tid; i < n_part; i += 32) acc += tile_count(i, row) * pb[2 * i];
    const double mean = warp_sum(acc) / (double)row;
    acc = 0.0;
    for (int i = tid; i < n_part; i += 32) {
      const double d = pb[2 * i] - mean;
      acc += pb[2 * i + 1] + tile_count(i, row) * d * d;
    }
    const double var = fmax(warp_sum(acc) / (double)row, 0.0);
    if (tid == 0) {
      stat[0] = mean;
      stat[1] = 1.0 / sqrt(var + EPS);
    }
  }
  __syncthreads();
  const int c_lo = o0 / S_out, c_hi = (o0 + n - 1) / S_out;
  for (int c = c_lo + tid; c <= c_hi; c += THREADS) {
    const double a = stat[1] * param(gamma, c, param_bf16);
    table[c - c_lo] = make_float2((float)a, (float)(param(beta, c, param_bf16) - stat[0] * a));
  }
  __syncthreads();

  // 3. y = x * A[c] + D[c], one fma in fp32, rounded once to T
  T* yb = y + b * row_out;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int o = o0 + (tid + j * THREADS) * N;
    if (o >= o0 + n) continue;
    const float2 ad = table[o / S_out - c_lo];
    if constexpr (MODE == 0) {
      yb[o] = Elem<T>::from_f(fmaf(s[j], ad.x, ad.y));
    } else {
      const uint4 v = MODE == 1 ? lo[j] : shifted(lo[j], hi[j], sh[j]);
      float f[N];
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = fmaf(Vec<T>::get(v, i), ad.x, ad.y);
      *reinterpret_cast<uint4*>(yb + o) = Vec<T>::from(f);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const void* x_, void* y_, double* part, const void* gamma, const void* beta, int param_bf16, int B, int C,
           int S, int left, int S_out, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  T* y = static_cast<T*>(y_);
  constexpr int N = Vec<T>::N;
  const long long row = (long long)C * S, row_out = (long long)C * S_out;
  const int n_part = (int)((row + TILE - 1) / TILE), n_out = (int)((row_out + TILE - 1) / TILE);
  const dim3 grid_stats(n_part, B), grid_apply(n_out, B);
  if (aligned16(x) && row % N == 0)
    tgn_stats_kernel<T, true><<<grid_stats, THREADS, 0, stream>>>(x, row, part, n_part);
  else
    tgn_stats_kernel<T, false><<<grid_stats, THREADS, 0, stream>>>(x, row, part, n_part);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t smem = sizeof(float2) * std::min(C, (TILE - 1) / S_out + 2);
  const bool vec_out = aligned16(x) && aligned16(y) && S_out % N == 0;
  const int mode = !vec_out ? 0 : (S % N == 0 && left % N == 0) ? 1 : 2;
  auto args = [&](auto kernel) {
    kernel<<<grid_apply, THREADS, smem, stream>>>(x, y, part, n_part, gamma, beta, param_bf16, C, S, S_out, left);
  };
  if (mode == 0) args(tgn_apply_kernel<T, 0>);
  else if (mode == 1) args(tgn_apply_kernel<T, 1>);
  else args(tgn_apply_kernel<T, 2>);
  return (int)cudaGetLastError();
}

}  // namespace

// time_group_norm of x (B, C, S) (S every spatial axis) into y
// (B, C, S - left - right): the statistics over all of x, the apply over the
// kept window of each channel. x, y in dtype (0 fp32, 1 bf16), gamma and beta
// (C) in param_dtype, part (B, n_part, 2) fp64 scratch with
// n_part = ceil(C * S / TILE); all contiguous, on the current device. Two
// launches on `stream`; returns the first CUDA error.
extern "C" int tgn_norm_launch(const void* x, void* y, void* part, int n_part, const void* gamma, const void* beta,
                               int B, int C, int S, int left, int right, int dtype, int param_dtype, void* stream) {
  if (B <= 0 || B > 65535 || C <= 0 || S <= 0 || left < 0 || right < 0 || left + right >= S || dtype < 0 ||
      dtype > 1 || param_dtype < 0 || param_dtype > 1 || (long long)C * S >= (1LL << 31) ||
      n_part != (int)(((long long)C * S + TILE - 1) / TILE))
    return (int)cudaErrorInvalidValue;
  const int S_out = S - left - right;
  if (std::min(C, (TILE - 1) / S_out + 2) > MAX_TABLE) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* p = static_cast<double*>(part);
  return dtype == 1 ? launch<__nv_bfloat16>(x, y, p, gamma, beta, param_dtype, B, C, S, left, S_out, st)
                    : launch<float>(x, y, p, gamma, beta, param_dtype, B, C, S, left, S_out, st);
}
