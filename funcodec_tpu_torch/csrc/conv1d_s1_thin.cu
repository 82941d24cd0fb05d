// The thin kernels of the fused stride-1 conv: one input or one output
// channel, bf16, on the CUDA cores (the design is described at the top of
// conv1d_s1.cu).

#include "conv1d_s1.cuh"
#include "resblock_tgn.cuh"

namespace funcodec {
namespace conv {
namespace {

using namespace funcodec::rb;  // bf16, THREADS, pad_value, pack_bf, unpack_bf, round_bf

constexpr int STEPS = 8;                    // time steps a thread: one 16-byte vector
constexpr int WARP_STEPS = 32 * STEPS;      // 256 a warp
constexpr int THIN_TILE = THREADS * STEPS;  // 2048 a block
constexpr int THIN_MAX_CH = 2048;           // the wide side's channels (weights in shared memory)
constexpr int ACT_ANY = -1;                 // the act chosen at run time

// act(v) rounded to bf16 (v is a bf16 value, so ACT_NONE needs no rounding)
template <int ACT>
__device__ __forceinline__ float act_round(float v, int act) {
  if constexpr (ACT == ACT_NONE)
    return v;
  else if constexpr (ACT == ACT_ELU)
    return round_bf(funcodec::elu(v));
  else
    return round_bf(funcodec::act_fn(v, act));
}

// x at padded position p of row xr (pad values; zero past the halo), not yet activated
__device__ __forceinline__ float raw_value(const bf16* __restrict__ xr, int p, int T_, int left, int right,
                                           int pad_mode) {
  return __bfloat162float(pad_value(xr, p, T_, left, right, pad_mode));
}

// The warp's halo before activation: lane l < left + right holds step
// wt0 - left + l (l < left) or wt0 + 256 + l - left, the others zero.
__device__ __forceinline__ float raw_edge(const bf16* __restrict__ xr, int wt0, int T_, int left, int right,
                                          int pad_mode) {
  const int lane = threadIdx.x & 31;
  if (lane >= left + right) return 0.0f;
  const int p = lane < left ? wt0 - left + lane : wt0 + WARP_STEPS + lane - left;
  return raw_value(xr, p, T_, left, right, pad_mode);
}

// The thread's 8 activated values of row xr from step t0: from the vector u
// where the row is aligned and the 8 steps lie inside it (vec), else by
// scalar loads with the pad values.
template <int ACT>
__device__ __forceinline__ void own_values(float (&v)[STEPS], uint4 u, bool vec, const bf16* __restrict__ xr, int t0,
                                           int T_, int left, int right, int pad_mode, int act) {
  if (vec) {
    const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack_bf(w4[i]);
      v[2 * i] = act_round<ACT>(f.x, act);
      v[2 * i + 1] = act_round<ACT>(f.y, act);
    }
  } else {
#pragma unroll
    for (int i = 0; i < STEPS; ++i) v[i] = act_round<ACT>(raw_value(xr, t0 + i, T_, left, right, pad_mode), act);
  }
}

// The lane's window: win[j] = act(x) at step t0 - LEFT + j, j < 8 + LEFT + RIGHT.
// The halo comes from the neighbouring lanes; lanes 0 and 31 take the warp's
// halo e (raw_edge, activated). Every lane of the warp must call this.
template <int LEFT, int RIGHT>
__device__ __forceinline__ void window(float (&win)[STEPS + LEFT + RIGHT], const float (&v)[STEPS], float e) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < LEFT; ++j) {
    const float prev = __shfl_up_sync(0xffffffffu, v[STEPS - LEFT + j], 1);
    const float edge = __shfl_sync(0xffffffffu, e, j);
    win[j] = lane == 0 ? edge : prev;
  }
#pragma unroll
  for (int i = 0; i < STEPS; ++i) win[LEFT + i] = v[i];
#pragma unroll
  for (int j = 0; j < RIGHT; ++j) {
    const float next = __shfl_down_sync(0xffffffffu, v[j], 1);
    const float edge = __shfl_sync(0xffffffffu, e, LEFT + j);
    win[LEFT + STEPS + j] = lane == 31 ? edge : next;
  }
}

// 8 sums + bias, rounded, to y row yr from step t0
__device__ __forceinline__ void store8(bf16* __restrict__ yr, int t0, int T_, bool vec, const float (&acc)[STEPS],
                                       float bias) {
  if (vec) {
    uint4 u;
    u.x = pack_bf(acc[0] + bias, acc[1] + bias);
    u.y = pack_bf(acc[2] + bias, acc[3] + bias);
    u.z = pack_bf(acc[4] + bias, acc[5] + bias);
    u.w = pack_bf(acc[6] + bias, acc[7] + bias);
    *reinterpret_cast<uint4*>(yr + t0) = u;
  } else {
#pragma unroll
    for (int i = 0; i < STEPS; ++i)
      if (t0 + i < T_) yr[t0 + i] = __float2bfloat16_rn(acc[i] + bias);
  }
}

// 1 -> Cout. w (Cout, K, 1), grid (ceil(T / 2048), B).
template <int K, int LEFT>
__global__ void __launch_bounds__(THREADS)
conv1d_s1_thin_in1(const bf16* __restrict__ x, const bf16* __restrict__ w, const float* __restrict__ bias,
                   bf16* __restrict__ y, int Cout, int T_, int pad_mode, int act) {
  constexpr int RIGHT = K - 1 - LEFT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // [Cout][K]
  float* bs = ws + Cout * K;
  for (int i = threadIdx.x; i < Cout * K; i += THREADS) ws[i] = __bfloat162float(w[i]);
  for (int i = threadIdx.x; i < Cout; i += THREADS) bs[i] = bias[i];
  __syncthreads();
  const int b = blockIdx.y;
  const int wt0 = blockIdx.x * THIN_TILE + (threadIdx.x >> 5) * WARP_STEPS;
  const int t0 = wt0 + (threadIdx.x & 31) * STEPS;
  const bool vec = T_ % STEPS == 0 && t0 + STEPS <= T_;
  const bf16* xr = x + (size_t)b * T_;
  float v[STEPS], win[STEPS + K - 1];
  const uint4 u = vec ? __ldg(reinterpret_cast<const uint4*>(xr + t0)) : make_uint4(0u, 0u, 0u, 0u);
  own_values<ACT_ANY>(v, u, vec, xr, t0, T_, LEFT, RIGHT, pad_mode, act);
  window<LEFT, RIGHT>(win, v, act_round<ACT_ANY>(raw_edge(xr, wt0, T_, LEFT, RIGHT, pad_mode), act));
  if (t0 >= T_) return;
  bf16* yb = y + (size_t)b * Cout * T_;
  for (int o = 0; o < Cout; ++o) {
    float acc[STEPS];
#pragma unroll
    for (int i = 0; i < STEPS; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float wk = ws[o * K + k];
#pragma unroll
      for (int i = 0; i < STEPS; ++i) acc[i] = fmaf(wk, win[i + k], acc[i]);
    }
    store8(yb + (size_t)o * T_, t0, T_, vec, acc, bs[o]);
  }
}

// Cin -> 1. w (1, K, Cin), grid (ceil(T / 2048), B), MINB blocks an SM. The
// load of the next channel is issued before the current one is computed.
template <int K, int LEFT, int ACT, int MINB = 4>
__global__ void __launch_bounds__(THREADS, MINB)
conv1d_s1_thin_out1(const bf16* __restrict__ x, const bf16* __restrict__ w, const float* __restrict__ bias,
                    bf16* __restrict__ y, int Cin, int T_, int pad_mode, int act) {
  constexpr int RIGHT = K - 1 - LEFT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // [Cin][K]
  for (int i = threadIdx.x; i < Cin * K; i += THREADS) ws[(i % Cin) * K + i / Cin] = __bfloat162float(w[i]);
  __syncthreads();
  const int b = blockIdx.y;
  const int wt0 = blockIdx.x * THIN_TILE + (threadIdx.x >> 5) * WARP_STEPS;
  const int t0 = wt0 + (threadIdx.x & 31) * STEPS;
  const bool vec = T_ % STEPS == 0 && t0 + STEPS <= T_;
  const bf16* xb = x + (size_t)b * Cin * T_;
  auto row = [&](int c) { return xb + (size_t)c * T_; };
  uint4 nu = make_uint4(0u, 0u, 0u, 0u);
  float ne;
  auto fetch = [&](int c) {
    if (vec) nu = __ldg(reinterpret_cast<const uint4*>(row(c) + t0));
    ne = raw_edge(row(c), wt0, T_, LEFT, RIGHT, pad_mode);
  };
  float acc[STEPS];
#pragma unroll
  for (int i = 0; i < STEPS; ++i) acc[i] = 0.0f;
  fetch(0);
  for (int c = 0; c < Cin; ++c) {
    const uint4 cu = nu;
    const float ce = ne;
    if (c + 1 < Cin) fetch(c + 1);
    float v[STEPS], win[STEPS + K - 1];
    own_values<ACT>(v, cu, vec, row(c), t0, T_, LEFT, RIGHT, pad_mode, act);
    window<LEFT, RIGHT>(win, v, act_round<ACT>(ce, act));
    const float* wc = ws + c * K;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float wk = wc[k];
#pragma unroll
      for (int i = 0; i < STEPS; ++i) acc[i] = fmaf(wk, win[i + k], acc[i]);
    }
  }
  if (t0 < T_) store8(y + (size_t)b * T_, t0, T_, vec, acc, bias[0]);
}

template <typename Kernel>
int launch_k(Kernel kernel, dim3 grid, unsigned smem, cudaStream_t s, const void* x, const void* w, const void* bias,
             void* y, int C, int T_, int pad_mode, int act) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, s>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                                     static_cast<const float*>(bias), static_cast<bf16*>(y), C, T_, pad_mode, act);
  return (int)cudaGetLastError();
}

template <int K, int LEFT>
int thin_launch_k(const void* x, const void* w, const void* bias, void* y, int B, int Cin, int Cout, int T_,
                  int pad_mode, int act, cudaStream_t s) {
  const dim3 grid((T_ + THIN_TILE - 1) / THIN_TILE, B);
  const unsigned smem = thin_smem(Cin, Cout, K);
  if (Cin == 1) return launch_k(conv1d_s1_thin_in1<K, LEFT>, grid, smem, s, x, w, bias, y, Cout, T_, pad_mode, act);
  if (act == ACT_NONE)
    return launch_k(conv1d_s1_thin_out1<K, LEFT, ACT_NONE>, grid, smem, s, x, w, bias, y, Cin, T_, pad_mode, act);
  if (act == ACT_ELU)  // six blocks an SM: more loads in flight to cover the ELU's issue time
    return launch_k(conv1d_s1_thin_out1<K, LEFT, ACT_ELU, 6>, grid, smem, s, x, w, bias, y, Cin, T_, pad_mode, act);
  return launch_k(conv1d_s1_thin_out1<K, LEFT, ACT_ANY>, grid, smem, s, x, w, bias, y, Cin, T_, pad_mode, act);
}

}  // namespace

bool thin_applies(int Cin, int Cout, int K, int dil, int left) {
  if (!(Cin == 1 || Cout == 1) || dil != 1 || Cin > THIN_MAX_CH || Cout > THIN_MAX_CH) return false;
  if (K != 3 && K != 5 && K != 7) return false;
  return left == (K - 1) - (K - 1) / 2 || left == K - 1;  // "same" (odd sample left) or causal
}

unsigned thin_smem(int Cin, int Cout, int K) {
  return Cin == 1 ? (unsigned)(Cout * K + Cout) * 4u : (unsigned)(Cin * K) * 4u;
}

int thin_launch(const void* x, const void* w, const void* bias, void* y, int B, int Cin, int Cout, int T_, int K,
                int left, int pad_mode, int act, cudaStream_t s) {
  const bool causal = left == K - 1;
  if (K == 3)
    return causal ? thin_launch_k<3, 2>(x, w, bias, y, B, Cin, Cout, T_, pad_mode, act, s)
                  : thin_launch_k<3, 1>(x, w, bias, y, B, Cin, Cout, T_, pad_mode, act, s);
  if (K == 5)
    return causal ? thin_launch_k<5, 4>(x, w, bias, y, B, Cin, Cout, T_, pad_mode, act, s)
                  : thin_launch_k<5, 2>(x, w, bias, y, B, Cin, Cout, T_, pad_mode, act, s);
  if (K == 7)
    return causal ? thin_launch_k<7, 6>(x, w, bias, y, B, Cin, Cout, T_, pad_mode, act, s)
                  : thin_launch_k<7, 3>(x, w, bias, y, B, Cin, Cout, T_, pad_mode, act, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace conv
}  // namespace funcodec
