// The first conv1d_s1 kernel (the function is described at the top of
// conv1d_s1.cu): one block per (time tile, output-channel tile, sample).
// Kept for what the redesigned kernels do not take (fp32, channel counts
// that are not multiples of 16, other conv geometries on the thin path) and,
// through variant "legacy", as their yardstick.
//
// Design. Input channels are walked in chunks of 32; for each chunk the
// block copies its input window with the halo into shared memory once (one
// global read per element, the activation applied on load, every pad value
// computed in place by index arithmetic). Two paths:
// - tensor cores (bf16 with at least 16 input and 16 output channels): one
//   block per (128 time steps, 64 output channels, sample), 8 warps. The
//   window is unfolded into an im2col tile in shared memory (shared memory
//   to shared memory) and multiplied with the staged weights by wmma bf16
//   fragments whose fp32 accumulators stay in registers over all chunks.
// - CUDA cores (fp32, and the codec's 1 -> 32 and 32 -> 1 convs): one block
//   per (256 time steps, up to 16 output channels, sample); each thread owns
//   one time step and one fp32 accumulator per output channel (1, 4 or 16,
//   the fewest that cover C_out) and reads the window directly.
// The ragged last tile and ragged channel tiles are masked in the kernel.

#include "conv1d_s1.cuh"

namespace {

using funcodec::Elem;
using funcodec::round_up;

constexpr int THREADS = 256;
constexpr int N_WARPS = THREADS / 32;
constexpr int CC = 32;  // input channels per chunk
// tensor-core path
constexpr int TT = 128;  // time steps per block
constexpr int TO = 64;   // output channels per block
constexpr int LDB = TT + 8;
constexpr int LDO = TT + 4;
constexpr int FPW = (TO / 16) * (TT / 16) / (THREADS / 32);  // fragments per warp
// CUDA-core path
constexpr int TT_S = THREADS;  // one time step per thread
constexpr int TO_S = 16;       // the most output channels per block (accumulators per thread)

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) / 128 * 128; }

struct TcLayout {
  int ldw, kdp, lda;
  size_t bcol, as, total;  // byte offsets; out (fp32) aliases the window and im2col tile
};

__host__ __device__ inline TcLayout tc_layout(int K, int dil) {
  TcLayout l;
  l.ldw = round_up(TT + (K - 1) * dil, 8);
  l.kdp = round_up(K * CC, 16);
  l.lda = l.kdp + 8;
  l.bcol = align128((size_t)CC * l.ldw * 2);
  const size_t tiles = l.bcol + align128((size_t)l.kdp * LDB * 2);
  const size_t out = align128((size_t)TO * LDO * sizeof(float));
  l.as = tiles > out ? tiles : out;
  l.total = l.as + (size_t)TO * l.lda * 2;
  return l;
}

__host__ __device__ inline size_t scalar_smem(int K, int dil, int elem) {
  return align128((size_t)CC * (TT_S + (K - 1) * dil) * elem) + (size_t)TO_S * K * CC * sizeof(float);
}

__global__ void __launch_bounds__(THREADS)
conv1d_s1_tc_kernel(const __nv_bfloat16* __restrict__ x,  // (B, Cin, T)
                    const __nv_bfloat16* __restrict__ w,  // (Cout, K, Cin)
                    const float* __restrict__ bias,       // (Cout)
                    __nv_bfloat16* __restrict__ y,        // (B, Cout, T)
                    int Cin, int Cout, int T_, int K, int dil, int left, int pad_mode, int act) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  const TcLayout L = tc_layout(K, dil);
  T* win = reinterpret_cast<T*>(smem);
  T* bcol = reinterpret_cast<T*>(smem + L.bcol);
  T* as = reinterpret_cast<T*>(smem + L.as);
  float* out = reinterpret_cast<float*>(smem);  // after the last chunk

  const int t0 = blockIdx.x * TT, o0 = blockIdx.y * TO, b = blockIdx.z;
  const int nt = min(TT, T_ - t0), M = min(TO, Cout - o0);
  const int mp = round_up(M, 16), span1 = (K - 1) * dil, right = span1 - left;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T zero = Elem<T>::from_f(0.0f);
  funcodec::TcAcc<FPW> acc;
  acc.zero();

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    const int cc = min(CC, Cin - c0);
    const int kd = K * cc, kdp = round_up(kd, 16);
    __syncthreads();  // the previous chunk's tiles are consumed
    funcodec::stage_window(win, L.ldw, cc, TT + span1, x + ((size_t)b * Cin + c0) * T_, T_, t0 - left,
                           -left, T_ + right, pad_mode, act);
    // weights: as[m][k*cc + c] = w[o0 + m, k, c0 + c]; a full chunk of a
    // layer with Cin % 8 == 0 moves as 16-byte vectors (8 channels)
    if (cc == CC && Cin % 8 == 0) {
      constexpr int V = CC / 8;  // vectors per (m, k) row
      for (int i = threadIdx.x; i < mp * K * V; i += THREADS) {
        const int m = i / (K * V), k = (i / V) % K, v = i % V;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (m < M) val = *reinterpret_cast<const uint4*>(w + ((size_t)(o0 + m) * K + k) * Cin + c0 + v * 8);
        *reinterpret_cast<uint4*>(as + m * L.lda + k * CC + v * 8) = val;
      }
      for (int i = threadIdx.x; i < mp * (kdp - kd); i += THREADS)
        as[(i / (kdp - kd)) * L.lda + kd + i % (kdp - kd)] = zero;
    } else {
      for (int i = threadIdx.x; i < mp * kdp; i += THREADS) {
        const int m = i / kdp, r = i % kdp;
        T v = zero;
        if (m < M && r < kd) v = w[((size_t)(o0 + m) * K + r / cc) * Cin + c0 + r % cc];
        as[m * L.lda + r] = v;
      }
    }
    __syncthreads();
    // im2col: bcol[k*cc + c][t] = win[c][t + k*dil]
    for (int r = warp; r < kdp; r += N_WARPS) {
      const T* src = win + (r % cc) * L.ldw + (r / cc) * dil;
      for (int t = lane; t < TT; t += 32) bcol[r * LDB + t] = r < kd ? src[t] : zero;
    }
    __syncthreads();
    acc.mma(as, L.lda, bcol, LDB, M, kd, TT);
  }
  __syncthreads();  // every warp is done with the window and the im2col tile
  acc.store(out, LDO, M, TT);
  __syncthreads();

  for (int m = warp; m < M; m += N_WARPS) {
    T* ym = y + ((size_t)b * Cout + o0 + m) * T_ + t0;
    for (int t = lane; t < nt; t += 32) ym[t] = Elem<T>::from_f(out[m * LDO + t] + bias[o0 + m]);
  }
}

template <typename T, int OPB>
__global__ void __launch_bounds__(THREADS)
conv1d_s1_scalar_kernel(const T* __restrict__ x,        // (B, Cin, T)
                        const T* __restrict__ w,        // (Cout, K, Cin)
                        const float* __restrict__ bias, // (Cout)
                        T* __restrict__ y,              // (B, Cout, T)
                        int Cin, int Cout, int T_, int K, int dil, int left, int pad_mode, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int span1 = (K - 1) * dil, right = span1 - left, ldw = TT_S + span1;
  T* win = reinterpret_cast<T*>(smem);
  float* ws = reinterpret_cast<float*>(smem + align128((size_t)CC * ldw * sizeof(T)));  // [OPB][K][CC]

  const int t0 = blockIdx.x * TT_S, o0 = blockIdx.y * OPB, b = blockIdx.z;
  const int M = min(OPB, Cout - o0), t = threadIdx.x;
  float acc[OPB];
#pragma unroll
  for (int m = 0; m < OPB; ++m) acc[m] = 0.0f;

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    const int cc = min(CC, Cin - c0);
    __syncthreads();
    funcodec::stage_window(win, ldw, cc, ldw, x + ((size_t)b * Cin + c0) * T_, T_, t0 - left, -left,
                           T_ + right, pad_mode, act);
    for (int i = threadIdx.x; i < OPB * K * cc; i += THREADS) {
      const int mk = i / cc, c = i % cc, m = mk / K;
      ws[mk * CC + c] = m < M ? Elem<T>::to_f(w[((size_t)(o0 + m) * K + mk % K) * Cin + c0 + c]) : 0.0f;
    }
    __syncthreads();
    for (int c = 0; c < cc; ++c) {
      for (int k = 0; k < K; ++k) {
        const float xv = Elem<T>::to_f(win[c * ldw + t + k * dil]);
        const float* wk = ws + k * CC + c;
#pragma unroll
        for (int m = 0; m < OPB; ++m) acc[m] = fmaf(wk[m * K * CC], xv, acc[m]);
      }
    }
  }
  if (t0 + t < T_) {
#pragma unroll
    for (int m = 0; m < OPB; ++m)
      if (m < M) y[((size_t)b * Cout + o0 + m) * T_ + t0 + t] = Elem<T>::from_f(acc[m] + bias[o0 + m]);
  }
}

template <typename Kernel, typename T>
int launch(Kernel kernel, size_t smem, dim3 grid, const void* x, const void* w, const void* bias, void* y,
           int Cin, int Cout, int T_, int K, int dil, int left, int pad_mode, int act, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                          static_cast<const float*>(bias), static_cast<T*>(y), Cin, Cout,
                                          T_, K, dil, left, pad_mode, act);
  return (int)cudaGetLastError();
}

// The CUDA-core kernel with the fewest accumulators per thread that cover Cout.
template <typename T>
int launch_scalar(size_t smem, const void* x, const void* w, const void* bias, void* y, int B, int Cin,
                  int Cout, int T_, int K, int dil, int left, int pad_mode, int act, cudaStream_t s) {
  const int opb = Cout <= 1 ? 1 : (Cout <= 4 ? 4 : TO_S);
  const dim3 grid((T_ + TT_S - 1) / TT_S, (Cout + opb - 1) / opb, B);
  auto kernel = opb == 1 ? conv1d_s1_scalar_kernel<T, 1>
                : (opb == 4 ? conv1d_s1_scalar_kernel<T, 4> : conv1d_s1_scalar_kernel<T, TO_S>);
  return launch<decltype(kernel), T>(kernel, smem, grid, x, w, bias, y, Cin, Cout, T_, K, dil, left, pad_mode,
                                     act, s);
}

bool use_tensor_cores(int Cin, int Cout, int dtype) { return dtype == 1 && Cin >= 16 && Cout >= 16; }

size_t smem_bytes(int Cin, int Cout, int K, int dil, int dtype) {
  if (use_tensor_cores(Cin, Cout, dtype)) return tc_layout(K, dil).total;
  return scalar_smem(K, dil, dtype == 1 ? 2 : 4);
}

}  // namespace

namespace funcodec {
namespace conv {

int legacy_launch(const void* x, const void* w, const void* bias, void* y, int B, int Cin, int Cout, int T_, int K,
                  int dil, int left, int pad_mode, int act, int dtype, cudaStream_t s) {
  const size_t smem = smem_bytes(Cin, Cout, K, dil, dtype);
  if (use_tensor_cores(Cin, Cout, dtype)) {
    const dim3 grid((T_ + TT - 1) / TT, (Cout + TO - 1) / TO, B);
    return launch<decltype(&conv1d_s1_tc_kernel), __nv_bfloat16>(
        conv1d_s1_tc_kernel, smem, grid, x, w, bias, y, Cin, Cout, T_, K, dil, left, pad_mode, act, s);
  }
  if (dtype == 1)
    return launch_scalar<__nv_bfloat16>(smem, x, w, bias, y, B, Cin, Cout, T_, K, dil, left, pad_mode, act, s);
  return launch_scalar<float>(smem, x, w, bias, y, B, Cin, Cout, T_, K, dil, left, pad_mode, act, s);
}

int legacy_smem_bytes(int Cin, int Cout, int K, int dil, int dtype) { return (int)smem_bytes(Cin, Cout, K, dil, dtype); }

}  // namespace conv
}  // namespace funcodec
