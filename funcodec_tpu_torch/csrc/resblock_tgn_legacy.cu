// The first resblock_tgn kernel: one block per (time tile, sample), the
// window staged time-major with scalar loads, wmma fragments with fp32 tiles
// in shared memory (or the CUDA cores for fp32 and widths that are not
// multiples of 16). Kept for what the persistent kernels (resblock_tgn.cu)
// are not compiled for, and as their yardstick. See resblock_tgn.cu for what
// the block computes and the rounding points.

#include "resblock_tgn.cuh"

namespace {

using funcodec::Elem;
using funcodec::round_up;

constexpr int THREADS = 256;
constexpr int N_WARPS = THREADS / 32;
constexpr int MAX_C = 256;

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) / 128 * 128; }

__host__ __device__ inline bool tensor_cores(int C, int H, int elem) {
  return elem == 2 && C % 16 == 0 && H % 16 == 0;
}

// The narrow blocks copy their weights into shared memory.
__host__ __device__ inline bool weights_in_smem(int C, int H, int elem) {
  return tensor_cores(C, H, elem) && (C > H ? C : H) <= 64;
}

// Time steps per block.
__host__ __device__ inline int tile_of(int C, int H, int elem) {
  const int tt = (C > H ? C : H) <= 32 ? 128 : 64;
  return elem == 4 ? tt / 2 : tt;
}

// Warps split an (mf x nf) grid of 16x16 tiles: WN = min(nf, 8) columns of
// warps, WM = 8 / WN rows; warp (wm, wn) owns tiles (wm + i*WM, wn + j*WN),
// at most MPW x NPW of them.
__host__ __device__ inline bool warp_grid_fits(int mf, int nf, int mpw, int npw) {
  const int wn = nf < N_WARPS ? nf : N_WARPS, wm = N_WARPS / wn;
  return (mf + wm - 1) / wm <= mpw && (nf + wn - 1) / wn <= npw;
}

// Accumulator tiles per warp (time x channels) that the widest GEMM of a
// block needs: 2 x 1 up to C = 64, 4 x 1 up to 128, 4 x 2 up to 256. The
// fewer, the fewer registers, and the more blocks share an SM.
__host__ __device__ inline int acc_class(int C, int H) {
  const int m = C > H ? C : H;
  return m <= 64 ? 0 : (m <= 128 ? 1 : 2);
}

struct Layout {
  int tt, rows, ldc, ldv, ldo;
  size_t xe, v, out, wts, red, total;  // byte offsets (the raw window at 0) and size
};

// xr / xe: the raw and the ELU'd window, time-major, row w at position
// t0 - left + w; v: the tile of v (TT x H); out: one GEMM's fp32 result
// (TT x N). In mode 2 the normalised conv2 branch (TT x C, x's type)
// reuses xe once conv1 is done.
__host__ __device__ inline Layout layout(int C, int H, int K, int dil, int elem) {
  Layout l;
  l.tt = tile_of(C, H, elem);
  l.rows = l.tt + (K - 1) * dil;
  l.ldc = round_up(C, 16) + 16;
  l.ldv = round_up(H, 16) + 16;
  l.ldo = (C > H ? C : H) + 4;
  const size_t win = align128((size_t)l.rows * l.ldc * elem);
  l.xe = win;
  l.v = l.xe + win;
  l.out = l.v + align128((size_t)l.tt * l.ldv * elem);
  l.wts = l.out + align128((size_t)l.tt * l.ldo * sizeof(float));
  const size_t n_wts = (size_t)H * K * C + (size_t)C * H + (size_t)C * C;  // w1, w2, ws
  l.red = l.wts + (weights_in_smem(C, H, elem) ? align128(n_wts * elem) : 0);
  l.total = l.red + 2 * N_WARPS * sizeof(double);
  return l;
}

// The tensor-core GEMM: acc (TT x N, fp32, in registers) += A (TT x Kd,
// row-major bf16 in shared memory) . W^T, with W^T (Kd x N) read as wmma
// col-major fragments from global memory: element (k, n) at w[n * ldw + k].
template <int MPW, int NPW>
struct WarpGemm {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[MPW][NPW];
  int mf, nf, wm, wn, WM, WN;

  __device__ __forceinline__ void init(int TT, int N) {
    mf = TT / 16;
    nf = N / 16;
    WN = nf < N_WARPS ? nf : N_WARPS;
    WM = N_WARPS / WN;
    const int warp = threadIdx.x / 32;
    wm = warp < WM * WN ? warp / WN : mf;  // a warp left over from the grid idles
    wn = warp % WN;
#pragma unroll
    for (int i = 0; i < MPW; ++i)
#pragma unroll
      for (int j = 0; j < NPW; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);
  }

  __device__ __forceinline__ void mma(const __nv_bfloat16* a, int lda, const __nv_bfloat16* __restrict__ w,
                                      int ldw, int Kd) {
    using namespace nvcuda;
    using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
    if (wm >= mf) return;  // more warp rows than time tiles
    // the weight fragments come from L2: the next step's are loaded before
    // this step's products, so their latency overlaps the tensor-core work
    FragB next[NPW];
#pragma unroll
    for (int j = 0; j < NPW; ++j)
      if (wn + j * WN < nf) wmma::load_matrix_sync(next[j], w + (size_t)(wn + j * WN) * 16 * ldw, ldw);
    for (int k = 0; k < Kd; k += 16) {
      FragB fb[NPW];
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        fb[j] = next[j];
        const int n = wn + j * WN;
        if (n < nf && k + 16 < Kd) wmma::load_matrix_sync(next[j], w + (size_t)n * 16 * ldw + k + 16, ldw);
      }
#pragma unroll
      for (int i = 0; i < MPW; ++i) {
        const int m = wm + i * WM;
        if (m < mf) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, a + m * 16 * lda + k, lda);
#pragma unroll
          for (int j = 0; j < NPW; ++j)
            if (wn + j * WN < nf) wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* out, int ldo) {
#pragma unroll
    for (int i = 0; i < MPW; ++i)
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const int m = wm + i * WM, n = wn + j * WN;
        if (m < mf && n < nf)
          nvcuda::wmma::store_matrix_sync(out + m * 16 * ldo + n * 16, acc[i][j], ldo, nvcuda::wmma::mem_row_major);
      }
  }
};

// out (TT x N) = sum over `taps` of A_k . W_k^T: A_k at a + k * a_step (row-major,
// lda), W_k^T element (c, n) at w[n * ldw + k * w_step + c], c < Kd. Ends
// with a barrier; out may be read by every thread after it.
template <bool TC, int MPW, int NPW, typename T>
__device__ void gemm(float* out, int ldo, const T* a, int lda, int a_step, const T* __restrict__ w, int ldw,
                     int w_step, int taps, int Kd, int TT, int N) {
  if constexpr (TC) {
    WarpGemm<MPW, NPW> g;
    g.init(TT, N);
    for (int k = 0; k < taps; ++k) g.mma(a + k * a_step, lda, w + k * w_step, ldw, Kd);
    g.store(out, ldo);
  } else {
    for (int i = threadIdx.x; i < TT * N; i += THREADS) {
      const int t = i % TT, n = i / TT;
      float s = 0.0f;
      for (int k = 0; k < taps; ++k) {
        const T* ar = a + k * a_step + t * lda;
        const T* wr = w + (size_t)n * ldw + k * w_step;
        for (int c = 0; c < Kd; ++c) s = fmaf(Elem<T>::to_f(ar[c]), Elem<T>::to_f(wr[c]), s);
      }
      out[t * ldo + n] = s;
    }
  }
  __syncthreads();
}

template <typename T, bool TC, int MPW, int NPW>
__global__ void __launch_bounds__(THREADS)
resblock_tgn_kernel(int mode,
                    const T* __restrict__ x,       // (B, C, T)
                    const T* w1,                   // (H, K, C): conv1 as (H, K*C)
                    const float* __restrict__ b1,  // (H)
                    const T* w2,                   // (C, H)
                    const float* __restrict__ b2,  // (C)
                    const T* ws,                   // (C, C)
                    const float* __restrict__ bs,  // (C)
                    const float* __restrict__ aff, // (B, 6, C): A1, D1 (first H), A2, D2, A3, D3
                    double* __restrict__ part,     // (B, n_t, 4) modes 0 and 1
                    T* __restrict__ y,             // (B, C, T) mode 2
                    int C, int H, int T_, int K, int dil, int left, int pad_mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(C, H, K, dil, sizeof(T));
  const int TT = L.tt, ldc = L.ldc, ldv = L.ldv, ldo = L.ldo;
  T* xr = reinterpret_cast<T*>(smem);
  T* xe = reinterpret_cast<T*>(smem + L.xe);
  T* cn = xe;  // mode 2, after conv1: (TT x C), leading dimension ldc
  T* vt = reinterpret_cast<T*>(smem + L.v);
  float* out = reinterpret_cast<float*>(smem + L.out);
  double* red = reinterpret_cast<double*>(smem + L.red);

  const int tile = blockIdx.x, b = blockIdx.y, n_tiles = gridDim.x;
  const int t0 = tile * TT, nt = min(TT, T_ - t0);
  const int right = (K - 1) * dil - left;
  const float* ab = aff + (size_t)b * 6 * C;
  double* pb = part + ((size_t)b * n_tiles + tile) * 4;
  const T* xb = x + (size_t)b * C * T_;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (weights_in_smem(C, H, sizeof(T))) {  // 16-byte copies; C and H are multiples of 16
    T* sw = reinterpret_cast<T*>(smem + L.wts);
    const int n1 = H * K * C, n2 = C * H, n = n1 + n2 + C * C;
    for (int i = threadIdx.x * 8; i < n; i += THREADS * 8) {
      const T* src = i < n1 ? w1 + i : (i < n1 + n2 ? w2 + (i - n1) : ws + (i - n1 - n2));
      *reinterpret_cast<uint4*>(sw + i) = *reinterpret_cast<const uint4*>(src);
    }
    w1 = sw;
    w2 = sw + n1;
    ws = sw + n1 + n2;
  }
  // the window, transposed to time-major: row w is position t0 - left + w
  funcodec::for_window(C, L.rows, xb, T_, t0 - left, -left, T_ + right, pad_mode, [&](int c, int w, float v) {
    xr[w * ldc + c] = Elem<T>::from_f(v);
    xe[w * ldc + c] = Elem<T>::from_f(funcodec::elu(v));
  });
  __syncthreads();

  // b = conv1(ELU(x)): tap k reads the ELU'd window k*dil rows down
  gemm<TC, MPW, NPW, T>(out, ldo, xe, ldc, dil * ldc, w1, K * C, C, K, C, TT, H);

  double s0 = 0.0, s1 = 0.0;
  if (mode == 0) {
    for (int t = warp; t < nt; t += N_WARPS)
      for (int h = lane; h < H; h += 32) {
        const double v = funcodec::round_to<T>(out[t * ldo + h] + b1[h]);
        s0 += v;
        s1 += v * v;
      }
    funcodec::block_sum2(s0, s1, red);
    if (threadIdx.x == 0) {
      pb[0] = s0;
      pb[1] = s1;
    }
  } else {
    // v = ELU(tgn1(b)), rounded
    for (int t = warp; t < TT; t += N_WARPS)
      for (int h = lane; h < H; h += 32) {
        const float bv = funcodec::round_to<T>(out[t * ldo + h] + b1[h]);
        vt[t * ldv + h] = Elem<T>::from_f(funcodec::elu(bv * ab[h] + ab[C + h]));
      }
    __syncthreads();
    gemm<TC, MPW, NPW, T>(out, ldo, vt, ldv, 0, w2, H, 0, 1, H, TT, C);
    if (mode == 1) {
      for (int t = warp; t < nt; t += N_WARPS)
        for (int c = lane; c < C; c += 32) {
          const double v = funcodec::round_to<T>(out[t * ldo + c] + b2[c]);
          s0 += v;
          s1 += v * v;
        }
      funcodec::block_sum2(s0, s1, red);
      if (threadIdx.x == 0) {
        pb[0] = s0;
        pb[1] = s1;
        pb[2] = 0.0;
        pb[3] = 0.0;
      }
      return;
    }
    // mode 2: keep tgn2(c), rounded, while the shortcut is computed
    for (int t = warp; t < TT; t += N_WARPS)
      for (int c = lane; c < C; c += 32) {
        const float cv = funcodec::round_to<T>(out[t * ldo + c] + b2[c]);
        cn[t * ldc + c] = Elem<T>::from_f(cv * ab[2 * C + c] + ab[3 * C + c]);
      }
    __syncthreads();
  }

  // s = shortcut(x): the raw window, `left` rows down
  gemm<TC, MPW, NPW, T>(out, ldo, xr + left * ldc, ldc, 0, ws, C, 0, 1, C, TT, C);

  if (mode == 0) {
    s0 = 0.0;
    s1 = 0.0;
    for (int t = warp; t < nt; t += N_WARPS)
      for (int c = lane; c < C; c += 32) {
        const double v = funcodec::round_to<T>(out[t * ldo + c] + bs[c]);
        s0 += v;
        s1 += v * v;
      }
    funcodec::block_sum2(s0, s1, red);
    if (threadIdx.x == 0) {
      pb[2] = s0;
      pb[3] = s1;
    }
    return;
  }
  T* yb = y + (size_t)b * C * T_;
  for (int c = warp; c < C; c += N_WARPS)
    for (int t = lane; t < nt; t += 32) {
      const float sv = funcodec::round_to<T>(out[t * ldo + c] + bs[c]);
      const float sn = funcodec::round_to<T>(sv * ab[4 * C + c] + ab[5 * C + c]);
      yb[(size_t)c * T_ + t0 + t] = Elem<T>::from_f(Elem<T>::to_f(cn[t * ldc + c]) + sn);
    }
}

template <typename T, bool TC, int MPW, int NPW>
int launch(int mode, const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           const void* ws, const void* bs, const void* aff, void* part, void* y, int B, int C,
           int H, int T_, int K, int dil, int left, int pad_mode, cudaStream_t stream) {
  const Layout L = layout(C, H, K, dil, sizeof(T));
  if (TC && !(warp_grid_fits(L.tt / 16, H / 16, MPW, NPW) && warp_grid_fits(L.tt / 16, C / 16, MPW, NPW)))
    return (int)cudaErrorInvalidConfiguration;  // more tiles than the warps hold
  auto kernel = resblock_tgn_kernel<T, TC, MPW, NPW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_ + L.tt - 1) / L.tt, B);
  kernel<<<grid, THREADS, L.total, stream>>>(
      mode, static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const float*>(b2), static_cast<const T*>(ws),
      static_cast<const float*>(bs), static_cast<const float*>(aff), static_cast<double*>(part),
      static_cast<T*>(y), C, H, T_, K, dil, left, pad_mode);
  return (int)cudaGetLastError();
}


}  // namespace

namespace funcodec {
namespace rb {

int legacy_launch(int mode, const Args& a, int C, int H, int dtype) {
  auto run = [&](auto fn) {
    return fn(mode, a.x, a.w1, a.b1, a.w2, a.b2, a.ws, a.bs, a.aff, a.part, a.y, a.B, C, H, a.T_, a.K, a.dil, a.left,
              a.pad_mode, a.stream);
  };
  if (C > MAX_C || H > MAX_C) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return run(launch<float, false, 1, 1>);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (!tensor_cores(C, H, 2)) return run(launch<__nv_bfloat16, false, 1, 1>);
  if (acc_class(C, H) == 0) return run(launch<__nv_bfloat16, true, 2, 1>);
  if (acc_class(C, H) == 1) return run(launch<__nv_bfloat16, true, 4, 1>);
  return run(launch<__nv_bfloat16, true, 4, 2>);
}

int legacy_tile(int C, int H, int dtype) { return tile_of(C, H, dtype == 0 ? 4 : 2); }

int legacy_smem_bytes(int C, int H, int K, int dil, int dtype) {
  return (int)layout(C, H, K, dil, dtype == 0 ? 4 : 2).total;
}

}  // namespace rb
}  // namespace funcodec
