// Shared by the persistent resblock kernels (resblock_tgn.cu: weights
// resident in shared memory; resblock_tgn_streamed.cu: weights streamed
// through a ring) and their host side: PTX wrappers (cp.async, ldmatrix,
// stmatrix, mma.sync.m16n8k16), the window load and its pad fix-up, the
// transposing ELU pass, the register epilogues, and the launch on a
// persistent grid. The design is described at the top of resblock_tgn.cu.

#pragma once

#include "common.cuh"

namespace funcodec {
namespace rb {

using bf16 = __nv_bfloat16;


constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned MAX_SMEM = 232448;  // 227 KB a block

__host__ __device__ inline unsigned align128(unsigned v) { return (v + 127u) / 128u * 128u; }

// ---- PTX ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// four 8x8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of matrix i,
// thread (g = lane / 4, q = lane % 4) gets elements (g, 2q), (g, 2q + 1) of each
__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// the same, transposed: the thread gets elements (2q, g), (2q + 1, g)
__device__ __forceinline__ void ldsm4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void stsm4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r[0]),
               "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float round_bf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ uint32_t pack_bf(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t elu_bf16x2(uint32_t u) {
  const float2 f = unpack_bf(u);
  return pack_bf(funcodec::elu(f.x), funcodec::elu(f.y));
}

// x at padded position p of a row, or zero outside [-left, T + right) and in a zero pad
__device__ __forceinline__ bf16 pad_value(const bf16* __restrict__ xr, int p, int T_, int left, int right,
                                          int pad_mode) {
  if (p < -left || p >= T_ + right) return __float2bfloat16_rn(0.0f);
  const int src = funcodec::pad_index(p, T_, pad_mode);
  return src >= 0 ? xr[src] : __float2bfloat16_rn(0.0f);
}

// acc (16*MT x N) += A . B^T over 16 columns of k: A fragments a[mt], B rows
// (n-major, k contiguous) at b_addr + n * ldb bytes (the lane's ldmatrix address)
template <int MT, int N>
__device__ __forceinline__ void mma_step(float (&acc)[MT][N / 8][4], const uint32_t (&a)[MT][4], uint32_t b_addr,
                                         int ldb_bytes) {
#pragma unroll
  for (int jp = 0; jp < N / 16; ++jp) {
    uint32_t bb[4];
    ldsm4(b_addr + jp * 16 * ldb_bytes, bb);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_bf16(acc[mt][2 * jp], a[mt], bb[0], bb[1]);
      mma_bf16(acc[mt][2 * jp + 1], a[mt], bb[2], bb[3]);
    }
  }
}

// Adds s[0..NV) over the block in a fixed order and writes them to pb.
// red holds WARPS * 4 doubles that no thread still reads.
template <int NV>
__device__ __forceinline__ void block_stats(double (&s)[NV], double* red, double* __restrict__ pb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    for (int off = 16; off > 0; off >>= 1) s[i] += __shfl_down_sync(0xffffffffu, s[i], off);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < NV; ++i) red[warp * 4 + i] = s[i];
  __syncthreads();
  if (threadIdx.x < 4) {
    double t = 0.0;
    if (threadIdx.x < NV)
      for (int w = 0; w < WARPS; ++w) t += red[w * 4 + threadIdx.x];
    pb[threadIdx.x] = t;
  }
}

// The window of a work item (time p0 .. p0 + win of every channel of the
// sample at xb) into dst: asynchronous 16-byte copies of the chunks inside
// [0, T), left to the caller to commit; or, where rows of x are not 16-byte
// aligned (`fast` false), scalar loads with the pad values.
__device__ __forceinline__ void load_window(bf16* dst, const bf16* __restrict__ xb, int C, int win, int p0, int T_,
                                            bool fast, int left, int right, int pad_mode) {
  if (fast) {
    const int WC = win / 8;
    for (int i = threadIdx.x; i < C * WC; i += THREADS) {
      const int c = i / WC, m = i - c * WC, p = p0 + 8 * m;
      if (p >= 0 && p + 8 <= T_) cp_async16(smem_u32(dst + c * win + 8 * m), xb + (size_t)c * T_ + p);
    }
  } else {
    for (int i = threadIdx.x; i < C * win; i += THREADS) {
      const int c = i / win, j = i - c * win;
      dst[c * win + j] = pad_value(xb + (size_t)c * T_, p0 + j, T_, left, right, pad_mode);
    }
  }
}

// The positions of an asynchronously loaded window that lie outside [0, T):
// reflect / replicate / zero values. Only the first and last tiles of a
// sample have any.
__device__ __forceinline__ void fix_pads(bf16* raw, const bf16* __restrict__ xb, int C, int win, int p0, int T_,
                                         int left, int right, int pad_mode) {
  for (int i = threadIdx.x; i < C * win; i += THREADS) {
    const int c = i / win, j = i - c * win, p = p0 + j;
    if (p < 0 || p >= T_) raw[c * win + j] = pad_value(xb + (size_t)c * T_, p, T_, left, right, pad_mode);
  }
}

// xe[r][c] = ELU(raw[c][r + shift]) for r < rows: a warp takes 8 channels x
// 32 steps at a time, ldmatrix.trans in, the ELU on the fragments, stmatrix out.
__device__ __forceinline__ void elu_transpose(const bf16* raw, bf16* xe, uint32_t dummy_a, int C, int win, int lde,
                                              int rows, int shift) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int WC = win / 8, n_u = (WC + 3) / 4;
  const uint32_t raw_a = smem_u32(raw), xe_s = smem_u32(xe);
  for (int unit = warp; unit < (C / 8) * n_u; unit += WARPS) {
    const int cg = unit / n_u, m = 4 * (unit - cg * n_u) + (lane >> 3);
    uint32_t r[4];
    ldsm4_t(raw_a + ((cg * 8 + (lane & 7)) * win + m * 8) * 2, r);
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = elu_bf16x2(r[i]);
    const int row = m * 8 + (lane & 7) - shift;
    stsm4(row >= 0 && row < rows && m < WC ? xe_s + (row * lde + cg * 8) * 2 : dummy_a, r);
  }
}

// The output tile ot (C x ldo, channel-major) to y: 16-byte vectors, or
// scalars where rows of y are not aligned.
template <int TT>
__device__ __forceinline__ void store_tile(const bf16* ot, int ldo, bf16* __restrict__ yb, int C, int t0, int nt,
                                           int T_, bool fast) {
  for (int i = threadIdx.x; i < C * (TT / 8); i += THREADS) {
    const int c = i / (TT / 8), t = (i % (TT / 8)) * 8;
    if (fast) {
      if (t < nt)
        *reinterpret_cast<uint4*>(yb + (size_t)c * T_ + t0 + t) = *reinterpret_cast<const uint4*>(ot + c * ldo + t);
    } else {
      for (int e = 0; e < 8 && t + e < nt; ++e) yb[(size_t)c * T_ + t0 + t + e] = ot[c * ldo + t + e];
    }
  }
}

// Epilogue of a statistics pass on one warp's accumulators: bias, rounding,
// (sum, sumsq) over the rows below nt, in fp64.
template <int MT, int N>
__device__ __forceinline__ void stats_of(const float (&acc)[MT][N / 8][4], const float* bias_s, int row0, int nt,
                                         double& s0, double& s1) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float2 bias = *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * q);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (row0 + mt * 16 + g + 8 * (e >> 1) < nt) {
          const double v = round_bf(acc[mt][j][e] + ((e & 1) ? bias.y : bias.x));
          s0 += v;
          s1 += v * v;
        }
    }
}

template <int MT, int N>
__device__ __forceinline__ void zero(float (&acc)[MT][N / 8][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
}

// cn = round(round(acc + bias) * A + D), packed by row
template <int MT, int N>
__device__ __forceinline__ void normalise(const float (&acc)[MT][N / 8][4], const float* bias_s, const float* A_,
                                          const float* D_, uint32_t (&cn)[MT][N / 8][2]) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = 8 * j + 2 * q;
      const float2 bias = *reinterpret_cast<const float2*>(bias_s + c);
      const float2 A = *reinterpret_cast<const float2*>(A_ + c), D = *reinterpret_cast<const float2*>(D_ + c);
      cn[mt][j][0] = pack_bf(round_bf(acc[mt][j][0] + bias.x) * A.x + D.x, round_bf(acc[mt][j][1] + bias.y) * A.y + D.y);
      cn[mt][j][1] = pack_bf(round_bf(acc[mt][j][2] + bias.x) * A.x + D.x, round_bf(acc[mt][j][3] + bias.y) * A.y + D.y);
    }
}

// ot[c][t] = cn + round(round(acc + bias) * A + D): the output tile,
// channel-major; this warp's rows start at row0, its columns at ot's row c0.
template <int MT, int N>
__device__ __forceinline__ void write_out(bf16* ot, int ldo, int row0, const float (&acc)[MT][N / 8][4],
                                          const uint32_t (&cn)[MT][N / 8][2], const float* bias_s, const float* A_,
                                          const float* D_) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = 8 * j + 2 * q;
      const float2 bias = *reinterpret_cast<const float2*>(bias_s + c);
      const float2 A = *reinterpret_cast<const float2*>(A_ + c), D = *reinterpret_cast<const float2*>(D_ + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = round_bf(acc[mt][j][e] + ((e & 1) ? bias.y : bias.x));
        const float sn = round_bf(sv * ((e & 1) ? A.y : A.x) + ((e & 1) ? D.y : D.x));
        const float2 cv = unpack_bf(cn[mt][j][e >> 1]);
        ot[(c + (e & 1)) * ldo + row0 + mt * 16 + g + 8 * (e >> 1)] =
            __float2bfloat16_rn(((e & 1) ? cv.y : cv.x) + sn);
      }
    }
}

struct Args {
  const void *x, *w1, *b1, *w2, *b2, *ws, *bs, *aff;
  void *part, *y;
  int B, T_, K, dil, left, pad_mode, max_blocks;
  cudaStream_t stream;
};

// Launches `kernel` (when a != nullptr) on SMs x resident blocks, at most one
// block a work item; returns the CUDA error, or with a == nullptr the
// resident blocks an SM (-1 on error).
template <typename Kernel>
int launch_or_count(Kernel kernel, unsigned smem, int tt, const Args* a) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (a == nullptr) return err == cudaSuccess ? per_sm : -1;
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const int n_t = (a->T_ + tt - 1) / tt;
  long long grid = (long long)sms * per_sm;
  if (a->max_blocks > 0 && grid > a->max_blocks) grid = a->max_blocks;
  if (grid > (long long)a->B * n_t) grid = (long long)a->B * n_t;
  kernel<<<(unsigned)grid, THREADS, smem, a->stream>>>(
      static_cast<const bf16*>(a->x), static_cast<const bf16*>(a->w1), static_cast<const float*>(a->b1),
      static_cast<const bf16*>(a->w2), static_cast<const float*>(a->b2), static_cast<const bf16*>(a->ws),
      static_cast<const float*>(a->bs), static_cast<const float*>(a->aff), static_cast<double*>(a->part),
      static_cast<bf16*>(a->y), a->B, a->T_, n_t, a->K, a->dil, a->left, a->pad_mode);
  return (int)cudaGetLastError();
}

// The streamed kernel (resblock_tgn_streamed.cu), compiled for (C, H) =
// (256, 128): whether it takes this conv1, its tile, its shared memory, and
// its launch (a == nullptr: the resident blocks an SM instead).
bool streamed_applies(int C, int H, int K, int dil, int left);
int streamed_tile();
unsigned streamed_smem_bytes(int C, int H, int K, int dil, int left);
int streamed_dispatch(int mode, int C, int H, int K, int dil, int left, const Args* a);

}  // namespace rb
}  // namespace funcodec
