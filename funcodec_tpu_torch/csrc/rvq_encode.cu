// Fused greedy residual-VQ encode for Hopper (sm_90a), CUDA C++.
//
// Replaces funcodec_tpu/quant/rvq_pallas.py::_rvq_encode_kernel. For each
// token and each quantizer q < n_q:
//   score[b] = 2 * dot(bf16(r), E_q[b]) - ||E_q[b]||^2   (fp32 accumulate)
//   k        = first argmax of score
//   r       -= E_q[k];  quant += E_q[k]                  (fp32)
// The residual stays on chip (registers) for all n_q stages; only the
// indices (n_q, N) int32 and the summed codewords (N, D) fp32 are written.
//
// Numerics follow the JAX wrapper (rvq_pallas.py:62-98): x arrives in bf16,
// the residual is held in fp32 and re-rounded to bf16 (round to nearest
// even) before each stage's distance product, codewords are bf16 rows
// widened exactly to fp32, ||E||^2 comes from the fp32 codebooks (computed
// once per call by the wrapper), and ties go to the lowest index.
//
// What bounds it: the distance products, N * n_q * bins * D FMAs (0.13 T
// FMA at N = 32,000, n_q = 32, bins = 1024, D = 128), run on the CUDA
// cores in fp32. This first version is bounded by CUDA-core FMA
// throughput. Its design keeps each block's 64-token residual tile in
// registers and shared memory and streams each codebook through shared
// memory in chunks of 128 codewords (the 8 MB of bf16 codebooks stay
// resident in the 50 MB L2). The next step is the tensor cores: wgmma on
// bf16 operands with fp32 accumulation, fed by TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;        // latent width; the wrapper passes no other
constexpr int TILE_N = 64;    // tokens per block
constexpr int CHUNK = 128;    // codewords staged in shared memory at a time
constexpr int THREADS = 256;
constexpr int LD = D + 4;     // padded row stride (floats) of the shared tiles

// Scoring micro-tile: each thread scores 4 tokens against 8 codewords of a
// chunk. Token group tg owns tokens tg*4 .. tg*4+3; bin group bg owns chunk
// rows bg, bg+16, ..., so the 16 threads that read one row of the residual
// tile read 16 consecutive codeword rows (no shared-memory bank conflicts).
constexpr int TOK_PER_THREAD = 4;
constexpr int BIN_PER_THREAD = 8;
constexpr int BIN_GROUPS = CHUNK / BIN_PER_THREAD;  // 16 = lanes per token group
static_assert((TILE_N / TOK_PER_THREAD) * BIN_GROUPS == THREADS, "micro-tile");
static_assert(BIN_GROUPS <= 32 && (32 % BIN_GROUPS) == 0, "token group within a warp");

// Residual ownership for the load/update/store: thread tid owns column
// tid % D of rows tid / D + k * ROW_STEP.
constexpr int ROW_STEP = THREADS / D;
constexpr int ELEMS = TILE_N / ROW_STEP;
static_assert(THREADS % D == 0, "row ownership");

constexpr size_t SMEM_BYTES =
    (size_t)(TILE_N * LD + CHUNK * LD) * sizeof(float) + TILE_N * sizeof(int);

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(THREADS)
rvq_encode_kernel(const __nv_bfloat16* __restrict__ x,      // (n, D)
                  const __nv_bfloat16* __restrict__ embed,  // (n_q, bins, D)
                  const float* __restrict__ embed_sq,       // (n_q, bins)
                  int32_t* __restrict__ idx_out,            // (n_q, n)
                  float* __restrict__ quant_out,            // (n, D)
                  int n, int n_q, int bins) {
  extern __shared__ __align__(16) float smem[];
  float* rb = smem;                              // [TILE_N][LD] bf16(residual)
  float* eb = rb + TILE_N * LD;                  // [CHUNK][LD] codeword chunk
  int* chosen = reinterpret_cast<int*>(eb + CHUNK * LD);  // [TILE_N]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TILE_N;
  const int col = tid % D;
  const int row0 = tid / D;

  // rows past n (the ragged last tile) carry a zero residual and are never
  // written out
  float r[ELEMS], qacc[ELEMS];
#pragma unroll
  for (int k = 0; k < ELEMS; ++k) {
    const int tok = n0 + row0 + k * ROW_STEP;
    r[k] = tok < n ? __bfloat162float(x[(size_t)tok * D + col]) : 0.0f;
    qacc[k] = 0.0f;
  }

  const int tg = tid / BIN_GROUPS;
  const int bg = tid % BIN_GROUPS;

  for (int q = 0; q < n_q; ++q) {
    const __nv_bfloat16* eq = embed + (size_t)q * bins * D;
    const float* esq = embed_sq + (size_t)q * bins;

#pragma unroll
    for (int k = 0; k < ELEMS; ++k) rb[(row0 + k * ROW_STEP) * LD + col] = bf16_round(r[k]);

    float best[TOK_PER_THREAD];
    int best_idx[TOK_PER_THREAD];
#pragma unroll
    for (int i = 0; i < TOK_PER_THREAD; ++i) {
      best[i] = -INFINITY;
      best_idx[i] = INT32_MAX;
    }

    for (int c0 = 0; c0 < bins; c0 += CHUNK) {
      __syncthreads();  // rb is written and the previous chunk is consumed
      for (int u = tid; u < CHUNK * D / 8; u += THREADS) {
        const int row = u / (D / 8);
        const int c8 = (u % (D / 8)) * 8;
        float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
        if (c0 + row < bins) {
          const uint4 v = *reinterpret_cast<const uint4*>(eq + (size_t)(c0 + row) * D + c8);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
          const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
          const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
          lo = make_float4(f0.x, f0.y, f1.x, f1.y);
          hi = make_float4(f2.x, f2.y, f3.x, f3.y);
        }
        *reinterpret_cast<float4*>(eb + row * LD + c8) = lo;
        *reinterpret_cast<float4*>(eb + row * LD + c8 + 4) = hi;
      }
      __syncthreads();

      float acc[TOK_PER_THREAD][BIN_PER_THREAD];
#pragma unroll
      for (int i = 0; i < TOK_PER_THREAD; ++i)
#pragma unroll
        for (int j = 0; j < BIN_PER_THREAD; ++j) acc[i][j] = 0.0f;

#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 a[TOK_PER_THREAD];
#pragma unroll
        for (int i = 0; i < TOK_PER_THREAD; ++i)
          a[i] = *reinterpret_cast<const float4*>(rb + (tg * TOK_PER_THREAD + i) * LD + d);
#pragma unroll
        for (int j = 0; j < BIN_PER_THREAD; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(eb + (bg + BIN_GROUPS * j) * LD + d);
#pragma unroll
          for (int i = 0; i < TOK_PER_THREAD; ++i) {
            float s = acc[i][j];
            s = fmaf(a[i].x, b.x, s);
            s = fmaf(a[i].y, b.y, s);
            s = fmaf(a[i].z, b.z, s);
            s = fmaf(a[i].w, b.w, s);
            acc[i][j] = s;
          }
        }
      }

      // this thread's bins rise with j and with c0, so a strict '>' keeps
      // the first maximum of its own subset
#pragma unroll
      for (int j = 0; j < BIN_PER_THREAD; ++j) {
        const int bin = c0 + bg + BIN_GROUPS * j;
        if (bin < bins) {
          const float e2 = esq[bin];
#pragma unroll
          for (int i = 0; i < TOK_PER_THREAD; ++i) {
            const float s = 2.0f * acc[i][j] - e2;
            if (s > best[i]) {
              best[i] = s;
              best_idx[i] = bin;
            }
          }
        }
      }
    }

    // merge the 16 subsets of each token: the larger score wins, and on
    // equal scores the lower index
#pragma unroll
    for (int i = 0; i < TOK_PER_THREAD; ++i) {
      float s = best[i];
      int b = best_idx[i];
#pragma unroll
      for (int off = BIN_GROUPS / 2; off > 0; off >>= 1) {
        const float so = __shfl_xor_sync(0xffffffffu, s, off);
        const int bo = __shfl_xor_sync(0xffffffffu, b, off);
        if (so > s || (so == s && bo < b)) {
          s = so;
          b = bo;
        }
      }
      if (bg == 0) {
        if (b >= bins) b = 0;  // every score NaN: keep a valid row
        const int row = tg * TOK_PER_THREAD + i;
        chosen[row] = b;
        if (n0 + row < n) idx_out[(size_t)q * n + n0 + row] = b;
      }
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < ELEMS; ++k) {
      const int row = row0 + k * ROW_STEP;
      const float c = __bfloat162float(eq[(size_t)chosen[row] * D + col]);
      r[k] -= c;
      qacc[k] += c;
    }
  }

#pragma unroll
  for (int k = 0; k < ELEMS; ++k) {
    const int tok = n0 + row0 + k * ROW_STEP;
    if (tok < n) quant_out[(size_t)tok * D + col] = qacc[k];
  }
}

}  // namespace

// x (n, 128) bf16, embed (n_q, bins, 128) bf16, embed_sq (n_q, bins) fp32,
// idx (n_q, n) int32, quant (n, 128) fp32; all contiguous, 16-byte aligned,
// on the current device. Launches on `stream` and returns cudaGetLastError().
extern "C" int rvq_encode_launch(const void* x, const void* embed, const void* embed_sq,
                                 void* idx, void* quant, int n, int n_q, int bins,
                                 void* stream) {
  if (n <= 0 || n_q <= 0 || bins <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rvq_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + TILE_N - 1) / TILE_N);
  rvq_encode_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(embed),
      static_cast<const float*>(embed_sq), static_cast<int32_t*>(idx),
      static_cast<float*>(quant), n, n_q, bins);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block of rvq_encode_kernel requests.
extern "C" int rvq_encode_smem_bytes() { return (int)SMEM_BYTES; }

extern "C" const char* funcodec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
