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
// by the wrapper, once per codebook), and ties go to the lowest index.
//
// What bounds it: the distance products, N * n_q * bins * D multiply-adds
// (0.13 T at N = 32,000, n_q = 32, bins = 1024, D = 128: 0.27 ms at the
// card's 989 TFLOP/s). Run as fp32 FMAs on the CUDA cores, as a first version
// of this kernel did, they took 34x that bound. Behind the products sits a
// serial chain per token tile: a stage's argmax, codeword gather and
// residual update cannot start before its products end, nor the next
// stage's products before them.
//
// Design (rvq_encode_wgmma_kernel):
//
// - The products run on the tensor cores: per stage and 128-bin chunk,
//   scores (64 tokens x 128 bins) = R (64 x 128, bf16, K-major in shared
//   memory) . E^T as 8 wgmma.m64n128k16 with fp32 accumulators in registers
//   (64 a thread). A 256-bin chunk would need 128 accumulator registers
//   beside the 128 that hold the fp32 residual and the codeword sum of the
//   thread's half row; 128-bin chunks keep everything in registers (the
//   consumers run at 232 registers after setmaxnreg).
// - Codebook chunks are constants of the model, so the wrapper pre-arranges
//   the bf16 codebooks once into the exact shared-memory image wgmma reads
//   (the 128-byte-swizzle K-major layout: two blocks of 64 columns, a row 128
//   bytes, its 16-byte pieces XOR-ed with row % 8; index formula in
//   quant/rvq_kernel.arranged_offset, held by a CPU test). One producer
//   thread then brings each 32 KB chunk and its 128 ||E||^2 values with two
//   1-D bulk copies (cp.async.bulk, completion on an mbarrier) into a ring of
//   4 stages: no tensor map to encode, and the copy costs no
//   registers or issue slots of the consumers.
// - The argmax runs on the accumulators: score = 2 * acc - ||E||^2, a running
//   (max, index) per row with strict '>' in rising bin order inside a thread,
//   then the lexicographic merge (larger score, then lower index) over the 4
//   lanes that share a row, and the all-NaN guard.
// - The residual never leaves the chip: thread t of a warpgroup owns half a
//   row (64 columns) of r and of the codeword sum in fp32 registers, gathers
//   the chosen bf16 codeword from L2 (the unarranged codebook), updates both,
//   and rewrites bf16(r) into the swizzled A tile, with fence.proxy.async and
//   a warpgroup barrier before the next stage's wgmma.
// - The serial chain is hidden by a second, independent tile: a block is two
//   consumer warpgroups, each with its own 64-token tile, that read the same
//   ring (a chunk is loaded once for both), so one's argmax and update
//   overlap the other's products. 64-token tiles keep 500 tiles at the
//   flagship's N = 32,000 (250 pairs over 132 persistent blocks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;       // latent width; the wrapper passes no other
constexpr int TILE = 64;     // tokens a warpgroup
constexpr int CHUNK = 128;   // codewords a ring stage
constexpr int STAGES = 4;
constexpr int WG = 128;      // threads a warpgroup
constexpr int THREADS = 3 * WG;  // two consumer warpgroups, one producer
constexpr int CHUNK_BYTES = CHUNK * D * 2;
constexpr int ESQ_BYTES = CHUNK * 4;
constexpr int STAGE_BYTES = CHUNK_BYTES + 1024;  // chunk image, then its ||E||^2; keeps stages 1024-byte aligned
constexpr int A_BYTES = TILE * D * 2;
constexpr int OFF_A = STAGES * STAGE_BYTES;
constexpr int OFF_CHOSEN = OFF_A + 2 * A_BYTES;
constexpr int OFF_BARS = OFF_CHOSEN + 2 * TILE * 4;
constexpr int SMEM_BYTES = OFF_BARS + 2 * STAGES * 8 + 1024;  // + slack to align the base to 1024

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// global -> shared, completion counted in bytes on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// A K-major operand in the 128-byte-swizzle layout: rows of 128 bytes, 8-row
// groups 1024 bytes apart (SBO), the leading offset unused (1), layout type 1.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x 128, fp32) = or += a (64 x 16, bf16) . b^T (128 x 16, bf16), both from shared memory
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Pins the accumulators around the asynchronous product (as CUTLASS's
// warpgroup_fence_operand does): d is an output of the wgmma asm, not of
// wgmma.wait_group, so nothing else keeps the compiler from reading it early.
__device__ __forceinline__ void fence_operand(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void group_barrier(int id) { asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(WG) : "memory"); }

__device__ __forceinline__ uint32_t pack_bf(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__global__ void __launch_bounds__(THREADS, 1)
rvq_encode_wgmma_kernel(const __nv_bfloat16* __restrict__ x,         // (n, D)
                        const __nv_bfloat16* __restrict__ embed,     // (n_q, bins, D): the gather's source
                        const __nv_bfloat16* __restrict__ arranged,  // (n_q, n_ch, CHUNK * D): wgmma's B images
                        const float* __restrict__ esq,               // (n_q, n_ch * CHUNK); +inf past bins
                        int32_t* __restrict__ idx_out,               // (n_q, n)
                        float* __restrict__ quant_out,               // (n, D)
                        int n, int n_q, int bins, int n_ch) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of address bits 4-9: operand bases sit on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t bars = base + OFF_BARS;  // full[STAGES], empty[STAGES]
  const int n_tiles = (n + TILE - 1) / TILE, n_pairs = (n_tiles + 1) / 2;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * WG) {
      int stage = 0;
      uint32_t phase = 0;
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x)
        for (int c = 0; c < n_q * n_ch; ++c) {
          mbar_wait(bars + 8 * (STAGES + stage), phase ^ 1);  // both warpgroups have left the stage
          const uint32_t full = bars + 8 * stage, dst = base + stage * STAGE_BYTES;
          mbar_arrive_expect_tx(full, CHUNK_BYTES + ESQ_BYTES);
          bulk_load(dst, arranged + (size_t)c * CHUNK * D, CHUNK_BYTES, full);
          bulk_load(dst + CHUNK_BYTES, esq + (size_t)c * CHUNK, ESQ_BYTES, full);
          if (++stage == STAGES) stage = 0, phase ^= 1;
        }
    }
  } else {
    // ---- consumers: warpgroup wg owns tile 2 * pair + wg ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % WG, lane = t & 31, g = lane >> 2, q4 = lane & 3;
    const int row = t >> 1, half = t & 1;     // this thread's half row of r and of the codeword sum
    const int arow = (t >> 5) * 16 + g;       // its two accumulator rows: arow, arow + 8
    unsigned char* a_tile = smem + OFF_A + wg * A_BYTES;
    int* chosen = reinterpret_cast<int*>(smem + OFF_CHOSEN) + wg * TILE;
    const uint64_t desc_a = wgmma_desc(base + OFF_A + wg * A_BYTES);
    int stage = 0;
    uint32_t phase = 0;

    for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
      const int n0 = (2 * pair + wg) * TILE;  // may lie past n: the tile then idles through the ring
      const int tok = n0 + row;
      float r[64], qa[64];
      if (tok < n) {
        const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)tok * D + half * 64);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint4 v = src[i];
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            r[8 * i + 2 * e] = f.x;
            r[8 * i + 2 * e + 1] = f.y;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) r[i] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) qa[i] = 0.0f;

      for (int q = 0; q < n_q; ++q) {
        // bf16(r) into the A tile: block `half` of 64 columns, row `row`, piece i at i ^ (row % 8)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          uint4 v;
          v.x = pack_bf(r[8 * i], r[8 * i + 1]);
          v.y = pack_bf(r[8 * i + 2], r[8 * i + 3]);
          v.z = pack_bf(r[8 * i + 4], r[8 * i + 5]);
          v.w = pack_bf(r[8 * i + 6], r[8 * i + 7]);
          *reinterpret_cast<uint4*>(a_tile + half * (TILE * 128) + row * 128 + ((i ^ (row & 7)) * 16)) = v;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wgmma reads through the async proxy
        group_barrier(1 + wg);

        float best0 = -INFINITY, best1 = -INFINITY;
        int bi0 = INT32_MAX, bi1 = INT32_MAX;
        for (int ch = 0; ch < n_ch; ++ch) {
          mbar_wait(bars + 8 * stage, phase);
          const uint64_t desc_b = wgmma_desc(base + stage * STAGE_BYTES);
          float d[64];
          fence_operand(d);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            // 16 columns are 32 bytes inside a 64-column block; descriptors count 16 bytes
            const uint64_t oa = (uint64_t)(((kk >> 2) * (TILE * 128) + (kk & 3) * 32) >> 4);
            const uint64_t ob = (uint64_t)(((kk >> 2) * (CHUNK * 128) + (kk & 3) * 32) >> 4);
            wgmma_m64n128k16(d, desc_a + oa, desc_b + ob, kk > 0);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_operand(d);
          const float* e2 = reinterpret_cast<const float*>(smem + stage * STAGE_BYTES + CHUNK_BYTES);
          const int bin0 = ch * CHUNK + 2 * q4;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float2 e = *reinterpret_cast<const float2*>(e2 + 8 * j + 2 * q4);
            const int bin = bin0 + 8 * j;
            float s = 2.0f * d[4 * j] - e.x;
            if (s > best0) best0 = s, bi0 = bin;
            s = 2.0f * d[4 * j + 1] - e.y;
            if (s > best0) best0 = s, bi0 = bin + 1;
            s = 2.0f * d[4 * j + 2] - e.x;
            if (s > best1) best1 = s, bi1 = bin;
            s = 2.0f * d[4 * j + 3] - e.y;
            if (s > best1) best1 = s, bi1 = bin + 1;
          }
          // The ||E||^2 values were read through the generic proxy and the
          // stage's next bulk copy writes through the async proxy: without
          // this fence ptxas left the last loads' results to be consumed
          // after the arrive, and now and then the producer's next copy
          // overwrote them first (one token of a launch took another codeword).
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(bars + 8 * (STAGES + stage));
          if (++stage == STAGES) stage = 0, phase ^= 1;
        }

        // merge the 4 column subsets of a row: the larger score wins, and on
        // equal scores the lower index
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          float so = __shfl_xor_sync(0xffffffffu, best0, off);
          int bo = __shfl_xor_sync(0xffffffffu, bi0, off);
          if (so > best0 || (so == best0 && bo < bi0)) best0 = so, bi0 = bo;
          so = __shfl_xor_sync(0xffffffffu, best1, off);
          bo = __shfl_xor_sync(0xffffffffu, bi1, off);
          if (so > best1 || (so == best1 && bo < bi1)) best1 = so, bi1 = bo;
        }
        if (q4 == 0) {
          if (bi0 >= bins) bi0 = 0;  // every score NaN: keep a valid row
          if (bi1 >= bins) bi1 = 0;
          chosen[arow] = bi0;
          chosen[arow + 8] = bi1;
          if (n0 + arow < n) idx_out[(size_t)q * n + n0 + arow] = bi0;
          if (n0 + arow + 8 < n) idx_out[(size_t)q * n + n0 + arow + 8] = bi1;
        }
        group_barrier(1 + wg);  // chosen is written; every warp's wgmma has left the A tile

        const uint4* cw = reinterpret_cast<const uint4*>(embed + ((size_t)q * bins + chosen[row]) * D + half * 64);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint4 v = __ldg(cw + i);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            r[8 * i + 2 * e] -= f.x;
            qa[8 * i + 2 * e] += f.x;
            r[8 * i + 2 * e + 1] -= f.y;
            qa[8 * i + 2 * e + 1] += f.y;
          }
        }
      }

      if (tok < n) {
        float4* dst = reinterpret_cast<float4*>(quant_out + (size_t)tok * D + half * 64);
#pragma unroll
        for (int i = 0; i < 16; ++i) dst[i] = make_float4(qa[4 * i], qa[4 * i + 1], qa[4 * i + 2], qa[4 * i + 3]);
      }
    }
  }
}

}  // namespace

// x (n, 128) bf16; embed (n_q, bins, 128) bf16; arranged (n_q, n_ch, 128 * 128)
// bf16, the codebooks in 128-bin chunks as wgmma's shared-memory image
// (quant/rvq_kernel.arrange_codebooks); esq (n_q, n_ch * 128) fp32, +inf past
// bins; idx (n_q, n) int32, quant (n, 128) fp32; all contiguous, 16-byte
// aligned, on the current device. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int rvq_encode_launch(const void* x, const void* embed, const void* arranged, const void* esq,
                                 void* idx, void* quant, int n, int n_q, int bins, int n_ch, void* stream) {
  if (n <= 0 || n_q <= 0 || bins <= 0 || n_ch != (bins + CHUNK - 1) / CHUNK) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(rvq_encode_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_pairs = ((n + TILE - 1) / TILE + 1) / 2;
  rvq_encode_wgmma_kernel<<<n_pairs < sms ? n_pairs : sms, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(embed),
      static_cast<const __nv_bfloat16*>(arranged), static_cast<const float*>(esq), static_cast<int32_t*>(idx),
      static_cast<float*>(quant), n, n_q, bins, n_ch);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a block requests.
extern "C" int rvq_encode_smem_bytes() { return SMEM_BYTES; }

extern "C" const char* funcodec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
