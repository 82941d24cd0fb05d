// HBM copy probes: o = 2 * x, streamed through the card once.
//
// Replaces the TPU bandwidth probes' Pallas kernels:
//   scripts/pallas_stream_probe.py:74 scale_kernel (pallas_copy, tiles 1000 / 4000 / 10000)
//   scripts/pallas_bw_probe.py:45     scale_kernel (variants A, B, C, E)
//   scripts/pallas_bw_probe.py:113    dma_kernel   (variant D, hand-issued double-buffered DMA)
//
// Both kernels compute o = 2 * x in the input's type (bf16 or fp32). Doubling
// is exact and overflows to +-inf, so each agrees bit for bit with the plain
// version x * 2 (ops/copy_kernel.scale_reference). The work is bound by bytes:
// every byte is read once and written once, so the least time is
// 2 * nbytes / 3.35 TB/s. What the probes measure is how close a hand-written
// stream gets to that.
//
// scale_copy: the blocked copy of BlockSpec((rows, tile, L)). The grid is
//   (ceil(T / tile), ceil(B / rows)); a block streams its rows' (tile, L) slabs,
//   each contiguous, with 16-byte vector loads and stores, neighbouring threads
//   on neighbouring addresses, four vectors in flight per thread. The ragged
//   last tile is masked, so T need not be a multiple of tile (the JAX probe
//   required Tp % tile == 0). Variant B's dimension_semantics (parallel /
//   arbitrary grid axes) has no Hopper counterpart: blocks always run in
//   parallel, in no order, on the 132 SMs. What B asked of the TPU -- what one
//   grid step costs -- the port's sweep over tile and row counts asks of the
//   card, down to tiles of a few KB per block.
//
// dma_copy: the Hopper form of pltpu.make_async_copy with DMA semaphores. A
//   persistent grid of about one block per SM walks the (R, L) rows in chunks
//   of chunk_rows, chunk c going to block c % gridDim.x. Each block holds two
//   input and two output slots in shared memory and one mbarrier per input
//   slot. One thread issues the 1-D TMA bulk load of the next chunk
//   (cp.async.bulk ... mbarrier::complete_tx::bytes) before all threads wait on
//   the current slot's barrier phase and scale it into an output slot; after
//   fence.proxy.async one thread issues the bulk store of that slot
//   (cp.async.bulk.global.shared::cta.bulk_group, commit_group), and waits with
//   cp.async.bulk.wait_group.read before an output slot is written again.
//   The TPU probe moved chunks of 2000 rows (512 KB of bf16 at L = 128) through
//   VMEM; four such slots are 2 MB, and a block has 227 KB of shared memory, so
//   chunk_rows is the port's own parameter (the wrapper picks 32 KB chunks). A
//   bulk copy needs 16-byte-aligned addresses and sizes: the wrapper refuses a
//   row that is not a multiple of 16 bytes or a misaligned pointer, and the
//   kernel takes a row count that is not a multiple of chunk_rows (the last
//   chunk is shorter).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCALE_THREADS = 256;
constexpr int SCALE_UNROLL = 4;  // 16-byte vectors in flight per thread
constexpr int DMA_THREADS = 256;
constexpr int SLOT_ALIGN = 128;

enum DType { DT_F32 = 0, DT_BF16 = 1 };

// 2 * v for each element of a 16-byte vector
template <int DT>
__device__ __forceinline__ uint4 scale2(uint4 v);

template <>
__device__ __forceinline__ uint4 scale2<DT_F32>(uint4 v) {
  v.x = __float_as_uint(2.0f * __uint_as_float(v.x));
  v.y = __float_as_uint(2.0f * __uint_as_float(v.y));
  v.z = __float_as_uint(2.0f * __uint_as_float(v.z));
  v.w = __float_as_uint(2.0f * __uint_as_float(v.w));
  return v;
}

__device__ __forceinline__ uint32_t scale2_bf16x2(uint32_t u) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&u);
  const float2 f = __bfloat1622float2(h);
  h = __floats2bfloat162_rn(2.0f * f.x, 2.0f * f.y);  // exact; overflow rounds to inf
  return *reinterpret_cast<uint32_t*>(&h);
}

template <>
__device__ __forceinline__ uint4 scale2<DT_BF16>(uint4 v) {
  v.x = scale2_bf16x2(v.x);
  v.y = scale2_bf16x2(v.y);
  v.z = scale2_bf16x2(v.z);
  v.w = scale2_bf16x2(v.w);
  return v;
}

// n16 16-byte vectors from src to dst, doubled, by the whole block
template <int DT>
__device__ __forceinline__ void stream_slab(const uint4* __restrict__ src, uint4* __restrict__ dst, long long n16) {
  const long long step = (long long)blockDim.x * SCALE_UNROLL;
  long long i = threadIdx.x;
  for (; i + (SCALE_UNROLL - 1) * (long long)blockDim.x < n16; i += step) {
    uint4 v[SCALE_UNROLL];
#pragma unroll
    for (int u = 0; u < SCALE_UNROLL; ++u) v[u] = __ldcs(src + i + u * blockDim.x);
#pragma unroll
    for (int u = 0; u < SCALE_UNROLL; ++u) __stcs(dst + i + u * blockDim.x, scale2<DT>(v[u]));
  }
  for (; i < n16; i += blockDim.x) __stcs(dst + i, scale2<DT>(__ldcs(src + i)));
}

template <int DT>
__global__ void __launch_bounds__(SCALE_THREADS)
    scale_copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, int B, long long T, long long row16,
                      int tile, int rows) {
  const long long t0 = (long long)blockIdx.x * tile;
  const long long n_t = T - t0 < tile ? T - t0 : tile;  // the ragged last tile
  const long long n16 = n_t * row16;
  for (int r = 0; r < rows; ++r) {
    const long long b = (long long)blockIdx.y * rows + r;
    if (b >= B) return;
    const long long off = (b * T + t0) * row16;
    stream_slab<DT>(x + off, y + off, n16);
  }
}

// ---- mbarrier and bulk-copy primitives (PTX) -------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// global -> shared, completion counted in bytes on `bar`
__device__ __forceinline__ void bulk_load(void* smem_dst, const void* gmem_src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(smem_dst)),
               "l"(gmem_src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// shared -> global in the current bulk group
__device__ __forceinline__ void bulk_store(void* gmem_dst, const void* smem_src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(gmem_dst),
               "r"(smem_addr(smem_src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// at most N committed bulk groups still reading shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// all committed bulk groups complete (their global writes done)
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// ---- dma_copy ---------------------------------------------------------------

template <int DT>
__global__ void __launch_bounds__(DMA_THREADS)
    dma_copy_kernel(const char* __restrict__ x, char* __restrict__ y, long long n_rows, int row_bytes,
                    int chunk_rows, int slot_bytes) {
  extern __shared__ __align__(SLOT_ALIGN) unsigned char smem[];
  unsigned char* in_slot[2] = {smem, smem + slot_bytes};
  unsigned char* out_slot[2] = {smem + 2 * slot_bytes, smem + 3 * slot_bytes};
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 4 * slot_bytes);

  const long long n_chunks = (n_rows + chunk_rows - 1) / chunk_rows;
  // this block's chunks: blockIdx.x, blockIdx.x + gridDim.x, ...
  const long long count = n_chunks > blockIdx.x ? (n_chunks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto chunk_of = [&](long long k) { return blockIdx.x + k * gridDim.x; };
  auto bytes_of = [&](long long c) {
    const long long r = n_rows - c * chunk_rows;
    return (uint32_t)((r < chunk_rows ? r : chunk_rows) * row_bytes);
  };
  auto offset_of = [&](long long c) { return c * chunk_rows * (long long)row_bytes; };
  const bool leader = threadIdx.x == 0;

  if (leader) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (leader && count > 0) {
    const long long c = chunk_of(0);
    mbar_arrive_expect_tx(&bar[0], bytes_of(c));
    bulk_load(in_slot[0], x + offset_of(c), bytes_of(c), &bar[0]);
  }
  for (long long k = 0; k < count; ++k) {
    const int slot = (int)(k & 1);
    const long long c = chunk_of(k);
    const uint32_t nbytes = bytes_of(c);
    if (leader) {
      if (k + 1 < count) {
        // the other input slot was last read in iteration k - 1, before its closing barrier
        const long long cn = chunk_of(k + 1);
        mbar_arrive_expect_tx(&bar[slot ^ 1], bytes_of(cn));
        bulk_load(in_slot[slot ^ 1], x + offset_of(cn), bytes_of(cn), &bar[slot ^ 1]);
      }
      bulk_wait_read<1>();  // the store of iteration k - 2 has left out_slot[slot]
    }
    __syncthreads();
    mbar_wait(&bar[slot], (uint32_t)((k >> 1) & 1));
    const uint4* src = reinterpret_cast<const uint4*>(in_slot[slot]);
    uint4* dst = reinterpret_cast<uint4*>(out_slot[slot]);
    for (uint32_t i = threadIdx.x; i < nbytes / 16; i += blockDim.x) dst[i] = scale2<DT>(src[i]);
    fence_proxy_async();  // these generic-proxy writes are seen by the bulk store
    __syncthreads();
    if (leader) {
      bulk_store(y + offset_of(c), out_slot[slot], nbytes);
      bulk_commit();
    }
  }
  if (leader) bulk_wait_all();
}

int slot_bytes_for(int chunk_rows, int row_bytes) {
  const long long b = (long long)chunk_rows * row_bytes;
  return (int)((b + SLOT_ALIGN - 1) / SLOT_ALIGN * SLOT_ALIGN);
}

}  // namespace

// o = 2 * x over x (B, T, L) with row_bytes = L * element size, a multiple of
// 16; x and y 16-byte aligned. Grid (ceil(T / tile), ceil(B / rows)).
extern "C" int scale_copy_launch(const void* x, void* y, int B, long long T, int row_bytes, int tile, int rows,
                                 int dtype, void* stream) {
  if (B <= 0 || T <= 0 || row_bytes <= 0 || row_bytes % 16 || tile <= 0 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  const long long gx = (T + tile - 1) / tile, gy = (B + rows - 1) / rows;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  const long long row16 = row_bytes / 16;
  auto s = static_cast<cudaStream_t>(stream);
  const uint4* xs = static_cast<const uint4*>(x);
  uint4* ys = static_cast<uint4*>(y);
  if (dtype == DT_BF16)
    scale_copy_kernel<DT_BF16><<<grid, SCALE_THREADS, 0, s>>>(xs, ys, B, T, row16, tile, rows);
  else if (dtype == DT_F32)
    scale_copy_kernel<DT_F32><<<grid, SCALE_THREADS, 0, s>>>(xs, ys, B, T, row16, tile, rows);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Dynamic shared memory a dma_copy block needs: 4 slots and 2 mbarriers.
extern "C" int dma_copy_smem_bytes(int chunk_rows, int row_bytes) {
  return 4 * slot_bytes_for(chunk_rows, row_bytes) + 2 * (int)sizeof(uint64_t);
}

// o = 2 * x over n_rows rows of row_bytes (a multiple of 16), chunk_rows rows
// per bulk copy; x and y 16-byte aligned. One block per SM (fewer if there
// are fewer chunks).
extern "C" int dma_copy_launch(const void* x, void* y, long long n_rows, int row_bytes, int chunk_rows, int dtype,
                               void* stream) {
  if (n_rows <= 0 || row_bytes <= 0 || row_bytes % 16 || chunk_rows <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)chunk_rows * row_bytes >= (1LL << 20)) return (int)cudaErrorInvalidValue;  // mbarrier tx count
  const int smem = dma_copy_smem_bytes(chunk_rows, row_bytes);
  int device = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (smem > smem_max) return (int)cudaErrorInvalidValue;
  const long long n_chunks = (n_rows + chunk_rows - 1) / chunk_rows;
  const long long grid = n_chunks < sms ? n_chunks : sms;
  auto s = static_cast<cudaStream_t>(stream);
  const char* xs = static_cast<const char*>(x);
  char* ys = static_cast<char*>(y);
  const int slot = slot_bytes_for(chunk_rows, row_bytes);
  if (dtype == DT_BF16) {
    err = cudaFuncSetAttribute(dma_copy_kernel<DT_BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dma_copy_kernel<DT_BF16><<<(unsigned)grid, DMA_THREADS, smem, s>>>(xs, ys, n_rows, row_bytes, chunk_rows, slot);
  } else if (dtype == DT_F32) {
    err = cudaFuncSetAttribute(dma_copy_kernel<DT_F32>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dma_copy_kernel<DT_F32><<<(unsigned)grid, DMA_THREADS, smem, s>>>(xs, ys, n_rows, row_bytes, chunk_rows, slot);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
