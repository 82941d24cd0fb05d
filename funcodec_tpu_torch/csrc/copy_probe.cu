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
// scale_copy: the blocked copy of BlockSpec((rows, tile, L)). The tile and
//   row count cut x (B, T, L) into the JAX probe's slabs, (ceil(T / tile),
//   ceil(B / rows)) of them; the ragged last tile is masked (the JAX probe
//   required Tp % tile == 0). A slab is not a block: each row segment
//   of a slab is cut into equal pieces of at most 16 KB (1024 16-byte
//   vectors), a block a piece, so a large tile does not leave a last wave of
//   a few blocks (a grid of one block a slab lost 6-7% to torch.mul that
//   way), no block takes a small remnant, and every thread issues all 4 of
//   its loads before its stores. 4 vectors a thread measured
//   ahead of 8 and 16, and of streaming cache hints (ld/st .cs), in bf16 and
//   fp32. Variant B's dimension_semantics (parallel / arbitrary grid axes)
//   has no Hopper counterpart: blocks always run in parallel, in no order,
//   on the 132 SMs. What B asked of the TPU -- what one grid step costs --
//   the sweep over tile and row counts asks of the card, down to slabs of
//   4 KB.
//
// dma_copy: the Hopper form of pltpu.make_async_copy with DMA semaphores. A
//   persistent grid (SMs x resident blocks) walks the (R, L) rows in chunks
//   of chunk_rows, chunk c going to block c % gridDim.x. A block holds a
//   ring of 4 slots in shared memory (fewer, down to 2, where 4 chunks do
//   not fit a block), one "full" and one "empty" mbarrier a slot, one producer warp and four consumer warps. The
//   producer's lane 0 keeps the ring full: for each chunk it waits until the
//   slot's last store has read it (empty), then issues the 1-D TMA bulk load
//   (cp.async.bulk ... mbarrier::complete_tx::bytes). The consumers wait on
//   the slot's full phase, double the chunk in place, fence.proxy.async, and
//   one of them issues the bulk store of the same slot
//   (cp.async.bulk.global.shared::cta.bulk_group); once the store before it
//   has read its slot (cp.async.bulk.wait_group.read 1) it arrives on that
//   slot's empty barrier. In place, a stage is one slot, half the shared
//   memory of separate input and output slots; 4 x 32 KB,
//   one block an SM, measured ahead of 6 x 16 KB (two blocks an SM),
//   3 x 16 KB and 8 x 8 KB. The TPU probe moved
//   chunks of 2000 rows (512 KB of bf16 at L = 128) through VMEM, which does
//   not fit 227 KB of shared memory, so chunk_rows is the port's own
//   parameter. A bulk copy needs 16-byte-aligned addresses and sizes: the
//   wrapper refuses a row that is not a multiple of 16 bytes or a misaligned
//   pointer, and the kernel takes a row count that is not a multiple of
//   chunk_rows (the last chunk is shorter).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCALE_THREADS = 256;
constexpr int SCALE_UNROLL = 4;  // 16-byte vectors in flight per thread: all loads, then all stores
constexpr long long PIECE = SCALE_THREADS * SCALE_UNROLL;  // the most vectors a block takes (16 KB)
constexpr int DMA_CONSUMERS = 128;                         // four consumer warps
constexpr int DMA_THREADS = DMA_CONSUMERS + 32;            // and one producer warp
constexpr int DMA_STAGES = 4;     // the ring's slots, where they fit a block
constexpr int SMEM_OPTIN = 232448;  // the shared memory an H100 block may ask for
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

// Block i: piece `part` of row r of slab (group, tile), in slab-major order,
// a slab's rows one after the other; a row segment of n16 vectors is cut
// into ppr pieces of piece16 = ceil(n16 / ppr) vectors each.
template <int DT>
__global__ void __launch_bounds__(SCALE_THREADS)
    scale_copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, int B, long long T, long long row16,
                      long long tile, int rows, int n_tiles, int ppr, int piece16) {
  const int pps = rows * ppr, slab = blockIdx.x / pps, rem = blockIdx.x - slab * pps;
  const int r = rem / ppr, part = rem - r * ppr, group = slab / n_tiles;
  const long long b = (long long)group * rows + r, t0 = (long long)(slab - group * n_tiles) * tile;
  const long long n16 = (T - t0 < tile ? T - t0 : tile) * row16;  // the ragged last tile
  const long long lo = (long long)part * piece16;
  if (b >= B || lo >= n16) return;
  const int n = (int)(n16 - lo < piece16 ? n16 - lo : piece16);
  const uint4* src = x + (b * T + t0) * row16 + lo;
  uint4* dst = y + (b * T + t0) * row16 + lo;
  uint4 v[SCALE_UNROLL];
#pragma unroll
  for (int u = 0; u < SCALE_UNROLL; ++u) {
    const int i = threadIdx.x + u * SCALE_THREADS;
    if (i < n) v[u] = src[i];
  }
#pragma unroll
  for (int u = 0; u < SCALE_UNROLL; ++u) {
    const int i = threadIdx.x + u * SCALE_THREADS;
    if (i < n) dst[i] = scale2<DT>(v[u]);
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// the consumer warps' own barrier (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(DMA_CONSUMERS) : "memory");
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
                    int chunk_rows, int slot_bytes, int stages) {
  extern __shared__ __align__(SLOT_ALIGN) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)stages * slot_bytes);
  uint64_t* empty = full + stages;

  const long long n_chunks = (n_rows + chunk_rows - 1) / chunk_rows;
  // this block's chunks: blockIdx.x, blockIdx.x + gridDim.x, ...
  const long long count = n_chunks > blockIdx.x ? (n_chunks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto chunk_of = [&](long long k) { return blockIdx.x + k * gridDim.x; };
  auto bytes_of = [&](long long c) {
    const long long r = n_rows - c * chunk_rows;
    return (uint32_t)((r < chunk_rows ? r : chunk_rows) * row_bytes);
  };
  auto offset_of = [&](long long c) { return c * chunk_rows * (long long)row_bytes; };
  auto slot_of = [&](long long k) { return smem + (size_t)(k % stages) * slot_bytes; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= DMA_CONSUMERS) {  // the producer warp: lane 0 keeps the ring full
    if (threadIdx.x == DMA_CONSUMERS)
      for (long long k = 0; k < count; ++k) {
        const int s = (int)(k % stages);
        const long long use = k / stages;
        if (use > 0) mbar_wait(&empty[s], (uint32_t)((use - 1) & 1));  // the slot's last store has read it
        const long long c = chunk_of(k);
        mbar_arrive_expect_tx(&full[s], bytes_of(c));
        bulk_load(slot_of(k), x + offset_of(c), bytes_of(c), &full[s]);
      }
    return;
  }

  const bool leader = threadIdx.x == 0;
  for (long long k = 0; k < count; ++k) {
    const int s = (int)(k % stages);
    const long long c = chunk_of(k);
    const uint32_t nbytes = bytes_of(c);
    mbar_wait(&full[s], (uint32_t)((k / stages) & 1));
    uint4* slot = reinterpret_cast<uint4*>(slot_of(k));
    for (uint32_t i = threadIdx.x; i < nbytes / 16; i += DMA_CONSUMERS) slot[i] = scale2<DT>(slot[i]);
    fence_proxy_async();  // these generic-proxy writes are seen by the bulk store
    consumers_sync();
    if (leader) {
      bulk_store(y + offset_of(c), slot, nbytes);
      bulk_commit();
      if (k > 0) {
        bulk_wait_read<1>();  // the store of chunk k - 1 has left its slot
        mbar_arrive(&empty[(k - 1) % stages]);
      }
    }
  }
  if (leader) bulk_wait_all();
}

int slot_bytes_for(int chunk_rows, int row_bytes) {
  const long long b = (long long)chunk_rows * row_bytes;
  return (int)((b + SLOT_ALIGN - 1) / SLOT_ALIGN * SLOT_ALIGN);
}

int smem_for(int chunk_rows, int row_bytes, int stages) {
  return stages * slot_bytes_for(chunk_rows, row_bytes) + 2 * stages * (int)sizeof(uint64_t);
}

// DMA_STAGES slots, fewer (down to 2) where they do not fit a block
int stages_for(int chunk_rows, int row_bytes) {
  int stages = DMA_STAGES;
  while (stages > 2 && smem_for(chunk_rows, row_bytes, stages) > SMEM_OPTIN) --stages;
  return stages;
}

// SMs and resident blocks an SM of `kernel` (threads, smem), or a CUDA error
template <typename Kernel>
cudaError_t residency(Kernel kernel, int threads, int smem, int& sms, int& per_sm) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && smem > 0)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidValue;
  return err;
}

}  // namespace

// o = 2 * x over x (B, T, L) with row_bytes = L * element size, a multiple of
// 16; x and y 16-byte aligned. Slabs of (rows, tile, L), a block an equal
// piece (at most 16 KB) of a slab's row.
extern "C" int scale_copy_launch(const void* x, void* y, int B, long long T, int row_bytes, int tile, int rows,
                                 int dtype, void* stream) {
  if (B <= 0 || T <= 0 || row_bytes <= 0 || row_bytes % 16 || tile <= 0 || rows <= 0 ||
      (dtype != DT_BF16 && dtype != DT_F32))
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (T + tile - 1) / tile, groups = (B + rows - 1) / rows;
  const long long seg16 = (tile < T ? tile : T) * (row_bytes / 16);  // a full row segment
  const long long ppr = (seg16 + PIECE - 1) / PIECE;
  if (n_tiles * groups * rows * ppr > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(n_tiles * groups * rows * ppr);
  const int piece16 = (int)((seg16 + ppr - 1) / ppr);
  auto s = static_cast<cudaStream_t>(stream);
  const uint4* xs = static_cast<const uint4*>(x);
  uint4* ys = static_cast<uint4*>(y);
  if (dtype == DT_BF16)
    scale_copy_kernel<DT_BF16><<<grid, SCALE_THREADS, 0, s>>>(xs, ys, B, T, row_bytes / 16, tile, rows, (int)n_tiles,
                                                              (int)ppr, piece16);
  else
    scale_copy_kernel<DT_F32><<<grid, SCALE_THREADS, 0, s>>>(xs, ys, B, T, row_bytes / 16, tile, rows, (int)n_tiles,
                                                             (int)ppr, piece16);
  return (int)cudaGetLastError();
}

// Dynamic shared memory a dma_copy block needs: its ring's slots and 2 mbarriers a slot.
extern "C" int dma_copy_smem_bytes(int chunk_rows, int row_bytes) {
  return smem_for(chunk_rows, row_bytes, stages_for(chunk_rows, row_bytes));
}

// o = 2 * x over n_rows rows of row_bytes (a multiple of 16), chunk_rows rows
// per bulk copy through a ring of 4 slots (fewer where they do not fit); x and
// y 16-byte aligned. A persistent grid of SMs x resident blocks (fewer if
// there are fewer chunks).
extern "C" int dma_copy_launch(const void* x, void* y, long long n_rows, int row_bytes, int chunk_rows, int dtype,
                               void* stream) {
  if (n_rows <= 0 || row_bytes <= 0 || row_bytes % 16 || chunk_rows <= 0 || (dtype != DT_BF16 && dtype != DT_F32))
    return (int)cudaErrorInvalidValue;
  if ((long long)chunk_rows * row_bytes >= (1LL << 20)) return (int)cudaErrorInvalidValue;  // mbarrier tx count
  const int stages = stages_for(chunk_rows, row_bytes);
  const int smem = smem_for(chunk_rows, row_bytes, stages);
  int sms = 0, per_sm = 0;
  const cudaError_t err = dtype == DT_BF16 ? residency(dma_copy_kernel<DT_BF16>, DMA_THREADS, smem, sms, per_sm)
                                           : residency(dma_copy_kernel<DT_F32>, DMA_THREADS, smem, sms, per_sm);
  if (err != cudaSuccess) return (int)err;
  const long long n_chunks = (n_rows + chunk_rows - 1) / chunk_rows;
  const long long grid = n_chunks < (long long)sms * per_sm ? n_chunks : (long long)sms * per_sm;
  auto s = static_cast<cudaStream_t>(stream);
  const char* xs = static_cast<const char*>(x);
  char* ys = static_cast<char*>(y);
  const int slot = slot_bytes_for(chunk_rows, row_bytes);
  if (dtype == DT_BF16)
    dma_copy_kernel<DT_BF16><<<(unsigned)grid, DMA_THREADS, smem, s>>>(xs, ys, n_rows, row_bytes, chunk_rows, slot,
                                                                       stages);
  else
    dma_copy_kernel<DT_F32><<<(unsigned)grid, DMA_THREADS, smem, s>>>(xs, ys, n_rows, row_bytes, chunk_rows, slot,
                                                                      stages);
  return (int)cudaGetLastError();
}

