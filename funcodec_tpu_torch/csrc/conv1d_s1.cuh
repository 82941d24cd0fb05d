// Shared by the fused stride-1 conv's sources: conv1d_s1.cu (the regime
// choice and the C entries), conv1d_s1_thin.cu (one input or one output
// channel), conv1d_s1_tc.cuh with conv1d_s1_tc.cu (the persistent
// tensor-core kernel) and conv1d_s1_legacy.cu (the first kernel,
// variant "legacy"). What the conv computes and the design of each kernel
// are described at the top of conv1d_s1.cu.

#pragma once

#include "common.cuh"

namespace funcodec {
namespace conv {

// Which kernel a layer runs (conv1d_s1_regime). ops/conv_kernel.plan mirrors
// plan_of, tc_layout and tc_blocks_per_sm for the CPU tests; the card test
// tests/test_torch_kernels.py::test_cuda_conv_plan_mirrors_the_launch is what
// keeps the two copies in sync.
enum Regime { LEGACY = 0, THIN = 1, TC_RESIDENT = 2, TC_STREAMED = 3 };

constexpr int TC_TILE = 256;                  // time steps a tensor-core work item
constexpr unsigned TC_MAX_SMEM = 232448;      // 227 KB a block
constexpr unsigned SM_SMEM = 233472;          // 228 KB an SM, 1 KB of it reserved for each resident block
constexpr int TC_MAX_BLOCKS = 2;              // 128 registers a thread (__launch_bounds__(256, 2))

__host__ __device__ inline unsigned tc_align128(unsigned v) { return (v + 127u) / 128u * 128u; }

// Shared memory of a tensor-core block, in bytes from its start. Rows of the
// window, the time-major chunk, the weights and the output tile are odd
// numbers of 16-byte pieces long, so the 8 row addresses of an ldmatrix /
// stmatrix fall into 8 different bank groups. The two window buffers sit on
// either side of the time-major chunk (raw0 | xe | raw1): where the output
// tile fits into a window buffer and the chunk (alias), it takes the pair
// that holds no load in flight, and needs no space of its own.
// ops/conv_kernel.tc_layout mirrors it.
struct TcLayout {
  int halo_l;  // window start before the tile: round_up(left, 8)
  int win;     // window row: tile + both halos, in whole 8-step pieces
  int rows;    // rows of the time-major chunk: TC_TILE + (K - 1) * dil
  int lde, ldw, ldo, n_ch;
  bool alias;  // the output tile over (window buffer, chunk)
  unsigned wst_bytes, raw_bytes, xe_bytes, wst, raw0, xe, raw1, out, bias, dummy, total;
};

__host__ __device__ inline TcLayout tc_layout(int NO, int CC, int Cin, int Cout, int K, int dil, int left,
                                              bool resident) {
  TcLayout l;
  const int span = (K - 1) * dil;
  l.halo_l = round_up(left, 8);
  l.win = TC_TILE + l.halo_l + round_up(span - left, 8);
  if ((l.win / 8) % 2 == 0) l.win += 8;
  l.rows = TC_TILE + span;
  l.lde = CC + 8;
  l.ldw = K * CC + 8;
  l.ldo = TC_TILE + 8;
  l.n_ch = Cin / CC;
  l.wst_bytes = tc_align128((unsigned)NO * l.ldw * 2);
  l.raw_bytes = tc_align128((unsigned)CC * l.win * 2 + 64);  // the transposing pass reads up to 3 pieces past a row
  l.xe_bytes = tc_align128((unsigned)l.rows * l.lde * 2);
  const unsigned out_bytes = tc_align128((unsigned)NO * l.ldo * 2);
  l.alias = out_bytes <= l.raw_bytes + l.xe_bytes;
  unsigned off = 0;
  l.wst = off, off += (resident ? (unsigned)l.n_ch : 2u) * l.wst_bytes;
  l.raw0 = off, off += l.raw_bytes;
  l.xe = off, off += l.xe_bytes;
  l.raw1 = off, off += l.raw_bytes;
  l.out = off, off += l.alias ? 0u : out_bytes;
  l.bias = off, off += tc_align128((unsigned)Cout * 4);
  l.dummy = off, off += 128;
  l.total = off;
  return l;
}

// Blocks of a tensor-core kernel that fit on an SM with `smem` bytes of
// shared memory each (0: it does not fit a block).
__host__ __device__ inline int tc_blocks_per_sm(unsigned smem) {
  if (smem > TC_MAX_SMEM) return 0;
  const int by_smem = (int)(SM_SMEM / (smem + 1024u));
  return by_smem < TC_MAX_BLOCKS ? by_smem : TC_MAX_BLOCKS;
}

struct Plan {
  Regime regime;
  int no, cc;  // output channels a work item, input channels a chunk (tensor cores)
};

Plan plan_of(int Cin, int Cout, int K, int dil, int left, int dtype, int variant);

struct TcArgs {
  const void *x, *w, *bias;
  void* y;
  int B, Cin, Cout, T_, K, dil, left, pad_mode, act;
  cudaStream_t stream;
};

// The tensor-core launch of a plan (conv1d_s1_tc.cu; a == nullptr: its
// resident blocks an SM, -1 on error).
int tc_dispatch(int no, int cc, bool resident, unsigned smem, const TcArgs* a);

// The thin kernels (conv1d_s1_thin.cu).
bool thin_applies(int Cin, int Cout, int K, int dil, int left);
unsigned thin_smem(int Cin, int Cout, int K);
int thin_launch(const void* x, const void* w, const void* bias, void* y, int B, int Cin, int Cout, int T_, int K,
                int left, int pad_mode, int act, cudaStream_t s);

// The first kernel. w is (Cout, K, Cin) in x's type.
int legacy_launch(const void* x, const void* w, const void* bias, void* y, int B, int Cin, int Cout, int T_, int K,
                  int dil, int left, int pad_mode, int act, int dtype, cudaStream_t s);
int legacy_smem_bytes(int Cin, int Cout, int K, int dil, int dtype);

}  // namespace conv
}  // namespace funcodec
