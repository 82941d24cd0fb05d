// Fused [act ->] pad -> stride-1 dilated "same" conv1d + bias, for Hopper (sm_90a).
//
// Replaces funcodec_tpu/ops/conv_pallas.py::_kernel (launched from
// _fused_conv1d_s1_impl, entry fused_conv1d_s1). On torch's (B, C, T) layout:
//
//   y[b, o, t] = bias[o] + sum_{k, c} w[o, c, k] * act(xpad[b, c, t + k*d - left])
//
// with act in {none, ELU, ReLU, GELU(tanh)} applied in fp32 and rounded to
// x's type before the products (conv_pallas.py:43-56), the pad values
// (reflect / replicate / zero) taken straight from x by index arithmetic,
// fp32 accumulation, and one rounding of the sum to x's type.
//
// What bounds it: in bf16 a layer does 2*C_in*K*C_out FLOP for every
// 2*(C_in + C_out) bytes of x read and y written. The flagship's 1 -> 32 and
// 32 -> 1 convs (K = 7) have ~7 FLOP per byte and its C -> C/2, K = 3
// resblock convs 32 to 256, under the card's 295 FLOP per byte, so they are
// memory-bound; its 512 -> 128 and 128 -> 512 K = 7 convs (~720) are
// compute-bound.
//
// The launch picks one of three regimes from the shapes (plan_of; the
// choice is exported as conv1d_s1_regime and mirrored by ops/conv_kernel.plan):
//
// THIN (bf16, C_in == 1 or C_out == 1, dilation 1, K in {3, 5, 7}, "same" or
//   causal; conv1d_s1_thin.cu): a bytes-bound stream on the CUDA cores. Each
//   thread owns 8 consecutive time steps, one 16-byte vector a row; a warp
//   256 steps. The window's halo comes from the neighbouring lanes by
//   shuffles, and the warp's own halo (K - 1 values) from one scalar load of
//   each of its first K - 1 lanes, so every element is loaded and activated
//   once. The weights and bias sit in shared memory as fp32 and are read as
//   broadcasts. 1 -> C loads its window once and writes one vector per output
//   channel; C -> 1 reads one vector per input channel (the next channel's
//   load in flight while one is computed) and writes one. Rows with
//   T % 8 != 0 are not 16-byte aligned and take a scalar branch of the same
//   kernel.
//
// TC_RESIDENT / TC_STREAMED (bf16, C_in and C_out multiples of 16;
//   conv1d_s1_tc.cuh, instantiated in conv1d_s1_tc.cu): an implicit GEMM with
//   time as M on the tensor cores, on a persistent grid (SMs x resident
//   blocks, two an SM where shared memory allows) over (sample, time
//   tile, output-channel tile) work items, item = (sample * n_t + tile) * n_o
//   + o_tile; block i takes items i, i + gridDim.x, ...
//   (ops/conv_kernel.work_items mirrors it).
//   - A tile is 256 time steps and NO output channels (64, or 32 / 16 where
//     C_out is no multiple of 64); each of the 8 warps takes 32 rows and all
//     NO channels, so every weight ldmatrix feeds two 16-row mma.sync tiles.
//     A 128-channel tile (4 x 2 warps of 64 x 64, one block an SM, the next
//     chunk made between the products) was measured slower at all three
//     shapes it took (512 -> 128, 128 -> 512, 256 -> 128): with one block of
//     8 warps an SM nothing hid its barriers and shared-memory latencies.
//     So was a loop with two time-major chunks (one barrier a stage, chunk
//     f + 1 made beside chunk f's products): its extra buffers cost the
//     chunk size and the blocks an SM that the plan below keeps.
//   - Input channels are walked in chunks of CC, 32 or 16: of resident
//     before streamed weights and 32 before 16, plan_of takes the candidate
//     that keeps the most blocks on an SM (the heads' 16-channel chunks run
//     two blocks an SM where 32 runs one, and measured faster). A chunk's
//     raw window (CC rows of 256 + halo steps, channel-major as x lies)
//     arrives by 16-byte cp.async (8-byte where T % 8 != 0 but T % 4 == 0,
//     as at T = 500) into one of two buffers while the chunk before it is
//     made and multiplied; pad values are a fix-up of the first
//     and last tile of a sample only, of the positions outside [0, T) only.
//   - One ldmatrix.trans -> act -> stmatrix pass makes the chunk time-major,
//     so a tap is a row offset (always 16-byte aligned) and the activation
//     runs once per element of a work item: no im2col tile exists.
//   - Weights are packed once by the wrapper as (C_in / CC, C_out, K, CC),
//     so a chunk of an output-channel tile is NO contiguous rows. Where the
//     whole tile's weights fit (the k3 convs up to 128 -> 64: one channel
//     tile) they are resident, copied once per block (TC_RESIDENT); otherwise
//     each chunk's slice streams in with the window, one stage ahead
//     (TC_STREAMED). A slice feeds 256 time rows, so the heads' 917 KB of
//     weights cross L2 once per 256 rows of the batch.
//   - Product: mma.sync.m16n8k16 bf16 -> fp32, chosen over wgmma (m64nNk16, A
//     from registers, B from a pre-arranged 128-byte-swizzle image) by a
//     measurement: with every other phase switched off (a temporary switch
//     in this kernel, taken out again) the products took under half of each
//     shape's time, and at the heads the loads and the time-major pass
//     alone took more than cuDNN's whole conv. A faster product instruction
//     can only take off the products' share; the rest is the bound.
//   - Epilogue in registers: bias, one rounding, the tile transposed through
//     shared memory and stored channel-major as 16-byte vectors. Where it
//     fits, the output tile lies over the window buffer and the time-major
//     chunk the item's last stage used, so the k3 convs keep two blocks an SM.
//
// LEGACY (fp32, other channel counts or geometries, and variant "legacy"):
//   the first kernel, conv1d_s1_legacy.cu.

#include "conv1d_s1.cuh"

namespace funcodec {
namespace conv {

Plan plan_of(int Cin, int Cout, int K, int dil, int left, int dtype, int variant) {
  const Plan legacy{LEGACY, 0, 0};
  if (variant == 1 || dtype != 1) return legacy;
  if (thin_applies(Cin, Cout, K, dil, left)) return {THIN, 0, 0};
  if (Cin % 16 != 0 || Cout % 16 != 0) return legacy;
  const int no = Cout % 64 == 0 ? 64 : (Cout % 32 == 0 ? 32 : 16);
  // Candidates in order of preference: the weights resident (one output-
  // channel tile), then streamed; chunks of 32, then 16. The first that
  // keeps the most blocks on an SM wins: the heads' chunks of 16 run two
  // blocks an SM where 32 runs one, and measured faster.
  Plan best = legacy;
  int best_blocks = 0;
  for (int resident = 1; resident >= 0; --resident)
    for (int cc = 32; cc >= 16; cc -= 16) {
      if (Cin % cc != 0 || (resident && no != Cout)) continue;
      const int blocks = tc_blocks_per_sm(tc_layout(no, cc, Cin, Cout, K, dil, left, resident).total);
      if (blocks > best_blocks) best = {resident ? TC_RESIDENT : TC_STREAMED, no, cc}, best_blocks = blocks;
    }
  return best;
}

}  // namespace conv
}  // namespace funcodec

namespace {

using namespace funcodec::conv;

// The tensor-core launch of a plan, or with a == nullptr its resident blocks an SM.
int tc_launch(const Plan& p, int Cin, int Cout, int K, int dil, int left, const TcArgs* a) {
  const bool resident = p.regime == TC_RESIDENT;
  return tc_dispatch(p.no, p.cc, resident, tc_layout(p.no, p.cc, Cin, Cout, K, dil, left, resident).total, a);
}

bool bad_args(int Cin, int Cout, int K, int dil, int left, int dtype, int variant) {
  return Cin <= 0 || Cout <= 0 || K < 1 || dil < 1 || left < 0 || left > (K - 1) * dil || (dtype != 0 && dtype != 1) ||
         variant < 0 || variant > 1;
}

}  // namespace

using namespace funcodec::conv;

// x (B, Cin, T), bias (Cout) fp32, y (B, Cout, T), all contiguous and 16-byte
// aligned on the current device; dtype 0: fp32, 1: bf16. w in x's type, laid
// out for the regime (conv1d_s1_regime): (Cout, K, Cin) for the thin and
// legacy kernels, (Cin / CC, Cout, K, CC) with CC = conv1d_s1_chunk(...)
// for the tensor-core kernels. pad_mode 0/1/2 = reflect/replicate/zero, act
// 0/1/2/3 = none/ELU/ReLU/GELU; variant 0 picks the kernel, 1 forces the
// legacy one. Launches on `stream` and returns cudaGetLastError().
extern "C" int conv1d_s1_launch(const void* x, const void* w, const void* bias, void* y, int B, int Cin, int Cout,
                                int T_, int K, int dil, int left, int pad_mode, int act, int dtype, int variant,
                                void* stream) {
  if (B <= 0 || B > 65535 || T_ <= 0 || bad_args(Cin, Cout, K, dil, left, dtype, variant))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = plan_of(Cin, Cout, K, dil, left, dtype, variant);
  switch (p.regime) {
    case THIN:
      return thin_launch(x, w, bias, y, B, Cin, Cout, T_, K, left, pad_mode, act, s);
    case TC_RESIDENT:
    case TC_STREAMED: {
      const TcArgs a{x, w, bias, y, B, Cin, Cout, T_, K, dil, left, pad_mode, act, s};
      return tc_launch(p, Cin, Cout, K, dil, left, &a);
    }
    default:
      return legacy_launch(x, w, bias, y, B, Cin, Cout, T_, K, dil, left, pad_mode, act, dtype, s);
  }
}

// Which kernel conv1d_s1_launch runs: 0 legacy, 1 thin, 2 tensor cores with
// resident weights, 3 with streamed weights (-1 on bad arguments).
extern "C" int conv1d_s1_regime(int Cin, int Cout, int K, int dil, int left, int dtype, int variant) {
  if (bad_args(Cin, Cout, K, dil, left, dtype, variant)) return -1;
  return (int)plan_of(Cin, Cout, K, dil, left, dtype, variant).regime;
}

// Input channels a chunk of the tensor-core kernels (the packed weights'
// CC), output channels a work item (NO); 0 for the other regimes.
extern "C" int conv1d_s1_chunk(int Cin, int Cout, int K, int dil, int left, int dtype, int variant) {
  if (bad_args(Cin, Cout, K, dil, left, dtype, variant)) return -1;
  return plan_of(Cin, Cout, K, dil, left, dtype, variant).cc;
}

extern "C" int conv1d_s1_out_tile(int Cin, int Cout, int K, int dil, int left, int dtype, int variant) {
  if (bad_args(Cin, Cout, K, dil, left, dtype, variant)) return -1;
  return plan_of(Cin, Cout, K, dil, left, dtype, variant).no;
}

// Dynamic shared memory a block requests for this layer.
extern "C" int conv1d_s1_smem_bytes(int Cin, int Cout, int K, int dil, int left, int dtype, int variant) {
  if (bad_args(Cin, Cout, K, dil, left, dtype, variant)) return -1;
  const Plan p = plan_of(Cin, Cout, K, dil, left, dtype, variant);
  switch (p.regime) {
    case THIN: return (int)thin_smem(Cin, Cout, K);
    case TC_RESIDENT:
    case TC_STREAMED:
      return (int)tc_layout(p.no, p.cc, Cin, Cout, K, dil, left, p.regime == TC_RESIDENT).total;
    default: return legacy_smem_bytes(Cin, Cout, K, dil, dtype);
  }
}

// Blocks of the persistent tensor-core kernel that share an SM (its grid is
// SMs times this, at most one block a work item); 0 for the other regimes,
// -1 on a CUDA error.
extern "C" int conv1d_s1_blocks_per_sm(int Cin, int Cout, int K, int dil, int left, int dtype, int variant) {
  if (bad_args(Cin, Cout, K, dil, left, dtype, variant)) return -1;
  const Plan p = plan_of(Cin, Cout, K, dil, left, dtype, variant);
  if (p.regime != TC_RESIDENT && p.regime != TC_STREAMED) return 0;
  return tc_launch(p, Cin, Cout, K, dil, left, nullptr);
}
