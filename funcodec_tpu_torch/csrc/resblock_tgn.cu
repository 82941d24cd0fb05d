// One SEANet residual block with time_group_norm on all three convs, for
// Hopper (sm_90a):
//
//   out = tgn2(conv2_1x1(ELU(tgn1(conv1_kd(ELU(x)))))) + tgn3(shortcut_1x1(x))
//
// Replaces funcodec_tpu/ops/resblock_pallas.py::_rb_kernel (launched from
// _rb_pass in modes 0/1/2, entry fused_resblock_tgn). tgn is GroupNorm(1, C):
// statistics over all channels and time of a sample. They are global, so the
// block runs as three launches over (sample, time tile) work items, each
// recomputing the convs from x instead of storing them:
//
//   mode 0: b = conv1(ELU(x)), s = shortcut(x); per-tile (sum, sumsq) of b, s
//   mode 1: c = conv2(ELU(b * A1 + D1));        per-tile (sum, sumsq) of c
//   mode 2: out = round(c * A2 + D2) + round(s * A3 + D3)
//
// Between the passes resblock_tgn_finalize (one block per sample, in this
// source) adds the per-tile fp64 partials up in a fixed order and writes the
// per-(sample, channel) affines (A, D): no atomics, so the result (and the
// tokens) is the same from run to run and does not depend on which block
// took which tile, and the single-pass variance E[y^2] - mu^2 keeps fp64
// precision. Rounding points follow the TPU kernel
// (resblock_pallas.py:116-160): b rounded to x's type after its bias; tgn1
// applied in fp32 and not rounded before the ELU; v = ELU(.) rounded; c
// rounded; each normalised branch rounded; their sum in x's type.
//
// What bounds it: per block, x is read three times and out written once,
// and 15*C^2*T FLOP are done for the 6*C^2*T of one unfused forward. Over
// the flagship's 8 blocks at B = 64 x 10 s that is 7.1 GB (counted once) and
// 0.83 TFLOP (counted once): 2.1 ms at 3.35 TB/s. The narrow blocks (C = 32,
// T = 160,000) are memory-bound, the wide one (C = 256) compute-bound. What
// held the first version (resblock_tgn_legacy.cu) at 45x that bound was not
// bytes or FLOP but latency: 80,000 one-shot blocks a launch that each
// reloaded the weights, staged the window with scalar, bank-conflicted
// transposing stores, and went through six block-wide barriers and three
// fp32 round trips through shared memory with nothing in flight meanwhile.
//
// Design of the persistent kernels (bf16; this file for (C, H) one of
// (32, 16), (64, 32), (128, 64), shared device code in resblock_tgn.cuh):
//
// - A persistent grid: SMs x resident blocks; block i takes work items
//   i, i + gridDim.x, ... with item = sample * n_tiles + tile
//   (ops/resblock_kernel.work_items mirrors it). Partials stay per item.
// - The three weight matrices and biases are copied into shared memory once
//   per block, row-major with 16 bytes of padding a row, which is the layout
//   ldmatrix wants for the B operand of mma.sync.m16n8k16 (rows 8 apart fall
//   into 8 different 16-byte bank groups).
// - The raw window of the next work item arrives by 16-byte cp.async into
//   the second of two buffers while the current one is computed. x is
//   (B, C, T), so a window is C contiguous row segments and is copied as it
//   lies, channel-major; the window starts round_up(left, 8) steps before
//   the tile so every 16-byte chunk is aligned and lies wholly inside or
//   outside [0, T). Chunks outside are not loaded; reflect / replicate / zero
//   values are a fix-up of the first and last tile of a sample only. (When
//   T % 8 != 0 rows are not 16-byte aligned and the window is loaded with
//   scalar loads and pad_index; the main path never takes that.)
// - Layout of the operands, and why. conv1's tap k reads the window k*dil
//   steps later, and ldmatrix rows need 16-byte-aligned starts, which a
//   shift by one bf16 breaks in a channel-major layout. So the ELU'd operand
//   is time-major: one smem -> smem pass reads 8x8 blocks of the raw window
//   with ldmatrix.trans, applies the ELU on the fragments in registers and
//   writes them with stmatrix as rows of (time, channel); a tap is then a
//   row offset and always aligned, the ELU runs once per element, and both
//   sides are conflict-free (row strides are odd multiples of 16 bytes). K
//   shifted channel-major copies would cost K ELUs and K times the space.
//   The shortcut reads the raw window itself through ldmatrix.trans (its
//   offset, the left halo, is a multiple of 8).
// - Time is the M dimension. Each of the 8 warps owns 16 * MT time steps of
//   the tile and every output channel, so conv1's accumulators, after bias,
//   rounding, the tgn affine and the ELU in registers, are exactly the A
//   fragments of conv2 (the accumulator layout of m16n8k16 is its A layout):
//   v never leaves the registers and no barrier separates the three GEMMs.
//   The (sum, sumsq) partials are taken on the accumulators in fp64. There
//   is no fp32 tile in shared memory.
// - The output tile is transposed once through shared memory (the ELU'd
//   window's space, free by then) and stored with 16-byte vectors.
//
// (C, H) = (256, 128): 393 KB of weights do not fit, so
// resblock_tgn_streamed.cu runs the same frame with K-slices of the weights
// streamed through a cp.async ring (its header note says how). fp32 and
// other widths run the legacy kernel (resblock_tgn_legacy.cu): one block per
// (tile, sample), wmma fragments or the CUDA cores.

#include "resblock_tgn.cuh"

namespace {

using namespace funcodec::rb;
using funcodec::round_up;

// Shared memory of a block, in bytes from its start. Rows of every operand
// are an odd number of 16-byte chunks long, so the 8 row addresses of an
// ldmatrix / stmatrix fall into 8 different bank groups.
struct Layout {
  int tt;      // time steps a tile
  int halo_l;  // window start before the tile: round_up(left, 8)
  int win;     // window length (ldr): tile + both halos, in whole chunks
  int rows;    // rows of the ELU'd time-major window: tt + (K - 1) * dil
  int lde, ldo, ldw1, ldw2, ldws;
  unsigned w1, w2, ws, bias, raw, raw_bytes, xe, red, dummy, total;
};

__host__ __device__ inline Layout layout(int C, int H, int MT, int K, int dil, int left) {
  Layout l;
  const int span = (K - 1) * dil;
  l.tt = WARPS * 16 * MT;
  l.halo_l = round_up(left, 8);
  l.win = l.tt + l.halo_l + round_up(span - left, 8);
  if ((l.win / 8) % 2 == 0) l.win += 8;
  l.rows = l.tt + span;
  l.lde = C + 8;
  l.ldo = l.tt + 8;
  l.ldw1 = K * C + 8;
  l.ldw2 = H + 8;
  l.ldws = C + 8;
  unsigned off = 0;
  l.w1 = off, off += align128((unsigned)H * l.ldw1 * 2);
  l.w2 = off, off += align128((unsigned)C * l.ldw2 * 2);
  l.ws = off, off += align128((unsigned)C * l.ldws * 2);
  l.bias = off, off += align128((unsigned)(H + 2 * C) * 4);
  l.raw_bytes = align128((unsigned)C * l.win * 2 + 64);  // the ELU pass reads up to 3 chunks past a row
  l.raw = off, off += 2 * l.raw_bytes;
  const unsigned xe_elems = (unsigned)l.rows * l.lde, out_elems = (unsigned)C * l.ldo;
  l.xe = off, off += align128((xe_elems > out_elems ? xe_elems : out_elems) * 2);
  l.red = off, off += 2 * WARPS * 4 * sizeof(double);
  l.dummy = off, off += 128;
  l.total = off;
  return l;
}

// ---- weights resident in shared memory: (C, H) up to (128, 64) --------------

template <int C, int H, int MT, int MODE>
__global__ void __launch_bounds__(THREADS)
resblock_tgn_persistent(const bf16* __restrict__ x,     // (B, C, T)
                        const bf16* __restrict__ w1,    // (H, K, C)
                        const float* __restrict__ b1,   // (H)
                        const bf16* __restrict__ w2,    // (C, H)
                        const float* __restrict__ b2,   // (C)
                        const bf16* __restrict__ ws,    // (C, C)
                        const float* __restrict__ bs,   // (C)
                        const float* __restrict__ aff,  // (B, 6, C)
                        double* __restrict__ part,      // (B, n_t, 4) modes 0 and 1
                        bf16* __restrict__ y,           // (B, C, T) mode 2
                        int B, int T_, int n_t, int K, int dil, int left, int pad_mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(C, H, MT, K, dil, left);
  constexpr int TT = WARPS * 16 * MT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, q = lane & 3;
  const int n_items = B * n_t;
  const int right = (K - 1) * dil - left;
  const bool fast = T_ % 8 == 0;  // every row of x and y starts 16-byte aligned

  bf16* w1s = reinterpret_cast<bf16*>(smem + L.w1);
  bf16* w2s = reinterpret_cast<bf16*>(smem + L.w2);
  bf16* wss = reinterpret_cast<bf16*>(smem + L.ws);
  float* b1s = reinterpret_cast<float*>(smem + L.bias);
  float* b2s = b1s + H;
  float* bss = b2s + C;
  bf16* xe = reinterpret_cast<bf16*>(smem + L.xe);
  double* red = reinterpret_cast<double*>(smem + L.red);
  const uint32_t dummy_a = smem_u32(smem + L.dummy);
  auto raw_of = [&](int buf) { return reinterpret_cast<bf16*>(smem + L.raw + buf * L.raw_bytes); };
  auto window = [&](int item, bf16* dst) {
    const int b = item / n_t;
    load_window(dst, x + (size_t)b * C * T_, C, L.win, (item - b * n_t) * TT - L.halo_l, T_, fast, left, right,
                pad_mode);
    cp_async_commit();
  };

  window(blockIdx.x, raw_of(0));  // the grid has at most one block a work item

  // weights and biases, once per block
  {
    const int r1 = K * C / 8;
    for (int i = tid; i < H * r1; i += THREADS) {
      const int n = i / r1, k8 = i - n * r1;
      *reinterpret_cast<uint4*>(w1s + n * L.ldw1 + 8 * k8) = *reinterpret_cast<const uint4*>(w1 + (size_t)i * 8);
    }
    for (int i = tid; i < C * (H / 8); i += THREADS) {
      const int n = i / (H / 8), k8 = i % (H / 8);
      *reinterpret_cast<uint4*>(w2s + n * L.ldw2 + 8 * k8) = *reinterpret_cast<const uint4*>(w2 + (size_t)i * 8);
    }
    for (int i = tid; i < C * (C / 8); i += THREADS) {
      const int n = i / (C / 8), k8 = i % (C / 8);
      *reinterpret_cast<uint4*>(wss + n * L.ldws + 8 * k8) = *reinterpret_cast<const uint4*>(ws + (size_t)i * 8);
    }
    for (int i = tid; i < H; i += THREADS) b1s[i] = b1[i];
    for (int i = tid; i < C; i += THREADS) {
      b2s[i] = b2[i];
      bss[i] = bs[i];
    }
  }

  // this lane's ldmatrix addresses: A rows (time) of the ELU'd window, B rows
  // (output channel) of each weight matrix, A of the shortcut in the raw window
  const int rw = warp * 16 * MT;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  const uint32_t xe_a = smem_u32(xe) + ((rw + a_row) * L.lde + a_col) * 2;
  const uint32_t w1_a = smem_u32(w1s) + (b_row * L.ldw1 + b_col) * 2;
  const uint32_t w2_a = smem_u32(w2s) + (b_row * L.ldw2 + b_col) * 2;
  const uint32_t ws_a = smem_u32(wss) + (b_row * L.ldws + b_col) * 2;
  // shortcut: matrix rows are channels, a row's 16 bytes 8 time steps
  const int s_off = (b_row * L.win + L.halo_l + rw + b_col) * 2;

  int it = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
    const int buf = it & 1;
    bf16* raw = raw_of(buf);
    const int b = item / n_t, t0 = (item - b * n_t) * TT, nt = min(TT, T_ - t0);
    const int p0 = t0 - L.halo_l;
    const bf16* xb = x + (size_t)b * C * T_;
    const float* ab = aff + (size_t)b * 6 * C;

    cp_async_wait_all();
    __syncthreads();  // the window has arrived; the previous item's reads of xe and of the other buffer are over
    if (fast && (p0 < 0 || p0 + L.win > T_)) {
      fix_pads(raw, xb, C, L.win, p0, T_, left, right, pad_mode);
      __syncthreads();
    }
    if (item + (int)gridDim.x < n_items) window(item + gridDim.x, raw_of(buf ^ 1));
    elu_transpose(raw, xe, dummy_a, C, L.win, L.lde, L.rows, L.halo_l - left);
    __syncthreads();

    double st[4] = {0.0, 0.0, 0.0, 0.0};

    // b = conv1(ELU(x)): tap k reads the ELU'd window k*dil rows down
    float acc1[MT][H / 8][4];
    zero<MT, H>(acc1);
    for (int k = 0; k < K; ++k) {
      const uint32_t a_k = xe_a + k * dil * L.lde * 2, b_k = w1_a + k * C * 2;
#pragma unroll
      for (int c0 = 0; c0 < C; c0 += 16) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldsm4(a_k + (mt * 16 * L.lde + c0) * 2, a[mt]);
        mma_step<MT, H>(acc1, a, b_k + c0 * 2, L.ldw1 * 2);
      }
    }

    float acc[MT][C / 8][4];
    uint32_t cn[MT][C / 8][2];
    if constexpr (MODE == 0) {
      stats_of<MT, H>(acc1, b1s, rw, nt, st[0], st[1]);
    } else {
      // v = ELU(tgn1(b)) rounded, on the accumulators: they are conv2's A fragments
      uint32_t va[H / 16][MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < H / 8; ++j) {
          const int h = 8 * j + 2 * q;
          const float2 bias = *reinterpret_cast<const float2*>(b1s + h);
          const float2 A = *reinterpret_cast<const float2*>(ab + h), D = *reinterpret_cast<const float2*>(ab + C + h);
          const float* v = acc1[mt][j];
          va[j / 2][mt][(j & 1) * 2] = pack_bf(funcodec::elu(round_bf(v[0] + bias.x) * A.x + D.x),
                                               funcodec::elu(round_bf(v[1] + bias.y) * A.y + D.y));
          va[j / 2][mt][(j & 1) * 2 + 1] = pack_bf(funcodec::elu(round_bf(v[2] + bias.x) * A.x + D.x),
                                                   funcodec::elu(round_bf(v[3] + bias.y) * A.y + D.y));
        }
      // c = conv2(v)
      zero<MT, C>(acc);
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) mma_step<MT, C>(acc, va[kk], w2_a + kk * 32, L.ldw2 * 2);
      if constexpr (MODE == 1)
        stats_of<MT, C>(acc, b2s, rw, nt, st[0], st[1]);
      else
        normalise<MT, C>(acc, b2s, ab + 2 * C, ab + 3 * C, cn);
    }

    if constexpr (MODE != 1) {
      // s = shortcut(x): the raw window, channel-major, read transposed
      zero<MT, C>(acc);
      const uint32_t s_a = smem_u32(raw) + s_off;
#pragma unroll
      for (int c0 = 0; c0 < C; c0 += 16) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldsm4_t(s_a + (c0 * L.win + mt * 16) * 2, a[mt]);
        mma_step<MT, C>(acc, a, ws_a + c0 * 2, L.ldws * 2);
      }
    }

    if constexpr (MODE == 0) stats_of<MT, C>(acc, bss, rw, nt, st[2], st[3]);
    if constexpr (MODE != 2) {
      block_stats(st, red + buf * WARPS * 4, part + (size_t)item * 4);
    } else {
      // out = tgn2(c) + tgn3(s), transposed through shared memory (xe's space)
      __syncthreads();  // every warp is done with xe
      write_out<MT, C>(xe, L.ldo, rw, acc, cn, bss, ab + 4 * C, ab + 5 * C);
      __syncthreads();
      store_tile<TT>(xe, L.ldo, y + (size_t)b * C * T_, C, t0, nt, T_, fast);
    }
  }
  cp_async_wait_all();
}


// ---- host side ---------------------------------------------------------

enum Kind { LEGACY = 0, RESIDENT = 1, STREAMED = 2 };

// 16-step row groups a warp of the resident kernel: a tile is 128 * MT steps.
constexpr int mt_of(int C) { return C == 32 ? 2 : 1; }

// Which kernel runs a block of these widths and this conv1.
Kind kind_of(int C, int H, int K, int dil, int left, int dtype, int variant) {
  if (variant == 1 || dtype != 1) return LEGACY;
  if ((C == 32 && H == 16) || (C == 64 && H == 32) || (C == 128 && H == 64))
    return layout(C, H, mt_of(C), K, dil, left).total <= MAX_SMEM ? RESIDENT : LEGACY;
  return streamed_applies(C, H, K, dil, left) ? STREAMED : LEGACY;
}

template <int MODE>
int resident_dispatch(int C, int H, int K, int dil, int left, const Args* a) {
  const unsigned smem = layout(C, H, mt_of(C), K, dil, left).total;
  const int tt = WARPS * 16 * mt_of(C);
  if (C == 32) return launch_or_count(resblock_tgn_persistent<32, 16, mt_of(32), MODE>, smem, tt, a);
  if (C == 64) return launch_or_count(resblock_tgn_persistent<64, 32, mt_of(64), MODE>, smem, tt, a);
  return launch_or_count(resblock_tgn_persistent<128, 64, mt_of(128), MODE>, smem, tt, a);
}

// The launch of a persistent kernel, or with a == nullptr its resident blocks an SM.
int dispatch(int mode, Kind kind, int C, int H, int K, int dil, int left, const Args* a) {
  if (kind == STREAMED) return streamed_dispatch(mode, C, H, K, dil, left, a);
  if (mode == 0) return resident_dispatch<0>(C, H, K, dil, left, a);
  if (mode == 1) return resident_dispatch<1>(C, H, K, dil, left, a);
  return resident_dispatch<2>(C, H, K, dil, left, a);
}

// ---------------------------------------------------------------------------
// the finalize between the passes
// ---------------------------------------------------------------------------

constexpr int FIN_THREADS = 128;

struct FinPair {
  const float* gamma;  // (n_ch)
  const float* beta;   // (n_ch)
  int n_ch;            // channels of the normalised tensor
  int slot;            // A goes to aff[:, slot, :n_ch], D to aff[:, slot + 1, :n_ch]
};

// Block (b, p): the (sum, sumsq) in columns 2p, 2p + 1 of part[b] summed over
// the tiles (thread i takes tiles i, i + 128, ... in rising order, then a
// fixed tree over the threads), then tgn(y) = y * A + D with
// mu = sum / n, var = max(sumsq / n - mu^2, 0), rs = 1 / sqrt(var + 1e-5),
// A = rs * gamma, D = beta - (mu * rs) * gamma, in fp64, stored as fp32
// (ops/resblock_kernel.finalize_affine).
__global__ void __launch_bounds__(FIN_THREADS)
resblock_tgn_finalize_kernel(const double* __restrict__ part, int n_t, float* __restrict__ aff, int C, int T_,
                             FinPair p0, FinPair p1) {
  __shared__ double red[FIN_THREADS][2];
  const int b = blockIdx.x, tid = threadIdx.x;
  const FinPair p = blockIdx.y == 0 ? p0 : p1;
  const double* pb = part + (size_t)b * n_t * 4 + 2 * blockIdx.y;
  double s = 0.0, sq = 0.0;
  for (int t = tid; t < n_t; t += FIN_THREADS) {
    s += pb[(size_t)t * 4];
    sq += pb[(size_t)t * 4 + 1];
  }
  red[tid][0] = s;
  red[tid][1] = sq;
  __syncthreads();
  for (int off = FIN_THREADS / 2; off > 0; off >>= 1) {
    if (tid < off) {
      red[tid][0] += red[tid + off][0];
      red[tid][1] += red[tid + off][1];
    }
    __syncthreads();
  }
  const double n = (double)T_ * (double)p.n_ch;
  const double mu = red[0][0] / n;
  const double var = fmax(red[0][1] / n - mu * mu, 0.0);
  const double rs = 1.0 / sqrt(var + 1e-5);
  float* a = aff + ((size_t)b * 6 + p.slot) * C;
  for (int c = tid; c < p.n_ch; c += FIN_THREADS) {
    const double gm = (double)p.gamma[c];
    a[c] = (float)(rs * gm);
    a[C + c] = (float)((double)p.beta[c] - (mu * rs) * gm);
  }
}

}  // namespace


// One pass (mode 0/1/2, above). x (B, C, T), w1 (H, K, C), w2 (C, H), ws (C, C)
// in x's type (dtype 0: fp32, 1: bf16); b1 (H), b2 (C), bs (C), aff (B, 6, C)
// fp32; part (B, n_t, 4) fp64 with n_t = ceil(T / resblock_tgn_tile(...)); y
// (B, C, T). All contiguous and 16-byte aligned on the current device.
// variant 0 picks the kernel (a persistent one where it applies), 1 forces
// the legacy kernel. max_blocks > 0 caps a persistent grid. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int resblock_tgn_launch(int mode, const void* x, const void* w1, const void* b1,
                                   const void* w2, const void* b2, const void* ws, const void* bs,
                                   const void* aff, void* part, void* y, int B, int C, int H,
                                   int T_, int K, int dil, int left, int pad_mode, int dtype,
                                   int variant, int max_blocks, void* stream) {
  if (mode < 0 || mode > 2 || B <= 0 || B > 65535 || C <= 0 || H <= 0 || T_ <= 0 || K < 1 || dil < 1 ||
      left < 0 || left > (K - 1) * dil || variant < 0 || variant > 1 || max_blocks < 0 ||
      (long long)B * T_ >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Args a{x, w1, b1, w2, b2, ws, bs, aff, part, y, B, T_, K, dil, left, pad_mode, max_blocks,
               static_cast<cudaStream_t>(stream)};
  const Kind kind = kind_of(C, H, K, dil, left, dtype, variant);
  if (kind == LEGACY) return legacy_launch(mode, a, C, H, dtype);
  return dispatch(mode, kind, C, H, K, dil, left, &a);
}

// Which kernel resblock_tgn_launch runs for these arguments: 0 the legacy
// one, 1 the persistent kernel with resident weights, 2 with streamed weights.
extern "C" int resblock_tgn_kind(int C, int H, int K, int dil, int left, int dtype, int variant) {
  return (int)kind_of(C, H, K, dil, left, dtype, variant);
}

// Blocks of the persistent kernel that share an SM in pass `mode` (the grid
// is SMs times this, at most one block a work item); 0 where the legacy
// kernel runs, -1 on a CUDA error.
extern "C" int resblock_tgn_blocks_per_sm(int mode, int C, int H, int K, int dil, int left, int dtype, int variant) {
  const Kind kind = kind_of(C, H, K, dil, left, dtype, variant);
  if (mode < 0 || mode > 2 || kind == LEGACY) return 0;
  return dispatch(mode, kind, C, H, K, dil, left, nullptr);
}

// Time steps per tile (the partials' n_t = ceil(T / tile)).
extern "C" int resblock_tgn_tile(int C, int H, int K, int dil, int left, int dtype, int variant) {
  const Kind kind = kind_of(C, H, K, dil, left, dtype, variant);
  if (kind == STREAMED) return streamed_tile();
  return kind == RESIDENT ? WARPS * 16 * mt_of(C) : legacy_tile(C, H, dtype);
}

// Dynamic shared memory a block requests.
extern "C" int resblock_tgn_smem_bytes(int C, int H, int K, int dil, int left, int dtype, int variant) {
  const Kind kind = kind_of(C, H, K, dil, left, dtype, variant);
  if (kind == STREAMED) return (int)streamed_smem_bytes(C, H, K, dil, left);
  return kind == RESIDENT ? (int)layout(C, H, mt_of(C), K, dil, left).total : legacy_smem_bytes(C, H, K, dil, dtype);
}

// The affines of one or two normalisations from the partials of a pass:
// pair p reads columns 2p, 2p + 1 of part (B, n_t, 4) and writes
// aff[:, slot_p, :n_ch_p] (A) and aff[:, slot_p + 1, :n_ch_p] (D); gamma_p,
// beta_p (n_ch_p) fp32. aff is (B, 6, C); the normalised tensor has
// T * n_ch_p elements a sample.
extern "C" int resblock_tgn_finalize_launch(const void* part, int n_t, void* aff, int B, int C, int T_, int n_pairs,
                                            const void* gamma0, const void* beta0, int n_ch0, int slot0,
                                            const void* gamma1, const void* beta1, int n_ch1, int slot1,
                                            void* stream) {
  if (B <= 0 || B > 65535 || n_t <= 0 || C <= 0 || T_ <= 0 || n_pairs < 1 || n_pairs > 2 || n_ch0 <= 0 ||
      n_ch0 > C || slot0 < 0 || slot0 > 4 || (n_pairs == 2 && (n_ch1 <= 0 || n_ch1 > C || slot1 < 0 || slot1 > 4)))
    return (int)cudaErrorInvalidValue;
  const FinPair p0{static_cast<const float*>(gamma0), static_cast<const float*>(beta0), n_ch0, slot0};
  const FinPair p1{static_cast<const float*>(gamma1), static_cast<const float*>(beta1), n_ch1, slot1};
  resblock_tgn_finalize_kernel<<<dim3(B, n_pairs), FIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(part), n_t, static_cast<float*>(aff), C, T_, p0, p1);
  return (int)cudaGetLastError();
}
