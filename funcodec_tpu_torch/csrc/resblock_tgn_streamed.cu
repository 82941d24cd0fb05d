// resblock_tgn for the widest SEANet block, (C, H) = (256, 128): the
// persistent kernel with its weights streamed through a ring. What the block
// computes, the passes and the rounding points are described at the top of
// resblock_tgn.cu; the shared device code is in resblock_tgn.cuh.

#include "resblock_tgn.cuh"

namespace funcodec {
namespace rb {
namespace {

// 393 KB of weights do not fit, so every GEMM walks its K dimension in
// slices of KS columns of the weight matrix (all its rows), which all
// threads copy with cp.async into a ring of NS stages, NS - 1 slices ahead
// of the one being multiplied; one barrier a slice. The sequence of slices
// runs on across work items, so the ring never drains between tiles, and
// the next item's window rides in the group of the item's first slice.
// Warps split a 64-step tile 4 ways in time and 2 ways in output channels
// (64 fp32 accumulators a thread at N = 256), so v crosses warps through
// shared memory here, time-major like the ELU'd window.

constexpr int KS = 32;       // weight columns a slice
constexpr int NS = 3;        // ring stages
constexpr int LDS = KS + 8;  // a slice row in a stage: 5 chunks of 16 bytes
constexpr int STT = 64;      // time steps a tile

struct SLayout {
  int halo_l, win, rows, lde, ldo, ldv;
  unsigned bias, raw, raw_bytes, xe, vt, ring, stage_bytes, red, dummy, total;
};

__host__ __device__ inline SLayout slayout(int C, int H, int K, int dil, int left) {
  SLayout l;
  const int span = (K - 1) * dil;
  l.halo_l = round_up(left, 8);
  l.win = STT + l.halo_l + round_up(span - left, 8);
  if ((l.win / 8) % 2 == 0) l.win += 8;
  l.rows = STT + span;
  l.lde = C + 8;
  l.ldo = STT + 8;
  l.ldv = H + 8;
  unsigned off = 0;
  l.bias = off, off += align128((unsigned)(H + 2 * C) * 4);
  l.raw_bytes = align128((unsigned)C * l.win * 2 + 64);
  l.raw = off, off += 2 * l.raw_bytes;
  const unsigned xe_elems = (unsigned)l.rows * l.lde, out_elems = (unsigned)C * l.ldo;
  l.xe = off, off += align128((xe_elems > out_elems ? xe_elems : out_elems) * 2);
  l.vt = off, off += align128((unsigned)STT * l.ldv * 2);
  l.stage_bytes = align128((unsigned)(C > H ? C : H) * LDS * 2);
  l.ring = off, off += NS * l.stage_bytes;
  l.red = off, off += 2 * WARPS * 4 * sizeof(double);
  l.dummy = off, off += 128;
  l.total = off;
  return l;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int C, int H, int MODE>
__global__ void __launch_bounds__(THREADS)
resblock_tgn_streamed(const bf16* __restrict__ x, const bf16* __restrict__ w1, const float* __restrict__ b1,
                      const bf16* __restrict__ w2, const float* __restrict__ b2, const bf16* __restrict__ ws,
                      const float* __restrict__ bs, const float* __restrict__ aff, double* __restrict__ part,
                      bf16* __restrict__ y, int B, int T_, int n_t, int K, int dil, int left, int pad_mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  static_assert(C % KS == 0 && H % KS == 0, "whole slices");
  constexpr int N1 = H / 2, N2 = C / 2;  // output channels a warp owns
  const SLayout L = slayout(C, H, K, dil, left);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int n_items = B * n_t;
  const int right = (K - 1) * dil - left;
  const bool fast = T_ % 8 == 0;
  const int S1 = K * C / KS;
  constexpr int S2 = MODE != 0 ? H / KS : 0, S3 = MODE != 1 ? C / KS : 0;
  const int n_s = S1 + S2 + S3;  // slices a work item
  const int my_items = (n_items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int total = my_items * n_s;

  float* b1s = reinterpret_cast<float*>(smem + L.bias);
  float* b2s = b1s + H;
  float* bss = b2s + C;
  bf16* xe = reinterpret_cast<bf16*>(smem + L.xe);
  bf16* vt = reinterpret_cast<bf16*>(smem + L.vt);
  double* red = reinterpret_cast<double*>(smem + L.red);
  const uint32_t dummy_a = smem_u32(smem + L.dummy), ring_a = smem_u32(smem + L.ring);
  auto raw_of = [&](int buf) { return reinterpret_cast<bf16*>(smem + L.raw + buf * L.raw_bytes); };
  auto window = [&](int li) {  // of this block's li-th item
    const int item = blockIdx.x + li * gridDim.x, b = item / n_t;
    load_window(raw_of(li & 1), x + (size_t)b * C * T_, C, L.win, (item - b * n_t) * STT - L.halo_l, T_, fast, left,
                right, pad_mode);
  };
  // slice f of this block's sequence into its stage
  auto issue = [&](int f) {
    if (f >= total) return;
    const int s = f % n_s;
    const bf16* src;
    int ld, rows;
    if (s < S1) {
      src = w1 + s * KS, ld = K * C, rows = H;
    } else if (s < S1 + S2) {
      src = w2 + (s - S1) * KS, ld = H, rows = C;
    } else {
      src = ws + (s - S1 - S2) * KS, ld = C, rows = C;
    }
    const uint32_t dst = ring_a + (f % NS) * L.stage_bytes;
    for (int i = tid; i < rows * (KS / 8); i += THREADS) {
      const int n = i / (KS / 8), ch = i % (KS / 8);
      cp_async16(dst + (n * LDS + ch * 8) * 2, src + (size_t)n * ld + ch * 8);
    }
  };

  for (int i = tid; i < H; i += THREADS) b1s[i] = b1[i];
  for (int i = tid; i < C; i += THREADS) {
    b2s[i] = b2[i];
    bss[i] = bs[i];
  }
  window(0);
  for (int f = 0; f < NS - 1; ++f) {
    issue(f);
    cp_async_commit();
  }

  int consumed = 0;  // slices multiplied so far
  // Makes the next slice visible to every thread, refills the stage freed by
  // the slice before it, and returns the slice's address. Its barrier is also
  // the one that orders everything else in the tile.
  auto advance = [&]() {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (consumed % n_s == 0 && consumed / n_s + 1 < my_items) window(consumed / n_s + 1);
    issue(consumed + NS - 1);
    cp_async_commit();
    return ring_a + (consumed++ % NS) * L.stage_bytes;
  };

  const int rw = (warp >> 1) * 16, nh = warp & 1;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  const uint32_t xe_a = smem_u32(xe) + ((rw + a_row) * L.lde + a_col) * 2;
  const uint32_t vt_a = smem_u32(vt) + ((rw + a_row) * L.ldv + a_col) * 2;
  const int s_off = (b_row * L.win + L.halo_l + rw + b_col) * 2;
  const int b1_off = ((nh * N1 + b_row) * LDS + b_col) * 2;  // this warp's rows of a conv1 slice
  const int b2_off = ((nh * N2 + b_row) * LDS + b_col) * 2;  // of a conv2 / shortcut slice

  for (int li = 0; li < my_items; ++li) {
    const int item = blockIdx.x + li * gridDim.x;
    bf16* raw = raw_of(li & 1);
    const int b = item / n_t, t0 = (item - b * n_t) * STT, nt = min(STT, T_ - t0);
    const int p0 = t0 - L.halo_l;
    const bf16* xb = x + (size_t)b * C * T_;
    const float* ab = aff + (size_t)b * 6 * C;

    uint32_t stage = advance();  // conv1's first slice; the window arrived in an older group
    if (fast && (p0 < 0 || p0 + L.win > T_)) {
      fix_pads(raw, xb, C, L.win, p0, T_, left, right, pad_mode);
      __syncthreads();
    }
    elu_transpose(raw, xe, dummy_a, C, L.win, L.lde, L.rows, L.halo_l - left);
    __syncthreads();

    double st[4] = {0.0, 0.0, 0.0, 0.0};
    float acc1[1][N1 / 8][4];
    zero<1, N1>(acc1);
    for (int s = 0; s < S1; ++s) {
      if (s > 0) stage = advance();
      const int k = s * KS / C, c0 = s * KS - k * C;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
        uint32_t a[1][4];
        ldsm4(xe_a + (k * dil * L.lde + c0 + kk) * 2, a[0]);
        mma_step<1, N1>(acc1, a, stage + b1_off + kk * 2, LDS * 2);
      }
    }

    float acc[1][N2 / 8][4];
    uint32_t cn[1][N2 / 8][2];
    if constexpr (MODE == 0) {
      stats_of<1, N1>(acc1, b1s + nh * N1, rw, nt, st[0], st[1]);
    } else {
      // v = ELU(tgn1(b)) rounded, to shared memory (time-major): conv2 needs every h
#pragma unroll
      for (int j = 0; j < N1 / 8; ++j) {
        const int h = nh * N1 + 8 * j + 2 * q;
        const float2 bias = *reinterpret_cast<const float2*>(b1s + h);
        const float2 A = *reinterpret_cast<const float2*>(ab + h), D = *reinterpret_cast<const float2*>(ab + C + h);
        const float* v = acc1[0][j];
        *reinterpret_cast<uint32_t*>(vt + (rw + g) * L.ldv + h) =
            pack_bf(funcodec::elu(round_bf(v[0] + bias.x) * A.x + D.x), funcodec::elu(round_bf(v[1] + bias.y) * A.y + D.y));
        *reinterpret_cast<uint32_t*>(vt + (rw + g + 8) * L.ldv + h) =
            pack_bf(funcodec::elu(round_bf(v[2] + bias.x) * A.x + D.x), funcodec::elu(round_bf(v[3] + bias.y) * A.y + D.y));
      }
      // c = conv2(v); the first slice's barrier makes v visible
      zero<1, N2>(acc);
#pragma unroll 1
      for (int s = 0; s < S2; ++s) {
        stage = advance();
#pragma unroll
        for (int kk = 0; kk < KS; kk += 16) {
          uint32_t a[1][4];
          ldsm4(vt_a + (s * KS + kk) * 2, a[0]);
          mma_step<1, N2>(acc, a, stage + b2_off + kk * 2, LDS * 2);
        }
      }
      if constexpr (MODE == 1)
        stats_of<1, N2>(acc, b2s + nh * N2, rw, nt, st[0], st[1]);
      else
        normalise<1, N2>(acc, b2s + nh * N2, ab + 2 * C + nh * N2, ab + 3 * C + nh * N2, cn);
    }

    if constexpr (MODE != 1) {
      zero<1, N2>(acc);
      const uint32_t s_a = smem_u32(raw) + s_off;
#pragma unroll 1
      for (int s = 0; s < S3; ++s) {
        stage = advance();
#pragma unroll
        for (int kk = 0; kk < KS; kk += 16) {
          uint32_t a[1][4];
          ldsm4_t(s_a + (s * KS + kk) * L.win * 2, a[0]);
          mma_step<1, N2>(acc, a, stage + b2_off + kk * 2, LDS * 2);
        }
      }
    }

    if constexpr (MODE == 0) stats_of<1, N2>(acc, bss + nh * N2, rw, nt, st[2], st[3]);
    if constexpr (MODE != 2) {
      block_stats(st, red + (li & 1) * WARPS * 4, part + (size_t)item * 4);
    } else {
      // xe was last read in conv1, slices and barriers ago
      write_out<1, N2>(xe + nh * N2 * L.ldo, L.ldo, rw, acc, cn, bss + nh * N2, ab + 4 * C + nh * N2,
                       ab + 5 * C + nh * N2);
      __syncthreads();
      store_tile<STT>(xe, L.ldo, y + (size_t)b * C * T_, C, t0, nt, T_, fast);
    }
  }
  cp_async_wait<0>();
}


template <int MODE>
int dispatch(int C, int H, int K, int dil, int left, const Args* a) {
  return launch_or_count(resblock_tgn_streamed<256, 128, MODE>, slayout(C, H, K, dil, left).total, STT, a);
}

}  // namespace

bool streamed_applies(int C, int H, int K, int dil, int left) {
  return C == 256 && H == 128 && (K * C) % KS == 0 && slayout(C, H, K, dil, left).total <= MAX_SMEM;
}

int streamed_tile() { return STT; }

unsigned streamed_smem_bytes(int C, int H, int K, int dil, int left) { return slayout(C, H, K, dil, left).total; }

int streamed_dispatch(int mode, int C, int H, int K, int dil, int left, const Args* a) {
  if (mode == 0) return dispatch<0>(C, H, K, dil, left, a);
  if (mode == 1) return dispatch<1>(C, H, K, dil, left, a);
  return dispatch<2>(C, H, K, dil, left, a);
}

}  // namespace rb
}  // namespace funcodec
