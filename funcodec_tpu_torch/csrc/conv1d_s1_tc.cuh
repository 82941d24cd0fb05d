// The persistent tensor-core kernel of the fused stride-1 conv (its design is
// described at the top of conv1d_s1.cu), instantiated by conv1d_s1_tc.cu.

#pragma once

#include "conv1d_s1.cuh"
#include <type_traits>

#include "resblock_tgn.cuh"

namespace funcodec {
namespace conv {
namespace tc {

using namespace funcodec::rb;  // bf16, THREADS, WARPS, PTX wrappers, pad_value, mma_step, zero

template <int NO>
struct Shape {
  static constexpr int WC = NO;                   // output channels a warp: all of the tile's
  static constexpr int WT = WARPS;                // warps along time
  static constexpr int MT = TC_TILE / (WT * 16);  // 16-row mma tiles a warp: two
  static_assert(NO <= 64 && MT * WT * 16 == TC_TILE, "warp grid");
};

// 16-byte vectors of 8 time steps, or 8 / 4 bytes where T is a multiple of 4 / 2 only
template <int BYTES>
__device__ __forceinline__ void cp_async_n(uint32_t dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(BYTES) : "memory");
}

template <int V>
__device__ __forceinline__ void load_pieces(bf16* dst, const bf16* __restrict__ xb, int C, int win, int p0, int T_) {
  const int WC = win / V;
  for (int i = threadIdx.x; i < C * WC; i += THREADS) {
    const int c = i / WC, m = i - c * WC, p = p0 + V * m;
    if (p >= 0 && p + V <= T_) cp_async_n<2 * V>(smem_u32(dst + c * win + V * m), xb + (size_t)c * T_ + p);
  }
}

// The window chunk (time p0 .. p0 + win of C rows at xb) into dst: vec-element
// asynchronous copies (vec 8 or 4) of the pieces inside [0, T); T % vec == 0
// and p0 % 8 == 0, so a piece lies wholly inside or outside. vec 1: scalar
// loads with the pad values.
__device__ __forceinline__ void load_window_v(bf16* dst, const bf16* __restrict__ xb, int C, int win, int p0, int T_,
                                              int vec, int left, int right, int pad_mode) {
  if (vec == 8) {
    load_pieces<8>(dst, xb, C, win, p0, T_);
  } else if (vec == 4) {
    load_pieces<4>(dst, xb, C, win, p0, T_);
  } else {
    for (int i = threadIdx.x; i < C * win; i += THREADS) {
      const int c = i / win, j = i - c * win;
      dst[c * win + j] = pad_value(xb + (size_t)c * T_, p0 + j, T_, left, right, pad_mode);
    }
  }
}

template <int ACT>
__device__ __forceinline__ uint32_t act2(uint32_t u, int act) {
  if constexpr (ACT == ACT_NONE) return u;
  const float2 f = unpack_bf(u);
  if constexpr (ACT == ACT_ELU) return pack_bf(funcodec::elu(f.x), funcodec::elu(f.y));
  return pack_bf(funcodec::act_fn(f.x, act), funcodec::act_fn(f.y, act));
}

// Making the time-major chunk xe (rows of lde, row r at step p0 + r,
// p0 = t0 - left) of C channels from the raw window of an item: the rows
// inside [0, T) are transposed and activated unit by unit (make_units), the
// pad rows (steps in [-left, 0) and [T, T + right)) are computed by index
// arithmetic and activated (make_pads). Rows past the halo of the ragged
// last tile feed no stored output and are not written.
struct Chunk {
  const bf16* raw;  // the window: C rows of win steps from step w0
  bf16* xe;
  const bf16* xc;   // the sample's first row of the chunk in x
  int p0, w0, lo, hi, n_units;
};

__device__ __forceinline__ Chunk chunk_of(const bf16* raw, bf16* xe, const bf16* xc, int C, int win, int rows,
                                          int halo_l, int t0, int T_, int left) {
  Chunk k;
  k.raw = raw, k.xe = xe, k.xc = xc;
  k.p0 = t0 - left, k.w0 = t0 - halo_l;
  k.lo = max(0, -k.p0), k.hi = min(rows, T_ - k.p0);
  k.n_units = (C / 8) * ((win / 8 + 3) / 4);
  return k;
}

// The transposition unit by unit, warp w taking units w, w + 8, ...:
// xe[r][c] = act(raw[c][r + p0 - w0]) for lo <= r < hi. A unit is 8 channels x
// 32 steps: ldmatrix.trans in, the activation on the fragments, stmatrix out
// (resblock_tgn.cuh elu_transpose, for any act and a range of rows). ACT -1:
// act at run time.
template <int ACT>
__device__ __forceinline__ void make_units_t(const Chunk& k, uint32_t dummy_a, int win, int lde, int act) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int WC = win / 8, n_u = (WC + 3) / 4, shift = k.p0 - k.w0;
  const uint32_t raw_a = smem_u32(k.raw), xe_s = smem_u32(k.xe);
  for (int unit = warp; unit < k.n_units; unit += WARPS) {
    const int cg = unit / n_u, m = 4 * (unit - cg * n_u) + (lane >> 3);
    uint32_t r[4];
    ldsm4_t(raw_a + ((cg * 8 + (lane & 7)) * win + m * 8) * 2, r);
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = act2<ACT>(r[i], act);
    const int row = m * 8 + (lane & 7) - shift;
    stsm4(row >= k.lo && row < k.hi && m < WC ? xe_s + (row * lde + cg * 8) * 2 : dummy_a, r);
  }
}

__device__ __forceinline__ void make_units(const Chunk& k, uint32_t dummy_a, int win, int lde, int act) {
  if (act == ACT_NONE)
    make_units_t<ACT_NONE>(k, dummy_a, win, lde, act);
  else if (act == ACT_ELU)
    make_units_t<ACT_ELU>(k, dummy_a, win, lde, act);
  else
    make_units_t<-1>(k, dummy_a, win, lde, act);
}

// The pad rows. A pad value's source step lies in [0, T), and in the window
// whenever the tile is not shorter than the pad: it is read there, else from x.
__device__ __forceinline__ void make_pads(const Chunk& k, int C, int win, int lde, int rows, int T_, int right,
                                          int pad_mode, int act) {
  const int n_lo = k.lo, hi_end = min(rows, T_ + right - k.p0), n_hi = hi_end > k.hi ? hi_end - k.hi : 0;
  for (int i = threadIdx.x; i < (n_lo + n_hi) * C; i += THREADS) {
    const int j = i / C, c = i - j * C, r = j < n_lo ? j : k.hi + (j - n_lo);
    const int src = funcodec::pad_index(k.p0 + r, T_, pad_mode);
    float v = 0.0f;
    if (src >= 0)
      v = __bfloat162float(src >= k.w0 && src < k.w0 + win ? k.raw[c * win + src - k.w0] : k.xc[(size_t)c * T_ + src]);
    k.xe[r * lde + c] = __float2bfloat16_rn(funcodec::act_fn(v, act));
  }
}

// ot[c][row] = round(acc + bias[c]) for this warp's rows (from row0) and
// the tile's channels (bias_s starts at the tile's first channel)
template <int MT, int N>
__device__ __forceinline__ void write_tile(bf16* ot, int ldo, int row0, const float (&acc)[MT][N / 8][4],
                                           const float* bias_s) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = 8 * j + 2 * q;
      const float2 bias = *reinterpret_cast<const float2*>(bias_s + c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ot[(c + (e & 1)) * ldo + row0 + mt * 16 + g + 8 * (e >> 1)] =
            __float2bfloat16_rn(acc[mt][j][e] + ((e & 1) ? bias.y : bias.x));
    }
}

template <int V>
__device__ __forceinline__ void store_pieces(const bf16* ot, int ldo, bf16* __restrict__ yb, int C, int t0, int nt,
                                             int T_) {
  using Vec = typename std::conditional<V == 8, uint4, typename std::conditional<V == 4, uint2, bf16>::type>::type;
  for (int i = threadIdx.x; i < C * (TC_TILE / V); i += THREADS) {
    const int c = i / (TC_TILE / V), t = (i % (TC_TILE / V)) * V;
    if (t < nt) *reinterpret_cast<Vec*>(yb + (size_t)c * T_ + t0 + t) = *reinterpret_cast<const Vec*>(ot + c * ldo + t);
  }
}

// The output tile ot (C rows of ldo, channel-major) to y in vec-element
// vectors (nt and t0 are multiples of vec; vec 1: scalars)
__device__ __forceinline__ void store_tile_v(const bf16* ot, int ldo, bf16* __restrict__ yb, int C, int t0, int nt,
                                             int T_, int vec) {
  if (vec == 8)
    store_pieces<8>(ot, ldo, yb, C, t0, nt, T_);
  else if (vec == 4)
    store_pieces<4>(ot, ldo, yb, C, t0, nt, T_);
  else
    store_pieces<1>(ot, ldo, yb, C, t0, nt, T_);
}

template <int NO, int CC, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 2)
conv1d_s1_tc(const bf16* __restrict__ x,     // (B, Cin, T)
             const bf16* __restrict__ wp,    // (Cin / CC, Cout, K, CC)
             const float* __restrict__ bias, // (Cout)
             bf16* __restrict__ y,           // (B, Cout, T)
             int Cin, int Cout, int T_, int n_items, int n_t, int K, int dil, int left, int pad_mode, int act) {
  using S = Shape<NO>;
  extern __shared__ __align__(128) unsigned char smem[];
  const TcLayout L = tc_layout(NO, CC, Cin, Cout, K, dil, left, RESIDENT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_o = Cout / NO, n_ch = L.n_ch;
  const int right = (K - 1) * dil - left;
  const int vec = T_ % 8 == 0 ? 8 : (T_ % 4 == 0 ? 4 : 1);  // the vector width the rows of x and y allow
  const int my_items = (n_items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;  // the grid has at most one block an item
  const int total = my_items * n_ch;                                          // stages: (item, chunk)

  float* bias_s = reinterpret_cast<float*>(smem + L.bias);
  const uint32_t smem_a = smem_u32(smem), dummy_a = smem_u32(smem + L.dummy);
  auto raw_of = [&](int f) { return reinterpret_cast<bf16*>(smem + ((f & 1) ? L.raw1 : L.raw0)); };
  bf16* xe = reinterpret_cast<bf16*>(smem + L.xe);
  // the output tile of stage f: over the chunk and the window buffer next to
  // it that holds no load in flight (stage f + 1 loads into the other one);
  // or its own space
  auto out_of = [&](int f) { return reinterpret_cast<bf16*>(smem + (L.alias ? ((f & 1) ? L.xe : L.raw0) : L.out)); };
  auto wst_of = [&](int f, int ch) { return L.wst + (unsigned)(RESIDENT ? ch : (f & 1)) * L.wst_bytes; };
  struct Stage {
    int b, tile, o, ch;
  };
  auto stage_of = [&](int f) {
    Stage st;
    const int li = f / n_ch, item = (int)blockIdx.x + li * (int)gridDim.x, bt = item / n_o;
    st.ch = f - li * n_ch;
    st.o = item - bt * n_o;
    st.b = bt / n_t;
    st.tile = bt - st.b * n_t;
    return st;
  };
  auto x_chunk = [&](const Stage& st) { return x + ((size_t)st.b * Cin + (size_t)st.ch * CC) * T_; };
  // chunk ch of output-channel tile o: NO rows of K * CC contiguous values
  auto copy_weights = [&](unsigned dst, int o, int ch) {
    const bf16* src = wp + ((size_t)ch * Cout + (size_t)o * NO) * K * CC;
    const int pieces = K * CC / 8;
    for (int i = tid; i < NO * pieces; i += THREADS) {
      const int n = i / pieces, p = i - n * pieces;
      cp_async16(smem_a + dst + (n * L.ldw + 8 * p) * 2, src + (size_t)n * K * CC + 8 * p);
    }
  };
  // stage f's window and (streamed) weight slice, asynchronously
  auto load = [&](int f) {
    if (f >= total) return;
    const Stage st = stage_of(f);
    load_window_v(raw_of(f), x_chunk(st), CC, L.win, st.tile * TC_TILE - L.halo_l, T_, vec, left, right, pad_mode);
    if (!RESIDENT) copy_weights(wst_of(f, st.ch), st.o, st.ch);
  };

  if (RESIDENT)  // one output-channel tile: the whole weight matrix, once a block
    for (int ch = 0; ch < n_ch; ++ch) copy_weights(L.wst + ch * L.wst_bytes, 0, ch);
  for (int i = tid; i < Cout; i += THREADS) bias_s[i] = bias[i];
  load(0);
  cp_async_commit();

  // this lane's ldmatrix addresses: A rows (time) of the chunk, B rows (output channel) of the weights;
  // warp w takes rows rw .. rw + 32 of the tile and all NO channels
  const int rw = warp * 16 * S::MT;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  const uint32_t a_lane = ((rw + a_row) * L.lde + a_col) * 2;
  const uint32_t w_lane = (b_row * L.ldw + b_col) * 2;

  float acc[S::MT][S::WC / 8][4];
  zero<S::MT, S::WC>(acc);
  // Stage f: its loads have arrived; stage f + 1's are issued; the chunk is
  // made time-major, then multiplied. Two or more blocks share an SM and
  // overlap each other's phases.
  for (int f = 0; f < total; ++f) {
    const Stage st = stage_of(f);
    cp_async_wait_all();
    __syncthreads();  // what stage f reads has arrived; every warp is done with stage f - 1
    load(f + 1);
    cp_async_commit();
    const Chunk chunk = chunk_of(raw_of(f), xe, x_chunk(st), CC, L.win, L.rows, L.halo_l, st.tile * TC_TILE, T_, left);
    make_units(chunk, dummy_a, L.win, L.lde, act);
    make_pads(chunk, CC, L.win, L.lde, L.rows, T_, right, pad_mode, act);
    __syncthreads();

    const uint32_t xe_a = smem_u32(xe) + a_lane, w_a = smem_a + wst_of(f, st.ch) + w_lane;
    for (int k = 0; k < K; ++k) {
      const uint32_t a_k = xe_a + k * dil * L.lde * 2, b_k = w_a + k * CC * 2;
#pragma unroll
      for (int c0 = 0; c0 < CC; c0 += 16) {
        uint32_t a[S::MT][4];
#pragma unroll
        for (int mt = 0; mt < S::MT; ++mt) ldsm4(a_k + (mt * 16 * L.lde + c0) * 2, a[mt]);
        mma_step<S::MT, S::WC>(acc, a, b_k + c0 * 2, L.ldw * 2);
      }
    }

    if (st.ch == n_ch - 1) {  // the item's last chunk: bias, one rounding, vector stores
      bf16* ot = out_of(f);
      if (L.alias) __syncthreads();  // every warp is done with what the tile overwrites
      write_tile<S::MT, S::WC>(ot, L.ldo, rw, acc, bias_s + st.o * NO);
      __syncthreads();
      const int t0 = st.tile * TC_TILE;
      store_tile_v(ot, L.ldo, y + ((size_t)st.b * Cout + (size_t)st.o * NO) * T_, NO, t0, min(TC_TILE, T_ - t0), T_,
                   vec);
      zero<S::MT, S::WC>(acc);
    }
  }
  cp_async_wait_all();
}

// Launches `kernel` on SMs x resident blocks (at most one block a work item),
// or with a == nullptr returns the resident blocks an SM (-1 on error).
template <typename Kernel>
int launch_or_count(Kernel kernel, unsigned smem, int no, const TcArgs* a) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (a == nullptr) return err == cudaSuccess ? per_sm : -1;
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const int n_t = (a->T_ + TC_TILE - 1) / TC_TILE;
  const long long n_items = (long long)a->B * n_t * (a->Cout / no);
  if (n_items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  long long grid = (long long)sms * per_sm;
  if (grid > n_items) grid = n_items;
  kernel<<<(unsigned)grid, THREADS, smem, a->stream>>>(
      static_cast<const bf16*>(a->x), static_cast<const bf16*>(a->w), static_cast<const float*>(a->bias),
      static_cast<bf16*>(a->y), a->Cin, a->Cout, a->T_, (int)n_items, n_t, a->K, a->dil, a->left, a->pad_mode,
      a->act);
  return (int)cudaGetLastError();
}

template <int NO, int CC, bool RESIDENT>
int dispatch(unsigned smem, const TcArgs* a) {
  return launch_or_count(conv1d_s1_tc<NO, CC, RESIDENT>, smem, NO, a);
}

}  // namespace tc
}  // namespace conv
}  // namespace funcodec
