// Grouped transposed 2D conv of FreqCodec's decoder (SConvTranspose2d), bf16,
// one launch over every group and the whole batch:
//
//   y[b, g Cog + o, fo, to] = bias[g Cog + o]
//     + sum over ci, (fi, kf), (ti, kt) with fo = fi sf + kf, to = ti st + kt of
//       x[b, g Cig + ci, fi, ti] * w[g Cig + ci, o, kf, kt]
//
// with kernel (2 sf, 2 st), stride (sf, st), no padding, written untrimmed and
// contiguous: y is (B, Cout, (F + 1) sf, (T + 1) st). The time_group_norm
// after it takes its statistics over the whole output and the trim is a view
// (ops/conv.apply_sconv_transpose2d), as in the reference.
//
// It replaces no TPU kernel: the JAX package leaves this conv to XLA
// (funcodec_tpu/ops/conv.py, apply_sconv_transpose2d). It was added because
// cuDNN runs the grouped bf16 transposed 2D conv as a data-gradient, group by
// group (a dgrad_engine launch and a scaleTensor_kernel a group, 52 of each
// for gr8's four convs): 36.8 ms of a 161 ms serving batch on the H100, for
// ~1.5 GB of tensors, and not the same bits from run to run.
//
// What bounds it: bytes. A group takes Cig = 16 input channels to Cog = 8
// output channels (gr8), so an output element costs 64 multiply-adds for
// 2 bytes written: ~40 operations a byte, far below the ~295 at which the
// tensor cores become the limit.
//
// Design:
//
// - Polyphase. The kernel is twice the stride on both axes, so output
//   (fo, to) = (qf sf + pf, qt st + pt), cell (qf, qt) and phase (pf, pt), sums
//   exactly four input points, (qf - df, qt - dt) with df, dt in {0, 1},
//   through weight tap (pf + df sf, pt + dt st). The cells are (F + 1) x
//   (T + 1); points outside x are zeros.
// - One product a (tap, 16 input channels): mma.sync m16n8k16, A the tap's
//   weights for 16 rows (two phases x 8 output channels), B 16 input channels
//   x 8 cells along time, fp32 accumulators; a warp takes 16 cells and all
//   phases, so the four taps' B fragments serve every phase.
// - A block is (group, 8 output channels, a tile of at most 160 cells along
//   time) and a run of at most 16 steps of the walk over (sample, cell row),
//   cell row fastest. The weight fragments are built once into shared memory
//   in the order a lane reads them (one 16-byte load a fragment). Input rows
//   qf - 1 and qf sit in a two-row ring, channels innermost ([cell column]
//   [channel], columns padded by 16 bytes so the ldmatrix of 8 columns hits 8
//   bank groups), so any time offset is a legal ldmatrix row; the next step's
//   row is loaded as aligned 16-byte vectors into registers while this step
//   is computed, then scattered into the ring. A sample's first step finds
//   the previous step's row zero (row F lies outside x), as row -1 must be.
// - The epilogue starts the sums at the bias, rounds once to bf16 and writes
//   the step's sf output rows a channel into shared memory, packed (2 or 4
//   outputs a store where st is 1 or 2). A warp then stores a staged row as
//   aligned 16-byte vectors, each put together from two staged vectors by a
//   funnel shift (the rows of y start at any element: (T + 1) st is odd for
//   gr8's last conv), scalars at the ragged ends.
// - The launch cuts the walk into runs that fill whole waves of resident
//   blocks (an occupancy query): a part-empty last wave had cost the small
//   convs about a third of their time.
// - No atomics and no split sums: the same input gives the same bits.
//
// Supported: bf16 x, weight, bias and y; kernel = 2 x stride on both axes;
// sf * st <= 8; Cin / groups <= 64 and Cout / groups <= 64 (padded with zero
// weights to 16 input and 8 output channels; narrower groups share a block,
// its weights block-diagonal, e.g. 8 of FreqCodec gr1's 2 -> 1); no padding,
// output padding or dilation. ops/convtr2d_kernel.convtr2d_reference is the
// plain version.

#include <algorithm>

#include "resblock_tgn.cuh"

namespace {

using funcodec::rb::ldsm4;
using funcodec::rb::mma_bf16;
using funcodec::rb::pack_bf;
using funcodec::rb::smem_u32;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_QT = 160;       // cells of a time tile
constexpr int MAX_STEPS = 16;     // steps of the (sample, cell row) walk a block
constexpr int MAX_PHASES = 8;     // sf * st
constexpr int MAX_GROUP_WIDTH = 64;
constexpr int NV_MAX = (MAX_QT + 8) / 8 + 1;  // 16-byte vectors a channel's window row spans

struct Args {
  const bf16* x;
  const bf16* w;
  const bf16* bias;  // nullptr: none
  bf16* y;
  long long x_numel;
  int Cin, F, T, sf, st;
  int G, Cig, Cog;  // blocks of S groups, and their input and output channels (S times a group's)
  int S, cig, cog;  // groups a block, and a group's own channels
  int OG;     // runs of 8 output channels in a block's S groups
  int QT;     // cells of a time tile, a multiple of 16
  int NT;     // time tiles
  int steps;  // steps of the walk a block (the last block's may be fewer), set at launch
  int total;  // steps of the walk: B (F + 1)
};

__host__ __device__ constexpr int ring_stride(int ks) { return ks * 16 + 8; }  // elements a cell column
__host__ __device__ constexpr int stage_stride(int qt, int st) { return qt * st + 24; }  // 8 ahead, 16 behind

// weight fragments, the two-row ring, the staged output rows and their offsets in y
__host__ __device__ inline unsigned smem_bytes(int ks, int rb, int qt, int sf, int st) {
  return (unsigned)(ks * rb * 4 * 512 + 2 * (qt + 1) * ring_stride(ks) * 2 + 8 * sf * stage_stride(qt, st) * 2 +
                    8 * sf * 8);
}

// element e of 8 packed bf16
__device__ __forceinline__ bf16 elem(const uint4& v, int e) {
  const uint32_t w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return __ushort_as_bfloat16((unsigned short)(e & 1 ? w >> 16 : w & 0xffffu));
}

// elements K .. K + 7 of the 16 in (lo, hi)
template <int K>
__device__ __forceinline__ uint4 funnel(const uint4& lo, const uint4& hi) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = K % 2 ? __funnelshift_r(w[K / 2 + j], w[K / 2 + j + 1], 16) : w[K / 2 + j];
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ uint4 shifted(const uint4& lo, const uint4& hi, int k) {
  switch (k) {
    case 1: return funnel<1>(lo, hi);
    case 2: return funnel<2>(lo, hi);
    case 3: return funnel<3>(lo, hi);
    case 4: return funnel<4>(lo, hi);
    case 5: return funnel<5>(lo, hi);
    case 6: return funnel<6>(lo, hi);
    case 7: return funnel<7>(lo, hi);
    default: return hi;
  }
}

// 5 blocks an SM where the accumulators and window registers allow it without spills
template <int KS, int RB>
__global__ void __launch_bounds__(THREADS, KS * RB <= 2 ? 5 : 4) convtr2d_kernel(const Args a) {
  constexpr int RS = ring_stride(KS), CP = KS * 16;           // ring columns' stride, padded input channels
  constexpr int PER = (CP * NV_MAX + THREADS - 1) / THREADS;  // window vectors a thread holds
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* wf = reinterpret_cast<uint4*>(smem);  // [tap][ks][rb][lane]: one A fragment a lane
  bf16* ring = reinterpret_cast<bf16*>(smem + KS * RB * 4 * 512);
  const int ring_row = (a.QT + 1) * RS;
  const int srow = stage_stride(a.QT, a.st);
  bf16* stg = ring + 2 * ring_row;  // [channel][pf][8 + output column of the tile]
  long long* row_at = reinterpret_cast<long long*>(stg + 8 * a.sf * srow);  // [channel][pf]: y offset, less the step's

  int item = blockIdx.x;  // og fastest: the blocks that read one window run together
  const int og = item % a.OG;
  item /= a.OG;
  const int tile = item % a.NT;
  item /= a.NT;
  const int g = item % a.G, run = item / a.G;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = a.sf * a.st, NQ = a.F + 1, Fo = NQ * a.sf, To = (a.T + 1) * a.st, Cout = a.G * a.Cog;
  const int q0 = tile * a.QT, nq = min(a.QT, a.T + 1 - q0);  // the tile's first cell and its cells
  const int sa = run * a.steps, sb = min(sa + a.steps, a.total);  // the block's steps
  const int n_out = min(8, a.Cog - og * 8);                       // output channels of this block
  // window column j holds ti = q0 - 1 + j; the columns inside x:
  const int t_lo = max(q0 - 1, 0), t_hi = min(q0 + a.QT, a.T);
  const int j_lo = t_lo - q0 + 1, j_hi = t_hi - q0 + 1;
  const int n_vec = CP * ((a.QT + 8) / 8 + 1);
  const long long FT = (long long)a.F * a.T;

  // 1. the weight fragments (zero for padded phases and channels), the ring zeroed
  bf16* wfe = reinterpret_cast<bf16*>(wf);
  for (int i = tid; i < KS * RB * 4 * 256; i += THREADS) {
    const int e = i & 7, l = (i >> 3) & 31, f = i >> 8;
    const int rb = f % RB, ks = (f / RB) % KS, tap = f / (RB * KS);
    const int r = (l >> 2) + ((e >> 1) & 1) * 8, k = 2 * (l & 3) + (e & 1) + (e >> 2) * 8;
    const int p = 2 * rb + (r >> 3), o = og * 8 + (r & 7), ci = ks * 16 + k;
    bf16 v = __float2bfloat16_rn(0.0f);
    if (p < P && o < a.Cog && ci < a.Cig && o / a.cog == ci / a.cig) {  // block-diagonal over the S groups
      const int kf = p / a.st + (tap >> 1) * a.sf, kt = p % a.st + (tap & 1) * a.st;
      v = a.w[(((size_t)(g * a.Cig + ci) * a.cog + o % a.cog) * (2 * a.sf) + kf) * (2 * a.st) + kt];
    }
    wfe[i] = v;
  }
  for (int i = tid; i < 2 * ring_row / 8; i += THREADS) reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  const int o_lane = og * 8 + (lane >> 2);
  const float bias_v = a.bias != nullptr && o_lane < a.Cog ? __bfloat162float(a.bias[g * a.Cog + o_lane]) : 0.0f;
  for (int r = tid; r < n_out * a.sf; r += THREADS)
    row_at[r] = ((long long)(g * a.Cog + og * 8 + r / a.sf) * Fo + r % a.sf) * To + (long long)q0 * a.st;
  __syncthreads();

  // 2. input row fi of sample b: its aligned vectors into registers, then scattered into a ring
  //    slot (channels fastest across the threads: a warp's scatter hits distinct banks)
  auto row_base = [&](int b, int fi) { return ((long long)b * a.Cin + g * a.Cig) * FT + (long long)fi * a.T; };
  auto load_row = [&](int b, int fi, uint4 (&v)[PER]) {
    if (fi < 0 || fi >= a.F) return;
    const long long rb0 = row_base(b, fi);
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * THREADS, ci = i % CP;
      if (i >= n_vec || ci >= a.Cig) continue;
      const long long base = rb0 + ci * FT;
      const long long vv = ((base + t_lo) >> 3) + i / CP;
      if (vv > (base + t_hi - 1) >> 3) continue;
      if (8 * vv + 8 <= a.x_numel) {
        v[u] = __ldg(reinterpret_cast<const uint4*>(a.x + 8 * vv));
      } else {  // the tensor's last, partial vector
        uint32_t h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) h[e] = 8 * vv + e < a.x_numel ? __bfloat16_as_ushort(a.x[8 * vv + e]) : 0u;
        v[u] = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16, h[6] | h[7] << 16);
      }
    }
  };
  auto store_row = [&](int b, int fi, bf16* s, const uint4 (&v)[PER]) {  // s: column j = ti - q0 + 1
    if (fi < 0 || fi >= a.F) {  // a row outside x: zeros (its halo columns are zero already)
      const int span = t_hi - t_lo;
      for (int i = tid; i < CP * span; i += THREADS)
        if (i % CP < a.Cig) s[(j_lo + i / CP) * RS + i % CP] = __float2bfloat16_rn(0.0f);
      return;
    }
    const long long rb0 = row_base(b, fi);
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * THREADS, ci = i % CP;
      if (i >= n_vec || ci >= a.Cig) continue;
      const long long base = rb0 + ci * FT;
      const long long vv = ((base + t_lo) >> 3) + i / CP;
      if (vv > (base + t_hi - 1) >> 3) continue;
      const int j0 = (int)(8 * vv - base) - q0 + 1;  // the vector's first element's column
      bf16* sv = s + j0 * RS + ci;
      if (j0 >= j_lo && j0 + 8 <= j_hi) {  // the row's inner vectors
#pragma unroll
        for (int e = 0; e < 8; ++e) sv[e * RS] = elem(v[u], e);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (j0 + e >= j_lo && j0 + e < j_hi) sv[e * RS] = elem(v[u], e);
      }
    }
  };
  auto slot = [&](int step) { return ring + (step & 1) * ring_row; };  // the df = 0 row of a step

  // this lane's ldmatrix row: matrices (cells 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
  const int lm_cell = (lane & 7) + (lane >> 4) * 8, lm_k = ((lane >> 3) & 1) * 8;
  const int gid = lane >> 2, tig = lane & 3;

  uint4 pend[PER];
  load_row(sa / NQ, sa % NQ - 1, pend);  // row -1 of a sample: zeros
  store_row(sa / NQ, sa % NQ - 1, slot(sa - 1), pend);
  load_row(sa / NQ, sa % NQ, pend);
  store_row(sa / NQ, sa % NQ, slot(sa), pend);
  for (int s = sa; s < sb; ++s) {
    const int b = s / NQ, qf = s % NQ;
    const bool next = s + 1 < sb;
    if (next) load_row((s + 1) / NQ, (s + 1) % NQ, pend);  // in flight through the product and the stores
    __syncthreads();  // this step's rows are in the ring; the staging is free

    // 3. the product: warp w takes cells 16 t .. 16 t + 15 for t = w, w + WARPS, ...
    for (int n0 = warp * 16; n0 < nq; n0 += WARPS * 16) {
      float acc[RB][2][4];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[rb][c][e] = bias_v;
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        const int df = tap >> 1, dt = tap & 1;
        const uint32_t addr = smem_u32(slot(s - df) + (n0 + lm_cell + 1 - dt) * RS + lm_k);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t bx[4];
          ldsm4(addr + ks * 32, bx);
#pragma unroll
          for (int rb = 0; rb < RB; ++rb) {
            const uint4 f = wf[((tap * KS + ks) * RB + rb) * 32 + lane];
            const uint32_t af[4] = {f.x, f.y, f.z, f.w};
            mma_bf16(acc[rb][0], af, bx[0], bx[1]);
            mma_bf16(acc[rb][1], af, bx[2], bx[3]);
          }
        }
      }
      // one rounding, into the staging rows of channel gid; a lane holds cells n, n + 1 of two phases
      if (gid < n_out) {
        bf16* so = stg + gid * a.sf * srow + 8;
#pragma unroll
        for (int rb = 0; rb < RB; ++rb)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int n = n0 + 8 * c + 2 * tig;
            const float* v = acc[rb][c];  // (n, 2 rb), (n + 1, 2 rb), (n, 2 rb + 1), (n + 1, 2 rb + 1)
            if (a.st == 1) {  // phase p is row pf = p
              if (2 * rb < P) *reinterpret_cast<uint32_t*>(so + 2 * rb * srow + n) = pack_bf(v[0], v[1]);
              if (2 * rb + 1 < P) *reinterpret_cast<uint32_t*>(so + (2 * rb + 1) * srow + n) = pack_bf(v[2], v[3]);
            } else if (a.st == 2) {  // phases 2 rb, 2 rb + 1 are (pf = rb, pt = 0, 1): four outputs in a row
              *reinterpret_cast<uint2*>(so + rb * srow + 2 * n) = make_uint2(pack_bf(v[0], v[2]), pack_bf(v[1], v[3]));
            } else {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int p = 2 * rb + h;
                if (p >= P) continue;
                bf16* sp = so + (p / a.st) * srow + p % a.st;
                sp[n * a.st] = __float2bfloat16_rn(v[2 * h]);
                sp[(n + 1) * a.st] = __float2bfloat16_rn(v[2 * h + 1]);
              }
            }
          }
      }
    }
    __syncthreads();  // the staging is whole; ring slot (s - 1) is free

    // 4. each staged row (channel, pf) to y: warp-wide 16-byte vectors at y's alignment, scalars at the ends
    const int L = nq * a.st;
    const long long step_at = ((long long)b * Cout * Fo + (long long)qf * a.sf) * To;
    for (int r = warp; r < n_out * a.sf; r += WARPS) {
      const long long gs = row_at[r] + step_at;  // the row's first element in y
      const int sh = (int)(gs & 7);
      bf16* yr = a.y + (gs - sh);  // aligned
      const bf16* sr = stg + r * srow;  // element 8 + c is column c
      for (int vi = lane; 8 * vi < sh + L; vi += 32) {
        const uint4 hi = *reinterpret_cast<const uint4*>(sr + 8 * vi + 8);
        const uint4 v = sh ? shifted(*reinterpret_cast<const uint4*>(sr + 8 * vi), hi, 8 - sh) : hi;
        if (8 * vi >= sh && 8 * vi + 8 <= sh + L) {
          *reinterpret_cast<uint4*>(yr + 8 * vi) = v;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (8 * vi + e >= sh && 8 * vi + e < sh + L) yr[8 * vi + e] = elem(v, e);
        }
      }
    }
    if (next) store_row((s + 1) / NQ, (s + 1) % NQ, slot(s + 1), pend);  // into the slot of step s - 1's row
  }
}

// Cuts the walk of B (F + 1) steps into runs of at most MAX_STEPS, as many as fill whole waves of
// the card's resident blocks, and launches them.
template <int KS, int RB>
int launch_as(Args a, unsigned smem, cudaStream_t stream) {
  auto kernel = convtr2d_kernel<KS, RB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const long long items = (long long)a.G * a.NT * a.OG, slots = (long long)sms * per_sm;
  const long long waves = (a.total * items + slots * MAX_STEPS - 1) / (slots * MAX_STEPS);
  long long runs = std::max(1LL, waves * slots / items);
  a.steps = (int)((a.total + runs - 1) / runs);
  runs = (a.total + a.steps - 1) / a.steps;
  if (runs * items >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)(runs * items), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int KS>
int launch_ks(const Args& a, int rb, unsigned smem, cudaStream_t stream) {
  switch (rb) {
    case 1: return launch_as<KS, 1>(a, smem, stream);
    case 2: return launch_as<KS, 2>(a, smem, stream);
    case 3: return launch_as<KS, 3>(a, smem, stream);
    default: return launch_as<KS, 4>(a, smem, stream);
  }
}

}  // namespace

// y (B, Cout, (F + 1) sf, (T + 1) st) = the grouped transposed conv of x
// (B, Cin, F, T) by w (Cin, Cout / groups, 2 sf, 2 st) plus bias (Cout; may
// be null), all bf16 and contiguous on the current device, x and y 16-byte
// aligned. One launch on `stream`; returns the CUDA error, or
// cudaErrorInvalidValue for a shape outside the kernel's range.
extern "C" int convtr2d_launch(const void* x, const void* w, const void* bias, void* y, int B, int Cin, int F, int T,
                               int groups, int Cout, int sf, int st, void* stream) {
  if (B <= 0 || F <= 0 || T <= 0 || groups <= 0 || Cin <= 0 || Cout <= 0 || Cin % groups || Cout % groups ||
      sf <= 0 || st <= 0 || sf * st > MAX_PHASES || Cin / groups > MAX_GROUP_WIDTH ||
      Cout / groups > MAX_GROUP_WIDTH || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(y) % 16 ||
      (long long)B * (F + 1) >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const bf16*>(bias);
  a.y = static_cast<bf16*>(y);
  a.x_numel = (long long)B * Cin * F * T;
  a.Cin = Cin, a.F = F, a.T = T, a.sf = sf, a.st = st;
  a.cig = Cin / groups, a.cog = Cout / groups;
  // narrow groups share a block (as many as fill 16 input and 8 output channels), so that
  // 2 -> 1 channels a group costs what 16 -> 8 does
  a.S = std::max(1, std::min(16 / a.cig, 8 / a.cog));
  while (groups % a.S) --a.S;
  a.G = groups / a.S, a.Cig = a.S * a.cig, a.Cog = a.S * a.cog;
  a.OG = (a.Cog + 7) / 8;
  a.NT = (T + 1 + MAX_QT - 1) / MAX_QT;
  a.QT = ((T + 1 + a.NT - 1) / a.NT + 15) / 16 * 16;
  a.total = B * (F + 1);
  const int ks = (a.Cig + 15) / 16, rb = (sf * st + 1) / 2;
  const unsigned smem = smem_bytes(ks, rb, a.QT, sf, st);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ks) {
    case 1: return launch_ks<1>(a, rb, smem, s);
    case 2: return launch_ks<2>(a, rb, smem, s);
    case 3: return launch_ks<3>(a, rb, smem, s);
    default: return launch_ks<4>(a, rb, smem, s);
  }
}
