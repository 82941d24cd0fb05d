// The tensor-core kernel of the fused stride-1 conv for work items of 16, 32
// or 64 output channels (conv1d_s1_tc.cuh): 12 instances.

#include "conv1d_s1_tc.cuh"

namespace funcodec {
namespace conv {

template <int NO>
static int dispatch_cc(int cc, bool resident, unsigned smem, const TcArgs* a) {
  if (cc == 32) return resident ? tc::dispatch<NO, 32, true>(smem, a) : tc::dispatch<NO, 32, false>(smem, a);
  return resident ? tc::dispatch<NO, 16, true>(smem, a) : tc::dispatch<NO, 16, false>(smem, a);
}

int tc_dispatch(int no, int cc, bool resident, unsigned smem, const TcArgs* a) {
  if (no == 16) return dispatch_cc<16>(cc, resident, smem, a);
  if (no == 32) return dispatch_cc<32>(cc, resident, smem, a);
  if (no == 64) return dispatch_cc<64>(cc, resident, smem, a);
  return a == nullptr ? -1 : (int)cudaErrorInvalidValue;
}

}  // namespace conv
}  // namespace funcodec
