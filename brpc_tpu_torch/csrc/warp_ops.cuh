// Warp-level sums and scans in wrapping 32-bit arithmetic, shared by the
// port's kernels. Every lane of the warp must call them.
#pragma once

namespace brpc_tpu_torch {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFullMask, v, d);
  return v;
}

// Inclusive prefix sum over the lanes: lane l gets v[0] + ... + v[l].
__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned n = __shfl_up_sync(kFullMask, v, d);
    if (lane >= d) v += n;
  }
  return v;
}

}  // namespace brpc_tpu_torch
