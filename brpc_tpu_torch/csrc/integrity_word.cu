// B2: integrity word of one staged chunk, for sm_90a.
//
// Replaces brpc_tpu/device_path.py:38-49 (_integrity_word, run by
// _touch_kernel): sum over i of words[i] * (2i + 1), wrapping at 2^32.
//
// Bound: HBM bytes, 4 * n read once (a multiply and an add a word). At
// the device path's chunk sizes (0.5-2 MiB) the bytes take 0.15-0.6 us,
// so launch and ramp, not bytes, set the kernel's time.
//
// Design: one launch per call and no same-address atomics.
// - One thread-block cluster of 16 blocks (the non-portable maximum, where the card can place it; else the portable 8) does the
//   whole chunk. Each block reduces its threads' sums in shared memory;
//   cluster rank 0 then adds the blocks' partials through distributed
//   shared memory and writes the word. Nothing is pre-zeroed, there is
//   no global scratch, and so no state can leak between two streams or
//   two replays of a CUDA graph. The alternative, a grid of one block
//   per SM whose last block (by ticket) combines partials from global
//   scratch, needs a ticket per stream that must be reset, for the sake
//   of HBM bandwidth that a 1 MiB chunk cannot use: a cluster of 16
//   SMs with 64 KiB of loads in flight each reads it in about one
//   memory round trip. Larger inputs loop.
// - Wide loads: each thread issues kUnroll 16-byte loads (uint4) before
//   it uses any; in each round, neighbouring threads read neighbouring
//   vectors. Lanes x, y, z, w of the vector at word i take the
//   multipliers 2i+1, 2i+3, 2i+5, 2i+7, computed in `unsigned`, which
//   wraps like the JAX uint32 arange.
// - Any start and length: the words before the first 16-byte boundary
//   (head, at most 3) and after the last whole vector (tail, at most 3)
//   are read as scalars by cluster rank 0 in the same launch.
// Wrapping addition is associative and commutative, so the result is
// exact whatever the order of the partial sums.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "warp_ops.cuh"

namespace cg = cooperative_groups;
using brpc_tpu_torch::warp_sum;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// 8 vectors a thread: one round covers a 2 MiB chunk on 16 blocks, and
// 32 data registers keep the thread above 32 registers, so no SM can
// hold two 1024-thread blocks and the cluster spans as many SMs.
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads, 1)
integrity_word_kernel(const unsigned* __restrict__ words,
                      unsigned* __restrict__ out, long long n, int head) {
  __shared__ unsigned warp_part[kWarps];
  __shared__ unsigned block_part;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int t = threadIdx.x;

  const long long n_vec = (n - head) >> 2;
  const uint4* vec = reinterpret_cast<const uint4*>(words + head);
  const long long stride = (long long)cluster.num_blocks() * kThreads;
  unsigned acc = 0;
  for (long long base = (long long)rank * kThreads + t; base < n_vec;
       base += stride * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = base + u * stride;
      v[u] = k < n_vec ? __ldg(vec + k) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned m = 2u * (unsigned)(head + 4 * (base + u * stride)) + 1u;
      acc += v[u].x * m + v[u].y * (m + 2u) + v[u].z * (m + 4u) +
             v[u].w * (m + 6u);
    }
  }
  if (rank == 0 && t < 8) {
    // Threads 0-3 take the head, 4-7 the tail (each at most 3 words).
    const long long i = t < 4 ? t : head + 4 * n_vec + (t - 4);
    const bool mine = t < 4 ? i < head : i < n;
    if (mine) acc += __ldg(words + i) * (2u * (unsigned)i + 1u);
  }

  acc = warp_sum(acc);
  if ((t & 31) == 0) warp_part[t >> 5] = acc;
  __syncthreads();
  if (t < 32) {
    const unsigned s = warp_sum(t < kWarps ? warp_part[t] : 0u);
    if (t == 0) block_part = s;
  }
  cluster.sync();  // every block's partial is written
  if (rank == 0 && t < 32) {
    unsigned s = 0;
    for (unsigned r = t; r < cluster.num_blocks(); r += 32)
      s += *cluster.map_shared_rank(&block_part, r);
    s = warp_sum(s);
    if (t == 0) *out = s;
  }
  cluster.sync();  // no block leaves while rank 0 reads its shared memory
}

// The cluster size, chosen once per device: 16 where the card can place
// such a cluster, else the portable 8; 0 if neither.
int cluster_size() {
  static int sizes[64];  // 0: not chosen yet; -1: none fits
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  int& size = sizes[dev];
  if (size != 0) return size > 0 ? size : 0;
  size = -1;
  if (cudaFuncSetAttribute(integrity_word_kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess)
    return 0;
  for (int c : {16, 8}) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kThreads);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = c;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, integrity_word_kernel,
                                       &cfg) == cudaSuccess &&
        clusters > 0) {
      size = c;
      return size;
    }
    cudaGetLastError();
  }
  return 0;
}

}  // namespace

// words: uint32[n] contiguous on the device, any 4-byte-aligned start,
// n >= 0; out: one uint32 on the device, written (not accumulated) by
// the kernel, 0 for n = 0. One launch on `stream`, no synchronisation; returns
// cudaGetLastError().
extern "C" int brpc_tpu_torch_integrity_word(const void* words, void* out,
                                             long long n, void* stream) {
  const int c = cluster_size();
  if (c == 0) return (int)cudaErrorInvalidConfiguration;
  long long head = (long long)((16u - ((size_t)words & 15u)) & 15u) / 4;
  if (head > n) head = n;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, integrity_word_kernel, (const unsigned*)words,
                     (unsigned*)out, n, (int)head);
  return (int)cudaGetLastError();
}

// The cluster size the kernel launches with (0 if none can be placed).
extern "C" int brpc_tpu_torch_integrity_word_cluster() { return cluster_size(); }
