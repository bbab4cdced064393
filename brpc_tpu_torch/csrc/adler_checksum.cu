// B1: per-row frame checksum over uint32[batch, words], for sm_90a.
//
// Replaces brpc_tpu/parallel/collective_echo.py:23-38
// (_adler_frame_checksum, run by echo_step). Per row: split each word
// into 16-bit halves, lo then hi; s1 = inclusive prefix sum over the
// halves, wrapping at 2^32; a = s1[-1] % 65521;
// b = (sum of s1 % 65521, wrapping at 2^32) % 65521; out = (b << 16) | a.
// Every sum is `unsigned`, which wraps at 2^32 exactly as the JAX uint32
// cumsum and sum do. Wrapping addition is associative, so any split of
// the scan and of the b sum is bit-exact. Never widen to 64 bits: the
// JAX reference wraps the b sum.
//
// Bound: HBM bytes (4 bytes a word, read once). The integer work is
// about ten instructions a word: the row's halves are summed with one
// dp2a per word (lo*1 + hi*1 + acc), each prefix is one dp2a
// (lo*1 + run, then lo*1 + hi*1 + run), each `% 65521` a multiply-high,
// a shift and a multiply-add, and the b sum one three-input add a word.
// At 3.35 TB/s that leaves room for about 20 instructions a word.
//
// Design, shared by both layouts (kernels/checksum.py `plan` picks one
// by row length and computes the launch):
// - Each thread owns V consecutive 16-byte granules (4 words each), all
//   V uint4 loads issued before any is used. Granules are counted
//   from the 16-byte boundary at or before the array's start (`off`
//   words before it), so a row whose start is not aligned (rows of
//   n % 4 != 0 from the second row on, or a view with a storage offset)
//   still loads whole uint4 inside the row; only a granule that
//   straddles the row's first or last word is peeled into scalar loads
//   of its words inside the row, and words outside it count as zero
//   halves and add nothing to b.
// - Layout "split" loads coalesced (in round u, lane l of a warp reads
//   the warp's granule 32u + l: 512 contiguous bytes an instruction) and
//   hands the granules out through shared memory, so that lane l gets
//   granules lV .. lV + V - 1. Loading its own 128 bytes directly makes
//   each instruction touch 32 cache lines. Layout "warp" loads
//   directly: the staging buffer costs its V = 4 kernel 16 registers
//   and so occupancy.
// - A thread first sums its halves (pass 1), the warp scans the thread
//   totals (5 shuffles), and then each thread walks its halves again
//   from its carry (pass 2), adding s1 % 65521 into its b share.
// Layout "warp" (rows of at most 4096 words): one warp per row, several
//   rows a block, looping over tiles of 128 * V words with the carry
//   held in registers: no block barrier at all. V = 8 (1024-word tiles,
//   64 registers) for a small batch, where each row's latency counts;
//   V = 4 (512-word tiles, 48 registers, so 40 warps share an SM) once
//   there are enough rows to fill the card.
// Layout "split" (longer rows): a row is cut into segments of 8192
//   words (256 threads, V = 8), so a few long rows still fill the card.
//   One block per segment; a block takes its segment by atomic ticket,
//   not by blockIdx, so a segment only ever waits on segments that are
//   already running. (Resident blocks that fetch their next ticket
//   early ran at half the speed: segments then start out of ticket
//   order and wait on each other's look-back.) A segment's carry
//   (the wrapping sum of all the row's earlier halves) comes from a
//   decoupled look-back (Merrill & Garland 2016): the segment publishes
//   its total at once as a 64-bit (status, value) word, then warp 0
//   reads 32 predecessors at a time and adds their totals back to the
//   nearest one that has published its inclusive prefix. The segment
//   then computes its b share over the data it still holds in
//   registers and adds it into the row's slot with one atomicAdd, then
//   counts itself done with a release add; neither waits for a reply.
//   The row's last segment by ticket waits (acquire) until the others
//   are counted and writes the checksum. Three block barriers per
//   segment: warp totals, carry, b shares. The flags, slots, counts and
//   ticket are zeroed by a cudaMemsetAsync on the same stream before
//   each launch (a memset node in a CUDA graph), so a replay starts
//   clean.
#include <cuda_runtime.h>

#include "warp_ops.cuh"

using brpc_tpu_torch::kFullMask;
using brpc_tpu_torch::warp_inclusive_scan;
using brpc_tpu_torch::warp_sum;

namespace {

constexpr unsigned kMod = 65521u;
// Layout "split": 8 granules a thread, 256 threads, 8192 words a segment.
constexpr int kSplitVecs = 8;
constexpr int kSplitThreads = 256;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSegGranules = kSplitThreads * kSplitVecs;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

// One granule of the aligned word space (word a is base[a]; base is
// 16-byte aligned): a uint4 when all its words are inside the row
// [lo, hi), else its words inside the row as scalars and 0 elsewhere.
__device__ __forceinline__ uint4 load_granule(const unsigned* __restrict__ base,
                                              long long g, long long lo,
                                              long long hi) {
  const long long a = 4 * g;
  if (a >= lo && a + 4 <= hi) return __ldg(reinterpret_cast<const uint4*>(base) + g);
  uint4 v;
  v.x = (a + 0 >= lo && a + 0 < hi) ? __ldg(base + a + 0) : 0u;
  v.y = (a + 1 >= lo && a + 1 < hi) ? __ldg(base + a + 1) : 0u;
  v.z = (a + 2 >= lo && a + 2 < hi) ? __ldg(base + a + 2) : 0u;
  v.w = (a + 3 >= lo && a + 3 < hi) ? __ldg(base + a + 3) : 0u;
  return v;
}

// The thread's own granules [g, g + V), loaded directly. kEdge is false
// when all their words are inside the row.
template <int V, bool kEdge>
__device__ __forceinline__ void load(const unsigned* __restrict__ base,
                                     long long g, long long lo, long long hi,
                                     uint4 (&v)[V]) {
  const uint4* vec = reinterpret_cast<const uint4*>(base);
#pragma unroll
  for (int u = 0; u < V; ++u)
    v[u] = kEdge ? load_granule(base, g + u, lo, hi) : __ldg(vec + g + u);
}

// The warp's 32 * V granules from gw on, loaded coalesced (in round u,
// lane l reads granule 32u + l: 512 contiguous bytes an instruction)
// and handed out blocked through `stage` (lane l gets granules
// lV .. lV + V - 1). One pad slot every V granules keeps both the
// stores and the loads free of bank conflicts. `stage` holds
// 32 * (V + 1) uint4.
template <int V>
__device__ __forceinline__ void load_warp(const unsigned* __restrict__ base,
                                          long long gw, long long lo,
                                          long long hi, int lane,
                                          uint4* __restrict__ stage,
                                          uint4 (&v)[V]) {
  uint4 x[V];
  if (4 * gw >= lo && 4 * (gw + 32 * V) <= hi) {
    const uint4* vec = reinterpret_cast<const uint4*>(base) + gw;
#pragma unroll
    for (int u = 0; u < V; ++u) x[u] = __ldg(vec + 32 * u + lane);
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) x[u] = load_granule(base, gw + 32 * u + lane, lo, hi);
  }
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int i = 32 * u + lane;
    stage[i + i / V] = x[u];
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < V; ++u) v[u] = stage[lane * (V + 1) + u];
  __syncwarp();
}

template <int V>
__device__ __forceinline__ bool is_edge(long long g, long long lo,
                                        long long hi) {
  return 4 * g < lo || 4 * (g + V) > hi;
}

// Pass 1: the wrapping sum of the thread's halves.
template <int V>
__device__ __forceinline__ unsigned halves_total(const uint4 (&v)[V]) {
  unsigned t = 0;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    t = __dp2a_lo(v[u].x, 0x0101u, t);
    t = __dp2a_lo(v[u].y, 0x0101u, t);
    t = __dp2a_lo(v[u].z, 0x0101u, t);
    t = __dp2a_lo(v[u].w, 0x0101u, t);
  }
  return t;
}

// Pass 2: the thread's share of b, sum of s1 % kMod over the halves of
// its words inside the row, where `run` is s1 before its first half.
template <int V, bool kEdge>
__device__ __forceinline__ unsigned b_share(const uint4 (&v)[V], unsigned run,
                                            long long a0, long long lo,
                                            long long hi) {
  unsigned b = 0;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const unsigned w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned s_lo = __dp2a_lo(w[k], 0x0001u, run);  // + lo half
      const unsigned s_hi = __dp2a_lo(w[k], 0x0101u, run);  // + both halves
      run = s_hi;
      const unsigned r = s_lo % kMod + s_hi % kMod;
      if (!kEdge) {
        b += r;
      } else {
        const long long a = a0 + 4 * u + k;
        if (a >= lo && a < hi) b += r;
      }
    }
  }
  return b;
}

template <int V>
__device__ __forceinline__ unsigned b_of(const uint4 (&v)[V], bool edge,
                                         unsigned run, long long g,
                                         long long lo, long long hi) {
  return edge ? b_share<V, true>(v, run, 4 * g, lo, hi)
              : b_share<V, false>(v, run, 4 * g, lo, hi);
}

// Layout "warp": warp w of block x checksums row x * rows_per_block + w,
// V granules a lane, 128 * V words a warp tile.
template <int V>
__global__ void __launch_bounds__(256)
adler_rows_kernel(const unsigned* __restrict__ base, unsigned* __restrict__ out,
                  long long batch, long long n, int off) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= batch) return;  // the whole warp leaves together
  const long long lo = row * n + off;
  const long long hi = lo + n;
  const long long g_end = (hi + 3) >> 2;
  unsigned carry = 0;  // s1 before this tile; the same in every lane
  unsigned b = 0;
  for (long long g0 = lo >> 2; g0 < g_end; g0 += 32 * V) {
    const long long g = g0 + lane * V;
    const bool edge = is_edge<V>(g, lo, hi);
    uint4 v[V];
    if (edge) load<V, true>(base, g, lo, hi, v); else load<V, false>(base, g, lo, hi, v);
    const unsigned total = halves_total<V>(v);
    const unsigned incl = warp_inclusive_scan(total, lane);
    b += b_of<V>(v, edge, carry + incl - total, g, lo, hi);
    carry += __shfl_sync(kFullMask, incl, 31);
  }
  b = warp_sum(b);
  if (lane == 0) out[row] = ((b % kMod) << 16) | (carry % kMod);
}

// Relaxed and acquire/release accesses at GPU scope. A look-back flag is
// one 64-bit word, so status and value travel together and need no
// fence.
__device__ __forceinline__ void store_flag(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_flag(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// Decoupled look-back for segment `seg` of a row, run by one warp:
// publishes the segment's total, returns its carry (the wrapping sum of
// the row's earlier halves) and publishes its inclusive prefix.
__device__ unsigned look_back(unsigned long long* __restrict__ flags,
                              long long seg, unsigned seg_total, int lane) {
  if (seg == 0) {
    if (lane == 0) store_flag(flags, kInclusive | seg_total);
    return 0;
  }
  if (lane == 0) store_flag(flags + seg, kAggregate | seg_total);
  unsigned carry = 0;
  for (long long end = seg;; end -= 32) {
    // Lane l reads segment end - 1 - l; before the row's start reads as
    // an inclusive prefix of 0.
    const long long j = end - 1 - lane;
    unsigned long long f;
    unsigned inclusive, need;
    for (;;) {
      f = j >= 0 ? load_flag(flags + j) : kInclusive;
      const unsigned status = (unsigned)(f >> 32);
      inclusive = __ballot_sync(kFullMask, status == 2);
      const unsigned ready = __ballot_sync(kFullMask, status != 0);
      // The lanes that count: up to and including the nearest inclusive.
      need = inclusive ? ((inclusive & (0u - inclusive)) << 1) - 1u : kFullMask;
      if ((ready & need) == need) break;
      __nanosleep(64);
    }
    carry += warp_sum(((need >> lane) & 1u) ? (unsigned)f : 0u);
    if (inclusive) break;
  }
  if (lane == 0) store_flag(flags + seg, kInclusive | (carry + seg_total));
  return carry;
}

// Layout "split": one block per segment, the segment by ticket. flags:
// uint64[batch * segs_per_row]; b_slot, done: uint32[batch]; ticket:
// one uint32; all zero at launch.
__global__ void __launch_bounds__(kSplitThreads, 4)
adler_split_kernel(const unsigned* __restrict__ base, unsigned* __restrict__ out,
                   long long n, int off, long long segs_per_row,
                   unsigned long long* __restrict__ flags,
                   unsigned* __restrict__ b_slot, unsigned* __restrict__ done,
                   unsigned* __restrict__ ticket) {
  __shared__ unsigned s_ticket, s_carry;
  __shared__ unsigned warp_total[kSplitWarps], warp_b[kSplitWarps];
  __shared__ uint4 stage_all[kSplitWarps][32 * (kSplitVecs + 1)];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) s_ticket = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long row = s_ticket / segs_per_row;
  const long long seg = s_ticket % segs_per_row;
  const long long lo = row * n + off;
  const long long hi = lo + n;
  const long long g = (lo >> 2) + seg * kSegGranules + (long long)t * kSplitVecs;
  const bool edge = is_edge<kSplitVecs>(g, lo, hi);
  uint4 v[kSplitVecs];
  load_warp<kSplitVecs>(base, g - (long long)lane * kSplitVecs, lo, hi, lane,
                        stage_all[warp], v);
  const unsigned total = halves_total<kSplitVecs>(v);
  const unsigned incl = warp_inclusive_scan(total, lane);
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  unsigned before = 0, seg_total = 0;
#pragma unroll
  for (int k = 0; k < kSplitWarps; ++k) {
    const unsigned x = warp_total[k];
    if (k < warp) before += x;
    seg_total += x;
  }
  if (warp == 0) {
    const unsigned carry =
        look_back(flags + row * segs_per_row, seg, seg_total, lane);
    if (lane == 0) s_carry = carry;
  }
  __syncthreads();
  const unsigned carry = s_carry;
  unsigned b = b_of<kSplitVecs>(v, edge, carry + before + incl - total, g, lo, hi);
  b = warp_sum(b);
  if (lane == 0) warp_b[warp] = b;
  __syncthreads();
  if (t == 0) {
    unsigned bs = 0;
#pragma unroll
    for (int k = 0; k < kSplitWarps; ++k) bs += warp_b[k];
    if (seg + 1 < segs_per_row) {
      // Add the b share, then count the segment done (release: the share
      // is visible before the count). Neither waits for a reply.
      atomicAdd(b_slot + row, bs);
      add_release(done + row, 1u);
    } else {
      // The row's last segment by ticket: every other segment of the row
      // holds an earlier ticket and is running or done, so the wait
      // ends. Acquire: their b shares are visible after it.
      while (load_acquire(done + row) != (unsigned)(segs_per_row - 1))
        __nanosleep(64);
      const unsigned b_row = load_acquire(b_slot + row) + bs;
      const unsigned s_end = carry + seg_total;  // s1[-1]
      out[row] = ((b_row % kMod) << 16) | (s_end % kMod);
    }
  }
}

// Bytes of the "split" layout's scratch: flags, b slots, counts, ticket.
long long scratch_bytes(long long batch, long long segs_per_row) {
  return 8 * batch * segs_per_row + 4 * batch + 4 * batch + 4;
}

}  // namespace

// words: uint32[batch, n_words] contiguous on the device; out:
// uint32[batch]. `layout` 0 is "warp" (`rows_per_block` warps a block),
// 1 is "split" (`segs_per_row` segments a row; `scratch` holds at least
// 8 * batch * segs_per_row + 8 * batch + 4 bytes). `off` is the words'
// 4-byte offset from a 16-byte boundary and `tile_words` the plan's tile
// or segment, both checked against this build. Launches on `stream`
// (split: after a memset of the scratch on it), does not synchronise,
// returns cudaGetLastError().
extern "C" int brpc_tpu_torch_adler_frame_checksum(
    const void* words, void* out, long long batch, long long n_words,
    int layout, int off, long long tile_words, long long rows_per_block,
    long long segs_per_row, void* scratch, long long scratch_len,
    void* stream) {
  if (batch <= 0 || n_words <= 0) return (int)cudaGetLastError();
  if (off != (int)(((size_t)words >> 2) & 3)) return (int)cudaErrorInvalidValue;
  const unsigned* base = (const unsigned*)words - off;
  cudaStream_t s = (cudaStream_t)stream;
  if (layout == 0) {
    if (rows_per_block < 1 || rows_per_block > 8)
      return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((batch + rows_per_block - 1) / rows_per_block);
    const unsigned threads = (unsigned)(32 * rows_per_block);
    if (tile_words == 4 * 32 * 4)
      adler_rows_kernel<4><<<blocks, threads, 0, s>>>(base, (unsigned*)out,
                                                      batch, n_words, off);
    else if (tile_words == 4 * 32 * 8)
      adler_rows_kernel<8><<<blocks, threads, 0, s>>>(base, (unsigned*)out,
                                                      batch, n_words, off);
    else
      return (int)cudaErrorInvalidValue;
  } else if (layout == 1) {
    const long long bytes = scratch_bytes(batch, segs_per_row);
    const long long n_segs = batch * segs_per_row;
    if (tile_words != 4 * kSegGranules || segs_per_row < 1 ||
        n_segs >= (1ll << 31) || scratch == nullptr ||
        scratch_len < bytes)
      return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)bytes, s);
    if (e != cudaSuccess) return (int)e;
    unsigned long long* flags = (unsigned long long*)scratch;
    unsigned* b_slot = (unsigned*)(flags + n_segs);
    unsigned* done = b_slot + batch;
    unsigned* ticket = done + batch;
    adler_split_kernel<<<(unsigned)n_segs, kSplitThreads, 0, s>>>(
        base, (unsigned*)out, n_words, off, segs_per_row, flags, b_slot, done,
        ticket);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
