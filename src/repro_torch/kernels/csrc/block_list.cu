// block_list: a hop's active-block list, built on the card in one launch.
//
//   flag[b]   = some source s in [src_min[b], src_max[b]] has w[r·n_src + s]
//               != zero in some row r < B   (B = 1: a single frontier)
//   block_idx = the flagged block ids, ascending, then the last flagged id
//               repeated to the end (0 when none is flagged)
//   n_active  = the number of flagged blocks
//
// Replaces the per-hop list build of the port's kernels/active.py
// (active_block_list: support mask, prefix count over the source domain,
// two gathers, a stable sort, a sum and a select: 14 eager PyTorch calls,
// each with its launch and host time), which ports the reference's jnp list
// build in repro/kernels/active.py::active_block_list. That build is not a
// pallas_call: the reference runs it inside its jitted program, so it costs
// no host time there. The lists are equal, id for id.
//
// What bounds it: launch and host time. The work is small: each block's
// source range is read until a live value turns up, and the ranges of an
// index's CSR-ordered blocks are monotone (a range shares at most its first
// source with the one before), so w is read at most about once (B times for
// B rows), and a dense frontier stops at the first value of each range. The
// design:
//   * one warp a block (grid-stride over the blocks): the lanes test the
//     range's first 32 sources, then 512 a step (16 independent loads a lane
//     and row, so a long range of a sparse frontier is not a chain of
//     dependent loads), and __any_sync ends the range at the first step with
//     a live value. No prefix count over the source domain is built;
//   * the flags go to block_idx itself (and to `flags`, when given: a fused
//     region's reach test reads them); each CTA then fences and takes a
//     ticket, and the last CTA to finish compacts the flags in order with a
//     shared-memory scan, in place (a flagged block's position never passes
//     its id, and a chunk is read whole before it is written), writes the
//     tail and n_active, and resets the ticket for the next launch. So no
//     memset or second launch is needed, and n_active never visits the host;
//   * the ticket is a word the caller owns, one for each stream it launches
//     on (kernels/block_list.py keeps one per device and stream): launches
//     in one stream run in order, so a ticket is never shared by two
//     launches at once, while launches on two streams may overlap.
// This file allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;  // flags a thread takes in a compaction chunk
constexpr int kPerLane = 16;  // sources a lane tests a step, past the first 32
constexpr int kMaxGrid = 132 * 8;

__device__ __forceinline__ bool live(const float* __restrict__ w, int B, int64_t n_src,
                                     int64_t s, float zero) {
  for (int r = 0; r < B; ++r) {
    if (!(__ldg(w + (int64_t)r * n_src + s) == zero)) return true;  // NaN is live
  }
  return false;
}

// An exclusive scan of one int a thread over the CTA; *total gets the sum.
__device__ __forceinline__ int cta_exclusive_scan(int x, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    if (lane < kWarps) warp_sums[lane] = v;  // inclusive over the warps
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kWarps - 1];
  return before + inc - x;
}

__global__ void __launch_bounds__(kThreads)
block_list_kernel(const float* __restrict__ w, int B, int64_t n_src, float zero,
                  const int32_t* __restrict__ src_min, const int32_t* __restrict__ src_max,
                  int nb, int32_t* block_idx, int32_t* n_active, uint8_t* flags,
                  unsigned int* ticket) {
  const int lane = threadIdx.x & 31;
  // 1. a flag a block, one warp a block
  for (int64_t b = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); b < nb;
       b += (int64_t)gridDim.x * kWarps) {  // uniform across the warp
    const int64_t lo = __ldg(src_min + b) > 0 ? __ldg(src_min + b) : 0;
    const int64_t hi = __ldg(src_max + b) < n_src - 1 ? __ldg(src_max + b) : n_src - 1;
    // the first 32 sources (a dense frontier stops here), then kPerLane
    // independent loads a lane a step, so a long range is not a chain of
    // dependent 32-wide reads
    bool found = __any_sync(0xffffffffu, lo + lane <= hi && live(w, B, n_src, lo + lane, zero));
    for (int64_t s0 = lo + 32; s0 <= hi && !found; s0 += 32 * kPerLane) {  // uniform
      bool hit = false;
      for (int r = 0; r < B; ++r) {
        const float* __restrict__ row = w + (int64_t)r * n_src;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const int64_t s = s0 + j * 32 + lane;
          if (s <= hi) hit |= !(__ldg(row + s) == zero);  // NaN is live
        }
      }
      found = __any_sync(0xffffffffu, hit);
    }
    if (lane == 0) {
      block_idx[b] = found ? 1 : 0;
      if (flags != nullptr) flags[b] = found ? 1 : 0;
    }
  }
  // 2. the last CTA to finish compacts
  __shared__ bool last;
  __shared__ int warp_sums[kWarps];
  __shared__ int last_id;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x == 0) last_id = -1;
  int done = 0;  // flagged blocks before the chunk
  for (int c0 = 0; c0 < nb; c0 += kThreads * kItems) {  // uniform across the CTA
    const int i0 = c0 + threadIdx.x * kItems;
    int f[kItems];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      f[j] = i0 + j < nb ? __ldcg(block_idx + i0 + j) : 0;  // L2: other CTAs wrote them
      mine += f[j];
    }
    int total;
    int pos = done + cta_exclusive_scan(mine, warp_sums, &total);  // syncs: all read first
    int top = -1;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (f[j]) {
        block_idx[pos++] = i0 + j;
        top = i0 + j;
      }
    }
    if (top >= 0) atomicMax(&last_id, top);
    done += total;
    __syncthreads();  // warp_sums is reused by the next chunk
  }
  const int32_t tail = last_id >= 0 ? last_id : 0;
  for (int i = done + threadIdx.x; i < nb; i += kThreads) block_idx[i] = tail;
  if (threadIdx.x == 0) {
    *n_active = done;
    *ticket = 0;  // every CTA has taken its ticket
  }
}

}  // namespace

// The list of an nb-block index for a frontier w[B, n_src] (B = 1: one
// frontier; the support is the OR over the rows) and its ⊕-identity `zero`,
// into block_idx[nb] and n_active[1] (and flags[nb], 0/1 bytes, unless
// nullptr). `ticket` is `stream`'s own word, 0 before the first launch; each
// launch leaves it 0. Returns cudaGetLastError() after the launch (0 =
// success). nb must be > 0.
extern "C" int block_list_launch(const float* w, int B, int64_t n_src, float zero,
                                 const int32_t* src_min, const int32_t* src_max, int nb,
                                 int32_t* block_idx, int32_t* n_active, uint8_t* flags,
                                 unsigned int* ticket, void* stream) {
  const int64_t want = ((int64_t)nb + kWarps - 1) / kWarps;
  const int grid = (int)(want < kMaxGrid ? want : kMaxGrid);
  block_list_kernel<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      w, B, n_src, zero, src_min, src_max, nb, block_idx, n_active, flags, ticket);
  return (int)cudaGetLastError();
}
