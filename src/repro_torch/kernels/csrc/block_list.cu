// block_list: a hop's active-block list, built on the card in one pass.
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
// What bounds it: latency. The work is small: each block's source range is
// read until a live value turns up, and the ranges of an index's CSR-ordered
// blocks are monotone (a range shares at most its first source with the one
// before), so w is read at most about once (B times for B rows), and a dense
// frontier stops at the first value of each range. The design, one pass with
// no CTA that works alone:
//   * a CTA owns a tile of kWarps consecutive blocks, one warp a block: the
//     lanes test the range's first 32 sources, then 512 a step (16
//     independent loads a lane and row, so a long range of a sparse frontier
//     is not a chain of dependent loads), and __any_sync ends the range at
//     the first step with a live value. The flags go to `flags` when given
//     (a fused region's reach test reads them);
//   * a CTA takes its tile from a counter, so a tile's predecessors are all
//     running or done (decoupled look-back needs that to make progress). It
//     publishes its tile's count and last flagged id (an aggregate) at once,
//     then its first warp looks back over the predecessors' status words, 32
//     at a time, summing aggregates back to the nearest inclusive prefix; it
//     then publishes its own inclusive prefix and writes its ids at their
//     final positions. The last id travels in the status word (a maximum),
//     so no atomic on a shared word is needed for it;
//   * the CTA of the last tile knows the total and the last id: it writes
//     n_active and fills the tail with all its threads, 16 bytes a store;
//   * the counter, the status words and a done ticket are a buffer the
//     caller owns, one for each stream it launches on (kernels/block_list.py
//     keeps one per device, stream and capacity), zero before the first
//     launch: the last CTA to finish zeroes what the launch used. Launches
//     in one stream run in order, so a buffer is never shared by two
//     launches at once, while launches on two streams may overlap.
// No memset, no second launch, no host read. This file allocates nothing and
// does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 32;              // blocks a tile, one a warp
constexpr int kThreads = kWarps * 32;
constexpr int kPerLane = 16;            // sources a lane tests a step, past the first 32
constexpr unsigned kFull = 0xffffffffu;

// A tile's status word: the state in bits 63-62 (0 not yet, 1 the tile's own
// aggregate, 2 the inclusive prefix up to it), the last flagged id + 1 in
// bits 61-31 (0: none) and the count in bits 30-0. Ids and counts are < 2^31.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kState = 3ull << 62;

__device__ __forceinline__ unsigned long long pack(unsigned long long state, int last,
                                                   unsigned count) {
  return state | ((unsigned long long)(unsigned)(last + 1) << 31) | count;
}
__device__ __forceinline__ unsigned count_of(unsigned long long s) {
  return (unsigned)(s & 0x7fffffffu);
}
__device__ __forceinline__ int last_of(unsigned long long s) {
  return (int)((s >> 31) & 0x7fffffffu) - 1;
}

__device__ __forceinline__ bool live(const float* __restrict__ w, int B, int64_t n_src,
                                     int64_t s, float zero) {
  for (int r = 0; r < B; ++r) {
    if (!(__ldg(w + (int64_t)r * n_src + s) == zero)) return true;  // NaN is live
  }
  return false;
}

// One block's test by one warp (uniform across it).
__device__ __forceinline__ bool block_live(const float* __restrict__ w, int B, int64_t n_src,
                                           float zero, int64_t lo, int64_t hi, int lane) {
  // the first 32 sources (a dense frontier stops here), then kPerLane
  // independent loads a lane a step
  bool found = __any_sync(kFull, lo + lane <= hi && live(w, B, n_src, lo + lane, zero));
  for (int64_t s0 = lo + 32; s0 <= hi && !found; s0 += 32 * kPerLane) {
    bool hit = false;
    for (int r = 0; r < B; ++r) {
      const float* __restrict__ row = w + (int64_t)r * n_src;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int64_t s = s0 + j * 32 + lane;
        if (s <= hi) hit |= !(__ldg(row + s) == zero);  // NaN is live
      }
    }
    found = __any_sync(kFull, hit);
  }
  return found;
}

// The buffer of a stream: the tile counter, the done ticket, then a status
// word a tile.
struct Header {
  unsigned int next_tile;
  unsigned int done;
  unsigned long long pad;
};

__global__ void __launch_bounds__(kThreads)
block_list_kernel(const float* __restrict__ w, int B, int64_t n_src, float zero,
                  const int32_t* __restrict__ src_min, const int32_t* __restrict__ src_max,
                  int nb, int32_t* __restrict__ block_idx, int32_t* __restrict__ n_active,
                  uint8_t* __restrict__ flags, Header* __restrict__ head,
                  unsigned long long* status) {
  __shared__ int s_tile;
  __shared__ unsigned char s_flag[kWarps];
  __shared__ int s_total, s_last;
  __shared__ bool s_last_cta;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntiles = (int)gridDim.x;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(&head->next_tile, 1u);
  __syncthreads();
  const int tile = s_tile;

  // 1. a flag a block, one warp a block
  const int64_t b = (int64_t)tile * kWarps + warp;
  bool found = false;
  if (b < nb) {
    const int64_t lo = __ldg(src_min + b) > 0 ? __ldg(src_min + b) : 0;
    const int64_t hi = __ldg(src_max + b) < n_src - 1 ? __ldg(src_max + b) : n_src - 1;
    found = block_live(w, B, n_src, zero, lo, hi, lane);
    if (lane == 0 && flags != nullptr) flags[b] = found ? 1 : 0;
  }
  if (lane == 0) s_flag[warp] = found ? 1 : 0;
  __syncthreads();

  // 2. the tile's prefix by decoupled look-back, its ids at their positions
  if (warp == 0) {
    const bool f = s_flag[lane] != 0;
    const unsigned m = __ballot_sync(kFull, f);
    const unsigned cnt = __popc(m);
    const int mine_last = m ? tile * kWarps + 31 - __clz(m) : -1;
    unsigned excl = 0;
    int excl_last = -1;
    volatile unsigned long long* vs = status;
    if (tile == 0) {
      if (lane == 0) vs[0] = pack(kInclusive, mine_last, cnt);
    } else {
      if (lane == 0) vs[tile] = pack(kAggregate, mine_last, cnt);
      for (int j = tile - 1;; j -= 32) {  // uniform across the warp
        const int at = j - lane;  // lane 0 the nearest predecessor
        unsigned long long s;
        unsigned inc;
        for (;;) {
          s = at >= 0 ? vs[at] : pack(kInclusive, -1, 0);
          const unsigned wait = __ballot_sync(kFull, (s & kState) == 0);
          inc = __ballot_sync(kFull, (s & kState) == kInclusive);
          // ready once every word up to the nearest inclusive one has come
          if (wait == 0 || (inc != 0 && __ffs(inc) < __ffs(wait))) break;
          __nanosleep(20);
        }
        const int stop = inc ? __ffs(inc) - 1 : 31;
        unsigned c = lane <= stop ? count_of(s) : 0;
        int l = lane <= stop ? last_of(s) : -1;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          c += __shfl_xor_sync(kFull, c, o);
          l = max(l, __shfl_xor_sync(kFull, l, o));
        }
        excl += c;
        excl_last = max(excl_last, l);
        if (inc) break;
      }
      if (lane == 0) vs[tile] = pack(kInclusive, max(excl_last, mine_last), excl + cnt);
    }
    if (f) block_idx[excl + __popc(m & ((1u << lane) - 1u))] = tile * kWarps + lane;
    if (tile == ntiles - 1 && lane == 0) {
      s_total = (int)(excl + cnt);
      s_last = max(excl_last, mine_last);
      *n_active = s_total;
    }
  }
  __syncthreads();

  // 3. the last tile's CTA fills the tail
  if (tile == ntiles - 1) {
    const int total = s_total;
    const int32_t tail = s_last >= 0 ? s_last : 0;
    const int aligned = min(nb, (total + 3) & ~3);
    for (int i = total + threadIdx.x; i < aligned; i += kThreads) block_idx[i] = tail;
    const int4 t4 = make_int4(tail, tail, tail, tail);
    int4* v = reinterpret_cast<int4*>(block_idx + aligned);  // block_idx is 16-byte aligned
    const int n4 = (nb - aligned) >> 2;
    for (int i = threadIdx.x; i < n4; i += kThreads) v[i] = t4;
    for (int i = aligned + 4 * n4 + threadIdx.x; i < nb; i += kThreads) block_idx[i] = tail;
  }

  // 4. the last CTA to finish leaves the buffer zero for the next launch
  if (threadIdx.x == 0) {
    __threadfence();
    s_last_cta = atomicAdd(&head->done, 1u) == (unsigned)ntiles - 1;
  }
  __syncthreads();
  if (s_last_cta) {
    for (int i = threadIdx.x; i < ntiles; i += kThreads) status[i] = 0;
    if (threadIdx.x == 0) {
      head->next_tile = 0;
      head->done = 0;
    }
  }
}

}  // namespace

// The tiles (status words) a list of nb blocks takes.
extern "C" int block_list_tiles(int nb) { return (nb + kWarps - 1) / kWarps; }

// The list of an nb-block index for a frontier w[B, n_src] (B = 1: one
// frontier; the support is the OR over the rows) and its ⊕-identity `zero`,
// into block_idx[nb] (16-byte aligned) and n_active[1] (and flags[nb], 0/1
// bytes, unless nullptr). `scratch` is `stream`'s own 16 bytes plus 8 a tile
// (block_list_tiles), zero before the first launch; each launch leaves it
// zero. Returns cudaGetLastError() after the launch (0 = success). nb must be
// > 0 and < 2^31 - 1.
extern "C" int block_list_launch(const float* w, int B, int64_t n_src, float zero,
                                 const int32_t* src_min, const int32_t* src_max, int nb,
                                 int32_t* block_idx, int32_t* n_active, uint8_t* flags,
                                 void* scratch, void* stream) {
  const int tiles = block_list_tiles(nb);
  Header* head = reinterpret_cast<Header*>(scratch);
  block_list_kernel<<<tiles, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      w, B, n_src, zero, src_min, src_max, nb, block_idx, n_active, flags, head,
      reinterpret_cast<unsigned long long*>(head + 1));
  return (int)cudaGetLastError();
}
