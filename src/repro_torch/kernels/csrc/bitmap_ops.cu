// bitmap_ops: the merge intersection of two uint32 bitmaps on Hopper (paper
// §6.1, θ = 0): the word-wise AND, and the popcount of the AND (the
// intersection's cardinality).
//
// Replaces the TPU kernels repro/kernels/bitmap_ops.py::bitmap_and
// (_and_kernel) and ::bitmap_and_popcount (_and_popcount_kernel). There the
// operands are padded to (8, 128) VMEM tiles, a grid step ANDs one tile, and
// the popcount carries its int32 sum across the sequential grid in a (1, 1)
// output block.
//
// What bounds them: bytes. The AND reads 8 bytes a word and writes 4; the
// popcount reads 8 and writes one count. Each word is touched once. The
// design:
//   * the AND: a CTA for each kThreads · kUnroll uint4 of each operand
//     (16 KiB), as many CTAs as the words need, which the block scheduler
//     balances over the SMs; the popcount: one wave of CTAs (as many as are
//     co-resident, asked once), fewer for a short bitmap, striding over the
//     words, so that few CTAs add into its count. At 2^26 words the AND as
//     one wave took 0.2756-0.2795 ms, a CTA a chunk 0.2627, a TMA bulk-copy
//     ring (cp.async.bulk into shared memory, an mbarrier a stage, bulk
//     stores) 0.2752, torch.bitwise_and 0.2630-0.2638 (NVIDIA H100 80GB
//     HBM3, 700 W; scripts/launch_probe.py part `variants`, whose
//     scripts/csrc/bitmap_variants.cu holds the other schedules);
//   * 16-byte uint4 loads and stores where the operands (and the output)
//     sit at the same offset mod 16 bytes: scalar words before the first
//     16-byte boundary (the head) and after the last (the tail), kUnroll
//     uint4 pairs a thread in flight between (independent loads issued
//     before any is used). Pointers at other offsets mod 16 (a view a[1:]
//     beside a fresh b) take scalar words throughout;
//   * evict-first loads and stores (__ldcs / __stcs): a word is read once,
//     so 768 MB of operands streaming through do not push the rest of the
//     card's working set out of the L2;
//   * the popcount in one launch: __popc a word, a per-thread sum,
//     __reduce_add_sync across the warp, the warps' sums in shared memory,
//     one 64-bit atomicAdd a CTA into the stream's scratch, then a ticket:
//     the last CTA to take one writes the count as int32 and leaves the
//     scratch at zero for the next launch on that stream (the pattern of
//     block_list.cu's last-CTA compaction). No fill before the kernel and no
//     cast after it. Integer addition does not depend on order, so the count
//     is exact and the same on every run; the wrapper refuses operands whose
//     count could pass int32 (the reference's int32 sum wraps there).
// This file allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // uint4 pairs in flight a thread

// Words [0, head) and [head + 4·n4, n) are scalar; [head, head + 4·n4) is
// n4 uint4 vectors.
struct Split {
  int64_t n, head, n4;
  __device__ __forceinline__ int64_t n_scalar() const { return n - 4 * n4; }
  __device__ __forceinline__ int64_t scalar_index(int64_t j) const {
    return j < head ? j : j + 4 * n4;
  }
};

// A launch's scratch, one for each stream the wrapper launches on: zero
// before the first launch, and each launch leaves it zero.
struct Scratch {
  unsigned long long sum;
  unsigned int ticket;
  unsigned int pad;
};

Split split(const void* a, const void* b, const void* out, int64_t n) {
  const uintptr_t off = (uintptr_t)a & 15;
  if (((uintptr_t)b & 15) != off || (out != nullptr && ((uintptr_t)out & 15) != off)) {
    return Split{n, n, 0};  // no common 16-byte alignment: every word scalar
  }
  int64_t head = (int64_t)((16 - off) & 15) / 4;
  if (head > n) head = n;
  return Split{n, head, (n - head) / 4};
}

// CTAs for the words: one for each kThreads · kUnroll vectors (or kThreads
// scalar words), at least one, at most cap.
int blocks_for(const Split& s, int64_t cap) {
  const int64_t vec = (s.n4 + kUnroll - 1) / kUnroll;
  const int64_t items = vec > s.n - 4 * s.n4 ? vec : s.n - 4 * s.n4;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (int)(blocks < cap ? blocks : cap);
}

// The CTAs of Kernel that are co-resident on the card: *wave, asked once.
// Returns a CUDA error code.
template <auto Kernel>
int wave_of(int* wave) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, per_sm = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads, 0);
    }
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms <= 0) return (int)cudaErrorInvalidConfiguration;
    cached = per_sm * sms;
  }
  *wave = cached;
  return 0;
}

__device__ __forceinline__ uint4 and4(uint4 x, uint4 y) {
  return make_uint4(x.x & y.x, x.y & y.y, x.z & y.z, x.w & y.w);
}

__global__ void __launch_bounds__(kThreads) bitmap_and_kernel(const uint32_t* __restrict__ a,
                                                              const uint32_t* __restrict__ b,
                                                              uint32_t* __restrict__ out,
                                                              Split s) {
  const uint4* __restrict__ a4 = reinterpret_cast<const uint4*>(a + s.head);
  const uint4* __restrict__ b4 = reinterpret_cast<const uint4*>(b + s.head);
  uint4* __restrict__ o4 = reinterpret_cast<uint4*>(out + s.head);
  const int64_t step = (int64_t)gridDim.x * kThreads * kUnroll;
  for (int64_t i0 = (int64_t)blockIdx.x * kThreads * kUnroll + threadIdx.x; i0 < s.n4;
       i0 += step) {
    uint4 x[kUnroll], y[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t i = i0 + (int64_t)j * kThreads;
      if (i < s.n4) {
        x[j] = __ldcs(a4 + i);
        y[j] = __ldcs(b4 + i);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t i = i0 + (int64_t)j * kThreads;
      if (i < s.n4) __stcs(o4 + i, and4(x[j], y[j]));
    }
  }
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < s.n_scalar(); j += stride) {
    const int64_t i = s.scalar_index(j);
    __stcs(out + i, __ldcs(a + i) & __ldcs(b + i));
  }
}

__device__ __forceinline__ unsigned popc4(uint4 x, uint4 y) {
  return __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) + __popc(x.w & y.w);
}

__global__ void __launch_bounds__(kThreads) bitmap_and_popcount_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, Split s,
    Scratch* __restrict__ scratch, int32_t* __restrict__ count) {
  __shared__ unsigned warp_sums[kThreads / 32];
  const uint4* __restrict__ a4 = reinterpret_cast<const uint4*>(a + s.head);
  const uint4* __restrict__ b4 = reinterpret_cast<const uint4*>(b + s.head);
  // at most 2^26 words in all (the wrapper's limit), so 32 bits a thread hold
  unsigned local = 0;
  const int64_t step = (int64_t)gridDim.x * kThreads * kUnroll;
  for (int64_t i0 = (int64_t)blockIdx.x * kThreads * kUnroll + threadIdx.x; i0 < s.n4;
       i0 += step) {
    uint4 x[kUnroll], y[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t i = i0 + (int64_t)j * kThreads;
      if (i < s.n4) {
        x[j] = __ldcs(a4 + i);
        y[j] = __ldcs(b4 + i);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (i0 + (int64_t)j * kThreads < s.n4) local += popc4(x[j], y[j]);
    }
  }
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x; j < s.n_scalar(); j += stride) {
    const int64_t i = s.scalar_index(j);
    local += __popc(__ldcs(a + i) & __ldcs(b + i));
  }
  local = __reduce_add_sync(0xffffffffu, local);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    if (total) atomicAdd(&scratch->sum, total);
    __threadfence();  // the sum lands before the ticket is taken
    if (atomicAdd(&scratch->ticket, 1u) == gridDim.x - 1) {
      // every CTA's sum has landed; read it and leave the scratch at zero
      *count = (int32_t)atomicExch(&scratch->sum, 0ull);
      scratch->ticket = 0;
    }
  }
}

}  // namespace

// out[i] = a[i] & b[i] for i < n on `stream`; n must be > 0. Returns a CUDA
// error code: cudaGetLastError() after the launch (0 = success).
extern "C" int bitmap_and_launch(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n,
                                 void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Split s = split(a, b, out, n);
  bitmap_and_kernel<<<blocks_for(s, 0x7fffffff), kThreads, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(a, b, out, s);
  return (int)cudaGetLastError();
}

// *count = popcount(a[i] & b[i]) summed over i < n, as int32, on `stream`;
// n must be > 0 and at most 2^26 - 1. `scratch` is `stream`'s own 16 bytes,
// zero before the first launch; each launch leaves it zero. Returns a CUDA
// error code: cudaGetLastError() after the launch (0 = success).
extern "C" int bitmap_and_popcount_launch(const uint32_t* a, const uint32_t* b, int64_t n,
                                          void* scratch, int32_t* count, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Split s = split(a, b, nullptr, n);
  int wave = 0;
  const int err = wave_of<bitmap_and_popcount_kernel>(&wave);
  if (err) return err;
  bitmap_and_popcount_kernel<<<blocks_for(s, wave), kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      a, b, s, reinterpret_cast<Scratch*>(scratch), count);
  return (int)cudaGetLastError();
}
