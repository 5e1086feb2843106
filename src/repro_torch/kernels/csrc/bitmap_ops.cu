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
// popcount reads 8 and writes one counter. The design:
//   * a grid-stride loop over 16-byte uint4 loads and stores, used when the
//     three pointers (two for the popcount) sit at the same offset mod 16
//     bytes: then scalar words before the first 16-byte boundary (the head)
//     and after the last (the tail), and uint4 between. Pointers at other
//     offsets mod 16 (a view a[1:] beside a fresh b) take scalar words
//     throughout;
//   * the popcount: __popc a word, a per-thread sum, __reduce_add_sync across
//     the warp, the warps' sums in shared memory, and one atomicAdd a CTA
//     into a 64-bit counter the wrapper zeroed. Integer addition does not
//     depend on order, so the count is exact and the same on every run; the
//     wrapper refuses operands whose count could pass int32 (the reference's
//     int32 sum wraps there);
//   * no padding: the grid bounds on n. One wave of CTAs at most.
// This file allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;  // 8 CTAs of 256 per SM of an H100

// Words [0, head) and [head + 4·n4, n) are scalar; [head, head + 4·n4) is
// n4 uint4 vectors.
struct Split {
  int64_t n, head, n4;
  __device__ __forceinline__ int64_t n_scalar() const { return n - 4 * n4; }
  __device__ __forceinline__ int64_t scalar_index(int64_t j) const {
    return j < head ? j : j + 4 * n4;
  }
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

int grid_for(const Split& s) {
  const int64_t items = s.n4 > s.n - 4 * s.n4 ? s.n4 : s.n - 4 * s.n4;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__global__ void bitmap_and_kernel(const uint32_t* __restrict__ a,
                                  const uint32_t* __restrict__ b,
                                  uint32_t* __restrict__ out, Split s) {
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const uint4* __restrict__ a4 = reinterpret_cast<const uint4*>(a + s.head);
  const uint4* __restrict__ b4 = reinterpret_cast<const uint4*>(b + s.head);
  uint4* __restrict__ o4 = reinterpret_cast<uint4*>(out + s.head);
  for (int64_t i = t0; i < s.n4; i += stride) {
    const uint4 x = a4[i], y = b4[i];
    o4[i] = make_uint4(x.x & y.x, x.y & y.y, x.z & y.z, x.w & y.w);
  }
  for (int64_t j = t0; j < s.n_scalar(); j += stride) {
    const int64_t i = s.scalar_index(j);
    out[i] = a[i] & b[i];
  }
}

__global__ void bitmap_and_popcount_kernel(const uint32_t* __restrict__ a,
                                           const uint32_t* __restrict__ b, Split s,
                                           unsigned long long* __restrict__ count) {
  __shared__ unsigned warp_sums[kThreads / 32];
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const uint4* __restrict__ a4 = reinterpret_cast<const uint4*>(a + s.head);
  const uint4* __restrict__ b4 = reinterpret_cast<const uint4*>(b + s.head);
  // at most 2^26 words in all (the wrapper's limit), so 32 bits a thread hold
  unsigned local = 0;
  for (int64_t i = t0; i < s.n4; i += stride) {
    const uint4 x = a4[i], y = b4[i];
    local += __popc(x.x & y.x) + __popc(x.y & y.y) + __popc(x.z & y.z) + __popc(x.w & y.w);
  }
  for (int64_t j = t0; j < s.n_scalar(); j += stride) {
    const int64_t i = s.scalar_index(j);
    local += __popc(a[i] & b[i]);
  }
  local = __reduce_add_sync(0xffffffffu, local);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    if (total) atomicAdd(count, total);
  }
}

}  // namespace

// out[i] = a[i] & b[i] for i < n on `stream`; n must be > 0. Returns
// cudaGetLastError() after the launch.
extern "C" int bitmap_and_launch(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n,
                                 void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Split s = split(a, b, out, n);
  bitmap_and_kernel<<<grid_for(s), kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      a, b, out, s);
  return (int)cudaGetLastError();
}

// *count += popcount(a[i] & b[i]) summed over i < n on `stream`; n must be
// > 0 and *count zeroed by the caller. Returns cudaGetLastError() after the
// launch.
extern "C" int bitmap_and_popcount_launch(const uint32_t* a, const uint32_t* b, int64_t n,
                                          unsigned long long* count, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const Split s = split(a, b, nullptr, n);
  bitmap_and_popcount_kernel<<<grid_for(s), kThreads, 0,
                               reinterpret_cast<cudaStream_t>(stream)>>>(a, b, s, count);
  return (int)cudaGetLastError();
}
