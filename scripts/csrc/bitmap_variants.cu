// bitmap_variants: other schedules of the bitmap AND (src/repro_torch/kernels/
// csrc/bitmap_ops.cu), built and timed only by scripts/launch_probe.py (part
// `variants`) beside the package's kernel, to see which moves the AND of two
// 2^26-word bitmaps closest to its bytes bound (12 bytes a word).
//
//   variant 0: one wave of CTAs, kUnroll uint4 pairs in flight a thread,
//              evict-first loads and stores (the package's schedule);
//   variant 1: the same with the default cache policy;
//   variant 2: a CTA for each chunk of kThreads · kUnroll uint4 (as many CTAs
//              as chunks, the hardware's block scheduler balancing them),
//              evict-first;
//   variant 3: variant 2 with the default cache policy;
//   variant 4: a TMA bulk-copy ring: persistent CTAs, kStages stages of an
//              8 KiB tile of each operand brought into shared memory by
//              cp.async.bulk and counted by an mbarrier each, the AND written
//              to a shared tile and sent back by a bulk store (the store of a
//              stage is waited for, by wait_group.read, only when the stage
//              comes round again).
//
// Every variant takes 16-byte-aligned operands of n words, n a multiple of 4
// (the probe's shapes), and returns cudaErrorInvalidValue otherwise. Nothing
// is allocated and nothing synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kTileVec = 512;  // uint4 a tile of one operand: 8 KiB
constexpr int kStages = 4;
constexpr int kTmaThreads = 128;
constexpr int kTmaSmem = 3 * kStages * kTileVec * 16;  // a, b and the AND: 96 KiB

__device__ __forceinline__ uint4 and4(uint4 x, uint4 y) {
  return make_uint4(x.x & y.x, x.y & y.y, x.z & y.z, x.w & y.w);
}

template <bool kHints>
__device__ __forceinline__ uint4 ld(const uint4* p) {
  if constexpr (kHints) return __ldcs(p);
  return *p;
}

template <bool kHints>
__device__ __forceinline__ void st(uint4* p, uint4 v) {
  if constexpr (kHints) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

template <bool kHints>
__global__ void __launch_bounds__(kThreads) and_strided(const uint4* __restrict__ a,
                                                        const uint4* __restrict__ b,
                                                        uint4* __restrict__ o, int64_t n4) {
  const int64_t step = (int64_t)gridDim.x * kThreads * kUnroll;
  for (int64_t i0 = (int64_t)blockIdx.x * kThreads * kUnroll + threadIdx.x; i0 < n4;
       i0 += step) {
    uint4 x[kUnroll], y[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t i = i0 + (int64_t)j * kThreads;
      if (i < n4) {
        x[j] = ld<kHints>(a + i);
        y[j] = ld<kHints>(b + i);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t i = i0 + (int64_t)j * kThreads;
      if (i < n4) st<kHints>(o + i, and4(x[j], y[j]));
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__global__ void __launch_bounds__(kTmaThreads) and_tma(const uint4* __restrict__ a,
                                                       const uint4* __restrict__ b,
                                                       uint4* __restrict__ o, int64_t n4) {
  extern __shared__ __align__(128) uint4 smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  uint4* sa = smem;
  uint4* sb = smem + kStages * kTileVec;
  uint4* so = smem + 2 * kStages * kTileVec;
  const int64_t tiles = (n4 + kTileVec - 1) / kTileVec;
  const int64_t mine = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&full[s]))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0: the k-th tile of this CTA into stage k % kStages
  auto issue = [&](int64_t k) {
    const int s = (int)(k % kStages);
    const int64_t v0 = ((int64_t)blockIdx.x + k * gridDim.x) * kTileVec;
    const int64_t left = n4 - v0;
    const uint32_t bytes = (uint32_t)((left < kTileVec ? left : kTileVec) * 16);
    const uint32_t bar = smem_u32(&full[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(2 * bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_u32(sa + s * kTileVec)),
        "l"(a + v0), "r"(bytes), "r"(bar)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_u32(sb + s * kTileVec)),
        "l"(b + v0), "r"(bytes), "r"(bar)
        : "memory");
  };
  if (threadIdx.x == 0) {
    for (int64_t k = 0; k < mine && k < kStages; ++k) issue(k);
  }
  for (int64_t k = 0; k < mine; ++k) {
    const int s = (int)(k % kStages);
    wait_parity(smem_u32(&full[s]), (uint32_t)((k / kStages) & 1));
    if (threadIdx.x == 0) {
      // the bulk store that read this stage's AND tile kStages tiles ago is done reading
      asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kStages - 1) : "memory");
    }
    __syncthreads();
    const int64_t v0 = ((int64_t)blockIdx.x + k * gridDim.x) * kTileVec;
    const int64_t left = n4 - v0;
    const int nv = (int)(left < kTileVec ? left : kTileVec);
    for (int i = threadIdx.x; i < nv; i += kTmaThreads) {
      so[s * kTileVec + i] = and4(sa[s * kTileVec + i], sb[s * kTileVec + i]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(o + v0),
                   "r"(smem_u32(so + s * kTileVec)), "r"((uint32_t)(nv * 16))
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (k + kStages < mine) issue(k + kStages);
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <auto Kernel>
int wave(int threads, int smem, int* out) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, per_sm = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && smem > 48 * 1024) {
      err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, threads, smem);
    }
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms <= 0) return (int)cudaErrorInvalidConfiguration;
    cached = per_sm * sms;
  }
  *out = cached;
  return 0;
}

}  // namespace

// out[i] = a[i] & b[i] for i < n by `variant` (0-4, above) on `stream`.
// Returns a CUDA error code (0 = success).
extern "C" int bitmap_and_variant_launch(int variant, const void* a, const void* b, void* out,
                                         int64_t n, void* stream) {
  if (n <= 0 || n % 4 != 0 || (((uintptr_t)a | (uintptr_t)b | (uintptr_t)out) & 15) != 0 ||
      variant < 0 || variant > 4) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n4 = n / 4;
  const auto* a4 = static_cast<const uint4*>(a);
  const auto* b4 = static_cast<const uint4*>(b);
  auto* o4 = static_cast<uint4*>(out);
  auto s = reinterpret_cast<cudaStream_t>(stream);
  const int64_t chunks = (n4 + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  int grid = 0, err = 0;
  switch (variant) {
    case 0:
    case 1:
      err = variant == 0 ? wave<and_strided<true>>(kThreads, 0, &grid)
                         : wave<and_strided<false>>(kThreads, 0, &grid);
      if (err) return err;
      grid = (int)(chunks < grid ? chunks : grid);
      if (variant == 0) {
        and_strided<true><<<grid, kThreads, 0, s>>>(a4, b4, o4, n4);
      } else {
        and_strided<false><<<grid, kThreads, 0, s>>>(a4, b4, o4, n4);
      }
      break;
    case 2:
      and_strided<true><<<(unsigned)chunks, kThreads, 0, s>>>(a4, b4, o4, n4);
      break;
    case 3:
      and_strided<false><<<(unsigned)chunks, kThreads, 0, s>>>(a4, b4, o4, n4);
      break;
    default: {
      err = wave<and_tma>(kTmaThreads, kTmaSmem, &grid);
      if (err) return err;
      const int64_t tiles = (n4 + kTileVec - 1) / kTileVec;
      grid = (int)(tiles < grid ? tiles : grid);
      and_tma<<<grid, kTmaThreads, kTmaSmem, s>>>(a4, b4, o4, n4);
    }
  }
  return (int)cudaGetLastError();
}
