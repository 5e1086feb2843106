// red_rate: the card's rate of float reductions to global memory, the
// second floor of a scatter (scripts/hop_table_probe.py, part 5).
//
//   y[addr(i)] += 1.0f   for i < count
//
// mode 0: addr = (i · 0x9E3779B1) mod n, n a power of two: distinct
//         addresses within a warp and a wave, each address hit count / n
//         times over the run (a spread scatter; no index is loaded);
// mode 1: the same with an L2::evict_last policy on every reduction;
// mode 2: addr = i mod n: a warp's 32 reductions on consecutive words;
// mode 3: one red.global.add.v4.f32 (four floats) into the first half of
//         32-byte sector (i · 0x9E3779B1) mod (n / 8): distinct sectors;
// mode 4: two of them, filling that sector (the batched hops' 8-row chunk).
// One thread a reduction (modes 3, 4: a sector) in a grid-stride loop;
// nothing else is read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void red_rate_kernel(float* __restrict__ y, int64_t n, int64_t count, int mode) {
  uint64_t pol = 0;
  if (mode == 1) asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride) {
    const uint64_t a = mode == 2 ? (uint64_t)i : (uint64_t)i * 0x9E3779B1ull;
    float* p = y + (a & (uint64_t)(n - 1));
    if (mode >= 3) {
      float* q = y + 8 * (a & (uint64_t)(n / 8 - 1));
      asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
                   :: "l"(q), "f"(1.0f), "f"(1.0f), "f"(1.0f), "f"(1.0f) : "memory");
      if (mode == 4) {
        asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
                     :: "l"(q + 4), "f"(1.0f), "f"(1.0f), "f"(1.0f), "f"(1.0f) : "memory");
      }
    } else if (mode == 1) {
      asm volatile("red.global.add.L2::cache_hint.f32 [%0], %1, %2;"
                   :: "l"(p), "f"(1.0f), "l"(pol) : "memory");
    } else {
      atomicAdd(p, 1.0f);
    }
  }
}

}  // namespace

// n must be a power of two (at least 8). Returns cudaGetLastError() after the launch.
extern "C" int red_rate_launch(float* y, int64_t n, int64_t count, int mode, void* stream) {
  red_rate_kernel<<<132 * 8, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(y, n, count,
                                                                             mode);
  return (int)cudaGetLastError();
}
