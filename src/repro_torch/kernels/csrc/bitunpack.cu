// bitunpack: decode `count` little-endian `width`-bit values (width 1..32)
// from a uint32 word stream into int32, on Hopper.
//
// Replaces the TPU kernel repro/kernels/bitunpack.py::bitunpack
// (decode_groups, _group_pattern). There a grid step decodes 1024 values as
// 32 groups of 32 with a static per-group bit-offset pattern, so the word
// operands of each output column are static column selects on the VPU.
//
// What bounds it: bytes. It reads count·width/8 bytes and writes 4·count;
// the shifts and masks are a few integer operations a value. The design is
// the simple one: one thread per value in a grid-stride loop, a 64-bit bit
// offset (bca.cuh), two word loads that neighbouring threads share (a warp's
// 32 values span `width` consecutive words, so the loads coalesce through
// L1), and a coalesced int32 store. The straddle read at the stream's last
// word is guarded, since streams here are not padded to whole blocks. A
// warp-per-32-value-group design (the TPU kernel's GROUP = 32 mapped onto a
// warp: `width` coalesced word loads, lanes extracting by shift) is the
// natural next step. This file allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bca.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

__global__ void bitunpack_kernel(const uint32_t* __restrict__ words, int64_t n_words,
                                 int width, int64_t count, int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride) {
    out[i] = (int32_t)bca::get(words, n_words, width, i);
  }
}

}  // namespace

// Decode on `stream`; count must be > 0 and the stream must hold
// ceil(count·width / 32) words. Returns cudaGetLastError() after the launch.
extern "C" int bitunpack_launch(const uint32_t* words, int64_t n_words, int width,
                                int64_t count, int32_t* out, void* stream) {
  if (width < 1 || width > 32) return (int)cudaErrorInvalidValue;
  int64_t blocks = (count + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  bitunpack_kernel<<<(int)blocks, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      words, n_words, width, count, out);
  return (int)cudaGetLastError();
}
