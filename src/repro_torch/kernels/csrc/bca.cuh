// bca.cuh: point decode of a BCA (bit-aligned compressed array) word stream.
//
// Layout (written by core/fragments.py::_pack_words): value i occupies bits
// [i*width, (i+1)*width) of a little-endian uint32 word stream, width 1..32,
// so a value may straddle two words. Shared by bitunpack.cu (whole-column
// decode) and fragment_spmv_packed.cu (decode inside the hop).
//
// The bit offset is 64-bit: i*width passes 2^32 bits at about 138M values of
// width 31, which a 32-bit offset would wrap. The stream is not padded past
// its last word (the TPU kernels pad to whole blocks; the port does not), so
// the straddle read of the second word is guarded: a value that ends inside
// the last word never reads past it.

#pragma once

#include <stdint.h>

namespace bca {

__device__ __forceinline__ uint32_t get(const uint32_t* __restrict__ words, int64_t n_words,
                                        int width, int64_t i) {
  const int64_t bit = i * (int64_t)width;
  const int64_t w0 = bit >> 5;
  const int off = (int)(bit & 31);
  uint64_t v = __ldg(words + w0);
  if (off + width > 32 && w0 + 1 < n_words) {
    v |= (uint64_t)__ldg(words + w0 + 1) << 32;
  }
  const uint64_t mask = width >= 32 ? 0xFFFFFFFFull : ((1ull << width) - 1ull);
  return (uint32_t)((v >> off) & mask);
}

}  // namespace bca
