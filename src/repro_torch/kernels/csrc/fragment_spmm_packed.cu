// fragment_spmm_packed: the decode-fused batched hop on Hopper, and its
// block-skipping variant fragment_spmm_packed_active.
//
//   Y[b, dst[e]] ⊕= W[b, src[e]] ⊗ m[e]   for every edge e and row b < B,
//   ⊕ ∈ {sum, min, max, bool}
//
// where dst is an int32 column or BCA words (dst_width bits a value) and the
// measure, shared by the rows, is absent (m_mode none: measure 1), a float32
// column (dense), BCA words whose integers are the measures (packed), or BCA
// words of indices into a float32 dictionary (dict) — the modes of
// fragment_spmv_packed.
//
// Replaces the TPU kernels repro/kernels/fragment_spmm.py::
// fragment_spmm_packed (_kernel_packed) and ::fragment_spmm_packed_active
// (_kernel_packed_active). There each 4096-edge block's words are DMA'd into
// VMEM and decoded once (bitunpack.decode_groups) for all B rows of the
// VMEM-resident W and Y: one decode serves the batch, which is that kernel's
// point.
//
// What bounds it: bytes — the packed streams as stored (22-bit dst over 4M
// documents: 2.75 bytes an edge instead of 4) read once for B rows, plus a
// gather of W[b, src] and, where the row is live, an atomic on Y[b, dst] per
// row. The design keeps the reference's point: each thread decodes its
// edge's dst and measure in registers once (hop.cuh's PackedDst /
// PackedMeasure / DictMeasure over bca.cuh), at the first row that needs
// them, and reuses the values for every row (hop.cuh's edge_rows); the
// schedules, guards and atomics are the dense SpMM's, so packed and dense
// cannot drift. Row offsets are int64. The dictionary is read through the
// read-only path (__ldg), as in the SpMV. A per-row measure stream is the
// dense SpMM's (fragment_spmm.cu): the executor sends a batch-dependent
// measure there. This file allocates nothing and does not synchronise.

#include "hop.cuh"

namespace {

using namespace hop;

enum MMode { kNone = 0, kDense = 1, kPacked = 2, kDict = 3 };

template <int OP, class Dst, class M>
__global__ void fragment_spmm_packed_kernel(FrontierRows<OP> w,
                                            const int32_t* __restrict__ src, Dst dst, M m,
                                            int64_t E, float* __restrict__ y, int n_dst,
                                            int B) {
  scan_rows<OP>(w, src, dst, m, E, y, n_dst, B);
}

template <int OP, class Dst, class M>
__global__ void fragment_spmm_packed_active_kernel(
    FrontierRows<OP> w, const int32_t* __restrict__ src, Dst dst, M m, int64_t E,
    float* __restrict__ y, int n_dst, int B, const int32_t* __restrict__ block_idx, int n_cap,
    const int32_t* __restrict__ n_active, int scan_above) {
  active_rows<OP>(w, src, dst, m, E, y, n_dst, B, block_idx, n_cap, n_active, scan_above);
}

struct Launch {
  const float* w;
  int n_src;
  int B;
  const int32_t* src;
  int64_t E;
  float* y;
  int n_dst;
  const int32_t* block_idx;  // nullptr: the scan kernel
  int n_cap;
  const int32_t* n_active;
  int scan_above;
  cudaStream_t s;
};

template <int OP, class Dst, class M>
void launch(const Launch& a, Dst dst, M m) {
  FrontierRows<OP> w{a.w, a.n_src};
  SharedRows<M> rows{m};
  if (a.block_idx == nullptr) {
    fragment_spmm_packed_kernel<OP, Dst, SharedRows<M>>
        <<<scan_grid(a.E), kThreads, 0, a.s>>>(w, a.src, dst, rows, a.E, a.y, a.n_dst, a.B);
  } else {
    fragment_spmm_packed_active_kernel<OP, Dst, SharedRows<M>>
        <<<(int)n_edge_blocks(a.E), kThreads, 0, a.s>>>(w, a.src, dst, rows, a.E, a.y,
                                                        a.n_dst, a.B, a.block_idx, a.n_cap,
                                                        a.n_active, a.scan_above);
  }
}

template <class Dst, class M>
int by_op(int op, const Launch& a, Dst dst, M m) {
  switch (op) {
    case kSum: launch<kSum>(a, dst, m); break;
    case kMin: launch<kMin>(a, dst, m); break;
    case kMax: launch<kMax>(a, dst, m); break;
    case kBool: launch<kBool>(a, dst, m); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <class Dst>
int by_measure(int op, const Launch& a, Dst dst, int m_mode, const void* m, int m_width,
               int64_t m_words, const float* mdict, int n_dict) {
  const uint32_t* mw = static_cast<const uint32_t*>(m);
  switch (m_mode) {
    case kNone: return by_op(op, a, dst, NoMeasure{});
    case kDense: return by_op(op, a, dst, DenseMeasure{static_cast<const float*>(m)});
    case kPacked: return by_op(op, a, dst, PackedMeasure{mw, m_words, m_width});
    case kDict: return by_op(op, a, dst, DictMeasure{mw, m_words, m_width, mdict, n_dict});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One decode-fused batched hop on `stream`. W is float32[B, n_src] and Y
// float32[B, n_dst], row-major; Y must already hold the ⊕-identity. dst:
// int32[E] when dst_width == 0, else dst_words uint32 words. m: per m_mode
// (0 none, 1 dense float32[E], 2 packed words, 3 dict words with
// mdict[n_dict]), shared by the rows. With block_idx == nullptr the scan
// kernel runs; otherwise the block-skipping kernel over block_idx[n_cap] and
// n_active[1] (scan order when n_active > scan_above). Returns
// cudaGetLastError() after the launch. E and B must be > 0.
extern "C" int fragment_spmm_packed_launch(
    const float* w, int n_src, int B, const int32_t* src, int64_t E, const void* dst,
    int dst_width, int64_t dst_words, int m_mode, const void* m, int m_width, int64_t m_words,
    const float* mdict, int n_dict, float* y, int n_dst, int op, const int32_t* block_idx,
    int n_cap, const int32_t* n_active, int scan_above, void* stream) {
  Launch a{w, n_src, B, src, E, y, n_dst, block_idx, n_cap, n_active, scan_above,
           reinterpret_cast<cudaStream_t>(stream)};
  if (dst_width > 0) {
    PackedDst d{static_cast<const uint32_t*>(dst), dst_words, dst_width};
    return by_measure(op, a, d, m_mode, m, m_width, m_words, mdict, n_dict);
  }
  DenseDst d{static_cast<const int32_t*>(dst)};
  return by_measure(op, a, d, m_mode, m, m_width, m_words, mdict, n_dict);
}
