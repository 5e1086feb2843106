// fragment_spmv_packed: the decode-fused hop on Hopper, and its
// block-skipping variant fragment_spmv_packed_active.
//
//   y[dst[e]] ⊕= w[src[e]] ⊗ m[e],   ⊕ ∈ {sum, min, max, bool}
//
// where dst is an int32 column or BCA words (dst_width bits a value), and
// the measure is absent (m_mode none: measure 1), a float32 column (dense),
// BCA words whose integers are the measures (packed), or BCA words of
// indices into a float32 dictionary (dict).
//
// Replaces the TPU kernels repro/kernels/fragment_spmv_packed.py::
// fragment_spmv_packed (_kernel, _decode_block, _packed_operands) and
// ::fragment_spmv_packed_active (_kernel_active). There each 4096-edge grid
// step DMAs EDGE_BLOCK·width/32 words into VMEM and decodes them 32 values at
// a time with a static bit-offset pattern (bitunpack.decode_groups), and the
// dictionary sits in VMEM beside the frontier and the accumulator.
//
// What bounds it: bytes, as for the dense hop, but fewer of them: the dst
// column costs dst_width/8 bytes an edge instead of 4 (22 bits for a 4M-doc
// Document domain), a packed measure m_width/8 instead of 4. The design:
//   * each thread decodes its own edge's dst and measure in registers from
//     the word stream (hop.cuh's PackedDst / PackedMeasure / DictMeasure over
//     bca.cuh): two word loads, which neighbouring threads share, so a warp
//     reads width consecutive words coalesced through L1. The decoded columns
//     never reach device memory;
//   * the schedules, the identity guard, the atomics and the ∞·0 guard are
//     the dense hop's (hop.cuh), so packed and dense cannot drift;
//   * the dictionary (at most DICT_MAX_ENTRIES = 65,536 floats = 256 KB, the
//     reference's cap, which is above the 227 KB of shared memory a CTA can
//     have) is not staged in shared memory: it is read through the read-only
//     path (__ldg), where the entries a column really uses stay in L1/L2;
//   * the word streams are not padded to whole blocks: the decode guards the
//     straddle read of the last word, and the grid bounds on E;
//   * the scatter aggregates per CTA (hop.cuh's scan_agg / active_agg): a
//     CTA combines its products per destination in a shared-memory table and
//     issues one global atomic per distinct destination, so a Zipf-hot
//     destination costs an atomic a CTA, not an atomic an edge (I_DA.Doc's
//     hop falls about sevenfold on the H100, PERF.md). Where no destination
//     is hot the table only costs (I_DT.Term's active hop ~30%), so the
//     caller passes table = 0 for such an index (kernels/ops.py uses_table)
//     and the hop takes hop.cuh's per-edge schedules (scan / active). The
//     aggregating kernels launch one wave (hop.cuh's wave_grid): as many
//     CTAs as are co-resident with the table's shared memory (no more than
//     the index has blocks), the scan each over one contiguous range of
//     edges, the active kernel each over a run of consecutive listed blocks,
//     both into one table flushed once;
//   * the per-edge active kernel launches one wave too (the CTAs
//     co-resident without shared memory), striding over the list, as the
//     dense pair's does: a one-block list costs one wave, not a CTA for each
//     of the index's blocks.
// This file allocates nothing and does not synchronise.

#include "hop.cuh"

namespace {

using namespace hop;

enum MMode { kNone = 0, kDense = 1, kPacked = 2, kDict = 3 };

template <int OP, class Dst, class M>
__global__ void fragment_spmv_packed_kernel(const float* __restrict__ w, int n_src,
                                            const int32_t* __restrict__ src, Dst dst, M m,
                                            int64_t E, float* __restrict__ y, int n_dst,
                                            int table) {
  if (!table) {
    scan<OP, Dst, M>(w, n_src, src, dst, m, E, y, n_dst);
    return;
  }
  extern __shared__ float smem[];
  scan_agg<OP, Dst, M>(smem, w, n_src, src, dst, m, E, y, n_dst);
}

template <int OP, class Dst, class M>
__global__ void fragment_spmv_packed_active_kernel(
    const float* __restrict__ w, int n_src, const int32_t* __restrict__ src, Dst dst, M m,
    int64_t E, float* __restrict__ y, int n_dst, const int32_t* __restrict__ block_idx,
    int n_cap, const int32_t* __restrict__ n_active, int scan_above, int table) {
  if (!table) {
    active<OP, Dst, M>(w, n_src, src, dst, m, E, y, n_dst, block_idx, n_cap, n_active,
                       scan_above);
    return;
  }
  extern __shared__ float smem[];
  active_agg<OP, Dst, M>(smem, w, n_src, src, dst, m, E, y, n_dst, block_idx, n_cap,
                         n_active, scan_above);
}

struct Launch {
  const float* w;
  int n_src;
  const int32_t* src;
  int64_t E;
  float* y;
  int n_dst;
  const int32_t* block_idx;  // nullptr: the scan kernel
  int n_cap;
  const int32_t* n_active;
  int scan_above;
  int table;
  cudaStream_t s;
};

template <int OP, class Dst, class M>
int launch(const Launch& a, Dst dst, M m) {
  int grid = 0;
  size_t smem = 0;
  if (a.block_idx == nullptr) {
    const int err = row_grid<fragment_spmv_packed_kernel<OP, Dst, M>>(a.E, a.table, false,
                                                                      &grid, &smem);
    if (err) return err;
    fragment_spmv_packed_kernel<OP, Dst, M><<<grid, kThreads, smem, a.s>>>(
        a.w, a.n_src, a.src, dst, m, a.E, a.y, a.n_dst, a.table);
  } else {
    const int err = row_grid<fragment_spmv_packed_active_kernel<OP, Dst, M>>(
        a.E, a.table, true, &grid, &smem);
    if (err) return err;
    fragment_spmv_packed_active_kernel<OP, Dst, M><<<grid, kThreads, smem, a.s>>>(
        a.w, a.n_src, a.src, dst, m, a.E, a.y, a.n_dst, a.block_idx, a.n_cap, a.n_active,
        a.scan_above, a.table);
  }
  return 0;
}

template <class Dst, class M>
int by_op(int op, const Launch& a, Dst dst, M m) {
  int err;
  switch (op) {
    case kSum: err = launch<kSum>(a, dst, m); break;
    case kMin: err = launch<kMin>(a, dst, m); break;
    case kMax: err = launch<kMax>(a, dst, m); break;
    case kBool: err = launch<kBool>(a, dst, m); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
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

int dispatch(const Launch& a, int op, const void* dst, int dst_width, int64_t dst_words,
             int m_mode, const void* m, int m_width, int64_t m_words, const float* mdict,
             int n_dict) {
  if (dst_width > 0) {
    PackedDst d{static_cast<const uint32_t*>(dst), dst_words, dst_width};
    return by_measure(op, a, d, m_mode, m, m_width, m_words, mdict, n_dict);
  }
  DenseDst d{static_cast<const int32_t*>(dst)};
  return by_measure(op, a, d, m_mode, m, m_width, m_words, mdict, n_dict);
}

}  // namespace

// One decode-fused hop on `stream`. `y` must already hold the ⊕-identity.
// dst: int32[E] when dst_width == 0, else dst_words uint32 words. m: per
// m_mode (0 none, 1 dense float32[E], 2 packed words, 3 dict words with
// mdict[n_dict]). With block_idx == nullptr the scan kernel runs; otherwise
// the block-skipping kernel over block_idx[n_cap] and n_active[1] (scan
// order when n_active > scan_above). table != 0 aggregates per CTA in
// hop.cuh's shared-memory table; 0 issues one global atomic an edge.
// Returns cudaGetLastError() after the launch. E must be > 0.
extern "C" int fragment_spmv_packed_launch(
    const float* w, int n_src, const int32_t* src, int64_t E, const void* dst, int dst_width,
    int64_t dst_words, int m_mode, const void* m, int m_width, int64_t m_words,
    const float* mdict, int n_dict, float* y, int n_dst, int op, const int32_t* block_idx,
    int n_cap, const int32_t* n_active, int scan_above, int table, void* stream) {
  Launch a{w, n_src, src, E, y, n_dst, block_idx, n_cap, n_active, scan_above, table ? 1 : 0,
           reinterpret_cast<cudaStream_t>(stream)};
  return dispatch(a, op, dst, dst_width, dst_words, m_mode, m, m_width, m_words, mdict,
                  n_dict);
}
