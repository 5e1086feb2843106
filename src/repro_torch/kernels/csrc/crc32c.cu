// crc32c: CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) of a byte
// stream on Hopper, continuing from a previous value so that parts chain.
//
// Replaces no TPU kernel: the reference hashes on the host
// (repro/storage/integrity.py::crc32c, through google_crc32c or a byte loop).
// It is here because the port's integrity layer (manifests, verified reads,
// snapshots, the scrubber) hashes the device column store, hundreds of MB,
// where the data lives. It gives the reference's values bit for bit.
//
// What bounds it: bytes. It reads each byte once and writes 8; a CRC is
// linear over GF(2), so the stream splits into pieces hashed apart and
// combined. The design:
//   * the stream is cut into a head (bytes before the first 16-byte
//     boundary), a body of 16-byte units and a tail (< 16 bytes); the body
//     is zero-padded at the front, virtually, to a whole number of tiles for
//     every warp (leading zeros leave a CRC that starts at 0 unchanged);
//   * a tile is 512 bytes, a uint4 a lane, so a warp's loads coalesce; the
//     warps stride over the tiles (warp g takes tiles g, g + W, g + 2W, ...
//     for W warps in the grid, one wave of CTAs), evict-first loads, kUnroll
//     tiles in flight;
//   * each lane keeps a raw CRC register (start 0, no final XOR) over its own
//     uint4s: before each one it carries the register over the W·512 − 16
//     bytes between them (one GF(2) operator as four byte tables in shared
//     memory), then hashes the 16 bytes by slicing-by-8 (eight 256-entry
//     tables in shared memory, built by the CTA at its start);
//   * at the end the lanes combine in a shuffle tree (level l carries the
//     left value over 16·2^l bytes: x^(2^(7+l)) mod P), the CTA's warps in
//     order (512 bytes apart), and each CTA carries its value over the bytes
//     of the CTAs after it (x^(8·d) mod P by square-and-multiply from the
//     table kX2n), then XORs it into the stream's scratch word; the last CTA
//     to take a ticket folds in the head and the tail (byte by byte), the
//     previous value and the final XOR, writes the CRC and leaves the scratch
//     at zero for the next launch on that stream (bitmap_ops.cu's pattern).
// The operators that depend only on the lengths and the previous value are
// computed on the host (crc32c_launch) and passed in. The per-step work is
// 20 shared-memory table reads and ~40 integer operations a uint4: with
// random indices the reads conflict on banks, which may bound it before the
// memory does. This file allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

// x^(2^k) mod P for k < 64, in the reflected representation (x^0 = 1 << 31);
// kernels/ref.py's X2N holds the same values.
#define CRC32C_X2N                                                                         \
  {0x40000000u, 0x20000000u, 0x08000000u, 0x00800000u, 0x00008000u, 0x82f63b78u,          \
   0x6ea2d55cu, 0x18b8ea18u, 0x510ac59au, 0xb82be955u, 0xb8fdb1e7u, 0x88e56f72u,          \
   0x74c360a4u, 0xe4172b16u, 0x0d65762au, 0x35d73a62u, 0x28461564u, 0xbf455269u,          \
   0xe2ea32dcu, 0xfe7740e6u, 0xf946610bu, 0x3c204f8fu, 0x538586e3u, 0x59726915u,          \
   0x734d5309u, 0xbc1ac763u, 0x7d0722ccu, 0xd289cabeu, 0xe94ca9bcu, 0x05b74f3fu,          \
   0xa51e1f42u, 0x40000000u, 0x20000000u, 0x08000000u, 0x00800000u, 0x00008000u,          \
   0x82f63b78u, 0x6ea2d55cu, 0x18b8ea18u, 0x510ac59au, 0xb82be955u, 0xb8fdb1e7u,          \
   0x88e56f72u, 0x74c360a4u, 0xe4172b16u, 0x0d65762au, 0x35d73a62u, 0x28461564u,          \
   0xbf455269u, 0xe2ea32dcu, 0xfe7740e6u, 0xf946610bu, 0x3c204f8fu, 0x538586e3u,          \
   0x59726915u, 0x734d5309u, 0xbc1ac763u, 0x7d0722ccu, 0xd289cabeu, 0xe94ca9bcu,          \
   0x05b74f3fu, 0xa51e1f42u, 0x40000000u, 0x20000000u}

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                // tiles in flight a lane
constexpr int64_t kTile = 32 * 16;        // bytes a warp reads a step
constexpr int kLogTile = 9;               // kTile = 2^9 bytes

__constant__ uint32_t kX2n[64] = CRC32C_X2N;
constexpr uint32_t kX2nHost[64] = CRC32C_X2N;

// A launch's scratch, one for each stream the wrapper launches on: zero
// before the first launch, and each launch leaves it zero.
struct Scratch {
  unsigned int x;       // XOR of the CTAs' contributions
  unsigned int ticket;  // last-CTA ticket
};

// a·b mod P over GF(2), reflected.
__host__ __device__ __forceinline__ uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll 8
  for (int i = 31; i >= 0; --i) {
    p ^= b & (0u - ((a >> i) & 1u));
    b = (b >> 1) ^ (kPoly & (0u - (b & 1u)));
  }
  return p;
}

// x^(8n) mod P: multiplying a raw register by it carries it over n zero bytes.
__device__ uint32_t x8nmodp(uint64_t n) {
  uint32_t p = 1u << 31;
  for (int k = 3; n; n >>= 1, ++k) {
    if (n & 1) p = multmodp(kX2n[k], p);
  }
  return p;
}

uint32_t host_x8nmodp(uint64_t n) {
  uint32_t p = 1u << 31;
  for (int k = 3; n; n >>= 1, ++k) {
    if (n & 1) p = multmodp(kX2nHost[k], p);
  }
  return p;
}

// Eight little-endian bytes (lo, hi) into the register, slicing-by-8.
__device__ __forceinline__ uint32_t step8(const uint32_t (*tab)[256], uint32_t crc, uint32_t lo,
                                          uint32_t hi) {
  crc ^= lo;
  return tab[7][crc & 255u] ^ tab[6][(crc >> 8) & 255u] ^ tab[5][(crc >> 16) & 255u] ^
         tab[4][crc >> 24] ^ tab[3][hi & 255u] ^ tab[2][(hi >> 8) & 255u] ^
         tab[1][(hi >> 16) & 255u] ^ tab[0][hi >> 24];
}

// The register carried over the fixed gap between a lane's uint4s.
__device__ __forceinline__ uint32_t carry(const uint32_t (*op)[256], uint32_t crc) {
  return op[0][crc & 255u] ^ op[1][(crc >> 8) & 255u] ^ op[2][(crc >> 16) & 255u] ^
         op[3][crc >> 24];
}

struct Args {
  const uint8_t* data;  // the stream
  int64_t head;         // bytes before the body (< 16)
  int64_t units;        // 16-byte units of the body
  int64_t pad_units;    // zero units in front of the body (virtual)
  int64_t steps;        // tiles a warp
  int64_t tail;         // bytes after the body (< 16)
  uint32_t op_gap;      // x^(8·(W·kTile − 16)): a lane's gap between uint4s
  uint32_t op_head;     // x^(8·(body + tail)): the head's raw CRC to the end
  uint32_t op_body;     // x^(8·tail): the body's raw CRC to the end
  uint32_t fold;        // shift(value ^ ~0, n) ^ ~0: the previous value and final XOR
};

__global__ void __launch_bounds__(kThreads) crc32c_kernel(Args a, Scratch* __restrict__ scratch,
                                                          int64_t* __restrict__ out) {
  __shared__ uint32_t tab[8][256];
  __shared__ uint32_t gap[4][256];
  __shared__ uint32_t warp_crc[kWarps];
  const int t = threadIdx.x;
  uint32_t c = (uint32_t)t;
  for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
  tab[0][t] = c;
  __syncthreads();
  for (int k = 1; k < 8; ++k) {
    c = (c >> 8) ^ tab[0][c & 255u];
    tab[k][t] = c;
  }
  for (int j = 0; j < 4; ++j) gap[j][t] = multmodp(a.op_gap, (uint32_t)t << (8 * j));
  __syncthreads();

  const int lane = t & 31, warp = t >> 5;
  const int64_t W = (int64_t)gridDim.x * kWarps;
  const int64_t g = (int64_t)blockIdx.x * kWarps + warp;
  const uint4* __restrict__ body = reinterpret_cast<const uint4*>(a.data + a.head);
  uint32_t acc = 0;
  for (int64_t k0 = 0; k0 < a.steps; k0 += kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t unit = (g + (k0 + u) * W) * 32 + lane - a.pad_units;
      v[u] = (k0 + u < a.steps && unit >= 0) ? __ldcs(body + unit) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u < a.steps) {
        acc = carry(gap, acc);
        acc = step8(tab, acc, v[u].x, v[u].y);
        acc = step8(tab, acc, v[u].z, v[u].w);
      }
    }
  }
  // lanes in order: level l carries the left value over 16·2^l bytes
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const uint32_t right = __shfl_down_sync(0xffffffffu, acc, 1 << l);
    const uint32_t left = multmodp(kX2n[7 + l], acc);
    if ((lane & ((2 << l) - 1)) == 0) acc = left ^ right;
  }
  if (lane == 0) warp_crc[warp] = acc;
  __syncthreads();
  if (t == 0) {
    // the CTA's warps in order, a tile apart, then carried over the tiles of
    // the CTAs after this one
    uint32_t cta = 0;
    for (int w = 0; w < kWarps; ++w) cta = multmodp(kX2n[3 + kLogTile], cta) ^ warp_crc[w];
    cta = multmodp(x8nmodp((uint64_t)(gridDim.x - 1 - blockIdx.x) * kWarps * kTile), cta);
    if (cta) atomicXor(&scratch->x, cta);
    __threadfence();  // the contribution lands before the ticket is taken
    if (atomicAdd(&scratch->ticket, 1u) == gridDim.x - 1) {
      const uint32_t raw_body = atomicExch(&scratch->x, 0u);
      uint32_t h = 0, tl = 0;
      for (int64_t i = 0; i < a.head; ++i) h = tab[0][(h ^ a.data[i]) & 255u] ^ (h >> 8);
      const uint8_t* tail = a.data + a.head + a.units * 16;
      for (int64_t i = 0; i < a.tail; ++i) tl = tab[0][(tl ^ tail[i]) & 255u] ^ (tl >> 8);
      const uint32_t raw = multmodp(a.op_head, h) ^ multmodp(a.op_body, raw_body) ^ tl;
      *out = (int64_t)(raw ^ a.fold);
      scratch->ticket = 0;
    }
  }
}

// The CTAs of crc32c_kernel that are co-resident on the card, asked once.
int wave_of(int* wave) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, per_sm = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crc32c_kernel, kThreads, 0);
    }
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms <= 0) return (int)cudaErrorInvalidConfiguration;
    cached = per_sm * sms;
  }
  *wave = cached;
  return 0;
}

}  // namespace

// *out = CRC-32C of data[0, n) continuing from `value`, as a non-negative
// int64, on `stream`; n must be > 0. `scratch` is `stream`'s own 8 bytes,
// zero before the first launch; each launch leaves it zero. Returns a CUDA
// error code: cudaGetLastError() after the launch (0 = success).
extern "C" int crc32c_launch(const uint8_t* data, int64_t n, uint32_t value, void* scratch,
                             int64_t* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.data = data;
  a.head = (int64_t)((16 - ((uintptr_t)data & 15)) & 15);
  if (a.head > n) a.head = n;
  a.units = (n - a.head) / 16;
  a.tail = n - a.head - a.units * 16;
  int wave = 0;
  const int err = wave_of(&wave);
  if (err) return err;
  const int64_t tiles = (a.units + 31) / 32;
  int64_t blocks = (tiles + kWarps - 1) / kWarps;
  if (blocks < 1) blocks = 1;
  if (blocks > wave) blocks = wave;
  const int64_t W = blocks * kWarps;
  a.steps = (tiles + W - 1) / W;
  a.pad_units = a.steps * W * 32 - a.units;
  a.op_gap = host_x8nmodp((uint64_t)(W * kTile - 16));
  a.op_head = host_x8nmodp((uint64_t)(n - a.head));
  a.op_body = host_x8nmodp((uint64_t)a.tail);
  a.fold = multmodp(host_x8nmodp((uint64_t)n), value ^ 0xffffffffu) ^ 0xffffffffu;
  crc32c_kernel<<<(int)blocks, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      a, reinterpret_cast<Scratch*>(scratch), out);
  return (int)cudaGetLastError();
}
