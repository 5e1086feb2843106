// crc32c: CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) of a byte
// stream on Hopper, continuing from a previous value so that parts chain.
//
// Replaces no TPU kernel: the reference hashes on the host
// (repro/storage/integrity.py::crc32c, through google_crc32c or a byte loop).
// It is here because the port's integrity layer (manifests, verified reads,
// snapshots, the scrubber) hashes the device column store, hundreds of MB,
// where the data lives. It gives the reference's values bit for bit.
//
// What bounds it: bytes, once the table reads do not. It reads each byte
// once and writes 8; a CRC is linear over GF(2), so the stream splits into
// pieces hashed apart and combined. Its work is table reads in shared
// memory, one a byte: with the tables laid out plainly the 32 lanes of a
// warp read at random indices and conflict on banks, and those conflicts,
// not the carry between a lane's uint4s, are what held a plain layout far
// from the bytes' bound (the measurement builds below show both). The
// design:
//   * the stream is cut into a head (bytes before the first 16-byte
//     boundary), a body of 16-byte units and a tail (< 16 bytes); the body
//     is zero-padded at the front, virtually, to a whole number of tiles for
//     every warp (leading zeros leave a CRC that starts at 0 unchanged);
//   * a tile is 512 bytes, a uint4 a lane, so a warp's loads coalesce; the
//     warps stride over the tiles (warp g takes tiles g, g + W, g + 2W, ...
//     for W warps in the grid, one CTA of 32 warps an SM), evict-first
//     loads, kUnroll tiles in flight, the first of them issued before the
//     tables are built; only a warp's first step reaches into the padding;
//   * the tables are a lane's own: slicing-by-4 (four 256-entry tables) with
//     a copy of every entry in each of the 32 banks, entry e of lane l at
//     word (e·32 + l) of its table, so the lanes' reads never conflict, and
//     the step operator (x^(8·W·512) mod P as four byte tables) with a copy
//     a half-warp lane, where two lanes can meet on a bank: 192 KiB of
//     dynamic shared memory, built by the CTA at its start;
//   * each lane keeps a raw CRC register (start 0, no final XOR) over its own
//     uint4s: at each step it carries the register over the W·512 bytes to
//     its next uint4 (4 reads) and XORs in that uint4's own CRC (16 reads,
//     which depend on the data alone, so the register's chain is one read
//     deep a step);
//   * at the end each thread carries its register over the bytes after its
//     last uint4, to its CTA's end (kThreadPow) and the grid's (kCtaPow), and
//     over the tail (op_body): one product of constants a thread, taken
//     before the loop; CTA 0's first two threads add the head's and the
//     tail's raw CRCs (byte by byte) and the previous value's fold; the
//     threads' values XOR together and each CTA XORs its value into the
//     stream's scratch word, and the last CTA to take a ticket reads the
//     sum, which is the CRC, and leaves the scratch at zero for the next
//     launch on that stream (bitmap_ops.cu's pattern).
// The operators that depend only on the lengths and the previous value are
// computed on the host (crc32c_launch) and passed in. Two builds exist for
// measurement only (scripts/redesign_probe.py): -DCRC32C_SHARED_TABLES has
// every lane read entry e from the copy in bank e mod 32 (the bank conflicts
// of a plain table, the same values) and -DCRC32C_NO_STEP drops the step's
// carry (a wrong value: what the carry costs). This file allocates nothing
// and does not synchronise.

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
constexpr int kWarps = 32;                // a CTA's warps: one CTA an SM
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;                // tiles in flight a lane
constexpr int64_t kTile = 32 * 16;        // bytes a warp reads a step
constexpr int kMaxCtas = 256;             // kCtaPow's entries
constexpr int kSWords = 4 * 256 * 32;     // slicing-by-4, a copy a bank
constexpr int kHWords = 4 * 256 * 16;     // the step operator, a copy a half-warp lane
constexpr size_t kSmemBytes = (size_t)(kSWords + kHWords) * 4;  // 196,608

// The carries a thread's register takes at the end, each x^(8n) mod P: over
// the n = 16·(1023 − t) bytes after thread t's uint4 in its CTA's 32 tiles
// (kThreadPow, read coalesced), and the n = 16384·d bytes of the d CTAs after
// it (kCtaPow). kernels/ref.py's x8nmodp gives the same values; a CPU test
// checks them.
__device__ const uint32_t kThreadPow[kThreads] = {
    0x99513d23u, 0x48046c93u, 0xbd91aec7u, 0xc98435d9u, 0x4ac192beu, 0xe753831du,
    0x1d6af0fdu, 0xb9475886u, 0x36cff3cbu, 0x974f0340u, 0xae87c8a8u, 0x24c4401au,
    0x57c7bb6eu, 0x96e7be07u, 0xf03e9401u, 0xd847ebfdu, 0x772b643cu, 0x2f21bce9u,
    0xf234aeb1u, 0xe74ed611u, 0x664a07f2u, 0xf66df9f0u, 0x2c97a0f2u, 0x84950b74u,
    0x62636f28u, 0x35efc574u, 0x8238c582u, 0x1b4a481eu, 0x47a23a81u, 0xb8339931u,
    0x99363a43u, 0x5282b1beu, 0x33765e07u, 0x6ca86550u, 0x12c9b6aau, 0x929e84ceu,
    0x77ee5549u, 0x6d2df3fau, 0x9342a803u, 0x6ca434d9u, 0x7579b20bu, 0x4ff3caaau,
    0x027bb076u, 0x8622db12u, 0xd61e0c44u, 0x59add165u, 0x7cfdc2c0u, 0xe45901d7u,
    0xfbe0f784u, 0x5fe6f009u, 0x31185ef7u, 0x5db302bbu, 0x5a09fd2du, 0xcc776610u,
    0x683f4d9cu, 0x2b825750u, 0x2e0e4a4au, 0x56afc58cu, 0xdd40f2dfu, 0x69b8b0e2u,
    0xc76a7f7fu, 0xd980c02au, 0x61c2d6bbu, 0x9714afd1u, 0x78ba9956u, 0x9b541b13u,
    0x3baa7f1fu, 0xb8b685e6u, 0x7e3138eau, 0xe3fa7e81u, 0xa73886e8u, 0x8e84845eu,
    0x2a6fc956u, 0x9527be98u, 0x7b5b0ec8u, 0x0972d0b8u, 0x288d2792u, 0xeefe133bu,
    0xbbf22b9fu, 0xc9f6cbf5u, 0xc28a6998u, 0x3c8d252eu, 0xd56b78fdu, 0xde9df8dfu,
    0xab9bb54eu, 0xde936a7au, 0xd99f95b8u, 0x9d078e29u, 0xa50d14beu, 0x3b78c07du,
    0x825e0145u, 0xf481c9d8u, 0x1032e33cu, 0x99ce0826u, 0xa85a3498u, 0x86162060u,
    0xe99e96dfu, 0xcec4c848u, 0xd8391318u, 0x75cb20eeu, 0x7c67596eu, 0x2839e5edu,
    0x1abfaf76u, 0x7fb7d61fu, 0x2b935b4eu, 0xc2c495fdu, 0xef253f31u, 0x0e971eeau,
    0xedf9d81cu, 0x92b2ffddu, 0xac08f37du, 0xbd9b04e0u, 0x4fef788au, 0x49b24488u,
    0xec855c6eu, 0xdfd06cb3u, 0x8a493e0fu, 0xb93ae14bu, 0xe3cd1677u, 0x44646491u,
    0x9b582e86u, 0xaed784d4u, 0x6e3e6dcfu, 0xfdc2e12cu, 0xac9e9ef4u, 0x76d790dbu,
    0x9bf2787fu, 0xba8dd573u, 0xfecacd7cu, 0xf0884d3du, 0x694c0f9fu, 0x42d05906u,
    0x0d0e4690u, 0xa1c617b7u, 0xb8122b86u, 0x83ca94b9u, 0x63102910u, 0x1f7d4dd4u,
    0x9b47e860u, 0x7271422au, 0x96c03fdcu, 0xb847445eu, 0x7728ce12u, 0xb158055fu,
    0x13b27502u, 0x7237ced0u, 0xaea2ed94u, 0x9a4b2243u, 0x8a6ad6abu, 0x44d7a81eu,
    0x8cac7ac1u, 0x06bda026u, 0xc7610869u, 0x6f38a544u, 0x8c87370bu, 0xadfa4c8cu,
    0xf1d69e99u, 0x335df457u, 0xfd34c272u, 0x3b1d89eau, 0x0586b10cu, 0x01142652u,
    0x0282cdf1u, 0xaa687436u, 0x50ab0cdbu, 0x58d43553u, 0x5c506b7eu, 0x7b6e116cu,
    0xc66e065au, 0xbc28700eu, 0xcece0bc9u, 0x56924f62u, 0x4c25b088u, 0x55c73e13u,
    0xa0b085e5u, 0x3ed57030u, 0x54be10b6u, 0x5eb04bc1u, 0x98d5572eu, 0xf6753ef8u,
    0x24e81751u, 0x96f8917fu, 0x68b8c48cu, 0x99acd5beu, 0x0bef589fu, 0x306332b1u,
    0xc4ab0acbu, 0x9e81d951u, 0x0f8797afu, 0xe635736eu, 0x19e4de9au, 0x456ea1c5u,
    0x277b39e0u, 0x6dea6bc0u, 0x548a7fe4u, 0x31642232u, 0x582330a7u, 0xfa457d03u,
    0x8fed0f8bu, 0xf6df7ef5u, 0xce40baf6u, 0x9c010356u, 0x98279d08u, 0xc047d5b4u,
    0xaaacc15au, 0x89200deeu, 0x23d02bc2u, 0x2082707cu, 0xa3daf3deu, 0x50554347u,
    0x8cc9f2d0u, 0x801a12fdu, 0x90abfed9u, 0xc4499ec5u, 0xb5787e3fu, 0x5a454111u,
    0x573d8ae8u, 0x5112bbffu, 0xe066fef1u, 0x52e937fcu, 0xe531b64bu, 0x8a6d0dc9u,
    0xd10db5a2u, 0xde5a3422u, 0x68a949cdu, 0x59851646u, 0xb8455314u, 0xb2a06117u,
    0xbf28ebebu, 0xc5ad8233u, 0x691f57d3u, 0x9949e705u, 0x34c1ddd5u, 0xa90dd9b5u,
    0x470c4719u, 0x320fa04bu, 0x4888a70fu, 0x1677dcb0u, 0x85f0c20eu, 0xb8868422u,
    0x5bf37de8u, 0x49b4b301u, 0xc479dfb8u, 0xee36a643u, 0x17225907u, 0xa020dda6u,
    0x44aac8c5u, 0x8bc83fb7u, 0x04e4142du, 0x381f575fu, 0x306770ceu, 0x7075f1f6u,
    0xa58f504eu, 0xbf8d7771u, 0x3a53a417u, 0x43eefc9fu, 0xa6fa8012u, 0x7c453e0au,
    0x5c0403c6u, 0x22f95447u, 0x3aedd27au, 0x9974e60fu, 0x56dea3b6u, 0x2cb874d8u,
    0x55f1ed8eu, 0xc8f37e81u, 0xbf1567c3u, 0xe46e11acu, 0x8fa0760du, 0xc10905f9u,
    0x2afc55aau, 0xc2d95be8u, 0x7cb1462fu, 0xbf2ef0c9u, 0x1fcbd0f6u, 0x22eb6ad0u,
    0x241c09d2u, 0xa8e5ada9u, 0xde367566u, 0xee77077eu, 0xa3702a98u, 0xa7a52b81u,
    0xd0de6d5du, 0x1aac922fu, 0x7c7130bbu, 0x8ff017e4u, 0x5a6e7964u, 0x186d1391u,
    0xba9c7e47u, 0x903e1d1du, 0x8ece9791u, 0x543d7be9u, 0xb0bcee6du, 0x83ee3a1bu,
    0xe952bb54u, 0x97c92d0cu, 0x32840aafu, 0x62ab8650u, 0xfe55ca8du, 0x3a9955f1u,
    0x82e700efu, 0xe61498fbu, 0xf63ad4e6u, 0x6e971abeu, 0xf5ca08b2u, 0x73d75d51u,
    0x3d1baa36u, 0xc1925c49u, 0x3768368fu, 0xda68e804u, 0x22ce5fc6u, 0x038e406fu,
    0xa4a6e9c7u, 0x9010fa00u, 0x96eb2671u, 0xe2cb0775u, 0x4ab3749bu, 0x2427fd0fu,
    0x7c4e987au, 0x8a898a05u, 0xcc8ef222u, 0xe47d13f3u, 0x7303c10bu, 0x7de0bfd0u,
    0x7cfa666au, 0x8788cd93u, 0x11f899beu, 0xefc3b747u, 0x5695d794u, 0xe5d5e603u,
    0x50ee88bfu, 0xccc10a55u, 0xd3d3a184u, 0xc707dbb5u, 0x9704bbf7u, 0xafc0eb67u,
    0x5c80c695u, 0x0a3941ceu, 0x9e1031f9u, 0xd2b7f735u, 0xb7711180u, 0xf6df4ba3u,
    0xacb5ab51u, 0xceeca6dfu, 0xe07d6c30u, 0x5af6f1ccu, 0x25a7c37cu, 0x2881eaf5u,
    0x7ce36bd7u, 0x0527ab9fu, 0xf61de3c9u, 0x9b9e9037u, 0xe2d7f7f5u, 0x3d22b2f0u,
    0x29a32a1au, 0x74c058aau, 0x74485e22u, 0x92166c75u, 0x6e9138a6u, 0x3346656fu,
    0xad415077u, 0x0c63c421u, 0xb935b93du, 0x7ddb2506u, 0x1b908b5bu, 0xf253dab6u,
    0x4be2e880u, 0xd8c96934u, 0x09292a4fu, 0x9ae6702au, 0x4b6b55aau, 0xd5c09c18u,
    0xc098e4b4u, 0xbbcdda75u, 0xffc42bb2u, 0x71879d3cu, 0x8fa0f541u, 0xf14874c0u,
    0x4ef92d13u, 0x3e6bad27u, 0xb2dfd2f0u, 0xc1ed191au, 0x4167a719u, 0x8778fbdeu,
    0x24552101u, 0x21acf686u, 0xa1033bbcu, 0x76ca9b7au, 0x8cb05c25u, 0xac925f65u,
    0x9aecfa59u, 0xfad639c0u, 0x70836f89u, 0xf68f7fc8u, 0x716ad9a5u, 0xf7a4f7a6u,
    0x44cae922u, 0x970f8579u, 0x2b08ff27u, 0x8c117538u, 0x6b531d36u, 0xbc40cf58u,
    0xbc667af2u, 0xc4565402u, 0x952b336eu, 0xebfd97dfu, 0xe6062ffdu, 0x61d19c24u,
    0x610110eeu, 0xcebc3ed1u, 0xc6564f8du, 0xb9c8811cu, 0xb1b3be4du, 0x2b36ff46u,
    0x14498839u, 0xde8a8e12u, 0xa828815cu, 0xeb805f00u, 0xff4e86a3u, 0x05530799u,
    0xc80fc548u, 0xc0310179u, 0xf52f2adcu, 0x2b0016bbu, 0x55a48728u, 0x3d9387d1u,
    0x862d1721u, 0xe68115c8u, 0x6987fba9u, 0x5f2048d8u, 0x0d5d3970u, 0xa32be27au,
    0x23fe9e1du, 0xb2c527cbu, 0x5a3f61c9u, 0xa96ed9bcu, 0x215b87c6u, 0xbbb6c3b2u,
    0xd11fea76u, 0x89ba16beu, 0x30a30e6fu, 0x7a47afc5u, 0x7639e0b6u, 0x1b0c363bu,
    0xcca4f452u, 0x1167cbb3u, 0xd2e165e6u, 0xce2c905du, 0xa8a50a2du, 0xb0b8412eu,
    0xa8f6f6cfu, 0x98e17b77u, 0x087f7adbu, 0xdca85abcu, 0x07941f2bu, 0x290b696bu,
    0x0eb11334u, 0xb4e00ab7u, 0xf228b18bu, 0xe039ee9fu, 0xce10ce0fu, 0xdb7a8be4u,
    0x2167e373u, 0x9b7ad6c5u, 0xdc53302eu, 0xe5837eabu, 0x500b2e5fu, 0xbffde245u,
    0x12feede7u, 0x47b9c1e0u, 0x8d3e0fa3u, 0xc583df5bu, 0xc58eb3afu, 0x0f718342u,
    0x376c24c5u, 0x49c460cdu, 0x5843ba35u, 0x29c287b0u, 0x56401fb6u, 0x6d8f49d8u,
    0x32380bc6u, 0x59cd10dau, 0x414be145u, 0x19415aa9u, 0x049e8630u, 0x668a1ab6u,
    0x2c0cbb17u, 0x05cb7d1du, 0xd3e16f6cu, 0xb1da94eau, 0x63fbae79u, 0x6254b971u,
    0x3db85684u, 0x9af7db69u, 0x527d98efu, 0xeccb4578u, 0x7928ef20u, 0x77db11aeu,
    0x919eabfau, 0x43f3d031u, 0x05e270deu, 0xc82a8c2bu, 0x0d41b139u, 0x07253bd1u,
    0x14065b66u, 0x945922d7u, 0x51a4f177u, 0xd72f83b9u, 0x3359988eu, 0x384af9e9u,
    0x1fec5334u, 0x28461564u, 0x0b79a9c2u, 0xfb8a62f3u, 0xba8ad6e7u, 0xa3c88bd4u,
    0x04ee6d07u, 0x46ba1e58u, 0x8076e126u, 0x10ab9540u, 0xd44c7adcu, 0x7c771dbeu,
    0xe60ff8d3u, 0xd3ed356fu, 0xa44c93a4u, 0x4a971ca9u, 0xae7c3d66u, 0xdc2ced79u,
    0x92e0cdccu, 0x64d541c4u, 0x7b87460cu, 0x5709951du, 0xbd91c60cu, 0xff317d78u,
    0x17db03a8u, 0xb7bc423au, 0x4fdfd0f6u, 0xfb286c60u, 0x779efa03u, 0x8eb509d8u,
    0xc251e92du, 0x907a05a0u, 0xaa2bbde3u, 0xda1c4087u, 0x48b63cf3u, 0x8439d4d6u,
    0xe159280du, 0x0cd95b64u, 0x3a70a6f5u, 0x1817d229u, 0x0e684eecu, 0x4aeee379u,
    0xb267853bu, 0x590d5defu, 0xf8dbac66u, 0xc0d1a6ecu, 0x78e2463au, 0x0a9a0ee1u,
    0x5d75d173u, 0xecbbe106u, 0xff3cd5afu, 0x34ae88fbu, 0x18a83f47u, 0xa8e195e7u,
    0xe7dc9c93u, 0x78ad9420u, 0x020b8729u, 0x75f6dccdu, 0x4066d902u, 0x884cbc92u,
    0xa14b6d20u, 0xae057a40u, 0x366e9382u, 0xaf7bb46du, 0x63c20e8fu, 0xefcf4f49u,
    0xfeb85cddu, 0xb77e570fu, 0x0dfc170cu, 0x126eedb2u, 0xc896a431u, 0x78dfab51u,
    0x6248644au, 0xd251fca9u, 0x1fd16ca9u, 0xedb29dd4u, 0x00579a9cu, 0x3fcf74c8u,
    0x9ec1867bu, 0xf5a35adcu, 0xe88513aeu, 0x717a8910u, 0x0cb24113u, 0xf0ed2823u,
    0x434cebb9u, 0xa9a5a800u, 0xbc4c36e9u, 0x05206bc4u, 0x10daf112u, 0x25500f9fu,
    0x21c7109eu, 0xefdd75d5u, 0x08f77b2au, 0x9b3b235cu, 0xa7f4f0cbu, 0xa62f8f86u,
    0x7d4b7eefu, 0x59f4852cu, 0x6399be5bu, 0x46ef0051u, 0x86e0eb94u, 0x3a4f6e10u,
    0x347c2de9u, 0x78bb1298u, 0x57f71204u, 0x064e5155u, 0x037e3ce9u, 0x5056321bu,
    0xab969bfeu, 0x998690d7u, 0xe61469beu, 0xd63b0456u, 0x8cd87b00u, 0xa8b4118bu,
    0x26ab9eb4u, 0x65f81f4au, 0x971674e6u, 0xaf0efc84u, 0xc05bc7feu, 0xaf81d24cu,
    0x6081534au, 0x1b7e73c6u, 0xae66dd06u, 0x2cda851eu, 0xd94f4c27u, 0xf6d137beu,
    0x308937c2u, 0x994f3cf0u, 0x11772db5u, 0x481bee08u, 0xa29f96f5u, 0xcc137cd5u,
    0xe6faeee8u, 0xe41ac9a3u, 0x82a76600u, 0xfe3e8fd4u, 0x4dd76bb2u, 0x6994c2c1u,
    0x4150ea17u, 0x7d6e5892u, 0x9d693189u, 0x090519d2u, 0x5143608au, 0xce52fe28u,
    0x8b9d4fb9u, 0xda17456bu, 0x7b0e9e46u, 0x879819dfu, 0xb6e791d5u, 0xb53b14f7u,
    0x7aa8077bu, 0xf27d586eu, 0xd6a3fe5du, 0x0a154c1cu, 0x8336d6e0u, 0xd69a0daeu,
    0x98de4383u, 0x5777afaau, 0x379ef2cau, 0x385f95d2u, 0x160867ebu, 0x84e3f8c8u,
    0x3831943cu, 0x4d74b9edu, 0xf46961dcu, 0x13cdd0b8u, 0xc1589de4u, 0x5e19e0bdu,
    0xbde46414u, 0x2b7fc988u, 0x4987441du, 0x20256209u, 0x6b3085d6u, 0xaca00c83u,
    0x03223295u, 0x1a735f29u, 0x7c2ab1a8u, 0xaca289d5u, 0x75710042u, 0xce74099fu,
    0x40408b23u, 0xdb8706e6u, 0x41f04bd5u, 0xf4703c20u, 0x59edc3d9u, 0xf1dad8f4u,
    0xbdfe8ac7u, 0x74b16676u, 0x7dbf78eeu, 0x3dcfdf13u, 0xd9367d3fu, 0x24b7ed2cu,
    0xf9b6ac53u, 0x8eeafe04u, 0x184427d3u, 0x07da3b6cu, 0x28b7aa1cu, 0x34c30edfu,
    0x4e005510u, 0x408a1e8au, 0x8832e74bu, 0xb3af8661u, 0xc16fb205u, 0xe0d74dccu,
    0x8541e50bu, 0xe833a391u, 0x904da288u, 0xa539faefu, 0xeb85cfddu, 0x68e46ea2u,
    0x46b2c22fu, 0xb483da6eu, 0x2348dea6u, 0xd3138298u, 0xef17f06cu, 0x37570957u,
    0x710ed5feu, 0x8af5e9ecu, 0xb02674a1u, 0x82401f02u, 0xf6b2bea8u, 0x6310dd9cu,
    0xef3d24fdu, 0x4b99ad8bu, 0x5cfd51c1u, 0xf65e86d6u, 0xec57916cu, 0x6001131au,
    0xf663b797u, 0x2630c54du, 0xc2d62a8eu, 0x675061a2u, 0xa456068du, 0x66fb3d79u,
    0x27535c43u, 0x3022d445u, 0x69d176bdu, 0x1d4c1de4u, 0x6cdb7581u, 0xebc8dfc2u,
    0x0f37e685u, 0x2600ffa6u, 0xd28e7c69u, 0x90e7c3f7u, 0xf10acb62u, 0x08bc681bu,
    0xc07c26bcu, 0x415fb8cdu, 0x1813d51fu, 0x796c32bfu, 0xbc75d95fu, 0xe8f67abdu,
    0x03536418u, 0x25080d95u, 0x9697c7cbu, 0x4a78ee55u, 0x1f565261u, 0x35d73a62u,
    0x3c1b4ed9u, 0x8cf9bfc7u, 0x9099a5b5u, 0xbcfda51cu, 0xd0b5e550u, 0x05284303u,
    0x14b55accu, 0xa957c550u, 0x9b8aa86fu, 0x6cc46486u, 0x0eb3025fu, 0xe8639712u,
    0x9784abbfu, 0xb4557a71u, 0x54ca9ed9u, 0x02331c01u, 0x1b5916e4u, 0x84972e35u,
    0x734065aeu, 0xcb8c45a6u, 0x33495f7du, 0x66968ee6u, 0x64d50646u, 0xd597ad7eu,
    0xfb366081u, 0x5de6ad06u, 0x2d354577u, 0x1a2bbe21u, 0xdf4f34dbu, 0x2c488c34u,
    0x3b586d7du, 0x3a5275eau, 0xf8137ef8u, 0x5eb96496u, 0x3c909e9fu, 0xedbe69a1u,
    0xf297a1edu, 0xa2f06e3eu, 0xcfecb313u, 0xebd59d26u, 0xf6a0e8adu, 0x75536ebfu,
    0xd4cd812du, 0xe2220529u, 0x8ac62af7u, 0xc8207880u, 0x5d168a9au, 0xd46d3063u,
    0x32c28f11u, 0xe8e861ddu, 0x3ee590b9u, 0xea2110f8u, 0x9ff868f7u, 0xe0adf4c9u,
    0x0dd7ccf9u, 0x9e7b1c10u, 0x8f0a1fe5u, 0x0ec49b7bu, 0xaa993dccu, 0xf977f383u,
    0xb591fcf2u, 0xe588c5e2u, 0xd6ce3ffeu, 0x5f60970fu, 0xb0752e29u, 0xc7a855b6u,
    0x37efe900u, 0xc726c863u, 0x9bab6945u, 0x933b96b2u, 0x586d6d7eu, 0xe31b4008u,
    0x21e0c5f5u, 0xd4bc93cau, 0x3a0337deu, 0x950979ddu, 0x3f0c1d07u, 0x5125538cu,
    0xc06f432du, 0xf373c3acu, 0x3fd60b13u, 0xac855af6u, 0x42628e7eu, 0xe78cd046u,
    0x010fe430u, 0x4672c7f2u, 0x7b92e3f1u, 0x46bf959eu, 0x4680b858u, 0xe7d5271eu,
    0xdf95118bu, 0x1977c75du, 0x7666bfadu, 0xe10b0816u, 0x72dace5bu, 0xb5a50ab7u,
    0x04ce136cu, 0x60baac8bu, 0xd66efa3du, 0x5e3750cdu, 0x99204812u, 0x09e3942fu,
    0xa8512dd6u, 0xe31e7f5bu, 0x9cebec39u, 0xc5cff747u, 0x0e90ac3fu, 0x61c30b85u,
    0x547c1f47u, 0x0fb42498u, 0x0c7d8892u, 0xafc81338u, 0xc0ff3d9fu, 0xc57313b6u,
    0x02afc347u, 0x013ee85bu, 0xfea1bb92u, 0xda19573fu, 0x25a2e78cu, 0xe6aef08fu,
    0x99d68a02u, 0x9d22ddc0u, 0x61afb2f0u, 0xebfcce28u, 0xd2195b1cu, 0xdfab5d96u,
    0xb2e4d458u, 0x0d65762au, 0xa155263bu, 0xae3443b8u, 0xe7a4a335u, 0xb5a65826u,
    0x1f3d8cedu, 0x67a80e60u, 0xffc66299u, 0x15e8653cu, 0x0ed891aeu, 0x8f161429u,
    0xfac3ed8fu, 0x584ea70du, 0x6bcdbb5eu, 0x70c55d08u, 0x3f2a5e75u, 0x196b1eaeu,
    0x4f0ff524u, 0x36fcab50u, 0x9fdba61cu, 0x46951631u, 0x66de63d5u, 0xe718f10au,
    0xf1e1d5bcu, 0x0e36a726u, 0xc1fb2a0au, 0xa97de204u, 0x1db75484u, 0xeaa500acu,
    0x32d52cb2u, 0xfbcf5e80u, 0xc4b98da4u, 0x835305c9u, 0x7fd4afa5u, 0x84dc435eu,
    0x1e9d0d7au, 0xd271158eu, 0xc26ddd5du, 0x9a9b1eccu, 0x5fe36eaeu, 0x69c2af09u,
    0xc0ef5d16u, 0xe1ff9265u, 0xd6a79573u, 0xd27285dbu, 0x3aec8d0fu, 0x594e3f16u,
    0x832b806du, 0x71892b1bu, 0xfe69538du, 0x71a0c3d3u, 0x14abacc9u, 0x35202632u,
    0x4965835eu, 0x3babc3e6u, 0xd06db732u, 0x4f47bf52u, 0x97a448c2u, 0xaa0f491du,
    0x87ab42bbu, 0xd3cb2137u, 0x0c7f24edu, 0x317b969au, 0x4859305du, 0xe4172b16u,
    0x53d7d3f5u, 0x4abfc80fu, 0x660f6be2u, 0x629069c6u, 0x83ccb72bu, 0xb244fe2du,
    0x1770cc1bu, 0x654f84e7u, 0x6aca8aa3u, 0x39727858u, 0xfabf15c7u, 0xee2a2d56u,
    0xb3ba0a4au, 0xc6dde0b7u, 0x6758875du, 0x631bb273u, 0x1fe5b948u, 0xa521e776u,
    0xd87d4885u, 0x24d84074u, 0xadd1b2f0u, 0x26b972a1u, 0x39d22060u, 0xb469724fu,
    0x1d35dbcbu, 0x67c6afb4u, 0x1230a27du, 0x8e9906a7u, 0xd47fa000u, 0x1c15527bu,
    0xe4776250u, 0x74c360a4u, 0x993083f9u, 0xc6ddcb06u, 0x8203be83u, 0xe744dcb2u,
    0x41019701u, 0xf882f186u, 0x1a4fce47u, 0x67db2c4au, 0xdf33d39du, 0xc1550ce8u,
    0x7df9f615u, 0x9030a49cu, 0xea132ac3u, 0x12b02f20u, 0x35490db3u, 0x88e56f72u,
    0x0246e2e6u, 0x56993a31u, 0x2b830011u, 0x18e4a304u, 0xe0553f1eu, 0x1fe0b5c3u,
    0xe55ef1f3u, 0xb8fdb1e7u, 0xc9e90b9eu, 0x19b29a35u, 0x36c41f1cu, 0xb82be955u,
    0xb2dea967u, 0x510ac59au, 0x18b8ea18u, 0x80000000u
};
__constant__ uint32_t kCtaPow[kMaxCtas] = {
    0x80000000u, 0xbf455269u, 0xe2ea32dcu, 0x9a4f01b6u, 0xfe7740e6u, 0x99569602u,
    0x78b57ca2u, 0x999dcda1u, 0xf946610bu, 0xc274d1e2u, 0xf5942afbu, 0x24c42589u,
    0xa0a51f5fu, 0x506431b0u, 0x8fd57416u, 0x4ea3e89bu, 0x3c204f8fu, 0x3c59560du,
    0x604b0eebu, 0x41e050b4u, 0x40f28a69u, 0x52425d8cu, 0xbcd7b6feu, 0x678a2be5u,
    0x35af26b2u, 0xb5882aadu, 0x92be2b7du, 0xd9a18a27u, 0xda70c2a6u, 0x5a46c173u,
    0x2c32338cu, 0x9eb72f75u, 0x538586e3u, 0x9e73ea03u, 0x135b0224u, 0x9f0868cdu,
    0x78edc103u, 0xaa041004u, 0xcab85929u, 0x3c9eab07u, 0xf0f3875eu, 0xc095bdd3u,
    0x4e215dc3u, 0x361958b0u, 0xefb7cf1du, 0x94cf0483u, 0xd9115470u, 0xd3064c7cu,
    0x683988b2u, 0x4f7d733eu, 0xefb856bdu, 0xefc27d2fu, 0xe5dbb221u, 0x44f3038cu,
    0xe0f4e012u, 0x7d72426du, 0x0fc062f5u, 0xe0d87bc0u, 0x78df72dbu, 0xf25e9094u,
    0xd7b17b91u, 0x9d620a0du, 0xc850989eu, 0x838b78eeu, 0x59726915u, 0x03ea517cu,
    0x85cebe45u, 0xacd3d0c8u, 0x706acb7cu, 0xcc409f5fu, 0x838c5e0au, 0x5e6da29cu,
    0xe6ad6d8du, 0xd38a7300u, 0xbe96645cu, 0x0934b3dau, 0x681e6ac5u, 0xca55e1cdu,
    0xdd1bbc5cu, 0xd02d2040u, 0x30c6966du, 0x79ec2449u, 0x8636264au, 0xf69f2491u,
    0x6163130eu, 0x5e0735cbu, 0xcc741dd9u, 0x4a02ab69u, 0x41757919u, 0xe076a1d4u,
    0x3faf748cu, 0xd64dea23u, 0x8af588f5u, 0x5891c881u, 0x1500dd65u, 0xeb8bfc16u,
    0x5be8b36eu, 0xa58daf40u, 0xd55bad88u, 0x6b50a246u, 0x4d48b1adu, 0xf52fe9cdu,
    0xb40f8cedu, 0xb006e8c5u, 0x5b146f36u, 0x5fd162edu, 0x94d3f3abu, 0xbef687a1u,
    0x39b976a2u, 0x7f163bb1u, 0x74fc5c8au, 0xfca6eea8u, 0x42c5623cu, 0x1aab5d11u,
    0xc8ae819eu, 0x0d740dcbu, 0xc24490f6u, 0x280b13a8u, 0xdaa858e2u, 0x89ebb49cu,
    0xd3c82384u, 0x309561e4u, 0xde97ef7cu, 0x8c78044fu, 0x8f07086au, 0x68301eb8u,
    0x1165d055u, 0xe47b7d20u, 0x734d5309u, 0xd95c718eu, 0xf5362c27u, 0x6729a357u,
    0xf96ca5b5u, 0x0d4c7cbdu, 0xf3132233u, 0x6a18e9fcu, 0xda26dee9u, 0x77474b45u,
    0x9ff9b5e8u, 0xa6fcb204u, 0xfc340e13u, 0x6c48063du, 0xf65e7057u, 0xa6c3c062u,
    0x1084fed0u, 0x016d84cdu, 0x5304d538u, 0x51c27da4u, 0x74e9c396u, 0x04ca723cu,
    0xd22f9eb5u, 0x69dce8eeu, 0xe61256a5u, 0x0de811eeu, 0xffde8dc7u, 0x3d33980du,
    0xe4507c9cu, 0xba75e6c5u, 0xc99dab79u, 0xdd925252u, 0x68a5f0f9u, 0x6348972bu,
    0xd35302c7u, 0xc67ca34eu, 0xadce2390u, 0xc180fb30u, 0x24553fa8u, 0x3072beefu,
    0x00a915f9u, 0xb275cb6du, 0x6064fef1u, 0xd9adf0dcu, 0x2a5d4726u, 0xbd7ad61cu,
    0x5de7457fu, 0x197328e6u, 0x1573fe60u, 0xe3eca25fu, 0x7543b3a0u, 0x294911fdu,
    0x30dc67b9u, 0x295c4288u, 0x9d1f8a28u, 0xfb7f498du, 0x8ca2bc36u, 0x18f4e7c5u,
    0x4f48999fu, 0x7261d91au, 0x53081e9fu, 0x1481bee3u, 0x8b65218fu, 0xcb257506u,
    0xdb1b3315u, 0x0bfbe7b5u, 0x5f50f2acu, 0x8eb21b07u, 0xd087d654u, 0x765ab986u,
    0x7d940e76u, 0xb51c8f9cu, 0x6767b49du, 0x10b5fe99u, 0x0eb75db6u, 0x6dfea6dfu,
    0xe44e6e8eu, 0x902e1d64u, 0x5b70ace5u, 0x928b4970u, 0xe0a82539u, 0xc33bc1d3u,
    0x7d0afb0cu, 0x429b774du, 0x592d0c1cu, 0xa413a7f0u, 0xc195eb03u, 0xa916176cu,
    0xe67026beu, 0xb8d555b2u, 0x43a41bb5u, 0x29ea9ba5u, 0x402d90e8u, 0xbc478bd4u,
    0x7ab83fbbu, 0xa8a1d539u, 0xe5c304f7u, 0x8649909du, 0x900b2e3au, 0xe6e89c82u,
    0xb2ba1822u, 0xb2af5f15u, 0xd24f063au, 0x1513289du, 0xfff9fc5du, 0xa12eaed0u,
    0xb23c0392u, 0x310595c3u, 0x3cbb5d24u, 0x94e92ec1u, 0x57d0a032u, 0x334135bfu,
    0xce8068d1u, 0x0dfe93b6u, 0x0236c2c4u, 0x9cde332fu, 0xa7dccf86u, 0x91123751u,
    0xd2c9af45u, 0xf2dc0818u, 0x069895dbu, 0x5988265fu, 0x7e5e7200u, 0x2cad318eu,
    0x871b7360u, 0xe7a42a40u, 0x78239bbcu, 0x968a8a08u
};

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

uint32_t host_x8nmodp(uint64_t n) {
  uint32_t p = 1u << 31;
  for (int k = 3; n; n >>= 1, ++k) {
    if (n & 1) p = multmodp(kX2nHost[k], p);
  }
  return p;
}

// The raw CRC register of one byte x (one table entry).
__device__ __forceinline__ uint32_t byte_crc(uint32_t c) {
#pragma unroll
  for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
  return c;
}

// Entry e of table k for the lane whose copies start at S (entry (k, e) at
// S[(k·256 + e)·32]); the measurement build -DCRC32C_SHARED_TABLES reads, for
// every lane, the copy in the bank a plain table puts entry e in.
__device__ __forceinline__ uint32_t sget(const uint32_t* __restrict__ S, uint32_t k, uint32_t e) {
#ifdef CRC32C_SHARED_TABLES
  return S[(k * 256 + e) * 32 + (e & 31u)];
#else
  return S[(k * 256 + e) * 32];
#endif
}

// Entry e of the step operator's byte table j (a copy a half-warp lane).
__device__ __forceinline__ uint32_t hget(const uint32_t* __restrict__ H, uint32_t j, uint32_t e) {
#ifdef CRC32C_SHARED_TABLES
  return H[(j * 256 + e) * 16 + (e & 15u)];
#else
  return H[(j * 256 + e) * 16];
#endif
}

// Four little-endian bytes x (XORed into a register already) through the
// slicing-by-4 tables.
__device__ __forceinline__ uint32_t s4(const uint32_t* __restrict__ S, uint32_t x) {
  return sget(S, 3, x & 255u) ^ sget(S, 2, (x >> 8) & 255u) ^ sget(S, 1, (x >> 16) & 255u) ^
         sget(S, 0, x >> 24);
}

// The raw CRC of one 16-byte unit from a zero register.
__device__ __forceinline__ uint32_t d16(const uint32_t* __restrict__ S, uint4 v) {
  uint32_t c = s4(S, v.x);
  c = s4(S, c ^ v.y);
  c = s4(S, c ^ v.z);
  return s4(S, c ^ v.w);
}

// The register carried over one step (W·512 bytes).
__device__ __forceinline__ uint32_t step(const uint32_t* __restrict__ H, uint32_t c) {
  return hget(H, 0, c & 255u) ^ hget(H, 1, (c >> 8) & 255u) ^ hget(H, 2, (c >> 16) & 255u) ^
         hget(H, 3, c >> 24);
}

struct Args {
  const uint8_t* data;  // the stream
  int64_t head;         // bytes before the body (< 16)
  int64_t units;        // 16-byte units of the body
  int64_t pad_units;    // zero units in front of the body (virtual, < one step's)
  int64_t steps;        // tiles a warp
  int64_t tail;         // bytes after the body (< 16)
  uint32_t op_step;     // x^(8·W·kTile): a lane's step from one uint4 to its next
  uint32_t op_head;     // x^(8·(body + tail)): the head's raw CRC to the end
  uint32_t op_body;     // x^(8·tail): the body's raw CRC to the end
  uint32_t fold;        // shift(value ^ ~0, n) ^ ~0: the previous value and final XOR
};

// The raw CRC of the k < 16 bytes p[0, k), byte by byte (table 0 of the
// lane's copy); the loads do not wait for the register.
__device__ __forceinline__ uint32_t bytes_crc(const uint32_t* __restrict__ S,
                                              const uint8_t* __restrict__ p, int64_t k) {
  uint32_t c = 0;
#pragma unroll
  for (int i = 0; i < 15; ++i) {
    if (i < k) c = sget(S, 0, (c ^ p[i]) & 255u) ^ (c >> 8);
  }
  return c;
}

__global__ void __launch_bounds__(kThreads, 1) crc32c_kernel(Args a, Scratch* __restrict__ scratch,
                                                             int64_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t warp_x[kWarps];
  uint32_t* S = smem;
  uint32_t* Hs = smem + kSWords;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t W = (int64_t)gridDim.x * kWarps;
  const int64_t stride = W * 32;  // uint4s from a lane's uint4 to its next
  // this lane's uint4 of its first step (only the first step reaches into the
  // front padding)
  const int64_t first = ((int64_t)blockIdx.x * kWarps + warp) * 32 + lane - a.pad_units;
  const uint4* __restrict__ body = reinterpret_cast<const uint4*>(a.data + a.head);

  uint4 v[kUnroll];  // the first kUnroll steps, in flight while the tables are built
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    v[u] = (u < a.steps && (u > 0 || first >= 0)) ? __ldcs(body + first + u * stride)
                                                  : make_uint4(0u, 0u, 0u, 0u);
  }
  // the thread's carry to the end of the stream, taken now: it does not
  // depend on the data
  const uint32_t to_end =
      multmodp(multmodp(__ldg(kThreadPow + t), kCtaPow[gridDim.x - 1 - blockIdx.x]), a.op_body);
  {
    // thread t builds entry e = t % 256 of table k = t / 256; at store r lane
    // l writes copy (r + l) % 32 (the step tables: (r + l / 2) % 16), so a
    // warp's stores fall on distinct banks
    const int k = t >> 8, e = t & 255;
    uint32_t c = byte_crc((uint32_t)e);
    for (int i = 0; i < k; ++i) c = (c >> 8) ^ byte_crc(c & 255u);
    uint32_t* sd = S + (k * 256 + e) * 32;
#pragma unroll 8
    for (int r = 0; r < 32; ++r) sd[(r + lane) & 31] = c;
    const uint32_t h = multmodp(a.op_step, (uint32_t)e << (8 * k));
    uint32_t* hd = Hs + (k * 256 + e) * 16;
#pragma unroll 8
    for (int r = 0; r < 16; ++r) hd[(r + (lane >> 1)) & 15] = h;
  }
  __syncthreads();

#ifdef CRC32C_SHARED_TABLES  // measurement only: the copies sget/hget pick
  const uint32_t* __restrict__ Sl = S;
  const uint32_t* __restrict__ Hl = Hs;
#else
  const uint32_t* __restrict__ Sl = S + lane;
  const uint32_t* __restrict__ Hl = Hs + (lane & 15);
#endif
  // CTA 0's first two threads add the head's and the tail's terms (and the
  // previous value's fold), so the last CTA only reads the sum
  uint32_t x = 0;
  if (blockIdx.x == 0 && t == 0) x = multmodp(a.op_head, bytes_crc(Sl, a.data, a.head)) ^ a.fold;
  if (blockIdx.x == 0 && t == 1) x = bytes_crc(Sl, a.data + a.head + a.units * 16, a.tail);

  uint32_t acc = 0;
  const uint4* __restrict__ p = body + first + kUnroll * stride;
  for (int64_t k0 = 0; k0 < a.steps; k0 += kUnroll) {
    if (k0 > 0) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k0 + u < a.steps) v[u] = __ldcs(p + u * stride);
      }
      p += kUnroll * stride;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#ifdef CRC32C_NO_STEP  // measurement only: no carry, a wrong value
      if (k0 + u < a.steps) acc ^= d16(Sl, v[u]);
#else
      if (k0 + u < a.steps) acc = step(Hl, acc) ^ d16(Sl, v[u]);
#endif
    }
  }
  // every thread's register carried to the end of the stream, XORed together
  x ^= multmodp(to_end, acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, o);
  if (lane == 0) warp_x[warp] = x;
  __syncthreads();
  if (warp != 0) return;
  x = warp_x[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, o);
  if (lane == 0) {
    if (x) atomicXor(&scratch->x, x);
    __threadfence();  // the contribution lands before the ticket is taken
    if (atomicAdd(&scratch->ticket, 1u) == gridDim.x - 1) {  // the last CTA
      *out = (int64_t)atomicExch(&scratch->x, 0u);
      scratch->ticket = 0;
    }
  }
}

// The CTAs of crc32c_kernel that are co-resident on the card (one an SM),
// asked once, after allowing the kernel its dynamic shared memory.
int wave_of(int* wave) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, per_sm = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(crc32c_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kSmemBytes);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crc32c_kernel, kThreads,
                                                          kSmemBytes);
    }
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm * sms <= 0) return (int)cudaErrorInvalidConfiguration;
    cached = per_sm * sms < kMaxCtas ? per_sm * sms : kMaxCtas;
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
  a.op_step = host_x8nmodp((uint64_t)(W * kTile));
  a.op_head = host_x8nmodp((uint64_t)(n - a.head));
  a.op_body = host_x8nmodp((uint64_t)a.tail);
  a.fold = multmodp(host_x8nmodp((uint64_t)n), value ^ 0xffffffffu) ^ 0xffffffffu;
  crc32c_kernel<<<(int)blocks, kThreads, kSmemBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
      a, reinterpret_cast<Scratch*>(scratch), out);
  return (int)cudaGetLastError();
}
