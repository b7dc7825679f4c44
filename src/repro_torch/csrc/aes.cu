// AES block encryption with per-chunk round keys (AES-128 and AES-256).
//
// Replaces: kernels/aes/bitslice_pallas.py::encrypt_planes_pallas (the
// bit-plane Pallas kernel of the JAX package; host adapter aes/ops.py::
// encrypt_many_bitsliced with per_chunk_rks=True). The bit planes exist
// only because the TPU's vector unit has no byte gather; here every
// 16-byte block is a plain T-table encryption, one thread per block.
//
// What bounds it: shared-memory wavefronts, then INT32 issue. A
// 14-round block makes 224 table reads (16 a middle round, 16 for the
// final one) at indices that are random state bytes. With the usual four
// 1 KiB T-tables the busiest bank of a warp's read serves ~3.3 distinct
// words, so each LDS cost ~3.3 wavefronts: that kernel ran at the
// shared-memory port, 0.707 ms at the publish tile (NVIDIA H100 80GB
// HBM3, 700.00 W). The design:
//   - Bank-interleaved tables. The word of T(x) for lane l sits in bank
//     l (row x holds one word per lane), so every LDS of a warp is one
//     wavefront. Four rotated copies T0..T3 (128 KiB) in rows of 256
//     bytes, T0|T1 then T2|T3 a 64 KiB step later, from a 64 KiB-aligned
//     shared address: a lookup's address is then one PRMT (the table's
//     high bytes and this lane's offset around the state byte) and the
//     copy's 64 KiB step an LDS immediate. One copy of T0 (32 KiB, T1..T3
//     by rotation, the address an IMAD) ran 17-21% slower (NVIDIA H100
//     80GB HBM3, 700.00 W).
//   - The final round takes S[x] from T0[x]'s middle bytes (2s|s|s|3s),
//     so there is no separate byte table.
//   - Round keys in shared memory. Each warp walks tiles of kTile
//     consecutive blocks; when every block of a tile names one of kSlots
//     schedules from the tile's first chunk index on (always for the
//     run-length protocol's ascending runs of kTile / 3 blocks or more),
//     the first block of each run copies its schedule into the warp's
//     slot and every round key is one broadcast LDS.128 (__syncwarp
//     only: no barrier across the block). Any other tile (one schedule
//     per block, scattered indices) reads its keys through the read-only
//     cache.
//   - One block of 1024 threads per SM (the tables fill its shared
//     memory), persistent over the card's SMs, loading each warp's next
//     tile before it computes this one.
// A middle round is then 16 PRMT, 8 LOP3, 16 LDS and 1 LDS.128 a warp
// (47 instructions with the loop's; scripts/aes_sass_probe.py counts
// them). At the publish tile (8,388,608 blocks) a block's 224 table
// reads, one wavefront a warp's LDS, take 0.225 ms at one wavefront a
// cycle per SM, above the INT32 work's 0.175 ms (348 operations a
// block): chip_smoke.py prints that shared-memory bound. The kernel
// took 0.328-0.330 ms (NVIDIA H100 80GB HBM3, 700.00 W), 68% of it.
#include "crypto_common.cuh"

namespace {

using rc::bswap;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 2;                     // blocks per lane per tile
constexpr int kTile = 32 * kPer;            // one warp's tile
constexpr int kSlots = 4;                   // round-key schedules per warp
constexpr int kMaxKeys = 15;                // AES-256: 14 rounds + 1
constexpr int kKeyBytes = kWarps * kSlots * kMaxKeys * 16;
// Four copies in rows of 256 bytes (32 lanes of two copies), T0 and T1
// side by side in the first 64 KiB, T2 and T3 in the next, starting on a
// 64 KiB boundary of the shared window (so a lookup's address is one
// byte permute; kTablePad is the room to align)
constexpr int kTableBytes = 4 * 256 * 32 * 4;
constexpr int kTablePad = 65536;
constexpr int kSmemBytes = kTablePad + kTableBytes + kKeyBytes;

// Shared-memory loads at a 32-bit shared address (LDS, LDS.128).
template <int kOffset = 0>
__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1+%2];" : "=r"(v) : "r"(addr),
               "n"(kOffset));
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

// This lane's view of the tables: `a` and `b` are the 64 KiB-aligned
// table address with this lane's byte offset (4 * lane, and + 128 for
// the odd copies) in byte 0.
struct Tab {
  uint32_t a, b;
};

// T_J[byte K of w] (T_J = T0 rotated right by 8J).
template <int J, int K>
__device__ __forceinline__ uint32_t lookup(Tab t, uint32_t w) {
  // address = table | byte K of w in bits 8..15 | lane offset: one PRMT
  const uint32_t addr = __byte_perm(w, J & 1 ? t.b : t.a, 0x7604 | K << 4);
  return lds<(J >> 1) * 65536>(addr);
}

// One MixColumns output column: T0[a.b3] ^ T1[b.b2] ^ T2[c.b1] ^ T3[d.b0].
__device__ __forceinline__ uint32_t column(Tab t, uint32_t a, uint32_t b,
                                           uint32_t c, uint32_t d,
                                           uint32_t k) {
  return lookup<0, 3>(t, a) ^ lookup<1, 2>(t, b) ^ lookup<2, 1>(t, c) ^
         lookup<3, 0>(t, d) ^ k;
}

// The final round's column as the little-endian word it is stored as:
// byte 0 = S[a.b3], 1 = S[b.b2], 2 = S[c.b1], 3 = S[d.b0]; S[x] is byte 1
// of T0[x]. `k` is the big-endian round-key word.
__device__ __forceinline__ uint32_t last_column(Tab t, uint32_t a,
                                                uint32_t b, uint32_t c,
                                                uint32_t d, uint32_t k) {
  const uint32_t lo = __byte_perm(lookup<0, 3>(t, a), lookup<0, 2>(t, b),
                                  0x0051);
  const uint32_t hi = __byte_perm(lookup<0, 1>(t, c), lookup<0, 0>(t, d),
                                  0x5100);
  return __byte_perm(lo, hi, 0x7610) ^ bswap(k);
}

// Round key r of a schedule: at shared address `smem_rk`, or at `rk` in
// device memory.
template <bool kSharedKeys>
__device__ __forceinline__ uint4 round_key(uint32_t smem_rk, const uint4* rk,
                                           int r) {
  if constexpr (kSharedKeys) return lds128(smem_rk + 16 * r);
  else return __ldg(rk + r);
}

// One 16-byte block `v` (as loaded: little-endian words) under the
// rounds + 1 big-endian round keys (round_key).
template <bool kSharedKeys>
__device__ __forceinline__ uint4 encrypt(Tab tab, uint32_t smem_rk,
                                         const uint4* rk, int rounds,
                                         uint4 v) {
  uint4 k = round_key<kSharedKeys>(smem_rk, rk, 0);
  uint32_t s0 = bswap(v.x) ^ k.x, s1 = bswap(v.y) ^ k.y;
  uint32_t s2 = bswap(v.z) ^ k.z, s3 = bswap(v.w) ^ k.w;
#pragma unroll 1
  for (int r = 1; r < rounds; ++r) {
    k = round_key<kSharedKeys>(smem_rk, rk, r);
    const uint32_t n0 = column(tab, s0, s1, s2, s3, k.x);
    const uint32_t n1 = column(tab, s1, s2, s3, s0, k.y);
    const uint32_t n2 = column(tab, s2, s3, s0, s1, k.z);
    const uint32_t n3 = column(tab, s3, s0, s1, s2, k.w);
    s0 = n0; s1 = n1; s2 = n2; s3 = n3;
  }
  k = round_key<kSharedKeys>(smem_rk, rk, rounds);
  return make_uint4(last_column(tab, s0, s1, s2, s3, k.x),
                    last_column(tab, s1, s2, s3, s0, k.y),
                    last_column(tab, s2, s3, s0, s1, k.z),
                    last_column(tab, s3, s0, s1, s2, k.w));
}

__global__ void __launch_bounds__(kThreads)
aes_encrypt_kernel(const uint4* __restrict__ blocks,
                   const int32_t* __restrict__ chunk_idx,
                   const uint4* __restrict__ rks, int rounds, int64_t n,
                   uint4* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t table = (base + 65535u) & ~65535u;
  uint8_t* tables = smem + (table - base);
  uint4* keys = reinterpret_cast<uint4*>(tables + kTableBytes);
  // word w: copy J = w >> 13, byte value x = (w >> 5) & 255, lane w & 31;
  // a warp's 32 words share one byte value, so kSbox reads broadcast
  for (int w = threadIdx.x; w < kTableBytes / 4; w += kThreads) {
    const int J = w >> 13, x = (w >> 5) & 255, l = w & 31;
    const uint32_t s = rc::kSbox[x], s2 = rc::xtime(s);
    const uint32_t t0 = (s2 << 24) | (s << 16) | (s << 8) | (s2 ^ s);
    const int at = (J >> 1) * 65536 + x * 256 + (J & 1) * 128 + 4 * l;
    *reinterpret_cast<uint32_t*>(tables + at) =
        __funnelshift_r(t0, t0, 8 * J);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Tab tab{table | 4 * lane, table | (128 + 4 * lane)};
  uint4* wkeys = keys + warp * kSlots * kMaxKeys;      // this warp's slots
  const uint32_t smem_keys =
      static_cast<uint32_t>(__cvta_generic_to_shared(wkeys));
  const int nk = rounds + 1;
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t step = (int64_t)gridDim.x * kWarps;
  // this lane's blocks and chunk indices of a tile, loaded one tile
  // ahead so the loads overlap the last tile's rounds
  struct Mine {
    int ci[kPer];
    uint4 v[kPer];
  };
  auto load = [&](int64_t tile) {
    Mine m;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t i = tile * kTile + j * 32 + lane;
      if (tile < tiles && i < n) {
        m.ci[j] = __ldg(chunk_idx + i);
        m.v[j] = __ldcs(blocks + i);
      }
    }
    return m;
  };
  const int64_t first = (int64_t)blockIdx.x * kWarps + warp;
  Mine cur = load(first);
  for (int64_t tile = first; tile < tiles; tile += step) {
    const int64_t i0 = tile * kTile;
    const int base = __ldg(chunk_idx + i0);
    bool in_range = true;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (i0 + j * 32 + lane < n)
        in_range &= (unsigned)(cur.ci[j] - base) < (unsigned)kSlots;
    }
    const bool shared_keys = __all_sync(0xffffffffu, in_range);
    if (shared_keys) {
      __syncwarp();             // every lane is done with the last keys
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int64_t i = i0 + j * 32 + lane;
        const int c = cur.ci[j];
        if (i < n && (i == i0 || __ldg(chunk_idx + i - 1) != c)) {
          const uint4* src = rks + (int64_t)c * nk;
          uint4* dst = wkeys + (c - base) * kMaxKeys;
          for (int r = 0; r < nk; ++r) dst[r] = __ldg(src + r);
        }
      }
      __syncwarp();
    }
    const Mine next = load(tile + step);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t i = i0 + j * 32 + lane;
      if (i >= n) continue;
      const int c = cur.ci[j];
      __stcs(out + i,
             shared_keys
                 ? encrypt<true>(tab, smem_keys + (c - base) * kMaxKeys * 16,
                                 nullptr, rounds, cur.v[j])
                 : encrypt<false>(tab, 0u, rks + (int64_t)c * nk, rounds,
                                  cur.v[j]));
    }
    cur = next;
  }
}

struct Geometry {
  int sms, per_sm, grid;
};

Geometry geometry(long long n) {
  Geometry g{132, 1, 1};
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&g.sms, cudaDevAttrMultiProcessorCount, dev);
  // the attribute belongs to the current device, so it is set each time
  cudaFuncSetAttribute(aes_encrypt_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g.per_sm, aes_encrypt_kernel,
                                                kThreads, kSmemBytes);
  const long long blocks = (n + kTile * kWarps - 1) / (kTile * kWarps);
  const long long most = (long long)g.sms * (g.per_sm > 0 ? g.per_sm : 1);
  g.grid = (int)(blocks < most ? (blocks > 0 ? blocks : 1) : most);
  return g;
}

}  // namespace

extern "C" int aes_encrypt_launch(const void* blocks, const void* chunk_idx,
                                  const void* rks, int rounds, long long n,
                                  void* out, void* stream) {
  if (rounds != 10 && rounds != 14) return (int)cudaErrorInvalidValue;
  if (n < 1) return 0;
  const Geometry g = geometry(n);
  if (g.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  aes_encrypt_kernel<<<g.grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const uint4*)blocks, (const int32_t*)chunk_idx, (const uint4*)rks,
      rounds, (int64_t)n, (uint4*)out);
  return (int)cudaGetLastError();
}

// Launch geometry for n blocks: out = {threads per block, blocks per
// lane per tile, key slots per warp, dynamic shared bytes, blocks per SM,
// SMs, grid}.
extern "C" int aes_geometry(int n, long long* out) {
  const Geometry g = geometry(n);
  out[0] = kThreads;
  out[1] = kPer;
  out[2] = kSlots;
  out[3] = kSmemBytes;
  out[4] = g.per_sm;
  out[5] = g.sms;
  out[6] = g.grid;
  return 0;
}
