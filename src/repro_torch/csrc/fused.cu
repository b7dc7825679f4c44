// Fused verify+decrypt: SHA-256 of each ciphertext AND its AES-CTR
// plaintext (zero IV, per-chunk key) in one launch.
//
// Replaces: kernels/fused/fusedp.py::fused_lanes_pallas (body
// _fused_body, with _ctr_planes and _planes_to_words; host adapter
// fused/ops.py::fused_verify_decrypt). The TPU kernel carries SHA
// schedule words and AES bit planes in one lane layout; here the
// ciphertexts arrive as one concatenated byte buffer with per-chunk
// offsets and lengths, and the launch splits its blocks by job:
//   hash blocks (the first ceil(N / G)): the SHA-256 engine of
//     sha256_engine.cuh on a group of G chunks, one consumer lane per
//     chunk;
//   CTR blocks (the rest, enough to fill the card): make the keystream
//     and XOR it into the plaintext buffer, 64 KiB segments of the
//     chunks dealt round robin, T-tables and the segment's round keys in
//     shared memory.
// The CTR blocks read the ciphertext from device memory, not from the
// hash blocks' staged ring: they run on other SMs, so their work never
// takes an issue slot from a chain, and the second read of the tile's
// bytes (134 MB at 3.35 TB/s, 0.04 ms) is small against the 3.7 ms
// chain.
//
// What bounds it: the longest chunk's SHA chain (sha256_engine.cuh),
// 3.707 ms for a 512 KiB chunk, as for sha256.cu. The keystream,
// ~600 instructions per 16-byte block, is spread over the SMs the hash
// blocks leave free (100 of 132 at the 256-chunk tile), and finishes
// under the chain. Every block asks for at least
// kOneBlockPerSm bytes of shared memory, so no SM holds two blocks and
// no CTR warp shares a sub-partition with a consumer.
#include "sha256_engine.cuh"

namespace {

using namespace rc;

constexpr int kThreads = sha::kThreads;   // hash and CTR blocks alike
constexpr int kSegBlocks = 4096;               // AES blocks per CTR item
constexpr int kOneBlockPerSm = 120 * 1024;     // > half the SM's 228 KB
// G, the chunks per hash block (one consumer lane each): of G = 8, 16
// and 32 at the 256 x 512 KiB tile, 8 was the fastest for this kernel
// (PERF.md). A decode tile holds at most 256 chunks, 32 hash blocks,
// well inside one wave of 132 SMs.
constexpr int kGroup = 8;

__device__ void ctr_part(uint8_t* smem, int worker, int workers,
                         const uint8_t* __restrict__ buf,
                         const int64_t* __restrict__ offsets,
                         const int64_t* __restrict__ lengths,
                         const uint32_t* __restrict__ rks, int rounds, int n,
                         uint8_t* __restrict__ plain) {
  AesTables* tb = reinterpret_cast<AesTables*>(smem);
  uint32_t* rk = reinterpret_cast<uint32_t*>(tb + 1);
  aes_fill_tables(tb);
  const int nrk = 4 * (rounds + 1);
  int64_t item = 0;                  // items before chunk i
  for (int i = 0; i < n; ++i) {
    const int64_t len = lengths[i];
    const int64_t nb = (len + 15) / 16;
    const int64_t nseg = (nb + kSegBlocks - 1) / kSegBlocks;
    const int64_t mine = item + ((worker - item % workers) + workers) % workers;
    for (int64_t it = mine; it < item + nseg; it += workers) {
      __syncthreads();               // tables filled, last item's keys read
      for (int k = threadIdx.x; k < nrk; k += blockDim.x)
        rk[k] = rks[(int64_t)i * nrk + k];
      __syncthreads();
      const uint8_t* ct = buf + offsets[i];
      uint8_t* pt = plain + offsets[i];
      const bool aligned = ((reinterpret_cast<uintptr_t>(ct) |
                             reinterpret_cast<uintptr_t>(pt)) & 15) == 0;
      const int64_t m0 = (it - item) * kSegBlocks;
      const int64_t m1 = m0 + kSegBlocks < nb ? m0 + kSegBlocks : nb;
      for (int64_t m = m0 + threadIdx.x; m < m1; m += blockDim.x) {
        uint32_t c[4] = {0u, 0u, static_cast<uint32_t>((uint64_t)m >> 32),
                         static_cast<uint32_t>(m)};
        aes_encrypt_cols(tb, rk, rounds, c);
        if (aligned && 16 * (m + 1) <= len) {
          uint4 v = reinterpret_cast<const uint4*>(ct)[m];
          v.x ^= bswap(c[0]);
          v.y ^= bswap(c[1]);
          v.z ^= bswap(c[2]);
          v.w ^= bswap(c[3]);
          reinterpret_cast<uint4*>(pt)[m] = v;
        } else {
          for (int j = 0; j < 16 && 16 * m + j < len; ++j) {
            uint8_t k = static_cast<uint8_t>(c[j >> 2] >> (24 - 8 * (j & 3)));
            pt[16 * m + j] = ct[16 * m + j] ^ k;
          }
        }
      }
    }
    item += nseg;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_kernel(const uint8_t* __restrict__ buf,
             const int64_t* __restrict__ offsets,
             const int64_t* __restrict__ lengths,
             const uint32_t* __restrict__ rks, int rounds, int n,
             int hash_blocks, uint8_t* __restrict__ plain,
             uint8_t* __restrict__ digests, uint32_t one) {
  extern __shared__ __align__(128) uint8_t smem[];
  if ((int)blockIdx.x >= hash_blocks) {
    ctr_part(smem, blockIdx.x - hash_blocks, gridDim.x - hash_blocks, buf,
             offsets, lengths, rks, rounds, n, plain);
    return;
  }
  if (threadIdx.x == 0) sha::init_barriers(smem);
  __syncthreads();
  sha::hash_group<kGroup>(smem, blockIdx.x, buf, offsets, lengths, n,
                          digests, one);
}

struct Geometry {
  int hash_blocks, ctr_blocks, smem;
};

Geometry geometry(int n) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  Geometry g;
  g.hash_blocks = (n + kGroup - 1) / kGroup;
  g.ctr_blocks = g.hash_blocks < sms ? sms - g.hash_blocks : sms;
  int need = sha::smem_bytes(kGroup);
  int aes = (int)sizeof(AesTables) + 60 * 4;
  if (aes > need) need = aes;
  g.smem = need > kOneBlockPerSm ? need : kOneBlockPerSm;
  return g;
}

}  // namespace

extern "C" int fused_verify_decrypt_launch(const void* buf,
                                           const void* offsets,
                                           const void* lengths,
                                           const void* rks, int rounds, int n,
                                           void* plain, void* digests,
                                           void* stream) {
  const Geometry g = geometry(n);
  cudaError_t e = cudaFuncSetAttribute(
      fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e != cudaSuccess) return (int)e;
  fused_kernel<<<g.hash_blocks + g.ctr_blocks, kThreads, g.smem,
                 (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const int64_t*)offsets, (const int64_t*)lengths,
      (const uint32_t*)rks, rounds, n, g.hash_blocks, (uint8_t*)plain,
      (uint8_t*)digests, 1u);
  return (int)cudaGetLastError();
}

// Launch geometry: out = {G, stages, hashing warps per hash block,
// threads per block, dynamic shared bytes, hash blocks, CTR blocks}.
extern "C" int fused_geometry(int n, long long* out) {
  const Geometry g = geometry(n);
  out[0] = kGroup;
  out[1] = sha::kStages;
  out[2] = sha::kWarps;
  out[3] = kThreads;
  out[4] = g.smem;
  out[5] = g.hash_blocks;
  out[6] = g.ctr_blocks;
  return 0;
}
