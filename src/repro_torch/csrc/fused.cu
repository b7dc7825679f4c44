// Fused verify+decrypt: SHA-256 of each ciphertext AND its AES-CTR
// plaintext (zero IV, per-chunk key) in one launch, one thread block
// per chunk.
//
// Replaces: kernels/fused/fusedp.py::fused_lanes_pallas (body
// _fused_body, with _ctr_planes and _planes_to_words; host adapter
// fused/ops.py::fused_verify_decrypt). The TPU kernel carries SHA
// schedule words and AES bit planes in one lane layout; here the
// ciphertexts arrive as one concatenated byte buffer with per-chunk
// offsets and lengths, and each block splits its warps by job: warp 0
// hashes the ciphertext (one thread, the serial chain), the other warps
// make the CTR keystream and XOR it into the plaintext buffer. Both
// read the same ciphertext bytes, which the L2 cache shares.
//
// What bounds it: per chunk, the SHA chain (8192 dependent compressions
// for a 512 KiB chunk) is longer than the CTR work spread over seven
// warps, so a launch lasts about one chunk's hash; counted as a whole,
// the ~2.2k operations per 64-byte block of SHA plus ~3.6k of AES put
// it far above the time its bytes take at 3.35 TB/s. The design hides
// all keystream work under the hash and keeps a few hundred chunks per
// launch so every SM holds several chains.
#include "crypto_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fused_kernel(const uint8_t* __restrict__ buf,
             const int64_t* __restrict__ offsets,
             const int64_t* __restrict__ lengths,
             const uint32_t* __restrict__ rks, int rounds,
             uint8_t* __restrict__ plain, uint8_t* __restrict__ digests) {
  __shared__ rc::AesTables tb;
  __shared__ uint32_t rk[60];
  const int chunk = blockIdx.x;
  const int64_t off = offsets[chunk];
  const int64_t len = lengths[chunk];
  rc::aes_fill_tables(&tb);
  for (int i = threadIdx.x; i < 4 * (rounds + 1); i += blockDim.x)
    rk[i] = rks[(int64_t)chunk * 4 * (rounds + 1) + i];
  __syncthreads();

  const uint8_t* ct = buf + off;
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0)
      rc::sha256_message(ct, len, digests + 32 * (int64_t)chunk);
    return;
  }
  uint8_t* pt = plain + off;
  const bool aligned = ((reinterpret_cast<uintptr_t>(ct) |
                         reinterpret_cast<uintptr_t>(pt)) & 15) == 0;
  const int64_t nb = (len + 15) / 16;
  for (int64_t m = threadIdx.x - 32; m < nb; m += blockDim.x - 32) {
    uint32_t c[4] = {0u, 0u, static_cast<uint32_t>((uint64_t)m >> 32),
                     static_cast<uint32_t>(m)};
    rc::aes_encrypt_cols(&tb, rk, rounds, c);
    if (aligned && 16 * (m + 1) <= len) {
      uint4 v = reinterpret_cast<const uint4*>(ct)[m];
      v.x ^= rc::bswap(c[0]);
      v.y ^= rc::bswap(c[1]);
      v.z ^= rc::bswap(c[2]);
      v.w ^= rc::bswap(c[3]);
      reinterpret_cast<uint4*>(pt)[m] = v;
    } else {
      for (int j = 0; j < 16 && 16 * m + j < len; ++j) {
        uint8_t k = static_cast<uint8_t>(c[j >> 2] >> (24 - 8 * (j & 3)));
        pt[16 * m + j] = ct[16 * m + j] ^ k;
      }
    }
  }
}

}  // namespace

extern "C" int fused_verify_decrypt_launch(const void* buf,
                                           const void* offsets,
                                           const void* lengths,
                                           const void* rks, int rounds, int n,
                                           void* plain, void* digests,
                                           void* stream) {
  fused_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const int64_t*)offsets, (const int64_t*)lengths,
      (const uint32_t*)rks, rounds, (uint8_t*)plain, (uint8_t*)digests);
  return (int)cudaGetLastError();
}
