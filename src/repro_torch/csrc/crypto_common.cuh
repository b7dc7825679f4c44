// Device functions shared by the three crypto kernels: SHA-256 with the
// padding done on the device, and T-table AES (encrypt direction).
//
// Byte order follows the host oracles (repro_torch/core/crypto):
// SHA-256 schedule words and digests are big-endian; AES state columns
// and round keys are big-endian column words (aes.expand_key); the CTR
// counter is the 128-bit big-endian block index with a zero IV.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace rc {

__constant__ uint32_t kSha256K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

__constant__ uint32_t kSha256H0[8] = {
    0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
    0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};

__constant__ uint8_t kSbox[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// big-endian <-> the little-endian word a 4-byte load gives
__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

// ----------------------------------------------------------- SHA-256

// Number of 64-byte blocks of the padded message (sha256v._pad).
__device__ __forceinline__ int64_t sha256_nblocks(int64_t len) {
  return (len + 72) / 64;
}

// Schedule words of padded block `b` of the message msg[0, len): data,
// the 0x80 byte, zeros, and the 64-bit big-endian bit length in the
// last block. Whole blocks inside the message are read as four 16-byte
// loads when the address allows it.
__device__ __forceinline__ void sha256_load_block(const uint8_t* msg,
                                                  int64_t len, int64_t b,
                                                  int64_t nblocks,
                                                  uint32_t w[16]) {
  const int64_t base = b * 64;
  const uint8_t* p = msg + base;
  if (base + 64 <= len && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint4 v = q[i];
      w[4 * i + 0] = bswap(v.x);
      w[4 * i + 1] = bswap(v.y);
      w[4 * i + 2] = bswap(v.z);
      w[4 * i + 3] = bswap(v.w);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int64_t pos = base + 4 * i + j;
      uint32_t byte = pos < len ? p[4 * i + j] : (pos == len ? 0x80u : 0u);
      word = (word << 8) | byte;
    }
    w[i] = word;
  }
  if (b == nblocks - 1) {
    uint64_t bits = static_cast<uint64_t>(len) * 8u;
    w[14] = static_cast<uint32_t>(bits >> 32);
    w[15] = static_cast<uint32_t>(bits);
  }
}

__device__ __forceinline__ void sha256_compress(uint32_t st[8],
                                                uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      // rolling 16-word window: w[t & 15] holds w[t - 16]
      uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = h + S1 + ch + kSha256K[t] + wt;
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// Digest of msg[0, len) written big-endian to out[0, 32).
__device__ __forceinline__ void sha256_message(const uint8_t* msg,
                                               int64_t len, uint8_t* out) {
  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = kSha256H0[i];
  const int64_t nb = sha256_nblocks(len);
  uint32_t w[16];
  for (int64_t b = 0; b < nb; ++b) {
    sha256_load_block(msg, len, b, nb, w);
    sha256_compress(st, w);
  }
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = bswap(st[i]);
}

// --------------------------------------------------------------- AES

struct AesTables {
  uint32_t t0[256], t1[256], t2[256], t3[256];
  uint8_t sbox[256];
};

__device__ __forceinline__ uint32_t xtime(uint32_t a) {
  return ((a << 1) ^ ((a & 0x80u) ? 0x1Bu : 0u)) & 0xFFu;
}

// Fill the shared T-tables from the S-box (aes._T0.._T3); every thread
// of the block takes part, the caller synchronises afterwards.
__device__ __forceinline__ void aes_fill_tables(AesTables* tb) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    uint32_t s = kSbox[i], s2 = xtime(s), s3 = s2 ^ s;
    tb->sbox[i] = static_cast<uint8_t>(s);
    tb->t0[i] = (s2 << 24) | (s << 16) | (s << 8) | s3;
    tb->t1[i] = (s3 << 24) | (s2 << 16) | (s << 8) | s;
    tb->t2[i] = (s << 24) | (s3 << 16) | (s2 << 8) | s;
    tb->t3[i] = (s << 24) | (s << 16) | (s3 << 8) | s2;
  }
}

// One block: c[4] big-endian state columns in, ciphertext columns out.
// rk holds (rounds + 1) * 4 big-endian round-key words.
__device__ __forceinline__ void aes_encrypt_cols(const AesTables* tb,
                                                 const uint32_t* rk,
                                                 int rounds, uint32_t c[4]) {
  uint32_t s0 = c[0] ^ rk[0], s1 = c[1] ^ rk[1];
  uint32_t s2 = c[2] ^ rk[2], s3 = c[3] ^ rk[3];
  for (int r = 1; r < rounds; ++r) {
    const uint32_t* k = rk + 4 * r;
    uint32_t n0 = tb->t0[s0 >> 24] ^ tb->t1[(s1 >> 16) & 0xFF] ^
                  tb->t2[(s2 >> 8) & 0xFF] ^ tb->t3[s3 & 0xFF] ^ k[0];
    uint32_t n1 = tb->t0[s1 >> 24] ^ tb->t1[(s2 >> 16) & 0xFF] ^
                  tb->t2[(s3 >> 8) & 0xFF] ^ tb->t3[s0 & 0xFF] ^ k[1];
    uint32_t n2 = tb->t0[s2 >> 24] ^ tb->t1[(s3 >> 16) & 0xFF] ^
                  tb->t2[(s0 >> 8) & 0xFF] ^ tb->t3[s1 & 0xFF] ^ k[2];
    uint32_t n3 = tb->t0[s3 >> 24] ^ tb->t1[(s0 >> 16) & 0xFF] ^
                  tb->t2[(s1 >> 8) & 0xFF] ^ tb->t3[s2 & 0xFF] ^ k[3];
    s0 = n0; s1 = n1; s2 = n2; s3 = n3;
  }
  const uint32_t* k = rk + 4 * rounds;
  const uint8_t* sb = tb->sbox;
  c[0] = ((uint32_t)sb[s0 >> 24] << 24 | (uint32_t)sb[(s1 >> 16) & 0xFF] << 16 |
          (uint32_t)sb[(s2 >> 8) & 0xFF] << 8 | sb[s3 & 0xFF]) ^ k[0];
  c[1] = ((uint32_t)sb[s1 >> 24] << 24 | (uint32_t)sb[(s2 >> 16) & 0xFF] << 16 |
          (uint32_t)sb[(s3 >> 8) & 0xFF] << 8 | sb[s0 & 0xFF]) ^ k[1];
  c[2] = ((uint32_t)sb[s2 >> 24] << 24 | (uint32_t)sb[(s3 >> 16) & 0xFF] << 16 |
          (uint32_t)sb[(s0 >> 8) & 0xFF] << 8 | sb[s1 & 0xFF]) ^ k[2];
  c[3] = ((uint32_t)sb[s3 >> 24] << 24 | (uint32_t)sb[(s0 >> 16) & 0xFF] << 16 |
          (uint32_t)sb[(s1 >> 8) & 0xFF] << 8 | sb[s2 & 0xFF]) ^ k[3];
}

}  // namespace rc
