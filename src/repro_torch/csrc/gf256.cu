// GF(256) matrix product out(r, L) = M(r, k) x data(k, L): the
// Reed-Solomon reconstruction of the L2's erasure coder.
//
// The field is GF(2^8) with reduction polynomial 0x11D, the field of
// core/erasure.py (not AES's 0x11B). The JAX kernel's module docstring
// names 0x1B, but its code reduces by 0x1D, as here.
//
// Replaces: kernels/gf256/gf256.py::rs_encode_pallas (body _rs_kernel,
// xtime_packed, gf_mul_const_packed) of the JAX package, host adapters
// gf256/ops.py::rs_matmul_fn and rs_parity_fn. It runs in
// ErasureCoder.decode_many, once per erasure signature of a batched L2
// read. The Pallas kernel bakes the coefficients in as static values and
// compiles once per signature; here the matrix is a runtime argument, a
// small (r, k) uint8 array on the device, so one build serves every
// signature.
//
// What bounds it: bytes. The reconstruction matrices of the 4-of-5 code
// hold only 0 and 1, so on the L2 path each output byte is an XOR of at
// most k input bytes. The design reads each stripe once: a block takes up
// to four output rows (grid.y tiles the rest), each thread 16 bytes of
// every stripe (one 16-byte load each), and keeps the four 16-byte sums
// in registers. A coefficient of 0 is skipped and one of 1 is an XOR;
// every other coefficient multiplies four packed bytes at a time by
// double-and-add over its bits (the TPU kernel's packed xtime), a loop
// that is uniform across the block because the coefficient is. When the
// stripe length is not a multiple of 16, the rows are not 16-byte
// aligned, and each thread then loads and stores its 16 bytes one at a
// time, masking the ragged tail.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 4;

// GF(256) doubling of four packed bytes: shift each byte left, and where
// its top bit fell out, reduce by 0x1D.
__device__ __forceinline__ uint32_t xtime4(uint32_t x) {
  return ((x << 1) & 0xFEFEFEFEu) ^ (((x >> 7) & 0x01010101u) * 0x1Du);
}

__device__ __forceinline__ uint32_t gf_mul4(uint32_t x, uint32_t c) {
  uint32_t acc = 0;
  while (c) {
    if (c & 1) acc ^= x;
    c >>= 1;
    if (c) x = xtime4(x);
  }
  return acc;
}

__device__ __forceinline__ uint4 gf_mul16(uint4 v, uint32_t c) {
  return make_uint4(gf_mul4(v.x, c), gf_mul4(v.y, c), gf_mul4(v.z, c),
                    gf_mul4(v.w, c));
}

__device__ __forceinline__ void xor16(uint4& acc, uint4 v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

// 16 bytes at p, of which the first n are inside the row (the rest read
// as zero); one 16-byte load when the row is aligned.
__device__ __forceinline__ uint4 load16(const uint8_t* p, long long n,
                                        int vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0, 0, 0, 0};
  for (int b = 0; b < 16 && b < n; ++b)
    w[b >> 2] |= (uint32_t)p[b] << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store16(uint8_t* p, uint4 v, long long n,
                                        int vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  for (int b = 0; b < 16 && b < n; ++b)
    p[b] = (uint8_t)(w[b >> 2] >> (8 * (b & 3)));
}

__global__ void gf256_matmul_kernel(const uint8_t* __restrict__ matrix, int r,
                                    int k, const uint8_t* __restrict__ data,
                                    long long len, uint8_t* __restrict__ out,
                                    int vec) {
  const long long c0 = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * 16;
  if (c0 >= len) return;
  const int i0 = blockIdx.y * kRowTile;
  const int rows = r - i0 < kRowTile ? r - i0 : kRowTile;
  const long long n = len - c0;
  uint4 acc[kRowTile];
#pragma unroll
  for (int ii = 0; ii < kRowTile; ++ii) acc[ii] = make_uint4(0, 0, 0, 0);
  for (int j = 0; j < k; ++j) {
    const uint4 v = load16(data + j * len + c0, n, vec);
#pragma unroll
    for (int ii = 0; ii < kRowTile; ++ii) {
      if (ii >= rows) break;
      const uint32_t c = __ldg(matrix + (i0 + ii) * k + j);
      if (c == 1)
        xor16(acc[ii], v);
      else if (c != 0)
        xor16(acc[ii], gf_mul16(v, c));
    }
  }
#pragma unroll
  for (int ii = 0; ii < kRowTile; ++ii) {
    if (ii >= rows) break;
    store16(out + (i0 + ii) * len + c0, acc[ii], n, vec);
  }
}

}  // namespace

extern "C" int gf256_matmul_launch(const void* matrix, int r, int k,
                                   const void* data, long long len, void* out,
                                   void* stream) {
  if (r < 1 || k < 1 || len < 1) return (int)cudaErrorInvalidValue;
  const int vec = len % 16 == 0 && (uintptr_t)data % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  const long long segments = (len + 15) / 16;
  const dim3 grid((unsigned)((segments + kThreads - 1) / kThreads),
                  (unsigned)((r + kRowTile - 1) / kRowTile));
  gf256_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)matrix, r, k, (const uint8_t*)data, len,
      (uint8_t*)out, vec);
  return (int)cudaGetLastError();
}
