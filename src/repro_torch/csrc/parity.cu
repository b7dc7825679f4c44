// XOR parity of k erasure stripes: out[l] = data[0][l] ^ ... ^ data[k-1][l].
//
// Replaces: kernels/parity/parity.py::parity_pallas (body _parity_kernel)
// of the JAX package, host adapter parity/ops.py::parity_fn_for_erasure.
// It is the parity row of the 4-of-5 erasure code (core/erasure.py), run
// once per L2 fill (DistributedCache.put_chunk). The Pallas kernel packs
// four bytes into each int32 lane because the TPU has no byte access;
// here the stripes stay bytes, row-major (k, L).
//
// What bounds it: bytes. Each output byte needs k input bytes and k-1
// XORs, far below the card's operation rate, so the kernel is a stream:
// each thread reads 16 bytes of every stripe (one 16-byte load per
// stripe, neighbouring threads on neighbouring addresses) and writes 16
// bytes. When the stripe length is not a multiple of 16 the rows are not
// 16-byte aligned, and each thread then moves its 16 bytes one at a time,
// masking the ragged tail. At the L2's 128 KiB stripes one launch is a
// few microseconds, set by the launch itself.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void parity_kernel(const uint8_t* __restrict__ data, int k,
                              long long len, uint8_t* __restrict__ out,
                              int vec) {
  const long long c0 = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * 16;
  if (c0 >= len) return;
  if (vec) {
    uint4 acc = __ldg(reinterpret_cast<const uint4*>(data + c0));
    for (int j = 1; j < k; ++j) {
      const uint4 v =
          __ldg(reinterpret_cast<const uint4*>(data + j * len + c0));
      acc.x ^= v.x;
      acc.y ^= v.y;
      acc.z ^= v.z;
      acc.w ^= v.w;
    }
    *reinterpret_cast<uint4*>(out + c0) = acc;
    return;
  }
  const long long end = c0 + 16 < len ? c0 + 16 : len;
  for (long long c = c0; c < end; ++c) {
    uint8_t acc = data[c];
    for (int j = 1; j < k; ++j) acc ^= data[j * len + c];
    out[c] = acc;
  }
}

}  // namespace

extern "C" int parity_launch(const void* data, int k, long long len,
                             void* out, void* stream) {
  if (k < 1 || len < 1) return (int)cudaErrorInvalidValue;
  // 16-byte loads need every row, and the output, on a 16-byte boundary
  const int vec = len % 16 == 0 && (uintptr_t)data % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  const long long segments = (len + 15) / 16;
  const unsigned blocks = (unsigned)((segments + kThreads - 1) / kThreads);
  parity_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, k, len, (uint8_t*)out, vec);
  return (int)cudaGetLastError();
}
