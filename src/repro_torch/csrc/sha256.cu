// SHA-256 over N messages of mixed length, one thread per message.
//
// Replaces: kernels/sha256/sha256p.py::sha256_lanes_pallas (the lockstep
// Pallas kernel of the JAX package; host adapter sha256/ops.py::
// sha256_many_pallas). Here the messages arrive as one concatenated
// byte buffer with per-message offsets and lengths, and the padding
// (sha256v._pad) is done on the device instead of on the host.
//
// What bounds it: SHA-256 is a serial chain of compressions within a
// message, ~2.2k 32-bit operations per 64-byte block, so the time of a
// launch is at least one message's chain (8192 dependent compressions
// for a 512 KiB chunk) and parallelism comes only from messages per
// launch. The design therefore gives each message its own thread and
// packs 32 messages per warp, one warp per block so the warps spread
// over the SMs; callers batch hundreds of chunks per launch.
#include "crypto_common.cuh"

namespace {

__global__ void sha256_lanes_kernel(const uint8_t* __restrict__ buf,
                                    const int64_t* __restrict__ offsets,
                                    const int64_t* __restrict__ lengths,
                                    int n, uint8_t* __restrict__ digests) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  rc::sha256_message(buf + offsets[i], lengths[i], digests + 32 * (int64_t)i);
}

}  // namespace

extern "C" int sha256_lanes_launch(const void* buf, const void* offsets,
                                   const void* lengths, int n, void* digests,
                                   void* stream) {
  const int threads = 32;
  const int blocks = (n + threads - 1) / threads;
  sha256_lanes_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const int64_t*)offsets, (const int64_t*)lengths,
      n, (uint8_t*)digests);
  return (int)cudaGetLastError();
}
