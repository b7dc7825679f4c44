// SHA-256 over N messages of mixed length: the warp-specialised engine
// of sha256_engine.cuh with a digest write, one thread block per group
// of G messages.
//
// Replaces: kernels/sha256/sha256p.py::sha256_lanes_pallas (the lockstep
// Pallas kernel of the JAX package; host adapter sha256/ops.py::
// sha256_many_pallas). Here the messages arrive as one concatenated
// byte buffer with per-message offsets and lengths, and the padding
// (sha256v._pad) is done on the device instead of on the host.
//
// What bounds it: the longest message's chain of dependent rounds
// (sha256_engine.cuh), 3.707 ms for a 512 KiB chunk at one instruction
// per cycle, ~7.4 ms as the card runs it. Messages are independent, so
// a launch of up to 132 x G messages costs about one chain: the consumer
// warp of each block runs only the rounds, the producer warps keep the
// next stages' W+K ready.
#include "sha256_engine.cuh"

namespace {

using namespace rc;

// G, the messages per thread block (one consumer lane each): of G = 8,
// 16 and 32 at the 256 x 512 KiB tile, 32 was the fastest for this
// kernel (PERF.md), and it needs the fewest blocks.
constexpr int kGroup = 32;

__global__ void __launch_bounds__(sha::kThreads)
sha256_engine_kernel(const uint8_t* __restrict__ buf,
                     const int64_t* __restrict__ offsets,
                     const int64_t* __restrict__ lengths, int n,
                     uint8_t* __restrict__ digests, uint32_t one) {
  extern __shared__ __align__(128) uint8_t smem[];
  if (threadIdx.x == 0) sha::init_barriers(smem);
  __syncthreads();
  sha::hash_group<kGroup>(smem, blockIdx.x, buf, offsets, lengths, n,
                          digests, one);
}

}  // namespace

extern "C" int sha256_lanes_launch(const void* buf, const void* offsets,
                                   const void* lengths, int n, void* digests,
                                   void* stream) {
  const int smem = sha::smem_bytes(kGroup);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sha256_engine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  sha256_engine_kernel<<<(n + kGroup - 1) / kGroup, sha::kThreads, smem,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const int64_t*)offsets, (const int64_t*)lengths,
      n, (uint8_t*)digests, 1u);
  return (int)cudaGetLastError();
}

// Launch geometry for n messages: out = {G, stages, warps per block,
// threads per block, dynamic shared bytes, blocks}.
extern "C" int sha256_lanes_geometry(int n, long long* out) {
  out[0] = kGroup;
  out[1] = sha::kStages;
  out[2] = sha::kWarps;
  out[3] = sha::kThreads;
  out[4] = sha::smem_bytes(kGroup);
  out[5] = (n + kGroup - 1) / kGroup;
  return 0;
}
