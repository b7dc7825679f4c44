// AES block encryption with per-chunk round keys, one thread per block.
//
// Replaces: kernels/aes/bitslice_pallas.py::encrypt_planes_pallas (the
// bit-plane Pallas kernel of the JAX package; host adapter aes/ops.py::
// encrypt_many_bitsliced with per_chunk_rks=True). The bit planes exist
// only because the TPU's vector unit has no byte gather; here the
// T-tables and S-box live in shared memory and every 16-byte block is a
// plain T-table encryption.
//
// What bounds it: operations, not bytes. One AES-256 block moves 36
// bytes (block in, block out, chunk index) against ~900 table reads,
// shifts and XORs, so at 3.35 TB/s against the card's 32-bit integer
// rate the operations take about five times longer than the bytes. The
// design keeps every table read in shared memory (4 KiB of T-tables,
// filled once per thread block) and the round keys in L1 through the
// read-only path; neighbouring threads share a chunk and so read the
// same round-key words.
#include "crypto_common.cuh"

namespace {

__global__ void aes_encrypt_kernel(const uint8_t* __restrict__ blocks,
                                   const int32_t* __restrict__ chunk_idx,
                                   const uint32_t* __restrict__ rks,
                                   int rounds, int64_t n,
                                   uint8_t* __restrict__ out) {
  __shared__ rc::AesTables tb;
  rc::aes_fill_tables(&tb);
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t* rk = rks + (int64_t)__ldg(chunk_idx + i) * 4 * (rounds + 1);
    uint4 v = reinterpret_cast<const uint4*>(blocks)[i];
    uint32_t c[4] = {rc::bswap(v.x), rc::bswap(v.y), rc::bswap(v.z),
                     rc::bswap(v.w)};
    rc::aes_encrypt_cols(&tb, rk, rounds, c);
    reinterpret_cast<uint4*>(out)[i] =
        make_uint4(rc::bswap(c[0]), rc::bswap(c[1]), rc::bswap(c[2]),
                   rc::bswap(c[3]));
  }
}

}  // namespace

extern "C" int aes_encrypt_launch(const void* blocks, const void* chunk_idx,
                                  const void* rks, int rounds, long long n,
                                  void* out, void* stream) {
  const int threads = 256;
  long long want = (n + threads - 1) / threads;
  const int grid = (int)(want < 132 * 32 ? (want > 0 ? want : 1) : 132 * 32);
  aes_encrypt_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)blocks, (const int32_t*)chunk_idx,
      (const uint32_t*)rks, rounds, (int64_t)n, (uint8_t*)out);
  return (int)cudaGetLastError();
}
