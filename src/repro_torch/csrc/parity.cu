// XOR parity of k erasure stripes: out[l] = data[0][l] ^ ... ^ data[k-1][l].
//
// Replaces: kernels/parity/parity.py::parity_pallas (body _parity_kernel)
// of the JAX package, host adapter parity/ops.py::parity_fn_for_erasure.
// It is the parity row of the 4-of-5 erasure code (core/erasure.py), run
// once per L2 fill (DistributedCache.put_chunk). The Pallas kernel packs
// four bytes into each int32 lane because the TPU has no byte access;
// here the stripes stay bytes, row-major (k, L).
//
// What bounds it: the launch. One put_chunk's (4, 131072) stripes move
// 640 KiB, 0.2 us at 3.35 TB/s, while an empty kernel of the same grid
// takes 1.77-1.94 us of device time between its neighbours on the
// stream and this kernel 2.05-2.27 us (NVIDIA H100 80GB HBM3, 700.00 W;
// chip_smoke.py prints both). So the design only keeps the kernel's own
// work small against that floor:
//   - Every SM works: 64 threads a block, each one vector of every
//     stripe, so the L2's 131072-byte stripes make 128 blocks.
//   - k is a template parameter for 2..8 (the L2 uses 4): the k loads are
//     all issued before the first XOR. Other k take a runtime loop.
//   - The widest vector (16, 8 or 4 bytes) that every row's start allows:
//     when the stripe length is a multiple of V, all rows share the first
//     row's offset modulo V, and the output must share it too (the
//     wrapper's fresh output and the L2's stripes sit on the 16-byte
//     grid). Only the ragged head before the first V-aligned byte and the
//     tail after the last whole vector go byte by byte, one thread a byte;
//     a length that is not a multiple of 4, or data and output on
//     different offsets, takes bytes throughout.
//   - Streaming cache hints (__ldcs/__stcs): every byte is read once.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

template <int V> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<1> { using T = uint8_t; };

__device__ __forceinline__ uint4 vxor(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
__device__ __forceinline__ uint2 vxor(uint2 a, uint2 b) {
  return make_uint2(a.x ^ b.x, a.y ^ b.y);
}
__device__ __forceinline__ uint32_t vxor(uint32_t a, uint32_t b) {
  return a ^ b;
}
__device__ __forceinline__ uint8_t vxor(uint8_t a, uint8_t b) {
  return a ^ b;
}

// Threads [0, units) XOR one V-byte vector at byte head + u * V of every
// row; the next (len - units * V) threads one byte each of the ragged
// head [0, head) and tail [head + units * V, len). K > 0: k == K.
template <int K, int V>
__global__ void __launch_bounds__(kThreads)
parity_kernel(const uint8_t* __restrict__ data, int k, long long len,
              uint8_t* __restrict__ out, long long head, long long units) {
  using T = typename Vec<V>::T;
  const long long u = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (u < units) {
    const long long c = head + u * V;
    T acc;
    if constexpr (K > 0) {
      T v[K];
#pragma unroll
      for (int j = 0; j < K; ++j)
        v[j] = __ldcs(reinterpret_cast<const T*>(data + j * len + c));
      acc = v[0];
#pragma unroll
      for (int j = 1; j < K; ++j) acc = vxor(acc, v[j]);
    } else {
      acc = __ldcs(reinterpret_cast<const T*>(data + c));
      for (int j = 1; j < k; ++j)
        acc = vxor(acc,
                   __ldcs(reinterpret_cast<const T*>(data + j * len + c)));
    }
    __stcs(reinterpret_cast<T*>(out + c), acc);
    return;
  }
  const long long e = u - units;
  const long long c = e < head ? e : head + units * V + (e - head);
  if (c >= len) return;
  uint8_t acc = __ldcs(data + c);
  for (int j = 1; j < (K > 0 ? K : k); ++j) acc ^= __ldcs(data + j * len + c);
  __stcs(out + c, acc);
}

__global__ void empty_kernel() {}

long long grid_for(long long len, long long units, int vec) {
  return (units + (len - units * vec) + kThreads - 1) / kThreads;
}

template <int K>
cudaError_t launch(int vec, const uint8_t* data, int k, long long len,
                   uint8_t* out, long long head, cudaStream_t stream) {
  const long long units = (len - head) / vec;
  const unsigned blocks = (unsigned)grid_for(len, units, vec);
  switch (vec) {
    case 16:
      parity_kernel<K, 16><<<blocks, kThreads, 0, stream>>>(data, k, len, out,
                                                            head, units);
      break;
    case 8:
      parity_kernel<K, 8><<<blocks, kThreads, 0, stream>>>(data, k, len, out,
                                                           head, units);
      break;
    case 4:
      parity_kernel<K, 4><<<blocks, kThreads, 0, stream>>>(data, k, len, out,
                                                           head, units);
      break;
    default:
      parity_kernel<K, 1><<<blocks, kThreads, 0, stream>>>(data, k, len, out,
                                                           0, len);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int parity_launch(const void* data, int k, long long len,
                             void* out, void* stream) {
  if (k < 1 || len < 1) return (int)cudaErrorInvalidValue;
  const uintptr_t d = (uintptr_t)data, o = (uintptr_t)out;
  const int widths[] = {16, 8, 4};
  int vec = 1;
  for (int v : widths) {
    if ((k == 1 || len % v == 0) && (d - o) % v == 0) {
      vec = v;
      break;
    }
  }
  long long head = (long long)((vec - d % vec) % vec);
  if (head > len) head = len;
  const auto* in = (const uint8_t*)data;
  auto* dst = (uint8_t*)out;
  auto s = (cudaStream_t)stream;
  cudaError_t e;
  switch (k) {
    case 2: e = launch<2>(vec, in, k, len, dst, head, s); break;
    case 3: e = launch<3>(vec, in, k, len, dst, head, s); break;
    case 4: e = launch<4>(vec, in, k, len, dst, head, s); break;
    case 5: e = launch<5>(vec, in, k, len, dst, head, s); break;
    case 6: e = launch<6>(vec, in, k, len, dst, head, s); break;
    case 7: e = launch<7>(vec, in, k, len, dst, head, s); break;
    case 8: e = launch<8>(vec, in, k, len, dst, head, s); break;
    default: e = launch<0>(vec, in, k, len, dst, head, s);
  }
  return (int)e;
}

// The launch floor: an empty kernel with the grid parity_launch uses for
// 16-byte-aligned rows of `len` bytes.
extern "C" int parity_empty_launch(long long len, void* stream) {
  const long long units = len / 16;
  empty_kernel<<<(unsigned)grid_for(len, units, 16), kThreads, 0,
                 (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
