// Warp-specialised SHA-256 for Hopper, shared by sha256.cu and fused.cu.
//
// A group is G <= 32 messages. One thread block hashes one group with
// four warps:
//   warp 0, the consumer: lane i runs message i's 64 rounds per block,
//     reading W+K (the schedule word plus the round constant) from a
//     ring of shared-memory stages, one LDS.128 per four rounds. It never
//     waits on device memory and does no schedule arithmetic.
//   warps 1-3, the producers: producer p owns blocks b = p-1 (mod 3)
//     of every message. Lane i streams message i's 64-byte blocks into
//     a private ring of kRaw slots with 16-byte cp.async copies, issued
//     kRaw - 1 blocks ahead; builds the padding blocks (0x80, zeros, the
//     64-bit bit length) on the device; expands the 64 schedule words,
//     adds K, and stores them as [t/4][lane][4] words, so that each
//     consumer load is 512 contiguous bytes for the warp, free of bank
//     conflicts. Full and empty mbarriers hand each of the kStages
//     stages between the producer that owns it and the consumer.
// The block's four warps land on the SM's four sub-partitions (their
// hardware slots are a rotation of 0..3: scripts/sha_engine_probe.py), so
// the consumer's sub-partition issues nothing of the producers'.
//
// Freezing (as the TPU kernel's sha_block_fold freezes lanes): the
// group runs to its longest message; a lane past its own last block
// computes on whatever the stage holds and keeps its state. So one
// launch hashes messages of any mix of lengths, from 0 bytes up.
//
// Alignment: a block is copied by cp.async only when the message starts
// on a 16-byte boundary (pack_messages aligns every start) and the block
// lies wholly inside the message. Other blocks (an unaligned message,
// the partial last data block, the padding blocks) are read byte by byte
// by the producer lane. No read goes past a message's last byte, so
// none goes past the end of the buffer.
//
// What bounds it: the chain. A message's 64-byte blocks are dependent,
// each 64 rounds of ~14 instructions (3 rotates and a 3-way xor for
// each Sigma, one LOP3 each for ch and maj, four adds), so a 512 KiB
// chunk (8193 padded blocks) is 524,352 dependent rounds: 3.707 ms at
// one instruction a cycle at 1.98 GHz, however many chunks run beside
// it (up to 132 SMs x 32 per launch). On Hopper a warp instruction holds
// a sub-partition's 16-lane INT32 pipe for 2 cycles, so the 10 logic ops
// of a round, which only that pipe runs, cost 20 cycles: 5.3 ms. The
// round below moves the adds it can to the FMA pipe as IMAD (round_),
// and the consumer loops over 32 rounds rather than unrolling all 64.
// ptxas then schedules 11.1 INT32 and 6.0 IMAD instructions in 23.3
// cycles a round (scripts/sha_engine_probe.py), and the card runs ~28
// (chip_smoke.py's kernel times). Each kernel fixes its own G.
// Each producer has three of the consumer's block times for its block.
#pragma once
#include "crypto_common.cuh"

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

namespace sha {

constexpr int kProducers = 3;            // warps 1..3
constexpr int kStagesPer = 2;            // W+K stages owned by each producer
constexpr int kStages = kProducers * kStagesPer;
constexpr int kRaw = 3;                  // cp.async slots per producer lane
constexpr int kWarps = 1 + kProducers;
constexpr int kThreads = 32 * kWarps;
constexpr int kBarrierBytes = 128;       // 2 * kStages mbarriers, padded

// Dynamic shared memory of one group of g messages: the barriers, the
// W+K ring (kStages x 64 words x g) and the producers' raw slots.
__host__ __device__ constexpr int wk_bytes(int g) { return kStages * 256 * g; }
__host__ __device__ constexpr int smem_bytes(int g) {
  return kBarrierBytes + wk_bytes(g) + kProducers * kRaw * 64 * g;
}

// ------------------------------------------------ PTX wrappers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Block until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------ arithmetic

// x + y as IMAD x * one + y on the FMA pipe (`one` is a kernel argument,
// so ptxas cannot fold it back into an add on the INT32 pipe).
__device__ __forceinline__ uint32_t imad_add(uint32_t x, uint32_t y,
                                             uint32_t one) {
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(one), "r"(y));
  return r;
}

__device__ __forceinline__ uint32_t big_sigma0(uint32_t a) {
  return rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
}
__device__ __forceinline__ uint32_t big_sigma1(uint32_t e) {
  return rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
}
__device__ __forceinline__ uint32_t small_sigma0(uint32_t w) {
  return rotr(w, 7) ^ rotr(w, 18) ^ (w >> 3);
}
__device__ __forceinline__ uint32_t small_sigma1(uint32_t w) {
  return rotr(w, 17) ^ rotr(w, 19) ^ (w >> 10);
}

// One round on the state named (a..h) with wk = W[t] + K[t]: d becomes
// the new e and h the new a, so the next round names (h, a, ..., g).
// hk = h + wk and dhk = d + hk are IMADs off the chain; e' = dhk + ch +
// S1 is one IADD3 after S1, so e -> e' is three dependent ops (SHF,
// LOP3, IADD3); a' = ((hk + maj + ch) + S1) + S0 is IMADs. The INT32 pipe
// keeps the 10 logic ops (6 SHF, 4 LOP3) and one IADD3. Leaving the adds
// to ptxas instead (t1 = h + S1 + ch + wk, e' = d + t1, a' = t1 + S0 +
// maj) gave 12.2 INT32 instructions a round and a longer schedule.
__device__ __forceinline__ void round_(uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t& d, uint32_t e, uint32_t f,
                                       uint32_t g, uint32_t& h, uint32_t wk,
                                       uint32_t one) {
  const uint32_t ch = (e & f) ^ (~e & g);
  const uint32_t maj = (a & b) | (c & (a | b));
  const uint32_t s1 = big_sigma1(e), s0 = big_sigma0(a);
  const uint32_t hk = imad_add(h, wk, one);
  const uint32_t dhk = imad_add(d, hk, one);
  d = dhk + ch + s1;
  h = imad_add(imad_add(imad_add(imad_add(hk, maj, one), ch, one), s1, one),
               s0, one);
}

// Padded block count of a message of `len` bytes (sha256v._pad).
__device__ __forceinline__ int64_t nblocks(int64_t len) { return (len + 72) / 64; }

// Schedule words of padded block `b` of msg[0, len), byte by byte: data,
// the 0x80 byte, zeros, and the big-endian bit length in the last block.
__device__ __forceinline__ void block_bytes(const uint8_t* __restrict__ msg,
                                            int64_t len, int64_t b,
                                            uint32_t w[16]) {
  const int64_t base = b * 64;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t pos = base + 4 * i + j;
      const uint32_t byte =
          pos < len ? __ldg(msg + pos) : (pos == len ? 0x80u : 0u);
      word = (word << 8) | byte;
    }
    w[i] = word;
  }
  if (b == nblocks(len) - 1) {
    const uint64_t bits = static_cast<uint64_t>(len) * 8u;
    w[14] = static_cast<uint32_t>(bits >> 32);
    w[15] = static_cast<uint32_t>(bits);
  }
}

// One lane's message within its group.
struct Lane {
  const uint8_t* msg;
  int64_t len;
  int64_t nb;        // padded blocks; 0 for a lane without a message
  bool aligned;      // starts on a 16-byte boundary
  int64_t index;     // message index, valid when nb > 0

  __device__ __forceinline__ bool fast(int64_t b) const {
    return aligned && (b + 1) * 64 <= len;
  }
};

template <int G>
__device__ __forceinline__ Lane lane_of(const uint8_t* buf,
                                        const int64_t* offsets,
                                        const int64_t* lengths, int n,
                                        int group, int lane) {
  Lane L{buf, 0, 0, false, static_cast<int64_t>(group) * G + lane};
  if (lane < G && L.index < n) {
    L.msg = buf + offsets[L.index];
    L.len = lengths[L.index];
    L.nb = nblocks(L.len);
    L.aligned = (reinterpret_cast<uintptr_t>(L.msg) & 15) == 0;
  }
  return L;
}

__device__ __forceinline__ int64_t warp_max(int64_t v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int64_t o = __shfl_xor_sync(0xffffffffu, v, s);
    v = o > v ? o : v;
  }
  return v;
}

// The block's barriers: full[kStages] then empty[kStages], 32 arrivals
// each (a whole warp). Thread 0 initialises and fences them; the caller
// then synchronises the block.
__device__ __forceinline__ void init_barriers(uint8_t* smem) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  for (int s = 0; s < 2 * kStages; ++s) mbar_init(bars + s, 32);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Producer warp `p` (1..kProducers): its blocks b = p-1, p-1+kProducers,
// ... of the group, each into stage b mod kStages.
template <int G>
__device__ __forceinline__ void produce(uint8_t* smem, const Lane& L,
                                        int64_t maxnb, int p, int lane) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  uint4* wk = reinterpret_cast<uint4*>(smem + kBarrierBytes);
  uint8_t* raw = smem + kBarrierBytes + wk_bytes(G) +
                 ((p - 1) * kRaw * G + lane % G) * 64;
  const int first = p - 1;
  auto issue = [&](int64_t j) {
    const int64_t b = first + j * kProducers;
    if (lane < G && b < L.nb && L.fast(b)) {
      uint8_t* dst = raw + (j % kRaw) * G * 64;
      const uint8_t* src = L.msg + b * 64;
#pragma unroll
      for (int k = 0; k < 4; ++k) cp_async16(dst + 16 * k, src + 16 * k);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kRaw - 1; ++j) issue(j);
  int stage = first, use = 0;
  for (int64_t j = 0, b = first; b < maxnb; ++j, b += kProducers) {
    issue(j + kRaw - 1);
    cp_async_wait<kRaw - 1>();
    uint32_t w[16];
    if (b < L.nb && L.fast(b)) {
      const uint4* q = reinterpret_cast<const uint4*>(raw + (j % kRaw) * G * 64);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 v = q[i];
        w[4 * i] = bswap(v.x);
        w[4 * i + 1] = bswap(v.y);
        w[4 * i + 2] = bswap(v.z);
        w[4 * i + 3] = bswap(v.w);
      }
    } else if (b < L.nb) {
      block_bytes(L.msg, L.len, b, w);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = 0;
    }
    mbar_wait(empty + stage, (use & 1) ^ 1);
    uint4* dst = wk + stage * 16 * G + lane % G;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      if (q >= 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 4 * q + i;
          w[t & 15] += small_sigma0(w[(t - 15) & 15]) + w[(t - 7) & 15] +
                       small_sigma1(w[(t - 2) & 15]);
        }
      }
      if (lane < G)
        dst[q * G] = make_uint4(w[(4 * q) & 15] + kSha256K[4 * q],
                                w[(4 * q + 1) & 15] + kSha256K[4 * q + 1],
                                w[(4 * q + 2) & 15] + kSha256K[4 * q + 2],
                                w[(4 * q + 3) & 15] + kSha256K[4 * q + 3]);
    }
    mbar_arrive(full + stage);
    stage += kProducers;
    if (stage >= kStages) {
      stage = first;
      ++use;
    }
  }
}

// Eight rounds with W+K words k0 (rounds 8s..8s+3) and k1 (8s+4..8s+7);
// the names come back to (a..h) after eight.
__device__ __forceinline__ void eight_rounds(uint32_t& a, uint32_t& b,
                                             uint32_t& c, uint32_t& d,
                                             uint32_t& e, uint32_t& f,
                                             uint32_t& g, uint32_t& h,
                                             uint4 k0, uint4 k1,
                                             uint32_t one) {
  round_(a, b, c, d, e, f, g, h, k0.x, one);
  round_(h, a, b, c, d, e, f, g, k0.y, one);
  round_(g, h, a, b, c, d, e, f, k0.z, one);
  round_(f, g, h, a, b, c, d, e, k0.w, one);
  round_(e, f, g, h, a, b, c, d, k1.x, one);
  round_(d, e, f, g, h, a, b, c, k1.y, one);
  round_(c, d, e, f, g, h, a, b, k1.z, one);
  round_(b, c, d, e, f, g, h, a, k1.w, one);
}

// Eight-round steps per iteration of the consumer's loop: 4 (32 rounds,
// ~9 KB of code) ran faster than the fully unrolled block (~18 KB) at the
// same static schedule, which points at instruction fetch.
constexpr int kStepsPerIteration = 4;

// The consumer warp: the 64 rounds of every block, W+K from the ring;
// lanes past their last block keep their state. Writes the digests.
template <int G>
__device__ __forceinline__ void consume(uint8_t* smem, const Lane& L,
                                        int64_t maxnb, int lane,
                                        uint8_t* __restrict__ digests,
                                        uint32_t one) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  const uint4* wk = reinterpret_cast<const uint4*>(smem + kBarrierBytes);
  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = kSha256H0[i];
  int stage = 0, use = 0;
  for (int64_t b = 0; b < maxnb; ++b) {
    mbar_wait(full + stage, use & 1);
    const uint4* src = wk + stage * 16 * G + lane % G;
    uint32_t a = st[0], bb = st[1], c = st[2], d = st[3];
    uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll (kStepsPerIteration)
    for (int q = 0; q < 16; q += 2)
      eight_rounds(a, bb, c, d, e, f, g, h, src[q * G], src[(q + 1) * G],
                   one);
    mbar_arrive(empty + stage);
    if (++stage == kStages) {
      stage = 0;
      ++use;
    }
    if (b < L.nb) {
      st[0] += a; st[1] += bb; st[2] += c; st[3] += d;
      st[4] += e; st[5] += f; st[6] += g; st[7] += h;
    }
  }
  if (L.nb > 0) {
    uint32_t* o = reinterpret_cast<uint32_t*>(digests + 32 * L.index);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = bswap(st[i]);
  }
}

// Digests of group `group` (messages group*G ..) by warps 0..kWarps-1
// of the block, after init_barriers and a block-wide synchronisation.
template <int G>
__device__ __forceinline__ void hash_group(uint8_t* smem, int group,
                                           const uint8_t* __restrict__ buf,
                                           const int64_t* __restrict__ offsets,
                                           const int64_t* __restrict__ lengths,
                                           int n, uint8_t* __restrict__ digests,
                                           uint32_t one) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Lane L = lane_of<G>(buf, offsets, lengths, n, group, lane);
  const int64_t maxnb = warp_max(L.nb);
  if (warp == 0)
    consume<G>(smem, L, maxnb, lane, digests, one);
  else if (warp < kWarps)
    produce<G>(smem, L, maxnb, warp, lane);
}

}  // namespace sha
}  // namespace rc
