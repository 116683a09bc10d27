// Philox4x32-10 random bits for general:rng='rbg': the stream XLA's CPU and
// GPU backends expand RngBitGenerator(algorithm=default) into, which is what
// the JAX package draws under jax.random.key(seed, impl="rbg").
//
// Replaces no Pallas kernel: the JAX package draws these bits outside any
// kernel (jax.random.bits on an rbg key, opendrift_tpu/models/base.py:1161,
// lowered by XLA).  It is a kernel of the port because the plain torch
// version is a chain of some two hundred int64 operations a draw.
//
// The stream (jax/_src/prng.py _rbg_random_bits; XLA's Philox expander).
// The key is four uint32 words w0..w3, s0 = w0 | w1 << 32 and
// s1 = w2 | w3 << 32.  Output word j of a draw, counted row-major over its
// shape, is word j % 4 of the Philox block of counter i = j / 4:
//   counter (lo c, hi c, lo h, hi h) with c = s1 + i mod 2^64 and
//   h = s0 + (carry of s1 + i) mod 2^64; key (k0, k1) = (w0, w1);
//   10 rounds of  p0 = 0xD2511F53 * x0,  p1 = 0xCD9E8D57 * x2  (64-bit),
//   x = (hi p1 ^ x1 ^ k0, lo p1, hi p0 ^ x3 ^ k1, lo p0),
//   each followed by k0 += 0x9E3779B9, k1 += 0xBB67AE85.
//
// A partitioned draw (one shard of a particle-sharded run) writes a
// (lead, last) block whose row r holds global words
// [r * n_global + offset, r * n_global + offset + last); an unpartitioned
// draw is lead = 1, offset = 0, n_global = last.
//
// What bounds it on an H100: the bytes it writes.  The output is the layout
// the port's rng.bits returns, int64 holding uint32 values, 8 B a word
// (16 MB at 2M words, 4.8 us at 3.35 TB/s); a counter costs about 100
// integer operations for its four words (10 rounds of two __umulhi, two
// multiplies, four xors and two adds), 50 M operations at 2M words, under
// 1 us.  So the design is one thread a counter: no shared memory, no
// communication, the four words of a counter stored by the thread that made
// them (32 contiguous bytes, neighbouring threads on neighbouring counters),
// and the ragged ends of each row masked.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kMul0 = 0xD2511F53u;
constexpr uint32_t kMul1 = 0xCD9E8D57u;
constexpr uint32_t kBump0 = 0x9E3779B9u;
constexpr uint32_t kBump1 = 0xBB67AE85u;
constexpr int kThreads = 256;

// per_row threads cover row r's counters from (r * n_global + offset) / 4;
// thread t of a row makes counter first + t and stores its words that fall
// inside the row
__global__ void philox_bits_kernel(uint32_t w0, uint32_t w1, uint64_t s0,
                                   uint64_t s1, long long lead,
                                   long long last, long long offset,
                                   long long n_global, long long per_row,
                                   long long* out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= lead * per_row) return;
  const long long row = idx / per_row;
  const long long start = row * n_global + offset;
  const unsigned long long ctr =
      (unsigned long long)(start >> 2) + (unsigned long long)(idx - row * per_row);
  const uint64_t c = s1 + ctr;
  const uint64_t h = s0 + (c < s1 ? 1ull : 0ull);
  uint32_t x0 = (uint32_t)c, x1 = (uint32_t)(c >> 32);
  uint32_t x2 = (uint32_t)h, x3 = (uint32_t)(h >> 32);
  uint32_t k0 = w0, k1 = w1;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kMul0, x0), lo0 = kMul0 * x0;
    const uint32_t hi1 = __umulhi(kMul1, x2), lo1 = kMul1 * x2;
    x0 = hi1 ^ x1 ^ k0;
    x1 = lo1;
    x2 = hi0 ^ x3 ^ k1;
    x3 = lo0;
    k0 += kBump0;
    k1 += kBump1;
  }
  const uint32_t words[4] = {x0, x1, x2, x3};
  const long long col0 = (long long)(ctr << 2) - start;
  long long* dst = out + row * last;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long col = col0 + j;
    if (col >= 0 && col < last) dst[col] = (long long)words[j];
  }
}

// The number of counters a row spans at most: its last words plus one for
// a start inside a counter (ops/philox.py counters_per_row).
long long counters_per_row(long long last) { return (last + 3) / 4 + 1; }

}  // namespace

extern "C" int philox_bits_launch(uint32_t w0, uint32_t w1, uint32_t w2,
                                  uint32_t w3, long long lead, long long last,
                                  long long offset, long long n_global,
                                  long long* out, void* stream) {
  if (lead <= 0 || last <= 0) return 0;
  const long long per_row = counters_per_row(last);
  const long long threads = lead * per_row;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidConfiguration;
  const uint64_t s0 = (uint64_t)w0 | ((uint64_t)w1 << 32);
  const uint64_t s1 = (uint64_t)w2 | ((uint64_t)w3 << 32);
  philox_bits_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(w0, w1, s0, s1, lead, last,
                                               offset, n_global, per_row,
                                               out);
  return (int)cudaGetLastError();
}
