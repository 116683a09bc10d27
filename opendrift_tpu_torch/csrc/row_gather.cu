// Packed-row gather: out[e, :] = table[clamp(idx[e], 0, R - 1), :], the row
// fetch under every sample of the packed-row sampler (ops/interp.py
// take_rows), for a contiguous (R, C) table of 2- or 4-byte elements.
//
// Replaces the two Pallas TPU kernels of tools/gather_ab.py:
//   gather_rows_async_kernel <- _pallas_dma_gather (pallas_call at :94):
//       one asynchronous copy per row from device memory into fast memory,
//       NBUF = 8 in flight, 1024 rows a grid step, rows padded to 128 lanes;
//   gather_rows_smem_kernel  <- _pallas_vmem_gather (pallas_call at :133):
//       the whole table staged in fast memory, rows read from there; valid
//       only while the table fits.
//
// What bounds them on an H100: bytes.  A gather does no arithmetic; it reads
// the indices (N x 4 or 8 B), reads each row it is asked for and writes
// N x C x itemsize.  The least the card can do is read every distinct row
// once, in whole 32-byte sectors, and write the output once, at 3.35 TB/s;
// chip_smoke.py and tools/gather_ab.py compute that from the run's indices
// (ops/gather.py gather_bound_bytes).  At the tool's default shape (250,000
// x 24 float32, 2M int32 indices) that is 8 + 24 + 192 MB, 67 us.  A kernel
// that re-reads a row for every index that names it moves
// N x (idx + 2 x C x itemsize) bytes, 392 MB or 117 us there, unless the L2
// cache (50 MB) holds the table.
//
// What the designs do about it.  Rows are gathered at their own width:
// nothing is padded to a lane count, and the ragged tail of N is masked.
// Everything is moved in "units" of W bytes, W the widest of 16, 8, 4 and
// 2 that divides the row's bytes and the base addresses, so a 96-byte row
// is six 16-byte copies and an 88-byte row eleven 8-byte ones.
//
//  * async: the TPU kernel walks its rows in order on one core.  Here every
//    warp owns a contiguous run of output rows, cut into stages of a few
//    rows (about 512 bytes).  It loads a stage's indices with its first
//    lanes, hands them round with shuffles, and issues the stage's row
//    copies from device memory into its own ring of NBUF stages of shared
//    memory with cp.async (cp.async has no 2-byte form: such rows use plain
//    loads into the same ring).  When the oldest stage has landed
//    (cp.async.wait_group) the warp writes it to `out` as one contiguous
//    run, neighbouring lanes on neighbouring addresses, and refills the
//    slot.  With 4 warps a block and NBUF - 1 = 7 stages in flight a warp,
//    an SM keeps well over the ~15 KB in flight that 3.35 TB/s over 132 SMs
//    needs at device-memory latency.
//  * smem: one persistent block an SM copies the table into dynamic shared
//    memory once (at most 232,448 bytes, opted into with
//    cudaFuncSetAttribute) and then walks chunks of 1024 indices in a
//    grid-stride loop, so the table's load is paid once a block (132 times)
//    and not once a chunk; every output unit is one shared-memory read and
//    one coalesced store.  It adds blocks x R x C x itemsize bytes of table
//    loads to the traffic and takes the row reads off device memory.
//
// Plain C interface, launched on the caller's stream; each launcher returns
// the cudaError_t of the launch (0 on success).  Bits pass through
// untouched (NaN payloads, signed zeros): nothing is interpreted as a number.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNBuf = 8;            // stages of the ring, as the TPU kernel's
constexpr int kWarps = 4;           // warps a block (async)
constexpr int kStageTarget = 512;   // bytes of rows in one stage
constexpr int kChunk = 1024;        // indices a chunk (smem), as the TPU CHUNK
constexpr int kSmemThreads = 1024;
constexpr int kMaxDynamicSmem = 232448;   // a block's limit on sm_90

template <int W> struct Unit;
template <> struct Unit<16> { using type = uint4; };
template <> struct Unit<8> { using type = uint2; };
template <> struct Unit<4> { using type = uint32_t; };
template <> struct Unit<2> { using type = uint16_t; };

// One unit from device memory into shared memory, asynchronously where the
// hardware has a copy of that width.
template <int W>
__device__ __forceinline__ void copy_unit(void* smem_dst, const void* src) {
  if constexpr (W == 16) {
    uint32_t d = (uint32_t)__cvta_generic_to_shared(smem_dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else if constexpr (W == 8) {
    uint32_t d = (uint32_t)__cvta_generic_to_shared(smem_dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else if constexpr (W == 4) {
    uint32_t d = (uint32_t)__cvta_generic_to_shared(smem_dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    *reinterpret_cast<uint16_t*>(smem_dst) =
        *reinterpret_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

template <typename Index>
__device__ __forceinline__ long long clamped(const Index* idx, long long e,
                                             long long rows) {
  long long i = (long long)idx[e];
  i = i < 0 ? 0 : i;
  return i > rows - 1 ? rows - 1 : i;
}

// A warp's run is stages [first, last); stage s covers output rows
// [s * G, s * G + G).  Units of a stage lie in the ring slot exactly as they
// will lie in `out`.
template <int W, typename Index>
__global__ void gather_rows_async_kernel(
    const unsigned char* __restrict__ table, const Index* __restrict__ idx,
    unsigned char* __restrict__ out, long long rows, long long n, int U,
    int G, int stage_bytes, long long stages_per_warp) {
  using unit_t = typename Unit<W>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* ring = smem + (size_t)warp * kNBuf * stage_bytes;
  const long long gwarp = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  const long long total = (n + G - 1) / G;
  const long long first = gwarp * stages_per_warp;
  long long last = first + stages_per_warp;
  if (last > total) last = total;
  if (first >= last) return;   // the whole warp leaves together
  const int stage_units = G * U;

  // issue the copies of stage s (none beyond the run) and close its group
  auto issue = [&](long long s) {
    if (s < last) {
      const int slot = (int)((s - first) % kNBuf);
      const long long row0 = s * G;
      const long long left = n - row0;
      const int valid = left < G ? (int)left : G;
      long long mine = 0;
      if (lane < valid) mine = clamped(idx, row0 + lane, rows);
      unsigned char* dst = ring + (size_t)slot * stage_bytes;
      for (int base = 0; base < stage_units; base += 32) {
        const int j = base + lane;
        int r = j / U;
        const int u = j - r * U;
        r = r < 31 ? r : 31;
        const long long row = __shfl_sync(0xffffffffu, mine, r);
        if (j < valid * U)
          copy_unit<W>(dst + (size_t)j * W,
                       table + ((size_t)row * U + u) * (size_t)W);
      }
    }
    commit_group();
  };

  for (int k = 0; k < kNBuf - 1; ++k) issue(first + k);
  for (long long s = first; s < last; ++s) {
    wait_group<kNBuf - 2>();    // this lane's copies of stage s have landed
    __syncwarp();               // ... and every other lane's
    const int slot = (int)((s - first) % kNBuf);
    const long long row0 = s * G;
    const long long left = n - row0;
    const int valid = left < G ? (int)left : G;
    const unit_t* src =
        reinterpret_cast<const unit_t*>(ring + (size_t)slot * stage_bytes);
    unit_t* dst = reinterpret_cast<unit_t*>(out) + (size_t)row0 * U;
    for (int j = lane; j < valid * U; j += 32) dst[j] = src[j];
    __syncwarp();               // the slot of stage s - 1 is free for all
    issue(s + kNBuf - 1);
  }
}

template <int W, typename Index>
__global__ void gather_rows_smem_kernel(
    const unsigned char* __restrict__ table, const Index* __restrict__ idx,
    unsigned char* __restrict__ out, long long rows, long long n, int U) {
  using unit_t = typename Unit<W>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  unit_t* tab = reinterpret_cast<unit_t*>(smem);
  const unit_t* gtab = reinterpret_cast<const unit_t*>(table);
  const long long table_units = rows * U;
  for (long long j = threadIdx.x; j < table_units; j += blockDim.x)
    tab[j] = gtab[j];
  __syncthreads();
  unit_t* o = reinterpret_cast<unit_t*>(out);
  const long long chunks = (n + kChunk - 1) / kChunk;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const long long row0 = c * kChunk;
    const long long left = n - row0;
    const int valid = left < kChunk ? (int)left : kChunk;
    const int units = valid * U;
    for (int j = threadIdx.x; j < units; j += blockDim.x) {
      const int r = j / U;
      const int u = j - r * U;
      const long long row = clamped(idx, row0 + r, rows);
      o[(size_t)row0 * U + j] = tab[(size_t)row * U + u];
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        count <= 0)
      count = 132;
  }
  return count;
}

template <int W, typename Index>
int launch_async(const void* table, const void* idx, void* out,
                 long long rows, long long n, int row_bytes, cudaStream_t s) {
  const int U = row_bytes / W;
  int G = kStageTarget / row_bytes;
  G = G < 1 ? 1 : (G > 32 ? 32 : G);
  const int stage_bytes = (G * row_bytes + 15) / 16 * 16;
  int warps = kWarps;
  while (warps > 1 && (size_t)warps * kNBuf * stage_bytes > kMaxDynamicSmem)
    warps /= 2;
  const size_t smem = (size_t)warps * kNBuf * stage_bytes;
  if (smem > kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  auto kernel = gather_rows_async_kernel<W, Index>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long total = (n + G - 1) / G;
  // at least 32 stages a warp, so that the ring's fill is a small share
  long long blocks = ((total + 31) / 32 + warps - 1) / warps;
  const long long most = (long long)sm_count() * 16;
  blocks = blocks < 1 ? 1 : (blocks > most ? most : blocks);
  const long long per_warp = (total + blocks * warps - 1) / (blocks * warps);
  kernel<<<(unsigned)blocks, warps * 32, smem, s>>>(
      static_cast<const unsigned char*>(table),
      static_cast<const Index*>(idx), static_cast<unsigned char*>(out), rows,
      n, U, G, stage_bytes, per_warp);
  return (int)cudaGetLastError();
}

template <int W, typename Index>
int launch_smem(const void* table, const void* idx, void* out, long long rows,
                long long n, int row_bytes, cudaStream_t s) {
  const int U = row_bytes / W;
  const size_t smem = ((size_t)rows * row_bytes + 15) / 16 * 16;
  if (smem > kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  auto kernel = gather_rows_smem_kernel<W, Index>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long chunks = (n + kChunk - 1) / kChunk;
  const long long sms = sm_count();
  const unsigned blocks = (unsigned)(chunks < sms ? chunks : sms);
  kernel<<<blocks, kSmemThreads, smem, s>>>(
      static_cast<const unsigned char*>(table),
      static_cast<const Index*>(idx), static_cast<unsigned char*>(out), rows,
      n, U);
  return (int)cudaGetLastError();
}

#define GATHER_DISPATCH(fn)                                                  \
  if (idx_bytes == 4) {                                                      \
    if (unit_bytes == 16) return fn<16, int32_t>(table, idx, out, rows, n,   \
                                                 row_bytes, s);              \
    if (unit_bytes == 8) return fn<8, int32_t>(table, idx, out, rows, n,     \
                                               row_bytes, s);                \
    if (unit_bytes == 4) return fn<4, int32_t>(table, idx, out, rows, n,     \
                                               row_bytes, s);                \
    if (unit_bytes == 2) return fn<2, int32_t>(table, idx, out, rows, n,     \
                                               row_bytes, s);                \
  } else if (idx_bytes == 8) {                                               \
    if (unit_bytes == 16) return fn<16, int64_t>(table, idx, out, rows, n,   \
                                                 row_bytes, s);              \
    if (unit_bytes == 8) return fn<8, int64_t>(table, idx, out, rows, n,     \
                                               row_bytes, s);                \
    if (unit_bytes == 4) return fn<4, int64_t>(table, idx, out, rows, n,     \
                                               row_bytes, s);                \
    if (unit_bytes == 2) return fn<2, int64_t>(table, idx, out, rows, n,     \
                                               row_bytes, s);                \
  }                                                                          \
  return (int)cudaErrorInvalidValue;

bool bad_shape(long long rows, long long n, int row_bytes, int unit_bytes) {
  return rows <= 0 || n < 0 || row_bytes <= 0 || unit_bytes <= 0 ||
         row_bytes % unit_bytes != 0;
}

}  // namespace

// table: (rows, row_bytes) bytes; idx: n indices of idx_bytes (4 or 8) each;
// out: (n, row_bytes) bytes.  unit_bytes (16, 8, 4 or 2) divides row_bytes and
// the three base addresses.
extern "C" int gather_rows_async_launch(const void* table, const void* idx,
                                        void* out, long long rows,
                                        long long n, int row_bytes,
                                        int unit_bytes, int idx_bytes,
                                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bad_shape(rows, n, row_bytes, unit_bytes))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  GATHER_DISPATCH(launch_async)
}

extern "C" int gather_rows_smem_launch(const void* table, const void* idx,
                                       void* out, long long rows, long long n,
                                       int row_bytes, int unit_bytes,
                                       int idx_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bad_shape(rows, n, row_bytes, unit_bytes))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  GATHER_DISPATCH(launch_smem)
}
