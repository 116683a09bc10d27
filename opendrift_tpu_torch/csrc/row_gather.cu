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
// is six 16-byte units and an 88-byte row eleven 8-byte ones.
//
//  * async: the TPU kernel walks its rows in order on one core.  Here every
//    warp owns a contiguous run of output rows, cut into stages, and keeps
//    a ring of stages of shared memory in flight; when the oldest stage has
//    landed it is written to `out`, where its rows are contiguous, and the
//    slot is refilled.  Two routes, chosen by the launcher from the copy
//    width and the row's bytes alone (ops/gather.py gather_route), the
//    same on every call:
//    - bulk (W = 16: the row's bytes and the table's and the output's base
//      addresses are multiples of 16; rows of kBulkMinRow bytes or more: a
//      bulk copy has a fixed cost that 16- and 32-byte rows do not repay,
//      measured slower than the ring there). The ring spends its
//      instructions on the bytes: a stage of one 352-byte row is 22 lanes
//      each issuing a 16-byte copy after a runtime division, a shuffle and
//      64-bit address arithmetic, and the row goes back through registers on
//      its way out, some 80-100 warp instructions a row, about as long as the
//      bytes take at 3.35 TB/s. Here a lane issues ONE bulk asynchronous copy
//      (cp.async.bulk, the Tensor Memory Accelerator) for each of its rows of
//      a stage of about kBulkStage bytes, completing on the slot's mbarrier,
//      and when the stage lands one lane writes it to `out` with one bulk copy
//      of the whole stage (bulk_group): registers never hold the bytes, and a
//      row costs the warp a fraction of an instruction. kBulkSlots - 1 stages
//      of loads a warp are in flight (the last slot drains its store): with 3
//      KB stages, 3 slots and 4 warps a block, 6 blocks an SM keep some 150 KB
//      of rows in flight. Many small stages beat few large ones (PERF.md:
//      16 KB stages took 1.3-2.4 times as long), as a warp refills a slot
//      only when its oldest stage lands.
//    - ring (W = 8, 4 or 2: rows of 88, 92 or 10 bytes, a view at an 8-byte
//      offset; and 16- or 32-byte rows): stages of about 512 bytes; a
//      stage's indices are loaded by its first lanes and handed round with
//      shuffles, its units copied with cp.async (cp.async has no 2-byte form:
//      such rows use plain loads into the same ring) into NBUF stages a warp;
//      a landed stage (cp.async.wait_group) goes out through registers,
//      neighbouring lanes on neighbouring addresses.
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
constexpr int kWarps = 4;           // warps a block (ring)
constexpr int kStageTarget = 512;   // bytes of rows in one stage (ring)
constexpr int kChunk = 1024;        // indices a chunk (smem), as the TPU CHUNK
constexpr int kSmemThreads = 1024;
constexpr int kMaxDynamicSmem = 232448;   // a block's limit on sm_90

// The bulk route (PERF.md has the ladder these were chosen on)
constexpr int kBulkStage = 3072;    // bytes of rows a stage
constexpr int kBulkSlots = 3;       // stages of a warp's ring
constexpr int kBulkWarps = 4;       // warps a block
constexpr int kBulkMinRow = 48;     // narrower rows take the ring
constexpr int kBulkMaxRows = 256;               // rows a stage at most
// a block's mbarriers (8 bytes each) come first, then the warps' rings
constexpr int kBulkBarrierBytes = (kBulkWarps * kBulkSlots * 8 + 127) / 128
                                  * 128;
static_assert(kBulkSlots >= 2, "a slot loads while another drains");

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

// ---- the bulk route: PTX of the Tensor Memory Accelerator's bulk copies --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

// one arrival that also announces the bytes the phase's copies will bring
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// device memory -> shared memory, completing on `bar` with its bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared memory -> device memory, in this thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               "cp.async.bulk.commit_group;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

// A warp's run is stages [first, last) of G rows each, as in the ring
// kernel; slot k of the warp's ring holds stage first + k, first + k +
// kBulkSlots, ...; its mbarrier completes one phase a use.  Lane 0 owns
// the barriers' arrivals, the stores and their bulk group.
//
// Ordering (PTX ISA, the asynchronous proxy): a bulk load's bytes are
// visible to a thread that has seen its mbarrier's phase complete; they
// are read again by the bulk store, an operation of the asynchronous
// proxy, after fence.proxy.async.  A slot is refilled only after the
// store that read it has finished reading (cp.async.bulk.wait_group.read),
// and the lanes that issue the refill learn it from __syncwarp.
template <typename Index>
__global__ void gather_rows_bulk_kernel(
    const unsigned char* __restrict__ table, const Index* __restrict__ idx,
    unsigned char* __restrict__ out, long long rows, long long n,
    int row_bytes, int G, int stage_bytes, long long stages_per_warp) {
  extern __shared__ __align__(128) unsigned char bulk_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint64_t* bars = reinterpret_cast<uint64_t*>(bulk_smem) + warp * kBulkSlots;
  unsigned char* ring = bulk_smem + kBulkBarrierBytes +
                        (size_t)warp * kBulkSlots * stage_bytes;
  const long long gwarp = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  const long long total = (n + G - 1) / G;
  const long long first = gwarp * stages_per_warp;
  long long last = first + stages_per_warp;
  if (last > total) last = total;
  if (first >= last) return;   // the whole warp leaves together
  if (lane == 0) {
    for (int k = 0; k < kBulkSlots; ++k) bar_init(bars + k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // the rows of stage s (none beyond the run) into their slot
  auto issue = [&](long long s) {
    if (s >= last) return;
    const int slot = (int)((s - first) % kBulkSlots);
    const long long row0 = s * G;
    const long long left = n - row0;
    const int valid = left < G ? (int)left : G;
    unsigned char* dst = ring + (size_t)slot * stage_bytes;
    if (lane == 0) bar_expect(bars + slot, (uint32_t)(valid * row_bytes));
    __syncwarp();
    for (int r = lane; r < valid; r += 32) {
      const long long row = clamped(idx, row0 + r, rows);
      bulk_load(dst + (size_t)r * row_bytes,
                table + (size_t)row * (size_t)row_bytes,
                (uint32_t)row_bytes, bars + slot);
    }
  };

  for (int k = 0; k < kBulkSlots - 1; ++k) issue(first + k);
  for (long long s = first; s < last; ++s) {
    if (lane == 0) {
      const long long use = (s - first) / kBulkSlots;
      const int slot = (int)((s - first) % kBulkSlots);
      const long long row0 = s * G;
      const long long left = n - row0;
      const int valid = left < G ? (int)left : G;
      bar_wait(bars + slot, (uint32_t)(use & 1));
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_store(out + (size_t)row0 * row_bytes,
                 ring + (size_t)slot * stage_bytes,
                 (uint32_t)(valid * row_bytes));
      // every store but this one has read its slot: stage s - 1's is free
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    }
    __syncwarp();
    issue(s + kBulkSlots - 1);
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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
int launch_bulk(const void* table, const void* idx, void* out,
                long long rows, long long n, int row_bytes, cudaStream_t s) {
  static_assert(W == 16, "bulk copies move whole 16-byte units");
  int G = kBulkStage / row_bytes;
  G = G < 1 ? 1 : (G > kBulkMaxRows ? kBulkMaxRows : G);
  const int stage_bytes = G * row_bytes;   // a multiple of 16
  // an mbarrier's phase counts fewer than 2^20 bytes
  if (stage_bytes >= (1 << 20)) return (int)cudaErrorInvalidValue;
  int warps = kBulkWarps;
  auto smem_of = [&](int w) {
    return (size_t)kBulkBarrierBytes + (size_t)w * kBulkSlots * stage_bytes;
  };
  while (warps > 1 && smem_of(warps) > kMaxDynamicSmem) warps /= 2;
  const size_t smem = smem_of(warps);
  if (smem > kMaxDynamicSmem) return (int)cudaErrorInvalidValue;
  auto kernel = gather_rows_bulk_kernel<Index>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long total = (n + G - 1) / G;
  // at least 8 stages a warp, so that the ring's fill is a small share; at
  // most the blocks that fit the SMs at once
  const long long per_sm =
      (long long)kMaxDynamicSmem / (long long)(smem + 1024);
  const long long most = (long long)sm_count() * (per_sm < 1 ? 1 : per_sm);
  long long blocks = ((total + 7) / 8 + warps - 1) / warps;
  blocks = blocks < 1 ? 1 : (blocks > most ? most : blocks);
  const long long per_warp = (total + blocks * warps - 1) / (blocks * warps);
  kernel<<<(unsigned)blocks, warps * 32, smem, s>>>(
      static_cast<const unsigned char*>(table),
      static_cast<const Index*>(idx), static_cast<unsigned char*>(out), rows,
      n, row_bytes, G, stage_bytes, per_warp);
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

// fn<W, Index> for the copy width W and the index type of the call
#define GATHER_CALL(fn, W)                                                   \
  if (unit_bytes == W) {                                                     \
    if (idx_bytes == 4)                                                      \
      return fn<W, int32_t>(table, idx, out, rows, n, row_bytes, s);         \
    if (idx_bytes == 8)                                                      \
      return fn<W, int64_t>(table, idx, out, rows, n, row_bytes, s);         \
  }

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
  // the route: whole 16-byte units take the bulk copies, the rest the ring
  if (row_bytes >= kBulkMinRow) {
    GATHER_CALL(launch_bulk, 16)
  }
  GATHER_CALL(launch_async, 16)
  GATHER_CALL(launch_async, 8)
  GATHER_CALL(launch_async, 4)
  GATHER_CALL(launch_async, 2)
  return (int)cudaErrorInvalidValue;
}

extern "C" int gather_rows_smem_launch(const void* table, const void* idx,
                                       void* out, long long rows, long long n,
                                       int row_bytes, int unit_bytes,
                                       int idx_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bad_shape(rows, n, row_bytes, unit_bytes))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  GATHER_CALL(launch_smem, 16)
  GATHER_CALL(launch_smem, 8)
  GATHER_CALL(launch_smem, 4)
  GATHER_CALL(launch_smem, 2)
  return (int)cudaErrorInvalidValue;
}
