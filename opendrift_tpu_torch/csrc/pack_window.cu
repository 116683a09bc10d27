// A forcing window's row tables assembled on the card from the reader's
// resident frames (ops/pack.py pack_window, fields/grid.py device_state).
//
// Replaces no Pallas kernel: the JAX package packs its tables on the host
// (fields/grid.py _pack_member there) and copies them whole.  It is a
// kernel of the port because a window's tables are some 30 times the bytes
// of the frames that are new in it: each window the host would reshuffle
// and copy ~281 MB (NorKyst800, 16 levels, 300 x 260 cells, u and v at
// three frames, 'xy' pairs) where one new u and one new v frame, ~10 MB,
// is all that changed.
//
// The layout (the plain version: ops/pack.py assemble_rows_plain).  A table
// of base columns c < Cb over M members is (M*Z*ny*nx, Cb*k): row
// ((m*Z + z)*ny + y)*nx + x, column b*Cb + c holds base column c of member
// m at the cell shifted by variant b: x+1 where b & 1, y+1 where b & 2,
// z+1 where b & 4, each clamped to the last cell, plane or row (k is 1,
// 2, 4 or 8 for the pair modes 'none', 'x', 'xy', 'xyz').  Base column c
// of member m reads the float32 frame src[m*Cb + c], with plane stride
// zs[m*Cb + c]: ny*nx for a 3D frame of at least Z planes, 0 for a 2D frame
// that every plane shares.  Values are copied, or rounded to nearest even
// for a float16 table (__float2half_rn, as numpy's astype rounds).
//
// What bounds it on an H100: the bytes it writes (281 MB a window in the
// benchmark's forecast, 84 us at 3.35 TB/s); the frames it reads are ~30 MB
// and are read k times each, from L1 and L2 after the first.  So the design
// is one thread a 16-byte vector of a row (a 128-byte float32 row of the
// 'xy' table is 8 lanes, a whole row stored by neighbouring lanes), rows of
// one plane side by side in a block, one block row of the grid per
// (table, member, plane), no shared memory.  A thread's source pointers and
// strides are the same for every row of its lane, so they come through L1
// as broadcasts.  Both tables of a window (the full one and the narrow u/v
// companion) are written by one launch.
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Job {
  void* out;               // (M*Z*ny*nx, Cb*k) of the table's type
  const long long* src;    // M*Cb frame pointers, then M*Cb plane strides
  int cb;                  // base columns
  int lanes;               // vectors a row: Cb*k / V
  int rows;                // rows a block: max(1, kThreads / lanes)
  int lanes_pass;          // lanes a thread steps by: min(lanes, kThreads)
};

struct Params {
  Job job[2];
  int njobs, M, Z, ny, nx, k;
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T>
__device__ __forceinline__ T convert(float f);
template <>
__device__ __forceinline__ float convert<float>(float f) { return f; }
template <>
__device__ __forceinline__ __half convert<__half>(float f) {
  return __float2half_rn(f);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    pack_window_kernel(const Params p) {
  const int MZ = p.M * p.Z;
  const int j = blockIdx.y / MZ;
  const Job job = j == 0 ? p.job[0] : p.job[1];
  const int mz = blockIdx.y - j * MZ;
  const int m = mz / p.Z;
  const int z = mz - m * p.Z;
  const int xl = threadIdx.x / job.lanes_pass;
  if (xl >= job.rows) return;
  const int cell = blockIdx.x * job.rows + xl;       // y*nx + x of the plane
  if (cell >= p.ny * p.nx) return;
  const int y = cell / p.nx;
  const int x = cell - y * p.nx;
  const int x1 = min(x + 1, p.nx - 1);
  const int y1 = min(y + 1, p.ny - 1);
  const int z1 = min(z + 1, p.Z - 1);
  const int cf = job.cb * p.k;
  T* out = static_cast<T*>(job.out) +
           ((long long)mz * p.ny * p.nx + cell) * cf;
  const long long* ptrs = job.src + (long long)m * job.cb;
  const long long* zs = job.src + (long long)(p.M + m) * job.cb;
  for (int lane = threadIdx.x - xl * job.lanes_pass; lane < job.lanes;
       lane += job.lanes_pass) {
    const int col = lane * V;
    int b = col / job.cb;
    int c = col - b * job.cb;
    Vec<T, V> vec;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float* src = reinterpret_cast<const float*>(__ldg(ptrs + c));
      const long long off = (long long)((b & 4) ? z1 : z) * __ldg(zs + c) +
                            (long long)((b & 2) ? y1 : y) * p.nx +
                            ((b & 1) ? x1 : x);
      vec.v[i] = convert<T>(__ldg(src + off));
      if (++c == job.cb) {
        c = 0;
        ++b;
      }
    }
    *reinterpret_cast<Vec<T, V>*>(out + col) = vec;
  }
}

template <typename T, int V>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  long long blocks_x = 0;
  const long long cells = (long long)p.ny * p.nx;
  for (int j = 0; j < p.njobs; ++j) {
    const long long b = (cells + p.job[j].rows - 1) / p.job[j].rows;
    if (b > blocks_x) blocks_x = b;
  }
  const long long blocks_y = (long long)p.njobs * p.M * p.Z;
  if (blocks_x > 0x7FFFFFFFll || blocks_y > 65535)
    return cudaErrorInvalidConfiguration;
  pack_window_kernel<T, V><<<dim3((unsigned)blocks_x, (unsigned)blocks_y),
                             kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

Job make_job(void* out, const long long* src, int cb, int k, int vec) {
  Job job;
  job.out = out;
  job.src = src;
  job.cb = cb;
  job.lanes = cb * k / vec;
  job.lanes_pass = job.lanes < kThreads ? job.lanes : kThreads;
  job.rows = job.lanes < kThreads ? kThreads / job.lanes : 1;
  return job;
}

}  // namespace

// Writes one or two tables (njobs) of a window in one launch.  half: 0 for
// float32 tables, 1 for float16; vec: the elements a thread stores at once
// (1, 2, 4, or 8 for float16), which must divide both tables' Cb*k, with
// the outputs aligned to vec elements.  Returns a cudaError_t.
extern "C" int pack_window_launch(int half, int vec, int njobs, void* out0,
                                  const long long* src0, int cb0, void* out1,
                                  const long long* src1, int cb1, int M,
                                  int Z, int ny, int nx, int k, void* stream) {
  if (njobs < 1 || njobs > 2 || M < 1 || Z < 1 || ny < 1 || nx < 1 ||
      (k != 1 && k != 2 && k != 4 && k != 8) || cb0 < 1 ||
      (njobs == 2 && cb1 < 1))
    return (int)cudaErrorInvalidValue;
  if ((long long)ny * nx > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  Params p;
  p.njobs = njobs;
  p.M = M;
  p.Z = Z;
  p.ny = ny;
  p.nx = nx;
  p.k = k;
  p.job[0] = make_job(out0, src0, cb0, k, vec);
  p.job[1] = njobs == 2 ? make_job(out1, src1, cb1, k, vec) : p.job[0];
  for (int j = 0; j < njobs; ++j)
    if ((p.job[j].cb * k) % vec != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc;
  if (half) {
    switch (vec) {
      case 8: rc = launch<__half, 8>(p, s); break;
      case 4: rc = launch<__half, 4>(p, s); break;
      case 2: rc = launch<__half, 2>(p, s); break;
      case 1: rc = launch<__half, 1>(p, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (vec) {
      case 4: rc = launch<float, 4>(p, s); break;
      case 2: rc = launch<float, 2>(p, s); break;
      case 1: rc = launch<float, 1>(p, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)rc;
}
