// Row sort: each row ascending by a unique int32 key, payload planes
// permuted along.
//
// Replaces: tpucomp/kernels/sort_pallas.py bitonic_sort_rows
// (_build_kernel), a bitonic network over VMEM-resident rows that moves
// every payload plane through every one of its 78 compare-exchange stages
// (at U = 4096), because the TPU has no gather.  Here only the key and
// its column index go through the network; the payload planes are then
// gathered once through the sorted column index.
//
// Rows of a power of two up to 16384 (sort_rows): one block per row.  A
// row's 8 B x U (key, column) pairs stay in shared memory for all stages
// (128 KiB at 16384), so device memory sees each key once each way, and
// each payload value is read once (a gather within its row, which the L1
// and L2 serve) and written once, coalesced.  The network is 78 stages of
// U/2 compare-exchanges at 4096 with a __syncthreads() between stages,
// the same for any data; at 78 barriers a block and 2 blocks an SM the
// network, not device memory, sets its time.
//
// Wider rows, up to 65536, and widths that are not a power of two
// (sort_rows_tiled): a row's pairs (512 KiB at 65536) do not fit one
// block's 227 KiB.  The row is padded in the network to a power of two
// Up with (INT32_MAX, column) pairs, compared as (key, column) so that
// padding sorts after every real key, and cut into tiles of T = 16384
// pairs (or Up, when smaller).  Stages whose stride is below T run in a
// tile's shared memory: the first kernel sorts every tile through all
// stages up to k = T; for each k above T, the stages of stride >= T are
// one pass each over device memory (a thread per pair) and the rest one
// tile merge.  At 65536: one tile sort, three device-memory passes and
// two tile merges, each reading and writing the 8-byte pairs once, then
// the gather.  (A thread-block cluster holding the row in distributed
// shared memory would save the device-memory passes; this first form
// keeps to plain blocks.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXP = 16;  // payload planes per launch
constexpr int MAX_THREADS = 1024;

struct Planes {
  const int32_t* in[MAXP];
  int32_t* out[MAXP];
};

__global__ void __launch_bounds__(MAX_THREADS)
sort_rows_kernel(const int32_t* __restrict__ key_in,
                 int32_t* __restrict__ key_out, Planes planes, int P, int U) {
  extern __shared__ int32_t smem[];
  int32_t* sk = smem;      // keys
  int32_t* sc = smem + U;  // their columns
  const size_t row = (size_t)blockIdx.x * U;
  for (int i = threadIdx.x; i < U; i += blockDim.x) {
    sk[i] = key_in[row + i];
    sc[i] = i;
  }
  __syncthreads();
  const int half = U >> 1;
  for (int k = 2; k <= U; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = 2 * t - (t & (j - 1));  // low lane of pair t
        const int l = i + j;
        const bool ascending = (i & k) == 0;
        const int a = sk[i], b = sk[l];
        if ((a > b) == ascending) {
          sk[i] = b;
          sk[l] = a;
          const int c = sc[i];
          sc[i] = sc[l];
          sc[l] = c;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < U; i += blockDim.x) key_out[row + i] = sk[i];
  for (int p = 0; p < P; ++p) {
    const int32_t* in = planes.in[p] + row;
    int32_t* out = planes.out[p] + row;
    for (int i = threadIdx.x; i < U; i += blockDim.x) out[i] = in[sc[i]];
  }
}


constexpr int TILE = 1 << 14;  // pairs of a tile in shared memory: 128 KiB
constexpr int32_t PAD_KEY = 0x7FFFFFFF;

// (key, column) order: columns are unique, so this is a total order, and
// the padding (column >= U) goes after a real INT32_MAX key
__device__ __forceinline__ bool after(int32_t ka, int32_t ca, int32_t kb,
                                      int32_t cb) {
  return ka > kb || (ka == kb && ca > cb);
}

// The stages k = k0 .. kmax (doubling) and, for each, strides j < T down
// to 1, on the tile's pairs in shared memory; direction by the pair's
// index in the row, gi = tile * T + i.
__device__ void tile_stages(int32_t* sk, int32_t* sc, int T, size_t base,
                            int k0, int kmax, int jmax) {
  for (int k = k0; k <= kmax; k <<= 1) {
    for (int j = min(k, jmax) >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < T / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (j - 1));
        const int l = i + j;
        const bool ascending = ((base + i) & k) == 0;
        const int32_t ka = sk[i], kb = sk[l], ca = sc[i], cb = sc[l];
        if (after(ka, ca, kb, cb) == ascending) {
          sk[i] = kb;
          sk[l] = ka;
          sc[i] = cb;
          sc[l] = ca;
        }
      }
      __syncthreads();
    }
  }
}

// grid (n, Up / T): load a tile of the row (padding past U), sort it
// through every stage k <= T, store the pairs.
__global__ void __launch_bounds__(MAX_THREADS)
tile_sort_kernel(const int32_t* __restrict__ key_in, int32_t* __restrict__ ks,
                 int32_t* __restrict__ cs, int U, int Up, int T) {
  extern __shared__ int32_t smem[];
  int32_t* sk = smem;
  int32_t* sc = smem + T;
  const size_t base = (size_t)blockIdx.y * T;
  const size_t row = (size_t)blockIdx.x;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const size_t c = base + i;
    sk[i] = c < (size_t)U ? key_in[row * U + c] : PAD_KEY;
    sc[i] = (int32_t)c;
  }
  __syncthreads();
  tile_stages(sk, sc, T, base, 2, T, T);
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    ks[row * Up + base + i] = sk[i];
    cs[row * Up + base + i] = sc[i];
  }
}

// One stage (k, j), j >= T, over device memory: a thread per pair.
__global__ void global_stage_kernel(int32_t* __restrict__ ks,
                                    int32_t* __restrict__ cs, int Up, int k,
                                    int j, size_t pairs) {
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= pairs) return;
  const size_t half = (size_t)Up / 2;
  const size_t row = g / half;
  const size_t t = g % half;
  const size_t i = 2 * t - (t & (size_t)(j - 1));
  const size_t a = row * Up + i, b = a + j;
  const bool ascending = (i & (size_t)k) == 0;
  const int32_t ka = ks[a], kb = ks[b], ca = cs[a], cb = cs[b];
  if (after(ka, ca, kb, cb) == ascending) {
    ks[a] = kb;
    ks[b] = ka;
    cs[a] = cb;
    cs[b] = ca;
  }
}

// grid (n, Up / T): the strides j < T of stage k, in a tile's shared
// memory.
__global__ void __launch_bounds__(MAX_THREADS)
tile_merge_kernel(int32_t* __restrict__ ks, int32_t* __restrict__ cs, int Up,
                  int T, int k) {
  extern __shared__ int32_t smem[];
  int32_t* sk = smem;
  int32_t* sc = smem + T;
  const size_t base = (size_t)blockIdx.y * T;
  int32_t* rk = ks + (size_t)blockIdx.x * Up + base;
  int32_t* rc = cs + (size_t)blockIdx.x * Up + base;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    sk[i] = rk[i];
    sc[i] = rc[i];
  }
  __syncthreads();
  tile_stages(sk, sc, T, base, k, k, T);
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    rk[i] = sk[i];
    rc[i] = sc[i];
  }
}

// grid (n, ceil(U / 1024)): the first U sorted keys, and every payload
// plane gathered through their columns.
__global__ void finish_kernel(const int32_t* __restrict__ ks,
                              const int32_t* __restrict__ cs,
                              int32_t* __restrict__ key_out, Planes planes,
                              int P, int U, int Up) {
  const int i = blockIdx.y * blockDim.x + threadIdx.x;
  if (i >= U) return;
  const size_t row = blockIdx.x;
  const size_t src = row * Up + i;
  key_out[row * U + i] = ks[src];
  const int c = cs[src];
  for (int p = 0; p < P; ++p) {
    planes.out[p][row * U + i] = planes.in[p][row * U + c];
  }
}

}  // namespace

static Planes make_planes(const void* const* ins, void* const* outs, int P) {
  Planes planes = {};
  for (int p = 0; p < P; ++p) {
    planes.in[p] = (const int32_t*)ins[p];
    planes.out[p] = (int32_t*)outs[p];
  }
  return planes;
}

// ins, outs: host arrays of P device pointers to the payload planes.
extern "C" int sort_rows(const void* key_in, void* key_out,
                         const void* const* ins, void* const* outs, int n,
                         int U, int P, void* stream) {
  if (P < 0 || P > MAXP || U < 1 || (U & (U - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const Planes planes = make_planes(ins, outs, P);
  const size_t smem = 2 * sizeof(int32_t) * (size_t)U;
  cudaError_t e = cudaFuncSetAttribute(
      sort_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = U / 2 < 32 ? 32 : (U / 2 > MAX_THREADS ? MAX_THREADS
                                                            : U / 2);
  sort_rows_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)key_in, (int32_t*)key_out, planes, P, U);
  return (int)cudaGetLastError();
}

// Rows of any width U up to 65536: see the head of this file.  ks, cs:
// int32 [n, Up] scratch for the pairs, Up = the power of two >= U.
extern "C" int sort_rows_tiled(const void* key_in, void* key_out, void* ks,
                               void* cs, const void* const* ins,
                               void* const* outs, int n, int U, int P,
                               void* stream) {
  if (P < 0 || P > MAXP || U < 1 || U > (1 << 16)) {
    return (int)cudaErrorInvalidValue;
  }
  int Up = 1;
  while (Up < U) Up <<= 1;
  const int T = Up < TILE ? Up : TILE;
  const Planes planes = make_planes(ins, outs, P);
  const size_t smem = 2 * sizeof(int32_t) * (size_t)T;
  cudaError_t e = cudaFuncSetAttribute(
      tile_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(tile_merge_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = T / 2 < 32 ? 32 : (T / 2 > MAX_THREADS ? MAX_THREADS
                                                            : T / 2);
  const dim3 tiles(n, Up / T);
  int32_t* k32 = (int32_t*)ks;
  int32_t* c32 = (int32_t*)cs;
  tile_sort_kernel<<<tiles, threads, smem, st>>>((const int32_t*)key_in, k32,
                                                  c32, U, Up, T);
  const size_t pairs = (size_t)n * (Up / 2);
  const unsigned pair_blocks = (unsigned)((pairs + 255) / 256);
  for (int k = 2 * T; k <= Up; k <<= 1) {
    for (int j = k >> 1; j >= T; j >>= 1) {
      global_stage_kernel<<<pair_blocks, 256, 0, st>>>(k32, c32, Up, k, j,
                                                       pairs);
    }
    tile_merge_kernel<<<tiles, threads, smem, st>>>(k32, c32, Up, T, k);
  }
  finish_kernel<<<dim3(n, (U + 1023) / 1024), 1024, 0, st>>>(
      k32, c32, (int32_t*)key_out, planes, P, U, Up);
  return (int)cudaGetLastError();
}
