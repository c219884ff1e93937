// Row sort: each row ascending by a unique int32 key, payload planes
// permuted along.  One block per row.
//
// Replaces: tpucomp/kernels/sort_pallas.py bitonic_sort_rows
// (_build_kernel), a bitonic network over VMEM-resident rows that moves
// every payload plane through every one of its 78 compare-exchange stages
// (at U = 4096), because the TPU has no gather.  Here only the key and
// its column index go through the network, in shared memory; the payload
// planes are then gathered once through the sorted column index.
//
// What bounds it on the card: device memory.  The un-sort of the LZNT1
// match finder moves 2 planes in and 2 out, 538 MB at [8208, 4096]; the
// hash sort moves its key plane in and out.  A row's 8 B x U pairs stay in
// shared memory for all stages (U <= 16384: 128 KiB), so device memory
// sees each key once each way, and each payload value is read once (a
// gather within its row, which the L1 and L2 serve) and written once,
// coalesced.  The network itself is 78 stages of U/2 compare-exchanges
// with a __syncthreads() between stages, the same for any data.

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

}  // namespace

// ins, outs: host arrays of P device pointers to the payload planes.
extern "C" int sort_rows(const void* key_in, void* key_out,
                         const void* const* ins, void* const* outs, int n,
                         int U, int P, void* stream) {
  if (P < 0 || P > MAXP || U < 1 || (U & (U - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  Planes planes = {};
  for (int p = 0; p < P; ++p) {
    planes.in[p] = (const int32_t*)ins[p];
    planes.out[p] = (int32_t*)outs[p];
  }
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
