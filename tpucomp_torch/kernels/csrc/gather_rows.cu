// Row gather: out[n, q] = data[n, idx[n, q]] & mask, 0 where idx[n, q]
// lies outside [0, K).
//
// Replaces: tpucomp/kernels/gather_pallas.py gather_rows_fused (_kernel,
// the one-hot MXU matmul over bf16 byte planes with a lane select) and
// the XLA form it stands for, common.mxu_gather_rows (common.py:863).
// Both assemble whole byte planes, ceil(nbits / 8) of them and at most 4,
// so the value keeps 8 * planes bits (24 at nbits = 20); the wrapper
// passes that mask, -1 for all 32 bits.  An index outside the table reads
// 0: negative ones and those at or past K.
//
// What bounds it on the card: device memory, the index and output planes
// read and written once.  One thread a query, QPB consecutive queries of
// one row a block.  A table of at most SMEM_MAX_K entries (48 KiB, the
// shared memory a block gets without opting in) is staged in shared
// memory once per block; a wider one is read through the read-only cache.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int QPB = THREADS * 8;  // queries of one row per block
constexpr int SMEM_MAX_K = 12288;

template <bool kShared>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const int32_t* __restrict__ data,
                   const int32_t* __restrict__ idx,
                   int32_t* __restrict__ out, int K, int Q, int chunks,
                   int32_t mask) {
  extern __shared__ int32_t tab[];
  const int row = blockIdx.x / chunks;
  const int q0 = (blockIdx.x - row * chunks) * QPB;
  const int32_t* const drow = data + (size_t)row * K;
  if (kShared) {
    for (int k = threadIdx.x; k < K; k += THREADS) tab[k] = drow[k];
    __syncthreads();
  }
  const int32_t* const irow = idx + (size_t)row * Q;
  int32_t* const orow = out + (size_t)row * Q;
  const int q1 = min(Q, q0 + QPB);
  for (int q = q0 + threadIdx.x; q < q1; q += THREADS) {
    const int i = irow[q];
    int32_t v = 0;
    if ((unsigned)i < (unsigned)K) v = (kShared ? tab[i] : __ldg(drow + i)) & mask;
    orow[q] = v;
  }
}

}  // namespace

extern "C" int gather_rows(const void* data, const void* idx, void* out,
                           int n, int K, int Q, int mask, void* stream) {
  const int chunks = (Q + QPB - 1) / QPB;
  const dim3 grid((unsigned)n * chunks);
  if (K <= SMEM_MAX_K) {
    gather_rows_kernel<true><<<grid, THREADS, K * sizeof(int32_t),
                               (cudaStream_t)stream>>>(
        (const int32_t*)data, (const int32_t*)idx, (int32_t*)out, K, Q,
        chunks, mask);
  } else {
    gather_rows_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)data, (const int32_t*)idx, (int32_t*)out, K, Q,
        chunks, mask);
  }
  return (int)cudaGetLastError();
}
