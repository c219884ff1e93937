// Records -> dense per-byte planes (value mod 2^22, token position mod
// 2^17) and an overflow flag, one block per row.
//
// Replaces: tpucomp/kernels/fill_pallas.py fill_records_delta2_fused
// (_build_kernel), with the contract of common.fill_records_delta2 for any
// record count R: records with 0 <= pos < U are real, positions do not
// decrease, the last of adjacent equal positions wins; byte j takes the
// last real record with pos <= j (0 where there is none); ovf flags more
// than keep distinct real records.  tpucomp reaches that with log-depth
// compaction, delta expansion and prefix-sum passes, because the TPU has
// no scatter; here each record's slot index goes straight to its
// position with atomicMax, and a max-scan along the row carries it on.
//
// What bounds it on the card: device memory.  A row reads its R records
// and writes U bytes of each plane, plus U slot indices written and read
// once; the atomics land in distinct words (positions are distinct but
// for adjacent runs).  One 1024-thread block per row keeps the row's scan
// inside the block; the slot indices live in the pos output itself, each
// read by the thread that overwrites it, so no scratch is needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int PER = 4;  // consecutive bytes per thread per tile
constexpr int V_MASK = (1 << 22) - 1;
constexpr int P_MASK = (1 << 17) - 1;

// Exclusive max-scan of one value per thread across the block; also
// returns the block's maximum.  -1 is the identity (no record).
__device__ int block_excl_max(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, off);
    if (lane >= off) x = max(x, y);
  }
  if (lane == 31) warp_tot[w] = x;
  __syncthreads();
  if (w == 0) {
    int t = lane < WARPS ? warp_tot[lane] : -1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, t, off);
      if (lane >= off) t = max(t, y);
    }
    warp_tot[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  int excl = __shfl_up_sync(0xFFFFFFFFu, x, 1);
  if (lane == 0) excl = -1;
  if (w > 0) excl = max(excl, warp_tot[w - 1]);
  *total = warp_tot[WARPS - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return excl;
}

__global__ void __launch_bounds__(THREADS)
fill_records_kernel(const int32_t* __restrict__ rec_pos,
                    const int32_t* __restrict__ rec_val,
                    int32_t* __restrict__ val_out, int32_t* pos_out,
                    int32_t* __restrict__ ovf, int R, int U, int keep) {
  __shared__ int warp_tot[WARPS];
  __shared__ int n_distinct;
  const int row = blockIdx.x;
  const int32_t* rp = rec_pos + (size_t)row * R;
  const int32_t* rv = rec_val + (size_t)row * R;
  int32_t* vo = val_out + (size_t)row * U;
  int32_t* last = pos_out + (size_t)row * U;  // slot indices, then pos

  if (threadIdx.x == 0) n_distinct = 0;
  for (int j = threadIdx.x; j < U; j += THREADS) last[j] = -1;
  __syncthreads();
  int distinct = 0;
  for (int i = threadIdx.x; i < R; i += THREADS) {
    const int p = rp[i];
    if (p < 0 || p >= U) continue;
    atomicMax(&last[p], i);
    // the last of an adjacent run of one position counts once
    distinct += !(i + 1 < R && rp[i + 1] == p);
  }
  atomicAdd(&n_distinct, distinct);
  __syncthreads();
  if (threadIdx.x == 0) ovf[row] = n_distinct > keep ? 1 : 0;

  int carry = -1;
  for (int base = 0; base < U; base += THREADS * PER) {
    const int j0 = base + threadIdx.x * PER;
    int run[PER];
    int m = -1;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      m = max(m, j0 + k < U ? last[j0 + k] : -1);
      run[k] = m;
    }
    int total;
    const int before = max(carry, block_excl_max(m, warp_tot, &total));
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = j0 + k;
      if (j >= U) break;
      const int s = max(before, run[k]);
      vo[j] = s >= 0 ? (rv[s] & V_MASK) : 0;
      last[j] = s >= 0 ? (rp[s] & P_MASK) : 0;
    }
    carry = max(carry, total);
  }
}

}  // namespace

extern "C" int fill_records(const void* rec_pos, const void* rec_val,
                            void* val_out, void* pos_out, void* ovf, int n,
                            int R, int U, int keep, void* stream) {
  fill_records_kernel<<<n, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rec_pos, (const int32_t*)rec_val, (int32_t*)val_out,
      (int32_t*)pos_out, (int32_t*)ovf, R, U, keep);
  return (int)cudaGetLastError();
}
