// Run matcher: for each displacement d, the length of the run of
// x[q] == x[q - d] starting at each position p (0 where p < d).  One block
// per row.
//
// Replaces: tpucomp/kernels/runs_pallas.py run_matchlens_fused
// (_build_kernel), which counts the run with a suffix-doubling recurrence
// over VMEM-resident rows, log2(U) shift rounds per displacement.  Here
// the same function is ml[p] = nxt(p) - p, where nxt(p) is the first
// q >= p with x[q] != x[q - d] (or q < d), U if there is none: a block-wide
// suffix-min scan, one pass per displacement.  Runs reach into the row's
// zero padding past a chunk's end exactly as tpucomp's do.
//
// What bounds it on the card: device memory.  A row reads U bytes once
// (into shared memory, shared by every displacement) and writes U int32
// per displacement: at [8208, 4096] and d = 1, 2, 3 that is 34 MB in and
// 403 MB out.  Each thread scans 16 contiguous positions in registers,
// the threads' segment minima meet in a warp-shuffle scan, and the
// lengths go through a padded shared-memory tile so that the stores are
// coalesced.  Rows are processed in tiles of 4096 positions from the
// right, carrying the running minimum, so any U up to 65536 fits.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER = 16;  // contiguous positions per thread
constexpr int TILE = THREADS * PER;
constexpr int STAGE_LD = PER + 1;  // padded: conflict-free staging
constexpr int MAXD = 4;

// Exclusive suffix minimum of one value per thread (over the threads
// after this one); also returns the block's minimum.  INT_MAX is the
// identity.
__device__ int block_excl_suffix_min(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_down_sync(0xFFFFFFFFu, x, off);
    if (lane + off < 32) x = min(x, y);
  }
  if (lane == 0) warp_tot[w] = x;  // the whole warp's minimum
  __syncthreads();
  if (w == 0) {
    int t = lane < WARPS ? warp_tot[lane] : INT_MAX;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_down_sync(0xFFFFFFFFu, t, off);
      if (lane + off < 32) t = min(t, y);
    }
    warp_tot[lane] = t;  // inclusive over warps >= lane
  }
  __syncthreads();
  int excl = __shfl_down_sync(0xFFFFFFFFu, x, 1);
  if (lane == 31) excl = INT_MAX;
  if (w + 1 < WARPS) excl = min(excl, warp_tot[w + 1]);
  *total = warp_tot[0];
  __syncthreads();  // warp_tot is reused by the next call
  return excl;
}

__global__ void __launch_bounds__(THREADS)
run_matchlens_kernel(const uint8_t* __restrict__ x, int32_t* __restrict__ out,
                     int N, int U, int D, int d0, int d1, int d2, int d3) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_tot[32];
  int32_t* stage = reinterpret_cast<int32_t*>(smem);  // THREADS * STAGE_LD
  uint8_t* xs = smem + THREADS * STAGE_LD * sizeof(int32_t);
  const int row = blockIdx.x;
  const uint8_t* xr = x + (size_t)row * U;
  for (int i = threadIdx.x; i < U; i += THREADS) xs[i] = xr[i];
  __syncthreads();

  const int ntiles = (U + TILE - 1) / TILE;
  for (int di = 0; di < D; ++di) {
    const int d = di == 0 ? d0 : di == 1 ? d1 : di == 2 ? d2 : d3;
    int32_t* o = out + ((size_t)di * N + row) * U;
    int carry = U;  // first break at or after the current tile's end
    for (int tile = ntiles - 1; tile >= 0; --tile) {
      const int base = tile * TILE;
      const int p0 = base + threadIdx.x * PER;
      int loc[PER];
      int m = U;
#pragma unroll
      for (int k = PER - 1; k >= 0; --k) {
        const int p = p0 + k;
        if (p < U && !(p >= d && xs[p] == xs[p - d])) m = p;
        loc[k] = m;
      }
      int total;
      const int right = min(carry, block_excl_suffix_min(m, warp_tot, &total));
#pragma unroll
      for (int k = 0; k < PER; ++k)
        stage[threadIdx.x * STAGE_LD + k] = min(loc[k], right) - (p0 + k);
      __syncthreads();
      for (int i = threadIdx.x; i < TILE && base + i < U; i += THREADS)
        o[base + i] = stage[(i / PER) * STAGE_LD + i % PER];
      __syncthreads();
      carry = min(carry, total);
    }
  }
}

}  // namespace

extern "C" int run_matchlens(const void* x, void* out, int n, int U, int D,
                             int d0, int d1, int d2, int d3, void* stream) {
  if (D < 1 || D > MAXD) return (int)cudaErrorInvalidValue;
  const size_t smem = THREADS * STAGE_LD * sizeof(int32_t) + (size_t)U;
  cudaError_t e = cudaFuncSetAttribute(
      run_matchlens_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  run_matchlens_kernel<<<n, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (int32_t*)out, n, U, D, d0, d1, d2, d3);
  return (int)cudaGetLastError();
}
