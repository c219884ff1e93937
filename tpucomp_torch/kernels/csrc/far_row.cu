// The full-row doubling level of copy resolution for rows wider than a
// block's shared memory holds (Xpress Huffman's 64 KiB blocks), every
// round in one launch, one block per row.
//
// Replaces: tpucomp/kernels/gather_pallas.py gather18_pairs (_g18_kernel,
// the pair-packed one-hot MXU gather) together with the round loop it
// drives at common._far_rounds's last level, _far_level_segmented(out, U,
// U): at most bitlen(U - 1) + 3 rounds (19 at U = 65536), then the tags
// left are zeroed (common.py:1530-1531).  State and chase rule are those
// of far_level.cu with one segment per row (base 0).
//
// The rounds are synchronous, as tpucomp's are: every read of round r
// sees the state after round r - 1, so the state after the level equals
// tpucomp's.  tpucomp's loop stops when no row of the batch has a live
// tag; here each row stops on its own, which changes nothing (a round on
// a row with no live tag leaves it as it was).
//
// What bounds it on the card: the state of one row (256 KiB at U = 65536)
// does not fit a block's 227 KiB of shared memory, so it lives in device
// memory, double-buffered between the output and a scratch tensor of the
// wrapper's, and every round reads and writes the whole row there (the
// gathers mostly hit L2).  A round is one pass that writes the next state
// and notes whether it still has a live tag; __syncthreads_or both orders
// the pass and answers whether another round is needed.  Rows converge in
// a few rounds, so the cap is rarely reached.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FAR_TAG = 1 << 24;
constexpr int THREADS = 1024;

__device__ __forceinline__ bool live_in_row(int s, int U) {
  return (s >> 17) == 1 && (s & 0x1FFFF) < U;
}

// out and scratch are read and written by other threads of the block
// between barriers: plain pointers, so the loads stay coherent
__global__ void __launch_bounds__(THREADS)
far_row_kernel(const int32_t* __restrict__ in, int32_t* out,
               int32_t* scratch, int U, int cap) {
  const int32_t* row_in = in + (size_t)blockIdx.x * U;
  int32_t* cur = out + (size_t)blockIdx.x * U;
  int32_t* nxt = scratch + (size_t)blockIdx.x * U;
  int32_t* const res = cur;

  int any = 0;
  for (int j = threadIdx.x; j < U; j += THREADS) {
    const int v = row_in[j];
    const int s =
        (v & FAR_TAG) ? ((1 << 17) | (v & (FAR_TAG - 1))) : (v & 0x1FF);
    cur[j] = s;
    any |= live_in_row(s, U);
  }
  for (int r = 0; r < cap; ++r) {
    // orders the last pass's writes before this pass's reads
    if (!__syncthreads_or(any)) break;
    any = 0;
    for (int j = threadIdx.x; j < U; j += THREADS) {
      int s = cur[j];
      if (live_in_row(s, U)) s = cur[s & 0x1FFFF] & 0x3FFFF;
      nxt[j] = s;
      any |= live_in_row(s, U);
    }
    int32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // the last round may still be reading res as its gather table
  __syncthreads();
  for (int j = threadIdx.x; j < U; j += THREADS) {
    const int s = cur[j];
    // tags left after the round cap (only corrupt, cyclic streams): zero
    res[j] = (s >> 17) == 1 ? 0 : (s & 0x1FF);
  }
}

}  // namespace

extern "C" int far_row(const void* in, void* out, void* scratch, int n,
                       int U, int cap, void* stream) {
  far_row_kernel<<<n, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, (int32_t*)scratch, U, cap);
  return (int)cudaGetLastError();
}
