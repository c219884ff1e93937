// The far level of copy resolution: pointer doubling over whole 4096-byte
// rows, every round in one launch, one block per row.
//
// Replaces: tpucomp/kernels/gather_pallas.py gather18_stacked (_g18s_kernel,
// the one-hot MXU gather of each round) together with the round loop of
// common._far_level_segmented that drives it, as common._far_rounds runs
// them for LZNT1: U = S = 4096, at most bitlen(4095) + 3 = 15 rounds,
// leftover tags zeroed.  The state is 18 bits per position: a byte, or
// (1 << 17) | src.  A round sets st[j] = st[src] & 0x3FFFF wherever a tag
// is live and its source lies in the row; a fetched tag is the target's
// own pointer, so every chain halves.
//
// tpucomp's while_loop tests "any live tag" over the whole batch; here
// each row stops on its own.  A round on a row with no live tag changes
// nothing in it, so the results are identical.
//
// What bounds it on the card: one 16 KiB row of state per block, read and
// written once per round; the gathers are random but stay in shared
// memory.  The design keeps the state in shared memory, double-buffered
// (32 KiB), so a round costs one barrier (__syncthreads_or, which also
// answers "any live tag?") and no device-memory traffic, and the whole
// loop costs one launch instead of 15 launches with a host sync each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int U = 4096;
constexpr int FAR_TAG = 1 << 24;
constexpr int MAX_ROUNDS = 15;  // bitlen(U - 1) + 3
constexpr int THREADS = 1024;
constexpr int PER = U / THREADS;

__global__ void __launch_bounds__(THREADS)
far_level_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out) {
  __shared__ int32_t buf[2][U];
  int32_t* cur = buf[0];
  int32_t* nxt = buf[1];
  const int32_t* row_in = in + (size_t)blockIdx.x * U;
  int32_t* row_out = out + (size_t)blockIdx.x * U;

  for (int k = 0; k < PER; ++k) {
    const int j = threadIdx.x + k * THREADS;
    const int v = row_in[j];
    cur[j] = (v & FAR_TAG) ? ((1 << 17) | (v & (FAR_TAG - 1))) : (v & 0x1FF);
  }
  for (int r = 0; r < MAX_ROUNDS; ++r) {
    // each thread tests only its own positions, which it wrote itself
    bool chase[PER];
    int any = 0;
    for (int k = 0; k < PER; ++k) {
      const int s = cur[threadIdx.x + k * THREADS];
      chase[k] = (s >> 17) == 1 && (s & 0x1FFFF) < U;
      any |= chase[k];
    }
    // the barrier also orders the last round's writes before these reads
    if (!__syncthreads_or(any)) break;
    for (int k = 0; k < PER; ++k) {
      const int j = threadIdx.x + k * THREADS;
      const int s = cur[j];
      // chase keeps the source inside the row: the gather never reads
      // out of range here
      nxt[j] = chase[k] ? (cur[s & 0x1FFFF] & 0x3FFFF) : s;
    }
    int32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int k = 0; k < PER; ++k) {
    const int j = threadIdx.x + k * THREADS;
    const int s = cur[j];
    const int res = (s >> 17) == 1 ? (FAR_TAG | (s & 0x1FFFF)) : (s & 0x1FF);
    // tags left after the round cap (only corrupt, cyclic streams): zero
    row_out[j] = (res & FAR_TAG) ? 0 : res;
  }
}

}  // namespace

extern "C" int far_level(const void* in, void* out, int n, void* stream) {
  far_level_kernel<<<n, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out);
  return (int)cudaGetLastError();
}
