// A doubling level of copy resolution over segments of S <= 4096 bytes,
// every round in one launch, one block per segment.
//
// Replaces: tpucomp/kernels/gather_pallas.py gather18_stacked (_g18s_kernel,
// the one-hot MXU gather of each round) together with the round loop of
// common._far_level_segmented(out, U, S, cap) that drives it.  Two levels
// of common._far_rounds run here: LZNT1's full row (U = S = 4096, cap 15,
// leftover tags zeroed) and the 4 KiB segment level inside the 64 KiB rows
// of the batched decodes and the 131072-wide [history | block] rows of the
// one-shot Xpress Huffman decode (S = 4096, base = (segment % (U / S)) *
// S < 2^17, cap 6, leftover tags kept for the next level).
//
// The state is 18 bits per position, absolute: a byte, or (1 << 17) | src.
// A round sets st[j] = st[src] & 0x3FFFF wherever a tag is live and base
// <= src < base + S (common.py:1733-1741); a fetched tag is the target's
// own pointer, so every chain halves.  A fetched tag whose source lies
// outside the segment is adopted: it stays in the state and this level
// does not chase it.
//
// tpucomp's while_loop tests "any live local tag" over the whole batch
// and stops at the cap; here each segment stops on its own.  A round on a
// segment with no live local tag changes nothing in it, and both forms
// share the cap, so the results are identical.
//
// What bounds it on the card: one S * 4-byte segment of state per block,
// read and written once per round; the gathers are random but stay in
// shared memory.  The design keeps the state in shared memory,
// double-buffered (32 KiB at S = 4096), so a round costs one barrier
// (__syncthreads_or, which also answers "any live tag?") and no
// device-memory traffic, and the whole loop costs one launch instead of
// one launch and a host sync per round.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_S = 4096;
constexpr int FAR_TAG = 1 << 24;
constexpr int THREADS = 1024;
constexpr int PER = MAX_S / THREADS;

// SEG > 0 fixes the segment width at compile time (4096, the width both
// decoders use), so that every position loop has a fixed trip count and
// no bounds test; SEG == 0 takes the width from S_arg.
template <int SEG>
__global__ void __launch_bounds__(THREADS)
far_level_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                 int S_arg, int row_segs, int cap, int zero) {
  constexpr bool FIXED = SEG > 0;
  const int S = FIXED ? SEG : S_arg;
  __shared__ int32_t buf[2][MAX_S];
  int32_t* cur = buf[0];
  int32_t* nxt = buf[1];
  const int32_t* seg_in = in + (size_t)blockIdx.x * S;
  int32_t* seg_out = out + (size_t)blockIdx.x * S;
  const int base = row_segs == 1 ? 0 : (int)(blockIdx.x % row_segs) * S;

#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = threadIdx.x + k * THREADS;
    if (!FIXED && j >= S) break;
    const int v = seg_in[j];
    cur[j] = (v & FAR_TAG) ? ((1 << 17) | (v & (FAR_TAG - 1))) : (v & 0x1FF);
  }
  for (int r = 0; r < cap; ++r) {
    // each thread tests only its own positions, which it wrote itself
    bool chase[PER];
    int any = 0;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = threadIdx.x + k * THREADS;
      const int s = (FIXED || j < S) ? cur[j] : 0;
      // base <= src < base + S, as one unsigned compare
      chase[k] = (s >> 17) == 1 &&
                 (unsigned)((s & 0x1FFFF) - base) < (unsigned)S;
      any |= chase[k];
    }
    // the barrier also orders the last round's writes before these reads
    if (!__syncthreads_or(any)) break;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = threadIdx.x + k * THREADS;
      if (!FIXED && j >= S) break;
      const int s = cur[j];
      // chase keeps the source inside the segment: the gather never
      // reads out of range here
      nxt[j] = chase[k] ? (cur[(s & 0x1FFFF) - base] & 0x3FFFF) : s;
    }
    int32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = threadIdx.x + k * THREADS;
    if (!FIXED && j >= S) break;
    const int s = cur[j];
    const int res = (s >> 17) == 1 ? (FAR_TAG | (s & 0x1FFFF)) : (s & 0x1FF);
    // tags left after the round cap; on the last level (only corrupt,
    // cyclic streams) they become 0
    seg_out[j] = (zero && (res & FAR_TAG)) ? 0 : res;
  }
}

}  // namespace

extern "C" int far_level(const void* in, void* out, int nsegs, int S,
                         int row_segs, int cap, int zero, void* stream) {
  if (S <= 0 || S > MAX_S) return (int)cudaErrorInvalidValue;
  if (S == MAX_S)
    far_level_kernel<MAX_S><<<nsegs, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)in, (int32_t*)out, S, row_segs, cap, zero);
  else
    far_level_kernel<0><<<nsegs, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)in, (int32_t*)out, S, row_segs, cap, zero);
  return (int)cudaGetLastError();
}
