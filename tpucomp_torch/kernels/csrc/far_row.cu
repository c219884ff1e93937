// The full-row doubling level of copy resolution for rows wider than a
// block's shared memory holds (Xpress Huffman's and plain Xpress's 64 KiB
// blocks, and the one-shot Xpress Huffman decode's [64 KiB history |
// block] rows of 131072), one block a row, as an in-order sweep over the
// row's chunks.
//
// Replaces: tpucomp/kernels/gather_pallas.py gather18_pairs (_g18_kernel,
// the pair-packed one-hot MXU gather) together with the round loop it
// drives at common._far_rounds's last level, _far_level_segmented(out, U,
// U): at most bitlen(U - 1) + 3 rounds (19 at U = 65536, 20 at 131072),
// then the tags left are zeroed (common.py:1530-1531).  U is at most
// 2^17: every source fits the state's 17 bits.  State and chase rule are those
// of far_level.cu with one segment per row (base 0): a position's state
// is a byte, or (1 << 17) | src, live when bits 17 and up are exactly 1
// and src < U; a round sets every live state to its source's state,
// masked to 18 bits.
//
// What the rounds compute: the cap is more hops than any chain without a
// cycle has, so a live position ends with the value its chain ends at (a
// byte; 0 for a dead tag, src >= U) and a position on a cycle, or on a
// chain into one, ends at 0.  Any schedule that follows every chain to
// its end gives the same bytes.  Real decode states point backward
// (src = j - disp, disp >= 1, clamped to 0), and so do the pointers the
// 4 KiB level adopts and the probes keep.
//
// Design, one block a row:
// 1. Sweep.  The row's chunks of CHUNK positions go from left to right.
//    Each chunk's input is staged into shared memory with cp.async
//    (16-byte copies; 4-byte ones when a row is not 16-byte aligned, as
//    when U % 4 != 0), NBUF - 1 chunks ahead of the one that resolves.
//    Each thread owns the 4 positions of a chunk that it copies.  A live
//    tag whose source lies in an earlier chunk takes out[src], which is
//    final: those chunks are written, and a final value is its chain's
//    end.  Tags that point inside the chunk (none in real rows after the
//    4 KiB level) then resolve by pointer doubling in shared memory, all
//    reads of a round before its writes; a chain inside the chunk has at
//    most CHUNK - 1 hops, so CHUNK_ROUNDS rounds resolve every one without
//    a cycle, and what is still live after them is on a cycle: 0.  The
//    chunk goes out with 16-byte stores.  The row is read once and
//    written once; only tagged positions gather, mostly from L2.
// 2. Classify while sweeping.  A row is swept only while each chunk, as
//    it is staged, holds no live tag whose source lies past the chunk's
//    end, and no tag with state bits above 17 set (those stay tags in
//    place, byte = their low 9 bits, but a position chasing one adopts
//    its low 17 bits as a new pointer, which out[] cannot give).  One
//    block-wide OR per chunk decides.  At the first chunk that fails, the
//    row drops the sweep and runs the rounds themselves (3.) from `in`,
//    which the sweep never writes.  Real rows never fail.
// 3. Round loop, for the other rows (synthetic states only): the level's
//    rounds, synchronous as tpucomp's are, every read of round r seeing
//    the state after round r - 1, with the state in device memory (256
//    KiB a row at U = 65536, 512 KiB at 131072, past a block's shared
//    memory) ping-ponging between the output and the wrapper's scratch
//    tensor; a row stops when it has no live tag, which changes nothing.
//
// `looped[row]` is 1 when the row took the round loop, else 0.
//
// Coherence: a chunk gathers from this block's own earlier stores, so
// `out` is a plain pointer (no read-only path), a barrier parts every
// chunk's stores from the next chunk's gathers, and only later chunks'
// input, never their gather targets, is fetched ahead.
//
// Occupancy: NBUF x 4 KiB of shared memory and 256 threads a block, so 6
// blocks an SM (1 KiB of each block's shared memory is the system's) and
// 792 on 132 SMs: the 546 rows of a [546, 65536] batch all run at once,
// as do the rows of a one-shot decode's batch at 131072 (its speculative
// batch has a row a Kraft candidate, at most 512; its sequential walk
// one row, on one SM, sweeping 128 chunks).
//
// What bounds it: the 512 KiB a row of 65536 moves, 1 MiB at 131072.  On an NVIDIA H100
// 80GB HBM3 at 700 W (scripts/far_row_variants.py) it takes 1.25-1.4
// times as long as a copy of the same bytes, at every chunk size tried
// with the same 32 KiB of staging (4096 x 2, 2048 x 4, 1024 x 8) and with
// 40 KiB at 5 blocks an SM; chunks of 1024 staged 7 ahead were 8% faster
// than 4096 x 2 on the decoded states and spill no registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FAR_TAG = 1 << 24;
constexpr int CHUNK = 1024;
constexpr int NBUF = 8;  // chunk buffers: NBUF - 1 chunks staged ahead
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 6;
constexpr int VECS = CHUNK / (4 * THREADS);  // a thread's 16-byte groups
constexpr int OWN = 4 * VECS;                // a thread's positions
constexpr int CHUNK_ROUNDS = 11;             // bitlen(CHUNK - 1) + 1
static_assert(VECS >= 1 && CHUNK % (4 * THREADS) == 0, "whole groups");

__device__ __forceinline__ bool live_in_row(int s, int U) {
  return (s >> 17) == 1 && (s & 0x1FFFF) < U;
}

__device__ __forceinline__ int state_of(int v) {
  return (v & FAR_TAG) ? ((1 << 17) | (v & (FAR_TAG - 1))) : (v & 0x1FF);
}

// a chunk's position of this thread's q-th slot: neighbouring threads own
// neighbouring 16-byte groups
__device__ __forceinline__ int slot(int q) {
  return 4 * ((int)threadIdx.x + THREADS * (q >> 2)) + (q & 3);
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// this thread's slots of the `len` positions from `row_in` into buf
template <bool VEC>
__device__ __forceinline__ void stage(int32_t* buf,
                                      const int32_t* __restrict__ row_in,
                                      int len) {
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const int at = slot(4 * i);
    if (VEC) {
      if (at < len) copy16(buf + at, row_in + at);  // len % 4 == 0
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (at + e < len) copy4(buf + at + e, row_in + at + e);
    }
  }
}

// 3.: the level's synchronous rounds on one row, then the zeroing
__device__ void round_loop(const int32_t* __restrict__ row_in, int32_t* cur,
                           int32_t* nxt, int U, int cap) {
  int32_t* const res = cur;
  int any = 0;
  for (int j = threadIdx.x; j < U; j += THREADS) {
    const int s = state_of(row_in[j]);
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

// out and scratch are read and written by other threads of the block
// between barriers: plain pointers, so the loads stay coherent
template <bool VEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
far_row_kernel(const int32_t* __restrict__ in, int32_t* out,
               int32_t* scratch, int32_t* looped, int U, int cap) {
  __shared__ alignas(16) int32_t buf[NBUF][CHUNK];
  const size_t roff = (size_t)blockIdx.x * U;
  const int32_t* row_in = in + roff;
  int32_t* row_out = out + roff;
  const int nchunks = (U + CHUNK - 1) / CHUNK;

  // one cp.async group a chunk, empty past the row's end
#pragma unroll
  for (int k = 0; k < NBUF - 1; ++k) {
    if (k < nchunks)
      stage<VEC>(buf[k], row_in + k * CHUNK, min(CHUNK, U - k * CHUNK));
    commit();
  }
  for (int k = 0; k < nchunks; ++k) {
    const int base = k * CHUNK, len = min(CHUNK, U - base);
    int32_t* cb = buf[k % NBUF];
    // chunk k + NBUF - 1 goes where chunk k - 1 was, whose reads all came
    // before the barriers of that chunk
    const int ahead = base + (NBUF - 1) * CHUNK;
    if (ahead < U)
      stage<VEC>(buf[(k + NBUF - 1) % NBUF], row_in + ahead,
                 min(CHUNK, U - ahead));
    commit();
    wait_groups<NBUF - 1>();  // this thread's copies of chunk k have landed

    // this thread's positions, 16 bytes at a time (a tail group may hold
    // stale words past len: masked here, and never a source below)
    int s[OWN];
    bool stop = false, inner = false;
#pragma unroll
    for (int i = 0; i < VECS; ++i) {
      const int at = slot(4 * i);
      const int4 w = *reinterpret_cast<const int4*>(cb + at);
      const int v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int st = at + e < len ? state_of(v[e]) : 0;
        const int src = st & 0x1FFFF;
        s[4 * i + e] = st;
        stop = stop || (st >> 17) > 1;  // a tag with bits above 17: see 2.
        if (live_in_row(st, U)) {
          stop = stop || src >= base + len;
          inner = inner || src >= base;
        }
      }
    }
    // also orders chunk k - 1's stores before this chunk's gathers
    const bool slow = __syncthreads_or(stop || inner);
    if (slow && __syncthreads_or(stop)) {
      wait_groups<0>();
      round_loop(row_in, row_out, scratch + roff, U, cap);
      if (threadIdx.x == 0) looped[blockIdx.x] = 1;
      return;
    }
#pragma unroll
    for (int q = 0; q < OWN; ++q)
      if (live_in_row(s[q], U) && (s[q] & 0x1FFFF) < base)
        s[q] = row_out[s[q] & 0x1FFFF];
    if (slow) {  // some tag points inside the chunk: pointer doubling
      for (int r = 0;; ++r) {
#pragma unroll
        for (int i = 0; i < VECS; ++i)
          *reinterpret_cast<int4*>(cb + slot(4 * i)) = make_int4(
              s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
        bool pending = false;
#pragma unroll
        for (int q = 0; q < OWN; ++q) pending = pending || live_in_row(s[q], U);
        // orders this round's writes before the next round's reads
        if (r == CHUNK_ROUNDS || !__syncthreads_or(pending)) break;
#pragma unroll
        for (int q = 0; q < OWN; ++q)
          if (live_in_row(s[q], U))
            s[q] = cb[(s[q] & 0x1FFFF) - base] & 0x3FFFF;
        __syncthreads();  // all reads of the round before its writes
      }
    }
#pragma unroll
    for (int q = 0; q < OWN; ++q)  // a live tag left is on a cycle: 0
      s[q] = (s[q] >> 17) == 1 ? 0 : (s[q] & 0x1FF);
#pragma unroll
    for (int i = 0; i < VECS; ++i) {
      const int at = slot(4 * i);
      if (VEC) {
        if (at < len)
          *reinterpret_cast<int4*>(row_out + base + at) =
              make_int4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (at + e < len) row_out[base + at + e] = s[4 * i + e];
      }
    }
  }
  if (threadIdx.x == 0) looped[blockIdx.x] = 0;
}

template <bool VEC>
int launch(const void* in, void* out, void* scratch, void* looped, int n,
           int U, int cap, cudaStream_t stream) {
  cudaError_t rc = cudaFuncSetAttribute(
      far_row_kernel<VEC>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (rc != cudaSuccess) return (int)rc;
  far_row_kernel<VEC><<<n, THREADS, 0, stream>>>(
      (const int32_t*)in, (int32_t*)out, (int32_t*)scratch,
      (int32_t*)looped, U, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int far_row(const void* in, void* out, void* scratch,
                       void* looped, int n, int U, int cap, void* stream) {
  const bool vec =
      U % 4 == 0 && (((uintptr_t)in | (uintptr_t)out) & 15) == 0;
  return vec ? launch<true>(in, out, scratch, looped, n, U, cap,
                            (cudaStream_t)stream)
             : launch<false>(in, out, scratch, looped, n, U, cap,
                             (cudaStream_t)stream);
}
