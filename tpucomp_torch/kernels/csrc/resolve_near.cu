// Near-window copy resolution over 512-byte segments: a warp a segment,
// its copy chains resolved by pointer doubling in shared memory.
//
// Replaces: tpucomp/kernels/resolve_pallas.py resolve_copies (the Pallas
// kernel built by _build_kernel), up to its call of _far_rounds: the
// output is exactly the array tpucomp hands to the far rounds.  Each row
// of U positions (a multiple of 512: 4096 for LZNT1, 65536 for the
// batched decodes' blocks, 131072 for the one-shot Xpress Huffman
// decode's [history | block] rows) is cut into U / 512 segments.  With base = the
// segment's start in its row, position j of a segment resolves so: a
// literal to litv & 0x1FF; a copy with d = min(disp, 0x1FFFF) and
// 1 <= d <= j to the resolved value of position j - d (far tags
// propagate through in-segment copies); any other copy to
// FAR_TAG | max(base + j - d, 0).
//
// Design: every resolved value is >= 0, so a near copy is coded as
// ~(j - d), a pointer to its source; every source lies earlier in the
// segment, so a chain ends at a literal or a far tag, its root, whose
// value the whole chain takes.  One warp takes one segment, WARPS
// segments a block.
// 1. Stage.  The warp copies the segment's three input planes into its
//    4,608 bytes of shared memory with 16-byte cp.async copies,
//    neighbouring lanes on neighbouring addresses (the 512 bytes of
//    is_copy in one copy a lane, each int32 plane in four), all issued
//    before the first is waited for.  Each lane codes its 16 positions,
//    j = 32 c + lane, into registers and into the window, the disp
//    plane's words.
// 2. Resolve.  Rounds of pointer doubling: every position that holds a
//    pointer takes what its source holds (a value, or a pointer twice as
//    far back along the chain), all reads of a round before any write,
//    until no position of the segment holds a pointer: ceil(log2(depth +
//    1)) rounds for a longest chain of depth hops, 9 for a run of
//    displacement 1 (511 hops), none without a near copy.
// 3. Store.  The window goes out with 16-byte stores, neighbouring lanes
//    on neighbouring addresses.
// Rows whose planes are not 16-byte aligned stage and store 4 (and 1)
// bytes a lane instead.
//
// Widths: a segment's base, (g % row_segs) * 512, and the sources it
// tags stay below U <= 2^17, the far levels' 17-bit field; segment g
// starts at g * 512 of the whole batch, a 64-bit offset, so N * U may
// pass 2^31 (the grid, N * U / 4096 blocks, takes any batch the card
// holds).
//
// What bounds it: the 13 bytes a position moves (is_copy, disp and litv
// read once, the output written once), 0.1305 ms for LZNT1's 8208 rows
// of 4 KiB at 3.35 TB/s.  An SM holds 6 blocks, 48 warps (36,864 bytes
// of shared memory a block, at most 40 registers a thread), so while some
// warps resolve, the others' staged loads keep the memory busy; the
// rounds are a few hundred cycles of shared-memory loads a segment.  On
// an NVIDIA H100 80GB HBM3 at 700 W (scripts/resolve_near_variants.py)
// the kernel took 5-13% longer than torch.where(is_copy, disp, litv),
// which moves the same bytes, and about as long on the corpus planes as
// on rows of literals alone, or of 511-hop chains.
//
// Chosen over a chunk walk (the segment's sixteen 32-position chunks in
// order, sources in the same chunk resolved by __shfl_sync pointer
// jumping) by measurement: the two took the same time at every shape,
// the deepest chains included, and the doubling is the shorter code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG = 512;
constexpr int CHUNKS = SEG / 32;  // a lane's positions, j = 32 c + lane
constexpr int FAR_TAG = 1 << 24;
constexpr int WARPS = 8;  // segments a block
constexpr int THREADS = 32 * WARPS;
constexpr int BLOCKS_PER_SM = 6;
constexpr unsigned FULL = 0xFFFFFFFFu;

constexpr int STAGE_BYTES = 4608;  // one segment's inputs

struct alignas(16) Stage {
  int32_t disp[SEG];  // then the resolved window
  int32_t litv[SEG];
  uint8_t is_copy[SEG];
};
static_assert(sizeof(Stage) == STAGE_BYTES, "Stage is one segment's inputs");

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// The segment that starts at position off into s: with VEC, 16-byte
// cp.async copies; else 4- and 1-byte loads.
template <bool VEC>
__device__ __forceinline__ void stage_segment(
    Stage& s, const bool* __restrict__ is_copy,
    const int32_t* __restrict__ disp, const int32_t* __restrict__ litv,
    size_t off, int lane) {
  if (VEC) {
    copy16(s.is_copy + 16 * lane, (const uint8_t*)is_copy + off + 16 * lane);
#pragma unroll
    for (int k = 0; k < SEG / 128; ++k) {
      const int at = 4 * (32 * k + lane);
      copy16(s.disp + at, disp + off + at);
      copy16(s.litv + at, litv + off + at);
    }
  } else {
    for (int j = lane; j < SEG; j += 32) {
      s.is_copy[j] = is_copy[off + j];
      s.disp[j] = disp[off + j];
      s.litv[j] = litv[off + j];
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                   : "memory");
  __syncwarp();
}

// Position j's code: a resolved value (>= 0) or ~source (< 0).  The far
// source wraps as int32 does in the plain version.
__device__ __forceinline__ int code_of(const Stage& s, int j, int base) {
  if (!s.is_copy[j]) return s.litv[j] & 0x1FF;
  const int d = min(s.disp[j], 0x1FFFF);
  if (d >= 1 && d <= j) return ~(j - d);
  return FAR_TAG | max((int)((unsigned)(base + j) - (unsigned)d), 0);
}

// The staged segment -> its resolved values in s.disp, the window.
__device__ __forceinline__ void resolve_segment(Stage& s, int lane,
                                                int base) {
  int32_t* win = s.disp;
  int code[CHUNKS];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) code[c] = code_of(s, 32 * c + lane, base);
  __syncwarp();  // every lane has read the disp plane: it becomes the window
  // each round, every position that holds a pointer takes what its source
  // holds, all read before any is written
  bool pending = false;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    win[32 * c + lane] = code[c];
    pending |= code[c] < 0;
  }
  while (__any_sync(FULL, pending)) {
    __syncwarp();
    pending = false;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      if (code[c] < 0) code[c] = win[~code[c]];
      pending |= code[c] < 0;
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) win[32 * c + lane] = code[c];
  }
  __syncwarp();
}

template <bool VEC>
__device__ __forceinline__ void store_segment(const Stage& s,
                                              int32_t* __restrict__ out,
                                              size_t off, int lane) {
  if (VEC) {
#pragma unroll
    for (int k = 0; k < SEG / 128; ++k) {
      const int at = 32 * k + lane;
      reinterpret_cast<int4*>(out + off)[at] =
          reinterpret_cast<const int4*>(s.disp)[at];
    }
  } else {
    for (int j = lane; j < SEG; j += 32) out[off + j] = s.disp[j];
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
resolve_near_kernel(const bool* __restrict__ is_copy,
                    const int32_t* __restrict__ disp,
                    const int32_t* __restrict__ litv,
                    int32_t* __restrict__ out, int nsegs, int row_segs) {
  __shared__ Stage stage[WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = blockIdx.x * WARPS + w;
  if (g >= nsegs) return;  // whole warps only: no block barrier below
  const size_t off = (size_t)g * SEG;  // row * U + base
  stage_segment<VEC>(stage[w], is_copy, disp, litv, off, lane);
  resolve_segment(stage[w], lane, (g % row_segs) * SEG);
  store_segment<VEC>(stage[w], out, off, lane);
}

template <bool VEC>
int launch(const void* is_copy, const void* disp, const void* litv,
           void* out, int nsegs, int row_segs, cudaStream_t stream) {
  cudaError_t rc = cudaFuncSetAttribute(
      resolve_near_kernel<VEC>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (rc != cudaSuccess) return (int)rc;
  const int blocks = (nsegs + WARPS - 1) / WARPS;
  resolve_near_kernel<VEC><<<blocks, THREADS, 0, stream>>>(
      (const bool*)is_copy, (const int32_t*)disp, (const int32_t*)litv,
      (int32_t*)out, nsegs, row_segs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int resolve_near(const void* is_copy, const void* disp,
                            const void* litv, void* out, int nsegs,
                            int row_segs, void* stream) {
  const bool vec = (((uintptr_t)is_copy | (uintptr_t)disp |
                     (uintptr_t)litv | (uintptr_t)out) & 15) == 0;
  return vec ? launch<true>(is_copy, disp, litv, out, nsegs, row_segs,
                            (cudaStream_t)stream)
             : launch<false>(is_copy, disp, litv, out, nsegs, row_segs,
                             (cudaStream_t)stream);
}
