// Near-window copy resolution over 512-byte segments, one thread per
// segment.
//
// Replaces: tpucomp/kernels/resolve_pallas.py resolve_copies (the Pallas
// kernel built by _build_kernel), up to its call of _far_rounds: the
// output is exactly the array tpucomp hands to the far rounds.  Each row
// of U positions (a multiple of 512: 4096 for LZNT1, up to 65536 for
// Xpress Huffman) is cut into U / 512 segments, each walked in order.  A
// literal resolves to its byte; a copy whose source lies in the segment
// takes the source's resolved value (far tags propagate through
// in-segment copies);
// any other copy becomes FAR_TAG | max(base + j - disp, 0).  disp is
// clamped to 17 bits and the literal masked to 9, as tpucomp packs them.
//
// What bounds it on the card: the walk is sequential within a segment
// (a copy reads what an earlier step wrote), so it is latency-bound, with
// N * U / 512 threads.  The design keeps each thread's 512-entry window in
// shared memory, laid out [position][thread] so that every window access
// of a warp -- whatever positions its threads read -- falls in 32
// distinct banks; the input loads do not depend on the walk, so the
// loads can run ahead of it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG = 512;
constexpr int FAR_TAG = 1 << 24;
constexpr int THREADS = 32;
constexpr int SMEM_BYTES = SEG * THREADS * (int)sizeof(int32_t);  // 64 KiB

__global__ void __launch_bounds__(THREADS)
resolve_near_kernel(const bool* __restrict__ is_copy,
                    const int32_t* __restrict__ disp,
                    const int32_t* __restrict__ litv,
                    int32_t* __restrict__ out, int nsegs, int row_segs) {
  extern __shared__ int32_t win[];  // [SEG][THREADS]
  const int t = threadIdx.x;
  const int g = blockIdx.x * THREADS + t;
  if (g >= nsegs) return;
  const int base = (g % row_segs) * SEG;
  const size_t off = (size_t)g * SEG;  // row * U + base
  for (int j = 0; j < SEG; ++j) {
    // tpucomp's lane word, packed and taken apart again.  The direct form
    // (d = c ? min(disp, 0x1FFFF) : 0, literal = litv & 0x1FF) gives the
    // same values but ran 1.45 ms, or 1.10 ms with its loads moved ahead
    // of the branch, against 0.89 ms for this form, at 8192 rows on an
    // NVIDIA H100 80GB HBM3 at 700 W.  Why nvcc compiles this form to a
    // faster loop was not traced.
    const bool c = is_copy[off + j];
    const int v = (litv[off + j] & 0x1FF)
                  | ((c ? min(disp[off + j], 0x1FFFF) : 0) << 9)
                  | (c ? 1 << 26 : 0);
    const int d = (v >> 9) & 0x1FFFF;
    int val;
    if (!((v >> 26) & 1)) {
      val = v & 0x1FF;
    } else if (d >= 1 && d <= j) {
      val = win[(j - d) * THREADS + t];
    } else {
      val = FAR_TAG | max(base + j - d, 0);
    }
    win[j * THREADS + t] = val;
    out[off + j] = val;
  }
}

}  // namespace

extern "C" int resolve_near(const void* is_copy, const void* disp,
                            const void* litv, void* out, int nsegs,
                            int row_segs, void* stream) {
  cudaError_t rc = cudaFuncSetAttribute(
      resolve_near_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  const int blocks = (nsegs + THREADS - 1) / THREADS;
  resolve_near_kernel<<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bool*)is_copy, (const int32_t*)disp, (const int32_t*)litv,
      (int32_t*)out, nsegs, row_segs);
  return (int)cudaGetLastError();
}
