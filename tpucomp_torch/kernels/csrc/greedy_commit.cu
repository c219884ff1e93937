// Greedy parse: per row, a cursor walk over the positions that commits a
// token where the cursor stands and jumps by the match length (or 1).
// One thread per row, one warp per block.
//
// Replaces: tpucomp/kernels/lz_pallas.py greedy_commit and
// greedy_commit_layout (_build_kernel), which walk one position per loop
// step with rows across the TPU's lanes, after transposing the input
// position-major and packing the commit bits 32 to a word.  Here the
// rows stay row-major: a warp's 32 rows are staged through shared memory
// in tiles of 128 positions (coalesced loads along each row), each lane
// walks its own row through the tile, and the outputs go back through
// the same tiles as coalesced stores.  committed comes out as one byte
// (bool) per position; with layout set, also t_after (tokens committed
// up to and including p) and data_before (data bytes, 2 per match and 1
// per literal, committed before p).
//
// What bounds it on the card: latency.  The walk is a dependent chain of
// n steps per row (each step's commit test needs the cursor the step
// before moved), and at [8208, 4096] there are 8208 rows, 257 warps for
// 132 SMs, too few to hide it.  Device memory sees 6 bytes in and 9 out
// per position (layout), about 0.5 GB, which alone would take 0.15 ms.
// The tile loads and stores are not overlapped with the walk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 32;   // rows per block: one per lane
constexpr int TP = 128;    // positions per tile
constexpr int LD = TP + 1;      // int32 tile stride: lane r starts at bank r
constexpr int LDB = TP + 4;     // byte tile stride: one word per row

__global__ void __launch_bounds__(ROWS)
greedy_commit_kernel(const bool* __restrict__ is_match,
                     const int32_t* __restrict__ best_len,
                     const bool* __restrict__ okpos,
                     bool* __restrict__ committed,
                     int32_t* __restrict__ t_after,
                     int32_t* __restrict__ data_before, int N, int n,
                     int layout) {
  __shared__ int32_t blen[ROWS][LD];  // best_len, then t_after
  __shared__ int32_t dbef[ROWS][LD];
  __shared__ uint8_t flag[ROWS][LDB];  // is_match | okpos << 1, then commit
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, N - row0);
  int nc = 0, tcnt = 0, dbytes = 0;
  for (int c = 0; c < n; c += TP) {
    const int w = min(TP, n - c);
    for (int r = 0; r < nrows; ++r) {
      const size_t off = (size_t)(row0 + r) * n + c;
      for (int t = lane; t < w; t += 32) {
        blen[r][t] = best_len[off + t];
        flag[r][t] = (uint8_t)(is_match[off + t] | (okpos[off + t] << 1));
      }
    }
    __syncwarp();
    if (lane < nrows) {
      for (int t = 0; t < w; ++t) {
        const int p = c + t;
        const int f = flag[lane][t];
        const bool commit = p == nc && (f & 2);
        if (commit) nc = p + ((f & 1) ? blen[lane][t] : 1);
        flag[lane][t] = commit;
        if (layout) {
          dbef[lane][t] = dbytes;
          tcnt += commit;
          dbytes += commit ? 1 + (f & 1) : 0;
          blen[lane][t] = tcnt;
        }
      }
    }
    __syncwarp();
    for (int r = 0; r < nrows; ++r) {
      const size_t off = (size_t)(row0 + r) * n + c;
      for (int t = lane; t < w; t += 32) {
        committed[off + t] = flag[r][t] != 0;
        if (layout) {
          t_after[off + t] = blen[r][t];
          data_before[off + t] = dbef[r][t];
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int greedy_commit(const void* is_match, const void* best_len,
                             const void* okpos, void* committed,
                             void* t_after, void* data_before, int n_rows,
                             int n, int layout, void* stream) {
  const int blocks = (n_rows + ROWS - 1) / ROWS;
  greedy_commit_kernel<<<blocks, ROWS, 0, (cudaStream_t)stream>>>(
      (const bool*)is_match, (const int32_t*)best_len, (const bool*)okpos,
      (bool*)committed, (int32_t*)t_after, (int32_t*)data_before, n_rows, n,
      layout);
  return (int)cudaGetLastError();
}
