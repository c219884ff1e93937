// Xpress Huffman code tables: int32 [N, 512] symbol counts -> int32
// [N, 512] code lengths (at most 15, 0 for an unused symbol) and
// canonical codes (0 for an unused symbol), a block a row.
//
// Replaces: no Pallas kernel.  tpucomp builds the tables in XLA
// (tpucomp/kernels/huffman.py huffman_code_lengths, a lax.scan of 511
// merge steps, and canonical_from_lengths for the codes); the port's
// plain version (kernels/huffman.py huffman_tables_ref) issues that scan
// from the host as a dozen small ops a step, with host syncs for the step
// count and each round of the 15-bit repair.  Every step here is the
// plain version's, so the tables are equal bit for bit:
//
//   1. rank the used symbols by the unique key (freq, sym) in shared
//      memory: each thread counts the keys below its own;
//   2. the two-queue merge, n_used - 1 steps in one thread: the first
//      pick compares leaf lp with node nh, the second the next two heads,
//      a leaf winning a tie; a consumed node records the step that
//      consumed it (its parent), each step how many leaves it consumed.
//      Weights are 64-bit and an empty slot costs 2^30, tpucomp's and the
//      plain version's cost: a row's counts must sum below it (an XH row
//      holds at most 65536 symbols), and a row at or above it gets
//      lengths and codes of -1, its merge not run;
//   3. node depths in one reverse pass: a node's parent is made later, so
//      the root (node n_used - 2) comes first; a leaf sits one below the
//      step that consumed it, and only the count of leaves a depth
//      (clamped to 15) is kept;
//   4. a row with one used symbol gives it a 1-bit code, an empty row
//      nothing;
//   5. the Kraft repair: while the counts oversubscribe 2^15, one leaf
//      moves from the deepest level in 1..14 that has any to the next;
//   6. the lengths go longest first to the rarest leaves;
//   7. canonical codes: fc[len] + the symbol's rank among the symbols of
//      its length, by symbol (a warp's ranks by __match_any_sync, the
//      earlier segments' counts from shared memory).
//
// What bounds it on the card: a call of 512 rows moves 3 MiB (under 1 us
// at 3.35 TB/s), but the merge and the depth pass are chains of about
// 511 dependent shared-memory steps in one thread of each block.  Blocks
// are small (128 threads, 16 KiB of shared memory), so every row of a
// call runs at once, several blocks an SM, and the rows' chains overlap.
// The kernel launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int S = 512;  // symbols a row
constexpr int THREADS = 128;
constexpr int PER = S / THREADS;  // symbols a thread: t, t + 128, ...
constexpr int SEGS = S / 32;      // warp-wide segments of 32 symbols
constexpr int MAX_LEN = 15;
constexpr long long EMPTY = 1LL << 30;  // an empty queue slot's cost
constexpr uint32_t UNUSED_KEY = 0x80000000u;

__global__ void __launch_bounds__(THREADS)
huffman_tables_kernel(const int32_t* __restrict__ freqs,
                      int32_t* __restrict__ lengths,
                      int32_t* __restrict__ codes) {
  __shared__ __align__(16) uint32_t key[S];
  __shared__ long long leaf_w[S + 2];  // sorted leaves, EMPTY past n_used
  __shared__ long long node_w[S];      // node s, EMPTY until step s
  __shared__ uint16_t leaf_sym[S];
  __shared__ uint16_t parent[S];       // the step that consumed node c
  __shared__ uint16_t depth[S];        // node depths
  __shared__ uint8_t nleaf[S];         // leaves step s consumed
  __shared__ uint8_t len[S];           // lengths by symbol
  __shared__ int seg_cnt[SEGS][MAX_LEN + 1];
  __shared__ int cnt[MAX_LEN + 1];     // leaves a depth, then a length
  __shared__ int fc[MAX_LEN + 1];
  __shared__ int n_used;
  __shared__ unsigned long long total;  // the row's sum of counts

  const int t = threadIdx.x;
  const int32_t* const frow = freqs + (size_t)blockIdx.x * S;
  if (t == 0) n_used = 0, total = 0;
  if (t <= MAX_LEN) cnt[t] = 0;
  for (int k = t; k < SEGS * (MAX_LEN + 1); k += THREADS)
    (&seg_cnt[0][0])[k] = 0;
  __syncthreads();

  // ---- 1. keys, and the rank of each used symbol ----
  uint32_t my_key[PER];
  int used = 0;
  unsigned long long sum = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int s = t + i * THREADS;
    const int32_t f = frow[s];
    my_key[i] = f > 0 ? (uint32_t)f : UNUSED_KEY;
    key[s] = my_key[i];
    used += f > 0;
    sum += f > 0 ? (unsigned)f : 0u;
    leaf_w[s] = EMPTY;
    node_w[s] = EMPTY;
    len[s] = 0;
  }
  if (t < 2) leaf_w[S + t] = EMPTY;
  if (used) atomicAdd(&n_used, used);
  if (sum) atomicAdd(&total, sum);
  __syncthreads();
  const int n = n_used;
  int32_t* const lrow = lengths + (size_t)blockIdx.x * S;
  int32_t* const crow = codes + (size_t)blockIdx.x * S;
  if (total >= (unsigned long long)EMPTY) {  // the whole block returns
    for (int s = t; s < S; s += THREADS) lrow[s] = crow[s] = -1;
    return;
  }

  int rank[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) rank[i] = 0;
  const uint4* const key4 = reinterpret_cast<const uint4*>(key);
  for (int j4 = 0; j4 < S / 4; ++j4) {
    const uint4 q = key4[j4];
    const uint32_t kj[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = 4 * j4 + m;
#pragma unroll
      for (int i = 0; i < PER; ++i)
        rank[i] += kj[m] < my_key[i] ||
                   (kj[m] == my_key[i] && j < t + i * THREADS);
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (my_key[i] != UNUSED_KEY) {  // used symbols rank below every unused
      leaf_w[rank[i]] = my_key[i];
      leaf_sym[rank[i]] = (uint16_t)(t + i * THREADS);
    }
  }
  __syncthreads();

  // ---- 2-5. merge, depths, repair: one thread ----
  if (t == 0) {
    int lp = 0, nh = 0;
    for (int s = 0; s < n - 1; ++s) {
      const long long lf0 = leaf_w[lp], lf1 = leaf_w[lp + 1];
      const long long nf0 = node_w[nh], nf1 = node_w[nh + 1];
      const bool t1 = lf0 <= nf0;  // the first pick is leaf lp
      const long long x = t1 ? lf1 : lf0, y = t1 ? nf0 : nf1;
      const bool t2 = x <= y;      // the second pick is a leaf
      node_w[s] = (t1 ? lf0 : nf0) + (t2 ? x : y);
      if (!t1) parent[nh] = (uint16_t)s;
      if (!t2) parent[nh + !t1] = (uint16_t)s;
      nleaf[s] = (uint8_t)(t1 + t2);
      lp += t1 + t2;
      nh += 2 - t1 - t2;
    }
    if (n >= 2) {
      depth[n - 2] = 0;
      for (int c = n - 3; c >= 0; --c) depth[c] = depth[parent[c]] + 1;
    }
  }
  __syncthreads();
  for (int s = t; s < n - 1; s += THREADS)
    atomicAdd(&cnt[min(depth[s] + 1, MAX_LEN)], nleaf[s]);
  __syncthreads();
  if (t == 0) {
    if (n == 1) cnt[1] = 1;
    long long kraft = 0;
    for (int l = 1; l <= MAX_LEN; ++l)
      kraft += (long long)cnt[l] << (MAX_LEN - l);
    while (kraft > (1 << MAX_LEN)) {
      int lsel = 0;
      for (int l = MAX_LEN - 1; l >= 1; --l)
        if (cnt[l] > 0) { lsel = l; break; }
      cnt[lsel] -= 1;
      cnt[lsel + 1] += 1;
      kraft -= 1LL << (MAX_LEN - 1 - lsel);
    }
    // from here cnt[l] holds how many leaves, from the rarest, get l or
    // more bits: the sum of the counts of levels l..15
    for (int l = MAX_LEN - 1; l >= 1; --l) cnt[l] += cnt[l + 1];
  }
  __syncthreads();

  // ---- 6. lengths, longest first to the rarest leaves ----
  for (int k = t; k < n; k += THREADS) {
    int l = MAX_LEN;
    while (l >= 1 && k >= cnt[l]) --l;
    len[leaf_sym[k]] = (uint8_t)l;
  }
  __syncthreads();

  // ---- 7. canonical codes ----
  const int lane = t & 31;
  const unsigned lt_mask = (1u << lane) - 1;
  int my_len[PER], intra[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int s = t + i * THREADS;
    my_len[i] = len[s];
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, my_len[i]);
    intra[i] = __popc(peers & lt_mask);
    if (my_len[i] > 0 && (peers & lt_mask) == 0)
      seg_cnt[s >> 5][my_len[i]] = __popc(peers);
  }
  __syncthreads();
  if (t == 0) {
    uint32_t code = 0;
    for (int l = 1; l <= MAX_LEN; ++l) {
      int c = 0;
      for (int g = 0; g < SEGS; ++g) c += seg_cnt[g][l];
      fc[l] = (int)code;
      code = (code + (uint32_t)c) << 1;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int s = t + i * THREADS;
    const int l = my_len[i];
    int32_t c = 0;
    if (l > 0) {
      int before = 0;
      for (int g = 0; g < (s >> 5); ++g) before += seg_cnt[g][l];
      c = (int32_t)((uint32_t)fc[l] + (uint32_t)(before + intra[i]));
    }
    lrow[s] = l;
    crow[s] = c;
  }
}

}  // namespace

extern "C" int huffman_tables(const void* freqs, void* lengths, void* codes,
                              int n, void* stream) {
  huffman_tables_kernel<<<n, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)freqs, (int32_t*)lengths, (int32_t*)codes);
  return (int)cudaGetLastError();
}
