// Row sort: each row ascending by a unique int32 key, payload planes
// permuted along.
//
// Replaces: tpucomp/kernels/sort_pallas.py bitonic_sort_rows
// (_build_kernel), a bitonic network over VMEM-resident rows that moves
// every payload plane through every compare-exchange stage, because the
// TPU has no gather.  Here a least-significant-digit radix sort moves only
// the key and its column index; each payload plane is then gathered once
// through the sorted columns.
//
// Keys go in with the sign bit flipped, so that unsigned order is signed
// order.  The bits that vary in a row are those where some key differs
// from the row's first key (an OR of XORs).  The sort runs as few digit
// passes as cover them, from the lowest to the highest, each digit as wide
// as the others (Digits), and no pass over the bits that do not vary.
//
// Every pass is one stable rank-and-scatter (rank_scatter) of a tile of
// (key, column) pairs held in registers, 8 a thread.  Each warp ranks its
// 256 pairs, 32 at a time, among the lanes of the same digit (one ballot
// per digit bit, the 8 pairs' ballots interleaved) and counts its digits
// in its own column of a [digit][warp] counter table in shared memory.  An
// exclusive scan of that table in its own order, digits major and warps
// minor, which every thread of the block shares, gives every (digit,
// warp) its first slot, so the scatter keeps the tile's order within a
// digit: LSD radix is right only if it does.
//
// Rows up to 8192 (sort_rows): one block a row, digits of up to 9 bits.
// The pairs stay in shared memory across passes, so device memory sees
// each key once each way and each payload value once each way (the read a
// gather within its row, all of a thread's loads before its stores).
// Shared memory and the instruction rate bound it, not bytes: per pass, a
// ballot per digit bit, a scatter with bank conflicts and four barriers
// for every pair; 64 registers a thread (at 512 threads, 2 blocks an SM).
// The 9-bit digits take the match finder's 25-bit hash key in 3 passes
// (9 + 9 + 7 bits) and its 12-bit un-sort key in 2 (6 + 6).
//
// Wider rows, up to 131072 (sort_rows_tiled): a row's pairs do not fit a
// block's shared memory, so every pass goes through device memory in
// tiles, one a block (tile / 8 threads; the wrapper picks the tile), with
// digits of up to 8 bits: wider ones would cut a tile's output into runs
// too short to coalesce.  An upsweep counts the digits of each (row,
// tile); a scan, a block a row, turns the counts into the first slot of
// each (tile, digit) in the row; the downsweep ranks its tile with
// rank_scatter into shared memory and writes it out in digit order, so
// that the stores of one digit's run are contiguous.  Blocks take a row's
// tiles one after another (TileOf), so that the stores in flight meet in
// L2.  A pass reads the keys twice and the pairs once and writes the
// pairs once, 20 B a key (12 B in pass 0).  The scan takes a row's tiles
// one after another (32 at 65536, 36 at the stream encoder's 73,728, 64
// at 131072); every index into a row is an int below 2^17, and offsets
// into the planes and hist are size_t.  Each row's pass count is found
// on the card, so the host launches all four passes and a pass that a row
// does not need returns at once; a row's pairs end in the ping-pong plane
// of its last pass.  (A thread-block cluster holding a 64 KiB row in
// distributed shared memory would save the device-memory passes.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXP = 16;  // payload planes per launch
constexpr int MAX_THREADS = 1024;
constexpr int ITEMS = 8;        // pairs a thread holds
constexpr int BLOCK_BITS = 9;   // the widest digit of the one-block form
constexpr int TILE_BITS = 8;    // the widest digit of the tiled form
constexpr int TILE_BINS = 1 << TILE_BITS;
constexpr int MAX_PASSES = 4;   // 32 bits at TILE_BITS
constexpr int FINISH = 2048;    // elements of a row a finish block writes
constexpr uint32_t SIGN = 0x80000000u;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Planes {
  const int32_t* in[MAXP];
  int32_t* out[MAXP];
};

// The tiled form's two ping-pong planes of (key, column) pairs, [n, U]
// each: plane b's keys at base + 2 b size, its columns after them.
struct Pairs {
  int32_t* base;
  size_t size;
  __device__ uint32_t* key(int b) const {
    return (uint32_t*)base + 2 * b * size;
  }
  __device__ int32_t* col(int b) const { return base + (2 * b + 1) * size; }
};

// A row's digit passes: as few as digits of at most max_bits bits allow,
// of even width, from its lowest to its highest varying bit; diff is the
// OR of every key XOR the row's first.
struct Digits {
  int lo, nbits, width, passes;
  __device__ Digits(uint32_t diff, int max_bits) {
    if (diff == 0) {
      lo = nbits = width = passes = 0;
      return;
    }
    lo = __ffs(diff) - 1;
    nbits = 32 - __clz(diff) - lo;
    passes = (nbits + max_bits - 1) / max_bits;
    width = (nbits + passes - 1) / passes;
  }
  __device__ int shift(int p) const { return lo + p * width; }
  __device__ int bits(int p) const { return min(width, nbits - p * width); }
};

// A block's shared memory: the pairs of its tile; the counter table,
// [bins][warps + 1] (digit d of warp w at d (warps + 1) + w; the last of
// each row a pad that stays 0); the tiled form's first slot of each digit
// in the row; the scan's warp sums; and a word.
struct Shared {
  uint32_t* key;
  int32_t* col;
  int32_t* cnt;
  int32_t* dest;  // [bins]
  int32_t* wsum;  // [32]
  uint32_t* word;
};

__device__ Shared carve(int32_t* base, int cap, int bins) {
  Shared s;
  s.key = (uint32_t*)base;
  s.col = base + cap;
  s.cnt = s.col + cap;
  s.dest = s.cnt + bins * (blockDim.x / 32 + 1);
  s.wsum = s.dest + bins;
  s.word = (uint32_t*)(s.wsum + 32);
  return s;
}

size_t shared_bytes(int cap, int threads, int bins) {
  return sizeof(int32_t) *
         (2 * (size_t)cap + (size_t)bins * (threads / 32 + 2) + 33);
}

// Zero the counter table's pads; every thread of the block calls it before
// its first rank_scatter, and a barrier follows.  (Each warp zeroes its
// own column in every pass.)
__device__ void zero_pads(const Shared& s, int bins) {
  const int warps = blockDim.x >> 5;
  for (int d = threadIdx.x; d < bins; d += blockDim.x) {
    s.cnt[d * (warps + 1) + warps] = 0;
  }
}

// The pair thread t holds as its i-th: j = (t / 32) * 32 * ITEMS + 32 i +
// t % 32, so that a warp's pairs are one run of the tile, in lane order.
__device__ __forceinline__ int first_item() {
  return (threadIdx.x >> 5) * 32 * ITEMS + (threadIdx.x & 31);
}

// Exclusive prefix sum of v over the threads of the block; every thread
// calls it.
__device__ int block_exclusive_scan(int v, int32_t* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < warps ? wsum[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < warps) wsum[lane] = wi - w;
  }
  __syncthreads();
  return wsum[warp] + incl - v;
}

// The stable rank-and-scatter of one digit, bits [shift, shift + bits)
// (bits <= BLOCK_BITS), over a tile of n pairs, the thread's i-th
// (first_item() + 32 i) in key[i], col[i] where it is below n.  Leaves the
// pairs in s.key, s.col in the order of their digit, equal digits in tile
// order, and each digit's first slot in the tile at s.cnt[d * (warps +
// 1)].  Every thread of the block calls it; it ends with a barrier.
__device__ void rank_scatter(const uint32_t (&key)[ITEMS],
                             const int32_t (&col)[ITEMS], int n, int shift,
                             int bits, const Shared& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5, stride = warps + 1;
  const int bins = 1 << bits;
  int32_t* mine = s.cnt + warp;  // this warp's column: digit d at d * stride
  for (int d = lane; d < bins; d += 32) mine[d * stride] = 0;
  __syncwarp();
  const uint32_t below = (1u << lane) - 1;
  const uint32_t dmask = bins - 1;
  const int first = first_item();
  // peers[i]: the lanes whose i-th pair is valid and of the same digit;
  // the pairs' ballots are independent, so they run interleaved
  uint32_t peers[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    peers[i] = __ballot_sync(FULL, first + 32 * i < n);
  }
#pragma unroll
  for (int b = 0; b < BLOCK_BITS; ++b) {
    if (b < bits) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const bool bit = (key[i] >> (shift + b)) & 1;
        const uint32_t m = __ballot_sync(FULL, bit);
        peers[i] &= bit ? m : ~m;
      }
    }
  }
  int rank[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool valid = first + 32 * i < n;
    const uint32_t d = (key[i] >> shift) & dmask;
    int before = 0;
    if (valid) before = mine[d * stride];
    __syncwarp();
    if (valid && (peers[i] & below) == 0) {
      mine[d * stride] = before + __popc(peers[i]);
    }
    __syncwarp();
    rank[i] = before + __popc(peers[i] & below);
  }
  __syncthreads();
  // the table's exclusive scan: each thread a run of `per` entries (the
  // pads count 0 and keep it)
  const int entries = bins * stride;
  const int per = (entries + blockDim.x - 1) / blockDim.x;
  const int e0 = min(entries, (int)threadIdx.x * per);
  const int e1 = min(entries, e0 + per);
  int sum = 0;
  for (int e = e0; e < e1; ++e) sum += s.cnt[e];
  int at = block_exclusive_scan(sum, s.wsum);
  for (int e = e0, w = e0 % stride; e < e1; ++e) {
    const int c = s.cnt[e];
    if (w != warps) s.cnt[e] = at;
    at += c;
    w = w == warps ? 0 : w + 1;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (first + 32 * i < n) {
      const int slot = mine[((key[i] >> shift) & dmask) * stride] + rank[i];
      s.key[slot] = key[i];
      s.col[slot] = col[i];
    }
  }
  __syncthreads();
}

// grid (n): one block a row of U <= blockDim.x * ITEMS keys.
__global__ void __launch_bounds__(MAX_THREADS)
sort_block_kernel(const int32_t* __restrict__ key_in,
                  int32_t* __restrict__ key_out, Planes planes, int P,
                  int U) {
  extern __shared__ int32_t smem[];
  const Shared s = carve(smem, blockDim.x * ITEMS, 1 << BLOCK_BITS);
  const size_t row = (size_t)blockIdx.x * U;
  const int first = first_item();
  if (threadIdx.x == 0) *s.word = 0;
  zero_pads(s, 1 << BLOCK_BITS);
  const uint32_t k0 = (uint32_t)key_in[row] ^ SIGN;
  uint32_t key[ITEMS];
  int32_t col[ITEMS];
  uint32_t diff = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = first + 32 * i;
    key[i] = j < U ? (uint32_t)key_in[row + j] ^ SIGN : k0;
    col[i] = j;
    diff |= key[i] ^ k0;
  }
  __syncthreads();
  diff = __reduce_or_sync(FULL, diff);
  if ((threadIdx.x & 31) == 0 && diff) atomicOr(s.word, diff);
  __syncthreads();
  const Digits dg(*s.word, BLOCK_BITS);
  for (int p = 0; p < dg.passes; ++p) {
    if (p > 0) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int j = first + 32 * i;
        if (j < U) {
          key[i] = s.key[j];
          col[i] = s.col[j];
        }
      }
    }
    rank_scatter(key, col, U, dg.shift(p), dg.bits(p), s);
  }
  if (dg.passes == 0) {  // a row of one key
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = first + 32 * i;
      if (j < U) {
        s.key[j] = key[i];
        s.col[j] = col[i];
      }
    }
    __syncthreads();
  }
  // the sorted keys, then each payload plane gathered through their
  // columns, all of a thread's loads of a plane before its stores
  int32_t c[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j < U) {
      key_out[row + j] = (int32_t)(s.key[j] ^ SIGN);
      c[i] = s.col[j];
    }
  }
  for (int p = 0; p < P; ++p) {
    const int32_t* in = planes.in[p] + row;
    int32_t* out = planes.out[p] + row;
    int32_t v[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (threadIdx.x + i * blockDim.x < U) v[i] = in[c[i]];
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = threadIdx.x + i * blockDim.x;
      if (j < U) out[j] = v[i];
    }
  }
}

// The tiled kernels' blocks take a row's tiles one after another (block b:
// row b / tiles, tile b % tiles), so that the blocks in flight share a few
// rows: their scattered stores meet in L2 before they reach device memory.
struct TileOf {
  size_t row;  // the row's first element
  int rowi, begin, end;
  __device__ TileOf(int U, int tile) {
    const int tiles = (U + tile - 1) / tile;
    rowi = blockIdx.x / tiles;
    row = (size_t)rowi * U;
    begin = (blockIdx.x % tiles) * tile;
    end = min(U, begin + tile);
  }
};

// grid (n tiles), tile / ITEMS threads: ORs into diff[row] every key of
// the tile XOR the row's first key.
__global__ void diff_kernel(const int32_t* __restrict__ key_in,
                            uint32_t* __restrict__ diff, int U, int tile) {
  const TileOf t(U, tile);
  const uint32_t k0 = (uint32_t)key_in[t.row];
  uint32_t d = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = t.begin + threadIdx.x + i * blockDim.x;
    if (j < t.end) d |= (uint32_t)key_in[t.row + j] ^ k0;
  }
  d = __reduce_or_sync(FULL, d);
  if ((threadIdx.x & 31) == 0 && d) atomicOr(diff + t.rowi, d);
}

// grid (n tiles), tile / ITEMS threads: the digit counts of pass p in
// each (row, tile), into hist[row][tile][TILE_BINS].  Pass p reads the
// input keys (p = 0) or the plane pass p - 1 wrote.
__global__ void upsweep_kernel(const int32_t* __restrict__ key_in,
                               Pairs pairs, const uint32_t* __restrict__ diff,
                               int32_t* __restrict__ hist, int U, int tile,
                               int p) {
  __shared__ int32_t h[TILE_BINS];
  const TileOf t(U, tile);
  const Digits dg(diff[t.rowi], TILE_BITS);
  if (p >= dg.passes) return;
  for (int b = threadIdx.x; b < TILE_BINS; b += blockDim.x) h[b] = 0;
  const uint32_t* src = pairs.key((p - 1) & 1) + t.row;
  uint32_t k[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = t.begin + threadIdx.x + i * blockDim.x;
    if (j < t.end) {
      k[i] = p == 0 ? (uint32_t)key_in[t.row + j] ^ SIGN : src[j];
    }
  }
  __syncthreads();
  const int shift = dg.shift(p);
  const uint32_t dmask = (1u << dg.bits(p)) - 1;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (t.begin + threadIdx.x + i * blockDim.x < t.end) {
      atomicAdd(&h[(k[i] >> shift) & dmask], 1);
    }
  }
  __syncthreads();
  int32_t* out = hist + (size_t)blockIdx.x * TILE_BINS;
  for (int b = threadIdx.x; b < TILE_BINS; b += blockDim.x) out[b] = h[b];
}

// grid (n), TILE_BINS threads: pass p's counts of each row, in place,
// become the first slot of each (tile, digit) in the row: the row's
// smaller digits, then this digit in the tiles before.
__global__ void scan_kernel(const uint32_t* __restrict__ diff,
                            int32_t* __restrict__ hist, int tiles, int p) {
  __shared__ int32_t wsum[32];
  const Digits dg(diff[blockIdx.x], TILE_BITS);
  if (p >= dg.passes) return;
  int32_t* h = hist + (size_t)blockIdx.x * tiles * TILE_BINS + threadIdx.x;
  int run = 0;
#pragma unroll 8
  for (int t = 0; t < tiles; ++t) {
    const int c = h[t * TILE_BINS];
    h[t * TILE_BINS] = run;
    run += c;
  }
  const int digit_first = block_exclusive_scan(run, wsum);
  for (int t = 0; t < tiles; ++t) h[t * TILE_BINS] += digit_first;
}

// grid (n tiles), tile / ITEMS threads: pass p over each (row, tile):
// the tile's rank_scatter, then the tile written out in digit order, each
// digit's run from the slot the scan gave it.
__global__ void __launch_bounds__(MAX_THREADS)
downsweep_kernel(const int32_t* __restrict__ key_in, Pairs pairs,
                 const uint32_t* __restrict__ diff,
                 const int32_t* __restrict__ hist, int U, int p) {
  extern __shared__ int32_t smem[];
  const TileOf t(U, blockDim.x * ITEMS);
  const Digits dg(diff[t.rowi], TILE_BITS);
  if (p >= dg.passes) return;
  const Shared s = carve(smem, blockDim.x * ITEMS, TILE_BINS);
  const int n = t.end - t.begin;
  zero_pads(s, TILE_BINS);
  for (int b = threadIdx.x; b < TILE_BINS; b += blockDim.x) {
    s.dest[b] = hist[(size_t)blockIdx.x * TILE_BINS + b];
  }
  const int first = first_item();
  uint32_t key[ITEMS];
  int32_t col[ITEMS];
  const uint32_t* src_key = pairs.key((p - 1) & 1) + t.row + t.begin;
  const int32_t* src_col = pairs.col((p - 1) & 1) + t.row + t.begin;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = first + 32 * i;
    key[i] = 0;
    col[i] = 0;
    if (j < n) {
      if (p == 0) {
        key[i] = (uint32_t)key_in[t.row + t.begin + j] ^ SIGN;
        col[i] = t.begin + j;
      } else {
        key[i] = src_key[j];
        col[i] = src_col[j];
      }
    }
  }
  __syncthreads();
  const int shift = dg.shift(p), bits = dg.bits(p);
  rank_scatter(key, col, n, shift, bits, s);
  const uint32_t dmask = (1u << bits) - 1;
  const int stride = blockDim.x / 32 + 1;
  uint32_t* out_key = pairs.key(p & 1) + t.row;
  int32_t* out_col = pairs.col(p & 1) + t.row;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const uint32_t k = s.key[i];
    const int d = (k >> shift) & dmask;
    const int at = s.dest[d] + i - s.cnt[d * stride];
    out_key[at] = k;
    out_col[at] = s.col[i];
  }
}

// grid (n ceil(U / FINISH)), FINISH / ITEMS threads, a row's blocks one
// after another: the sorted keys, from the plane of the row's last pass,
// and every payload plane gathered through their columns, all of a
// thread's loads of a plane before its stores.
__global__ void finish_kernel(const int32_t* __restrict__ key_in, Pairs pairs,
                              const uint32_t* __restrict__ diff,
                              int32_t* __restrict__ key_out, Planes planes,
                              int P, int U) {
  const TileOf t(U, FINISH);
  const Digits dg(diff[t.rowi], TILE_BITS);
  const int b = (dg.passes - 1) & 1;
  const uint32_t* sk = pairs.key(b) + t.row;
  const int32_t* sc = pairs.col(b) + t.row;
  int32_t k[ITEMS], c[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = t.begin + threadIdx.x + i * blockDim.x;
    c[i] = j;
    if (j < t.end) {
      if (dg.passes == 0) {
        k[i] = key_in[t.row + j];
      } else {
        k[i] = (int32_t)(sk[j] ^ SIGN);
        if (P > 0) c[i] = sc[j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = t.begin + threadIdx.x + i * blockDim.x;
    if (j < t.end) key_out[t.row + j] = k[i];
  }
  for (int p = 0; p < P; ++p) {
    const int32_t* in = planes.in[p] + t.row;
    int32_t* out = planes.out[p] + t.row;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (t.begin + threadIdx.x + i * blockDim.x < t.end) k[i] = in[c[i]];
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int j = t.begin + threadIdx.x + i * blockDim.x;
      if (j < t.end) out[j] = k[i];
    }
  }
}

}  // namespace

#define TRY(call)                          \
  do {                                     \
    const cudaError_t e_ = (call);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

static Planes make_planes(const void* const* ins, void* const* outs, int P) {
  Planes planes = {};
  for (int p = 0; p < P; ++p) {
    planes.in[p] = (const int32_t*)ins[p];
    planes.out[p] = (int32_t*)outs[p];
  }
  return planes;
}

// Rows of up to 8192: see the head of this file.  ins, outs: host arrays
// of P device pointers to the payload planes.
extern "C" int sort_rows(const void* key_in, void* key_out,
                         const void* const* ins, void* const* outs, int n,
                         int U, int P, void* stream) {
  if (P < 0 || P > MAXP || U < 1 || U > MAX_THREADS * ITEMS) {
    return (int)cudaErrorInvalidValue;
  }
  const Planes planes = make_planes(ins, outs, P);
  // a warp for every 32 ITEMS keys
  const int threads = ((U + ITEMS - 1) / ITEMS + 31) / 32 * 32;
  const size_t smem =
      shared_bytes(threads * ITEMS, threads, 1 << BLOCK_BITS);
  TRY(cudaFuncSetAttribute(sort_block_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem));
  sort_block_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)key_in, (int32_t*)key_out, planes, P, U);
  return (int)cudaGetLastError();
}

// Rows of any width U up to 131072, in tiles of `tile` pairs (a multiple
// of 32 ITEMS, at most MAX_THREADS ITEMS): see the head of this file.  Scratch: pairs, int32 [4, n, U] (the two ping-pong planes'
// keys and columns); hist, int32 [n, ceil(U / tile), 256]; diff, int32
// [n].
extern "C" int sort_rows_tiled(const void* key_in, void* key_out, void* pairs,
                               void* hist, void* diff, const void* const* ins,
                               void* const* outs, int n, int U, int P,
                               int tile, void* stream) {
  if (P < 0 || P > MAXP || U < 1 || U > (1 << 17) ||
      tile <= 0 || tile % (32 * ITEMS) != 0 || tile > MAX_THREADS * ITEMS) {
    return (int)cudaErrorInvalidValue;
  }
  const Planes planes = make_planes(ins, outs, P);
  const Pairs pp = {(int32_t*)pairs, (size_t)n * U};
  const int32_t* in = (const int32_t*)key_in;
  uint32_t* d = (uint32_t*)diff;
  int32_t* h = (int32_t*)hist;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = tile / ITEMS;
  const int tiles = (U + tile - 1) / tile;
  const unsigned blocks = (unsigned)n * tiles;
  const size_t smem = shared_bytes(tile, threads, TILE_BINS);
  TRY(cudaFuncSetAttribute(downsweep_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem));
  TRY(cudaMemsetAsync(diff, 0, sizeof(uint32_t) * n, st));
  diff_kernel<<<blocks, threads, 0, st>>>(in, d, U, tile);
  TRY(cudaGetLastError());
  for (int p = 0; p < MAX_PASSES; ++p) {
    upsweep_kernel<<<blocks, threads, 0, st>>>(in, pp, d, h, U, tile, p);
    TRY(cudaGetLastError());
    scan_kernel<<<n, TILE_BINS, 0, st>>>(d, h, tiles, p);
    TRY(cudaGetLastError());
    downsweep_kernel<<<blocks, threads, smem, st>>>(in, pp, d, h, U, p);
    TRY(cudaGetLastError());
  }
  finish_kernel<<<(unsigned)n * ((U + FINISH - 1) / FINISH), FINISH / ITEMS,
                  0, st>>>(in, pp, d, (int32_t*)key_out, planes, P, U);
  return (int)cudaGetLastError();
}
