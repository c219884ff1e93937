// Run matcher: for each displacement d, the length of the run of
// x[q] == x[q - d] starting at each position p (0 where p < d).  A block
// takes a tile of 4096 positions of a row, every displacement of the
// launch at once.
//
// Replaces: tpucomp/kernels/runs_pallas.py run_matchlens_fused
// (_build_kernel), which counts the run with a suffix-doubling recurrence
// over VMEM-resident rows, log2(U) shift rounds per displacement.  Here
// the same function is ml[p] = nxt(p) - p, where nxt(p) is the first
// q >= p that is a break: q < d, q >= U or x[q] != x[q - d].  Runs reach
// into the row's zero padding past a chunk's end exactly as tpucomp's do.
//
// What bounds it on the card: device memory, and almost all of it the
// stores.  A row reads U bytes and writes U int32 per displacement: at
// [8208, 4096] and d = 1, 2, 3, 34 MB in and 403 MB out; at [514, 65536]
// 34 MB in and 404 MB out.  The design keeps every SM busy with stores:
// - Tiles, not rows: a block a tile of TILE positions, whatever U is
//   (8208 blocks at LZNT1's shape, 8224 at [514, 65536]), and no row
//   held whole in shared memory, so the row width does not touch the
//   shared memory.
// - One load for all displacements: a thread reads its 16 bytes with one
//   16-byte load, and for each d the 16 bytes d before them (the
//   neighbour's bytes for d <= 16, served by L1; further back from L1 or
//   L2); the break masks of every d come from byte compares in registers
//   (__vcmpeq4), and each position's next break in the thread's segment
//   from __ffs of its mask.
// - One block exchange for all d together: a warp finds the first later
//   lane with a break by a ballot, and the warps' first breaks, with the
//   carry from later tiles, meet in shared memory across one barrier.
// - The carry across tiles, the first break at or after the tile's end:
//   where a row has several tiles, a first kernel writes each (row, tile,
//   d)'s first break, a warp a tile scanning from the tile's start until
//   every d has one (512 bytes of most tiles; at most the tile's bytes
//   once more, 8% of the traffic, on rows of runs); the main kernel takes
//   the least of its later tiles'.  Bounded: no warp looks past its tile.
// - Stores: each warp passes its 512 lengths of a d through a swizzled
//   shared-memory stage (conflict-free both ways), then writes them as
//   16-byte stores, each warp instruction 512 contiguous bytes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER = 16;  // contiguous positions per thread: one 16-byte load
constexpr int TILE = THREADS * PER;
constexpr int MAXD = 4;
constexpr int NONE = INT_MAX;  // no break found
constexpr int FIRST_WARPS = 8;  // tiles a block of the first kernel

struct Params {
  const uint8_t* x;
  int32_t* first;  // [n, T, MAXD]: each tile's first break per d
  int32_t* out;    // [D, n, U]
  int n, U, T, D;
  int d[MAXD];
  int vec_in;   // x 16-byte aligned and U % 16 == 0: 16-byte loads
  int vec_out;  // out 16-byte aligned and U % 4 == 0: 16-byte stores
};

// The 16 bytes of a row at [a, a + 16), a a multiple of 16; 0 outside
// [0, U) (such positions are breaks whatever the bytes).
__device__ __forceinline__ uint4 chunk16(const uint8_t* row, int a, int U) {
  if (a < 0 || a >= U) return make_uint4(0, 0, 0, 0);
  return __ldg(reinterpret_cast<const uint4*>(row + a));
}

// Bytes [s, s + 16) of the 32 bytes lo:hi (little-endian), s in [0, 16).
__device__ __forceinline__ uint4 shift16(uint4 lo, uint4 hi, int s) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = s >> 2, r = (s & 3) * 8;
  uint32_t a[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    // w[q + i] with a uniform q: selects, no local-memory indexing
    uint32_t v = w[i];
    if (q == 1) v = w[i + 1];
    if (q == 2) v = w[i + 2];
    if (q == 3 && i + 3 < 8) v = w[i + 3];
    a[i] = v;
  }
  return make_uint4(__funnelshift_r(a[0], a[1], r),
                    __funnelshift_r(a[1], a[2], r),
                    __funnelshift_r(a[2], a[3], r),
                    __funnelshift_r(a[3], a[4], r));
}

// The 16 bytes at [a, a + 16), any a, one byte load each (rows that are
// not 16-byte aligned); 0 outside [0, U).
__device__ __forceinline__ uint4 bytes16(const uint8_t* row, int a, int U) {
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int q = a + k;
    const uint32_t b = (q >= 0 && q < U) ? row[q] : 0u;
    w[k >> 2] |= b << (8 * (k & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One bit per byte: bit k set where byte k of a equals byte k of b.
__device__ __forceinline__ uint32_t eq_mask(uint4 a, uint4 b) {
  const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t e = __vcmpeq4(aw[i], bw[i]) & 0x01010101u;
    e = (e | (e >> 7) | (e >> 14) | (e >> 21)) & 0xFu;
    m |= e << (4 * i);
  }
  return m;
}

// The break masks of the thread's 16 positions [p0, p0 + 16), one per d:
// bit k set where p0 + k is a break.
__device__ __forceinline__ void break_masks(const Params& P, int row, int p0,
                                            uint32_t (&brk)[MAXD]) {
  const uint8_t* xr = P.x + (size_t)row * P.U;
  const uint4 cur = P.vec_in ? chunk16(xr, p0, P.U) : bytes16(xr, p0, P.U);
  uint32_t edge = 0;  // positions at or past U
  if (P.U - p0 < PER) edge = 0xFFFFu << max(P.U - p0, 0);
#pragma unroll
  for (int di = 0; di < MAXD; ++di) {
    brk[di] = 0;
    if (di >= P.D) continue;
    const int d = P.d[di];
    uint4 prv;
    if (p0 + PER <= d) {  // every position lies before d
      brk[di] = 0xFFFFu;
      continue;
    }
    if (P.vec_in) {
      const int s = (p0 - d) & 15, a = (p0 - d) - s;
      const uint4 lo = chunk16(xr, a, P.U);
      prv = s ? shift16(lo, chunk16(xr, a + 16, P.U), s) : lo;
    } else {
      prv = bytes16(xr, p0 - d, P.U);
    }
    uint32_t b = ~eq_mask(cur, prv) & 0xFFFFu;
    if (d > p0) b |= (1u << (d - p0)) - 1;  // q < d
    brk[di] = (b | edge) & 0xFFFFu;
  }
}

// First kernel, rows of several tiles: each tile's first break per d.  A
// warp takes a tile and scans it from its start, 32 * PER positions a
// step, until every d has a break: one step on most tiles, every step
// (each byte read once) only where a d has a run across the whole tile.
__global__ void __launch_bounds__(FIRST_WARPS * 32)
tile_first_kernel(Params P) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * FIRST_WARPS + (threadIdx.x >> 5);
  if (t >= P.n * P.T) return;
  const int row = t / P.T, base = (t % P.T) * TILE;
  int found = NONE;  // lane di < D: d[di]'s first break
  uint32_t pending = (1u << P.D) - 1;  // the d's with none yet
  for (int p = base; pending && p < base + TILE; p += 32 * PER) {
    const int p0 = p + lane * PER;
    uint32_t brk[MAXD];
    break_masks(P, row, p0, brk);
#pragma unroll
    for (int di = 0; di < MAXD; ++di) {
      const uint32_t bal = __ballot_sync(0xFFFFFFFFu, brk[di] != 0);
      const int fb = brk[di] ? p0 + __ffs(brk[di]) - 1 : NONE;
      const int f = __shfl_sync(0xFFFFFFFFu, fb, bal ? __ffs(bal) - 1 : 0);
      if ((pending >> di & 1) && bal) {
        if (lane == di) found = f;
        pending &= ~(1u << di);
      }
    }
  }
  if (lane < MAXD) P.first[(size_t)t * MAXD + lane] = found;
}

__global__ void __launch_bounds__(THREADS) run_matchlens_kernel(Params P) {
  // wfirst[di][w]: warp w's first break; [di][WARPS]: the carry
  __shared__ int wfirst[MAXD][WARPS + 1];
  __shared__ __align__(16) int32_t stage[WARPS][32 * PER];
  const int row = blockIdx.x / P.T, tile = blockIdx.x % P.T;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int base = tile * TILE, p0 = base + threadIdx.x * PER;
  uint32_t brk[MAXD];
  break_masks(P, row, p0, brk);

  // the first later break in this warp, by ballot; the warp's first
  int right[MAXD];
#pragma unroll
  for (int di = 0; di < MAXD; ++di) {
    const int fb = brk[di] ? p0 + __ffs(brk[di]) - 1 : NONE;
    const uint32_t bal = __ballot_sync(0xFFFFFFFFu, brk[di] != 0);
    const uint32_t later = lane == 31 ? 0u : bal & (0xFFFFFFFEu << lane);
    const int r = __shfl_sync(0xFFFFFFFFu, fb, later ? __ffs(later) - 1 : 0);
    right[di] = later ? r : NONE;
    const int wf = __shfl_sync(0xFFFFFFFFu, fb, bal ? __ffs(bal) - 1 : 0);
    if (lane == 0) wfirst[di][w] = bal ? wf : NONE;
  }
  if (w == WARPS - 1) {
    // the carry: the first break at or after the tile's end, the least
    // of the later tiles' first breaks (positions from U on are breaks)
#pragma unroll
    for (int di = 0; di < MAXD; ++di) {
      int c = P.U;
      for (int t = tile + 1 + lane; t < P.T; t += 32)
        c = min(c, P.first[((size_t)row * P.T + t) * MAXD + di]);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        c = min(c, __shfl_xor_sync(0xFFFFFFFFu, c, off));
      if (lane == 0) wfirst[di][WARPS] = c;
    }
  }
  __syncthreads();

  int32_t* st = stage[w];
  const int wbase = base + w * 32 * PER;  // the warp's first position
  const int wlen = P.U - wbase;           // its positions inside the row
#pragma unroll
  for (int di = 0; di < MAXD; ++di) {
    if (di >= P.D) break;
    int r = right[di];
    for (int k = w + 1; r == NONE; ++k) r = wfirst[di][k];  // carry: never NONE
    // the lengths of the thread's 16 positions, staged as 4 chunks of 4
    // at chunk index lane * 4 + (c ^ ((lane >> 1) & 3)): conflict-free
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * c + j;
        const uint32_t nb = brk[di] >> k;
        v[j] = (nb ? p0 + k + __ffs(nb) - 1 : r) - (p0 + k);
      }
      reinterpret_cast<int4*>(st)[lane * 4 + (c ^ ((lane >> 1) & 3))] =
          make_int4(v[0], v[1], v[2], v[3]);
    }
    __syncwarp();
    int32_t* o = P.out + ((size_t)di * P.n + row) * P.U + wbase;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = j * 32 + lane;  // output chunk: positions 4g .. 4g + 3
      const int t = g >> 2, c = g & 3;
      const int4 v =
          reinterpret_cast<const int4*>(st)[t * 4 + (c ^ ((t >> 1) & 3))];
      if (P.vec_out && 4 * g + 3 < wlen) {
        reinterpret_cast<int4*>(o)[g] = v;
      } else {
        const int vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * g + i < wlen) o[4 * g + i] = vv[i];
      }
    }
    __syncwarp();  // the stage is rewritten for the next d
  }
}

}  // namespace

extern "C" int run_matchlens(const void* x, void* first, void* out, int n,
                             int U, int D, int d0, int d1, int d2, int d3,
                             void* stream) {
  if (D < 1 || D > MAXD) return (int)cudaErrorInvalidValue;
  Params P;
  P.x = (const uint8_t*)x;
  P.first = (int32_t*)first;
  P.out = (int32_t*)out;
  P.n = n;
  P.U = U;
  P.T = (U + TILE - 1) / TILE;
  P.D = D;
  P.d[0] = d0;
  P.d[1] = d1;
  P.d[2] = d2;
  P.d[3] = d3;
  P.vec_in = ((uintptr_t)x % 16 == 0) && U % 16 == 0;
  P.vec_out = ((uintptr_t)out % 16 == 0) && U % 4 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (P.T > 1) {
    tile_first_kernel<<<(n * P.T + FIRST_WARPS - 1) / FIRST_WARPS,
                        FIRST_WARPS * 32, 0, s>>>(P);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  run_matchlens_kernel<<<n * P.T, THREADS, 0, s>>>(P);
  return (int)cudaGetLastError();
}
