// LZNT1 decode parse: a warp a chunk, its tokens walked 32 at a time, one
// a lane.
//
// Replaces: tpucomp/kernels/lznt1_pallas.py parse_records (_build_kernel),
// which runs the [MS-XCA] §2.5 byte machine with one TPU vector lane per
// chunk.  The record contract is the same for the first P columns: the
// byte that completes a token (a literal, or a copy's hi byte) holds
// rec_pos[n, s] = its output position and rec_val[n, s] = the literal
// byte or COPY_BIT | disp; every other slot holds SENT and EMPTY_VAL.
// p_final is the decoded length; err flags disp > position, a copy past
// the chunk end, or a stream that ends after an active copy's lo byte.
// A token that starts at output position p >= 4096 is not parsed, and
// that is not an error.
//
// Why the tokens can be walked in parallel:
// - Byte offsets do not depend on p.  A flag group at byte g is its flag
//   byte f and 8 tokens (a literal 1 byte, a copy 2), so the next group
//   starts at g + 9 + popc(f), and token j starts at
//   g + 1 + j + popc(f & ((1 << j) - 1)).
// - p is a prefix sum of token lengths: a literal adds 1, a copy
//   (word & mask) + 3, where the mask's width d_shift =
//   12 - max(bitlen(max(p - 1, 0)) - 4, 0) depends on p only through its
//   band: p <= 16, 17..32, ..., 2049..4096.  p never decreases, so a chunk
//   crosses at most 8 band edges.
// - A scan under the band of its first token's p is exact up to the first
//   token whose start p leaves that band: that token's start p is still
//   right, only its own length must be redone under its band.
//
// Design: one warp a chunk, WARPS chunks a block.
// 1. Stage.  The warp copies the chunk's first min(len, STAGE) payload
//    bytes into its slice of shared memory with 8-byte cp.async copies
//    (payload rows of 4616 bytes are only 8-byte aligned), the ragged
//    ends byte by byte; the slice keeps the row's address mod 8.  An
//    active token never reaches byte 4609: it starts at p <= 4095, after
//    at most 4095 bytes of earlier tokens (a token adds at least as much
//    to p as it has bytes) and 512 flag bytes.
// 2. Walk windows of 32 tokens, token j0 + lane of the group at byte g.
//    Each lane finds its group's start (every lane walks the same chain
//    of four flag bytes from g), its token's offset, kind and 16-bit
//    word, and its length under the band of the window's first p.  An
//    inclusive warp scan gives each token's start p.  One ballot finds
//    the first lane whose start p left the band; another the first lane
//    at which the walk stops: its token starts at or past len, at p >=
//    4096, or is a copy whose hi byte is at or past len (err).  The lanes
//    before both are accepted.  If the first of the two is a stop, the
//    walk ends there; else the next window starts at that token, under
//    its own band (a "redone" window, at most 8 a chunk); if all 32 are
//    accepted it starts 32 tokens on.  Lanes past the stop may read
//    bytes past what was staged (stale bytes of an earlier chunk, never
//    used): g lies before byte 4610, so a window reads at most 84 bytes
//    past it, inside the slice.
// 3. Store.  Accepted lanes write their record at their token's last
//    byte, SENT / EMPTY_VAL at a copy's lo byte and at a group's flag
//    byte: every slot of the window's byte span, each store of the warp
//    within that span of about 41 slots.  After the last window the warp
//    fills the row's tail [end, P) with 16-byte stores.
//
// What bounds it: the two record planes, 8 bytes a payload byte, written
// once (303 MB at [8208, 4616]), and the payload read as far as plen,
// 0.094 ms at 3.35 TB/s; about 69% of a corpus row is the tail fill.  On
// the card the walk costs more: a window is some 135 warp instructions,
// nearly all integer ones, for 38.6 windows (5.6 of them redone) a
// corpus chunk, and the SM's integer pipes, not the memory, set the time
// (scripts/lznt1_parse_variants.py on an NVIDIA H100 80GB HBM3 at 700 W:
// 1.7x a fill_ of the two planes on the corpus, 3x on chunks of 4096
// literals, 1.06x on stored chunks).
// An SM holds 5 blocks, 40 warps (37,696 bytes of shared memory a block,
// at most 48 registers a thread), so the blocks of 8208 chunks run in
// two waves.
//
// windows[2 n] and windows[2 n + 1] count row n's windows and the redone
// ones among them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int U = 4096;
constexpr int MIN_MATCH = 3;
constexpr int SENT = 1 << 28;
constexpr int COPY_BIT = 1 << 20;
constexpr int EMPTY_VAL = COPY_BIT | 0x3FFF;
constexpr int STAGE = 4616;  // bytes staged a chunk (>= 4609)
// a slice: the row's address mod 8, then what a window may read, up to
// byte 4609 + 4 * 17 + 16
constexpr int STAGE_BYTES = 4712;
constexpr int WARPS = 8;  // chunks a block
constexpr int THREADS = 32 * WARPS;
constexpr int BLOCKS_PER_SM = 5;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ void copy8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Bytes [0, n) of the row at src into buf; returns B with B[s] == src[s].
// buf is 8-byte aligned, and B keeps src's address mod 8.
__device__ __forceinline__ const uint8_t* stage_row(uint8_t* buf,
                                                    const uint8_t* src,
                                                    int n, int lane) {
  uint8_t* dst = buf + ((uintptr_t)src & 7);
  const int head = min((int)((8 - ((uintptr_t)src & 7)) & 7), n);
  const int words = (n - head) >> 3;
  for (int k = lane; k < words; k += 32)
    copy8(dst + head + 8 * k, src + head + 8 * k);
  asm volatile("cp.async.commit_group;" ::: "memory");
  const int tail = head + 8 * words;
  if (lane < head) dst[lane] = src[lane];
  if (lane < n - tail) dst[tail + lane] = src[tail + lane];
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncwarp();
  return dst;
}

// p, kept in a register: the compiler would rebuild it from i and P at
// every store (5 instructions an address)
__device__ __forceinline__ int32_t* pinned(int32_t* p) {
  int32_t* q;
  asm volatile("mov.b64 %0, %1;" : "=l"(q) : "l"(p));
  return q;
}

// One step of an inclusive warp scan: x plus the value o lanes down.
__device__ __forceinline__ int scan_step(int x, int o) {
  int y;
  asm volatile(
      "{ .reg .s32 r; .reg .pred p;\n"
      "  shfl.sync.up.b32 r|p, %1, %2, 0, -1;\n"
      "  @p add.s32 r, r, %1;\n"
      "  mov.s32 %0, r; }"
      : "=r"(y)
      : "r"(x), "r"(o));
  return y;
}

// row[from, to) = v: 4-byte stores up to a 16-byte boundary, then 16-byte.
__device__ __forceinline__ void fill_plane(int32_t* row, int from, int to,
                                           int v, int lane) {
  if (from >= to) return;
  const int mis = (int)(((uintptr_t)(row + from) >> 2) & 3);
  const int head = min((4 - mis) & 3, to - from);
  if (lane < head) row[from + lane] = v;
  const int a = from + head;
  const int quads = (to - a) >> 2;
  int4* q = reinterpret_cast<int4*>(row + a);
  const int4 vv = make_int4(v, v, v, v);
  for (int k = lane; k < quads; k += 32) q[k] = vv;
  const int b = a + 4 * quads;
  if (lane < to - b) row[b + lane] = v;
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
lznt1_parse_kernel(const uint8_t* __restrict__ payload,
                   const int32_t* __restrict__ plen,
                   const bool* __restrict__ is_comp,
                   int32_t* __restrict__ rec_pos,
                   int32_t* __restrict__ rec_val,
                   int32_t* __restrict__ p_final,
                   int32_t* __restrict__ err,
                   int32_t* __restrict__ windows, int n, int P) {
  __shared__ __align__(16) uint8_t stage[WARPS][STAGE_BYTES];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * WARPS + w;
  if (i >= n) return;  // whole warps only: no block barrier below
  const int len = is_comp[i] ? max(min(plen[i], P), 0) : 0;
  int32_t* rp = pinned(rec_pos + (size_t)i * P);
  int32_t* rv = pinned(rec_val + (size_t)i * P);
  const uint8_t* B =
      stage_row(stage[w], payload + (size_t)i * P, min(len, STAGE), lane);

  // the window's first token: token j0 of the group at byte g, at p
  int g = 0, j0 = 0, p = 0;
  int end = 0;      // this lane's accepted slots lie before end
  bool bad = false;  // this lane's accepted copies: one malformed
  int nwin = 0, nredo = 0;
  for (bool more = len > 0; more;) {
    ++nwin;
    const int t = j0 + lane, k = t >> 3, jj = t & 7;
    // the chain of group starts: G_0 = g, ..., G_4; lane keeps G_k, f_k
    int G = g;
    unsigned f = B[G];
    int Gk = G;
    unsigned fk = f;
#pragma unroll
    for (int q = 1; q <= 4; ++q) {
      G += 9 + __popc(f);
      f = B[G];
      if (q == k) {
        Gk = G;
        fk = f;
      }
    }
    const int ts = Gk + 1 + jj + __popc(fk & ((1u << jj) - 1u));
    const int cp = (fk >> jj) & 1u;
    const unsigned lo = B[ts];
    const unsigned word = lo | (B[ts + 1] << 8);
    // the band of the window's first p
    const int dsh = 12 - max(32 - __clz(max(p - 1, 0)) - 4, 0);
    const int length =
        cp ? (int)(word & ((1u << dsh) - 1u)) + MIN_MATCH : 1;
    int incl = length;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) incl = scan_step(incl, o);
    const int sp = p + incl - length;  // the token's start p
    const bool stop = ts >= len || sp >= U || (cp && ts + 1 >= len);
    const unsigned stops = __ballot_sync(FULL, stop);
    const unsigned first = stops | __ballot_sync(FULL, sp > (1 << (16 - dsh)));
    const int e = first ? __ffs(first) - 1 : 32;
    const int slot = ts + cp;
    const int disp = (int)(word >> dsh) + 1;
    if (lane < e) {
      rp[slot] = sp;
      rv[slot] = cp ? COPY_BIT | disp : (int)lo;
      if (cp) {
        rp[ts] = SENT;
        rv[ts] = EMPTY_VAL;
      }
      if (jj == 0) {
        rp[Gk] = SENT;
        rv[Gk] = EMPTY_VAL;
      }
      end = slot + 1;
      bad |= cp && (disp > sp || sp + length > U);
    }
    // p moves to lane e's start p: exact there
    const int taken = __shfl_sync(FULL, incl, (e - 1) & 31);
    p += e ? taken : 0;
    if (e == 32) {
      g = G;  // G_4: token j0 + 32 is token j0 of group 4
      more = p < U && g < len;
    } else if ((stops >> e) & 1u) {
      // a copy cut after its lo byte
      bad |= lane == e && cp && ts < len && sp < U;
      more = false;
    } else {
      ++nredo;  // lane e's byte offsets are exact: start there
      g = __shfl_sync(FULL, Gk, e);
      j0 = __shfl_sync(FULL, jj, e);
    }
  }
  end = __reduce_max_sync(FULL, end);
  fill_plane(rp, end, P, SENT, lane);
  fill_plane(rv, end, P, EMPTY_VAL, lane);
  const int bad_row = __any_sync(FULL, bad) ? 1 : 0;
  if (lane == 0) {
    p_final[i] = min(p, U);
    err[i] = bad_row;
    windows[2 * i] = nwin;
    windows[2 * i + 1] = nredo;
  }
}

}  // namespace

extern "C" int lznt1_parse(const void* payload, const void* plen,
                           const void* is_comp, void* rec_pos, void* rec_val,
                           void* p_final, void* err, void* windows, int n,
                           int P, void* stream) {
  cudaError_t rc = cudaFuncSetAttribute(
      lznt1_parse_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (rc != cudaSuccess) return (int)rc;
  const int blocks = (n + WARPS - 1) / WARPS;
  lznt1_parse_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)payload, (const int32_t*)plen, (const bool*)is_comp,
      (int32_t*)rec_pos, (int32_t*)rec_val, (int32_t*)p_final,
      (int32_t*)err, (int32_t*)windows, n, P);
  return (int)cudaGetLastError();
}
