// Greedy parse: per row, the chain of committed positions 0 -> next(0) ->
// next(next(0)) -> ..., where next(p) = p + (is_match[p] ? best_len[p] :
// 1).  The chain ends at a position that cannot commit (okpos false),
// and after a position whose jump is 0 or less or reaches n or beyond.
// committed[p] is true iff p is on the chain; with layout set, also
// t_after[p] (tokens committed up to and including p) and data_before[p]
// (data bytes, 2 per match and 1 per literal, committed before p).
//
// Replaces: tpucomp/kernels/lz_pallas.py greedy_commit and
// greedy_commit_layout (_build_kernel), which walk one position per loop
// step with rows across the TPU's lanes: cheap there only because the
// TPU has thousands of lanes' worth of rows.  At 514 rows of 64 KiB one
// thread a row is 17 warps for 132 SMs, each a dependent chain of 65536
// steps.
//
// Here a row is cut into segments of SEG positions, one thread each (a
// team of threads a row: a warp for rows up to 4096, up to 16 warps for
// rows up to 65536), and the walk runs on all segments at once:
//
//   1. Stage.  The team loads its row coalesced and turns it into a jump
//      array in shared memory: uint16 jump = next(p) - p, 0 where the
//      chain ends at p (a jump that would reach n or beyond is 0, so
//      65536 never has to be stored).  Beside it, bitmaps of okpos and
//      (layout) is_match, built with warp shuffles.
//   2. Speculate.  Each thread walks the chain from its segment's first
//      position to its first chain position at or past the segment's
//      end (its exit), or to the chain's end; the segment's visited bits
//      stay in registers.
//   3. Repair rounds.  A thread's entry is the largest exit of the
//      segments before it, in the round before (an exclusive max scan
//      over the team).  On the true chain exits do not decrease, so that
//      is the exit of the segment just before; a match that jumps over
//      many segments reaches all of them in one round.  A thread whose
//      entry has not changed since it last walked does nothing; one whose
//      entry is past its segment clears its bits and exits at its entry;
//      any other walks from the entry until it lands on a bit of its old
//      chain (chains that meet are equal from there on: the old bits from
//      there are kept, and the old exit) or leaves the segment.  Rounds
//      repeat until no entry changed in the block (__syncthreads_or).
//      Segment 0's entry is 0 and never changes, so round r leaves
//      segments 0..r final: at most one round a segment, exact on every
//      input.  rounds[row] = 1 + the last round in which an entry of the
//      row changed.
//   4. Write.  committed = visited & okpos, through a bitmap in shared
//      memory, as coalesced 4-byte stores; with layout, per-word popcounts
//      and one exclusive scan over the team give each word's token and
//      data-byte base, and t_after / data_before follow by masked
//      popcounts, stored 16 bytes a thread.
//
// What bounds it on the card: device memory, 6 bytes read and 1 written
// a position (9 more with layout), if the rounds are few.  A 64 KiB row's
// jumps take 130 KiB of shared memory, so one block (512 threads) an SM;
// its staging, walk and stores run one after the other.  The worst case
// is a row whose chains never meet (one round a segment), which is no
// faster than a serial walk but still exact.  Each segment's jumps start
// SEG_PAD uint16 after the last, one bank on, so threads walking in step
// read 32 banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG = 128;          // positions a thread walks
constexpr int WPS = SEG / 32;     // its bitmap words
constexpr int SEG_PAD = SEG + 2;  // uint16 stride of a segment's jumps
constexpr int MAX_N = 1 << 16;    // jumps fit in uint16
constexpr int BLOCK_MIN = 128;    // rows of few segments share a block
constexpr unsigned FULL = 0xffffffffu;

#define TRY(call)                               \
  do {                                          \
    const cudaError_t e_ = (call);              \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

__host__ __device__ inline int align4(int x) { return (x + 3) & ~3; }

// One row's slot of shared memory, offsets in 32-bit words, each array
// 16-byte aligned.  T is the team's thread count.
struct RowSlot {
  int wt, rmax, okw, cw, mw, tb, db, jmp, words;
  __host__ __device__ RowSlot(int n, int T, bool layout) {
    const int nseg = (n + SEG - 1) / SEG;
    const int W = nseg * WPS;
    int o = 0;
    wt = o;  // per-warp scan totals: exits, or (tokens, data bytes)
    o += align4(2 * (T / 32));
    rmax = o;  // the row's last round with a change
    o += 4;
    okw = o;
    o += W;
    cw = o;
    o += W;
    mw = o;
    o += layout ? W : 0;
    tb = o;
    o += layout ? W : 0;
    db = o;
    o += layout ? W : 0;
    jmp = o;  // uint16 [nseg * SEG_PAD]
    o += nseg * SEG_PAD / 2;
    words = align4(o);
  }
};

// The uint16 jump of a position with `room` = n - p >= 1 positions left.
__device__ __forceinline__ uint32_t jump_of(bool ok, bool m, int bl,
                                            int room) {
  const int step = m ? bl : 1;
  return ok && step > 0 && step < room ? (uint32_t)step : 0u;
}

__device__ __forceinline__ uint32_t pick(const uint32_t (&b)[WPS], int w) {
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < WPS; ++k) r = k == w ? b[k] : r;
  return r;
}

// Walk the chain from position p through segment [s0, s1), whose jumps
// start at jseg.  bits: in, the segment's old chain (which exits at
// old_exit); out, the new one.  Returns the new exit: the first chain
// position at or past s1, or `end` if the chain ends inside.
__device__ __forceinline__ int walk(const uint16_t* __restrict__ jseg,
                                    int p, int s0, int s1, int end,
                                    uint32_t (&bits)[WPS], int old_exit) {
  uint32_t nb[WPS];
#pragma unroll
  for (int k = 0; k < WPS; ++k) nb[k] = 0;
  int keep = SEG;  // old bits kept from this offset on
  int exit;
  for (;;) {
    if (p >= s1) {
      exit = p;
      break;
    }
    const int o = p - s0;
    const uint32_t m = 1u << (o & 31);
    if (pick(bits, o >> 5) & m) {  // met the old chain
      keep = o;
      exit = old_exit;
      break;
    }
#pragma unroll
    for (int k = 0; k < WPS; ++k) nb[k] |= k == (o >> 5) ? m : 0u;
    const int j = jseg[o];
    if (j == 0) {
      exit = end;
      break;
    }
    p += j;
  }
#pragma unroll
  for (int k = 0; k < WPS; ++k) {
    const int lo = 32 * k;
    const uint32_t km =
        keep <= lo ? FULL : keep >= lo + 32 ? 0u : FULL << (keep - lo);
    bits[k] = nb[k] | (bits[k] & km);
  }
  return exit;
}

// Stage, 4 positions a thread and iteration (n % 4 == 0, aligned rows).
template <bool LAYOUT>
__device__ void stage_vec(const uint8_t* __restrict__ is_match,
                          const int32_t* __restrict__ best_len,
                          const uint8_t* __restrict__ okpos, size_t base,
                          int n, int T, int seg, int iters, int words,
                          uint16_t* jump, uint32_t* okw, uint32_t* mw) {
  constexpr int U = 4;  // iterations whose loads are in flight together
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < iters; k0 += U) {
    uint32_t m4[U], o4[U];
    int4 b4[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = 4 * ((k0 + u) * T + seg);
      m4[u] = o4[u] = 0;
      b4[u] = make_int4(0, 0, 0, 0);
      if (k0 + u < iters && i < n) {
        m4[u] = __ldg((const uint32_t*)(is_match + base + i));
        o4[u] = __ldg((const uint32_t*)(okpos + base + i));
        b4[u] = __ldg((const int4*)(best_len + base + i));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u >= iters) break;  // uniform across the team
      const int i = 4 * ((k0 + u) * T + seg);
      uint32_t okn = 0, mn = 0;
      if (i < n) {
        const int bl[4] = {b4[u].x, b4[u].y, b4[u].z, b4[u].w};
        uint32_t j[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = (o4[u] >> (8 * q)) & 0xff;
          const bool m = (m4[u] >> (8 * q)) & 0xff;
          okn |= (uint32_t)ok << q;
          mn |= (uint32_t)m << q;
          j[q] = jump_of(ok, m, bl[q], n - i - q);
        }
        uint32_t* js = (uint32_t*)(jump + i + 2 * (i / SEG));
        js[0] = j[0] | j[1] << 16;
        js[1] = j[2] | j[3] << 16;
      }
      // 8 lanes hold a word's 32 bits, 4 each
      uint32_t ow = okn << ((4 * lane) & 31), mwv = mn << ((4 * lane) & 31);
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        ow |= __shfl_xor_sync(FULL, ow, o);
        if (LAYOUT) mwv |= __shfl_xor_sync(FULL, mwv, o);
      }
      if ((lane & 7) == 0 && i < words * 32) {
        okw[i >> 5] = ow;
        if (LAYOUT) mw[i >> 5] = mwv;
      }
    }
  }
}

// Stage, one position a thread and iteration (any width or alignment).
template <bool LAYOUT>
__device__ void stage_scalar(const uint8_t* __restrict__ is_match,
                             const int32_t* __restrict__ best_len,
                             const uint8_t* __restrict__ okpos, size_t base,
                             int n, int T, int seg, int iters, int words,
                             uint16_t* jump, uint32_t* okw, uint32_t* mw) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < iters; ++k) {
    const int i = k * T + seg;
    bool ok = false, m = false;
    if (i < n) {
      ok = okpos[base + i] != 0;
      m = is_match[base + i] != 0;
      jump[i + 2 * (i / SEG)] =
          (uint16_t)jump_of(ok, m, best_len[base + i], n - i);
    }
    const uint32_t ow = __ballot_sync(FULL, ok);
    const uint32_t mwv = LAYOUT ? __ballot_sync(FULL, m) : 0u;
    if (lane == 0 && i < words * 32) {
      okw[i >> 5] = ow;
      if (LAYOUT) mw[i >> 5] = mwv;
    }
  }
}

// One block holds blockDim.x / T rows, a team of T threads (a multiple of
// 32, one segment a thread) each.
template <bool VEC, bool LAYOUT>
__global__ void __launch_bounds__(512)
greedy_commit_kernel(const uint8_t* __restrict__ is_match,
                     const int32_t* __restrict__ best_len,
                     const uint8_t* __restrict__ okpos,
                     uint8_t* __restrict__ committed,
                     int32_t* __restrict__ t_after,
                     int32_t* __restrict__ data_before,
                     int32_t* __restrict__ rounds, int N, int n, int T) {
  extern __shared__ __align__(16) uint32_t smem[];
  const RowSlot L(n, T, LAYOUT);
  const int local = threadIdx.x / T;
  const int seg = threadIdx.x % T;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x / T) + local;
  const bool live = row < N;  // uniform across the team
  const int nseg = (n + SEG - 1) / SEG;
  uint32_t* slot = smem + (size_t)local * L.words;
  int32_t* wt = (int32_t*)slot + L.wt;
  int* rmax = (int*)slot + L.rmax;
  uint32_t* okw = slot + L.okw;
  uint32_t* cw = slot + L.cw;
  uint32_t* mw = slot + L.mw;
  int32_t* tb = (int32_t*)slot + L.tb;
  int32_t* db = (int32_t*)slot + L.db;
  uint16_t* jump = (uint16_t*)(slot + L.jmp);
  const size_t base = (size_t)(live ? row : 0) * n;

  // ---- 1. stage
  if (live) {
    if (VEC) {
      const int iters = (nseg * SEG + 4 * T - 1) / (4 * T);
      stage_vec<LAYOUT>(is_match, best_len, okpos, base, n, T, seg, iters,
                        nseg * WPS, jump, okw, mw);
    } else {
      const int iters = (nseg * SEG + T - 1) / T;
      stage_scalar<LAYOUT>(is_match, best_len, okpos, base, n, T, seg, iters,
                           nseg * WPS, jump, okw, mw);
    }
  }
  if (seg == 0) *rmax = 0;
  __syncthreads();

  // ---- 2. speculate
  const int s0 = seg * SEG, s1 = min(s0 + SEG, n);
  const bool walks = live && s0 < n;
  const uint16_t* jseg = jump + seg * SEG_PAD;
  uint32_t bits[WPS];
#pragma unroll
  for (int k = 0; k < WPS; ++k) bits[k] = 0;
  int exit = n, last = s0;  // n: the chain has ended
  if (walks) exit = walk(jseg, s0, s0, s1, n, bits, n);

  // ---- 3. repair rounds
  const int wi = seg >> 5;  // the thread's warp in its team
  int lastr = 0;
  for (int r = 1;; ++r) {
    // entry: the largest exit of the segments before, an exclusive max
    // scan over the team (0 for segment 0)
    int incl = exit;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl = max(incl, x);
    }
    int entry = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) entry = 0;
    if (lane == 31) wt[wi] = incl;
    __syncthreads();
    for (int k = 0; k < wi; ++k) entry = max(entry, wt[k]);
    const bool ch = walks && entry != last;
    if (ch) {
      exit = walk(jseg, entry, s0, s1, n, bits, exit);
      last = entry;
      lastr = r;
    }
    if (!__syncthreads_or(ch)) break;
  }
  if (lastr) atomicMax(rmax, lastr);

  // ---- 4. write
  uint32_t c[WPS];
  if (walks) {
    const uint4 ok = *(const uint4*)(okw + seg * WPS);
    c[0] = bits[0] & ok.x;
    c[1] = bits[1] & ok.y;
    c[2] = bits[2] & ok.z;
    c[3] = bits[3] & ok.w;
    *(uint4*)(cw + seg * WPS) = make_uint4(c[0], c[1], c[2], c[3]);
  }
  if (LAYOUT) {
    uint32_t cm[WPS];
    int tok = 0, dat = 0;
    if (walks) {
      const uint4 m = *(const uint4*)(mw + seg * WPS);
      cm[0] = c[0] & m.x;
      cm[1] = c[1] & m.y;
      cm[2] = c[2] & m.z;
      cm[3] = c[3] & m.w;
#pragma unroll
      for (int k = 0; k < WPS; ++k) {
        tok += __popc(c[k]);
        dat += __popc(c[k]) + __popc(cm[k]);
      }
    }
    // exclusive scan of (tok, dat) over the team
    int itok = tok, idat = dat;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(FULL, itok, o);
      const int b = __shfl_up_sync(FULL, idat, o);
      if (lane >= o) {
        itok += a;
        idat += b;
      }
    }
    if (lane == 31) {
      wt[2 * wi] = itok;
      wt[2 * wi + 1] = idat;
    }
    __syncthreads();
    int btok = itok - tok, bdat = idat - dat;
    for (int k = 0; k < wi; ++k) {
      btok += wt[2 * k];
      bdat += wt[2 * k + 1];
    }
    if (walks) {
#pragma unroll
      for (int k = 0; k < WPS; ++k) {
        tb[seg * WPS + k] = btok;
        db[seg * WPS + k] = bdat;
        btok += __popc(c[k]);
        bdat += __popc(c[k]) + __popc(cm[k]);
      }
    }
  }
  __syncthreads();
  if (!live) return;
  if (seg == 0) rounds[row] = 1 + *rmax;
  if (VEC) {
    for (int i = 4 * seg; i < n; i += 4 * T) {
      const int w = i >> 5, sh = i & 31;
      const uint32_t cv = cw[w];
      const uint32_t nib = cv >> sh;
      *(uint32_t*)(committed + base + i) =
          (nib & 1) | (nib >> 1 & 1) << 8 | (nib >> 2 & 1) << 16 |
          (nib >> 3 & 1) << 24;
      if (LAYOUT) {
        const uint32_t cmv = cv & mw[w];
        const int t0 = tb[w], d0 = db[w];
        int ta[4], dv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t below = (1u << (sh + q)) - 1u;
          const int before = __popc(cv & below);
          ta[q] = t0 + before + (int)(nib >> q & 1);
          dv[q] = d0 + before + __popc(cmv & below);
        }
        *(int4*)(t_after + base + i) = make_int4(ta[0], ta[1], ta[2], ta[3]);
        *(int4*)(data_before + base + i) =
            make_int4(dv[0], dv[1], dv[2], dv[3]);
      }
    }
  } else {
    for (int i = seg; i < n; i += T) {
      const int w = i >> 5, sh = i & 31;
      const uint32_t cv = cw[w];
      const uint32_t bit = cv >> sh & 1;
      committed[base + i] = (uint8_t)bit;
      if (LAYOUT) {
        const uint32_t below = (1u << sh) - 1u;
        const int before = __popc(cv & below);
        t_after[base + i] = tb[w] + before + (int)bit;
        data_before[base + i] = db[w] + before + __popc(cv & mw[w] & below);
      }
    }
  }
}

typedef void (*Kernel)(const uint8_t*, const int32_t*, const uint8_t*,
                       uint8_t*, int32_t*, int32_t*, int32_t*, int, int, int);

}  // namespace

// committed: bool [n_rows, n]; t_after, data_before: int32 [n_rows, n]
// (read only when layout is set); rounds: int32 [n_rows], each row's
// round count.  n is at most 65536.
extern "C" int greedy_commit(const void* is_match, const void* best_len,
                             const void* okpos, void* committed,
                             void* t_after, void* data_before, void* rounds,
                             int n_rows, int n, int layout, void* stream) {
  if (n_rows < 1 || n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  const int nseg = (n + SEG - 1) / SEG;
  const int T = (nseg + 31) / 32 * 32;
  const int R = T < BLOCK_MIN ? BLOCK_MIN / T : 1;
  uintptr_t a4 = (uintptr_t)is_match | (uintptr_t)okpos |
                 (uintptr_t)committed, a16 = (uintptr_t)best_len;
  if (layout) a16 |= (uintptr_t)t_after | (uintptr_t)data_before;
  const bool vec = n % 4 == 0 && a4 % 4 == 0 && a16 % 16 == 0;
  const Kernel kernels[2][2] = {
      {greedy_commit_kernel<false, false>, greedy_commit_kernel<false, true>},
      {greedy_commit_kernel<true, false>, greedy_commit_kernel<true, true>}};
  const Kernel kernel = kernels[vec][layout != 0];
  const size_t smem = (size_t)R * RowSlot(n, T, layout != 0).words * 4;
  TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem));
  kernel<<<(n_rows + R - 1) / R, R * T, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)is_match, (const int32_t*)best_len,
      (const uint8_t*)okpos, (uint8_t*)committed, (int32_t*)t_after,
      (int32_t*)data_before, (int32_t*)rounds, n_rows, n, T);
  return (int)cudaGetLastError();
}
