// Records -> dense per-byte planes (value mod 2^22, token position mod
// 2^17) and an overflow flag, as tiles of record slots that each write
// their own spans of the row.
//
// Replaces: tpucomp/kernels/fill_pallas.py fill_records_delta2_fused
// (_build_kernel), with the contract of common.fill_records_delta2 for any
// record count R: records with 0 <= pos < U are real; byte j takes the
// last real record (by slot) with pos <= j, 0 where there is none; ovf
// flags more than keep distinct real records (the last of each run of
// adjacent equal positions counts).  The value-only form (WITH_POS false)
// is common.fill_records_delta, LZNT1's fill: no position plane, no ovf.
// tpucomp reaches that with log-depth compaction, delta expansion and
// prefix sums, because the TPU has no scatter.
//
// The spans.  Record i owns bytes [p_i, e_i), e_i the least real position
// in a later slot (U after the last).  A record whose span is empty is
// overwritten (the earlier of an equal run, or one a later record passes
// under when positions do decrease, as in a malformed stream); the
// others partition [min p, U) with their starts rising by slot, so every
// byte is written once, from shared memory, with no scatter and no
// gather.  For the non-decreasing rows of every parse, e_i is simply the
// next real position.
//
// What bounds it on the card: device memory.  The least traffic is
// rec_pos read once (each slot says whether its record is real), rec_val
// only where a record is real, and the planes written once.  A row's
// slots are cut into T tiles of at most K * THREADS = 8192, one block a
// tile, so the grid has N * T blocks (4368 at XH's [546, 65536], 8208 for
// LZNT1) of up to 512 threads.  A block loads its tile's positions with
// 16-byte loads, K consecutive slots a thread held in registers, and a
// thread loads its K values only when one of its slots is real (LZNT1's
// rows end in a long empty tail); finds each slot's e_i by a suffix-min
// scan; compacts the records with non-empty spans into shared memory by
// a prefix-sum scan; then its threads write the tile's whole output
// range [first start, carry) as 16-byte vectors of both planes, each
// vector's record found by a binary search of the compacted starts, so a
// long span (the zeros unit's single match) is split across all the
// block's threads.
//
// Tile edges.  A tile needs the least real position after it (its carry,
// past any empty run such as XH's tail) and the row needs its least
// position (bytes before it are 0) and its distinct count.  For T > 1 a
// first pass over rec_pos alone writes one (min, count) pair a tile; the
// fill reads the row's T pairs.  Tile t also zeroes [0, row min) within
// its t-th share of the row, and a tile with no non-empty span loads
// nothing more.  A row of at most 8192 slots (LZNT1's 4616) is one tile,
// with no first pass.  XH's rows are a dense prefix and an empty tail:
// the fill loads only the prefix's tiles, which pays for the first
// pass's read of rec_pos.  No global scratch plane, no global atomic.  On
// an NVIDIA H100 80GB HBM3 at 700 W, back to back: 1.70x the bound for
// LZNT1's value plane, 1.76x for XH's planes, 1.64x for plain Xpress's,
// whose first pass reads rec_pos a second time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 16;          // consecutive slots a thread
constexpr int THREADS = 512;   // most threads a block
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 32;  // a scan's scratch: one int a lane of warp 0
constexpr int VEC = 4;         // ints a vector store
constexpr int V_MASK = (1 << 22) - 1;
constexpr int P_MASK = (1 << 17) - 1;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ bool is_real(int p, int U) {
  return (unsigned)p < (unsigned)U;
}

// A thread's K slots [s0, s0 + K) of one row plane; slots at or past end
// read as -1 (an empty record).
__device__ __forceinline__ void load_slots(const int32_t* __restrict__ row,
                                           int s0, int end, bool vec,
                                           int (&x)[K]) {
  if (vec && s0 + K <= end) {
#pragma unroll
    for (int c = 0; c < K; c += 4) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(row + s0 + c));
      x[c] = a.x; x[c + 1] = a.y; x[c + 2] = a.z; x[c + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < K; ++c) x[c] = s0 + c < end ? __ldg(row + s0 + c) : -1;
  }
}

// The real slots of p that end their run of adjacent equal positions;
// nxt is the position of the slot after the thread's last.
__device__ __forceinline__ int distinct(const int (&p)[K], int nxt, int U) {
  int cnt = 0;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const int next = c + 1 < K ? p[c + 1] : nxt;
    cnt += is_real(p[c], U) && next != p[c];
  }
  return cnt;
}

// The slot after each thread's last, for distinct(): the next thread's
// first slot, or past the tile's end the row's next slot (-1 past R).
__device__ __forceinline__ int next_slot(const int (&p)[K], int s0, int end,
                                         int R, const int32_t* __restrict__ rp,
                                         int* first) {
  first[threadIdx.x] = p[0];
  __syncthreads();
  if (s0 + K < end) return first[threadIdx.x + 1];
  return s0 + K == end && end < R ? __ldg(rp + end) : -1;
}

__device__ __forceinline__ int block_sum(int x, int* tmp) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  x = __reduce_add_sync(FULL, x);
  if (lane == 0) tmp[w] = x;
  __syncthreads();
  int s = 0;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) s += tmp[k];
  return s;
}

// Exclusive prefix sum over the block's threads; *total gets the sum.
__device__ int block_excl_sum(int x, int* tmp, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) tmp[w] = inc;
  __syncthreads();
  if (w == 0) {
    int t = lane < nw ? tmp[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, t, off);
      if (lane >= off) t += y;
    }
    tmp[lane] = t;
  }
  __syncthreads();
  *total = tmp[nw - 1];
  return inc - x + (w > 0 ? tmp[w - 1] : 0);
}

// Exclusive suffix min over the block's threads (ident past the last);
// *total gets the block's min.
__device__ int block_excl_suffix_min(int x, int ident, int* tmp, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_down_sync(FULL, inc, off);
    if (lane + off < 32) inc = min(inc, y);
  }
  if (lane == 0) tmp[w] = inc;
  __syncthreads();
  if (w == 0) {
    int t = lane < nw ? tmp[lane] : ident;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_down_sync(FULL, t, off);
      if (lane + off < 32) t = min(t, y);
    }
    tmp[lane] = t;
  }
  __syncthreads();
  *total = tmp[0];
  int ex = __shfl_down_sync(FULL, inc, 1);
  if (lane == 31) ex = ident;
  return w + 1 < nw ? min(ex, tmp[w + 1]) : ex;
}

// Write constant planes over [a, b) of a row, vectors where whole.
template <bool WITH_POS>
__device__ void fill_const(int32_t* vo, int32_t* po, int a, int b, int v,
                           int p, bool vec) {
  for (int q = a / VEC + (int)threadIdx.x; q * VEC < b; q += blockDim.x) {
    const int j0 = q * VEC;
    if (vec && j0 >= a && j0 + VEC <= b) {
      *reinterpret_cast<int4*>(vo + j0) = make_int4(v, v, v, v);
      if (WITH_POS) *reinterpret_cast<int4*>(po + j0) = make_int4(p, p, p, p);
    } else {
      for (int j = max(j0, a); j < min(j0 + VEC, b); ++j) {
        vo[j] = v;
        if (WITH_POS) po[j] = p;
      }
    }
  }
}

// First pass of a row of T > 1 tiles: each tile's least real position (U
// if none) and distinct count, into summary[n, t, 0:2].
__global__ void __launch_bounds__(THREADS)
fill_summary_kernel(const int32_t* __restrict__ rec_pos,
                    int32_t* __restrict__ summary, int R, int U, int T,
                    int TS, int vec) {
  __shared__ int first[THREADS + 1];
  __shared__ int tmp_min[WARPS], tmp_cnt[WARPS];
  const int n = blockIdx.x / T, t = blockIdx.x % T;
  const int32_t* rp = rec_pos + (size_t)n * R;
  const int end = min(t * TS + TS, R);
  const int s0 = t * TS + threadIdx.x * K;
  int p[K];
  load_slots(rp, s0, end, vec, p);
  const int nxt = next_slot(p, s0, end, R, rp, first);
  int m = U;
#pragma unroll
  for (int c = 0; c < K; ++c) m = is_real(p[c], U) ? min(m, p[c]) : m;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int cnt = __reduce_add_sync(FULL, distinct(p, nxt, U));
  m = __reduce_min_sync(FULL, m);
  if (lane == 0) {
    tmp_min[w] = m;
    tmp_cnt[w] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int mm = U, cc = 0;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
      mm = min(mm, tmp_min[k]);
      cc += tmp_cnt[k];
    }
    summary[2 * ((size_t)n * T + t)] = mm;
    summary[2 * ((size_t)n * T + t) + 1] = cc;
  }
}

// The fill: block (n, t) writes the spans of tile t of row n.  Dynamic
// shared memory holds the compacted starts S[0..nv] (S[nv] = the carry)
// and values W[0..nv).
template <bool WITH_POS>
__global__ void __launch_bounds__(THREADS, 2)
fill_records_kernel(const int32_t* __restrict__ rec_pos,
                    const int32_t* __restrict__ rec_val,
                    const int32_t* __restrict__ summary,
                    int32_t* __restrict__ val_out,
                    int32_t* __restrict__ pos_out, int32_t* __restrict__ ovf,
                    int R, int U, int T, int TS, int keep, int vec_in,
                    int vec_out) {
  extern __shared__ int lists[];
  __shared__ int first[THREADS + 1];
  __shared__ int tmp_a[LANES], tmp_b[LANES], tmp_c[LANES];
  int* S = lists;
  int* W = lists + TS + 1;
  const int n = blockIdx.x / T, t = blockIdx.x % T;
  const int32_t* rp = rec_pos + (size_t)n * R;
  const int32_t* rv = rec_val + (size_t)n * R;
  int32_t* vo = val_out + (size_t)n * U;
  int32_t* po = WITH_POS ? pos_out + (size_t)n * U : nullptr;
  const int end = min(t * TS + TS, R);
  const int s0 = t * TS + threadIdx.x * K;

  int carry = U;
  if (T > 1) {
    const int32_t* sm = summary + 2 * (size_t)n * T;
    int row_min = U;
    for (int k = 0; k < T; ++k) {
      const int m = __ldg(sm + 2 * k);
      row_min = min(row_min, m);
      if (k > t) carry = min(carry, m);
    }
    if (WITH_POS && t == 0 && threadIdx.x == 0) {
      int cnt = 0;
      for (int k = 0; k < T; ++k) cnt += __ldg(sm + 2 * k + 1);
      ovf[n] = cnt > keep ? 1 : 0;
    }
    // bytes before the row's first record: tile t zeroes its t-th share
    const int share = ((U + T - 1) / T + VEC - 1) / VEC * VEC;
    const int z0 = min(t * share, U);
    fill_const<WITH_POS>(vo, po, z0, min(z0 + share, row_min), 0, 0,
                         vec_out);
    if (__ldg(sm + 2 * t) >= carry) return;  // no span starts in this tile
  }

  int p[K], v[K];
  load_slots(rp, s0, end, vec_in, p);
  bool any_real = false;
#pragma unroll
  for (int c = 0; c < K; ++c) any_real |= is_real(p[c], U);
  if (any_real) {
    load_slots(rv, s0, end, vec_in, v);
  } else {
#pragma unroll
    for (int c = 0; c < K; ++c) v[c] = 0;
  }
  int m = U;
#pragma unroll
  for (int c = 0; c < K; ++c) m = is_real(p[c], U) ? min(m, p[c]) : m;
  int tile_min;  // the row's least position when T == 1
  int after = min(carry, block_excl_suffix_min(m, U, tmp_a, &tile_min));
  if (T == 1) {
    if (WITH_POS) {
      const int nxt = next_slot(p, s0, end, R, rp, first);
      const int cnt = block_sum(distinct(p, nxt, U), tmp_b);
      if (threadIdx.x == 0) ovf[n] = cnt > keep ? 1 : 0;
    }
    fill_const<WITH_POS>(vo, po, 0, tile_min, 0, 0, vec_out);
  }
  // a record's span is non-empty when it starts before every later start
  unsigned vis = 0;
#pragma unroll
  for (int c = K - 1; c >= 0; --c) {
    if (is_real(p[c], U)) {
      if (p[c] < after) vis |= 1u << c;
      after = min(after, p[c]);
    }
  }
  int nv;
  int k = block_excl_sum(__popc(vis), tmp_c, &nv);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    if (vis >> c & 1u) {
      S[k] = p[c];
      W[k] = v[c] & V_MASK;
      ++k;
    }
  }
  if (threadIdx.x == 0) S[nv] = carry;
  __syncthreads();
  if (nv == 0) return;

  // the tile's output range [S[0], carry), vector by vector
  const int lo = S[0];
  for (int q = lo / VEC + (int)threadIdx.x; q * VEC < carry;
       q += blockDim.x) {
    const int j0 = q * VEC;
    int a = 0, b = nv;  // r: the last record with S[r] <= j0, -1 if none
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (S[mid] <= j0) a = mid + 1; else b = mid;
    }
    int r = a - 1;
    int ov[VEC], op[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      while (r + 1 < nv && S[r + 1] <= j0 + c) ++r;
      ov[c] = r >= 0 ? W[r] : 0;
      op[c] = r >= 0 ? S[r] & P_MASK : 0;
    }
    if (vec_out && j0 >= lo && j0 + VEC <= carry) {
      *reinterpret_cast<int4*>(vo + j0) = make_int4(ov[0], ov[1], ov[2], ov[3]);
      if (WITH_POS)
        *reinterpret_cast<int4*>(po + j0) =
            make_int4(op[0], op[1], op[2], op[3]);
    } else {
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        const int j = j0 + c;
        if (j < lo || j >= carry) continue;  // a neighbour tile's byte
        vo[j] = ov[c];
        if (WITH_POS) po[j] = op[c];
      }
    }
  }
}

template <bool WITH_POS>
int launch(const void* rec_pos, const void* rec_val, void* summary,
           void* val_out, void* pos_out, void* ovf, int n, int R, int U,
           int keep, int T, int TS, int threads, int vec_in, int vec_out,
           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (threads <= 0 || threads > THREADS || threads % 32 || TS > K * threads ||
      TS % K)
    return (int)cudaErrorInvalidValue;
  if (T > 1) {
    fill_summary_kernel<<<n * T, threads, 0, s>>>(
        (const int32_t*)rec_pos, (int32_t*)summary, R, U, T, TS, vec_in);
  }
  const size_t smem = (2 * (size_t)TS + 1) * sizeof(int);
  // the dynamic shared memory may pass 48 KiB
  const cudaError_t rc = cudaFuncSetAttribute(
      fill_records_kernel<WITH_POS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (2 * K * THREADS + 1) * (int)sizeof(int));
  if (rc != cudaSuccess) return (int)rc;
  fill_records_kernel<WITH_POS><<<n * T, threads, smem, s>>>(
      (const int32_t*)rec_pos, (const int32_t*)rec_val,
      (const int32_t*)summary, (int32_t*)val_out, (int32_t*)pos_out,
      (int32_t*)ovf, R, U, T, TS, keep, vec_in, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Both planes and the overflow flag.  summary: int32 [n, T, 2] scratch
// when T > 1.
extern "C" int fill_records(const void* rec_pos, const void* rec_val,
                            void* summary, void* val_out, void* pos_out,
                            void* ovf, int n, int R, int U, int keep, int T,
                            int TS, int threads, int vec_in, int vec_out,
                            void* stream) {
  return launch<true>(rec_pos, rec_val, summary, val_out, pos_out, ovf, n, R,
                      U, keep, T, TS, threads, vec_in, vec_out, stream);
}

// The value plane alone (LZNT1's fill).
extern "C" int fill_records_value(const void* rec_pos, const void* rec_val,
                                  void* summary, void* val_out, int n, int R,
                                  int U, int T, int TS, int threads,
                                  int vec_in, int vec_out, void* stream) {
  return launch<false>(rec_pos, rec_val, summary, val_out, nullptr, nullptr,
                       n, R, U, 0, T, TS, threads, vec_in, vec_out, stream);
}
