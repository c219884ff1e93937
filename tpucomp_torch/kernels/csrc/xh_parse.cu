// Xpress Huffman decode parse: the canonical-Huffman byte machine, one
// row per block of THREADS threads, decoded in segments at once.
//
// Replaces: tpucomp/kernels/xh_pallas.py parse_records (_build_kernel),
// which runs the same machine with one TPU vector lane per block.  Each
// body byte is one step (refill-word byte or length-escape byte); after a
// refill past the 32-bit prime, or after an escape completes a match, up
// to ss[n] substeps each finish a pending offset, then decode one symbol.
// The order inside a step is tpucomp's exactly (xh_pallas.py:124-251);
// run() below is that machine, over an explicit state.
//
// History and span (tpucomp's XLA scan with_history and want_span,
// codecs/xpress_huff.py:170-390, which its one-shot multi-block decode
// runs): an offset may reach hist_len[n] bytes before the block's start
// (the checks are offset > p + hist_len), and span[n] = 2 * (2 + max(0,
// ceil(bits / 16) - 1)) + raw, where bits are the code and offset bits
// and raw the escape bytes the row consumed while active (before the
// body's end and before out_len): where the next block of a multi-block
// stream starts.  span is exact on rows without err; the one-shot decode
// reads it on no other.
//
// Records: record k of a row goes to slot k of the [N, U] planes, its
// output position in rec_pos and the literal or COPY_BIT | offset in
// rec_val; the rest of the row holds SENT and 0.  Positions strictly
// increase, so a row never has more than out_len <= U records.  tpucomp
// instead left-compacts every 64 steps' slots in VMEM to KEEP_CHUNK
// entries (xh_pallas.py:256-315), a workaround for the TPU's lack of a
// scatter; a thread here simply stores each record where it belongs.
// KEEP_CHUNK's overflow flag never fires for a row decoded at its own
// substep tier: each record is one symbol of at least the tier's
// shortest code length, and a 64-step chunk holds at most 543 bits
// (xh_pallas.py:56-65), so err stays equal to tpucomp's without it.  A
// row with more records than U slots (only possible when an escape
// length wraps int32 and moves the position backwards) sets err.
//
// Integers follow XLA's int32 rules: additions wrap (done in unsigned
// arithmetic, which C++ defines), and the refill shift, 16 - bitcount, is
// negative once bitcount passes 16; XLA gives 0 for such a shift, and so
// does the guard below.  Only rows already flagged by the leftover check
// get there, but the guard keeps the kernel free of undefined behaviour
// and p_final equal on those rows too.
//
// The machine is sequential in its state, so the block cuts the body into
// segments (xh_parse.segments in the wrapper: at most THREADS, each 4
// times an odd number of bytes so that threads reading in step hit 32
// banks) and finds each segment's entry state by speculation:
//
//   1. Stage.  The row's body (16 bytes a thread when aligned), its
//      rank->symbol table and rbf go to shared memory; the 15 scaled
//      limits sit in registers.  A first-level table gives the level
//      and symbol of every window whose top FAST_BITS bits settle both
//      (the compares, as tpucomp's, serve the rest), and a W0 byte and
//      the W1 byte after it run in one turn of the loop.
//   2. Speculate (ss != 3).  Thread t decodes segment t from a guess, the
//      state the machine reaches from its initial state over the WARM
//      bytes before the segment (segment 0 from the true initial state),
//      and keeps its exit and its count of positions and records (dp,
//      dk).  Positions are relative and the p < out_len guards off: until
//      the true p reaches out_len none of them fires, nor the clamp to U
//      (out_len <= U), so this is exact up to the row's stop.
//   3. Rounds.  A thread whose entry, its left neighbour's exit in the
//      round before, differs from the one it used re-decodes, until no
//      entry changes (__syncthreads_or).  Entries compare in their live
//      fields only: lowbyte in W1, len_acc in E16B and E32B-D, obc and lh
//      with a pending offset, off with a pending escape.  Segment 0's
//      entry never changes, so round r leaves segments 0..r final: exact
//      on every input, at most one round a segment.  rounds[row] = 1 +
//      the rounds in which an entry changed.
//   2'. Tier 3 (ss == 3: every code 8 bits or more).  A decoder started
//      k bits off a codeword boundary there stays off, so guesses do not
//      resynchronise.  The block takes THREADS / HYP coarse segments and
//      decodes each under HYP entry hypotheses side by side: a word
//      boundary with c in [HYP_LO, HYP_LO + HYP) = [8, 16) bits left
//      over, the low c bits of the word before.  After a code of 8 bits
//      a refill leaves 8 to 15 bits, so these are every boundary of a
//      run of 8-bit codes.  One thread then resolves the true entries
//      left to right: an entry equal to hypothesis c takes its exit; any
//      other (fewer bits left after a longer code, a pending offset or
//      escape, odd word parity) re-decodes the segment.  rounds[row] =
//      the segments re-decoded.  Each hypothesis also records its state
//      at SUB - 1 points inside its segment (the row's part of the
//      device scratch), for the final pass.
//   4. Final pass.  Scans of dp and dk give each segment its absolute
//      position and first slot; every segment re-decodes from its true
//      entry with every guard, err check and clamp, storing its records.
//      A tier-3 segment whose entry was a hypothesis runs as SUB
//      sub-segments, from the states that hypothesis recorded.  The
//      first (sub-)segment that reaches out_len ends the row: p_final,
//      err (its OR up to there, and k > U) and the record count come from
//      it.  Later ones start at or past that count, so whatever they
//      store lands in slots that the fill then sets to SENT and 0.  Each
//      (sub-)segment also counts its bits and escape bytes up to its own
//      stop; the span sums them up to and including the one that ends
//      the row.
//
// The wrapper launches tier-3 rows first: theirs is the longest path.
//
// What bounds it on the card: the dependent chain of byte steps along the
// longest path a row takes (the warm-up, a segment per round, the final
// segment; on tier 3 a coarse segment, then a sub-segment), each step a
// shared-memory byte and up to ss substeps of branches and dependent
// shared loads, and the branches of one warp's threads apart.  The
// bytes it must move (the bodies, 8 bytes a record slot) bound it far
// below that.  A 64 KiB body takes 65 KiB of shared memory, so three
// blocks share an SM.
//
// XH_DROP and XH_HYP / XH_HYP_LO select variants for measurement only
// (scripts/xh_parse_variants.py times each against this build); every
// variant is exact.  XH_DROP bit 0 drops the first-level table, bit 1
// the W0/W1 turn, bit 2 the tier-3 sub-segments of the final pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MIN_MATCH = 3;
constexpr int COPY_BIT = 1 << 20;
constexpr int SENT = 1 << 28;
// the geometry; kernels/xh_parse.py mirrors it (segments(), the model)
constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
#ifndef XH_DROP
#define XH_DROP 0
#endif
#ifndef XH_HYP
#define XH_HYP 8
#endif
#ifndef XH_HYP_LO
#define XH_HYP_LO 8
#endif
constexpr int HYP = XH_HYP;
constexpr int HYP_LO = XH_HYP_LO;  // hypotheses c in [HYP_LO, HYP_LO + HYP)
constexpr int FAST_BITS = 10;  // the first-level decode table's index
constexpr int SUB = HYP;  // tier-3 final pass: sub-segments of a segment
constexpr int REC = 7;  // ints of a recorded state: Live, dp, dk
constexpr int WARM = 32;
constexpr int SEG_MIN = 64;
constexpr unsigned FULL = 0xffffffffu;

enum Mode { M_W0 = 0, M_W1, M_EB, M_E16A, M_E16B, M_E32A, M_E32B, M_E32C,
            M_E32D };
enum Pend { P_NONE = 0, P_OFFSET = 1, P_ESC = 2 };

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

// The machine's state between two body bytes.
struct St {
  uint32_t bitbuf, lowbyte, len_acc;
  int bitcount, mode, pend, obc, lh, off;
};

__device__ __forceinline__ St init_state() {
  St s;
  s.bitbuf = s.lowbyte = s.len_acc = 0;
  s.bitcount = s.obc = s.lh = s.off = 0;
  s.mode = M_W0;
  s.pend = P_NONE;
  return s;
}

// A state with its dead fields dropped: two states equal here decode the
// same from any byte on.
struct Live {
  uint32_t bb, pk, len;
  int bc, off;
};

__device__ __forceinline__ Live live(const St& s) {
  Live o;
  o.bb = s.bitbuf;
  o.bc = s.bitcount;
  o.pk = (uint32_t)(s.mode | s.pend << 4);
  if (s.pend == P_OFFSET) o.pk |= (uint32_t)(s.obc << 8 | s.lh << 12);
  if (s.mode == M_W1) o.pk |= s.lowbyte << 16;
  o.off = s.pend == P_ESC ? s.off : 0;
  o.len = (s.mode == M_E16B || s.mode >= M_E32B) ? s.len_acc : 0u;
  return o;
}

__device__ __forceinline__ St state_of(const Live& o) {
  St s;
  s.bitbuf = o.bb;
  s.bitcount = o.bc;
  s.mode = (int)(o.pk & 15);
  s.pend = (int)(o.pk >> 4 & 3);
  s.obc = (int)(o.pk >> 8 & 15);
  s.lh = (int)(o.pk >> 12 & 15);
  s.lowbyte = o.pk >> 16 & 255;
  s.off = o.off;
  s.len_acc = o.len;
  return s;
}

__device__ __forceinline__ bool same(const Live& a, const Live& b) {
  return a.bb == b.bb && a.bc == b.bc && a.pk == b.pk && a.off == b.off &&
         a.len == b.len;
}

// The states of a block's segments (or tier-3 hypotheses), one slot each.
struct Slots {
  uint32_t bb[THREADS], pk[THREADS], len[THREADS];
  int bc[THREADS], off[THREADS], dp[THREADS], dk[THREADS];
  __device__ __forceinline__ void put(int i, const Live& o, int p, int k) {
    bb[i] = o.bb;
    pk[i] = o.pk;
    len[i] = o.len;
    bc[i] = o.bc;
    off[i] = o.off;
    dp[i] = p;
    dk[i] = k;
  }
  __device__ __forceinline__ Live get(int i) const {
    Live o;
    o.bb = bb[i];
    o.pk = pk[i];
    o.len = len[i];
    o.bc = bc[i];
    o.off = off[i];
    return o;
  }
};

struct Row {
  const uint8_t* bytes;  // the body, in shared memory
  const int32_t* rbf;
  const uint16_t* sym;
  const uint16_t* fast;  // level | symbol << 4 by the top FAST_BITS bits
  int lim15[16];
  int ss, olen, U, hl;  // hl: the history's reach before the block
  int32_t *rp, *rv;  // this row's record planes
};

// What the final pass counts for the span: code and offset bits, escape
// bytes.
struct Used {
  int bits = 0, raw = 0;
};

// Body bytes [s0, s1) from state st at position p with k records made.
// FINAL: absolute p, every guard and err, records stored, bits and escape
// bytes counted into u; otherwise p relative, no guard, no err, no store,
// no count.  Stops early (FINAL) once p reaches out_len, as the row does.
template <bool FINAL>
__device__ __forceinline__ void run(const Row& r, int s0, int s1, St& st,
                                    int& p, int& k, int& err, Used& u) {
  const int olen = r.olen, U = r.U;
  auto record = [&](int pos, int val) {
    if (FINAL && k < U) {
      r.rp[k] = pos;
      r.rv[k] = val;
    }
    ++k;
  };
  for (int s = s0; s < s1; ++s) {
    if (FINAL && p >= olen) break;
    uint32_t b = r.bytes[s];
    bool esc_match = false, w1 = false;
    int esc_len = 0;
    if (st.mode == M_W0) {
      st.lowbyte = b;
      st.mode = M_W1;
      // a W0 step does nothing more (p unchanged), so the W1 byte after
      // it, if in range, follows in the same turn
      if ((XH_DROP & 2) || s + 1 == s1) continue;
      b = r.bytes[++s];
    }
    // every role but a word's high byte is an escape byte: the span counts it
    if (FINAL && st.mode != M_W1) ++u.raw;
    if (st.mode == M_W1) {
      const int sh = 16 - st.bitcount;  // XLA: a negative shift gives 0
      if (sh >= 0) st.bitbuf |= (st.lowbyte | (b << 8)) << sh;
      st.bitcount += 16;
      w1 = true;
      st.mode = M_W0;
    } else switch (st.mode) {
      case M_EB:
        if (b < 255) {
          esc_match = true;
          esc_len = (int)b + 15 + MIN_MATCH;
          st.mode = M_W0;
        } else {
          st.mode = M_E16A;
        }
        break;
      case M_E16A:
        st.len_acc = b;
        st.mode = M_E16B;
        break;
      case M_E16B: {
        const uint32_t u16v = st.len_acc | (b << 8);
        if (u16v == 0) {
          st.mode = M_E32A;
        } else {
          esc_match = true;
          esc_len = (int)u16v + MIN_MATCH;
          st.mode = M_W0;
        }
        break;
      }
      case M_E32A:
        st.len_acc = b;
        st.mode = M_E32B;
        break;
      case M_E32B:
        st.len_acc |= b << 8;
        st.mode = M_E32C;
        break;
      case M_E32C:
        st.len_acc |= b << 16;
        st.mode = M_E32D;
        break;
      default: {  // M_E32D: a u32 length, int32 in tpucomp
        esc_match = true;
        esc_len = wadd((int)(st.len_acc | (b << 24)), MIN_MATCH);
        st.mode = M_W0;
        break;
      }
    }
    if (esc_match) {
      const int end = wadd(p, esc_len);
      if (FINAL && (st.off > wadd(p, r.hl) || end > olen)) err = 1;
      record(p, COPY_BIT | st.off);
      p = FINAL ? min(end, U) : end;
      st.pend = P_NONE;
    }
    // the 32-bit prime: no symbol before the second word (s >= 3)
    if (!(esc_match || (w1 && s >= 3))) continue;

    for (int j = 0; j < r.ss; ++j) {
      bool acted = false;
      // 1) the pending match's offset bits
      if (st.pend == P_OFFSET && st.bitcount >= st.obc) {
        const int obc = st.obc;
        const uint32_t raw =
            obc > 0 ? (st.bitbuf >> (32 - obc)) & ((1u << obc) - 1u) : 0u;
        const int offv = (int)((1u << obc) | raw);
        st.bitbuf <<= obc;
        st.bitcount -= obc;
        if (FINAL) u.bits += obc;
        if (st.lh < 15) {
          const int mlen = st.lh + MIN_MATCH;
          if (FINAL && (offv > wadd(p, r.hl) || p + mlen > olen)) err = 1;
          record(p, COPY_BIT | offv);
          p = FINAL ? min(p + mlen, U) : wadd(p, mlen);
          st.pend = P_NONE;
        } else {
          st.pend = P_ESC;
        }
        st.off = offv;
        acted = true;
      }
      // 2) a fresh symbol: level = 1 + #{l < 15 : peek15 >= LIM15[l]}
      if (st.pend == P_NONE && st.bitcount >= 16 && (!FINAL || p < olen)) {
        const int peek15 = (int)(st.bitbuf >> 17);
        const uint32_t e =
            (XH_DROP & 1) ? 0u : r.fast[st.bitbuf >> (32 - FAST_BITS)];
        int level = e & 15, sy = e >> 4;
        if (!e) {  // a code longer than FAST_BITS, or none
          level = 1;
#pragma unroll
          for (int l = 1; l < 15; ++l) level += peek15 >= r.lim15[l];
          const int rank = wadd(r.rbf[level], peek15 >> (15 - level));
          sy = (rank >= 0 && rank < 512) ? r.sym[rank] : 0;
        }
        if (e || peek15 < r.lim15[15]) {
          st.bitbuf <<= level;
          st.bitcount -= level;
          if (FINAL) u.bits += level;
          if (sy < 256) {
            record(p, sy);
            p = wadd(p, 1);
          } else {
            st.obc = (sy - 256) >> 4;
            st.lh = (sy - 256) & 0xF;
            st.pend = P_OFFSET;
          }
          acted = true;
        }
      }
      // a substep that did nothing leaves the state as it was, and so
      // would every later one
      if (!acted || (FINAL && p >= olen)) break;
    }
    // a refill that leaves decodable bits behind would desync the next
    // byte: flag it (ss[n] covers every valid row)
    if (FINAL && p < olen &&
        ((st.pend == P_NONE && st.bitcount >= 16) ||
         (st.pend == P_OFFSET && st.bitcount >= st.obc)))
      err = 1;
    st.mode = (st.pend == P_ESC && st.bitcount >= 16) ? M_EB : M_W0;
  }
}

// Decode [s0, s1) speculatively from `entry`: its exit (live fields) and
// relative dp, dk into slot i.
__device__ __forceinline__ void speculate(const Row& r, int s0, int s1,
                                          const Live& entry, Slots& sl,
                                          int i) {
  St st = state_of(entry);
  int p = 0, k = 0, err = 0;
  Used u;
  run<false>(r, s0, s1, st, p, k, err, u);
  sl.put(i, live(st), p, k);
}

// Tier-3 hypothesis c of a segment starting at byte b >= 2.
__device__ __forceinline__ Live hypothesis(const uint8_t* bytes, int b,
                                           int c) {
  const uint32_t word = bytes[b - 2] | (uint32_t)bytes[b - 1] << 8;
  St s = init_state();
  s.bitcount = c;
  s.bitbuf = c ? (word & ((1u << c) - 1u)) << (32 - c) : 0u;
  return live(s);
}

// Exclusive scans of a (wrapping) and b over the block.
__device__ __forceinline__ void block_scan(int& a, int& b, int* wa, int* wb) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(FULL, ia, o);
    const int y = __shfl_up_sync(FULL, ib, o);
    if (lane >= o) {
      ia = wadd(ia, x);
      ib += y;
    }
  }
  if (lane == 31) {
    wa[w] = ia;
    wb[w] = ib;
  }
  __syncthreads();
  int ba = 0, bb = 0;
  for (int i = 0; i < w; ++i) {
    ba = wadd(ba, wa[i]);
    bb += wb[i];
  }
  a = wadd(ba, wadd(ia, -a));
  b = bb + ib - b;
}

__global__ void __launch_bounds__(THREADS, 3)
xh_parse_kernel(const uint8_t* __restrict__ body,
                const int32_t* __restrict__ blen_in,
                const int32_t* __restrict__ out_len,
                const int32_t* __restrict__ ss_in,
                const int32_t* __restrict__ lim15_in,
                const int32_t* __restrict__ rbf_in,
                const int32_t* __restrict__ sym_by_rank,
                const int32_t* __restrict__ hist_len,
                const int32_t* __restrict__ order,
                int32_t* __restrict__ rec_pos, int32_t* __restrict__ rec_val,
                int32_t* __restrict__ p_final, int32_t* __restrict__ err_out,
                int32_t* __restrict__ span_out,
                int32_t* __restrict__ rounds_out,
                int32_t* __restrict__ scratch, int Pb, int U) {
  extern __shared__ __align__(16) uint8_t sbody[];
  __shared__ Slots sl;
  __shared__ uint16_t sym[512];
  __shared__ uint16_t fast[1 << FAST_BITS];
  __shared__ int32_t rbf[16];
  __shared__ int wa[NWARP], wb[NWARP];
  __shared__ int s_stop, s_last, s_p, s_k, s_rounds, s_bits, s_raw;
  __shared__ int hsel[THREADS / HYP], c_p[THREADS / HYP], c_k[THREADS / HYP];
  const int row = order[blockIdx.x];
  const int tid = threadIdx.x;
  const uint8_t* gbody = body + (size_t)row * Pb;
  const int blen = min(blen_in[row], Pb);

  // ---- 1. stage ---------------------------------------------------------
  if ((Pb & 15) == 0 && ((uintptr_t)body & 15) == 0) {
    const int n16 = (max(blen, 0) + 15) >> 4;
    for (int i = tid; i < n16; i += THREADS)
      reinterpret_cast<uint4*>(sbody)[i] =
          __ldg(reinterpret_cast<const uint4*>(gbody) + i);
  } else {
    for (int i = tid; i < blen; i += THREADS) sbody[i] = __ldg(gbody + i);
  }
  for (int i = tid; i < 512; i += THREADS)
    sym[i] = (uint16_t)sym_by_rank[(size_t)row * 512 + i];
  if (tid < 16) rbf[tid] = rbf_in[row * 16 + tid];
  if (tid == 0) {
    s_stop = THREADS;
    s_last = -1;
    s_bits = 0;
    s_raw = 0;
  }
  Row r;
  r.bytes = sbody;
  r.rbf = rbf;
  r.sym = sym;
  r.fast = fast;
#pragma unroll
  for (int l = 0; l < 16; ++l) r.lim15[l] = lim15_in[row * 16 + l];
  r.ss = ss_in[row];
  r.olen = out_len[row];
  r.U = U;
  r.hl = hist_len[row];
  r.rp = rec_pos + (size_t)row * U;
  r.rv = rec_val + (size_t)row * U;
  __syncthreads();
  // the first-level table: where every window with these top bits has
  // one level, at most FAST_BITS (levels only grow with the window), and
  // a code, its level and symbol; 0 sends the step to the compares
  for (int v = tid; v < 1 << FAST_BITS; v += THREADS) {
    const int lo = v << (15 - FAST_BITS), hi = lo | ((1 << (15 - FAST_BITS)) - 1);
    int llo = 1, lhi = 1;
#pragma unroll
    for (int l = 1; l < 15; ++l) {
      llo += lo >= r.lim15[l];
      lhi += hi >= r.lim15[l];
    }
    uint32_t e = 0;
    if (llo == lhi && llo <= FAST_BITS && hi < r.lim15[15]) {
      const int rank = wadd(rbf[llo], lo >> (15 - llo));
      e = (uint32_t)llo | (uint32_t)(rank >= 0 && rank < 512 ? sym[rank] : 0)
                              << 4;
    }
    fast[v] = (uint16_t)e;
  }
  __syncthreads();

  // the geometry (xh_parse.segments)
  const bool tier3 = r.ss == 3;
  int S = 0, nseg = 0;
  if (blen > 0) {
    const int parts = tier3 ? THREADS / HYP : THREADS;
    const int seg = max((blen + parts - 1) / parts, tier3 ? 1 : SEG_MIN);
    S = 4 * (((seg + 3) / 4) | 1);
    nseg = (blen + S - 1) / S;
  }
  const Live init = live(init_state());
  Live entry = init;  // segment tid's entry (final pass)
  int rounds = 0;
  // tier 3: the final pass runs on SUB sub-segments of F bytes a segment,
  // from states recorded on the way
  const int F = 4 * (S / (4 * SUB));
  const bool fine = !(XH_DROP & 4) && tier3 && F > 0;

  if (!tier3) {
    // ---- 2. speculate ---------------------------------------------------
    const int s0 = tid * S, s1 = min(s0 + S, blen);
    const bool mine = tid < nseg;
    if (mine) {
      if (tid > 0) {
        St st = init_state();
        int p = 0, k = 0, err = 0;
        Used u;
        run<false>(r, max(0, s0 - WARM), s0, st, p, k, err, u);
        entry = live(st);
      }
      speculate(r, s0, s1, entry, sl, tid);
    }
    rounds = nseg > 0;
    // ---- 3. rounds --------------------------------------------------------
    for (;;) {
      __syncthreads();
      bool changed = false;
      if (mine && tid > 0) {
        const Live e = sl.get(tid - 1);
        changed = !same(e, entry);
        entry = e;
      }
      __syncthreads();  // every entry read before any exit changes
      if (changed) speculate(r, s0, s1, entry, sl, tid);
      if (!__syncthreads_or(changed)) break;
      ++rounds;
    }
  } else {
    // ---- 2'. tier 3: hypotheses, then resolved left to right ---------------
    const int g = tid / HYP, c = HYP_LO + tid % HYP;
    const int s0 = g * S, s1 = min(s0 + S, blen);
    if (g < nseg && (g > 0 || tid == 0)) {
      St st = state_of(g ? hypothesis(sbody, s0, c) : init);
      int p = 0, k = 0, err = 0, a = s0;
      Used u;
      if (fine) {
        int32_t* rec =
            scratch + ((size_t)row * THREADS + tid) * (SUB - 1) * REC;
        for (int j = 1; j < SUB; ++j, rec += REC) {
          const int b = min(s0 + j * F, s1);
          run<false>(r, a, b, st, p, k, err, u);
          a = b;
          const Live o = live(st);
          rec[0] = (int)o.bb;
          rec[1] = (int)o.pk;
          rec[2] = (int)o.len;
          rec[3] = o.bc;
          rec[4] = o.off;
          rec[5] = p;
          rec[6] = k;
        }
      }
      run<false>(r, a, s1, st, p, k, err, u);
      sl.put(tid, live(st), p, k);
    }
    __syncthreads();
    if (tid == 0) {
      // slot t (1 <= t < nseg) then takes segment t's entry and dp, dk:
      // slot t belongs to a segment at or before t, already resolved
      int redone = 0;
      Live cur = sl.get(0);
      hsel[0] = 0;
      for (int t = 1; t < nseg; ++t) {
        const int b = t * S;
        Live ex;
        int dp, dk;
        if (cur.pk == 0 && cur.bc >= HYP_LO && cur.bc < HYP_LO + HYP &&
            same(cur, hypothesis(sbody, b, cur.bc))) {
          const int i = t * HYP + cur.bc - HYP_LO;
          ex = sl.get(i);
          dp = sl.dp[i];
          dk = sl.dk[i];
          hsel[t] = i;
        } else {
          St st = state_of(cur);
          int p = 0, k = 0, err = 0;
          Used u;
          run<false>(r, b, min(b + S, blen), st, p, k, err, u);
          ex = live(st);
          dp = p;
          dk = k;
          hsel[t] = -1;
          ++redone;
        }
        sl.put(t, cur, dp, dk);
        cur = ex;
      }
      s_rounds = redone;
    }
    __syncthreads();
    rounds = s_rounds;
    if (tid > 0 && tid < nseg) entry = sl.get(tid);
  }

  // ---- 4. final pass ------------------------------------------------------
  // thread tid's range [a, b), entry and first position and slot; ranges
  // follow the body in thread order
  int p = tid < nseg ? sl.dp[tid] : 0, k = tid < nseg ? sl.dk[tid] : 0;
  block_scan(p, k, wa, wb);  // its barrier: tier 3's slots are final
  int a = tid * S, b = min(a + S, blen);
  bool active = tid < nseg;
  if (fine) {
    // segment g's sub-segment j; a segment that was re-decoded has no
    // recorded states, and its first thread takes it whole
    if (tid < nseg) {
      c_p[tid] = p;
      c_k[tid] = k;
    }
    __syncthreads();
    const int g = tid / SUB, j = tid % SUB;
    const int g1 = min(g * S + S, blen), h = g < nseg ? hsel[g] : -1;
    a = g * S + j * F;
    b = j == SUB - 1 || h < 0 ? g1 : min(a + F, g1);
    active = g < nseg && a < b && (j == 0 || h >= 0);
    if (active) {
      p = c_p[g];
      k = c_k[g];
      if (j == 0) {
        entry = g ? sl.get(g) : init;
      } else {
        const int32_t* rec =
            scratch + (((size_t)row * THREADS + h) * (SUB - 1) + j - 1) * REC;
        entry.bb = (uint32_t)rec[0];
        entry.pk = (uint32_t)rec[1];
        entry.len = (uint32_t)rec[2];
        entry.bc = rec[3];
        entry.off = rec[4];
        p = wadd(p, rec[5]);
        k += rec[6];
      }
    }
  }
  int err = 0;
  Used u;
  if (active) {
    St st = state_of(entry);
    run<true>(r, a, b, st, p, k, err, u);
    if (p >= r.olen) atomicMin(&s_stop, tid);
    atomicMax(&s_last, tid);
  }
  __syncthreads();
  const int last = s_stop < THREADS ? s_stop : s_last;
  if (tid == last) {
    s_p = p;
    s_k = k;
  }
  if (last < 0 && tid == 0) {  // an empty body
    s_p = 0;
    s_k = 0;
  }
  // the span: the (sub-)segments up to the one that ends the row, each
  // counted up to its own stop
  if (active && tid <= last) {
    if (u.bits) atomicAdd(&s_bits, u.bits);
    if (u.raw) atomicAdd(&s_raw, u.raw);
  }
  const int any_err = __syncthreads_or(active && tid <= last && err);
  const int n_rec = min(s_k, U);
  if (tid == 0) {
    p_final[row] = s_p;
    err_out[row] = any_err | (s_k > U ? 1 : 0);
    span_out[row] = 2 * (2 + max(0, (s_bits + 15) / 16 - 1)) + s_raw;
    rounds_out[row] = rounds;
  }
  for (int s = n_rec + tid; s < U; s += THREADS) {
    r.rp[s] = SENT;
    r.rv[s] = 0;
  }
}

}  // namespace

extern "C" int xh_parse(const void* body, const void* blen,
                        const void* out_len, const void* ss,
                        const void* lim15, const void* rbf,
                        const void* sym_by_rank, const void* hist_len,
                        const void* order, void* rec_pos, void* rec_val,
                        void* p_final, void* err, void* span, void* rounds,
                        void* scratch, int n, int Pb, int U, void* stream) {
  const int smem = (Pb + 15) & ~15;
  cudaError_t e = cudaFuncSetAttribute(
      xh_parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(xh_parse_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  xh_parse_kernel<<<n, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)body, (const int32_t*)blen, (const int32_t*)out_len,
      (const int32_t*)ss, (const int32_t*)lim15, (const int32_t*)rbf,
      (const int32_t*)sym_by_rank, (const int32_t*)hist_len,
      (const int32_t*)order, (int32_t*)rec_pos, (int32_t*)rec_val,
      (int32_t*)p_final, (int32_t*)err, (int32_t*)span, (int32_t*)rounds,
      (int32_t*)scratch, Pb, U);
  return (int)cudaGetLastError();
}
