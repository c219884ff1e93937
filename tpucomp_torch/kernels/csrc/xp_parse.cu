// Plain Xpress decode parse: a flag-word skeleton walk per row, with a
// parallel emission of the row's records beside it.
//
// Replaces: tpucomp/kernels/xp_pallas.py parse_records (_build_kernel),
// which runs the 14-state byte machine of [MS-XCA] 2.4 with one TPU
// vector lane per unit and packs each record into one plane ((val << 16)
// | pos) + 1 for the lanes.  Here byte step s that completes a token
// writes rec_pos[n, s] = its output position and rec_val[n, s] = the
// literal byte or COPY_BIT | offset; every other slot holds SENT and 0,
// past the stop too.  p_final is the final output position; err flags a
// match before the start or past out_len and an escape length below 22.
// Every int32 value wraps as in tpucomp (XLA's rule): a u32 escape length
// >= 2^31 - 3 wraps the match length negative, and the position moves
// backwards with err clear, as there.
//
// Design: one block of THREADS a row, all rows of a decode batch in
// flight at once (72 registers a thread and 45,424 bytes of shared memory
// a block, from nvcc -Xptxas -v: BLOCKS_PER_SM blocks an SM, 660 on the
// H100's 132 SMs, against 546 rows of 64 KiB in a batch).
// - The skeleton walk (warp 0, its lanes in step on one state) carries the
//   machine's exact state from flag word to flag word.  A word of 32
//   literals goes with the ones after it, up to 32 words in one step (lane
//   j reads the flag word 36 j bytes on).  Any other word is walked first
//   without the machine's stop checks, in rounds of the warp: lane j reads
//   token j's low byte where token j starts if every match before it in
//   the round has 2 bytes; the first escaped match (length field 7) ends
//   the round and is taken alone (the shared nibble, the byte and u16
//   escapes).  The word stands if it ended inside the stream at a position
//   within min(out_len, U) with no u32 escape: then no token of it met a
//   stop, a clamp or a wrap.  Otherwise (the row's last word, and words
//   with a u32 escape or a clamp) it is walked again from its entry token
//   by token with every check, as the byte machine makes them.  The body
//   streams through a ring of SLOTS chunks in shared memory filled by
//   cp.async two chunks ahead.  Each word's entry state (s, p, nibble,
//   flags) goes to device scratch, and the step count (flag words plus
//   matches: the byte machine's chain at token granularity) to ``steps``.
// - The emission (warps 1-3) follows the walk, one window of WIN record
//   slots at a time, as soon as the walk has passed the window's end; the
//   windows past plen, which hold no record, are stored at once.  Each
//   thread re-walks a flag word that reaches into the window from its
//   entry state, over the window's body bytes staged in shared memory,
//   into a staging window that holds SENT / 0 (the last word recorded
//   with every check, the others without the stop checks, which never
//   fire in them), and finds err on the tokens it walks; the window is
//   then stored with 16-byte stores, neighbouring threads on neighbouring
//   addresses.  Every slot is written once.
//
// What bounds it: the longest row's walk, its flag words plus the rounds
// its escaped matches add, each some hundred cycles of dependent
// shared-memory loads, warp votes and branches; then the emission's last
// window.  On rows of random bytes, where the walk takes 32 words a step,
// the emission's windows.  The record planes' bytes, written once, are
// the floor.
//
// Why not the speculative segments of csrc/xh_parse.cu: Huffman codes
// resynchronise, so a segment decoded from a wrong entry soon rejoins the
// true path and repair rounds converge.  Plain Xpress does not: its
// structure is where the flag words fall, and a path started from a wrong
// guess rejoins the true one only when it starts a flag word on the true
// flag word's byte with the same nibble state.  A CPU model of the byte
// machine's structure (scripts/xp_convergence.py; CPU counts, not device
// measurements) on 12 units of 64 KiB of benchmarks/corpus.py
// silesia_like, encoded by the native C encoder, with a guess "fresh flag
// word, no stored nibble" every 1 KiB: the guess met the true path after a
// median of 1.1-3.9 KB per unit, and 84 of 257 guesses had not met it
// within 8 KB, so repair rounds would run nearly one segment after
// another.  The same model counts 310-1,261 flag words and 652-7,258
// matches per unit: the skeleton chain.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

// For measurement only (scripts/xp_parse_variants.py), a build may leave a
// mechanism out: 1, no words of 32 literals taken together; 2, no walk
// without the stop checks (every word with every check, token by token);
// 4, no emission beside the walk (the emitters wait for its end).
#ifndef XP_DROP
#define XP_DROP 0
#endif

namespace {

constexpr int MIN_MATCH = 3;
constexpr int SENT = 1 << 28;
constexpr int COPY_BIT = 1 << 20;
constexpr int THREADS = 128;
constexpr int EMITTERS = 96;  // warps 1-3
constexpr int CAND = 128;     // flag words an emission window takes
constexpr int BLOCKS_PER_SM = 5;
constexpr int WIN = 4096;      // record slots an emission window
constexpr int CHUNK = 2048;    // body bytes a refill of the walk's ring
constexpr int SLOTS = 4;       // ring chunks: two walked, two landing
constexpr int TOKEN_MAX = 10;  // low, high, nibble, byte, u16, u32 bytes
constexpr int WORD_MIN = 36;   // a flag word and 32 one-byte tokens
constexpr int WORD_MAX = 324;  // a flag word and 32 tokens of TOKEN_MAX
constexpr int LEAD = 336;      // body bytes staged before a window
constexpr int BODY_WIN = LEAD + WIN + 16;
constexpr int EMIT_BAR = 1;            // the emitters' named barrier
constexpr uint32_t FULL = 0xffffffffu;

static_assert(WORD_MIN == 4 + 32 && WORD_MAX == 4 + 32 * TOKEN_MAX, "");
static_assert(CHUNK >= 32 * WORD_MIN + 4 && CHUNK >= WORD_MAX &&
                  (CHUNK & (CHUNK - 1)) == 0 && SLOTS == 4,
              "a step reads only the two chunks that have landed");
static_assert(WIN % CHUNK == 0, "a window ends where a chunk begins");
static_assert(LEAD >= WORD_MAX - 4 && LEAD % 16 == 0 && WIN % 16 == 0,
              "a window's flag words start inside its staged body");
static_assert((WIN + WORD_MAX - 1) / WORD_MIN + 1 <= CAND &&
                  CAND <= 2 * EMITTERS && EMITTERS + 32 == THREADS,
              "every flag word that reaches into a window has a thread");

// Body bytes of the walk's ring: byte x at x mod SLOTS * CHUNK.
struct RingBody {
  const uint8_t* b;
  __device__ __forceinline__ uint32_t operator()(int x) const {
    return b[x & (SLOTS * CHUNK - 1)];
  }
};

// Body bytes of an emission window: byte x at x - base.
struct WinBody {
  const uint8_t* b;
  int base;
  __device__ __forceinline__ uint32_t operator()(int x) const {
    return b[x - base];
  }
};

// The literals that a run of ``run`` zero flag bits makes from (s, p),
// with s <= len: the byte machine takes one only while s < len and
// p < olen.  p <= U rises by one a literal up to U, so with olen > U it
// never stops the run.  With p < olen, olen - p is exact in uint32_t.
__device__ __forceinline__ int lit_count(int run, int s, int len, int32_t p,
                                         int32_t olen, int U) {
  const uint32_t room = olen <= U ? (uint32_t)olen - (uint32_t)p : 32u;
  return p < olen ? (int)min(min((uint32_t)run, (uint32_t)(len - s)), room)
                  : 0;
}

// min(p + k, U) for p <= U and k >= 0, without overflow.
__device__ __forceinline__ int32_t lit_pos(int32_t p, int k, int U) {
  return (uint32_t)k > (uint32_t)U - (uint32_t)p ? U : p + k;
}

// flags << k for k in [0, 32].
__device__ __forceinline__ uint32_t shl(uint32_t flags, int k) {
  return __funnelshift_lc(0u, flags, k);
}

// The escape chain of a match whose length field is 7, after its high
// byte t: the shared nibble, then a byte, u16 or u32 escape, as the byte
// machine takes them.  Sets m_len (wrapping as tpucomp's int32 does), err
// for an escape length below 22, and t to the chain's last byte.  Returns
// CUT when the stream ends inside the chain (CHECKED), U32 after a u32
// escape, else DONE.
enum Chain { CUT, DONE, U32 };

template <bool CHECKED, class Body>
__device__ __forceinline__ Chain escape_chain(const Body& body, int len,
                                              int& t, uint32_t& nib_have,
                                              uint32_t& nib_val,
                                              uint32_t& m_len, uint32_t& e) {
  uint32_t nv;
  if (nib_have) {  // the high half of an earlier nibble byte
    nib_have = 0;
    nv = nib_val;
  } else {
    if (CHECKED && t + 1 >= len) return CUT;
    const uint32_t b = body(++t);
    nib_have = 1;
    nib_val = b >> 4;
    nv = b & 15;
  }
  if (nv < 15) {
    m_len = nv + 7 + MIN_MATCH;
    return DONE;
  }
  if (CHECKED && t + 1 >= len) return CUT;
  const uint32_t b = body(++t);
  if (b < 255) {
    m_len = b + 22 + MIN_MATCH;
    return DONE;
  }
  if (CHECKED && t + 2 >= len) return CUT;
  const uint32_t u16v = body(t + 1) | (body(t + 2) << 8);
  t += 2;
  if (u16v != 0) {
    m_len = u16v + MIN_MATCH;
    if (u16v < 22) e = 1;
    return DONE;
  }
  if (CHECKED && t + 4 >= len) return CUT;
  const uint32_t u32v = body(t + 1) | (body(t + 2) << 8) |
                        (body(t + 3) << 16) | (body(t + 4) << 24);
  t += 4;
  m_len = u32v + MIN_MATCH;
  if ((int32_t)u32v < 22) e = 1;
  return U32;
}

// One match token whose low byte is at s, as the byte machine takes it:
// its bytes, the escapes, err and the new position (wrapping, clamped to
// U).  CHECKED: s < len, and the function returns false when the stream
// ends inside the token (the row stops there, and nothing it changed is
// read again).  Else ``slot`` is its last byte, ``val`` its record, s the
// byte after it.
template <bool CHECKED, class Body>
__device__ __forceinline__ bool match_token(
    const Body& body, int len, int& s, int32_t& p, int32_t olen, int U,
    uint32_t& nib_have, uint32_t& nib_val, uint32_t& e, int& slot,
    int32_t& val) {
  if (CHECKED && s + 1 >= len) return false;
  const uint32_t tok = body(s) | (body(s + 1) << 8);
  int t = s + 1;
  uint32_t m_len = (tok & 7) + MIN_MATCH;
  if ((tok & 7) == 7 &&
      escape_chain<CHECKED>(body, len, t, nib_have, nib_val, m_len, e) == CUT)
    return false;
  const int32_t off = (int32_t)(tok >> 3) + 1;
  const int32_t end = (int32_t)((uint32_t)p + m_len);
  if (off > p || end > olen) e = 1;
  slot = t;
  val = COPY_BIT | off;
  p = min(end, U);
  s = t + 1;
  return true;
}

// The walk's escaped match (length field 7) at s, without checks: q
// unclamped.  Returns false on a u32 escape, which may wrap q: the word
// is walked again with every check.
__device__ __forceinline__ bool escape_fast(const RingBody& body, int& s,
                                            int32_t& q, uint32_t& nib_have,
                                            uint32_t& nib_val) {
  int t = s + 1;
  uint32_t m_len, e = 0;  // err is the emitters' to find
  if (escape_chain<false>(body, 0, t, nib_have, nib_val, m_len, e) == U32)
    return false;
  q += (int32_t)m_len;
  s = t + 1;
  return true;
}

// A flag word's tokens from the byte after its flags, with every check of
// the byte machine.  Returns false if the row stops inside the word.
__device__ __forceinline__ bool word_checked(const RingBody& rb, int len,
                                             int32_t olen, int U,
                                             uint32_t flags, int& s,
                                             int32_t& p, uint32_t& nib_have,
                                             uint32_t& nib_val, int& steps) {
  int n = 32;
  uint32_t e = 0;  // err is the emitters' to find
  for (;;) {
    const int run = min(__clz(flags), n);  // literals up to the next 1
    const int k = lit_count(run, s, len, p, olen, U);
    p = lit_pos(p, k, U);
    s += k;
    flags = shl(flags, k);
    n -= k;
    if (n == 0) return true;
    if (!(s < len && p < olen)) return false;
    ++steps;
    int slot;
    int32_t val;
    if (!match_token<true>(rb, len, s, p, olen, U, nib_have, nib_val, e,
                           slot, val))
      return false;
    flags <<= 1;
    --n;
  }
}

// Chunk c of the row's body into ring slot c % SLOTS (warp 0; bytes past
// P read as 0).  VEC (P % 16 == 0, the payload aligned): 16-byte cp.async
// copies, one commit group a chunk, landing while the walk goes on;
// otherwise byte loads, done when the chunk is asked for.
template <bool VEC>
__device__ __forceinline__ void load_chunk(const uint8_t* __restrict__ body,
                                           int P, int c, int lane,
                                           uint8_t* ring) {
  uint8_t* dst = ring + (c & (SLOTS - 1)) * CHUNK;
  if (VEC) {
#pragma unroll
    for (int j = 0; j < CHUNK / 512; ++j) {
      const int at = 16 * (lane + 32 * j), off = c * CHUNK + at;
      const int n = off + 16 <= P ? 16 : 0;  // 0: the 16 bytes read as 0
      asm volatile(
          "cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
              (uint32_t)__cvta_generic_to_shared(dst + at)),
          "l"(body + (n ? off : 0)), "r"(n)
          : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  } else {
    for (int i = lane; i < CHUNK; i += 32) {
      const int off = c * CHUNK + i;
      dst[i] = off < P ? body[off] : 0;
    }
  }
}

// Wait until all but the newest two chunks have landed, for every lane.
template <bool VEC>
__device__ __forceinline__ void chunks_landed() {
  if (VEC) asm volatile("cp.async.wait_group 2;" ::: "memory");
  __syncwarp();
}

// What the walk tells the emitters, in shared memory: ``pos`` = (flag
// words recorded, the first byte after the last one's tokens), written as
// one 64-bit store so that the pair is read whole; ``done`` once the walk
// has stopped and ``pos`` is final.
struct Progress {
  int2 pos;
  int done;
};

// Lane 0 publishes (w, edge) to the emitters; the lanes' entry stores
// before it are ordered by the warp's barrier and the fence.
__device__ __forceinline__ void publish(volatile Progress* prog, int lane,
                                       int w, int edge) {
  __syncwarp();
  if (lane == 0) {
    __threadfence_block();
    *(volatile long long*)&prog->pos =
        (long long)(uint32_t)w | ((long long)edge << 32);
  }
}

// The skeleton walk (warp 0; every lane holds the same state).  Each flag
// word's entry is stored as the walk reaches it.  The progress is
// published, behind a fence, when the walk enters a new ring chunk: the
// emitters wait for the walk to pass a window's end, a multiple of CHUNK.
template <bool VEC>
__device__ void skeleton_walk(const uint8_t* __restrict__ body, int len,
                              int32_t olen, int P, int U, uint8_t* ring,
                              int4* ent, int lane, volatile Progress* prog,
                              int32_t* p_out, int32_t* steps_out) {
  for (int c = 0; c < SLOTS; ++c) load_chunk<VEC>(body, P, c, lane, ring);
  chunks_landed<VEC>();
  const RingBody rb{ring};
  const int32_t q_max = min(olen, U);
  uint32_t lt;  // the lanes below this one
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(lt));
  int s = 0, w = 0, steps = 0, c0 = 0;
  int32_t p = 0;
  uint32_t nib_have = 0, nib_val = 0;
  bool stopped = false;
  while (s + 4 <= len && p < olen) {  // at a flag word
    ++steps;
    if (s >= (c0 + 1) * CHUNK) {
      // chunk c0 lies behind the walk: chunk c0 + SLOTS takes its slot
      load_chunk<VEC>(body, P, c0 + SLOTS, lane, ring);
      ++c0;
      chunks_landed<VEC>();
      publish(prog, lane, w, s);
    }
    const uint32_t flags =
        rb(s) | (rb(s + 1) << 8) | (rb(s + 2) << 16) | (rb(s + 3) << 24);
    if (flags == 0 && !(XP_DROP & 1)) {
      // this word and the words of 32 literals after it, up to 32 at
      // once: lane j takes the word that starts WORD_MIN * j bytes on
      const int sj = s + WORD_MIN * lane;
      const uint32_t fj = lane ? rb(sj) | (rb(sj + 1) << 8) |
                                     (rb(sj + 2) << 16) | (rb(sj + 3) << 24)
                               : 0u;
      const bool lit = fj == 0 && sj + WORD_MIN <= len &&
                       p + 32 * (lane + 1) <= q_max;
      const uint32_t ok = __ballot_sync(FULL, lit);
      const int f = ok == FULL ? 32 : __ffs(~ok) - 1;
      if (f) {
        if (lane < f)
          ent[w + lane] = make_int4(sj + 4, p + 32 * lane,
                                    (int)((nib_have << 4) | nib_val), 0);
        w += f;
        steps += f - 1;
        s += WORD_MIN * f;
        p += 32 * f;
        continue;
      }
    }
    // every lane stores the same entry: one store, no divergence
    ent[w++] = make_int4(s + 4, p, (int)((nib_have << 4) | nib_val),
                         (int)flags);
    // the word without the stop checks, a round of the warp at a time:
    // lane j reads token j's low byte where token j starts if every match
    // before it in the round has 2 bytes; the first escaped match (length
    // field 7) ends the round and is taken alone
    const int s0 = s + 4, steps0 = steps;
    const uint32_t have0 = nib_have, val0 = nib_val;
    uint32_t mr = __brev(flags);  // token j's flag bit at bit j
    int c = 0;                    // tokens done
    int32_t q = p;
    bool plain = !(XP_DROP & 2);
    s = s0;
    for (; plain;) {
      const bool is_m = (mr >> lane) & 1;
      const int sj = s + (lane - c) + __popc(mr & lt);
      const uint32_t L0 = is_m ? rb(sj) & 7 : 0;
      const uint32_t esc = __ballot_sync(FULL, L0 == 7);
      const int x = esc ? __ffs(esc) - 1 : 32;  // the escaped match
      q += (int32_t)__reduce_add_sync(
          FULL, lane < c || lane >= x ? 0u : is_m ? L0 + MIN_MATCH : 1u);
      const uint32_t done = x == 32 ? mr : mr & ((1u << x) - 1);
      steps += __popc(done);
      if (x == 32) {
        s += 32 - c + __popc(mr);
        break;
      }
      s += x - c + __popc(done);
      ++steps;
      if (!escape_fast(rb, s, q, nib_have, nib_val)) {
        plain = false;
        break;
      }
      mr &= ~((2u << x) - 1);  // tokens up to x done
      c = x + 1;
      if (c == 32) break;
    }
    if (plain && s <= len && q <= q_max) {
      p = q;
      continue;
    }
    // again with every check: the row's last word, or a clamp or a wrap
    s = s0;
    steps = steps0;
    nib_have = have0;
    nib_val = val0;
    if (!word_checked(rb, len, olen, U, flags, s, p, nib_have, nib_val,
                      steps)) {
      stopped = true;
      break;
    }
  }
  if (!stopped && s < len && p < olen) ++steps;  // a flag word cut short
  publish(prog, lane, w, s);
  if (lane == 0) {
    *p_out = p;
    *steps_out = steps;
    __threadfence_block();
    prog->done = 1;
  }
}

// An emitter re-walks the flag word of entry ``e4`` into the staging
// window of slots [a, a + WIN), and ORs the err of the tokens it walks
// into ``e``.  CHECKED: the last word the walk has recorded, which may
// hold the row's stop, with every check; the others complete all 32
// tokens, so their stop checks never fire and are left out (clamps and
// wraps stay).
template <bool CHECKED, class Body>
__device__ void walk_word(const Body& body, int4 e4, int len, int32_t olen,
                          int U, int a, int32_t* st_pos, int32_t* st_val,
                          uint32_t& e) {
  int s = e4.x;
  int32_t p = e4.y;
  uint32_t nib_have = (uint32_t)e4.z >> 4, nib_val = (uint32_t)e4.z & 15;
  uint32_t flags = (uint32_t)e4.w;
  int n = 32;
  const int hi = a + WIN;
  for (;;) {
    const int run = min(__clz(flags), n);
    const int k = CHECKED ? lit_count(run, s, len, p, olen, U) : run;
    const int j1 = min(k, hi - s);
    for (int j = max(0, a - s); j < j1; ++j) {
      st_pos[s + j - a] = lit_pos(p, j, U);
      st_val[s + j - a] = (int32_t)body(s + j);
    }
    p = lit_pos(p, k, U);
    s += k;
    flags = shl(flags, k);
    n -= k;
    if (n == 0 || s >= hi) return;
    if (CHECKED && !(s < len && p < olen)) return;
    const int32_t pos = p;
    int slot;
    int32_t val;
    if (!match_token<CHECKED>(body, len, s, p, olen, U, nib_have, nib_val, e,
                              slot, val))
      return;
    if (slot >= a && slot < hi) {
      st_pos[slot - a] = pos;
      st_val[slot - a] = val;
    }
    flags <<= 1;
    --n;
  }
}

__device__ __forceinline__ void emit_sync() {
  asm volatile("bar.sync %0, %1;" ::"r"(EMIT_BAR), "r"(EMITTERS) : "memory");
}

// The emitters' count of ``pred``, also their barrier.
__device__ __forceinline__ int emit_count(bool pred) {
  int n;
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %1, 0;\n\t"
      "bar.red.popc.u32 %0, %2, %3, p;\n\t}"
      : "=r"(n)
      : "r"((int)pred), "r"(EMIT_BAR), "r"(EMITTERS)
      : "memory");
  return n;
}

// The emission (warps 1-3; t = threadIdx.x - 32).
template <bool VEC>
__device__ void emit(const uint8_t* __restrict__ body, int len, int32_t olen,
                     int P, int U, uint8_t* bodyw, int32_t* st_pos,
                     int32_t* st_val, const int4* ent,
                     volatile Progress* prog, int32_t* __restrict__ rp,
                     int32_t* __restrict__ rv, int32_t* err, int t) {
  for (int i = t; i < WIN; i += EMITTERS) {
    st_pos[i] = SENT;
    st_val[i] = 0;
  }
  // windows at or past the stream's end hold no record: stored now,
  // while the walk goes on
  const int a_end = min(P, (max(len, 0) + WIN - 1) / WIN * WIN);
  if (VEC) {
    for (int g = a_end / 4 + t; g < P / 4; g += EMITTERS) {
      *(int4*)(rp + 4 * g) = make_int4(SENT, SENT, SENT, SENT);
      *(int4*)(rv + 4 * g) = make_int4(0, 0, 0, 0);
    }
  } else {
    for (int i = a_end + t; i < P; i += EMITTERS) {
      rp[i] = SENT;
      rv[i] = 0;
    }
  }
  int w0 = 0;  // the first flag word whose tokens end past window a
  uint32_t e = 0;  // err of every token this thread walks
  for (int a = 0; a < a_end; a += WIN) {
    // the walk has passed the window's end (so every flag word that
    // reaches into the window is recorded, and where its tokens end), or
    // it has stopped
    if (t == 0) {
      while (!prog->done && (prog->pos.y < a + WIN || (XP_DROP & 4)))
        __nanosleep(256);
      __threadfence_block();
    }
    emit_sync();
    __threadfence_block();
    const long long pr = *(volatile long long*)&prog->pos;
    const int nw = (int)(uint32_t)pr;
    const int edge = (int)(pr >> 32);  // where the last word's tokens end
    const int base = a - LEAD;
    if (a < edge) {  // the body bytes of the window's flag words
      if (VEC) {
        for (int g = t; g < BODY_WIN / 16; g += EMITTERS) {
          const int off = base + 16 * g;
          *(uint4*)(bodyw + 16 * g) =
              off >= 0 && off + 16 <= P ? __ldg((const uint4*)(body + off))
                                        : make_uint4(0, 0, 0, 0);
        }
      } else {
        for (int i = t; i < BODY_WIN; i += EMITTERS) {
          const int off = base + i;
          bodyw[i] = off >= 0 && off < P ? body[off] : 0;
        }
      }
    }
    // a word's tokens fill slots [ent.x, end): end is the next word's
    // first byte, or the edge for the last word recorded
    int4 e4[2];
    int end[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int w = w0 + t + h * EMITTERS;
      end[h] = INT_MAX;
      e4[h] = make_int4(INT_MAX, 0, 0, 0);
      if (w < nw && t + h * EMITTERS < CAND) {
        e4[h] = __ldcg(ent + w);  // L2: written by this block's walk
        end[h] = w + 1 < nw ? __ldcg(&ent[w + 1].x) - 4 : edge;
      }
    }
    emit_sync();
    const WinBody wb{bodyw, base};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the last word recorded may hold the stop: every check for it
      if (end[h] > a && e4[h].x - 4 < a + WIN) {
        if (end[h] == edge)
          walk_word<true>(wb, e4[h], len, olen, U, a, st_pos, st_val, e);
        else
          walk_word<false>(wb, e4[h], len, olen, U, a, st_pos, st_val, e);
      }
    }
    const int passed =
        emit_count(end[0] <= a + WIN) + emit_count(end[1] <= a + WIN);
    const int n_slots = min(WIN, P - a);
    if (VEC) {
      for (int g = t; g < n_slots / 4; g += EMITTERS) {
        *(int4*)(rp + a + 4 * g) = *(const int4*)(st_pos + 4 * g);
        *(int4*)(rv + a + 4 * g) = *(const int4*)(st_val + 4 * g);
        *(int4*)(st_pos + 4 * g) = make_int4(SENT, SENT, SENT, SENT);
        *(int4*)(st_val + 4 * g) = make_int4(0, 0, 0, 0);
      }
    } else {
      for (int i = t; i < n_slots; i += EMITTERS) {
        rp[a + i] = st_pos[i];
        rv[a + i] = st_val[i];
        st_pos[i] = SENT;
        st_val[i] = 0;
      }
    }
    w0 += passed;
  }
  const int bad = emit_count(e != 0);
  if (t == 0) *err = bad != 0;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
xp_parse_kernel(const uint8_t* __restrict__ payload,
                const int32_t* __restrict__ plen,
                const int32_t* __restrict__ out_len,
                int32_t* __restrict__ rec_pos, int32_t* __restrict__ rec_val,
                int32_t* __restrict__ p_final, int32_t* __restrict__ err,
                int32_t* __restrict__ steps, int4* entries,
                int P, int U, int max_words) {
  __shared__ __align__(16) uint8_t ring[SLOTS * CHUNK];
  __shared__ __align__(16) uint8_t bodyw[BODY_WIN];
  __shared__ __align__(16) int32_t st_pos[WIN];
  __shared__ __align__(16) int32_t st_val[WIN];
  __shared__ Progress prog;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const uint8_t* body = payload + (size_t)row * P;
  const int len = min(plen[row], P);
  const int32_t olen = out_len[row];
  int4* ent = entries + (size_t)row * max_words;
  volatile Progress* vp = &prog;
  if (tid == 0) {
    *(volatile long long*)&vp->pos = 0;
    vp->done = 0;
  }
  __syncthreads();
  if (tid < 32)
    skeleton_walk<VEC>(body, len, olen, P, U, ring, ent, tid, vp,
                       p_final + row, steps + row);
  else
    emit<VEC>(body, len, olen, P, U, bodyw, st_pos, st_val, ent, vp,
              rec_pos + (size_t)row * P, rec_val + (size_t)row * P,
              err + row, tid - 32);
}

}  // namespace

extern "C" int xp_parse(const void* payload, const void* plen,
                        const void* out_len, void* rec_pos, void* rec_val,
                        void* p_final, void* err, void* steps, void* entries,
                        int n, int P, int U, int max_words, void* stream) {
  const bool vec = P % 16 == 0 && (uintptr_t)payload % 16 == 0;
  auto kernel = vec ? xp_parse_kernel<true> : xp_parse_kernel<false>;
  kernel<<<n, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)payload, (const int32_t*)plen, (const int32_t*)out_len,
      (int32_t*)rec_pos, (int32_t*)rec_val, (int32_t*)p_final,
      (int32_t*)err, (int32_t*)steps, (int4*)entries, P, U, max_words);
  return (int)cudaGetLastError();
}

// For a report of the occupancy reached: each build of the kernel (16-byte
// loads, then byte loads) writes three host ints to ``out``: its resident
// blocks an SM on the current device, its registers a thread and its
// static shared memory in bytes.
extern "C" int xp_parse_occupancy(int* out) {
  const void* fns[2] = {(const void*)xp_parse_kernel<true>,
                        (const void*)xp_parse_kernel<false>};
  for (int v = 0; v < 2; ++v) {
    cudaFuncAttributes attr;
    int blocks = 0;
    cudaFuncGetAttributes(&attr, fns[v]);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[v], THREADS, 0);
    out[3 * v] = blocks;
    out[3 * v + 1] = attr.numRegs;
    out[3 * v + 2] = (int)attr.sharedSizeBytes;
  }
  return (int)cudaGetLastError();
}
