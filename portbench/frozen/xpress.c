/* The benchmark's frozen copy of the port's one-shot plain LZXPRESS
 * encoder ([MS-XCA] 2.3-2.4): xpress_compress_opt and xpress_compress of
 * tpucomp_torch/native/tpucomp_native.c, with the offset-rewrite and
 * decode-depth helpers (rw_*) that xpress_compress_opt carries, as they
 * stand there.  The benchmark makes the plain-Xpress read cells' streams
 * with it, so the streams a read decodes never come from the code under
 * test, and stay the same whatever later changes make of the program.
 * Built with the host C compiler, in one library with every C source of
 * portbench/frozen/, into portbench/.build/ at first use
 * (portbench/frozen/__init__.py), which finds the encoder by its
 * exported name xpress_compress; every other name here is static, and
 * none is one of codec.c's.
 *
 * API: xpress_compress(in, n, out, cap) returns the number of bytes
 * written, or a negative code: -1 out of memory, -3 output buffer too
 * small.  It keeps static scratch: one caller at a time.
 */


#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define ERR_DATA (-1)
#define ERR_BUF (-3)
#define ERR_TABLE (-5) /* an over-subscribed XH Huffman table */
#define ERR_AGAIN (-7) /* internal: need more input (streaming) */
/* The bytes of a hash candidate taken as matching before the compare:
 * none, so every byte of a match is compared.  Built with
 * -DPORTBENCH_CONTROL (the control of the benchmark's write cells), the
 * 3 hashed bytes are taken unverified, as a finder that trusts its hash
 * takes them, and a hash collision makes a wrong match. */
#ifdef PORTBENCH_CONTROL
#define UNVERIFIED 3
#else
#define UNVERIFIED 0
#endif


/* Encoder option flags (the *_compress_opt entry points). */
#define OPT_RESOLVE_OFFSETS 1 /* encode-time origin-ascent offset rewrite */

/* Offset-rewrite parameters.  RW_NEAR mirrors the TPU decoder's
 * in-scan resolve window (kernels/common.py RESOLVE_WINDOW): matches
 * with d <= RW_NEAR resolve inside the decode scan, so only farther
 * matches are rewritten (growing a near offset would ADD far tags).
 * RW_LEVELS caps the ascent on adversarial chain topologies. */
#define RW_NEAR 512
#define RW_LEVELS 32

/* Origin-ascent offset rewrite (valid parse choice under [MS-XCA]
 * §2.1/§2.3: any source span with identical bytes is a legal match).
 * ``imm[x]`` holds the EMITTED immediate source of byte x (x itself
 * for literals).  A far match's source span ascends to its deepest
 * contiguous ancestor level — with earlier matches already rewritten,
 * that is an all-literal span after 1–2 hops — so a decoder's
 * data-parallel copy resolution sees depth-1 chains: one gather round
 * instead of log(depth) pointer-doubling rounds on the archive path.
 * Foreign decoders are unaffected (the stream stays bit-compatible). */
static inline int rw_ascend(const int32_t *imm, int pos, int off, int len,
                            int winmax) {
    if (off <= RW_NEAR || len > off) return off;
    for (int lvl = 0; lvl < RW_LEVELS; lvl++) {
        int s = pos - off;
        int32_t b0 = imm[s];
        int contig = 1;
        for (int i = 1; i < len; i++)
            if (imm[s + i] != b0 + i) { contig = 0; break; }
        if (!contig || b0 == s) break;
        int noff = pos - b0;
        if (noff > winmax) break;
        off = noff;
    }
    return off;
}

/* Decode-depth model, mirroring the TPU decoder's resolve semantics
 * (kernels/resolve_pallas.py + kernels/common._far_rounds): copy chains
 * confined to one RW_SEG-byte segment are resolved by the decoder's
 * CHEAP segment-level pointer-doubling rounds (gather table = segment);
 * only a hop that CROSSES a segment boundary costs a full-row dense
 * round.  ``R[x]`` = dense rounds until byte x is final (0 = final
 * after the near scan + segment level).  The in-segment chain length is
 * tracked separately (low bits of the same byte would be overkill —
 * the decoder's doubling resolves depth 2^cap per level, effectively
 * unbounded for real streams). */
#define RW_SEG_SHIFT 12 /* 4096 — kernels/common._far_rounds levels[0] */
/* In-segment chains are resolved by the decoder's segment-level
 * pointer DOUBLING (cond-driven: rounds run only while live in-segment
 * chains remain, so the encoder-side cap directly sets the decoder's
 * round count at ceil(log2(cap))).  With near-walk adoption charging
 * same-512 hops zero links (rw_state below), tightening the cap from
 * 48 to 8 measured +0.00% size on the 8 MB bench slice while cutting
 * the decoder's 4 KiB level from ~6 rounds to 3 (a depth-k chain
 * needs ceil(log2(k))+1 doubling rounds — the +1 fetches the terminus
 * value; tightening to 4 saves no round and costs +0.07%). */
#ifndef RW_CHAIN_CAP
#define RW_CHAIN_CAP 8
#endif
/* Plain-Xpress overlap-mode chain cap.  With the decoder's OVERLAPPED
 * segment tables every in-window hop is one cheap link, and a depth-k
 * chain costs the (adoptive, log-depth) overlapped DOUBLING rounds
 * ceil(log2(k))+1 dispatches — cap 32 => exactly the level's 6-round
 * budget.  Size sweep (8 MB silesia-like): cap 8 -> +8.2%, 16 ->
 * +4.2%, 32 -> +1.8%, 64 -> +0.6% over the unresolved stream; 32 is
 * the <= +2% north-star point. */
#ifndef RW_XP_CHAIN_CAP
#define RW_XP_CHAIN_CAP 32
#endif
/* Near-walk granule: the decoder's Pallas near scan (resolve_pallas.py,
 * SEG=512) walks each 512-byte segment sequentially and copies window
 * VALUES verbatim — a hop whose source lies in the SAME 512-segment
 * therefore ADOPTS the source's pointer state (final byte or far tag)
 * at zero chain cost.  Charging such hops +1 chain link (the pre-r4
 * model) over-counted the common small-offset case and shortened
 * matches the decoder resolves for free. */
#define RW_NEAR_SHIFT 9

static inline int rw_src_fold(int pos, int off, int i) {
    return (i < off) ? pos - off + i : pos + (i % off);
}

/* ``ov``: overlapped-table mode (plain Xpress).  The format's 8 KiB
 * window lets the decoder gather each 4 KiB segment from an OVERLAPPED
 * table [seg_base - ov, seg_base + S) that contains EVERY in-window
 * source (kernels/common._far_level_overlapped), so an in-table hop is
 * a cheap chain link (ncl) rather than a dense full-row round (nr) —
 * only periodic-fold hops whose source falls below seg_base - ov cost
 * a dense round.  ov == 0 selects the segment model (XH: the 64 KiB
 * window spans the whole block, overlapping cannot cover it). */
static inline void rw_state(const uint8_t *R, const uint8_t *CL, int srcf,
                            int dst, int *nr, int *ncl, int ov) {
    if ((srcf >> RW_NEAR_SHIFT) == (dst >> RW_NEAR_SHIFT)) {
        *nr = R[srcf]; *ncl = CL[srcf]; /* near-walk adoption */
    } else if (ov ? (srcf >= ((dst >> RW_SEG_SHIFT) << RW_SEG_SHIFT) - ov)
                  : ((srcf >> RW_SEG_SHIFT) == (dst >> RW_SEG_SHIFT))) {
        *nr = R[srcf]; *ncl = CL[srcf] + 1; /* in-table/in-segment link */
    } else {
        *nr = R[srcf] + 1; *ncl = 0; /* out of table: one dense round */
    }
}

static inline int rw_depth_prefix(const uint8_t *R, const uint8_t *CL,
                                  int pos, int off, int len, int D,
                                  int ov, int clcap) {
    for (int i = 0; i < len; i++) {
        int srcf = rw_src_fold(pos, off, i);
        int nr, ncl;
        rw_state(R, CL, srcf, pos + i, &nr, &ncl, ov);
        if (nr > D || ncl > clcap) return i;
    }
    return len;
}

static inline void rw_set_depth(uint8_t *R, uint8_t *CL, int pos, int off,
                                int len, int ov) {
    for (int i = 0; i < len; i++) {
        int srcf = rw_src_fold(pos, off, i);
        int nr, ncl;
        rw_state(R, CL, srcf, pos + i, &nr, &ncl, ov);
        R[pos + i] = (uint8_t)(nr > 15 ? 15 : nr);
        CL[pos + i] = (uint8_t)(ncl > 255 ? 255 : ncl);
    }
}

/* Combined rewrite step: origin ascent (bit 0) + hard decode-depth
 * bound D = (flags >> 8) & 0xF (0 = unbounded).  May SHORTEN the match
 * (possibly below the format minimum: caller emits a literal then).
 * Ascent and depth-shortening interact — a shorter span can ascend
 * farther and an ascended span is usually shallower — so alternate
 * twice, then enforce the bound exactly. */
static inline void rw_apply(const int32_t *imm, const uint8_t *R,
                            const uint8_t *CL, int pos, int *off, int *len,
                            int winmax, int flags, int ov, int clcap) {
    int D = (flags >> 8) & 0xF;
    for (int pass = 0; pass < 2; pass++) {
        if (flags & OPT_RESOLVE_OFFSETS)
            *off = rw_ascend(imm, pos, *off, *len, winmax);
        if (!D) return;
        int ul = rw_depth_prefix(R, CL, pos, *off, *len, D, ov, clcap);
        if (ul == *len) return;
        *len = ul;
        if (*len < 3) return;
    }
    *len = rw_depth_prefix(R, CL, pos, *off, *len, D, ov, clcap);
}


#define XP_WINDOW 8192
#define XP_HASH_BITS 14
#define XP_HASH_SIZE (1 << XP_HASH_BITS)
#define XP_DEPTH 48

static inline uint32_t xp_hash3(const uint8_t *p) {
    uint32_t v = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
    return (v * 0x9E3779B1u) >> (32 - XP_HASH_BITS);
}

typedef struct {
    uint8_t *out;
    int cap, o;
    uint32_t flags;
    int nflags;
    int flag_pos;
    int nib_pos;
} xp_writer;

static int xpw_flag(xp_writer *w, int bit) {
    if (w->flag_pos < 0) {
        if (w->o + 4 > w->cap) return ERR_BUF;
        w->flag_pos = w->o;
        w->o += 4;
    }
    w->flags = (w->flags << 1) | (uint32_t)bit;
    if (++w->nflags == 32) {
        memcpy(w->out + w->flag_pos, &w->flags, 4);
        w->flags = 0;
        w->nflags = 0;
        w->flag_pos = -1;
    }
    return 0;
}

static int xpw_finish(xp_writer *w) {
    if (w->flag_pos >= 0) {
        int rem = 32 - w->nflags;
        uint32_t f = (w->flags << rem) | ((rem == 32) ? 0xFFFFFFFFu : ((1u << rem) - 1));
        memcpy(w->out + w->flag_pos, &f, 4);
        w->flag_pos = -1;
    }
    return w->o;
}

static int xpress_compress_opt(const uint8_t *in, int in_len, uint8_t *out,
                               int cap, int flags) {
    static int32_t head[XP_HASH_SIZE];
    /* grown-once scratch arena (single-threaded ctypes usage) */
    static int32_t *prev = 0;
    static int32_t *imm = 0;
    static uint8_t *Rd = 0;
    static uint8_t *CLd = 0;
    static int prev_cap = 0;
    if (in_len > prev_cap) {
        free(prev);
        free(imm);
        free(Rd);
        free(CLd);
        prev_cap = in_len < (1 << 16) ? (1 << 16) : in_len;
        prev = (int32_t *)malloc((size_t)prev_cap * 4);
        imm = (int32_t *)malloc((size_t)prev_cap * 4);
        Rd = (uint8_t *)malloc((size_t)prev_cap);
        CLd = (uint8_t *)malloc((size_t)prev_cap);
        if (!prev || !imm || !Rd || !CLd) {
            free(prev); free(imm); free(Rd); free(CLd);
            prev = imm = 0; Rd = CLd = 0;
            prev_cap = 0; return ERR_DATA; }
    }
    if (in_len > 0) { /* zeroed depth state: see the head of this file */
        memset(Rd, 0, (size_t)in_len);
        memset(CLd, 0, (size_t)in_len);
    }
    memset(head, -1, sizeof(head));
    xp_writer w = { out, cap, 0, 0, 0, -1, -1 };
    int pos = 0;
    int bounded = (flags >> 8) & 0xF;
    while (pos < in_len) {
        int best_len = 0, best_off = 0;
        if (pos + 3 <= in_len) {
            uint32_t h = xp_hash3(in + pos);
            int cand = head[h];
            int depth = 0;
            while (cand >= 0 && pos - cand <= XP_WINDOW && depth++ < XP_DEPTH) {
                int lim = in_len - pos;
                int len = UNVERIFIED;
                while (len < lim && in[cand + len] == in[pos + len]) len++;
                if (bounded) {
                    /* depth-aware selection (see xh_compress_block) */
                    if (len >= 3) {
                        int off_c = pos - cand, len_c = len;
                        rw_apply(imm, Rd, CLd, pos, &off_c, &len_c,
                                 XP_WINDOW, flags, XP_WINDOW,
                                 RW_XP_CHAIN_CAP);
                        if (len_c > best_len) {
                            best_len = len_c; best_off = off_c;
                            if (best_len >= lim) break;
                        }
                    }
                } else if (len > best_len) {
                    best_len = len;
                    best_off = pos - cand;
                    if (len >= lim) break;
                }
                cand = prev[cand];
            }
        }
        if (best_len >= 3 && flags && !bounded)
            rw_apply(imm, Rd, CLd, pos, &best_off, &best_len, XP_WINDOW,
                     flags, XP_WINDOW, RW_XP_CHAIN_CAP);
        if (best_len >= 3) {
            if (flags) {
                for (int i = 0; i < best_len; i++)
                    imm[pos + i] = pos - best_off + i;
                rw_set_depth(Rd, CLd, pos, best_off, best_len,
                             XP_WINDOW);
            }
            if (xpw_flag(&w, 1)) return ERR_BUF;
            if (w.o + 2 > cap) return ERR_BUF;
            int L = best_len - 3;
            uint16_t tok = (uint16_t)(((best_off - 1) << 3) | (L < 7 ? L : 7));
            w.out[w.o++] = (uint8_t)tok;
            w.out[w.o++] = (uint8_t)(tok >> 8);
            if (L >= 7) {
                L -= 7;
                int nib = L < 15 ? L : 15;
                if (w.nib_pos < 0) {
                    if (w.o >= cap) return ERR_BUF;
                    w.nib_pos = w.o;
                    w.out[w.o++] = (uint8_t)nib;
                } else {
                    w.out[w.nib_pos] |= (uint8_t)(nib << 4);
                    w.nib_pos = -1;
                }
                if (L >= 15) {
                    L -= 15;
                    if (L < 255) {
                        if (w.o >= cap) return ERR_BUF;
                        w.out[w.o++] = (uint8_t)L;
                    } else {
                        uint32_t full = (uint32_t)(best_len - 3);
                        if (w.o + 3 > cap) return ERR_BUF;
                        w.out[w.o++] = 255;
                        if (full < 0x10000 && full != 0) {
                            w.out[w.o++] = (uint8_t)full;
                            w.out[w.o++] = (uint8_t)(full >> 8);
                        } else {
                            if (w.o + 6 > cap) return ERR_BUF;
                            w.out[w.o++] = 0;
                            w.out[w.o++] = 0;
                            memcpy(w.out + w.o, &full, 4);
                            w.o += 4;
                        }
                    }
                }
            }
            int end = pos + best_len;
            int he = end < in_len - 2 ? end : in_len - 2;
            for (; pos < he; pos++) {
                uint32_t h = xp_hash3(in + pos);
                prev[pos] = head[h];
                head[h] = pos;
            }
            pos = end;
        } else {
            if (xpw_flag(&w, 0)) return ERR_BUF;
            if (w.o >= cap) return ERR_BUF;
            if (flags) { imm[pos] = pos; Rd[pos] = 0; CLd[pos] = 0; }
            if (pos + 3 <= in_len) {
                uint32_t h = xp_hash3(in + pos);
                prev[pos] = head[h];
                head[h] = pos;
            }
            w.out[w.o++] = in[pos++];
        }
    }
    return xpw_finish(&w);
}

int xpress_compress(const uint8_t *in, int in_len, uint8_t *out, int cap) {
    return xpress_compress_opt(in, in_len, out, cap, 0);
}
