/* tpucomp_torch's copy of tpucomp's native C codec
 * (tpucomp/native/tpucomp_native.c): LZNT1, plain Xpress and Xpress
 * Huffman one-shot encode and decode, the archive profile's resolved
 * encoders (xpress_compress_opt, xh_compress_opt, with the offset
 * rewrite and decode-depth model they share, rw_*), and the four
 * window-carry stream engines (xh_scomp_*, xp_scomp_*, xp_sdec_*,
 * xh_sdec_*).  The code below is tpucomp's, so that either package gives
 * the same bytes.  One change: each resolved call first sets the depth
 * state (R, CL) to zero.  tpucomp's resolved encoders read that state
 * inside a match's own span before they write it, so their bytes depend
 * on the calls before (uninitialised heap on the first plain Xpress
 * call).  Here a call gives the bytes tpucomp gives from a zeroed state,
 * whatever came before.  The plain encoders (flags 0) never read that
 * state, so their bytes are tpucomp's.  The port builds this file with
 * the host C compiler at first use (tpucomp_torch/_native.py).
 *
 * API: each entry point returns the number of bytes written, or a
 * negative code: -1 data error, -3 output buffer too small.  The
 * encoders keep static scratch: one caller at a time.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define ERR_DATA (-1)
#define ERR_BUF (-3)
#define ERR_AGAIN (-7) /* internal: need more input (streaming) */

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

/* ================= LZNT1 ([MS-XCA] 2.5) ================= */

#define LZ_CHUNK 4096
#define LZ_HASH_BITS 12
#define LZ_HASH_SIZE (1 << LZ_HASH_BITS)
#define LZ_DEPTH 48

static inline uint32_t hash3(const uint8_t *p) {
    uint32_t v = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
    return (v * 0x9E3779B1u) >> (32 - LZ_HASH_BITS);
}

static inline void lznt1_split(int pos, int *d_shift) {
    int s = 0, q = pos - 1;
    while (q >= 0x10) { s++; q >>= 1; }
    *d_shift = 12 - s;
}

static int lznt1_compress_chunk(const uint8_t *in, int n, uint8_t *out, int cap) {
    int16_t head[LZ_HASH_SIZE];
    int16_t prev[LZ_CHUNK];
    memset(head, -1, sizeof(head));
    int o = 0, pos = 0;
    while (pos < n) {
        if (o >= cap) return ERR_BUF;
        int flag_pos = o++;
        uint8_t flag = 0;
        for (int bit = 0; bit < 8 && pos < n; bit++) {
            int d_shift;
            lznt1_split(pos, &d_shift);
            int l_mask = (1 << d_shift) - 1;
            int max_len = l_mask + 3;
            if (max_len > n - pos) max_len = n - pos;
            int best_len = 0, best_disp = 0;
            if (pos + 3 <= n) {
                uint32_t h = hash3(in + pos);
                int cand = head[h];
                int depth = 0;
                while (cand >= 0 && depth++ < LZ_DEPTH) {
                    int len = 0;
                    while (len < max_len && in[cand + len] == in[pos + len]) len++;
                    if (len > best_len) {
                        best_len = len;
                        best_disp = pos - cand;
                        if (len >= max_len) break;
                    }
                    cand = prev[cand];
                }
            }
            if (best_len >= 3) {
                if (o + 2 > cap) return ERR_BUF;
                uint16_t tok = (uint16_t)(((best_disp - 1) << d_shift) | (best_len - 3));
                out[o++] = (uint8_t)tok;
                out[o++] = (uint8_t)(tok >> 8);
                flag |= (uint8_t)(1 << bit);
                int next = pos + best_len;
                int hash_end = next < n - 2 ? next : n - 2;
                for (; pos < hash_end; pos++) {
                    uint32_t h = hash3(in + pos);
                    prev[pos] = head[h];
                    head[h] = (int16_t)pos;
                }
                pos = next;
            } else {
                if (o >= cap) return ERR_BUF;
                if (pos + 3 <= n) {
                    uint32_t h = hash3(in + pos);
                    prev[pos] = head[h];
                    head[h] = (int16_t)pos;
                }
                out[o++] = in[pos++];
            }
        }
        out[flag_pos] = flag;
    }
    return o;
}

int lznt1_compress(const uint8_t *in, int in_len, uint8_t *out, int cap) {
    int o = 0;
    for (int start = 0; start < in_len; start += LZ_CHUNK) {
        int n = in_len - start;
        if (n > LZ_CHUNK) n = LZ_CHUNK;
        if (o + 2 > cap) return ERR_BUF;
        uint8_t tmp[LZ_CHUNK + LZ_CHUNK / 8 + 16];
        int c = lznt1_compress_chunk(in + start, n, tmp, (int)sizeof(tmp));
        if (c < 0 && c != ERR_BUF) return c;
        if (c > 0 && c < n) {
            uint16_t hdr = (uint16_t)(0xB000 | (c - 1));
            out[o++] = (uint8_t)hdr;
            out[o++] = (uint8_t)(hdr >> 8);
            if (o + c > cap) return ERR_BUF;
            memcpy(out + o, tmp, (size_t)c);
            o += c;
        } else {
            uint16_t hdr = (uint16_t)(0x3000 | (n - 1));
            out[o++] = (uint8_t)hdr;
            out[o++] = (uint8_t)(hdr >> 8);
            if (o + n > cap) return ERR_BUF;
            memcpy(out + o, in + start, (size_t)n);
            o += n;
        }
    }
    return o;
}

int lznt1_decompress(const uint8_t *in, int in_len, uint8_t *out, int cap) {
    int i = 0, o = 0;
    while (i + 2 <= in_len) {
        uint16_t hdr = (uint16_t)(in[i] | (in[i + 1] << 8));
        i += 2;
        if (hdr == 0) break;
        int size = (hdr & 0xFFF) + 1;
        if (i + size > in_len) return ERR_DATA;
        int chunk_start = o;
        if (!(hdr & 0x8000)) {
            if (o + size > cap) return ERR_BUF;
            memcpy(out + o, in + i, (size_t)size);
            o += size;
            i += size;
        } else {
            int end = i + size;
            while (i < end) {
                uint8_t flags = in[i++];
                for (int bit = 0; bit < 8 && i < end; bit++) {
                    if (flags & (1 << bit)) {
                        if (i + 2 > end) return ERR_DATA;
                        uint16_t tok = (uint16_t)(in[i] | (in[i + 1] << 8));
                        i += 2;
                        int p = o - chunk_start;
                        int d_shift;
                        lznt1_split(p, &d_shift);
                        int len = (tok & ((1 << d_shift) - 1)) + 3;
                        int disp = (tok >> d_shift) + 1;
                        if (disp > p || p + len > LZ_CHUNK) return ERR_DATA;
                        if (o + len > cap) return ERR_BUF;
                        for (int k = 0; k < len; k++, o++) out[o] = out[o - disp];
                    } else {
                        if (o >= cap) return ERR_BUF;
                        out[o++] = in[i++];
                    }
                }
            }
            if (o - chunk_start > LZ_CHUNK) return ERR_DATA;
        }
    }
    return o;
}

/* ================= Plain Xpress ([MS-XCA] 2.3-2.4) ================= */

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

int xpress_compress_opt(const uint8_t *in, int in_len, uint8_t *out, int cap,
                        int flags) {
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
                int len = 0;
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

int xpress_decompress(const uint8_t *in, int in_len, uint8_t *out, int out_len) {
    int i = 0, o = 0;
    uint32_t flags = 0;
    int nflags = 0, nib_pos = -1;
    while (o < out_len) {
        if (nflags == 0) {
            if (i + 4 > in_len) return ERR_DATA;
            memcpy(&flags, in + i, 4);
            i += 4;
            nflags = 32;
        }
        int is_match = (flags >> 31) & 1;
        flags <<= 1;
        nflags--;
        if (!is_match) {
            if (i >= in_len) return ERR_DATA;
            out[o++] = in[i++];
        } else {
            if (i + 2 > in_len) return ERR_DATA;
            uint16_t tok = (uint16_t)(in[i] | (in[i + 1] << 8));
            i += 2;
            int off = (tok >> 3) + 1;
            uint32_t L = tok & 7;
            if (L == 7) {
                if (nib_pos < 0) {
                    if (i >= in_len) return ERR_DATA;
                    nib_pos = i;
                    L = in[i++] & 0xF;
                } else {
                    L = in[nib_pos] >> 4;
                    nib_pos = -1;
                }
                if (L == 15) {
                    if (i >= in_len) return ERR_DATA;
                    L = in[i++];
                    if (L == 255) {
                        if (i + 2 > in_len) return ERR_DATA;
                        L = (uint32_t)(in[i] | (in[i + 1] << 8));
                        i += 2;
                        if (L == 0) {
                            if (i + 4 > in_len) return ERR_DATA;
                            memcpy(&L, in + i, 4);
                            i += 4;
                        }
                        if (L < 22) return ERR_DATA;
                        L -= 22;
                    }
                    L += 15;
                }
                L += 7;
            }
            int len = (int)L + 3;
            if (off > o || o + len > out_len) return ERR_DATA;
            for (int k = 0; k < len; k++, o++) out[o] = out[o - off];
        }
    }
    return o;
}

/* ============ Xpress Huffman ([MS-XCA] 2.1-2.2) ============ */

#define XH_BLOCK 65536
#define XH_SYMS 512
#define XH_MAXLEN 15

typedef struct {
    uint8_t *out;
    int cap, o;
    uint32_t bitbuf;
    int bitcount;
    int slot0, slot1;
} xh_writer;

static int xhw_init(xh_writer *w, uint8_t *out, int cap, int o) {
    w->out = out; w->cap = cap; w->o = o;
    w->bitbuf = 0; w->bitcount = 0;
    if (o + 4 > cap) return ERR_BUF;
    w->slot0 = o; w->slot1 = o + 2;
    w->out[o] = w->out[o+1] = w->out[o+2] = w->out[o+3] = 0;
    w->o = o + 4;
    return 0;
}

static int xhw_bits(xh_writer *w, uint32_t val, int nbits) {
    if (!nbits) return 0;
    w->bitbuf = (w->bitbuf << nbits) | (val & ((1u << nbits) - 1));
    w->bitcount += nbits;
    while (w->bitcount > 16) {
        w->bitcount -= 16;
        uint16_t word = (uint16_t)(w->bitbuf >> w->bitcount);
        w->out[w->slot0] = (uint8_t)word;
        w->out[w->slot0 + 1] = (uint8_t)(word >> 8);
        w->slot0 = w->slot1;
        if (w->o + 2 > w->cap) return ERR_BUF;
        w->slot1 = w->o;
        w->out[w->o] = w->out[w->o + 1] = 0;
        w->o += 2;
    }
    return 0;
}

static void xhw_flush(xh_writer *w) {
    if (w->bitcount) {
        uint16_t word = (uint16_t)((w->bitbuf << (16 - w->bitcount)) & 0xFFFF);
        w->out[w->slot0] = (uint8_t)word;
        w->out[w->slot0 + 1] = (uint8_t)(word >> 8);
    }
}

/* two-queue Huffman + 15-bit repair + canonical codes */
static void xh_build_lengths(const uint32_t *freq, uint8_t *lens) {
    int order[XH_SYMS];
    uint32_t f[XH_SYMS];
    int n = 0;
    for (int s = 0; s < XH_SYMS; s++) {
        lens[s] = 0;
        if (freq[s]) { order[n] = s; f[n] = freq[s]; n++; }
    }
    if (n == 0) return;
    if (n == 1) { lens[order[0]] = 1; return; }
    /* sort leaves by (freq, sym) — insertion sort is fine at 512 */
    for (int a = 1; a < n; a++) {
        int s = order[a]; uint32_t fa = f[a];
        int b = a - 1;
        while (b >= 0 && (f[b] > fa)) { f[b+1] = f[b]; order[b+1] = order[b]; b--; }
        f[b+1] = fa; order[b+1] = s;
    }
    /* two-queue merge recording parents */
    uint32_t nodef[XH_SYMS];
    int leaf_parent[XH_SYMS], node_parent[XH_SYMS];
    int lp = 0, nh = 0, created = 0;
    while (created < n - 1) {
        int take_leaf1 = (nh >= created) || (lp < n && f[lp] <= nodef[nh]);
        uint32_t c1; int t1l = take_leaf1, i1 = take_leaf1 ? lp : nh;
        if (take_leaf1) c1 = f[lp++]; else c1 = nodef[nh++];
        int take_leaf2 = (nh >= created) || (lp < n && f[lp] <= nodef[nh]);
        if (lp >= n) take_leaf2 = 0;
        uint32_t c2; int t2l = take_leaf2, i2 = take_leaf2 ? lp : nh;
        if (take_leaf2) c2 = f[lp++]; else c2 = nodef[nh++];
        nodef[created] = c1 + c2;
        if (t1l) leaf_parent[i1] = created; else node_parent[i1] = created;
        if (t2l) leaf_parent[i2] = created; else node_parent[i2] = created;
        created++;
    }
    int node_depth[XH_SYMS];
    node_depth[created - 1] = 0;
    for (int s = created - 2; s >= 0; s--)
        node_depth[s] = node_depth[node_parent[s]] + 1;
    /* depth profile with 15-bit clamp + kraft repair */
    int cnt[XH_MAXLEN + 2];
    memset(cnt, 0, sizeof(cnt));
    for (int k = 0; k < n; k++) {
        int d = node_depth[leaf_parent[k]] + 1;
        if (d > XH_MAXLEN) d = XH_MAXLEN;
        cnt[d]++;
    }
    long kraft = 0;
    for (int l = 1; l <= XH_MAXLEN; l++) kraft += (long)cnt[l] << (XH_MAXLEN - l);
    while (kraft > (1L << XH_MAXLEN)) {
        for (int l = XH_MAXLEN - 1; l >= 1; l--) {
            if (cnt[l] > 0) {
                cnt[l]--; cnt[l + 1]++;
                kraft -= 1L << (XH_MAXLEN - 1 - l);
                break;
            }
        }
    }
    /* assign: longest codes to smallest-freq leaves (sorted order) */
    int k = 0;
    for (int l = XH_MAXLEN; l >= 1; l--)
        for (int c = 0; c < cnt[l]; c++) lens[order[k++]] = (uint8_t)l;
}

static void xh_canonical(const uint8_t *lens, uint16_t *codes) {
    int cnt[XH_MAXLEN + 1];
    memset(cnt, 0, sizeof(cnt));
    for (int s = 0; s < XH_SYMS; s++) if (lens[s]) cnt[lens[s]]++;
    uint16_t first[XH_MAXLEN + 1];
    uint16_t code = 0;
    for (int l = 1; l <= XH_MAXLEN; l++) {
        first[l] = code;
        code = (uint16_t)((code + cnt[l]) << 1);
    }
    uint16_t next[XH_MAXLEN + 1];
    memcpy(next, first, sizeof(next));
    for (int s = 0; s < XH_SYMS; s++)
        if (lens[s]) codes[s] = next[lens[s]]++;
}

/* Compress ONE <=64 KiB block (table + bitstream) into out; returns
 * bytes written.  Shared by the one-shot path and the stream
 * compressor (block-local window: identical output either way).
 * ``clear``: set the depth state to zero first (a call's first block). */
static int xh_compress_block(const uint8_t *blk, int n, uint8_t *out, int cap,
                             int flags, int clear) {
    static int32_t head[XP_HASH_SIZE];
    static int32_t prev_buf[XH_BLOCK];
    static int32_t imm_buf[XH_BLOCK];
    static uint8_t R_buf[XH_BLOCK];
    static uint8_t CL_buf[XH_BLOCK];
    static int32_t tok_pos[XH_BLOCK];
    static int32_t tok_len[XH_BLOCK];
    static int32_t tok_off[XH_BLOCK];
    int o = 0;
    if (clear) { /* a call's first block: zeroed depth state */
        memset(R_buf, 0, sizeof(R_buf));
        memset(CL_buf, 0, sizeof(CL_buf));
    }
    {
        memset(head, -1, sizeof(head));
        /* parse */
        int T = 0, pos = 0;
        uint32_t freq[XH_SYMS];
        memset(freq, 0, sizeof(freq));
        int bounded = (flags >> 8) & 0xF;
        while (pos < n) {
            int best_len = 0, best_off = 0;
            if (pos + 3 <= n) {
                uint32_t h = xp_hash3(blk + pos);
                int cand = head[h];
                int depth = 0;
                while (cand >= 0 && depth++ < XP_DEPTH) {
                    int lim = n - pos;
                    int len = 0;
                    while (len < lim && blk[cand + len] == blk[pos + len]) len++;
                    if (bounded) {
                        /* depth-aware selection: score each candidate
                         * by its USABLE length after ascent + depth
                         * bound — a shallower source often beats a
                         * longer-but-deep one under the bound */
                        if (len >= 3) {
                            int off_c = pos - cand, len_c = len;
                            rw_apply(imm_buf, R_buf, CL_buf, pos, &off_c,
                                     &len_c, n - 1, flags, 0,
                                     RW_CHAIN_CAP);
                            if (len_c > best_len) {
                                best_len = len_c; best_off = off_c;
                                if (best_len >= lim) break;
                            }
                        }
                    } else if (len > best_len) {
                        best_len = len; best_off = pos - cand;
                        if (len >= lim) break;
                    }
                    cand = prev_buf[cand];
                }
            }
            if (best_len >= 3 && flags && !bounded)
                rw_apply(imm_buf, R_buf, CL_buf, pos, &best_off, &best_len,
                         n - 1, flags, 0, RW_CHAIN_CAP);
            if (best_len >= 3) {
                if (flags) {
                    for (int i = 0; i < best_len; i++)
                        imm_buf[pos + i] = pos - best_off + i;
                    rw_set_depth(R_buf, CL_buf, pos, best_off, best_len,
                                 0);
                }
                tok_pos[T] = pos; tok_len[T] = best_len; tok_off[T] = best_off; T++;
                int L = best_len - 3;
                int obc = 0; while ((1 << (obc + 1)) <= best_off) obc++;
                int lh = L < 15 ? L : 15;
                freq[256 + ((obc << 4) | lh)]++;
                int end = pos + best_len;
                int he = end < n - 2 ? end : n - 2;
                for (; pos < he; pos++) {
                    uint32_t h = xp_hash3(blk + pos);
                    prev_buf[pos] = head[h];
                    head[h] = pos;
                }
                pos = end;
            } else {
                tok_pos[T] = pos; tok_len[T] = -1; tok_off[T] = blk[pos]; T++;
                freq[blk[pos]]++;
                if (flags) { imm_buf[pos] = pos; R_buf[pos] = 0;
                             CL_buf[pos] = 0; }
                if (pos + 3 <= n) {
                    uint32_t h = xp_hash3(blk + pos);
                    prev_buf[pos] = head[h];
                    head[h] = pos;
                }
                pos++;
            }
        }
        /* table */
        uint8_t lens[XH_SYMS];
        uint16_t codes[XH_SYMS];
        xh_build_lengths(freq, lens);
        xh_canonical(lens, codes);
        if (o + 256 > cap) return ERR_BUF;
        for (int i2 = 0; i2 < 256; i2++)
            out[o + i2] = (uint8_t)(lens[2 * i2] | (lens[2 * i2 + 1] << 4));
        o += 256;
        /* bitstream */
        xh_writer w;
        if (xhw_init(&w, out, cap, o)) return ERR_BUF;
        for (int t = 0; t < T; t++) {
            if (tok_len[t] < 0) {
                int s = tok_off[t];
                if (xhw_bits(&w, codes[s], lens[s])) return ERR_BUF;
            } else {
                int L = tok_len[t] - 3;
                int off = tok_off[t];
                int obc = 0; while ((1 << (obc + 1)) <= off) obc++;
                int lh = L < 15 ? L : 15;
                int s = 256 + ((obc << 4) | lh);
                if (xhw_bits(&w, codes[s], lens[s])) return ERR_BUF;
                if (xhw_bits(&w, (uint32_t)off & ((1u << obc) - 1), obc)) return ERR_BUF;
                if (lh == 15) {
                    int rem = L - 15;
                    if (rem < 255) {
                        if (w.o >= w.cap) return ERR_BUF;
                        w.out[w.o++] = (uint8_t)rem;
                    } else {
                        if (w.o + 3 > w.cap) return ERR_BUF;
                        w.out[w.o++] = 255;
                        w.out[w.o++] = (uint8_t)L;
                        w.out[w.o++] = (uint8_t)(L >> 8);
                    }
                }
            }
        }
        xhw_flush(&w);
        o = w.o;
    }
    return o;
}

int xh_compress_opt(const uint8_t *in, int in_len, uint8_t *out, int cap,
                    int flags) {
    int o = 0;
    int nblocks = in_len ? (in_len + XH_BLOCK - 1) / XH_BLOCK : 1;
    for (int bi = 0; bi < nblocks; bi++) {
        const uint8_t *blk = in + bi * XH_BLOCK;
        int n = in_len - bi * XH_BLOCK;
        if (n > XH_BLOCK) n = XH_BLOCK;
        if (n < 0) n = 0;
        int c = xh_compress_block(blk, n, out + o, cap - o, flags, bi == 0);
        if (c < 0) return c;
        o += c;
    }
    return o;
}

int xh_compress(const uint8_t *in, int in_len, uint8_t *out, int cap) {
    return xh_compress_opt(in, in_len, out, cap, 0);
}

/* Shared XH parse loop.  ``disp``/``tokp`` (both-or-neither) record each
 * output byte's source displacement (0 for literals) and its token's
 * first output position — inputs to offline resolve-schedule analysis.
 * static inline + compile-time-NULL call site: the production
 * xh_decompress wrapper constant-folds the recording branches away, so
 * there is exactly ONE parse loop to maintain. */
static inline int xh_decompress_impl(const uint8_t *in, int in_len,
                                     uint8_t *out, int out_len,
                                     int32_t *disp, int32_t *tokp) {
    static uint16_t lut[1 << XH_MAXLEN]; /* (sym<<4)|len */
    int i = 0, o = 0;
    while (o < out_len) {
        if (i + 256 > in_len) return ERR_DATA;
        uint8_t lens[XH_SYMS];
        for (int k = 0; k < 256; k++) {
            lens[2 * k] = in[i + k] & 0xF;
            lens[2 * k + 1] = in[i + k] >> 4;
        }
        i += 256;
        uint16_t codes[XH_SYMS];
        xh_canonical(lens, codes);
        memset(lut, 0xFF, sizeof(lut));
        for (int s = 0; s < XH_SYMS; s++) {
            if (!lens[s]) continue;
            int span = 1 << (XH_MAXLEN - lens[s]);
            int base = codes[s] << (XH_MAXLEN - lens[s]);
            for (int k = 0; k < span; k++) lut[base + k] = (uint16_t)((s << 4) | lens[s]);
        }
        /* bit reader */
        uint32_t bitbuf = 0;
        int bitcount = 0, bits_used = 0, raw_used = 0;
        int start = i, p = i;
        uint32_t w0 = 0, w1 = 0;
        w0 = (p < in_len ? in[p] : 0) | ((p + 1 < in_len ? in[p + 1] : 0) << 8); p += 2;
        w1 = (p < in_len ? in[p] : 0) | ((p + 1 < in_len ? in[p + 1] : 0) << 8); p += 2;
        bitbuf = (w0 << 16) | w1;
        bitcount = 32;
        int block_end = o + XH_BLOCK;
        if (block_end > out_len) block_end = out_len;
        while (o < block_end) {
            uint16_t e = lut[(bitbuf >> 17) & 0x7FFF];
            if (e == 0xFFFF) return ERR_DATA;
            int sym = e >> 4, sl = e & 0xF;
            bitbuf <<= sl; bitcount -= sl; bits_used += sl;
            if (bitcount < 16) {
                uint32_t wnext = (uint32_t)((p < in_len ? in[p] : 0) | ((p + 1 < in_len ? in[p + 1] : 0) << 8));
                bitbuf |= wnext << (16 - bitcount);
                p += 2; bitcount += 16;
            }
            if (sym < 256) {
                if (disp) { disp[o] = 0; tokp[o] = o; }
                out[o++] = (uint8_t)sym;
                continue;
            }
            int m = sym - 256;
            int obc = m >> 4;
            uint32_t L = (uint32_t)(m & 0xF);
            uint32_t off = (1u << obc);
            if (obc) {
                off |= (bitbuf >> (32 - obc));
                bitbuf <<= obc; bitcount -= obc; bits_used += obc;
                if (bitcount < 16) {
                    uint32_t wnext = (uint32_t)((p < in_len ? in[p] : 0) | ((p + 1 < in_len ? in[p + 1] : 0) << 8));
                    bitbuf |= wnext << (16 - bitcount);
                    p += 2; bitcount += 16;
                }
            }
            if (L == 15) {
                if (p >= in_len) return ERR_DATA;
                uint32_t b = in[p++]; raw_used++;
                if (b == 255) {
                    uint32_t u16 = (uint32_t)((p < in_len ? in[p] : 0) | ((p + 1 < in_len ? in[p + 1] : 0) << 8));
                    p += 2; raw_used += 2;
                    if (u16 == 0) {
                        if (p + 4 > in_len) return ERR_DATA;
                        memcpy(&u16, in + p, 4); p += 4; raw_used += 4;
                    }
                    L = u16;
                } else {
                    L = b + 15;
                }
            }
            int len = (int)L + 3;
            if ((int)off > o || o + len > out_len) return ERR_DATA;
            int t0 = o;
            for (int k = 0; k < len; k++, o++) {
                if (disp) { disp[o] = (int32_t)off; tokp[o] = t0; }
                out[o] = out[o - (int)off];
            }
        }
        /* writer-layout span: 2*(2+f)+raw, f = max(0, ceil(bits/16)-1) */
        int flushes = bits_used > 16 ? (bits_used + 15) / 16 - 1 : 0;
        i = start + 2 * (2 + flushes) + raw_used;
    }
    return o;
}

int xh_decompress(const uint8_t *in, int in_len, uint8_t *out, int out_len) {
    return xh_decompress_impl(in, in_len, out, out_len, NULL, NULL);
}

int xh_decompress_dbg(const uint8_t *in, int in_len, uint8_t *out,
                      int out_len, int32_t *disp, int32_t *tokp) {
    return xh_decompress_impl(in, in_len, out, out_len, disp, tokp);
}

/* ============ Streaming (reference ms_deflate/ms_inflate parity) ======
 *
 * zlib-style incremental operation with the match window / writer state
 * carried across feeds (SURVEY.md §3.5; reference streaming recalled as
 * per-format state machines inside each codec TU).  Protocol per stream
 * object: feed() consumes input and advances the state machine;
 * avail() reports finalized output bytes; read() drains them;
 * finish() flushes.  All return >=0 or a negative MSCompStatus code.
 */

typedef struct { uint8_t *p; size_t len, cap; } gbuf;

static int gb_reserve(gbuf *g, size_t need) {
    if (g->cap >= need) return 0;
    size_t c = g->cap ? g->cap : 4096;
    while (c < need) c *= 2;
    uint8_t *np = (uint8_t *)realloc(g->p, c);
    if (!np) return ERR_DATA;
    g->p = np;
    g->cap = c;
    return 0;
}

static int gb_put(gbuf *g, const uint8_t *d, size_t n) {
    if (gb_reserve(g, g->len + n)) return ERR_DATA;
    if (n) memcpy(g->p + g->len, d, n);
    g->len += n;
    return 0;
}

/* ---------------- XH stream compressor ----------------
 * 64 KiB block granularity: each block's table+bitstream is self-
 * contained, so streamed bytes == one-shot xh_compress(concat) for ANY
 * feed slicing (block-local match window, same as the one-shot path).
 */

typedef struct {
    gbuf in, out;
    size_t out_read;
    long total_in;
    int finished;
} xh_sc;

void *xh_scomp_new(void) { return calloc(1, sizeof(xh_sc)); }

void xh_scomp_free(void *h) {
    xh_sc *s = (xh_sc *)h;
    if (!s) return;
    free(s->in.p);
    free(s->out.p);
    free(s);
}

static int xh_sc_block(xh_sc *s, const uint8_t *d, int n) {
    if (gb_reserve(&s->out, s->out.len + 264 + 2 * (size_t)XH_BLOCK + 16))
        return ERR_DATA;
    int c = xh_compress_block(d, n, s->out.p + s->out.len,
                              (int)(s->out.cap - s->out.len), 0, 0);
    if (c < 0) return c;
    s->out.len += (size_t)c;
    return 0;
}

int xh_scomp_feed(void *h, const uint8_t *d, int n) {
    xh_sc *s = (xh_sc *)h;
    if (!s || s->finished || n < 0) return ERR_DATA;
    s->total_in += n;
    if (gb_put(&s->in, d, (size_t)n)) return ERR_DATA;
    size_t off = 0;
    while (s->in.len - off >= XH_BLOCK) {
        int rc = xh_sc_block(s, s->in.p + off, XH_BLOCK);
        if (rc < 0) return rc;
        off += XH_BLOCK;
    }
    if (off) {
        memmove(s->in.p, s->in.p + off, s->in.len - off);
        s->in.len -= off;
    }
    return 0;
}

int xh_scomp_finish(void *h) {
    xh_sc *s = (xh_sc *)h;
    if (!s || s->finished) return ERR_DATA;
    s->finished = 1;
    if (s->in.len || s->total_in == 0) {
        /* final partial block; empty input = one empty block (same as
         * one-shot xh_compress on b"") */
        int rc = xh_sc_block(s, s->in.p, (int)s->in.len);
        if (rc < 0) return rc;
        s->in.len = 0;
    }
    return 0;
}

int xh_scomp_avail(void *h) {
    xh_sc *s = (xh_sc *)h;
    return s ? (int)(s->out.len - s->out_read) : ERR_DATA;
}

int xh_scomp_read(void *h, uint8_t *dst, int cap) {
    xh_sc *s = (xh_sc *)h;
    if (!s || cap < 0) return ERR_DATA;
    size_t n = s->out.len - s->out_read;
    if (n > (size_t)cap) n = (size_t)cap;
    if (n) memcpy(dst, s->out.p + s->out_read, n);
    s->out_read += n;
    if (s->out_read == s->out.len) s->out_read = s->out.len = 0;
    return (int)n;
}

/* ---------------- Xpress plain stream compressor ----------------
 * Window and writer state carried across feeds; output bytes equal the
 * one-shot xpress_compress(concat) for any slicing, except when a
 * single match would have to span more than XP_DEFER_CAP not-yet-fed
 * bytes (then it is emitted early; the stream stays spec-valid).  The
 * flag-word and shared-nibble backpatch slots hold back read()
 * visibility until they finalize (the format backpatches output).
 */

#define XP_DEFER_CAP (1 << 20)

typedef struct {
    gbuf in;      /* whole input accumulated; absolute positions */
    size_t pos;   /* parse cursor */
    size_t hfront; /* hash-insertion frontier (lazy, one-shot order) */
    int32_t head[XP_HASH_SIZE];
    int32_t *prev;
    size_t prev_cap;
    gbuf out;
    size_t out_read;
    uint32_t flags;
    int nflags;
    long flag_pos, nib_pos; /* absolute indices into out; -1 = closed */
    int finished;
} xp_sc;

void *xp_scomp_new(void) {
    xp_sc *s = (xp_sc *)calloc(1, sizeof(xp_sc));
    if (!s) return 0;
    memset(s->head, -1, sizeof(s->head));
    s->flag_pos = s->nib_pos = -1;
    return s;
}

void xp_scomp_free(void *h) {
    xp_sc *s = (xp_sc *)h;
    if (!s) return;
    free(s->in.p);
    free(s->out.p);
    free(s->prev);
    free(s);
}

static int xp_sc_byte(xp_sc *s, uint8_t b) {
    uint8_t v = b;
    return gb_put(&s->out, &v, 1);
}

static int xp_sc_flag(xp_sc *s, int bit) {
    if (s->flag_pos < 0) {
        s->flag_pos = (long)s->out.len;
        uint8_t z[4] = {0, 0, 0, 0};
        if (gb_put(&s->out, z, 4)) return ERR_DATA;
    }
    s->flags = (s->flags << 1) | (uint32_t)bit;
    if (++s->nflags == 32) {
        memcpy(s->out.p + s->flag_pos, &s->flags, 4);
        s->flags = 0;
        s->nflags = 0;
        s->flag_pos = -1;
    }
    return 0;
}

static void xp_sc_finish_flags(xp_sc *s) {
    if (s->flag_pos >= 0) {
        int rem = 32 - s->nflags;
        uint32_t f = (s->flags << rem) |
                     ((rem == 32) ? 0xFFFFFFFFu : ((1u << rem) - 1));
        memcpy(s->out.p + s->flag_pos, &f, 4);
        s->flag_pos = -1;
    }
}

static int xp_sc_parse(xp_sc *s, int final) {
    const uint8_t *in = s->in.p;
    size_t avail = s->in.len;
    if (avail > s->prev_cap) {
        size_t c = s->prev_cap ? s->prev_cap : (1 << 16);
        while (c < avail) c *= 2;
        int32_t *np = (int32_t *)realloc(s->prev, c * sizeof(int32_t));
        if (!np) return ERR_DATA;
        s->prev = np;
        s->prev_cap = c;
    }
    while (s->pos < avail) {
        size_t pos = s->pos;
        /* lazy hash insertion in one-shot order: every p < pos with
         * p + 3 <= avail */
        while (s->hfront < pos && s->hfront + 3 <= avail) {
            uint32_t hh = xp_hash3(in + s->hfront);
            s->prev[s->hfront] = s->head[hh];
            s->head[hh] = (int32_t)s->hfront;
            s->hfront++;
        }
        size_t lim = avail - pos;
        if (!final && lim < 3) break; /* a future feed may open a match */
        int best_len = 0, best_off = 0, hit_lim = 0;
        if (pos + 3 <= avail) {
            uint32_t h = xp_hash3(in + pos);
            int32_t cand = s->head[h];
            int depth = 0;
            while (cand >= 0 && pos - (size_t)cand <= XP_WINDOW &&
                   depth++ < XP_DEPTH) {
                size_t len = 0;
                while (len < lim && in[cand + len] == in[pos + len]) len++;
                if (len >= lim) hit_lim = 1;
                if ((int)len > best_len) {
                    best_len = (int)len;
                    best_off = (int)(pos - (size_t)cand);
                    if (len >= lim) break;
                }
                cand = s->prev[cand];
            }
        }
        if (!final && hit_lim && lim <= XP_DEFER_CAP)
            break; /* a longer match may complete with more input */
        if (best_len >= 3) {
            if (xp_sc_flag(s, 1)) return ERR_DATA;
            int L = best_len - 3;
            uint16_t tok =
                (uint16_t)(((best_off - 1) << 3) | (L < 7 ? L : 7));
            if (xp_sc_byte(s, (uint8_t)tok)) return ERR_DATA;
            if (xp_sc_byte(s, (uint8_t)(tok >> 8))) return ERR_DATA;
            if (L >= 7) {
                L -= 7;
                int nib = L < 15 ? L : 15;
                if (s->nib_pos < 0) {
                    s->nib_pos = (long)s->out.len;
                    if (xp_sc_byte(s, (uint8_t)nib)) return ERR_DATA;
                } else {
                    s->out.p[s->nib_pos] |= (uint8_t)(nib << 4);
                    s->nib_pos = -1;
                }
                if (L >= 15) {
                    L -= 15;
                    if (L < 255) {
                        if (xp_sc_byte(s, (uint8_t)L)) return ERR_DATA;
                    } else {
                        uint32_t full = (uint32_t)(best_len - 3);
                        if (xp_sc_byte(s, 255)) return ERR_DATA;
                        if (full < 0x10000 && full != 0) {
                            if (xp_sc_byte(s, (uint8_t)full)) return ERR_DATA;
                            if (xp_sc_byte(s, (uint8_t)(full >> 8)))
                                return ERR_DATA;
                        } else {
                            uint8_t z[2] = {0, 0};
                            if (gb_put(&s->out, z, 2)) return ERR_DATA;
                            if (gb_put(&s->out, (uint8_t *)&full, 4))
                                return ERR_DATA;
                        }
                    }
                }
            }
            s->pos = pos + (size_t)best_len;
        } else {
            if (xp_sc_flag(s, 0)) return ERR_DATA;
            if (xp_sc_byte(s, in[pos])) return ERR_DATA;
            s->pos = pos + 1;
        }
    }
    return 0;
}

/* Bound input memory at O(XP_WINDOW): once the parse cursor is far
 * enough along, drop input older than XP_WINDOW behind it and remap the
 * absolute hash-chain positions (older candidates are out of reach of
 * any future match anyway).  Amortized O(1)/byte. */
#define XP_REBASE_MIN (1 << 20)

static void xp_sc_rebase(xp_sc *s) {
    if (s->pos < XP_REBASE_MIN) return;
    size_t delta = s->pos - XP_WINDOW;
    size_t tail = s->in.len - delta;
    size_t pfx = (s->hfront > delta) ? s->hfront - delta : 0;
    memmove(s->in.p, s->in.p + delta, tail);
    for (size_t i = 0; i < pfx; i++) {
        int32_t p = s->prev[i + delta];
        s->prev[i] = (p >= (int32_t)delta) ? p - (int32_t)delta : -1;
    }
    for (int i = 0; i < XP_HASH_SIZE; i++)
        s->head[i] =
            (s->head[i] >= (int32_t)delta) ? s->head[i] - (int32_t)delta : -1;
    s->in.len = tail;
    s->pos -= delta;
    s->hfront = pfx;
}

int xp_scomp_feed(void *h, const uint8_t *d, int n) {
    xp_sc *s = (xp_sc *)h;
    if (!s || s->finished || n < 0) return ERR_DATA;
    if (gb_put(&s->in, d, (size_t)n)) return ERR_DATA;
    int rc = xp_sc_parse(s, 0);
    xp_sc_rebase(s);
    return rc;
}

int xp_scomp_finish(void *h) {
    xp_sc *s = (xp_sc *)h;
    if (!s || s->finished) return ERR_DATA;
    s->finished = 1;
    int rc = xp_sc_parse(s, 1);
    if (rc < 0) return rc;
    xp_sc_finish_flags(s);
    s->nib_pos = -1;
    return 0;
}

static size_t xp_sc_stable(xp_sc *s) {
    size_t w = s->out.len;
    if (s->flag_pos >= 0 && (size_t)s->flag_pos < w) w = (size_t)s->flag_pos;
    if (s->nib_pos >= 0 && (size_t)s->nib_pos < w) w = (size_t)s->nib_pos;
    return w;
}

int xp_scomp_avail(void *h) {
    xp_sc *s = (xp_sc *)h;
    return s ? (int)(xp_sc_stable(s) - s->out_read) : ERR_DATA;
}

int xp_scomp_read(void *h, uint8_t *dst, int cap) {
    xp_sc *s = (xp_sc *)h;
    if (!s || cap < 0) return ERR_DATA;
    size_t n = xp_sc_stable(s) - s->out_read;
    if (n > (size_t)cap) n = (size_t)cap;
    if (n) memcpy(dst, s->out.p + s->out_read, n);
    s->out_read += n;
    if (s->out_read == s->out.len && s->flag_pos < 0 && s->nib_pos < 0) {
        s->out_read = s->out.len = 0;
    } else if (s->out_read > 65536) {
        memmove(s->out.p, s->out.p + s->out_read, s->out.len - s->out_read);
        s->out.len -= s->out_read;
        if (s->flag_pos >= 0) s->flag_pos -= (long)s->out_read;
        if (s->nib_pos >= 0) s->nib_pos -= (long)s->out_read;
        s->out_read = 0;
    }
    return (int)n;
}

/* ---------------- Xpress plain stream decompressor ----------------
 * Arbitrary feed slicing; token-level resumable state machine with the
 * 8 KiB window carried in a history buffer. */

typedef struct {
    gbuf in;
    size_t ic; /* consumed cursor */
    uint32_t flags;
    int nflags;
    int nib; /* pending high-nibble value, -1 = none */
    gbuf hist;
    size_t emitted;
    long out_total, out_len;
    int finished;
} xp_sd;

void *xp_sdec_new(long out_len) {
    if (out_len < 0) return 0;
    xp_sd *s = (xp_sd *)calloc(1, sizeof(xp_sd));
    if (!s) return 0;
    s->nib = -1;
    s->out_len = out_len;
    return s;
}

void xp_sdec_free(void *h) {
    xp_sd *s = (xp_sd *)h;
    if (!s) return;
    free(s->in.p);
    free(s->hist.p);
    free(s);
}

static int xp_sd_run(xp_sd *s, int final) {
    const uint8_t *in = s->in.p;
    while (s->out_total < s->out_len) {
        size_t avail = s->in.len;
        /* worst-case token: 4 flag + 2 tok + 1 nib + 1 byte + 2 u16 +
         * 4 u32 = 14 bytes */
        if (!final && avail - s->ic < 14) return 0;
        size_t i = s->ic;
        uint32_t flags = s->flags;
        int nflags = s->nflags;
        int nib = s->nib;
        if (nflags == 0) {
            if (i + 4 > avail) return final ? ERR_DATA : 0;
            memcpy(&flags, in + i, 4);
            i += 4;
            nflags = 32;
        }
        int is_match = (flags >> 31) & 1;
        flags <<= 1;
        nflags--;
        if (!is_match) {
            if (i >= avail) return final ? ERR_DATA : 0;
            uint8_t b = in[i++];
            if (gb_put(&s->hist, &b, 1)) return ERR_DATA;
            s->out_total++;
        } else {
            if (i + 2 > avail) return final ? ERR_DATA : 0;
            uint16_t tok = (uint16_t)(in[i] | (in[i + 1] << 8));
            i += 2;
            int off = (tok >> 3) + 1;
            uint32_t L = tok & 7;
            if (L == 7) {
                if (nib < 0) {
                    if (i >= avail) return final ? ERR_DATA : 0;
                    nib = in[i] >> 4;
                    L = in[i] & 0xF;
                    i++;
                } else {
                    L = (uint32_t)nib;
                    nib = -1;
                }
                if (L == 15) {
                    if (i >= avail) return final ? ERR_DATA : 0;
                    L = in[i++];
                    if (L == 255) {
                        if (i + 2 > avail) return final ? ERR_DATA : 0;
                        L = (uint32_t)(in[i] | (in[i + 1] << 8));
                        i += 2;
                        if (L == 0) {
                            if (i + 4 > avail) return final ? ERR_DATA : 0;
                            memcpy(&L, in + i, 4);
                            i += 4;
                        }
                        if (L < 22) return ERR_DATA;
                        L -= 22;
                    }
                    L += 15;
                }
                L += 7;
            }
            long len = (long)L + 3;
            if ((long)off > (long)s->hist.len ||
                s->out_total + len > s->out_len)
                return ERR_DATA;
            if (gb_reserve(&s->hist, s->hist.len + (size_t)len))
                return ERR_DATA;
            uint8_t *hp = s->hist.p;
            size_t o = s->hist.len;
            for (long k = 0; k < len; k++, o++) hp[o] = hp[o - off];
            s->hist.len = o;
            s->out_total += len;
        }
        /* token fully consumed: commit state */
        s->ic = i;
        s->flags = flags;
        s->nflags = nflags;
        s->nib = nib;
    }
    return 0;
}

int xp_sdec_feed(void *h, const uint8_t *d, int n) {
    xp_sd *s = (xp_sd *)h;
    if (!s || n < 0) return ERR_DATA;
    if (gb_put(&s->in, d, (size_t)n)) return ERR_DATA;
    return xp_sd_run(s, 0);
}

int xp_sdec_finish(void *h) {
    xp_sd *s = (xp_sd *)h;
    if (!s || s->finished) return ERR_DATA;
    s->finished = 1;
    int rc = xp_sd_run(s, 1);
    if (rc < 0) return rc;
    return s->out_total == s->out_len ? 0 : ERR_DATA;
}

int xp_sdec_avail(void *h) {
    xp_sd *s = (xp_sd *)h;
    return s ? (int)(s->hist.len - s->emitted) : ERR_DATA;
}

int xp_sdec_read(void *h, uint8_t *dst, int cap) {
    xp_sd *s = (xp_sd *)h;
    if (!s || cap < 0) return ERR_DATA;
    size_t n = s->hist.len - s->emitted;
    if (n > (size_t)cap) n = (size_t)cap;
    if (n) memcpy(dst, s->hist.p + s->emitted, n);
    s->emitted += n;
    if (s->emitted == s->hist.len && s->hist.len > XP_WINDOW) {
        /* keep the 8 KiB window, drop older emitted history */
        memmove(s->hist.p, s->hist.p + s->hist.len - XP_WINDOW, XP_WINDOW);
        s->hist.len = s->emitted = XP_WINDOW;
    }
    return (int)n;
}

/* ---------------- XH stream decompressor ----------------
 * Arbitrary feed slicing; whole-block retry: a block is (re)attempted
 * from buffered input until its full compressed span is present, then
 * committed (blocks are <= 64 KiB output, so the retry cost is small).
 * The 64 KiB cross-block window ([MS-XCA] §2.1) is carried in the
 * history buffer. */

typedef struct {
    gbuf in;
    gbuf hist;
    size_t emitted;
    long out_total, out_len;
    int finished;
} xh_sd;

void *xh_sdec_new(long out_len) {
    if (out_len < 0) return 0;
    xh_sd *s = (xh_sd *)calloc(1, sizeof(xh_sd));
    if (!s) return 0;
    s->out_len = out_len;
    return s;
}

void xh_sdec_free(void *h) {
    xh_sd *s = (xh_sd *)h;
    if (!s) return;
    free(s->in.p);
    free(s->hist.p);
    free(s);
}

/* decode ONE block from in[0..avail); history = hist[0..h), output
 * appended at hist+h (caller reserved 64 KiB).  Returns consumed input
 * span (>0), ERR_AGAIN (need more input; only when !final) or
 * ERR_DATA.  *produced gets the block's output byte count. */
static int xh_sd_block(const uint8_t *in, long avail, int final,
                       uint8_t *hist, long h, long remaining,
                       long *produced) {
    if (avail < 256 + 4) return final ? ERR_DATA : ERR_AGAIN;
    uint16_t lut[1 << XH_MAXLEN];
    uint8_t lens[XH_SYMS];
    uint16_t codes[XH_SYMS];
    for (int k = 0; k < 256; k++) {
        lens[2 * k] = in[k] & 0xF;
        lens[2 * k + 1] = in[k] >> 4;
    }
    xh_canonical(lens, codes);
    memset(lut, 0xFF, sizeof(lut));
    for (int sx = 0; sx < XH_SYMS; sx++) {
        if (!lens[sx]) continue;
        int span = 1 << (XH_MAXLEN - lens[sx]);
        int base = codes[sx] << (XH_MAXLEN - lens[sx]);
        for (int k = 0; k < span; k++)
            lut[base + k] = (uint16_t)((sx << 4) | lens[sx]);
    }
    long p = 256;
    int bits_used = 0, raw_used = 0;
    uint32_t w0 = (uint32_t)((p < avail ? in[p] : 0) |
                             ((p + 1 < avail ? in[p + 1] : 0) << 8));
    p += 2;
    uint32_t w1 = (uint32_t)((p < avail ? in[p] : 0) |
                             ((p + 1 < avail ? in[p + 1] : 0) << 8));
    p += 2;
    uint32_t bitbuf = (w0 << 16) | w1;
    int bitcount = 32;
    long o = h;
    long block_end = h + XH_BLOCK;
    if (block_end > h + remaining) block_end = h + remaining;
    while (o < block_end) {
        uint16_t e = lut[(bitbuf >> 17) & 0x7FFF];
        if (e == 0xFFFF) return (final || p <= avail) ? ERR_DATA : ERR_AGAIN;
        int sym = e >> 4, sl = e & 0xF;
        bitbuf <<= sl;
        bitcount -= sl;
        bits_used += sl;
        if (bitcount < 16) {
            uint32_t wn = (uint32_t)((p < avail ? in[p] : 0) |
                                     ((p + 1 < avail ? in[p + 1] : 0) << 8));
            bitbuf |= wn << (16 - bitcount);
            p += 2;
            bitcount += 16;
        }
        if (sym < 256) {
            hist[o++] = (uint8_t)sym;
            continue;
        }
        int m = sym - 256;
        int obc = m >> 4;
        uint32_t L = (uint32_t)(m & 0xF);
        uint32_t off = (1u << obc);
        if (obc) {
            off |= (bitbuf >> (32 - obc));
            bitbuf <<= obc;
            bitcount -= obc;
            bits_used += obc;
            if (bitcount < 16) {
                uint32_t wn = (uint32_t)(
                    (p < avail ? in[p] : 0) |
                    ((p + 1 < avail ? in[p + 1] : 0) << 8));
                bitbuf |= wn << (16 - bitcount);
                p += 2;
                bitcount += 16;
            }
        }
        if (L == 15) {
            if (p >= avail) return final ? ERR_DATA : ERR_AGAIN;
            uint32_t b = in[p++];
            raw_used++;
            if (b == 255) {
                if (p + 2 > avail && !final) return ERR_AGAIN;
                uint32_t u16 = (uint32_t)((p < avail ? in[p] : 0) |
                                          ((p + 1 < avail ? in[p + 1] : 0)
                                           << 8));
                p += 2;
                raw_used += 2;
                if (u16 == 0) {
                    if (p + 4 > avail) return final ? ERR_DATA : ERR_AGAIN;
                    memcpy(&u16, in + p, 4);
                    p += 4;
                    raw_used += 4;
                }
                L = u16;
            } else {
                L = b + 15;
            }
        }
        long len = (long)L + 3;
        if ((long)off > o || o + len > h + remaining)
            return (final || p <= avail) ? ERR_DATA : ERR_AGAIN;
        for (long k = 0; k < len; k++, o++) hist[o] = hist[o - (long)off];
    }
    int flushes = bits_used > 16 ? (bits_used + 15) / 16 - 1 : 0;
    long span = 256 + 2 * (2 + flushes) + raw_used;
    /* the refill pipeline reads up to 4 bytes past the true span */
    if (!final && span + 4 > avail) return ERR_AGAIN;
    if (span > avail) return final ? ERR_DATA : ERR_AGAIN;
    *produced = o - h;
    return (int)span;
}

int xh_sdec_feed(void *h, const uint8_t *d, int n) {
    xh_sd *s = (xh_sd *)h;
    if (!s || n < 0) return ERR_DATA;
    if (gb_put(&s->in, d, (size_t)n)) return ERR_DATA;
    while (s->out_total < s->out_len) {
        if (gb_reserve(&s->hist, s->hist.len + XH_BLOCK)) return ERR_DATA;
        long produced = 0;
        int span = xh_sd_block(s->in.p, (long)s->in.len, 0, s->hist.p,
                               (long)s->hist.len,
                               s->out_len - s->out_total, &produced);
        if (span == ERR_AGAIN) return 0;
        if (span < 0) return span;
        s->hist.len += (size_t)produced;
        s->out_total += produced;
        memmove(s->in.p, s->in.p + span, s->in.len - (size_t)span);
        s->in.len -= (size_t)span;
    }
    return 0;
}

int xh_sdec_finish(void *h) {
    xh_sd *s = (xh_sd *)h;
    if (!s || s->finished) return ERR_DATA;
    s->finished = 1;
    while (s->out_total < s->out_len) {
        if (gb_reserve(&s->hist, s->hist.len + XH_BLOCK)) return ERR_DATA;
        long produced = 0;
        int span = xh_sd_block(s->in.p, (long)s->in.len, 1, s->hist.p,
                               (long)s->hist.len,
                               s->out_len - s->out_total, &produced);
        if (span < 0) return span;
        s->hist.len += (size_t)produced;
        s->out_total += produced;
        if ((size_t)span > s->in.len) span = (int)s->in.len;
        memmove(s->in.p, s->in.p + span, s->in.len - (size_t)span);
        s->in.len -= (size_t)span;
    }
    return 0;
}

int xh_sdec_avail(void *h) {
    xh_sd *s = (xh_sd *)h;
    return s ? (int)(s->hist.len - s->emitted) : ERR_DATA;
}

int xh_sdec_read(void *h, uint8_t *dst, int cap) {
    xh_sd *s = (xh_sd *)h;
    if (!s || cap < 0) return ERR_DATA;
    size_t n = s->hist.len - s->emitted;
    if (n > (size_t)cap) n = (size_t)cap;
    if (n) memcpy(dst, s->hist.p + s->emitted, n);
    s->emitted += n;
    if (s->emitted == s->hist.len && s->hist.len > (size_t)XH_BLOCK) {
        /* keep the 64 KiB cross-block window */
        memmove(s->hist.p, s->hist.p + s->hist.len - XH_BLOCK, XH_BLOCK);
        s->hist.len = s->emitted = XH_BLOCK;
    }
    return (int)n;
}
