// Plain Xpress decode parse: the 14-state byte machine, one thread per
// unit row.
//
// Replaces: tpucomp/kernels/xp_pallas.py parse_records (_build_kernel),
// which runs the same machine with one TPU vector lane per unit and packs
// each record into one plane ((val << 16) | pos) + 1 for the lanes.  Here
// byte step s that completes a token writes rec_pos[n, s] = its output
// position and rec_val[n, s] = the literal byte or COPY_BIT | offset;
// empty slots hold SENT and 0 (the packing is a TPU layout and buys
// nothing here).  p_final is the final output position; err flags a
// match before the start or past out_len and an escape length below 22.
//
// Every int32 value of tpucomp's machine wraps mod 2^32 (XLA's rule), so
// the state is uint32_t and each comparison casts to int32_t as tpucomp
// compares: a u32 escape length >= 2^31 - 3 wraps the match length
// negative, and the position moves backwards with err clear, as there.
//
// What bounds it on the card: the machine is sequential within a unit,
// one dependent step per payload byte, so it is latency-bound and the
// longest row sets its time; with a few hundred 64 KiB units there are a
// few hundred threads.  The design spreads them thin (32 threads a block,
// so every SM gets work), keeps a step's state in registers, and writes
// each row's record slots once (strided across the warp; L2 merges them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MIN_MATCH = 3;
constexpr int32_t SENT = 1 << 28;
constexpr uint32_t COPY_BIT = 1u << 20;
constexpr int THREADS = 32;

enum Mode {
  M_F0 = 0, M_F1 = 1, M_F2 = 2, M_F3 = 3, M_TOK = 4, M_HI = 5, M_NIB = 6,
  M_ESC = 7, M_U16_0 = 8, M_U16_1 = 9, M_U32_0 = 10, M_U32_1 = 11,
  M_U32_2 = 12, M_U32_3 = 13
};

__global__ void __launch_bounds__(THREADS)
xp_parse_kernel(const uint8_t* __restrict__ payload,
                const int32_t* __restrict__ plen,
                const int32_t* __restrict__ out_len,
                int32_t* __restrict__ rec_pos, int32_t* __restrict__ rec_val,
                int32_t* __restrict__ p_final, int32_t* __restrict__ err,
                int n, int P, int U) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint8_t* body = payload + (size_t)i * P;
  int32_t* rp = rec_pos + (size_t)i * P;
  int32_t* rv = rec_val + (size_t)i * P;
  const int len = min(plen[i], P);
  const int32_t olen = out_len[i];

  int32_t p = 0;
  int mode = M_F0, nflags = 0, nib_have = 0;
  uint32_t flags = 0, pend_lo = 0, pend_len = 0, nib_val = 0, e = 0;
  int s = 0;
  for (; s < len && p < olen; ++s) {
    const uint32_t b = body[s];
    bool lit = false, done = false;
    uint32_t m_len = 0;  // wraps as tpucomp's int32 does
    int next = mode;
    switch (mode) {
      case M_F0:
      case M_F1:
      case M_F2:
      case M_F3:
        flags |= b << (8 * mode);
        if (mode == M_F3) {
          nflags = 32;
          next = M_TOK;
        } else {
          next = mode + 1;
        }
        break;
      case M_TOK:
        if ((flags >> 31) == 0) {
          lit = true;
        } else {
          pend_lo = b;
          next = M_HI;
        }
        break;
      case M_HI: {
        pend_lo |= b << 8;  // the whole token: its offset outlives escapes
        const uint32_t L0 = pend_lo & 7;
        if (L0 < 7) {
          done = true;
          m_len = L0 + MIN_MATCH;
        } else if (nib_have) {  // the high half of an earlier nibble byte
          nib_have = 0;
          if (nib_val < 15) {
            done = true;
            m_len = nib_val + 7 + MIN_MATCH;
          } else {
            next = M_ESC;
          }
        } else {
          next = M_NIB;
        }
        break;
      }
      case M_NIB:
        nib_have = 1;
        nib_val = b >> 4;
        if ((b & 0xF) < 15) {
          done = true;
          m_len = (b & 0xF) + 7 + MIN_MATCH;
        } else {
          next = M_ESC;
        }
        break;
      case M_ESC:
        if (b < 255) {
          done = true;
          m_len = b + 22 + MIN_MATCH;
        } else {
          next = M_U16_0;
        }
        break;
      case M_U16_0:
      case M_U32_0:
        pend_len = b;
        next = mode + 1;
        break;
      case M_U16_1: {
        const uint32_t u16v = pend_len | (b << 8);
        if (u16v == 0) {
          next = M_U32_0;
        } else {
          done = true;
          m_len = u16v + MIN_MATCH;
          if (u16v < 22) e = 1;
        }
        break;
      }
      case M_U32_1:
        pend_len |= b << 8;
        next = M_U32_2;
        break;
      case M_U32_2:
        pend_len |= b << 16;
        next = M_U32_3;
        break;
      default: {  // M_U32_3
        const uint32_t u32v = pend_len | (b << 24);
        done = true;
        m_len = u32v + MIN_MATCH;
        if ((int32_t)u32v < 22) e = 1;
        break;
      }
    }
    int32_t pos = SENT, val = 0;
    if (lit) {
      pos = p;
      val = (int32_t)b;
      p = min(p + 1, U);
    } else if (done) {
      const int32_t off = (int32_t)(pend_lo >> 3) + 1;
      const int32_t end = (int32_t)((uint32_t)p + m_len);
      if (off > p || end > olen) e = 1;
      pos = p;
      val = (int32_t)(COPY_BIT | (uint32_t)off);
      p = min(end, U);
    }
    if (lit || done) {
      flags <<= 1;
      nflags -= 1;
      next = nflags == 0 ? M_F0 : M_TOK;  // a fresh flag word per 32 tokens
      if (next == M_F0) flags = 0;
    }
    mode = next;
    rp[s] = pos;
    rv[s] = val;
  }
  for (; s < P; ++s) {
    rp[s] = SENT;
    rv[s] = 0;
  }
  p_final[i] = p;
  err[i] = (int32_t)e;
}

}  // namespace

extern "C" int xp_parse(const void* payload, const void* plen,
                        const void* out_len, void* rec_pos, void* rec_val,
                        void* p_final, void* err, int n, int P, int U,
                        void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  xp_parse_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)payload, (const int32_t*)plen, (const int32_t*)out_len,
      (int32_t*)rec_pos, (int32_t*)rec_val, (int32_t*)p_final, (int32_t*)err,
      n, P, U);
  return (int)cudaGetLastError();
}
