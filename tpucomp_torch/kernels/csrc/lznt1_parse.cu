// LZNT1 decode parse: the flag/token byte machine, one thread per chunk.
//
// Replaces: tpucomp/kernels/lznt1_pallas.py parse_records (_build_kernel),
// which runs the same machine with one TPU vector lane per chunk.  The
// record contract is the same for the first P columns: byte step s that
// completes a token writes rec_pos[n, s] = its output position and
// rec_val[n, s] = the literal byte or COPY_BIT | disp; empty slots hold
// SENT and EMPTY_VAL.  p_final is the decoded length; err flags
// disp > position, a copy past the chunk end, or a stream that ends
// after a copy token's lo byte.  Bytes after the output reaches 4096
// are ignored, and that is not an error.
//
// What bounds it on the card: the parse is sequential within a chunk,
// one dependent step per payload byte, so it is latency-bound; at
// N = 8192 chunks there are only 8192 threads, a few warps per SM.  The
// design spreads them thin (32 threads a block, so every SM gets blocks)
// and keeps a step's state in registers; the per-thread row reads and
// slot writes are strided across the warp and rely on L1/L2 to merge.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int U = 4096;
constexpr int MIN_MATCH = 3;
constexpr int SENT = 1 << 28;
constexpr int COPY_BIT = 1 << 20;
constexpr int EMPTY_VAL = COPY_BIT | 0x3FFF;
constexpr int THREADS = 32;

enum Mode { M_FLAG = 0, M_TOK = 1, M_HI = 2 };

__global__ void __launch_bounds__(THREADS)
lznt1_parse_kernel(const uint8_t* __restrict__ payload,
                   const int32_t* __restrict__ plen,
                   const bool* __restrict__ is_comp,
                   int32_t* __restrict__ rec_pos,
                   int32_t* __restrict__ rec_val,
                   int32_t* __restrict__ p_final,
                   int32_t* __restrict__ err, int n, int P) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint8_t* body = payload + (size_t)i * P;
  int32_t* rp = rec_pos + (size_t)i * P;
  int32_t* rv = rec_val + (size_t)i * P;
  const bool comp = is_comp[i];
  const int len = comp ? min(plen[i], P) : 0;

  int p = 0, mode = M_FLAG, nflags = 0, e = 0;
  unsigned flags = 0, pend_lo = 0;
  int s = 0;
  for (; s < len && p < U; ++s) {
    const unsigned b = body[s];
    int pos = SENT, val = EMPTY_VAL;
    if (mode == M_FLAG) {
      flags = b;
      nflags = 8;
      mode = M_TOK;
    } else if (mode == M_TOK) {
      // the flag bit is consumed when the token starts
      const bool literal = (flags & 1u) == 0;
      flags >>= 1;
      nflags -= 1;
      if (literal) {
        pos = p;
        val = (int)b;
        p += 1;
        mode = nflags == 0 ? M_FLAG : M_TOK;
      } else {
        pend_lo = b;
        mode = M_HI;
      }
    } else {
      // copy token: the length/displacement split depends on p
      const unsigned tok = pend_lo | (b << 8);
      const int q = max(p - 1, 0);
      const int d_shift = 12 - max(32 - __clz(q) - 4, 0);
      const int length = (int)(tok & ((1u << d_shift) - 1u)) + MIN_MATCH;
      const int disp = (int)(tok >> d_shift) + 1;
      if (disp > p || p + length > U) e = 1;
      pos = p;
      val = COPY_BIT | disp;
      p = min(p + length, U);
      mode = nflags == 0 ? M_FLAG : M_TOK;
    }
    rp[s] = pos;
    rv[s] = val;
  }
  for (; s < P; ++s) {
    rp[s] = SENT;
    rv[s] = EMPTY_VAL;
  }
  p_final[i] = p;
  err[i] = e | (comp && mode == M_HI ? 1 : 0);
}

}  // namespace

extern "C" int lznt1_parse(const void* payload, const void* plen,
                           const void* is_comp, void* rec_pos, void* rec_val,
                           void* p_final, void* err, int n, int P,
                           void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  lznt1_parse_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)payload, (const int32_t*)plen, (const bool*)is_comp,
      (int32_t*)rec_pos, (int32_t*)rec_val, (int32_t*)p_final,
      (int32_t*)err, n, P);
  return (int)cudaGetLastError();
}
