// Xpress Huffman decode parse: the canonical-Huffman byte machine, one
// row per block of one warp.
//
// Replaces: tpucomp/kernels/xh_pallas.py parse_records (_build_kernel),
// which runs the same machine with one TPU vector lane per block.  Each
// body byte is one step (refill-word byte or length-escape byte); after a
// refill past the 32-bit prime, or after an escape completes a match, up
// to ss[n] substeps each finish a pending offset, then decode one symbol.
// The order inside a step is tpucomp's exactly (xh_pallas.py:124-251).
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
// What bounds it on the card: the machine is sequential within a row,
// one dependent step per body byte (up to ~66 K steps with up to 17
// substeps), so the kernel is latency-bound and its time is that of the
// longest row.  With about 514 rows, 32-thread blocks of one row each put
// about four warps on each of the 132 SMs (one per warp scheduler),
// where 32 rows a block would fill 17 SMs and leave 115 idle.  The warp
// loads the row's 512-entry rank->symbol table into shared memory and
// fills the empty record slots; lane 0 runs the machine with its state
// and the 15 scaled limits in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MIN_MATCH = 3;
constexpr int COPY_BIT = 1 << 20;
constexpr int SENT = 1 << 28;
constexpr int THREADS = 32;

enum Mode { M_W0 = 0, M_W1, M_EB, M_E16A, M_E16B, M_E32A, M_E32B, M_E32C,
            M_E32D };
enum Pend { P_NONE = 0, P_OFFSET = 1, P_ESC = 2 };

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__global__ void __launch_bounds__(THREADS)
xh_parse_kernel(const uint8_t* __restrict__ body,
                const int32_t* __restrict__ blen_in,
                const int32_t* __restrict__ out_len,
                const int32_t* __restrict__ ss_in,
                const int32_t* __restrict__ lim15_in,
                const int32_t* __restrict__ rbf_in,
                const int32_t* __restrict__ sym_by_rank,
                int32_t* __restrict__ rec_pos, int32_t* __restrict__ rec_val,
                int32_t* __restrict__ p_final, int32_t* __restrict__ err_out,
                int Pb, int U) {
  __shared__ uint16_t sym[512];
  __shared__ int32_t rbf[16];
  __shared__ int n_rec;
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  for (int r = lane; r < 512; r += THREADS)
    sym[r] = (uint16_t)sym_by_rank[(size_t)row * 512 + r];
  if (lane < 16) rbf[lane] = rbf_in[row * 16 + lane];
  __syncwarp();
  int32_t* rp = rec_pos + (size_t)row * U;
  int32_t* rv = rec_val + (size_t)row * U;

  if (lane == 0) {
    const uint8_t* bytes = body + (size_t)row * Pb;
    const int blen = min(blen_in[row], Pb);
    const int olen = out_len[row];
    const int ss = ss_in[row];
    int lim15[16];
#pragma unroll
    for (int l = 1; l < 16; ++l) lim15[l] = lim15_in[row * 16 + l];

    int p = 0, mode = M_W0, pend = P_NONE, bitcount = 0, obc = 0, lh = 0;
    int off = 0, err = 0, k = 0;
    uint32_t bitbuf = 0, lowbyte = 0, len_acc = 0;
    auto record = [&](int pos, int val) {
      if (k < U) {
        rp[k] = pos;
        rv[k] = val;
      }
      ++k;
    };

    // a row whose position reached out_len is inactive for good
    for (int s = 0; s < blen && p < olen; ++s) {
      const uint32_t b = __ldg(bytes + s);
      bool esc_match = false, w1 = false;
      int esc_len = 0;
      switch (mode) {
        case M_W0:
          lowbyte = b;
          mode = M_W1;
          break;
        case M_W1: {
          const int sh = 16 - bitcount;  // XLA: a negative shift gives 0
          if (sh >= 0) bitbuf |= (lowbyte | (b << 8)) << sh;
          bitcount += 16;
          w1 = true;
          mode = M_W0;
          break;
        }
        case M_EB:
          if (b < 255) {
            esc_match = true;
            esc_len = (int)b + 15 + MIN_MATCH;
            mode = M_W0;
          } else {
            mode = M_E16A;
          }
          break;
        case M_E16A:
          len_acc = b;
          mode = M_E16B;
          break;
        case M_E16B: {
          const uint32_t u16v = len_acc | (b << 8);
          if (u16v == 0) {
            mode = M_E32A;
          } else {
            esc_match = true;
            esc_len = (int)u16v + MIN_MATCH;
            mode = M_W0;
          }
          break;
        }
        case M_E32A:
          len_acc = b;
          mode = M_E32B;
          break;
        case M_E32B:
          len_acc |= b << 8;
          mode = M_E32C;
          break;
        case M_E32C:
          len_acc |= b << 16;
          mode = M_E32D;
          break;
        default: {  // M_E32D: a u32 length, int32 in tpucomp
          esc_match = true;
          esc_len = wadd((int)(len_acc | (b << 24)), MIN_MATCH);
          mode = M_W0;
          break;
        }
      }
      if (esc_match) {
        const int end = wadd(p, esc_len);
        if (off > p || end > olen) err = 1;
        record(p, COPY_BIT | off);
        p = min(end, U);
        pend = P_NONE;
      }
      // the 32-bit prime: no symbol before the second word (s >= 3)
      if (!(esc_match || (w1 && s >= 3))) continue;

      bool work = true;
      for (int j = 0; j < ss && work; ++j) {
        // 1) the pending match's offset bits
        if (pend == P_OFFSET && bitcount >= obc) {
          const int obc_c = max(obc, 1);
          const uint32_t raw =
              obc > 0 ? (bitbuf >> (32 - obc_c)) & ((1u << obc_c) - 1u) : 0u;
          const int offv = (int)((1u << obc) | raw);
          bitbuf <<= obc;
          bitcount -= obc;
          if (lh < 15) {
            const int mlen = lh + MIN_MATCH;
            if (offv > p || p + mlen > olen) err = 1;
            record(p, COPY_BIT | offv);
            p = min(p + mlen, U);
            pend = P_NONE;
          } else {
            pend = P_ESC;
          }
          off = offv;
        }
        // 2) a fresh symbol: level = 1 + #{l < 15 : peek15 >= LIM15[l]}
        if (pend == P_NONE && bitcount >= 16 && p < olen) {
          const int peek15 = (int)((bitbuf >> 17) & 0x7FFF);
          int level = 1;
#pragma unroll
          for (int l = 1; l < 15; ++l) level += peek15 >= lim15[l];
          if (peek15 < lim15[15]) {
            const int rank = wadd(rbf[level], peek15 >> (15 - level));
            const int sy = (rank >= 0 && rank < 512) ? sym[rank] : 0;
            bitbuf <<= level;
            bitcount -= level;
            if (sy < 256) {
              record(p, sy);
              p += 1;
            } else {
              obc = (sy - 256) >> 4;
              lh = (sy - 256) & 0xF;
              pend = P_OFFSET;
            }
          }
        }
        work = p < olen;
      }
      // a refill that leaves decodable bits behind would desync the next
      // byte: flag it (ss[n] covers every valid row)
      if (p < olen && ((pend == P_NONE && bitcount >= 16) ||
                       (pend == P_OFFSET && bitcount >= obc)))
        err = 1;
      mode = (pend == P_ESC && bitcount >= 16) ? M_EB : M_W0;
    }
    p_final[row] = p;
    err_out[row] = err | (k > U ? 1 : 0);
    n_rec = min(k, U);
  }
  __syncwarp();
  for (int s = n_rec + lane; s < U; s += THREADS) {
    rp[s] = SENT;
    rv[s] = 0;
  }
}

}  // namespace

extern "C" int xh_parse(const void* body, const void* blen,
                        const void* out_len, const void* ss,
                        const void* lim15, const void* rbf,
                        const void* sym_by_rank, void* rec_pos, void* rec_val,
                        void* p_final, void* err, int n, int Pb, int U,
                        void* stream) {
  xh_parse_kernel<<<n, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)body, (const int32_t*)blen, (const int32_t*)out_len,
      (const int32_t*)ss, (const int32_t*)lim15, (const int32_t*)rbf,
      (const int32_t*)sym_by_rank, (int32_t*)rec_pos, (int32_t*)rec_val,
      (int32_t*)p_final, (int32_t*)err, Pb, U);
  return (int)cudaGetLastError();
}
