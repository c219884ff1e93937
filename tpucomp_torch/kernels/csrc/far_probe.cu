// Value-chase probe rounds of copy resolution, the archive fast path, one
// block per row.
//
// Replaces: tpucomp/kernels/gather_pallas.py probe_gather_pairs
// (_probe_kernel, the pair-packed one-hot MXU gather of a single bf16
// plane) together with the round loop that common._far_rounds(fast=True)
// runs (common.py:1401-1433, 1518-1529).  A round reads the probe of
// every tag's source -- 256 while the source is still tagged, else its
// byte (out & 0xFF); a source outside the row reads 0, as the Pallas
// gather does -- and sets the tag to that byte when it is below 256.
// Values are in the near walk's encoding: bytes, or FAR_TAG | src.
//
// tpucomp runs at most ARCHIVE_PROBE_BUDGET rounds while some row of the
// batch has a tag and the last round changed the batch.  A round is a
// function of its row alone, so a row that one round left unchanged would
// never change again; each row here stops on its own, with the same
// result.  The rounds are synchronous: every read of a round sees the
// previous round's state.
//
// What bounds it on the card: device memory.  A row's state is 25-bit
// words (256 KiB at U = 65536, past a block's shared memory), so each
// round reads it and writes the next state to the other buffer (the
// output, then a scratch tensor of the wrapper's); the probe is computed
// from the source's word as it is fetched, so no probe plane is built.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FAR_TAG = 1 << 24;
constexpr int THREADS = 1024;

// out and scratch are read and written by other threads of the block
// between barriers: plain pointers, so the loads stay coherent
__global__ void __launch_bounds__(THREADS)
far_probe_kernel(const int32_t* in, int32_t* out, int32_t* scratch, int U,
                 int rounds) {
  const int32_t* cur = in + (size_t)blockIdx.x * U;
  int32_t* const res = out + (size_t)blockIdx.x * U;
  int32_t* const spare = scratch + (size_t)blockIdx.x * U;
  int32_t* nxt = res;
  for (int r = 0; r < rounds; ++r) {
    int changed = 0;
    for (int j = threadIdx.x; j < U; j += THREADS) {
      int v = cur[j];
      if (v & FAR_TAG) {
        const int src = v & (FAR_TAG - 1);
        int probe = 0;
        if (src < U) {
          const int t = cur[src];
          probe = (t & FAR_TAG) ? 256 : (t & 0xFF);
        }
        if (probe < 256) {
          v = probe;
          changed = 1;
        }
      }
      nxt[j] = v;
    }
    // orders this round's writes before the next round's reads
    if (!__syncthreads_or(changed)) {
      cur = nxt;
      break;
    }
    cur = nxt;
    nxt = nxt == res ? spare : res;
  }
  if (cur != res) {
    // the last round wrote the scratch (or no round ran); each thread
    // copies positions it wrote itself, after the round's barrier
    for (int j = threadIdx.x; j < U; j += THREADS) res[j] = cur[j];
  }
}

}  // namespace

extern "C" int far_probe(const void* in, void* out, void* scratch, int n,
                         int U, int rounds, void* stream) {
  far_probe_kernel<<<n, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, (int32_t*)scratch, U, rounds);
  return (int)cudaGetLastError();
}
