// Value-chase probe rounds of copy resolution, the archive fast path, in
// one pass: each position written once.
//
// Replaces: tpucomp/kernels/gather_pallas.py probe_gather_pairs
// (_probe_kernel, the pair-packed one-hot MXU gather of a single bf16
// plane) together with the round loop that common._far_rounds(fast=True)
// runs (common.py:1401-1433, 1511-1529).  A round reads the probe of
// every tag's source -- 256 while the source is still tagged, else its
// byte (out & 0xFF); a source outside the row reads 0, as the Pallas
// gather does -- and sets the tag to that byte when it is below 256.
// Values are in the near walk's encoding: bytes, or FAR_TAG | src.
//
// Why one pass equals the rounds: a tag's source never changes, and a
// round either turns a tag into a byte or leaves it exactly as it was.
// So by induction on r, after r synchronous rounds a tag at j is a byte
// exactly when its chain through the INPUT plane, j -> s1 -> s2 -> ...,
// reaches a byte, or a source at or past U, within r hops: hop 1 reads
// in[s1], and s1 is a byte after r - 1 rounds exactly when its own chain
// ends within r - 1 hops.  Its value is then that byte (& 0xFF), or 0 for
// a source past the row; otherwise it keeps its input value.  A thread
// therefore follows each tag at most `rounds` dependent loads through the
// input and writes the position once.  tpucomp stops early when a round
// changed nothing or no tag is left; either means every later round is
// the identity, so the result is the same for any `rounds`.
//
// What bounds it on the card: device memory.  The plane is read once and
// written once (16-byte loads and stores, 4 positions a thread); the
// chase loads hit L2, since a row's tiles run in adjacent blocks (row
// major) and every source lies in the same row's 256 KiB.  No scratch
// plane, no round barrier, no copy back.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FAR_TAG = 1 << 24;
constexpr int THREADS = 256;
constexpr int PER = 4;  // positions a thread: one 16-byte load and store
constexpr int TILE = THREADS * PER;

__device__ __forceinline__ void chase(const int32_t* __restrict__ row, int U,
                                      int rounds, int (&v)[PER]) {
  int cur[PER];
  bool live[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    cur[k] = v[k];
    live[k] = (v[k] & FAR_TAG) != 0;
  }
  for (int h = 0; h < rounds; ++h) {
    bool any = false;
    int t[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {  // the loads of one hop, all in flight
      t[k] = 0;
      if (live[k]) {
        const int src = cur[k] & (FAR_TAG - 1);
        if (src < U) t[k] = __ldg(row + src);
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (!live[k]) continue;
      if (t[k] & FAR_TAG) {  // the source is still a tag: one hop on
        cur[k] = t[k];
        any = true;
      } else {  // a byte (0 for a source past the row)
        v[k] = t[k] & 0xFF;
        live[k] = false;
      }
    }
    if (!any) break;
  }
}

__global__ void __launch_bounds__(THREADS)
far_probe_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                 int U, int tiles, int rounds, int vec) {
  const int row = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int32_t* src = in + (size_t)row * U;
  int32_t* dst = out + (size_t)row * U;
  const int p0 = tile * TILE + threadIdx.x * PER;
  if (p0 >= U) return;
  int v[PER];
  if (vec) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(src + p0));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < PER; ++k) v[k] = p0 + k < U ? src[p0 + k] : 0;
  }
  chase(src, U, rounds, v);
  if (vec) {
    reinterpret_cast<int4*>(dst + p0)[0] = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (p0 + k < U) dst[p0 + k] = v[k];
  }
}

}  // namespace

extern "C" int far_probe(const void* in, void* out, int n, int U, int rounds,
                         void* stream) {
  const int tiles = (U + TILE - 1) / TILE;
  const int vec = U % PER == 0 && (uintptr_t)in % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  far_probe_kernel<<<n * tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, U, tiles, rounds, vec);
  return (int)cudaGetLastError();
}
