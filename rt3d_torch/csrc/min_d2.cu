// Per-query squared distance to the nearest valid reference point (kernel K4).
//
// Replaces `_min_d2_kernel` as launched by `min_sqdist_pallas`
// (rt3d/geometry/pallas_ops.py). Distances come from coordinate differences,
//     d2 = (dx dx + dy dy) + dz dz,  d = q - r,
// in round-to-nearest intrinsics (no fused multiply-add), the same bits as
// the plain PyTorch version in rt3d_torch/geometry/subtract.py. The result is
// exact for every query (no pruning), which keeps the Pallas contract (exact
// wherever d2 <= threshold^2); a query with no valid reference gets 3.4e38.
//
// Bound on the H100: operations. Every query meets every valid reference
// (about 9 flops each) against 16 bytes a query and 13 bytes a reference.
// Design: one thread per query, 256 queries per block; references are staged
// in chunks of 1024 (12 KB of shared memory), invalid ones at +inf so they
// never lower the minimum. A chunk with no valid reference is skipped after
// staging: the fused-object buffer is compacted, so its valid rows sit at the
// front and the padding chunks cost one pass over their valid flags.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;
constexpr float kBig = 3.4e38f;

__global__ void min_d2_kernel(const float* __restrict__ q,
                              const float* __restrict__ r,
                              const uint8_t* __restrict__ rvalid,
                              float* __restrict__ out, int n, int m) {
  __shared__ float sx[kChunk];
  __shared__ float sy[kChunk];
  __shared__ float sz[kChunk];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (i < n) {
    qx = q[3 * static_cast<size_t>(i)];
    qy = q[3 * static_cast<size_t>(i) + 1];
    qz = q[3 * static_cast<size_t>(i) + 2];
  }
  float acc = kBig;
  for (int c0 = 0; c0 < m; c0 += kChunk) {
    const int cnt = min(kChunk, m - c0);
    bool any = false;
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const size_t g = static_cast<size_t>(c0) + j;
      const bool ok = rvalid[g] != 0;
      any |= ok;
      sx[j] = ok ? r[3 * g] : INFINITY;
      sy[j] = ok ? r[3 * g + 1] : INFINITY;
      sz[j] = ok ? r[3 * g + 2] : INFINITY;
    }
    if (__syncthreads_or(any)) {
      for (int j = 0; j < cnt; ++j) {
        const float dx = __fsub_rn(qx, sx[j]);
        const float dy = __fsub_rn(qy, sy[j]);
        const float dz = __fsub_rn(qz, sz[j]);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        acc = fminf(acc, d2);
      }
    }
    __syncthreads();
  }
  if (i < n) out[i] = acc;
}

}  // namespace

extern "C" int rt3d_min_sqdist(const float* queries, const float* refs,
                               const uint8_t* ref_valid, float* out, int n,
                               int m, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kThreads - 1) / kThreads);
  min_d2_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      queries, refs, ref_valid, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
