// Slot-batched k-nearest-neighbour mean distance for statistical outlier
// removal (kernel K3).
//
// Replaces `_sor_knn_kernel` as launched by `sor_knn_mean_pallas_slots`
// (rt3d/geometry/pallas_ops.py). For every valid point of slot s: the sum of
// sqrt(min(d2, 1e30)) over its k smallest squared distances to the points of
// its own slot (itself included, at distance 0), divided by max(k - 1, 1),
// plus `saturated` = the k-th smallest d2 >= (1e5)^2 / 4, i.e. the slot ran
// out of valid neighbours. Invalid points sit at (1e5, 1e5, 1e5), exactly as
// in the Pallas kernel, and d2 keeps its formula
//     d2 = max((|q|^2 + |r|^2) - 2 (q . r), 0),
//     |p|^2 = (px px + py py) + pz pz,  q . r = (qx rx + qy ry) + qz rz,
// evaluated with round-to-nearest intrinsics (no fused multiply-add), so the
// kernel gives the same bits as the plain PyTorch version in
// rt3d_torch/geometry/sor.py. Invalid query rows return (3.4e38, true):
// the caller masks them by `valid`.
//
// Bound on the H100: operations. Per valid query the kernel visits all cap
// points of its slot (about 9 flops for d2 plus a compare), so 20 slots of
// 2048 points cost up to 20 * 2048 * 2048 * 10 operations against 33 MB of
// input. Design: one thread per query, 128 queries per block, the slot's
// points and their squared norms staged once per block in shared memory
// (16 bytes a point, 32 KB at cap 2048), the k smallest kept sorted in
// registers by a branch-free insertion that runs only when a candidate beats
// the current k-th. Blocks whose queries are all invalid (empty slots, the
// padding of small objects) return before staging anything.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 32;
constexpr int kThreads = 128;
constexpr float kFar = 1.0e5f;
constexpr float kBig = 3.4e38f;

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__global__ void sor_knn_slots_kernel(const float* __restrict__ pts,
                                     const uint8_t* __restrict__ valid,
                                     float* __restrict__ mean,
                                     uint8_t* __restrict__ sat, int cap,
                                     int k) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = smem + cap;
  float* sz = smem + 2 * cap;
  float* sn = smem + 3 * cap;
  const size_t base = static_cast<size_t>(blockIdx.y) * cap;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool qvalid = qi < cap && valid[base + qi] != 0;
  if (!__syncthreads_or(qvalid)) {
    if (qi < cap) {
      mean[base + qi] = kBig;
      sat[base + qi] = 1;
    }
    return;
  }
  for (int i = threadIdx.x; i < cap; i += kThreads) {
    const bool ok = valid[base + i] != 0;
    const float* p = pts + 3 * (base + i);
    const float x = ok ? p[0] : kFar;
    const float y = ok ? p[1] : kFar;
    const float z = ok ? p[2] : kFar;
    sx[i] = x;
    sy[i] = y;
    sz[i] = z;
    sn[i] = sq_norm(x, y, z);
  }
  __syncthreads();
  if (qi >= cap) return;
  if (!qvalid) {
    mean[base + qi] = kBig;
    sat[base + qi] = 1;
    return;
  }
  const float qx = sx[qi], qy = sy[qi], qz = sz[qi], q2 = sn[qi];
  float best[kMaxK];
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) best[i] = INFINITY;
  float kth = INFINITY;
  for (int j = 0; j < cap; ++j) {
    const float cross = __fadd_rn(
        __fadd_rn(__fmul_rn(qx, sx[j]), __fmul_rn(qy, sy[j])),
        __fmul_rn(qz, sz[j]));
    const float d2 =
        fmaxf(__fsub_rn(__fadd_rn(q2, sn[j]), __fmul_rn(2.0f, cross)), 0.0f);
    if (d2 < kth) {
      float v = d2;
#pragma unroll
      for (int i = 0; i < kMaxK; ++i) {
        const float lo = fminf(best[i], v);
        v = fmaxf(best[i], v);
        best[i] = lo;
      }
#pragma unroll
      for (int i = 0; i < kMaxK; ++i) {
        if (i == k - 1) kth = best[i];
      }
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) {
    if (i < k) acc = __fadd_rn(acc, __fsqrt_rn(fminf(best[i], 1e30f)));
  }
  mean[base + qi] = __fdiv_rn(acc, static_cast<float>(k > 1 ? k - 1 : 1));
  sat[base + qi] = kth >= kFar * kFar * 0.25f ? 1 : 0;
}

}  // namespace

extern "C" int rt3d_sor_knn_slots(const float* pts, const uint8_t* valid,
                                  float* mean, uint8_t* sat, int slots,
                                  int cap, int k, void* stream) {
  if (k < 1 || k > kMaxK || k > cap) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(cap) * 4 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sor_knn_slots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((cap + kThreads - 1) / kThreads, slots);
  sor_knn_slots_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(pts, valid, mean,
                                                              sat, cap, k);
  return static_cast<int>(cudaGetLastError());
}
