// Greedy thresholded matching of one cost matrix, every round on the card.
//
// The plain version is `solve_matching_greedy_plain`
// (rt3d_torch/tracking/assignment.py): each round takes every row's and
// every column's argmin of the masked matrix (lowest index on ties, as
// `torch.argmin`), claims every pair that is both its row's and its
// column's argmin and feasible, then masks the claimed rows and columns. It
// reads a flag back to the host after every round to stop; this kernel
// loops on the card instead, so a solve is one launch and no host wait, and
// a CUDA graph can hold it. The pairs are the plain version's, pair for
// pair:
//  - an entry is feasible when `cost < thresh` (thresh as f32, as PyTorch
//    compares an f32 tensor with a Python float); every other entry, NaN
//    included, becomes kBig, the plain version's 1e9;
//  - the matrix lives in shared memory as those values, and a claimed row
//    or column reads as kBig through one flag a row and a column, which is
//    what the plain version writes into its matrix;
//  - a row whose argmin value is not below kBig claims nothing (the plain
//    test `cm[row, rmin] < big`), nor does a column whose argmin value is
//    not: a claim needs its entry below kBig, so such a column's index is
//    never compared. Entries of claimed rows in a column are kBig, so they
//    never tie with a minimum below kBig either;
//  - the loop ends after a round that claims nothing (one __syncthreads_or)
//    or after min(R, C) rounds, the plain loop's bound.
//
// It replaces no TPU kernel: the JAX package leaves this loop to XLA. It
// is bound by neither bytes nor operations (a 64 x 20 matrix is 5 KB and a
// round 2 560 compares) but by latency: each round is two reductions and
// two block barriers after the last, and the rounds run one after another.
// So one block of kThreads threads takes a matrix, whole in shared memory.
// Each warp takes rows (then columns) in turn, its lanes striding over the
// row's columns (the column's rows), and folds (value, index) pairs by
// shuffles, the lower index winning a tie.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e9f;
constexpr unsigned kInfBits = 0x7f800000u;  // +inf: no entry is as large

__device__ __forceinline__ void take_min(float v, int i, float& bv, int& bi) {
  if (v < bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ void warp_min(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, o);
    const int oi = __shfl_down_sync(0xffffffffu, i, o);
    take_min(ov, oi, v, i);
  }
}

// Shared memory: the masked matrix (r * c floats), each row's argmin
// column and each column's argmin row (-1 where its minimum is not below
// kBig), and the claimed flags of rows and columns.
__global__ void __launch_bounds__(kThreads)
greedy_match_kernel(const float* __restrict__ cost, float thresh, int r, int c,
                    int32_t* __restrict__ col_of_row, int32_t* __restrict__ row_of_col) {
  extern __shared__ float smem[];
  float* cm = smem;
  int* rmin = reinterpret_cast<int*>(cm + static_cast<size_t>(r) * c);
  int* cmin = rmin + r;
  uint8_t* row_done = reinterpret_cast<uint8_t*>(cmin + c);
  uint8_t* col_done = row_done + r;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < r * c; i += kThreads) {
    const float v = cost[i];
    cm[i] = v < thresh ? v : kBig;
  }
  for (int i = tid; i < r; i += kThreads) {
    row_done[i] = 0;
    col_of_row[i] = -1;
  }
  for (int j = tid; j < c; j += kThreads) {
    col_done[j] = 0;
    row_of_col[j] = -1;
  }
  __syncthreads();

  const int rounds = min(r, c);
  for (int round = 0; round < rounds; ++round) {
    for (int i = warp; i < r; i += kWarps) {
      float bv = __uint_as_float(kInfBits);
      int bi = INT_MAX;
      if (!row_done[i]) {
        for (int j = lane; j < c; j += 32) take_min(col_done[j] ? kBig : cm[i * c + j], j, bv, bi);
      }
      warp_min(bv, bi);
      if (lane == 0) rmin[i] = bv < kBig ? bi : -1;
    }
    for (int j = warp; j < c; j += kWarps) {
      float bv = __uint_as_float(kInfBits);
      int bi = INT_MAX;
      if (!col_done[j]) {
        for (int i = lane; i < r; i += 32) take_min(row_done[i] ? kBig : cm[i * c + j], i, bv, bi);
      }
      warp_min(bv, bi);
      if (lane == 0) cmin[j] = bv < kBig ? bi : -1;
    }
    __syncthreads();
    // the mutual pairs hold distinct rows and columns: each thread writes
    // only its own row's and its column's entries
    int claimed = 0;
    for (int i = tid; i < r; i += kThreads) {
      const int j = rmin[i];
      if (j >= 0 && cmin[j] == i) {
        col_of_row[i] = j;
        row_of_col[j] = i;
        row_done[i] = 1;
        col_done[j] = 1;
        claimed = 1;
      }
    }
    if (!__syncthreads_or(claimed)) break;
  }
}

}  // namespace

// Shared bytes the kernel takes for an r x c matrix; the caller keeps it
// within the card's opt-in limit (rt3d_torch/tracking/assignment.py).
static size_t greedy_smem_bytes(int r, int c) {
  return static_cast<size_t>(r) * c * sizeof(float) + (r + c) * (sizeof(int) + 1);
}

extern "C" int rt3d_greedy_match(const float* cost, int r, int c, float thresh,
                                 int32_t* col_of_row, int32_t* row_of_col, void* stream) {
  if (r == 0 || c == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = greedy_smem_bytes(r, c);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        greedy_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  greedy_match_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cost, thresh, r, c, col_of_row, row_of_col);
  return static_cast<int>(cudaGetLastError());
}
