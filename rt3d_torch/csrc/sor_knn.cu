// k-nearest-neighbour mean distance for statistical outlier removal:
// kernel K3 over object slots and kernel K5 over one cloud.
//
// Both replace the Pallas `_sor_knn_kernel` (rt3d/geometry/pallas_ops.py):
// K3 as launched by `sor_knn_mean_pallas_slots`, K5 as launched by
// `sor_knn_mean_pallas`. For every valid point of slot s: the sum of
// sqrt(min(d2, 1e30)) over its k smallest squared distances to the cap rows
// of its own slot (itself included), taken in ascending order and divided
// by max(k - 1, 1), plus `saturated` = the k-th smallest d2 >= (1e5)^2 / 4,
// i.e. the slot ran out of valid neighbours. Invalid rows count as points
// at (1e5, 1e5, 1e5), exactly as in the Pallas kernel, and d2 keeps its
// formula
//     d2 = max((|q|^2 + |r|^2) - 2 (q . r), 0),
//     |p|^2 = (px px + py py) + pz pz,  q . r = (qx rx + qy ry) + qz rz,
// evaluated with round-to-nearest intrinsics (no fused multiply-add), so the
// kernel gives the same bits as the plain PyTorch version in
// rt3d_torch/geometry/sor.py. Invalid query rows return (3.4e38, true):
// the caller masks them by `valid`.
//
// Bound on the H100: operations, on the CUDA cores. The statistic needs
// every valid pair of a slot (about 9 flops for d2 plus a compare), n * n *
// 10 operations for a slot of n valid points, against at most 16 bytes of
// input and 5 of output a row.
//
// No tensor cores. `wgmma` takes f32 data only as TF32, which keeps 10
// mantissa bits and accumulates the three products in one fused sum, so it
// cannot give the separately rounded d2 above, on which the bits of every
// mean and keep mask depend; and its contraction would be 3 deep.
//
// Design, per block of kThreads threads, one query of one slot per warp
// (kQueries = kThreads / 32 queries a block):
//  1. Count the slot's valid rows. The block takes the valid rows of rank
//     [q0, q0 + kQueries) as its queries and writes (3.4e38, true) for the
//     invalid rows among rows [q0, q0 + kQueries); a block with no query
//     returns before staging anything (empty slots, the tail of padded ones).
//  2. Stage only the valid rows, compacted, in shared memory as (x, y, z,
//     |p|^2): 16 bytes a row, at most 64 KB at cap 4096. The order of the
//     compacted rows does not matter: the k smallest are a multiset.
//  3. The 32 lanes of a warp share its query: one warp per query was the
//     fastest of 4, 8, 16 and 32 lanes per query when they were measured
//     (PERF.md). Each lane scans a strided share of the n_valid candidates
//     and keeps its own k smallest, sorted, in registers (a min/max chain
//     of k rounded up to 8, a template on that length). Every kSyncEvery
//     candidates the lanes exchange the least of their k-th values, a bound
//     no entry of the query's k smallest exceeds, and reject candidates
//     above it.
//  4. The padding is not scanned: all cap - n_valid invalid rows sit at the
//     same point, so they give one d2 per query, taken that many times.
//  5. k rounds of a warp-wide shuffle-min over the lanes' list heads (and
//     the padding's d2 while copies remain) pop the k smallest in ascending
//     order; every lane sums the same values, so the mean has the plain
//     version's bits.
// The staging copy is a plain loop (no cp.async, TMA or cluster): each block
// of a slot counts and stages the slot's valid rows again, at most 64 KB
// from L2. kThreads and kSyncEvery were not swept, and no measurement has
// yet separated the staging's time from the scan's.
//
// That register path takes k <= kMaxK = 32. Above it, up to k = cap, a
// second kernel (`sor_knn_large_kernel`) gives the same bits. It stages the
// slot's valid rows the same way; then each warp takes one query at a time:
//  a. it writes the query's n_valid squared distances, as uint32 keys (the
//     bits of a d2 >= 0 order as the floats do; the sign bit is masked so a
//     -0 sorts with +0), into its own row of shared memory;
//  b. radix select, four passes of 8 bits from the top, finds the k-th
//     smallest key of the row plus the padding's cap - n_valid copies of its
//     one d2 (one histogram of 256 bins a warp, lanes of one bin adding once
//     through __match_any_sync);
//  c. the keys below that threshold are compacted to the front of the row
//     in place and sorted ascending by a warp-wide bitonic sort;
//  d. the lanes take their square roots, and lane 0 sums them in ascending
//     order, merging in the padding's copies below the threshold, then adds
//     the threshold's own copies up to k: the order in which the plain
//     version sums its sorted top k, so the mean has its bits.
// Its bound is the register path's: the distances of every valid pair. The
// selection, the sort and the serial sum grow with k on top of it; at
// k = cap they take most of its time (PERF.md).
// Shared memory a block: 16 bytes a staged row, 4 bytes a row entry for each
// warp's row (cap rounded up to a power of two, for the sort) and 1 KB of
// histogram a warp: 200 KB at cap 4096, within the 227 KB a block may ask
// for; a launch that asks for more is refused and reported.
// One launch per call, no host read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 32;  // the register path's largest k
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQueries = kWarps;  // one query per warp
constexpr int kSyncEvery = 8;   // candidates a lane scans between exchanges
constexpr unsigned kAll = 0xffffffffu;
constexpr float kFar = 1.0e5f;
constexpr float kBig = 3.4e38f;

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__device__ __forceinline__ float sq_dist(float4 q, float4 r) {
  const float cross = __fadd_rn(
      __fadd_rn(__fmul_rn(q.x, r.x), __fmul_rn(q.y, r.y)),
      __fmul_rn(q.z, r.z));
  return fmaxf(__fsub_rn(__fadd_rn(q.w, r.w), __fmul_rn(2.0f, cross)), 0.0f);
}

// least of v over the warp
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kAll, v, off));
  return v;
}

// A refused request for shared memory (more than a block may have) leaves
// its error as the thread's last one, which the next launch's check (ours or
// PyTorch's) would report as its own: clear it, and return it to the caller.
int refused(cudaError_t e) {
  cudaGetLastError();
  return static_cast<int>(e);
}

// KR: k rounded up to a multiple of 8. best[0, KR - k) hold -inf, so
// best[KR - 1] is the k-th smallest kept.
template <int KR>
__global__ void __launch_bounds__(kThreads)
sor_knn_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
               float* __restrict__ mean, uint8_t* __restrict__ sat, int cap,
               int k) {
  extern __shared__ float4 cand[];
  __shared__ int qrow[kQueries];
  __shared__ int warp_count[kWarps];
  const size_t base = static_cast<size_t>(blockIdx.y) * cap;
  const uint8_t* v = valid + base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kQueries;

  if (tid < kQueries && q0 + tid < cap && v[q0 + tid] == 0) {
    mean[base + q0 + tid] = kBig;
    sat[base + q0 + tid] = 1;
  }
  // warp w owns rows [r0, r1); the compacted order is the row order, the
  // same in every block of the slot
  const int span = (cap + kThreads - 1) / kThreads * 32;
  const int r0 = warp * span, r1 = min(r0 + span, cap);
  int c = 0;
  for (int i = r0 + lane; i < r1; i += 32) c += v[i] != 0;
  c = __reduce_add_sync(kAll, c);
  if (lane == 0) warp_count[warp] = c;
  __syncthreads();
  int nv = 0, off = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    off += w < warp ? warp_count[w] : 0;
    nv += warp_count[w];
  }
  if (q0 >= nv) return;

  for (int i0 = r0; i0 < r1; i0 += 32) {
    const int i = i0 + lane;
    const bool ok = i < r1 && v[i] != 0;
    const unsigned m = __ballot_sync(kAll, ok);
    if (ok) {
      const int pos = off + __popc(m & ((1u << lane) - 1u));
      const float* p = pts + 3 * (base + i);
      const float x = p[0], y = p[1], z = p[2];
      cand[pos] = make_float4(x, y, z, sq_norm(x, y, z));
      if (pos >= q0 && pos < q0 + kQueries) qrow[pos - q0] = i;
    }
    off += __popc(m);
  }
  __syncthreads();

  const int cq = q0 + warp;
  if (cq >= nv) return;  // the whole warp: no block barrier follows
  const float4 q = cand[cq];

  float best[KR];
#pragma unroll
  for (int i = 0; i < KR; ++i) best[i] = i < KR - k ? -INFINITY : INFINITY;
  float thr = INFINITY;
  const int steps = (nv + 31) / 32;
  for (int s0 = 0; s0 < steps; s0 += kSyncEvery) {
    const int s1 = min(s0 + kSyncEvery, steps);
    for (int s = s0; s < s1; ++s) {
      const int j = s * 32 + lane;
      if (j < nv) {
        float d2 = sq_dist(q, cand[j]);
        if (d2 < thr) {
#pragma unroll
          for (int i = 0; i < KR; ++i) {
            const float lo = fminf(best[i], d2);
            d2 = fmaxf(best[i], d2);
            best[i] = lo;
          }
          thr = fminf(thr, best[KR - 1]);
        }
      }
    }
    thr = fminf(thr, warp_min(best[KR - 1]));
  }

  // drop the -inf fillers: best[0, k) becomes the lane's k smallest
  for (int s = 0; s < KR - k; ++s) {
#pragma unroll
    for (int i = 0; i < KR - 1; ++i) best[i] = best[i + 1];
    best[KR - 1] = INFINITY;
  }

  const float far2 = sq_dist(q, make_float4(kFar, kFar, kFar,
                                            sq_norm(kFar, kFar, kFar)));
  int far_left = cap - nv;
  float acc = 0.0f, last = 0.0f;
  for (int r = 0; r < k; ++r) {
    const float mn = warp_min(best[0]);
    const bool take_far = far_left > 0 && far2 <= mn;
    const unsigned heads = __ballot_sync(kAll, !take_far && best[0] == mn);
    const float val = take_far ? far2 : mn;
    far_left -= take_far ? 1 : 0;
    if (!take_far && __ffs(heads) - 1 == lane) {
#pragma unroll
      for (int i = 0; i < KR - 1; ++i) best[i] = best[i + 1];
      best[KR - 1] = INFINITY;
    }
    acc = __fadd_rn(acc, __fsqrt_rn(fminf(val, 1e30f)));
    last = val;
  }
  if (lane == 0) {
    const size_t row = base + qrow[cq - q0];
    mean[row] = __fdiv_rn(acc, static_cast<float>(k > 1 ? k - 1 : 1));
    sat[row] = last >= kFar * kFar * 0.25f ? 1 : 0;
  }
}

template <int KR>
int launch_kr(const float* pts, const uint8_t* valid, float* mean,
              uint8_t* sat, int slots, int cap, int k, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(cap) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sor_knn_kernel<KR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return refused(e);
  }
  const dim3 grid((cap + kQueries - 1) / kQueries, slots);
  sor_knn_kernel<KR><<<grid, kThreads, smem, stream>>>(pts, valid, mean, sat,
                                                        cap, k);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// k > kMaxK: radix select and a sorted sum in shared memory
// ---------------------------------------------------------------------------

constexpr int kLargeWarps = 8;
constexpr int kLargeThreads = kLargeWarps * 32;
constexpr int kLargePerWarp = 2;  // queries a warp takes in turn
constexpr int kLargeQueries = kLargeWarps * kLargePerWarp;
constexpr int kBins = 256;        // radix digit of 8 bits
constexpr uint32_t kPad = 0xffffffffu;

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__device__ __forceinline__ uint32_t d2_key(float d2) {
  return __float_as_uint(d2) & 0x7fffffffu;
}

// row_len: cap rounded up to a power of two
__global__ void __launch_bounds__(kLargeThreads)
sor_knn_large_kernel(const float* __restrict__ pts,
                     const uint8_t* __restrict__ valid, float* __restrict__ mean,
                     uint8_t* __restrict__ sat, int cap, int k, int row_len) {
  extern __shared__ float4 cand[];
  uint32_t* rows = reinterpret_cast<uint32_t*>(cand + cap);
  uint32_t* hists = rows + static_cast<size_t>(kLargeWarps) * row_len;
  __shared__ int qrow[kLargeQueries];
  __shared__ int warp_count[kLargeWarps];
  const size_t base = static_cast<size_t>(blockIdx.y) * cap;
  const uint8_t* v = valid + base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kLargeQueries;

  if (tid < kLargeQueries && q0 + tid < cap && v[q0 + tid] == 0) {
    mean[base + q0 + tid] = kBig;
    sat[base + q0 + tid] = 1;
  }
  // staging as in sor_knn_kernel
  const int span = (cap + kLargeThreads - 1) / kLargeThreads * 32;
  const int r0 = warp * span, r1 = min(r0 + span, cap);
  int c = 0;
  for (int i = r0 + lane; i < r1; i += 32) c += v[i] != 0;
  c = __reduce_add_sync(kAll, c);
  if (lane == 0) warp_count[warp] = c;
  __syncthreads();
  int nv = 0, off = 0;
#pragma unroll
  for (int w = 0; w < kLargeWarps; ++w) {
    off += w < warp ? warp_count[w] : 0;
    nv += warp_count[w];
  }
  if (q0 >= nv) return;

  for (int i0 = r0; i0 < r1; i0 += 32) {
    const int i = i0 + lane;
    const bool ok = i < r1 && v[i] != 0;
    const unsigned m = __ballot_sync(kAll, ok);
    if (ok) {
      const int pos = off + __popc(m & ((1u << lane) - 1u));
      const float* p = pts + 3 * (base + i);
      const float x = p[0], y = p[1], z = p[2];
      cand[pos] = make_float4(x, y, z, sq_norm(x, y, z));
      if (pos >= q0 && pos < q0 + kLargeQueries) qrow[pos - q0] = i;
    }
    off += __popc(m);
  }
  __syncthreads();

  uint32_t* row = rows + static_cast<size_t>(warp) * row_len;
  uint32_t* hist = hists + warp * kBins;
  const int far_cnt = cap - nv;
  const float4 far4 = make_float4(kFar, kFar, kFar, sq_norm(kFar, kFar, kFar));
  const unsigned below_me = (1u << lane) - 1u;
  for (int t = 0; t < kLargePerWarp; ++t) {
    const int cq = q0 + warp + t * kLargeWarps;
    if (cq >= nv) break;  // the whole warp: no block barrier follows
    const float4 q = cand[cq];
    // a. the row of distances
    for (int j = lane; j < nv; j += 32) row[j] = d2_key(sq_dist(q, cand[j]));
    const uint32_t far_key = d2_key(sq_dist(q, far4));
    __syncwarp();

    // b. radix select: `rank` is the wanted key's rank (from 1) among the
    // keys that share the digits fixed so far
    uint32_t prefix = 0, fixed = 0;
    int rank = k;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int b = lane; b < kBins; b += 32) hist[b] = 0;
      __syncwarp();
      for (int j0 = 0; j0 < nv; j0 += 32) {
        const int j = j0 + lane;
        uint32_t key = 0;
        if (j < nv) key = row[j];
        const bool in = j < nv && (key & fixed) == prefix;
        const unsigned act = __ballot_sync(kAll, in);
        if (in) {
          const uint32_t bin = (key >> shift) & 255u;
          const unsigned peers = __match_any_sync(act, bin);
          if ((peers & below_me) == 0) atomicAdd(&hist[bin], __popc(peers));
        }
      }
      if (lane == 0 && far_cnt > 0 && (far_key & fixed) == prefix)
        atomicAdd(&hist[(far_key >> shift) & 255u], static_cast<uint32_t>(far_cnt));
      __syncwarp();
      int cnt[8], sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        cnt[i] = static_cast<int>(hist[lane * 8 + i]);
        sum += cnt[i];
      }
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kAll, incl, d);
        if (lane >= d) incl += u;
      }
      int below = incl - sum, digit = -1;
      if (below < rank && rank <= incl) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (digit < 0) {
            if (below + cnt[i] >= rank) digit = lane * 8 + i;
            else below += cnt[i];
          }
        }
      }
      const int src = __ffs(__ballot_sync(kAll, digit >= 0)) - 1;
      digit = __shfl_sync(kAll, digit, src);
      below = __shfl_sync(kAll, below, src);
      rank -= below;
      prefix |= static_cast<uint32_t>(digit) << shift;
      fixed |= 255u << shift;
      __syncwarp();
    }
    const uint32_t thr = prefix;  // the k-th smallest; `rank` copies of it end the k

    // c. keys below the threshold to the front (every lane reads its entry
    // of a chunk before any lane writes, and writes land at or before it)
    int m = 0;
    for (int j0 = 0; j0 < nv; j0 += 32) {
      const int j = j0 + lane;
      uint32_t key = kPad;
      if (j < nv) key = row[j];
      const bool lt = key < thr;
      const unsigned b = __ballot_sync(kAll, lt);
      if (lt) row[m + __popc(b & below_me)] = key;
      m += __popc(b);
    }
    const int p2 = pow2_at_least(m);
    for (int j = m + lane; j < p2; j += 32) row[j] = kPad;
    __syncwarp();
    for (int size = 2; size <= p2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int u = lane; u < p2 / 2; u += 32) {
          const int i = 2 * u - (u & (stride - 1));
          const uint32_t a = row[i], b = row[i + stride];
          if ((a > b) == ((i & size) == 0)) {
            row[i] = b;
            row[i + stride] = a;
          }
        }
        __syncwarp();
      }
    }

    // d. square roots in parallel, the sum in ascending order on lane 0
    for (int j = lane; j < m; j += 32)
      row[j] = __float_as_uint(__fsqrt_rn(fminf(__uint_as_float(row[j]), 1e30f)));
    __syncwarp();
    if (lane == 0) {
      const float fv = __fsqrt_rn(fminf(__uint_as_float(far_key), 1e30f));
      const float tv = __fsqrt_rn(fminf(__uint_as_float(thr), 1e30f));
      int far_left = far_cnt > 0 && far_key < thr ? far_cnt : 0;
      float acc = 0.0f;
      for (int j = 0; j < m; ++j) {
        const float x = __uint_as_float(row[j]);
        for (; far_left > 0 && fv <= x; --far_left) acc = __fadd_rn(acc, fv);
        acc = __fadd_rn(acc, x);
      }
      for (; far_left > 0; --far_left) acc = __fadd_rn(acc, fv);
      for (int r = 0; r < rank; ++r) acc = __fadd_rn(acc, tv);
      const size_t out = base + qrow[cq - q0];
      mean[out] = __fdiv_rn(acc, static_cast<float>(k > 1 ? k - 1 : 1));
      sat[out] = __uint_as_float(thr) >= kFar * kFar * 0.25f ? 1 : 0;
    }
    __syncwarp();  // the row is rewritten by the next query
  }
}

int launch_large(const float* pts, const uint8_t* valid, float* mean,
                 uint8_t* sat, int slots, int cap, int k, cudaStream_t stream) {
  const int row_len = pow2_at_least(cap);
  const size_t smem = static_cast<size_t>(cap) * sizeof(float4) +
                      static_cast<size_t>(kLargeWarps) * (row_len + kBins) *
                          sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sor_knn_large_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return refused(e);
  }
  const dim3 grid((cap + kLargeQueries - 1) / kLargeQueries, slots);
  sor_knn_large_kernel<<<grid, kLargeThreads, smem, stream>>>(
      pts, valid, mean, sat, cap, k, row_len);
  return static_cast<int>(cudaGetLastError());
}

int launch_sor_knn(const float* pts, const uint8_t* valid, float* mean,
                   uint8_t* sat, int slots, int cap, int k, void* stream) {
  if (k < 1 || k > cap) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > kMaxK) return launch_large(pts, valid, mean, sat, slots, cap, k, s);
  switch ((k + 7) / 8) {
    case 1: return launch_kr<8>(pts, valid, mean, sat, slots, cap, k, s);
    case 2: return launch_kr<16>(pts, valid, mean, sat, slots, cap, k, s);
    case 3: return launch_kr<24>(pts, valid, mean, sat, slots, cap, k, s);
    default: return launch_kr<32>(pts, valid, mean, sat, slots, cap, k, s);
  }
}

}  // namespace

// K3: (slots, cap) clouds.
extern "C" int rt3d_sor_knn_slots(const float* pts, const uint8_t* valid,
                                  float* mean, uint8_t* sat, int slots,
                                  int cap, int k, void* stream) {
  return launch_sor_knn(pts, valid, mean, sat, slots, cap, k, stream);
}

// K5: one cloud of n points, K3's launch over one slot.
extern "C" int rt3d_sor_knn(const float* pts, const uint8_t* valid,
                            float* mean, uint8_t* sat, int n, int k,
                            void* stream) {
  return launch_sor_knn(pts, valid, mean, sat, 1, n, k, stream);
}
