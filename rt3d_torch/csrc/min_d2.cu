// Per-query squared distance to the nearest valid reference point (kernel K4).
//
// Replaces `_min_d2_kernel` as launched by `min_sqdist_pallas`
// (rt3d/geometry/pallas_ops.py). Distances come from coordinate differences,
//     d2 = (dx dx + dy dy) + dz dz,  d = q - r,
// in round-to-nearest intrinsics (no fused multiply-add), the same bits as
// the plain PyTorch version in rt3d_torch/geometry/subtract.py. Contract,
// with t2 the caller's f32 threshold * threshold (+inf for no threshold):
// every valid query whose d2 <= t2 gets its d2 exactly, every other valid
// query some value > t2, every invalid query 3.4e38 (so does every query
// when no reference is valid). With t2 = +inf every valid query is exact.
//
// Bound on the H100: operations on the CUDA cores, 9 unfused f32
// instructions (3 subtractions, 3 products, 2 sums, 1 min) for each pair
// that has to be scanned, against 16-17 bytes a query and 13 a reference.
// Shared-memory loads are the other limit: with x, y and z apart, one
// 16-byte broadcast load brings one coordinate of four references, and an
// item shares it between two queries a lane, 0.375 loads a pair.
// The work is cut before it is done, as the Pallas kernel did it:
//  1. `ref_boxes_kernel` (one block per chunk of kChunk references) writes
//     the box of the valid references of every chunk and of every tile of
//     kTile references within it; a box with no valid reference is empty
//     (lo = +inf, hi = -inf). It also sets every output to 3.4e38.
//  2. `min_d2_kernel`: kSlices blocks share each block of kThreads queries
//     (one a thread), block s taking tile j of each chunk when j % kSlices
//     == s, so the work near the objects, which a few query blocks hold,
//     spreads over kSlices SMs; each block folds its minima into the output
//     with a global atomicMin on the bits (d2 >= 0 orders as an int). A
//     block takes the box of its valid queries and of each warp's (invalid
//     rows are left out: the workspace buffer holds (0, 0, 0) rows among
//     and after its sorted valid rows), lists the chunks whose box is not
//     farther than the threshold from the block's, and stages its tiles of
//     them, kStagedTiles at a time, in shared memory, x, y and z apart
//     (invalid rows at +inf). Each warp marks the staged tiles whose box is
//     not farther from its own; the warps marked on a tile are paired into
//     items (tile, two query groups), which the block's warps share. An
//     item reads the tile's 32 references once for 64 queries, two
//     independent chains a lane, and folds its minima into shared memory
//     with atomicMin. A block with no valid query returns at once.
// The workspace rows come sorted by voxel key, x-major, so the 32 queries of
// a warp lie in one or two x slices and a short run of y, and the object
// references are compacted slot by slot in key order: on the step's inputs
// the box tests leave a few per cent of the valid pairs. On unordered
// queries nothing is pruned and the scan costs what it did without tests.
//
// The tests are sound in floating point. Per axis the gap of two boxes is
// max(lo_b - hi_a, lo_a - hi_b, 0) with round-to-nearest subtractions, and
// gap2 = (gx gx + gy gy) + gz gz in d2's own rounded order. Rounding to
// nearest is monotone and symmetric, so for a query q in box a and a
// reference r in box b: |fl(q - r)| >= gap on each axis, each rounded
// square and sum is >= its counterpart, and fl(d2(q, r)) >= gap2. A pair
// is dropped only when gap2 > t2, so its computed d2 > t2: a query whose
// computed minimum is <= t2 keeps that pair and gets it exactly, and a
// query whose minimum lies only in dropped pairs gets the minimum of the
// pairs it kept, or 3.4e38, both > t2. No margin and no >= test is needed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // queries a block, one a thread
constexpr int kChunk = 256;              // references under one chunk box
constexpr int kTile = 32;                // references under one finer box
constexpr int kTiles = kChunk / kTile;   // tiles a chunk
constexpr int kSlices = 2;               // blocks a query block; tile j of a chunk
                                         // goes to the block with j % kSlices
constexpr int kSliceTiles = kTiles / kSlices;  // tiles of a chunk a block takes
constexpr int kStagedTiles = 32;         // tiles in shared memory at a time
constexpr int kStaged = kStagedTiles / kSliceTiles;  // chunks a stage
static_assert(kTiles % kSlices == 0 && kStagedTiles <= 32, "tile layout");
constexpr int kWarps = kThreads / 32;
constexpr int kBoxes = 2 + 2 * kTiles;   // float4 a chunk: its box, its tiles'
constexpr float kBig = 3.4e38f;
constexpr unsigned kAll = 0xffffffffu;

struct Box {
  float4 lo, hi;
};

__device__ __forceinline__ Box warp_box(Box b) {
  for (int off = 16; off > 0; off >>= 1) {
    b.lo.x = fminf(b.lo.x, __shfl_xor_sync(kAll, b.lo.x, off));
    b.lo.y = fminf(b.lo.y, __shfl_xor_sync(kAll, b.lo.y, off));
    b.lo.z = fminf(b.lo.z, __shfl_xor_sync(kAll, b.lo.z, off));
    b.hi.x = fmaxf(b.hi.x, __shfl_xor_sync(kAll, b.hi.x, off));
    b.hi.y = fmaxf(b.hi.y, __shfl_xor_sync(kAll, b.hi.y, off));
    b.hi.z = fmaxf(b.hi.z, __shfl_xor_sync(kAll, b.hi.z, off));
  }
  return b;
}

__device__ __forceinline__ Box point_box(bool ok, float x, float y, float z) {
  return ok ? Box{make_float4(x, y, z, 0.0f), make_float4(x, y, z, 0.0f)}
            : Box{make_float4(INFINITY, INFINITY, INFINITY, 0.0f),
                  make_float4(-INFINITY, -INFINITY, -INFINITY, 0.0f)};
}

__device__ __forceinline__ float axis_gap(float alo, float ahi, float blo,
                                          float bhi) {
  return fmaxf(fmaxf(__fsub_rn(blo, ahi), __fsub_rn(alo, bhi)), 0.0f);
}

// True when no pair of box a and box b can have d2 <= t2: b is empty, or
// its gap to a exceeds the threshold (see the note above).
__device__ __forceinline__ bool beyond(const Box& a, float4 blo, float4 bhi,
                                       float t2) {
  if (blo.x > bhi.x) return true;
  const float gx = axis_gap(a.lo.x, a.hi.x, blo.x, bhi.x);
  const float gy = axis_gap(a.lo.y, a.hi.y, blo.y, bhi.y);
  const float gz = axis_gap(a.lo.z, a.hi.z, blo.z, bhi.z);
  const float g2 = __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                             __fmul_rn(gz, gz));
  return g2 > t2;
}

__global__ void __launch_bounds__(kChunk)
ref_boxes_kernel(const float* __restrict__ r, const uint8_t* __restrict__ rvalid,
                 float4* __restrict__ boxes, float* __restrict__ d2, int m,
                 int n) {
  __shared__ Box wbox[kTiles];
  const int g = blockIdx.x * kChunk + threadIdx.x;
  if (g < n) d2[g] = kBig;  // the main kernel's slices lower it by atomicMin
  if (blockIdx.x >= (m + kChunk - 1) / kChunk) return;
  // the flag and the coordinates are read together, not one after the other
  const bool in = g < m;
  const bool ok = in && rvalid[g] != 0;
  const float x = in ? r[3 * static_cast<size_t>(g)] : 0.0f;
  const float y = in ? r[3 * static_cast<size_t>(g) + 1] : 0.0f;
  const float z = in ? r[3 * static_cast<size_t>(g) + 2] : 0.0f;
  const Box b = warp_box(point_box(ok, x, y, z));
  const int w = threadIdx.x / 32;
  float4* out = boxes + static_cast<size_t>(blockIdx.x) * kBoxes;
  if (threadIdx.x % 32 == 0) {
    wbox[w] = b;
    out[2 + 2 * w] = b.lo;
    out[3 + 2 * w] = b.hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Box c = wbox[0];
    for (int i = 1; i < kTiles; ++i) {
      c.lo = make_float4(fminf(c.lo.x, wbox[i].lo.x), fminf(c.lo.y, wbox[i].lo.y),
                         fminf(c.lo.z, wbox[i].lo.z), 0.0f);
      c.hi = make_float4(fmaxf(c.hi.x, wbox[i].hi.x), fmaxf(c.hi.y, wbox[i].hi.y),
                         fmaxf(c.hi.z, wbox[i].hi.z), 0.0f);
    }
    out[0] = c.lo;
    out[1] = c.hi;
  }
}

// Squared distances of Q queries (one a lane) to the kTile staged references
// at (bx, by, bz), folded into mn; the references are read once for all Q.
template <int Q>
__device__ __forceinline__ void scan_tile(const float* bx, const float* by,
                                          const float* bz, const float* px,
                                          const float* py, const float* pz,
                                          float* mn) {
  float a0[Q], a1[Q];
#pragma unroll
  for (int u = 0; u < Q; ++u) a0[u] = a1[u] = kBig;
#pragma unroll
  for (int j = 0; j < kTile; j += 2) {
    const float rx0 = bx[j], ry0 = by[j], rz0 = bz[j];
    const float rx1 = bx[j + 1], ry1 = by[j + 1], rz1 = bz[j + 1];
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const float ax = __fsub_rn(px[u], rx0), ay = __fsub_rn(py[u], ry0),
                  az = __fsub_rn(pz[u], rz0);
      const float cx = __fsub_rn(px[u], rx1), cy = __fsub_rn(py[u], ry1),
                  cz = __fsub_rn(pz[u], rz1);
      a0[u] = fminf(a0[u], __fadd_rn(__fadd_rn(__fmul_rn(ax, ax), __fmul_rn(ay, ay)),
                                     __fmul_rn(az, az)));
      a1[u] = fminf(a1[u], __fadd_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)),
                                     __fmul_rn(cz, cz)));
    }
  }
#pragma unroll
  for (int u = 0; u < Q; ++u) mn[u] = fminf(a0[u], a1[u]);
}

__global__ void __launch_bounds__(kThreads)
min_d2_kernel(const float* __restrict__ q, const uint8_t* __restrict__ qvalid,
              const float* __restrict__ r, const uint8_t* __restrict__ rvalid,
              const float4* __restrict__ boxes, int* __restrict__ out, int n,
              int m, float t2) {
  __shared__ float sx[kStagedTiles * kTile], sy[kStagedTiles * kTile],
      sz[kStagedTiles * kTile];
  __shared__ float4 stile[2 * kStagedTiles];
  __shared__ float qsx[kThreads], qsy[kThreads], qsz[kThreads];
  __shared__ int acc[kThreads];                  // d2 bits: >= 0, so int order
  __shared__ Box wbox[kWarps];
  __shared__ int list[kThreads];                 // chunks near the block
  __shared__ unsigned tile_warps[kStagedTiles];  // warps near each staged tile
  __shared__ int items[kStagedTiles * kWarps / 2];  // (tile, warp, warp) to scan
  __shared__ int nlist, nitems;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int slice = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  bool ok = false;
  if (i < n) {
    qx = q[3 * static_cast<size_t>(i)];
    qy = q[3 * static_cast<size_t>(i) + 1];
    qz = q[3 * static_cast<size_t>(i) + 2];
    ok = qvalid == nullptr || qvalid[i] != 0;
  }
  qsx[threadIdx.x] = qx;
  qsy[threadIdx.x] = qy;
  qsz[threadIdx.x] = qz;
  acc[threadIdx.x] = __float_as_int(kBig);
  const Box mine = warp_box(point_box(ok, qx, qy, qz));
  if (lane == 0) wbox[warp] = mine;
  if (threadIdx.x == 0) nlist = 0;
  if (!__syncthreads_or(ok)) return;  // its rows stay at kBig
  Box blk = wbox[0];
  for (int w = 1; w < kWarps; ++w) {
    blk.lo = make_float4(fminf(blk.lo.x, wbox[w].lo.x), fminf(blk.lo.y, wbox[w].lo.y),
                         fminf(blk.lo.z, wbox[w].lo.z), 0.0f);
    blk.hi = make_float4(fmaxf(blk.hi.x, wbox[w].hi.x), fmaxf(blk.hi.y, wbox[w].hi.y),
                         fmaxf(blk.hi.z, wbox[w].hi.z), 0.0f);
  }
  const bool warp_live = mine.lo.x <= mine.hi.x;
  const int n_chunks = (m + kChunk - 1) / kChunk;
  for (int b0 = 0; b0 < n_chunks; b0 += kThreads) {
    // list this batch's chunks near the block (in any order: min is exact)
    const int c = b0 + threadIdx.x;
    if (c < n_chunks) {
      const float4* cb = boxes + static_cast<size_t>(c) * kBoxes;
      if (!beyond(blk, cb[0], cb[1], t2)) list[atomicAdd(&nlist, 1)] = c;
    }
    __syncthreads();
    const int cnt = nlist;
    for (int k0 = 0; k0 < cnt; k0 += kStaged) {
      // stage this slice's tiles of up to kStaged listed chunks, invalid
      // rows at +inf; staged tile t is tile slice + kSlices * (t %
      // kSliceTiles) of listed chunk k0 + t / kSliceTiles
      const int nt = min(kStaged, cnt - k0) * kSliceTiles;
      for (int k = threadIdx.x; k < nt * kTile; k += kThreads) {
        const int t = k / kTile;
        const int g = list[k0 + t / kSliceTiles] * kChunk +
                      (slice + kSlices * (t % kSliceTiles)) * kTile + k % kTile;
        const bool in = g < m;
        const bool v = in && rvalid[g] != 0;
        const float x = in ? r[3 * static_cast<size_t>(g)] : 0.0f;
        const float y = in ? r[3 * static_cast<size_t>(g) + 1] : 0.0f;
        const float z = in ? r[3 * static_cast<size_t>(g) + 2] : 0.0f;
        sx[k] = v ? x : INFINITY;
        sy[k] = v ? y : INFINITY;
        sz[k] = v ? z : INFINITY;
      }
      if (threadIdx.x < 2 * nt) {
        const int t = threadIdx.x / 2;
        stile[threadIdx.x] =
            boxes[static_cast<size_t>(list[k0 + t / kSliceTiles]) * kBoxes + 2 +
                  2 * (slice + kSlices * (t % kSliceTiles)) + threadIdx.x % 2];
      }
      if (threadIdx.x < kStagedTiles) tile_warps[threadIdx.x] = 0;
      __syncthreads();
      // each warp marks the staged tiles near its own queries
      if (warp_live && lane < nt &&
          !beyond(mine, stile[2 * lane], stile[2 * lane + 1], t2)) {
        atomicOr(&tile_warps[lane], 1u << warp);
      }
      __syncthreads();
      // warp 0 pairs the warps marked on each tile into items of two query
      // groups (the last one alone), which read the tile once for both
      if (warp == 0) {
        unsigned marked = lane < nt ? tile_warps[lane] : 0u;
        const int cnt_items = (__popc(marked) + 1) / 2;
        int off = cnt_items;
        for (int d = 1; d < 32; d *= 2) {
          const int v = __shfl_up_sync(kAll, off, d);
          if (lane >= d) off += v;
        }
        if (lane == 31) nitems = off;
        off -= cnt_items;
        while (marked != 0) {
          const int a = __ffs(marked) - 1;
          marked &= marked - 1;
          int b = kWarps;  // none
          if (marked != 0) {
            b = __ffs(marked) - 1;
            marked &= marked - 1;
          }
          items[off++] = lane | a << 5 | b << 10;
        }
      }
      __syncthreads();
      // the block's warps share the items, so a few queries near many
      // references do not hold one warp while the others wait
      const int ni = nitems;
      for (int it = warp; it < ni; it += kWarps) {
        const int v = items[it];
        const int t = v & 31;
        const int ga = ((v >> 5) & 31) * 32 + lane;
        const int gb = (v >> 10) * 32 + lane;
        const float* bx = sx + t * kTile;
        const float* by = sy + t * kTile;
        const float* bz = sz + t * kTile;
        if (gb < kThreads) {
          const float px[2] = {qsx[ga], qsx[gb]}, py[2] = {qsy[ga], qsy[gb]},
                      pz[2] = {qsz[ga], qsz[gb]};
          float mn[2];
          scan_tile<2>(bx, by, bz, px, py, pz, mn);
          atomicMin(&acc[ga], __float_as_int(mn[0]));
          atomicMin(&acc[gb], __float_as_int(mn[1]));
        } else {
          float mn[1];
          scan_tile<1>(bx, by, bz, &qsx[ga], &qsy[ga], &qsz[ga], mn);
          atomicMin(&acc[ga], __float_as_int(mn[0]));
        }
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) nlist = 0;
    __syncthreads();
  }
  if (ok && acc[threadIdx.x] != __float_as_int(kBig)) atomicMin(&out[i], acc[threadIdx.x]);
}

}  // namespace

// `boxes`: scratch of ceil(m / 256) * 18 float4, written by the first kernel
// and read by the second. `query_valid` may be null (every query valid);
// `t2` is +inf for an exact result on every valid query.
extern "C" int rt3d_min_sqdist(const float* queries, const uint8_t* query_valid,
                               const float* refs, const uint8_t* ref_valid,
                               void* boxes, float* out, int n, int m, float t2,
                               void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (m + kChunk - 1) / kChunk;
  const int n_blocks = (n + kThreads - 1) / kThreads;
  float4* b = static_cast<float4*>(boxes);
  ref_boxes_kernel<<<max(n_chunks, n_blocks), kChunk, 0, s>>>(refs, ref_valid, b, out,
                                                              m, n);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_chunks == 0) return static_cast<int>(e);
  min_d2_kernel<<<dim3(n_blocks, kSlices), kThreads, 0, s>>>(
      queries, query_valid, refs, ref_valid, b, reinterpret_cast<int*>(out), n, m, t2);
  return static_cast<int>(cudaGetLastError());
}
