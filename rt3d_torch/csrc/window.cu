// Windowed voxel-key pre-dedupe over an image grid (kernels K1 and K2).
//
// K1 replaces `_window_dedupe_kernel` (rt3d/geometry/pallas_ops.py, called
// through `window_dedupe_pallas`): every key that equals a row-major-
// preceding key inside the window dy in [0, dy_max], dx in [-dx_max, dx_max]
// (dx in [1, dx_max] on the same row) becomes `sentinel`. Output equals
// `where(ops._window_duplicate_mask(kg), sentinel, kg)` everywhere.
//
// K2 replaces `_window_prev_or_kernel` (same file, `window_prev_or_pallas`):
// per pixel, the OR of the mask words of the preceding window pixels whose
// key equals this pixel's key. Output equals `ops._window_prev_or` everywhere
// (out-of-grid neighbours count as key `sentinel`, word 0, as in its padding).
//
// K1's design: one thread per pixel; a block stages its 32x8 tile plus a
// halo of dy_max rows above and dx_max columns each side in shared memory,
// so every global word is read about 1.5 times (halo overlap) instead of 58
// times, with a warp reading 32 consecutive keys. Each pixel then makes its
// 58 window compares from shared memory.
//
// K2's bound on the H100: integer operations on a dense grid (58 compares a
// pixel and an OR a matching neighbour, at 64 INT32 lanes a clock an SM),
// bytes (12 a pixel) on the step's grids, which are almost all sentinel:
// the object-mask path sets key = sentinel and word = 0 wherever no mask
// covers the pixel. Its design:
//  - A block of 128 x 4 threads owns a 128-column x 8-row tile; it stages
//    the tile with 4 rows above and 8 columns each side (16-byte loads when
//    the width is a multiple of 4).
//  - Exact block skip: when every staged word is 0, every output of the
//    tile is 0 whatever the keys, and the block writes zeros (one
//    __syncthreads_or). The TPU kernel skipped all-sentinel key blocks,
//    which is exact only where words under sentinels are 0; this test needs
//    no such promise.
//  - When no staged pixel pairs a sentinel key with a non-zero word (the
//    step's grids), a sentinel output is 0 and needs no compare.
//  - A thread owns kRows = 2 rows of one column. For each of the 13 column
//    offsets it walks the 2 + dy_max window rows once, loading each key and
//    word a single time from shared memory and comparing the key with every
//    output whose window holds it; the OR is a predicated register OR, not
//    a load a compare. Two rows a thread, not more: on the step's grids the
//    few blocks that hold mask pixels set the kernel's time, and a short
//    chain a thread with 16 warps a block finishes them soonest (rows a
//    thread and threads a block were swept once; PERF.md).
// The window is at most 4 rows x 6 columns each side (the template covers
// each dy_max up to 4; dx_max is a uniform runtime bound).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;

__global__ void dedupe_kernel(const int32_t* __restrict__ keys,
                              int32_t* __restrict__ out, int h, int w,
                              int dy_max, int dx_max, int32_t sentinel) {
  extern __shared__ int32_t sk[];
  const int tw = kTileX + 2 * dx_max;
  const int th = kTileY + dy_max;
  const int c0 = blockIdx.x * kTileX - dx_max;
  const int r0 = blockIdx.y * kTileY - dy_max;
  for (int i = threadIdx.y * kTileX + threadIdx.x; i < tw * th;
       i += kTileX * kTileY) {
    const int r = r0 + i / tw;
    const int c = c0 + i % tw;
    const bool in = r >= 0 && r < h && c >= 0 && c < w;
    sk[i] = in ? keys[static_cast<size_t>(r) * w + c] : sentinel;
  }
  __syncthreads();
  const int r = blockIdx.y * kTileY + threadIdx.y;
  const int c = blockIdx.x * kTileX + threadIdx.x;
  if (r >= h || c >= w) return;
  const int tr = threadIdx.y + dy_max;
  const int tc = threadIdx.x + dx_max;
  const int32_t cur = sk[tr * tw + tc];
  bool dup = false;
  for (int dy = 0; dy <= dy_max; ++dy) {
    const int row = (tr - dy) * tw + tc;
    for (int dx = (dy == 0 ? 1 : -dx_max); dx <= dx_max; ++dx) {
      dup |= sk[row - dx] == cur;
    }
  }
  out[static_cast<size_t>(r) * w + c] = dup ? sentinel : cur;
}

constexpr int kMaxDy = 4;
constexpr int kMaxDx = 6;
constexpr int kRows = 2;                         // output rows a thread
constexpr int kCols = 128;                       // tile columns, a thread each
constexpr int kGroups = 4;                       // threads down a column
constexpr int kThreads = kCols * kGroups;        // 512
constexpr int kRowsTile = kRows * kGroups;       // 8
constexpr int kHalo = 8;                         // kMaxDx rounded up to 16 B
constexpr int kPitch = kCols + 2 * kHalo;        // 144
constexpr int kStageRows = kRowsTile + kMaxDy;   // 12
constexpr int kStage = kStageRows * kPitch;      // staged pixels

template <int DY>
__global__ void __launch_bounds__(kThreads)
prev_or_kernel(const int32_t* __restrict__ keys,
               const int32_t* __restrict__ words, int32_t* __restrict__ out,
               int h, int w, int dx_max, int32_t sentinel, bool vec) {
  __shared__ __align__(16) int32_t sk[kStage];
  __shared__ __align__(16) int32_t sw[kStage];
  const int tid = threadIdx.y * kCols + threadIdx.x;
  const int c0 = blockIdx.x * kCols;
  const int r0 = blockIdx.y * kRowsTile;
  const int sr0 = r0 - kMaxDy;   // grid row of staged row 0
  const int sc0 = c0 - kHalo;    // grid column of staged column 0
  bool word_nz = false;          // some staged word is not 0
  bool sent_word = false;        // some staged sentinel key has a word
  if (vec) {
    // w % 4 == 0 and sc0 % 4 == 0: each group of 4 lies inside or outside
    for (int i = tid; i < kStage / 4; i += kThreads) {
      const int r = sr0 + i / (kPitch / 4);
      const int c = sc0 + (i % (kPitch / 4)) * 4;
      int4 k = make_int4(sentinel, sentinel, sentinel, sentinel);
      int4 v = make_int4(0, 0, 0, 0);
      if (r >= 0 && r < h && c >= 0 && c < w) {
        const size_t g = static_cast<size_t>(r) * w + c;
        k = *reinterpret_cast<const int4*>(keys + g);
        v = *reinterpret_cast<const int4*>(words + g);
      }
      reinterpret_cast<int4*>(sk)[i] = k;
      reinterpret_cast<int4*>(sw)[i] = v;
      word_nz |= (v.x | v.y | v.z | v.w) != 0;
      sent_word |= (k.x == sentinel && v.x != 0) || (k.y == sentinel && v.y != 0) ||
                   (k.z == sentinel && v.z != 0) || (k.w == sentinel && v.w != 0);
    }
  } else {
    for (int i = tid; i < kStage; i += kThreads) {
      const int r = sr0 + i / kPitch;
      const int c = sc0 + i % kPitch;
      int32_t k = sentinel, v = 0;
      if (r >= 0 && r < h && c >= 0 && c < w) {
        const size_t g = static_cast<size_t>(r) * w + c;
        k = keys[g];
        v = words[g];
      }
      sk[i] = k;
      sw[i] = v;
      word_nz |= v != 0;
      sent_word |= k == sentinel && v != 0;
    }
  }
  const int c = c0 + threadIdx.x;
  const int rb = threadIdx.y * kRows;  // tile row of this thread's first output
  if (!__syncthreads_or(word_nz)) {
    if (c < w) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = r0 + rb + i;
        if (r < h) out[static_cast<size_t>(r) * w + c] = 0;
      }
    }
    return;
  }
  const bool sent_zero = !__syncthreads_or(sent_word);
  const int lc = threadIdx.x + kHalo;  // staged column of this thread's outputs
  int32_t cur[kRows];
  int32_t prev[kRows];
  bool live[kRows];
  bool any = false;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    cur[i] = sk[(rb + i + kMaxDy) * kPitch + lc];
    prev[i] = 0;
    live[i] = c < w && r0 + rb + i < h && !(sent_zero && cur[i] == sentinel);
    any |= live[i];
  }
  if (any) {
    const int srow = rb + kMaxDy - DY;  // staged row of window row j = 0
#pragma unroll
    for (int e = -kMaxDx; e <= kMaxDx; ++e) {
      if (e < -dx_max || e > dx_max) continue;
      // window row j holds neighbour (row - dy, column + e) of output
      // i = j - DY + dy; on the output's own row (dy = 0) only e < 0
#pragma unroll
      for (int j = 0; j < kRows + DY; ++j) {
        const int32_t kj = sk[(srow + j) * kPitch + lc + e];
        const int32_t wj = sw[(srow + j) * kPitch + lc + e];
#pragma unroll
        for (int i = (j > DY ? j - DY : 0); i <= (j < kRows - 1 ? j : kRows - 1); ++i) {
          if (i + DY - j == 0 && e >= 0) continue;
          if (live[i] && kj == cur[i]) prev[i] |= wj;
        }
      }
    }
  }
  if (c < w) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + rb + i;
      if (r < h) out[static_cast<size_t>(r) * w + c] = prev[i];
    }
  }
}

template <int DY>
void launch_prev_or(const int32_t* keys, const int32_t* words, int32_t* out,
                    int h, int w, int dx_max, int32_t sentinel,
                    cudaStream_t stream) {
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(words) % 16 == 0;
  const dim3 grid((w + kCols - 1) / kCols, (h + kRowsTile - 1) / kRowsTile);
  prev_or_kernel<DY><<<grid, dim3(kCols, kGroups), 0, stream>>>(
      keys, words, out, h, w, dx_max, sentinel, vec);
}

}  // namespace

extern "C" int rt3d_window_dedupe(const int32_t* keys, int32_t* out, int h,
                                  int w, int dy_max, int dx_max,
                                  int32_t sentinel, void* stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
  const size_t smem = static_cast<size_t>(kTileX + 2 * dx_max) *
                      (kTileY + dy_max) * sizeof(int32_t);
  dedupe_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      keys, out, h, w, dy_max, dx_max, sentinel);
  return static_cast<int>(cudaGetLastError());
}

// dy_max in [0, 4] and dx_max in [0, 6]; anything else is refused with
// cudaErrorInvalidValue (the wrapper raises before that).
extern "C" int rt3d_window_prev_or(const int32_t* keys, const int32_t* words,
                                   int32_t* out, int h, int w, int dy_max,
                                   int dx_max, int32_t sentinel,
                                   void* stream) {
  if (dx_max < 0 || dx_max > kMaxDx) return static_cast<int>(cudaErrorInvalidValue);
  if (h == 0 || w == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dy_max) {
    case 0: launch_prev_or<0>(keys, words, out, h, w, dx_max, sentinel, s); break;
    case 1: launch_prev_or<1>(keys, words, out, h, w, dx_max, sentinel, s); break;
    case 2: launch_prev_or<2>(keys, words, out, h, w, dx_max, sentinel, s); break;
    case 3: launch_prev_or<3>(keys, words, out, h, w, dx_max, sentinel, s); break;
    case 4: launch_prev_or<4>(keys, words, out, h, w, dx_max, sentinel, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
