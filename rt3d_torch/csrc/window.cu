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
// Bounds on the H100: integer operations on a dense grid (58 compares a
// live pixel, and for K2 an OR a matching neighbour, at 64 INT32 lanes a
// clock an SM) and bytes (8 a pixel for K1, 12 for K2). For K1 on the
// step's 360x640 grids both are about 0.5 us, below an empty kernel's
// launch: what the kernel can save is the latency of its busiest block.
//
// Both kernels are one staged-tile body, `window_kernel<OR, DY>`:
//  - A block of 128 x 4 threads owns a 128-column x 8-row tile; it stages
//    the tile with 4 rows above and 8 columns each side in static shared
//    memory (16-byte loads when the width is a multiple of 4 and the
//    pointers are aligned, 4-byte loads otherwise; out-of-grid pixels are
//    staged as key `sentinel`, word 0). Every index is a constant division.
//  - Exact block skip, tested while staging (one __syncthreads_or):
//    K1: when every key of the tile's own pixels is the sentinel, every
//    output is that sentinel whether or not it has a duplicate, and the
//    block writes it back. This is the Pallas kernel's all-sentinel
//    pass-through; 40 % of the step's tiles take it.
//    K2: when every staged word is 0, every output of the tile is 0
//    whatever the keys, and the block writes zeros. The TPU kernel skipped
//    all-sentinel key blocks, which is exact only where words under
//    sentinels are 0; this test needs no such promise.
//  - Exact pixel skip: a sentinel key needs no compare. For K1 its output is
//    the sentinel either way. For K2 it is 0 when no staged pixel pairs a
//    sentinel key with a non-zero word (the step's grids), tested once more.
//  - A thread owns kRows = 2 rows of one column. For each of the 13 column
//    offsets (a fully unrolled loop under the uniform runtime bound dx_max)
//    it walks the 2 + DY window rows once, loading each staged key (and K2's
//    word) a single time from shared memory and comparing it with every
//    output whose window holds it: 78 loads for 2 outputs at DY = 4, not 58
//    for each. K1 ORs the compare into a predicate ("found"), K2 ORs the
//    word in under it; neither is a load a compare.
// Two rows a thread, 16 warps a block: the blocks that hold live pixels set
// the time, and a short chain a thread finishes them soonest. Sweeps on the
// card (PERF.md) found 1, 2 and 4 rows a thread within the noise for K1, and
// a warp-uniform early exit once every lane has found a duplicate slower,
// even where 92 % of the live keys are duplicates: a warp holds 64 outputs,
// and one unique key among them keeps it walking.
// That body covers windows of at most 4 rows x 6 columns each side (the
// template covers each dy_max up to 4; dx_max is a uniform runtime bound).
// Any wider window (dy_max > 4 or dx_max > 6) takes `window_wide_kernel`:
// one thread an output pixel, reading its window straight from global
// memory through L1 and L2, the offsets clamped to the grid (a neighbour
// outside it counts as key `sentinel`, word 0: it changes no output). K1
// keeps the exact pixel skip of a sentinel key and stops at the first
// duplicate; K2 walks every pixel, since a sentinel key's output is the OR
// of the words under sentinel neighbours, which need not be 0. Its bound is
// the staged-tile body's (the compares the window's live keys need, at the
// INT32 rate, or the grid's bytes); reading each neighbour from L1 rather
// than a staged tile, it runs about 10x that bound (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

// K1 when OR is false (`words` unused), K2 when it is true.
template <bool OR, int DY>
__global__ void __launch_bounds__(kThreads)
window_kernel(const int32_t* __restrict__ keys,
              const int32_t* __restrict__ words, int32_t* __restrict__ out,
              int h, int w, int dx_max, int32_t sentinel, bool vec) {
  __shared__ __align__(16) int32_t sk[kStage];
  __shared__ __align__(16) int32_t sw[OR ? kStage : 4];
  const int tid = threadIdx.y * kCols + threadIdx.x;
  const int c0 = blockIdx.x * kCols;
  const int r0 = blockIdx.y * kRowsTile;
  const int sr0 = r0 - kMaxDy;   // grid row of staged row 0
  const int sc0 = c0 - kHalo;    // grid column of staged column 0
  // K1: some key of the tile's own pixels is live; K2: some staged word is
  // not 0
  bool work = false;
  bool sent_word = false;        // K2: some staged sentinel key has a word
  if (vec) {
    // w % 4 == 0 and sc0 % 4 == 0: each group of 4 lies inside or outside
    for (int i = tid; i < kStage / 4; i += kThreads) {
      const int sr = i / (kPitch / 4);
      const int sc = (i % (kPitch / 4)) * 4;
      const int r = sr0 + sr;
      const int c = sc0 + sc;
      int4 k = make_int4(sentinel, sentinel, sentinel, sentinel);
      int4 v = make_int4(0, 0, 0, 0);
      if (r >= 0 && r < h && c >= 0 && c < w) {
        const size_t g = static_cast<size_t>(r) * w + c;
        k = *reinterpret_cast<const int4*>(keys + g);
        if (OR) v = *reinterpret_cast<const int4*>(words + g);
      }
      reinterpret_cast<int4*>(sk)[i] = k;
      if (OR) {
        reinterpret_cast<int4*>(sw)[i] = v;
        work |= (v.x | v.y | v.z | v.w) != 0;
        sent_word |= (k.x == sentinel && v.x != 0) || (k.y == sentinel && v.y != 0) ||
                     (k.z == sentinel && v.z != 0) || (k.w == sentinel && v.w != 0);
      } else {
        const bool own = sr >= kMaxDy && sc >= kHalo && sc < kHalo + kCols;
        work |= own && (k.x != sentinel || k.y != sentinel || k.z != sentinel ||
                        k.w != sentinel);
      }
    }
  } else {
    for (int i = tid; i < kStage; i += kThreads) {
      const int sr = i / kPitch;
      const int sc = i % kPitch;
      const int r = sr0 + sr;
      const int c = sc0 + sc;
      int32_t k = sentinel, v = 0;
      if (r >= 0 && r < h && c >= 0 && c < w) {
        const size_t g = static_cast<size_t>(r) * w + c;
        k = keys[g];
        if (OR) v = words[g];
      }
      sk[i] = k;
      if (OR) {
        sw[i] = v;
        work |= v != 0;
        sent_word |= k == sentinel && v != 0;
      } else {
        work |= sr >= kMaxDy && sc >= kHalo && sc < kHalo + kCols && k != sentinel;
      }
    }
  }
  const int c = c0 + threadIdx.x;
  const int rb = threadIdx.y * kRows;  // tile row of this thread's first output
  if (!__syncthreads_or(work)) {
    if (c < w) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = r0 + rb + i;
        if (r < h) out[static_cast<size_t>(r) * w + c] = OR ? 0 : sentinel;
      }
    }
    return;
  }
  const bool sent_zero = !OR || !__syncthreads_or(sent_word);
  const int lc = threadIdx.x + kHalo;  // staged column of this thread's outputs
  int32_t cur[kRows];
  int32_t prev[kRows];  // K2's OR
  bool found[kRows];    // K1: a preceding window key equals cur
  bool live[kRows];
  bool any = false;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    cur[i] = sk[(rb + i + kMaxDy) * kPitch + lc];
    prev[i] = 0;
    found[i] = false;
    // K1's out-of-grid outputs were staged as the sentinel
    live[i] = (!OR || (c < w && r0 + rb + i < h)) && !(sent_zero && cur[i] == sentinel);
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
        const int32_t wj = OR ? sw[(srow + j) * kPitch + lc + e] : 0;
#pragma unroll
        for (int i = (j > DY ? j - DY : 0); i <= (j < kRows - 1 ? j : kRows - 1); ++i) {
          if (i + DY - j == 0 && e >= 0) continue;
          if (OR) {
            if (live[i] && kj == cur[i]) prev[i] |= wj;
          } else {
            found[i] |= kj == cur[i];  // a sentinel cur's output is the sentinel anyway
          }
        }
      }
    }
  }
  if (c < w) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + rb + i;
      if (r < h)
        out[static_cast<size_t>(r) * w + c] = OR ? prev[i] : (found[i] ? sentinel : cur[i]);
    }
  }
}

constexpr int kWideCols = 32;
constexpr int kWideRows = 8;

// K1 when OR is false (`words` unused), K2 when it is true; any dy_max,
// dx_max >= 0.
template <bool OR>
__global__ void __launch_bounds__(kWideCols * kWideRows)
window_wide_kernel(const int32_t* __restrict__ keys,
                   const int32_t* __restrict__ words, int32_t* __restrict__ out,
                   int h, int w, int dy_max, int dx_max, int32_t sentinel) {
  const int c = blockIdx.x * kWideCols + threadIdx.x;
  const int r = blockIdx.y * kWideRows + threadIdx.y;
  if (r >= h || c >= w) return;
  const size_t g = static_cast<size_t>(r) * w + c;
  const int32_t cur = __ldg(keys + g);
  if (!OR && cur == sentinel) {
    out[g] = sentinel;
    return;
  }
  const int c_lo = c - min(dx_max, c);
  const int c_hi = c + min(dx_max, w - 1 - c);
  const int r_lo = r - min(dy_max, r);
  bool found = false;
  int32_t prev = 0;
  for (int rr = r; rr >= r_lo && !found; --rr) {
    const size_t row = static_cast<size_t>(rr) * w;
    const int hi = rr == r ? c - 1 : c_hi;  // the own row: columns before c
    for (int cc = c_lo; cc <= hi; ++cc) {
      if (__ldg(keys + row + cc) == cur) {
        if (OR) {
          prev |= __ldg(words + row + cc);
        } else {
          found = true;
          break;
        }
      }
    }
  }
  out[g] = OR ? prev : (found ? sentinel : cur);
}

template <bool OR>
int launch_window(const int32_t* keys, const int32_t* words, int32_t* out,
                  int h, int w, int dy_max, int dx_max, int32_t sentinel,
                  void* stream) {
  if (dy_max < 0 || dx_max < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (h == 0 || w == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dy_max > kMaxDy || dx_max > kMaxDx) {
    const dim3 grid((w + kWideCols - 1) / kWideCols, (h + kWideRows - 1) / kWideRows);
    window_wide_kernel<OR><<<grid, dim3(kWideCols, kWideRows), 0, s>>>(
        keys, words, out, h, w, dy_max, dx_max, sentinel);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                   (!OR || reinterpret_cast<uintptr_t>(words) % 16 == 0);
  const dim3 grid((w + kCols - 1) / kCols, (h + kRowsTile - 1) / kRowsTile);
  const dim3 block(kCols, kGroups);
  switch (dy_max) {
#define RT3D_WINDOW_CASE(D)                                                  \
    case D:                                                                  \
      window_kernel<OR, D><<<grid, block, 0, s>>>(keys, words, out, h, w,    \
                                                  dx_max, sentinel, vec);    \
      break;
    RT3D_WINDOW_CASE(0)
    RT3D_WINDOW_CASE(1)
    RT3D_WINDOW_CASE(2)
    RT3D_WINDOW_CASE(3)
    RT3D_WINDOW_CASE(4)
#undef RT3D_WINDOW_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries take any dy_max >= 0 and dx_max >= 0 (the staged-tile body up
// to 4 x 6, the wide kernel beyond); a negative extent is refused with
// cudaErrorInvalidValue (the wrappers raise before that).
extern "C" int rt3d_window_dedupe(const int32_t* keys, int32_t* out, int h,
                                  int w, int dy_max, int dx_max,
                                  int32_t sentinel, void* stream) {
  return launch_window<false>(keys, nullptr, out, h, w, dy_max, dx_max,
                              sentinel, stream);
}

extern "C" int rt3d_window_prev_or(const int32_t* keys, const int32_t* words,
                                   int32_t* out, int h, int w, int dy_max,
                                   int dx_max, int32_t sentinel,
                                   void* stream) {
  return launch_window<true>(keys, words, out, h, w, dy_max, dx_max, sentinel,
                             stream);
}
