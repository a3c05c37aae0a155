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
// Bound on the H100: bytes. Each pixel is read once and written once (K1:
// 8 B/pixel, K2: 12 B/pixel) against 58 integer compares, far below the
// card's ratio of operations to bytes. Design: one thread per pixel; a block
// stages its 32x8 tile plus a halo of dy_max rows above and dx_max columns
// each side in shared memory, so every global word is read about 1.5 times
// (halo overlap) instead of 58 times, with a warp reading 32 consecutive
// keys. The TPU kernel's row-block roll and all-sentinel skip are not
// needed: the skip never changes the output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;

template <bool kWords>
__global__ void window_kernel(const int32_t* __restrict__ keys,
                              const int32_t* __restrict__ words,
                              int32_t* __restrict__ out, int h, int w,
                              int dy_max, int dx_max, int32_t sentinel) {
  extern __shared__ int32_t smem[];
  const int tw = kTileX + 2 * dx_max;
  const int th = kTileY + dy_max;
  int32_t* sk = smem;
  int32_t* sw = smem + tw * th;
  const int c0 = blockIdx.x * kTileX - dx_max;
  const int r0 = blockIdx.y * kTileY - dy_max;
  for (int i = threadIdx.y * kTileX + threadIdx.x; i < tw * th;
       i += kTileX * kTileY) {
    const int r = r0 + i / tw;
    const int c = c0 + i % tw;
    const bool in = r >= 0 && r < h && c >= 0 && c < w;
    const size_t idx = static_cast<size_t>(r) * w + c;
    sk[i] = in ? keys[idx] : sentinel;
    if (kWords) sw[i] = in ? words[idx] : 0;
  }
  __syncthreads();
  const int r = blockIdx.y * kTileY + threadIdx.y;
  const int c = blockIdx.x * kTileX + threadIdx.x;
  if (r >= h || c >= w) return;
  const int tr = threadIdx.y + dy_max;
  const int tc = threadIdx.x + dx_max;
  const int32_t cur = sk[tr * tw + tc];
  bool dup = false;
  int32_t prev = 0;
  for (int dy = 0; dy <= dy_max; ++dy) {
    const int row = (tr - dy) * tw + tc;
    for (int dx = (dy == 0 ? 1 : -dx_max); dx <= dx_max; ++dx) {
      const bool same = sk[row - dx] == cur;
      if (kWords) {
        prev |= same ? sw[row - dx] : 0;
      } else {
        dup |= same;
      }
    }
  }
  const size_t o = static_cast<size_t>(r) * w + c;
  out[o] = kWords ? prev : (dup ? sentinel : cur);
}

template <bool kWords>
int launch(const int32_t* keys, const int32_t* words, int32_t* out, int h,
           int w, int dy_max, int dx_max, int32_t sentinel, void* stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
  const size_t smem = static_cast<size_t>(kTileX + 2 * dx_max) *
                      (kTileY + dy_max) * sizeof(int32_t) * (kWords ? 2 : 1);
  window_kernel<kWords><<<grid, block, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      keys, words, out, h, w, dy_max, dx_max, sentinel);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt3d_window_dedupe(const int32_t* keys, int32_t* out, int h,
                                  int w, int dy_max, int dx_max,
                                  int32_t sentinel, void* stream) {
  return launch<false>(keys, nullptr, out, h, w, dy_max, dx_max, sentinel,
                       stream);
}

extern "C" int rt3d_window_prev_or(const int32_t* keys, const int32_t* words,
                                   int32_t* out, int h, int w, int dy_max,
                                   int dx_max, int32_t sentinel,
                                   void* stream) {
  return launch<true>(keys, words, out, h, w, dy_max, dx_max, sentinel,
                      stream);
}
