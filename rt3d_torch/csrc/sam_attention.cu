// SAM's image-encoder attention with decomposed relative positions
// (`Attention` with `use_rel_pos` in segment_anything's image_encoder.py),
// one launch a block call, on the qkv Linear's output as it lies.
//
// The plain version is `sam_attention_plain` (rt3d_torch/models/sam.py):
// for every window of (wh, ww) tokens of the (B, Hp, Wp) grid (a global
// block is one window of the whole grid) and every head,
//     logits[q, k] = scale (q . k) + rel_h[q, row(k)] + rel_w[q, col(k)],
//     rel_h[q, r] = q . R_h[row(q) - r + wh - 1],
//     rel_w[q, c] = q . R_w[col(q) - c + ww - 1]   (q unscaled),
// then softmax over the window's keys and the weighted sum of v. The tables
// are read as SAM reads them: their first 2 wh - 1 (2 ww - 1) rows, also
// when they were built for a larger size. Padded tokens of the grid are
// keys like any other.
//
// It replaces no TPU kernel: the JAX package has no SAM. Before it, the
// encoder built a (B, heads, N, N) bias in device memory by broadcast adds
// (1.07 GB in bf16 a global block), copied q, k and v out of the qkv
// Linear's output, handed the bias to cuDNN's fused attention and copied
// the windows back.
//
// Bound on the H100: a global block (N 4 096, 2 images x 16 heads) is
// operations: 172 GFLOP of q.k and p.v against 84 MB of qkv in and output
// out; a windowed block (N 196 in 50 windows x 16 heads) is bytes: 100 MB
// against 10 GFLOP. So the kernel reads every q, k and v element from the
// Linear's output through its strides and writes its output into the grid's
// (B, Hp, Wp, C) layout, finding each window by index arithmetic: no view is
// copied, and no N x N tensor reaches device memory. Both products run as
// Hopper's warpgroup MMA (wgmma, bf16 operands, fp32 sums): q and the
// probabilities from registers, k and v from shared memory, so that a key
// tile read from shared memory serves 64 query rows at once (a per-warp
// mma.sync would read it once for every 16, and shared memory bandwidth
// would bound the kernel). Softmax runs online in fp32 (flash-attention
// style); the probabilities are rounded to bf16 only as the operand of p.v.
//
// Design, one block of four warpgroups per (image, head, window, 256 query
// rows); each warp owns 16 query rows:
//  1. cp.async stages the warp's q rows and the two tables' rows (zero-filled
//     to a multiple of 16) in shared memory. Each warp keeps its q rows as
//     MMA operands in registers for the whole block, and multiplies them by
//     both tables (mma.sync, an extra 16 x 80 x 128 product at most), keeping
//     for each of its rows only the wh + ww terms that its keys read, in fp32,
//     scaled by log2(e).
//  2. Keys come in tiles of KT, in a ring of STAGES tiles that cp.async keeps
//     filled ahead of the MMAs (zero-filled past the window's last key), laid
//     out as wgmma's 8 x 16-byte core matrices. S = q.k^T, then each logit
//     gains its two terms from shared memory, keys past the window are
//     masked, and the running maximum, sum and output are rescaled as in
//     flash attention.
//  3. The output of each warp is divided by the row sums and stored as bf16
//     pairs into the grid.
// Tiles adapt to the shape: a window one grid row of 64 keys wide (a global
// block) takes tiles of one grid row, so a tile's row term is one value a
// query row; a narrower window (14 x 14: 196 keys) takes tiles of 32 keys,
// its whole window resident at once (7 tiles). Head dim 80 is five k16 steps
// of q.k and n80 for p.v.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHd = 80;              // head dim (ViT-H: 1280 / 16)
constexpr int kKSteps = kHd / 16;    // k16 steps of q . k
constexpr int kDBlocks = kHd / 8;    // n8 blocks of the output
constexpr int kChunks = kHd / 8;     // 16-byte chunks of a row
constexpr int kRow = kHd + 8;        // row stride of staged q and tables, in bf16: ldmatrix without conflicts
constexpr int kCore = 128;           // bytes of one core matrix: 8 rows of 16 bytes
constexpr int kGroup = kChunks * kCore;  // bytes of 8 key rows in core matrices
constexpr int kWarps = 16;           // four warpgroups
constexpr int kThreads = kWarps * 32;
constexpr int kQRows = kWarps * 16;  // query rows a block
constexpr int kMaxSide = 64;         // largest window side: tables of 127 rows
constexpr int kRowKt = 64, kRowStages = 4;  // a window 64 keys wide: a grid row a tile
constexpr int kKt = 32, kStages = 7;        // any other window
constexpr int kSmemMax = 232448;     // the H100's shared memory a block, in bytes
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* qkv;    // (B, Hp, Wp, 3, heads, kHd)
  const __nv_bfloat16* rel_h;  // (>= 2 wh - 1, kHd), or null: no relative terms
  const __nv_bfloat16* rel_w;  // (>= 2 ww - 1, kHd)
  __nv_bfloat16* out;          // (B, Hp, Wp, heads, kHd)
  int hp, wp, heads, wh, ww;
  int n;         // tokens a window, wh * ww
  int nwin_w;    // windows a grid row
  int nwin;      // windows an image
  int qtiles;    // blocks of kQRows query rows a window
  int ktiles;    // key tiles a window
  int sw;        // row stride of a warp's column terms, in floats
  int area;      // floats of shared memory a warp: its q rows, then its terms
  int warp_off;  // bytes: where the warps' areas start (after the key ring)
  int tab_off;   // bytes: where the tables are staged
  int tab_alias; // 1: the tables lie in the key ring, read before its first tile is loaded
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where `valid` is false (nothing read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// what this thread's cp.async wrote becomes visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A shared-memory matrix descriptor of wgmma without swizzle: the operand
// lies in core matrices of 8 rows x 16 bytes, `lbo` bytes apart along the
// reduced dimension (K) and `sbo` bytes apart along M or N. That holds for
// the K-major k tile (rows: keys; 16 bytes: 8 of the head dim) and for the
// N-major v tile (rows: keys, the reduced dimension of p.v; 16 bytes: 8 of
// the head dim, its N) alike, so both tiles share one layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from reading an accumulator before the wait above
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d (m64 x n32, fp32) (+)= a (m64 x k16, bf16 registers) . b (k16 x n32, bf16 in shared memory)
__device__ __forceinline__ void wgmma_n32(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (m64 x n64, fp32) (+)= a (m64 x k16, bf16 registers) . b (k16 x n64, bf16 in shared memory)
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (m64 x n80, fp32) (+)= a (m64 x k16, bf16 registers) . b (k16 x n80, bf16 in shared memory)
__device__ __forceinline__ void wgmma_n80_t(float (&d)[10][4], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// 2^x on the special-function unit; x <= 0 here, results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The warp's 16 q rows times a table's rows [0, rows_pad) (shared, zero
// past the table's 2 side - 1 rows): for each row r of the warp, the terms
// of key positions k = 0..side-1, term = q_r . R[pos(q_r) - k + side - 1] in
// log2 units, stored at dst[k * ks + r * rs]. `pa` and `pb` are the
// positions of the thread's rows g and g + 8.
__device__ __forceinline__ void table_terms(const uint32_t (&qf)[kKSteps][4],
                                            const __nv_bfloat16* r_s, int rows_pad, int side,
                                            int pa, int pb, float* dst, int ks, int rs, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int j0 = 0; j0 < rows_pad; j0 += 16) {
    float acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t b0, b1, b2, b3;
      const int row = j0 + (lane & 7) + ((lane >> 4) << 3);
      const int col = kk * 16 + ((lane >> 3) & 1) * 8;
      ldsm_x4(smem_u32(r_s + row * kRow + col), b0, b1, b2, b3);
      mma(acc[0], qf[kk], b0, b1);
      mma(acc[1], qf[kk], b2, b3);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + h * 8 + 2 * t + (e & 1);
        const int k = ((e >> 1) ? pb : pa) + side - 1 - j;
        if (k >= 0 && k < side) dst[k * ks + (g + (e >> 1) * 8) * rs] = acc[h][e] * kLog2e;
      }
    }
  }
}

// kRowTile: the window is KT keys wide, so key tile `it` is grid row `it`
// of the window and column c of a tile is column c of the window.
//
// Shared memory: the ring of STAGES key tiles, each its K then its V in
// core matrices (8 keys x 16 bytes; byte (key r, chunk c) at
// (r / 8) kGroup + c kCore + (r % 8) 16); then one area a warp, which holds
// the warp's 16 q rows until they sit in registers, then its terms:
// th[k * 16 + r], the row terms of its row r for key row k, and
// tw[r * sw + k], its column terms (sw is 8 modulo 32, so the float2 reads of
// a quad's columns meet no bank conflict); then the tables, unless they
// share the ring's memory.
template <int KT, int STAGES, bool kRowTile>
__global__ void __launch_bounds__(kThreads, 1) sam_rel_attention_fwd(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kTileBytes = KT * kHd * 2;  // K or V of one tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* th = reinterpret_cast<float*>(smem + p.warp_off) + warp * p.area;
  float* tw = th + p.wh * 16;
  __nv_bfloat16* q_w = reinterpret_cast<__nv_bfloat16*>(th);
  const __nv_bfloat16* tab_s = reinterpret_cast<const __nv_bfloat16*>(smem + p.tab_off);

  // the q tiles, then the heads of a window run side by side: together
  // they read its tokens' qkv rows whole
  int idx = blockIdx.x;
  const int tile = idx % p.qtiles;
  idx /= p.qtiles;
  const int head = idx % p.heads;
  idx /= p.heads;
  const int win = idx % p.nwin;
  const int b = idx / p.nwin;
  const int y0 = (win / p.nwin_w) * p.wh, x0 = (win % p.nwin_w) * p.ww;
  const int c = p.heads * kHd;
  const long long tok = 3LL * c;  // elements a token of qkv
  const long long img = static_cast<long long>(p.hp) * p.wp;
  const __nv_bfloat16* base = p.qkv + b * img * tok + head * kHd;
  // the grid token of window index i, counted from the image's first
  auto token = [&](int i) -> long long {
    return static_cast<long long>(y0 + i / p.ww) * p.wp + x0 + i % p.ww;
  };

  auto load_kv = [&](int it) {
    unsigned char* st = smem + (it % STAGES) * 2 * kTileBytes;
    for (int ci = tid; ci < 2 * KT * kChunks; ci += kThreads) {
      const int part = ci / (KT * kChunks);  // 0: K, 1: V
      const int rc = ci - part * KT * kChunks;
      const int r = rc / kChunks, ch = rc % kChunks;
      const int i = it * KT + r;
      const bool ok = kRowTile || i < p.n;
      const long long at =
          kRowTile ? static_cast<long long>(y0 + it) * p.wp + x0 + r : (ok ? token(i) : 0);
      cp_async16(smem_u32(st + part * kTileBytes + (r >> 3) * kGroup + ch * kCore + (r & 7) * 16),
                 base + at * tok + (1 + part) * c + ch * 8, ok);
    }
  };
  auto load_ring = [&]() {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < p.ktiles) load_kv(s);
      cp_async_commit();
    }
  };

  // 1. the warp's q rows and the tables; the first key tiles too where the
  // tables have memory of their own
  const int q0 = tile * kQRows + warp * 16;
  for (int ci = lane; ci < 16 * kChunks; ci += 32) {
    const int r = ci / kChunks, ch = ci % kChunks;
    const int i = q0 + r;
    const bool ok = i < p.n;
    cp_async16(smem_u32(q_w + r * kRow + ch * 8), base + (ok ? token(i) : 0) * tok + ch * 8, ok);
  }
  const bool rel = p.rel_h != nullptr;
  const int rows_h = 2 * p.wh - 1, rows_w = 2 * p.ww - 1;
  const int pad_h = (rows_h + 15) & ~15, pad_w = (rows_w + 15) & ~15;
  if (rel) {
    for (int ci = tid; ci < (pad_h + pad_w) * kChunks; ci += kThreads) {
      const int r = ci / kChunks, ch = ci % kChunks;
      const bool is_h = r < pad_h;
      const int j = is_h ? r : r - pad_h;
      const bool ok = j < (is_h ? rows_h : rows_w);
      const __nv_bfloat16* src = (is_h ? p.rel_h : p.rel_w) + (ok ? j : 0) * kHd + ch * 8;
      cp_async16(smem_u32(tab_s + r * kRow + ch * 8), src, ok);
    }
  }
  cp_async_commit();
  if (p.tab_alias) {
    cp_async_wait<0>();
  } else {
    load_ring();
    cp_async_wait<STAGES - 1>();
  }
  __syncthreads();

  uint32_t qf[kKSteps][4];
  {
    const int r = lane & 15;
    const int col = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
      ldsm_x4(smem_u32(q_w + r * kRow + kk * 16 + col), qf[kk][0], qf[kk][1], qf[kk][2],
              qf[kk][3]);
  }
  __syncwarp();  // the q rows are in registers: the terms overwrite them
  // rows past the window hold zero q; their positions are the last token's
  const int qa = min(q0 + g, p.n - 1), qb = min(q0 + g + 8, p.n - 1);
  if (rel) {
    table_terms(qf, tab_s, pad_h, p.wh, qa / p.ww, qb / p.ww, th, 16, 1, lane);
    table_terms(qf, tab_s + pad_h * kRow, pad_w, p.ww, qa % p.ww, qb % p.ww, tw, 1, p.sw, lane);
  } else {
    for (int i = lane; i < p.wh * 16 + 16 * p.sw; i += 32) th[i] = 0.f;
  }
  __syncthreads();  // the tables are read before a key tile overwrites them
  if (p.tab_alias) load_ring();

  float o[kDBlocks][4];
#pragma unroll
  for (int d = 0; d < kDBlocks; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int it = 0; it < p.ktiles; ++it) {
    // tile `it` has landed, and every warpgroup is done with tile it - 1,
    // whose stage now takes tile it + STAGES - 1
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    if (it + STAGES - 1 < p.ktiles) load_kv(it + STAGES - 1);
    cp_async_commit();
    const uint32_t k_s = smem_u32(smem + (it % STAGES) * 2 * kTileBytes);
    const uint32_t v_s = k_s + kTileBytes;
    const int k0 = it * KT;
    const int nvalid = kRowTile ? KT : min(KT, p.n - k0);

    // 2. S = q . k^T over the tile, the warpgroup's 64 rows at once
    float s[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const uint64_t desc = smem_desc(k_s + kk * 2 * kCore, kCore, kGroup);
      if constexpr (KT == 64)
        wgmma_n64(s, qf[kk], desc, 1);
      else
        wgmma_n32(s, qf[kk], desc, 1);
    }
    wgmma_commit_wait();
    fence_regs(s);

    // the logits in log2 units with their relative terms, keys past the
    // window masked. A thread's keys come in pairs (2t, 2t + 1) of one
    // grid row (the window's width is even)
    if constexpr (kRowTile) {
      const float ha = th[it * 16 + g], hb = th[it * 16 + g + 8];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        const float2 wa = *reinterpret_cast<const float2*>(tw + g * p.sw + j * 8 + 2 * t);
        const float2 wb = *reinterpret_cast<const float2*>(tw + (g + 8) * p.sw + j * 8 + 2 * t);
        s[j][0] = fmaf(s[j][0], p.scale_log2, ha + wa.x);
        s[j][1] = fmaf(s[j][1], p.scale_log2, ha + wa.y);
        s[j][2] = fmaf(s[j][2], p.scale_log2, hb + wb.x);
        s[j][3] = fmaf(s[j][3], p.scale_log2, hb + wb.y);
      }
    } else {
      int ky = (k0 + 2 * t) / p.ww, kx = (k0 + 2 * t) % p.ww;
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        if (j * 8 + 2 * t < nvalid) {
          const float ha = th[ky * 16 + g], hb = th[ky * 16 + g + 8];
          const float2 wa = *reinterpret_cast<const float2*>(tw + g * p.sw + kx);
          const float2 wb = *reinterpret_cast<const float2*>(tw + (g + 8) * p.sw + kx);
          s[j][0] = fmaf(s[j][0], p.scale_log2, ha + wa.x);
          s[j][1] = fmaf(s[j][1], p.scale_log2, ha + wa.y);
          s[j][2] = fmaf(s[j][2], p.scale_log2, hb + wb.x);
          s[j][3] = fmaf(s[j][3], p.scale_log2, hb + wb.y);
        } else {
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = -INFINITY;
        }
        kx += 8;
        while (kx >= p.ww) {
          kx -= p.ww;
          ++ky;
        }
      }
    }

    // online softmax: each row lives in the 4 lanes of a quad
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int sh = 1; sh < 4; sh <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
    }
    const float ua = mx_a == -INFINITY ? 0.f : mx_a, ub = mx_b == -INFINITY ? 0.f : mx_b;
    const float ca = exp2_ftz(m_a - ua), cb = exp2_ftz(m_b - ub);
    m_a = mx_a;
    m_b = mx_b;
    l_a *= ca;
    l_b *= cb;
#pragma unroll
    for (int d = 0; d < kDBlocks; ++d) {
      o[d][0] *= ca;
      o[d][1] *= ca;
      o[d][2] *= cb;
      o[d][3] *= cb;
    }
    uint32_t pf[KT / 16][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      s[j][0] = exp2_ftz(s[j][0] - ua);
      s[j][1] = exp2_ftz(s[j][1] - ua);
      s[j][2] = exp2_ftz(s[j][2] - ub);
      s[j][3] = exp2_ftz(s[j][3] - ub);
      l_a += s[j][0] + s[j][1];
      l_b += s[j][2] + s[j][3];
      pf[j >> 1][(j & 1) * 2] = pack_bf16(s[j][0], s[j][1]);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
    }

    // O += P . V over the tile's 16-key steps that hold a key
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      if (kRowTile || kk * 16 < nvalid)
        wgmma_n80_t(o, pf[kk], smem_desc(v_s + kk * 2 * kGroup, kGroup, kCore), 1);
    }
    wgmma_commit_wait();
    fence_regs(o);
  }

  // 3. the rows' sums across the quad, then the output into the grid
#pragma unroll
  for (int sh = 1; sh < 4; sh <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
  }
  const float ia = 1.f / l_a, ib = 1.f / l_b;
  __nv_bfloat16* out = p.out + b * img * c + head * kHd + 2 * t;
  const int ra = q0 + g, rb = ra + 8;
  if (ra < p.n) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + token(ra) * c);
#pragma unroll
    for (int d = 0; d < kDBlocks; ++d) dst[d * 4] = pack_bf16(o[d][0] * ia, o[d][1] * ia);
  }
  if (rb < p.n) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + token(rb) * c);
#pragma unroll
    for (int d = 0; d < kDBlocks; ++d) dst[d * 4] = pack_bf16(o[d][2] * ib, o[d][3] * ib);
  }
}

// Lays out the shared memory of a launch with tiles of `kt` keys in a ring
// of `stages`; false if it does not fit.
bool layout(Params& p, int kt, int stages, bool rel, size_t& smem) {
  const int ring = stages * 2 * kt * kHd * 2;
  const int q_floats = 16 * kRow * 2 / 4;
  p.area = (max(q_floats, p.wh * 16 + 16 * p.sw) + 3) & ~3;
  p.warp_off = ring;
  const int warps = kWarps * p.area * 4;
  const int rows = ((2 * p.wh - 1 + 15) & ~15) + ((2 * p.ww - 1 + 15) & ~15);
  const int tables = rel ? rows * kRow * 2 : 0;
  if (ring + warps + tables <= kSmemMax) {
    p.tab_alias = 0;
    p.tab_off = ring + warps;
    smem = ring + warps + tables;
    return true;
  }
  p.tab_alias = 1;
  p.tab_off = 0;
  smem = ring + warps;
  return tables <= ring && static_cast<int>(smem) <= kSmemMax;
}

template <int KT, int STAGES, bool kRowTile>
cudaError_t launch(const Params& p, long long blocks, size_t smem, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(sam_rel_attention_fwd<KT, STAGES, kRowTile>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  sam_rel_attention_fwd<KT, STAGES, kRowTile><<<static_cast<unsigned>(blocks), kThreads, smem,
                                                static_cast<cudaStream_t>(stream)>>>(p);
  return cudaSuccess;
}

}  // namespace

// qkv (B, Hp, Wp, 3 * heads * 80) and out (B, Hp, Wp, heads * 80), bf16,
// contiguous; windows of wh x ww tokens (Hp % wh == Wp % ww == 0, sides at
// most 64, ww even; a global block passes wh = Hp, ww = Wp); rel_h and rel_w
// contiguous bf16 tables of 80 columns and at least 2 wh - 1 (2 ww - 1)
// rows, or both null. The wrapper (rt3d_torch/models/sam.py) checks all of
// it.
extern "C" int rt3d_sam_attention(const void* qkv, const void* rel_h, const void* rel_w, void* out,
                                  int b, int hp, int wp, int heads, int wh, int ww, float scale,
                                  void* stream) {
  if (wh < 1 || ww < 2 || wh > kMaxSide || ww > kMaxSide || ww % 2 || hp % wh || wp % ww)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.qkv = static_cast<const __nv_bfloat16*>(qkv);
  p.rel_h = static_cast<const __nv_bfloat16*>(rel_h);
  p.rel_w = static_cast<const __nv_bfloat16*>(rel_w);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.hp = hp;
  p.wp = wp;
  p.heads = heads;
  p.wh = wh;
  p.ww = ww;
  p.n = wh * ww;
  p.nwin_w = wp / ww;
  p.nwin = (hp / wh) * p.nwin_w;
  p.qtiles = (p.n + kQRows - 1) / kQRows;
  p.scale_log2 = scale * kLog2e;
  p.sw = (ww + 23) / 32 * 32 + 8;
  // a window one grid row of 64 keys wide takes a grid row a tile
  const bool row_tile = ww == kRowKt;
  const int kt = row_tile ? kRowKt : kKt;
  p.ktiles = (p.n + kt - 1) / kt;
  size_t smem = 0;
  if (!layout(p, kt, row_tile ? kRowStages : kStages, rel_h != nullptr, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(b) * heads * p.nwin * p.qtiles;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t e = row_tile ? launch<kRowKt, kRowStages, true>(p, blocks, smem, stream)
                                 : launch<kKt, kStages, false>(p, blocks, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
