// Tensor-core building blocks shared by the bf16 instantiations of K2
// (window_attn.cu) and K2b (window_attn_bwd.cu).
//
// A (window, head) tile is n <= 64 tokens of HD channels (K2's long-window
// body, window_attn.cu, stages 144 rows the same way). It is staged in
// shared memory as 64 rows of bf16 (rows n..63 stay zero) with a row stride
// of HD + 8 elements: 16 bytes of padding put the eight 16-byte rows of
// every ldmatrix phase in eight different bank groups, so fragment loads
// are conflict-free (HD = 32: 80-byte rows land on 0, 80, 32, 112, 64, 16,
// 96, 48 mod 128). The rows come in with 16-byte cp.async copies, which is
// why the wrapper demands 16-byte aligned bases and strides.
//
// Products are mma.sync.m16n8k16 (bf16 in, f32 accumulate). wgmma was not
// taken: a tile is one 64 x 64 x 32 product, too small to amortise the
// descriptor set-up and the warpgroup-wide waits, and mma.sync keeps S and P
// in the registers of the warp that owns the rows, so the softmax and the
// P v product need no shared-memory round trip. One warp owns 16 query rows,
// four warps the padded tile. With g = lane / 4, t = lane % 4 the fragments
// hold (PTX ISA, mma.m16n8k16 with .bf16):
//   A (16 x 16): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                a3 (g+8, 2t+8..)
//   B (16 x 8):  b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8.., n = g)
//   C (16 x 8):  c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// so two neighbouring C tiles of S, rounded to bf16, are one A fragment of
// the next product: {c0c1 of tile 2j, c2c3 of 2j, c0c1 of 2j+1, c2c3 of 2j+1}.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "philox.cuh"

#define WTC_THREADS 128
#define WTC_ROWS 64  // padded tokens of a tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices; lane l gives the row address of row l % 8 of
// matrix l / 8 and receives elements (l / 4, 2 (l % 4)..+1) of each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed on the way in
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b, 16 x 8 x 16, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest even, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [0, n) of one tile, global (row stride in elements) -> shared (row
// stride HD + 8), 16 bytes a thread
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int n) {
  constexpr int CH = HD / 8;
  for (int c = threadIdx.x; c < n * CH; c += WTC_THREADS) {
    const int i = c / CH, j = c - i * CH;
    cp_async16(smem_u32(dst + i * (HD + 8) + j * 8),
               src + i * row_stride + j * 8);
  }
}

// S accumulators of this warp's 16 rows over the NT * 8 padded keys (64
// unless given): acc += a_tile[16 warp rows] b_tile^T, both tiles
// row-major (rows, HD)
template <int HD, int NT = 8>
__device__ __forceinline__ void mma_rows_by_rows(float (&acc)[NT][4],
                                                 const __nv_bfloat16* a_tile,
                                                 const __nv_bfloat16* b_tile,
                                                 int warp, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, smem_u32(a_tile +
                        (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                        ks * 16 + 8 * (lane >> 4)));
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t b[4];
      ldsm_x4(b, smem_u32(b_tile +
                          (nt * 8 + (lane & 7) + 8 * (lane >> 4)) * LD +
                          ks * 16 + 8 * ((lane >> 3) & 1)));
      mma_bf16(acc[nt], a, b[0], b[1]);
      mma_bf16(acc[nt + 1], a, b[2], b[3]);
    }
  }
}

// out (16 x HD) += A b_tile with A (16 x 16 KK) given as KK bf16 A
// fragments (four unless given) over the 16 KK padded rows of b_tile
// (row-major (16 KK, HD), read transposed)
template <int HD, int KK = 4>
__device__ __forceinline__ void mma_frag_by_tile(float (&out)[HD / 8][4],
                                                 const uint32_t (&a)[KK][4],
                                                 const __nv_bfloat16* b_tile,
                                                 int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
    for (int nt = 0; nt < HD / 8; nt += 2) {
      uint32_t b[4];
      ldsm_x4_trans(
          b, smem_u32(b_tile +
                      (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                      (nt + (lane >> 4)) * 8));
      mma_bf16(out[nt], a[kk], b[0], b[1]);
      mma_bf16(out[nt + 1], a[kk], b[2], b[3]);
    }
  }
}

// the C tiles of a 16 x 16 KK f32 block (16 x 64 unless given) as the KK A
// fragments of the next product, rounded to bf16
template <int KK = 4>
__device__ __forceinline__ void c_to_a_frags(uint32_t (&a)[KK][4],
                                             const float (&c)[2 * KK][4]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

static __device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

static __device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// bias[h] in the C layout of this thread's rows r0 = 16 warp + g and
// r0 + 8; a padded key column (>= n) gets -inf, a padded query row 0
__device__ __forceinline__ void load_bias_frag(float (&s)[8][4],
                                               const float* __restrict__ bh,
                                               int n, int r0, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = r0 + 8 * (c >> 1), col = nt * 8 + 2 * t + (c & 1);
      s[nt][c] = col >= n ? -INFINITY : row < n ? bh[row * n + col] : 0.f;
    }
  }
}

// The f32 mask tile of a window is staged like q, k, v, so that its device
// memory latency hides behind the previous window's arithmetic. A tile
// (n * n floats, n odd) starts on a 4-byte boundary only, so the copy starts
// at the 16-byte boundary below it: 16-byte cp.async chunks bring the tile
// in flat, `shift` = 0..3 floats into the staged buffer (the floats before
// it belong to the previous window's tile; the last chunk of the last tile
// is cut at the end of the mask with cp.async's zero fill). The buffer has
// 64 zero floats of slack behind the chunks: a fragment read of a padded
// key column (whose score is -inf whatever is added) runs into the next
// rows or into that slack, never out of the buffer.
__host__ __device__ __forceinline__ int mask_stage_floats(int n) {
  return (n * n + 6) / 4 * 4 + 64;
}

__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

// mask: the whole (nW, n, n) array, 16-byte aligned; first: the float index
// of this window's tile; total: nW * n * n. Returns nothing; the tile
// starts at dst + (first & 3).
__device__ __forceinline__ void load_mask_tile(float* dst,
                                               const float* __restrict__ mask,
                                               long long first,
                                               long long total, int n) {
  const int shift = (int)(first & 3);
  const long long start = first - shift;
  const int chunks = (shift + n * n + 3) >> 2;
  for (int c = threadIdx.x; c < chunks; c += WTC_THREADS) {
    const long long left = total - (start + 4 * c);
    cp_async16_zfill(smem_u32(dst + 4 * c), mask + start + 4 * c,
                     left >= 4 ? 16 : (int)left * 4);
  }
}

// zero what the chunks of a stage may leave unwritten (they cover at least
// n * n floats): the stage's last 72 floats, in both stages
__device__ __forceinline__ void zero_mask_slack(float* smask, int mstage) {
  const int first = mstage > 72 ? mstage - 72 : 0;
  const int count = mstage - first;
  for (int i = threadIdx.x; i < 2 * count; i += WTC_THREADS)
    smask[(i / count) * mstage + first + i % count] = 0.f;
}

// s += the staged mask tile (stile: its first float), in the C layout.
// Rows >= n are not staged and add nothing; columns >= n add whatever
// follows in the buffer to a score that is -inf already.
__device__ __forceinline__ void add_mask_frag(float (&s)[8][4],
                                              const float* stile, int n,
                                              int r0, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row < n) {
      const float* m = stile + row * n + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][2 * half] += m[nt * 8];
        s[nt][2 * half + 1] += m[nt * 8 + 1];
      }
    }
  }
}

// zero rows [n, 64) of `tiles` consecutive staged bf16 tiles (row stride
// HD + 8): the copies never write them, the products read them
template <int HD>
__device__ __forceinline__ void zero_pad_rows(__nv_bfloat16* tiles_base,
                                              int tiles, int n) {
  constexpr int LD = HD + 8;
  const int per_tile = (WTC_ROWS - n) * LD / 8;  // 16-byte stores
  for (int i = threadIdx.x; i < tiles * per_tile; i += WTC_THREADS) {
    const int tile = i / per_tile, j = i - tile * per_tile;
    reinterpret_cast<uint4*>(tiles_base + tile * WTC_ROWS * LD + n * LD)[j] =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// softmax over the 64 padded keys of rows r0 and r0 + 8, in place:
// s <- exp(s - rowmax) / rowsum (padded columns, at -inf, give 0). The
// exponential is ex2.approx of a pre-scaled argument and the division one
// reciprocal per row: both within a few f32 ulps, far inside the bf16
// rounding of P that follows.
__device__ __forceinline__ void softmax_rows(float (&s)[8][4]) {
  constexpr float LOG2E = 1.4426950408889634f;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
    m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
  }
  m0 = quad_max(m0) * LOG2E;
  m1 = quad_max(m1) * LOG2E;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = exp2f(fmaf(s[nt][0], LOG2E, -m0));
    s[nt][1] = exp2f(fmaf(s[nt][1], LOG2E, -m0));
    s[nt][2] = exp2f(fmaf(s[nt][2], LOG2E, -m1));
    s[nt][3] = exp2f(fmaf(s[nt][3], LOG2E, -m1));
    l0 += s[nt][0] + s[nt][1];
    l1 += s[nt][2] + s[nt][3];
  }
  l0 = 1.f / quad_sum(l0);
  l1 = 1.f / quad_sum(l1);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] *= l0;
    s[nt][1] *= l0;
    s[nt][2] *= l1;
    s[nt][3] *= l1;
  }
}

// the keep bits (philox.cuh) of this thread's 32 entries of a 16 x 64 C
// block, entry [nt][c] at bit 4 nt + c, for the tile whose element (0, 0)
// has flat index `base`; padded rows and columns are not kept
__device__ __forceinline__ uint32_t dropout_bits(const Dropout& d,
                                                 unsigned long long base,
                                                 int n, int r0, int t) {
  uint32_t bits = 0u;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = r0 + 8 * (c >> 1), col = nt * 8 + 2 * t + (c & 1);
      if (row < n && col < n && dropout_keep(d, base + row * n + col))
        bits |= 1u << (4 * nt + c);
    }
  return bits;
}

// s <- s / (1 - p) where kept, else 0
__device__ __forceinline__ void apply_dropout(float (&s)[8][4], uint32_t bits,
                                              float scale) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s[nt][c] = (bits >> (4 * nt + c)) & 1u ? s[nt][c] * scale : 0.f;
}

// a (16 x HD) C block -> rows r0, r0 + 8 (where < n) of a contiguous
// (n, HD) bf16 tile in device memory, times alpha
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* tile,
                                           const float (&c)[HD / 8][4],
                                           float alpha, int n, int r0,
                                           int t) {
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(tile + r0 * HD + col) =
          pack_bf16(c[nt][0] * alpha, c[nt][1] * alpha);
    if (r0 + 8 < n)
      *reinterpret_cast<uint32_t*>(tile + (r0 + 8) * HD + col) =
          pack_bf16(c[nt][2] * alpha, c[nt][3] * alpha);
  }
}
