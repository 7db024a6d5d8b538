// K2: Swin window attention forward, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel rscotr_tpu/ops/pallas/window_attention.py
// (window_attention_fused, body _kernel):
//   out[b,w,h] = softmax(scale * q k^T + rel_bias[h] + shift_mask[w]) v
// for every (image, window, head). The output is written in q's dtype.
//
// What bounds it on the card: bytes. A tile is tiny (n = 49 tokens, hd = 32:
// 0.3 MFLOP over 9.4 KB of q, k, v in bf16 plus a 9.6 KB f32 mask tile), so
// the floor is moving q, k, v, the mask and the output once: 39.7 MB at the
// det 800^2 stage 0 (841 windows x 3 heads), 0.012 ms at 3.35 TB/s, against
// under 0.001 ms for its 0.78 GFLOP on the tensor cores.
//
// Three instantiations behind the one entry point, chosen by the wrapper
// from dtype, shape and alignment (run > 0 selects one of the first two,
// by n):
//
// * bf16, n <= 64, hd 32 or 64, 16-byte aligned rows: the tensor-core
//   kernel, which computes what the Pallas body computes (both products on
//   the matrix unit with f32 accumulation, P rounded to v's dtype before
//   P v). A block of four warps owns a tile padded to 64 rows, one warp 16
//   query rows, and walks a run of consecutive windows of one head, so the
//   bias fragment is loaded once per block. q, k, v rows arrive by 16-byte
//   cp.async into a padded shared tile, and the window's f32 mask tile
//   beside them (flat, from the 16-byte boundary below its start),
//   double-buffered: the next window's rows are in flight while this one
//   is computed. S = q k^T by mma.sync.m16n8k16 from ldmatrix fragments (window_attn_tc.cuh has the
//   layouts), then s * scale + bias + mask in f32 in the accumulator's own
//   layout (the scale is applied to the f32 product, not to q), the padded
//   key columns 49..63 at -inf as the Pallas body masks its padding, row max
//   and sum by quad shuffles, and P, still in registers, rounded to bf16, is
//   the A operand of P v. No f32 copy of q, k, v and no score row ever
//   touches shared memory. Padded query rows are computed and never stored.
// * bf16, 64 < n <= 144 (windows 9 to 12: Swin-L's 12 x 12), hd 32, the
//   same alignment: the long-window tensor-core kernel
//   (window_attn_tc144_kernel). A tile is padded to 144 rows, nine warps of
//   16 query rows, and each warp holds its rows' scores over all 144 keys
//   in registers (18 C tiles), so the softmax needs no second pass. The
//   bias and mask no longer fit the registers as at n <= 64, and a 144^2
//   f32 tile of each is 83 KB, four times a tile's q, k, v and output: a
//   block therefore owns one (window, head) and walks a run of IMAGES of it,
//   loading bias[h] + mask[w] once, summed in f32, into registers in the C
//   layout (72 a thread beside the 72 scores; padded key columns -inf,
//   padded query rows 0), where every image of the run adds it. Per image
//   only q, k, v (by cp.async, three buffers in flight) and the output
//   move; the heads of a window are neighbouring blocks. The softmax
//   carries log2(e) in the scale and the bias, so an element costs one
//   subtraction and one ex2 (ftz); P's bf16 rounding and P v are as in the
//   n <= 64 kernel. What bounds it is the softmax's elementwise work
//   beside the bytes: 20,736 exponentials a tile against 37 KB moved
//   (PERF.md).
// * f32 inputs (full f32 arithmetic), and bf16 shapes outside the above:
//   the CUDA-core kernel below, one block per (image * window, head) with
//   q, k, v and the bias + mask tile as f32 in shared memory and each warp
//   owning whole query rows; its QK and PV loops load both FMA operands from
//   shared memory, which caps it near 1/8 of the f32 rate (PERF.md).
//
// Attention dropout (Swin's attn_drop_rate in training): every body has a
// DROP instantiation, taken at launch when the rate is above 0, that
// multiplies P by keep / (1 - p) after the softmax and before P v, the keep
// bits regenerated from the call's seed (philox.cuh); in bf16 P' = P keep /
// (1 - p) is what is rounded to the operand. Rate 0 launches the bodies
// above, compiled as they were.
//
// q, k, v may be strided views of the fused qkv projection (no copies);
// the output is contiguous (B, nW, H, n, hd).
#include <math.h>

#include "common.cuh"
#include "window_attn_tc.cuh"

#define WA_THREADS 128

// ---- CUDA-core instantiation (f32, and bf16 outside the tensor-core shapes)

template <typename T, bool DROP>
__global__ void __launch_bounds__(WA_THREADS) window_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    Strides qs, Strides ks, Strides vs,
    const float* __restrict__ rel_bias,  // (H, n, n)
    const float* __restrict__ mask,      // (nW, n, n) or nullptr
    T* __restrict__ out,                 // (B * nW, H, n, hd)
    int H, int nW, int n, int hd, float scale, Dropout drop) {
  extern __shared__ float smem[];
  const int kst = hd + 1;
  float* sq = smem;                 // n * hd, pre-scaled
  float* sk = sq + n * hd;          // n * (hd + 1)
  float* sv = sk + n * kst;         // n * hd
  float* sbm = sv + n * hd;         // n * n, bias + mask
  float* sp = sbm + n * n;          // (threads / 32) * n, one row per warp

  const long long bw = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int w = (int)(bw % nW);
  const T* qb = q + bw * qs.b + h * qs.h;
  const T* kb = k + bw * ks.b + h * ks.h;
  const T* vb = v + bw * vs.b + h * vs.h;
  for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
    const int i = idx / hd, d = idx - i * hd;
    sq[idx] = to_f32(qb[i * qs.n + d]) * scale;
    sk[i * kst + d] = to_f32(kb[i * ks.n + d]);
    sv[idx] = to_f32(vb[i * vs.n + d]);
  }
  const float* bh = rel_bias + (long long)h * n * n;
  const float* mw = mask ? mask + (long long)w * n * n : nullptr;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x)
    sbm[idx] = mw ? bh[idx] + mw[idx] : bh[idx];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float* prow = sp + warp * n;
  T* ob = out + (bw * H + h) * (long long)n * hd;
  for (int i = warp; i < n; i += nwarps) {
    const float* qi = sq + i * hd;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kj = sk + j * kst;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += qi[d] * kj[d];
      s += sbm[i * n + j];
      prow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(prow[j] - mx);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    // P (P' under dropout) in v's dtype before P v, as the tensor-core
    // kernel and the Pallas body round it (the identity for f32)
    const unsigned long long row0 = ((bw * H + h) * n + i) * (long long)n;
    for (int j = lane; j < n; j += 32) {
      const float p = prow[j] / sum;
      prow[j] = round_as<T>(DROP ? p * dropout_factor(drop, row0 + j) : p);
    }
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float o = 0.f;
      for (int j = 0; j < n; ++j) o += prow[j] * sv[j * hd + d];
      ob[i * hd + d] = from_f32<T>(o);
    }
    __syncwarp();
  }
}

static size_t smem_bytes(int n, int hd) {
  return sizeof(float) *
         ((size_t)n * hd * 2 + (size_t)n * (hd + 1) + (size_t)n * n +
          (size_t)(WA_THREADS / 32) * n);
}

template <typename T, bool DROP>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const long long* st, const float* rel_bias,
                          const float* mask, void* out, int BW, int H, int nW,
                          int n, int hd, float scale, Dropout drop,
                          cudaStream_t stream) {
  const size_t smem = smem_bytes(n, hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_attn_kernel<T, DROP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]};
  window_attn_kernel<T, DROP><<<(unsigned)((long long)BW * H), WA_THREADS,
                                smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qs, ks, vs, rel_bias, mask,
      static_cast<T*>(out), H, nW, n, hd, scale, drop);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_any(const void* q, const void* k, const void* v,
                              const long long* st, const float* rel_bias,
                              const float* mask, void* out, int BW, int H,
                              int nW, int n, int hd, float scale,
                              Dropout drop, cudaStream_t stream) {
  if (drop.threshold > 0)
    return launch<T, true>(q, k, v, st, rel_bias, mask, out, BW, H, nW, n, hd,
                           scale, drop, stream);
  return launch<T, false>(q, k, v, st, rel_bias, mask, out, BW, H, nW, n, hd,
                          scale, drop, stream);
}

// ---- tensor-core instantiation (bf16) -------------------------------------

template <int HD, bool DROP>
__global__ void __launch_bounds__(WTC_THREADS) window_attn_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, Strides qs, Strides ks, Strides vs,
    const float* __restrict__ rel_bias,  // (H, n, n)
    const float* __restrict__ mask,      // (nW, n, n) or nullptr
    __nv_bfloat16* __restrict__ out,     // (B * nW, H, n, HD)
    int BW, int nW, int n, int run, float scale, Dropout drop) {
  constexpr int TILE = WTC_ROWS * (HD + 8);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][3]
  float* smask = reinterpret_cast<float*>(sm + 2 * 3 * TILE);      // [2]
  const int mstage = mask_stage_floats(n);
  const long long mtotal = (long long)nW * n * n;

  const int h = blockIdx.y, H = gridDim.y;
  const int w0 = blockIdx.x * run;
  const int cnt = min(run, BW - w0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3, r0 = warp * 16 + (lane >> 2);

  // rows n..63 of every staged tile, and the slack behind the mask tiles
  zero_pad_rows<HD>(sm, 2 * 3, n);
  if (mask) zero_mask_slack(smask, mstage);
  __syncthreads();

  auto prefetch = [&](int it) {
    const long long bw = w0 + it;
    __nv_bfloat16* buf = sm + (it & 1) * 3 * TILE;
    load_tile<HD>(buf, q + bw * qs.b + h * qs.h, qs.n, n);
    load_tile<HD>(buf + TILE, k + bw * ks.b + h * ks.h, ks.n, n);
    load_tile<HD>(buf + 2 * TILE, v + bw * vs.b + h * vs.h, vs.n, n);
    if (mask)
      load_mask_tile(smask + (it & 1) * mstage, mask, (bw % nW) * n * n,
                     mtotal, n);
    cp_async_commit();
  };

  float bias[8][4];
  load_bias_frag(bias, rel_bias + (long long)h * n * n, n, r0, t);
  prefetch(0);
  for (int it = 0; it < cnt; ++it) {
    const long long bw = w0 + it;
    if (it + 1 < cnt) prefetch(it + 1);
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = bias[nt][c];
    if (it + 1 < cnt)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (mask)
      add_mask_frag(s, smask + (it & 1) * mstage + (((bw % nW) * n * n) & 3),
                    n, r0, t);

    const __nv_bfloat16* sq = sm + (it & 1) * 3 * TILE;
    float acc[8][4] = {};
    mma_rows_by_rows<HD>(acc, sq, sq + TILE, warp, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = fmaf(acc[nt][c], scale, s[nt][c]);
    softmax_rows(s);
    if (DROP)
      apply_dropout(s,
                    dropout_bits(drop, (bw * H + h) * (long long)n * n, n, r0,
                                 t),
                    drop.scale);
    uint32_t pa[4][4];
    c_to_a_frags(pa, s);
    float o[HD / 8][4] = {};
    mma_frag_by_tile<HD>(o, pa, sq + 2 * TILE, lane);
    store_rows<HD>(out + (bw * H + h) * (long long)n * HD, o, 1.f, n, r0, t);
    // the buffer is the next prefetch's target
    __syncthreads();
  }
}

template <int HD, bool DROP>
static cudaError_t launch_tc(const void* q, const void* k, const void* v,
                             const long long* st, const float* rel_bias,
                             const float* mask, void* out, int BW, int H,
                             int nW, int n, int run, float scale,
                             Dropout drop, cudaStream_t stream) {
  const size_t smem = 2 * 3 * WTC_ROWS * (HD + 8) * sizeof(__nv_bfloat16) +
                      (mask ? 2 * mask_stage_floats(n) * sizeof(float) : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_attn_tc_kernel<HD, DROP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]};
  const dim3 grid((unsigned)((BW + run - 1) / run), (unsigned)H);
  window_attn_tc_kernel<HD, DROP><<<grid, WTC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), qs, ks, vs, rel_bias, mask,
      static_cast<__nv_bfloat16*>(out), BW, nW, n, run, scale, drop);
  return cudaGetLastError();
}

template <int HD>
static cudaError_t launch_tc_any(const void* q, const void* k, const void* v,
                                 const long long* st, const float* rel_bias,
                                 const float* mask, void* out, int BW, int H,
                                 int nW, int n, int run, float scale,
                                 Dropout drop, cudaStream_t stream) {
  if (drop.threshold > 0)
    return launch_tc<HD, true>(q, k, v, st, rel_bias, mask, out, BW, H, nW, n,
                               run, scale, drop, stream);
  return launch_tc<HD, false>(q, k, v, st, rel_bias, mask, out, BW, H, nW, n,
                              run, scale, drop, stream);
}

// ---- long-window tensor-core instantiation (bf16, 64 < n <= 144, hd 32) --

#define WTC144_WARPS 9
#define WTC144_THREADS (32 * WTC144_WARPS)
#define WTC144_ROWS (16 * WTC144_WARPS)  // padded tokens of a tile
#define WTC144_STAGES 3                  // q, k, v buffers in flight

static size_t tc144_smem_bytes() {
  return WTC144_STAGES * 3 * WTC144_ROWS * (32 + 8) * sizeof(__nv_bfloat16);
}

// (bias[h] + mask[w]) * log2(e) (the sum in f32, as the n <= 64 kernel
// sums them) in the C layout of this thread's rows r0 and r0 + 8 over the
// 144 padded keys: a padded key column -inf, a padded query row 0. The
// loads are independent, so all of a thread's are in flight at once.
template <int NT>
__device__ __forceinline__ void load_bias_mask_frag(
    float (&bm)[NT][4], const float* __restrict__ bh,
    const float* __restrict__ mw, int n, int r0, int t) {
  constexpr float LOG2E = 1.4426950408889634f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = r0 + 8 * (c >> 1), col = nt * 8 + 2 * t + (c & 1);
      const int at = row * n + col;
      bm[nt][c] = col >= n   ? -INFINITY
                  : row >= n ? 0.f
                  : LOG2E * (mw ? __ldg(bh + at) + __ldg(mw + at)
                                : __ldg(bh + at));
    }
}

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// softmax_rows for scores already in log2 units (times log2(e), folded
// into the scale and the bias): one subtraction and one ex2 an element;
// results under 2^-126 flush to 0, far below P's bf16 rounding
template <int NT>
__device__ __forceinline__ void softmax_rows_log2(float (&s)[NT][4]) {
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
    m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = ex2_ftz(s[nt][0] - m0);
    s[nt][1] = ex2_ftz(s[nt][1] - m0);
    s[nt][2] = ex2_ftz(s[nt][2] - m1);
    s[nt][3] = ex2_ftz(s[nt][3] - m1);
    l0 += s[nt][0] + s[nt][1];
    l1 += s[nt][2] + s[nt][3];
  }
  l0 = 1.f / quad_sum(l0);
  l1 = 1.f / quad_sum(l1);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] *= l0;
    s[nt][1] *= l0;
    s[nt][2] *= l1;
    s[nt][3] *= l1;
  }
}

template <bool DROP>
__global__ void __launch_bounds__(WTC144_THREADS, 1) window_attn_tc144_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, Strides qs, Strides ks, Strides vs,
    const float* __restrict__ rel_bias,  // (H, n, n)
    const float* __restrict__ mask,      // (nW, n, n) or nullptr
    __nv_bfloat16* __restrict__ out,     // (B * nW, H, n, 32)
    int B, int H, int nW, int n, int run, float scale, Dropout drop) {
  constexpr int HD = 32, LD = HD + 8, TILE = WTC144_ROWS * LD;
  constexpr int NT = WTC144_ROWS / 8, KK = WTC144_ROWS / 16;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  // the heads of a window are neighbouring blocks: together they read
  // whole rows of the fused q, k, v projection
  const int h = blockIdx.x % H;
  const int w = blockIdx.x / H % nW;
  const int b0 = blockIdx.x / H / nW * run;
  const int cnt = min(run, B - b0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3, r0 = warp * 16 + (lane >> 2);

  // rows n..143 of every staged tile (the copies never write them)
  {
    const int per_tile = (WTC144_ROWS - n) * LD / 8;  // 16-byte stores
    for (int i = threadIdx.x; i < WTC144_STAGES * 3 * per_tile;
         i += WTC144_THREADS) {
      const int tile = i / per_tile, j = i - tile * per_tile;
      reinterpret_cast<uint4*>(sm + tile * TILE + n * LD)[j] =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // rows [0, n) of one tile, 16 bytes a thread
  auto rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* src,
                  long long stride) {
    for (int c = threadIdx.x; c < n * (HD / 8); c += WTC144_THREADS) {
      const int i = c / (HD / 8), j = c - i * (HD / 8);
      cp_async16(smem_u32(dst + i * LD + j * 8), src + i * stride + j * 8);
    }
  };
  auto prefetch = [&](int it) {
    const long long bw = (long long)(b0 + it) * nW + w;
    __nv_bfloat16* buf = sm + (it % WTC144_STAGES) * 3 * TILE;
    rows(buf, q + bw * qs.b + h * qs.h, qs.n);
    rows(buf + TILE, k + bw * ks.b + h * ks.h, ks.n);
    rows(buf + 2 * TILE, v + bw * vs.b + h * vs.h, vs.n);
    cp_async_commit();
  };
  prefetch(0);
  if (cnt > 1) prefetch(1);

  // the block's one bias + mask, held in registers for its whole run
  float bm[NT][4];
  load_bias_mask_frag<NT>(bm, rel_bias + (long long)h * n * n,
                          mask ? mask + (long long)w * n * n : nullptr, n,
                          r0, t);
  const float scale2 = scale * LOG2E;

  for (int it = 0; it < cnt; ++it) {
    const long long bw = (long long)(b0 + it) * nW + w;
    // this image's group done; the next two may still be in flight
    if (it + 2 < cnt) {
      prefetch(it + 2);
      cp_async_wait<2>();
    } else if (it + 1 < cnt) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* sq = sm + (it % WTC144_STAGES) * 3 * TILE;
    float s[NT][4] = {};
    mma_rows_by_rows<HD, NT>(s, sq, sq + TILE, warp, lane);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = fmaf(s[nt][c], scale2, bm[nt][c]);
    softmax_rows_log2<NT>(s);
    if (DROP) {
      const unsigned long long base = (bw * H + h) * (long long)n * n;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = r0 + 8 * (c >> 1), col = nt * 8 + 2 * t + (c & 1);
          const bool keep = row < n && col < n &&
                            dropout_keep(drop, base + row * n + col);
          s[nt][c] = keep ? s[nt][c] * drop.scale : 0.f;
        }
    }
    uint32_t pa[KK][4];
    c_to_a_frags<KK>(pa, s);
    float o[HD / 8][4] = {};
    mma_frag_by_tile<HD, KK>(o, pa, sq + 2 * TILE, lane);
    store_rows<HD>(out + (bw * H + h) * (long long)n * HD, o, 1.f, n, r0, t);
    // the buffer is a later prefetch's target
    __syncthreads();
  }
}

template <bool DROP>
static cudaError_t launch_tc144(const void* q, const void* k, const void* v,
                                const long long* st, const float* rel_bias,
                                const float* mask, void* out, int BW, int H,
                                int nW, int n, int run, float scale,
                                Dropout drop, cudaStream_t stream) {
  const size_t smem = tc144_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      window_attn_tc144_kernel<DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]};
  const int B = BW / nW;
  const unsigned grid = (unsigned)((long long)H * nW * ((B + run - 1) / run));
  window_attn_tc144_kernel<DROP><<<grid, WTC144_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), qs, ks, vs, rel_bias, mask,
      static_cast<__nv_bfloat16*>(out), B, H, nW, n, run, scale, drop);
  return cudaGetLastError();
}

// strides: host array of 9 element strides, (image * window, head, token)
// for q, k, v in turn; the channel stride must be 1. mask may be null.
// run > 0: a tensor-core kernel (bf16, bases and strides multiples of 16
// bytes: the wrapper checks). For n <= 64 (hd 32 or 64) each block walks
// `run` consecutive (image * window) tiles of one head; for 64 < n <= 144
// (hd 32) `run` images of one (window, head). run == 0: the CUDA-core
// kernel. drop_threshold 0: no dropout (the bodies without it);
// else P is multiplied by drop_scale where word 0 of Philox(flat index,
// drop_seed) >= drop_threshold (at most 2^32), by 0 elsewhere. Returns a
// cudaError_t code.
extern "C" int window_attn_fwd(const void* q, const void* k, const void* v,
                               int dtype, const long long* strides,
                               const float* rel_bias, const float* mask,
                               void* out, int BW, int H, int nW, int n, int hd,
                               float scale, int run,
                               unsigned long long drop_seed,
                               unsigned long long drop_threshold,
                               float drop_scale, void* stream) {
  if (BW < 1 || H < 1 || nW < 1 || n < 1 || hd < 1 || BW % nW != 0 ||
      run < 0 || drop_threshold > (1ull << 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_seed, drop_threshold, drop_scale};
  if (run > 0 && n > WTC_ROWS) {
    if (dtype != kBF16 || n > WTC144_ROWS || hd != 32 || H > 65535)
      return (int)cudaErrorInvalidValue;
    if (drop.threshold > 0)
      return (int)launch_tc144<true>(q, k, v, strides, rel_bias, mask, out,
                                     BW, H, nW, n, run, scale, drop, s);
    return (int)launch_tc144<false>(q, k, v, strides, rel_bias, mask, out, BW,
                                    H, nW, n, run, scale, drop, s);
  }
  if (run > 0) {
    if (dtype != kBF16 || H > 65535)
      return (int)cudaErrorInvalidValue;
    if (hd == 32)
      return (int)launch_tc_any<32>(q, k, v, strides, rel_bias, mask, out, BW,
                                    H, nW, n, run, scale, drop, s);
    if (hd == 64)
      return (int)launch_tc_any<64>(q, k, v, strides, rel_bias, mask, out, BW,
                                    H, nW, n, run, scale, drop, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == kF32)
    return (int)launch_any<float>(q, k, v, strides, rel_bias, mask, out, BW,
                                  H, nW, n, hd, scale, drop, s);
  if (dtype == kBF16)
    return (int)launch_any<__nv_bfloat16>(q, k, v, strides, rel_bias, mask,
                                          out, BW, H, nW, n, hd, scale, drop,
                                          s);
  return (int)cudaErrorInvalidValue;
}
