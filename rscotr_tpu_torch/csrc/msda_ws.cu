// K4 / K5: the MSDA corner-weighted sum and its gradients, hand-written for
// Hopper.
//
// Replace the Pallas TPU kernels rscotr_tpu/ops/pallas/msda_ws.py: ws_fwd
// (K4, body _fwd_kernel) and ws_bwd (K5, body _bwd_kernel). Same layouts:
// g (G, Q, KP, 4D) holds one quad-gathered row of four bilinear corners per
// sampling point, corner c in columns [c*D, (c+1)*D); the weights travel as
// (G, Q, 4*KP) with the corner axis folded c-major, wt[c*KP + k]:
//   K4: out[g,q,d]           = sum_k sum_c g[g,q,k,c*D+d] * wt[g,q,c*KP+k]
//   K5: d_g[g,q,k,c*D+d]     = wt[g,q,c*KP+k] * d_out[g,q,d]  (g's dtype)
//       d_wt[g,q,c*KP+k]     = sum_d g[g,q,k,c*D+d] * d_out[g,q,d]
// Products and sums in f32; out and d_wt are f32, d_out is f32.
//
// What bounds it on the card: streaming g. At the det encoder (G=8,
// Q=13,294, KP=16, 4D=128, bf16) g is 435.6 MB per call; K4 reads it once
// (~0.13 ms at 3.35 TB/s), K5 reads it once and writes d_g once (~0.28 ms).
// The arithmetic is 2 FLOP per element. The TPU kernels existed to dodge an
// XLA relayout copy and lane-padding of the corner axis; neither exists here.
// No atomics: the results are deterministic.
//
// K4 and K5's lane body: one warp per (g, q) row, lane j owns columns j,
// j+32, ... of the 4D-wide row (each k row is read as coalesced 64 B / 128 B
// segments of 2- or 4-byte accesses), the row's 4*KP weights are staged once
// in shared memory, and per-column f32 sums over k are folded over the four
// corners at the end through a per-warp shared buffer. K5's lane body writes
// d_g in the same streaming pass and warp-reduces the four corner dot
// products of each k, one k after another (64 dependent warp sums a row at
// KP = 16). The lane bodies take any D <= 128.
//
// The vector bodies (D in {16, 32, 64}; K4: 16-byte aligned g and out, K5:
// 16-byte aligned g, d_out and d_g): still one warp per row, but a lane owns
// 4 consecutive channels, so a warp instruction covers 128 consecutive
// elements of the row's KP x 4D block (8-byte g loads in bf16, 16-byte in
// f32; at D = 32 one k row). A lane's channels d..d+3 are the same in every
// instruction. Batches of WS_BATCH instructions issue all their g loads
// before the first product; each instruction's weight wt[c*KP + k] is a
// 2- or 4-byte load from the row's weights, which hit in L1 after the first.
//
// K4's vector body loads g with the streaming hint (read once) and sums
// v * w into 4 f32 accumulators a lane; at the row's end the 32 / (D/4)
// lanes that hold the same channels fold their sums by __shfl_xor_sync (2
// steps at D = 32), and lanes 0 .. D/4 - 1 write the row's D outputs with
// one 16-byte store each. Nothing else is written, and no shared memory or
// block-wide sync is used. Measured at the det encoder (`python -m
// rscotr_tpu_torch.tools.msda_parts`): it takes about what a plain read of
// g (torch.sum) takes. Its weights held in registers and handed round by
// __shfl_sync were slower than the L1 loads, g loads without the streaming
// hint slightly slower, and batches of 8 instructions no faster.
//
// K5's vector body reads its d_out once with one 16-byte load and writes
// d_g in the same pass. A lane's partial for d_wt is the sum over its 4
// channels; the D/4 lanes of a corner group (one (k, c) slice of an
// instruction) combine D/4 instructions' partials with a reduce-scatter by
// __shfl_xor_sync (D/4 - 1 shuffles, 7 at D = 32), after which lane s of
// the group holds the whole sum of the group's slice in instruction s of
// the chunk: the stores into the c-major d_wt are consecutive within a
// group, and no shared memory or per-k warp sum is left.
#include "common.cuh"

#define WS_THREADS 256
#define WS_WARPS (WS_THREADS / 32)
#define WS_MAX_C4 (4 * 128)  // 4*D, D <= 128
#define WS_MAX_NW 256        // 4*KP, KP <= 64
#define WS_COLS (WS_MAX_C4 / 32)

// K4's lane body
template <typename T>
__global__ void __launch_bounds__(WS_THREADS) ws_fwd_kernel(
    const T* __restrict__ g,     // (rows, KP, 4D)
    const T* __restrict__ wt,    // (rows, 4*KP), c-major
    float* __restrict__ out,     // (rows, D)
    long long rows, int KP, int D) {
  __shared__ float s_w[WS_WARPS][WS_MAX_NW];
  __shared__ float s_acc[WS_WARPS][WS_MAX_C4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WS_WARPS + warp;
  if (row >= rows) return;  // the whole warp leaves; no block-wide sync
  const int C4 = 4 * D, NW = 4 * KP;
  const T* w_r = wt + row * NW;
  for (int i = lane; i < NW; i += 32) s_w[warp][i] = to_f32(w_r[i]);
  __syncwarp();
  int wbase[WS_COLS];
  float acc[WS_COLS];
#pragma unroll
  for (int i = 0; i < WS_COLS; ++i) {
    wbase[i] = ((lane + 32 * i) / D) * KP;  // corner of this column, * KP
    acc[i] = 0.f;
  }
  const T* g_r = g + row * (long long)KP * C4;
  for (int k = 0; k < KP; ++k) {
    const T* gk = g_r + (long long)k * C4;
#pragma unroll
    for (int i = 0; i < WS_COLS; ++i) {
      const int col = lane + 32 * i;
      if (col < C4) acc[i] += to_f32(gk[col]) * s_w[warp][wbase[i] + k];
    }
  }
#pragma unroll
  for (int i = 0; i < WS_COLS; ++i) {
    const int col = lane + 32 * i;
    if (col < C4) s_acc[warp][col] = acc[i];
  }
  __syncwarp();
  float* o = out + row * D;
  for (int d = lane; d < D; d += 32)
    o[d] = ((s_acc[warp][d] + s_acc[warp][D + d]) + s_acc[warp][2 * D + d]) +
           s_acc[warp][3 * D + d];
}

// K5's lane body
template <typename T>
__global__ void __launch_bounds__(WS_THREADS) ws_bwd_kernel(
    const T* __restrict__ g,         // (rows, KP, 4D)
    const T* __restrict__ wt,        // (rows, 4*KP), c-major
    const float* __restrict__ d_out, // (rows, D)
    T* __restrict__ d_g,             // (rows, KP, 4D)
    float* __restrict__ d_wt,        // (rows, 4*KP), c-major
    long long rows, int KP, int D) {
  __shared__ float s_w[WS_WARPS][WS_MAX_NW];
  __shared__ float s_dw[WS_WARPS][WS_MAX_NW];
  __shared__ float s_p[WS_WARPS][WS_MAX_C4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WS_WARPS + warp;
  if (row >= rows) return;
  const int C4 = 4 * D, NW = 4 * KP;
  const T* w_r = wt + row * NW;
  for (int i = lane; i < NW; i += 32) s_w[warp][i] = to_f32(w_r[i]);
  int wbase[WS_COLS];
  float dov[WS_COLS];
#pragma unroll
  for (int i = 0; i < WS_COLS; ++i) {
    const int col = lane + 32 * i;
    wbase[i] = (col / D) * KP;
    dov[i] = col < C4 ? d_out[row * D + col % D] : 0.f;
  }
  __syncwarp();
  const long long off = row * (long long)KP * C4;
  for (int k = 0; k < KP; ++k) {
    const T* gk = g + off + (long long)k * C4;
    T* dgk = d_g + off + (long long)k * C4;
#pragma unroll
    for (int i = 0; i < WS_COLS; ++i) {
      const int col = lane + 32 * i;
      if (col < C4) {
        dgk[col] = from_f32<T>(s_w[warp][wbase[i] + k] * dov[i]);
        s_p[warp][col] = to_f32(gk[col]) * dov[i];
      }
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += s_p[warp][c * D + d];
      s = warp_sum(s);
      if (lane == 0) s_dw[warp][c * KP + k] = s;
    }
    __syncwarp();
  }
  float* dw = d_wt + row * NW;
  for (int i = lane; i < NW; i += 32) dw[i] = s_dw[warp][i];
}

// ---- the vector bodies of K4 and K5: D in {16, 32, 64} -------------------
#define WS_BATCH 16  // warp instructions of a row whose g loads fly together

// Instruction i of a row covers elements [128 i, 128 i + 128) of its KP x 4D
// block; lane l's 4 elements start at e = 128 i + 4 l: k = e / 4D, corner
// c = (e % 4D) / D, channels d = 4 l % D .. + 3. The D/4 lanes with equal
// (k, c) in an instruction are an aligned group (at D = 16 a warp
// instruction holds two k rows, at D = 64 half of one). Elements past the
// row's end (e >= KP * 4D: at D = 16 with odd KP, or KP * 4D < 128) load
// nothing and add 0.
template <typename T, int D>
__global__ void __launch_bounds__(WS_THREADS) ws_fwd_vec_kernel(
    const T* __restrict__ g,     // (rows, KP, 4D)
    const T* __restrict__ wt,    // (rows, 4*KP), c-major
    float* __restrict__ out,     // (rows, D)
    long long rows, int KP) {
  constexpr int R = D / 4;  // lanes with distinct channels
  constexpr int C4 = 4 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WS_WARPS + warp;
  if (row >= rows) return;  // the whole warp leaves; no block-wide sync
  const int E = KP * C4;    // elements of the row
  const int NI = (E + 127) / 128;
  const T* g_r = g + row * E;
  const T* w_r = wt + row * 4 * KP;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i0 = 0; i0 < NI; i0 += WS_BATCH) {
    float v[WS_BATCH][4], w[WS_BATCH];
#pragma unroll
    for (int b = 0; b < WS_BATCH; ++b) {  // every load of the batch first
      const int e = 128 * (i0 + b) + 4 * lane;
      if (e < E) {
        load4_once(g_r + e, v[b]);
        w[b] = to_f32(w_r[(e % C4) / D * KP + e / C4]);
      } else {
        v[b][0] = v[b][1] = v[b][2] = v[b][3] = w[b] = 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < WS_BATCH; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += v[b][j] * w[b];
  }
  // lanes l, l + R, l + 2R, ... hold the same channels
#pragma unroll
  for (int h = R; h < 32; h <<= 1)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[j] += __shfl_xor_sync(FULL_MASK, acc[j], h);
  if (lane < R) store4(out + row * D + 4 * lane, acc);
}

template <typename T, int D>
__global__ void __launch_bounds__(WS_THREADS) ws_bwd_vec_kernel(
    const T* __restrict__ g,         // (rows, KP, 4D)
    const T* __restrict__ wt,        // (rows, 4*KP), c-major
    const float* __restrict__ d_out, // (rows, D)
    T* __restrict__ d_g,             // (rows, KP, 4D)
    float* __restrict__ d_wt,        // (rows, 4*KP), c-major
    long long rows, int KP) {
  constexpr int R = D / 4;  // lanes of a corner group, partials a chunk
  constexpr int C4 = 4 * D;
  static_assert(WS_BATCH % R == 0, "a batch holds whole chunks");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WS_WARPS + warp;
  if (row >= rows) return;  // the whole warp leaves; no block-wide sync
  const int E = KP * C4;    // elements of the row
  const int NI = (E + 127) / 128;
  const T* g_r = g + row * E;
  T* dg_r = d_g + row * E;
  const T* w_r = wt + row * 4 * KP;
  float* dw_r = d_wt + row * 4 * KP;
  const int s = lane % R;   // place in the corner group
  float dov[4];
  load4(d_out + row * D + (4 * lane) % D, dov);

  for (int i0 = 0; i0 < NI; i0 += WS_BATCH) {
    float v[WS_BATCH][4], w[WS_BATCH];
#pragma unroll
    for (int b = 0; b < WS_BATCH; ++b) {  // every load of the batch first
      const int e = 128 * (i0 + b) + 4 * lane;
      if (e < E) {
        load4(g_r + e, v[b]);
        w[b] = to_f32(w_r[(e % C4) / D * KP + e / C4]);
      } else {
        v[b][0] = v[b][1] = v[b][2] = v[b][3] = w[b] = 0.f;
      }
    }
    float p[WS_BATCH];
#pragma unroll
    for (int b = 0; b < WS_BATCH; ++b) {
      const int e = 128 * (i0 + b) + 4 * lane;
      p[b] = v[b][0] * dov[0] + v[b][1] * dov[1] + v[b][2] * dov[2] +
             v[b][3] * dov[3];
      const float o[4] = {w[b] * dov[0], w[b] * dov[1], w[b] * dov[2],
                          w[b] * dov[3]};
      if (e < E) store4(dg_r + e, o);
    }
#pragma unroll
    for (int m = 0; m < WS_BATCH; m += R) {
      if (i0 + m >= NI) break;  // warp-uniform
      // reduce-scatter of p[m .. m+R) over the group: a lane keeps the half
      // its bit h points to and adds its partner's copy of it
#pragma unroll
      for (int h = R / 2; h >= 1; h >>= 1) {
        const bool up = s & h;
#pragma unroll
        for (int j = 0; j < h; ++j) {
          const float send = up ? p[m + j] : p[m + j + h];
          const float keep = up ? p[m + j + h] : p[m + j];
          p[m + j] = keep + __shfl_xor_sync(FULL_MASK, send, h);
        }
      }
      // p[m]: the group's whole sum in instruction i0 + m + s
      const int e = 128 * (i0 + m + s) + 4 * (lane - s);
      if (e < E) dw_r[(e % C4) / D * KP + e / C4] = p[m];
    }
  }
}

static inline unsigned ws_blocks(long long rows) {
  return (unsigned)((rows + WS_WARPS - 1) / WS_WARPS);
}

static inline bool ws_sizes_ok(long long rows, int KP, int D) {
  return rows >= 1 && KP >= 1 && 4 * KP <= WS_MAX_NW && D >= 1 &&
         4 * D <= WS_MAX_C4;
}

template <typename T>
static cudaError_t ws_fwd_launch(const void* g, const void* wt, float* out,
                                 long long rows, int KP, int D, int body,
                                 cudaStream_t s) {
  const unsigned nb = ws_blocks(rows);
  const T* gg = static_cast<const T*>(g);
  const T* ww = static_cast<const T*>(wt);
  if (body == 0) {
    ws_fwd_kernel<T><<<nb, WS_THREADS, 0, s>>>(gg, ww, out, rows, KP, D);
  } else if (D == 16) {
    ws_fwd_vec_kernel<T, 16><<<nb, WS_THREADS, 0, s>>>(gg, ww, out, rows, KP);
  } else if (D == 32) {
    ws_fwd_vec_kernel<T, 32><<<nb, WS_THREADS, 0, s>>>(gg, ww, out, rows, KP);
  } else if (D == 64) {
    ws_fwd_vec_kernel<T, 64><<<nb, WS_THREADS, 0, s>>>(gg, ww, out, rows, KP);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// g and wt in one dtype (kF32 / kBF16), out f32. body: 0 the lane body, 1
// the vector body, which needs D in {16, 32, 64} and 16-byte aligned g and
// out. Returns a cudaError_t.
extern "C" int ws_fwd(const void* g, const void* wt, int dtype, float* out,
                      long long rows, int KP, int D, int body, void* stream) {
  if (!ws_sizes_ok(rows, KP, D) || body < 0 || body > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)ws_fwd_launch<float>(g, wt, out, rows, KP, D, body, s);
  if (dtype == kBF16)
    return (int)ws_fwd_launch<__nv_bfloat16>(g, wt, out, rows, KP, D, body,
                                             s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static cudaError_t ws_bwd_launch(const void* g, const void* wt,
                                 const float* d_out, void* d_g, float* d_wt,
                                 long long rows, int KP, int D, int body,
                                 cudaStream_t s) {
  const unsigned nb = ws_blocks(rows);
  const T* gg = static_cast<const T*>(g);
  const T* ww = static_cast<const T*>(wt);
  T* dg = static_cast<T*>(d_g);
  if (body == 0) {
    ws_bwd_kernel<T><<<nb, WS_THREADS, 0, s>>>(gg, ww, d_out, dg, d_wt, rows,
                                               KP, D);
  } else if (D == 16) {
    ws_bwd_vec_kernel<T, 16><<<nb, WS_THREADS, 0, s>>>(gg, ww, d_out, dg,
                                                       d_wt, rows, KP);
  } else if (D == 32) {
    ws_bwd_vec_kernel<T, 32><<<nb, WS_THREADS, 0, s>>>(gg, ww, d_out, dg,
                                                       d_wt, rows, KP);
  } else if (D == 64) {
    ws_bwd_vec_kernel<T, 64><<<nb, WS_THREADS, 0, s>>>(gg, ww, d_out, dg,
                                                       d_wt, rows, KP);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// g, wt and d_g in one dtype; d_out, d_wt f32. body: 0 the lane body, 1 the
// vector body, which needs D in {16, 32, 64} and 16-byte aligned g, d_out
// and d_g. Returns a cudaError_t.
extern "C" int ws_bwd(const void* g, const void* wt, int dtype,
                      const float* d_out, void* d_g, float* d_wt,
                      long long rows, int KP, int D, int body, void* stream) {
  if (!ws_sizes_ok(rows, KP, D) || body < 0 || body > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)ws_bwd_launch<float>(g, wt, d_out, d_g, d_wt, rows, KP, D,
                                     body, s);
  if (dtype == kBF16)
    return (int)ws_bwd_launch<__nv_bfloat16>(g, wt, d_out, d_g, d_wt, rows,
                                             KP, D, body, s);
  return (int)cudaErrorInvalidValue;
}
