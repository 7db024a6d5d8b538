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
// (~0.13 ms at 3.35 TB/s), K5 reads it once and writes d_g once. The
// arithmetic is 2 FLOP per element. The TPU kernels existed to dodge an XLA
// relayout copy and lane-padding of the corner axis; neither exists here,
// so the design is the plain streaming one: one warp per (g, q) row, lane j
// owns columns j, j+32, ... of the 4D-wide row (each k row is read as
// coalesced 64 B / 128 B segments), the row's 4*KP weights are staged once
// in shared memory, and per-column f32 sums over k are folded over the four
// corners at the end through a per-warp shared buffer. K5 writes d_g in the
// same streaming pass and warp-reduces the four corner dot products of
// each k. No atomics: the results are deterministic.
#include "common.cuh"

#define WS_THREADS 256
#define WS_WARPS (WS_THREADS / 32)
#define WS_MAX_C4 (4 * 128)  // 4*D, D <= 128
#define WS_MAX_NW 256        // 4*KP, KP <= 64
#define WS_COLS (WS_MAX_C4 / 32)

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

static inline unsigned ws_blocks(long long rows) {
  return (unsigned)((rows + WS_WARPS - 1) / WS_WARPS);
}

static inline bool ws_sizes_ok(long long rows, int KP, int D) {
  return rows >= 1 && KP >= 1 && 4 * KP <= WS_MAX_NW && D >= 1 &&
         4 * D <= WS_MAX_C4;
}

// g and wt in one dtype (kF32 / kBF16), out f32. Returns a cudaError_t.
extern "C" int ws_fwd(const void* g, const void* wt, int dtype, float* out,
                      long long rows, int KP, int D, void* stream) {
  if (!ws_sizes_ok(rows, KP, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = ws_blocks(rows);
#define WS_FWD(T)                                                          \
  ws_fwd_kernel<T><<<nb, WS_THREADS, 0, s>>>(                              \
      static_cast<const T*>(g), static_cast<const T*>(wt), out, rows, KP, D)
  if (dtype == kF32) WS_FWD(float);
  else if (dtype == kBF16) WS_FWD(__nv_bfloat16);
  else return (int)cudaErrorInvalidValue;
#undef WS_FWD
  return (int)cudaGetLastError();
}

// g, wt and d_g in one dtype; d_out, d_wt f32. Returns a cudaError_t.
extern "C" int ws_bwd(const void* g, const void* wt, int dtype,
                      const float* d_out, void* d_g, float* d_wt,
                      long long rows, int KP, int D, void* stream) {
  if (!ws_sizes_ok(rows, KP, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = ws_blocks(rows);
#define WS_BWD(T)                                                          \
  ws_bwd_kernel<T><<<nb, WS_THREADS, 0, s>>>(                              \
      static_cast<const T*>(g), static_cast<const T*>(wt), d_out,          \
      static_cast<T*>(d_g), d_wt, rows, KP, D)
  if (dtype == kF32) WS_BWD(float);
  else if (dtype == kBF16) WS_BWD(__nv_bfloat16);
  else return (int)cudaErrorInvalidValue;
#undef WS_BWD
  return (int)cudaGetLastError();
}
