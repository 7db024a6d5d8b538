// K6: weight-folded row gather, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel of tools/probe_msda_weighted_gather_mm.py
// (weighted_gather_mm, body _wg_kernel), the probe of a one-hot matmul
// gather for the MSDA forward:
//   out[g, k, :] = acc(w[g, k]) * acc(table[g, idx[g, k], :])   (f32)
// where acc() rounds to the accumulation dtype (bf16 by default: the TPU
// kernel builds its one-hot block from w in acc_dtype and feeds the MXU the
// table in acc_dtype, accumulating in f32). An index outside [0, Nv) never
// matches the one-hot and gives a zero row.
//
// What bounds it on the card: the looked-up rows. At the probe's det-encoder
// shapes (G=8, K=53,376 lookups of C=128 bf16 per level) one call reads
// 109 MB of scattered 256 B rows (the tables, 0.3-20 MB, sit in L2) and
// writes 219 MB of f32 rows. The TPU kernel contracted (K x Nv) one-hot
// blocks on the MXU because Mosaic had no arbitrary-row gather; a scattered
// row read is native here, so the design is the gather itself: one warp per
// looked-up row, lanes over the channels (coalesced reads and writes), the
// index and weight read once per warp. The one-hot's sum has one non-zero
// term, so the result is that single product, exactly as the TPU kernel's.
#include "common.cuh"

#define WG_THREADS 256

template <typename A>
__device__ __forceinline__ float round_acc(float x);
template <>
__device__ __forceinline__ float round_acc<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_acc<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T, typename W, typename A>
__global__ void __launch_bounds__(WG_THREADS) weighted_gather_kernel(
    const T* __restrict__ table,  // (G, Nv, C)
    const int* __restrict__ idx,  // (G, K)
    const W* __restrict__ w,      // (G, K)
    float* __restrict__ out,      // (G, K, C)
    long long total, int K, int Nv, int C) {
  const long long row =
      (long long)blockIdx.x * (WG_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= total) return;
  const int lane = threadIdx.x & 31;
  const int r = idx[row];
  float* o = out + row * (long long)C;
  if (r < 0 || r >= Nv) {
    for (int c = lane; c < C; c += 32) o[c] = 0.f;
    return;
  }
  const long long g = row / K;
  const float wv = round_acc<A>(to_f32(w[row]));
  const T* t = table + (g * Nv + r) * (long long)C;
  for (int c = lane; c < C; c += 32) o[c] = wv * round_acc<A>(to_f32(t[c]));
}

template <typename T, typename W, typename A>
static cudaError_t wg_launch(const void* table, const int* idx, const void* w,
                             float* out, int G, int K, int Nv, int C,
                             cudaStream_t s) {
  const long long total = (long long)G * K;
  const long long per_block = WG_THREADS / 32;
  weighted_gather_kernel<T, W, A>
      <<<(unsigned)((total + per_block - 1) / per_block), WG_THREADS, 0, s>>>(
          static_cast<const T*>(table), idx, static_cast<const W*>(w), out,
          total, K, Nv, C);
  return cudaGetLastError();
}

template <typename T, typename W>
static cudaError_t wg_acc(int acc_dtype, const void* table, const int* idx,
                          const void* w, float* out, int G, int K, int Nv,
                          int C, cudaStream_t s) {
  if (acc_dtype == kF32)
    return wg_launch<T, W, float>(table, idx, w, out, G, K, Nv, C, s);
  if (acc_dtype == kBF16)
    return wg_launch<T, W, __nv_bfloat16>(table, idx, w, out, G, K, Nv, C, s);
  return cudaErrorInvalidValue;
}

// table: t_dtype, w: w_dtype, acc_dtype: the rounding of both (kF32 /
// kBF16); out f32 (G, K, C). Returns a cudaError_t code.
extern "C" int weighted_gather(const void* table, int t_dtype, const int* idx,
                               const void* w, int w_dtype, int acc_dtype,
                               float* out, int G, int K, int Nv, int C,
                               void* stream) {
  if (G < 1 || K < 1 || Nv < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_dtype == kF32 && w_dtype == kF32)
    return (int)wg_acc<float, float>(acc_dtype, table, idx, w, out, G, K, Nv,
                                     C, s);
  if (t_dtype == kBF16 && w_dtype == kBF16)
    return (int)wg_acc<__nv_bfloat16, __nv_bfloat16>(acc_dtype, table, idx,
                                                     w, out, G, K, Nv, C, s);
  if (t_dtype == kBF16 && w_dtype == kF32)
    return (int)wg_acc<__nv_bfloat16, float>(acc_dtype, table, idx, w, out,
                                             G, K, Nv, C, s);
  if (t_dtype == kF32 && w_dtype == kBF16)
    return (int)wg_acc<float, __nv_bfloat16>(acc_dtype, table, idx, w, out,
                                             G, K, Nv, C, s);
  return (int)cudaErrorInvalidValue;
}
