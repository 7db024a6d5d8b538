// Shared helpers for the rscotr_tpu_torch CUDA kernels.
//
// Every kernel is exported through a plain C function that takes raw device
// pointers, sizes, a dtype code and the caller's stream, launches on that
// stream, allocates nothing and returns cudaGetLastError(). The Python
// wrappers (rscotr_tpu_torch/ops/*.py) check shapes, dtypes, devices and
// contiguity before calling and raise on a non-zero return.
#pragma once

#include <math.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes shared with rscotr_tpu_torch/ops/kernel_lib.py
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// x rounded to T and back: where a bf16 kernel rounds an operand
template <typename T>
__device__ __forceinline__ float round_as(float x) {
  return to_f32(from_f32<T>(x));
}

static __device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// every lane gets the sum
static __device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- multi-scale deformable attention (msda_fwd.cu, msda_bwd.cu) --------
#define MSDA_MAX_LEVELS 8
#define MSDA_MAX_D 128
#define MSDA_THREADS 256

struct Levels {
  int num;
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

// Levels from L host (h, w) pairs; false if their rows do not add up to Nv.
static inline bool make_levels(const int* shapes, int L, int Nv, Levels* lv) {
  lv->num = L;
  int s = 0;
  for (int l = 0; l < L; ++l) {
    lv->h[l] = shapes[2 * l];
    lv->w[l] = shapes[2 * l + 1];
    lv->start[l] = s;
    s += lv->h[l] * lv->w[l];
  }
  return s == Nv;
}

// ---- window attention (window_attn.cu, window_attn_bwd.cu) ---------------
struct Strides {  // element strides over (image * window, head, token)
  long long b, h, n;
};
