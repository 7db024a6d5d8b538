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
// A level's width sits below the mask of a point's corners on the map.
#define MSDA_WIDTH_BITS 27

struct Levels {
  int num;
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
};

// Levels from L host (h, w) pairs; false if their rows do not add up to Nv
// or a width does not fit below the corner mask (MSDA_WIDTH_BITS).
static inline bool make_levels(const int* shapes, int L, int Nv, Levels* lv) {
  lv->num = L;
  int s = 0;
  for (int l = 0; l < L; ++l) {
    lv->h[l] = shapes[2 * l];
    lv->w[l] = shapes[2 * l + 1];
    lv->start[l] = s;
    s += lv->h[l] * lv->w[l];
    if (lv->w[l] >> MSDA_WIDTH_BITS) return false;
  }
  return s == Nv;
}

#define FULL_MASK 0xffffffffu

// One sampling point as the forward sees it: x = loc_x * W_l - 0.5 with an
// explicit round-to-nearest multiply, so no FMA contraction moves floor()
// away from the reference's separate multiply and subtract.
struct Start {
  int x0i, y0i;
  float fx, fy;
};

static __device__ __forceinline__ Start start_cell(float lx, float ly, int Wl,
                                                   int Hl) {
  const float x = __fmul_rn(lx, (float)Wl) - 0.5f;
  const float y = __fmul_rn(ly, (float)Hl) - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  return {(int)x0, (int)y0, x - x0, y - y0};
}

// ---- the vector bodies of K1 and K1b (D in {16, 32, 64}) ----------------
// A lane owns 4 consecutive channels of a row; one sampling point's data is
// worked out by the lane that owns it and handed round by __shfl_sync.

// Level l's constants by selects: indexing lv by a lane's own l would copy
// the struct to local memory.
static __device__ __forceinline__ void level_of(const Levels& lv, int l,
                                                int& Hl, int& Wl, int& st) {
  Hl = Wl = st = 0;
#pragma unroll
  for (int i = 0; i < MSDA_MAX_LEVELS; ++i)
    if (i == l) Hl = lv.h[i], Wl = lv.w[i], st = lv.start[i];
}

// Wl with bit MSDA_WIDTH_BITS + c set where corner c = 2 dy + dx of the
// point starting at s lies on the Hl x Wl map.
static __device__ __forceinline__ unsigned width_and_corners(const Start& s,
                                                             int Wl, int Hl) {
  const unsigned vx0 = s.x0i >= 0 && s.x0i < Wl;
  const unsigned vx1 = s.x0i + 1 >= 0 && s.x0i + 1 < Wl;
  const unsigned vy0 = s.y0i >= 0 && s.y0i < Hl;
  const unsigned vy1 = s.y0i + 1 >= 0 && s.y0i + 1 < Hl;
  const unsigned on_map = (vy0 & vx0) | (vy0 & vx1) << 1 | (vy1 & vx0) << 2 |
                          (vy1 & vx1) << 3;
  return (unsigned)Wl | on_map << MSDA_WIDTH_BITS;
}

static __device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}

static __device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                             float (&v)[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(t.x << 16), v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16), v[3] = __uint_as_float(t.y & 0xffff0000u);
}

// load4 with the streaming hint (ld.global.cs, evict first), for data read
// once. Used by K3' (scatter_add.cu) and K4 (msda_ws.cu).
static __device__ __forceinline__ void load4_once(const float* p,
                                                  float (&v)[4]) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}

static __device__ __forceinline__ void load4_once(const __nv_bfloat16* p,
                                                  float (&v)[4]) {
  const uint2 t = __ldcs(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(t.x << 16), v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16), v[3] = __uint_as_float(t.y & 0xffff0000u);
}

static __device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

static __device__ __forceinline__ void store4(__nv_bfloat16* p,
                                              const float (&v)[4]) {
  unsigned u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    u[j] = __bfloat16_as_ushort(from_f32<__nv_bfloat16>(v[j]));
  *reinterpret_cast<uint2*>(p) = make_uint2(u[0] | u[1] << 16,
                                            u[2] | u[3] << 16);
}

// p[0..3] += (a, b, c, d), p 16-byte aligned; nothing is read back. Used by
// K1b (msda_bwd.cu) and K3' (scatter_add.cu).
static __device__ __forceinline__ void red_add4(float* p, float a, float b,
                                                float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(
                   __cvta_generic_to_global(p)),
               "f"(a), "f"(b), "f"(c), "f"(d));
}

// ---- window attention (window_attn.cu, window_attn_bwd.cu) ---------------
struct Strides {  // element strides over (image * window, head, token)
  long long b, h, n;
};
