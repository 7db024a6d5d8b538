// K7: LayerNorm forward over the last dimension, hand-written for Hopper.
//
// Replaces no TPU kernel: the JAX package's flax nn.LayerNorm(epsilon=1e-5)
// is left to XLA, which fuses it with its neighbours. On the card the port's
// LayerNorm ran as PyTorch's vectorized_layer_norm_kernel behind a separate
// cast of a bf16 input to f32, and wrote f32 that every bf16 reader cast
// back; the benchmark's serving traces put it first of all device
// operations in the Swin cells, at 21-35% of its bandwidth bound. This
// kernel serves the calls that autograd does not record (serving,
// evaluation, export); training keeps F.layer_norm.
//
// What it computes, per row of C elements: the float32 mean, then the sum
// of squared deviations from that mean (two passes over registers, not
// E[x^2] - mean^2), y = (x - mean) * rsqrt(var + eps) * gamma + beta with
// float32 gamma and beta. It reads x in its own dtype (f32 or bf16) and
// writes y in f32 or in bf16, rounded to nearest even as torch's .to()
// rounds the f32 result.
//
// What bounds it on the card: bytes. About one operation per byte, far
// under the ~295 the H100 needs to be bound by arithmetic, so the least time
// is reading x once and writing y once at 3.35 TB/s. The design is about
// bytes and latency:
// * a row is read once, with 16-byte loads (4 f32 or 8 bf16 elements, a
//   "chunk"), and stays in registers through both reductions; y is written
//   once, in 16-byte (f32 out) or 8- to 16-byte (bf16 out) stores;
// * a group of G lanes owns a row, G sized to C: G is the largest power of
//   two up to 32 that divides the row's chunks, so a narrow row (C = 96 f32:
//   24 chunks, G = 8) leaves several rows to a warp and a wide one (C = 768
//   f32: 192 chunks, G = 32) a warp to a row. Lane l of a group takes
//   chunks l, l + G, l + 2G, ...: neighbouring lanes on neighbouring 16-byte
//   addresses. The reductions are xor shuffles inside the group;
// * the grid is as many blocks as the card holds at once, and each group
//   walks rows at a stride of all groups, so gamma and beta are loaded into
//   registers once per thread and every SM keeps enough rows in flight to
//   cover the memory latency.
#include "common.cuh"

#define LN_THREADS 256
#define LN_MAX_DEVICES 64

namespace {

// 16 bytes of Tin as K floats
template <typename Tin>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int K = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int K = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the top half of its f32: element 2i sits in the low bits
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// K consecutive floats stored as Tout (K = 4 or 8)
template <typename Tout, int K>
__device__ __forceinline__ void store(Tout* p, const float* v);

template <>
__device__ __forceinline__ void store<float, 4>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <>
__device__ __forceinline__ void store<float, 8>(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// two floats rounded to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

template <>
__device__ __forceinline__ void store<__nv_bfloat16, 4>(__nv_bfloat16* p,
                                                        const float* v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

template <>
__device__ __forceinline__ void store<__nv_bfloat16, 8>(__nv_bfloat16* p,
                                                        const float* v) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// every lane of a group of 2^log_g lanes (aligned in the warp) gets the sum
__device__ __forceinline__ float group_sum(float s, int log_g) {
  for (int o = (1 << log_g) >> 1; o > 0; o >>= 1)
    s += __shfl_xor_sync(FULL_MASK, s, o);
  return s;
}

// NV chunks a lane: C = 2^log_g * NV * K
template <typename Tin, typename Tout, int NV>
__global__ void __launch_bounds__(LN_THREADS) layer_norm_fwd_kernel(
    const Tin* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, Tout* __restrict__ y, long long rows,
    int C, int log_g, float eps) {
  constexpr int K = Chunk<Tin>::K;
  const int G = 1 << log_g;
  const int lane = threadIdx.x & (G - 1);
  // groups of a warp take consecutive rows; the warp loops while its first
  // group has a row, so every lane of it reaches each shuffle
  const long long tid = (long long)blockIdx.x * LN_THREADS + threadIdx.x;
  const long long group = tid >> log_g;
  const long long warp_first = (tid & ~31LL) >> log_g;
  const long long groups = ((long long)gridDim.x * LN_THREADS) >> log_g;

  // scalar loads, once a thread: gamma and beta need no alignment
  float g[NV][K], b[NV][K];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      g[j][k] = gamma[(lane + j * G) * K + k];
      b[j][k] = beta[(lane + j * G) * K + k];
    }

  for (long long step = 0; warp_first + step < rows; step += groups) {
    const long long r = group + step;
    const bool live = r < rows;
    float v[NV][K];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (live) {
        Chunk<Tin>::load(x + r * C + (lane + j * G) * K, v[j]);
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) v[j][k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) s += v[j][k];
    }
    const float mean = group_sum(s, log_g) / (float)C;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        v[j][k] -= mean;
        q = fmaf(v[j][k], v[j][k], q);
      }
    const float rstd = rsqrtf(group_sum(q, log_g) / (float)C + eps);
    if (!live) continue;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        v[j][k] = fmaf(v[j][k] * rstd, g[j][k], b[j][k]);
      store<Tout, K>(y + r * C + (lane + j * G) * K, v[j]);
    }
  }
}

template <typename Tin, typename Tout, int NV>
cudaError_t launch(const void* x, const float* gamma, const float* beta,
                   void* y, long long rows, int C, int log_g, float eps,
                   cudaStream_t stream) {
  auto kern = layer_norm_fwd_kernel<Tin, Tout, NV>;
  // the blocks one SM holds at once and the SM count, per device
  static int per_sm[LN_MAX_DEVICES], sms[LN_MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= LN_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, LN_THREADS,
                                                        0);
    if (err != cudaSuccess) return err;
    per_sm[dev] = n > 0 ? n : 1;
  }
  const long long rows_per_block = LN_THREADS >> log_g;
  const long long need = (rows + rows_per_block - 1) / rows_per_block;
  const long long resident = (long long)sms[dev] * per_sm[dev];
  const int grid = (int)(need < resident ? need : resident);
  kern<<<grid, LN_THREADS, 0, stream>>>(
      static_cast<const Tin*>(x), gamma, beta, static_cast<Tout*>(y), rows,
      C, log_g, eps);
  return cudaGetLastError();
}

// the chunk counts a lane may hold (csrc and ops/layer_norm.py NV_SIZES)
template <typename Tin, typename Tout>
cudaError_t by_nv(int nv, const void* x, const float* gamma,
                  const float* beta, void* y, long long rows, int C,
                  int log_g, float eps, cudaStream_t s) {
#define LN_CASE(N) \
  case N:          \
    return launch<Tin, Tout, N>(x, gamma, beta, y, rows, C, log_g, eps, s);
  switch (nv) {
    LN_CASE(1) LN_CASE(2) LN_CASE(3) LN_CASE(4)
    LN_CASE(6) LN_CASE(8) LN_CASE(12) LN_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef LN_CASE
}

}  // namespace

// y (rows, C) = LayerNorm(x (rows, C)) with float32 gamma, beta (C,); x and
// y contiguous and 16-byte aligned, a row a whole number of 16-byte chunks
// of x. in_dtype / out_dtype: kF32 or kBF16. The launch goes to `stream` of
// device `device`, which is made current for it where it is not.
extern "C" int layer_norm_fwd(const void* x, int in_dtype,
                              const float* gamma, const float* beta, void* y,
                              int out_dtype, long long rows, int C, float eps,
                              int device, void* stream) {
  const int K = in_dtype == kBF16 ? 8 : 4;
  if (rows < 1 || C < 1 || C % K || (in_dtype != kF32 && in_dtype != kBF16) ||
      (out_dtype != kF32 && out_dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  const int chunks = C / K;
  int log_g = 0;
  while (log_g < 5 && !((chunks >> log_g) & 1)) ++log_g;
  const int nv = chunks >> log_g;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == kF32)
    err = out_dtype == kF32
              ? by_nv<float, float>(nv, x, gamma, beta, y, rows, C, log_g,
                                    eps, s)
              : by_nv<float, __nv_bfloat16>(nv, x, gamma, beta, y, rows, C,
                                            log_g, eps, s);
  else
    err = out_dtype == kF32
              ? by_nv<__nv_bfloat16, float>(nv, x, gamma, beta, y, rows, C,
                                            log_g, eps, s)
              : by_nv<__nv_bfloat16, __nv_bfloat16>(nv, x, gamma, beta, y,
                                                    rows, C, log_g, eps, s);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}
