// K2: Swin window attention forward, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel rscotr_tpu/ops/pallas/window_attention.py
// (window_attention_fused, body _kernel):
//   out[b,w,h] = softmax(scale * q k^T + rel_bias[h] + shift_mask[w]) v
// for every (image, window, head). Scores, row max, exponentials and sums
// are f32; the output is written in q's dtype.
//
// What bounds it on the card: each problem is tiny (n = 49 tokens, hd = 32:
// ~0.3 MFLOP over ~19 KB of q/k/v in bf16), far below tensor-core scale, so
// the floor is reading q, k, v once. The TPU kernel padded n to 56 and
// masked the padding (its (8, 128) tiling); here one block per
// (image * window, head) holds q, k, v and the summed bias + mask tile in
// shared memory at n = 49 exactly, and each warp owns whole query rows:
// lanes compute the row's scores over keys (k rows padded by one float so
// the per-lane rows hit distinct banks), a warp-shuffle max and sum give
// the softmax, and lanes then own output channels for P v. As written, the
// QK and PV loops load every FMA operand from shared memory, and that
// shared-load rate, not device memory, is what bounds this version
// (PERF.md); register-blocking k and v is the next step.
// q, k, v may be strided views of the fused qkv projection (no copies);
// the output is contiguous (B, nW, H, n, hd).
#include <math.h>

#include "common.cuh"

#define WA_THREADS 128

template <typename T>
__global__ void __launch_bounds__(WA_THREADS) window_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    Strides qs, Strides ks, Strides vs,
    const float* __restrict__ rel_bias,  // (H, n, n)
    const float* __restrict__ mask,      // (nW, n, n) or nullptr
    T* __restrict__ out,                 // (B * nW, H, n, hd)
    int H, int nW, int n, int hd, float scale) {
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
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float o = 0.f;
      for (int j = 0; j < n; ++j) o += prow[j] * sv[j * hd + d];
      ob[i * hd + d] = from_f32<T>(o / sum);
    }
    __syncwarp();
  }
}

static size_t smem_bytes(int n, int hd) {
  return sizeof(float) *
         ((size_t)n * hd * 2 + (size_t)n * (hd + 1) + (size_t)n * n +
          (size_t)(WA_THREADS / 32) * n);
}

template <typename T>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const long long* st, const float* rel_bias,
                          const float* mask, void* out, int BW, int H, int nW,
                          int n, int hd, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]};
  window_attn_kernel<T><<<(unsigned)((long long)BW * H), WA_THREADS, smem,
                          stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qs, ks, vs, rel_bias, mask,
      static_cast<T*>(out), H, nW, n, hd, scale);
  return cudaGetLastError();
}

// strides: host array of 9 element strides, (image * window, head, token)
// for q, k, v in turn; the channel stride must be 1. mask may be null.
// Returns a cudaError_t code.
extern "C" int window_attn_fwd(const void* q, const void* k, const void* v,
                               int dtype, const long long* strides,
                               const float* rel_bias, const float* mask,
                               void* out, int BW, int H, int nW, int n, int hd,
                               float scale, void* stream) {
  if (BW < 1 || H < 1 || nW < 1 || n < 1 || hd < 1 || BW % nW != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)launch<float>(q, k, v, strides, rel_bias, mask, out, BW, H, nW,
                              n, hd, scale, s);
  if (dtype == kBF16)
    return (int)launch<__nv_bfloat16>(q, k, v, strides, rel_bias, mask, out,
                                      BW, H, nW, n, hd, scale, s);
  return (int)cudaErrorInvalidValue;
}
