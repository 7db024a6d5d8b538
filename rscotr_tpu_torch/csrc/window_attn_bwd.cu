// K2b: Swin window attention backward, hand-written for Hopper.
//
// The JAX package has no backward kernel for K2 (window_attention_fused in
// rscotr_tpu/ops/pallas/window_attention.py has no VJP; JAX trains through
// the einsum path of rscotr_tpu/models/backbones/swin.py). This kernel is
// the gradient of K2 (csrc/window_attn.cu) for every (image, window, head):
// with S = scale q k^T + rel_bias[h] + shift_mask[w] and P = softmax(S),
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - rowsum(P * dP)),
//   dQ = scale dS K,  dK = scale dS^T Q,  d_rel_bias[h] += dS.
// rowsum(P * dP) equals rowsum(dO * O) with O = P V recomputed in f32, so
// the forward's output is not needed. P is recomputed in f32 from q, k and
// the bias + mask tile (no log-sum-exp buffer); all sums are f32; dQ, dK,
// dV are written in q's dtype and d_rel_bias (H, n, n) is accumulated in
// f32 with atomicAdd (the caller zeroes it); the shift mask is a constant.
//
// What bounds it on the card: as in the forward, each problem is tiny
// (n = 49, hd = 32: ~1 MFLOP over ~25 KB of q, k, v, dO in bf16), so the
// floor is reading those once and writing dQ, dK, dV once. One block per
// (image * window, head) holds q (pre-scaled), k, v, dO, the bias + mask
// tile, P and dS in shared memory (54 KB at n = 49, hd = 32, so the
// dynamic shared-memory limit is raised). Each warp owns whole query rows:
// lanes over keys compute the row's scores, softmax, dP and dS (k and v
// rows padded by one float so per-lane rows hit distinct banks), then
// lanes over channels form the row's dQ. After a block barrier the threads
// own (key, channel) pairs of dK and dV, and finally add dS into
// d_rel_bias with one atomicAdd per entry: 2,401 per block, with 841
// blocks per head contending at det 800^2 stage 0 (PERF.md has the time).
#include "common.cuh"

#define WAB_THREADS 128

template <typename T>
__global__ void __launch_bounds__(WAB_THREADS) window_attn_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    Strides qs, Strides ks, Strides vs,
    const float* __restrict__ rel_bias,  // (H, n, n)
    const float* __restrict__ mask,      // (nW, n, n) or nullptr
    const T* __restrict__ d_out,         // (B * nW, H, n, hd)
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ d_bias,          // (H, n, n), zeroed by the caller
    int H, int nW, int n, int hd, float scale) {
  extern __shared__ float smem[];
  const int kst = hd + 1;
  float* sq = smem;                 // n * hd, pre-scaled
  float* sk = sq + n * hd;          // n * (hd + 1)
  float* sv = sk + n * kst;         // n * (hd + 1)
  float* sdo = sv + n * kst;        // n * hd
  float* sbm = sdo + n * hd;        // n * n, bias + mask
  float* sp = sbm + n * n;          // n * n, P
  float* sds = sp + n * n;          // n * n, dS

  const long long bw = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int w = (int)(bw % nW);
  const T* qb = q + bw * qs.b + h * qs.h;
  const T* kb = k + bw * ks.b + h * ks.h;
  const T* vb = v + bw * vs.b + h * vs.h;
  const long long tile = (bw * H + h) * (long long)n * hd;
  const T* dob = d_out + tile;
  for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
    const int i = idx / hd, d = idx - i * hd;
    sq[idx] = to_f32(qb[i * qs.n + d]) * scale;
    sk[i * kst + d] = to_f32(kb[i * ks.n + d]);
    sv[i * kst + d] = to_f32(vb[i * vs.n + d]);
    sdo[idx] = to_f32(dob[idx]);
  }
  const float* bh = rel_bias + (long long)h * n * n;
  const float* mw = mask ? mask + (long long)w * n * n : nullptr;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x)
    sbm[idx] = mw ? bh[idx] + mw[idx] : bh[idx];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  T* dqb = dq + tile;
  for (int i = warp; i < n; i += nwarps) {
    const float* qi = sq + i * hd;
    const float* doi = sdo + i * hd;
    float* pi = sp + i * n;
    float* dsi = sds + i * n;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kj = sk + j * kst;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s += qi[d] * kj[d];
      s += sbm[i * n + j];
      pi[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(pi[j] - mx);
      pi[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float dsum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float* vj = sv + j * kst;
      const float p = pi[j] / sum;
      float dp = 0.f;
      for (int d = 0; d < hd; ++d) dp += doi[d] * vj[d];
      pi[j] = p;
      dsi[j] = dp;
      dsum += p * dp;
    }
    dsum = warp_sum(dsum);
    for (int j = lane; j < n; j += 32) dsi[j] = pi[j] * (dsi[j] - dsum);
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc += dsi[j] * sk[j * kst + d];
      dqb[i * hd + d] = from_f32<T>(acc * scale);
    }
  }
  __syncthreads();

  T* dkb = dk + tile;
  T* dvb = dv + tile;
  for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
    const int j = idx / hd, d = idx - j * hd;
    float accv = 0.f, acck = 0.f;
    for (int i = 0; i < n; ++i) {
      accv += sp[i * n + j] * sdo[i * hd + d];
      acck += sds[i * n + j] * sq[i * hd + d];
    }
    dvb[idx] = from_f32<T>(accv);
    dkb[idx] = from_f32<T>(acck);
  }
  float* db = d_bias + (long long)h * n * n;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x)
    atomicAdd(db + idx, sds[idx]);
}

static size_t smem_bytes(int n, int hd) {
  return sizeof(float) *
         ((size_t)n * hd * 2 + (size_t)n * (hd + 1) * 2 + (size_t)n * n * 3);
}

template <typename T>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const long long* st, const float* rel_bias,
                          const float* mask, const void* d_out, void* dq,
                          void* dk, void* dv, float* d_bias, int BW, int H,
                          int nW, int n, int hd, float scale,
                          cudaStream_t stream) {
  const size_t smem = smem_bytes(n, hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_attn_bwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]};
  window_attn_bwd_kernel<T><<<(unsigned)((long long)BW * H), WAB_THREADS,
                              smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qs, ks, vs, rel_bias, mask,
      static_cast<const T*>(d_out), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), d_bias, H, nW, n, hd, scale);
  return cudaGetLastError();
}

// strides: host array of 9 element strides, (image * window, head, token)
// for q, k, v in turn; the channel stride must be 1. mask may be null.
// d_out, dq, dk, dv are contiguous (B * nW, H, n, hd) in q's dtype; d_bias
// must be zeroed. Returns a cudaError_t code.
extern "C" int window_attn_bwd(const void* q, const void* k, const void* v,
                               int dtype, const long long* strides,
                               const float* rel_bias, const float* mask,
                               const void* d_out, void* dq, void* dk,
                               void* dv, float* d_bias, int BW, int H, int nW,
                               int n, int hd, float scale, void* stream) {
  if (BW < 1 || H < 1 || nW < 1 || n < 1 || hd < 1 || BW % nW != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)launch<float>(q, k, v, strides, rel_bias, mask, d_out, dq, dk,
                              dv, d_bias, BW, H, nW, n, hd, scale, s);
  if (dtype == kBF16)
    return (int)launch<__nv_bfloat16>(q, k, v, strides, rel_bias, mask, d_out,
                                      dq, dk, dv, d_bias, BW, H, nW, n, hd,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}
