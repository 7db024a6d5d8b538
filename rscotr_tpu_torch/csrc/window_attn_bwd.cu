// K2b: Swin window attention backward, hand-written for Hopper.
//
// The JAX package has no backward kernel for K2 (window_attention_fused in
// rscotr_tpu/ops/pallas/window_attention.py has no VJP; JAX trains through
// the einsum path of rscotr_tpu/models/backbones/swin.py). This kernel is
// the gradient of K2 (csrc/window_attn.cu) for every (image, window, head):
// with S = scale q k^T + rel_bias[h] + shift_mask[w] and P = softmax(S),
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - rowsum(P * dP)),
//   dQ = scale dS K,  dK = scale dS^T Q,  d_rel_bias[h] += dS.
// P is recomputed from q, k and the bias + mask tile (no log-sum-exp
// buffer) and the forward's output is not needed. dQ, dK, dV are written
// in q's dtype; d_rel_bias (H, n, n) is accumulated in f32 with atomicAdd
// (the caller zeroes it); the shift mask is a constant.
//
// What bounds it on the card: bytes. A tile is ~1 MFLOP over 12.5 KB of q,
// k, v, dO in bf16 plus the f32 mask tile, so the floor is reading those
// once and writing dQ, dK, dV once: 63.5 MB at the det 800^2 stage 0,
// 0.019 ms at 3.35 TB/s, against 0.002 ms for its five products on the
// tensor cores.
//
// Two instantiations behind the one entry point, chosen by the wrapper as
// in the forward (run > 0 selects the first):
//
// * bf16, n <= 64, hd 32 or 64, 16-byte aligned rows: the tensor-core
//   kernel. Tile ownership, staging (q, k, v, dO and the mask tile by
//   cp.async, double-buffered over the run of windows), the bias fragment
//   in registers and the fragment layouts are the forward's
//   (window_attn_tc.cuh). Phase 1, a warp per 16 query rows: S and P as in
//   the forward, dP = dO v^T from the same kind of fragments,
//   rowsum(P * dP) and dS in registers in f32, dQ = scale dS k with dS
//   rounded to bf16 as the A operand. P and dS, rounded to bf16, also go to
//   two padded 64 x 64 shared tiles (2 x 9 KB). Phase 2, after a block
//   barrier, a warp per 16 key rows: dV = P^T dO and dK = scale dS^T q
//   with the transposed A fragments straight from those tiles by
//   ldmatrix.trans. P and dS are rounded only as operands of these three
//   products; the softmax, rowsum and d_rel_bias use the f32 values.
//   Padded rows and columns add nothing: padded key columns have P = 0
//   (score -inf), padded query rows have dO = 0 and q = 0 in the staged
//   tiles, hence dP = dS = 0 there.
//   d_rel_bias: a block keeps the f32 sum of dS over its run of windows in
//   registers (the accumulator layout) and adds it once at the end, so the
//   2,401 atomics per block come from BW / run blocks per head instead of
//   BW (841, 1,024 or 1,444 at the flagship's stage 0).
// * f32 inputs (full f32 arithmetic) and bf16 shapes outside the above:
//   the CUDA-core kernel below, one block per (image * window, head), every
//   operand as f32 in shared memory, 2,401 atomics per block.
//
// The f32 atomics land in an order that changes from run to run, so
// d_rel_bias is reproducible only to f32 rounding of a sum of BW terms; the
// comparison against the plain version scales its bound by the largest
// entry for that reason (BTOL in chip_smoke.py).
//
// The ordered body (the caller passes a partials buffer; the wrapper does
// so under torch.use_deterministic_algorithms): each block writes its f32
// sum of dS, the same values it would add with atomics, to its own slice of
// a (blocks per head, H, n, n) buffer, and a second launch,
// bias_sum_kernel, adds the slices in block order, one thread per entry of
// d_rel_bias. dQ, dK and dV have one writer each in both bodies.
//
// Attention dropout (the DROP instantiations, taken at launch when the rate
// is above 0, in both bodies and with or without the partials buffer): the
// forward used P' = P M, M = keep / (1 - p) with the keep bits of the same
// seed, regenerated here (philox.cuh). Then dV = P'^T dO, dP = (dO v^T) M,
// and dS = P (dP - rowsum(P dP)) as before: rowsum(P dP) = rowsum(dO O)
// with O = P' v, so the formula stays exact. In bf16 P' (not P) is the
// operand of dV.
#include "common.cuh"
#include "window_attn_tc.cuh"

#define WAB_THREADS 128

// ---- CUDA-core instantiation (f32, and bf16 outside the tensor-core shapes)

template <typename T, bool DROP>
__global__ void __launch_bounds__(WAB_THREADS) window_attn_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    Strides qs, Strides ks, Strides vs,
    const float* __restrict__ rel_bias,  // (H, n, n)
    const float* __restrict__ mask,      // (nW, n, n) or nullptr
    const T* __restrict__ d_out,         // (B * nW, H, n, hd)
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ d_bias,          // (H, n, n), zeroed by the caller
    float* __restrict__ partials,        // (BW, H, n, n) or nullptr
    int H, int nW, int n, int hd, float scale, Dropout drop) {
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
    const unsigned long long row0 = ((bw * H + h) * n + i) * (long long)n;
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
      if (DROP) dp *= dropout_factor(drop, row0 + j);
      pi[j] = p;
      dsi[j] = dp;
      dsum += p * dp;
    }
    dsum = warp_sum(dsum);
    for (int j = lane; j < n; j += 32) {
      dsi[j] = pi[j] * (dsi[j] - dsum);
      // P' for dV (the bits drawn again rather than kept)
      if (DROP) pi[j] *= dropout_factor(drop, row0 + j);
    }
    __syncwarp();
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j)
        acc += round_as<T>(dsi[j]) * sk[j * kst + d];
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
      accv += round_as<T>(sp[i * n + j]) * sdo[i * hd + d];
      acck += round_as<T>(sds[i * n + j]) * sq[i * hd + d];
    }
    dvb[idx] = from_f32<T>(accv);
    dkb[idx] = from_f32<T>(acck);
  }
  if (partials) {  // this block's slice, summed in block order later
    float* pb = partials + (long long)blockIdx.x * n * n;
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x)
      pb[idx] = sds[idx];
    return;
  }
  float* db = d_bias + (long long)h * n * n;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x)
    atomicAdd(db + idx, sds[idx]);
}

// d_bias[i] = the sum of partials[blk][i] over blk = 0, 1, ..., nblk - 1 in
// that order (per = H n n entries a slice), the loads of UNROLL slices in
// flight before their adds.
#define BIAS_SUM_THREADS 256
#define BIAS_SUM_UNROLL 8
__global__ void __launch_bounds__(BIAS_SUM_THREADS) bias_sum_kernel(
    const float* __restrict__ partials, int nblk, long long per,
    float* __restrict__ d_bias) {
  const long long i = (long long)blockIdx.x * BIAS_SUM_THREADS + threadIdx.x;
  if (i >= per) return;
  float acc = 0.f;
  int blk = 0;
  for (; blk + BIAS_SUM_UNROLL <= nblk; blk += BIAS_SUM_UNROLL) {
    float t[BIAS_SUM_UNROLL];
#pragma unroll
    for (int u = 0; u < BIAS_SUM_UNROLL; ++u)
      t[u] = __ldcs(partials + (long long)(blk + u) * per + i);
#pragma unroll
    for (int u = 0; u < BIAS_SUM_UNROLL; ++u) acc += t[u];
  }
  for (; blk < nblk; ++blk) acc += __ldcs(partials + (long long)blk * per + i);
  d_bias[i] = acc;
}

static cudaError_t launch_bias_sum(const float* partials, int nblk, int H,
                                   int n, float* d_bias, cudaStream_t stream) {
  const long long per = (long long)H * n * n;
  bias_sum_kernel<<<(unsigned)((per + BIAS_SUM_THREADS - 1) /
                               BIAS_SUM_THREADS),
                    BIAS_SUM_THREADS, 0, stream>>>(partials, nblk, per,
                                                   d_bias);
  return cudaGetLastError();
}

static size_t smem_bytes(int n, int hd) {
  return sizeof(float) *
         ((size_t)n * hd * 2 + (size_t)n * (hd + 1) * 2 + (size_t)n * n * 3);
}

template <typename T, bool DROP>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          const long long* st, const float* rel_bias,
                          const float* mask, const void* d_out, void* dq,
                          void* dk, void* dv, float* d_bias, float* partials,
                          int BW, int H, int nW, int n, int hd, float scale,
                          Dropout drop, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_attn_bwd_kernel<T, DROP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]};
  window_attn_bwd_kernel<T, DROP><<<(unsigned)((long long)BW * H),
                                    WAB_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qs, ks, vs, rel_bias, mask,
      static_cast<const T*>(d_out), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), d_bias, partials, H, nW, n, hd, scale, drop);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !partials) return e;
  return launch_bias_sum(partials, BW, H, n, d_bias, stream);
}

template <typename T>
static cudaError_t launch_any(const void* q, const void* k, const void* v,
                              const long long* st, const float* rel_bias,
                              const float* mask, const void* d_out, void* dq,
                              void* dk, void* dv, float* d_bias,
                              float* partials, int BW, int H, int nW, int n,
                              int hd, float scale, Dropout drop,
                              cudaStream_t stream) {
  if (drop.threshold > 0)
    return launch<T, true>(q, k, v, st, rel_bias, mask, d_out, dq, dk, dv,
                           d_bias, partials, BW, H, nW, n, hd, scale, drop,
                           stream);
  return launch<T, false>(q, k, v, st, rel_bias, mask, d_out, dq, dk, dv,
                          d_bias, partials, BW, H, nW, n, hd, scale, drop,
                          stream);
}

// ---- tensor-core instantiation (bf16) -------------------------------------

#define WTC_PLD 72  // row stride of the shared P and dS tiles (64 + 8)

template <int HD, bool DROP>
__global__ void __launch_bounds__(WTC_THREADS) window_attn_bwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, Strides qs, Strides ks, Strides vs,
    const float* __restrict__ rel_bias,        // (H, n, n)
    const float* __restrict__ mask,            // (nW, n, n) or nullptr
    const __nv_bfloat16* __restrict__ d_out,   // (B * nW, H, n, HD)
    __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv,
    float* __restrict__ d_bias,                // (H, n, n), zeroed by caller
    float* __restrict__ partials,  // (gridDim.x, H, n, n) or nullptr
    int BW, int nW, int n, int run, float scale, Dropout drop) {
  constexpr int LD = HD + 8;
  constexpr int TILE = WTC_ROWS * LD;
  constexpr int PT = WTC_ROWS * WTC_PLD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][4]
  __nv_bfloat16* sp = sm + 2 * 4 * TILE;  // P, then dS
  float* smask = reinterpret_cast<float*>(sp + 2 * PT);  // [2]
  const int mstage = mask_stage_floats(n);
  const long long mtotal = (long long)nW * n * n;

  const int h = blockIdx.y, H = gridDim.y;
  const int w0 = blockIdx.x * run;
  const int cnt = min(run, BW - w0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3, r0 = warp * 16 + (lane >> 2);

  // rows n..63 of every staged tile and the slack behind the mask tiles
  // (phase 1 writes all 64 x 64 entries of P and dS for every window)
  zero_pad_rows<HD>(sm, 2 * 4, n);
  if (mask) zero_mask_slack(smask, mstage);
  __syncthreads();

  auto prefetch = [&](int it) {
    const long long bw = w0 + it;
    __nv_bfloat16* buf = sm + (it & 1) * 4 * TILE;
    load_tile<HD>(buf, q + bw * qs.b + h * qs.h, qs.n, n);
    load_tile<HD>(buf + TILE, k + bw * ks.b + h * ks.h, ks.n, n);
    load_tile<HD>(buf + 2 * TILE, v + bw * vs.b + h * vs.h, vs.n, n);
    load_tile<HD>(buf + 3 * TILE, d_out + (bw * H + h) * (long long)n * HD,
                  HD, n);
    if (mask)
      load_mask_tile(smask + (it & 1) * mstage, mask, (bw % nW) * n * n,
                     mtotal, n);
    cp_async_commit();
  };

  float bias[8][4];
  load_bias_frag(bias, rel_bias + (long long)h * n * n, n, r0, t);
  float dsum[8][4] = {};  // sum of dS over the run, accumulator layout
  prefetch(0);
  for (int it = 0; it < cnt; ++it) {
    const long long bw = w0 + it;
    if (it + 1 < cnt) prefetch(it + 1);
    float p[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) p[nt][c] = bias[nt][c];
    if (it + 1 < cnt)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (mask)
      add_mask_frag(p, smask + (it & 1) * mstage + (((bw % nW) * n * n) & 3),
                    n, r0, t);

    const __nv_bfloat16* sq = sm + (it & 1) * 4 * TILE;
    const __nv_bfloat16* sk = sq + TILE;
    const __nv_bfloat16* sv = sk + TILE;
    const __nv_bfloat16* sdo = sv + TILE;
    const long long tile = (bw * H + h) * (long long)n * HD;

    // phase 1: this warp's 16 query rows
    {
      float acc[8][4] = {};
      mma_rows_by_rows<HD>(acc, sq, sk, warp, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          p[nt][c] = fmaf(acc[nt][c], scale, p[nt][c]);
    }
    softmax_rows(p);
    float ds[8][4] = {};
    mma_rows_by_rows<HD>(ds, sdo, sv, warp, lane);  // dP = dO v^T
    uint32_t keep = 0u;
    if (DROP) {  // dP = (dO v^T) M
      keep = dropout_bits(drop, (bw * H + h) * (long long)n * n, n, r0, t);
      apply_dropout(ds, keep, drop.scale);
    }
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      d0 += p[nt][0] * ds[nt][0] + p[nt][1] * ds[nt][1];
      d1 += p[nt][2] * ds[nt][2] + p[nt][3] * ds[nt][3];
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      ds[nt][0] = p[nt][0] * (ds[nt][0] - d0);
      ds[nt][1] = p[nt][1] * (ds[nt][1] - d0);
      ds[nt][2] = p[nt][2] * (ds[nt][2] - d1);
      ds[nt][3] = p[nt][3] * (ds[nt][3] - d1);
#pragma unroll
      for (int c = 0; c < 4; ++c) dsum[nt][c] += ds[nt][c];
      // bf16 copies for phase 2 (P' = P M under dropout)
      float pm[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        pm[c] = !DROP                           ? p[nt][c]
                : (keep >> (4 * nt + c)) & 1u ? p[nt][c] * drop.scale
                                              : 0.f;
      const int col = nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(sp + r0 * WTC_PLD + col) =
          pack_bf16(pm[0], pm[1]);
      *reinterpret_cast<uint32_t*>(sp + (r0 + 8) * WTC_PLD + col) =
          pack_bf16(pm[2], pm[3]);
      *reinterpret_cast<uint32_t*>(sp + PT + r0 * WTC_PLD + col) =
          pack_bf16(ds[nt][0], ds[nt][1]);
      *reinterpret_cast<uint32_t*>(sp + PT + (r0 + 8) * WTC_PLD + col) =
          pack_bf16(ds[nt][2], ds[nt][3]);
    }
    {
      uint32_t a[4][4];
      c_to_a_frags(a, ds);
      float o[HD / 8][4] = {};
      mma_frag_by_tile<HD>(o, a, sk, lane);  // dQ = dS k
      store_rows<HD>(dq + tile, o, scale, n, r0, t);
    }
    __syncthreads();

    // phase 2: this warp's 16 key rows, A = P^T and dS^T from shared memory
    {
      float ov[HD / 8][4] = {}, ok[HD / 8][4] = {};
      uint32_t ap[4][4], ads[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int off = (kk * 16 + (lane & 7) + 8 * (lane >> 4)) * WTC_PLD +
                        warp * 16 + 8 * ((lane >> 3) & 1);
        ldsm_x4_trans(ap[kk], smem_u32(sp + off));
        ldsm_x4_trans(ads[kk], smem_u32(sp + PT + off));
      }
      mma_frag_by_tile<HD>(ov, ap, sdo, lane);  // dV = P^T dO
      mma_frag_by_tile<HD>(ok, ads, sq, lane);  // dK = dS^T q
      store_rows<HD>(dv + tile, ov, 1.f, n, r0, t);
      store_rows<HD>(dk + tile, ok, scale, n, r0, t);
    }
    // the staged tiles and P / dS are the next iteration's targets
    __syncthreads();
  }

  // this block's slice (summed in block order by bias_sum_kernel), else
  // the atomics
  float* db = partials ? partials + ((long long)blockIdx.x * H + h) * n * n
                       : d_bias + (long long)h * n * n;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = r0 + 8 * (c >> 1), col = nt * 8 + 2 * t + (c & 1);
      if (row >= n || col >= n) continue;
      if (partials)
        db[row * n + col] = dsum[nt][c];
      else
        atomicAdd(db + row * n + col, dsum[nt][c]);
    }
}

template <int HD, bool DROP>
static cudaError_t launch_tc(const void* q, const void* k, const void* v,
                             const long long* st, const float* rel_bias,
                             const float* mask, const void* d_out, void* dq,
                             void* dk, void* dv, float* d_bias,
                             float* partials, int BW, int H, int nW, int n,
                             int run, float scale, Dropout drop,
                             cudaStream_t stream) {
  const size_t smem = (2 * 4 * WTC_ROWS * (HD + 8) + 2 * WTC_ROWS * WTC_PLD) *
                          sizeof(__nv_bfloat16) +
                      (mask ? 2 * mask_stage_floats(n) * sizeof(float) : 0);
  cudaError_t e = cudaFuncSetAttribute(
      window_attn_bwd_tc_kernel<HD, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]};
  const dim3 grid((unsigned)((BW + run - 1) / run), (unsigned)H);
  typedef __nv_bfloat16 bf;
  window_attn_bwd_tc_kernel<HD, DROP><<<grid, WTC_THREADS, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), qs, ks, vs, rel_bias, mask,
      static_cast<const bf*>(d_out), static_cast<bf*>(dq),
      static_cast<bf*>(dk), static_cast<bf*>(dv), d_bias, partials, BW, nW,
      n, run, scale, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess || !partials) return e;
  return launch_bias_sum(partials, (int)grid.x, H, n, d_bias, stream);
}

template <int HD>
static cudaError_t launch_tc_any(const void* q, const void* k, const void* v,
                                 const long long* st, const float* rel_bias,
                                 const float* mask, const void* d_out,
                                 void* dq, void* dk, void* dv, float* d_bias,
                                 float* partials, int BW, int H, int nW,
                                 int n, int run, float scale, Dropout drop,
                                 cudaStream_t stream) {
  if (drop.threshold > 0)
    return launch_tc<HD, true>(q, k, v, st, rel_bias, mask, d_out, dq, dk, dv,
                               d_bias, partials, BW, H, nW, n, run, scale,
                               drop, stream);
  return launch_tc<HD, false>(q, k, v, st, rel_bias, mask, d_out, dq, dk, dv,
                              d_bias, partials, BW, H, nW, n, run, scale,
                              drop, stream);
}

// strides: host array of 9 element strides, (image * window, head, token)
// for q, k, v in turn; the channel stride must be 1. mask may be null.
// d_out, dq, dk, dv are contiguous (B * nW, H, n, hd) in q's dtype; d_bias
// must be zeroed. run > 0: the tensor-core kernel, each block walking `run`
// consecutive (image * window) tiles of one head (bf16, n <= 64, hd 32 or
// 64, bases and strides multiples of 16 bytes: the wrapper checks);
// run == 0: the CUDA-core kernel. partials: null for the atomics, else the
// ordered body's f32 buffer of (blocks per head, H, n, n), blocks per head
// being ceil(BW / run) for run > 0 and BW for run == 0; d_rel_bias is then
// written, not added to. drop_seed / drop_threshold / drop_scale: the
// forward's dropout (window_attn_fwd; threshold 0: none). Returns a
// cudaError_t code.
extern "C" int window_attn_bwd(const void* q, const void* k, const void* v,
                               int dtype, const long long* strides,
                               const float* rel_bias, const float* mask,
                               const void* d_out, void* dq, void* dk,
                               void* dv, float* d_bias, int BW, int H, int nW,
                               int n, int hd, float scale, int run,
                               float* partials, unsigned long long drop_seed,
                               unsigned long long drop_threshold,
                               float drop_scale, void* stream) {
  if (BW < 1 || H < 1 || nW < 1 || n < 1 || hd < 1 || BW % nW != 0 ||
      run < 0 || drop_threshold > (1ull << 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{drop_seed, drop_threshold, drop_scale};
  if (run > 0) {
    if (dtype != kBF16 || n > WTC_ROWS || H > 65535)
      return (int)cudaErrorInvalidValue;
    if (hd == 32)
      return (int)launch_tc_any<32>(q, k, v, strides, rel_bias, mask, d_out,
                                    dq, dk, dv, d_bias, partials, BW, H, nW,
                                    n, run, scale, drop, s);
    if (hd == 64)
      return (int)launch_tc_any<64>(q, k, v, strides, rel_bias, mask, d_out,
                                    dq, dk, dv, d_bias, partials, BW, H, nW,
                                    n, run, scale, drop, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == kF32)
    return (int)launch_any<float>(q, k, v, strides, rel_bias, mask, d_out, dq,
                                  dk, dv, d_bias, partials, BW, H, nW, n, hd,
                                  scale, drop, s);
  if (dtype == kBF16)
    return (int)launch_any<__nv_bfloat16>(q, k, v, strides, rel_bias, mask,
                                          d_out, dq, dk, dv, d_bias, partials,
                                          BW, H, nW, n, hd, scale, drop, s);
  return (int)cudaErrorInvalidValue;
}
