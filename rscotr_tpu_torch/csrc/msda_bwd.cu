// K1b: multi-scale deformable attention backward, hand-written for Hopper.
//
// Replaces the JAX backward of K1 (ms_deform_attn_pallas has no backward of
// its own; its VJP is XLA autodiff of rscotr_tpu/ops/ms_deform_attn.py::
// _ms_deform_attn_xla with _corner_weighted_sum_bwd, and the value gradient
// is the Pallas scatter K3, ops/pallas/scatter_mm.py). Same decomposition:
// for each sampling point (b, q, h, l, p) with x = loc_x * W_l - 0.5,
// y = loc_y * H_l - 0.5, corners c = (dy, dx), bilinear weights
// w_c = wy_dy * wx_dx and a = attn[b, q, h, l, p], this kernel writes
//   d_attn[b,q,h,l,p] = sum over valid c of w_c <V_c, d_out[b,q,h]>
//   d_loc_x = a * W_l * sum over valid c of (dx ? +1 : -1) wy_dy <V_c, d_out>
//   d_loc_y = a * H_l * sum over valid c of (dy ? +1 : -1) wx_dx <V_c, d_out>
// (floor has zero gradient, the validity factors are constants), and the
// point's quad-row update d_g = the four quad-slot weights (x) d_out, 4*D
// wide, at the quad row gidx = yl * W_l + xl + start_l with the start
// clamped to the map, exactly as _ms_deform_attn_xla routes corners to
// quad slots. K3' (csrc/scatter_add.cu) scatters d_g into the quad-table
// gradient; the wrapper folds that back to d_value.
//
// What bounds it on the card: the d_g write. At the flagship det encoder
// (B=1, Q=Nv=13,294, H=8, L=4, P=4, D=32, bf16) one layer writes 8 x 212,704
// rows of 128 bf16 = 435.6 MB and reads 6.8 M corner rows of 64 B from a
// 6.8 MB value table that sits in L2. The design is the forward's: one warp
// per (b, q, h), lane = channel d (D > 32 loops), corner indices and
// weights recomputed exactly as msda_fwd.cu does, each corner row one
// coalesced read, <V_c, d_out> by a warp shuffle reduction, and each d_g
// slot one coalesced store. Fusing the scatter into this kernel with
// atomics would remove the d_g round trip (ROADMAP).
#include "common.cuh"

template <typename T, typename W>
__global__ void __launch_bounds__(MSDA_THREADS) msda_bwd_kernel(
    const T* __restrict__ value,      // (B, Nv, H, D)
    const float* __restrict__ loc,    // (B, Q, H, L, P, 2)
    const W* __restrict__ attw,       // (B, Q, H, L, P)
    const T* __restrict__ d_out,      // (B, Q, H * D)
    W* __restrict__ d_attw,           // (B, Q, H, L, P)
    float* __restrict__ d_loc,        // (B, Q, H, L, P, 2)
    T* __restrict__ d_g,              // (B, H, Q, L, P, 4 * D)
    int* __restrict__ gidx,           // (B, H, Q, L, P)
    int Nv, int Q, int H, int D, int P, long long total, Levels lv) {
  const long long task =
      (long long)blockIdx.x * (MSDA_THREADS / 32) + (threadIdx.x >> 5);
  if (task >= total) return;
  const int lane = threadIdx.x & 31;
  const int h = (int)(task % H);
  const long long bq = task / H;  // b * Q + q
  const long long b = bq / Q;
  const long long q = bq - b * Q;
  const int L = lv.num;
  const int KP = L * P;
  const float* loc_t = loc + task * (long long)(KP * 2);
  const W* w_t = attw + task * (long long)KP;
  const long long row_stride = (long long)H * D;
  const T* v_bh = value + b * (long long)Nv * row_stride + (long long)h * D;
  const T* do_t = d_out + bq * row_stride + (long long)h * D;
  const long long grow = ((b * H + h) * Q + q) * KP;  // (b, h, q) point row

  float dov[MSDA_MAX_D / 32];
#pragma unroll
  for (int j = 0; j < MSDA_MAX_D / 32; ++j) {
    const int d = lane + 32 * j;
    dov[j] = d < D ? to_f32(do_t[d]) : 0.f;
  }

  for (int l = 0; l < L; ++l) {
    const int Hl = lv.h[l], Wl = lv.w[l], st = lv.start[l];
    for (int p = 0; p < P; ++p) {
      const int lp = l * P + p;
      const float a = to_f32(w_t[lp]);
      // the forward's arithmetic, so floor() lands on the same cell
      const float x = __fmul_rn(loc_t[2 * lp], (float)Wl) - 0.5f;
      const float y = __fmul_rn(loc_t[2 * lp + 1], (float)Hl) - 0.5f;
      const float x0 = floorf(x), y0 = floorf(y);
      const float fx = x - x0, fy = y - y0;
      const int x0i = (int)x0, y0i = (int)y0;
      const int xl = min(max(x0i, 0), Wl - 1);
      const int yl = min(max(y0i, 0), Hl - 1);
      const int sx = x0i - xl, sy = y0i - yl;
      float wslot[4] = {0.f, 0.f, 0.f, 0.f};
      float dattn = 0.f, dfx = 0.f, dfy = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int dy = c >> 1, dx = c & 1;
        const int xi = x0i + dx, yi = y0i + dy;
        // warp-uniform: every lane works on the same point
        if (xi < 0 || xi >= Wl || yi < 0 || yi >= Hl) continue;
        const float wy = dy ? fy : 1.f - fy;
        const float wx = dx ? fx : 1.f - fx;
        const T* row = v_bh + (long long)(st + yi * Wl + xi) * row_stride;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < MSDA_MAX_D / 32; ++j) {
          const int d = lane + 32 * j;
          if (d < D) part += to_f32(row[d]) * dov[j];
        }
        const float dot = warp_sum(part);
        dattn += wy * wx * dot;
        dfx += (dx ? wy : -wy) * dot;
        dfy += (dy ? wx : -wx) * dot;
        // a valid corner always lands on a slot in [0, 4)
        const int s = 2 * (sy + dy) + (sx + dx);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (k == s) wslot[k] = a * wy * wx;
      }
      const long long pt = task * (long long)KP + lp;
      if (lane == 0) {
        d_attw[pt] = from_f32<W>(dattn);
        d_loc[2 * pt] = a * dfx * (float)Wl;
        d_loc[2 * pt + 1] = a * dfy * (float)Hl;
        gidx[grow + lp] = st + yl * Wl + xl;
      }
      T* g = d_g + (grow + lp) * (long long)(4 * D);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int j = 0; j < MSDA_MAX_D / 32; ++j) {
          const int d = lane + 32 * j;
          if (d < D) g[k * D + d] = from_f32<T>(wslot[k] * dov[j]);
        }
      }
    }
  }
}

template <typename T, typename W>
static cudaError_t launch(const void* value, const void* loc, const void* attw,
                          const void* d_out, void* d_attw, float* d_loc,
                          void* d_g, int* gidx, int B, int Nv, int Q, int H,
                          int D, int P, const Levels& lv,
                          cudaStream_t stream) {
  const long long total = (long long)B * Q * H;
  const long long warps_per_block = MSDA_THREADS / 32;
  const long long blocks = (total + warps_per_block - 1) / warps_per_block;
  msda_bwd_kernel<T, W><<<(unsigned)blocks, MSDA_THREADS, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const W*>(attw), static_cast<const T*>(d_out),
      static_cast<W*>(d_attw), d_loc, static_cast<T*>(d_g), gidx, Nv, Q, H,
      D, P, total, lv);
  return cudaGetLastError();
}

// d_out and d_g have value's dtype, d_attw attw's. shapes: host array of L
// (h, w) pairs. Returns a cudaError_t code.
extern "C" int msda_bwd(const void* value, int value_dtype, const void* loc,
                        const void* attw, int w_dtype, const void* d_out,
                        void* d_attw, float* d_loc, void* d_g, int* gidx,
                        int B, int Nv, int Q, int H, int D, int L, int P,
                        const int* shapes, void* stream) {
  if (L < 1 || L > MSDA_MAX_LEVELS || D < 1 || D > MSDA_MAX_D || B < 1 ||
      Q < 1 || H < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!make_levels(shapes, L, Nv, &lv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (value_dtype == kF32 && w_dtype == kF32)
    return (int)launch<float, float>(value, loc, attw, d_out, d_attw, d_loc,
                                     d_g, gidx, B, Nv, Q, H, D, P, lv, st);
  if (value_dtype == kBF16 && w_dtype == kBF16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        value, loc, attw, d_out, d_attw, d_loc, d_g, gidx, B, Nv, Q, H, D, P,
        lv, st);
  if (value_dtype == kBF16 && w_dtype == kF32)
    return (int)launch<__nv_bfloat16, float>(value, loc, attw, d_out, d_attw,
                                             d_loc, d_g, gidx, B, Nv, Q, H, D,
                                             P, lv, st);
  if (value_dtype == kF32 && w_dtype == kBF16)
    return (int)launch<float, __nv_bfloat16>(value, loc, attw, d_out, d_attw,
                                             d_loc, d_g, gidx, B, Nv, Q, H, D,
                                             P, lv, st);
  return (int)cudaErrorInvalidValue;
}
