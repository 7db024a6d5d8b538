// K1: multi-scale deformable attention forward, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel in
// rscotr_tpu/ops/pallas/ms_deform_attn_kernel.py: ms_deform_attn_pallas ->
// _pallas_forward (prologue _corner_indices_weights, body _kernel). Same
// math: for each (b, q, h) the output row is
//   sum over levels l, points p, corners c of
//     frac_c * valid_c * attn[b,q,h,l,p]
//       * value[b, start_l + y_c * W_l + x_c, h, :]
// with x = loc_x * W_l - 0.5, y = loc_y * H_l - 0.5 (grid_sample with
// align_corners=False and zero padding). Corner weights are formed in f32
// exactly as _corner_indices_weights does; sums are f32; the output is
// written in value's dtype.
//
// What bounds it on the card: scattered row reads. At the det-encoder shape
// (B=1, Q=Nv=13,294, H=8, L=4, P=4, D=32) one layer reads 6.8 M corner rows
// of 64 B (bf16) from a 6.8 MB value table, which sits in the 50 MB L2; the
// arithmetic is ~2 FLOP per byte read. The TPU kernel had to stage the whole
// table in VMEM and could not compile the gather; here a scattered load is
// native, so the design is one warp per (b, q, h) with lane = channel d: each
// corner row is one coalesced 64 B (bf16) / 128 B (f32) read by the warp,
// the location and weight loads are warp-wide broadcasts, and nothing is
// staged in shared memory. Invalid corners are skipped (weight 0 in the
// TPU kernel). D > 32 loops over lanes (up to 128); D < 32 idles lanes.
#include "common.cuh"

template <typename T, typename W>
__global__ void __launch_bounds__(MSDA_THREADS) msda_fwd_kernel(
    const T* __restrict__ value,      // (B, Nv, H, D)
    const float* __restrict__ loc,    // (B, Q, H, L, P, 2), (x, y) in [0, 1]
    const W* __restrict__ attw,       // (B, Q, H, L, P)
    T* __restrict__ out,              // (B, Q, H * D)
    int Nv, int Q, int H, int D, int P, long long total, Levels lv) {
  const long long task =
      (long long)blockIdx.x * (MSDA_THREADS / 32) + (threadIdx.x >> 5);
  if (task >= total) return;
  const int lane = threadIdx.x & 31;
  const int h = (int)(task % H);
  const long long bq = task / H;  // b * Q + q
  const long long b = bq / Q;
  const int L = lv.num;
  const float* loc_t = loc + task * (long long)(L * P * 2);
  const W* w_t = attw + task * (long long)(L * P);
  const long long row_stride = (long long)H * D;
  const T* v_bh = value + b * (long long)Nv * row_stride + (long long)h * D;

  float acc[MSDA_MAX_D / 32];
#pragma unroll
  for (int j = 0; j < MSDA_MAX_D / 32; ++j) acc[j] = 0.f;

  for (int l = 0; l < L; ++l) {
    const int Hl = lv.h[l], Wl = lv.w[l], st = lv.start[l];
    for (int p = 0; p < P; ++p) {
      const int lp = l * P + p;
      const float a = to_f32(w_t[lp]);
      // explicit round-to-nearest multiply so no FMA contraction moves
      // floor() away from the reference's separate mul and subtract
      const float x = __fmul_rn(loc_t[2 * lp], (float)Wl) - 0.5f;
      const float y = __fmul_rn(loc_t[2 * lp + 1], (float)Hl) - 0.5f;
      const float x0 = floorf(x), y0 = floorf(y);
      const float fx = x - x0, fy = y - y0;
      const int x0i = (int)x0, y0i = (int)y0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int dy = c >> 1, dx = c & 1;
        const int xi = x0i + dx, yi = y0i + dy;
        if (xi < 0 || xi >= Wl || yi < 0 || yi >= Hl) continue;
        const float wc = (dx ? fx : 1.f - fx) * (dy ? fy : 1.f - fy);
        const float wt = wc * a;
        const T* row = v_bh + (long long)(st + yi * Wl + xi) * row_stride;
#pragma unroll
        for (int j = 0; j < MSDA_MAX_D / 32; ++j) {
          const int d = lane + 32 * j;
          if (d < D) acc[j] += wt * to_f32(row[d]);
        }
      }
    }
  }
  T* o = out + bq * row_stride + (long long)h * D;
#pragma unroll
  for (int j = 0; j < MSDA_MAX_D / 32; ++j) {
    const int d = lane + 32 * j;
    if (d < D) o[d] = from_f32<T>(acc[j]);
  }
}

template <typename T, typename W>
static cudaError_t launch(const void* value, const void* loc, const void* attw,
                          void* out, int B, int Nv, int Q, int H, int D, int P,
                          const Levels& lv, cudaStream_t stream) {
  const long long total = (long long)B * Q * H;
  const long long warps_per_block = MSDA_THREADS / 32;
  const long long blocks = (total + warps_per_block - 1) / warps_per_block;
  msda_fwd_kernel<T, W><<<(unsigned)blocks, MSDA_THREADS, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const W*>(attw), static_cast<T*>(out), Nv, Q, H, D, P,
      total, lv);
  return cudaGetLastError();
}

// shapes: host array of L (h, w) pairs. Returns a cudaError_t code.
extern "C" int msda_fwd(const void* value, int value_dtype, const void* loc,
                        const void* attw, int w_dtype, void* out, int B,
                        int Nv, int Q, int H, int D, int L, int P,
                        const int* shapes, void* stream) {
  if (L < 1 || L > MSDA_MAX_LEVELS || D < 1 || D > MSDA_MAX_D || B < 1 ||
      Q < 1 || H < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!make_levels(shapes, L, Nv, &lv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (value_dtype == kF32 && w_dtype == kF32)
    return (int)launch<float, float>(value, loc, attw, out, B, Nv, Q, H, D, P,
                                     lv, st);
  if (value_dtype == kBF16 && w_dtype == kBF16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(value, loc, attw, out, B,
                                                     Nv, Q, H, D, P, lv, st);
  if (value_dtype == kBF16 && w_dtype == kF32)
    return (int)launch<__nv_bfloat16, float>(value, loc, attw, out, B, Nv, Q,
                                             H, D, P, lv, st);
  if (value_dtype == kF32 && w_dtype == kBF16)
    return (int)launch<float, __nv_bfloat16>(value, loc, attw, out, B, Nv, Q,
                                             H, D, P, lv, st);
  return (int)cudaErrorInvalidValue;
}
