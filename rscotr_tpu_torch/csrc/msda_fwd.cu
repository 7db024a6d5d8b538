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
// align_corners=False and zero padding; start_cell, shared with K1b). Corner
// weights are formed in f32 as (wx * wy) * attn, exactly as
// _corner_indices_weights does; sums are f32; the output is rounded once to
// value's dtype. Corners off the map are skipped (weight 0 in the TPU
// kernel).
//
// What bounds it on the card: not device memory. At the det-encoder shape
// (B=1, Q=Nv=13,294, H=8, L=4, P=4, D=32) one layer reads up to 6.8 M corner
// rows of 64 B (bf16) from a 6.8 MB value table, which sits in the 50 MB L2;
// the arithmetic is ~2 FLOP per byte read. The TPU kernel had to stage the
// whole table in VMEM and could not compile the gather; here a scattered
// load is native, and what is left is the instructions issued per task and
// per corner row: with every corner off the map (no row loaded) the vector
// body takes over 90% of its time at a model's locations
// (rscotr_tpu_torch/tools/msda_parts.py). The vector body (D in {16, 32,
// 64}, 16-byte aligned value, loc and output):
//  - one warp per (b, q, h), one grid row per image, so the task's indices
//    are 32-bit arithmetic; a lane owns 4 consecutive channels, so a corner
//    row is D / 4 lanes and one 8-byte (bf16) or 16-byte (f32) load a lane;
//    the warp's 32 / (D / 4) lane groups each take one sampling point a
//    round (D = 32: four points side by side), and a group issues its four
//    corner loads before the first multiply-add;
//  - a task's locations and weights are read once, one point per lane, as
//    coalesced 8-byte loads; that lane works out the point's start cell,
//    which corners are on the map and their four weights, and hands them
//    round with __shfl_sync (level constants by selects, level_of);
//  - each lane keeps its 4 channels' sum over the rounds; at the end one
//    __shfl_xor_sync tree over the groups adds the points up and the first
//    group writes the output row with one 8- or 16-byte store a lane.
// Any other D in 1..128, or an unaligned base, takes the lane-per-channel
// body: lane = channel d, one corner row at a time.
#include "common.cuh"

// ---- lane-per-channel body: any D <= MSDA_MAX_D ---------------------------
// One warp per (b, q, h), lane = channel d (D > 32 loops, D < 32 idles
// lanes): each corner row is one coalesced read by the warp, the location
// and weight loads are warp-wide broadcasts.
template <typename T, typename W>
__global__ void __launch_bounds__(MSDA_THREADS) msda_fwd_lane_kernel(
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
      const Start s = start_cell(loc_t[2 * lp], loc_t[2 * lp + 1], Wl, Hl);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int dy = c >> 1, dx = c & 1;
        const int xi = s.x0i + dx, yi = s.y0i + dy;
        if (xi < 0 || xi >= Wl || yi < 0 || yi >= Hl) continue;
        const float wc = (dx ? s.fx : 1.f - s.fx) * (dy ? s.fy : 1.f - s.fy);
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

// ---- vector body: D in {16, 32, 64} ---------------------------------------
// A task's points are taken 16 at a time (a chunk): lane i < 16 owns point
// i of the chunk. A round gives each of the warp's ROWS = 32 / (D / 4) lane
// groups one point; the rounds of a chunk are unrolled, their loads
// predicated on the corner mask (0 for a point past the task's last).
template <typename T, typename W, int D>
__global__ void __launch_bounds__(MSDA_THREADS) msda_fwd_vec_kernel(
    const T* __restrict__ value, const float* __restrict__ loc,
    const W* __restrict__ attw, T* __restrict__ out, int Nv, int Q, int H,
    int P, Levels lv) {
  constexpr int LPR = D / 4;      // lanes per corner row
  constexpr int ROWS = 32 / LPR;  // corner rows per warp load, points a round
  constexpr int CHUNK = 16;       // points per chunk
  static_assert(CHUNK % ROWS == 0, "a round stays inside its chunk");

  // blockIdx.y = b; t = q * H + h within the image, in 32 bits
  const int t = blockIdx.x * (MSDA_THREADS / 32) + (threadIdx.x >> 5);
  if (t >= Q * H) return;
  const int lane = threadIdx.x & 31;
  const int grp = lane / LPR, sub = lane % LPR;
  const int h = t % H;
  const long long b = blockIdx.y;
  const long long bq = b * Q + t / H;  // b * Q + q
  const long long task = b * Q * H + t;
  const int KP = lv.num * P;
  const float2* loc_t = reinterpret_cast<const float2*>(loc) + task * KP;
  const W* w_t = attw + task * (long long)KP;
  const int row_stride = H * D;
  // this lane's 4 channels of row 0
  const T* v_bh = value + b * Nv * row_stride + h * D + 4 * sub;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < KP; c0 += CHUNK) {
    // this lane's point: start cell, level width with the mask of corners
    // on the map above it, the four corner weights (0 off the map)
    int cell0 = 0;
    unsigned wmask = 0;
    float wc[4] = {0.f, 0.f, 0.f, 0.f};
    if (lane < min(CHUNK, KP - c0)) {
      const int lp = c0 + lane;
      int Hl, Wl, st;
      level_of(lv, lp / P, Hl, Wl, st);
      const float2 xy = __ldg(loc_t + lp);
      const Start s = start_cell(xy.x, xy.y, Wl, Hl);
      const float a = to_f32(w_t[lp]);
      cell0 = st + s.y0i * Wl + s.x0i;
      wmask = width_and_corners(s, Wl, Hl);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float w = ((c & 1) ? s.fx : 1.f - s.fx) *
                        ((c >> 1) ? s.fy : 1.f - s.fy) * a;
        wc[c] = (wmask >> (MSDA_WIDTH_BITS + c)) & 1u ? w : 0.f;
      }
    }
#pragma unroll
    for (int r0 = 0; r0 < CHUNK; r0 += ROWS) {
      const int pl = r0 + grp;  // this group's point
      const int pc = __shfl_sync(FULL_MASK, cell0, pl);
      const unsigned pm = __shfl_sync(FULL_MASK, wmask, pl);
      const int Wl = (int)(pm & ((1u << MSDA_WIDTH_BITS) - 1u));
      float v[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // all four loads before the first sum
        if ((pm >> (MSDA_WIDTH_BITS + c)) & 1u) {
          load4(v_bh + (long long)(pc + (c >> 1) * Wl + (c & 1)) * row_stride,
                v[c]);
        } else {
          v[c][0] = v[c][1] = v[c][2] = v[c][3] = 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float w = __shfl_sync(FULL_MASK, wc[c], pl);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] += w * v[c][j];
      }
    }
  }
  // add the groups' sums: lanes sub, sub + LPR, ... hold the same channels
#pragma unroll
  for (int o = 16; o >= LPR; o >>= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[j] += __shfl_xor_sync(FULL_MASK, acc[j], o);
  }
  if (grp == 0) store4(out + bq * row_stride + h * D + 4 * sub, acc);
}

template <typename T, typename W>
static cudaError_t launch(const void* value, const void* loc, const void* attw,
                          void* out, int B, int Nv, int Q, int H, int D, int P,
                          int body, const Levels& lv, cudaStream_t stream) {
  const long long total = (long long)B * Q * H;
  const long long warps_per_block = MSDA_THREADS / 32;
  const unsigned blocks =
      (unsigned)((total + warps_per_block - 1) / warps_per_block);
  const T* v = static_cast<const T*>(value);
  const float* lc = static_cast<const float*>(loc);
  const W* aw = static_cast<const W*>(attw);
  T* o = static_cast<T*>(out);
  // vector body: one grid row per image
  const dim3 grid((unsigned)(((long long)Q * H + warps_per_block - 1) /
                             warps_per_block),
                  (unsigned)B);
  if (body == 0) {
    msda_fwd_lane_kernel<T, W><<<blocks, MSDA_THREADS, 0, stream>>>(
        v, lc, aw, o, Nv, Q, H, D, P, total, lv);
  } else if ((long long)Q * H > 0x7fffffffLL || B > 65535) {
    return cudaErrorInvalidValue;
  } else if (D == 16) {
    msda_fwd_vec_kernel<T, W, 16><<<grid, MSDA_THREADS, 0, stream>>>(
        v, lc, aw, o, Nv, Q, H, P, lv);
  } else if (D == 32) {
    msda_fwd_vec_kernel<T, W, 32><<<grid, MSDA_THREADS, 0, stream>>>(
        v, lc, aw, o, Nv, Q, H, P, lv);
  } else if (D == 64) {
    msda_fwd_vec_kernel<T, W, 64><<<grid, MSDA_THREADS, 0, stream>>>(
        v, lc, aw, o, Nv, Q, H, P, lv);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// shapes: host array of L (h, w) pairs. body: 0 the lane-per-channel
// kernel, 1 the vector kernel, which needs D in {16, 32, 64}, 16-byte
// aligned value, loc and out, Q * H < 2^31 and B <= 65535 (grid rows).
// Returns a cudaError_t code.
extern "C" int msda_fwd(const void* value, int value_dtype, const void* loc,
                        const void* attw, int w_dtype, void* out, int B,
                        int Nv, int Q, int H, int D, int L, int P,
                        const int* shapes, int body, void* stream) {
  if (L < 1 || L > MSDA_MAX_LEVELS || D < 1 || D > MSDA_MAX_D || B < 1 ||
      Q < 1 || H < 1 || P < 1 || body < 0 || body > 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!make_levels(shapes, L, Nv, &lv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (value_dtype == kF32 && w_dtype == kF32)
    return (int)launch<float, float>(value, loc, attw, out, B, Nv, Q, H, D, P,
                                     body, lv, st);
  if (value_dtype == kBF16 && w_dtype == kBF16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        value, loc, attw, out, B, Nv, Q, H, D, P, body, lv, st);
  if (value_dtype == kBF16 && w_dtype == kF32)
    return (int)launch<__nv_bfloat16, float>(value, loc, attw, out, B, Nv, Q,
                                             H, D, P, body, lv, st);
  if (value_dtype == kF32 && w_dtype == kBF16)
    return (int)launch<float, __nv_bfloat16>(value, loc, attw, out, B, Nv, Q,
                                             H, D, P, body, lv, st);
  return (int)cudaErrorInvalidValue;
}
