// K1b: the whole multi-scale deformable attention backward in one kernel,
// hand-written for Hopper.
//
// Replaces the JAX backward of K1 (ms_deform_attn_pallas has no backward of
// its own; its VJP is XLA autodiff of rscotr_tpu/ops/ms_deform_attn.py::
// _ms_deform_attn_xla with _corner_weighted_sum_bwd, and the value gradient
// is the Pallas scatter K3, ops/pallas/scatter_mm.py). For each sampling
// point (b, q, h, l, p) with x = loc_x * W_l - 0.5, y = loc_y * H_l - 0.5,
// corners c = (dy, dx) at cell (y0 + dy, x0 + dx), bilinear weights
// w_c = wy_dy * wx_dx and a = attn[b, q, h, l, p], this kernel computes
//   d_attn[b,q,h,l,p] = sum over valid c of w_c <V_c, d_out[b,q,h]>
//   d_loc_x = a * W_l * sum over valid c of (dx ? +1 : -1) wy_dy <V_c, d_out>
//   d_loc_y = a * H_l * sum over valid c of (dy ? +1 : -1) wx_dx <V_c, d_out>
//   d_value[b, cell_c, h, :] += round_T((a * wy_dy) * wx_dx * d_out[b,q,h,:])
// (floor has zero gradient, the validity factors are constants). The last
// line is the work of K3 on the model path: JAX writes each point's
// quad-row update d_g = slot weights (x) d_out (rounded to value's dtype),
// scatter-adds the rows into a quad-table gradient in f32 and folds the
// table back to d_value. A valid corner (dy, dx) lands on slot
// 2 (sy + dy) + (sx + dx) of the clamped quad row (yl, xl), and the fold
// sends that slot to cell (yl + sy + dy, xl + sx + dx) = (y0 + dy, x0 + dx),
// the corner's own cell, so adding the same rounded term there with an f32
// atomic is the same sum in another order. The TPU needed the detour
// because its scatter-add serializes; on this card an f32 reduction into L2
// is native, so d_g, the quad-table gradient and the fold never exist.
// d_value is an f32 accumulator of value's layout, zeroed by the caller.
//
// What bounds it on the card: not device memory. At the flagship det encoder
// (B=1, Q=Nv=13,294, H=8, L=4, P=4, D=32, bf16) inputs and outputs are
// ~55 MB, while up to 6.8 M corner rows of 64 B are read from a 6.8 MB value
// table and as many rows of 128 B are reduced into a 13.6 MB accumulator,
// both of which sit in L2: the L2's load and reduction traffic and, before
// either, the instruction count per corner are the limit. The vector body
// (D in {16, 32, 64}):
//  - a lane owns 4 consecutive channels, so a corner row is D / 4 lanes and
//    a warp reads 32 / (D / 4) corner rows with one 8- or 16-byte load per
//    lane; each lane group takes one sampling point (D = 32: four points
//    side by side), loads its four corner rows before the first sum, and
//    reduces <V_c, d_out> inside the group, so the sums over a point's
//    corners never leave the group's registers;
//  - each lane adds its 4 channels with one 16-byte red.global.add.v4.f32;
//  - a task's locations and weights are read once, one point per lane, as
//    coalesced 8-byte loads; that lane works out the point's start cell,
//    fractions and which corners are on the map, and hands them round with
//    __shfl_sync; d_attn and d_loc go out the same way, one point per lane.
// Any other D in 1..128 takes the lane-per-channel body with scalar
// atomics. The order of the atomic adds changes from run to run, so
// d_value differs from a sequential sum in the last bits. Hot cells (many
// points adding into the few cells of the coarsest level) cost little: all
// points on the 13 x 13 level take about as long as all on the 100 x 100.
#include "common.cuh"

// ---- lane-per-channel body: any D <= MSDA_MAX_D ---------------------------
// One warp per (b, q, h), lane = channel d (D > 32 loops), one corner at a
// time: a coalesced read of the corner row, <V_c, d_out> by a warp shuffle
// reduction, one scalar atomic add per channel.
template <typename T, typename W>
__global__ void __launch_bounds__(MSDA_THREADS) msda_bwd_lane_kernel(
    const T* __restrict__ value,      // (B, Nv, H, D)
    const float* __restrict__ loc,    // (B, Q, H, L, P, 2)
    const W* __restrict__ attw,       // (B, Q, H, L, P)
    const T* __restrict__ d_out,      // (B, Q, H * D)
    W* __restrict__ d_attw,           // (B, Q, H, L, P)
    float* __restrict__ d_loc,        // (B, Q, H, L, P, 2)
    float* __restrict__ d_value,      // (B, Nv, H, D), zeroed by the caller
    int Nv, int Q, int H, int D, int P, long long total, Levels lv) {
  const long long task =
      (long long)blockIdx.x * (MSDA_THREADS / 32) + (threadIdx.x >> 5);
  if (task >= total) return;
  const int lane = threadIdx.x & 31;
  const int h = (int)(task % H);
  const long long bq = task / H;  // b * Q + q
  const long long b = bq / Q;
  const int L = lv.num;
  const int KP = L * P;
  const float* loc_t = loc + task * (long long)(KP * 2);
  const W* w_t = attw + task * (long long)KP;
  const long long row_stride = (long long)H * D;
  const long long bh = b * (long long)Nv * row_stride + (long long)h * D;
  const T* v_bh = value + bh;
  float* dv_bh = d_value + bh;
  const T* do_t = d_out + bq * row_stride + (long long)h * D;

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
      const Start s = start_cell(loc_t[2 * lp], loc_t[2 * lp + 1], Wl, Hl);
      float dattn = 0.f, dfx = 0.f, dfy = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int dy = c >> 1, dx = c & 1;
        const int xi = s.x0i + dx, yi = s.y0i + dy;
        // warp-uniform: every lane works on the same point
        if (xi < 0 || xi >= Wl || yi < 0 || yi >= Hl) continue;
        const float wy = dy ? s.fy : 1.f - s.fy;
        const float wx = dx ? s.fx : 1.f - s.fx;
        const long long row = (long long)(st + yi * Wl + xi) * row_stride;
        const float wgt = a * wy * wx;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < MSDA_MAX_D / 32; ++j) {
          const int d = lane + 32 * j;
          if (d < D) {
            part += to_f32(v_bh[row + d]) * dov[j];
            atomicAdd(dv_bh + row + d, round_as<T>(wgt * dov[j]));
          }
        }
        const float dot = warp_sum(part);
        dattn += wy * wx * dot;
        dfx += (dx ? wy : -wy) * dot;
        dfy += (dy ? wx : -wx) * dot;
      }
      const long long pt = task * (long long)KP + lp;
      if (lane == 0) {
        d_attw[pt] = from_f32<W>(dattn);
        d_loc[2 * pt] = a * dfx * (float)Wl;
        d_loc[2 * pt + 1] = a * dfy * (float)Hl;
      }
    }
  }
}

// ---- vector body: D in {16, 32, 64} ---------------------------------------
// One warp per (b, q, h). A task's points are taken 16 at a time (a chunk):
// lane i < 16 owns point i of the chunk. A round gives each of the warp's
// ROWS = 32 / (D / 4) lane groups one point: the group loads the point's
// four corner rows, then reduces them one after another, so the corner sums
// stay inside the group and only <V_c, d_out> is shuffled.
template <typename T, typename W, int D>
__global__ void __launch_bounds__(MSDA_THREADS) msda_bwd_vec_kernel(
    const T* __restrict__ value, const float* __restrict__ loc,
    const W* __restrict__ attw, const T* __restrict__ d_out,
    W* __restrict__ d_attw, float* __restrict__ d_loc,
    float* __restrict__ d_value, int Nv, int Q, int H, int P, long long total,
    Levels lv) {
  constexpr int LPR = D / 4;      // lanes per corner row
  constexpr int ROWS = 32 / LPR;  // corner rows per warp load, points a round
  constexpr int CHUNK = 16;       // points per chunk
  static_assert(CHUNK % ROWS == 0, "a round stays inside its chunk");

  const long long task =
      (long long)blockIdx.x * (MSDA_THREADS / 32) + (threadIdx.x >> 5);
  if (task >= total) return;
  const int lane = threadIdx.x & 31;
  const int grp = lane / LPR, sub = lane % LPR;
  const int h = (int)(task % H);
  const long long bq = task / H;  // b * Q + q
  const long long b = bq / Q;
  const int KP = lv.num * P;
  const float2* loc_t = reinterpret_cast<const float2*>(loc) + task * KP;
  const W* w_t = attw + task * (long long)KP;
  const long long row_stride = (long long)H * D;
  const long long bh =
      b * (long long)Nv * row_stride + (long long)h * D + 4 * sub;
  const T* v_bh = value + bh;  // this lane's 4 channels of row 0
  float* dv_bh = d_value + bh;
  float dov[4];
  load4(d_out + bq * row_stride + (long long)h * D + 4 * sub, dov);

  for (int c0 = 0; c0 < KP; c0 += CHUNK) {
    const int npts = min(CHUNK, KP - c0);
    // this lane's point: start cell, level width with the mask of corners
    // on the map above it, fractions, attention weight, level size
    int cell0 = 0;
    unsigned wmask = 0;
    float fx = 0.f, fy = 0.f, aw = 0.f, fW = 0.f, fH = 0.f;
    if (lane < npts) {
      const int lp = c0 + lane;
      int Hl, Wl, st;
      level_of(lv, lp / P, Hl, Wl, st);
      const float2 xy = __ldg(loc_t + lp);
      const Start s = start_cell(xy.x, xy.y, Wl, Hl);
      cell0 = st + s.y0i * Wl + s.x0i;
      wmask = width_and_corners(s, Wl, Hl);
      fx = s.fx, fy = s.fy;
      aw = to_f32(w_t[lp]);
      fW = (float)Wl, fH = (float)Hl;
    }
    float o_a = 0.f, o_x = 0.f, o_y = 0.f;  // the sums of this lane's point

    for (int r0 = 0; r0 < npts; r0 += ROWS) {
      const int pl = r0 + grp;  // this group's point; past npts its mask is 0
      const int pc = __shfl_sync(FULL_MASK, cell0, pl);
      const unsigned pm = __shfl_sync(FULL_MASK, wmask, pl);
      const float pfx = __shfl_sync(FULL_MASK, fx, pl);
      const float pfy = __shfl_sync(FULL_MASK, fy, pl);
      const float a = __shfl_sync(FULL_MASK, aw, pl);
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
      float t_a = 0.f, t_x = 0.f, t_y = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int dy = c >> 1, dx = c & 1;
        float dot = v[c][0] * dov[0] + v[c][1] * dov[1] + v[c][2] * dov[2] +
                    v[c][3] * dov[3];
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(FULL_MASK, dot, o);
        if ((pm >> (MSDA_WIDTH_BITS + c)) & 1u) {
          const float wy = dy ? pfy : 1.f - pfy;
          const float wx = dx ? pfx : 1.f - pfx;
          t_a += wy * wx * dot;
          t_x += (dx ? wy : -wy) * dot;
          t_y += (dy ? wx : -wx) * dot;
          const float wgt = a * wy * wx;
          red_add4(dv_bh + (long long)(pc + dy * Wl + dx) * row_stride,
                   round_as<T>(wgt * dov[0]), round_as<T>(wgt * dov[1]),
                   round_as<T>(wgt * dov[2]), round_as<T>(wgt * dov[3]));
        }
      }
      // point r0 + j sits in lane group j: hand its sums to lane r0 + j
      const int src = ((lane - r0) * LPR) & 31;
      t_a = __shfl_sync(FULL_MASK, t_a, src);
      t_x = __shfl_sync(FULL_MASK, t_x, src);
      t_y = __shfl_sync(FULL_MASK, t_y, src);
      if (lane >= r0 && lane < r0 + ROWS) o_a = t_a, o_x = t_x, o_y = t_y;
    }
    if (lane < npts) {
      const long long pt = task * (long long)KP + c0 + lane;
      d_attw[pt] = from_f32<W>(o_a);
      reinterpret_cast<float2*>(d_loc)[pt] =
          make_float2(aw * o_x * fW, aw * o_y * fH);
    }
  }
}

template <typename T, typename W>
static cudaError_t launch(const void* value, const void* loc, const void* attw,
                          const void* d_out, void* d_attw, float* d_loc,
                          float* d_value, int B, int Nv, int Q, int H, int D,
                          int P, int body, const Levels& lv,
                          cudaStream_t stream) {
  const long long total = (long long)B * Q * H;
  const long long warps_per_block = MSDA_THREADS / 32;
  const unsigned blocks =
      (unsigned)((total + warps_per_block - 1) / warps_per_block);
  const T* v = static_cast<const T*>(value);
  const float* lc = static_cast<const float*>(loc);
  const W* aw = static_cast<const W*>(attw);
  const T* go = static_cast<const T*>(d_out);
  W* da = static_cast<W*>(d_attw);
  if (body == 0) {
    msda_bwd_lane_kernel<T, W><<<blocks, MSDA_THREADS, 0, stream>>>(
        v, lc, aw, go, da, d_loc, d_value, Nv, Q, H, D, P, total, lv);
  } else if (D == 16) {
    msda_bwd_vec_kernel<T, W, 16><<<blocks, MSDA_THREADS, 0, stream>>>(
        v, lc, aw, go, da, d_loc, d_value, Nv, Q, H, P, total, lv);
  } else if (D == 32) {
    msda_bwd_vec_kernel<T, W, 32><<<blocks, MSDA_THREADS, 0, stream>>>(
        v, lc, aw, go, da, d_loc, d_value, Nv, Q, H, P, total, lv);
  } else if (D == 64) {
    msda_bwd_vec_kernel<T, W, 64><<<blocks, MSDA_THREADS, 0, stream>>>(
        v, lc, aw, go, da, d_loc, d_value, Nv, Q, H, P, total, lv);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// d_out has value's dtype, d_attw attw's; d_value is the zeroed f32
// accumulator (B, Nv, H, D). shapes: host array of L (h, w) pairs. body: 0
// the lane-per-channel kernel, 1 the vector kernel, which needs D in {16,
// 32, 64} and 16-byte aligned value, loc, d_out, d_loc and d_value. Returns
// a cudaError_t code.
extern "C" int msda_bwd(const void* value, int value_dtype, const void* loc,
                        const void* attw, int w_dtype, const void* d_out,
                        void* d_attw, float* d_loc, float* d_value, int B,
                        int Nv, int Q, int H, int D, int L, int P,
                        const int* shapes, int body, void* stream) {
  if (L < 1 || L > MSDA_MAX_LEVELS || D < 1 || D > MSDA_MAX_D || B < 1 ||
      Q < 1 || H < 1 || P < 1 || body < 0 || body > 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!make_levels(shapes, L, Nv, &lv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (value_dtype == kF32 && w_dtype == kF32)
    return (int)launch<float, float>(value, loc, attw, d_out, d_attw, d_loc,
                                     d_value, B, Nv, Q, H, D, P, body, lv, st);
  if (value_dtype == kBF16 && w_dtype == kBF16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        value, loc, attw, d_out, d_attw, d_loc, d_value, B, Nv, Q, H, D, P,
        body, lv, st);
  if (value_dtype == kBF16 && w_dtype == kF32)
    return (int)launch<__nv_bfloat16, float>(value, loc, attw, d_out, d_attw,
                                             d_loc, d_value, B, Nv, Q, H, D,
                                             P, body, lv, st);
  if (value_dtype == kF32 && w_dtype == kBF16)
    return (int)launch<float, __nv_bfloat16>(value, loc, attw, d_out, d_attw,
                                             d_loc, d_value, B, Nv, Q, H, D,
                                             P, body, lv, st);
  return (int)cudaErrorInvalidValue;
}
