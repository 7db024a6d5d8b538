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
template <typename T, typename W, bool DV>
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
            if (DV) atomicAdd(dv_bh + row + d, round_as<T>(wgt * dov[j]));
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
template <typename T, typename W, int D, bool DV>
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
          if (DV)
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

// ---- the ordered value gradient -------------------------------------------
// Under torch.use_deterministic_algorithms the wrapper runs a body above
// with its d_value reduction switched off (body | MSDA_ORDERED), then adds
// the same rounded terms in an order that the data fixes, not the card:
//  1. msda_bwd_keys: for corner c of sampling point pt = task * KP + lp
//     (corner index e = 4 pt + c), its target row (b Nv + cell) H + h of
//     the accumulator, the cell being st + yi Wl + xi as in the bodies, or
//     MSDA_NO_ROW where the corner is off the map;
//  2. the wrapper sorts the keys stably (torch.sort(stable=True), which
//     only orders indices): the corners of one row come out in e order,
//     which for the row's fixed (b, h) is the (q, l, p, c) order;
//     msda_bwd_bounds marks each row's [start, end) in the sorted keys;
//  3. msda_bwd_walk: each row's corners walked in that order; each
//     corner's weight (a wy) wx recomputed from loc and attw as the bodies
//     compute it, round_T(wgt * d_out[b, q, h, :]) added in f32 registers,
//     the row's sum added once into d_value (one writer per row, no
//     atomics).
// The walk takes its corners 32 at a time: lane i works out corner i's
// weight and d_out row and hands them round by __shfl_sync, so each
// corner is decoded once. Vector walk (D in {16, 32, 64}, 16-byte aligned
// d_out and d_value): a lane owns 4 channels and the warp's G = 32 / (D /
// 4) lane groups take every G-th corner, their sums meeting in a fixed
// xor-butterfly order. A warp walks one row; a block any of whose rows
// holds more than WALK_HOT corners (the coarse levels' cells, which take
// ~1,300 corners a row at the det encoder) walks its rows one after
// another with all its warps, each a fixed slice of the row, the slices'
// sums added in warp order through shared memory. Lane walk (any D): lanes
// over channels, one corner after another.
#define MSDA_ORDERED 2
#define MSDA_NO_ROW 0x7fffffff
#define WALK_HOT 256
#define WALK_WARPS (MSDA_THREADS / 32)

__global__ void __launch_bounds__(MSDA_THREADS) msda_keys_kernel(
    const float* __restrict__ loc, int* __restrict__ keys, int Nv, int Q,
    int H, int P, long long npts, Levels lv) {
  const long long pt = (long long)blockIdx.x * MSDA_THREADS + threadIdx.x;
  if (pt >= npts) return;
  const int KP = lv.num * P;
  const long long task = pt / KP;
  const int lp = (int)(pt - task * KP);
  const int h = (int)(task % H);
  const long long b = task / H / Q;
  int Hl, Wl, st;
  level_of(lv, lp / P, Hl, Wl, st);
  const Start s = start_cell(loc[2 * pt], loc[2 * pt + 1], Wl, Hl);
  int k[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int xi = s.x0i + (c & 1), yi = s.y0i + (c >> 1);
    k[c] = xi >= 0 && xi < Wl && yi >= 0 && yi < Hl
               ? (int)((b * Nv + st + yi * Wl + xi) * H + h)
               : MSDA_NO_ROW;
  }
  reinterpret_cast<int4*>(keys)[pt] = make_int4(k[0], k[1], k[2], k[3]);
}

__global__ void __launch_bounds__(MSDA_THREADS) msda_bounds_kernel(
    const int* __restrict__ sk, long long n, long long* __restrict__ start,
    long long* __restrict__ end) {
  const long long i = (long long)blockIdx.x * MSDA_THREADS + threadIdx.x;
  if (i >= n) return;
  const int k = sk[i];
  if (k == MSDA_NO_ROW) return;
  if (i == 0 || sk[i - 1] != k) start[k] = i;
  if (i == n - 1 || sk[i + 1] != k) end[k] = i + 1;
}

// What the walk reads of its corners: the caller's tensors and sizes.
template <typename T, typename W>
struct Walk {
  const float* __restrict__ loc;
  const W* __restrict__ attw;
  const T* __restrict__ d_out;
  const long long* __restrict__ perm;
  int KP, P, H;
  Levels lv;
};

// corner e's weight (a wy) wx, as the bodies compute it, and its d_out
// row b Q + q (valid_sizes keeps the point count below 2^31)
template <typename T, typename W>
static __device__ __forceinline__ float corner_weight(const Walk<T, W>& w,
                                                      long long e,
                                                      unsigned& bq) {
  const unsigned pt = (unsigned)(e >> 2);
  const int dy = (int)(e >> 1) & 1, dx = (int)e & 1;
  const unsigned task = pt / (unsigned)w.KP;
  const int lp = (int)(pt - task * (unsigned)w.KP);
  int Hl, Wl, st;
  level_of(w.lv, lp / w.P, Hl, Wl, st);
  const Start s = start_cell(w.loc[2 * (long long)pt],
                             w.loc[2 * (long long)pt + 1], Wl, Hl);
  const float a = to_f32(w.attw[pt]);
  const float wy = dy ? s.fy : 1.f - s.fy;
  const float wx = dx ? s.fx : 1.f - s.fx;
  bq = task / (unsigned)w.H;
  return a * wy * wx;
}

// The sum of the sorted corners [a, b) into acc, this lane's 4 channels
// (ch: their offset in a d_out row): lane i decodes corner j0 + i of each
// 32, group g adds corners g, g + G, ... of them in that order, then the
// groups' sums meet in the xor butterfly (every lane ends with the same
// bits).
template <typename T, typename W, int D>
static __device__ __forceinline__ void walk_span(const Walk<T, W>& w,
                                                 long long a, long long b,
                                                 long long ch, int lane,
                                                 float (&acc)[4]) {
  constexpr int LPR = D / 4;   // lanes per row, corners a group takes of 32
  constexpr int G = 32 / LPR;  // lane groups
  const int grp = lane / LPR;
  for (long long j0 = a; j0 < b; j0 += 32) {
    const int cnt = (int)min(32LL, b - j0);
    float wl = 0.f;
    unsigned bql = 0;
    if (lane < cnt) wl = corner_weight(w, w.perm[j0 + lane], bql);
    float wk[LPR], dov[LPR][4];
#pragma unroll
    for (int k = 0; k < LPR; ++k) {  // all loads before the first sum
      const int src = k * G + grp;
      wk[k] = __shfl_sync(FULL_MASK, wl, src);
      const unsigned bq = __shfl_sync(FULL_MASK, bql, src);
      if (src < cnt) load4(w.d_out + (long long)bq * w.H * D + ch, dov[k]);
    }
#pragma unroll
    for (int k = 0; k < LPR; ++k)
      if (k * G + grp < cnt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] += round_as<T>(wk[k] * dov[k][c]);
  }
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] += __shfl_xor_sync(FULL_MASK, acc[c], o);
}

static __device__ __forceinline__ void add4(float* p, const float (&v)[4]) {
  float4 cur = *reinterpret_cast<const float4*>(p);
  cur.x += v[0], cur.y += v[1], cur.z += v[2], cur.w += v[3];
  *reinterpret_cast<float4*>(p) = cur;
}

template <typename T, typename W, int D>
__global__ void __launch_bounds__(MSDA_THREADS) msda_walk_vec_kernel(
    Walk<T, W> w, const long long* __restrict__ start,
    const long long* __restrict__ end, float* __restrict__ d_value,
    long long rows) {
  constexpr int LPR = D / 4;
  __shared__ __align__(16) float part[WALK_WARPS][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane % LPR;
  const long long row0 = (long long)blockIdx.x * WALK_WARPS;
  const long long row = row0 + warp;
  long long s = 0, e = 0;
  if (row < rows) s = start[row], e = end[row];
  if (!__syncthreads_or(e - s > WALK_HOT)) {
    if (s == e) return;  // warp-uniform: no corner lands on this row
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    walk_span<T, W, D>(w, s, e, (row % w.H) * D + 4 * sub, lane, acc);
    if (lane < LPR) add4(d_value + row * D + 4 * sub, acc);
    return;
  }
  // a hot block: its rows in turn, each split over the block's warps
  for (int r = 0; r < WALK_WARPS && row0 + r < rows; ++r) {
    const long long rr = row0 + r, rs = start[rr], n = end[rr] - rs;
    if (n == 0) continue;  // block-uniform
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    walk_span<T, W, D>(w, rs + n * warp / WALK_WARPS,
                       rs + n * (warp + 1) / WALK_WARPS,
                       (rr % w.H) * D + 4 * sub, lane, acc);
    if (lane < LPR) store4(&part[warp][4 * sub], acc);
    __syncthreads();
    if (warp == 0 && lane < LPR) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < WALK_WARPS; ++k)
#pragma unroll
        for (int c = 0; c < 4; ++c) t[c] += part[k][4 * sub + c];
      add4(d_value + rr * D + 4 * sub, t);
    }
    __syncthreads();
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(MSDA_THREADS) msda_walk_lane_kernel(
    Walk<T, W> w, const long long* __restrict__ start,
    const long long* __restrict__ end, float* __restrict__ d_value, int D,
    long long rows) {
  const long long row =
      (long long)blockIdx.x * WALK_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long s = start[row], e = end[row];
  if (s == e) return;
  const int lane = threadIdx.x & 31;
  const long long ch = (row % w.H) * D;
  float acc[MSDA_MAX_D / 32] = {};
  for (long long j0 = s; j0 < e; j0 += 32) {
    const int cnt = (int)min(32LL, e - j0);
    float wl = 0.f;
    unsigned bql = 0;
    if (lane < cnt) wl = corner_weight(w, w.perm[j0 + lane], bql);
    for (int k = 0; k < cnt; ++k) {
      const float wgt = __shfl_sync(FULL_MASK, wl, k);
      const T* dr =
          w.d_out + (long long)__shfl_sync(FULL_MASK, bql, k) * w.H * D + ch;
#pragma unroll
      for (int jj = 0; jj < MSDA_MAX_D / 32; ++jj) {
        const int d = lane + 32 * jj;
        if (d < D) acc[jj] += round_as<T>(wgt * to_f32(dr[d]));
      }
    }
  }
  float* p = d_value + row * D;
#pragma unroll
  for (int jj = 0; jj < MSDA_MAX_D / 32; ++jj) {
    const int d = lane + 32 * jj;
    if (d < D) p[d] += acc[jj];
  }
}

template <typename T, typename W, bool DV>
static cudaError_t launch_body(const T* v, const float* lc, const W* aw,
                               const T* go, W* da, float* d_loc,
                               float* d_value, int Nv, int Q, int H, int D,
                               int P, bool vec, long long total,
                               unsigned blocks, const Levels& lv,
                               cudaStream_t stream) {
  if (!vec) {
    msda_bwd_lane_kernel<T, W, DV><<<blocks, MSDA_THREADS, 0, stream>>>(
        v, lc, aw, go, da, d_loc, d_value, Nv, Q, H, D, P, total, lv);
  } else if (D == 16) {
    msda_bwd_vec_kernel<T, W, 16, DV><<<blocks, MSDA_THREADS, 0, stream>>>(
        v, lc, aw, go, da, d_loc, d_value, Nv, Q, H, P, total, lv);
  } else if (D == 32) {
    msda_bwd_vec_kernel<T, W, 32, DV><<<blocks, MSDA_THREADS, 0, stream>>>(
        v, lc, aw, go, da, d_loc, d_value, Nv, Q, H, P, total, lv);
  } else if (D == 64) {
    msda_bwd_vec_kernel<T, W, 64, DV><<<blocks, MSDA_THREADS, 0, stream>>>(
        v, lc, aw, go, da, d_loc, d_value, Nv, Q, H, P, total, lv);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
  const bool vec = body & 1;
  if (body & MSDA_ORDERED)
    return launch_body<T, W, false>(v, lc, aw, go, da, d_loc, d_value, Nv, Q,
                                    H, D, P, vec, total, blocks, lv, stream);
  return launch_body<T, W, true>(v, lc, aw, go, da, d_loc, d_value, Nv, Q, H,
                                 D, P, vec, total, blocks, lv, stream);
}

template <typename T, typename W>
static cudaError_t launch_walk(const void* loc, const void* attw,
                               const void* d_out, const long long* perm,
                               const long long* start, const long long* end,
                               float* d_value, long long rows, int H, int D,
                               int P, bool vec, const Levels& lv,
                               cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + WALK_WARPS - 1) / WALK_WARPS);
  const Walk<T, W> w{static_cast<const float*>(loc),
                     static_cast<const W*>(attw),
                     static_cast<const T*>(d_out), perm, lv.num * P, P, H,
                     lv};
  if (!vec) {
    msda_walk_lane_kernel<T, W><<<blocks, MSDA_THREADS, 0, stream>>>(
        w, start, end, d_value, D, rows);
  } else if (D == 16) {
    msda_walk_vec_kernel<T, W, 16><<<blocks, MSDA_THREADS, 0, stream>>>(
        w, start, end, d_value, rows);
  } else if (D == 32) {
    msda_walk_vec_kernel<T, W, 32><<<blocks, MSDA_THREADS, 0, stream>>>(
        w, start, end, d_value, rows);
  } else if (D == 64) {
    msda_walk_vec_kernel<T, W, 64><<<blocks, MSDA_THREADS, 0, stream>>>(
        w, start, end, d_value, rows);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// sizes every entry takes; the ordered path's keys and walk also need the
// accumulator's rows and the sampling points below 2^31
static bool valid_sizes(int B, int Nv, int Q, int H, int D, int L, int P) {
  return L >= 1 && L <= MSDA_MAX_LEVELS && D >= 1 && D <= MSDA_MAX_D &&
         B >= 1 && Q >= 1 && H >= 1 && P >= 1 && Nv >= 1 &&
         (long long)B * Nv * H < MSDA_NO_ROW &&
         (long long)B * Q * H * L * P < MSDA_NO_ROW;
}

// d_out has value's dtype, d_attw attw's; d_value is the zeroed f32
// accumulator (B, Nv, H, D). shapes: host array of L (h, w) pairs. body: 0
// the lane-per-channel kernel, 1 the vector kernel, which needs D in {16,
// 32, 64} and 16-byte aligned value, loc, d_out, d_loc and d_value; with
// MSDA_ORDERED (2) added, the kernel writes d_attw and d_loc and leaves
// d_value alone (the ordered path's msda_bwd_keys / _bounds / _walk add
// it). Returns a cudaError_t code.
extern "C" int msda_bwd(const void* value, int value_dtype, const void* loc,
                        const void* attw, int w_dtype, const void* d_out,
                        void* d_attw, float* d_loc, float* d_value, int B,
                        int Nv, int Q, int H, int D, int L, int P,
                        const int* shapes, int body, void* stream) {
  if (!valid_sizes(B, Nv, Q, H, D, L, P) || body < 0 || body > 3)
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

// The ordered path's first step: keys (B * Q * H * L * P * 4 int32,
// 16-byte aligned) of the corners of every sampling point of loc.
extern "C" int msda_bwd_keys(const void* loc, int B, int Nv, int Q, int H,
                             int L, int P, const int* shapes, int* keys,
                             void* stream) {
  if (!valid_sizes(B, Nv, Q, H, 1, L, P)) return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!make_levels(shapes, L, Nv, &lv)) return (int)cudaErrorInvalidValue;
  const long long npts = (long long)B * Q * H * L * P;
  msda_keys_kernel<<<(unsigned)((npts + MSDA_THREADS - 1) / MSDA_THREADS),
                     MSDA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(loc), keys, Nv, Q, H, P, npts, lv);
  return (int)cudaGetLastError();
}

// Each row's [start, end) in the n stably sorted keys; start and end
// (B * Nv * H int64) are zeroed by the caller, so a row no corner lands on
// keeps an empty range.
extern "C" int msda_bwd_bounds(const int* sorted_keys, long long n,
                               long long* start, long long* end,
                               void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  msda_bounds_kernel<<<(unsigned)((n + MSDA_THREADS - 1) / MSDA_THREADS),
                       MSDA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      sorted_keys, n, start, end);
  return (int)cudaGetLastError();
}

// The ordered path's last step: each row of d_value (the f32 accumulator
// (B, Nv, H, D)) plus the sum of its corners' terms, walked in the order
// of perm (the stable sort's int64 permutation of the corner indices).
// body as msda_bwd's (its MSDA_ORDERED bit ignored): 1, the vector walk,
// needs D in {16, 32, 64} and 16-byte aligned d_out and d_value.
extern "C" int msda_bwd_walk(int value_dtype, const void* loc,
                             const void* attw, int w_dtype, const void* d_out,
                             const long long* perm, const long long* start,
                             const long long* end, float* d_value, int B,
                             int Nv, int Q, int H, int D, int L, int P,
                             const int* shapes, int body, void* stream) {
  if (!valid_sizes(B, Nv, Q, H, D, L, P) || body < 0 || body > 3)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  if (!make_levels(shapes, L, Nv, &lv)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * Nv * H;
  const bool vec = body & 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (value_dtype == kF32 && w_dtype == kF32)
    return (int)launch_walk<float, float>(loc, attw, d_out, perm, start, end,
                                          d_value, rows, H, D, P, vec, lv,
                                          st);
  if (value_dtype == kBF16 && w_dtype == kBF16)
    return (int)launch_walk<__nv_bfloat16, __nv_bfloat16>(
        loc, attw, d_out, perm, start, end, d_value, rows, H, D, P, vec, lv,
        st);
  if (value_dtype == kBF16 && w_dtype == kF32)
    return (int)launch_walk<__nv_bfloat16, float>(
        loc, attw, d_out, perm, start, end, d_value, rows, H, D, P, vec, lv,
        st);
  if (value_dtype == kF32 && w_dtype == kBF16)
    return (int)launch_walk<float, __nv_bfloat16>(
        loc, attw, d_out, perm, start, end, d_value, rows, H, D, P, vec, lv,
        st);
  return (int)cudaErrorInvalidValue;
}
