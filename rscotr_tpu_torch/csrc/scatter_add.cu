// K3': grouped scatter-add with f32 accumulation, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel rscotr_tpu/ops/pallas/scatter_mm.py
// (scatter_add_mm, bodies _kernel and _kernel_gated, which compute the same
// function):
//   out[g, r, :] = sum over k with idx[g, k] == r of updates[g, k, :]
// accumulated in f32 whatever the updates' dtype. Indices outside
// [0, num_rows) contribute nothing. In the port it is the MSDA value
// gradient of the quad-gather path (ms_deform_attn(impl="quad")): the
// gradients d_g of the gathered quad rows, which K5 writes, are scattered
// into the quad-table gradient (B*H, Nv, 4*D). The default path does the
// same sum inside its backward kernel (csrc/msda_bwd.cu), which adds each
// corner's term to the value gradient itself and writes no d_g.
//
// What bounds it on the card: by bytes, reading the updates once. At the
// flagship det encoder's shapes one call reads 8 x 212,704 rows of 128 bf16
// (435.6 MB) and adds them into a 54.5 MB f32 table, one group's 6.8 MB
// slice at a time (the grid walks the updates in order), which sits in the
// 50 MB L2. In practice the L2's rate of f32 reductions bounds it (below).
// The TPU kernel built one-hot blocks and contracted them on the MXU, and
// skipped empty (row-block, update-block) pairs, because XLA:TPU's
// scatter-add serializes. On Hopper an f32 reduction into L2 is native and
// the work is per update, so there is no empty pair to skip.
//
// The vector body (C % 4 == 0, 16-byte aligned updates and out): a lane owns
// 4 consecutive channels, so a warp instruction covers 128 consecutive
// elements of a group's updates (one row at C = 128, two at C = 64, half of
// one at C = 256); each lane adds its 4 channels with one 16-byte
// red.global.add.v4.f32, which returns nothing. A warp takes SA_STEPS such
// instructions in a row (8 update rows at C = 128) of one group and issues
// all their index and update loads before the first reduction; the updates
// are loaded with the streaming hint, since they are read once. Measured at
// the det encoder (`python -m rscotr_tpu_torch.tools.msda_parts`): the
// loads alone take about what reading 435.6 MB takes, and the reductions,
// 217.8 M f32 adds into L2, take the rest, at about the rate the scalar body
// reaches too; spreading a warp instruction's reductions over several rows
// did not raise it. Updates that hit one row are not combined before their
// reduction. The scalar body, one warp per update row with lanes over the
// channels and one scalar atomicAdd per element, takes every other C and
// unaligned bases. The order of the atomic adds changes from run to run, so
// sums differ from a sequential order in the last bits.
#include "common.cuh"

#define SA_THREADS 256
#define SA_WARPS (SA_THREADS / 32)
#define SA_STEPS 8                       // warp instructions of a warp's task
#define SA_VEC_MAX_ELEMENTS (1 << 30)    // the vector body's 32-bit offsets

template <typename T>
__global__ void __launch_bounds__(SA_THREADS) scatter_add_kernel(
    const T* __restrict__ updates,  // (G, K, C)
    const int* __restrict__ idx,    // (G, K)
    float* __restrict__ out,        // (G, num_rows, C), zeroed by the caller
    long long total, int K, int C, int num_rows) {
  const long long row =
      (long long)blockIdx.x * SA_WARPS + (threadIdx.x >> 5);
  if (row >= total) return;
  const int lane = threadIdx.x & 31;
  const int r = idx[row];
  if (r < 0 || r >= num_rows) return;
  const long long g = row / K;
  const T* u = updates + row * C;
  float* o = out + (g * num_rows + r) * (long long)C;
  for (int c = lane; c < C; c += 32) atomicAdd(o + c, to_f32(u[c]));
}

// A group's blocks take its K x C updates in order, 1,024 elements a warp.
// Lane l's 4 elements in step i start at e = base + 128 i + 4 l of the
// group's updates: update row e / C, channel e % C, walked forward 128
// elements a step by selects. The load loop has no branch, so all its loads
// issue before the first is used: a step past the group's end loads its
// last 4 elements again and is dropped.
template <typename T>
__global__ void __launch_bounds__(SA_THREADS) scatter_add_vec_kernel(
    const T* __restrict__ updates, const int* __restrict__ idx,
    float* __restrict__ out, int K, int C, int num_rows,
    int blocks_per_group) {
  const int lane = threadIdx.x & 31;
  const int grp = blockIdx.x / blocks_per_group;
  const int n = K * C;  // elements of a group
  const int base = ((blockIdx.x - grp * blocks_per_group) * SA_WARPS +
                    (threadIdx.x >> 5)) * (SA_STEPS * 128);
  if (base >= n) return;  // the whole warp leaves
  const T* u = updates + (long long)grp * n;
  const int* ix = idx + (long long)grp * K;
  float* o = out + (long long)grp * num_rows * C;
  int e = base + 4 * lane;
  int row = e / C, ch = e - row * C;
  const int dq = 128 / C, dc = 128 - dq * C;  // rows and channels a step
  float v[SA_STEPS][4];
  int tgt[SA_STEPS], at_ch[SA_STEPS];
#pragma unroll
  for (int i = 0; i < SA_STEPS; ++i) {  // every load before a reduction
    const int t = __ldg(ix + min(row, K - 1));
    load4_once(u + min(e, n - 4), v[i]);
    tgt[i] = e < n ? t : -1;
    at_ch[i] = ch;
    e += 128, row += dq, ch += dc;
    const bool wrap = ch >= C;
    ch = wrap ? ch - C : ch;
    row += wrap;
  }
#pragma unroll
  for (int i = 0; i < SA_STEPS; ++i) {
    if ((unsigned)tgt[i] < (unsigned)num_rows)
      red_add4(o + (long long)tgt[i] * C + at_ch[i], v[i][0], v[i][1],
               v[i][2], v[i][3]);
  }
}

template <typename T>
static cudaError_t launch(const void* updates, const int* idx, float* out,
                          int G, int K, int C, int num_rows, int body,
                          cudaStream_t stream) {
  const long long total = (long long)G * K;
  const T* u = static_cast<const T*>(updates);
  if (body == 0) {
    const long long blocks = (total + SA_WARPS - 1) / SA_WARPS;
    scatter_add_kernel<T><<<(unsigned)blocks, SA_THREADS, 0, stream>>>(
        u, idx, out, total, K, C, num_rows);
  } else {
    const int per_block = SA_WARPS * SA_STEPS * 128;
    const int blocks_per_group = (K * C + per_block - 1) / per_block;
    scatter_add_vec_kernel<T><<<(unsigned)(G * blocks_per_group), SA_THREADS,
                                0, stream>>>(u, idx, out, K, C, num_rows,
                                             blocks_per_group);
  }
  return cudaGetLastError();
}

// out must be zeroed by the caller. body: 0 the scalar body, 1 the vector
// body, which needs C % 4 == 0, G * K * C < SA_VEC_MAX_ELEMENTS and 16-byte
// aligned updates and out. Returns a cudaError_t code.
extern "C" int scatter_add(const void* updates, int dtype, const int* idx,
                           float* out, int G, int K, int C, int num_rows,
                           int body, void* stream) {
  if (G < 1 || K < 1 || C < 1 || num_rows < 1 || body < 0 || body > 1)
    return (int)cudaErrorInvalidValue;
  if (body == 1 &&
      (C % 4 || (long long)G * K * C >= (long long)SA_VEC_MAX_ELEMENTS))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)launch<float>(updates, idx, out, G, K, C, num_rows, body, s);
  if (dtype == kBF16)
    return (int)launch<__nv_bfloat16>(updates, idx, out, G, K, C, num_rows,
                                      body, s);
  return (int)cudaErrorInvalidValue;
}
