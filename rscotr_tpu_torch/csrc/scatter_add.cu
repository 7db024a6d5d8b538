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
// What bounds it on the card: reading the updates once. At the flagship det
// encoder's shapes one call reads 8 x 212,704 rows of 128 bf16 (435.6 MB)
// and adds them into a 54.5 MB f32 table that mostly sits in the 50 MB L2.
// The TPU
// kernel built one-hot blocks and contracted them on the MXU, and skipped
// empty (row-block, update-block) pairs, because XLA:TPU's scatter-add
// serializes. On Hopper an f32 atomic add into L2 is native and the work is
// per update, so there is no empty pair to skip: one warp per update row,
// lanes over the channels (coalesced reads of the row), one atomicAdd per
// element. The order of the atomic adds changes from run to run, so sums
// differ from a sequential order in the last bits.
#include "common.cuh"

#define SA_THREADS 256

template <typename T>
__global__ void __launch_bounds__(SA_THREADS) scatter_add_kernel(
    const T* __restrict__ updates,  // (G, K, C)
    const int* __restrict__ idx,    // (G, K)
    float* __restrict__ out,        // (G, num_rows, C), zeroed by the caller
    long long total, int K, int C, int num_rows) {
  const long long row =
      (long long)blockIdx.x * (SA_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= total) return;
  const int lane = threadIdx.x & 31;
  const int r = idx[row];
  if (r < 0 || r >= num_rows) return;
  const long long g = row / K;
  const T* u = updates + row * C;
  float* o = out + (g * num_rows + r) * (long long)C;
  for (int c = lane; c < C; c += 32) atomicAdd(o + c, to_f32(u[c]));
}

template <typename T>
static cudaError_t launch(const void* updates, const int* idx, float* out,
                          int G, int K, int C, int num_rows,
                          cudaStream_t stream) {
  const long long total = (long long)G * K;
  const long long per_block = SA_THREADS / 32;
  const long long blocks = (total + per_block - 1) / per_block;
  scatter_add_kernel<T><<<(unsigned)blocks, SA_THREADS, 0, stream>>>(
      static_cast<const T*>(updates), idx, out, total, K, C, num_rows);
  return cudaGetLastError();
}

// out must be zeroed by the caller. Returns a cudaError_t code.
extern "C" int scatter_add(const void* updates, int dtype, const int* idx,
                           float* out, int G, int K, int C, int num_rows,
                           void* stream) {
  if (G < 1 || K < 1 || C < 1 || num_rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)launch<float>(updates, idx, out, G, K, C, num_rows, s);
  if (dtype == kBF16)
    return (int)launch<__nv_bfloat16>(updates, idx, out, G, K, C, num_rows,
                                      s);
  return (int)cudaErrorInvalidValue;
}
