// Attention dropout of K2 / K2b: counter-based keep bits, regenerated
// wherever they are needed (forward, backward, a with_cp recompute), so
// nothing of the (B, nW, H, n, n) size is drawn on the host or stored.
//
// Philox4x32-10 (Salmon et al., SC'11) with curand's and Random123's
// constants; rscotr_tpu_torch/ops/philox.py is the same function in plain
// PyTorch. An element of the probabilities P is kept when word 0 of
// Philox(counter = its flat index in (B, nW, H, n, n), key = the call's
// seed) is at least `threshold` = ceil(p 2^32); a kept element is scaled by
// 1 / (1 - p). The threshold is 64-bit so that p = 1 (2^32) keeps nothing.
//
// Cost: ten rounds of two 32-bit multiply-high / multiply-low pairs for
// every element (the last round reduced to word 0 by the compiler). It is
// integer work beside the tile's products and adds to the kernels' time;
// the p = 0 bodies (eval mode, and every config of configs/) are compiled
// without it.
#pragma once

#include <stdint.h>

struct Dropout {
  unsigned long long seed;       // the Philox key
  unsigned long long threshold;  // keep when word 0 >= threshold
  float scale;                   // 1 / (1 - p)
};

__device__ __forceinline__ uint32_t philox_word0(unsigned long long ctr,
                                                 unsigned long long key) {
  uint32_t c0 = (uint32_t)ctr, c1 = (uint32_t)(ctr >> 32), c2 = 0u, c3 = 0u;
  uint32_t k0 = (uint32_t)key, k1 = (uint32_t)(key >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// whether flat element `idx` of the probabilities is kept
__device__ __forceinline__ bool dropout_keep(const Dropout& d,
                                             unsigned long long idx) {
  return (unsigned long long)philox_word0(idx, d.seed) >= d.threshold;
}

// what P[idx] is multiplied by: 1 / (1 - p) if kept, else 0
__device__ __forceinline__ float dropout_factor(const Dropout& d,
                                               unsigned long long idx) {
  return dropout_keep(d, idx) ? d.scale : 0.f;
}
