// The constants of the LinearAttention kernels K1 (linear_attention.cu),
// K3 (linear_attention_bwd.cu) and K4 (linear_attention_core.cu), and the
// one merge of their kv phase:
//
//   k, v = the k and v projections (K1, K3) or thirds of packed qkv (K4)
//   m    = max_n k                   (per lane, online)
//   s    = sum_n exp(k - m)
//   C    = sum_n round_T(exp(k - m))^T v   (the four 32x32 head blocks)
//   C^   = round_T(C / max(s, 1e-30) * 32^-1/2 / n)
//
// Blocks run in parallel and carry nothing, so the statistics come in two
// launches: each kernel's kernel A over (split, batch) writes per-split
// (m, s, C) partials (PSTRIDE floats each; bodies in
// linear_attention_tc.cuh, linear_attention_tf32.cuh and
// linear_attention_core.cu), and merge_context_body over batch merges them
// with max-rescaling. Each kernel file wraps it in a __global__ kernel of
// its own name, so a profile tells the kernels' launches apart.

#pragma once

#include "common.cuh"

#include <math.h>

namespace prgpt {
namespace la {

constexpr int HID = 128;              // heads * dim_head
constexpr int DH = 32;                // dim_head
constexpr int NH = HID / DH;          // heads
constexpr int QKV = 3 * HID;          // packed projection width
constexpr int CBLK = NH * DH * DH;    // head-diagonal blocks of C
constexpr int PSTRIDE = 2 * HID + CBLK;  // one partial: m, s, C blocks
constexpr int STATS = 2 * HID + CBLK;    // merged m, s, C of one batch row
constexpr int THREADS = 256;          // threads of a merge block

// Kernel B over grid (CBLK / THREADS, b): the partials of batch row
// blockIdx.y merged with max-rescaling into C^ (rounded to T), one thread
// per entry of the four head blocks (one block per batch row walking some
// 66 splits per entry serially was a quarter of K1's bf16 forward); when
// stats is not null (K3), also the merged m, s and unscaled C into
// stats[bi * STATS + (0 | HID | 2 * HID)].
template <typename T>
__device__ __forceinline__ void merge_context_body(
    const float* __restrict__ part, float* __restrict__ chat,
    float* __restrict__ stats, int splits, float scale) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  const int bi = blockIdx.y;
  const int d = (idx / (DH * DH)) * DH + (idx / DH) % DH;  // C^'s row lane
  const float* pb = part + static_cast<size_t>(bi) * splits * PSTRIDE;
  float m = -INFINITY;
#pragma unroll 8
  for (int sp = 0; sp < splits; ++sp) m = fmaxf(m, pb[sp * PSTRIDE + d]);
  float s = 0.f, acc = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < splits; ++sp) {
    const float mi = pb[sp * PSTRIDE + d];
    if (mi != -INFINITY) {
      const float w = expf(mi - m);
      s += pb[sp * PSTRIDE + HID + d] * w;
      acc += pb[sp * PSTRIDE + 2 * HID + idx] * w;
    }
  }
  chat[static_cast<size_t>(bi) * CBLK + idx] =
      rnd<T>(acc * scale * (1.f / fmaxf(s, 1e-30f)));
  if (stats) {
    float* st = stats + static_cast<size_t>(bi) * STATS;
    st[2 * HID + idx] = acc;
    if (idx % DH == 0) {
      st[d] = m;
      st[HID + d] = s;
    }
  }
}

}  // namespace la
}  // namespace prgpt
