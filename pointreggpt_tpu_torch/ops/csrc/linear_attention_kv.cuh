// The k/v side of the LinearAttention core in CUDA-core fp32 FMAs, the
// bodies of K4 (linear_attention_core.cu, the core alone on packed qkv),
// and the constants K1 and K3 share with it (their bodies are on the
// tensor cores: linear_attention_tc.cuh, linear_attention_tf32.cuh):
//
//   k, v = qkv[:, 128:256], qkv[:, 256:384]
//   m    = max_n k                   (per lane, online)
//   s    = sum_n exp(k - m)
//   C    = sum_n round_T(exp(k - m))^T v   (the four 32x32 head blocks)
//   C^   = round_T(C / max(s, 1e-30) * 32^-1/2 / n)
//
// Blocks run in parallel and carry nothing, so the statistics come in two
// launches: kv_partials_body over (split, batch) writes per-split (m, s, C)
// partials; merge_context_body over batch merges them with max-rescaling.
// kv_partials_body takes its rows of k and v from a row loader (LoadKV).
// q_context_body is K4's q side: per-head softmax of q, then q C^. Each
// kernel file wraps these bodies in __global__ kernels of its own names,
// so a profile tells the kernels' launches apart.

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
constexpr int THREADS = 256;
constexpr int ROWS = 16;              // rows per tile

// Dynamic shared memory of kv_partials_body whose loader stages c
// channels per row (c = 0: LoadKV stages nothing).
inline size_t kv_partials_smem(int c) {
  return sizeof(float) * (ROWS * c + ROWS * 3 * HID + 2 * HID);
}

// Row loader of kv_partials_body: called by all THREADS threads, fills
// kv[r * 2 * HID + j] (r < rows, j < 2 * HID: k, then v) for rows
// r0 .. r0 + rows of batch row bi; the first argument is the loader's
// staging, none here.
template <typename T>
struct LoadKV {  // k and v read from packed qkv (b, n, 3 * HID): K4
  const T* qkv;

  __device__ __forceinline__ void operator()(float*, float* kv, int bi,
                                             int n, int r0,
                                             int rows) const {
    const int tid = threadIdx.x;  // lane tid of [k | v]
    const T* src = qkv + (static_cast<size_t>(bi) * n + r0) * QKV + HID + tid;
    for (int r = 0; r < rows; ++r)
      kv[r * 2 * HID + tid] = to_f(src[static_cast<size_t>(r) * QKV]);
  }
};

template <typename T, typename LoadRows>
__device__ __forceinline__ void kv_partials_body(
    const LoadRows& load_rows, float* __restrict__ part, int n, int c,
    int rows_per_split, int splits) {
  extern __shared__ float smem[];
  float* xs = smem;                     // ROWS * c, the loader's staging
  float* kv = xs + ROWS * c;            // ROWS * 2*HID, [k | v]
  float* ek = kv + ROWS * 2 * HID;      // ROWS * HID, exp(k - m) in T
  float* m_s = ek + ROWS * HID;         // HID running max
  float* alpha_s = m_s + HID;           // HID rescale for this tile

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int bi = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);

  // this thread's C entries: row cd, 16 columns inside cd's head block
  const int cd = tid >> 1;
  const int ce0 = (cd / DH) * DH + (tid & 1) * 16;
  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
  float run_s = 0.f;
  if (tid < HID) m_s[tid] = -INFINITY;

  for (int r0 = r_begin; r0 < r_end; r0 += ROWS) {
    const int rows = min(ROWS, r_end - r0);
    __syncthreads();
    load_rows(xs, kv, bi, n, r0, rows);
    __syncthreads();

    if (tid < HID) {
      float tmax = -INFINITY;
      for (int r = 0; r < rows; ++r) tmax = fmaxf(tmax, kv[r * 2 * HID + tid]);
      const float m_old = m_s[tid];
      const float m_new = fmaxf(m_old, tmax);
      const float al = expf(m_old - m_new);
      float ssum = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float e = expf(kv[r * 2 * HID + tid] - m_new);
        ssum += e;
        ek[r * HID + tid] = rnd<T>(e);
      }
      run_s = run_s * al + ssum;
      m_s[tid] = m_new;
      alpha_s[tid] = al;
    }
    __syncthreads();

    const float al = alpha_s[cd];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] *= al;
    for (int r = 0; r < rows; ++r) {
      const float p = ek[r * HID + cd];
      const float* vr = kv + r * 2 * HID + HID + ce0;
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = fmaf(p, vr[j], acc[j]);
    }
  }

  __syncthreads();
  float* out = part + (static_cast<size_t>(bi) * splits + split) * PSTRIDE;
  if (tid < HID) {
    out[tid] = m_s[tid];
    out[HID + tid] = run_s;
  }
  float* cout = out + 2 * HID + (cd / DH) * DH * DH + (cd % DH) * DH +
                (ce0 % DH);
#pragma unroll
  for (int j = 0; j < 16; ++j) cout[j] = acc[j];
}

// Merge the partials of batch row blockIdx.x: C^ (rounded to T) into chat
// and, when stats is not null, the merged m, s and unscaled C into
// stats[bi * STATS + (0 | HID | 2 * HID)].
template <typename T>
__device__ __forceinline__ void merge_context_body(
    const float* __restrict__ part, float* __restrict__ chat,
    float* __restrict__ stats, int splits, float scale) {
  __shared__ float m_s[HID];
  __shared__ float inv_s[HID];
  const int tid = threadIdx.x;
  const int bi = blockIdx.x;
  const float* pb = part + static_cast<size_t>(bi) * splits * PSTRIDE;
  float* st = stats ? stats + static_cast<size_t>(bi) * STATS : nullptr;

  if (tid < HID) {
    float m = -INFINITY;
    for (int i = 0; i < splits; ++i) m = fmaxf(m, pb[i * PSTRIDE + tid]);
    float s = 0.f;
    for (int i = 0; i < splits; ++i) {
      const float mi = pb[i * PSTRIDE + tid];
      if (mi != -INFINITY) s += pb[i * PSTRIDE + HID + tid] * expf(mi - m);
    }
    m_s[tid] = m;
    inv_s[tid] = 1.f / fmaxf(s, 1e-30f);
    if (st) {
      st[tid] = m;
      st[HID + tid] = s;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < CBLK; idx += THREADS) {
    const int d = (idx / (DH * DH)) * DH + (idx / DH) % DH;
    float acc = 0.f;
    for (int i = 0; i < splits; ++i) {
      const float mi = pb[i * PSTRIDE + d];
      if (mi != -INFINITY)
        acc += pb[i * PSTRIDE + 2 * HID + idx] * expf(mi - m_s[d]);
    }
    chat[static_cast<size_t>(bi) * CBLK + idx] = rnd<T>(acc * scale * inv_s[d]);
    if (st) st[2 * HID + idx] = acc;
  }
}

// The q side of K4's forward for one tile of rows: qs holds q
// (rows x HID, rounded to T) and becomes its per-head softmax (rounded to
// T); core = qs C^ on the head blocks (rounded to T), ch holding C^
// (CBLK). Called by all THREADS threads; returns after a barrier.
template <typename T>
__device__ __forceinline__ void q_context_body(float* qs,
                                               const float* ch,
                                               float* core, int rows) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // softmax over each head's 32 lanes: one warp per (row, head)
  for (int task = warp; task < rows * NH; task += THREADS / 32) {
    float* qv = qs + (task / NH) * HID + (task % NH) * DH;
    const float v = qv[lane];
    const float e = expf(v - prgpt::warp_max(v));
    qv[lane] = rnd<T>(e / prgpt::warp_sum(e));
  }
  __syncthreads();

  // core = q C^, head blocks only
  for (int idx = tid; idx < rows * HID; idx += THREADS) {
    const int r = idx / HID;
    const int e = idx % HID;
    const int h = e / DH;
    const float* qv = qs + r * HID + h * DH;
    const float* cv = ch + h * DH * DH + (e % DH);
    float a = 0.f;
#pragma unroll
    for (int dl = 0; dl < DH; ++dl) a = fmaf(qv[dl], cv[dl * DH], a);
    core[idx] = rnd<T>(a);
  }
  __syncthreads();
}

}  // namespace la
}  // namespace prgpt
