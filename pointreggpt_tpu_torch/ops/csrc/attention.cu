// K2: bottleneck full attention softmax(q k^T * scale) v, hand-written for
// Hopper (sm_90a).
//
// Replaces pointreggpt_tpu/ops/attention.py::_attention_pallas.
//
// q, k, v (b, n, h, d) in T (bf16 or fp32), possibly strided views of one
// packed (b, n, 3, h, d) projection: element (bi, row, hi, dd) sits at
// bi * sb + row * sn + hi * d + dd. Math is fp32; the output is written
// contiguous (b, n, h, d) in T.
//
// Bound on this card at the production shape (8, 1024, 4, 32) bf16:
// 4 tensors x 2 MB = 8.4 MB moved, 2.5 us at 3.35 TB/s, against
// 2 * 2 * b*h*n*n*d = 4.3 GFLOP, 4.3 us at 989 TFLOP/s: operation-bound.
//
// Design: the TPU kernel holds the whole 1024x1024 fp32 score matrix (4 MB)
// in VMEM, which no Hopper block can. This is a tiled online-softmax (flash)
// kernel: one block per (64-row q tile, b*h) — 16 x 32 = 512 blocks at the
// production shape — one thread per q row holding its scaled q, its running
// max and sum and its fp32 accumulator in registers, looping over 64-row
// k/v tiles staged in shared memory. The scale is applied to q in fp32
// before the product, as the TPU kernel does. Products are fp32 FMAs on the
// CUDA cores (the fp32 math of the reference); tensor cores are later work.

#include "common.cuh"

#include <math.h>

namespace {

using prgpt::from_f;
using prgpt::to_f;

constexpr int TILE = 64;

template <typename T, int D>
__global__ void __launch_bounds__(TILE)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int n, int h,
          long long sb, long long sn, float scale) {
  __shared__ float ks[TILE][D];
  __shared__ float vs[TILE][D];
  const int tid = threadIdx.x;
  const int bi = blockIdx.y / h;
  const int hi = blockIdx.y % h;
  const int row = blockIdx.x * TILE + tid;
  const size_t base = static_cast<size_t>(bi) * sb + static_cast<size_t>(hi) * D;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    qr[dd] = row < n ? to_f(q[base + static_cast<size_t>(row) * sn + dd]) *
                           scale
                     : 0.f;
    acc[dd] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int kt = 0; kt < n; kt += TILE) {
    __syncthreads();
    const int kr = kt + tid;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      const size_t off = base + static_cast<size_t>(kr) * sn + dd;
      ks[tid][dd] = kr < n ? to_f(k[off]) : 0.f;
      vs[tid][dd] = kr < n ? to_f(v[off]) : 0.f;
    }
    __syncthreads();
    const int kn = min(TILE, n - kt);

    float s[TILE];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) dot = fmaf(qr[dd], ks[j][dd], dot);
      s[j] = j < kn ? dot : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float al = expf(m - m_new);
    l *= al;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) acc[dd] *= al;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) acc[dd] = fmaf(p, vs[j][dd], acc[dd]);
    }
    m = m_new;
  }

  if (row < n) {
    T* o = out + ((static_cast<size_t>(bi) * n + row) * h + hi) * D;
    const float inv = 1.f / l;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) o[dd] = from_f<T>(acc[dd] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int n, int h, long long sb, long long sn,
                   float scale, cudaStream_t stream) {
  dim3 grid((n + TILE - 1) / TILE, b * h);
  flash_fwd<T, D><<<grid, TILE, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n, h, sb, sn, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int prgpt_attention(const void* q, const void* k, const void* v,
                               void* out, int b, int n, int h, int d,
                               long long sb, long long sn, float scale,
                               int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32) {
    return is_bf16 ? launch<__nv_bfloat16, 32>(q, k, v, out, b, n, h, sb, sn,
                                               scale, s)
                   : launch<float, 32>(q, k, v, out, b, n, h, sb, sn, scale,
                                       s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
