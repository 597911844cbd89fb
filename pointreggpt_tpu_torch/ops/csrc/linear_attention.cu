// K1: the whole LinearAttention block forward, hand-written for Hopper
// (sm_90a).
//
// Replaces pointreggpt_tpu/ops/linear_attention.py::_pallas_fused.
//
//   k, v = x W_qkv[:, 128:256], x W_qkv[:, 256:384]
//   C    = sum_n exp(k - m)^T v   (online softmax of k over n per lane)
//   C^   = blockdiag_heads(C / max(s, 1e-30)) * 32^-1/2 / n
//   q    = softmax_per_head(x W_qkv[:, :128])
//   out  = LayerNorm_g(q C^ W_out + b_out)      (scale only, biased var)
//
// x (b, n, c) and the weights in T (bf16 or fp32), b_out and g fp32, out T.
// heads = 4, dim_head = 32 (hidden = 128) are compile-time constants.
//
// Bound on this card, at (8, 65536, 64) bf16: the products are 42.9 GFLOP
// (per row 2*4*128*c for the three projections and the out projection, and
// 2*2*4*32*32 for the two context products on the four head blocks), 43 us
// at 989 TFLOP/s. The function must move x once and the output once,
// 134 MB, 40 us at 3.35 TB/s, so it is just operation-bound; this design
// reads x twice (201 MB, 60 us). At the other shapes of a forward the two
// limits lie within 15% of each other (ops/linear_attention.py::work
// counts every shape, and chip_smoke.py turns that into the bound).
//
// Design: the TPU kernel walks n sequentially with (m, s, C) carried in
// VMEM. Here blocks run in parallel and carry nothing, so one wrapper call
// is three launches:
//   A  kv_partials   grid (splits, b): each block streams its row range,
//                    projects k and v in its own body, keeps a running
//                    per-lane max and sum and the four 32x32 head blocks of
//                    C (the off-diagonal blocks are masked anyway, so they
//                    are never computed), and writes (m, s, C) partials.
//   B  merge_context grid (b): merges the partials with max-rescaling and
//                    writes C^ (head blocks only), rounded to T.
//   C  emit_out      grid (row tiles, b): q projection, per-head softmax,
//                    q C^, out projection + bias, LayerNorm, store T.
// Intermediates (qkv, core, pre-norm output) never leave shared memory;
// only x is read twice, as on the TPU. Weights are read through L1/L2 (at
// c = 512 W_qkv is 384 KB in bf16, beyond shared memory), never staged
// whole. Products run as fp32 FMAs on the CUDA cores: correct and simple,
// far from the tensor-core rate (wgmma + TMA is later work).
//
// Rounding follows the plain PyTorch version (ops/linear_attention.py):
// qkv, exp(k - m), C^, the softmaxed q, the core and the projected output
// (+ bias) are rounded to T where that version materializes them in T.

#include "common.cuh"

#include <math.h>

namespace {

using prgpt::from_f;
using prgpt::rnd;
using prgpt::to_f;

constexpr int HID = 128;              // heads * dim_head
constexpr int DH = 32;                // dim_head
constexpr int NH = HID / DH;          // heads
constexpr int QKV = 3 * HID;          // packed projection width
constexpr int CBLK = NH * DH * DH;    // head-diagonal blocks of C
constexpr int PSTRIDE = 2 * HID + CBLK;  // one partial: m, s, C blocks
constexpr int THREADS = 256;
constexpr int ROWS = 16;              // rows per tile

template <typename T>
__global__ void __launch_bounds__(THREADS)
kv_partials(const T* __restrict__ x, const T* __restrict__ wqkv,
            float* __restrict__ part, int n, int c, int rows_per_split,
            int splits) {
  extern __shared__ float smem[];
  float* xs = smem;                     // ROWS * c
  float* kv = xs + ROWS * c;            // ROWS * 2*HID, [k | v]
  float* ek = kv + ROWS * 2 * HID;      // ROWS * HID, exp(k - m) in T
  float* m_s = ek + ROWS * HID;         // HID running max
  float* alpha_s = m_s + HID;           // HID rescale for this tile

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int bi = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);
  const T* xb = x + static_cast<size_t>(bi) * n * c;

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
    for (int i = tid; i < rows * c; i += THREADS)
      xs[i] = to_f(xb[static_cast<size_t>(r0) * c + i]);
    __syncthreads();

    // kv column tid (k for tid < 128, v above), all rows of the tile
    {
      float a[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) a[r] = 0.f;
      const T* wcol = wqkv + HID + tid;
      for (int ci = 0; ci < c; ++ci) {
        const float w = to_f(wcol[static_cast<size_t>(ci) * QKV]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) a[r] = fmaf(xs[r * c + ci], w, a[r]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (r < rows) kv[r * 2 * HID + tid] = rnd<T>(a[r]);
    }
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
merge_context(const float* __restrict__ part, float* __restrict__ chat,
              int splits, float scale) {
  __shared__ float m_s[HID];
  __shared__ float inv_s[HID];
  const int tid = threadIdx.x;
  const int bi = blockIdx.x;
  const float* pb = part + static_cast<size_t>(bi) * splits * PSTRIDE;

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
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
emit_out(const T* __restrict__ x, const T* __restrict__ wqkv,
         const T* __restrict__ wout, const float* __restrict__ bout,
         const float* __restrict__ g, const float* __restrict__ chat,
         T* __restrict__ out, int n, int c, float eps) {
  extern __shared__ float smem[];
  float* xs = smem;                 // ROWS * c; reused for the projection
  float* qs = xs + ROWS * c;        // ROWS * HID
  float* core = qs + ROWS * HID;    // ROWS * HID
  float* ch = core + ROWS * HID;    // CBLK

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bi = blockIdx.y;
  const int r0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, n - r0);
  const size_t row0 = static_cast<size_t>(bi) * n + r0;

  for (int i = tid; i < CBLK; i += THREADS)
    ch[i] = chat[static_cast<size_t>(bi) * CBLK + i];
  for (int i = tid; i < rows * c; i += THREADS)
    xs[i] = to_f(x[row0 * c + i]);
  __syncthreads();

  // q = x W_q: column tid % 128, rows tid / 128 + 2k
  {
    const int col = tid & (HID - 1);
    const int rh = tid >> 7;
    float a[ROWS / 2];
#pragma unroll
    for (int k = 0; k < ROWS / 2; ++k) a[k] = 0.f;
    for (int ci = 0; ci < c; ++ci) {
      const float w = to_f(wqkv[static_cast<size_t>(ci) * QKV + col]);
#pragma unroll
      for (int k = 0; k < ROWS / 2; ++k)
        a[k] = fmaf(xs[(rh + 2 * k) * c + ci], w, a[k]);
    }
#pragma unroll
    for (int k = 0; k < ROWS / 2; ++k)
      if (rh + 2 * k < rows) qs[(rh + 2 * k) * HID + col] = rnd<T>(a[k]);
  }
  __syncthreads();

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

  // y = core W_out + b_out, into xs
  for (int j = tid; j < c; j += THREADS) {
    float a[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) a[r] = 0.f;
    for (int e = 0; e < HID; ++e) {
      const float w = to_f(wout[static_cast<size_t>(e) * c + j]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) a[r] = fmaf(core[r * HID + e], w, a[r]);
    }
    const float bj = rnd<T>(bout[j]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < rows) xs[r * c + j] = rnd<T>(rnd<T>(a[r]) + bj);
  }
  __syncthreads();

  // LayerNorm over c: one warp per row
  for (int r = warp; r < rows; r += THREADS / 32) {
    const float* yr = xs + r * c;
    float s = 0.f;
    for (int j = lane; j < c; j += 32) s += yr[j];
    const float mean = prgpt::warp_sum(s) / c;
    float v = 0.f;
    for (int j = lane; j < c; j += 32) {
      const float d = yr[j] - mean;
      v = fmaf(d, d, v);
    }
    const float inv = rsqrtf(prgpt::warp_sum(v) / c + eps);
    T* orow = out + (row0 + r) * c;
    for (int j = lane; j < c; j += 32)
      orow[j] = from_f<T>((yr[j] - mean) * inv * g[j]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wqkv, const void* wout,
                   const float* bout, const float* g, void* out,
                   float* part, float* chat, int b, int n, int c,
                   int splits, int rows_per_split, float eps,
                   cudaStream_t stream) {
  const size_t smem_a = sizeof(float) * (ROWS * c + ROWS * 3 * HID + 2 * HID);
  const size_t smem_c = sizeof(float) * (ROWS * c + 2 * ROWS * HID + CBLK);
  cudaError_t err = prgpt::allow_smem(kv_partials<T>, smem_a);
  if (err != cudaSuccess) return err;
  err = prgpt::allow_smem(emit_out<T>, smem_c);
  if (err != cudaSuccess) return err;

  kv_partials<T><<<dim3(splits, b), THREADS, smem_a, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), part, n, c,
      rows_per_split, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const float scale = rsqrtf(static_cast<float>(DH)) / static_cast<float>(n);
  merge_context<T><<<b, THREADS, 0, stream>>>(part, chat, splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  emit_out<T><<<dim3((n + ROWS - 1) / ROWS, b), THREADS, smem_c, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv),
      static_cast<const T*>(wout), bout, g, chat, static_cast<T*>(out), n, c,
      eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per tile: the wrapper sizes its splits in whole tiles.
int prgpt_linear_attention_rows_per_tile() { return ROWS; }

// Scratch floats the wrapper must allocate for (b, splits).
long long prgpt_linear_attention_scratch(int b, int splits) {
  return static_cast<long long>(b) * splits * PSTRIDE +
         static_cast<long long>(b) * CBLK;
}

int prgpt_linear_attention(const void* x, const void* wqkv, const void* wout,
                           const float* bout, const float* g, void* out,
                           float* scratch, int b, int n, int c, int splits,
                           int rows_per_split, float eps, int is_bf16,
                           void* stream) {
  float* part = scratch;
  float* chat = scratch + static_cast<size_t>(b) * splits * PSTRIDE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, wqkv, wout, bout, g, out, part, chat, b,
                                 n, c, splits, rows_per_split, eps, s);
  return launch<float>(x, wqkv, wout, bout, g, out, part, chat, b, n, c,
                       splits, rows_per_split, eps, s);
}

}  // extern "C"
