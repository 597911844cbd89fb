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
//   C  emit_out      q projection, per-head softmax, q C^, out projection
//                    + bias, LayerNorm, store T.
// Intermediates (qkv, core, pre-norm output) never leave shared memory or
// registers; only x is read twice, as on the TPU.
//
// bf16 (the DiffusionUNet): the bodies of linear_attention_tc.cuh: A and C
// on the tensor cores (64-row tiles, cp.async staging, weights resident in
// shared memory where they fit, ldmatrix + mma.sync.m16n8k16 for the three
// projections, the two context products and the out projection; C on a
// persistent grid), B with one thread per entry of C^. fp32 (the MaskUNet):
// the CUDA-core bodies of linear_attention_kv.cuh (16-row tiles, fp32
// FMAs, weights read through L1/L2; TF32 would not hold the fp32
// tolerance), A and B shared with K3.
//
// Rounding follows the plain PyTorch version (ops/linear_attention.py):
// qkv, exp(k - m), C^, the softmaxed q, the core and the projected output
// (+ bias) are rounded to T where that version materializes them in T.

#include "linear_attention_kv.cuh"
#include "linear_attention_tc.cuh"

#include <math.h>

#include <mutex>

namespace {

using prgpt::from_f;
using prgpt::rnd;
using prgpt::to_f;
using namespace prgpt::la;

template <typename T>
__global__ void __launch_bounds__(THREADS)
kv_partials(const T* __restrict__ x, const T* __restrict__ wqkv,
            float* __restrict__ part, int n, int c, int rows_per_split,
            int splits) {
  kv_partials_body<T>(ProjectKV<T>{x, wqkv, c}, part, n, c,
                      rows_per_split, splits);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
merge_context(const float* __restrict__ part, float* __restrict__ chat,
              int splits, float scale) {
  merge_context_body<T>(part, chat, nullptr, splits, scale);
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

  // per-head softmax of q, then core = q C^ (head blocks only)
  q_context_body<T>(qs, ch, core, rows);

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
  const size_t smem_a = kv_partials_smem(c);
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

__global__ void __launch_bounds__(tc::NTHREADS, 2)
kv_partials_tc(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ wqkv,
               float* __restrict__ part, int n, int c, int rows_per_split,
               int splits, int resident, int stage_bytes) {
  tc::kv_partials_tc_body(x, wqkv, part, n, c, rows_per_split, splits,
                          resident, stage_bytes);
}

__global__ void __launch_bounds__(tc::NTHREADS)
merge_context_tc(const float* __restrict__ part, float* __restrict__ chat,
                 int splits, float scale) {
  tc::merge_context_tc_body(part, chat, nullptr, splits, scale);
}

__global__ void __launch_bounds__(tc::NTHREADS)
emit_out_tc(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ wqkv,
            const __nv_bfloat16* __restrict__ wout,
            const float* __restrict__ bout, const float* __restrict__ g,
            const float* __restrict__ chat, __nv_bfloat16* __restrict__ out,
            int b, int n, int c, float eps, int resident, int stage_bytes,
            int yglob) {
  tc::emit_out_tc_body(x, wqkv, wout, bout, g, chat, out, b, n, c, eps,
                       resident, stage_bytes, yglob);
}

// bf16: kernels A and C on the tensor cores. cp.async moves 16-byte
// chunks, so c must be a multiple of 8 and every tensor 16-byte aligned.
cudaError_t launch_tc(const void* x, const void* wqkv, const void* wout,
                      const float* bout, const float* g, void* out,
                      float* part, float* chat, int b, int n, int c,
                      int splits, int rows_per_split, float eps,
                      cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (c % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wqkv) |
       reinterpret_cast<uintptr_t>(wout) | reinterpret_cast<uintptr_t>(g) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return cudaErrorInvalidValue;
  // the card's limits, the kernels' shared-memory caps and kernel C's
  // occupancy, looked up once per device and size: the wrapper runs 2,016
  // times per sample step, and each lookup costs microseconds of host time
  struct Cache {
    int max_smem = 0, sms = 0;
    size_t cap_a = 0, cap_c = 0, occ_smem = 0;
    int per_sm = 0;
  };
  static Cache caches[64];
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(lock);
  Cache& k = caches[dev];
  if (k.sms == 0) {
    err = cudaDeviceGetAttribute(&k.max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&k.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const size_t cap = static_cast<size_t>(k.max_smem);

  const int res_a = tc::kv_smem(c, true) <= cap;
  const size_t smem_a = tc::kv_smem(c, res_a);
  const int res_c = tc::emit_smem(c, true) <= cap;
  // above c of about 1,200 a tile of y no longer fits beside the ring: it
  // goes through out's rows (in L2) instead
  const int yglob = !res_c && tc::emit_smem(c, false) > cap;
  const size_t smem_c = tc::emit_smem(c, res_c, yglob);
  if (smem_a > cap || smem_c > cap) return cudaErrorInvalidValue;
  if (smem_a > k.cap_a) {
    err = prgpt::allow_smem(kv_partials_tc, smem_a);
    if (err != cudaSuccess) return err;
    k.cap_a = smem_a;
  }
  if (smem_c > k.cap_c) {
    err = prgpt::allow_smem(emit_out_tc, smem_c);
    if (err != cudaSuccess) return err;
    k.cap_c = smem_c;
  }
  if (smem_c != k.occ_smem) {
    // persistent grid of kernel C: as many blocks as fit on the card
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &k.per_sm, emit_out_tc, tc::NTHREADS, smem_c);
    if (err != cudaSuccess) return err;
    k.occ_smem = smem_c;
  }

  kv_partials_tc<<<dim3(splits, b), tc::NTHREADS, smem_a, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv), part, n,
      c, rows_per_split, splits, res_a,
      res_a ? tc::X_BYTES : tc::X_BYTES + tc::WKV_BYTES);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const float scale = rsqrtf(static_cast<float>(DH)) / static_cast<float>(n);
  merge_context_tc<<<dim3(CBLK / tc::NTHREADS, b), tc::NTHREADS, 0, stream>>>(
      part, chat, splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // as few blocks as take every tile in equal runs of consecutive tiles
  const int tiles = b * ((n + tc::TM - 1) / tc::TM);
  const int slots = k.sms * (k.per_sm > 0 ? k.per_sm : 1);
  const int per = (tiles + slots - 1) / slots;
  const int grid = (tiles + per - 1) / per;
  emit_out_tc<<<grid, tc::NTHREADS, smem_c, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(wout), bout, g, chat, static_cast<bf16*>(out),
      b, n, c, eps, res_c,
      res_c ? tc::X_BYTES : tc::X_BYTES + tc::WQ_BYTES, yglob);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per tile of kernel A: the wrapper sizes its splits in whole tiles.
int prgpt_linear_attention_rows_per_tile(int is_bf16) {
  return is_bf16 ? tc::TM : ROWS;
}

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
    return launch_tc(x, wqkv, wout, bout, g, out, part, chat, b, n, c,
                     splits, rows_per_split, eps, s);
  return launch<float>(x, wqkv, wout, bout, g, out, part, chat, b, n, c,
                       splits, rows_per_split, eps, s);
}

}  // extern "C"
