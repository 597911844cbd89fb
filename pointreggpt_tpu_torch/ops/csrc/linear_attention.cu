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
//   B  merge_context grid (16, b): merges the partials with max-rescaling
//                    and writes C^ (head blocks only), rounded to T, one
//                    thread per entry.
//   C  emit_out      persistent grid: q projection, per-head softmax, q C^,
//                    out projection + bias, LayerNorm, store T.
// Each has a bf16 body (suffix _tc) and an fp32 one (_tf32).
// Intermediates (qkv, core, pre-norm output) never leave shared memory or
// registers; only x is read twice, as on the TPU.
//
// bf16 (the DiffusionUNet): the bodies of linear_attention_tc.cuh: A and C
// on the tensor cores (64-row tiles, cp.async staging, weights resident in
// shared memory where they fit, ldmatrix + mma.sync.m16n8k16 for the three
// projections, the two context products and the out projection; C on a
// persistent grid), B with one thread per entry of C^. fp32 (the MaskUNet):
// A and C are linear_attention_tf32.cuh's bodies, the same design on the
// TF32 tensor cores with every product in three passes (a_lo b_hi + a_hi
// b_lo + a_hi b_hi, about 21 bits of each product; one TF32 pass, 10 bits,
// would not hold the fp32 tolerance), 32-channel chunks and fp32 byte
// counts; B with one thread per entry of C^, as in bf16. K3's fp32
// backward launches the same A and B. Bound of the fp32 forward at batch
// 8, summed over a U-Net forward's eight shapes: 3 x 136.7 GFLOP of TF32
// products, 0.83 ms at 494.7 TFLOP/s, against 0.89 GB moved, 0.27 ms.
//
// Rounding follows the plain PyTorch version (ops/linear_attention.py):
// qkv, exp(k - m), C^, the softmaxed q, the core and the projected output
// (+ bias) are rounded to T where that version materializes them in T.

#include "linear_attention_kv.cuh"
#include "linear_attention_tc.cuh"
#include "linear_attention_tf32.cuh"

#include <math.h>

#include <mutex>

namespace {

using namespace prgpt::la;

// The card's limits, the kernels' shared-memory caps and kernel C's
// occupancy, per device and body (0: bf16, 1: fp32), looked up once per
// device and size: the wrapper runs 2,016 times per sample step, and each
// lookup costs microseconds of host time. Guarded by limits_lock.
struct Limits {
  int max_smem = 0, sms = 0;
  size_t cap_a = 0, cap_c = 0, occ_smem = 0;
  int per_sm = 0;
};
std::mutex limits_lock;

cudaError_t card_limits(int body, Limits** out) {
  static Limits limits[2][64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  Limits& k = limits[body][dev];
  if (k.sms == 0) {
    err = cudaDeviceGetAttribute(&k.max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&k.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *out = &k;
  return cudaSuccess;
}

// Raise kernels A's and C's shared-memory caps to smem_a and smem_c where
// they are lower, and look up C's blocks per SM for smem_c.
template <typename KA, typename KC>
cudaError_t grant(Limits& k, KA ka, size_t smem_a, KC kc, size_t smem_c,
                  int threads) {
  cudaError_t err;
  if (smem_a > k.cap_a) {
    if ((err = prgpt::allow_smem(ka, smem_a)) != cudaSuccess) return err;
    k.cap_a = smem_a;
  }
  if (smem_c > k.cap_c) {
    if ((err = prgpt::allow_smem(kc, smem_c)) != cudaSuccess) return err;
    k.cap_c = smem_c;
  }
  if (smem_c != k.occ_smem) {
    // persistent grid of kernel C: as many blocks as fit on the card
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k.per_sm, kc,
                                                        threads, smem_c);
    if (err != cudaSuccess) return err;
    k.occ_smem = smem_c;
  }
  return cudaSuccess;
}

// Kernel C's persistent grid: as few blocks as take every one of `tiles`
// tiles in equal runs of consecutive tiles.
int persistent_grid(const Limits& k, int tiles) {
  const int slots = k.sms * (k.per_sm > 0 ? k.per_sm : 1);
  const int per = (tiles + slots - 1) / slots;
  return (tiles + per - 1) / per;
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
  merge_context_body<__nv_bfloat16>(part, chat, nullptr, splits, scale);
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
  std::lock_guard<std::mutex> guard(limits_lock);
  Limits* k = nullptr;
  cudaError_t err = card_limits(0, &k);
  if (err != cudaSuccess) return err;
  const size_t cap = static_cast<size_t>(k->max_smem);

  const int res_a = tc::kv_smem(c, true) <= cap;
  const size_t smem_a = tc::kv_smem(c, res_a);
  const int res_c = tc::emit_smem(c, true) <= cap;
  // above c of about 1,200 a tile of y no longer fits beside the ring: it
  // goes through out's rows (in L2) instead
  const int yglob = !res_c && tc::emit_smem(c, false) > cap;
  const size_t smem_c = tc::emit_smem(c, res_c, yglob);
  if (smem_a > cap || smem_c > cap) return cudaErrorInvalidValue;
  err = grant(*k, kv_partials_tc, smem_a, emit_out_tc, smem_c, tc::NTHREADS);
  if (err != cudaSuccess) return err;

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

  emit_out_tc<<<persistent_grid(*k, b * ((n + tc::TM - 1) / tc::TM)),
                tc::NTHREADS, smem_c, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(wout), bout, g, chat, static_cast<bf16*>(out),
      b, n, c, eps, res_c,
      res_c ? tc::X_BYTES : tc::X_BYTES + tc::WQ_BYTES, yglob);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(tf32x3::NTHREADS, 1)
kv_partials_tf32(const float* __restrict__ x, const float* __restrict__ wqkv,
                 float* __restrict__ part, int n, int c, int rows_per_split,
                 int splits, int resident, int stage_bytes, int vec) {
  tf32x3::kv_partials_tf32_body(x, wqkv, part, n, c, rows_per_split, splits,
                                resident, stage_bytes, vec);
}

__global__ void __launch_bounds__(tf32x3::NTHREADS, 1)
emit_out_tf32(const float* __restrict__ x, const float* __restrict__ wqkv,
              const float* __restrict__ wout, const float* __restrict__ bout,
              const float* __restrict__ g, const float* __restrict__ chat,
              float* __restrict__ out, int b, int n, int c, float eps,
              int resident, int stage_bytes, int yglob, int vec) {
  tf32x3::emit_out_tf32_body(x, wqkv, wout, bout, g, chat, out, b, n, c, eps,
                             resident, stage_bytes, yglob, vec);
}

__global__ void __launch_bounds__(tf32x3::NTHREADS)
merge_context_tf32(const float* __restrict__ part, float* __restrict__ chat,
                   int splits, float scale) {
  merge_context_body<float>(part, chat, nullptr, splits, scale);
}

// fp32: kernels A and C on the TF32 tensor cores in three passes, B with
// one thread per entry of C^. 16-byte copies where c % 4 == 0 and every tensor is
// 16-byte aligned, 4-byte copies otherwise.
cudaError_t launch_tf32x3(const float* x, const float* wqkv,
                          const float* wout, const float* bout,
                          const float* g, float* out, float* part,
                          float* chat, int b, int n, int c, int splits,
                          int rows_per_split, float eps, cudaStream_t stream) {
  namespace t3 = tf32x3;
  const int vec =
      c % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wqkv) |
       reinterpret_cast<uintptr_t>(wout) | reinterpret_cast<uintptr_t>(g) |
       reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  std::lock_guard<std::mutex> guard(limits_lock);
  Limits* k = nullptr;
  cudaError_t err = card_limits(1, &k);
  if (err != cudaSuccess) return err;
  const size_t cap = static_cast<size_t>(k->max_smem);

  const int res_a = t3::kv_smem(c, true) <= cap;
  const size_t smem_a = t3::kv_smem(c, res_a);
  const int res_c = t3::emit_smem(c, true) <= cap;
  // above c = 512 a tile of y no longer fits beside the ring: it goes
  // through out's rows (in L2) instead
  const int yglob = !res_c && t3::emit_smem(c, false) > cap;
  const size_t smem_c = t3::emit_smem(c, res_c, yglob);
  if (smem_a > cap || smem_c > cap) return cudaErrorInvalidValue;
  err = grant(*k, kv_partials_tf32, smem_a, emit_out_tf32, smem_c,
              t3::NTHREADS);
  if (err != cudaSuccess) return err;

  kv_partials_tf32<<<dim3(splits, b), t3::NTHREADS, smem_a, stream>>>(
      x, wqkv, part, n, c, rows_per_split, splits, res_a,
      res_a ? t3::X_BYTES : t3::X_BYTES + t3::WKV_BYTES, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const float scale = rsqrtf(static_cast<float>(DH)) / static_cast<float>(n);
  merge_context_tf32<<<dim3(CBLK / t3::NTHREADS, b), t3::NTHREADS, 0,
                       stream>>>(part, chat, splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  emit_out_tf32<<<persistent_grid(*k, b * ((n + t3::TM - 1) / t3::TM)),
                  t3::NTHREADS, smem_c, stream>>>(
      x, wqkv, wout, bout, g, chat, out, b, n, c, eps, res_c,
      res_c ? t3::X_BYTES : t3::X_BYTES + t3::WQ_BYTES, yglob, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per tile of kernel A: the wrapper sizes its splits in whole tiles.
int prgpt_linear_attention_rows_per_tile(int is_bf16) {
  return is_bf16 ? tc::TM : tf32x3::TM;
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
  return launch_tf32x3(
      static_cast<const float*>(x), static_cast<const float*>(wqkv),
      static_cast<const float*>(wout), bout, g, static_cast<float*>(out), part,
      chat, b, n, c, splits, rows_per_split, eps, s);
}

}  // extern "C"
