// K3: the analytic backward of the LinearAttention block (K1), hand-written
// for Hopper (sm_90a).
//
// Replaces pointreggpt_tpu/ops/linear_attention.py::_pallas_fused_bwd.
//
// Given x and dy (b, n, c) in T (bf16 or fp32) and K1's weights (W_qkv
// (c, 384) and W_out (128, c) in T, b_out and g fp32), returns
//   dx_q  = the part of dx through the q projection            (b, n, c) T
//   dx_kv = the part of dx through the k and v projections     (b, n, c) T
//   dW_qkv (c, 384), dW_out (128, c), db_out (c), dg (c)        fp32
// heads = 4, dim_head = 32 are compile-time constants; 1 <= c <= 2048, the
// TPU kernel's own limit (and c % 8 == 0 in bf16).
//
// Bound on this card, at (32, 65536, 64) bf16: the function needs 515
// GFLOP of products (per row 2 * (1536 c + 24,576): the q, k, v and out
// projections once, their transposes for dx, the weight gradients, and the
// six context products on the four head blocks), 0.52 ms at 989 TFLOP/s;
// it must move x, dy, dx_q and dx_kv once, 1.07 GB, 0.32 ms at 3.35 TB/s:
// it is operation-bound (ops/linear_attention.py::work_bwd counts every
// shape, and chip_smoke.py turns that into the bound). This kernel, like
// the TPU one, projects k and v a second time in its kv pass (another
// 256 c products per row) rather than keep them.
//
// Design: the TPU kernel walks n sequentially per batch row in four phases
// and keeps every weight-gradient accumulator in VMEM across the whole
// grid. Hopper blocks carry nothing between them, so one call is these
// launches, each a pure function of its inputs:
//   1 k/v statistics    (splits, b)  the forward's per-split (m, s, C)
//   2 merge             C^ for the q path, and the merged m, s and
//                                    unscaled C the fold needs
//   3 q path            (splits, b)  per row tile: recompute q, its
//                        per-head softmax, the core and the pre-norm output;
//                        LayerNorm backward -> dpre; dcore = dpre W_out^T;
//                        dqs = dcore C^T; softmax backward -> dq; dx_q =
//                        dq W_q^T. Writes core, dpre and dq (in T) for the
//                        weight gradients, and per-block partials of dC^,
//                        dg and db_out kept in registers across its tiles.
//   4 fold_context      (b)          dC^ = round_T(sum of the partials);
//                        dC = dC^ scale / s; ds = -sum_e dC^ C scale / s^2
//   5 kv path           recompute k, v and ek = exp(k - m);
//                        dk = ek (round_T(v dC^T) + ds), dv = round_T(ek) dC,
//                        dx_kv = dk W_k^T + dv W_v^T; writes dk, dv (in T)
//   6 weight gradients x2  split-over-rows products dW_qkv = x^T [dq|dk|dv]
//                        and dW_out = core^T dpre
//   7 reduce_partials x4 sum the partials of dW_qkv, dW_out, dg, db_out
// The gradient through the running max m cancels (C / s does not move when
// m shifts), so m is a constant here, as in the TPU kernel. Every
// reduction across blocks sums its partials in a fixed order, with no
// atomics: two runs agree bit for bit.
//
// Both types run 3, 5 and 6 on the tensor cores, with 64-row tiles and
// weights resident or streamed chunk by chunk (up to c = 2048): bf16 (the
// DiffusionUNet's training path) in linear_attention_bwd_tc.cuh, 1 and 2
// being K1's kernels A and B (linear_attention_tc.cuh); fp32 (the
// MaskUNet's, which trains in fp32) in linear_attention_bwd_tf32.cuh, every
// product in three TF32 passes, 1 and 2 being K1's fp32 kernels A and B
// (linear_attention_tf32.cuh), launched with K1's splits, so that the
// statistics are the forward's bit for bit. The fp32 bound is the three
// passes' operations at the TF32 rate (chip_smoke.py). core, dpre and
// dq|dk|dv round-trip through device memory to feed the weight gradients:
// (128 + c + 384) elements per row.
//
// Rounding follows the plain PyTorch version (the autograd of K1's plain
// version, ops/linear_attention.py::fused_linear_attention_bwd_plain): the
// forward quantities are recomputed with K1's roundings, and dpre, dcore,
// dC^ (after its sum over n), dqs, dq, v dC^T, dk, dv and both dx parts
// are rounded to T where that version materializes them in T. The weight
// gradients stay fp32 (the plain version rounds them to T: at most one T
// step apart).

#include "linear_attention_bwd_tc.cuh"
#include "linear_attention_bwd_tf32.cuh"
#include "linear_attention_kv.cuh"
#include "linear_attention_tf32.cuh"

#include <math.h>

#include <mutex>

namespace {

using prgpt::rnd;
using namespace prgpt::la;

constexpr int MAX_C = 2048;           // widest c, as the TPU kernel's
constexpr int TARGET_BLOCKS = 2 * 2 * 132;  // ~2x the SMs, two waves

__global__ void __launch_bounds__(tf32x3::NTHREADS, 1)
bwd_kv_partials_tf32(const float* __restrict__ x,
                     const float* __restrict__ wqkv, float* __restrict__ part,
                     int n, int c, int rows_per_split, int splits,
                     int resident, int stage_bytes, int vec) {
  tf32x3::kv_partials_tf32_body(x, wqkv, part, n, c, rows_per_split, splits,
                                resident, stage_bytes, vec);
}

__global__ void __launch_bounds__(tf32x3::NTHREADS)
bwd_merge_context_tf32(const float* __restrict__ part,
                       float* __restrict__ chat, float* __restrict__ stats,
                       int splits, float scale) {
  merge_context_body<float>(part, chat, stats, splits, scale);
}

__global__ void __launch_bounds__(bwd32::NTHREADS, 1)
q_path_bwd_tf32(const float* __restrict__ x, const float* __restrict__ dy,
                const float* __restrict__ wqkv, const float* __restrict__ wout,
                const float* __restrict__ bout, const float* __restrict__ g,
                const float* __restrict__ chat, float* __restrict__ dxq,
                float* __restrict__ core_out, float* __restrict__ dpre_out,
                float* __restrict__ dqkv, float* __restrict__ qpart, int n,
                int c, int rows_per_split, int splits, float eps, int resident,
                int stage_bytes, int ysmem, int vec) {
  bwd32::q_path_tf32_body(x, dy, wqkv, wout, bout, g, chat, dxq, core_out,
                          dpre_out, dqkv, qpart, n, c, rows_per_split, splits,
                          eps, resident, stage_bytes, ysmem, vec);
}

__global__ void __launch_bounds__(bwd32::NTHREADS, 1)
kv_path_bwd_tf32(const float* __restrict__ x, const float* __restrict__ wqkv,
                 const float* __restrict__ stats,
                 const float* __restrict__ dctx, float* __restrict__ dxkv,
                 float* __restrict__ dqkv, int n, int c, int rows_per_split,
                 int resident, int stage_bytes, int vec) {
  bwd32::kv_path_tf32_body(x, wqkv, stats, dctx, dxkv, dqkv, n, c,
                           rows_per_split, resident, stage_bytes, vec);
}

__global__ void __launch_bounds__(bwd32::NTHREADS, 2)
wgrad_partials_tf32(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ part, long long rows, int P, int Q,
                    long long rows_per_split, int vec) {
  bwd32::wgrad_tf32_body(a, b, part, rows, P, Q, rows_per_split, vec);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fold_context(const float* __restrict__ qpart, const float* __restrict__ stats,
             float* __restrict__ dctx, int splits, int c, float scale) {
  __shared__ float dchs[CBLK];
  const int tid = threadIdx.x;
  const int bi = blockIdx.x;
  const int qstride = CBLK + 2 * c;
  const float* pb = qpart + static_cast<size_t>(bi) * splits * qstride;
  const float* st = stats + static_cast<size_t>(bi) * STATS;  // m, s, C
  float* out = dctx + static_cast<size_t>(bi) * (CBLK + HID);  // dC, ds

  for (int idx = tid; idx < CBLK; idx += THREADS) {
    float a = 0.f;
    for (int i = 0; i < splits; ++i) a += pb[i * qstride + idx];
    dchs[idx] = rnd<T>(a);
  }
  __syncthreads();

  if (tid < HID) {
    const int h = tid / DH;
    const int dl = tid % DH;
    const float s = fmaxf(st[HID + tid], 1e-30f);
    const float* row = dchs + h * DH * DH + dl * DH;
    const float* crow = st + 2 * HID + h * DH * DH + dl * DH;
    float a = 0.f;
#pragma unroll
    for (int el = 0; el < DH; ++el) a = fmaf(row[el], crow[el], a);
    out[CBLK + tid] = -a * scale / (s * s);
  }
  for (int idx = tid; idx < CBLK; idx += THREADS) {
    const int d = (idx / (DH * DH)) * DH + (idx / DH) % DH;
    out[idx] = dchs[idx] * scale / fmaxf(st[HID + d], 1e-30f);
  }
}

// out[i] = sum over s < count of part[s * stride + i], in order of s
__global__ void __launch_bounds__(THREADS)
reduce_partials(const float* __restrict__ part, long long stride, int count,
                int len, float* __restrict__ out) {
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < len;
       i += gridDim.x * THREADS) {
    float a = 0.f;
    for (int s = 0; s < count; ++s) a += part[s * stride + i];
    out[i] = a;
  }
}


// bf16: the tensor-core kernels of linear_attention_bwd_tc.cuh under names
// of their own, so that a profile tells K3's launches from K1's
__global__ void __launch_bounds__(tc::NTHREADS, 2)
bwd_kv_partials_tc(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ wqkv,
                   float* __restrict__ part, int n, int c,
                   int rows_per_split, int splits, int resident,
                   int stage_bytes) {
  tc::kv_partials_tc_body(x, wqkv, part, n, c, rows_per_split, splits,
                          resident, stage_bytes);
}

__global__ void __launch_bounds__(tc::NTHREADS)
bwd_merge_context_tc(const float* __restrict__ part, float* __restrict__ chat,
                     float* __restrict__ stats, int splits, float scale) {
  merge_context_body<__nv_bfloat16>(part, chat, stats, splits, scale);
}

__global__ void __launch_bounds__(tc::NTHREADS, 2)
q_path_bwd_tc(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ dy,
              const __nv_bfloat16* __restrict__ wqkv,
              const __nv_bfloat16* __restrict__ wout,
              const float* __restrict__ bout, const float* __restrict__ g,
              const float* __restrict__ chat, __nv_bfloat16* __restrict__ dxq,
              __nv_bfloat16* __restrict__ core_out,
              __nv_bfloat16* __restrict__ dpre_out,
              __nv_bfloat16* __restrict__ dqkv, float* __restrict__ qpart,
              int n, int c, int rows_per_split, int splits, float eps,
              int resident, int stage_bytes, int ysmem) {
  tc::q_path_tc_body(x, dy, wqkv, wout, bout, g, chat, dxq, core_out,
                     dpre_out, dqkv, qpart, n, c, rows_per_split, splits, eps,
                     resident, stage_bytes, ysmem);
}

__global__ void __launch_bounds__(tc::NTHREADS, 2)
kv_path_bwd_tc(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ wqkv,
               const float* __restrict__ stats,
               const float* __restrict__ dctx,
               __nv_bfloat16* __restrict__ dxkv,
               __nv_bfloat16* __restrict__ dqkv, int n, int c,
               int rows_per_split, int resident, int stage_bytes) {
  tc::kv_path_tc_body(x, wqkv, stats, dctx, dxkv, dqkv, n, c,
                      rows_per_split, resident, stage_bytes);
}

__global__ void __launch_bounds__(tc::NTHREADS, 2)
wgrad_partials_tc(const __nv_bfloat16* __restrict__ a,
                  const __nv_bfloat16* __restrict__ b,
                  float* __restrict__ part, long long rows, int P, int Q,
                  long long rows_per_split) {
  tc::wgrad_tc_body(a, b, part, rows, P, Q, rows_per_split);
}

// How one call divides its work (the same for both types): row splits
// of the streaming passes (in whole 64-row tiles), row splits of the two
// weight-gradient products, and the fp32 and T scratch they need (counts
// of elements, each part starting on a 32-byte boundary).
struct Plan {
  int kv_splits, kv_rows;              // passes 1 and 2, as K1 splits them
  int splits, rows_per_split;          // passes 3 and 5
  int ws_qkv, ws_out;                  // weight-gradient row splits
  long long wrows_qkv, wrows_out;      // rows per weight-gradient split
  size_t part, chat, stats, qpart, dctx, wq, wo, f_total;  // fp32 offsets
  size_t core, dpre, dqkv, t_total;    // T offsets
};

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Row splits of `rows` in whole `step`s for about `target` blocks.
inline void split_rows(long long rows, long long step, long long target,
                       int* splits, long long* per) {
  const long long steps = cdiv(rows, step);
  long long s = target < 1 ? 1 : target;
  if (s > steps) s = steps;
  const long long steps_per = cdiv(steps, s);
  *splits = static_cast<int>(cdiv(steps, steps_per));
  *per = steps_per * step;
}

static_assert(tc::TM == tf32x3::TM && tc::WG_P == bwd32::WG_P &&
                  tc::WG_Q == bwd32::WG_Q && tc::WG_K == bwd32::WG_K,
              "one plan for both types");

inline Plan plan(int b, int n, int c) {
  Plan p;
  long long per;
  split_rows(n, tc::TM, cdiv(TARGET_BLOCKS, b), &p.kv_splits, &per);
  p.kv_rows = static_cast<int>(per);
  p.splits = p.kv_splits;
  p.rows_per_split = p.kv_rows;
  const long long rows = static_cast<long long>(b) * n;
  // output tiles of each weight-gradient product, and its rows per stage
  split_rows(rows, tc::WG_K,
             cdiv(TARGET_BLOCKS, cdiv(c, tc::WG_P) * cdiv(QKV, tc::WG_Q)),
             &p.ws_qkv, &p.wrows_qkv);
  split_rows(rows, tc::WG_K,
             cdiv(TARGET_BLOCKS, cdiv(HID, tc::WG_P) * cdiv(c, tc::WG_Q)),
             &p.ws_out, &p.wrows_out);
  size_t o = 0;
  auto take = [&o](size_t count) {
    const size_t at = o;
    o = (o + count + 7) / 8 * 8;
    return at;
  };
  p.part = take(static_cast<size_t>(b) * p.kv_splits * PSTRIDE);
  p.chat = take(static_cast<size_t>(b) * CBLK);
  p.stats = take(static_cast<size_t>(b) * STATS);
  p.qpart = take(static_cast<size_t>(b) * p.splits * (CBLK + 2 * c));
  p.dctx = take(static_cast<size_t>(b) * (CBLK + HID));
  p.wq = take(static_cast<size_t>(p.ws_qkv) * c * QKV);
  p.wo = take(static_cast<size_t>(p.ws_out) * HID * c);
  p.f_total = o;
  o = 0;
  p.core = take(static_cast<size_t>(rows) * HID);
  p.dpre = take(static_cast<size_t>(rows) * c);
  p.dqkv = take(static_cast<size_t>(rows) * QKV);
  p.t_total = o;
  return p;
}

inline cudaError_t reduce(const float* part, long long stride, int count,
                          int len, float* out, cudaStream_t stream) {
  const int blocks = static_cast<int>(
      cdiv(len, THREADS) < 1024 ? cdiv(len, THREADS) : 1024);
  reduce_partials<<<blocks, THREADS, 0, stream>>>(part, stride, count, len,
                                                  out);
  return cudaGetLastError();
}

// Launch 7, shared by both types: the weight-gradient partials, and dg and
// db_out from the q path's per-block partials, each summed in order.
inline cudaError_t reduce_all(const Plan& p, const float* fs, float* dwqkv,
                              float* dwout, float* dbout, float* dg, int b,
                              int c, cudaStream_t stream) {
  cudaError_t err;
  const long long qstride = CBLK + 2 * c;
  if ((err = reduce(fs + p.wq, static_cast<long long>(c) * QKV, p.ws_qkv,
                    c * QKV, dwqkv, stream)) != cudaSuccess)
    return err;
  if ((err = reduce(fs + p.wo, static_cast<long long>(HID) * c, p.ws_out,
                    HID * c, dwout, stream)) != cudaSuccess)
    return err;
  if ((err = reduce(fs + p.qpart + CBLK, qstride, b * p.splits, c, dg,
                    stream)) != cudaSuccess)
    return err;
  return reduce(fs + p.qpart + CBLK + c, qstride, b * p.splits, c, dbout,
                stream);
}

// the card's shared-memory cap, and the caps granted so far, per device
// and type (0: bf16, 1: fp32); guarded by limits_lock
struct Cache {
  int max_smem = 0;
  size_t cap_a = 0, cap_q = 0, cap_kv = 0, cap_w = 0;
};
std::mutex limits_lock;

cudaError_t card_cache(int type, Cache** out) {
  static Cache caches[2][64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  Cache& k = caches[type][dev];
  if (k.max_smem == 0) {
    err = cudaDeviceGetAttribute(&k.max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  *out = &k;
  return cudaSuccess;
}

// Raise a kernel's shared-memory cap to bytes where `have` is lower.
template <typename K>
cudaError_t grant(K kernel, size_t bytes, size_t& have) {
  if (bytes <= have) return cudaSuccess;
  const cudaError_t e = prgpt::allow_smem(kernel, bytes);
  if (e == cudaSuccess) have = bytes;
  return e;
}

// fp32 on the TF32 tensor cores, any c and alignment (4-byte staging
// where c % 4 != 0 or a tensor is not 16-byte aligned).
cudaError_t launch_f32(const float* x, const float* dy, const float* wqkv,
                       const float* wout, const float* bout, const float* g,
                       float* dxq, float* dxkv, float* dwqkv, float* dwout,
                       float* dbout, float* dg, float* fs, float* ts, int b,
                       int n, int c, float eps, cudaStream_t stream) {
  namespace t3 = tf32x3;
  const Plan p = plan(b, n, c);
  const float scale = rsqrtf(static_cast<float>(DH)) / static_cast<float>(n);

  std::lock_guard<std::mutex> guard(limits_lock);
  Cache* kp = nullptr;
  cudaError_t err = card_cache(1, &kp);
  if (err != cudaSuccess) return err;
  Cache& k = *kp;
  const size_t cap = static_cast<size_t>(k.max_smem);
  // kernel A exactly as K1 launches it (linear_attention.cu)
  const int res_a = t3::kv_smem(c, true) <= cap;
  const int vec_a = c % 4 == 0 && (reinterpret_cast<uintptr_t>(x) |
                                   reinterpret_cast<uintptr_t>(wqkv)) % 16 == 0;
  const int vec = c % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(x) |
                   reinterpret_cast<uintptr_t>(dy) |
                   reinterpret_cast<uintptr_t>(wqkv) |
                   reinterpret_cast<uintptr_t>(wout) |
                   reinterpret_cast<uintptr_t>(dxq) |
                   reinterpret_cast<uintptr_t>(dxkv) |
                   reinterpret_cast<uintptr_t>(ts)) % 16 == 0;
  // the q path's row buffer in shared memory where it fits (c <= 384),
  // and with it the weights where they fit too (c <= 64)
  const int res_q = bwd32::q_path_smem(c, true, true) <= cap;
  const int ysm = res_q || bwd32::q_path_smem(c, false, true) <= cap;
  const int res_kv = bwd32::kv_path_smem(c, true) <= cap;
  const size_t smem_a = t3::kv_smem(c, res_a);
  const size_t smem_q = bwd32::q_path_smem(c, res_q, ysm);
  const size_t smem_kv = bwd32::kv_path_smem(c, res_kv);
  if (smem_a > cap || smem_q > cap || smem_kv > cap || bwd32::WG_SMEM > cap)
    return cudaErrorInvalidValue;
  if ((err = grant(bwd_kv_partials_tf32, smem_a, k.cap_a)) != cudaSuccess ||
      (err = grant(q_path_bwd_tf32, smem_q, k.cap_q)) != cudaSuccess ||
      (err = grant(kv_path_bwd_tf32, smem_kv, k.cap_kv)) != cudaSuccess ||
      (err = grant(wgrad_partials_tf32, bwd32::WG_SMEM, k.cap_w)) !=
          cudaSuccess)
    return err;

  bwd_kv_partials_tf32<<<dim3(p.kv_splits, b), t3::NTHREADS, smem_a,
                         stream>>>(
      x, wqkv, fs + p.part, n, c, p.kv_rows, p.kv_splits, res_a,
      res_a ? t3::X_BYTES : t3::X_BYTES + t3::WKV_BYTES, vec_a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_merge_context_tf32<<<dim3(CBLK / t3::NTHREADS, b), t3::NTHREADS, 0,
                           stream>>>(fs + p.part, fs + p.chat, fs + p.stats,
                                     p.kv_splits, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  q_path_bwd_tf32<<<dim3(p.splits, b), t3::NTHREADS, smem_q, stream>>>(
      x, dy, wqkv, wout, bout, g, fs + p.chat, dxq, ts + p.core, ts + p.dpre,
      ts + p.dqkv, fs + p.qpart, n, c, p.rows_per_split, p.splits, eps,
      res_q, res_q ? t3::X_BYTES : t3::X_BYTES + t3::WQ_BYTES, ysm, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fold_context<float><<<b, THREADS, 0, stream>>>(
      fs + p.qpart, fs + p.stats, fs + p.dctx, p.splits, c, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kv_path_bwd_tf32<<<dim3(p.splits, b), t3::NTHREADS, smem_kv, stream>>>(
      x, wqkv, fs + p.stats, fs + p.dctx, dxkv, ts + p.dqkv, n, c,
      p.rows_per_split, res_kv,
      res_kv ? t3::X_BYTES : t3::X_BYTES + t3::WKV_BYTES, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long rows = static_cast<long long>(b) * n;
  wgrad_partials_tf32<<<dim3(cdiv(c, bwd32::WG_P), cdiv(QKV, bwd32::WG_Q),
                             p.ws_qkv),
                        t3::NTHREADS, bwd32::WG_SMEM, stream>>>(
      x, ts + p.dqkv, fs + p.wq, rows, c, QKV, p.wrows_qkv, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wgrad_partials_tf32<<<dim3(cdiv(HID, bwd32::WG_P), cdiv(c, bwd32::WG_Q),
                             p.ws_out),
                        t3::NTHREADS, bwd32::WG_SMEM, stream>>>(
      ts + p.core, ts + p.dpre, fs + p.wo, rows, HID, c, p.wrows_out, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_all(p, fs, dwqkv, dwout, dbout, dg, b, c, stream);
}

// bf16 on the tensor cores. cp.async moves 16-byte chunks, so c must be a
// multiple of 8 and every tensor 16-byte aligned (the wrapper checks).
cudaError_t launch_tc(const void* x_, const void* dy_, const void* wqkv_,
                      const void* wout_, const float* bout, const float* g,
                      void* dxq_, void* dxkv_, float* dwqkv, float* dwout,
                      float* dbout, float* dg, float* fs, void* ts_, int b,
                      int n, int c, float eps, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  using T = bf16;
  const bf16* x = static_cast<const bf16*>(x_);
  const bf16* dy = static_cast<const bf16*>(dy_);
  const bf16* wqkv = static_cast<const bf16*>(wqkv_);
  const bf16* wout = static_cast<const bf16*>(wout_);
  bf16* ts = static_cast<bf16*>(ts_);
  if (c % 8 != 0) return cudaErrorInvalidValue;
  const Plan p = plan(b, n, c);
  const float scale = rsqrtf(static_cast<float>(DH)) / static_cast<float>(n);

  std::lock_guard<std::mutex> guard(limits_lock);
  Cache* kp = nullptr;
  cudaError_t err = card_cache(0, &kp);
  if (err != cudaSuccess) return err;
  Cache& k = *kp;
  const size_t cap = static_cast<size_t>(k.max_smem);
  const int res_a = tc::kv_smem(c, true) <= cap;
  // the q path's row buffer in shared memory where it fits (c <= 1024),
  // and with it the weights where they fit too (c <= 256)
  const int res_q = tc::q_path_smem(c, true, true) <= cap;
  const int ysm = res_q || tc::q_path_smem(c, false, true) <= cap;
  const int res_kv = tc::kv_path_smem(c, true) <= cap;
  const size_t smem_a = tc::kv_smem(c, res_a);
  const size_t smem_q = tc::q_path_smem(c, res_q, ysm);
  const size_t smem_kv = tc::kv_path_smem(c, res_kv);
  if (smem_a > cap || smem_q > cap || smem_kv > cap || tc::WG_SMEM > cap)
    return cudaErrorInvalidValue;
  if ((err = grant(bwd_kv_partials_tc, smem_a, k.cap_a)) != cudaSuccess ||
      (err = grant(q_path_bwd_tc, smem_q, k.cap_q)) != cudaSuccess ||
      (err = grant(kv_path_bwd_tc, smem_kv, k.cap_kv)) != cudaSuccess ||
      (err = grant(wgrad_partials_tc, tc::WG_SMEM, k.cap_w)) != cudaSuccess)
    return err;

  bwd_kv_partials_tc<<<dim3(p.kv_splits, b), tc::NTHREADS, smem_a,
                       stream>>>(
      x, wqkv, fs + p.part, n, c, p.kv_rows, p.kv_splits, res_a,
      res_a ? tc::X_BYTES : tc::X_BYTES + tc::WKV_BYTES);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_merge_context_tc<<<dim3(CBLK / tc::NTHREADS, b), tc::NTHREADS, 0,
                         stream>>>(fs + p.part, fs + p.chat, fs + p.stats,
                                   p.kv_splits, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  q_path_bwd_tc<<<dim3(p.splits, b), tc::NTHREADS, smem_q, stream>>>(
      x, dy, wqkv, wout, bout, g, fs + p.chat, static_cast<bf16*>(dxq_),
      ts + p.core, ts + p.dpre, ts + p.dqkv, fs + p.qpart, n, c,
      p.rows_per_split, p.splits, eps, res_q,
      res_q ? tc::X_BYTES : tc::X_BYTES + tc::WQ_BYTES, ysm);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fold_context<T><<<b, THREADS, 0, stream>>>(
      fs + p.qpart, fs + p.stats, fs + p.dctx, p.splits, c, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kv_path_bwd_tc<<<dim3(p.splits, b), tc::NTHREADS, smem_kv, stream>>>(
      x, wqkv, fs + p.stats, fs + p.dctx, static_cast<bf16*>(dxkv_),
      ts + p.dqkv, n, c, p.rows_per_split, res_kv,
      res_kv ? tc::X_BYTES : tc::X_BYTES + tc::WKV_BYTES);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long rows = static_cast<long long>(b) * n;
  wgrad_partials_tc<<<dim3(cdiv(c, tc::WG_P), cdiv(QKV, tc::WG_Q),
                           p.ws_qkv),
                      tc::NTHREADS, tc::WG_SMEM, stream>>>(
      x, ts + p.dqkv, fs + p.wq, rows, c, QKV, p.wrows_qkv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wgrad_partials_tc<<<dim3(cdiv(HID, tc::WG_P), cdiv(c, tc::WG_Q),
                           p.ws_out),
                      tc::NTHREADS, tc::WG_SMEM, stream>>>(
      ts + p.core, ts + p.dpre, fs + p.wo, rows, HID, c, p.wrows_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_all(p, fs, dwqkv, dwout, dbout, dg, b, c, stream);
}

}  // namespace

extern "C" {

// fp32 and T scratch elements the wrapper must allocate for (b, n, c).
long long prgpt_linear_attention_bwd_fscratch(int b, int n, int c) {
  return static_cast<long long>(plan(b, n, c).f_total);
}
long long prgpt_linear_attention_bwd_tscratch(int b, int n, int c) {
  return static_cast<long long>(plan(b, n, c).t_total);
}

int prgpt_linear_attention_bwd(const void* x, const void* dy,
                               const void* wqkv, const void* wout,
                               const float* bout, const float* g, void* dxq,
                               void* dxkv, float* dwqkv, float* dwout,
                               float* dbout, float* dg, float* fscratch,
                               void* tscratch, int b, int n, int c, float eps,
                               int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c < 1 || c > MAX_C) return cudaErrorInvalidValue;
  if (is_bf16)
    return launch_tc(x, dy, wqkv, wout, bout, g, dxq, dxkv, dwqkv, dwout,
                     dbout, dg, fscratch, tscratch, b, n, c, eps, s);
  return launch_f32(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const float*>(wqkv), static_cast<const float*>(wout), bout,
      g, static_cast<float*>(dxq), static_cast<float*>(dxkv), dwqkv, dwout,
      dbout, dg, fscratch, static_cast<float*>(tscratch), b, n, c, eps, s);
}

}  // extern "C"
