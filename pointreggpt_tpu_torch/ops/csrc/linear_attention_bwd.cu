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
// bf16 (the DiffusionUNet's training path): 1 and 2 are K1's kernels A
// and B (linear_attention_tc.cuh); 3, 5 and 6 the tensor-core bodies of
// linear_attention_bwd_tc.cuh, mma.sync with 64-row tiles and weights
// resident or streamed in 64-channel chunks (see that header). fp32 (no
// model path trains in fp32 today): 1 and 2 are K1's fp32 kernels A and B
// (linear_attention_tf32.cuh: A in three TF32 passes), launched with K1's
// splits, so that the statistics are the forward's bit for bit; 3-6 the
// CUDA-core bodies below, fp32 FMAs with one shared-memory load each (not
// yet on the three-pass TF32 split kernel A uses); the q path takes
// 16-row tiles up to c = 1024 and 8-row tiles above, so that x and dy fit
// in shared memory at c = 2048. core, dpre and dq|dk|dv round-trip through
// device memory to feed the weight gradients in both: 2 (128 + c + 384)
// bytes per row.
//
// Rounding follows the plain PyTorch version (the autograd of K1's plain
// version, ops/linear_attention.py::fused_linear_attention_bwd_plain): the
// forward quantities are recomputed with K1's roundings, and dpre, dcore,
// dC^ (after its sum over n), dqs, dq, v dC^T, dk, dv and both dx parts
// are rounded to T where that version materializes them in T. The weight
// gradients stay fp32 (the plain version rounds them to T: at most one T
// step apart).

#include "linear_attention_bwd_tc.cuh"
#include "linear_attention_kv.cuh"
#include "linear_attention_tf32.cuh"

#include <math.h>

#include <mutex>

namespace {

using prgpt::from_f;
using prgpt::rnd;
using prgpt::to_f;
using prgpt::warp_max;
using prgpt::warp_sum;
using namespace prgpt::la;

constexpr int MAX_C = 2048;           // widest c, as the TPU kernel's
constexpr int WIDE_C = 1024;          // above: 8-row fp32 q-path tiles
constexpr int CPT = MAX_C / THREADS;  // dg / db columns per thread
constexpr int WT = 64;                // weight-gradient output tile
constexpr int WK = 32;                // rows per weight-gradient stage
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
  tf32x3::merge_context_tf32_body(part, chat, stats, splits, scale);
}

template <typename T, int R>
__global__ void __launch_bounds__(THREADS)
q_path_bwd(const T* __restrict__ x, const T* __restrict__ dy,
           const T* __restrict__ wqkv, const T* __restrict__ wout,
           const float* __restrict__ bout, const float* __restrict__ g,
           const float* __restrict__ chat, T* __restrict__ dxq,
           T* __restrict__ core_out, T* __restrict__ dpre_out,
           T* __restrict__ dqkv, float* __restrict__ qpart, int n, int c,
           int rows_per_split, int splits, float eps) {
  extern __shared__ float smem[];
  float* A = smem;               // R * c: x, then pre, then dpre
  float* B = A + R * c;          // R * c: dy
  float* qsm = B + R * c;        // R * HID: softmaxed q, fp32
  float* cb = qsm + R * HID;     // R * HID: core, then dcore
  float* db = cb + R * HID;      // R * HID: dqs, then dq
  float* ch = db + R * HID;      // CBLK: C^
  float* rs = ch + CBLK;         // R * 4: mean, 1/sigma, the two means

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int bi = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);
  const size_t base = static_cast<size_t>(bi) * n;

  for (int i = tid; i < CBLK; i += THREADS)
    ch[i] = chat[static_cast<size_t>(bi) * CBLK + i];

  // this thread's dC^ entries: row cd, 16 columns inside cd's head block
  const int cd = tid >> 1;
  const int ce0 = (cd / DH) * DH + (tid & 1) * 16;
  float dch[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) dch[j] = 0.f;
  float dg_acc[CPT], db_acc[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) dg_acc[k] = db_acc[k] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += R) {
    const int rows = min(R, r_end - r0);
    const size_t row0 = base + r0;
    __syncthreads();
    for (int i = tid; i < rows * c; i += THREADS) {
      A[i] = to_f(x[row0 * c + i]);
      B[i] = to_f(dy[row0 * c + i]);
    }
    __syncthreads();

    // q = x W_q, rounded to T: column tid % 128, rows tid / 128 + 2k
    {
      const int col = tid & (HID - 1);
      const int rh = tid >> 7;
      float a[R / 2];
#pragma unroll
      for (int k = 0; k < R / 2; ++k) a[k] = 0.f;
      for (int ci = 0; ci < c; ++ci) {
        const float w = to_f(wqkv[static_cast<size_t>(ci) * QKV + col]);
#pragma unroll
        for (int k = 0; k < R / 2; ++k)
          a[k] = fmaf(A[(rh + 2 * k) * c + ci], w, a[k]);
      }
#pragma unroll
      for (int k = 0; k < R / 2; ++k)
        if (rh + 2 * k < rows) qsm[(rh + 2 * k) * HID + col] = rnd<T>(a[k]);
    }
    __syncthreads();

    // softmax over each head's 32 lanes, kept in fp32 for its backward
    for (int task = warp; task < rows * NH; task += THREADS / 32) {
      float* qv = qsm + (task / NH) * HID + (task % NH) * DH;
      const float v = qv[lane];
      const float e = expf(v - warp_max(v));
      qv[lane] = e / warp_sum(e);
    }
    __syncthreads();

    // core = round_T(q_s) C^ on the head blocks, rounded; kept for dW_out
    for (int idx = tid; idx < rows * HID; idx += THREADS) {
      const int r = idx / HID;
      const int e = idx % HID;
      const int h = e / DH;
      const float* qv = qsm + r * HID + h * DH;
      const float* cv = ch + h * DH * DH + (e % DH);
      float a = 0.f;
#pragma unroll
      for (int dl = 0; dl < DH; ++dl) a = fmaf(rnd<T>(qv[dl]), cv[dl * DH], a);
      const float cr = rnd<T>(a);
      cb[idx] = cr;
      core_out[(row0 + r) * HID + e] = from_f<T>(cr);
    }
    __syncthreads();

    // pre = round_T(round_T(core W_out) + round_T(b_out)), into A
    for (int j = tid; j < c; j += THREADS) {
      float a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = 0.f;
      for (int e = 0; e < HID; ++e) {
        const float w = to_f(wout[static_cast<size_t>(e) * c + j]);
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] = fmaf(cb[r * HID + e], w, a[r]);
      }
      const float bj = rnd<T>(bout[j]);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rows) A[r * c + j] = rnd<T>(rnd<T>(a[r]) + bj);
    }
    __syncthreads();

    // per row: LayerNorm mean and 1/sigma, and the means of dxhat and
    // dxhat * xhat (dxhat = dy g) that its backward subtracts
    for (int r = warp; r < rows; r += THREADS / 32) {
      const float* yr = A + r * c;
      const float* dr = B + r * c;
      float s = 0.f;
      for (int j = lane; j < c; j += 32) s += yr[j];
      const float mean = warp_sum(s) / c;
      float v = 0.f;
      for (int j = lane; j < c; j += 32) {
        const float d = yr[j] - mean;
        v = fmaf(d, d, v);
      }
      const float inv = rsqrtf(warp_sum(v) / c + eps);
      float s1 = 0.f, s2 = 0.f;
      for (int j = lane; j < c; j += 32) {
        const float dxh = dr[j] * g[j];
        s1 += dxh;
        s2 = fmaf(dxh, (yr[j] - mean) * inv, s2);
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        rs[4 * r] = mean;
        rs[4 * r + 1] = inv;
        rs[4 * r + 2] = s1 / c;
        rs[4 * r + 3] = s2 / c;
      }
    }
    __syncthreads();

    // dpre = (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) / sigma, rounded,
    // in place of pre; dg += dy xhat, db_out += dpre
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int j = tid + k * THREADS;
      if (j < c) {
        const float gj = g[j];
        for (int r = 0; r < rows; ++r) {
          const float xh = (A[r * c + j] - rs[4 * r]) * rs[4 * r + 1];
          const float dyv = B[r * c + j];
          dg_acc[k] = fmaf(dyv, xh, dg_acc[k]);
          const float dp = rnd<T>(rs[4 * r + 1] *
                                  (dyv * gj - rs[4 * r + 2] -
                                   xh * rs[4 * r + 3]));
          db_acc[k] += dp;
          A[r * c + j] = dp;
          dpre_out[(row0 + r) * c + j] = from_f<T>(dp);
        }
      }
    }
    __syncthreads();

    // dcore = round_T(dpre W_out^T): column e = tid % 128, rows tid/128 + 2k
    {
      const int e = tid & (HID - 1);
      const int rh = tid >> 7;
      float a[R / 2];
#pragma unroll
      for (int k = 0; k < R / 2; ++k) a[k] = 0.f;
      const T* wrow = wout + static_cast<size_t>(e) * c;
      for (int j = 0; j < c; ++j) {
        const float w = to_f(wrow[j]);
#pragma unroll
        for (int k = 0; k < R / 2; ++k)
          a[k] = fmaf(A[(rh + 2 * k) * c + j], w, a[k]);
      }
#pragma unroll
      for (int k = 0; k < R / 2; ++k)
        if (rh + 2 * k < rows) cb[(rh + 2 * k) * HID + e] = rnd<T>(a[k]);
    }
    __syncthreads();

    // dC^ partial += round_T(q_s)^T dcore over this tile's rows
    for (int r = 0; r < rows; ++r) {
      const float p = rnd<T>(qsm[r * HID + cd]);
      const float* dv = cb + r * HID + ce0;
#pragma unroll
      for (int j = 0; j < 16; ++j) dch[j] = fmaf(p, dv[j], dch[j]);
    }
    // dqs = round_T(dcore C^T): lane d of head h takes row d of the block
    for (int idx = tid; idx < rows * HID; idx += THREADS) {
      const int r = idx / HID;
      const int d = idx % HID;
      const int h = d / DH;
      const float* dv = cb + r * HID + h * DH;
      const float* cv = ch + h * DH * DH + (d % DH) * DH;
      float a = 0.f;
#pragma unroll
      for (int el = 0; el < DH; ++el) a = fmaf(dv[el], cv[el], a);
      db[idx] = rnd<T>(a);
    }
    __syncthreads();

    // softmax backward per (row, head): dq = q_s (dqs - sum(dqs q_s))
    for (int task = warp; task < rows * NH; task += THREADS / 32) {
      const int r = task / NH;
      const int off = r * HID + (task % NH) * DH + lane;
      const float qv = qsm[off];
      const float dv = db[off];
      const float s = warp_sum(dv * qv);
      const float dq = rnd<T>(qv * (dv - s));
      db[off] = dq;
      dqkv[(row0 + r) * QKV + (task % NH) * DH + lane] = from_f<T>(dq);
    }
    __syncthreads();

    // dx_q = dq W_q^T: column j, every row of the tile
    for (int j = tid; j < c; j += THREADS) {
      float a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = 0.f;
      const T* wrow = wqkv + static_cast<size_t>(j) * QKV;
      for (int e = 0; e < HID; ++e) {
        const float w = to_f(wrow[e]);
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] = fmaf(db[r * HID + e], w, a[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rows) dxq[(row0 + r) * c + j] = from_f<T>(a[r]);
    }
  }

  // this block's partials: dC^ blocks, then dg, then db_out
  const int qstride = CBLK + 2 * c;
  float* out = qpart + (static_cast<size_t>(bi) * splits + split) * qstride;
  float* cout = out + (cd / DH) * DH * DH + (cd % DH) * DH + (ce0 % DH);
#pragma unroll
  for (int j = 0; j < 16; ++j) cout[j] = dch[j];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int j = tid + k * THREADS;
    if (j < c) {
      out[CBLK + j] = dg_acc[k];
      out[CBLK + c + j] = db_acc[k];
    }
  }
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
kv_path_bwd(const T* __restrict__ x, const T* __restrict__ wqkv,
            const float* __restrict__ stats, const float* __restrict__ dctx,
            T* __restrict__ dxkv, T* __restrict__ dqkv, int n, int c) {
  extern __shared__ float smem[];
  float* xs = smem;                  // ROWS * c
  float* kv = xs + ROWS * c;         // ROWS * 2*HID: [k | v]
  float* ek = kv + ROWS * 2 * HID;   // ROWS * HID: exp(k - m), fp32
  float* dkv = ek + ROWS * HID;      // ROWS * 2*HID: [dk | dv]
  float* dc = dkv + ROWS * 2 * HID;  // CBLK: dC
  float* ds = dc + CBLK;             // HID
  float* m = ds + HID;               // HID

  const int tid = threadIdx.x;
  const int bi = blockIdx.y;
  const int r0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, n - r0);
  const size_t row0 = static_cast<size_t>(bi) * n + r0;
  const float* dcb = dctx + static_cast<size_t>(bi) * (CBLK + HID);

  for (int i = tid; i < CBLK + HID; i += THREADS) dc[i] = dcb[i];
  if (tid < HID) m[tid] = stats[static_cast<size_t>(bi) * STATS + tid];
  for (int i = tid; i < rows * c; i += THREADS) xs[i] = to_f(x[row0 * c + i]);
  __syncthreads();

  // k, v = x W_kv rounded to T: column tid, every row of the tile
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

  for (int idx = tid; idx < rows * HID; idx += THREADS) {
    const int r = idx / HID;
    const int d = idx % HID;
    ek[idx] = expf(kv[r * 2 * HID + d] - m[d]);
  }
  __syncthreads();

  // dk = round_T(ek (round_T(v dC^T) + ds)), dv = round_T(round_T(ek) dC)
  for (int idx = tid; idx < rows * 2 * HID; idx += THREADS) {
    const int r = idx / (2 * HID);
    const int col = idx % (2 * HID);
    float a = 0.f;
    if (col < HID) {
      const int h = col / DH;
      const float* vr = kv + r * 2 * HID + HID + h * DH;
      const float* cr = dc + h * DH * DH + (col % DH) * DH;
#pragma unroll
      for (int el = 0; el < DH; ++el) a = fmaf(vr[el], cr[el], a);
      dkv[idx] = rnd<T>(ek[r * HID + col] * (rnd<T>(a) + ds[col]));
    } else {
      const int e = col - HID;
      const int h = e / DH;
      const float* er = ek + r * HID + h * DH;
      const float* cc = dc + h * DH * DH + (e % DH);
#pragma unroll
      for (int dl = 0; dl < DH; ++dl) a = fmaf(rnd<T>(er[dl]), cc[dl * DH], a);
      dkv[idx] = rnd<T>(a);
    }
  }
  __syncthreads();

  for (int idx = tid; idx < rows * 2 * HID; idx += THREADS) {
    const int r = idx / (2 * HID);
    dqkv[(row0 + r) * QKV + HID + idx % (2 * HID)] = from_f<T>(dkv[idx]);
  }
  // dx_kv = dk W_k^T + dv W_v^T: column j, every row of the tile
  for (int j = tid; j < c; j += THREADS) {
    float a[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) a[r] = 0.f;
    const T* wrow = wqkv + static_cast<size_t>(j) * QKV + HID;
    for (int e = 0; e < 2 * HID; ++e) {
      const float w = to_f(wrow[e]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) a[r] = fmaf(dkv[r * 2 * HID + e], w, a[r]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < rows) dxkv[(row0 + r) * c + j] = from_f<T>(a[r]);
  }
}

// part[split] (P, Q) = sum over the split's rows of a[row]^T b[row]: a is
// (rows, P), b (rows, Q), both row-major in T. One 64x64 output tile per
// block, a 4x4 micro-tile per thread.
template <typename T>
__global__ void __launch_bounds__(THREADS)
wgrad_partials(const T* __restrict__ a, const T* __restrict__ b,
               float* __restrict__ part, long long rows, int P, int Q,
               long long rows_per_split) {
  __shared__ __align__(16) float as[WK][WT];
  __shared__ __align__(16) float bs[WK][WT];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int p0 = blockIdx.x * WT;
  const int q0 = blockIdx.y * WT;
  const int split = blockIdx.z;
  const long long r_begin = split * rows_per_split;
  const long long r_end = min(rows, r_begin + rows_per_split);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = r_begin; k0 < r_end; k0 += WK) {
    __syncthreads();
    for (int i = tid; i < WK * WT; i += THREADS) {
      const int kk = i / WT;
      const int cc = i % WT;
      const long long r = k0 + kk;
      const bool in = r < r_end;
      as[kk][cc] = (in && p0 + cc < P) ? to_f(a[r * P + p0 + cc]) : 0.f;
      bs[kk][cc] = (in && q0 + cc < Q) ? to_f(b[r * Q + q0 + cc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < WK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }

  float* out = part + static_cast<size_t>(split) * P * Q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = q0 + tx * 4 + j;
      if (q < Q) out[static_cast<size_t>(p) * Q + q] = acc[i][j];
    }
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
  tc::merge_context_tc_body(part, chat, stats, splits, scale);
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

// How one call divides its work: row splits of the streaming passes (in
// whole tiles of `tile` rows), row splits of the two weight-gradient
// products, and the fp32 and T scratch they need (counts of elements).
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

inline Plan plan(int b, int n, int c, bool bf16) {
  Plan p;
  long long per;
  split_rows(n, bf16 ? tc::TM : tf32x3::TM, cdiv(TARGET_BLOCKS, b),
             &p.kv_splits, &per);
  p.kv_rows = static_cast<int>(per);
  split_rows(n, bf16 ? tc::TM : ROWS, cdiv(TARGET_BLOCKS, b), &p.splits,
             &per);
  p.rows_per_split = static_cast<int>(per);
  const long long rows = static_cast<long long>(b) * n;
  // output tiles of each weight-gradient product, and its rows per stage
  const int tp = bf16 ? tc::WG_P : WT, tq = bf16 ? tc::WG_Q : WT;
  const int step = bf16 ? tc::WG_K : WK;
  split_rows(rows, step, cdiv(TARGET_BLOCKS, cdiv(c, tp) * cdiv(QKV, tq)),
             &p.ws_qkv, &p.wrows_qkv);
  split_rows(rows, step, cdiv(TARGET_BLOCKS, cdiv(HID, tp) * cdiv(c, tq)),
             &p.ws_out, &p.wrows_out);
  size_t o = 0;
  p.part = o;  o += static_cast<size_t>(b) * p.kv_splits * PSTRIDE;
  p.chat = o;  o += static_cast<size_t>(b) * CBLK;
  p.stats = o; o += static_cast<size_t>(b) * STATS;
  p.qpart = o; o += static_cast<size_t>(b) * p.splits * (CBLK + 2 * c);
  p.dctx = o;  o += static_cast<size_t>(b) * (CBLK + HID);
  p.wq = o;    o += static_cast<size_t>(p.ws_qkv) * c * QKV;
  p.wo = o;    o += static_cast<size_t>(p.ws_out) * HID * c;
  p.f_total = o;
  o = 0;
  p.core = o;  o += static_cast<size_t>(rows) * HID;
  p.dpre = o;  o += static_cast<size_t>(rows) * c;
  p.dqkv = o;  o += static_cast<size_t>(rows) * QKV;
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

cudaError_t launch_f32(const float* x, const float* dy, const float* wqkv,
                       const float* wout, const float* bout, const float* g,
                       float* dxq, float* dxkv, float* dwqkv, float* dwout,
                       float* dbout, float* dg, float* fs, float* ts, int b,
                       int n, int c, float eps, cudaStream_t stream) {
  using T = float;
  namespace t3 = tf32x3;
  const Plan p = plan(b, n, c, false);
  const float scale = rsqrtf(static_cast<float>(DH)) / static_cast<float>(n);
  const bool wide = c > WIDE_C;
  const int R = wide ? ROWS / 2 : ROWS;

  std::lock_guard<std::mutex> guard(limits_lock);
  Cache* k = nullptr;
  cudaError_t err = card_cache(1, &k);
  if (err != cudaSuccess) return err;
  // kernel A exactly as K1 launches it (linear_attention.cu)
  const int res_a = t3::kv_smem(c, true) <= static_cast<size_t>(k->max_smem);
  const size_t smem_a = t3::kv_smem(c, res_a);
  const int vec = c % 4 == 0 && (reinterpret_cast<uintptr_t>(x) |
                                 reinterpret_cast<uintptr_t>(wqkv)) % 16 == 0;
  const size_t smem_q =
      sizeof(float) * (2 * R * c + 3 * R * HID + CBLK + 4 * R);
  const size_t smem_kv =
      sizeof(float) * (ROWS * c + 5 * ROWS * HID + CBLK + 2 * HID);
  err = grant(bwd_kv_partials_tf32, smem_a, k->cap_a);
  if (err != cudaSuccess) return err;
  err = wide ? prgpt::allow_smem(q_path_bwd<T, ROWS / 2>, smem_q)
             : prgpt::allow_smem(q_path_bwd<T, ROWS>, smem_q);
  if (err != cudaSuccess) return err;
  err = prgpt::allow_smem(kv_path_bwd<T>, smem_kv);
  if (err != cudaSuccess) return err;

  bwd_kv_partials_tf32<<<dim3(p.kv_splits, b), t3::NTHREADS, smem_a,
                         stream>>>(
      x, wqkv, fs + p.part, n, c, p.kv_rows, p.kv_splits, res_a,
      res_a ? t3::X_BYTES : t3::X_BYTES + t3::WKV_BYTES, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_merge_context_tf32<<<dim3(CBLK / t3::NTHREADS, b), t3::NTHREADS, 0,
                           stream>>>(fs + p.part, fs + p.chat, fs + p.stats,
                                     p.kv_splits, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (wide)
    q_path_bwd<T, ROWS / 2><<<dim3(p.splits, b), THREADS, smem_q, stream>>>(
        x, dy, wqkv, wout, bout, g, fs + p.chat, dxq, ts + p.core,
        ts + p.dpre, ts + p.dqkv, fs + p.qpart, n, c, p.rows_per_split,
        p.splits, eps);
  else
    q_path_bwd<T, ROWS><<<dim3(p.splits, b), THREADS, smem_q, stream>>>(
        x, dy, wqkv, wout, bout, g, fs + p.chat, dxq, ts + p.core,
        ts + p.dpre, ts + p.dqkv, fs + p.qpart, n, c, p.rows_per_split,
        p.splits, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fold_context<T><<<b, THREADS, 0, stream>>>(
      fs + p.qpart, fs + p.stats, fs + p.dctx, p.splits, c, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kv_path_bwd<T><<<dim3(cdiv(n, ROWS), b), THREADS, smem_kv, stream>>>(
      x, wqkv, fs + p.stats, fs + p.dctx, dxkv, ts + p.dqkv, n, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long rows = static_cast<long long>(b) * n;
  wgrad_partials<T><<<dim3(cdiv(c, WT), cdiv(QKV, WT), p.ws_qkv), THREADS,
                      0, stream>>>(x, ts + p.dqkv, fs + p.wq, rows, c, QKV,
                                   p.wrows_qkv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wgrad_partials<T><<<dim3(cdiv(HID, WT), cdiv(c, WT), p.ws_out), THREADS,
                      0, stream>>>(ts + p.core, ts + p.dpre, fs + p.wo, rows,
                                   HID, c, p.wrows_out);
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
  const Plan p = plan(b, n, c, true);
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
long long prgpt_linear_attention_bwd_fscratch(int b, int n, int c,
                                              int is_bf16) {
  return static_cast<long long>(plan(b, n, c, is_bf16).f_total);
}
long long prgpt_linear_attention_bwd_tscratch(int b, int n, int c,
                                              int is_bf16) {
  return static_cast<long long>(plan(b, n, c, is_bf16).t_total);
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
