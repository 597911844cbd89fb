// K3's bf16 bodies on the tensor cores, written for Hopper (sm_90a): the
// q path, the kv path and the weight-gradient products of
// linear_attention_bwd.cu. The k/v statistics and their merge are K1's
// kernels A and B (kv_partials_tc_body in linear_attention_tc.cuh,
// merge_context_body in linear_attention_kv.cuh; B also keeps the merged
// m, s and C for the fold); the fold (dC^ -> dC, ds) and the fixed-order reductions stay the
// shared CUDA-core kernels of linear_attention_bwd.cu.
//
// - Tiles. TM (64) rows, 8 warps, as K1's kernels; a block walks the row
//   tiles of one split of one batch row (grid (splits, b)), so its dC^,
//   dg and db_out partials sum over its whole range in registers and are
//   written once. Everything staged in shared memory (x, dpre and weight
//   chunks, q~, core, dcore, dq, k|v, exp(k - m), dk|dv) sits in rows of a
//   multiple of 128 bytes with the 128-byte XOR swizzle of swz().
// - Weights. W_q and W_out (q path) and W_k|v (kv path) in 64-channel
//   chunks, resident for the whole block where every chunk fits beside the
//   rest (c <= 256), otherwise carried chunk by chunk through the ring
//   beside the activations, as K1's kernels do: this is what reaches
//   c = 2048. One chunk serves a product and its transpose: W as the
//   k x n B operand by ldmatrix.trans (ldb), W^T by plain ldmatrix
//   (ldb_n).
// - Ring. Two stages of cp.async work items, item i + 1 loading while
//   item i computes. An item is one 64-channel chunk of one pass of a
//   tile (q path: x | pre | dpre | dx_q; kv path: x | dx_kv).
// - Row buffer. The pre-norm output of a tile, and then its gradient dpre
//   in place of it, sit in shared memory where the tile fits (y_s, c <=
//   1024): the LayerNorm backward then reads shared memory instead of
//   making dependent L2 round trips, and dcore takes dpre from there.
//   Above, they live in dpre's rows in device memory, written and read
//   back by the same block (L2); that holds every c <= 2048. dpre is
//   copied to device memory either way, for the weight gradient.
// - q path (q_path_bwd_tc): q = x W_q; the per-head softmax on the
//   accumulator fragments (fp32 kept in registers for its backward,
//   rounded for the products); core = q~ C^_h; pre = core W_out + b; the
//   LayerNorm backward, per row (mean, 1/sigma and the two means, a
//   group of lanes a row, two-pass as emit_out_tc's forward) then per
//   column (dpre, and dg and db_out summed over the block's rows in a
//   fixed order); dcore =
//   dpre W_out^T; the dC^ partial += q~^T dcore (A by ldmatrix.trans);
//   dq~ = dcore C^_h^T with dcore's fragments repacked as A; the softmax
//   backward per head on fragments; dx_q = dq W_q^T. core, dpre and dq go
//   to device memory for the weight gradients.
// - kv path (kv_path_bwd_tc): k|v = x W_k|v, rounded; exp(k - m) with the
//   merged m; dk = exp(k - m) (round(v dC^T) + ds) and dv = round(exp(k -
//   m)) dC by mma per head, dC split into a bf16 high and low part (dC is
//   fp32, C^ / s scaled: the two parts keep 16 bits of it); dx_kv =
//   [dk | dv] W_k|v^T.
// - Weight gradients (wgrad_partials_tc): dW_qkv = x^T [dq | dk | dv] and
//   dW_out = core^T dpre, bf16 operands and fp32 accumulators, split over
//   rows into fixed partials that reduce_partials sums in order: no
//   atomics anywhere, so two runs agree bit for bit.
//
// Rounding happens where fused_linear_attention_bwd_plain materializes
// bf16 (the list in linear_attention_bwd.cu); only the order of fp32 sums
// differs, and dC enters its two products as hi + lo instead of fp32.
#pragma once

#include "linear_attention_tc.cuh"

namespace prgpt {
namespace la {
namespace tc {

constexpr int OST_BYTES = TM * KCH * 2;   // a 64 x 64 bf16 output tile
constexpr int DKV_ROW = 2 * HID_ROW;      // bytes of a row of [dk | dv]
constexpr int WG_K = 32;                  // rows per weight-gradient stage
constexpr int WG_P = 64, WG_Q = 128;      // weight-gradient output tile
constexpr int WG_STAGES = 3;
constexpr int WG_A = WG_K * WG_P * 2, WG_B = WG_K * WG_Q * 2;

// columns at once of the q path's per-channel LayerNorm pass
__host__ __device__ __forceinline__ int col_width(int c) {
  return c <= 64 ? 64 : c <= 128 ? 128 : NTHREADS;
}

// B fragments of n8 blocks n0 and n0 + 8 (b[0..1], b[2..3]), k0 .. k0 +
// 16, of a row-major n x k tile (B^T stored): plain ldmatrix
__device__ __forceinline__ void ldb_n(uint32_t (&b)[4], uint32_t base, int k0,
                                      int n0, int rb, int lane) {
  ldm_x4(b, base + swz(n0 + (lane & 7) + (lane >> 4) * 8,
                       (k0 >> 3) + ((lane >> 3) & 1), rb));
}

// A fragment (k = 16 columns: n8 blocks j0, j0 + 1) repacked from fp32
// accumulator fragments, rounded to bf16
__device__ __forceinline__ void repack_a(uint32_t (&a)[4],
                                         const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

// a staged TM x KCH bf16 tile (128-byte swizzled rows) to rows r0 .. r0 +
// rows, channels c0 .. of dst (rows of ld channels), 16 bytes a thread
__device__ __forceinline__ void store_tile(const unsigned char* ost,
                                           bf16* dst, int ld, int r0,
                                           int rows, int c0, int c) {
  for (int i = threadIdx.x; i < TM * 8; i += NTHREADS) {
    const int r = i >> 3, j = i & 7;
    if (r < rows && c0 + 8 * j < c)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r0 + r) * ld + c0 +
                                8 * j) =
          *reinterpret_cast<const uint4*>(ost + swz(r, j, KCH * 2));
  }
}

// 64 rows x 64 output channels of A (TM x 16 ks, rows of rb bytes) times a
// weight chunk: B = W^T (n x k rows of wrb bytes, ldb_n) or W (k x n,
// ldb); 2 x 4 warps of 32 rows x 16 channels, rounded into ost
template <int KSTEPS, bool TRANS>
__device__ __forceinline__ void chunk_product(uint32_t as, int rb,
                                              uint32_t ws, int wrb,
                                              unsigned char* ost) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  float y[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[mi][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t a[2][4], bw[4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      lda(a[mi], as, wm * 32 + mi * 16, kk, rb, lane);
    if (TRANS)
      ldb_n(bw, ws, kk * 16, wn * 16, wrb, lane);
    else
      ldb(bw, ws, kk * 16, wn * 16, wrb, lane);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      mma16816(y[mi][0], a[mi], bw[0], bw[1]);
      mma16816(y[mi][1], a[mi], bw[2], bw[3]);
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(
            ost + el(wm * 32 + mi * 16 + g + 8 * h, wn * 16 + j * 8 + 2 * t4,
                     KCH * 2)) = pack_bf16x2(y[mi][j][2 * h],
                                             y[mi][j][2 * h + 1]);
}

// The q path over grid (splits, b): the row tiles of rows blockIdx.x *
// rows_per_split .. of batch row blockIdx.y. The tile's row buffer (pre,
// then dpre in place) is y_s in shared memory (ysmem) or dpre's rows in
// device memory. Items per tile: resident (which implies ysmem), its nch
// x chunks; streamed, nch x (+ W_q) chunks, nch W_out chunks (pre), nch
// W_out (+ dpre, from device memory) chunks (dcore), nch W_q chunks
// (dx_q).
__device__ __forceinline__ void q_path_tc_body(
    const bf16* __restrict__ x, const bf16* __restrict__ dy,
    const bf16* __restrict__ wqkv, const bf16* __restrict__ wout,
    const float* __restrict__ bout, const float* __restrict__ gam,
    const float* __restrict__ chat, bf16* __restrict__ dxq,
    bf16* __restrict__ core_out, bf16* __restrict__ dpre_out,
    bf16* __restrict__ dqkv, float* __restrict__ qpart, int n, int c,
    int rows_per_split, int splits, float eps, int resident,
    int stage_bytes, int ysmem) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int nch = (c + KCH - 1) / KCH;
  const int yrb = nch * KCH * 2;  // bytes of a row of y_s
  unsigned char* wq_res = tc_smem;
  unsigned char* wo_res = tc_smem + nch * WQ_BYTES;
  unsigned char* ring =
      tc_smem + (resident ? nch * (WQ_BYTES + WO_BYTES) : 0);
  unsigned char* ch_s = ring + 2 * stage_bytes;  // C^ as DH x (head, e)
  unsigned char* qs_s = ch_s + DH * HID_ROW;     // TM x HID: q~, then dq
  unsigned char* core_s = qs_s + TM * HID_ROW;   // TM x HID: core, dcore
  unsigned char* ost = core_s + TM * HID_ROW;    // TM x KCH output tile
  float* rs = reinterpret_cast<float*>(ost + OST_BYTES);  // TM x 4
  unsigned char* y_s = reinterpret_cast<unsigned char*>(rs + 4 * TM);
  // the column split of the LayerNorm backward's per-channel pass: CW
  // columns at once, G = NTHREADS / CW row groups, each summing its own
  // rows; thread tid's dg and db_out sums of columns j0 + k CW sit at
  // gsum[k NTHREADS + tid] and gsum[(cpt + k) NTHREADS + tid]
  const int CW = col_width(c), G = NTHREADS / CW, cpt = (c + CW - 1) / CW;
  float* gsum = reinterpret_cast<float*>(y_s + (ysmem ? TM * yrb : 0));

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int qm = warp & 3, qh = warp >> 2;  // 16 rows x heads 2qh, 2qh + 1
  const int split = blockIdx.x, bi = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);
  const size_t brow = static_cast<size_t>(bi) * n;
  const bf16* xb = x + brow * c;
  const bf16* dyb = dy + brow * c;
  bf16* dpb = dpre_out + brow * c;  // the row buffer: pre, then dpre
  const int P = resident ? nch : 4 * nch;    // items per tile
  const int dp0 = resident ? nch : 2 * nch;  // first dcore item
  const int L = (r_end - r_begin + TM - 1) / TM * P;

  auto prefetch = [&](int i) {
    if (i < L) {
      const int r0 = r_begin + (i / P) * TM;
      const int k = i % P;
      unsigned char* st = ring + (i & 1) * stage_bytes;
      const uint32_t s = smem_u32(st);
      if (k < nch) {  // x (+ W_q)
        load_x(s, xb, c, r0, r_end, k * KCH);
        if (!resident)
          load_w<HID>(s + X_BYTES, wqkv, QKV, k * KCH, KCH, c, 0, QKV);
      } else if (k < dp0) {  // streamed W_out for pre
        load_w<KCH>(s, wout, c, 0, HID, HID, (k - nch) * KCH, c);
      } else if (k < dp0 + nch) {  // W_out (+ dpre) for dcore
        if (!ysmem) load_x(s, dpb, c, r0, r_end, (k - dp0) * KCH);
        load_w<KCH>(s + X_BYTES, wout, c, 0, HID, HID, (k - dp0) * KCH, c);
      } else {  // streamed W_q for dx_q
        load_w<HID>(s, wqkv, QKV, (k - dp0 - nch) * KCH, KCH, c, 0, QKV);
      }
    }
    cp_commit();
  };
  if (resident && L > 0)
    for (int ch = 0; ch < nch; ++ch) {  // committed with item 0
      load_w<HID>(smem_u32(wq_res + ch * WQ_BYTES), wqkv, QKV, ch * KCH, KCH,
                  c, 0, QKV);
      load_w<KCH>(smem_u32(wo_res + ch * WO_BYTES), wout, c, 0, HID, HID,
                  ch * KCH, c);
    }
  prefetch(0);
  // C^ of batch row bi, exact in bf16 (the merge rounded it)
  for (int idx = tid; idx < CBLK; idx += NTHREADS) {
    const int hd = idx / (DH * DH), d = (idx / DH) % DH, e = idx % DH;
    const float cv = chat[static_cast<size_t>(bi) * CBLK + idx];
    *reinterpret_cast<bf16*>(ch_s + el(d, hd * DH + e, HID_ROW)) =
        __float2bfloat16_rn(cv);
  }
  // channels past c stay zeros (dcore reads whole 64-channel chunks)
  if (ysmem)
    for (int i = tid; i < TM * yrb / 16; i += NTHREADS)
      reinterpret_cast<uint4*>(y_s)[i] = make_uint4(0, 0, 0, 0);

  // pre = round(round(core W_out) + round(b_out)) for channels 64 kc ..,
  // into the row buffer
  auto pre_chunk = [&](int kc, uint32_t wsm, int r0, int rows) {
    chunk_product<HID / 16, false>(smem_u32(core_s), HID_ROW, wsm, KCH * 2,
                                   ost);
    __syncthreads();
    for (int i = tid; i < TM * 8; i += NTHREADS) {
      const int r = i >> 3, j = i & 7, col = kc * KCH + 8 * j;
      if (r >= rows || col >= c) continue;
      const uint4 u = *reinterpret_cast<const uint4*>(ost + swz(r, j, KCH * 2));
      const bf16* v = reinterpret_cast<const bf16*>(&u);
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = pack_bf16x2(
            __bfloat162float(v[2 * e]) + rnd16(bout[col + 2 * e]),
            __bfloat162float(v[2 * e + 1]) + rnd16(bout[col + 2 * e + 1]));
      *reinterpret_cast<uint4*>(
          ysmem ? y_s + swz(r, kc * 8 + j, yrb)
                : reinterpret_cast<unsigned char*>(
                      dpb + static_cast<size_t>(r0 + r) * c + col)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();
  };

  const int j0 = tid % CW, grp = tid / CW;
  for (int k = 0; k < 2 * cpt; ++k) gsum[k * NTHREADS + tid] = 0.f;

  // LayerNorm backward of the tile's rows: dpre in place of pre, then
  // (ysmem) copied to dpre's rows for the weight gradient. Per row, a
  // group of lpr lanes (8 where c <= 64, so that no lane idles), 8
  // channels a lane and step: the mean, 1/sigma (two passes, as
  // emit_out_tc's forward) and the means of dy g and dy g xhat
  auto layer_norm_bwd = [&](int r0, int rows) {
    const int c8 = c >> 3;
    const int lpr = c8 > 16 ? 32 : c8 > 8 ? 16 : 8;
    const int rpw = 32 / lpr;  // rows of a warp at once
    auto group_sum = [&](float v) {
      for (int o = lpr >> 1; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      return v;
    };
    auto pre8 = [&](int r, int j) {  // 8 channels of row r of pre
      return ysmem ? *reinterpret_cast<const uint4*>(y_s + swz(r, j, yrb))
                   : __ldcg(reinterpret_cast<const uint4*>(
                         dpb + static_cast<size_t>(r0 + r) * c + 8 * j));
    };
    // every lane runs every step (the shuffles need the whole warp): TM is
    // a multiple of 8 rpw; rows past the tile read and store nothing
    for (int r = warp * rpw + lane / lpr; r < TM; r += 8 * rpw) {
      const bool live = r < rows;
      const int sl = lane % lpr;
      float s = 0.f;
      for (int j = sl; live && j < c8; j += lpr) {
        const uint4 u = pre8(r, j);
        const bf16* v = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += __bfloat162float(v[e]);
      }
      const float mean = group_sum(s) / c;
      float var = 0.f;
      for (int j = sl; live && j < c8; j += lpr) {
        const uint4 u = pre8(r, j);
        const bf16* v = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = __bfloat162float(v[e]) - mean;
          var = fmaf(d, d, var);
        }
      }
      const float inv = rsqrtf(group_sum(var) / c + eps);
      float s1 = 0.f, s2 = 0.f;
      for (int j = sl; live && j < c8; j += lpr) {
        const uint4 u = pre8(r, j);
        const uint4 w = *reinterpret_cast<const uint4*>(
            dyb + static_cast<size_t>(r0 + r) * c + 8 * j);
        const bf16* v = reinterpret_cast<const bf16*>(&u);
        const bf16* dv = reinterpret_cast<const bf16*>(&w);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float dxh = __bfloat162float(dv[e]) * gam[8 * j + e];
          s1 += dxh;
          s2 = fmaf(dxh, (__bfloat162float(v[e]) - mean) * inv, s2);
        }
      }
      s1 = group_sum(s1);
      s2 = group_sum(s2);
      if (live && sl == 0) {
        rs[4 * r] = mean;
        rs[4 * r + 1] = inv;
        rs[4 * r + 2] = s1 / c;
        rs[4 * r + 3] = s2 / c;
      }
    }
    __syncthreads();
    // dpre = (dy g - mean(dy g) - xhat mean(dy g xhat)) / sigma, rounded;
    // dg += dy xhat and db_out += dpre over this thread's rows, in order.
    // y_s rows past the tile become zeros, so that dcore is 0 there
    for (int k = 0; k < cpt; ++k) {
      const int j = j0 + k * CW;
      if (j >= c) continue;
      const float gj = gam[j];
      float dga = 0.f, dba = 0.f;
      for (int r = grp; r < TM; r += G) {
        bf16* ys = reinterpret_cast<bf16*>(y_s + el(r, j, yrb));
        if (r >= rows) {
          if (ysmem) *ys = __float2bfloat16_rn(0.f);
          continue;
        }
        const size_t o = static_cast<size_t>(r0 + r) * c + j;
        const float* st = rs + 4 * r;  // mean, 1/sigma, the two means
        const float pre = __bfloat162float(ysmem ? *ys : __ldcg(dpb + o));
        const float xh = (pre - st[0]) * st[1];
        const float dyv = __bfloat162float(dyb[o]);
        dga = fmaf(dyv, xh, dga);
        const float dp = rnd16(st[1] * (dyv * gj - st[2] - xh * st[3]));
        dba += dp;
        if (ysmem)
          *ys = __float2bfloat16_rn(dp);
        else
          dpb[o] = __float2bfloat16_rn(dp);
      }
      gsum[k * NTHREADS + tid] += dga;
      gsum[(cpt + k) * NTHREADS + tid] += dba;
    }
    __syncthreads();
    if (ysmem)
      for (int idx = tid; idx < rows * c8; idx += NTHREADS) {
        const int r = idx / c8, j = idx % c8;
        *reinterpret_cast<uint4*>(dpb + static_cast<size_t>(r0 + r) * c +
                                  8 * j) =
            *reinterpret_cast<const uint4*>(y_s + swz(r, j, yrb));
      }
  };

  float acc[8][4];    // q, then its softmax in fp32: 16 rows x 2 heads
  float dacc[8][4];   // dcore, then dq~ and dq, in the same layout
  float dch[4][4];    // this warp's dC^ rows: head warp >> 1, d 16 (warp & 1)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dch[j][e] = 0.f;

  auto zero = [](float (&t)[8][4]) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[j][e] = 0.f;
  };
  // dcore += A W_out^T over one 64-channel chunk: A the chunk's dpre (at
  // 16-column block k16 of rows of rb bytes), wsm the W_out chunk
  auto dcore_chunk = [&](uint32_t as, int rb, int k16, uint32_t wsm) {
#pragma unroll
    for (int kk = 0; kk * 16 < KCH; ++kk) {
      uint32_t a[4];
      lda(a, as, qm * 16, k16 + kk, rb, lane);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bw[4];
        ldb_n(bw, wsm, kk * 16, qh * 64 + jj * 16, KCH * 2, lane);
        mma16816(dacc[2 * jj], a, bw[0], bw[1]);
        mma16816(dacc[2 * jj + 1], a, bw[2], bw[3]);
      }
    }
  };
  // dcore complete in dacc: the dC^ partial, dq~, the softmax backward,
  // dq, and (resident) dx_q
  auto dq_epilogue = [&](int r0, int rows) {
    // dcore rounded, into core_s (core is in device memory already)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dacc[j][e] = rnd16(dacc[j][e]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(
            core_s + el(qm * 16 + g + 8 * h, qh * 64 + j * 8 + 2 * t4,
                        HID_ROW)) =
            pack_bf16x2(dacc[j][2 * h], dacc[j][2 * h + 1]);
    }
    __syncthreads();
    {  // dC^ partial += q~_h^T dcore_h over the tile's rows (rows past the
       // range have dcore = 0: their dpre is zeros)
      const int hh = warp >> 1, mf = warp & 1;
#pragma unroll
      for (int kk = 0; kk < TM / 16; ++kk) {
        uint32_t a[4];
        lda_t(a, smem_u32(qs_s), kk * 16, hh * DH + mf * 16, HID_ROW, lane);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t b[4];
          ldb(b, smem_u32(core_s), kk * 16, hh * DH + jj * 16, HID_ROW, lane);
          mma16816(dch[2 * jj], a, b[0], b[1]);
          mma16816(dch[2 * jj + 1], a, b[2], b[3]);
        }
      }
    }
    {  // dq~ = round(dcore_h C^_h^T), then the softmax backward per head:
       // dq = round(q~ (dq~ - sum_head(dq~ q~)))
      float dqs[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqs[j][e] = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int ke = 0; ke < 2; ++ke) {
          const int j0a = 4 * hh + 2 * ke;
          uint32_t a[4];
          repack_a(a, dacc[j0a], dacc[j0a + 1]);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            uint32_t bc[4];
            ldb_n(bc, smem_u32(ch_s), (2 * qh + hh) * DH + ke * 16, jj * 16,
                  HID_ROW, lane);
            mma16816(dqs[4 * hh + 2 * jj], a, bc[0], bc[1]);
            mma16816(dqs[4 * hh + 2 * jj + 1], a, bc[2], bc[3]);
          }
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int f0 = 4 * hh, f1 = f0 + 4;  // this head's fragments
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float s = 0.f;
#pragma unroll
          for (int j = f0; j < f1; ++j) {
            dqs[j][2 * r] = rnd16(dqs[j][2 * r]);
            dqs[j][2 * r + 1] = rnd16(dqs[j][2 * r + 1]);
            s = fmaf(dqs[j][2 * r], acc[j][2 * r], s);
            s = fmaf(dqs[j][2 * r + 1], acc[j][2 * r + 1], s);
          }
          s = quad_sum(s);
#pragma unroll
          for (int j = f0; j < f1; ++j) {
            dacc[j][2 * r] = acc[j][2 * r] * (dqs[j][2 * r] - s);
            dacc[j][2 * r + 1] = acc[j][2 * r + 1] * (dqs[j][2 * r + 1] - s);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with q~ in qs_s
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(
            qs_s + el(qm * 16 + g + 8 * h, qh * 64 + j * 8 + 2 * t4,
                      HID_ROW)) =
            pack_bf16x2(dacc[j][2 * h], dacc[j][2 * h + 1]);
    __syncthreads();
    for (int idx = tid; idx < TM * (HID / 8); idx += NTHREADS) {
      const int r = idx >> 4, j = idx & 15;
      if (r < rows)
        *reinterpret_cast<uint4*>(dqkv + (brow + r0 + r) * QKV + 8 * j) =
            *reinterpret_cast<const uint4*>(qs_s + swz(r, j, HID_ROW));
    }
    if (resident)  // dx_q = dq W_q^T, chunk by chunk
      for (int kc2 = 0; kc2 < nch; ++kc2) {
        chunk_product<HID / 16, true>(smem_u32(qs_s), HID_ROW,
                                      smem_u32(wq_res + kc2 * WQ_BYTES),
                                      HID_ROW, ost);
        __syncthreads();
        store_tile(ost, dxq + brow * c, c, r0, rows, kc2 * KCH, c);
        __syncthreads();
      }
  };

  for (int i = 0; i < L; ++i) {
    cp_wait<0>();
    // item i is in shared memory for every thread, and every warp is done
    // with item i - 1, whose stage the prefetch below refills; dpre's first
    // chunk waits for the LayerNorm backward that writes it
    __syncthreads();
    if ((i + 1) % P != dp0) prefetch(i + 1);
    const int r0 = r_begin + (i / P) * TM;
    const int rows = min(TM, r_end - r0);
    const int k = i % P;
    unsigned char* st = ring + (i & 1) * stage_bytes;

    if (k < nch) {  // q += x W_q over this chunk
      if (k == 0) zero(acc);
      const uint32_t xs = smem_u32(st);
      const uint32_t ws = smem_u32(resident ? wq_res + k * WQ_BYTES
                                            : st + X_BYTES);
#pragma unroll
      for (int kk = 0; kk * 16 < KCH; ++kk) {
        uint32_t a[4];
        lda(a, xs, qm * 16, kk, KCH * 2, lane);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t bq[4];
          ldb(bq, ws, kk * 16, qh * 64 + jj * 16, HID_ROW, lane);
          mma16816(acc[2 * jj], a, bq[0], bq[1]);
          mma16816(acc[2 * jj + 1], a, bq[2], bq[3]);
        }
      }
      if (k != nch - 1) continue;

      // element e of acc[j] is row 16 qm + g + 8 (e >> 1), column 8 j +
      // 2 t4 + (e & 1) of heads 2 qh (j < 4) and 2 qh + 1: q rounded, then
      // its softmax over each head's 32 columns, kept in fp32
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = rnd16(acc[j][e]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q0 = 4 * hh, q1 = q0 + 4;  // this head's fragments
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = q0; j < q1; ++j)
            mx = fmaxf(mx, fmaxf(acc[j][2 * r], acc[j][2 * r + 1]));
          mx = quad_max(mx);
          float sm = 0.f;
#pragma unroll
          for (int j = q0; j < q1; ++j) {
            acc[j][2 * r] = __expf(acc[j][2 * r] - mx);
            acc[j][2 * r + 1] = __expf(acc[j][2 * r + 1] - mx);
            sm += acc[j][2 * r] + acc[j][2 * r + 1];
          }
          const float inv = 1.f / quad_sum(sm);
#pragma unroll
          for (int j = q0; j < q1; ++j) {
            acc[j][2 * r] *= inv;
            acc[j][2 * r + 1] *= inv;
          }
        }
      }
      // q~ rounded into qs_s (the dC^ partial reads it transposed); core
      // = q~_h C^_h from the repacked fragments, rounded into core_s
      float cacc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(
              qs_s + el(qm * 16 + g + 8 * h, qh * 64 + j * 8 + 2 * t4,
                        HID_ROW)) =
              pack_bf16x2(acc[j][2 * h], acc[j][2 * h + 1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) cacc[j][e] = 0.f;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int kd = 0; kd < 2; ++kd) {
          const int j0a = 4 * hh + 2 * kd;
          uint32_t a[4];
          repack_a(a, acc[j0a], acc[j0a + 1]);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            uint32_t bc[4];
            ldb(bc, smem_u32(ch_s), kd * 16, (2 * qh + hh) * DH + jj * 16,
                HID_ROW, lane);
            mma16816(cacc[4 * hh + 2 * jj], a, bc[0], bc[1]);
            mma16816(cacc[4 * hh + 2 * jj + 1], a, bc[2], bc[3]);
          }
        }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(
              core_s + el(qm * 16 + g + 8 * h, qh * 64 + j * 8 + 2 * t4,
                          HID_ROW)) =
              pack_bf16x2(cacc[j][2 * h], cacc[j][2 * h + 1]);
      __syncthreads();
      for (int idx = tid; idx < TM * (HID / 8); idx += NTHREADS) {
        const int r = idx >> 4, j = idx & 15;
        if (r < rows)
          *reinterpret_cast<uint4*>(core_out + (brow + r0 + r) * HID + 8 * j) =
              *reinterpret_cast<const uint4*>(core_s + swz(r, j, HID_ROW));
      }
      if (!resident) continue;
      for (int kc = 0; kc < nch; ++kc)
        pre_chunk(kc, smem_u32(wo_res + kc * WO_BYTES), r0, rows);
      layer_norm_bwd(r0, rows);
      zero(dacc);
      for (int kc = 0; kc < nch; ++kc)
        dcore_chunk(smem_u32(y_s), yrb, 4 * kc,
                    smem_u32(wo_res + kc * WO_BYTES));
      dq_epilogue(r0, rows);
      continue;
    }

    if (k < dp0) {  // streamed: pre for one W_out chunk
      pre_chunk(k - nch, smem_u32(st), r0, rows);
      if (k == dp0 - 1) {
        layer_norm_bwd(r0, rows);
        prefetch(i + 1);
      }
      continue;
    }

    if (k >= dp0 + nch) {  // streamed: dx_q for one W_q chunk
      const int kc = k - dp0 - nch;
      chunk_product<HID / 16, true>(smem_u32(qs_s), HID_ROW, smem_u32(st),
                                    HID_ROW, ost);
      __syncthreads();
      store_tile(ost, dxq + brow * c, c, r0, rows, kc * KCH, c);
      continue;
    }

    // dcore += dpre W_out^T over one streamed W_out chunk
    const int kc = k - dp0;
    if (kc == 0) zero(dacc);
    if (ysmem)
      dcore_chunk(smem_u32(y_s), yrb, 4 * kc, smem_u32(st + X_BYTES));
    else
      dcore_chunk(smem_u32(st), KCH * 2, 0, smem_u32(st + X_BYTES));
    if (kc == nch - 1) dq_epilogue(r0, rows);
  }
  cp_wait<0>();
  __syncthreads();

  // this block's partials: dC^ blocks, then dg, then db_out
  const int qstride = CBLK + 2 * c;
  float* out = qpart + (static_cast<size_t>(bi) * splits + split) * qstride;
  {
    const int hh = warp >> 1, mf = warp & 1;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(out + hh * DH * DH +
                                   (mf * 16 + g + 8 * h) * DH + j * 8 +
                                   2 * t4) =
            make_float2(dch[j][2 * h], dch[j][2 * h + 1]);
  }
  // the row groups' sums of each column, in order (G > 1: c <= 128, one
  // column a thread)
  if (grp == 0)
    for (int k = 0; k < cpt; ++k) {
      const int j = j0 + k * CW;
      if (j >= c) continue;
      float a = 0.f, b = 0.f;
      for (int q = 0; q < G; ++q) {
        a += gsum[k * NTHREADS + q * CW + j0];
        b += gsum[(cpt + k) * NTHREADS + q * CW + j0];
      }
      out[CBLK + j] = a;
      out[CBLK + c + j] = b;
    }
}

// The kv path over grid (splits, b). Items per tile: nch x (+ W_k|v)
// chunks, then, streamed, nch W_k|v chunks (dx_kv).
__device__ __forceinline__ void kv_path_tc_body(
    const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
    const float* __restrict__ stats, const float* __restrict__ dctx,
    bf16* __restrict__ dxkv, bf16* __restrict__ dqkv, int n, int c,
    int rows_per_split, int resident, int stage_bytes) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int nch = (c + KCH - 1) / KCH;
  unsigned char* wres = tc_smem;
  unsigned char* ring = tc_smem + (resident ? nch * WKV_BYTES : 0);
  unsigned char* ek_s = ring + 2 * stage_bytes;  // TM x HID exp(k - m)
  unsigned char* v_s = ek_s + TM * HID_ROW;      // TM x HID v
  unsigned char* dkv_s = ek_s;                   // TM x 2 HID, after both
  unsigned char* dch_s = v_s + TM * HID_ROW;     // dC high, DH x (h, e)
  unsigned char* dcl_s = dch_s + DH * HID_ROW;   // dC low
  unsigned char* ost = dcl_s + DH * HID_ROW;     // TM x KCH output tile
  float* m_s = reinterpret_cast<float*>(ost + OST_BYTES);
  float* ds_s = m_s + HID;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // 32 rows x 64 of [k | v]
  const int split = blockIdx.x, bi = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);
  const size_t brow = static_cast<size_t>(bi) * n;
  const bf16* xb = x + brow * c;
  const int P = resident ? nch : 2 * nch;
  const int L = (r_end - r_begin + TM - 1) / TM * P;

  auto prefetch = [&](int i) {
    if (i < L) {
      const int k = i % P;
      const uint32_t s = smem_u32(ring + (i & 1) * stage_bytes);
      if (k < nch) {
        load_x(s, xb, c, r_begin + (i / P) * TM, r_end, k * KCH);
        if (!resident)
          load_w<2 * HID>(s + X_BYTES, wqkv, QKV, k * KCH, KCH, c, HID, QKV);
      } else {
        load_w<2 * HID>(s, wqkv, QKV, (k - nch) * KCH, KCH, c, HID, QKV);
      }
    }
    cp_commit();
  };
  if (resident && L > 0)
    for (int ch = 0; ch < nch; ++ch)  // committed with item 0
      load_w<2 * HID>(smem_u32(wres + ch * WKV_BYTES), wqkv, QKV, ch * KCH,
                      KCH, c, HID, QKV);
  prefetch(0);
  {  // dC as hi + lo bf16 parts, ds and m of batch row bi
    const float* dcb = dctx + static_cast<size_t>(bi) * (CBLK + HID);
    for (int idx = tid; idx < CBLK; idx += NTHREADS) {
      const int hd = idx / (DH * DH), d = (idx / DH) % DH, e = idx % DH;
      const float v = dcb[idx];
      const bf16 hi = __float2bfloat16_rn(v);
      *reinterpret_cast<bf16*>(dch_s + el(d, hd * DH + e, HID_ROW)) = hi;
      *reinterpret_cast<bf16*>(dcl_s + el(d, hd * DH + e, HID_ROW)) =
          __float2bfloat16_rn(v - __bfloat162float(hi));
    }
    if (tid < HID) {
      ds_s[tid] = dcb[CBLK + tid];
      m_s[tid] = stats[static_cast<size_t>(bi) * STATS + tid];
    }
  }

  float acc[2][8][4];  // k|v: rows 32 wm + 16 mi .., columns 64 wn + 8 j ..
  for (int i = 0; i < L; ++i) {
    cp_wait<0>();
    // item i is in shared memory for every thread, and every warp is done
    // with item i - 1, whose stage the prefetch below refills
    __syncthreads();
    prefetch(i + 1);
    const int r0 = r_begin + (i / P) * TM;
    const int rows = min(TM, r_end - r0);
    const int k = i % P;
    unsigned char* st = ring + (i & 1) * stage_bytes;
    if (k >= nch) {  // streamed: dx_kv for one W_k|v chunk
      chunk_product<2 * HID / 16, true>(smem_u32(dkv_s), DKV_ROW,
                                        smem_u32(st), DKV_ROW, ost);
      __syncthreads();
      store_tile(ost, dxkv + brow * c, c, r0, rows, (k - nch) * KCH, c);
      continue;
    }
    if (k == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
    }
    {
      const uint32_t xs = smem_u32(st);
      const uint32_t ws = smem_u32(resident ? wres + k * WKV_BYTES
                                            : st + X_BYTES);
#pragma unroll
      for (int kk = 0; kk * 16 < KCH; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          lda(a[mi], xs, wm * 32 + mi * 16, kk, KCH * 2, lane);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t b[4];
          ldb(b, ws, kk * 16, wn * 64 + jj * 16, 2 * HID_ROW, lane);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma16816(acc[mi][2 * jj], a[mi], b[0], b[1]);
            mma16816(acc[mi][2 * jj + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
    if (k != nch - 1) continue;

    // element e of acc[mi][j] is row 32 wm + 16 mi + g + 8 (e >> 1),
    // column 64 wn + 8 j + 2 t4 + (e & 1) of [k | v]: k and v rounded;
    // k becomes exp(k - m) in fp32 (rounded into ek_s), v goes to v_s
    const bool kside = wn < 2;
    unsigned char* dst = kside ? ek_s : v_s;
    const int cb = (kside ? wn : wn - 2) * 64;  // column in ek_s / v_s
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cb + j * 8 + 2 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = rnd16(acc[mi][j][2 * h]);
          float v1 = rnd16(acc[mi][j][2 * h + 1]);
          if (kside) {
            v0 = __expf(v0 - m_s[col]);
            v1 = __expf(v1 - m_s[col + 1]);
          }
          acc[mi][j][2 * h] = v0;
          acc[mi][j][2 * h + 1] = v1;
          *reinterpret_cast<uint32_t*>(
              dst + el(wm * 32 + mi * 16 + g + 8 * h, col, HID_ROW)) =
              pack_bf16x2(v0, v1);
        }
      }
    __syncthreads();
    // k side: dk = round(ek (round(v_h dC_h^T) + ds)); v side: dv =
    // round(round(ek)_h dC_h), both per head with dC = hi + lo, into acc
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int hd = (cb >> 5) + hh;  // head
      float t[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) t[mi][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          lda(a[mi], smem_u32(kside ? v_s : ek_s), wm * 32 + mi * 16,
              2 * hd + kk, HID_ROW, lane);
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          const uint32_t dcs = smem_u32(part ? dcl_s : dch_s);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            uint32_t b[4];
            if (kside)  // B = dC^T: dC rows d are n, columns e are k
              ldb_n(b, dcs, hd * DH + kk * 16, jj * 16, HID_ROW, lane);
            else        // B = dC: rows d are k, columns e are n
              ldb(b, dcs, kk * 16, hd * DH + jj * 16, HID_ROW, lane);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma16816(t[mi][2 * jj], a[mi], b[0], b[1]);
              mma16816(t[mi][2 * jj + 1], a[mi], b[2], b[3]);
            }
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& o = acc[mi][4 * hh + j][e];
            if (kside) {
              const int col = hd * DH + j * 8 + 2 * t4 + (e & 1);
              o = rnd16(o * (rnd16(t[mi][j][e]) + ds_s[col]));
            } else {
              o = rnd16(t[mi][j][e]);
            }
          }
    }
    __syncthreads();  // every warp is done with ek_s and v_s
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(
              dkv_s + el(wm * 32 + mi * 16 + g + 8 * h,
                         wn * 64 + j * 8 + 2 * t4, DKV_ROW)) =
              pack_bf16x2(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
    __syncthreads();
    for (int idx = tid; idx < TM * (2 * HID / 8); idx += NTHREADS) {
      const int r = idx >> 5, j = idx & 31;
      if (r < rows)
        *reinterpret_cast<uint4*>(dqkv + (brow + r0 + r) * QKV + HID + 8 * j) =
            *reinterpret_cast<const uint4*>(dkv_s + swz(r, j, DKV_ROW));
    }
    if (resident)  // dx_kv = [dk | dv] W_k|v^T, chunk by chunk
      for (int kc = 0; kc < nch; ++kc) {
        chunk_product<2 * HID / 16, true>(smem_u32(dkv_s), DKV_ROW,
                                          smem_u32(wres + kc * WKV_BYTES),
                                          DKV_ROW, ost);
        __syncthreads();
        store_tile(ost, dxkv + brow * c, c, r0, rows, kc * KCH, c);
        __syncthreads();
      }
  }
  cp_wait<0>();
}

// part[split] (P, Q) = sum over rows split * rows_per_split .. of
// a[row]^T b[row]: a is (rows, P), b (rows, Q), both row-major bf16, P
// and Q multiples of 8. Grid (P / 64, Q / 128, splits): a 64 x 128 output
// tile per block, 2 x 4 warps of 32 x 32, a ring of WG_STAGES stages of
// 32 rows; A^T by ldmatrix.trans.
__device__ __forceinline__ void wgrad_tc_body(
    const bf16* __restrict__ a, const bf16* __restrict__ b,
    float* __restrict__ part, long long rows, int P, int Q,
    long long rows_per_split) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wp = warp & 1, wq = warp >> 1;
  const int p0 = blockIdx.x * WG_P, q0 = blockIdx.y * WG_Q;
  const int split = blockIdx.z;
  const long long r_begin = split * rows_per_split;
  const long long r_end = min(rows, r_begin + rows_per_split);
  const int L = static_cast<int>((r_end - r_begin + WG_K - 1) / WG_K);

  auto prefetch = [&](int i) {
    if (i < L) {
      unsigned char* st = tc_smem + (i % WG_STAGES) * (WG_A + WG_B);
      const long long k0 = r_begin + static_cast<long long>(i) * WG_K;
      for (int t = tid; t < WG_K * (WG_P / 8 + WG_Q / 8); t += NTHREADS) {
        if (t < WG_K * (WG_P / 8)) {
          const int r = t >> 3, j = t & 7, col = p0 + 8 * j;
          const bool in = k0 + r < r_end && col < P;
          cp16(smem_u32(st) + swz(r, j, WG_P * 2),
               in ? a + (k0 + r) * P + col : a, in);
        } else {
          const int u = t - WG_K * (WG_P / 8);
          const int r = u >> 4, j = u & 15, col = q0 + 8 * j;
          const bool in = k0 + r < r_end && col < Q;
          cp16(smem_u32(st + WG_A) + swz(r, j, WG_Q * 2),
               in ? b + (k0 + r) * Q + col : b, in);
        }
      }
    }
    cp_commit();
  };
  for (int s = 0; s < WG_STAGES - 1; ++s) prefetch(s);

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  for (int i = 0; i < L; ++i) {
    cp_wait<WG_STAGES - 2>();
    // stage i is in for every thread; every warp is done with stage i - 1,
    // which the prefetch below refills
    __syncthreads();
    prefetch(i + WG_STAGES - 1);
    const unsigned char* st = tc_smem + (i % WG_STAGES) * (WG_A + WG_B);
#pragma unroll
    for (int kk = 0; kk < WG_K / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        lda_t(af[mi], smem_u32(st), kk * 16, wp * 32 + mi * 16, WG_P * 2,
              lane);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t bf[4];
        ldb(bf, smem_u32(st + WG_A), kk * 16, wq * 32 + jj * 16, WG_Q * 2,
            lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma16816(acc[mi][2 * jj], af[mi], bf[0], bf[1]);
          mma16816(acc[mi][2 * jj + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
  cp_wait<0>();

  float* out = part + static_cast<size_t>(split) * P * Q;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + wp * 32 + mi * 16 + g + 8 * h;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + wq * 32 + j * 8 + 2 * t4;
        if (q < Q)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(p) * Q + q) =
              make_float2(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
      }
    }
}

// Dynamic shared memory of the q path and the kv path for c channels,
// weights resident or streamed, and of the weight-gradient product.
inline size_t q_path_smem(int c, bool resident, bool ysmem) {
  const int nch = (c + KCH - 1) / KCH;
  const int cpt = (c + col_width(c) - 1) / col_width(c);
  const size_t fixed = DH * HID_ROW + 2 * TM * HID_ROW + OST_BYTES +
                       TM * 4 * sizeof(float) +
                       (ysmem ? static_cast<size_t>(TM) * nch * KCH * 2 : 0) +
                       2 * cpt * NTHREADS * sizeof(float);
  return resident ? static_cast<size_t>(nch) * (WQ_BYTES + WO_BYTES) +
                        2 * X_BYTES + fixed
                  : 2 * (X_BYTES + WQ_BYTES) + fixed;
}

inline size_t kv_path_smem(int c, bool resident) {
  const int nch = (c + KCH - 1) / KCH;
  const size_t fixed = 2 * TM * HID_ROW + 2 * DH * HID_ROW + OST_BYTES +
                       2 * HID * sizeof(float);
  return resident ? static_cast<size_t>(nch) * WKV_BYTES + 2 * X_BYTES + fixed
                  : 2 * (X_BYTES + WKV_BYTES) + fixed;
}

constexpr size_t WG_SMEM = WG_STAGES * (WG_A + WG_B);

}  // namespace tc
}  // namespace la
}  // namespace prgpt
