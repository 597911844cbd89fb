// K3's fp32 bodies on the TF32 tensor cores, written for Hopper (sm_90a):
// the q path, the kv path and the weight-gradient products of
// linear_attention_bwd.cu, every product in three TF32 passes (common.cuh:
// a b ~= a_lo b_hi + a_hi b_lo + a_hi b_hi, hi = tf32(x) and lo = x - hi
// read to TF32 by the tensor cores (split_frag), about 21 bits of
// each product where one pass keeps 10; mma.sync.m16n8k8.tf32, fp32
// accumulators). The
// k/v statistics and their merge are K1's fp32 kernels A and B
// (linear_attention_tf32.cuh), bit for bit the forward's; the fold (dC^ ->
// dC, ds) and the fixed-order reductions are the shared CUDA-core kernels
// of linear_attention_bwd.cu.
//
// The structure is linear_attention_bwd_tc.cuh's (K3 bf16), with fp32
// byte counts and K1 fp32's fragments:
// - Tiles. TM (64) rows, 8 warps; a block walks the row tiles of one
//   split of one batch row (grid (splits, b)), so its dC^, dg and db_out
//   partials sum over its whole range in registers and are written once.
// - Chunks. x, dpre and the weights in chunks of KCH (32) channels:
//   W_q 32 x 128 and W_out 128 x 32 (16 KB each), W_k|v 32 x 256 (32 KB).
//   Resident in shared memory where every chunk fits beside the rest (q
//   path c <= 64, kv path c <= 128), otherwise carried chunk by chunk
//   through a 2-stage ring beside the activations, which reaches c = 2048.
//   Channels past c and rows past the range are zero-filled; 16-byte
//   copies where c % 4 == 0 and every tensor is 16-byte aligned, else
//   4-byte ones.
// - One tile, both orientations. A weight chunk serves a product and its
//   transpose (W_q: q = x W_q and dx_q = dq W_q^T; W_out: pre = core W_out
//   and dcore = dpre W_out^T; W_k|v: k|v and dx_kv), and dC, q~ and dcore
//   are read as they lie and transposed. ldmatrix.trans cannot transpose
//   32-bit elements, so a tile read as the k x n B operand (or as A^T)
//   is read with 32-bit loads, lane (g, t) taking row t, column g, and a
//   tile read as A or as B^T (rows n, k contiguous) by plain ldmatrix,
//   whose non-transposed 8x8 b16 matrix is an 8x4 matrix of 32-bit
//   elements in fragment order. One swizzle serves both on every tile
//   here (swk): 16-byte chunk j of row r sits at j ^ key(r), key(r) =
//   2 (r & 3) + ((r >> 2) & 1), a permutation of r & 7, so the 8 rows of
//   an ldmatrix hit 8 bank groups, and so do the 4 rows t x 2 chunks of a
//   32-bit (row t, column g) load. C^ keeps K1's swizzle (its rows are
//   read in the fragments' permuted order, 2t and 2t + 1).
// - Row buffer. The tile's pre-norm output, then its gradient dpre in
//   place of it, in shared memory where it fits (y_s, c <= 384), else in
//   dpre's rows in device memory, written and read back by the same block
//   (L2). dpre is copied to device memory either way, for dW_out.
// - q path (q_path_tf32_body): q = x W_q (4 x 2 warps of 16 rows x two
//   heads); the per-head softmax on the accumulator fragments, kept in
//   fp32 registers for its backward; core = q~ C^_h with the softmax
//   fragments as A operands (each k8 step takes its d in the order 0, 2,
//   4, 6, 1, 3, 5, 7, as K1's kernel C does); pre = core W_out + b_out; the
//   LayerNorm backward per row (mean, 1/sigma, the two means; a lane group
//   a row) then per column (dpre; dg and db_out summed over the block's
//   rows in a fixed order); dcore = dpre W_out^T; the dC^ partial += q~^T
//   dcore (A^T by 32-bit loads); dq~ = dcore C^_h^T with dcore's
//   fragments as A; the softmax backward per head on fragments; dx_q = dq
//   W_q^T. core, dpre and dq go to device memory for the weight gradients.
// - kv path (kv_path_tf32_body): k|v = x W_k|v (2 x 4 warps of 32 rows x
//   64 columns); exp(k - m) with the merged m; per head dk = exp(k - m)
//   (v dC^T + ds) and dv = exp(k - m) dC, dC an ordinary fp32 operand;
//   dx_kv = [dk | dv] W_k|v^T.
// - Weight gradients (wgrad_tf32_body): dW_qkv = x^T [dq | dk | dv] and
//   dW_out = core^T dpre, split over rows into fixed partials that
//   reduce_partials sums in order: no atomics, two runs agree bit for bit.
// - Accuracy. The tensor cores truncate the sum each mma accumulates, so a
//   long sum in one fragment drifts (as in K1's fp32 bodies): no fragment
//   takes more than one 32-deep k range (4 k8 steps, 12 mma; the dC^
//   partial one 64-row tile, 24) before it is added to the running sum in
//   fp32.
//
// No rounding point: the plain version (fused_linear_attention_bwd_plain)
// keeps every intermediate in fp32, so only the order of sums differs.
#pragma once

#include "linear_attention_bwd_tc.cuh"
#include "linear_attention_tf32.cuh"

namespace prgpt {
namespace la {
namespace bwd32 {

using tf32x3::HROW;
using tf32x3::KCH;
using tf32x3::lds;
using tf32x3::NTHREADS;
using tf32x3::quad_max;
using tf32x3::quad_sum;
using tf32x3::TM;
using tf32x3::WKV_BYTES;
using tf32x3::WO_BYTES;
using tf32x3::WQ_BYTES;
using tf32x3::X_BYTES;

constexpr int WG_K = 32;              // rows per weight-gradient stage
constexpr int WG_P = 64, WG_Q = 128;  // weight-gradient output tile
constexpr int WG_STAGES = 3;
constexpr int WG_A = WG_K * WG_P * 4, WG_B = WG_K * WG_Q * 4;
constexpr size_t WG_SMEM = WG_STAGES * (WG_A + WG_B);  // 73,728

// byte offset of 16-byte chunk j of row r, rows of rb bytes (a multiple
// of 128): j ^ key(r), key(r) = 2 (r & 3) + ((r >> 2) & 1)
__device__ __forceinline__ uint32_t swk(int r, int j, int rb) {
  return r * rb + ((j ^ (((r & 3) << 1) | ((r >> 2) & 1))) << 4);
}

// byte offset of float (r, col) in a tile staged by swk
__device__ __forceinline__ uint32_t elk(int r, int col, int rb) {
  return swk(r, col >> 2, rb) + (col & 3) * 4;
}

// rows r0 .. r0 + nr (zeros from r_lim) and columns c0 .. c0 + NC (zeros
// from c_lim) of src (rows of ld floats) into dst (rows of NC floats)
template <int NC>
__device__ __forceinline__ void load_tile(uint32_t dst, const float* src,
                                          int ld, long long r0, int nr,
                                          long long r_lim, int c0, int c_lim,
                                          int vec) {
  if (vec) {
    constexpr int CPR = NC / 4;
    for (int i = threadIdx.x; i < nr * CPR; i += NTHREADS) {
      const int r = i / CPR, j = i % CPR, col = c0 + 4 * j;
      const bool in = r0 + r < r_lim && col < c_lim;
      cp16(dst + swk(r, j, NC * 4),
           in ? src + static_cast<size_t>(r0 + r) * ld + col : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < nr * NC; i += NTHREADS) {
      const int r = i / NC, e = i % NC;
      const bool in = r0 + r < r_lim && c0 + e < c_lim;
      cp4(dst + elk(r, e, NC * 4),
          in ? src + static_cast<size_t>(r0 + r) * ld + c0 + e : src, in);
    }
  }
}

// A fragment, split: rows row0 .. row0 + 16, k8 step kk of a row-major
// tile
__device__ __forceinline__ void lda(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                    uint32_t base, int row0, int kk, int rb,
                                    int lane) {
  ldm_x4(hi, base + swk(row0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                        2 * kk + (lane >> 4), rb));
  split_frag(hi, lo);
}

// B fragment, split: k0 .. k0 + 8, n8 block n0, of a row-major k x n tile
__device__ __forceinline__ void ldb(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                    const unsigned char* base, int k0,
                                    int n0, int rb, int lane) {
  const int t4 = lane & 3, col = n0 + (lane >> 2);
  hi[0] = lds(base + elk(k0 + t4, col, rb));
  hi[1] = lds(base + elk(k0 + t4 + 4, col, rb));
  split_frag(hi, lo);
}

// B fragments of n8 blocks n0 and n0 + 8, k0 .. k0 + 8, split, of a
// row-major n x k tile (B^T stored): one ldmatrix.x4
__device__ __forceinline__ void ldbt(uint32_t (&hi)[2][2],
                                     uint32_t (&lo)[2][2], uint32_t base,
                                     int k0, int n0, int rb, int lane) {
  uint32_t r[4];
  ldm_x4(r, base + swk(n0 + (lane & 7) + ((lane >> 4) << 3),
                       (k0 >> 2) + ((lane >> 3) & 1), rb));
  hi[0][0] = r[0], hi[0][1] = r[1], hi[1][0] = r[2], hi[1][1] = r[3];
  split_frag(hi[0], lo[0]);
  split_frag(hi[1], lo[1]);
}

// A fragment of T^T, split: rows m0 .. m0 + 16 of A are columns of the
// row-major k x m tile T, k0 .. k0 + 8 its rows
__device__ __forceinline__ void lda_t(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                      const unsigned char* base, int k0,
                                      int m0, int rb, int lane) {
  const int t4 = lane & 3, col = m0 + (lane >> 2);
  hi[0] = lds(base + elk(k0 + t4, col, rb));
  hi[1] = lds(base + elk(k0 + t4, col + 8, rb));
  hi[2] = lds(base + elk(k0 + t4 + 4, col, rb));
  hi[3] = lds(base + elk(k0 + t4 + 4, col + 8, rb));
  split_frag(hi, lo);
}

// y (rows 16 (warp & 3) .., 16 channels 16 (warp >> 2) ..) = A (rows of
// rb bytes, k8 steps k8a .. k8a + KS) times a chunk's B over KS k8 steps:
// B^T rows (n x k, BT) or B rows (k x n) of wrb bytes; each 4 k8 steps'
// products summed apart
template <int KS, bool BT>
__device__ __forceinline__ void row_product(float (&y)[2][4], uint32_t as,
                                            int rb, int k8a,
                                            const unsigned char* ws,
                                            int wrb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ym = warp & 3, yn = warp >> 2;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[j][e] = 0.f;
#pragma unroll
  for (int k4 = 0; k4 < KS; k4 += 4) {
    float p[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
#pragma unroll
    for (int kk = k4; kk < k4 + 4; ++kk) {
      uint32_t ah[4], al[4];
      lda(ah, al, as, ym * 16, k8a + kk, rb, lane);
      if (BT) {
        uint32_t bh[2][2], bl[2][2];
        ldbt(bh, bl, smem_u32(ws), kk * 8, yn * 16, wrb, lane);
        mma_3xtf32(p[0], ah, al, bh[0], bl[0]);
        mma_3xtf32(p[1], ah, al, bh[1], bl[1]);
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bh[2], bl[2];
          ldb(bh, bl, ws, kk * 8, yn * 16 + j * 8, wrb, lane);
          mma_3xtf32(p[j], ah, al, bh, bl);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[j][e] += p[j][e];
  }
}

// y of row_product stored to rows r0 .. (below rows) and channels 32 kc
// + .. (below c) of dst (rows of c floats)
__device__ __forceinline__ void store_rows(const float (&y)[2][4],
                                           float* dst, int c, int r0,
                                           int rows, int kc, int vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = kc * KCH + (warp >> 2) * 16 + j * 8 + 2 * t4;
    if (col >= c) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (warp & 3) * 16 + g + 8 * h;
      if (r >= rows) continue;
      float* o = dst + static_cast<size_t>(r0 + r) * c + col;
      if (vec) {
        *reinterpret_cast<float2*>(o) = make_float2(y[j][2 * h],
                                                    y[j][2 * h + 1]);
      } else {
        o[0] = y[j][2 * h];
        if (col + 1 < c) o[1] = y[j][2 * h + 1];
      }
    }
  }
}

// The q path over grid (splits, b): the row tiles of rows blockIdx.x *
// rows_per_split .. of batch row blockIdx.y. Items per tile: resident
// (which implies ysmem), its nch x chunks; streamed, nch x (+ W_q)
// chunks, nch W_out chunks (pre), nch W_out (+ dpre, from device memory)
// chunks (dcore), nch W_q chunks (dx_q).
__device__ __forceinline__ void q_path_tf32_body(
    const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ wqkv, const float* __restrict__ wout,
    const float* __restrict__ bout, const float* __restrict__ gam,
    const float* __restrict__ chat, float* __restrict__ dxq,
    float* __restrict__ core_out, float* __restrict__ dpre_out,
    float* __restrict__ dqkv, float* __restrict__ qpart, int n, int c,
    int rows_per_split, int splits, float eps, int resident,
    int stage_bytes, int ysmem, int vec) {
  extern __shared__ __align__(128) unsigned char tf_smem[];
  const int nch = (c + KCH - 1) / KCH;
  const int yrb = nch * KCH * 4;  // bytes of a row of y_s
  unsigned char* wq_res = tf_smem;
  unsigned char* wo_res = tf_smem + nch * WQ_BYTES;
  unsigned char* ring =
      tf_smem + (resident ? nch * (WQ_BYTES + WO_BYTES) : 0);
  unsigned char* ch_s = ring + 2 * stage_bytes;  // C^ as DH x (head, e)
  unsigned char* qs_s = ch_s + DH * HROW;        // TM x HID: q~, then dq
  unsigned char* core_s = qs_s + TM * HROW;      // TM x HID: core, dcore
  float* rs = reinterpret_cast<float*>(core_s + TM * HROW);  // TM x 4
  unsigned char* y_s = reinterpret_cast<unsigned char*>(rs + 4 * TM);
  // the column split of the LayerNorm backward's per-channel pass: CW
  // columns at once, G = NTHREADS / CW row groups, each summing its own
  // rows; thread tid's dg and db_out sums of columns j0 + k CW sit at
  // gsum[k NTHREADS + tid] and gsum[(cpt + k) NTHREADS + tid]
  const int CW = tc::col_width(c), G = NTHREADS / CW;
  const int cpt = (c + CW - 1) / CW;
  float* gsum = reinterpret_cast<float*>(y_s + (ysmem ? TM * yrb : 0));

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int qm = warp & 3, qh = warp >> 2;  // 16 rows x heads 2qh, 2qh + 1
  const int split = blockIdx.x, bi = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);
  const size_t brow = static_cast<size_t>(bi) * n;
  const float* xb = x + brow * c;
  const float* dyb = dy + brow * c;
  float* dpb = dpre_out + brow * c;  // the row buffer: pre, then dpre
  const int P = resident ? nch : 4 * nch;    // items per tile
  const int dp0 = resident ? nch : 2 * nch;  // first dcore item
  const int L = (r_end - r_begin + TM - 1) / TM * P;

  auto prefetch = [&](int i) {
    if (i < L) {
      const int r0 = r_begin + (i / P) * TM;
      const int k = i % P;
      const uint32_t s = smem_u32(ring + (i & 1) * stage_bytes);
      if (k < nch) {  // x (+ W_q)
        load_tile<KCH>(s, xb, c, r0, TM, r_end, k * KCH, c, vec);
        if (!resident)
          load_tile<HID>(s + X_BYTES, wqkv, QKV, k * KCH, KCH, c, 0, HID,
                         vec);
      } else if (k < dp0) {  // streamed W_out for pre
        load_tile<KCH>(s, wout, c, 0, HID, HID, (k - nch) * KCH, c, vec);
      } else if (k < dp0 + nch) {  // W_out (+ dpre) for dcore
        if (!ysmem)
          load_tile<KCH>(s, dpb, c, r0, TM, r_end, (k - dp0) * KCH, c, vec);
        load_tile<KCH>(s + X_BYTES, wout, c, 0, HID, HID, (k - dp0) * KCH, c,
                       vec);
      } else {  // streamed W_q for dx_q
        load_tile<HID>(s, wqkv, QKV, (k - dp0 - nch) * KCH, KCH, c, 0, HID,
                       vec);
      }
    }
    cp_commit();
  };
  if (resident && L > 0)
    for (int ch = 0; ch < nch; ++ch) {  // committed with item 0
      load_tile<HID>(smem_u32(wq_res + ch * WQ_BYTES), wqkv, QKV, ch * KCH,
                     KCH, c, 0, HID, vec);
      load_tile<KCH>(smem_u32(wo_res + ch * WO_BYTES), wout, c, 0, HID, HID,
                     ch * KCH, c, vec);
    }
  prefetch(0);
  for (int idx = tid; idx < CBLK; idx += NTHREADS) {  // C^ of batch row bi
    const int hd = idx / (DH * DH), d = (idx / DH) % DH, e = idx % DH;
    *reinterpret_cast<float*>(ch_s + tf32x3::el(d, hd * DH + e, HROW)) =
        chat[static_cast<size_t>(bi) * CBLK + idx];
  }
  // channels past c stay zeros (dcore reads whole 32-channel chunks)
  if (ysmem)
    for (int i = tid; i < TM * yrb / 16; i += NTHREADS)
      reinterpret_cast<uint4*>(y_s)[i] = make_uint4(0, 0, 0, 0);

  // pre = core W_out + b_out for channels 32 kc .., into the row buffer
  auto pre_chunk = [&](int kc, const unsigned char* wsm, int r0, int rows) {
    float y[2][4];
    row_product<HID / 8, false>(y, smem_u32(core_s), HROW, 0, wsm, KCH * 4);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = kc * KCH + (warp >> 2) * 16 + j * 8 + 2 * t4;
      if (col >= c) continue;
      const bool two = col + 1 < c;
      const float b0 = bout[col];
      const float b1 = two ? bout[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (warp & 3) * 16 + g + 8 * h;
        if (r >= rows) continue;
        float* o = ysmem ? reinterpret_cast<float*>(y_s + elk(r, col, yrb))
                         : dpb + static_cast<size_t>(r0 + r) * c + col;
        o[0] = y[j][2 * h] + b0;
        if (two) o[1] = y[j][2 * h + 1] + b1;
      }
    }
  };

  const int j0 = tid % CW, grp = tid / CW;
  for (int k = 0; k < 2 * cpt; ++k) gsum[k * NTHREADS + tid] = 0.f;

  // LayerNorm backward of the tile's rows: dpre in place of pre, then
  // (ysmem) copied to dpre's rows for the weight gradient. Per row, a
  // group of lpr lanes (fewer than 32 where a row has at most 16 steps,
  // so that few lanes idle), 4 channels (16 bytes) a lane and step where
  // vec, else one, in two
  // passes: the sums of pre and of dy g, then (about the mean) the
  // variance and the sum of dy g (pre - mean), each pass's two group sums
  // in flight together
  auto layer_norm_bwd = [&](int r0, int rows) {
    __syncthreads();  // the row buffer holds the tile's pre
    const int cw = vec ? c >> 2 : c;  // steps of a row
    const int lpr = cw > 16 ? 32 : cw > 8 ? 16 : 8;
    const int rpw = 32 / lpr;  // rows of a warp at once
    const int ne = vec ? 4 : 1;  // channels a step
    const float inv_c = 1.f / c;
    auto group_sum2 = [&](float& u, float& v) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        if (o < lpr) {
          u += __shfl_xor_sync(0xffffffffu, u, o);
          v += __shfl_xor_sync(0xffffffffu, v, o);
        }
    };
    auto pre4 = [&](int r, int j) {  // step j of row r of pre
      if (vec)
        return ysmem ? *reinterpret_cast<const float4*>(y_s + swk(r, j, yrb))
                     : __ldcg(reinterpret_cast<const float4*>(
                           dpb + static_cast<size_t>(r0 + r) * c + 4 * j));
      return make_float4(
          ysmem ? *reinterpret_cast<const float*>(y_s + elk(r, j, yrb))
                : __ldcg(dpb + static_cast<size_t>(r0 + r) * c + j),
          0.f, 0.f, 0.f);
    };
    auto dyg4 = [&](int r, int j) {  // step j of row r of dy g
      const float* d = dyb + static_cast<size_t>(r0 + r) * c + ne * j;
      const float4 w = vec ? *reinterpret_cast<const float4*>(d)
                           : make_float4(d[0], 0.f, 0.f, 0.f);
      return make_float4(w.x * gam[ne * j], vec ? w.y * gam[4 * j + 1] : 0.f,
                         vec ? w.z * gam[4 * j + 2] : 0.f,
                         vec ? w.w * gam[4 * j + 3] : 0.f);
    };
    // every lane runs every step (the shuffles need the whole warp): TM is
    // a multiple of 8 rpw; rows past the tile read and store nothing
    for (int r = warp * rpw + lane / lpr; r < TM; r += 8 * rpw) {
      const bool live = r < rows;
      const int sl = lane % lpr;
      float s = 0.f, s1 = 0.f;
      for (int j = sl; live && j < cw; j += lpr) {
        const float4 u = pre4(r, j), w = dyg4(r, j);
        s += (u.x + u.y) + (u.z + u.w);
        s1 += (w.x + w.y) + (w.z + w.w);
      }
      group_sum2(s, s1);
      const float mean = s * inv_c;
      float var = 0.f, t2 = 0.f;
      for (int j = sl; live && j < cw; j += lpr) {
        const float4 u = pre4(r, j), w = dyg4(r, j);
        const float v[4] = {u.x - mean, u.y - mean, u.z - mean, u.w - mean};
        const float d[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < ne) {
            var = fmaf(v[e], v[e], var);
            t2 = fmaf(d[e], v[e], t2);
          }
      }
      group_sum2(var, t2);
      const float inv = rsqrtf(var * inv_c + eps);
      if (live && sl == 0) {
        rs[4 * r] = mean;
        rs[4 * r + 1] = inv;
        rs[4 * r + 2] = s1 * inv_c;
        rs[4 * r + 3] = t2 * inv * inv_c;
      }
    }
    __syncthreads();
    // dpre = (dy g - mean(dy g) - xhat mean(dy g xhat)) / sigma; dg += dy
    // xhat and db_out += dpre over this thread's rows, in order. y_s rows
    // past the tile become zeros, so that dcore is 0 there
    // (8 rows at once, their loads in flight together)
    for (int k = 0; k < cpt; ++k) {
      const int j = j0 + k * CW;
      if (j >= c) continue;
      const float gj = gam[j];
      float dga = 0.f, dba = 0.f;
      for (int r8 = grp; r8 < TM; r8 += 8 * G) {
        float dyv[8], pre[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = r8 + u * G;
          const size_t o = static_cast<size_t>(r0 + r) * c + j;
          dyv[u] = r < rows ? dyb[o] : 0.f;
          pre[u] = r >= rows ? 0.f
                   : ysmem ? *reinterpret_cast<const float*>(
                                 y_s + elk(r, j, yrb))
                           : __ldcg(dpb + o);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = r8 + u * G;
          float* ys = reinterpret_cast<float*>(y_s + elk(r, j, yrb));
          if (r >= rows) {
            if (ysmem) *ys = 0.f;
            continue;
          }
          const float* st = rs + 4 * r;  // mean, 1/sigma, the two means
          const float xh = (pre[u] - st[0]) * st[1];
          dga = fmaf(dyv[u], xh, dga);
          const float dp = st[1] * (dyv[u] * gj - (st[2] + xh * st[3]));
          dba += dp;
          if (ysmem)
            *ys = dp;
          else
            dpb[static_cast<size_t>(r0 + r) * c + j] = dp;
        }
      }
      gsum[k * NTHREADS + tid] += dga;
      gsum[(cpt + k) * NTHREADS + tid] += dba;
    }
    __syncthreads();
    if (ysmem) {
      if (vec) {
        const int c4 = c >> 2;
        for (int idx = tid; idx < rows * c4; idx += NTHREADS) {
          const int r = idx / c4, j = idx % c4;
          *reinterpret_cast<float4*>(dpb + static_cast<size_t>(r0 + r) * c +
                                     4 * j) =
              *reinterpret_cast<const float4*>(y_s + swk(r, j, yrb));
        }
      } else {
        for (int idx = tid; idx < rows * c; idx += NTHREADS) {
          const int r = idx / c, j = idx % c;
          dpb[static_cast<size_t>(r0 + r) * c + j] =
              *reinterpret_cast<const float*>(y_s + elk(r, j, yrb));
        }
      }
    }
  };

  float acc[8][4];   // q, then its softmax in fp32: 16 rows x 2 heads
  float dacc[8][4];  // dcore, then dq, in the same layout
  float dch[4][4];   // this warp's dC^ rows: head warp >> 1, d 16 (warp & 1)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dch[j][e] = 0.f;

  // dcore += dpre W_out^T over one 32-channel chunk, summed apart: A the
  // chunk's dpre (k8 steps k8a .. of rows of rb bytes), wsm the W_out
  // chunk (128 rows e x 32 channels: B^T)
  auto dcore_chunk = [&](uint32_t as, int rb, int k8a, uint32_t wsm) {
    float pc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KCH / 8; ++kk) {
      uint32_t ah[4], al[4];
      lda(ah, al, as, qm * 16, k8a + kk, rb, lane);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bh[2][2], bl[2][2];
        ldbt(bh, bl, wsm, kk * 8, qh * 64 + jj * 16, KCH * 4, lane);
        mma_3xtf32(pc[2 * jj], ah, al, bh[0], bl[0]);
        mma_3xtf32(pc[2 * jj + 1], ah, al, bh[1], bl[1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dacc[j][e] += pc[j][e];
  };
  // dx_q = dq W_q^T for output channels 32 kc .. (W_q chunk: 32 rows ci
  // x 128 e, B^T)
  auto dxq_chunk = [&](int kc, const unsigned char* wsm, int r0, int rows) {
    float y[2][4];
    row_product<HID / 8, true>(y, smem_u32(qs_s), HROW, 0, wsm, HROW);
    store_rows(y, dxq + brow * c, c, r0, rows, kc, vec);
  };
  // dcore complete in dacc: the dC^ partial, dq~, the softmax backward,
  // dq, and (resident) dx_q
  auto dq_epilogue = [&](int r0, int rows) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            core_s + elk(qm * 16 + g + 8 * h, qh * 64 + j * 8 + 2 * t4,
                         HROW)) = make_float2(dacc[j][2 * h],
                                              dacc[j][2 * h + 1]);
    __syncthreads();
    {  // dC^ partial += q~_h^T dcore_h over the tile's rows, summed apart
       // (rows past the range have dcore = 0: their dpre is zeros)
      const int hh = warp >> 1, mf = warp & 1;
      float tcc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tcc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < TM / 8; ++kk) {
        uint32_t ah[4], al[4];
        lda_t(ah, al, qs_s, kk * 8, hh * DH + mf * 16, HROW, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bh[2], bl[2];
          ldb(bh, bl, core_s, kk * 8, hh * DH + j * 8, HROW, lane);
          mma_3xtf32(tcc[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dch[j][e] += tcc[j][e];
    }
    {  // dq~ = dcore_h C^_h^T with dcore's fragments as A operands: k index
       // t is e = 2t of the step and t + 4 is e = 2t + 1, so B's rows (C^'s
       // columns e) are read in that order, both of a lane's in one 8-byte
       // load; then the softmax backward per head: dq = q~ (dq~ -
       // sum_head(dq~ q~))
      float dqs[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqs[j][e] = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int ke = 0; ke < 4; ++ke) {
          const int ja = 4 * hh + ke;
          uint32_t ah[4] = {__float_as_uint(dacc[ja][0]),
                            __float_as_uint(dacc[ja][2]),
                            __float_as_uint(dacc[ja][1]),
                            __float_as_uint(dacc[ja][3])};
          uint32_t al[4];
          split_frag(ah, al);
          const int col = (2 * qh + hh) * DH + ke * 8 + 2 * t4;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const uint2 bb = *reinterpret_cast<const uint2*>(
                ch_s + tf32x3::el(jj * 8 + g, col, HROW));
            uint32_t bh[2] = {bb.x, bb.y}, bl[2];
            split_frag(bh, bl);
            mma_3xtf32(dqs[4 * hh + jj], ah, al, bh, bl);
          }
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s0 = 4 * hh, s1 = s0 + 4;  // this head's fragments
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float s = 0.f;
#pragma unroll
          for (int j = s0; j < s1; ++j) {
            s = fmaf(dqs[j][2 * r], acc[j][2 * r], s);
            s = fmaf(dqs[j][2 * r + 1], acc[j][2 * r + 1], s);
          }
          s = quad_sum(s);
#pragma unroll
          for (int j = s0; j < s1; ++j) {
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
      for (int h = 0; h < 2; ++h) {
        const int r = qm * 16 + g + 8 * h, col = qh * 64 + j * 8 + 2 * t4;
        const float2 v = make_float2(dacc[j][2 * h], dacc[j][2 * h + 1]);
        *reinterpret_cast<float2*>(qs_s + elk(r, col, HROW)) = v;
        if (r < rows)
          *reinterpret_cast<float2*>(dqkv + (brow + r0 + r) * QKV + col) = v;
      }
    __syncthreads();
    if (resident)  // dx_q = dq W_q^T, chunk by chunk
      for (int kc = 0; kc < nch; ++kc)
        dxq_chunk(kc, wq_res + kc * WQ_BYTES, r0, rows);
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

    if (k < nch) {  // q += x W_q over this chunk, summed apart
      float pc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pc[j][e] = 0.f;
      const uint32_t xs = smem_u32(st);
      const unsigned char* ws = resident ? wq_res + k * WQ_BYTES
                                         : st + X_BYTES;
#pragma unroll
      for (int kk = 0; kk < KCH / 8; ++kk) {
        uint32_t ah[4], al[4];
        lda(ah, al, xs, qm * 16, kk, KCH * 4, lane);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t bh[2], bl[2];
          ldb(bh, bl, ws, kk * 8, qh * 64 + j * 8, HROW, lane);
          mma_3xtf32(pc[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = k == 0 ? pc[j][e] : acc[j][e] + pc[j][e];
      if (k != nch - 1) continue;

      // element e of acc[j] is row 16 qm + g + 8 (e >> 1), column 8 j +
      // 2 t4 + (e & 1) of heads 2 qh (j < 4) and 2 qh + 1: the softmax
      // over each head's 32 columns, kept in fp32
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
            acc[j][2 * r] = expf(acc[j][2 * r] - mx);
            acc[j][2 * r + 1] = expf(acc[j][2 * r + 1] - mx);
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
      // q~ into qs_s (the dC^ partial reads it transposed); core = q~_h
      // C^_h with q~'s fragments as A: k8 step kd takes d = 8 kd + (0, 2,
      // 4, 6, 1, 3, 5, 7), and C^'s rows are read in that order
      float cacc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              qs_s + elk(qm * 16 + g + 8 * h, qh * 64 + j * 8 + 2 * t4,
                         HROW)) = make_float2(acc[j][2 * h],
                                              acc[j][2 * h + 1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) cacc[j][e] = 0.f;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int kd = 0; kd < 4; ++kd) {
          const int ja = 4 * hh + kd;
          uint32_t ah[4] = {__float_as_uint(acc[ja][0]),
                            __float_as_uint(acc[ja][2]),
                            __float_as_uint(acc[ja][1]),
                            __float_as_uint(acc[ja][3])};
          uint32_t al[4];
          split_frag(ah, al);
          const int d0 = kd * 8 + 2 * t4;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int col = (2 * qh + hh) * DH + jj * 8 + g;
            uint32_t bh[2] = {lds(ch_s + tf32x3::el(d0, col, HROW)),
                              lds(ch_s + tf32x3::el(d0 + 1, col, HROW))};
            uint32_t bl[2];
            split_frag(bh, bl);
            mma_3xtf32(cacc[4 * hh + jj], ah, al, bh, bl);
          }
        }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = qm * 16 + g + 8 * h, col = qh * 64 + j * 8 + 2 * t4;
          const float2 v = make_float2(cacc[j][2 * h], cacc[j][2 * h + 1]);
          *reinterpret_cast<float2*>(core_s + elk(r, col, HROW)) = v;
          if (r < rows)
            *reinterpret_cast<float2*>(core_out + (brow + r0 + r) * HID +
                                       col) = v;
        }
      __syncthreads();
      if (!resident) continue;
      for (int kc = 0; kc < nch; ++kc)
        pre_chunk(kc, wo_res + kc * WO_BYTES, r0, rows);
      layer_norm_bwd(r0, rows);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dacc[j][e] = 0.f;
      for (int kc = 0; kc < nch; ++kc)
        dcore_chunk(smem_u32(y_s), yrb, 4 * kc,
                    smem_u32(wo_res + kc * WO_BYTES));
      dq_epilogue(r0, rows);
      continue;
    }

    if (k < dp0) {  // streamed: pre for one W_out chunk
      pre_chunk(k - nch, st, r0, rows);
      if (k == dp0 - 1) {
        layer_norm_bwd(r0, rows);
        prefetch(i + 1);
      }
      continue;
    }

    if (k >= dp0 + nch) {  // streamed: dx_q for one W_q chunk
      dxq_chunk(k - dp0 - nch, st, r0, rows);
      continue;
    }

    // dcore += dpre W_out^T over one streamed W_out chunk
    const int kc = k - dp0;
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dacc[j][e] = 0.f;
    }
    if (ysmem)
      dcore_chunk(smem_u32(y_s), yrb, 4 * kc, smem_u32(st + X_BYTES));
    else
      dcore_chunk(smem_u32(st), KCH * 4, 0, smem_u32(st + X_BYTES));
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
      for (int h = 0; h < 2; ++h) {  // two floats (qstride may be odd)
        float* o = out + hh * DH * DH + (mf * 16 + g + 8 * h) * DH + j * 8 +
                   2 * t4;
        o[0] = dch[j][2 * h];
        o[1] = dch[j][2 * h + 1];
      }
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
__device__ __forceinline__ void kv_path_tf32_body(
    const float* __restrict__ x, const float* __restrict__ wqkv,
    const float* __restrict__ stats, const float* __restrict__ dctx,
    float* __restrict__ dxkv, float* __restrict__ dqkv, int n, int c,
    int rows_per_split, int resident, int stage_bytes, int vec) {
  extern __shared__ __align__(128) unsigned char tf_smem[];
  const int nch = (c + KCH - 1) / KCH;
  unsigned char* wres = tf_smem;
  unsigned char* ring = tf_smem + (resident ? nch * WKV_BYTES : 0);
  unsigned char* ek_s = ring + 2 * stage_bytes;  // TM x HID exp(k - m)
  unsigned char* v_s = ek_s + TM * HROW;         // TM x HID v
  unsigned char* dkv_s = ek_s;                   // TM x 2 HID, after both
  unsigned char* dc_s = v_s + TM * HROW;         // dC as DH x (head, e)
  float* m_s = reinterpret_cast<float*>(dc_s + DH * HROW);
  float* ds_s = m_s + HID;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // 32 rows x 64 of [k | v]
  const int split = blockIdx.x, bi = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);
  const size_t brow = static_cast<size_t>(bi) * n;
  const float* xb = x + brow * c;
  const int P = resident ? nch : 2 * nch;
  const int L = (r_end - r_begin + TM - 1) / TM * P;

  auto prefetch = [&](int i) {
    if (i < L) {
      const int k = i % P;
      const uint32_t s = smem_u32(ring + (i & 1) * stage_bytes);
      if (k < nch) {
        load_tile<KCH>(s, xb, c, r_begin + (i / P) * TM, TM, r_end, k * KCH,
                       c, vec);
        if (!resident)
          load_tile<2 * HID>(s + X_BYTES, wqkv, QKV, k * KCH, KCH, c, HID,
                             QKV, vec);
      } else {
        load_tile<2 * HID>(s, wqkv, QKV, (k - nch) * KCH, KCH, c, HID, QKV,
                           vec);
      }
    }
    cp_commit();
  };
  if (resident && L > 0)
    for (int ch = 0; ch < nch; ++ch)  // committed with item 0
      load_tile<2 * HID>(smem_u32(wres + ch * WKV_BYTES), wqkv, QKV,
                         ch * KCH, KCH, c, HID, QKV, vec);
  prefetch(0);
  {  // dC, ds and m of batch row bi
    const float* dcb = dctx + static_cast<size_t>(bi) * (CBLK + HID);
    for (int idx = tid; idx < CBLK; idx += NTHREADS) {
      const int hd = idx / (DH * DH), d = (idx / DH) % DH, e = idx % DH;
      *reinterpret_cast<float*>(dc_s + elk(d, hd * DH + e, HROW)) = dcb[idx];
    }
    if (tid < HID) {
      ds_s[tid] = dcb[CBLK + tid];
      m_s[tid] = stats[static_cast<size_t>(bi) * STATS + tid];
    }
  }

  // dx_kv = [dk | dv] W_k|v^T for output channels 32 kc .. (W_k|v chunk:
  // 32 rows ci x 256, B^T)
  auto dxkv_chunk = [&](int kc, const unsigned char* wsm, int r0, int rows) {
    float y[2][4];
    row_product<2 * HID / 8, true>(y, smem_u32(dkv_s), 2 * HROW, 0, wsm,
                                   2 * HROW);
    store_rows(y, dxkv + brow * c, c, r0, rows, kc, vec);
  };

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
      dxkv_chunk(k - nch, st, r0, rows);
      continue;
    }
    {  // k|v += x W_k|v over this chunk, summed apart
      float pc[2][8][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) pc[mi][j][e] = 0.f;
      const uint32_t xs = smem_u32(st);
      const unsigned char* ws = resident ? wres + k * WKV_BYTES
                                         : st + X_BYTES;
#pragma unroll
      for (int kk = 0; kk < KCH / 8; ++kk) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          lda(ah[mi], al[mi], xs, wm * 32 + mi * 16, kk, KCH * 4, lane);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t bh[2], bl[2];
          ldb(bh, bl, ws, kk * 8, wn * 64 + j * 8, 2 * HROW, lane);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma_3xtf32(pc[mi][j], ah[mi], al[mi], bh, bl);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mi][j][e] =
                k == 0 ? pc[mi][j][e] : acc[mi][j][e] + pc[mi][j][e];
    }
    if (k != nch - 1) continue;

    // element e of acc[mi][j] is row 32 wm + 16 mi + g + 8 (e >> 1),
    // column 64 wn + 8 j + 2 t4 + (e & 1) of [k | v]: k becomes exp(k -
    // m) (into ek_s, and kept), v goes to v_s
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
          float v0 = acc[mi][j][2 * h], v1 = acc[mi][j][2 * h + 1];
          if (kside) {
            v0 = expf(v0 - m_s[col]);
            v1 = expf(v1 - m_s[col + 1]);
          }
          acc[mi][j][2 * h] = v0;
          acc[mi][j][2 * h + 1] = v1;
          *reinterpret_cast<float2*>(
              dst + elk(wm * 32 + mi * 16 + g + 8 * h, col, HROW)) =
              make_float2(v0, v1);
        }
      }
    __syncthreads();
    // k side: dk = ek (v_h dC_h^T + ds); v side: dv = ek_h dC_h; per head,
    // each product's 4 k8 steps summed apart, into acc
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
      for (int kk = 0; kk < DH / 8; ++kk) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          lda(ah[mi], al[mi], smem_u32(kside ? v_s : ek_s),
              wm * 32 + mi * 16, 4 * hd + kk, HROW, lane);
        if (kside) {  // B = dC^T: dC's rows d are n, its columns e are k
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            uint32_t bh[2][2], bl[2][2];
            ldbt(bh, bl, smem_u32(dc_s), hd * DH + kk * 8, jj * 16, HROW,
                 lane);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_3xtf32(t[mi][2 * jj], ah[mi], al[mi], bh[0], bl[0]);
              mma_3xtf32(t[mi][2 * jj + 1], ah[mi], al[mi], bh[1], bl[1]);
            }
          }
        } else {  // B = dC: rows d are k, columns e are n
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t bh[2], bl[2];
            ldb(bh, bl, dc_s, kk * 8, hd * DH + j * 8, HROW, lane);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              mma_3xtf32(t[mi][j], ah[mi], al[mi], bh, bl);
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
            if (kside)
              o *= t[mi][j][e] + ds_s[hd * DH + j * 8 + 2 * t4 + (e & 1)];
            else
              o = t[mi][j][e];
          }
    }
    __syncthreads();  // every warp is done with ek_s and v_s
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + mi * 16 + g + 8 * h;
          const int col = wn * 64 + j * 8 + 2 * t4;
          const float2 v = make_float2(acc[mi][j][2 * h],
                                       acc[mi][j][2 * h + 1]);
          *reinterpret_cast<float2*>(dkv_s + elk(r, col, 2 * HROW)) = v;
          if (r < rows)
            *reinterpret_cast<float2*>(dqkv + (brow + r0 + r) * QKV + HID +
                                       col) = v;
        }
    __syncthreads();
    if (resident)  // dx_kv = [dk | dv] W_k|v^T, chunk by chunk
      for (int kc = 0; kc < nch; ++kc)
        dxkv_chunk(kc, wres + kc * WKV_BYTES, r0, rows);
  }
  cp_wait<0>();
}

// part[split] (P, Q) = sum over rows split * rows_per_split .. of
// a[row]^T b[row]: a is (rows, P), b (rows, Q), both row-major fp32. Grid
// (ceil(P / 64), ceil(Q / 128), splits): a 64 x 128 output tile per block,
// 2 x 4 warps of 32 x 32, a ring of WG_STAGES stages of 32 rows, each
// stage's products summed apart; A^T by 32-bit loads.
__device__ __forceinline__ void wgrad_tf32_body(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ part, long long rows, int P, int Q,
    long long rows_per_split, int vec) {
  extern __shared__ __align__(128) unsigned char tf_smem[];
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
      const uint32_t st =
          smem_u32(tf_smem + (i % WG_STAGES) * (WG_A + WG_B));
      const long long k0 = r_begin + static_cast<long long>(i) * WG_K;
      load_tile<WG_P>(st, a, P, k0, WG_K, r_end, p0, P, vec);
      load_tile<WG_Q>(st + WG_A, b, Q, k0, WG_K, r_end, q0, Q, vec);
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
    const unsigned char* st = tf_smem + (i % WG_STAGES) * (WG_A + WG_B);
    float pc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pc[mi][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < WG_K / 8; ++kk) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        lda_t(ah[mi], al[mi], st, kk * 8, wp * 32 + mi * 16, WG_P * 4, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bh[2], bl[2];
        ldb(bh, bl, st + WG_A, kk * 8, wq * 32 + j * 8, WG_Q * 4, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          mma_3xtf32(pc[mi][j], ah[mi], al[mi], bh, bl);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] += pc[mi][j][e];
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
        float* o = out + static_cast<size_t>(p) * Q + q;
        if (q < Q) o[0] = acc[mi][j][2 * h];
        if (q + 1 < Q) o[1] = acc[mi][j][2 * h + 1];
      }
    }
}

// Dynamic shared memory of the q path and the kv path for c channels,
// weights resident or streamed.
inline size_t q_path_smem(int c, bool resident, bool ysmem) {
  const int nch = (c + KCH - 1) / KCH;
  const int cpt = (c + tc::col_width(c) - 1) / tc::col_width(c);
  const size_t fixed = DH * HROW + 2 * TM * HROW + TM * 4 * sizeof(float) +
                       (ysmem ? static_cast<size_t>(TM) * nch * KCH * 4 : 0) +
                       2 * cpt * NTHREADS * sizeof(float);
  return resident ? static_cast<size_t>(nch) * (WQ_BYTES + WO_BYTES) +
                        2 * X_BYTES + fixed
                  : 2 * (X_BYTES + WQ_BYTES) + fixed;
}

inline size_t kv_path_smem(int c, bool resident) {
  const int nch = (c + KCH - 1) / KCH;
  const size_t fixed = 2 * TM * HROW + DH * HROW + 2 * HID * sizeof(float);
  return resident ? static_cast<size_t>(nch) * WKV_BYTES + 2 * X_BYTES + fixed
                  : 2 * (X_BYTES + WKV_BYTES) + fixed;
}

}  // namespace bwd32
}  // namespace la
}  // namespace prgpt
