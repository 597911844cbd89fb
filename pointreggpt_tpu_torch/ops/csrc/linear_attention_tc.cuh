// K1's bf16 bodies on the tensor cores, written for Hopper (sm_90a):
// kernels A (kv_partials_tc) and C (emit_out_tc) of K1's three launches
// (linear_attention.cu); its kernel B is linear_attention_kv.cuh's
// merge_context_body, which merges A's (m, s, C) partials with one thread
// per entry of C^. K3's bf16 backward runs A and B too
// (linear_attention_bwd.cu); the fp32 paths have bodies of their own
// (linear_attention_tf32.cuh), and K4 (linear_attention_core.cu) uses this
// file's fragment loaders and swizzle.
//
// - Tiles. TM (64) rows, 8 warps. x is staged by cp.async in chunks of
//   KCH (64) channels, 128-byte rows; channels past c are zero-filled (c
//   must be a multiple of 8), rows past the range too.
// - Weights. Chunked as x is: W_k|v 64 x 256 (32 KB), W_q 64 x 128 and
//   W_out 128 x 64 (16 KB each). Where all chunks fit beside the tile
//   buffers they are loaded once per block and stay resident (c <= 256);
//   otherwise each ring stage carries its chunk of weights with x's chunk
//   (streamed from L2). A block walks many tiles (A: its split's row range;
//   C: a persistent grid over all tiles), so resident weights are read once
//   per block, not once per tile.
// - Ring. Two stages, one work item (a tile's chunk) each: item i + 1
//   loads while item i computes.
// - Swizzle. Every staged row is a multiple of 128 bytes; 16-byte chunk j
//   of row r sits at j ^ (r & 7), so the 8 rows of one ldmatrix hit 8
//   different bank groups, and the 4-byte fragment stores of a warp 32
//   different banks.
// - Products. mma.sync.m16n8k16, bf16 in, fp32 accumulators, from
//   ldmatrix (A row-major; B, and A = ek^T, by ldmatrix.trans).
// - A. k|v = x W_k|v (2 x 4 warps of 32 rows x 64 columns), rounded to
//   bf16. The column max of k over the tile by quad shuffles, then across
//   the two row warps through shared memory, updates the running max m;
//   exp(k - m) goes to shared memory rounded to bf16, its fp32 column sums
//   to the running sum s. Each warp owns 16 rows of one head's 32 x 32
//   block of C, rescales them by alpha[d] and adds ek_h^T v_h by mma.
// - C. q = x W_q (4 x 2 warps of 16 rows x two heads), rounded; the
//   softmax over each head's 32 columns on the accumulator fragments
//   (quad shuffles), rounded; core = q C^_h by mma with the softmax
//   fragments repacked as A operands, rounded, into shared memory; y =
//   core W_out by mma in 64-channel chunks (2 x 4 warps of 32 rows x 16
//   channels), rounded, the bias added and rounded again, held as a bf16
//   row tile in shared memory; the LayerNorm over c is two-pass per row,
//   one warp per row, 16-byte loads and stores.
//
// Rounding happens where the plain version (ops/linear_attention.py::
// _fused_plain) materializes bf16: qkv, exp(k - m), C^, the softmaxed q,
// the core and y (+ bias). Only the order of fp32 sums differs.
#pragma once

#include "linear_attention_kv.cuh"

namespace prgpt {
namespace la {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int TM = 64;            // rows per tile
constexpr int NTHREADS = 256;     // 8 warps
constexpr int KCH = 64;           // channels per chunk
constexpr int HID_ROW = HID * 2;  // bytes of a row of 128 bf16
constexpr int X_BYTES = TM * KCH * 2;        // x chunk, 128-byte rows
constexpr int WKV_BYTES = KCH * 2 * HID * 2;  // W_k|v chunk, 512-byte rows
constexpr int WQ_BYTES = KCH * HID * 2;       // W_q chunk, 256-byte rows
constexpr int WO_BYTES = HID * KCH * 2;       // W_out chunk, 128-byte rows
// kernel A's buffers beside weights and ring: ek and v tiles, the column
// reduction, running max and rescale
constexpr int A_FIXED = 2 * TM * HID_ROW + 4 * HID * 4;

// x rounded to bf16 (nearest, ties to even) and back to fp32, as
// rnd<bf16> does, on the integer pipe (four ALU operations instead of two
// conversions, which issue at a quarter of the rate); exact for every
// finite x and for infinities
__device__ __forceinline__ float rnd16(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// byte offset of 16-byte chunk j of row r, rows of rb bytes (a multiple of
// 128): chunk j sits at j ^ (r & 7)
__device__ __forceinline__ uint32_t swz(int r, int j, int rb) {
  return r * rb + ((j ^ (r & 7)) << 4);
}

// byte offset of bf16 element (r, col)
__device__ __forceinline__ uint32_t el(int r, int col, int rb) {
  return swz(r, col >> 3, rb) + (col & 7) * 2;
}

// rows r0 .. r0 + TM (zeros from r_lim) and channels c0 .. c0 + KCH (zeros
// from c) of x (rows of c) into dst
__device__ __forceinline__ void load_x(uint32_t dst, const bf16* x, int c,
                                       int r0, int r_lim, int c0) {
  for (int i = threadIdx.x; i < TM * 8; i += NTHREADS) {
    const int r = i >> 3, j = i & 7;
    const int ch = c0 + 8 * j;
    const bool in = r0 + r < r_lim && ch < c;
    cp16(dst + swz(r, j, KCH * 2),
         in ? x + static_cast<size_t>(r0 + r) * c + ch : x, in);
  }
}

// rows k0 .. k0 + nk (zeros from k_lim) and columns col0 .. col0 + NCOLS
// (zeros from col_lim) of w (rows of ld) into dst
template <int NCOLS>
__device__ __forceinline__ void load_w(uint32_t dst, const bf16* w, int ld,
                                       int k0, int nk, int k_lim, int col0,
                                       int col_lim) {
  constexpr int CPR = NCOLS / 8;
  for (int i = threadIdx.x; i < nk * CPR; i += NTHREADS) {
    const int r = i / CPR, j = i % CPR;
    const int col = col0 + 8 * j;
    const bool in = k0 + r < k_lim && col < col_lim;
    cp16(dst + swz(r, j, NCOLS * 2),
         in ? w + static_cast<size_t>(k0 + r) * ld + col : w, in);
  }
}

// A fragment: rows row0 .. row0 + 16, k 16 k16 .. of a row-major tile
__device__ __forceinline__ void lda(uint32_t (&a)[4], uint32_t base, int row0,
                                    int k16, int rb, int lane) {
  ldm_x4(a, base + swz(row0 + (lane & 15), 2 * k16 + (lane >> 4), rb));
}

// A fragment of the transpose of a row-major k x m tile: m0 .. m0 + 16,
// k0 .. k0 + 16
__device__ __forceinline__ void lda_t(uint32_t (&a)[4], uint32_t base, int k0,
                                      int m0, int rb, int lane) {
  ldm_x4_trans(a, base + swz(k0 + (lane & 7) + (lane >> 4) * 8,
                             (m0 >> 3) + ((lane >> 3) & 1), rb));
}

// B fragments of n8 blocks n0 and n0 + 8 (b[0..1], b[2..3]), k0 .. k0 + 16,
// of a row-major k x n tile
__device__ __forceinline__ void ldb(uint32_t (&b)[4], uint32_t base, int k0,
                                    int n0, int rb, int lane) {
  ldm_x4_trans(b, base + swz(k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                             (n0 >> 3) + (lane >> 4), rb));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// over the 8 row groups g of a warp (lanes with the same lane & 3)
__device__ __forceinline__ float col_max(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float col_sum(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Kernel A over grid (splits, b): the (m, s, C) partials of split
// blockIdx.x of batch row blockIdx.y, in PSTRIDE floats each: m, s, then
// the four 32x32 head blocks of C.
__device__ __forceinline__ void kv_partials_tc_body(
    const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
    float* __restrict__ part, int n, int c, int rows_per_split, int splits,
    int resident, int stage_bytes) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int nch = (c + KCH - 1) / KCH;
  unsigned char* wres = tc_smem;
  unsigned char* ring = tc_smem + (resident ? nch * WKV_BYTES : 0);
  unsigned char* ek_s = ring + 2 * stage_bytes;  // TM x HID, exp(k - m)
  unsigned char* v_s = ek_s + TM * HID_ROW;      // TM x HID, v
  float* red = reinterpret_cast<float*>(v_s + TM * HID_ROW);  // [2][HID]
  float* m_s = red + 2 * HID;                    // running max
  float* al_s = m_s + HID;                       // this tile's rescale

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // 32 rows x 64 of [k | v]
  const int hh = warp >> 1, mf = warp & 1;  // C rows 16 mf .. of head hh
  const int split = blockIdx.x, bi = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);
  const bf16* xb = x + static_cast<size_t>(bi) * n * c;
  const int L = (r_end - r_begin + TM - 1) / TM * nch;

  auto prefetch = [&](int i) {
    if (i < L) {
      const int ch = i % nch;
      unsigned char* st = ring + (i & 1) * stage_bytes;
      load_x(smem_u32(st), xb, c, r_begin + (i / nch) * TM, r_end, ch * KCH);
      if (!resident)
        load_w<2 * HID>(smem_u32(st + X_BYTES), wqkv, QKV, ch * KCH, KCH, c,
                        HID, QKV);
    }
    cp_commit();
  };
  if (resident)
    for (int ch = 0; ch < nch; ++ch)
      load_w<2 * HID>(smem_u32(wres + ch * WKV_BYTES), wqkv, QKV, ch * KCH,
                      KCH, c, HID, QKV);  // committed with item 0
  prefetch(0);
  if (tid < HID) m_s[tid] = -INFINITY;
  float run_s = 0.f;  // thread tid < HID: the running sum of lane tid

  float acc[2][8][4];  // k|v: rows 32 wm + 16 mi .., columns 64 wn + 8 j ..
  float cacc[4][4];    // C of head hh: d 16 mf + g (+ 8), e 8 j + 2 t4 ..
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cacc[j][e] = 0.f;

  for (int i = 0; i < L; ++i) {
    cp_wait<0>();
    // item i is in shared memory for every thread, and every warp is done
    // with item i - 1, whose stage the prefetch below refills
    __syncthreads();
    prefetch(i + 1);
    const int ch = i % nch;
    unsigned char* st = ring + (i & 1) * stage_bytes;
    const uint32_t xs = smem_u32(st);
    const uint32_t ws = smem_u32(resident ? wres + ch * WKV_BYTES
                                          : st + X_BYTES);
    if (ch == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
    }
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
    if (ch != nch - 1) continue;

    // the tile's epilogue: element e of acc[mi][j] is row
    // 32 wm + 16 mi + g + 8 (e >> 1), column 64 wn + 8 j + 2 t4 + (e & 1)
    const int rows = min(TM, r_end - (r_begin + (i / nch) * TM));
    if (wn < 2) {  // k: rounded, rows past the tile masked, column max
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = wm * 32 + mi * 16 + g + 8 * (e >> 1);
            acc[mi][j][e] = r < rows ? rnd16(acc[mi][j][e]) : -INFINITY;
          }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const float mx = col_max(
              fmaxf(fmaxf(acc[0][j][e2], acc[0][j][e2 + 2]),
                    fmaxf(acc[1][j][e2], acc[1][j][e2 + 2])));
          if (g == 0) red[wm * HID + wn * 64 + j * 8 + 2 * t4 + e2] = mx;
        }
    } else {  // v: rounded into v_s (rows past the tile are zeros)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(
                v_s + el(wm * 32 + mi * 16 + g + 8 * h,
                         (wn - 2) * 64 + j * 8 + 2 * t4, HID_ROW)) =
                pack_bf16x2(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
    }
    __syncthreads();
    if (tid < HID) {
      const float m_old = m_s[tid];
      const float m_new = fmaxf(m_old, fmaxf(red[tid], red[HID + tid]));
      const float al = expf(m_old - m_new);
      m_s[tid] = m_new;
      al_s[tid] = al;
      run_s *= al;
    }
    __syncthreads();
    if (wn < 2) {  // exp(k - m) rounded into ek_s; its fp32 column sums
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = wn * 64 + j * 8 + 2 * t4;
        const float m0 = m_s[col], m1 = m_s[col + 1];
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float p0 = __expf(acc[mi][j][2 * h] - m0);
            const float p1 = __expf(acc[mi][j][2 * h + 1] - m1);
            s0 += p0;
            s1 += p1;
            *reinterpret_cast<uint32_t*>(
                ek_s + el(wm * 32 + mi * 16 + g + 8 * h, col, HID_ROW)) =
                pack_bf16x2(p0, p1);
          }
        s0 = col_sum(s0);
        s1 = col_sum(s1);
        if (g == 0) {
          red[wm * HID + col] = s0;
          red[wm * HID + col + 1] = s1;
        }
      }
    }
    __syncthreads();
    if (tid < HID) run_s += red[tid] + red[HID + tid];
    {  // C_h = alpha C_h + ek_h^T v_h
      const float a0 = al_s[hh * DH + mf * 16 + g];
      const float a1 = al_s[hh * DH + mf * 16 + g + 8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) cacc[j][e] *= e < 2 ? a0 : a1;
#pragma unroll
      for (int kk = 0; kk < TM / 16; ++kk) {
        uint32_t a[4];
        lda_t(a, smem_u32(ek_s), kk * 16, hh * DH + mf * 16, HID_ROW, lane);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t b[4];
          ldb(b, smem_u32(v_s), kk * 16, hh * DH + jj * 16, HID_ROW, lane);
          mma16816(cacc[2 * jj], a, b[0], b[1]);
          mma16816(cacc[2 * jj + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  float* po = part + (static_cast<size_t>(bi) * splits + split) * PSTRIDE;
  if (tid < HID) {
    po[tid] = m_s[tid];
    po[HID + tid] = run_s;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(po + 2 * HID + hh * DH * DH +
                                 (mf * 16 + g + 8 * h) * DH + j * 8 +
                                 2 * t4) =
          make_float2(cacc[j][2 * h], cacc[j][2 * h + 1]);
}

// Kernel C over a persistent grid: block blockIdx.x takes the
// ceil(tiles / gridDim.x) consecutive tiles from blockIdx.x times that of
// the b x ceil(n / TM) row tiles (batch row major), so that its batch row,
// and with it the C^ it stages, changes at most a few times. Work items per
// tile: its nch x chunks, then (weights streamed) its nch W_out chunks.
__device__ __forceinline__ void emit_out_tc_body(
    const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
    const bf16* __restrict__ wout, const float* __restrict__ bout,
    const float* __restrict__ gam, const float* __restrict__ chat,
    bf16* __restrict__ out, int b, int n, int c, float eps, int resident,
    int stage_bytes, int yglob) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int nch = (c + KCH - 1) / KCH;
  const int yrb = nch * KCH * 2;  // bytes of a y row
  unsigned char* wq_res = tc_smem;
  unsigned char* wo_res = tc_smem + nch * WQ_BYTES;
  unsigned char* ring = tc_smem + (resident ? nch * (WQ_BYTES + WO_BYTES) : 0);
  unsigned char* ch_s = ring + 2 * stage_bytes;  // C^ as DH x (head, e)
  unsigned char* core_s = ch_s + DH * HID_ROW;   // TM x HID
  unsigned char* y_s = core_s + TM * HID_ROW;    // TM x nch KCH, or none

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int qm = warp & 3, qh = warp >> 2;  // q: 16 rows x heads 2qh, 2qh+1
  const int wm = warp & 1, wn = warp >> 1;  // y: 32 rows x 16 channels
  const int row_tiles = (n + TM - 1) / TM;
  const int tiles = b * row_tiles;
  const int per = (tiles + gridDim.x - 1) / gridDim.x;
  const int t0 = blockIdx.x * per;
  const int my = max(0, min(tiles, t0 + per) - t0);
  const int P = resident ? nch : 2 * nch;  // items per tile
  const int L = my * P;

  auto prefetch = [&](int i) {
    if (i < L) {
      const int tt = t0 + i / P;
      const int bi = tt / row_tiles, r0 = (tt % row_tiles) * TM;
      const int k = i % P;
      unsigned char* st = ring + (i & 1) * stage_bytes;
      if (k < nch) {
        load_x(smem_u32(st), x + static_cast<size_t>(bi) * n * c, c, r0, n,
               k * KCH);
        if (!resident)
          load_w<HID>(smem_u32(st + X_BYTES), wqkv, QKV, k * KCH, KCH, c, 0,
                      QKV);
      } else {
        load_w<KCH>(smem_u32(st), wout, c, 0, HID, HID, (k - nch) * KCH, c);
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

  // y = core W_out for output channels 64 kc .., rounded, + bias, rounded,
  // into y_s, or (yglob: the tile of y does not fit) into out's rows
  auto out_chunk = [&](int kc, uint32_t wsm, int bi, int r0) {
    float y[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[mi][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HID / 16; ++kk) {
      uint32_t a[2][4], bw[4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        lda(a[mi], smem_u32(core_s), wm * 32 + mi * 16, kk, HID_ROW, lane);
      ldb(bw, wsm, kk * 16, wn * 16, KCH * 2, lane);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma16816(y[mi][0], a[mi], bw[0], bw[1]);
        mma16816(y[mi][1], a[mi], bw[2], bw[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = kc * KCH + wn * 16 + j * 8 + 2 * t4;
      if (col >= c) continue;  // c % 8 == 0: col + 1 < c as well
      const float2 bj =
          make_float2(rnd16(bout[col]), rnd16(bout[col + 1]));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + mi * 16 + g + 8 * h;
          const uint32_t v = pack_bf16x2(rnd16(y[mi][j][2 * h]) + bj.x,
                                         rnd16(y[mi][j][2 * h + 1]) + bj.y);
          if (!yglob)
            *reinterpret_cast<uint32_t*>(y_s + el(r, col, yrb)) = v;
          else if (r0 + r < n)
            *reinterpret_cast<uint32_t*>(
                out + (static_cast<size_t>(bi) * n + r0 + r) * c + col) = v;
        }
    }
  };

  // LayerNorm over c of the tile's rows of y_s, two passes: a group of
  // lpr lanes per row (8 where c <= 64, so that no lane idles), 8
  // channels (16 bytes) per lane and step
  auto layer_norm = [&](int bi, int r0) {
    const int c8 = c >> 3;
    auto yld = [&](int r, int j) {  // 8 channels of row r of y
      return yglob ? __ldcg(reinterpret_cast<const uint4*>(
                         out + (static_cast<size_t>(bi) * n + r0 + r) * c +
                         8 * j))
                   : *reinterpret_cast<const uint4*>(y_s + swz(r, j, yrb));
    };
    const int lpr = c8 > 16 ? 32 : c8 > 8 ? 16 : 8;
    const int rpw = 32 / lpr;  // rows of a warp at once
    auto group_sum = [&](float v) {
      for (int o = lpr >> 1; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      return v;
    };
    // every lane runs every step (the shuffles need the whole warp):
    // TM is a multiple of 8 rpw
    for (int r = warp * rpw + lane / lpr; r < TM; r += 8 * rpw) {
      // yglob holds only the rows of out; it needs c > 256, where a row
      // is a whole warp's
      if (yglob && r0 + r >= n) continue;
      const int sl = lane % lpr;
      float s = 0.f;
      for (int j = sl; j < c8; j += lpr) {
        const uint4 u = yld(r, j);
        const bf16* v = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += __bfloat162float(v[e]);
      }
      const float mean = group_sum(s) / c;
      float var = 0.f;
      for (int j = sl; j < c8; j += lpr) {
        const uint4 u = yld(r, j);
        const bf16* v = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = __bfloat162float(v[e]) - mean;
          var = fmaf(d, d, var);
        }
      }
      const float inv = rsqrtf(group_sum(var) / c + eps);
      if (r0 + r >= n) continue;
      bf16* orow = out + (static_cast<size_t>(bi) * n + r0 + r) * c;
      for (int j = sl; j < c8; j += lpr) {
        const uint4 u = yld(r, j);
        const bf16* v = reinterpret_cast<const bf16*>(&u);
        const float4 g0 = *reinterpret_cast<const float4*>(gam + 8 * j);
        const float4 g1 = *reinterpret_cast<const float4*>(gam + 8 * j + 4);
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = pack_bf16x2(
              (__bfloat162float(v[2 * e]) - mean) * inv * gv[2 * e],
              (__bfloat162float(v[2 * e + 1]) - mean) * inv * gv[2 * e + 1]);
        *reinterpret_cast<uint4*>(orow + 8 * j) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  };

  int cur_b = -1;
  float acc[8][4];  // q, then its softmax: 16 rows x 64 columns (2 heads)
  for (int i = 0; i < L; ++i) {
    cp_wait<0>();
    // item i is in shared memory for every thread, and every warp is done
    // with item i - 1, whose stage the prefetch below refills
    __syncthreads();
    prefetch(i + 1);
    const int tt = t0 + i / P;
    const int bi = tt / row_tiles, r0 = (tt % row_tiles) * TM;
    const int k = i % P;
    unsigned char* st = ring + (i & 1) * stage_bytes;
    if (k >= nch) {  // a streamed W_out chunk
      out_chunk(k - nch, smem_u32(st), bi, r0);
      if (k == P - 1) {
        __syncthreads();
        layer_norm(bi, r0);
      }
      continue;
    }

    // q += x W_q over this chunk's channels
    if (k == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
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

    if (bi != cur_b) {  // C^ of batch row bi, exact in bf16 (B rounded it)
      for (int idx = tid; idx < CBLK; idx += NTHREADS) {
        const int hd = idx / (DH * DH), d = (idx / DH) % DH, e = idx % DH;
        *reinterpret_cast<bf16*>(ch_s + el(d, hd * DH + e, HID_ROW)) =
            __float2bfloat16_rn(chat[static_cast<size_t>(bi) * CBLK + idx]);
      }
      __syncthreads();
      cur_b = bi;
    }

    // element e of acc[j] is row 16 qm + g + 8 (e >> 1), column 8 j + 2 t4
    // + (e & 1) of heads 2 qh (j < 4) and 2 qh + 1 (j >= 4): q rounded,
    // then its softmax over each head's 32 columns, rounded
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = rnd16(acc[j][e]);
    float hmax[2][2], hinv[2][2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int nb0 = 4 * hh, nb1 = nb0 + 4;  // this head's fragments
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = nb0; j < nb1; ++j)
          mx = fmaxf(mx, fmaxf(acc[j][2 * r], acc[j][2 * r + 1]));
        hmax[hh][r] = quad_max(mx);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = __expf(acc[j][e] - hmax[j >> 2][e >> 1]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int nb0 = 4 * hh, nb1 = nb0 + 4;  // this head's fragments
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sm = 0.f;
#pragma unroll
        for (int j = nb0; j < nb1; ++j) sm += acc[j][2 * r] + acc[j][2 * r + 1];
        hinv[hh][r] = 1.f / quad_sum(sm);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = rnd16(acc[j][e] * hinv[j >> 2][e >> 1]);

    // core = softmax(q)_h C^_h per head: the softmax fragments repacked as
    // A operands (k = d), C^ rows d as B; rounded into core_s
    float cacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cacc[j][e] = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int kd = 0; kd < 2; ++kd) {
        const int j0 = 4 * hh + 2 * kd;
        const uint32_t a[4] = {pack_bf16x2(acc[j0][0], acc[j0][1]),
                               pack_bf16x2(acc[j0][2], acc[j0][3]),
                               pack_bf16x2(acc[j0 + 1][0], acc[j0 + 1][1]),
                               pack_bf16x2(acc[j0 + 1][2], acc[j0 + 1][3])};
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
    if (resident) {
      for (int kc = 0; kc < nch; ++kc)
        out_chunk(kc, smem_u32(wo_res + kc * WO_BYTES), bi, r0);
      __syncthreads();
      layer_norm(bi, r0);
    }
  }
  cp_wait<0>();
}

// Dynamic shared memory of kernel A (weights resident or streamed) and
// kernel C for c channels (yglob: its tile of y kept in out's rows).
inline size_t kv_smem(int c, bool resident) {
  const int nch = (c + KCH - 1) / KCH;
  return resident ? static_cast<size_t>(nch) * WKV_BYTES + 2 * X_BYTES + A_FIXED
                  : 2 * (X_BYTES + WKV_BYTES) + A_FIXED;
}

inline size_t emit_smem(int c, bool resident, bool yglob = false) {
  const int nch = (c + KCH - 1) / KCH;
  const size_t fixed = DH * HID_ROW + TM * HID_ROW +
                       (yglob ? 0 : static_cast<size_t>(TM) * nch * KCH * 2);
  return resident ? static_cast<size_t>(nch) * (WQ_BYTES + WO_BYTES) +
                        2 * X_BYTES + fixed
                  : 2 * (X_BYTES + WQ_BYTES) + fixed;
}

}  // namespace tc
}  // namespace la
}  // namespace prgpt
