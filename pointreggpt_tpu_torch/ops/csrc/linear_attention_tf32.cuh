// K1's fp32 bodies, written for Hopper (sm_90a): kernels A
// (kv_partials_tf32) and C (emit_out_tf32) of K1's three launches
// (linear_attention.cu), on the TF32 tensor cores; kernel B is
// linear_attention_kv.cuh's merge_context_body, as in bf16. A writes the
// same (m, s, C) partials as the other bodies, in the same scratch layout.
// K3's fp32 backward (linear_attention_bwd.cu) launches this A and B too,
// so that it recomputes the forward's statistics bit for bit. K4
// (linear_attention_core.cu) uses this file's swizzles.
//
// Every product runs in three TF32 passes (common.cuh: a b ~= a_lo b_hi +
// a_hi b_lo + a_hi b_hi, about 21 bits of each product, where one TF32
// pass keeps 10): mma.sync.m16n8k8.tf32 with fp32 accumulators. Each A
// fragment is split once and reused over every n8 tile it meets. The
// tensor cores truncate the sum each mma accumulates, so a long sum into
// one fragment drifts by about a unit in its last place per mma (at c =
// 2048, 768 of them): the products of each 32-channel chunk, and of each
// tile's context update, go into fragments of their own and are added to
// the running sums in fp32.
//
// The structure is linear_attention_tc.cuh's, with fp32 byte counts:
// - Tiles. TM (64) rows, 8 warps. x is staged by cp.async in chunks of
//   KCH (32) channels, 128-byte rows; channels past c and rows past the
//   range are zero-filled. Where c % 4 == 0 and every tensor is 16-byte
//   aligned the copies are 16 bytes, else 4 bytes (a ragged c such as a
//   dim-34 net's).
// - Weights. Chunked as x is: W_k|v 32 x 256 (32 KB), W_q 32 x 128 and
//   W_out 128 x 32 (16 KB each). Resident in shared memory where all
//   chunks fit beside the tile buffers (A: c <= 128, C: c <= 128);
//   otherwise each ring stage carries its chunk of weights with x's chunk.
// - Fragments. A operands that are row-major in shared memory (x, the
//   core) come by ldmatrix, whose b16 pairs are the 32-bit elements: a
//   32-bit element is two b16 halves, and a non-transposed 8x8 b16 matrix
//   is an 8x4 matrix of 32-bit elements, one per lane in the order the
//   tf32 fragment wants. B operands and the transposed A of ek^T need
//   (row t, column g) elements, which ldmatrix.trans cannot give for
//   32-bit elements: plain 32-bit shared loads.
// - Swizzles. Tiles read by ldmatrix (x, the core), and C^ and the y row
//   tile, keep 16-byte chunk j of row r at j ^ (r & 7): the 8 rows of a
//   matrix, and C^'s rows 2t, 2t + 1 (below), hit 8 different bank
//   groups. Tiles read
//   in (row t, column g) order (the weights, ek and v) keep 32-byte group
//   j of row r at j ^ (r & 3): the 4 rows t of a load hit 4 different
//   groups of 8 banks. Rows are multiples of 128 bytes.
// - A. k|v = x W_k|v (2 x 4 warps of 32 rows x 64 columns). The column max
//   of k over the tile by quad shuffles, then across the two row warps
//   through shared memory, updates the running max m; exp(k - m) goes to
//   shared memory, its column sums to the running sum s. Each warp owns 16
//   rows of one head's 32 x 32 block of C, rescales them by alpha[d] and
//   adds ek_h^T v_h.
// - C (persistent grid). q = x W_q (4 x 2 warps of 16 rows x two heads);
//   the softmax over each head's 32 columns on the accumulator fragments
//   (quad shuffles); core = q C^_h with the softmax fragments as A
//   operands: they hold columns 2t and 2t + 1 where A wants k indices t
//   and t + 4, so each k8 step takes its 8 d in the order 0, 2, 4, 6, 1,
//   3, 5, 7 and reads C^'s rows in that order; y = core W_out in 32-channel
//   chunks (4 x 2 warps of 16 rows x 16 channels) + bias, held as a row
//   tile in shared memory (in out's rows where it does not fit, c > 512);
//   the LayerNorm over c is two-pass per row, one lane group per row.
//
// No rounding point: the plain version keeps every intermediate in fp32.
#pragma once

#include "linear_attention_kv.cuh"
#include "linear_attention_tc.cuh"

namespace prgpt {
namespace la {
namespace tf32x3 {

// the fragment reductions of the bf16 bodies: over a quad (a row's lanes)
// and over the 8 row groups of a warp (a column's lanes)
using tc::col_max;
using tc::col_sum;
using tc::quad_max;
using tc::quad_sum;

constexpr int TM = 64;                        // rows per tile
constexpr int NTHREADS = 256;                 // 8 warps
constexpr int KCH = 32;                       // channels per chunk
constexpr int HROW = HID * 4;                 // bytes of a row of 128 floats
constexpr int X_BYTES = TM * KCH * 4;         // x chunk, 128-byte rows
constexpr int WKV_BYTES = KCH * 2 * HROW;     // W_k|v chunk, 1 KB rows
constexpr int WQ_BYTES = KCH * HROW;          // W_q chunk, 512-byte rows
constexpr int WO_BYTES = HID * KCH * 4;       // W_out chunk, 128-byte rows
// kernel A's buffers beside weights and ring: ek and v tiles, the column
// reduction, running max and rescale
constexpr int A_FIXED = 2 * TM * HROW + 4 * HID * 4;

// byte offset of 16-byte chunk j of row r, rows of rb bytes: j ^ (r & 7)
__device__ __forceinline__ uint32_t swz(int r, int j, int rb) {
  return r * rb + ((j ^ (r & 7)) << 4);
}

// byte offset of float (r, col) in a tile whose 16-byte chunks sit at
// swz
__device__ __forceinline__ uint32_t el(int r, int col, int rb) {
  return swz(r, col >> 2, rb) + (col & 3) * 4;
}

// byte offset of float (r, col) in a tile read in (row t, column g)
// order: 32-byte group j of row r at j ^ (r & 3)
__device__ __forceinline__ uint32_t elt(int r, int col, int rb) {
  return r * rb + (((col >> 3) ^ (r & 3)) << 5) + (col & 7) * 4;
}

__device__ __forceinline__ uint32_t lds(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows r0 .. r0 + TM (zeros from r_lim) and channels c0 .. c0 + KCH (zeros
// from c) of x (rows of c) into dst
__device__ __forceinline__ void load_x(uint32_t dst, const float* x, int c,
                                       int r0, int r_lim, int c0, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < TM * 8; i += NTHREADS) {
      const int r = i >> 3, j = i & 7;
      const int ch = c0 + 4 * j;
      const bool in = r0 + r < r_lim && ch < c;
      cp16(dst + swz(r, j, KCH * 4),
           in ? x + static_cast<size_t>(r0 + r) * c + ch : x, in);
    }
  } else {
    for (int i = threadIdx.x; i < TM * KCH; i += NTHREADS) {
      const int r = i / KCH, e = i % KCH;
      const bool in = r0 + r < r_lim && c0 + e < c;
      cp4(dst + el(r, e, KCH * 4),
          in ? x + static_cast<size_t>(r0 + r) * c + c0 + e : x, in);
    }
  }
}

// rows k0 .. k0 + nk (zeros from k_lim) and columns col0 .. col0 + NCOLS
// (zeros from col_lim) of w (rows of ld) into dst, read in (row t, column
// g) order
template <int NCOLS>
__device__ __forceinline__ void load_w(uint32_t dst, const float* w, int ld,
                                       int k0, int nk, int k_lim, int col0,
                                       int col_lim, bool vec) {
  if (vec) {
    constexpr int CPR = NCOLS / 4;
    for (int i = threadIdx.x; i < nk * CPR; i += NTHREADS) {
      const int r = i / CPR, j = i % CPR;
      const int col = col0 + 4 * j;
      const bool in = k0 + r < k_lim && col < col_lim;
      cp16(dst + elt(r, 4 * j, NCOLS * 4),
           in ? w + static_cast<size_t>(k0 + r) * ld + col : w, in);
    }
  } else {
    for (int i = threadIdx.x; i < nk * NCOLS; i += NTHREADS) {
      const int r = i / NCOLS, e = i % NCOLS;
      const bool in = k0 + r < k_lim && col0 + e < col_lim;
      cp4(dst + elt(r, e, NCOLS * 4),
          in ? w + static_cast<size_t>(k0 + r) * ld + col0 + e : w, in);
    }
  }
}

// A fragment, split: rows row0 .. row0 + 16, k8 step kk of a row-major
// tile staged by swz
__device__ __forceinline__ void lda(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                    uint32_t base, int row0, int kk, int rb,
                                    int lane) {
  ldm_x4(hi, base + swz(row0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                        2 * kk + (lane >> 4), rb));
  split_frag(hi, lo);
}

// B fragment, split: k0 .. k0 + 8, n8 block n0, of a row-major k x n
// tile staged by elt
__device__ __forceinline__ void ldb(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                    const unsigned char* base, int k0,
                                    int n0, int rb, int lane) {
  const int t4 = lane & 3, col = n0 + (lane >> 2);
  hi[0] = lds(base + elt(k0 + t4, col, rb));
  hi[1] = lds(base + elt(k0 + t4 + 4, col, rb));
  split_frag(hi, lo);
}

// Kernel A over grid (splits, b): the (m, s, C) partials of split
// blockIdx.x of batch row blockIdx.y, as kv_partials_tc_body writes them.
__device__ __forceinline__ void kv_partials_tf32_body(
    const float* __restrict__ x, const float* __restrict__ wqkv,
    float* __restrict__ part, int n, int c, int rows_per_split, int splits,
    int resident, int stage_bytes, int vec) {
  extern __shared__ __align__(128) unsigned char tf_smem[];
  const int nch = (c + KCH - 1) / KCH;
  unsigned char* wres = tf_smem;
  unsigned char* ring = tf_smem + (resident ? nch * WKV_BYTES : 0);
  unsigned char* ek_s = ring + 2 * stage_bytes;  // TM x HID, exp(k - m)
  unsigned char* v_s = ek_s + TM * HROW;         // TM x HID, v
  float* red = reinterpret_cast<float*>(v_s + TM * HROW);  // [2][HID]
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
  const float* xb = x + static_cast<size_t>(bi) * n * c;
  const int L = (r_end - r_begin + TM - 1) / TM * nch;

  auto prefetch = [&](int i) {
    if (i < L) {
      const int ch = i % nch;
      unsigned char* st = ring + (i & 1) * stage_bytes;
      load_x(smem_u32(st), xb, c, r_begin + (i / nch) * TM, r_end, ch * KCH,
             vec);
      if (!resident)
        load_w<2 * HID>(smem_u32(st + X_BYTES), wqkv, QKV, ch * KCH, KCH, c,
                        HID, QKV, vec);
    }
    cp_commit();
  };
  if (resident)
    for (int ch = 0; ch < nch; ++ch)
      load_w<2 * HID>(smem_u32(wres + ch * WKV_BYTES), wqkv, QKV, ch * KCH,
                      KCH, c, HID, QKV, vec);  // committed with item 0
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
    const unsigned char* ws = resident ? wres + ch * WKV_BYTES : st + X_BYTES;
    float pc[2][8][4];  // this chunk's products
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pc[mi][j][e] = 0.f;
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
          acc[mi][j][e] = ch == 0 ? pc[mi][j][e] : acc[mi][j][e] + pc[mi][j][e];
    if (ch != nch - 1) continue;

    // the tile's epilogue: element e of acc[mi][j] is row
    // 32 wm + 16 mi + g + 8 (e >> 1), column 64 wn + 8 j + 2 t4 + (e & 1)
    const int rows = min(TM, r_end - (r_begin + (i / nch) * TM));
    if (wn < 2) {  // k: rows past the tile masked, column max
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = wm * 32 + mi * 16 + g + 8 * (e >> 1);
            if (r >= rows) acc[mi][j][e] = -INFINITY;
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
    } else {  // v into v_s (rows past the tile are zeros)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(
                v_s + elt(wm * 32 + mi * 16 + g + 8 * h,
                          (wn - 2) * 64 + j * 8 + 2 * t4, HROW)) =
                make_float2(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
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
    if (wn < 2) {  // exp(k - m) into ek_s; its column sums
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = wn * 64 + j * 8 + 2 * t4;
        const float m0 = m_s[col], m1 = m_s[col + 1];
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float p0 = expf(acc[mi][j][2 * h] - m0);
            const float p1 = expf(acc[mi][j][2 * h + 1] - m1);
            s0 += p0;
            s1 += p1;
            *reinterpret_cast<float2*>(
                ek_s + elt(wm * 32 + mi * 16 + g + 8 * h, col, HROW)) =
                make_float2(p0, p1);
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
    {  // C_h = alpha C_h + ek_h^T v_h, the tile's products summed apart
      const int d0 = hh * DH + mf * 16;
      float tcc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tcc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < TM / 8; ++kk) {
        // A = ek_h^T: (d, row) elements, row 8 kk + t4 (+ 4)
        const int r = kk * 8 + t4;
        uint32_t ah[4] = {lds(ek_s + elt(r, d0 + g, HROW)),
                          lds(ek_s + elt(r, d0 + g + 8, HROW)),
                          lds(ek_s + elt(r + 4, d0 + g, HROW)),
                          lds(ek_s + elt(r + 4, d0 + g + 8, HROW))};
        uint32_t al[4];
        split_frag(ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bh[2], bl[2];
          ldb(bh, bl, v_s, kk * 8, hh * DH + j * 8, HROW, lane);
          mma_3xtf32(tcc[j], ah, al, bh, bl);
        }
      }
      const float al0 = al_s[d0 + g], al1 = al_s[d0 + g + 8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          cacc[j][e] = fmaf(cacc[j][e], e < 2 ? al0 : al1, tcc[j][e]);
    }
  }
  cp_wait<0>();
  __syncthreads();

  float* pf = part + (static_cast<size_t>(bi) * splits + split) * PSTRIDE;
  if (tid < HID) {
    pf[tid] = m_s[tid];
    pf[HID + tid] = run_s;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(pf + 2 * HID + hh * DH * DH +
                                 (mf * 16 + g + 8 * h) * DH + j * 8 +
                                 2 * t4) =
          make_float2(cacc[j][2 * h], cacc[j][2 * h + 1]);
}

// Kernel C over a persistent grid: block blockIdx.x takes the
// ceil(tiles / gridDim.x) consecutive tiles from blockIdx.x times that of
// the b x ceil(n / TM) row tiles (batch row major), so that its batch row,
// and with it the C^ it stages, changes at most a few times. Work items per
// tile: its nch x chunks, then (weights streamed) its nch W_out chunks.
__device__ __forceinline__ void emit_out_tf32_body(
    const float* __restrict__ x, const float* __restrict__ wqkv,
    const float* __restrict__ wout, const float* __restrict__ bout,
    const float* __restrict__ gam, const float* __restrict__ chat,
    float* __restrict__ out, int b, int n, int c, float eps, int resident,
    int stage_bytes, int yglob, int vec) {
  extern __shared__ __align__(128) unsigned char tf_smem[];
  const int nch = (c + KCH - 1) / KCH;
  const int yrb = nch * KCH * 4;  // bytes of a y row
  unsigned char* wq_res = tf_smem;
  unsigned char* wo_res = tf_smem + nch * WQ_BYTES;
  unsigned char* ring = tf_smem + (resident ? nch * (WQ_BYTES + WO_BYTES) : 0);
  unsigned char* ch_s = ring + 2 * stage_bytes;  // C^ as DH x (head, e)
  unsigned char* core_s = ch_s + DH * HROW;      // TM x HID
  unsigned char* y_s = core_s + TM * HROW;       // TM x nch KCH, or none

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int qm = warp & 3, qh = warp >> 2;  // q: 16 rows x heads 2qh, 2qh+1
  const int ym = warp & 3, yn = warp >> 2;  // y: 16 rows x 16 channels
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
               k * KCH, vec);
        if (!resident)
          load_w<HID>(smem_u32(st + X_BYTES), wqkv, QKV, k * KCH, KCH, c, 0,
                      QKV, vec);
      } else {
        load_w<KCH>(smem_u32(st), wout, c, 0, HID, HID, (k - nch) * KCH, c,
                    vec);
      }
    }
    cp_commit();
  };
  if (resident && L > 0)
    for (int ch = 0; ch < nch; ++ch) {  // committed with item 0
      load_w<HID>(smem_u32(wq_res + ch * WQ_BYTES), wqkv, QKV, ch * KCH, KCH,
                  c, 0, QKV, vec);
      load_w<KCH>(smem_u32(wo_res + ch * WO_BYTES), wout, c, 0, HID, HID,
                  ch * KCH, c, vec);
    }
  prefetch(0);

  // y = core W_out + b_out for output channels 32 kc .., into y_s, or
  // (yglob: the tile of y does not fit) into out's rows
  auto out_chunk = [&](int kc, const unsigned char* wsm, int bi, int r0) {
    float y[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HID / 8; ++kk) {
      uint32_t ah[4], al[4];
      lda(ah, al, smem_u32(core_s), ym * 16, kk, HROW, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t bh[2], bl[2];
        ldb(bh, bl, wsm, kk * 8, yn * 16 + j * 8, KCH * 4, lane);
        mma_3xtf32(y[j], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = kc * KCH + yn * 16 + j * 8 + 2 * t4;
      if (col >= c) continue;
      const bool two = col + 1 < c;
      const float b0 = bout[col], b1 = two ? bout[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ym * 16 + g + 8 * h;
        const float2 v = make_float2(y[j][2 * h] + b0, y[j][2 * h + 1] + b1);
        if (!yglob) {
          *reinterpret_cast<float2*>(y_s + el(r, col, yrb)) = v;
        } else if (r0 + r < n) {
          float* o = out + (static_cast<size_t>(bi) * n + r0 + r) * c + col;
          if (vec) {
            *reinterpret_cast<float2*>(o) = v;
          } else {
            o[0] = v.x;
            if (two) o[1] = v.y;
          }
        }
      }
    }
  };

  // LayerNorm over c of the tile's rows of y, two passes: a group of lpr
  // lanes per row (8 where c <= 128, so that no lane idles), 4 channels
  // (16 bytes) per lane and step where c % 4 == 0, else one
  auto layer_norm = [&](int bi, int r0) {
    const int cw = vec ? c >> 2 : c;  // steps of a row
    const int lpr = cw > 16 ? 32 : cw > 8 ? 16 : 8;
    const int rpw = 32 / lpr;  // rows of a warp at once
    auto group_sum = [&](float v) {
      for (int o = lpr >> 1; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      return v;
    };
    // step j of row r: 4 channels (vec) or one, zeros past 4 of them
    auto yld = [&](int r, int j) {
      if (vec) {
        if (yglob)
          return __ldcg(reinterpret_cast<const float4*>(
              out + (static_cast<size_t>(bi) * n + r0 + r) * c + 4 * j));
        return *reinterpret_cast<const float4*>(y_s + swz(r, j, yrb));
      }
      const float v =
          yglob ? __ldcg(out + (static_cast<size_t>(bi) * n + r0 + r) * c + j)
                : *reinterpret_cast<const float*>(y_s + el(r, j, yrb));
      return make_float4(v, 0.f, 0.f, 0.f);
    };
    // every lane runs every step (the shuffles need the whole warp):
    // TM is a multiple of 8 rpw
    for (int r = warp * rpw + lane / lpr; r < TM; r += 8 * rpw) {
      // yglob holds only the rows of out; it needs c > 512, where a row
      // is a whole warp's
      if (yglob && r0 + r >= n) continue;
      const int sl = lane % lpr;
      float s = 0.f;
      for (int j = sl; j < cw; j += lpr) {
        const float4 u = yld(r, j);
        s += (u.x + u.y) + (u.z + u.w);
      }
      const float mean = group_sum(s) / c;
      float var = 0.f;
      for (int j = sl; j < cw; j += lpr) {
        const float4 u = yld(r, j);
        var = fmaf(u.x - mean, u.x - mean, var);
        if (vec) {
          var = fmaf(u.y - mean, u.y - mean, var);
          var = fmaf(u.z - mean, u.z - mean, var);
          var = fmaf(u.w - mean, u.w - mean, var);
        }
      }
      const float inv = rsqrtf(group_sum(var) / c + eps);
      if (r0 + r >= n) continue;
      float* orow = out + (static_cast<size_t>(bi) * n + r0 + r) * c;
      for (int j = sl; j < cw; j += lpr) {
        const float4 u = yld(r, j);
        if (vec) {
          const float4 gv = *reinterpret_cast<const float4*>(gam + 4 * j);
          *reinterpret_cast<float4*>(orow + 4 * j) = make_float4(
              (u.x - mean) * inv * gv.x, (u.y - mean) * inv * gv.y,
              (u.z - mean) * inv * gv.z, (u.w - mean) * inv * gv.w);
        } else {
          orow[j] = (u.x - mean) * inv * gam[j];
        }
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
      out_chunk(k - nch, st, bi, r0);
      if (k == P - 1) {
        __syncthreads();
        layer_norm(bi, r0);
      }
      continue;
    }

    // q += x W_q over this chunk's channels, summed apart
    float pc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pc[j][e] = 0.f;
    const uint32_t xs = smem_u32(st);
    const unsigned char* ws = resident ? wq_res + k * WQ_BYTES : st + X_BYTES;
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

    if (bi != cur_b) {  // C^ of batch row bi
      const float* chb = chat + static_cast<size_t>(bi) * CBLK;
      for (int idx = tid; idx < CBLK; idx += NTHREADS) {
        const int hd = idx / (DH * DH), d = (idx / DH) % DH, e = idx % DH;
        *reinterpret_cast<float*>(ch_s + el(d, hd * DH + e, HROW)) = chb[idx];
      }
      __syncthreads();
      cur_b = bi;
    }

    // element e of acc[j] is row 16 qm + g + 8 (e >> 1), column 8 j + 2 t4
    // + (e & 1) of heads 2 qh (j < 4) and 2 qh + 1 (j >= 4): the softmax
    // over each head's 32 columns
    float hmax[2][2], hinv[2][2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int jb0 = 4 * hh, jb1 = jb0 + 4;  // this head's fragments
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = jb0; j < jb1; ++j)
          mx = fmaxf(mx, fmaxf(acc[j][2 * r], acc[j][2 * r + 1]));
        hmax[hh][r] = quad_max(mx);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = expf(acc[j][e] - hmax[j >> 2][e >> 1]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int jb0 = 4 * hh, jb1 = jb0 + 4;  // this head's fragments
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sm = 0.f;
#pragma unroll
        for (int j = jb0; j < jb1; ++j)
          sm += acc[j][2 * r] + acc[j][2 * r + 1];
        hinv[hh][r] = 1.f / quad_sum(sm);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= hinv[j >> 2][e >> 1];

    // core = softmax(q)_h C^_h per head: k8 step kd takes d = 8 kd + (0, 2,
    // 4, 6, 1, 3, 5, 7), so the softmax fragment is the A operand as it
    // lies; C^'s rows are read in that order
    float cacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cacc[j][e] = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int kd = 0; kd < 4; ++kd) {
        const int j0 = 4 * hh + kd;
        uint32_t ah[4] = {__float_as_uint(acc[j0][0]),
                          __float_as_uint(acc[j0][2]),
                          __float_as_uint(acc[j0][1]),
                          __float_as_uint(acc[j0][3])};
        uint32_t al[4];
        split_frag(ah, al);
        // A's k index t is d = 2t of the step and t + 4 is d = 2t + 1
        const int d0 = kd * 8 + 2 * t4, d1 = d0 + 1;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int col = (2 * qh + hh) * DH + jj * 8 + g;
          uint32_t bh[2] = {lds(ch_s + el(d0, col, HROW)),
                            lds(ch_s + el(d1, col, HROW))};
          uint32_t bl[2];
          split_frag(bh, bl);
          mma_3xtf32(cacc[4 * hh + jj], ah, al, bh, bl);
        }
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            core_s + el(qm * 16 + g + 8 * h, qh * 64 + j * 8 + 2 * t4,
                        HROW)) = make_float2(cacc[j][2 * h],
                                             cacc[j][2 * h + 1]);
    __syncthreads();
    if (resident) {
      for (int kc = 0; kc < nch; ++kc)
        out_chunk(kc, wo_res + kc * WO_BYTES, bi, r0);
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
  const size_t fixed = DH * HROW + TM * HROW +
                       (yglob ? 0 : static_cast<size_t>(TM) * nch * KCH * 4);
  return resident ? static_cast<size_t>(nch) * (WQ_BYTES + WO_BYTES) +
                        2 * X_BYTES + fixed
                  : 2 * (X_BYTES + WQ_BYTES) + fixed;
}

}  // namespace tf32x3
}  // namespace la
}  // namespace prgpt
