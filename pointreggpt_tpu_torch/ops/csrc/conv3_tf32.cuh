// K5's fp32 body (conv3x3.cu): a 3x3 stride-1 SAME conv, NHWC fp32 in,
// fp32 out, as an implicit GEMM on the TF32 tensor cores in three passes,
// written for Hopper (sm_90a).
//
//   out (pixels x cout) = A (pixels x 9 cin) @ B (9 cin x cout)
//   A[(y, x), (tap, i)] = x[y + dy - 1, x + dx - 1, i], tap = 3 dy + dx
//
// Each product is a b ~= a_lo b_hi + a_hi b_lo + a_hi b_hi with x = hi +
// lo, hi = tf32(x) and lo = x - hi, which the tensor cores read to TF32
// (common.cuh's split_frag): about 21 bits of each product where
// one TF32 pass keeps 10; mma.sync.m16n8k8.tf32 with fp32 accumulators.
//
// The tile walk, the ring, the resident weights and the launch are
// conv3_tc.cuh's kernel and launch (K5 bf16 and K6), templates over a
// body; this file is the body, the staging and the fragments:
// - Tiles. TR (16) output rows x TC (16) columns x BN (64) output
//   channels, on a persistent grid (ops/conv.py::conv_tiles mirrors the
//   walk). 8 warps, 4 along the rows x 2 along the channels; a warp owns
//   RW (4) whole image rows of 16 pixels (four A fragments) x 32 channels.
// - Chunks. cin in chunks of KCH (32) channels: a window position's 32
//   floats are one 128-byte row, the row the bf16 body's 64 channels
//   fill, swizzled alike (16-byte chunk j of row r at j ^ (r & 7)). The
//   last chunk is zero-filled past cin.
// - Weights. The wrapper repacks w once per call as wt = (cout, 3, 3,
//   cin), so that B^T's rows (one output channel, k contiguous) are rows
//   of a staged tile: a chunk is [tap][64 n][32 k], 128-byte rows under
//   the same swizzle, 73,728 bytes, the bf16 chunk's size. Both operands
//   then come by plain ldmatrix: a non-transposed 8x8 b16 matrix is an 8x4
//   matrix of 32-bit elements, one per lane in the order the tf32 A and B
//   fragments want (ldmatrix.trans cannot transpose 32-bit elements, and
//   32-bit loads of an HWIO tile would take four instructions where one
//   ldmatrix.x4 gives two n8 blocks' B fragments). cin <= 64 keeps all 9
//   cin x 64 weights of an n tile resident beside two window stages
//   (147,456 + 2 x 41,472 bytes; pre-split hi and lo would be twice that
//   and do not fit); above, each of two ring stages carries its chunk's
//   weights with the window (2 x 115,200 bytes).
// - Compute. Per tap column dx and k8 step, the B fragments of the three
//   taps (0..2, dx) (six ldmatrix.x4, split), then each of the RW + 2
//   window rows the warp's rows touch: one A fragment (ldmatrix.x4, split
//   once) feeds image row wr - dy at tap dy, up to three taps. The
//   tensor cores truncate the sum each mma accumulates, so a long sum in
//   one fragment drifts (linear_attention_tf32.cuh): each k8 step's
//   products of a tap column (3 taps x 3 passes = 9 mma) go into
//   fragments of their own, added to the running sums in fp32. A tap
//   column's four k8 steps (36 mma) a fragment left the forward 6.9e-7
//   from fp64 where this gives 2-3e-7, for 7-10% more time; on the
//   MaskUNet route the larger drift moved the MaskTrainer's third step
//   3x further from the benchmark's fp32 reference (PERF.md).
// - Epilogue. The bias added where one is given (the route of
//   ops/conv.py::conv2d), fp32 stored as 8-byte pairs (one float where
//   cout or alignment forbid), masked at the ragged edges of h, w and
//   cout.
// Channel counts that are no multiple of 4, or unaligned tensors, take
// 4-byte staging (VEC = false), with the same ring, layout and compute.
#pragma once

#include "conv3_tc.cuh"

namespace prgpt {
namespace conv3 {
namespace tf32 {

// byte offset of 16-byte chunk j of 128-byte row r: j ^ (r & 7)
__device__ __forceinline__ uint32_t row_chunk(int r, int j) {
  return r * 128 + ((j ^ (r & 7)) << 4);
}

struct Body {
  using E = float;
  static constexpr int TC = 16;      // output columns per tile
  static constexpr int TR = 16;      // output rows per tile
  static constexpr int RW = 4;       // image rows per warp
  static constexpr int KCH = 32;     // input channels per chunk
  static constexpr int WC = TC + 2;  // window columns
  static constexpr int WIN_BYTES = (TR + 2) * WC * ROW_BYTES;  // 41,472
  static_assert(4 * RW == TR && TC * RW == WARP_PX,
                "one 16-pixel A fragment a row");

  // The (TR + 2) x (TC + 2) halo window of channels c0 .. c0 + 32 of one
  // tile into `win` ([position][32 floats], swizzled); zeros outside the
  // image and past cin.
  template <bool VEC>
  static __device__ __forceinline__ void load_window(uint32_t win,
                                                     const float* x,
                                                     const Geo& g,
                                                     const Tile& tl,
                                                     int c0) {
    constexpr int NPOS = (TR + 2) * WC;
    if (VEC) {
      for (int i = threadIdx.x; i < NPOS * 8; i += THREADS) {
        const int j = i & 7, pos = i >> 3;
        bool in;
        const float* src = window_src<TC>(x, g, tl, pos, c0 + 4 * j, in);
        cp16(win + row_chunk(pos, j), src, in);
      }
    } else {
      for (int i = threadIdx.x; i < NPOS * KCH; i += THREADS) {
        const int k = i & (KCH - 1), pos = i >> 5;
        bool in;
        const float* src = window_src<TC>(x, g, tl, pos, c0 + k, in);
        cp4(win + row_chunk(pos, k >> 2) + (k & 3) * 4, src, in);
      }
    }
  }

  // The weights of input channels c0 .. c0 + 32 and output channels n0 ..
  // n0 + BN from wt (cout, 9, cin) into `dst` ([tap][n][32 k], row (tap,
  // n) swizzled by n & 7); zeros past cin and cout.
  template <bool VEC>
  static __device__ __forceinline__ void load_weights(uint32_t dst,
                                                      const float* wt,
                                                      const Geo& g, int n0,
                                                      int c0) {
    if (VEC) {
      for (int i = threadIdx.x; i < 9 * BN * 8; i += THREADS) {
        const int j = i & 7, row = i >> 3;  // row = tap * BN + n
        const int n = n0 + (row & (BN - 1)), ci = c0 + 4 * j;
        const bool in = n < g.cout && ci < g.cin;
        const float* src =
            in ? wt + (static_cast<size_t>(n) * 9 + row / BN) * g.cin + ci
               : wt;
        cp16(dst + row_chunk(row, j), src, in);
      }
    } else {
      for (int i = threadIdx.x; i < 9 * BN * KCH; i += THREADS) {
        const int k = i & (KCH - 1), row = i >> 5;
        const int n = n0 + (row & (BN - 1)), ci = c0 + k;
        const bool in = n < g.cout && ci < g.cin;
        const float* src =
            in ? wt + (static_cast<size_t>(n) * 9 + row / BN) * g.cin + ci
               : wt;
        cp4(dst + row_chunk(row, k >> 2) + (k & 3) * 4, src, in);
      }
    }
  }

  // apos: window position of this lane's A row, the warp's first image
  // row, column lane & 15 (window row wr and tap column dx add wr * WC +
  // dx); brow: B^T row of this lane within a tap's 64 (n8 blocks 2 jj,
  // 2 jj + 1 of the warp's 32 channels add 16 jj)
  struct Lanes {
    int apos, brow;
  };
  static __device__ __forceinline__ Lanes lanes(int lane, int warp_m,
                                                int warp_n) {
    return {warp_m * RW * WC + (lane & 15),
            warp_n * 32 + (lane & 7) + ((lane >> 4) << 3)};
  }

  // Chunk c's products (window at xs, weights at wsm) into acc; acc[r][n]
  // is image row r of the warp (16 pixels) x n8 block n.
  static __device__ __forceinline__ void compute(Acc& acc, uint32_t xs,
                                                 uint32_t wsm, int c,
                                                 int lane, int warp_n,
                                                 const Lanes& ln) {
    const int apos = ln.apos, brow = ln.brow;
#pragma unroll 1
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int kk = 0; kk < KCH / 8; ++kk) {
        // this k8 step's products of the tap column, summed apart
        float t[RW][NJ][4];
#pragma unroll
        for (int r = 0; r < RW; ++r)
#pragma unroll
          for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) t[r][n][e] = 0.f;
        // the B fragments of the three taps (0, dx), (1, dx), (2, dx):
        // matrices (n 0-7, k 0-3), (n 0-7, k 4-7), (n 8-15, k 0-3), (n
        // 8-15, k 4-7) of a 16-channel pair of n8 blocks
        uint32_t bh[3][NJ][2], bl[3][NJ][2];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int jj = 0; jj < NJ / 2; ++jj) {
            const int row = (dy * 3 + dx) * BN + brow + 16 * jj;
            uint32_t r[4];
            ldm_x4(r, wsm + row_chunk(row, 2 * kk + ((lane >> 3) & 1)));
            bh[dy][2 * jj][0] = r[0];
            bh[dy][2 * jj][1] = r[1];
            bh[dy][2 * jj + 1][0] = r[2];
            bh[dy][2 * jj + 1][1] = r[3];
          }
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int n = 0; n < NJ; ++n)
            split_frag(bh[dy][n], bl[dy][n]);
        // window row wr feeds the warp's image row wr - dy at tap dy: each
        // A fragment is loaded and split once for up to three taps
#pragma unroll
        for (int wr = 0; wr < RW + 2; ++wr) {
          const int wpos = apos + wr * WC + dx;
          uint32_t ah[4], al[4];
          ldm_x4(ah, xs + row_chunk(wpos, 2 * kk + (lane >> 4)));
          split_frag(ah, al);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int r = wr - dy;
            if (0 <= r && r < RW) {
#pragma unroll
              for (int n = 0; n < NJ; ++n)
                mma_3xtf32(t[r][n], ah, al, bh[dy][n], bl[dy][n]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RW; ++r)
#pragma unroll
          for (int n = 0; n < NJ; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][n][e] += t[r][n][e];
      }
    }
  }

  // The finished tile, stored. Element e of acc[r][n] is pixel (lane >> 2)
  // + 8 (e >> 1) of row r, channel 8 n + 2 (lane & 3) + (e & 1) of the
  // warp's 32.
  template <bool VEC>
  static __device__ __forceinline__ void store(const Acc& acc, float* out,
                                               const Geo& g, const Tile& tl,
                                               int lane, int warp_m,
                                               int warp_n) {
    const int nw = tl.n0 + warp_n * 8 * NJ + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int y = tl.y0 + warp_m * RW + r;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int xg = tl.x0 + (lane >> 2) + 8 * hh;
        if (warp_m * RW + r >= g.rows || y >= g.h || xg >= g.wd) continue;
        float* orow =
            out + ((static_cast<size_t>(tl.img) * g.h + y) * g.wd + xg) *
                      g.cout;
#pragma unroll
        for (int n = 0; n < NJ; ++n) {
          const int ch = nw + 8 * n;
          float v0 = acc[r][n][2 * hh], v1 = acc[r][n][2 * hh + 1];
          if (g.bias != nullptr) {
            if (ch < g.cout) v0 += g.bias[ch];
            if (ch + 1 < g.cout) v1 += g.bias[ch + 1];
          }
          if (VEC) {
            if (ch < g.cout)
              *reinterpret_cast<float2*>(orow + ch) = make_float2(v0, v1);
          } else {
            if (ch < g.cout) orow[ch] = v0;
            if (ch + 1 < g.cout) orow[ch + 1] = v1;
          }
        }
      }
    }
  }
};

// Launch over (b, h, wd, cin, cout), wt = w repacked as (cout, 3, 3, cin);
// `bias` (cout), when not null, is added to the sums before the store.
inline cudaError_t launch(const float* x, const float* wt, float* out, int b,
                          int h, int wd, int cin, int cout, int sms,
                          cudaStream_t stream, const float* bias = nullptr) {
  return launch_body<Body>(x, wt, out, b, h, wd, cin, cout, Body::TR, sms,
                           stream, bias);
}

}  // namespace tf32
}  // namespace conv3
}  // namespace prgpt
