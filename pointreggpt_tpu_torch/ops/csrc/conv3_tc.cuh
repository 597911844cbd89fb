// The body shared by K5's bf16 path (conv3x3.cu) and K6 (conv3_igemm.cu):
// a 3x3 stride-1 SAME conv, NHWC x HWIO, bf16 in, fp32 sums, rounded once,
// as an implicit GEMM on the tensor cores, written for Hopper (sm_90a).
//
//   out (pixels x cout) = A (pixels x 9 cin) @ B (9 cin x cout)
//   A[(y, x), (tap, i)] = x[y + dy - 1, x + dx - 1, i], tap = 3 dy + dx
//   B = w.reshape(9 cin, cout)        (tap-major, then cin)
//
// A is never written to device memory: it is read from a halo window of x
// in shared memory, the tap (dy, dx) only an offset into the window.
//
// - Tiles. A tile is `rows` output rows x TC columns of one image and
//   BN (64) output channels; the block's 8 warps cover 4 x RW (RW = 64 /
//   TC) rows of it, so rows <= 4 RW. The tiles are numbered column
//   fastest, then row, then image, then n tile (ops/conv.py::conv_tiles
//   mirrors this). A grid of about one block per SM walks them
//   persistently: block g takes tiles g, g + G, g + 2G, ..., so the blocks
//   in flight hold neighbouring tiles, whose shared halo rows come from L2,
//   and a block's n tile (and so its weights) changes at most n_tiles - 1
//   times.
// - Work items. cin is cut into chunks of KCH (64) channels, 128 bytes per
//   window position, the last one zero-filled past cin (a cin below 64
//   costs the products of a whole chunk). A block's work items are its
//   (tile, chunk) pairs in order; the fp32 accumulators live in registers
//   across a tile's chunks.
// - Weights. Where all 9 x cin x BN weights of an n tile fit beside the
//   ring, a block loads them once per n tile and keeps them (resident);
//   otherwise each ring stage carries its chunk's 9 x 64 x BN weights with
//   the window (streamed, read from L2 again for every tile).
// - Ring. 2 or 3 stages, filled with cp.async.cg 16-byte copies (the
//   zero-fill form, source size 0, for positions outside the image and
//   channels past cin), one commit group per work item: item i + S - 1
//   loads while item i computes. Channel counts that are no multiple of 8
//   (or unaligned tensors) take element-wise staging (VEC = false), with
//   the same ring, layout and compute.
// - Swizzle. Window and weight rows are 128 bytes, eight 16-byte chunks;
//   chunk j of row r is stored at j ^ (r & 7). The 8 rows of one ldmatrix
//   (8 neighbouring pixels, or 8 consecutive k) then hit 8 different bank
//   groups.
// - Compute. 8 warps, 4 along the rows x 2 along the channels; a warp
//   owns RW whole image rows of the tile (64 pixels, four 16-pixel A
//   fragments) x 32 channels. For each tap column dx and 16-deep k step it
//   loads the B fragments of the three taps (0..2, dx) with six
//   ldmatrix.x4.trans, then walks the RW + 2 window rows its rows touch:
//   each A fragment (ldmatrix.x4, each lane giving the address of its own
//   pixel's 16-byte row) feeds image row wr - dy at tap dy, so it is
//   loaded once for up to three taps; 48 mma.sync.m16n8k16 (bf16, fp32
//   accumulators) per 6 + (RW + 2) TC / 16 ldmatrix. The k steps have no
//   guard, so the compiler can interleave one step's ldmatrix with the
//   last one's mma.
// - Epilogue. The accumulators are rounded to bf16 once; a transpose
//   within each quad of lanes gives every lane 8 consecutive channels,
//   stored as one 16-byte vector (element-wise where cout % 8 != 0),
//   masked at the ragged edges of h, w, the tile's rows and cout.
//
// The tile walk, the ring, the resident weights and the launch's choice
// of stages are one kernel and one launch, templates over a body: Bf16
// here, K5's fp32 body in conv3_tf32.cuh. A body gives the element type
// E, the tile's columns TC, the channels of a chunk KCH, the window's
// bytes, the staging of a chunk's window and weights (load_window,
// load_weights), each lane's fixed offsets (lanes), the products of one
// staged chunk (compute) and the epilogue (store). The kernel holds a
// warp's 4 x NJ accumulator fragments across a tile's chunks.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace prgpt {
namespace conv3 {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // 8 warps: 4 along the pixels x 2
constexpr int NJ = 4;         // n8 fragments per warp: 32 channels
constexpr int BN = 64;        // output channels per tile
constexpr int KCH = 64;       // bf16 input channels per chunk
constexpr int WARP_PX = 64;   // pixels per warp: 4 A fragments
constexpr int ROW_BYTES = 128;  // a window position's chunk, a weight row
constexpr int CHUNK_W_BYTES = 9 * BN * ROW_BYTES;  // 73,728

struct Geo {
  int b, h, wd, cin, cout, rows;
  int col_tiles, row_tiles, n_tiles, spatial, tiles, nch;
  const float* bias;  // the fp32 body's optional bias (cout); else null
};

struct Tile {
  int img, y0, x0, n0;
};

// a warp's accumulators: 4 A fragments (16 pixels each) x NJ n8 blocks
using Acc = float[4][NJ][4];

__device__ __forceinline__ uint32_t pick4(const uint32_t (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

template <int TC>
__device__ __forceinline__ Tile decode(int t, const Geo& g) {
  const int n = t / g.spatial;
  int s = t - n * g.spatial;
  const int per_img = g.row_tiles * g.col_tiles;
  const int img = s / per_img;
  s -= img * per_img;
  const int r = s / g.col_tiles;
  return {img, r * g.rows, (s - r * g.col_tiles) * TC, n * BN};
}

// Where window position `pos`, channel `ch` of tile `tl` comes from, and
// whether it lies inside the image and below cin (else it is zero); E is
// the element type.
template <int TC, typename E>
__device__ __forceinline__ const E* window_src(const E* x, const Geo& g,
                                               const Tile& tl, int pos,
                                               int ch, bool& in) {
  constexpr int WC = TC + 2;
  const int wr = pos / WC;
  const int gy = tl.y0 - 1 + wr;
  const int gx = tl.x0 - 1 + (pos - wr * WC);
  in = gy >= 0 && gy < g.h && gx >= 0 && gx < g.wd && ch < g.cin;
  return in ? x + ((static_cast<size_t>(tl.img) * g.h + gy) * g.wd + gx) *
                      g.cin + ch
            : x;
}

// The bf16 body (K5 bf16, K6): 64-channel chunks, mma.sync.m16n8k16.
template <int TC_>
struct Bf16 {
  using E = bf16;
  static constexpr int TC = TC_;
  static constexpr int KCH = conv3::KCH;
  static constexpr int RW = WARP_PX / TC;  // image rows per warp
  static constexpr int CJ = TC / 16;       // 16-pixel A fragments a row
  static constexpr int WC = TC + 2;
  static constexpr int WIN_BYTES = (4 * RW + 2) * WC * ROW_BYTES;
  static_assert(TC % 16 == 0 && WARP_PX % TC == 0, "tile columns");

  // The (rows + 2) x (TC + 2) halo window of channels c0 .. c0 + 64 of
  // one tile into the stage at `dst` ([position][64 channels],
  // swizzled); zeros outside the image and past cin.
  template <bool VEC>
  static __device__ __forceinline__ void load_window(uint32_t dst,
                                                     const bf16* x,
                                                     const Geo& g,
                                                     const Tile& tl,
                                                     int c0) {
    const int npos = (g.rows + 2) * WC;
    if (VEC) {
      for (int i = threadIdx.x; i < npos * 8; i += THREADS) {
        const int j = i & 7;
        const int pos = i >> 3;
        bool in;
        const bf16* src = window_src<TC>(x, g, tl, pos, c0 + 8 * j, in);
        cp16(dst + pos * ROW_BYTES + ((j ^ (pos & 7)) << 4), src, in);
      }
    } else {
      for (int i = threadIdx.x; i < npos * KCH; i += THREADS) {
        const int k = i & (KCH - 1);
        const int pos = i >> 6;
        bool in;
        const bf16* src = window_src<TC>(x, g, tl, pos, c0 + k, in);
        const uint32_t a = dst + pos * ROW_BYTES +
                           (((k >> 3) ^ (pos & 7)) << 4) + (k & 7) * 2;
        const bf16 v = in ? *src : __float2bfloat16_rn(0.f);
        asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(a),
                     "h"(*reinterpret_cast<const unsigned short*>(&v))
                     : "memory");
      }
    }
  }

  // Weights of input channels c0 .. c0 + 64 and output channels n0 .. n0
  // + BN into `dst` ([tap][64 k][BN], row (tap, k) swizzled by k & 7);
  // zeros past cin and cout.
  template <bool VEC>
  static __device__ __forceinline__ void load_weights(uint32_t dst,
                                                      const bf16* w,
                                                      const Geo& g, int n0,
                                                      int c0) {
    if (VEC) {
      for (int i = threadIdx.x; i < 9 * KCH * (BN / 8); i += THREADS) {
        const int jn = i & 7;
        const int row = i >> 3;
        const int k = row & (KCH - 1);
        const int ci = c0 + k, n = n0 + 8 * jn;
        const bool in = ci < g.cin && n < g.cout;
        const bf16* src =
            in ? w + (static_cast<size_t>(row >> 6) * g.cin + ci) * g.cout +
                     n
               : w;
        cp16(dst + row * ROW_BYTES + ((jn ^ (k & 7)) << 4), src, in);
      }
    } else {
      for (int i = threadIdx.x; i < 9 * KCH * BN; i += THREADS) {
        const int nn = i & (BN - 1);
        const int row = i >> 6;
        const int k = row & (KCH - 1);
        const int ci = c0 + k, n = n0 + nn;
        const bf16 v =
            ci < g.cin && n < g.cout
                ? w[(static_cast<size_t>(row >> 6) * g.cin + ci) * g.cout +
                    n]
                : __float2bfloat16_rn(0.f);
        const uint32_t a = dst + row * ROW_BYTES +
                           (((nn >> 3) ^ (k & 7)) << 4) + (nn & 7) * 2;
        asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(a),
                     "h"(*reinterpret_cast<const unsigned short*>(&v))
                     : "memory");
      }
    }
  }

  // Window position of this lane's A row: the warp's first image row,
  // column lane & 15 (window row wr, fragment column j and tap column dx
  // add wr * WC + 16 j + dx).
  struct Lanes {
    int lpos;
  };
  static __device__ __forceinline__ Lanes lanes(int lane, int warp_m,
                                                int warp_n) {
    return {warp_m * RW * WC + (lane & 15)};
  }

  // Chunk c's products (window at xsm, weights at wsm) into acc; acc[i *
  // CJ + j] is image row i of the warp, pixels 16 j .. 16 j + 15.
  static __device__ __forceinline__ void compute(Acc& acc, uint32_t xsm,
                                                 uint32_t wsm, int c,
                                                 int lane, int warp_n,
                                                 const Lanes& ln) {
    const int lpos = ln.lpos;
    // B rows (tap, k) with k = 16 kk + (lane & 7) + 8 ((lane >> 3) & 1)
    const uint32_t bl = wsm + ((lane & 7) + ((lane >> 3) & 1) * 8) * ROW_BYTES;

#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int kk = 0; kk < KCH / 16; ++kk) {
        // the B fragments of the three taps (0, dx), (1, dx), (2, dx)
        uint32_t bfr[3][NJ][2];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int jj = 0; jj < NJ / 2; ++jj) {
            const int nchunk = warp_n * NJ + jj * 2 + (lane >> 4);
            uint32_t r[4];
            ldm_x4_trans(r, bl + ((dy * 3 + dx) * KCH + kk * 16) * ROW_BYTES +
                                ((nchunk ^ (lane & 7)) << 4));
            bfr[dy][2 * jj][0] = r[0];
            bfr[dy][2 * jj][1] = r[1];
            bfr[dy][2 * jj + 1][0] = r[2];
            bfr[dy][2 * jj + 1][1] = r[3];
          }
        // the A fragments of the RW + 2 window rows the warp's rows touch,
        // all in flight before the first mma
        uint32_t a[CJ][RW + 2][4];
#pragma unroll
        for (int j = 0; j < CJ; ++j)
#pragma unroll
          for (int wr = 0; wr < RW + 2; ++wr) {
            const int pos = lpos + wr * WC + 16 * j + dx;
            ldm_x4(a[j][wr], xsm + pos * ROW_BYTES +
                                 (((2 * kk) ^ (lane >> 4) ^ (pos & 7)) << 4));
          }
        // window row wr of the warp feeds its image row wr - dy at tap dy:
        // each A fragment is loaded once for up to three taps
#pragma unroll
        for (int j = 0; j < CJ; ++j)
#pragma unroll
          for (int wr = 0; wr < RW + 2; ++wr)
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
              const int r = wr - dy;
              if (r >= 0 && r < RW) {
#pragma unroll
                for (int n = 0; n < NJ; ++n)
                  mma16816(acc[r * CJ + j][n], a[j][wr], bfr[dy][n][0],
                           bfr[dy][n][1]);
              }
            }
      }
    }
  }

  // The finished tile: round once, store.
  template <bool VEC>
  static __device__ __forceinline__ void store(const Acc& acc, bf16* out,
                                               const Geo& g, const Tile& tl,
                                               int lane, int warp_m,
                                               int warp_n) {
    const int t = lane & 3;
    const int nw = tl.n0 + warp_n * 8 * NJ;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = warp_m * RW + f / CJ;
        const int y = tl.y0 + r;
        const int xg = tl.x0 + 16 * (f % CJ) + (lane >> 2) + 8 * hh;
        const bool valid = r < g.rows && y < g.h && xg < g.wd;
        bf16* orow =
            out + ((static_cast<size_t>(tl.img) * g.h + y) * g.wd + xg) *
                      g.cout;
        if (VEC) {
          uint32_t wv[4], o[4];
#pragma unroll
          for (int n = 0; n < 4; ++n)
            wv[n] = pack_bf16x2(acc[f][n][2 * hh], acc[f][n][2 * hh + 1]);
          // a 4 x 4 transpose of words within the quad: lane t gets
          // fragment t's 8 channels
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const int src = (t - rr) & 3;
            const uint32_t got = __shfl_sync(
                0xffffffffu, pick4(wv, (t + rr) & 3), (lane & ~3) | src);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (q == src) o[q] = got;
          }
          const int n = nw + t * 8;
          if (valid && n < g.cout)
            *reinterpret_cast<uint4*>(orow + n) =
                make_uint4(o[0], o[1], o[2], o[3]);
        } else if (valid) {
#pragma unroll
          for (int n8 = 0; n8 < NJ; ++n8)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = nw + n8 * 8 + 2 * t + e;
              if (n < g.cout)
                orow[n] = __float2bfloat16_rn(acc[f][n8][2 * hh + e]);
            }
        }
      }
    }
  }
};

template <class B, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
conv3_kernel(const typename B::E* __restrict__ x,
             const typename B::E* __restrict__ w,
             typename B::E* __restrict__ out, Geo g, int resident,
             int stages, int stage_bytes) {
  constexpr int TC = B::TC;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t wres = smem_u32(smem);
  const uint32_t ring = wres + (resident ? g.nch * CHUNK_W_BYTES : 0);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int G = gridDim.x;
  const int my_tiles = g.tiles > static_cast<int>(blockIdx.x)
                           ? (g.tiles - 1 - blockIdx.x) / G + 1
                           : 0;
  const int L = my_tiles * g.nch;
  const typename B::Lanes ln = B::lanes(lane, warp_m, warp_n);

  auto prefetch = [&](int i) {
    if (i < L) {
      const Tile tl = decode<TC>(blockIdx.x + (i / g.nch) * G, g);
      const int c0 = (i % g.nch) * B::KCH;
      const uint32_t st = ring + (i % stages) * stage_bytes;
      B::template load_window<VEC>(st, x, g, tl, c0);
      if (!resident)
        B::template load_weights<VEC>(st + B::WIN_BYTES, w, g, tl.n0, c0);
    }
    cp_commit();
  };
  auto load_resident = [&](int n0) {
    for (int c = 0; c < g.nch; ++c)
      B::template load_weights<VEC>(wres + c * CHUNK_W_BYTES, w, g, n0,
                                    c * B::KCH);
  };

  int cur_n = -1;
  if (resident && L > 0) {
    cur_n = decode<TC>(blockIdx.x, g).n0;
    load_resident(cur_n);  // committed with item 0
  }
  for (int s = 0; s < stages - 1; ++s) prefetch(s);

  Acc acc;
#pragma unroll
  for (int f = 0; f < 4; ++f)
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][n][e] = 0.f;

  for (int i = 0; i < L; ++i) {
    if (stages == 3)
      cp_wait<1>();
    else
      cp_wait<0>();
    // item i is in shared memory for every thread, and every warp is done
    // with item i - 1, whose stage the prefetch below refills
    __syncthreads();
    prefetch(i + stages - 1);

    const Tile tl = decode<TC>(blockIdx.x + (i / g.nch) * G, g);
    const int c = i % g.nch;
    if (resident && tl.n0 != cur_n) {
      load_resident(tl.n0);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      cur_n = tl.n0;
    }
    const uint32_t xsm = ring + (i % stages) * stage_bytes;
    const uint32_t wsm =
        resident ? wres + c * CHUNK_W_BYTES : xsm + B::WIN_BYTES;
    B::compute(acc, xsm, wsm, c, lane, warp_n, ln);

    if (c != g.nch - 1) continue;
    // epilogue: store, reset the accumulators
    B::template store<VEC>(acc, out, g, tl, lane, warp_m, warp_n);
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][n][e] = 0.f;
  }
  cp_wait<0>();
}

// Launch body B over (b, h, wd, cin, cout) with tiles of `rows` output rows
// (at most 4 WARP_PX / TC) x TC columns on a persistent grid of min(tiles,
// sms) blocks; `bias` is passed to the body's epilogue.
template <class B>
cudaError_t launch_body(const void* x, const void* w, void* out, int b,
                        int h, int wd, int cin, int cout, int rows, int sms,
                        cudaStream_t stream, const float* bias = nullptr) {
  using E = typename B::E;
  constexpr int TC = B::TC;
  constexpr int VEC_C = 16 / sizeof(E);  // channels of a 16-byte copy
  if (b < 1 || h < 1 || wd < 1 || cin < 1 || cout < 1 || rows < 1 ||
      rows > 4 * (WARP_PX / TC) || sms < 1)
    return cudaErrorInvalidValue;
  Geo g;
  g.b = b, g.h = h, g.wd = wd, g.cin = cin, g.cout = cout, g.rows = rows;
  g.bias = bias;
  g.col_tiles = (wd + TC - 1) / TC;
  g.row_tiles = (h + rows - 1) / rows;
  g.n_tiles = (cout + BN - 1) / BN;
  g.spatial = b * g.row_tiles * g.col_tiles;
  g.tiles = g.n_tiles * g.spatial;
  g.nch = (cin + B::KCH - 1) / B::KCH;

  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t cap = static_cast<size_t>(max_smem);
  const size_t res_bytes = static_cast<size_t>(g.nch) * CHUNK_W_BYTES;
  int resident = 1, stages = 3, stage_bytes = B::WIN_BYTES;
  if (res_bytes + 3 * B::WIN_BYTES > cap) stages = 2;
  if (res_bytes + 2 * B::WIN_BYTES > cap) {
    resident = 0;
    stage_bytes = B::WIN_BYTES + CHUNK_W_BYTES;
    stages = 3 * static_cast<size_t>(stage_bytes) <= cap ? 3 : 2;
  }
  const size_t smem = (resident ? res_bytes : 0) +
                      static_cast<size_t>(stages) * stage_bytes;
  if (smem > cap) return cudaErrorInvalidValue;

  const bool vec = cin % VEC_C == 0 && cout % VEC_C == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(w) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  auto kernel = vec ? conv3_kernel<B, true> : conv3_kernel<B, false>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int grid = g.tiles < sms ? g.tiles : sms;
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(w),
      static_cast<E*>(out), g, resident, stages, stage_bytes);
  return cudaGetLastError();
}

// The bf16 body with TC output columns a tile.
template <int TC>
cudaError_t launch(const void* x, const void* w, void* out, int b, int h,
                   int wd, int cin, int cout, int rows, int sms,
                   cudaStream_t stream) {
  return launch_body<Bf16<TC>>(x, w, out, b, h, wd, cin, cout, rows, sms,
                               stream);
}

}  // namespace conv3
}  // namespace prgpt
