// The weight and bias gradients of K5's fp32 conv (a 3x3 stride-1 SAME
// convolution, NHWC), hand-written for Hopper (sm_90a):
//
//   dw[o, dy, dx, i] = sum_{b, y, x} x[b, y + dy - 1, x + dx - 1, i]
//                                    * g[b, y, x, o]
//   db[o]            = sum_{b, y, x} g[b, y, x, o]
//
// with zeros outside the image; x (b, h, w, cin) and g (b, h, w, cout)
// fp32, dw written as (cout, 3, 3, cin) (a (cout, cin, 3, 3) weight in
// channels-last memory) and db as (cout). It replaces no TPU kernel: the
// JAX conv tool leaves its weight gradient to XLA (tools/profile_conv.py
// ::_wgrad, nine shifted products), and the port's plain version of it
// (ops/conv.py::_wgrad) was 80-86% of the op's forward + backward. It is
// the backward half the MaskUNet's fp32 3x3 convs need to run on
// hand-written kernels instead of cuDNN (ops/conv.py::conv2d).
//
// Bound on this card: the products. Each is computed in three TF32 passes
// (a_lo b_hi + a_hi b_lo + a_hi b_hi, common.cuh's split_frag: about 21
// bits of each product where one TF32 pass keeps 10), so the bound is 3 x
// 2 x 9 x pixels x cin x cout operations at 494.7 TFLOP/s: at the
// MaskUNet's batch of 4, 117 us at 256^2 64 -> 64 and 29 us at 128^2 64
// -> 64 (x and g are 67 MB and 17 MB, 20 us and 5 us at 3.35 TB/s), 176
// us at 32^2 768 -> 512; at every shape the tensor cores set the time.
// ops/conv.py::work_conv counts the operations, chip_smoke.py the bound.
//
// Design.
// - The products are one GEMM per tap, dw_tap (cout x cin) = g^T (cout x
//   pixels) @ x_tap (pixels x cin), whose contraction, the pixels, is the
//   outer axis of both operands in memory. mma.sync.m16n8k8.tf32 wants
//   each lane's A and B values at pixels (k) t and t + 4 of one channel
//   row, so a fragment needs k-contiguous 32-bit rows; ldmatrix's .trans
//   moves 16-bit halves and would tear every fp32 value apart. The
//   fragments are instead loaded straight from the pixel-major tiles with
//   ld.shared.v4 (16 bytes: four channels of one pixel): the m slots of
//   the A fragments and the n slots of the B fragments are assigned to
//   channels so that one 16-byte load fills one k column of two A
//   fragments (ci 4g .. 4g + 3 <- slots g, g + 8 of m16 fragments 0 and
//   1) or of four B fragments (co 4g .. 4g + 3 <- slot g of n8 fragments 4q
//   .. 4q + 3), and the epilogue undoes the assignment. Four 16-byte loads
//   a k8 step feed a warp's 2 x 4 fragments' 24 mma. The 16-byte chunk j
//   of a position's row is stored at j ^ 2 (pos & 3): the four pixels t = 0..3
//   of a load then fall in four different chunk pairs, and each phase of
//   eight lanes reads 8 distinct bank groups.
// - Tiles. A block owns 32 input x 64 output channels of all nine taps,
//   two warps a tap, each 32 of the output channels: the 18 warps read one
//   staged window of x and one staged tile of g, so the x rows serve all
//   nine taps from shared memory, as K5's window does. The kernel is held
//   by latency, not by issue slots: one warp a tap (nine warps an SM, 48
//   mma a k8 step) ran 7-9% slower, and splitting g once in shared memory
//   for all nine, which saved a third of their instructions, slower
//   still (PERF.md). The pixels come in items of R (4) rows x C (32)
//   columns of one image: g's R x C pixels (64 channels, 256-byte rows)
//   and x's (R + 2) x (C + 2) halo window (32 channels, 128-byte rows),
//   58,880 bytes a stage, two stages filled by cp.async (zero-fill outside
//   the image and past the channels; 4-byte copies where a channel count
//   is no multiple of 4 or a pointer is unaligned). At 18 warps ptxas
//   gives a thread 96 registers, and spills a few bytes.
// - Split. The pixel sum is cut into `splits` contiguous runs of items,
//   only as far as the SMs need it: the wrapper (ops/conv.py::dw_split)
//   takes the split that finishes soonest with one block per SM a wave,
//   so the 2-tile 64 -> 64 convs split 64 ways at 256^2 and 128^2 and the
//   192-tile 768 -> 512 convs 2 ways. Each split writes its partial sums
//   to a scratch tensor the wrapper allocates, and conv3_kernel_dw_sum
//   adds them in a fixed order: no atomics, the same bits every run. With
//   one split the block writes dw and db directly.
// - Sums. The tensor cores truncate the sum each mma accumulates, so a
//   long sum in one fragment drifts (linear_attention_tf32.cuh, K5): each
//   fragment sums RUN (16) k8 steps (48 mma; 8 kept the gap to fp64 at
//   5e-7 where 16 gives 9e-7, both a tenth of cuDNN's fp32 weight
//   gradient's, and 16 is 1-3% faster), and is then added to the lane's
//   running sums in fp32 and cleared. The running sums live in
//   shared memory (32 floats a lane, 73,728 bytes a block), so the
//   registers hold only the fragments. db is summed from g's fp32 values
//   as they are loaded, k8 step s by the warps of tap s mod 9 (only in the
//   blocks of input-channel tile 0), then across lanes and taps in a
//   fixed order.
//
// Kernel names carry conv3_kernel (portbench/lib/trace.py reads them as
// hand-written).

#include "common.cuh"

namespace prgpt {
namespace conv3dw {

constexpr int NH = 2;     // warps a tap
constexpr int NF = 8 / NH;  // n8 fragments a warp
constexpr int WARPS = 9 * NH;
constexpr int THREADS = 32 * WARPS;
constexpr int BM = 32;    // input channels a tile
constexpr int BN = 64;    // output channels a tile
constexpr int R = 4;      // g's rows an item
constexpr int C = 32;     // g's columns an item
constexpr int WCOL = C + 2;
constexpr int WIN_POS = (R + 2) * WCOL;           // 204
constexpr int WIN_BYTES = WIN_POS * BM * 4;       // 26,112
constexpr int G_BYTES = R * C * BN * 4;           // 32,768
constexpr int STAGE_BYTES = WIN_BYTES + G_BYTES;  // 58,880
constexpr int STAGES = 2;
constexpr int STEPS = R * C / 8;  // k8 steps an item
constexpr int RUN = 16;           // k8 steps a fragment sums
constexpr int ACC4 = 2 * NF;      // running sums a lane, float4s
constexpr int ACC_BYTES = WARPS * 32 * ACC4 * 16;  // 73,728
constexpr int DB_BYTES = 9 * BN * 4;               // 2,304
constexpr int SMEM = STAGES * STAGE_BYTES + ACC_BYTES + DB_BYTES;
static_assert(STEPS % RUN == 0 && C % 8 == 0, "runs end with an item");
static_assert(NF % 4 == 0, "a warp's B fragments fill whole 16-byte loads");

struct Geo {
  int b, h, wd, cin, cout;
  int col_items, row_items, items, m_tiles, tiles, splits;
};

// 16-byte chunk j of position pos's row sits at chunk j ^ 2 (pos & 3)
__device__ __forceinline__ int swz(int pos, int j) {
  return j ^ ((pos & 3) << 1);
}

// Item `item` (image, R rows, C columns) into the stage at `st`: x's halo
// window of channels m0 .. m0 + 32, then g's pixels of channels n0 .. n0
// + 64; zeros outside the image and past cin and cout.
template <bool VEC>
__device__ __forceinline__ void load_item(uint32_t st, const float* x,
                                          const float* g, const Geo& q,
                                          int item, int m0, int n0) {
  const int per_img = q.row_items * q.col_items;
  const int img = item / per_img;
  const int rem = item - img * per_img;
  const int ry = rem / q.col_items;
  const int y0 = ry * R, x0 = (rem - ry * q.col_items) * C;
  const size_t img_px = static_cast<size_t>(img) * q.h;
  if (VEC) {
    for (int i = threadIdx.x; i < WIN_POS * 8; i += THREADS) {
      const int j = i & 7, pos = i >> 3;
      const int wr = pos / WCOL;
      const int gy = y0 - 1 + wr, gx = x0 - 1 + (pos - wr * WCOL);
      const int ch = m0 + 4 * j;
      const bool in =
          gy >= 0 && gy < q.h && gx >= 0 && gx < q.wd && ch < q.cin;
      const float* src =
          in ? x + ((img_px + gy) * q.wd + gx) * q.cin + ch : x;
      cp16(st + pos * (BM * 4) + (swz(pos, j) << 4), src, in);
    }
    for (int i = threadIdx.x; i < R * C * 16; i += THREADS) {
      const int j = i & 15, p = i >> 4;
      const int gy = y0 + p / C, gx = x0 + p % C, ch = n0 + 4 * j;
      const bool in = gy < q.h && gx < q.wd && ch < q.cout;
      const float* src =
          in ? g + ((img_px + gy) * q.wd + gx) * q.cout + ch : g;
      cp16(st + WIN_BYTES + p * (BN * 4) + (swz(p, j) << 4), src, in);
    }
  } else {
    for (int i = threadIdx.x; i < WIN_POS * BM; i += THREADS) {
      const int k = i & (BM - 1), pos = i / BM;
      const int wr = pos / WCOL;
      const int gy = y0 - 1 + wr, gx = x0 - 1 + (pos - wr * WCOL);
      const int ch = m0 + k;
      const bool in =
          gy >= 0 && gy < q.h && gx >= 0 && gx < q.wd && ch < q.cin;
      const float* src =
          in ? x + ((img_px + gy) * q.wd + gx) * q.cin + ch : x;
      cp4(st + pos * (BM * 4) + (swz(pos, k >> 2) << 4) + (k & 3) * 4, src,
          in);
    }
    for (int i = threadIdx.x; i < R * C * BN; i += THREADS) {
      const int k = i & (BN - 1), p = i / BN;
      const int gy = y0 + p / C, gx = x0 + p % C, ch = n0 + k;
      const bool in = gy < q.h && gx < q.wd && ch < q.cout;
      const float* src =
          in ? g + ((img_px + gy) * q.wd + gx) * q.cout + ch : g;
      cp4(st + WIN_BYTES + p * (BN * 4) + (swz(p, k >> 2) << 4) +
              (k & 3) * 4,
          src, in);
    }
  }
}

__device__ __forceinline__ uint4 lds128(const unsigned char* base,
                                        uint32_t off) {
  return *reinterpret_cast<const uint4*>(base + off);
}

// Block (tile, split): warp w computes tap w / NH's sums of 32 input x
// 32 output channels (half w % NH of the tile's 64) over the split's
// items. frag[mf][nf][e]: m slot g + 8 (e >> 1) of m16 fragment mf is
// input channel m0 + 4 g + 2 mf + (e >> 1); n slot 2 t + (e & 1) of n8
// fragment nf is output channel n0 + 32 q + 8 t + 4 (e & 1) + (nf & 3),
// q = (w % NH) (NF / 4) + nf / 4 (g = lane >> 2, t = lane & 3).
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
conv3_kernel_dw(const float* __restrict__ x, const float* __restrict__ g,
                float* __restrict__ dw, float* __restrict__ db, Geo q) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = smem_u32(smem);
  float4* acc4 = reinterpret_cast<float4*>(smem + STAGES * STAGE_BYTES);
  float* dbs = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES +
                                        ACC_BYTES);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int tap = warp / NH, q0 = (warp % NH) * (NF / 4);
  const int ty = tap / 3, tx = tap - 3 * ty;
  const int tile = blockIdx.x % q.tiles, split = blockIdx.x / q.tiles;
  const int mt = tile % q.m_tiles;
  const int m0 = mt * BM, n0 = (tile / q.m_tiles) * BN;
  const int i0 = static_cast<int>(static_cast<long long>(split) * q.items /
                                  q.splits);
  const int L = static_cast<int>(static_cast<long long>(split + 1) *
                                 q.items / q.splits) - i0;
  const bool with_db = db != nullptr && mt == 0;

  // this lane's running sums: float4 (nf, e & 1), lanes contiguous
  float4* mine = acc4 + warp * ACC4 * 32 + lane;
#pragma unroll
  for (int k = 0; k < ACC4; ++k)
    mine[k * 32] = make_float4(0.f, 0.f, 0.f, 0.f);

  // fixed parts of this lane's shared-memory offsets. A: window position
  // (r + ty) WCOL + 8 c8 + tx + t at k = t (+ 4 at k = t + 4), whose low
  // two bits vary with r's parity (WCOL = 2 mod 4); B: g's pixel r C + 8
  // c8 + t, low bits t
  const int abase = ty * WCOL + tx + t;
  uint32_t aoff[2], boff[NF / 4];
#pragma unroll
  for (int par = 0; par < 2; ++par)
    aoff[par] = abase * (BM * 4) + (swz(abase + 2 * par, gq) << 4);
#pragma unroll
  for (int h = 0; h < NF / 4; ++h)
    boff[h] = WIN_BYTES + t * (BN * 4) + (swz(t, 8 * (q0 + h) + gq) << 4);

  auto prefetch = [&](int i) {
    if (i < L)
      load_item<VEC>(ring + (i % STAGES) * STAGE_BYTES, x, g, q, i0 + i, m0,
                     n0);
    cp_commit();
  };
  prefetch(0);

  float frag[2][NF][4];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) frag[mf][nf][e] = 0.f;
  float dbl[NF];
#pragma unroll
  for (int nf = 0; nf < NF; ++nf) dbl[nf] = 0.f;
  int turn = 0;  // the tap whose warps add this k8 step's g to db

  for (int i = 0; i < L; ++i) {
    cp_wait<0>();
    // item i has landed for every thread, and every warp is done with
    // item i - 1, whose stage the prefetch below refills
    __syncthreads();
    prefetch(i + 1);
    const unsigned char* st = smem + (i % STAGES) * STAGE_BYTES;
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int r = s / (C / 8), c8 = s % (C / 8);
      const uint32_t ao = aoff[r & 1] + (r * WCOL + 8 * c8) * (BM * 4);
      const uint32_t bo = (r * C + 8 * c8) * (BN * 4);
      uint32_t a[2][4], al[2][4], b[NF][2], bl[NF][2];
      {
        const uint4 v0 = lds128(st, ao), v1 = lds128(st, ao + 4 * BM * 4);
        a[0][0] = v0.x, a[0][1] = v0.y, a[1][0] = v0.z, a[1][1] = v0.w;
        a[0][2] = v1.x, a[0][3] = v1.y, a[1][2] = v1.z, a[1][3] = v1.w;
      }
#pragma unroll
      for (int h = 0; h < NF / 4; ++h) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {  // pixel t, then t + 4
          const uint4 u = lds128(st, boff[h] + bo + k * 4 * BN * 4);
          b[4 * h][k] = u.x, b[4 * h + 1][k] = u.y;
          b[4 * h + 2][k] = u.z, b[4 * h + 3][k] = u.w;
        }
      }
      if (with_db && turn == tap) {
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
          dbl[nf] += __uint_as_float(b[nf][0]) + __uint_as_float(b[nf][1]);
      }
      turn = turn == 8 ? 0 : turn + 1;
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) split_frag(a[mf], al[mf]);
#pragma unroll
      for (int nf = 0; nf < NF; ++nf) split_frag(b[nf], bl[nf]);
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
          mma_3xtf32(frag[mf][nf], a[mf], al[mf], b[nf], bl[nf]);
      if ((s + 1) % RUN == 0) {
        // the run's sums into the running sums in fp32, fragments cleared
#pragma unroll
        for (int nf = 0; nf < NF; ++nf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float4 v = mine[(2 * nf + e) * 32];
            v.x += frag[0][nf][e];
            v.y += frag[0][nf][2 + e];
            v.z += frag[1][nf][e];
            v.w += frag[1][nf][2 + e];
            mine[(2 * nf + e) * 32] = v;
            frag[0][nf][e] = frag[0][nf][2 + e] = 0.f;
            frag[1][nf][e] = frag[1][nf][2 + e] = 0.f;
          }
      }
    }
  }
  cp_wait<0>();

  // dw (or this split's partial): float4 (nf, e) of the running sums is
  // input channels m0 + 4 gq .. + 3 of output channel co, tap `tap`
  float* out = dw + static_cast<size_t>(split) * q.cout * 9 * q.cin;
  const bool vec_out = VEC && m0 + 4 * gq < q.cin;
#pragma unroll
  for (int nf = 0; nf < NF; ++nf)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = n0 + 32 * (q0 + nf / 4) + 8 * t + 4 * e + (nf & 3);
      if (co >= q.cout) continue;
      const float4 v = mine[(2 * nf + e) * 32];
      float* dst = out + (static_cast<size_t>(co) * 9 + tap) * q.cin + m0 +
                   4 * gq;
      if (vec_out) {
        *reinterpret_cast<float4*>(dst) = v;
      } else if (!VEC) {
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (m0 + 4 * gq + c < q.cin) dst[c] = vs[c];
      }
    }

  if (with_db) {  // the same for every thread of the block
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
      dbl[nf] += __shfl_xor_sync(0xffffffffu, dbl[nf], 1);
      dbl[nf] += __shfl_xor_sync(0xffffffffu, dbl[nf], 2);
    }
    if (t == 0) {
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
        dbs[tap * BN + 32 * (q0 + nf / 4) + 4 * gq + (nf & 3)] = dbl[nf];
    }
    __syncthreads();
    if (threadIdx.x < BN && n0 + threadIdx.x < q.cout) {
      float sum = 0.f;
      for (int k = 0; k < 9; ++k) sum += dbs[k * BN + threadIdx.x];
      db[static_cast<size_t>(split) * q.cout + n0 + threadIdx.x] = sum;
    }
  }
}

// dw[i] = sum over the splits of part[s][i] (float4s where V4: n % 4 ==
// 0, aligned), in a fixed order: a block takes SUM_COLS columns, each of
// its SUM_GROUPS thread rows one contiguous run of the splits, and the
// runs' sums are added in run order; the last block sums db (when given)
// from dbpart[s][co] in split order. One thread a column in split order
// left 9,216 threads with 64 dependent loads each at the 64 -> 64 convs.
constexpr int SUM_COLS = 32, SUM_GROUPS = 8;

template <bool V4>
__global__ void __launch_bounds__(SUM_COLS * SUM_GROUPS)
conv3_kernel_dw_sum(const float* __restrict__ part,
                    const float* __restrict__ dbpart, float* __restrict__ dw,
                    float* __restrict__ db, int n, int cout, int splits) {
  __shared__ float4 red[SUM_GROUPS][SUM_COLS];
  const int nw = V4 ? n / 4 : n;
  const int col_blocks = (nw + SUM_COLS - 1) / SUM_COLS;
  if (static_cast<int>(blockIdx.x) == col_blocks) {
    for (int c = threadIdx.x; c < cout; c += blockDim.x) {
      float sum = 0.f;
      for (int s = 0; s < splits; ++s)
        sum += dbpart[static_cast<size_t>(s) * cout + c];
      db[c] = sum;
    }
    return;
  }
  const int col = threadIdx.x % SUM_COLS, grp = threadIdx.x / SUM_COLS;
  const int i = blockIdx.x * SUM_COLS + col;
  const int s0 = grp * splits / SUM_GROUPS;
  const int s1 = (grp + 1) * splits / SUM_GROUPS;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < nw) {
#pragma unroll 4
    for (int s = s0; s < s1; ++s) {
      if (V4) {
        const float4 v = reinterpret_cast<const float4*>(
            part)[static_cast<size_t>(s) * nw + i];
        sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
      } else {
        sum.x += part[static_cast<size_t>(s) * n + i];
      }
    }
  }
  red[grp][col] = sum;
  __syncthreads();
  if (grp == 0 && i < nw) {
    for (int k = 1; k < SUM_GROUPS; ++k) {
      const float4 v = red[k][col];
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
    if (V4)
      reinterpret_cast<float4*>(dw)[i] = sum;
    else
      dw[i] = sum.x;
  }
}

}  // namespace conv3dw
}  // namespace prgpt

extern "C" {

// The kernel's tile and item: 0 input channels, 1 output channels, 2
// rows, 3 columns (ops/conv.py mirrors them).
int prgpt_conv3_dw_dims(int which) {
  using namespace prgpt::conv3dw;
  const int dims[4] = {BM, BN, R, C};
  return which >= 0 && which < 4 ? dims[which] : -1;
}

// dw (cout, 3, 3, cin) and, when db is not null, db (cout) from x (b, h,
// wd, cin) and g (b, h, wd, cout), all fp32; the pixel sum cut into
// `splits` runs. With splits > 1, scratch holds splits x (9 cin cout +
// cout) floats.
int prgpt_conv3_dw(const void* x, const void* g, void* dw, void* db,
                   void* scratch, int b, int h, int wd, int cin, int cout,
                   int splits, void* stream) {
  using namespace prgpt::conv3dw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || h < 1 || wd < 1 || cin < 1 || cout < 1 || splits < 1 ||
      (splits > 1 && scratch == nullptr))
    return cudaErrorInvalidValue;
  Geo q;
  q.b = b, q.h = h, q.wd = wd, q.cin = cin, q.cout = cout;
  q.col_items = (wd + C - 1) / C;
  q.row_items = (h + R - 1) / R;
  const long long items = static_cast<long long>(b) * q.row_items *
                          q.col_items;
  q.m_tiles = (cin + BM - 1) / BM;
  const long long tiles =
      static_cast<long long>(q.m_tiles) * ((cout + BN - 1) / BN);
  if (items > (1 << 30) || splits > items || tiles * splits > (1 << 30))
    return cudaErrorInvalidValue;
  q.items = static_cast<int>(items);
  q.tiles = static_cast<int>(tiles);
  q.splits = splits;

  const bool vec = cin % 4 == 0 && cout % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(g) |
                    reinterpret_cast<uintptr_t>(dw) |
                    reinterpret_cast<uintptr_t>(scratch)) % 16 == 0;
  auto kernel = vec ? conv3_kernel_dw<true> : conv3_kernel_dw<false>;
  cudaError_t err = prgpt::allow_smem(kernel, SMEM);
  if (err != cudaSuccess) return err;
  const int n = 9 * cin * cout;
  float* part = splits > 1 ? static_cast<float*>(scratch)
                           : static_cast<float*>(dw);
  float* dbpart = db == nullptr ? nullptr
                  : splits > 1  ? static_cast<float*>(scratch) +
                                     static_cast<size_t>(splits) * n
                                : static_cast<float*>(db);
  kernel<<<q.tiles * splits, THREADS, SMEM, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), part,
      dbpart, q);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int col_blocks = ((vec ? n / 4 : n) + SUM_COLS - 1) / SUM_COLS;
  auto sum = vec ? conv3_kernel_dw_sum<true> : conv3_kernel_dw_sum<false>;
  sum<<<col_blocks + (db != nullptr), SUM_COLS * SUM_GROUPS, 0, s>>>(
      part, dbpart, static_cast<float*>(dw), static_cast<float*>(db), n,
      cout, splits);
  return cudaGetLastError();
}

}  // extern "C"
