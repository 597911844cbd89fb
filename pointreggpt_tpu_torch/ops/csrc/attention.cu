// K2: bottleneck full attention softmax(q k^T * scale) v, hand-written for
// Hopper (sm_90a).
//
// Replaces pointreggpt_tpu/ops/attention.py::_attention_pallas.
//
// q, k, v (b, n, h, d) in T (bf16 or fp32), possibly strided views of one
// packed projection: element (bi, row, hi, dd) sits at
// bi * sb + row * sn + hi * sh + dd. The head stride sh is d for the
// PointRegGPT nets' (b, n, 3, h, d) packing and 3 d for ADM's legacy
// per-head [q_h | k_h | v_h] order, so neither copies q, k or v. The
// output is written contiguous (b, n, h, d) in T.
//
// Bound on this card at the production shape (8, 1024, 4, 32) bf16:
// 4 tensors x 2 MB = 8.4 MB moved, 2.5 us at 3.35 TB/s, against
// 2 * 2 * b*h*n*n*d = 4.3 GFLOP, 4.3 us at 989 TFLOP/s: operation-bound.
// ADM's d = 64 at (8, 1024, 8, 64): 33.6 MB, 10.0 us, against 17.2 GFLOP,
// 17.4 us: operation-bound; at (8, 256, 16, 64) and (8, 64, 16, 64) the
// bytes bound it (5.0 and 1.25 us).
//
// The TPU kernel holds the whole 1024x1024 fp32 score matrix (4 MB) of a
// head in VMEM, which no Hopper block can. Both paths here are tiled
// online-softmax (flash) kernels over 64-row k/v tiles; the scores never
// leave registers.
//
// bf16 (flash_fwd_tc, FlashAttention-2 style, a template on d = 32 or 64):
// one block of 4 warps per (64 q rows, b*h), each warp owning 16 q rows:
// 16 x 32 = 512 blocks at (8, 1024, 4, 32), 2,048 at microbatch 32, 1,024
// at ADM's (8, 1024, 8, 64). q, and k and v tile by tile through a
// two-stage ring, are staged by cp.async into rows of 2 d bytes, swizzled
// (d = 32: chunk j of row r at j ^ ((r >> 1) & 3); d = 64: j ^ (r & 7))
// so that the 8 rows of an ldmatrix hit 8 different bank groups; at
// d = 64 the block's shared memory is 40 KB. S = q k^T runs as
// mma.sync.m16n8k16 (bf16 in, fp32 sums; bf16 x bf16 products are exact in
// fp32) from q fragments held in registers for the whole walk. The scale
// is applied to S in fp32, times log2 e, so that the softmax uses exp2f:
// exact algebra of the TPU kernel's fp32 q * scale before the product, up
// to fp32 rounding. The online softmax runs on the accumulator fragments
// (row max and row sum over each quad by __shfl_xor); P is rounded to bf16
// and reused in registers as the A operand of O += P V, with V read by
// ldmatrix.trans. O / l is written in bf16.
//
// fp32 (flash_fwd_tf32x3, the MaskUNet's path): the same structure on the
// TF32 tensor cores in three passes (common.cuh: a b ~= a_lo b_hi + a_hi
// b_lo + a_hi b_hi, about 21 bits of each product; one TF32 pass keeps 10
// and misses the fp32 tolerance). q is scaled in fp32 before the product,
// as the TPU kernel and the plain version do, and split once for the
// whole walk. Rows are 128 bytes (32 floats); 16-byte chunk j of row r
// sits at j ^ (r & 7). S = (q scale) k^T is four k8 steps of
// mma.m16n8k8.tf32, k read by ldmatrix as pairs of b16 (a 32-bit
// element is two b16 halves, so the non-transposed fragments come out
// right). The accumulator of S holds keys 2t and 2t + 1 (t = lane & 3)
// where the A operand of P V wants k indices t and t + 4, so each k8 step
// of P V takes its 8 keys in the order 0, 2, 4, 6, 1, 3, 5, 7: A's index t
// is key 2t and t + 4 is key 2t + 1, and V's rows are read in that order
// (the swizzle keeps those reads on 32 different banks). P is split once
// per k8 step and reused over the four d tiles. Bound at (8, 1024, 4, 32):
// 3 x 4.3 GFLOP of TF32 products, 26 us at 494.7 TFLOP/s, against 17 MB
// moved, 5 us: operation-bound.

#include "common.cuh"

#include <math.h>

namespace {

// ---- bf16: tensor cores ----

using bf16 = __nv_bfloat16;
using prgpt::cp16;
using prgpt::cp_commit;
using prgpt::cp_wait;
using prgpt::ldm_x4;
using prgpt::ldm_x4_trans;
using prgpt::mma16816;
using prgpt::pack_bf16x2;

constexpr int TC_WARPS = 4;            // 16 q rows each
constexpr int TC_ROWS = 16 * TC_WARPS;  // q rows per block
constexpr int KT = 64;                 // k / v rows per tile

// Byte offset of 16-byte chunk j of staged row r of D bf16 values. d = 32:
// rows of 64 bytes, two to a 128-byte line of banks; chunk j (0..3) of row
// r sits at j ^ ((r >> 1) & 3), so 8 consecutive rows cover all 8 bank
// groups. d = 64: rows of 128 bytes; chunk j (0..7) of row r sits at
// j ^ (r & 7), the same property.
template <int D>
__device__ __forceinline__ uint32_t swz_tc(int r, int j) {
  if constexpr (D == 32) {
    return r * 64 + ((j ^ ((r >> 1) & 3)) << 4);
  } else {
    return r * 128 + ((j ^ (r & 7)) << 4);
  }
}

// D = 32 or 64 values a head; d / 16 k16 steps of S = q k^T, d / 8 n8
// fragments of O.
template <int D>
__global__ void __launch_bounds__(32 * TC_WARPS)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out, int n,
             int h, long long sb, long long sn, long long sh, float scale) {
  constexpr int ROW_B = 2 * D;        // bytes of one staged row
  constexpr int CHUNKS = D / 8;       // 16-byte chunks of a row
  constexpr int TILE_B = KT * ROW_B;
  constexpr int KS = D / 16;          // k16 steps over d
  constexpr int NF = D / 8;           // n8 fragments of O over d
  // q rows, then two ring stages of [k tile | v tile]
  __shared__ __align__(128) unsigned char smem[TC_ROWS * ROW_B + 4 * TILE_B];
  const uint32_t qs = prgpt::smem_u32(smem);
  const uint32_t ring = qs + TC_ROWS * ROW_B;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bi = blockIdx.y / h;
  const int hi = blockIdx.y % h;
  const int q0 = blockIdx.x * TC_ROWS;
  const size_t base = static_cast<size_t>(bi) * sb + static_cast<size_t>(hi) * sh;
  const float sl2 = scale * 1.4426950408889634f;  // scale * log2 e

  // rows r0 .. r0 + 64 of src into dst, zeros past n
  auto stage = [&](uint32_t dst, const bf16* src, int r0, int nrows) {
    for (int i = tid; i < nrows * CHUNKS; i += 32 * TC_WARPS) {
      const int r = i / CHUNKS, j = i % CHUNKS;
      const bool in = r0 + r < n;
      cp16(dst + swz_tc<D>(r, j),
           in ? src + base + static_cast<size_t>(r0 + r) * sn + j * 8 : src,
           in);
    }
  };
  const int tiles = (n + KT - 1) / KT;
  stage(qs, q, q0, TC_ROWS);
  stage(ring, k, 0, KT);
  stage(ring + TILE_B, v, 0, KT);
  cp_commit();

  uint32_t qf[KS][4];  // this warp's 16 q rows x D: KS k16 A fragments
  float o[NF][4];      // 16 rows x D: NF n8 fragments
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // rows g = lane / 4 and g + 8: running max (scaled by log2 e) and this
  // lane's share of the running sum
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int t = 0; t < tiles; ++t) {
    cp_wait<0>();
    // tile t is in shared memory for every thread, and every warp is done
    // with tile t - 1, whose stage the prefetch below refills
    __syncthreads();
    if (t + 1 < tiles) {
      const uint32_t st = ring + ((t + 1) & 1) * 2 * TILE_B;
      stage(st, k, (t + 1) * KT, KT);
      stage(st + TILE_B, v, (t + 1) * KT, KT);
    }
    cp_commit();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldm_x4(qf[kk], qs + swz_tc<D>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
    }
    const uint32_t ks = ring + (t & 1) * 2 * TILE_B;
    const uint32_t vs = ks + TILE_B;

    // S = q k^T: 16 rows x 64 keys, eight n8 fragments
    float s[8][4];
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jb][e] = 0.f;
#pragma unroll
      for (int hh = 0; hh < D / 32; ++hh) {
        uint32_t b[4];  // keys 8 jb .. 8 jb + 7, d 32 hh .. 32 hh + 31
        ldm_x4(b, ks + swz_tc<D>(jb * 8 + (lane & 7), 4 * hh + (lane >> 3)));
        mma16816(s[jb], qf[2 * hh], b[0], b[1]);
        mma16816(s[jb], qf[2 * hh + 1], b[2], b[3]);
      }
    }

    // online softmax on the fragments: element e of fragment jb is row
    // g + 8 (e >> 1), key 8 jb + 2 (lane & 3) + (e & 1)
    const int kn = n - t * KT;  // valid keys in this tile
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = jb * 8 + 2 * (lane & 3) + (e & 1);
        s[jb][e] = key < kn ? s[jb][e] * sl2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[jb][e]);
      }
    float al[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      al[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= al[r];
    }
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= al[e >> 1];
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[jb][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[jb][e] = p;
      }

    // O += P V: P rounded to bf16, the S fragments repacked as A operands
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int kr = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        uint32_t b[4];
        ldm_x4_trans(b, vs + swz_tc<D>(kr, 2 * jj + (lane >> 4)));
        mma16816(o[2 * jj], a, b[0], b[1]);
        mma16816(o[2 * jj + 1], a, b[2], b[3]);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
    if (row >= n) continue;
    bf16* orow = out + ((static_cast<size_t>(bi) * n + row) * h + hi) * D +
                 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NF; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16x2(o[j][2 * r] * inv[r], o[j][2 * r + 1] * inv[r]);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      int b, int n, int h, long long sb, long long sn,
                      long long sh, float scale, cudaStream_t stream) {
  // cp.async copies 16-byte chunks: every row must start 16-byte aligned
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
              16 != 0 ||
      sb % 8 != 0 || sn % 8 != 0 || sh % 8 != 0)
    return cudaErrorInvalidValue;
  dim3 grid((n + TC_ROWS - 1) / TC_ROWS, b * h);
  flash_fwd_tc<D><<<grid, 32 * TC_WARPS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), n, h, sb, sn, sh,
      scale);
  return cudaGetLastError();
}

// ---- fp32: TF32 tensor cores, three passes ----

using prgpt::mma_3xtf32;
using prgpt::split_frag;

constexpr int F_ROW = 128;            // bytes of one staged row (32 floats)
constexpr int F_TILE = KT * F_ROW;

// Byte offset of 16-byte chunk j (0..7) of staged fp32 row r: chunk j of
// row r sits at j ^ (r & 7), so the 8 rows of an ldmatrix, and the rows
// 2t, 2t + 1 of the permuted V reads, hit different bank groups.
__device__ __forceinline__ uint32_t swz128(int r, int j) {
  return r * F_ROW + ((j ^ (r & 7)) << 4);
}

__global__ void __launch_bounds__(32 * TC_WARPS)
flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int n,
                 int h, long long sb, long long sn, long long sh,
                 float scale) {
  // q rows, then two ring stages of [k tile | v tile]
  __shared__ __align__(128) unsigned char smem[TC_ROWS * F_ROW + 4 * F_TILE];
  const uint32_t qs = prgpt::smem_u32(smem);
  const uint32_t ring = qs + TC_ROWS * F_ROW;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bi = blockIdx.y / h;
  const int hi = blockIdx.y % h;
  const int q0 = blockIdx.x * TC_ROWS;
  const size_t base = static_cast<size_t>(bi) * sb + static_cast<size_t>(hi) * sh;

  // rows r0 .. r0 + nrows of src into dst, zeros past n
  auto stage = [&](uint32_t dst, const float* src, int r0, int nrows) {
    for (int i = tid; i < nrows * 8; i += 32 * TC_WARPS) {
      const int r = i >> 3, j = i & 7;
      const bool in = r0 + r < n;
      cp16(dst + swz128(r, j),
           in ? src + base + static_cast<size_t>(r0 + r) * sn + j * 4 : src,
           in);
    }
  };
  const int tiles = (n + KT - 1) / KT;
  stage(qs, q, q0, TC_ROWS);
  stage(ring, k, 0, KT);
  stage(ring + F_TILE, v, 0, KT);
  cp_commit();

  // this warp's 16 q rows x 32 d, scaled, split: four k8 A fragments
  uint32_t qh[4][4], ql[4][4];
  float o[4][4];  // 16 rows x 32 d: four n8 fragments
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // rows g and g + 8: running max (times log2 e) and this lane's share of
  // the running sum
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int kt = 0; kt < tiles; ++kt) {
    cp_wait<0>();
    // tile kt is in shared memory for every thread, and every warp is done
    // with tile kt - 1, whose stage the prefetch below refills
    __syncthreads();
    if (kt + 1 < tiles) {
      const uint32_t st = ring + ((kt + 1) & 1) * 2 * F_TILE;
      stage(st, k, (kt + 1) * KT, KT);
      stage(st + F_TILE, v, (kt + 1) * KT, KT);
    }
    cp_commit();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldm_x4(qh[kk], qs + swz128(warp * 16 + (lane & 7) +
                                       ((lane >> 3) & 1) * 8,
                                   2 * kk + (lane >> 4)));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          qh[kk][e] = __float_as_uint(__uint_as_float(qh[kk][e]) * scale);
        split_frag(qh[kk], ql[kk]);
      }
    }
    const uint32_t ks = ring + (kt & 1) * 2 * F_TILE;
    const unsigned char* vs = smem + (ks - qs) + F_TILE;

    // S = (q scale) k^T: 16 rows x 64 keys, eight n8 fragments; element e
    // of s[jb] is row g + 8 (e >> 1), key 8 jb + 2 t4 + (e & 1)
    float s[8][4];
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jb][e] = 0.f;
      uint32_t b[2][4];  // keys 8 jb .., d 16 h .. 16 h + 15
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        ldm_x4(b[hh], ks + swz128(jb * 8 + (lane & 7), 4 * hh + (lane >> 3)));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bh[2] = {b[kk >> 1][2 * (kk & 1)],
                          b[kk >> 1][2 * (kk & 1) + 1]};
        uint32_t bl[2];
        split_frag(bh, bl);
        mma_3xtf32(s[jb], qh[kk], ql[kk], bh, bl);
      }
    }

    // online softmax on the fragments, in log2 units
    const int kn = n - kt * KT;  // valid keys in this tile
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = jb * 8 + 2 * t4 + (e & 1);
        s[jb][e] = key < kn ? s[jb][e] * 1.4426950408889634f : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[jb][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[jb][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[jb][e] = p;
      }

    // O = alpha O + P V, P V summed apart (each mma truncates the sum it
    // accumulates); k8 step jb takes keys 8 jb + (0, 2, 4, 6, 1, 3, 5, 7)
    float pv[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      uint32_t ah[4] = {__float_as_uint(s[jb][0]), __float_as_uint(s[jb][2]),
                        __float_as_uint(s[jb][1]), __float_as_uint(s[jb][3])};
      uint32_t al[4];
      split_frag(ah, al);
      // A's k index t is key 2t of the block and t + 4 is key 2t + 1
      const int k0 = jb * 8 + 2 * t4, k1 = k0 + 1;
#pragma unroll
      for (int nd = 0; nd < 4; ++nd) {
        const int col = nd * 8 + g;
        uint32_t bh[2] = {
            *reinterpret_cast<const uint32_t*>(vs + swz128(k0, col >> 2) +
                                               (col & 3) * 4),
            *reinterpret_cast<const uint32_t*>(vs + swz128(k1, col >> 2) +
                                               (col & 3) * 4)};
        uint32_t bl[2];
        split_frag(bh, bl);
        mma_3xtf32(pv[nd], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = fmaf(o[j][e], alpha[e >> 1], pv[j][e]);
  }

  float rl[2];  // 1 / the row sums
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    rl[r] = 1.f / l[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= n) continue;
    float* orow = out + ((static_cast<size_t>(bi) * n + row) * h + hi) * 32 +
                  2 * t4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float2*>(orow + j * 8) =
          make_float2(o[j][2 * r] * rl[r], o[j][2 * r + 1] * rl[r]);
  }
}

cudaError_t launch_tf32x3(const void* q, const void* k, const void* v,
                          void* out, int b, int n, int h, long long sb,
                          long long sn, long long sh, float scale,
                          cudaStream_t stream) {
  // cp.async copies 16-byte chunks: every row must start 16-byte aligned
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
              16 != 0 ||
      sb % 4 != 0 || sn % 4 != 0 || sh % 4 != 0)
    return cudaErrorInvalidValue;
  dim3 grid((n + TC_ROWS - 1) / TC_ROWS, b * h);
  flash_fwd_tf32x3<<<grid, 32 * TC_WARPS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, h, sb, sn,
      sh, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int prgpt_attention(const void* q, const void* k, const void* v,
                               void* out, int b, int n, int h, int d,
                               long long sb, long long sn, long long sh,
                               float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32) {
    return is_bf16
               ? launch_tc<32>(q, k, v, out, b, n, h, sb, sn, sh, scale, s)
               : launch_tf32x3(q, k, v, out, b, n, h, sb, sn, sh, scale, s);
  }
  if (d == 64 && is_bf16)
    return launch_tc<64>(q, k, v, out, b, n, h, sb, sn, sh, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
