// K2: bottleneck full attention softmax(q k^T * scale) v, hand-written for
// Hopper (sm_90a).
//
// Replaces pointreggpt_tpu/ops/attention.py::_attention_pallas.
//
// q, k, v (b, n, h, d) in T (bf16 or fp32), possibly strided views of one
// packed (b, n, 3, h, d) projection: element (bi, row, hi, dd) sits at
// bi * sb + row * sn + hi * d + dd. The output is written contiguous
// (b, n, h, d) in T.
//
// Bound on this card at the production shape (8, 1024, 4, 32) bf16:
// 4 tensors x 2 MB = 8.4 MB moved, 2.5 us at 3.35 TB/s, against
// 2 * 2 * b*h*n*n*d = 4.3 GFLOP, 4.3 us at 989 TFLOP/s: operation-bound.
//
// The TPU kernel holds the whole 1024x1024 fp32 score matrix (4 MB) of a
// head in VMEM, which no Hopper block can. Both paths here are tiled
// online-softmax (flash) kernels over 64-row k/v tiles; the scores never
// leave registers.
//
// bf16 (flash_fwd_tc, FlashAttention-2 style, d = 32): one block of 4 warps
// per (64 q rows, b*h), each warp owning 16 q rows: 16 x 32 = 512 blocks at
// (8, 1024, 4, 32), 2,048 at microbatch 32. q, and k and v tile by tile
// through a two-stage ring, are staged by cp.async into 64-byte rows,
// swizzled (chunk j of row r at j ^ ((r >> 1) & 3)) so that the 8 rows of
// an ldmatrix hit 8 different bank groups. S = q k^T runs as
// mma.sync.m16n8k16 (bf16 in, fp32 sums; bf16 x bf16 products are exact in
// fp32) from q fragments held in registers for the whole walk. The scale
// is applied to S in fp32, times log2 e, so that the softmax uses exp2f:
// exact algebra of the TPU kernel's fp32 q * scale before the product, up
// to fp32 rounding. The online softmax runs on the accumulator fragments
// (row max and row sum over each quad by __shfl_xor); P is rounded to bf16
// and reused in registers as the A operand of O += P V, with V read by
// ldmatrix.trans. O / l is written in bf16.
//
// fp32 (flash_fwd, the MaskUNet's path): one thread per q row holding its
// scaled q, running max and sum and fp32 accumulator in registers, k/v
// tiles in shared memory, fp32 FMAs on the CUDA cores (TF32 would not hold
// the fp32 tolerance). The scale is applied to q before the product, as the
// TPU kernel does.

#include "common.cuh"

#include <math.h>

namespace {

using prgpt::from_f;
using prgpt::to_f;

constexpr int TILE = 64;

template <typename T, int D>
__global__ void __launch_bounds__(TILE)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int n, int h,
          long long sb, long long sn, float scale) {
  __shared__ float ks[TILE][D];
  __shared__ float vs[TILE][D];
  const int tid = threadIdx.x;
  const int bi = blockIdx.y / h;
  const int hi = blockIdx.y % h;
  const int row = blockIdx.x * TILE + tid;
  const size_t base = static_cast<size_t>(bi) * sb + static_cast<size_t>(hi) * D;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    qr[dd] = row < n ? to_f(q[base + static_cast<size_t>(row) * sn + dd]) *
                           scale
                     : 0.f;
    acc[dd] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int kt = 0; kt < n; kt += TILE) {
    __syncthreads();
    const int kr = kt + tid;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      const size_t off = base + static_cast<size_t>(kr) * sn + dd;
      ks[tid][dd] = kr < n ? to_f(k[off]) : 0.f;
      vs[tid][dd] = kr < n ? to_f(v[off]) : 0.f;
    }
    __syncthreads();
    const int kn = min(TILE, n - kt);

    float s[TILE];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) dot = fmaf(qr[dd], ks[j][dd], dot);
      s[j] = j < kn ? dot : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float al = expf(m - m_new);
    l *= al;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) acc[dd] *= al;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) acc[dd] = fmaf(p, vs[j][dd], acc[dd]);
    }
    m = m_new;
  }

  if (row < n) {
    T* o = out + ((static_cast<size_t>(bi) * n + row) * h + hi) * D;
    const float inv = 1.f / l;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) o[dd] = from_f<T>(acc[dd] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int n, int h, long long sb, long long sn,
                   float scale, cudaStream_t stream) {
  dim3 grid((n + TILE - 1) / TILE, b * h);
  flash_fwd<T, D><<<grid, TILE, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n, h, sb, sn, scale);
  return cudaGetLastError();
}


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
constexpr int ROW_B = 64;              // bytes of one staged row (32 bf16)
constexpr int TILE_B = KT * ROW_B;

// Byte offset of 16-byte chunk j (0..3) of staged row r. Rows are 64
// bytes, two to a 128-byte line of banks; chunk j of row r sits at
// j ^ ((r >> 1) & 3), so 8 consecutive rows cover all 8 bank groups.
__device__ __forceinline__ uint32_t swz64(int r, int j) {
  return r * ROW_B + ((j ^ ((r >> 1) & 3)) << 4);
}

__global__ void __launch_bounds__(32 * TC_WARPS)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ out, int n,
             int h, long long sb, long long sn, float scale) {
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
  const size_t base = static_cast<size_t>(bi) * sb + static_cast<size_t>(hi) * 32;
  const float sl2 = scale * 1.4426950408889634f;  // scale * log2 e

  // rows r0 .. r0 + 64 of src into dst, zeros past n
  auto stage = [&](uint32_t dst, const bf16* src, int r0, int nrows) {
    for (int i = tid; i < nrows * 4; i += 32 * TC_WARPS) {
      const int r = i >> 2, j = i & 3;
      const bool in = r0 + r < n;
      cp16(dst + swz64(r, j),
           in ? src + base + static_cast<size_t>(r0 + r) * sn + j * 8 : src,
           in);
    }
  };
  const int tiles = (n + KT - 1) / KT;
  stage(qs, q, q0, TC_ROWS);
  stage(ring, k, 0, KT);
  stage(ring + TILE_B, v, 0, KT);
  cp_commit();

  uint32_t qf[2][4];  // this warp's 16 q rows x 32 d: two k16 A fragments
  float o[4][4];      // 16 rows x 32 d: four n8 fragments
#pragma unroll
  for (int j = 0; j < 4; ++j)
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
      for (int kk = 0; kk < 2; ++kk)
        ldm_x4(qf[kk], qs + swz64(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
    }
    const uint32_t ks = ring + (t & 1) * 2 * TILE_B;
    const uint32_t vs = ks + TILE_B;

    // S = q k^T: 16 rows x 64 keys, eight n8 fragments
    float s[8][4];
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jb][e] = 0.f;
      uint32_t b[4];  // keys 8 jb .. 8 jb + 7, d 0..31
      ldm_x4(b, ks + swz64(jb * 8 + (lane & 7), lane >> 3));
      mma16816(s[jb], qf[0], b[0], b[1]);
      mma16816(s[jb], qf[1], b[2], b[3]);
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
    for (int j = 0; j < 4; ++j)
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
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t b[4];
        ldm_x4_trans(b, vs + swz64(kr, 2 * jj + (lane >> 4)));
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
    bf16* orow = out + ((static_cast<size_t>(bi) * n + row) * h + hi) * 32 +
                 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16x2(o[j][2 * r] * inv[r], o[j][2 * r + 1] * inv[r]);
  }
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      int b, int n, int h, long long sb, long long sn,
                      float scale, cudaStream_t stream) {
  // cp.async copies 16-byte chunks: every row must start 16-byte aligned
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
              16 != 0 ||
      sb % 8 != 0 || sn % 8 != 0)
    return cudaErrorInvalidValue;
  dim3 grid((n + TC_ROWS - 1) / TC_ROWS, b * h);
  flash_fwd_tc<<<grid, 32 * TC_WARPS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), n, h, sb, sn,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int prgpt_attention(const void* q, const void* k, const void* v,
                               void* out, int b, int n, int h, int d,
                               long long sb, long long sn, float scale,
                               int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 32) {
    return is_bf16 ? launch_tc(q, k, v, out, b, n, h, sb, sn, scale, s)
                   : launch<float, 32>(q, k, v, out, b, n, h, sb, sn, scale,
                                       s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
