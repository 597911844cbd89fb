// K4: the LinearAttention core on packed qkv, hand-written for Hopper
// (sm_90a).
//
// Replaces pointreggpt_tpu/ops/linear_attention.py::_pallas_core.
//
//   q, k, v = qkv[:, :128], qkv[:, 128:256], qkv[:, 256:384]  (head-major)
//   C    = sum_n exp(k - m)^T v   (online softmax of k over n per lane)
//   C^   = blockdiag_heads(C / max(s, 1e-30)) * 32^-1/2 / n
//   out  = softmax_per_head(q) C^                          (b, n, 128)
//
// qkv (b, n, 384) and out in T (bf16 or fp32), qkv 16-byte aligned; any
// n >= 1. heads = 4, dim_head = 32 (hidden = 128) are compile-time
// constants.
//
// Bound on this card, at (8, 65536, 384) bf16: the function must read qkv
// once and write out once, 537 MB, 0.160 ms at 3.35 TB/s; its products
// (two context products on the four 32x32 head blocks, 2 * 2 * 4096 per
// row) are 4.3 GFLOP, 4 us at 989 TFLOP/s: it is bound by bytes
// (ops/linear_attention.py::work_core counts every shape, chip_smoke.py
// turns that into the bound). So the design is about the bytes in flight
// (about 20 KB per SM at 3.35 TB/s and ~0.8 us of latency) and about
// keeping the products off shared memory and the CUDA cores. Each byte of
// qkv is read once: k and v in launch A, q in launch C.
//
// The TPU kernel walks n sequentially per batch row, phase 0 over k and v
// with (m, s, C) in VMEM, phase 1 over q. C^ needs all of n before any q
// row, so the phases stay apart; blocks here carry nothing, so one call is
// three launches:
//   A  core_kv<B>     grid (splits, b): one split's 64-row tiles of k|v,
//                     staged by 16-byte cp.async in a ring of KV_STAGES;
//                     per tile the column max over all 256 threads (each
//                     a 16-byte chunk of k on a few rows, reduced by warp
//                     shuffles), exp(k - m) rounded to T written over k
//                     in the stage, and C_h = alpha C_h + ek_h^T v_h for
//                     the four head blocks on the tensor cores; writes
//                     the (m, s, C) partials in K1's scratch layout.
//   B  core_merge<T>  grid (16, b): merge_context_body (linear_attention_
//                     kv.cuh), one thread per entry of C^, shared with K1
//                     and K3. Folding it into A's last block per batch row
//                     would save a launch of a few microseconds; K1 and K3
//                     keep the separate merge, so K4 does too.
//   C  core_emit<B>   persistent grid: the batch row's C^ resident in
//                     shared memory; 64 x 128 q tiles by 16-byte cp.async
//                     in a ring of Q_STAGES; each warp's 16 rows x two
//                     heads as A fragments straight from the stage, the
//                     per-head softmax on them (quad shuffles), q C^_h on
//                     the tensor cores, the output rounded into the
//                     warp's own region of the stage and written out in
//                     16-byte stores.
// One skeleton (the tile walk, the ring, the softmaxes, the launch sizing)
// over two bodies that give the staging layout and the products: Bf16
// (mma.sync.m16n8k16, ldmatrix) and Tf32 (three TF32 passes of
// mma.sync.m16n8k8 on split operands, common.cuh, with one fp32 add per
// 32-deep k range: a long sum in one fragment drifts).
//
// Rounding follows the plain PyTorch version (the port of _xla_core,
// ops/linear_attention.py::linear_attention_core_plain): exp(k - m), C^,
// the softmaxed q and the output are rounded to T. exp(k - m) is taken
// against the running max of the split at its tile, rescaled by alpha as
// the max grows, where the plain version takes the global max.

#include "linear_attention_kv.cuh"
#include "linear_attention_tc.cuh"
#include "linear_attention_tf32.cuh"

#include <mutex>

namespace {

using namespace prgpt;
using namespace prgpt::la;
using bf16 = __nv_bfloat16;

constexpr int TM = 64;   // rows per tile
constexpr int NT = 256;  // 8 warps

// bf16: k|v rows of 512 bytes and q rows of 256 bytes, 16-byte chunk j of
// row r at j ^ (r & 7) (tc::swz), read by ldmatrix.
struct Bf16 {
  using T = bf16;
  static constexpr int KV_STAGES = 3;  // 3 x 32 KB: two blocks an SM
  static constexpr int Q_STAGES = 4;   // 4 x 16 KB
  static constexpr int A_BLOCKS = 2, C_BLOCKS = 2;
  static constexpr int NB = 4;  // k16 blocks of a warp's two heads of q

  static __device__ __forceinline__ uint32_t kv_chunk(int r, int j) {
    return tc::swz(r, j, 2 * HID * 2);
  }
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&v)[8]) {
    const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int l = 0; l < 8; ++l) v[l] = __bfloat162float(h[l]);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[8]) {
    return make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                      pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  }

  // the tile's ek_h^T v_h for C rows d0 .. d0 + 16 of head hh (all 32 e)
  static __device__ __forceinline__ void kv_products(
      float (&t)[4][4], const unsigned char* stp, int hh, int d0, int lane) {
    const uint32_t st = smem_u32(stp);
#pragma unroll
    for (int kk = 0; kk < TM / 16; ++kk) {
      uint32_t a[4];
      tc::lda_t(a, st, kk * 16, d0, 2 * HID * 2, lane);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t b[4];
        tc::ldb(b, st + HID * 2, kk * 16, hh * DH + jj * 16, 2 * HID * 2,
                lane);
        mma16816(t[2 * jj], a, b[0], b[1]);
        mma16816(t[2 * jj + 1], a, b[2], b[3]);
      }
    }
  }

  // q of rows row0 .. row0 + 16, columns 64 qh .. + 64, as A fragments:
  // x[8 kb + 2 i + u] is register i, half u of k16 block kb: row g + 8 (i
  // & 1) (row_half), column 64 qh + 16 kb + 2 t4 + 8 (i >> 1) + u
  static __device__ __forceinline__ int row_half(int v) { return (v >> 1) & 1; }
  static __device__ __forceinline__ void load_q(float (&x)[32],
                                                const unsigned char* st,
                                                int row0, int qh, int lane) {
#pragma unroll
    for (int kb = 0; kb < NB; ++kb) {
      uint32_t a[4];
      tc::lda(a, smem_u32(st), row0, qh * NB + kb, HID * 2, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&a[i]);
        x[8 * kb + 2 * i] = __low2float(p);
        x[8 * kb + 2 * i + 1] = __high2float(p);
      }
    }
  }

  // o[hh] = softmax(q)_h C^_h, h = 2 qh + hh: the softmax rounded to
  // bf16 as A operands as it lies, C^ rows d as B
  static __device__ __forceinline__ void context(float (&o)[2][4][4],
                                                 const float (&x)[32],
                                                 const unsigned char* chp,
                                                 int qh, int lane) {
    const uint32_t ch = smem_u32(chp);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int kd = 0; kd < 2; ++kd) {
        const float* xb = x + 8 * (2 * hh + kd);
        const uint32_t a[4] = {pack_bf16x2(xb[0], xb[1]),
                               pack_bf16x2(xb[2], xb[3]),
                               pack_bf16x2(xb[4], xb[5]),
                               pack_bf16x2(xb[6], xb[7])};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t bc[4];
          tc::ldb(bc, ch, kd * 16, (2 * qh + hh) * DH + jj * 16, HID * 2,
                  lane);
          mma16816(o[hh][2 * jj], a, bc[0], bc[1]);
          mma16816(o[hh][2 * jj + 1], a, bc[2], bc[3]);
        }
      }
  }

  // C^ entry (d, col), col = head * 32 + e, into the resident rows of C^
  static __device__ __forceinline__ void put_chat(unsigned char* ch, int d,
                                                  int col, float v) {
    *reinterpret_cast<bf16*>(ch + tc::el(d, col, HID * 2)) =
        __float2bfloat16_rn(v);
  }

  // the output pair (r, col), (r, col + 1), rounded, into the q stage
  static __device__ __forceinline__ void put_out(unsigned char* st, int r,
                                                 int col, float a, float b) {
    *reinterpret_cast<uint32_t*>(st + tc::el(r, col, HID * 2)) =
        pack_bf16x2(a, b);
  }
};

// fp32: k|v rows of 1 KB read as (row t, column g) by 32-bit loads, so
// 32-byte group j of row r sits at j ^ (r & 3) (tf32x3::elt); q rows of
// 512 bytes read by ldmatrix, 16-byte chunk j at j ^ (r & 7); C^ as elt.
struct Tf32 {
  using T = float;
  static constexpr int KV_STAGES = 3;  // 3 x 64 KB: one block an SM
  static constexpr int Q_STAGES = 3;   // 3 x 32 KB: two blocks an SM
  static constexpr int A_BLOCKS = 1, C_BLOCKS = 2;
  static constexpr int NB = 8;  // k8 blocks of a warp's two heads of q

  static __device__ __forceinline__ uint32_t kv_chunk(int r, int j) {
    return tf32x3::elt(r, 4 * j, 2 * HID * 4);
  }
  static __device__ __forceinline__ void unpack(const uint4& u,
                                                float (&v)[4]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }

  // the tile's ek_h^T v_h for C rows d0 .. d0 + 16 of head hh, each
  // 32-row range in fragments of its own, added in fp32
  static __device__ __forceinline__ void kv_products(
      float (&t)[4][4], const unsigned char* st, int hh, int d0, int lane) {
    const int g = lane >> 2, t4 = lane & 3;
    constexpr int RB = 2 * HID * 4;
#pragma unroll
    for (int r32 = 0; r32 < TM; r32 += 32) {
      float p[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // A = ek_h^T: (d, row) elements, rows r and r + 4
        const int r = r32 + kk * 8 + t4;
        uint32_t ah[4] = {tf32x3::lds(st + tf32x3::elt(r, d0 + g, RB)),
                          tf32x3::lds(st + tf32x3::elt(r, d0 + g + 8, RB)),
                          tf32x3::lds(st + tf32x3::elt(r + 4, d0 + g, RB)),
                          tf32x3::lds(st + tf32x3::elt(r + 4, d0 + g + 8, RB))};
        uint32_t al[4];
        split_frag(ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = HID + hh * DH + j * 8 + g;
          uint32_t bh[2] = {tf32x3::lds(st + tf32x3::elt(r, col, RB)),
                            tf32x3::lds(st + tf32x3::elt(r + 4, col, RB))};
          uint32_t bl[2];
          split_frag(bh, bl);
          mma_3xtf32(p[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[j][e] += p[j][e];
    }
  }

  // q of rows row0 .. row0 + 16, columns 64 qh .. + 64, as tf32 A
  // fragments by ldmatrix (a b16 pair is one fp32 element): x[4 kb + i] is
  // row g + 8 (i & 1), column 64 qh + 8 kb + t4 + 4 (i >> 1)
  static __device__ __forceinline__ int row_half(int v) { return v & 1; }
  static __device__ __forceinline__ void load_q(float (&x)[32],
                                                const unsigned char* st,
                                                int row0, int qh, int lane) {
#pragma unroll
    for (int kb = 0; kb < NB; ++kb) {
      uint32_t a[4];
      ldm_x4(a, smem_u32(st) + tf32x3::swz(row0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                 2 * (qh * NB + kb) + (lane >> 4), HID * 4));
#pragma unroll
      for (int i = 0; i < 4; ++i) x[4 * kb + i] = __uint_as_float(a[i]);
    }
  }

  // o[hh] = softmax(q)_h C^_h, h = 2 qh + hh, in three TF32 passes: the
  // softmax fragments are the A operands as they lie (k index t4 and t4 + 4
  // of each 8-deep step), C^ rows d as B; the 32-deep sum in one fragment
  static __device__ __forceinline__ void context(float (&o)[2][4][4],
                                                 const float (&x)[32],
                                                 const unsigned char* ch,
                                                 int qh, int lane) {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int kd = 0; kd < 4; ++kd) {
        const float* xb = x + 4 * (4 * hh + kd);
        uint32_t ah[4] = {__float_as_uint(xb[0]), __float_as_uint(xb[1]),
                          __float_as_uint(xb[2]), __float_as_uint(xb[3])};
        uint32_t al[4];
        split_frag(ah, al);
        const int d = kd * 8 + t4;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int col = (2 * qh + hh) * DH + jj * 8 + g;
          uint32_t bh[2] = {tf32x3::lds(ch + tf32x3::elt(d, col, HID * 4)),
                            tf32x3::lds(ch + tf32x3::elt(d + 4, col, HID * 4))};
          uint32_t bl[2];
          split_frag(bh, bl);
          mma_3xtf32(o[hh][jj], ah, al, bh, bl);
        }
      }
  }

  static __device__ __forceinline__ void put_chat(unsigned char* ch, int d,
                                                  int col, float v) {
    *reinterpret_cast<float*>(ch + tf32x3::elt(d, col, HID * 4)) = v;
  }

  static __device__ __forceinline__ void put_out(unsigned char* st, int r,
                                                 int col, float a, float b) {
    *reinterpret_cast<float2*>(st + tf32x3::el(r, col, HID * 4)) =
        make_float2(a, b);
  }
};

// Shared-memory bytes of the two walks: KV_STAGES tiles of k|v and the
// tile's rescale; Q_STAGES tiles of q and C^.
template <class B>
constexpr size_t kv_smem() {
  return static_cast<size_t>(B::KV_STAGES) * TM * 2 * HID *
             sizeof(typename B::T) + HID * sizeof(float);
}

template <class B>
constexpr size_t emit_smem() {
  return static_cast<size_t>(B::Q_STAGES * TM + DH) * HID *
         sizeof(typename B::T);
}

// A ring of S stages of `bytes` each: item i sits in stage i % S. A walk
// loads S - 1 items ahead; at item i, after cp_wait<S - 2> and a barrier,
// it refills the stage of item i - 1, which every warp is done with.
template <int S>
struct Ring {
  int bytes;
  __device__ __forceinline__ int stage(int i) const { return (i % S) * bytes; }
};

// Kernel A over grid (splits, b): the (m, s, C) partials of split
// blockIdx.x of batch row blockIdx.y, as K1's kernel A writes them.
template <class B>
__global__ void __launch_bounds__(NT, B::A_BLOCKS)
core_kv(const typename B::T* __restrict__ qkv, float* __restrict__ part,
        int n, int rows_per_split, int splits) {
  using T = typename B::T;
  constexpr int S = B::KV_STAGES;
  constexpr int LPC = 16 / sizeof(T);  // lanes of a 16-byte chunk
  constexpr int CPR = 2 * HID / LPC;   // chunks of a k|v row
  constexpr int KCH = HID / LPC;       // chunks of k
  constexpr int RG = NT / KCH;         // row groups of the max / exp pass
  extern __shared__ __align__(128) unsigned char k4_smem[];
  const Ring<S> ring{TM * 2 * HID * static_cast<int>(sizeof(T))};
  float* al_s = reinterpret_cast<float*>(k4_smem + S * ring.bytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int hh = warp >> 1, d0 = hh * DH + (warp & 1) * 16;  // C rows
  const int jc = tid / RG, rg = tid % RG;  // k lanes LPC jc .., rows rg + RG t
  const int split = blockIdx.x, bi = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);
  const int L = (r_end - r_begin + TM - 1) / TM;
  const T* src = qkv + static_cast<size_t>(bi) * n * QKV + HID;  // k|v

  // rows r_begin + TM i .. (zeros from r_end) of k|v into item i's stage
  auto load = [&](int i) {
    if (i < L) {
      const uint32_t dst = smem_u32(k4_smem + ring.stage(i));
      const int r0 = r_begin + i * TM;
      for (int c = tid; c < TM * CPR; c += NT) {
        const int r = c / CPR, j = c % CPR;
        const bool in = r0 + r < r_end;
        cp16(dst + B::kv_chunk(r, j),
             in ? src + static_cast<size_t>(r0 + r) * QKV + j * LPC : src,
             in);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) load(i);

  float mrun[LPC], srun[LPC];  // running max and sum of lanes LPC jc ..
#pragma unroll
  for (int l = 0; l < LPC; ++l) {
    mrun[l] = -INFINITY;
    srun[l] = 0.f;
  }
  float cacc[4][4];  // C rows d0 + g (+ 8), columns 8 j + 2 t4 (+ 1)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cacc[j][e] = 0.f;

  for (int i = 0; i < L; ++i) {
    cp_wait<S - 2>();
    __syncthreads();
    load(i + S - 1);
    unsigned char* st = k4_smem + ring.stage(i);
    const int rows = min(TM, r_end - (r_begin + i * TM));

    // the column max of k over the tile's rows (rows past it masked), the
    // running max, and exp(k - m) rounded to T over k in the stage
    float kx[TM / RG][LPC], tmax[LPC];
#pragma unroll
    for (int l = 0; l < LPC; ++l) tmax[l] = -INFINITY;
#pragma unroll
    for (int t = 0; t < TM / RG; ++t) {
      const int r = rg + RG * t;
      B::unpack(*reinterpret_cast<const uint4*>(st + B::kv_chunk(r, jc)),
                kx[t]);
#pragma unroll
      for (int l = 0; l < LPC; ++l) {
        if (r >= rows) kx[t][l] = -INFINITY;
        tmax[l] = fmaxf(tmax[l], kx[t][l]);
      }
    }
    float al[LPC];
#pragma unroll
    for (int l = 0; l < LPC; ++l) {
#pragma unroll
      for (int o = 1; o < RG; o <<= 1)
        tmax[l] = fmaxf(tmax[l], __shfl_xor_sync(0xffffffffu, tmax[l], o));
      const float m_new = fmaxf(mrun[l], tmax[l]);
      al[l] = expf(mrun[l] - m_new);
      mrun[l] = m_new;
      srun[l] *= al[l];
    }
#pragma unroll
    for (int t = 0; t < TM / RG; ++t) {
#pragma unroll
      for (int l = 0; l < LPC; ++l) {
        const float e = expf(kx[t][l] - mrun[l]);
        srun[l] += e;
        kx[t][l] = e;
      }
      *reinterpret_cast<uint4*>(st + B::kv_chunk(rg + RG * t, jc)) =
          B::pack(kx[t]);
    }
    if (rg == 0)
#pragma unroll
      for (int l = 0; l < LPC; ++l) al_s[LPC * jc + l] = al[l];
    __syncthreads();

    // C_h = alpha C_h + ek_h^T v_h, the tile's products summed apart
    float tile[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tile[j][e] = 0.f;
    B::kv_products(tile, st, hh, d0, lane);
    const float al_lo = al_s[d0 + g], al_hi = al_s[d0 + g + 8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cacc[j][e] = fmaf(cacc[j][e], e < 2 ? al_lo : al_hi, tile[j][e]);
  }
  cp_wait<0>();

  float* po = part + (static_cast<size_t>(bi) * splits + split) * PSTRIDE;
#pragma unroll
  for (int l = 0; l < LPC; ++l) {
#pragma unroll
    for (int o = 1; o < RG; o <<= 1)
      srun[l] += __shfl_xor_sync(0xffffffffu, srun[l], o);
    if (rg == 0) {
      po[LPC * jc + l] = mrun[l];
      po[HID + LPC * jc + l] = srun[l];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(po + 2 * HID + hh * DH * DH +
                                 (d0 - hh * DH + g + 8 * h) * DH + j * 8 +
                                 2 * t4) =
          make_float2(cacc[j][2 * h], cacc[j][2 * h + 1]);
}

// Kernel B over grid (CBLK / NT, b): C^ of batch row blockIdx.y, rounded
// to T.
template <typename T>
__global__ void __launch_bounds__(NT)
core_merge(const float* __restrict__ part, float* __restrict__ chat,
           int splits, float scale) {
  merge_context_body<T>(part, chat, nullptr, splits, scale);
}

// Kernel C over a persistent grid: block blockIdx.x takes the
// ceil(tiles / gridDim.x) consecutive tiles from blockIdx.x times that of
// the b x ceil(n / TM) row tiles (batch row major), so that its batch row,
// and with it the C^ it stages, changes at most a few times.
template <class B>
__global__ void __launch_bounds__(NT, B::C_BLOCKS)
core_emit(const typename B::T* __restrict__ qkv,
          const float* __restrict__ chat, typename B::T* __restrict__ out,
          int b, int n) {
  using T = typename B::T;
  constexpr int S = B::Q_STAGES, NB = B::NB, VPB = 32 / NB;
  constexpr int LPC = 16 / sizeof(T);     // lanes of a 16-byte chunk
  constexpr int QROW = HID * sizeof(T);   // bytes of a staged row of q
  constexpr int QCH = QROW / 16;          // chunks of a row of q
  constexpr int WCH = QCH / 2;            // chunks of a warp's two heads
  extern __shared__ __align__(128) unsigned char k4_smem[];
  const Ring<S> ring{TM * QROW};
  unsigned char* ch_s = k4_smem + S * ring.bytes;  // C^ as DH x (head, e)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int qm = warp & 3, qh = warp >> 2;  // 16 rows x heads 2qh, 2qh+1
  const int row_tiles = (n + TM - 1) / TM;
  const int tiles = b * row_tiles;
  const int per = (tiles + gridDim.x - 1) / gridDim.x;
  const int t0 = blockIdx.x * per;
  const int L = max(0, min(tiles, t0 + per) - t0);

  // rows r0 .. r0 + TM of q (zeros from n) of tile t0 + i into its stage
  auto load = [&](int i) {
    if (i < L) {
      const int tt = t0 + i;
      const int r0 = (tt % row_tiles) * TM;
      const T* src =
          qkv + (static_cast<size_t>(tt / row_tiles) * n + r0) * QKV;
      const uint32_t dst = smem_u32(k4_smem + ring.stage(i));
      for (int c = tid; c < TM * QCH; c += NT) {
        const int r = c / QCH, j = c % QCH;
        const bool in = r0 + r < n;
        cp16(dst + tc::swz(r, j, QROW),
             in ? src + static_cast<size_t>(r) * QKV + j * LPC : src, in);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) load(i);

  int cur_b = -1;
  for (int i = 0; i < L; ++i) {
    cp_wait<S - 2>();
    __syncthreads();
    load(i + S - 1);
    const int tt = t0 + i;
    const int bi = tt / row_tiles, r0 = (tt % row_tiles) * TM;
    if (bi != cur_b) {  // C^ of batch row bi (kernel B rounded it to T)
      const float* chat_b = chat + static_cast<size_t>(bi) * CBLK;
      for (int idx = tid; idx < CBLK; idx += NT) {
        const float cv = chat_b[idx];
        B::put_chat(ch_s, (idx / DH) % DH, (idx / (DH * DH)) * DH + idx % DH,
                    cv);
      }
      __syncthreads();
      cur_b = bi;
    }
    unsigned char* st = k4_smem + ring.stage(i);

    // the softmax over each head's 32 columns of the warp's 16 rows: a
    // row's values of a head lie in its quad's four lanes
    float x[32];
    B::load_q(x, st, qm * 16, qh, lane);
    float mx[2][2], inv[2][2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int b0 = hh * (NB / 2), b1 = b0 + NB / 2;
      float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int kb = b0; kb < b1; ++kb)
#pragma unroll
        for (int v = 0; v < VPB; ++v)
          m[B::row_half(v)] = fmaxf(m[B::row_half(v)], x[kb * VPB + v]);
      mx[hh][0] = tc::quad_max(m[0]);
      mx[hh][1] = tc::quad_max(m[1]);
    }
#pragma unroll
    for (int kb = 0; kb < NB; ++kb)
#pragma unroll
      for (int v = 0; v < VPB; ++v)
        x[kb * VPB + v] =
            expf(x[kb * VPB + v] - mx[kb / (NB / 2)][B::row_half(v)]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int b0 = hh * (NB / 2), b1 = b0 + NB / 2;
      float sm[2] = {0.f, 0.f};
#pragma unroll
      for (int kb = b0; kb < b1; ++kb)
#pragma unroll
        for (int v = 0; v < VPB; ++v) sm[B::row_half(v)] += x[kb * VPB + v];
      inv[hh][0] = 1.f / tc::quad_sum(sm[0]);
      inv[hh][1] = 1.f / tc::quad_sum(sm[1]);
    }
#pragma unroll
    for (int kb = 0; kb < NB; ++kb)
#pragma unroll
      for (int v = 0; v < VPB; ++v)
        x[kb * VPB + v] *= inv[kb / (NB / 2)][B::row_half(v)];

    // out = softmax(q)_h C^_h (the softmax rounded to T as the body packs
    // it), rounded to T into the warp's own rows and columns of the stage
    // (read above), then 16 bytes a lane to out
    float o[2][4][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[hh][j][e] = 0.f;
    B::context(o, x, ch_s, qh, lane);
    __syncwarp();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          B::put_out(st, qm * 16 + g + 8 * h,
                     (2 * qh + hh) * DH + j * 8 + 2 * t4, o[hh][j][2 * h],
                     o[hh][j][2 * h + 1]);
    __syncwarp();
    T* ob = out + (static_cast<size_t>(bi) * n + r0) * HID;
#pragma unroll
    for (int c = lane; c < 16 * WCH; c += 32) {
      const int r = qm * 16 + c / WCH, j = qh * WCH + c % WCH;
      if (r0 + r < n)
        *reinterpret_cast<uint4*>(ob + static_cast<size_t>(r) * HID +
                                  j * LPC) =
            *reinterpret_cast<const uint4*>(st + tc::swz(r, j, QROW));
    }
  }
  cp_wait<0>();
}

// Blocks of kernels A and C the card holds at once, per device and body
// (0: bf16, 1: fp32), looked up once; raises the shared-memory caps on
// the way. Guarded by slots_lock.
struct Slots {
  int a = 0, c = 0;
};
std::mutex slots_lock;

template <class B>
cudaError_t lookup(Slots& k) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(core_kv<B>, kv_smem<B>())) != cudaSuccess ||
      (err = allow_smem(core_emit<B>, emit_smem<B>())) != cudaSuccess)
    return err;
  int per_a = 0, per_c = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_a, core_kv<B>, NT,
                                                      kv_smem<B>());
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_c, core_emit<B>,
                                                      NT, emit_smem<B>());
  if (err != cudaSuccess) return err;
  k.a = sms * (per_a > 0 ? per_a : 1);
  k.c = sms * (per_c > 0 ? per_c : 1);
  return cudaSuccess;
}

cudaError_t card_slots(int is_bf16, Slots* out) {
  static Slots slots[2][64];
  std::lock_guard<std::mutex> guard(slots_lock);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  Slots& k = slots[is_bf16 ? 0 : 1][dev];
  if (k.a == 0) {
    err = is_bf16 ? lookup<Bf16>(k) : lookup<Tf32>(k);
    if (err != cudaSuccess) {
      k = Slots{};
      return err;
    }
  }
  *out = k;
  return cudaSuccess;
}

template <class B>
cudaError_t launch(const void* qkv_, void* out_, float* part, float* chat,
                   int b, int n, int splits, int rows_per_split,
                   cudaStream_t stream) {
  using T = typename B::T;
  if ((reinterpret_cast<uintptr_t>(qkv_) | reinterpret_cast<uintptr_t>(out_)) %
          16 != 0)
    return cudaErrorInvalidValue;
  Slots k;
  cudaError_t err = card_slots(sizeof(T) == 2, &k);
  if (err != cudaSuccess) return err;
  const T* qkv = static_cast<const T*>(qkv_);

  core_kv<B><<<dim3(splits, b), NT, kv_smem<B>(), stream>>>(
      qkv, part, n, rows_per_split, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const float scale = rsqrtf(static_cast<float>(DH)) / static_cast<float>(n);
  core_merge<T><<<dim3(CBLK / NT, b), NT, 0, stream>>>(part, chat, splits,
                                                       scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // persistent grid: as few blocks as take every tile in equal runs
  const int tiles = b * ((n + TM - 1) / TM);
  const int per = (tiles + k.c - 1) / k.c;
  core_emit<B><<<(tiles + per - 1) / per, NT, emit_smem<B>(), stream>>>(
      qkv, chat, static_cast<T*>(out_), b, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per tile: the wrapper sizes its splits in whole tiles.
int prgpt_linear_attention_core_rows_per_tile() { return TM; }

// Blocks of kernel A the card holds at once for the dtype, into *slots:
// the wrapper gives each batch row slots / b splits, so that kernel A
// runs in one wave.
int prgpt_linear_attention_core_kv_slots(int is_bf16, int* slots) {
  Slots k;
  const cudaError_t err = card_slots(is_bf16, &k);
  if (err == cudaSuccess) *slots = k.a;
  return err;
}

// Scratch floats the wrapper must allocate for (b, splits).
long long prgpt_linear_attention_core_scratch(int b, int splits) {
  return static_cast<long long>(b) * splits * PSTRIDE +
         static_cast<long long>(b) * CBLK;
}

int prgpt_linear_attention_core(const void* qkv, void* out, float* scratch,
                                int b, int n, int splits, int rows_per_split,
                                int is_bf16, void* stream) {
  float* part = scratch;
  float* chat = scratch + static_cast<size_t>(b) * splits * PSTRIDE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<Bf16>(qkv, out, part, chat, b, n, splits, rows_per_split,
                        s);
  return launch<Tf32>(qkv, out, part, chat, b, n, splits, rows_per_split, s);
}

}  // extern "C"
