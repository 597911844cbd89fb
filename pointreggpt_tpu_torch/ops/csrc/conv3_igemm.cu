// K6: 3x3 stride-1 SAME convolution as an implicit GEMM on the tensor
// cores, hand-written for Hopper (sm_90a).
//
// Replaces tools/profile_conv_igemm.py::conv3_igemm.
//
//   out (pixels x cout) = A (pixels x 9 cin) @ B (9 cin x cout)
//   A[(y, x), (tap, i)] = x[y + dy - 1, x + dx - 1, i], tap = 3 dy + dx
//   B = w.reshape(9 cin, cout)       (tap-major, (dy, dx) row-major, then cin)
//
// x (b, h, w, cin), B and out (b, h, w, cout) in bf16; products exact in
// the tensor cores' fp32 accumulators, the output rounded to bf16 once.
// There is no fp32 version: the JAX tool runs bf16 only. h is a multiple
// of the row block `rows` (1 .. MAX_ROWS); any w, cin, cout >= 1.
//
// Bound on this card, at (16, 256, 256, 64 -> 64) bf16: 77.3 GFLOP, 78 us
// at 989 TFLOP/s; x and out 268 MB, 80 us at 3.35 TB/s
// (ops/conv.py::work_conv).
//
// Design: as on the TPU, the im2col tile A is never written to device
// memory. A block owns `rows` output rows x WT (16) columns of one image
// and NT (64) output channels: one warp per output row, whose 16 pixels
// are the 16 rows of an A fragment. For each stage of KC input channels
// the block stages the (rows + 2) x (WT + 2) halo window of x (zeros
// outside the image) and the 9 x KC x NT slice of B in shared memory;
// then for each tap and each 16-channel slice a warp loads its A fragment
// straight from the window (a row stride of KC elements: pixel p of tap
// (dy, dx) is window position (row + dy, p + dx)), so the gather is
// free, and issues one 16x16x16 bf16 mma (WMMA, fp32 accumulators) per
// 16 output channels. The epilogue goes through shared memory to round
// and mask the store. TMA, wgmma and a multi-stage pipeline are later
// work.

#include "common.cuh"

#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int WT = 16;        // output columns per block: one A fragment
constexpr int NT = 64;        // output channels per block
constexpr int KC = 32;        // input channels per stage
constexpr int NF = NT / 16;   // accumulator fragments per warp
constexpr int MAX_ROWS = 16;  // row block: one warp per row

__host__ __device__ inline size_t window_elems(int rows) {
  return static_cast<size_t>(rows + 2) * (WT + 2) * KC;
}

inline size_t smem_bytes(int rows) {
  return sizeof(bf16) * (window_elems(rows) + 9 * KC * NT) +
         sizeof(float) * rows * 16 * 16;
}

__global__ void conv3_igemm_kernel(const bf16* __restrict__ x,
                                   const bf16* __restrict__ wmat,
                                   bf16* __restrict__ out, int h, int wd,
                                   int cin, int cout, int rows,
                                   int col_tiles) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [row][col][channel]
  bf16* ws = xs + window_elems(rows);             // [tap][channel][out]
  float* stage = reinterpret_cast<float*>(ws + 9 * KC * NT);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int y0 = (blockIdx.x / col_tiles) * rows;
  const int x0 = (blockIdx.x % col_tiles) * WT;
  const int n0 = blockIdx.y * NT;
  const int bi = blockIdx.z;
  const bf16* xb = x + static_cast<size_t>(bi) * h * wd * cin;
  const bf16 zero = __float2bfloat16_rn(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int k0 = 0; k0 < cin; k0 += KC) {
    __syncthreads();
    const int win = static_cast<int>(window_elems(rows));
    for (int i = tid; i < win; i += nthreads) {
      const int k = i % KC;
      const int pos = i / KC;
      const int gy = y0 - 1 + pos / (WT + 2);
      const int gx = x0 - 1 + pos % (WT + 2);
      const int ch = k0 + k;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < wd && ch < cin;
      xs[i] = in ? xb[(static_cast<size_t>(gy) * wd + gx) * cin + ch] : zero;
    }
    for (int i = tid; i < 9 * KC * NT; i += nthreads) {
      const int n = i % NT;
      const int k = (i / NT) % KC;
      const int tap = i / (NT * KC);
      const bool in = k0 + k < cin && n0 + n < cout;
      ws[i] = in ? wmat[(static_cast<size_t>(tap) * cin + k0 + k) * cout +
                        n0 + n]
                 : zero;
    }
    __syncthreads();

    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(
            a, xs + ((warp + dy) * (WT + 2) + dx) * KC + kk, KC);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              bm;
          wmma::load_matrix_sync(bm, ws + (tap * KC + kk) * NT + f * 16, NT);
          wmma::mma_sync(acc[f], a, bm, acc[f]);
        }
      }
    }
  }

  // epilogue: one 16x16 fragment at a time through this warp's stage
  float* st = stage + warp * 256;
  const size_t orow = (static_cast<size_t>(bi) * h + y0 + warp) * wd;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    wmma::store_matrix_sync(st, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int p = i / 16;
      const int n = n0 + f * 16 + i % 16;
      if (x0 + p < wd && n < cout)
        out[(orow + x0 + p) * cout + n] = __float2bfloat16_rn(st[i]);
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Largest row block the kernel takes (one warp per output row).
int prgpt_conv3_igemm_max_rows() { return MAX_ROWS; }

int prgpt_conv3_igemm(const void* x, const void* wmat, void* out, int b,
                      int h, int wd, int cin, int cout, int rows,
                      void* stream) {
  if (rows < 1 || rows > MAX_ROWS || h % rows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(rows);
  cudaError_t err = prgpt::allow_smem(conv3_igemm_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int col_tiles = (wd + WT - 1) / WT;
  conv3_igemm_kernel<<<dim3(col_tiles * (h / rows), (cout + NT - 1) / NT, b),
                       32 * rows, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wmat),
      static_cast<bf16*>(out), h, wd, cin, cout, rows, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
