// K5: 3x3 stride-1 SAME convolution, NHWC x HWIO, hand-written for Hopper
// (sm_90a).
//
// Replaces tools/profile_conv.py::_conv3x3_pallas.
//
//   out[b, y, x, o] = sum_{dy, dx, i} x[b, y + dy - 1, x + dx - 1, i]
//                                     * w[dy, dx, i, o]
//
// with zeros outside the image. x (b, h, w, cin), w (3, 3, cin, cout) and
// out (b, h, w, cout) in T (bf16 or fp32); products accumulate in fp32 and
// the output is rounded to T once. Any b, h, w >= 1; cin and cout in
// [1, MAX_C].
//
// Bound on this card, at (16, 256, 256, 64 -> 64) bf16: 77.3 GFLOP of
// products, 78 us at 989 TFLOP/s; x and out are 268 MB, 80 us at
// 3.35 TB/s; at 128 -> 64 and 128 -> 128 the products bound it
// (ops/conv.py::work_conv counts every shape, chip_smoke.py turns that
// into the bound). Either way only the tensor cores can reach it: the
// fp32 rate outside them (67 TFLOP/s) needs 1.15 ms for the 77.3 GFLOP.
//
// Design: the TPU kernel pairs taps along the channel axis (K = 2 cin
// contractions) to fill the MXU's contraction depth; that has no meaning
// here. bf16 runs the tensor-core implicit GEMM of conv3_tc.cuh (shared
// with K6) on tiles of TR (16) output rows x 16 columns x 64 output
// channels: each warp owns 4 whole rows of 16 pixels, so each A fragment
// it loads serves up to three taps, the window's halo is 27% of its
// pixels, and the weights of cin <= 128 stay resident in shared memory.
// The last row tile is masked at h. fp32 has no tensor-core path that keeps its tolerance
// (TF32 keeps about three digits), so it stays a direct conv on the CUDA
// cores: a block owns R x WT output pixels of one image and CT output
// channels; for each stage of KC input channels it stages the halo window
// (zeros outside the image) and the 9 x KC x CT weight slice in shared
// memory, and each thread keeps PX x CO outputs in registers, reading
// PX + 2 inputs once for the three taps of a window row.

#include "common.cuh"
#include "conv3_tc.cuh"

namespace {

using prgpt::from_f;
using prgpt::to_f;

constexpr int R = 4;          // output rows per block
constexpr int WT = 32;        // output columns per block
constexpr int CT = 64;        // output channels per block
constexpr int KC = 16;        // input channels per stage
constexpr int PX = 8;         // pixels per thread (one row)
constexpr int CO = 4;         // output channels per thread
constexpr int THREADS = (R * WT / PX) * (CT / CO);  // 256
constexpr int WIN = (R + 2) * (WT + 2);             // window positions
constexpr int MAX_C = 4096;
constexpr int TR = 16;        // tensor-core path: output rows per tile
static_assert(THREADS == 256, "thread layout");

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_direct(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int h, int wd, int cin, int cout,
               int col_tiles) {
  extern __shared__ float smem[];
  float* xs = smem;             // WIN * KC: [row][col][channel]
  float* ws = xs + WIN * KC;    // 9 * KC * CT: [tap][channel][out channel]

  const int tid = threadIdx.x;
  const int cg = tid % (CT / CO);      // output channels cg * CO ...
  const int pg = tid / (CT / CO);      // pixel group
  const int prow = pg / (WT / PX);     // output row in the tile
  const int pcol = (pg % (WT / PX)) * PX;
  const int y0 = (blockIdx.x / col_tiles) * R;
  const int x0 = (blockIdx.x % col_tiles) * WT;
  const int o0 = blockIdx.y * CT;
  const int bi = blockIdx.z;
  const T* xb = x + static_cast<size_t>(bi) * h * wd * cin;

  float acc[PX][CO];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int j = 0; j < CO; ++j) acc[p][j] = 0.f;

  for (int k0 = 0; k0 < cin; k0 += KC) {
    __syncthreads();
    for (int i = tid; i < WIN * KC; i += THREADS) {
      const int k = i % KC;
      const int pos = i / KC;
      const int gy = y0 - 1 + pos / (WT + 2);
      const int gx = x0 - 1 + pos % (WT + 2);
      const int ch = k0 + k;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < wd && ch < cin;
      xs[i] = in ? to_f(xb[(static_cast<size_t>(gy) * wd + gx) * cin + ch])
                 : 0.f;
    }
    for (int i = tid; i < 9 * KC * CT; i += THREADS) {
      const int o = i % CT;
      const int k = (i / CT) % KC;
      const int tap = i / (CT * KC);
      const bool in = k0 + k < cin && o0 + o < cout;
      ws[i] = in ? to_f(w[(static_cast<size_t>(tap) * cin + k0 + k) * cout +
                          o0 + o])
                 : 0.f;
    }
    __syncthreads();

    const int kn = min(KC, cin - k0);
    for (int dy = 0; dy < 3; ++dy) {
      for (int k = 0; k < kn; ++k) {
        const float* xr = xs + ((prow + dy) * (WT + 2) + pcol) * KC + k;
        float xv[PX + 2];
#pragma unroll
        for (int p = 0; p < PX + 2; ++p) xv[p] = xr[p * KC];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wv = *reinterpret_cast<const float4*>(
              ws + ((dy * 3 + dx) * KC + k) * CT + cg * CO);
#pragma unroll
          for (int p = 0; p < PX; ++p) {
            acc[p][0] = fmaf(xv[p + dx], wv.x, acc[p][0]);
            acc[p][1] = fmaf(xv[p + dx], wv.y, acc[p][1]);
            acc[p][2] = fmaf(xv[p + dx], wv.z, acc[p][2]);
            acc[p][3] = fmaf(xv[p + dx], wv.w, acc[p][3]);
          }
        }
      }
    }
  }

  const int y = y0 + prow;
  if (y >= h) return;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int gx = x0 + pcol + p;
    if (gx >= wd) break;
    T* orow = out + ((static_cast<size_t>(bi) * h + y) * wd + gx) * cout;
#pragma unroll
    for (int j = 0; j < CO; ++j) {
      const int o = o0 + cg * CO + j;
      if (o < cout) orow[o] = from_f<T>(acc[p][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int b, int h,
                   int wd, int cin, int cout, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (WIN * KC + 9 * KC * CT);
  cudaError_t err = prgpt::allow_smem(conv3x3_direct<T>, smem);
  if (err != cudaSuccess) return err;
  const int col_tiles = (wd + WT - 1) / WT;
  const int row_tiles = (h + R - 1) / R;
  conv3x3_direct<T><<<dim3(col_tiles * row_tiles, (cout + CT - 1) / CT, b),
                      THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), h, wd, cin, cout, col_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Widest cin and cout the kernel takes.
int prgpt_conv3x3_max_c() { return MAX_C; }

int prgpt_conv3x3(const void* x, const void* w, void* out, int b, int h,
                  int wd, int cin, int cout, int is_bf16, int sms,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return prgpt::conv3::launch<16>(x, w, out, b, h, wd, cin, cout, TR, sms,
                                    s);
  return launch<float>(x, w, out, b, h, wd, cin, cout, s);
}

}  // extern "C"
