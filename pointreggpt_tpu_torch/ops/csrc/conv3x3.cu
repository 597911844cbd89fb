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
// fp32 rate outside them (67 TFLOP/s) needs 1.15 ms for the 77.3 GFLOP,
// in fp32 as in bf16.
//
// Design: the TPU kernel pairs taps along the channel axis (K = 2 cin
// contractions) to fill the MXU's contraction depth; that has no meaning
// here. Both types run one implicit GEMM on the tensor cores, a halo
// window of x in shared memory standing in for A, on tiles of TR (16)
// output rows x 16 columns x 64 output channels: each warp owns 4 whole
// rows of 16 pixels, so each A fragment it loads serves up to three taps,
// the window's halo is 27% of its pixels, and the weights stay resident
// in shared memory where they fit (bf16 cin <= 128, fp32 cin <= 64). bf16
// is conv3_tc.cuh (shared with K6): 64-channel chunks, mma.sync.m16n8k16.
// fp32 is conv3_tf32.cuh: 32-channel chunks of the same 128-byte rows, and
// every product in three TF32 passes (a_lo b_hi + a_hi b_lo + a_hi b_hi,
// about 21 bits each, where one TF32 pass keeps 10), mma.sync.m16n8k8;
// the fp32 bound is the three passes' operations at the TF32 rate, 3 x
// 77.3 GFLOP in 0.47 ms at (16, 256, 256, 64 -> 64).

#include "common.cuh"
#include "conv3_tc.cuh"
#include "conv3_tf32.cuh"

namespace {

constexpr int MAX_C = 4096;
constexpr int TR = 16;  // bf16: output rows per tile

}  // namespace

extern "C" {

// Widest cin and cout the kernel takes.
int prgpt_conv3x3_max_c() { return MAX_C; }

// bf16: w (3, 3, cin, cout).
int prgpt_conv3x3(const void* x, const void* w, void* out, int b, int h,
                  int wd, int cin, int cout, int sms, void* stream) {
  return prgpt::conv3::launch<16>(x, w, out, b, h, wd, cin, cout, TR, sms,
                                  static_cast<cudaStream_t>(stream));
}

// fp32: wt = w repacked as (cout, 3, 3, cin); bias (cout) or null, added
// before the store (ops/conv.py::conv2d's route).
int prgpt_conv3x3_f32(const void* x, const void* wt, const void* bias,
                      void* out, int b, int h, int wd, int cin, int cout,
                      int sms, void* stream) {
  return prgpt::conv3::tf32::launch(
      static_cast<const float*>(x), static_cast<const float*>(wt),
      static_cast<float*>(out), b, h, wd, cin, cout, sms,
      static_cast<cudaStream_t>(stream), static_cast<const float*>(bias));
}

}  // extern "C"
