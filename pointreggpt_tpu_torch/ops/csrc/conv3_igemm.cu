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
// (ops/conv.py::work_conv). The two are even, so the products and the
// loads have to overlap, and every byte of x should come from device
// memory about once.
//
// Design: as on the TPU, the im2col tile A is never written to device
// memory. K6 is the implicit GEMM of conv3_tc.cuh (shared with K5's bf16
// path): a tile is `rows` output rows x TC columns x 64 output channels,
// so the tool's row sweep still sets the row block. The columns follow
// from it, so that a tile fills the block's 256 pixels (4 warps of 64
// whole-row pixels along the rows): rows 1 .. 4 take 64 columns, 5 .. 8
// take 32, 9 .. 16 take 16 (rows below 4, 8 or 16 leave part of the block
// idle). A cin above 64 takes 16 columns at any rows: only the 18 x 18
// window leaves room beside 128 channels of resident weights, or beside a
// streamed weight chunk in each of two stages. Persistent blocks keep the
// weights resident, a cp.async ring loads the next tile's window while
// mma.sync works on this one, ldmatrix reads conflict-free swizzled rows,
// and the epilogue stores 16-byte vectors.

#include "conv3_tc.cuh"

namespace {

constexpr int MAX_ROWS = 16;  // 4 warps of 4 rows x 16 columns

}  // namespace

extern "C" {

// Largest row block the kernel takes.
int prgpt_conv3_igemm_max_rows() { return MAX_ROWS; }

int prgpt_conv3_igemm(const void* x, const void* wmat, void* out, int b,
                      int h, int wd, int cin, int cout, int rows, int sms,
                      void* stream) {
  if (rows < 1 || rows > MAX_ROWS || h % rows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cin > prgpt::conv3::KCH || rows > 8)
    err = prgpt::conv3::launch<16>(x, wmat, out, b, h, wd, cin, cout, rows,
                                   sms, s);
  else if (rows > 4)
    err = prgpt::conv3::launch<32>(x, wmat, out, b, h, wd, cin, cout, rows,
                                   sms, s);
  else
    err = prgpt::conv3::launch<64>(x, wmat, out, b, h, wd, cin, cout, rows,
                                   sms, s);
  return static_cast<int>(err);
}

}  // extern "C"
