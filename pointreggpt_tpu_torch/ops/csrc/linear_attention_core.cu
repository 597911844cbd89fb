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
// qkv (b, n, 384) and out in T (bf16 or fp32); any n >= 1. heads = 4,
// dim_head = 32 (hidden = 128) are compile-time constants.
//
// Bound on this card, at (8, 65536, 384) bf16: the function must read qkv
// once and write out once, 537 MB, 0.160 ms at 3.35 TB/s; its products
// (two context products on the four 32x32 head blocks, 2 * 2 * 4096 per
// row) are 4.3 GFLOP, 4 us at 989 TFLOP/s: it is bound by bytes
// (ops/linear_attention.py::work_core counts every shape, chip_smoke.py
// turns that into the bound). This design reads each byte of qkv once:
// k and v in launch A, q in launch C.
//
// Design: the TPU kernel walks n sequentially per batch row, phase 0 over
// k and v with (m, s, C) in VMEM, phase 1 over q. Blocks here carry
// nothing, so one call is three launches, K1's structure with k and v
// loaded instead of projected (the CUDA-core bodies of
// linear_attention_kv.cuh; B is also kernel B of K1's fp32 path):
//   A  core_kv_partials   grid (splits, b): per-split (m, s, C) partials,
//                         the four 32x32 head blocks of C only (the TPU
//                         kernel computes all of 128x128 and masks it).
//   B  core_merge_context grid (b): C^, rounded to T.
//   C  core_emit          grid (row groups, b): per 16-row tile, q's
//                         per-head softmax and q C^; C^ is read
//                         once per block of TILES tiles.
// Products are fp32 FMAs on the CUDA cores; the bytes, not the products,
// bound this function.
//
// Rounding follows the plain PyTorch version (the port of _xla_core,
// ops/linear_attention.py::linear_attention_core_plain): exp(k - m), C^,
// the softmaxed q and the output are rounded to T. The TPU kernel keeps
// them in fp32; in bf16 the two differ by bf16 roundings.

#include "linear_attention_kv.cuh"

namespace {

using prgpt::from_f;
using prgpt::to_f;
using namespace prgpt::la;

constexpr int TILES = 4;  // 16-row tiles per block of core_emit

template <typename T>
__global__ void __launch_bounds__(THREADS)
core_kv_partials(const T* __restrict__ qkv, float* __restrict__ part, int n,
                 int rows_per_split, int splits) {
  kv_partials_body<T>(LoadKV<T>{qkv}, part, n, 0, rows_per_split, splits);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
core_merge_context(const float* __restrict__ part, float* __restrict__ chat,
                   int splits, float scale) {
  merge_context_body<T>(part, chat, nullptr, splits, scale);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
core_emit(const T* __restrict__ qkv, const float* __restrict__ chat,
          T* __restrict__ out, int n) {
  __shared__ float qs[ROWS * HID];
  __shared__ float core[ROWS * HID];
  __shared__ float ch[CBLK];

  const int tid = threadIdx.x;
  const int bi = blockIdx.y;
  for (int i = tid; i < CBLK; i += THREADS)
    ch[i] = chat[static_cast<size_t>(bi) * CBLK + i];

  for (int t = 0; t < TILES; ++t) {
    const int r0 = (blockIdx.x * TILES + t) * ROWS;
    if (r0 >= n) break;
    const int rows = min(ROWS, n - r0);
    const size_t row0 = static_cast<size_t>(bi) * n + r0;
    for (int i = tid; i < rows * HID; i += THREADS)
      qs[i] = to_f(qkv[(row0 + i / HID) * QKV + i % HID]);
    __syncthreads();
    q_context_body<T>(qs, ch, core, rows);
    for (int i = tid; i < rows * HID; i += THREADS)
      out[row0 * HID + i] = from_f<T>(core[i]);
  }
}

template <typename T>
cudaError_t launch(const void* qkv_, void* out_, float* part, float* chat,
                   int b, int n, int splits, int rows_per_split,
                   cudaStream_t stream) {
  const T* qkv = static_cast<const T*>(qkv_);
  const size_t smem_a = kv_partials_smem(0);
  cudaError_t err = prgpt::allow_smem(core_kv_partials<T>, smem_a);
  if (err != cudaSuccess) return err;

  core_kv_partials<T><<<dim3(splits, b), THREADS, smem_a, stream>>>(
      qkv, part, n, rows_per_split, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const float scale = rsqrtf(static_cast<float>(DH)) / static_cast<float>(n);
  core_merge_context<T><<<b, THREADS, 0, stream>>>(part, chat, splits, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int groups = (n + TILES * ROWS - 1) / (TILES * ROWS);
  core_emit<T><<<dim3(groups, b), THREADS, 0, stream>>>(
      qkv, chat, static_cast<T*>(out_), n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per tile: the wrapper sizes its splits in whole tiles.
int prgpt_linear_attention_core_rows_per_tile() { return ROWS; }

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
    return launch<__nv_bfloat16>(qkv, out, part, chat, b, n, splits,
                                 rows_per_split, s);
  return launch<float>(qkv, out, part, chat, b, n, splits, rows_per_split,
                       s);
}

}  // extern "C"
