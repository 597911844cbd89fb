// Shared helpers for the hand-written Hopper kernels: conversion between
// the storage type T (float or __nv_bfloat16) and the fp32 math type, and
// rounding an fp32 value to T's precision where the plain PyTorch version
// materializes a tensor in the model dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace prgpt {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T's precision (round to nearest even), returned as fp32
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Tensor-core and async-copy primitives of the sm_90a kernels (K1 and K2
// in both types, K3's and K5's bf16 paths, K6): cp.async staging,
// ldmatrix, mma.sync.m16n8k16 (bf16) and, below, the TF32 split and
// mma.sync.m16n8k8 of the fp32 bodies.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled where !full (no bytes are read)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldm_x4_trans(uint32_t (&r)[4],
                                             uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) @ b (16x8, col), bf16 in, fp32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// fp32-accurate products on the TF32 tensor cores (the fp32 bodies of K1,
// K2, K3 and K5): x = hi + lo with hi = tf32(x) and lo = x - hi as the
// tensor cores read it (split_frag below), so hi + lo holds x within
// 2^-21 relative, and a b ~= a_lo b_hi + a_hi b_lo + a_hi b_hi keeps
// about 21 bits of each product (the dropped a_lo b_lo is 2^-22 of it):
// the "3xTF32" of CUTLASS's OpMultiplyAddFastF32.

// 4 bytes global -> shared; zero-filled where !full (no bytes are read)
__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

// x rounded to TF32 (10 stored mantissa bits; nearest, ties away from 0)
// as cvt.rna.tf32.f32 rounds it, bit for bit for every finite x, on the
// integer pipe: half a unit of the 13 dropped bits added to the magnitude,
// then those bits cleared. Conversions issue at a quarter of the rate, and
// with cvt.rna the splits made K1's fp32 forward measurably slower.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// A fragment (4 values) or B fragment (2 values) split in place for three
// TF32 passes: v holds the fp32 bits and becomes hi = tf32(x), lo gets x -
// hi, exact in fp32 and left unrounded. The tensor cores read a tf32
// operand's top 19 bits, so lo loses its low 13 there: x ~= hi + lo within
// 2^-21 relative (2^-22 with lo rounded too), for two integer operations
// fewer a value. Every fp32 body takes this split: against a rounded lo
// it made each of K1, K2, K3 and K5 fp32 faster at the same measured
// error (PERF.md, on an H100).
template <int N>
__device__ __forceinline__ void split_frag(uint32_t (&v)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float x = __uint_as_float(v[i]);
    v[i] = to_tf32(x);
    lo[i] = __float_as_uint(x - __uint_as_float(v[i]));
  }
}

// c += a (16x8, row) @ b (8x8, col), tf32 in, fp32 accumulators
__device__ __forceinline__ void mma1688_tf32(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in three passes: the two small products first, a_hi b_hi last
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma1688_tf32(c, a_lo, b_hi[0], b_hi[1]);
  mma1688_tf32(c, a_hi, b_lo[0], b_lo[1]);
  mma1688_tf32(c, a_hi, b_hi[0], b_hi[1]);
}

// Raise the dynamic shared-memory cap when a launch needs more than 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace prgpt
