// GroupNorm with its epilogue, channels-last, hand-written for Hopper
// (sm_90a). For x (b, h, w, c) (NHWC) and g groups of c / g channels:
//
//   y = (x - mean) * rstd * gamma + beta       mean, rstd per (image, group)
//   y = y * (scale + 1) + shift                optional, per (image, channel)
//   y = y / (1 + exp(-y))                      optional (SiLU)
//
// all in fp32 (biased variance, rstd = rsqrt(var + eps)), then rounded once
// to the output type. x and y are bf16 and bf16, bf16 and fp32 (ADM's
// head) or fp32 and fp32 (the MaskUNet), scale and shift bf16 or fp32,
// gamma and beta fp32. It replaces no TPU kernel: the JAX
// package leaves GroupNorm and its epilogue to XLA, which fuses them. On
// the card PyTorch's nn.GroupNorm takes and returns only NCHW, so the
// port's channels-last bf16 stream paid a cast, a copy to NCHW, the
// statistics (one block per (image, group) row), the affine, the
// scale-shift, SiLU and a cast back, and the next conv a copy back to
// NHWC: some 50-60 bytes an element (ops/group_norm.py holds that chain as
// the plain version, which the CPU and autograd still take).
//
// Bound on this card: the bytes, one read of x and one write of y at 3.35
// TB/s: 0.63 ms for the 38 GroupNorms of a dim-64 U-Net forward at batch
// 8 in bf16 (528 M elements), 3.8 ms for ADM's 101 (3.2 G). A few fp32
// operations an element.
//
// Design: two launches, the first reads x, the second reads it again and
// writes y.
// - Threads. A thread owns V channels of one group (16 bytes: 8 bf16 or 4
//   fp32; every group of the nets is 8 channels wide or more) at every
//   by-th pixel row of its block's range: a block is (c / V) x by threads,
//   about 256 (up to 1024 for fp32 x past 1,024 channels, an fp32 ADM's),
//   neighbouring threads on neighbouring addresses.
// - Statistics (group_norm_stats). Each image is cut into splits of whole
//   pixel rows, about four blocks an SM in all (ops/group_norm.py::plan),
//   so a (image, group) slab is spread over many blocks and SMs and each
//   block streams enough to bury its fixed cost (its merge, fence and
//   atomic; at one 32 KB tile a block that cost was most of the pass). A
//   thread folds each run of loaded values into its (count, mean, M2) by
//   Chan's formula (the run's own mean and M2 first), never E[x^2] -
//   mean^2: a slab holds up to 524 K elements and the fp32 MaskUNet's
//   output is held to a few 1e-4. The block merges its threads' triples
//   per group in shared memory and writes one (mean, M2) per (split,
//   group). The last block of an image to finish (a counter per image,
//   atomicInc, which wraps back to 0 for the next call) merges that
//   image's partials in split order and writes (mean, rstd) per group: no
//   atomics on the values, the same bits every run. A split is read from
//   its end back, thread 0 asking L2 for the block's next rows ahead of
//   the loads (cp.async.bulk.prefetch).
// - Apply (group_norm_apply). Each split is cut into tiles of about 32 KB,
//   one block a tile; block i takes tile i / (b splits) of split i mod (b
//   splits), so the first wave reads the start of every split, which the
//   statistics read last and the 50 MB L2 may still hold. A block folds
//   mean, rstd, gamma, beta, scale and shift into one fp32 a x + b per
//   channel of its threads, streams its tile and stores y in the output
//   type. SiLU is v / (1 + expf(-v)), PyTorch's expression, with expf
//   (within 2 ulp, as PyTorch's) and the fast division (within 2 ulp where
//   the divisor is under 2^126, where PyTorch's is exact): a few 1e-7 of
//   the value, far under a bf16 step and the fp32 MaskUNet's 4e-4 limit;
//   the exact division left the pass bound by its instructions. The pass
//   is a programmatic
//   dependent launch: its blocks start as the statistics' retire, load
//   their parameters and ask L2 for their tile, and wait for the
//   statistics only to read them (about 1 us less a call at 32^2-64^2).
//
// Kernel names carry group_norm.

#include "common.cuh"

namespace prgpt {
namespace gn {

constexpr int U = 4;   // pixel rows a thread of the statistics loads at once
constexpr int UA = 2;  // and of the apply pass
constexpr int MERGE_RUN = 8;  // partials a lane of the last block loads at once

// V values of T at p (16 bytes, aligned) as fp32; `LAST` marks a read
// that nothing reads again (evict first)
template <typename T, int V, bool LAST>
__device__ __forceinline__ void load(const T* p, float (&f)[V]) {
  static_assert(sizeof(T) * V == 16, "16-byte loads");
  const uint4 r = LAST ? __ldcs(reinterpret_cast<const uint4*>(p))
                       : __ldg(reinterpret_cast<const uint4*>(p));
  const T* t = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int j = 0; j < V; ++j) f[j] = to_f<T>(t[j]);
}

// V fp32 values rounded to T, stored at p in 16-byte pieces
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&f)[V]) {
  constexpr int N = 16 / sizeof(T);
  static_assert(V % N == 0, "whole 16-byte stores");
#pragma unroll
  for (int k = 0; k < V / N; ++k) {
    uint4 r;
    T* t = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int j = 0; j < N; ++j) t[j] = from_f<T>(f[k * N + j]);
    *reinterpret_cast<uint4*>(p + k * N) = r;
  }
}

// (n, m, s) <- the count, mean and M2 of the union of (n, m, s) and (nb,
// mb, sb) (Chan, Golub and LeVeque); an empty side leaves the other. The
// weight nb / (n + nb) lies in (0, 1], where the approximate division is
// within 2 ulp.
__device__ __forceinline__ void chan(float& n, float& m, float& s, float nb,
                                     float mb, float sb) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float d = mb - m;
  const float w = __fdividef(nb, nn);
  m = fmaf(d, w, m);
  s = s + sb + d * d * n * w;
  n = nn;
}

__device__ __forceinline__ void warp_chan(float& n, float& m, float& s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, n, o);
    const float mb = __shfl_xor_sync(0xffffffffu, m, o);
    const float sb = __shfl_xor_sync(0xffffffffu, s, o);
    chan(n, m, s, nb, mb, sb);
  }
}

// Rows r0, r0 - by, ..., U of them, of a thread's V channels into f, as
// far as they lie at or above row 0 (zeros past that); returns how many.
template <typename TI, int V>
__device__ __forceinline__ int load_rows(const TI* xb, int r0, int by, int c,
                                         float (&f)[U][V]) {
  int k = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = r0 - u * by;
    if (r >= 0) {
      load<TI, V, false>(xb + static_cast<long long>(r) * c, f[u]);
      k = u + 1;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) f[u][j] = 0.f;
    }
  }
  return k;
}

// The whole 16-byte pieces of [begin, end) prefetched into L2 by one bulk
// request
__device__ __forceinline__ void prefetch_l2(const void* begin,
                                            const void* end) {
  const unsigned long long b0 =
      (reinterpret_cast<unsigned long long>(begin) + 15) & ~15ull;
  const unsigned long long b1 =
      reinterpret_cast<unsigned long long>(end) & ~15ull;
  if (b1 <= b0) return;
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(b0),
               "r"(static_cast<unsigned>(b1 - b0))
               : "memory");
}

// (n, m, s) <- merged with the first k rows of f: their own mean and M2
// first, each row summed apart so that the sums run side by side
template <int V>
__device__ __forceinline__ void fold(const float (&f)[U][V], int k, float& n,
                                     float& m, float& s) {
  float part[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    part[u] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) part[u] += f[u][j];
  }
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (u < k) sum += part[u];
  const float kn = static_cast<float>(k * V);
  const float mk = __fdividef(sum, kn);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    part[u] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = f[u][j] - mk;
      part[u] = fmaf(d, d, part[u]);
    }
  }
  float sk = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (u < k) sk += part[u];
  chan(n, m, s, kn, mk, sk);
}

struct Geo {
  long long hw;  // pixels an image
  int c, groups, cpg;
  int span;    // pixels a split of the statistics (a multiple of by)
  int splits;  // splits an image
  int tile;    // pixels an apply block (a multiple of by, at most span)
  int tiles;   // apply blocks a split
};

// Per block (image n, split sp): (mean, M2) of each group over the split's
// pixels, read from its end back, into part[(n splits + sp) groups + g];
// the image's last block then writes stats[n groups + g] = (mean, rstd).
template <typename TI, int V, int MAXT>
__global__ void __launch_bounds__(MAXT)
    group_norm_stats(const TI* __restrict__ x, float2* __restrict__ part,
                     float2* __restrict__ stats, unsigned* __restrict__ done,
                     Geo q, float eps) {
  __shared__ float sn[MAXT], sm[MAXT], ss[MAXT];
  __shared__ bool last;
  const int by = blockDim.y;
  const int nt = blockDim.x * by;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n = blockIdx.x / q.splits, sp = blockIdx.x % q.splits;
  const long long p0 = static_cast<long long>(sp) * q.span;
  const int rows = static_cast<int>(min(p0 + q.span, q.hw) - p0);
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const TI* xs = x + (static_cast<long long>(n) * q.hw + p0) * q.c;
  const TI* xb = xs + threadIdx.x * V;

  // a block folds U * by pixel rows an iteration, from the split's end
  // back; thread 0 asks L2 for the next iteration's rows (at 67 MB in
  // bf16 34 us a pass against 39 without; two or four ahead did worse)
  const int step = U * by;
  float cnt = 0.f, mean = 0.f, m2 = 0.f;
  int it = 0;
  for (int r0 = rows - 1 - threadIdx.y; r0 >= 0; r0 -= step, ++it) {
    const int hi = rows - (it + 1) * step;
    if (tid == 0 && hi > 0)
      prefetch_l2(xs + static_cast<long long>(max(hi - step, 0)) * q.c,
                  xs + static_cast<long long>(hi) * q.c);
    float f[U][V];
    fold<V>(f, load_rows<TI, V>(xb, r0, by, q.c, f), cnt, mean, m2);
  }
  sn[tid] = cnt, sm[tid] = mean, ss[tid] = m2;
  __syncthreads();

  // per group, the (c / g / V) x by threads that hold it, in the block's
  // whole warps: each lane merges a run of them, then the warp's lanes
  // merge (a last partial warp, where c / V x by is no multiple of 32,
  // takes no group); lane 0 writes the partials, then fences them
  const int lane = tid & 31, warp = tid >> 5, warps = nt >> 5;
  const int vpg = q.cpg / V;
  const int per = vpg * by;
  const int g0 = warp < warps ? warp : q.groups;
  for (int g = g0; g < q.groups; g += warps) {
    float gn = 0.f, gm = 0.f, gs = 0.f;
    for (int e = lane; e < per; e += 32) {
      const int i = (e / vpg) * blockDim.x + g * vpg + e % vpg;
      chan(gn, gm, gs, sn[i], sm[i], ss[i]);
    }
    warp_chan(gn, gm, gs);
    if (lane == 0)
      part[static_cast<long long>(blockIdx.x) * q.groups + g] =
          make_float2(gm, gs);
  }
  if (lane == 0) __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicInc(done + n, q.splits - 1) == q.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the image's partials, MERGE_RUN splits a lane loaded at once
  const float2* pn = part + static_cast<long long>(n) * q.splits * q.groups;
  for (int g = g0; g < q.groups; g += warps) {
    float gn = 0.f, gm = 0.f, gs = 0.f;
    for (int t0 = lane; t0 < q.splits; t0 += 32 * MERGE_RUN) {
      float2 pr[MERGE_RUN];
#pragma unroll
      for (int k = 0; k < MERGE_RUN; ++k) {
        const int t = t0 + 32 * k;
        if (t < q.splits)
          pr[k] = __ldcg(pn + static_cast<long long>(t) * q.groups + g);
      }
#pragma unroll
      for (int k = 0; k < MERGE_RUN; ++k) {
        const long long t = t0 + 32 * k;
        if (t < q.splits)
          chan(gn, gm, gs,
               static_cast<float>(
                   min(static_cast<long long>(q.span), q.hw - t * q.span) *
                   q.cpg),
               pr[k].x, pr[k].y);
      }
    }
    warp_chan(gn, gm, gs);
    if (lane == 0)
      stats[n * q.groups + g] = make_float2(gm, rsqrtf(gs / gn + eps));
  }
}

template <typename T>
__device__ __forceinline__ float param(const void* p, long long i) {
  return to_f<T>(static_cast<const T*>(p)[i]);
}

// y over one tile: block i takes tile i / (b splits) of split i mod (b
// splits), so the first blocks to run read the start of every split,
// which the statistics read last
template <typename TI, typename TO, int V, int MAXT>
__global__ void __launch_bounds__(MAXT)
    group_norm_apply(const TI* __restrict__ x, TO* __restrict__ y,
                     const float2* __restrict__ stats,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, const void* scale,
                     const void* shift, long long scale_stride,
                     long long shift_stride, int ss_bf16, int silu, int b,
                     Geo q) {
  const int by = blockDim.y;
  const int all = b * q.splits;
  const int split = blockIdx.x % all, t = blockIdx.x / all;
  const int n = split / q.splits;
  const long long s0 = static_cast<long long>(split % q.splits) * q.span;
  const long long p0 = s0 + static_cast<long long>(t) * q.tile;
  const long long p1 = min(min(p0 + q.tile, s0 + q.span), q.hw);
  if (p0 >= p1) return;
  const int rows = static_cast<int>(p1 - p0);
  const int c0 = threadIdx.x * V;
  // gamma, beta, scale and shift first: the block may start while the
  // statistics still run (programmatic dependent launch), and waits for
  // them only where it reads them
  float a[V], bb[V], s1[V], sh[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] = gamma != nullptr ? gamma[c0 + j] : 1.f;
    bb[j] = beta != nullptr ? beta[c0 + j] : 0.f;
    s1[j] = 1.f, sh[j] = 0.f;
    if (scale != nullptr) {
      const long long i = n * scale_stride + c0 + j;
      const long long k = n * shift_stride + c0 + j;
      s1[j] = (ss_bf16 ? param<__nv_bfloat16>(scale, i)
                       : param<float>(scale, i)) + 1.f;
      sh[j] = ss_bf16 ? param<__nv_bfloat16>(shift, k)
                      : param<float>(shift, k);
    }
  }
  const long long base = (static_cast<long long>(n) * q.hw + p0) * q.c + c0;
  if (threadIdx.x == 0 && threadIdx.y == 0)
    prefetch_l2(x + base, x + base + static_cast<long long>(rows) * q.c);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const float2 st = stats[n * q.groups + c0 / q.cpg];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    a[j] *= st.y;
    bb[j] = fmaf(-a[j], st.x, bb[j]);
    if (scale != nullptr) {
      a[j] *= s1[j];
      bb[j] = fmaf(bb[j], s1[j], sh[j]);
    }
  }
  const TI* xb = x + base;
  TO* yb = y + base;
  for (int r0 = threadIdx.y; r0 < rows; r0 += UA * by) {
    float f[UA][V];
#pragma unroll
    for (int u = 0; u < UA; ++u) {
      const int r = r0 + u * by;
      if (r < rows)
        load<TI, V, true>(xb + static_cast<long long>(r) * q.c, f[u]);
    }
#pragma unroll
    for (int u = 0; u < UA; ++u) {
      const int r = r0 + u * by;
      if (r < rows) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float v = fmaf(a[j], f[u][j], bb[j]);
          // SiLU; expf is within 2 ulp, the approximate division within 2
          // ulp, and gives 0 where exp(-v) passes 2^126 (v < -87), where
          // SiLU is below 1e-36
          if (silu) v = __fdividef(v, 1.f + expf(-v));
          f[u][j] = v;
        }
        store<TO, V>(yb + static_cast<long long>(r) * q.c, f[u]);
      }
    }
  }
}

template <typename TI, typename TO, int V, int MAXT>
cudaError_t launch(const void* x, void* y, const void* gamma,
                   const void* beta, const void* scale, const void* shift,
                   long long scale_stride, long long shift_stride,
                   int ss_bf16, float* work, unsigned* done, int b, Geo q,
                   int by, int silu, float eps, cudaStream_t s) {
  const dim3 block(q.c / V, by);
  const int splits = b * q.splits;
  float2* part = reinterpret_cast<float2*>(work);
  float2* stats = part + static_cast<long long>(splits) * q.groups;
  group_norm_stats<TI, V, MAXT><<<splits, block, 0, s>>>(
      static_cast<const TI*>(x), part, stats, done, q, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the apply grid may launch as the statistics' blocks retire
  // (programmatic dependent launch); its blocks wait for the whole grid
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits * q.tiles);
  cfg.blockDim = block;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, group_norm_apply<TI, TO, V, MAXT>, static_cast<const TI*>(x),
      static_cast<TO*>(y), static_cast<const float2*>(stats),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      scale, shift, scale_stride, shift_stride, ss_bf16, silu, b, q);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace gn
}  // namespace prgpt

extern "C" {

// y (b, hw, c) from x (b, hw, c), both contiguous and 16-byte aligned;
// dtype codes 0 fp32, 1 bf16 (x_dtype, y_dtype, ss_dtype): x and y bf16
// and bf16, bf16 and fp32, or fp32 and fp32, vec 8 for bf16 x and 4 for
// fp32 (else cudaErrorInvalidValue). gamma, beta (c) fp32 or null; scale,
// shift (b, c) rows `scale_stride` / `shift_stride` elements apart, or
// both null. work holds 2 (b splits + b) groups
// floats, splits = ceil(hw / span); done b unsigned counters, zero before
// the first call (each call leaves them zero). The plan (vec channels a
// thread, by pixel rows a block, span pixels a split of the statistics,
// tile pixels an apply block) is ops/group_norm.py::plan's.
int prgpt_group_norm(const void* x, void* y, const void* gamma,
                     const void* beta, const void* scale, const void* shift,
                     long long scale_stride, long long shift_stride,
                     int ss_dtype, void* work, void* done, int b,
                     long long hw, int c, int groups, int vec, int by,
                     int span, int tile, int x_dtype, int y_dtype, int silu,
                     float eps, void* stream) {
  using namespace prgpt::gn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || hw < 1 || c < 1 || groups < 1 || c % groups || vec < 1 ||
      (c / groups) % vec || by < 1 || span < by || span % by || tile < by ||
      tile % by || tile > span || (scale == nullptr) != (shift == nullptr))
    return cudaErrorInvalidValue;
  const int threads = c / vec * by;
  if (threads > 1024 || threads < 128) return cudaErrorInvalidValue;
  Geo q;
  q.hw = hw, q.c = c, q.groups = groups, q.cpg = c / groups;
  q.span = span, q.tile = tile;
  const long long splits = (hw + span - 1) / span;
  q.tiles = (span + tile - 1) / tile;
  if (splits * b * q.tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  q.splits = static_cast<int>(splits);
  float* w = static_cast<float*>(work);
  unsigned* d = static_cast<unsigned*>(done);
  const int ss = ss_dtype == 1;
  // the bodies the nets run: bf16 x 8 a thread, at most 256 threads a
  // block; fp32 x 4 a thread, 256 or 1,024
#define PRGPT_GN_LAUNCH(TI, TO, VV, MAXT)                                   \
  return launch<TI, TO, VV, MAXT>(x, y, gamma, beta, scale, shift,         \
                                  scale_stride, shift_stride, ss, w, d, b, \
                                  q, by, silu, eps, s)
  if (x_dtype == 1 && vec == 8 && threads <= 256) {
    if (y_dtype == 1) PRGPT_GN_LAUNCH(__nv_bfloat16, __nv_bfloat16, 8, 256);
    if (y_dtype == 0) PRGPT_GN_LAUNCH(__nv_bfloat16, float, 8, 256);
  }
  if (x_dtype == 0 && y_dtype == 0 && vec == 4) {
    if (threads <= 256) PRGPT_GN_LAUNCH(float, float, 4, 256);
    PRGPT_GN_LAUNCH(float, float, 4, 1024);
  }
#undef PRGPT_GN_LAUNCH
  return cudaErrorInvalidValue;
}

// The id of the graph capture under way on `stream`, 0 where none:
// ops/group_norm.py gives the calls of each capture their own counters.
unsigned long long prgpt_capture_id(void* stream) {
  cudaStreamCaptureStatus st;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &st, &id) !=
          cudaSuccess ||
      st != cudaStreamCaptureStatusActive)
    return 0;
  return id;
}

}  // extern "C"
