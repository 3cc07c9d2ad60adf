// Hopper (sm_90a) kernel of the joint histogram (pdf2d, B8).
//
// Replaces _pdf2d_kernel (fava_tpu/ops/pallas_pdf2d.py:75, exact counts) and
// _pdf2d_weighted_kernel (:91, per-bin weight sums), entries pdf2d_counts
// (:233) and pdf2d_counts_traced (:207). Plain C entry points, bound with
// ctypes by fava_tpu_torch/ops/_build.py; the kernel launches on the
// caller's stream, allocates nothing and returns cudaGetLastError() of its
// launch. The output must be zeroed by the caller.
//
// Semantics are np.histogram2d's, against float64 edges: sample s falls in
// bin (bx, by) when xe[bx] <= x_s < xe[bx+1] and ye[by] <= y_s < ye[by+1],
// the last bin of each axis closed at its upper edge; samples outside the
// edges, or NaN, are dropped. The float64 edges never reach the card: the
// host (cuda_kernels._pdf2d_axis) turns each axis into float32 thresholds,
// t[b] the least float f with (double)f >= e[b] and hi the largest float
// <= e[nb], so that for every float v, v >= e[b] exactly when v >= t[b] and
// v <= e[nb] exactly when v <= hi. A sample's bin is then the largest b
// with t[b] <= v, all in float32, and the counts stay numpy's bit for bit.
//
// What bounds it: one pass over 8 (counts) or 12 (weighted) bytes per
// sample, 1.07 / 1.68 GB on the path's 134 M / 140 M samples. The TPU
// kernel's mechanisms (one-hot matrices contracted on the MXU, bf16 Dekker
// splits of the weights, 2Sum planes, inf padding, 128-bin edge columns) do
// not carry over: on Hopper a histogram is a scatter. Design:
// - A warp takes tiles of 32 x kSpan consecutive samples (a grid-stride walk
//   over tiles, one wave of blocks); each lane takes kSpan consecutive
//   samples of the tile and issues all of its float4 loads before it bins.
// - The bin of an axis: g = (v - lo) * scale in float32 and b = floor(g).
//   The host bounds how far g can lie from the exact position of v among
//   the thresholds (the edges' departure from uniform plus the float32
//   rounding of g) as fast_lo; when g's fraction lies in (fast_lo,
//   1 - fast_lo), b is the bin and no threshold is read. Otherwise (a
//   sample within ~1e-5 of a bin's width of an edge, or edges that are far
//   from uniform, where the host switches this test off) a search of the
//   thresholds in shared memory from b finds it exactly.
// - Runs of one bin along a lane's span are summed in registers (an int
//   count, an f64 weight sum) and added when the bin changes. The runs that
//   reach the ends of the lanes' spans are summed across lanes in one
//   segmented shuffle scan per tile (lanes in a row on one bin add once).
// - Each block keeps a private histogram in shared memory (uint32 counts,
//   40 KB at 100 x 100, added with native shared atomics; f64 sums, 80 KB,
//   whose shared atomicAdd sm_90a compiles to a compare-and-swap loop, so
//   fewer adds matter most there) and adds it to the output with 64-bit
//   global atomics at the end. The launch caps a block's samples below
//   2^32, so its uint32 counts cannot wrap. Where the histogram does not
//   fit a block's shared memory (beyond about 57,000 bins counted, 28,500
//   weighted) runs are added to the output in global memory directly.
// Counts are exact integers; weight sums are f64 added by atomics in an
// order that varies between runs (rounding-level spread).
//
// Where its time goes (NVIDIA H100 80GB HBM3 at 700 W, probe_pdf2d.py,
// through the C entry): counted on the 512^3 window's samples 0.375 ms
// (bound 0.321), weighted on the 140 M AMR leaves 0.593 (bound 0.502);
// with its loads served from L1 the counted kernel takes 0.313, without
// the binning 0.349, without the shared adds 0.364: loads and arithmetic
// overlap, and neither alone is far below the whole. A sample's runs are
// short on these fields (5.1 and 3.9 samples, 3.4 and 3.3 within a span),
// so the weighted kernel's shared compare-and-swap adds still cost ~0.05
// ms of its 0.59 there and 0.13 of 0.66 on uncorrelated samples. 64
// registers a thread (60 counted) and the 80 KB weighted histogram hold an
// SM to 2 blocks of 16 warps; spans of 16 samples or blocks of 256
// threads make the weighted kernel 1.3-1.5x slower.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "row_moments.cuh"

namespace {

using fava::kFullMask;
using fava::launch_status;

constexpr int kThreads = 512;       // threads a block
constexpr int kSpan = 8;            // consecutive samples a lane bins per tile
constexpr int kTile = 32 * kSpan;   // samples a warp bins per tile
constexpr int kAxisHead = 5;        // per axis: lo, hi, scale, fast_lo, fast_hi
constexpr int kHead = 2 * kAxisHead;

struct Axis {
  float lo, hi, scale, fast_lo, fast_hi;
  int nb;
  const float* t;  // t[0 .. nb-1], in shared memory
};

__device__ __forceinline__ Axis load_axis(const float* head, int nb, const float* t) {
  return Axis{head[0], head[1], head[2], head[3], head[4], nb, t};
}

// The largest b in [0, nb-1] with t[b] <= v, given t[0] <= v, starting
// from the guess b: exact for any non-decreasing thresholds.
__device__ __forceinline__ int search_bin(float v, const float* t, int nb, int b) {
  int lo = 0, hi = nb - 1;
  if (v >= t[b]) {
    if (b == hi || v < t[b + 1]) return b;
    lo = b + 1;
  } else {
    hi = b - 1;
  }
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (v >= t[mid]) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Bin of v on one axis, or -1 outside [lo, hi] and for NaN.
__device__ __forceinline__ int axis_bin(float v, const Axis& a) {
  if (!(v >= a.lo && v <= a.hi)) return -1;
  const float g = __fmul_rn(__fsub_rn(v, a.lo), a.scale);
  const int b = (int)fminf(fmaxf(g, 0.f), (float)(a.nb - 1));
  const float f = __fsub_rn(g, (float)b);
  if (g < (float)a.nb && f > a.fast_lo && f < a.fast_hi) return b;
  return search_bin(v, a.t, a.nb, b);
}

// The kSpan samples i0 .. i0+kSpan-1 of p; ``fill`` past n.
__device__ __forceinline__ void load_span(const float* __restrict__ p, int64_t i0, int64_t n,
                                          int vec, float fill, float (&v)[kSpan]) {
  if (vec && i0 + kSpan <= n) {
    const float4* p4 = reinterpret_cast<const float4*>(p + i0);
#pragma unroll
    for (int j = 0; j < kSpan / 4; ++j) {
      const float4 q = __ldg(p4 + j);
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kSpan; ++k) v[k] = i0 + k < n ? __ldg(p + i0 + k) : fill;
  }
}

// Adds a run to its bin: in the block's shared histogram, or in the output.
template <bool kShared, typename Acc>
__device__ __forceinline__ void add_run(Acc* hist, void* out, int bin, Acc v) {
  if constexpr (kShared) {
    atomicAdd(hist + bin, v);
  } else if constexpr (std::is_same<Acc, double>::value) {
    atomicAdd(static_cast<double*>(out) + bin, v);
  } else {
    atomicAdd(static_cast<unsigned long long*>(out) + bin, (unsigned long long)v);
  }
}

// Segmented sum over the lanes of the runs that end their spans: lanes in a
// row on one bin form a segment, whose first lane (``first``) gets its sum.
template <typename Acc>
__device__ __forceinline__ Acc segment_sum(int bin, Acc v, int lane, bool& first) {
  const int prev = __shfl_up_sync(kFullMask, bin, 1);
  const unsigned heads = __ballot_sync(kFullMask, lane == 0 || prev != bin);
  const unsigned after = heads & (0xfffffffeu << lane);  // segment heads beyond this lane
  const int end = after ? __ffs(after) - 2 : 31;         // this segment's last lane
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Acc o = __shfl_down_sync(kFullMask, v, d);
    if (lane + d <= end) v += o;
  }
  first = (heads >> lane) & 1u;
  return v;
}

template <bool kWeighted, bool kShared>
__global__ void __launch_bounds__(kThreads, 2)
pdf2d_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ w, const float* __restrict__ table,
             void* __restrict__ out, int64_t n, int nbx, int nby, int vec) {
  using Acc = typename std::conditional<kWeighted, double, unsigned>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nbins = nbx * nby;
  Acc* hist = reinterpret_cast<Acc*>(smem);  // [nbins] when kShared
  float* tab = reinterpret_cast<float*>(smem + (kShared ? (size_t)nbins * sizeof(Acc) : 0));
  for (int i = threadIdx.x; i < kHead + nbx + nby; i += kThreads) tab[i] = table[i];
  if constexpr (kShared) {
    for (int b = threadIdx.x; b < nbins; b += kThreads) hist[b] = Acc(0);
  }
  __syncthreads();
  const Axis ax = load_axis(tab, nbx, tab + kHead);
  const Axis ay = load_axis(tab + kAxisHead, nby, tab + kHead + nbx);
  const int lane = threadIdx.x & 31;
  const float nan = __int_as_float(0x7fc00000);

  const int64_t ntiles = (n + kTile - 1) / kTile;
  const int64_t nwarps = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t t = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32; t < ntiles;
       t += nwarps) {
    const int64_t i0 = t * kTile + (int64_t)lane * kSpan;
    float xs[kSpan], ys[kSpan], ws[kSpan];
    load_span(x, i0, n, vec, nan, xs);  // NaN past n: dropped
    load_span(y, i0, n, vec, 0.f, ys);
    if constexpr (kWeighted) load_span(w, i0, n, vec, 0.f, ws);
    int cur = -1;
    Acc run = Acc(0);
#pragma unroll
    for (int k = 0; k < kSpan; ++k) {
      const int bx = axis_bin(xs[k], ax);
      const int by = axis_bin(ys[k], ay);
      const int bin = (bx | by) < 0 ? -1 : bx * nby + by;
      if (bin != cur) {
        if (cur >= 0) add_run<kShared>(hist, out, cur, run);
        cur = bin;
        run = Acc(0);
      }
      if constexpr (kWeighted) run += (double)ws[k];
      else run += 1u;
    }
    bool first;
    run = segment_sum(cur, run, lane, first);
    if (first && cur >= 0) add_run<kShared>(hist, out, cur, run);
  }

  if constexpr (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < nbins; b += kThreads) {
      const Acc v = hist[b];
      if (v != Acc(0)) add_run<false>(hist, out, b, v);
    }
  }
}

template <bool kWeighted, bool kShared>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(pdf2d_kernel<kWeighted, kShared>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool kWeighted, bool kShared>
int launch_pdf2d(const float* x, const float* y, const float* w, const float* table, void* out,
                 int64_t n, int nbx, int nby, int vec, int blocks, size_t smem,
                 cudaStream_t stream) {
  const cudaError_t err = allow_smem<kWeighted, kShared>(smem);
  if (err != cudaSuccess) return (int)err;
  pdf2d_kernel<kWeighted, kShared>
      <<<blocks, kThreads, smem, stream>>>(x, y, w, table, out, n, nbx, nby, vec);
  return launch_status();
}

template <bool kWeighted, bool kShared>
int blocks_per_sm(size_t smem) {
  cudaError_t err = allow_smem<kWeighted, kShared>(smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pdf2d_kernel<kWeighted, kShared>,
                                                        kThreads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

extern "C" {

// Joint histogram of n samples (x, y), weighted by w unless w is null: out
// is (nbx, nby) int64 counts, or f64 sums when weighted. ``table`` holds
// the two axes' heads (lo, hi, scale, fast_lo, fast_hi) and then their
// thresholds (nbx, then nby floats); ``shared`` says whether the histogram
// lives in shared memory, ``smem`` is the dynamic shared bytes a block
// takes (the histogram, if shared, then the table).
int fava_pdf2d(const void* x, const void* y, const void* w, const void* table, void* out,
               long long n, int nbx, int nby, int vec, int shared, long long smem, int blocks,
               void* stream) {
  (void)cudaGetLastError();
  const float* xf = (const float*)x;
  const float* yf = (const float*)y;
  const float* wf = (const float*)w;
  const float* tf = (const float*)table;
  const size_t sb = (size_t)smem;
  cudaStream_t st = (cudaStream_t)stream;
  if (w != nullptr) {
    return shared ? launch_pdf2d<true, true>(xf, yf, wf, tf, out, n, nbx, nby, vec, blocks, sb, st)
                  : launch_pdf2d<true, false>(xf, yf, wf, tf, out, n, nbx, nby, vec, blocks, sb, st);
  }
  return shared ? launch_pdf2d<false, true>(xf, yf, wf, tf, out, n, nbx, nby, vec, blocks, sb, st)
                : launch_pdf2d<false, false>(xf, yf, wf, tf, out, n, nbx, nby, vec, blocks, sb, st);
}

// Blocks of the kernel that fit one SM of the current device at once with
// ``smem`` dynamic shared bytes; a negative CUDA error code on failure.
int fava_pdf2d_blocks_per_sm(int weighted, int shared, long long smem) {
  (void)cudaGetLastError();
  const size_t sb = (size_t)smem;
  if (weighted) return shared ? blocks_per_sm<true, true>(sb) : blocks_per_sm<true, false>(sb);
  return shared ? blocks_per_sm<false, true>(sb) : blocks_per_sm<false, false>(sb);
}

// The dynamic shared bytes a block may opt in to on the current device; a
// negative CUDA error code on failure.
int fava_pdf2d_smem_optin() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? optin : -(int)err;
}

}  // extern "C"
