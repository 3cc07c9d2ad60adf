// Hopper (sm_90a) kernel of the joint histogram (pdf2d, B8).
//
// Replaces _pdf2d_kernel (fava_tpu/ops/pallas_pdf2d.py:75, exact counts) and
// _pdf2d_weighted_kernel (:91, per-bin weight sums), entries pdf2d_counts
// (:233) and pdf2d_counts_traced (:207). Plain C entry point, bound with
// ctypes by fava_tpu_torch/ops/_build.py; it launches on the caller's
// stream, allocates nothing and returns cudaGetLastError() of its launch.
// The output must be zeroed by the caller.
//
// Semantics are np.histogram2d's, against float64 edges: sample s falls in
// bin (bx, by) when xe[bx] <= x_s < xe[bx+1] and ye[by] <= y_s < ye[by+1],
// the last bin of each axis closed at its upper edge; samples outside the
// edges, or NaN, are dropped. Each float32 sample is compared as the double
// it converts to exactly, so the counts equal numpy's on the same values.
//
// What bounds it: one pass over 8 (counts) or 12 (weighted) bytes per
// sample, 1.07 / 1.61 GB at 512^3 — or, on a smooth field whose samples
// crowd a few bins, the atomic traffic on those bins. The TPU kernel's
// mechanisms (one-hot matrices contracted on the MXU, bf16 Dekker splits of
// the weights, 2Sum planes, inf padding, 128-bin edge columns) do not carry
// over. Design: a grid-stride loop with float4 loads; each sample's bin is
// guessed by arithmetic on the uniform edges and corrected against the
// exact edges held in shared memory (0 or 1 steps for linspace edges, any
// monotone edges stay exact). Each block keeps a private histogram in
// shared memory (uint32 counts, 40 KB at 100 x 100; f64 weight sums, 80 KB)
// and adds it to the output with 64-bit global atomics at the end. Counts
// are aggregated per warp first: lanes that hit one bin are found with
// __match_any_sync and their leader adds the population count. Where the
// histogram does not fit a block's 227 KB of shared memory (beyond about
// 57,000 bins counted, 28,500 weighted) the block adds to the output in
// global memory directly. Counts are exact integers; weight sums are f64 added by
// atomics in an order that varies between runs (rounding-level spread).

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_moments.cuh"

namespace {

using fava::kFullMask;
using fava::launch_status;

constexpr int kHistThreads = 256;

// Bin of v against the edges e[0..nb]: e[b] <= v < e[b+1], the last bin
// closed; -1 outside [e[0], e[nb]] or for NaN. ``scale`` = nb / (e[nb] -
// e[0]) gives the guess; the walk makes it exact.
__device__ __forceinline__ int find_bin(double v, const double* e, int nb, double scale) {
  if (!(v >= e[0] && v <= e[nb])) return -1;
  const double g = (v - e[0]) * scale;
  int b = g >= 0.0 && g < (double)nb ? (int)g : (g >= (double)nb ? nb - 1 : 0);
  while (b > 0 && v < e[b]) --b;
  while (b < nb - 1 && v >= e[b + 1]) ++b;
  return b;
}

template <bool kWeighted, bool kSharedHist>
__global__ void __launch_bounds__(kHistThreads)
pdf2d_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ w, const double* __restrict__ xe,
             const double* __restrict__ ye, void* __restrict__ out, int64_t n, int nbx, int nby,
             int vec) {
  extern __shared__ double smem[];
  double* sxe = smem;
  double* sye = smem + nbx + 1;
  void* shist = sye + nby + 1;  // [nbx * nby] when kSharedHist
  const int nbins = nbx * nby;
  for (int b = threadIdx.x; b <= nbx; b += blockDim.x) sxe[b] = xe[b];
  for (int b = threadIdx.x; b <= nby; b += blockDim.x) sye[b] = ye[b];
  if constexpr (kSharedHist) {
    for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
      if constexpr (kWeighted) ((double*)shist)[b] = 0.0;
      else ((unsigned*)shist)[b] = 0u;
    }
  }
  __syncthreads();
  const double xs = nbx / (sxe[nbx] - sxe[0]);
  const double ys = nby / (sye[nby] - sye[0]);
  const int lane = threadIdx.x & 31;

  // Every lane of a warp calls this the same number of times (the loops
  // below are warp-uniform), as __match_any_sync needs.
  auto put = [&](float fx, float fy, float fw, bool valid) {
    int bin = -1;
    if (valid) {
      const int bx = find_bin((double)fx, sxe, nbx, xs);
      const int by = bx < 0 ? -1 : find_bin((double)fy, sye, nby, ys);
      bin = by < 0 ? -1 : bx * nby + by;
    }
    if constexpr (kWeighted) {
      if (bin >= 0) {
        double* h = kSharedHist ? (double*)shist : (double*)out;
        atomicAdd(&h[bin], (double)fw);
      }
    } else {
      const unsigned peers = __match_any_sync(kFullMask, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1) {
        if constexpr (kSharedHist) {
          atomicAdd(&((unsigned*)shist)[bin], (unsigned)__popc(peers));
        } else {
          atomicAdd(&((unsigned long long*)out)[bin], (unsigned long long)__popc(peers));
        }
      }
    }
  };

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x - lane;  // warp's base
  int64_t scalar_from = 0;
  if (vec) {
    const int64_t nv = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    const float4* w4 = reinterpret_cast<const float4*>(w);
    for (int64_t base = first; base < nv; base += stride) {
      const int64_t i = base + lane;
      const bool ok = i < nv;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 a = ok ? x4[i] : zero;
      const float4 c = ok ? y4[i] : zero;
      float4 u = zero;
      if constexpr (kWeighted) u = ok ? w4[i] : zero;
      put(a.x, c.x, u.x, ok);
      put(a.y, c.y, u.y, ok);
      put(a.z, c.z, u.z, ok);
      put(a.w, c.w, u.w, ok);
    }
    scalar_from = 4 * nv;
  }
  for (int64_t base = scalar_from + first; base < n; base += stride) {
    const int64_t i = base + lane;
    const bool ok = i < n;
    float u = 0.f;
    if constexpr (kWeighted) u = ok ? w[i] : 0.f;
    put(ok ? x[i] : 0.f, ok ? y[i] : 0.f, u, ok);
  }

  if constexpr (kSharedHist) {
    __syncthreads();
    for (int b = threadIdx.x; b < nbins; b += blockDim.x) {
      if constexpr (kWeighted) {
        const double v = ((double*)shist)[b];
        if (v != 0.0) atomicAdd(&((double*)out)[b], v);
      } else {
        const unsigned v = ((unsigned*)shist)[b];
        if (v != 0u) atomicAdd(&((unsigned long long*)out)[b], (unsigned long long)v);
      }
    }
  }
}

template <bool kWeighted, bool kSharedHist>
int launch_pdf2d(const float* x, const float* y, const float* w, const double* xe,
                 const double* ye, void* out, int64_t n, int nbx, int nby, int vec, int blocks,
                 size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pdf2d_kernel<kWeighted, kSharedHist>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pdf2d_kernel<kWeighted, kSharedHist>
      <<<blocks, kHistThreads, smem, stream>>>(x, y, w, xe, ye, out, n, nbx, nby, vec);
  return launch_status();
}

// Where an (nbx, nby) histogram goes on the current device: 1 in shared
// memory beside the edges, 0 in global memory (only the edges fit), -1 when
// not even the edges fit or the device cannot be queried. ``smem`` gets the
// dynamic shared memory a block needs.
int hist_mode(int nbx, int nby, bool weighted, size_t* smem) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  const size_t edges = (size_t)(nbx + nby + 2) * sizeof(double);
  const size_t hist = (size_t)nbx * nby * (weighted ? sizeof(double) : sizeof(unsigned));
  if (edges + hist <= (size_t)optin) {
    *smem = edges + hist;
    return 1;
  }
  *smem = edges;
  return edges <= (size_t)optin ? 0 : -1;
}

}  // namespace

extern "C" {

// Joint histogram of n samples (x, y), weighted by w unless w is null:
// out is (nbx, nby) int64 counts, or f64 sums when weighted.
int fava_pdf2d(const void* x, const void* y, const void* w, const void* xe, const void* ye,
               void* out, long long n, int nbx, int nby, int vec, int blocks, void* stream) {
  (void)cudaGetLastError();
  const bool weighted = w != nullptr;
  size_t smem = 0;
  const int mode = hist_mode(nbx, nby, weighted, &smem);
  if (mode < 0) return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  const float* yf = (const float*)y;
  const float* wf = (const float*)w;
  const double* xd = (const double*)xe;
  const double* yd = (const double*)ye;
  cudaStream_t st = (cudaStream_t)stream;
  if (weighted) {
    return mode == 1
               ? launch_pdf2d<true, true>(xf, yf, wf, xd, yd, out, n, nbx, nby, vec, blocks, smem, st)
               : launch_pdf2d<true, false>(xf, yf, wf, xd, yd, out, n, nbx, nby, vec, blocks, smem, st);
  }
  return mode == 1
             ? launch_pdf2d<false, true>(xf, yf, wf, xd, yd, out, n, nbx, nby, vec, blocks, smem, st)
             : launch_pdf2d<false, false>(xf, yf, wf, xd, yd, out, n, nbx, nby, vec, blocks, smem, st);
}

// hist_mode for the current device, for callers that report the path.
int fava_pdf2d_hist_mode(int nbx, int nby, int weighted) {
  size_t smem = 0;
  return hist_mode(nbx, nby, weighted != 0, &smem);
}

}  // extern "C"
