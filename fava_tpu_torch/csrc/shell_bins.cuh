// Shell-binning building blocks shared by the folded binning kernel (K4 in
// flagship_kernels.cu), the unfolded one (B10 in spectra_kernels.cu) and the
// fused powers binning (B9 in fused_spectra_kernels.cu): a warp adds 32
// consecutive cells of one row to a block's shared-memory histogram of C
// channels, and the block adds its histogram to the output.

#pragma once

#include <cuda_runtime.h>

#include "row_moments.cuh"

namespace fava {

// Unfold multiplicity of index idx of a folded axis of extent n: 1 for the
// self-conjugate indices (0 and, for even n, n/2), 2 for the others.
__device__ __forceinline__ double hermitian_mult(int idx, int n) {
  return (idx == 0 || (n % 2 == 0 && 2 * idx == n)) ? 1.0 : 2.0;
}

// Adds v[c] of every lane to hist[c * nbins + shell]; lanes with shell ==
// nbins add nothing. Along the 32 lanes the shell must never decrease (the
// kernels walk each row outwards in |k|, dropped lanes last), so the lanes
// of one shell form one contiguous run: a 5-step segmented shuffle scan sums
// each run and only its last lane touches shared memory.
template <int C>
__device__ __forceinline__ void warp_bin_add(int shell, double (&v)[C], double* hist, int nbins,
                                             int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    double u[C];
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = __shfl_up_sync(kFullMask, v[c], o);
    const int us = __shfl_up_sync(kFullMask, shell, o);
    if (lane >= o && us == shell) {
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] += u[c];
    }
  }
  const int next = __shfl_down_sync(kFullMask, shell, 1);
  if (shell < nbins && (lane == 31 || next != shell)) {
#pragma unroll
    for (int c = 0; c < C; ++c) atomicAdd(&hist[c * nbins + shell], v[c]);
  }
}

__device__ __forceinline__ void zero_hist(double* hist, int n) {
  for (int b = threadIdx.x; b < n; b += blockDim.x) hist[b] = 0.0;
  __syncthreads();
}

// Adds the block's histogram to the output with f64 global atomics (their
// order varies between runs: the sums agree to rounding).
__device__ __forceinline__ void flush_hist(const double* hist, double* out, int n) {
  __syncthreads();
  for (int b = threadIdx.x; b < n; b += blockDim.x) {
    const double v = hist[b];
    if (v != 0.0) atomicAdd(&out[b], v);
  }
}

}  // namespace fava
