// Hopper (sm_90a) kernels of the flagship analysis step.
//
// Four kernels (K4 in a one- and a two-channel form, and with a count
// channel as B11a), each the counterpart of one Pallas kernel of
// fava_tpu/ops/pallas_kernels.py. Plain C entry
// points (bound with ctypes by fava_tpu_torch/ops/_build.py); each launches
// on the caller's stream, allocates nothing, and returns cudaGetLastError()
// of its launch. The
// Python wrappers in fava_tpu_torch/ops/cuda_kernels.py check devices,
// dtypes, shapes and contiguity before calling in.
//
// Inputs are float32 field/power volumes; every accumulator is float64
// (Hopper has native f64, so the TPU's two-stage f32 sums are not needed).

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_moments.cuh"
#include "shell_bins.cuh"

namespace {

using fava::CenteredCell;
using fava::kFullMask;
using fava::launch_status;
using fava::RawCell;
using fava::row_sweep;

constexpr int kRowThreads = 256;  // threads of a row-moment block

// ---------------------------------------------------------------------------
// Per-row moments (K1, K2).
//
// K1 replaces _moments_kernel (pallas_kernels.py:95) and K2 replaces
// _centered_kernel (pallas_kernels.py:200). Both read four volumes once and
// do ~20 flops per cell, far below the card's f64 rate: they are bound by
// device-memory bandwidth (2 GiB per pass at 512^3 f32). Design: one block
// per x row (the row is one contiguous ny*nz run of each field), 16-byte
// vector loads where alignment allows, f64 register partials per thread,
// then a warp-shuffle and shared-memory block reduction. Each row's sums are
// written by one block, so results are deterministic and need no atomics.
// The TPU's sequential grid carried nothing between rows either, so the
// design maps directly; K2 reads the row means from a device pointer in
// place of the TPU's scalar prefetch. The cell functors and the row sweep
// live in row_moments.cuh, shared with the AMR block-stack kernels K5, K6.

// Sums acc[m] over the block and stores it at out[m * stride + col].
template <int N>
__device__ __forceinline__ void block_sum_store(double (&acc)[N], double* __restrict__ out,
                                                int64_t stride, int64_t col) {
  constexpr int kWarps = kRowThreads / 32;
  __shared__ double partial[N][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    double v = acc[m];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
    if (lane == 0) partial[m][warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int m = 0; m < N; ++m) {
      double v = lane < kWarps ? partial[m][lane] : 0.0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
      if (lane == 0) out[m * stride + col] = v;
    }
  }
}

__global__ void __launch_bounds__(kRowThreads)
row_moments_kernel(const float* __restrict__ d, const float* __restrict__ vx,
                   const float* __restrict__ vy, const float* __restrict__ vz,
                   double* __restrict__ out, int64_t nx, int64_t len, int vec) {
  const int64_t x = blockIdx.x;
  const int64_t off = x * len;
  double acc[13] = {};
  row_sweep(d + off, vx + off, vy + off, vz + off, len, vec != 0, (int)threadIdx.x,
            (int)blockDim.x, acc, RawCell{});
  block_sum_store(acc, out, nx, x);
}

__global__ void __launch_bounds__(kRowThreads)
centered_row_moments_kernel(const float* __restrict__ d, const float* __restrict__ vx,
                            const float* __restrict__ vy, const float* __restrict__ vz,
                            const double* __restrict__ means, double* __restrict__ out,
                            int64_t nx, int64_t len, int vec) {
  const int64_t x = blockIdx.x;
  const int64_t off = x * len;
  const CenteredCell cell{means[x], means[nx + x], means[2 * nx + x]};
  double acc[9] = {};
  row_sweep(d + off, vx + off, vy + off, vz + off, len, vec != 0, (int)threadIdx.x,
            (int)blockDim.x, acc, cell);
  block_sum_store(acc, out, nx, x);
}

// ---------------------------------------------------------------------------
// Quadrant fold (K3), replacing _fold_pair_kernel (pallas_kernels.py:678).
//
// out[i, j, z] = sum of in[+-i, +-j, z] over the distinct mirror partners,
// for i <= nx/2, j <= ny/2. Self-paired slabs (index 0 and, for even
// extents, the Nyquist index n/2) are counted once. Bound by device memory:
// each input element is read once and a quarter of it is written. One
// thread per output element, neighbouring threads on neighbouring z, so
// every load and store is coalesced. The TPU version folded y with an exact
// 0/1 matmul to avoid relayouts; here the mirror rows are plain strided
// loads. The output has exactly ny/2+1 rows (no pad to 8). The sum order
// (in[i,j] + in[im,j]) + (in[i,jm] + in[im,jm]) is the plain version's.

__global__ void fold_pair_kernel(const float* __restrict__ t, const float* __restrict__ l,
                                 float* __restrict__ to, float* __restrict__ lo, int nx, int ny,
                                 int nzr, int nxh, int nyh) {
  const int64_t n = (int64_t)nxh * nyh * nzr;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int z = (int)(idx % nzr);
    const int64_t r = idx / nzr;
    const int j = (int)(r % nyh);
    const int i = (int)(r / nyh);
    const int im = (i > 0 && 2 * i != nx) ? nx - i : -1;
    const int jm = (j > 0 && 2 * j != ny) ? ny - j : -1;
    const int64_t p = ((int64_t)i * ny + j) * nzr + z;
    float at = t[p], al = l[p];
    if (im >= 0) {
      const int64_t q = ((int64_t)im * ny + j) * nzr + z;
      at += t[q];
      al += l[q];
    }
    if (jm >= 0) {
      const int64_t q = ((int64_t)i * ny + jm) * nzr + z;
      float bt = t[q], bl = l[q];
      if (im >= 0) {
        const int64_t s = ((int64_t)im * ny + jm) * nzr + z;
        bt += t[s];
        bl += l[s];
      }
      at += bt;
      al += bl;
    }
    to[idx] = at;
    lo[idx] = al;
  }
}

// ---------------------------------------------------------------------------
// Folded shell binning (K4), replacing _shell_kernel_folded_v3
// (pallas_kernels.py:955, defer_rows=True), with C = 2 channels (total and
// longitudinal power, the KE spectra) or C = 1 (one power volume, the scalar
// spectra: shell_bin_sums_rfft_scalar, pallas_kernels.py:1271).
//
// For each folded cell (i, j, z): k = sqrt(i^2 + j^2 + z^2) in f32 (the
// integer k^2 is exact in f32; past 4095 shells, the wide walk of
// shell_bins.cuh, in f64), shell = floor(k + 0.5), cells with
// k > nbins - 0.5 or j > ny/2 dropped; each channel's f64 shell sum gains
// wz * value with wz = 1 on self-conjugate z planes (0, and nz/2 for even
// nz) and 2 elsewhere.
//
// What bounds it: the read of the cells inside the last shell, 4 bytes a
// channel (8.7 M cells of the 512^3 fold, 0.021 ms at 3.35 TB/s for two
// channels). The TPU kernel looped over shells with masks; here each cell
// is touched once. Design: the walk of shell_bins.cuh (shell_walk_kernel)
// over FoldedRows, the kernel of B6/B10: one warp a folded row along z,
// only as far as the last shell (first_kz_outside); 4m consecutive cells a
// lane, their float4 loads issued together behind a masked head (rows of
// nzr = 257 cells alternate 4-byte offsets from 16 bytes); each cell's
// shell from the block's table of class thresholds, no square root; runs
// of one shell summed in f64 registers and added to the warp's own
// histogram with plain shared adds; one segmented shuffle scan a trip;
// blocks of as many warps as shared memory holds histograms for, one wave.
// Rows past ny/2 are skipped unread.
//
// The one-pass folded binning B11a, replacing _shell_kernel_folded
// (pallas_kernels.py:758), is this kernel with kCounts: a leading count
// channel of weight mx * my * wz (the unfold multiplicities of the row's x
// and y indices, from full_nx and full_ny), summed a run at a time beside
// the two value channels; out is then [counts, total, longi]. Its counts
// equal the static _folded_counts exactly (integer weights summed in f64).
// B11b, replacing the row-chunked _shell_kernel_folded_v2 (:851), is K4's
// values-only launch on a fold with rows >= ny/2+1 (fava_tpu pads them to
// a multiple of 8): rows past ny/2 are skipped unread, whatever they hold.

using fava::FoldedRows;
using fava::shell_walk_kernel;

template <int C, bool kCounts>
int launch_shell_bin_folded(const float* t, const float* l, double* out, int nxh, int rows,
                            int nzr, int nbins, int full_nx, int full_ny, int full_nz,
                            int blocks, cudaStream_t stream) {
  // Vector loads need both volumes' rows at the same offset from 16 bytes.
  const int vec = C == 1 || ((reinterpret_cast<uintptr_t>(t) ^ reinterpret_cast<uintptr_t>(l)) & 15) == 0;
  return fava::launch_walk(shell_walk_kernel<C, kCounts, FoldedRows, false>,
                           shell_walk_kernel<C, kCounts, FoldedRows, true>, C + kCounts, nbins,
                           blocks, stream, t, l, out,
                           FoldedRows{nxh, rows, nzr, full_nz, full_nx, full_ny}, nbins, vec);
}

template <int C, bool kCounts>
int folded_blocks_per_sm(int nbins) {
  return fava::walk_blocks_per_sm(shell_walk_kernel<C, kCounts, FoldedRows, false>,
                                  shell_walk_kernel<C, kCounts, FoldedRows, true>, C + kCounts, nbins);
}

}  // namespace

extern "C" {

const char* fava_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int fava_row_moments(const void* d, const void* vx, const void* vy, const void* vz, void* out,
                     long long nx, long long row_len, int vec, void* stream) {
  (void)cudaGetLastError();
  row_moments_kernel<<<(unsigned)nx, kRowThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)vx, (const float*)vy, (const float*)vz, (double*)out, nx,
      row_len, vec);
  return launch_status();
}

int fava_centered_row_moments(const void* d, const void* vx, const void* vy, const void* vz,
                              const void* means, void* out, long long nx, long long row_len,
                              int vec, void* stream) {
  (void)cudaGetLastError();
  centered_row_moments_kernel<<<(unsigned)nx, kRowThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)vx, (const float*)vy, (const float*)vz,
      (const double*)means, (double*)out, nx, row_len, vec);
  return launch_status();
}

int fava_fold_quadrants_pair(const void* t, const void* l, void* to, void* lo, int nx, int ny,
                             int nzr, int blocks, void* stream) {
  (void)cudaGetLastError();
  fold_pair_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)t, (const float*)l, (float*)to, (float*)lo, nx, ny, nzr, nx / 2 + 1,
      ny / 2 + 1);
  return launch_status();
}

int fava_shell_bin_values_folded(const void* t, const void* l, void* out, int nxh, int rows,
                                 int nzr, int nbins, int full_ny, int full_nz, int channels,
                                 int blocks, void* stream) {
  (void)cudaGetLastError();
  const float* tf = (const float*)t;
  const float* lf = (const float*)l;
  double* o = (double*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (channels == 1)
    return launch_shell_bin_folded<1, false>(tf, lf, o, nxh, rows, nzr, nbins, 0, full_ny, full_nz,
                                             blocks, st);
  if (channels == 2)
    return launch_shell_bin_folded<2, false>(tf, lf, o, nxh, rows, nzr, nbins, 0, full_ny, full_nz,
                                             blocks, st);
  return (int)cudaErrorInvalidValue;
}

// B11a: out is (3, nbins) [counts, total, longi].
int fava_shell_bin_sums_folded_onepass(const void* t, const void* l, void* out, int nxh, int rows,
                                       int nzr, int nbins, int full_nx, int full_ny, int full_nz,
                                       int blocks, void* stream) {
  (void)cudaGetLastError();
  return launch_shell_bin_folded<2, true>((const float*)t, (const float*)l, (double*)out, nxh,
                                          rows, nzr, nbins, full_nx, full_ny, full_nz, blocks,
                                          (cudaStream_t)stream);
}

// Blocks of the folded kernel with ``channels`` value channels (1 or 2;
// ``counts``: B11a's, with its count channel) that fit one SM at once; a
// negative CUDA error code on failure (also for nbins outside 1 ..
// kMaxWideBins).
int fava_shell_bin_folded_blocks_per_sm(int channels, int counts, int nbins) {
  if (counts) return channels == 2 ? folded_blocks_per_sm<2, true>(nbins) : -(int)cudaErrorInvalidValue;
  if (channels == 1) return folded_blocks_per_sm<1, false>(nbins);
  if (channels == 2) return folded_blocks_per_sm<2, false>(nbins);
  return -(int)cudaErrorInvalidValue;
}

}  // extern "C"
