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
constexpr int kBinThreads = 256;  // threads of a binning block (8 warps)

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
// integer k^2 is exact in f32), shell = floor(k + 0.5), cells with
// k > nbins - 0.5 or j > ny/2 dropped; each channel's f64 shell sum gains
// wz * value with wz = 1 on self-conjugate z planes (0, and nz/2 for even
// nz) and 2 elsewhere.
//
// What bounds it: the TPU kernel looped over shells with masks, so it was
// bound by the loop. Here each cell is touched once, and the limit is
// contention on the histogram: neighbouring cells fall in the same shell.
// Design: blocks run in parallel with no order, so nothing carries between
// them; each block keeps its own C x nbins f64 histogram in shared memory
// (sized from nbins at run time) and adds it to the output with f64 global
// atomics at the end. A warp walks one (i, j) row along z, 32 cells at a
// time (coalesced loads), and sums runs of equal shells with a segmented
// shuffle scan before touching shared memory (shell_bins.cuh). Rows and row
// tails beyond the last shell are skipped without reading them. The
// single-channel variant is the same kernel without the second channel's
// loads, scan and atomics.
//
// The one-pass folded binning B11a, replacing _shell_kernel_folded
// (pallas_kernels.py:758), is this kernel with kCounts: a leading count
// channel of weight mx * my * wz (the unfold multiplicities of the row's x
// and y indices, from full_nx and full_ny) beside the two value channels;
// out is then [counts, total, longi]. Its counts equal the static
// _folded_counts exactly (integer weights summed in f64). B11b, replacing
// the row-chunked _shell_kernel_folded_v2 (:851), is K4's values-only launch
// on a fold with rows >= ny/2+1 (fava_tpu pads them to a multiple of 8):
// rows past ny/2 are skipped unread, whatever they hold.

template <int C, bool kCounts>
__global__ void __launch_bounds__(kBinThreads)
shell_bin_folded_kernel(const float* __restrict__ t, const float* __restrict__ l,
                        double* __restrict__ out, int nxh, int rows, int nzr, int nbins,
                        int full_nx, int full_ny, int full_nz) {
  constexpr int kOff = kCounts ? 1 : 0;  // value channels follow the count channel
  constexpr int kOut = C + kOff;
  extern __shared__ double hist[];  // [kOut][nbins]
  fava::zero_hist(hist, kOut * nbins);

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int64_t nrows = (int64_t)nxh * rows;
  const float kmax = (float)nbins - 0.5f;
  const int ny_half = full_ny / 2;
  const int z_nyq = (full_nz % 2 == 0) ? full_nz / 2 : -1;

  for (int64_t row = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5); row < nrows;
       row += (int64_t)gridDim.x * warps) {
    const int i = (int)(row / rows);
    const int j = (int)(row % rows);
    if (j > ny_half) continue;  // fold padding rows bin nothing (warp-uniform)
    const int ij2 = i * i + j * j;
    const int64_t off = row * nzr;
    double mxy = 0.0;
    if constexpr (kCounts) mxy = fava::hermitian_mult(i, full_nx) * fava::hermitian_mult(j, full_ny);
    for (int z0 = 0; z0 < nzr; z0 += 32) {
      // Warp-uniform: k grows with z, so every later cell is out of range.
      if (sqrtf((float)(ij2 + z0 * z0)) > kmax) break;
      const int z = z0 + lane;
      int shell = nbins;  // sentinel: bins nothing, sorts after every shell
      double v[kOut] = {};
      if (z < nzr) {
        const float k = sqrtf((float)(ij2 + z * z));
        if (k <= kmax) {
          shell = min((int)floorf(k + 0.5f), nbins - 1);
          const double wz = (z == 0 || z == z_nyq) ? 1.0 : 2.0;
          if constexpr (kCounts) v[0] = wz * mxy;
          v[kOff] = wz * (double)t[off + z];
          if constexpr (C == 2) v[kOff + 1] = wz * (double)l[off + z];
        }
      }
      fava::warp_bin_add<kOut>(shell, v, hist, nbins, lane);
    }
  }
  fava::flush_hist(hist, out, kOut * nbins);
}

template <int C, bool kCounts>
int launch_shell_bin_folded(const float* t, const float* l, double* out, int nxh, int rows,
                            int nzr, int nbins, int full_nx, int full_ny, int full_nz,
                            int blocks, cudaStream_t stream) {
  const size_t smem = (C + (kCounts ? 1 : 0)) * (size_t)nbins * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(shell_bin_folded_kernel<C, kCounts>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  shell_bin_folded_kernel<C, kCounts><<<blocks, kBinThreads, smem, stream>>>(
      t, l, out, nxh, rows, nzr, nbins, full_nx, full_ny, full_nz);
  return launch_status();
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

}  // extern "C"
