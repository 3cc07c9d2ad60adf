// Hopper (sm_90a) kernel of the unfolded Hermitian shell binning: B10 and,
// with a run-time x offset, the out-of-core chunk binning B6.
//
// Replaces _shell_kernel (fava_tpu/ops/pallas_kernels.py:515), reached from
// shell_bin_sums (:608) and the odd-extent branch of shell_bin_sums_rfft
// (:649-653), and _shell_kernel_chunkx (:1291), reached from
// shell_bin_values_rfft_chunk (:1516) and shell_bin_sums_rfft_chunk (:1715).
// The quadrant fold (K3) needs even x and y extents; volumes with an odd one
// (a 511-wide window) bin their (nx, ny, nzr) power volumes here directly.
// The streamed flagship step (ops/outofcore.py) bins each x-chunk of rows
// kx0 .. kx0+rows-1 of the full volume's half-spectrum as it is produced:
// the chunks' sums add up to the whole volume's. Plain C entry points,
// bound with ctypes by fava_tpu_torch/ops/_build.py; each launches on the
// caller's stream, allocates nothing and returns cudaGetLastError() of its
// launch.
//
// For each cell (i, j, z): kx is the signed FFT wavenumber of the global row
// jx = kx0 + i of an x extent full_nx (jx <= (full_nx-1)/2 ? jx : jx -
// full_nx; kx0 = 0 and full_nx = nx for a whole volume), ky that of j; on an
// rfft half-spectrum (nzr != full_nz) kz = z >= 0 and the cell carries the
// Hermitian weight wz = 1 at z = 0 and, for even full_nz, at the Nyquist
// plane z = full_nz/2, 2 elsewhere; on a full grid (nzr == full_nz) kz is
// signed as well and every weight is 1. k = sqrt(kx^2 + ky^2 + kz^2) in f32
// (k^2 is an exact integer there), shell = floor(k + 0.5), cells with
// k > nbins - 0.5 dropped. Output: C f64 shell sums, C = 1 (scalar power) or
// 2 (total and longitudinal power); the counts are a shape function the
// wrapper takes from the host. kx0 is an ordinary argument: what the TPU
// passed by scalar prefetch costs nothing here, and one build serves every
// chunk.
//
// What bounds it: the read of the volumes' cells inside the last shell
// (511 x 512 x 257 for B10, 0.27 GB per channel; a 1024^3 chunk of 128 rows,
// 0.27 GB per channel) and the histogram contention, as for K4, which it
// follows: one warp walks one (i, j) row, 32 cells at a time, f64 shared
// histogram per block, segmented shuffle scan over runs of equal shells,
// f64 atomics at the end (shell_bins.cuh). The scan needs shells that never
// decrease along the lanes: a half-spectrum row is walked from z = 0 up; a
// full-grid row in two walks, z = 0 .. (n-1)/2 up and z = n-1 .. down to
// the first negative wavenumber, so |kz| grows in both. Each walk stops at
// the first 32 cells beyond the last shell. The TPU kernel's per-slab loop
// over shells with masks is gone.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_moments.cuh"
#include "shell_bins.cuh"

namespace {

using fava::launch_status;

constexpr int kBinThreads = 256;  // 8 warps, one row each at a time

template <int C>
__global__ void __launch_bounds__(kBinThreads)
shell_bin_unfolded_kernel(const float* __restrict__ t, const float* __restrict__ l,
                          double* __restrict__ out, int nx, int ny, int nzr, int nbins,
                          int full_nz, int kx0, int full_nx) {
  extern __shared__ double hist[];  // [C][nbins]
  fava::zero_hist(hist, C * nbins);

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int64_t nrows = (int64_t)nx * ny;
  const float kmax = (float)nbins - 0.5f;
  const bool half = full_nz != nzr;
  const int z_nyq = (half && full_nz % 2 == 0) ? full_nz / 2 : -1;
  // Walk 0 covers z = 0 .. npos-1 (kz = z); walk 1 the full grid's negative
  // wavenumbers, z = nzr-1 down to npos (|kz| = 1, 2, ...).
  const int npos = half ? nzr : (nzr - 1) / 2 + 1;

  for (int64_t row = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5); row < nrows;
       row += (int64_t)gridDim.x * warps) {
    const int jx = kx0 + (int)(row / ny);
    const int j = (int)(row % ny);
    const int kx = jx <= (full_nx - 1) / 2 ? jx : jx - full_nx;
    const int ky = j <= (ny - 1) / 2 ? j : j - ny;
    const int ij2 = kx * kx + ky * ky;
    const int64_t off = row * nzr;
    for (int walk = 0; walk < 2; ++walk) {
      const int len = walk == 0 ? npos : nzr - npos;
      for (int p0 = 0; p0 < len; p0 += 32) {
        // Warp-uniform: |kz| grows along the walk, so every later cell is
        // out of range too.
        const int kz0 = walk == 0 ? p0 : p0 + 1;
        if (sqrtf((float)(ij2 + kz0 * kz0)) > kmax) break;
        const int p = p0 + lane;
        int shell = nbins;  // sentinel: bins nothing, sorts after every shell
        double v[C] = {};
        if (p < len) {
          const int kz = walk == 0 ? p : p + 1;
          const int z = walk == 0 ? p : nzr - 1 - p;
          const float k = sqrtf((float)(ij2 + kz * kz));
          if (k <= kmax) {
            shell = min((int)floorf(k + 0.5f), nbins - 1);
            const double w = (half && z != 0 && z != z_nyq) ? 2.0 : 1.0;
            v[0] = w * (double)t[off + z];
            if constexpr (C == 2) v[1] = w * (double)l[off + z];
          }
        }
        fava::warp_bin_add<C>(shell, v, hist, nbins, lane);
      }
    }
  }
  fava::flush_hist(hist, out, C * nbins);
}

template <int C>
int launch_unfolded(const float* t, const float* l, double* out, int nx, int ny, int nzr,
                    int nbins, int full_nz, int kx0, int full_nx, int blocks,
                    cudaStream_t stream) {
  const size_t smem = C * (size_t)nbins * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        shell_bin_unfolded_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  shell_bin_unfolded_kernel<C><<<blocks, kBinThreads, smem, stream>>>(
      t, l, out, nx, ny, nzr, nbins, full_nz, kx0, full_nx);
  return launch_status();
}

int launch_channels(const void* t, const void* l, void* out, int nx, int ny, int nzr, int nbins,
                    int full_nz, int kx0, int full_nx, int channels, int blocks, void* stream) {
  (void)cudaGetLastError();
  const float* tf = (const float*)t;
  const float* lf = (const float*)l;
  double* o = (double*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (channels == 1)
    return launch_unfolded<1>(tf, lf, o, nx, ny, nzr, nbins, full_nz, kx0, full_nx, blocks, st);
  if (channels == 2)
    return launch_unfolded<2>(tf, lf, o, nx, ny, nzr, nbins, full_nz, kx0, full_nx, blocks, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// B10: a whole volume (kx0 = 0, full_nx = nx).
int fava_shell_bin_sums_unfolded(const void* t, const void* l, void* out, int nx, int ny, int nzr,
                                 int nbins, int full_nz, int channels, int blocks, void* stream) {
  return launch_channels(t, l, out, nx, ny, nzr, nbins, full_nz, 0, nx, channels, blocks, stream);
}

// B6: rows kx0 .. kx0+rows-1 of the half-spectrum of a full_nx-wide volume.
int fava_shell_bin_sums_rfft_chunk(const void* t, const void* l, void* out, int rows, int ny,
                                   int nzr, int nbins, int full_nx, int full_nz, int kx0,
                                   int channels, int blocks, void* stream) {
  return launch_channels(t, l, out, rows, ny, nzr, nbins, full_nz, kx0, full_nx, channels, blocks,
                         stream);
}

}  // extern "C"
