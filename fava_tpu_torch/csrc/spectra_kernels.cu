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
// (k^2 is an exact integer there; in f64 past 4095 shells, the wide walk of
// shell_bins.cuh), shell = floor(k + 0.5), cells with
// k > nbins - 0.5 dropped. Output: C f64 shell sums, C = 1 (scalar power) or
// 2 (total and longitudinal power); the counts are a shape function the
// wrapper takes from the host. kx0 is an ordinary argument: what the TPU
// passed by scalar prefetch costs nothing here, and one build serves every
// chunk.
//
// What bounds it: the read of the cells inside the last shell, 4 bytes per
// channel (51 M cells of the (128, 1024, 513) chunk at kx0 = 0, 35 M of a
// 511 x 512 x 257 volume), so device memory. Each row splits into walks
// along z in which k never decreases: a half-spectrum row from z = 0 up; a
// full-grid row twice, z = 0 .. (n-1)/2 up and z = n-1 down to the first
// negative wavenumber. The kernel is the walk of shell_bins.cuh
// (shell_walk_kernel) over UnfoldedRows: one warp a walk, 4m cells a lane
// with their float4 loads issued together, runs summed in f64 registers,
// plain shared adds, one shuffle scan a trip, per-warp histograms summed
// into the output at the end. The TPU kernel's per-slab loop over shells
// with masks is gone.
//
// Where its time goes (NVIDIA H100 80GB HBM3 at 700 W, probe_bin_regrid.py:
// builds with a part cut out): on the chunk 0.239 ms; without the binning
// (walk setup, loads, scans) 0.167, without the loads 0.207, the walk
// setup alone 0.014. Half of the cells end a run (61% of the chunk's, 50%
// of the 511-wide volume's), and the shared adds that end them cost 0.067
// ms of the chunk's. The f64 histograms (8 KB a warp at 511 shells) fill
// shared memory at 24 warps an SM; with half the warps it runs 1.6x
// slower, so it waits on latency, not on a unit's throughput.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_moments.cuh"
#include "shell_bins.cuh"

namespace {

using fava::shell_walk_kernel;
using fava::UnfoldedRows;

int launch_channels(const void* t, const void* l, void* out, int nx, int ny, int nzr, int nbins,
                    int full_nz, int kx0, int full_nx, int channels, int blocks, void* stream) {
  (void)cudaGetLastError();
  const float* tf = (const float*)t;
  const float* lf = (const float*)l;
  const UnfoldedRows rows{nx, ny, nzr, full_nz, kx0, full_nx};
  cudaStream_t st = (cudaStream_t)stream;
  if (channels == 1)
    return fava::launch_walk(shell_walk_kernel<1, false, UnfoldedRows, false>,
                             shell_walk_kernel<1, false, UnfoldedRows, true>, 1, nbins, blocks, st,
                             tf, lf, (double*)out, rows, nbins, 1);
  // Vector loads need both volumes' rows at the same offset from 16 bytes.
  const int vec = ((reinterpret_cast<uintptr_t>(t) ^ reinterpret_cast<uintptr_t>(l)) & 15) == 0;
  if (channels == 2)
    return fava::launch_walk(shell_walk_kernel<2, false, UnfoldedRows, false>,
                             shell_walk_kernel<2, false, UnfoldedRows, true>, 2, nbins, blocks, st,
                             tf, lf, (double*)out, rows, nbins, vec);
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

// Blocks of the kernel (up to kBinMaxWarps warps, channels * nbins doubles
// of shared memory a warp) that fit one SM at once; a negative CUDA error
// code on failure (also for nbins outside 1 .. kMaxWideBins).
int fava_shell_bin_unfolded_blocks_per_sm(int channels, int nbins) {
  if (channels == 1)
    return fava::walk_blocks_per_sm(shell_walk_kernel<1, false, UnfoldedRows, false>,
                                    shell_walk_kernel<1, false, UnfoldedRows, true>, 1, nbins);
  if (channels == 2)
    return fava::walk_blocks_per_sm(shell_walk_kernel<2, false, UnfoldedRows, false>,
                                    shell_walk_kernel<2, false, UnfoldedRows, true>, 2, nbins);
  return -(int)cudaErrorInvalidValue;
}

}  // extern "C"
