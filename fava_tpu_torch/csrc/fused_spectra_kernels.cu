// Hopper (sm_90a) kernel of the fused spectral powers, quadrant fold and
// Hermitian shell binning (B9), straight from the three velocity transforms.
//
// Replaces _powers_fold_bin_kernel (fava_tpu/ops/pallas_kernels.py:1539),
// entry shell_bin_powers_fused (:1697). Plain C entry point, bound with
// ctypes by fava_tpu_torch/ops/_build.py; it launches on the caller's
// stream, allocates nothing and returns cudaGetLastError() of its launch.
//
// Input: the normalized rfft half-spectra w_c (c = x, y, z velocity
// component) of an (nx, ny, nz) volume, even nx and ny, as a stack of three
// (nx, ny, nzr = nz/2+1) complex64 volumes: either cuFFT's interleaved
// output read directly (8-byte float2 loads) or two planar float32 stacks.
// For each folded cell (i <= nx/2, j <= ny/2, z) the kernel takes its up to
// four partners (+-i, +-j): the mirror row nx - i exists for 0 < i < nx/2
// and ny - j for 0 < j < ny/2, as the fold K3 decides. Each partner's total
// power is 0.5 sum_c |w_c|^2 and its longitudinal power |k.w|^2 / max(k^2,
// 1) with the Nyquist split of ops/spectra.py:86-95: the partner's own
// signed kx, ky (a mirror row is never a Nyquist row); on the kz = 0 plane
// |reg - nyq|^2, elsewhere |reg|^2 + |nyq|^2. The partners' powers are
// summed in the plain fold's order, ((i, j) + (-i, j)) + ((i, -j) + (-i,
// -j)), and binned as K4 bins a folded cell: k = sqrt(i^2 + j^2 + z^2) in f32,
// shell floor(k + 0.5), cells beyond nbins - 0.5 dropped, Hermitian z weight
// wz. Output (3, nbins) f64: [counts (weight mx * my * wz), total, longi];
// the counts equal the static _folded_counts exactly (integer weights in
// f64). Powers are formed in f64 registers from the f32 values, so the
// kernel differs from its plain f64 twin only in summation order.
//
// What bounds it: the read of the transforms' cells inside the last shell,
// 24 bytes per partner cell (~0.83 GB of the 1.62 GB at 512^3, 0.25 ms at
// 3.35 TB/s); ~60 f64 operations per partner cell are far below the card's
// rate. The power volumes (two f32 volumes written and read again, and the
// ~40 eager passes that form them) and the fold's volumes are never
// materialized. Design: K4's walk. One warp takes one folded row (i, j) and
// walks z upward 32 cells at a time: the partner rows are contiguous along
// z, so each of the up-to-12 loads of a step is coalesced (256 contiguous
// bytes per warp in the interleaved layout); the walk stops at the first 32
// cells beyond the last shell, so cells outside it are never read. Shells
// never decrease along the lanes, so the warp sums runs of equal shells with
// the segmented scan of shell_bins.cuh before one shared-memory atomic per
// run; each block keeps a 3 x nbins f64 histogram and adds it to the output
// with f64 global atomics. The TPU kernel's mirror-slab refs, anti-diagonal
// y-fold matmul and per-shell mask loop are gone.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_moments.cuh"
#include "shell_bins.cuh"

namespace {

using fava::launch_status;

constexpr int kBinThreads = 256;  // 8 warps, one folded row each at a time

// One axis's wavenumber split: the conjugate-even part r and the Nyquist
// magnitude n (nonzero only at an even extent's index n/2, where r = 0).
struct Wave {
  double r, n;
};

__device__ __forceinline__ Wave own_wave(int idx, int n) {
  return 2 * idx == n ? Wave{0.0, 0.5 * n} : Wave{(double)idx, 0.0};
}

// The three components of one cell of the stacked transforms.
template <bool kInterleaved>
struct Stack {
  const float* re;  // interleaved: the complex stack as (re, im) float pairs
  const float* im;  // planar only
  int64_t cells;    // cells per component

  __device__ __forceinline__ void load(int64_t idx, double (&wr)[3], double (&wi)[3]) const {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if constexpr (kInterleaved) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(re) + c * cells + idx);
        wr[c] = v.x;
        wi[c] = v.y;
      } else {
        wr[c] = __ldg(re + c * cells + idx);
        wi[c] = __ldg(im + c * cells + idx);
      }
    }
  }
};

// Total and longitudinal power of one partner cell.
template <bool kInterleaved>
__device__ __forceinline__ void partner_powers(const Stack<kInterleaved>& s, int64_t idx, Wave kx,
                                               Wave ky, Wave kz, bool kz0, double inv_k2,
                                               double& tot, double& lon) {
  double wr[3], wi[3];
  s.load(idx, wr, wi);
  tot = 0.5 * ((wr[0] * wr[0] + wi[0] * wi[0]) + (wr[1] * wr[1] + wi[1] * wi[1]) +
               (wr[2] * wr[2] + wi[2] * wi[2]));
  const double reg_r = kx.r * wr[0] + ky.r * wr[1] + kz.r * wr[2];
  const double reg_i = kx.r * wi[0] + ky.r * wi[1] + kz.r * wi[2];
  const double nyq_r = kx.n * wr[0] + ky.n * wr[1] + kz.n * wr[2];
  const double nyq_i = kx.n * wi[0] + ky.n * wi[1] + kz.n * wi[2];
  double p;
  if (kz0) {
    const double a = reg_r - nyq_r, b = reg_i - nyq_i;
    p = a * a + b * b;
  } else {
    p = (reg_r * reg_r + reg_i * reg_i) + (nyq_r * nyq_r + nyq_i * nyq_i);
  }
  lon = p * inv_k2;
}

template <bool kInterleaved>
__global__ void __launch_bounds__(kBinThreads)
powers_fold_bin_kernel(Stack<kInterleaved> s, double* __restrict__ out, int nx, int ny, int nzr,
                       int nbins, int full_nz) {
  extern __shared__ double hist[];  // [3][nbins]: counts, total, longi
  fava::zero_hist(hist, 3 * nbins);

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int nyh = ny / 2 + 1;
  const int64_t nrows = (int64_t)(nx / 2 + 1) * nyh;
  const float kmax = (float)nbins - 0.5f;
  const int z_nyq = (full_nz % 2 == 0) ? full_nz / 2 : -1;

  for (int64_t row = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5); row < nrows;
       row += (int64_t)gridDim.x * warps) {
    const int i = (int)(row / nyh);
    const int j = (int)(row % nyh);
    // Warp-uniform: whether the mirror rows exist.
    const bool x_pair = i > 0 && 2 * i < nx;
    const bool y_pair = j > 0 && 2 * j < ny;
    const Wave kx = own_wave(i, nx), kxm{-(double)i, 0.0};
    const Wave ky = own_wave(j, ny), kym{-(double)j, 0.0};
    const double mxy = (x_pair ? 2.0 : 1.0) * (y_pair ? 2.0 : 1.0);
    const int ij2 = i * i + j * j;
    const int64_t p00 = ((int64_t)i * ny + j) * nzr;
    const int64_t p10 = ((int64_t)(nx - i) * ny + j) * nzr;
    const int64_t p01 = ((int64_t)i * ny + (ny - j)) * nzr;
    const int64_t p11 = ((int64_t)(nx - i) * ny + (ny - j)) * nzr;
    for (int z0 = 0; z0 < nzr; z0 += 32) {
      // Warp-uniform: k grows with z, so every later cell is out of range.
      if (sqrtf((float)(ij2 + z0 * z0)) > kmax) break;
      const int z = z0 + lane;
      int shell = nbins;  // sentinel: bins nothing, sorts after every shell
      double v[3] = {};
      if (z < nzr) {
        const float k = sqrtf((float)(ij2 + z * z));
        if (k <= kmax) {
          shell = min((int)floorf(k + 0.5f), nbins - 1);
          const Wave kz = own_wave(z, full_nz);
          const bool kz0 = z == 0;
          const double inv_k2 = 1.0 / fmax((double)(ij2 + z * z), 1.0);
          double t, l, tq, lq;
          partner_powers(s, p00 + z, kx, ky, kz, kz0, inv_k2, t, l);
          if (x_pair) {
            partner_powers(s, p10 + z, kxm, ky, kz, kz0, inv_k2, tq, lq);
            t += tq;
            l += lq;
          }
          if (y_pair) {
            double ty, ly;
            partner_powers(s, p01 + z, kx, kym, kz, kz0, inv_k2, ty, ly);
            if (x_pair) {
              partner_powers(s, p11 + z, kxm, kym, kz, kz0, inv_k2, tq, lq);
              ty += tq;
              ly += lq;
            }
            t += ty;
            l += ly;
          }
          const double wz = (z == 0 || z == z_nyq) ? 1.0 : 2.0;
          v[0] = wz * mxy;
          v[1] = wz * t;
          v[2] = wz * l;
        }
      }
      fava::warp_bin_add<3>(shell, v, hist, nbins, lane);
    }
  }
  fava::flush_hist(hist, out, 3 * nbins);
}

template <bool kInterleaved>
int launch_powers_fold_bin(Stack<kInterleaved> s, double* out, int nx, int ny, int nzr, int nbins,
                           int full_nz, int blocks, cudaStream_t stream) {
  const size_t smem = 3 * (size_t)nbins * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(powers_fold_bin_kernel<kInterleaved>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  powers_fold_bin_kernel<kInterleaved><<<blocks, kBinThreads, smem, stream>>>(s, out, nx, ny, nzr,
                                                                             nbins, full_nz);
  return launch_status();
}

}  // namespace

extern "C" {

// re, im: the planar stacks, or (interleaved != 0) re is the complex stack
// and im is unused. out: (3, nbins) f64, zeroed by the caller.
int fava_shell_bin_powers_fused(const void* re, const void* im, void* out, int nx, int ny, int nzr,
                                int nbins, int full_nz, int interleaved, int blocks, void* stream) {
  (void)cudaGetLastError();
  const int64_t cells = (int64_t)nx * ny * nzr;
  double* o = (double*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (interleaved)
    return launch_powers_fold_bin(Stack<true>{(const float*)re, nullptr, cells}, o, nx, ny, nzr,
                                  nbins, full_nz, blocks, st);
  return launch_powers_fold_bin(Stack<false>{(const float*)re, (const float*)im, cells}, o, nx, ny,
                                nzr, nbins, full_nz, blocks, st);
}

}  // extern "C"
