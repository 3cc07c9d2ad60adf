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
// output read directly (float4 loads of two complex cells) or two planar
// float32 stacks.
// For each folded cell (i <= nx/2, j <= ny/2, z) the kernel takes its up to
// four partners (+-i, +-j): the mirror row nx - i exists for 0 < i < nx/2
// and ny - j for 0 < j < ny/2, as the fold K3 decides. Each partner's total
// power is 0.5 sum_c |w_c|^2 and its longitudinal power |k.w|^2 / max(k^2,
// 1) with the Nyquist split of ops/spectra.py:86-95: the partner's own
// signed kx, ky (a mirror row is never a Nyquist row); on the kz = 0 plane
// |reg - nyq|^2, elsewhere |reg|^2 + |nyq|^2. The partners' powers are
// summed in the plain fold's order, ((i, j) + (-i, j)) + ((i, -j) + (-i,
// -j)), and binned as K4 bins a folded cell: k = sqrt(i^2 + j^2 + z^2) in f32
// (in f64 past 4095 shells), shell floor(k + 0.5), cells beyond nbins - 0.5
// dropped, Hermitian z weight wz. Output (3, nbins) f64: [counts (weight
// mx * my * wz), total, longi]; the counts equal the static _folded_counts
// exactly (integer weights in f64). Powers are formed in f64 registers from the f32 values, so the
// kernel differs from its plain f64 twin only in summation order.
//
// What bounds it: the read of the transforms' cells inside the last shell,
// 24 bytes per partner cell (~0.83 GB of the 1.62 GB at 512^3, 0.25 ms at
// 3.35 TB/s); ~60 f64 operations per partner cell are far below the card's
// rate. The power volumes (two f32 volumes written and read again, and the
// ~40 eager passes that form them) and the fold's volumes are never
// materialized. Design: the walk of shell_bins.cuh. One warp takes one
// folded row (i, j) and walks z upward only as far as the last shell
// (first_kz_outside); each lane takes a span of kSpan consecutive cells of
// the four partner rows, all of them contiguous along z, and issues every
// load of the span (4 partners x 3 components) before any arithmetic, so
// one memory latency serves them all. In the interleaved layout a float4
// holds two complex cells; in the planar one a float4 holds four floats of
// re or im. Rows start at any 8-byte (interleaved) or 4-byte (planar)
// offset, so the lanes' spans start at a head of up to 1 (3) cells before
// the row, masked; the partner rows and components share the (i, j) row's
// offset from 16 bytes (even nx and ny), except a planar y-partner at an
// odd nzr and a planar im stack at another offset than re, which take
// scalar loads. Each cell's shell comes from the block's table of class
// thresholds, runs of one shell are summed in f64 registers and added to
// the warp's own histogram with plain shared adds, the span-end runs meet
// in one segmented shuffle scan a trip of 32 kSpan cells; blocks of as many
// warps as shared memory holds 3-channel histograms for, one wave. The TPU
// kernel's mirror-slab refs, anti-diagonal y-fold matmul and per-shell
// mask loop are gone.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_moments.cuh"
#include "shell_bins.cuh"

namespace {

using fava::Run;

// Cells of a lane's span: one float4 of each stream in the interleaved
// layout (two complex cells), one of re and one of im in the planar one
// (four cells); and the blocks an SM that the registers must leave room
// for (the loads of a span take 24 kSpan registers, and more spill).
template <bool kInterleaved>
struct Layout {
  static constexpr int kSpan = kInterleaved ? 2 : 4;
  static constexpr int kMinBlocks = kInterleaved ? 2 : 1;
};

// One axis's wavenumber split: the conjugate-even part r and the Nyquist
// magnitude n (nonzero only at an even extent's index n/2, where r = 0).
struct Wave {
  double r, n;
};

__device__ __forceinline__ Wave own_wave(int idx, int n) {
  return 2 * idx == n ? Wave{0.0, 0.5 * n} : Wave{(double)idx, 0.0};
}

// The three components' transforms: cells per component, and either the
// complex stack as (re, im) float pairs (kInterleaved) or two planar
// float stacks.
template <bool kInterleaved>
struct Stack {
  const float* re;
  const float* im;
  int64_t cells;
};

// One partner row's span: the three components at kSpan cells.
template <int kSpan>
struct Span {
  float re[3][kSpan], im[3][kSpan];
};

// Four floats of a planar row at cells z .. z+3 (cells outside 0 .. len-1
// read as 0): one float4 when the row's cell z sits on 16 bytes (vec),
// else four scalar loads.
__device__ __forceinline__ float4 load4(const float* row, int z, int len, bool on, bool vec) {
  if (vec)
    return (on && z + 3 >= 0 && z < len) ? __ldg(reinterpret_cast<const float4*>(row + z))
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
  float e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = (on && z + i >= 0 && z + i < len) ? __ldg(row + z + i) : 0.f;
  return make_float4(e[0], e[1], e[2], e[3]);
}

// Loads cells z0 .. z0+kSpan-1 of the partner row at cell offset rowoff
// (``on``: the partner exists). Interleaved: cell z0 of every row sits on
// 16 bytes. Planar: re's does; vec_im says whether im's does too, and
// vec_row whether this row's does (a y-partner at an odd nzr may not).
template <bool kInterleaved, int kSpan>
__device__ __forceinline__ void load_span(const Stack<kInterleaved>& s, int64_t rowoff, int z0,
                                          int len, bool on, bool vec_row, bool vec_im,
                                          Span<kSpan>& sp) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int64_t o = c * s.cells + rowoff;
    if constexpr (kInterleaved) {
#pragma unroll
      for (int k = 0; k < kSpan; k += 2) {
        const int z = z0 + k;
        const float4 v = (on && z + 1 >= 0 && z < len)
                             ? __ldg(reinterpret_cast<const float4*>(s.re + 2 * (o + z)))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        sp.re[c][k] = v.x;
        sp.im[c][k] = v.y;
        sp.re[c][k + 1] = v.z;
        sp.im[c][k + 1] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kSpan; k += 4) {
        const float4 a = load4(s.re + o, z0 + k, len, on, vec_row);
        const float4 b = load4(s.im + o, z0 + k, len, on, vec_row && vec_im);
        sp.re[c][k] = a.x, sp.re[c][k + 1] = a.y, sp.re[c][k + 2] = a.z, sp.re[c][k + 3] = a.w;
        sp.im[c][k] = b.x, sp.im[c][k + 1] = b.y, sp.im[c][k + 2] = b.z, sp.im[c][k + 3] = b.w;
      }
    }
  }
}

// Total and longitudinal power of cell k of one partner's span, with the
// partner's own wavenumber split; on the kz = 0 plane |reg - nyq|^2, else
// |reg|^2 + |nyq|^2. A missing partner's span holds zeros: its powers are
// exactly 0, and adding them leaves a sum unchanged.
template <int kSpan>
__device__ __forceinline__ void partner_powers(const Span<kSpan>& sp, int k, Wave kx, Wave ky, Wave kz,
                                               bool kz0, double inv_k2, double& tot, double& lon) {
  double wr[3], wi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    wr[c] = sp.re[c][k];
    wi[c] = sp.im[c][k];
  }
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

// The row's four partners: (i, j), (-i, j), (i, -j), (-i, -j), and their
// own wavenumber splits along x and y.
struct Partners {
  Wave kx[4], ky[4];
  double mxy;  // the count weight: the partners that exist
};

// Bins cell k of the span, at z (inside the walk), weight wz: the
// partners' powers summed in the plain fold's order, ((i, j) + (-i, j)) +
// ((i, -j) + (-i, -j)), then [mxy, total, longi] added to the run.
template <int kSpan, class H>
__device__ __forceinline__ void bin_cell(const Span<kSpan> (&sp)[4], int k, const Partners& pt, Wave kz,
                                         bool kz0, double wz, const int* thr, const H& hist,
                                         Run<3>& r) {
  const double inv_k2 = 1.0 / fmax((double)r.k2, 1.0);  // r.k2 = i^2 + j^2 + z^2 here
  double t[4], l[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) partner_powers(sp[p], k, pt.kx[p], pt.ky[p], kz, kz0, inv_k2, t[p], l[p]);
  const double v[3] = {pt.mxy, (t[0] + t[1]) + (t[2] + t[3]), (l[0] + l[1]) + (l[2] + l[3])};
  r.add(v, wz, thr, hist);
}

// kWide: the wide walk of shell_bins.cuh (nbins > kMaxBins).
template <bool kInterleaved, bool kWide>
__global__ void __launch_bounds__(fava::kBinMaxWarps * 32, Layout<kInterleaved>::kMinBlocks)
powers_fold_bin_kernel(Stack<kInterleaved> s, double* __restrict__ out, int nx, int ny, int nzr,
                       int nbins, int full_nz, int vec_im) {
  extern __shared__ __align__(16) double hists[];  // [warps][nbins][3]: counts, total, longi
  const int* thr;
  const fava::Hist<kWide> hist = fava::walk_hists_init<3, kWide>(hists, out, nbins, thr);
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int nyh = ny / 2 + 1;
  const int64_t nrows = (int64_t)(nx / 2 + 1) * nyh;
  const int z_nyq = (full_nz % 2 == 0) ? full_nz / 2 : -1;
  const int k2_out = thr[nbins];
  constexpr int kSpan = Layout<kInterleaved>::kSpan;
  // Cells of the layout's 16 bytes: a row's head is its offset from them.
  constexpr int kUnit = kInterleaved ? 2 : 4;
  const uintptr_t base = reinterpret_cast<uintptr_t>(s.re) / (kInterleaved ? 8 : 4);

  for (int64_t row = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5); row < nrows;
       row += (int64_t)gridDim.x * warps) {
    const int i = (int)(row / nyh);
    const int j = (int)(row - (int64_t)i * nyh);
    const int ij2 = i * i + j * j;
    const int len = min(nzr, fava::first_kz_outside(ij2, k2_out));
    if (len == 0) continue;
    // Warp-uniform: whether the mirror rows exist (K3's rule).
    const bool x_pair = i > 0 && 2 * i < nx;
    const bool y_pair = j > 0 && 2 * j < ny;
    Partners pt;
    pt.kx[0] = pt.kx[2] = own_wave(i, nx);
    pt.kx[1] = pt.kx[3] = Wave{-(double)i, 0.0};
    pt.ky[0] = pt.ky[1] = own_wave(j, ny);
    pt.ky[2] = pt.ky[3] = Wave{-(double)j, 0.0};
    pt.mxy = fava::hermitian_mult(i, nx) * fava::hermitian_mult(j, ny);
    const int64_t p00 = ((int64_t)i * ny + j) * nzr;
    const int64_t off[4] = {p00, x_pair ? ((int64_t)(nx - i) * ny + j) * nzr : p00,
                            y_pair ? ((int64_t)i * ny + (ny - j)) * nzr : p00,
                            x_pair && y_pair ? ((int64_t)(nx - i) * ny + (ny - j)) * nzr : p00};
    const bool on[4] = {true, x_pair, y_pair, x_pair && y_pair};
    const int head = (int)((base + p00) % kUnit);
    // A planar y-partner sits (ny - 2j) nzr cells from its x-partner.
    const bool vec_y = kInterleaved || ((ny - 2 * j) * nzr) % 4 == 0;
    const int lo = 1, hi = z_nyq >= 0 ? min(len, z_nyq) : len;  // cells of weight 2
    const int cells = head + len;
    for (int q0 = 0; q0 < cells; q0 += 32 * kSpan) {
      const int qs = q0 + lane * kSpan;
      Run<3> r;
      r.none(nbins);
      if (qs < cells) {
        const int z0 = qs - head;  // the span's first cell (z0 < 0: before the row)
        r.template open<kWide>(ij2, max(z0, 0), z0, nbins, thr);
        // Every load of the span first, so one memory latency serves the trip.
        Span<kSpan> sp[4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          load_span<kInterleaved, kSpan>(s, off[p], z0, len, on[p], p < 2 || vec_y, vec_im != 0, sp[p]);
        if (z0 >= lo && z0 + kSpan - 1 < hi) {
#pragma unroll
          for (int k = 0; k < kSpan; ++k) {
            bin_cell(sp, k, pt, Wave{(double)(z0 + k), 0.0}, false, 2.0, thr, hist, r);
            r.step();
          }
        } else {
#pragma unroll
          for (int k = 0; k < kSpan; ++k) {
            const int z = z0 + k;
            if (z >= 0 && z < len)
              bin_cell(sp, k, pt, own_wave(z, full_nz), z == 0, z == 0 || z == z_nyq ? 1.0 : 2.0,
                       thr, hist, r);
            r.step();
          }
        }
      }
      // Runs that reach a span's end may continue in the next lanes' spans
      // (or the next trip's): added after a barrier, one add a shell.
      __syncwarp();
      fava::add_span_ends<3>(r, hist, nbins, lane);
      __syncwarp();
    }
  }
  fava::walk_hists_flush<3, kWide>(hists, out, nbins);
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
    return fava::launch_walk(powers_fold_bin_kernel<true, false>, powers_fold_bin_kernel<true, true>,
                             3, nbins, blocks, st,
                             Stack<true>{(const float*)re, nullptr, cells}, o, nx, ny, nzr, nbins,
                             full_nz, 1);
  // im's rows sit at re's offset from 16 bytes when the stacks do.
  const int vec_im = ((reinterpret_cast<uintptr_t>(re) ^ reinterpret_cast<uintptr_t>(im)) & 15) == 0;
  return fava::launch_walk(powers_fold_bin_kernel<false, false>, powers_fold_bin_kernel<false, true>,
                           3, nbins, blocks, st,
                           Stack<false>{(const float*)re, (const float*)im, cells}, o, nx, ny, nzr,
                           nbins, full_nz, vec_im);
}

// Blocks of the kernel that fit one SM at once; a negative CUDA error code
// on failure (also for nbins outside 1 .. kMaxWideBins).
int fava_shell_bin_powers_fused_blocks_per_sm(int interleaved, int nbins) {
  return interleaved ? fava::walk_blocks_per_sm(powers_fold_bin_kernel<true, false>,
                                                powers_fold_bin_kernel<true, true>, 3, nbins)
                     : fava::walk_blocks_per_sm(powers_fold_bin_kernel<false, false>,
                                                powers_fold_bin_kernel<false, true>, 3, nbins);
}

}  // extern "C"
