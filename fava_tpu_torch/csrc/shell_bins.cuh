// The shell-binning walk shared by every Hermitian shell-binning kernel:
// B6/B10 (unfolded, spectra_kernels.cu), K4/B4/B11a/B11b (folded,
// flagship_kernels.cu) and B9 (fused powers, fused_spectra_kernels.cu).
//
// Each row of a spectrum splits into walks along z in which |k| never
// decreases. One warp takes one walk at a time and owns a histogram of C
// f64 channels in shared memory. Each lane takes a span of consecutive
// cells (its loads issued together), and sums each run of equal shells in
// f64 registers. A cell's shell comes from a per-block table of the k^2 at
// which each class starts (class_thresholds: the f32 formula bit for bit),
// so a cell costs an integer step of k^2 and one compare, no square root.
// A run that ends inside a lane's span belongs to that lane alone, so it
// is added with plain shared loads and stores (Hist<false>; sm_90a compiles
// a shared f64 atomicAdd to a compare-and-swap loop, ATOMS.CAST.SPIN.64);
// the runs that reach the ends of spans meet in one segmented shuffle scan
// a trip (add_span_ends). The block sums its warps' histograms into the
// output with f64 global atomics at the end. A block has as many warps
// (up to kBinMaxWarps) as shared memory holds histograms for; the grid is
// one wave (the wrappers size it from walk_blocks_per_sm), whose warps
// stride over the walks.
//
// That is the narrow walk, for up to kMaxBins shells: past them a warp's
// histogram outgrows shared memory (131 KB at 8191 shells and 2 channels)
// and k^2 outgrows f32's exact integers. The wide walk (kWide, up to
// kMaxWideBins shells) runs the same walks, runs and scans, but classifies
// on the exact integer k^2 (its thresholds from the f64 formula), keeps
// only the thresholds in shared memory, and adds each run's f64 sums to the
// output with global atomics where the narrow walk adds them to the warp's
// histogram. Runs along z are long where k is large, so the atomics are
// few; their order varies between runs, as the narrow flush's does.
//
// This header also holds the walk of float32 channel volumes
// (shell_walk_kernel, for B6/B10 and the folded kernels): a lane takes 4m
// consecutive cells of each channel, m = 1..kMaxGroups float4 loads sized
// to the walk, the first load starting up to 3 cells before the row,
// masked; a Rows policy maps a walk to its row and wavenumbers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <map>
#include <mutex>
#include <utility>

#include "row_moments.cuh"

namespace fava {

constexpr int kBinMaxWarps = 8;  // warps of a binning block, each with its own histogram
constexpr int kMaxBins = 4095;   // the narrow walk: (nbins + 1)^2 <= 2^24, |k|^2 of every binned cell exact in f32
// The wide walk: every k^2 it steps to stays below 2^31 (the last shell's
// (nbins - 1/2)^2 plus a lane span's overrun), given rows of kx^2 + ky^2 <
// 2^31 (the wrappers' check).
constexpr int kMaxWideBins = 46000;
constexpr int kMaxGroups = 2;    // float4 groups of a lane's span in shell_walk_kernel: at most 8 cells
// Unfold multiplicity of index idx of a folded axis of extent n: 1 for the
// self-conjugate indices (0 and, for even n, n/2), 2 for the others.
__device__ __forceinline__ double hermitian_mult(int idx, int n) {
  return (idx == 0 || (n % 2 == 0 && 2 * idx == n)) ? 1.0 : 2.0;
}

// The class of a cell of squared wavenumber k2: its shell, or nbins when it
// lies beyond the last shell (k > nbins - 0.5). The narrow walk takes the
// f32 formula (k2 < 2^24 is exact in f32), as fava_tpu's kernels do; the
// wide walk the shell of the exact integer k2, in f64: k never sits on a
// half-integer (s + 1/2)^2 = s^2 + s + 1/4, and the nearest k2, s^2 + s, is
// 1/(8s) below it, far above f64's rounding of sqrt at k2 < 2^31.
template <bool kWide = false>
__device__ __forceinline__ int cell_class(int k2, int nbins) {
  if constexpr (kWide) {
    const double k = sqrt((double)k2);
    if (!(k <= (double)nbins - 0.5)) return nbins;
    return min((int)floor(k + 0.5), nbins - 1);
  } else {
    const float k = sqrtf((float)k2);
    if (!(k <= (float)nbins - 0.5f)) return nbins;
    return min(__float2int_rd(k + 0.5f), nbins - 1);
  }
}

// thr[s], s = 0 .. nbins + 1: the least k2 whose class is >= s (thr[nbins]
// the first k2 beyond the last shell, thr[nbins + 1] none). The class never
// decreases with k2, so a cell's class is the s with thr[s] <= k2 <
// thr[s + 1]: cell_class above, bit for bit, without a square root per
// cell. The guess (s - 1/2)^2 is off by at most a few integers (exact in
// the wide walk).
template <bool kWide>
__device__ inline void class_thresholds(int* thr, int nbins) {
  for (int s = threadIdx.x; s <= nbins + 1; s += blockDim.x) {
    int g = 0;
    if (s > nbins) {
      g = INT_MAX;
    } else if (s > 0) {
      g = s * s - s + 1;
      while (g > 0 && cell_class<kWide>(g - 1, nbins) >= s) --g;
      while (cell_class<kWide>(g, nbins) < s) ++g;
    }
    thr[s] = g;
  }
}

// The least |kz| >= 0 whose cell lies beyond the last shell (ij2 + kz^2 >=
// out). k never decreases with |kz|, so the cells inside are exactly those
// of smaller |kz|.
__device__ __forceinline__ int first_kz_outside(int ij2, int out) {
  if (ij2 >= out) return 0;
  int g = (int)sqrtf((float)(out - ij2));  // a first guess: the loops make it exact
  while (g > 0 && ij2 + (g - 1) * (g - 1) >= out) --g;
  while (ij2 + g * g < out) ++g;
  return g;
}

// Where a run's sums go. The narrow walk: the warp's histogram in shared
// memory, [nbins][C] doubles, hist[shell] += acc with plain loads and
// stores (callers never let two lanes add to one shell at once). The wide
// walk: the output out[c * nbins + shell], with f64 global atomics.
template <bool kWide>
struct Hist;

template <>
struct Hist<false> {
  double* hist;

  template <int C>
  __device__ __forceinline__ void add(int shell, const double (&acc)[C]) const {
    if constexpr (C == 2) {
      double2* p = reinterpret_cast<double2*>(hist) + shell;
      double2 x = *p;
      x.x += acc[0];
      x.y += acc[1];
      *p = x;
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) hist[shell * C + c] += acc[c];
    }
  }
};

template <>
struct Hist<true> {
  double* out;
  int nbins;

  template <int C>
  __device__ __forceinline__ void add(int shell, const double (&acc)[C]) const {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (acc[c] != 0.0) atomicAdd(out + (int64_t)c * nbins + shell, acc[c]);
  }
};

// A lane's run: its class (nbins: none), the k2 that ends it (thr[cur +
// 1]), its f64 sums; and k2 of the lane's next position with the step to
// the one after (k2 grows by 2|kz| + 1 a position).
template <int C>
struct Run {
  int cur, next, k2, dk;
  double acc[C];

  __device__ __forceinline__ void none(int nbins) {
    cur = nbins;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0;
  }

  // Opens the run of the lane's first cell, at |kz| = kz_cell (inside the
  // last shell), with the lane's first position at |kz| = kz_pos (-head
  // <= kz_pos <= kz_cell: positions before the row are stepped over).
  template <bool kWide>
  __device__ __forceinline__ void open(int ij2, int kz_cell, int kz_pos, int nbins, const int* thr) {
    cur = cell_class<kWide>(ij2 + kz_cell * kz_cell, nbins);
    next = thr[cur + 1];
    k2 = ij2 + kz_pos * kz_pos;
    dk = 2 * kz_pos + 1;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0;
  }

  __device__ __forceinline__ void step() {
    k2 += dk;
    dk += 2;
  }

  // Adds w * v of the inside cell at the current position: a cell past the
  // run's end closes the run (its sums go to hist) and opens the run of its
  // class. Does not step.
  template <class H>
  __device__ __forceinline__ void add(const double (&v)[C], double w, const int* thr,
                                      const H& hist) {
    if (k2 >= next) {
      hist.add(cur, acc);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.0;
      do {
        next = thr[++cur + 1];
      } while (k2 >= next);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = fma(w, v[c], acc[c]);
  }
};

// Adds the runs that reach the end of the lanes' spans: shells never
// decrease along the lanes (lanes past the walk hold nbins), so the lanes
// of one shell are contiguous; a segmented shuffle scan sums them and the
// last lane of each adds the sum. Called by the whole warp, between
// __syncwarp()s (the adds inside spans must have landed).
template <int C, class H>
__device__ __forceinline__ void add_span_ends(Run<C>& r, const H& hist, int nbins, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    double u[C];
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = __shfl_up_sync(kFullMask, r.acc[c], o);
    const int us = __shfl_up_sync(kFullMask, r.cur, o);
    if (lane >= o && us == r.cur) {
#pragma unroll
      for (int c = 0; c < C; ++c) r.acc[c] += u[c];
    }
  }
  const int next = __shfl_down_sync(kFullMask, r.cur, 1);
  if (r.cur < nbins && (lane == 31 || next != r.cur)) hist.add(r.cur, r.acc);
}

// The block's shared memory: in the narrow walk [warps][nbins][C] doubles,
// then the nbins + 2 int class thresholds; in the wide walk the thresholds
// alone. Zeroes the histograms, fills the thresholds and returns where
// this warp's runs go (after a barrier).
template <int C, bool kWide>
__device__ __forceinline__ Hist<kWide> walk_hists_init(double* hists, double* out, int nbins,
                                                       const int*& thr) {
  const int nh = kWide ? 0 : (blockDim.x >> 5) * C * nbins;
  int* t = reinterpret_cast<int*>(hists + nh);
  for (int b = threadIdx.x; b < nh; b += blockDim.x) hists[b] = 0.0;
  class_thresholds<kWide>(t, nbins);
  __syncthreads();
  thr = t;
  if constexpr (kWide)
    return Hist<true>{out, nbins};
  else
    return Hist<false>{hists + (threadIdx.x >> 5) * C * nbins};
}

// The narrow walk's end: sums the warps' histograms into out[c * nbins +
// shell] with f64 global atomics (their order varies between runs: the
// sums agree to rounding). The wide walk's runs are in out already.
template <int C, bool kWide>
__device__ __forceinline__ void walk_hists_flush(const double* hists, double* out, int nbins) {
  if constexpr (!kWide) {
    __syncthreads();
    const int warps = blockDim.x >> 5;
    const int nh = C * nbins;
    for (int b = threadIdx.x; b < nh; b += blockDim.x) {
      double s = 0.0;
      for (int w = 0; w < warps; ++w) s += hists[w * nh + b];
      if (s != 0.0) atomicAdd(&out[(b % C) * nbins + b / C], s);
    }
  }
}

// ---------------------------------------------------------------------------
// The walk of float32 channel volumes (B6/B10, K4/B4/B11a/B11b).

// One walk of one row: its row index, the row's (kx^2 + ky^2), whether it
// is a full grid's descending walk, and its count weight (B11a: the unfold
// multiplicity mx * my of its folded row).
struct RowWalk {
  int64_t row;
  int ij2;
  bool down;
  double mxy;
};

// The walks of an (nx, ny, nzr) unfolded volume (B10), or of rows kx0 ..
// kx0+nx-1 of a full_nx-wide one (B6): one ascending walk a row of an rfft
// half-spectrum (nzr != full_nz), two a row of a full grid.
struct UnfoldedRows {
  int nx, ny, nzr, full_nz, kx0, full_nx;

  __device__ __forceinline__ bool half() const { return full_nz != nzr; }
  __device__ __forceinline__ int64_t walks() const {
    return (int64_t)nx * ny * (half() ? 1 : 2);
  }
  __device__ __forceinline__ bool walk(int64_t idx, RowWalk& w) const {
    w.row = half() ? idx : idx >> 1;
    const unsigned rx = (unsigned)w.row / (unsigned)ny;  // rows < 2^31 (the wrapper's int shapes)
    const int jx = kx0 + (int)rx;
    const int j = (int)((unsigned)w.row - rx * (unsigned)ny);
    const int kx = jx <= (full_nx - 1) / 2 ? jx : jx - full_nx;
    const int ky = j <= (ny - 1) / 2 ? j : j - ny;
    w.ij2 = kx * kx + ky * ky;
    w.down = !half() && (idx & 1);
    w.mxy = 0.0;
    return true;
  }
};

// The walks of a folded (nxh, rows, nzr) half-spectrum (K4, B4, B11a,
// B11b): one ascending walk a row, kx = i and ky = j; rows j > full_ny/2
// (fava_tpu's pad rows) bin nothing and are never read. Walk idx is row
// (i, j) = (idx % nxh, idx / nxh), so a warp's j moves from one stride to
// the next unless the wave's warps are a multiple of nxh = n/2 + 1 (odd;
// 257 at 512^3). Taken j-fastest, a pad8 fold's 264 rows and a wave of
// 16 x 264 warps gave each warp one j: some only the longest walks, some
// only pad rows (B11a/B11b 1.4-1.5x slower, probe_bin_regrid.py).
struct FoldedRows {
  int nxh, rows, nzr, full_nz, full_nx, full_ny;

  __device__ __forceinline__ bool half() const { return true; }
  __device__ __forceinline__ int64_t walks() const { return (int64_t)nxh * rows; }
  __device__ __forceinline__ bool walk(int64_t idx, RowWalk& w) const {
    const unsigned j = (unsigned)idx / (unsigned)nxh;  // rows < 2^31 (the wrapper's int shapes)
    const int i = (int)((unsigned)idx - j * (unsigned)nxh);
    if (2 * (int)j > full_ny) return false;
    w.row = (int64_t)i * rows + j;
    w.ij2 = i * i + (int)(j * j);
    w.down = false;
    w.mxy = hermitian_mult(i, full_nx) * hermitian_mult((int)j, full_ny);
    return true;
  }
};

// One walk of one row. Position q of the walk is its cell p = q - head:
// ascending walks hold z = p (kz = z), descending ones z = nzr-1-p
// (|kz| = p + 1, head 0).
template <int CV>
struct Walk {
  const float* row[CV];  // the row's first cell in each channel
  int head;              // cells before the row in its first aligned float4 (vector loads), else 0
  int len;               // cells of the walk inside the last shell
  int lo, hi;            // cells lo .. hi-1 are inside and carry the walk's common weight
  bool down;             // the full grid's descending walk
  bool vec;              // aligned float4 loads
};

template <int CV>
__device__ __forceinline__ void load_group(const Walk<CV>& w, int q, int nzr, float4 (&a)[CV]) {
#pragma unroll
  for (int c = 0; c < CV; ++c) {
    if (w.vec) {
      // A float4 that holds a cell of the walk is read whole.
      a[c] = (q + 3 >= w.head && q < w.head + w.len)
                 ? __ldg(reinterpret_cast<const float4*>(w.row[c] - w.head + q))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = q + i;
        e[i] = p < w.len ? __ldg(w.row[c] + (w.down ? nzr - 1 - p : p)) : 0.f;
      }
      a[c] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
}

__device__ __forceinline__ float part(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// The values of cell i of a group: the count weight first (kCounts), then
// the channels.
template <int CV, bool kCounts>
__device__ __forceinline__ void group_cell(const float4 (&a)[CV], int i, double mxy,
                                           double (&v)[CV + kCounts]) {
  if constexpr (kCounts) v[0] = mxy;
#pragma unroll
  for (int c = 0; c < CV; ++c) v[c + kCounts] = (double)part(a[c], i);
}

// Bins the 4 cells at walk positions p0 .. p0+3. A group wholly inside
// [lo, hi) takes no test but the run's end; the others mask the cells
// outside the walk and weigh z = 0 and the Nyquist plane 1.
template <int CV, bool kCounts, class H>
__device__ __forceinline__ void bin_group(const float4 (&a)[CV], int p0, const Walk<CV>& w,
                                          double bw, int z_nyq, double mxy, const int* thr,
                                          const H& hist, Run<CV + kCounts>& r) {
  double v[CV + kCounts];
  if (p0 >= w.lo && p0 + 3 < w.hi) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      group_cell<CV, kCounts>(a, i, mxy, v);
      r.add(v, bw, thr, hist);
      r.step();
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + i;
      if (p >= 0 && p < w.len) {
        group_cell<CV, kCounts>(a, i, mxy, v);
        r.add(v, p == 0 || p == z_nyq ? 1.0 : bw, thr, hist);
      }
      r.step();
    }
  }
}

// Hermitian-weighted shell sums of CV float32 channel volumes (t, and l
// when CV == 2), with a leading count channel of weight mxy * wz when
// kCounts: out[c * nbins + shell]. On an rfft half-spectrum (Rows::half)
// a cell's weight wz is 1 at z = 0 and, for even full_nz, at the Nyquist
// plane z = full_nz/2, 2 elsewhere; on a full grid 1. ``vec``: every
// channel's rows sit at the same offset from 16 bytes (float4 loads).
// kWide: the wide walk (nbins > kMaxBins).
template <int CV, bool kCounts, class Rows, bool kWide>
__global__ void __launch_bounds__(kBinMaxWarps * 32)
shell_walk_kernel(const float* __restrict__ t, const float* __restrict__ l,
                  double* __restrict__ out, Rows rows, int nbins, int vec) {
  constexpr int CO = CV + kCounts;
  extern __shared__ __align__(16) double hists[];
  const int* thr;
  const Hist<kWide> hist = walk_hists_init<CO, kWide>(hists, out, nbins, thr);
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int nzr = rows.nzr;
  const bool half = rows.half();
  const int z_nyq = (half && rows.full_nz % 2 == 0) ? rows.full_nz / 2 : -1;
  const double bw = half ? 2.0 : 1.0;  // the weight of every cell but z = 0 and the Nyquist plane
  const int k2_out = thr[nbins];
  // The ascending walk covers z = 0 .. npos-1; a full grid's descending
  // walk the negative wavenumbers z = nzr-1 down to npos.
  const int npos = half ? nzr : (nzr - 1) / 2 + 1;
  const int64_t nwalks = rows.walks();

  for (int64_t idx = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5); idx < nwalks;
       idx += (int64_t)gridDim.x * warps) {
    RowWalk rw;
    if (!rows.walk(idx, rw)) continue;
    const int stop = first_kz_outside(rw.ij2, k2_out);
    Walk<CV> w;
    w.down = rw.down;
    w.len = w.down ? min(nzr - npos, max(stop - 1, 0)) : min(npos, stop);
    if (w.len == 0) continue;
    w.row[0] = t + rw.row * nzr;
    if constexpr (CV == 2) w.row[1] = l + rw.row * nzr;
    w.vec = vec && !w.down;
    w.head = w.vec ? (int)((reinterpret_cast<uintptr_t>(w.row[0]) >> 2) & 3) : 0;
    w.lo = half ? 1 : 0;
    w.hi = z_nyq >= 0 ? min(w.len, z_nyq) : w.len;
    const int cells = w.head + w.len;  // positions 0 .. cells-1 hold the walk
    // Each lane takes m float4 groups (4m consecutive cells) a trip.
    const int m = min(kMaxGroups, (cells + 127) / 128);
    for (int q0 = 0; q0 < cells; q0 += 128 * m) {
      const int qs = q0 + lane * 4 * m;
      Run<CO> r;
      r.none(nbins);
      if (qs < cells) {
        const int p0 = qs - w.head;  // the lane's first position; its first cell max(p0, 0)
        // |kz| of the first cell and of position p0 (p0 < 0: before the row)
        if (w.down)
          r.template open<kWide>(rw.ij2, max(p0, 0) + 1, p0 + 1, nbins, thr);
        else
          r.template open<kWide>(rw.ij2, max(p0, 0), p0, nbins, thr);
        // Every load of the span first, so one memory latency serves the trip.
        float4 a[kMaxGroups][CV];
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g)
          if (g < m) load_group<CV>(w, qs + 4 * g, nzr, a[g]);
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g)
          if (g < m) bin_group<CV, kCounts>(a[g], p0 + 4 * g, w, bw, z_nyq, rw.mxy, thr, hist, r);
      }
      // A run that ends inside a span is the span's alone: those adds above
      // never meet. Runs that reach a span's end may continue in the next
      // lanes' spans (or the next trip's), so they are added after a
      // barrier, one add a shell.
      __syncwarp();
      add_span_ends<CO>(r, hist, nbins, lane);
      __syncwarp();
    }
  }
  walk_hists_flush<CO, kWide>(hists, out, nbins);
}

// ---------------------------------------------------------------------------
// Host side of a walk kernel's launch.

// Dynamic shared bytes of a block of ``warps`` warps: their histograms of
// ``channels`` f64 channels (the narrow walk's) and the class thresholds.
inline size_t walk_smem_bytes(int warps, int channels, int nbins) {
  const size_t hist = nbins > kMaxBins ? 0 : warps * channels * (size_t)nbins * sizeof(double);
  return hist + (nbins + 2) * sizeof(int);
}

// The dynamic shared bytes a block may opt in to on the current device (0
// on failure).
inline int smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return optin;
}

// Warps of a block: as many as kBinMaxWarps whose histograms fit the
// shared memory; kBinMaxWarps in the wide walk, whose warps share the
// thresholds alone (0: not even one fits, or nbins lies outside 1 ..
// kMaxWideBins).
inline int walk_block_warps(int channels, int nbins) {
  if (nbins < 1 || nbins > kMaxWideBins) return 0;
  const size_t optin = (size_t)smem_optin();
  const size_t fixed = walk_smem_bytes(0, channels, nbins);
  if (optin <= fixed) return 0;
  if (nbins > kMaxBins) return kBinMaxWarps;
  const size_t per_warp = walk_smem_bytes(1, channels, nbins) - fixed;
  return (int)std::min<size_t>(kBinMaxWarps, (optin - fixed) / per_warp);
}

// Lets ``kernel`` take ``smem`` dynamic shared bytes on the current
// device: the attribute is raised only when a launch needs more than any
// before it, so a process sets it once for a shape, not once a launch. It
// is not raised beyond the need: the card sizes each SM's split between
// shared memory and L1 by it.
inline cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> allowed;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  size_t& now = allowed[{kernel, dev}];
  if (smem <= now) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) now = smem;
  return err;
}

// Launches a walk kernel of ``channels`` histogram channels, ``narrow``
// up to kMaxBins shells and ``wide`` (its kWide variant) beyond, with as
// many warps a block as its histograms allow.
template <class... Params, class... Args>
int launch_walk(void (*narrow)(Params...), void (*wide)(Params...), int channels, int nbins,
                int blocks, cudaStream_t stream, Args... args) {
  void (*kernel)(Params...) = nbins > kMaxBins ? wide : narrow;
  const int warps = walk_block_warps(channels, nbins);
  if (warps < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = walk_smem_bytes(warps, channels, nbins);
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, warps * 32, smem, stream>>>(args...);
  return launch_status();
}

// Blocks of the walk kernel that launch_walk takes for nbins (``narrow``
// or ``wide``) that fit one SM at once (occupancy query); a negative CUDA
// error code on failure (also for nbins outside 1 .. kMaxWideBins).
template <class... Params>
int walk_blocks_per_sm(void (*narrow)(Params...), void (*wide)(Params...), int channels,
                       int nbins) {
  (void)cudaGetLastError();
  void (*kernel)(Params...) = nbins > kMaxBins ? wide : narrow;
  const int warps = walk_block_warps(channels, nbins);
  if (warps < 1) return -(int)cudaErrorInvalidValue;
  const size_t smem = walk_smem_bytes(warps, channels, nbins);
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, warps * 32, smem);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace fava
