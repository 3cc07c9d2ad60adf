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
// What bounds it: the read of the cells inside the last shell, 4 bytes per
// channel (51 M cells of the (128, 1024, 513) chunk at kx0 = 0, 35 M of a
// 511 x 512 x 257 volume), so device memory. Each row splits into walks
// along z in which k never decreases: a half-spectrum row from z = 0 up; a
// full-grid row twice, z = 0 .. (n-1)/2 up and z = n-1 down to the first
// negative wavenumber. A walk's length inside the last shell is found once
// (first_kz_outside). One warp takes one walk at a time and owns a
// histogram in shared memory; each lane takes 4m consecutive cells (m =
// 1..kMaxGroups float4 loads per channel, sized to the walk and issued
// together; the first load starts up to 3 cells before the row, masked)
// and sums each run of equal shells in f64 registers. A cell's shell
// comes from a per-block table of the k^2 at which each class starts
// (class_thresholds: the f32 formula, bit for bit), so a cell costs an
// integer step of k^2 and one compare. A run that ends inside a lane's
// span belongs to that lane alone, so it is added with plain shared loads
// and stores, no atomics (sm_90a compiles a shared f64 atomicAdd to a
// compare-and-swap loop, ATOMS.CAST.SPIN.64); the runs that reach the ends
// of spans meet in one segmented shuffle scan per trip of 128m cells. The
// block sums its warps' histograms into the output with f64 global atomics
// at the end. The TPU kernel's per-slab loop over shells with masks is
// gone.
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

#include <algorithm>
#include <climits>

#include "row_moments.cuh"

namespace {

using fava::kFullMask;
using fava::launch_status;

constexpr int kMaxWarps = 8;   // warps a block, each with its own histogram
constexpr int kMaxGroups = 2;  // float4 groups of a lane's span: at most 8 cells
constexpr int kMaxBins = 4095; // (nbins + 1)^2 < 2^24: |k|^2 of every binned cell is exact in f32

// The class of a cell of squared wavenumber k2: its shell, or nbins when it
// lies beyond the last shell (k > nbins - 0.5). k2 < 2^24 is exact in f32.
__device__ __forceinline__ int cell_class(int k2, int nbins) {
  const float k = sqrtf((float)k2);
  if (!(k <= (float)nbins - 0.5f)) return nbins;
  return min(__float2int_rd(k + 0.5f), nbins - 1);
}

// thr[s], s = 0 .. nbins + 1: the least k2 whose class is >= s (thr[nbins]
// the first k2 beyond the last shell, thr[nbins + 1] none). The class never
// decreases with k2, so a cell's class is the s with thr[s] <= k2 <
// thr[s + 1]: the f32 formula above, bit for bit, without a square root
// per cell. The guess (s - 1/2)^2 is off by at most a few integers.
__device__ void class_thresholds(int* thr, int nbins) {
  for (int s = threadIdx.x; s <= nbins + 1; s += blockDim.x) {
    int g = 0;
    if (s > nbins) {
      g = INT_MAX;
    } else if (s > 0) {
      g = s * s - s + 1;
      while (g > 0 && cell_class(g - 1, nbins) >= s) --g;
      while (cell_class(g, nbins) < s) ++g;
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

// hist[shell] += acc with plain shared-memory loads and stores; the
// histogram holds [nbins][C] doubles. Callers never let two lanes add to
// one shell at once.
template <int C>
__device__ __forceinline__ void add_plain(double* hist, int shell, const double (&acc)[C]) {
  if constexpr (C == 2) {
    double2* p = reinterpret_cast<double2*>(hist) + shell;
    double2 x = *p;
    x.x += acc[0];
    x.y += acc[1];
    *p = x;
  } else {
    hist[shell] += acc[0];
  }
}

// One walk of one row. Position q of the walk is its cell p = q - head:
// ascending walks hold z = p (kz = z), descending ones z = nzr-1-p
// (|kz| = p + 1, head 0).
struct Walk {
  const float* row[2];  // the row's first cell in each channel
  int head;             // cells before the row in its first aligned float4 (vector loads), else 0
  int len;              // cells of the walk inside the last shell
  int lo, hi;           // cells lo .. hi-1 are inside and carry the walk's common weight
  bool down;            // the full grid's descending walk
  bool vec;             // aligned float4 loads
};

template <int C>
__device__ __forceinline__ void load_group(const Walk& w, int q, int nzr, float4 (&a)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
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

// A lane's run: its class (nbins: none), the k2 that ends it (thr[cur +
// 1]), its f64 sums; and k2 of the lane's next cell with the step to the
// one after (k2 grows by 2|kz| + 1 a cell).
template <int C>
struct Run {
  int cur, next, k2, dk;
  double acc[C];
};

// One inside cell of weight wz: a cell past the run's end closes the run
// (its sums go to hist) and opens the run of its class.
template <int C>
__device__ __forceinline__ void bin_cell(Run<C>& r, const float4 (&a)[C], int i, double wz,
                                         const int* thr, double* hist) {
  if (r.k2 >= r.next) {
    add_plain<C>(hist, r.cur, r.acc);
#pragma unroll
    for (int c = 0; c < C; ++c) r.acc[c] = 0.0;
    do {
      r.next = thr[++r.cur + 1];
    } while (r.k2 >= r.next);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) r.acc[c] = fma(wz, (double)part(a[c], i), r.acc[c]);
}

// Bins the 4 cells at walk positions p0 .. p0+3. A group wholly inside
// [lo, hi) takes no test but the run's end; the others mask the cells
// outside the walk and weigh z = 0 and the Nyquist plane 1.
template <int C>
__device__ __forceinline__ void bin_group(const float4 (&a)[C], int p0, const Walk& w, double bw,
                                          int z_nyq, const int* thr, double* hist, Run<C>& r) {
  if (p0 >= w.lo && p0 + 3 < w.hi) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bin_cell<C>(r, a, i, bw, thr, hist);
      r.k2 += r.dk;
      r.dk += 2;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + i;
      if (p >= 0 && p < w.len) bin_cell<C>(r, a, i, p == 0 || p == z_nyq ? 1.0 : bw, thr, hist);
      r.k2 += r.dk;
      r.dk += 2;
    }
  }
}

// Adds the runs that reach the end of the lanes' spans: shells never
// decrease along the lanes (lanes past the walk hold nbins), so the lanes
// of one shell are contiguous; a segmented shuffle scan sums them and the
// last lane of each adds the sum.
template <int C>
__device__ __forceinline__ void add_span_ends(int cur, double (&acc)[C], double* hist, int nbins,
                                              int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    double u[C];
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = __shfl_up_sync(kFullMask, acc[c], o);
    const int us = __shfl_up_sync(kFullMask, cur, o);
    if (lane >= o && us == cur) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += u[c];
    }
  }
  const int next = __shfl_down_sync(kFullMask, cur, 1);
  if (cur < nbins && (lane == 31 || next != cur)) add_plain<C>(hist, cur, acc);
}

template <int C>
__global__ void __launch_bounds__(kMaxWarps * 32)
shell_bin_unfolded_kernel(const float* __restrict__ t, const float* __restrict__ l,
                          double* __restrict__ out, int nx, int ny, int nzr, int nbins,
                          int full_nz, int kx0, int full_nx, int vec) {
  extern __shared__ __align__(16) double hists[];  // [warps][nbins][C], then thr[nbins + 2]
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int nh = C * nbins;
  int* thr = reinterpret_cast<int*>(hists + warps * nh);
  for (int b = threadIdx.x; b < warps * nh; b += blockDim.x) hists[b] = 0.0;
  class_thresholds(thr, nbins);
  __syncthreads();
  double* hist = hists + (threadIdx.x >> 5) * nh;

  const bool half = full_nz != nzr;
  const int z_nyq = (half && full_nz % 2 == 0) ? full_nz / 2 : -1;
  const double bw = half ? 2.0 : 1.0;  // the weight of every cell but z = 0 and the Nyquist plane
  const int k2_out = thr[nbins];
  // The ascending walk covers z = 0 .. npos-1; a full grid's descending
  // walk the negative wavenumbers z = nzr-1 down to npos.
  const int npos = half ? nzr : (nzr - 1) / 2 + 1;
  const int per_row = half ? 1 : 2;
  const int64_t nwalks = (int64_t)nx * ny * per_row;

  for (int64_t idx = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5); idx < nwalks;
       idx += (int64_t)gridDim.x * warps) {
    const int64_t row = half ? idx : idx >> 1;
    const unsigned rx = (unsigned)row / (unsigned)ny;  // rows < 2^31 (the wrapper's int shapes)
    const int jx = kx0 + (int)rx;
    const int j = (int)((unsigned)row - rx * (unsigned)ny);
    const int kx = jx <= (full_nx - 1) / 2 ? jx : jx - full_nx;
    const int ky = j <= (ny - 1) / 2 ? j : j - ny;
    const int ij2 = kx * kx + ky * ky;
    const int stop = first_kz_outside(ij2, k2_out);
    Walk w;
    w.down = !half && (idx & 1);
    w.len = w.down ? min(nzr - npos, max(stop - 1, 0)) : min(npos, stop);
    if (w.len == 0) continue;
    w.row[0] = t + row * nzr;
    w.row[1] = C == 2 ? l + row * nzr : w.row[0];
    w.vec = vec && !w.down;
    w.head = w.vec ? (int)((reinterpret_cast<uintptr_t>(w.row[0]) >> 2) & 3) : 0;
    w.lo = half ? 1 : 0;
    w.hi = z_nyq >= 0 ? min(w.len, z_nyq) : w.len;
    const int cells = w.head + w.len;  // positions 0 .. cells-1 hold the walk
    // Each lane takes m float4 groups (4m consecutive cells) a trip.
    const int m = min(kMaxGroups, (cells + 127) / 128);
    for (int q0 = 0; q0 < cells; q0 += 128 * m) {
      const int qs = q0 + lane * 4 * m;
      Run<C> r;
      r.cur = nbins;  // no run
#pragma unroll
      for (int c = 0; c < C; ++c) r.acc[c] = 0.0;
      if (qs < cells) {
        const int p0 = qs - w.head;  // the lane's first position; its first cell max(p0, 0)
        const int kz0 = w.down ? max(p0, 0) + 1 : max(p0, 0);
        r.cur = cell_class(ij2 + kz0 * kz0, nbins);  // inside: < nbins
        r.next = thr[r.cur + 1];
        const int kz = w.down ? p0 + 1 : p0;  // |kz| of position p0 (p0 < 0: before the row)
        r.k2 = ij2 + kz * kz;
        r.dk = 2 * kz + 1;
        // Every load of the span first, so one memory latency serves the trip.
        float4 a[kMaxGroups][C];
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g)
          if (g < m) load_group<C>(w, qs + 4 * g, nzr, a[g]);
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g)
          if (g < m) bin_group<C>(a[g], p0 + 4 * g, w, bw, z_nyq, thr, hist, r);
      }
      // A run that ends inside a span is the span's alone: those adds above
      // never meet. Runs that reach a span's end may continue in the next
      // lanes' spans (or the next trip's), so they are added after a
      // barrier, one add a shell.
      __syncwarp();
      add_span_ends<C>(r.cur, r.acc, hist, nbins, lane);
      __syncwarp();
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nh; b += blockDim.x) {
    double s = 0.0;
    for (int k = 0; k < warps; ++k) s += hists[k * nh + b];
    if (s != 0.0) atomicAdd(&out[(b % C) * nbins + b / C], s);
  }
}

// Dynamic shared bytes of a block of ``warps`` warps: their histograms and
// the class thresholds.
size_t smem_bytes(int warps, int channels, int nbins) {
  return warps * channels * (size_t)nbins * sizeof(double) + (nbins + 2) * sizeof(int);
}

// Warps of a block: as many as kMaxWarps whose histograms fit the shared memory.
int block_warps(int channels, int nbins) {
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t per_warp = smem_bytes(1, channels, nbins) - smem_bytes(0, channels, nbins);
  const size_t room = smem_max - std::min<size_t>(smem_max, smem_bytes(0, channels, nbins));
  return (int)std::min<size_t>(kMaxWarps, room / per_warp);
}

template <int C>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(shell_bin_unfolded_kernel<C>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int C>
int launch_unfolded(const float* t, const float* l, double* out, int nx, int ny, int nzr,
                    int nbins, int full_nz, int kx0, int full_nx, int blocks,
                    cudaStream_t stream) {
  const int warps = block_warps(C, nbins);
  if (nbins > kMaxBins || warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(warps, C, nbins);
  const cudaError_t err = allow_smem<C>(smem);
  if (err != cudaSuccess) return (int)err;
  // Vector loads need both volumes' rows at the same offset from 16 bytes.
  const int vec = C == 1 || ((reinterpret_cast<uintptr_t>(t) ^ reinterpret_cast<uintptr_t>(l)) & 15) == 0;
  shell_bin_unfolded_kernel<C><<<blocks, warps * 32, smem, stream>>>(
      t, l, out, nx, ny, nzr, nbins, full_nz, kx0, full_nx, vec);
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

template <int C>
int blocks_per_sm(int nbins) {
  const int warps = block_warps(C, nbins);
  if (nbins > kMaxBins || warps < 1) return -(int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(warps, C, nbins);
  cudaError_t err = allow_smem<C>(smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, shell_bin_unfolded_kernel<C>,
                                                        warps * 32, smem);
  return err == cudaSuccess ? n : -(int)err;
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

// Blocks of the kernel (up to kMaxWarps warps, C * nbins doubles of shared
// memory a warp) that fit one SM at once; a negative CUDA error code on
// failure (also for nbins > kMaxBins).
int fava_shell_bin_unfolded_blocks_per_sm(int channels, int nbins) {
  (void)cudaGetLastError();
  if (channels == 1) return blocks_per_sm<1>(nbins);
  if (channels == 2) return blocks_per_sm<2>(nbins);
  return -(int)cudaErrorInvalidValue;
}

}  // extern "C"
