// Hopper (sm_90a) kernels of the AMR path: block-stack row moments and the
// AMR -> uniform regrid.
//
// Three kernels, each the counterpart of a Pallas kernel of fava_tpu. Plain
// C entry points (bound with ctypes by fava_tpu_torch/ops/_build.py); each
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() of its launch. The Python wrappers in
// fava_tpu_torch/ops/cuda_kernels.py check devices, dtypes, shapes and
// contiguity before calling in.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "row_moments.cuh"

namespace {

using fava::CenteredCell;
using fava::launch_status;
using fava::RawFirstCell;
using fava::row_sweep;
using fava::warp_sum;

constexpr int kBlockRowThreads = 256;  // 8 warps: 8 block rows per thread block
constexpr int kRegridMaxFields = 8;     // fields per regrid launch

// ---------------------------------------------------------------------------
// Block-stack row moments (K5, K6).
//
// K5 replaces _raw_rows_kernel (pallas_kernels.py:331) and K6 replaces
// _centered_rows_kernel (pallas_kernels.py:352). An AMR leaf stack is
// (nB, ncx, ncy, ncz) float32; each (block, x row) is one contiguous run of
// ncy*ncz cells (256 for 16^3 blocks), and there are nB*ncx rows (~5.5e5 at
// the rtflame-like size). Like K1/K2 they read each field once and do ~10-20
// flops per cell: bound by device-memory bandwidth. K1's one-block-per-row
// layout would leave one element per thread on rows this short, so here one
// warp owns a row (two float4 loads per lane per field for 256-cell rows),
// eight rows share a thread block, each lane keeps float64 partials, and a
// warp shuffle closes the row; lane 0 writes out[m * nrows + row]. One warp
// writes each row, so results are deterministic and need no atomics. The
// TPU's row blocks sized for VMEM and its lane packing of the outputs are
// gone. K6 takes the per-row means as float64 from device memory (the TPU
// cast them to the field dtype).

template <int N, typename MakeCell>
__device__ __forceinline__ void block_rows(const float* __restrict__ d, const float* __restrict__ vx,
                                           const float* __restrict__ vy,
                                           const float* __restrict__ vz, double* __restrict__ out,
                                           int64_t nrows, int64_t len, int vec,
                                           const MakeCell& make_cell) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  // The row is warp-uniform, so every lane of a warp takes the same trips
  // and the shuffles in warp_sum see the full warp.
  for (int64_t row = (int64_t)blockIdx.x * warps + (threadIdx.x >> 5); row < nrows;
       row += (int64_t)gridDim.x * warps) {
    const int64_t off = row * len;
    double acc[N] = {};
    row_sweep(d + off, vx + off, vy + off, vz + off, len, vec != 0, lane, 32, acc,
              make_cell(row));
    warp_sum(acc);
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m < N; ++m) out[m * nrows + row] = acc[m];
    }
  }
}

struct MakeRawFirst {
  __device__ __forceinline__ RawFirstCell operator()(int64_t) const { return RawFirstCell{}; }
};

struct MakeCentered {
  const double* __restrict__ means;  // (3, nrows)
  int64_t nrows;
  __device__ __forceinline__ CenteredCell operator()(int64_t row) const {
    return CenteredCell{means[row], means[nrows + row], means[2 * nrows + row]};
  }
};

__global__ void __launch_bounds__(kBlockRowThreads)
block_row_moments_kernel(const float* __restrict__ d, const float* __restrict__ vx,
                         const float* __restrict__ vy, const float* __restrict__ vz,
                         double* __restrict__ out, int64_t nrows, int64_t len, int vec) {
  block_rows<7>(d, vx, vy, vz, out, nrows, len, vec, MakeRawFirst{});
}

__global__ void __launch_bounds__(kBlockRowThreads)
block_centered_row_moments_kernel(const float* __restrict__ d, const float* __restrict__ vx,
                                  const float* __restrict__ vy, const float* __restrict__ vz,
                                  const double* __restrict__ means, double* __restrict__ out,
                                  int64_t nrows, int64_t len, int vec) {
  block_rows<9>(d, vx, vy, vz, out, nrows, len, vec, MakeCentered{means, nrows});
}

// ---------------------------------------------------------------------------
// AMR -> uniform regrid (K7), replacing _regrid_kernel (pallas_regrid.py:78).
//
// What it computes is regrid.py's closed form (:177-194): output cell g
// (offset by the plan's origin) lies in fine-block tile g // ncells, whose
// source block is blk = leaf_table[tile]; its source cell is
// clip((g - block_offsets[blk]) // 2^shift[blk], 0, nc - 1), and cells with
// blk < 0 get 0. Block scales are powers of two (2^(lmax - level)), so the
// floor division is an arithmetic right shift.
//
// What bounds it: it writes every output cell once (2.1 GB per float32 field
// for the 2048x512x512 full-domain regrid) and reads a smaller, cached set of
// source cells, so device memory. The TPU kernel's whole-block DMA into VMEM,
// its block-id cache and its Kronecker 0/1 matmul existed for Mosaic's lane
// rules; here each thread finds its source cells by integer arithmetic. Each
// thread takes 4 consecutive cells of an output row: one division by ncz and
// one lookup (table, shift, offsets) serve them, a later cell steps to the
// next tile only when it crosses one (ncz < 4, or a window origin that is not
// a multiple of 4), and each field's 4 values go out as one float4 store (the
// row's first and last groups are masked when nz is not a multiple of 4: the
// groups are aligned to the flat output). On the narrow path the per-cell
// index math is 32-bit. A block of 256 threads holds 256/tz output rows, tz
// <= 16 threads along z (a power of two the wrapper picks), each taking every
// tz-th group of its row, so the row's setup (three divisions, the tile row)
// serves several groups. The field loop is unrolled, so the field pointers
// stay kernel parameters. The source reads of a coarse tile (scale >= 4)
// repeat along z and hit L1. One launch copies up to kRegridMaxFields
// fields; any block shape and power-of-two scale is taken.
//
// Where its time goes (NVIDIA H100 80GB HBM3 at 700 W, probe_bin_regrid.py):
// the 4-field 512^3 window takes 1.53 ms, 1.06x a library copy_ of the same
// bytes; the one-field full domain 1.48 ms against 0.65 for a library fill_
// of its output, held by each group's index work: without the table lookups
// it takes 1.16 ms, without the source loads 1.28, without the stores 1.40.

struct RegridFields {
  const float* src[kRegridMaxFields];
  float* dst[kRegridMaxFields];
};

constexpr int kRegridThreads = 256;

template <typename T>
__device__ __forceinline__ T clamp0(T v, T hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// The type of a z offset: 32 bits on the narrow path, where the domain's z
// extent in fine cells fits in 31 (so does every block's).
template <typename I>
using ZOff = typename std::conditional<sizeof(I) == 4, int, int64_t>::type;

// The source block of one fine-block tile: the block's first source cell of
// the output row (cx, cy fixed) and what gives cz along z.
template <typename Z>
struct RegridTile {
  int blk;          // < 0: no source block, the cells are 0
  int shift;        // log2 of the block's scale
  int64_t base;     // ((blk * bx + cx) * by + cy) * bz
  Z zoff;           // gz - the block's z offset, at the current cell
};

template <typename I>
__device__ __forceinline__ RegridTile<ZOff<I>> regrid_tile(const int* __restrict__ table,
                                                  const int64_t* __restrict__ offsets,
                                                  const int* __restrict__ shifts, I tile, I gx,
                                                  I gy, I gz, int64_t bx, int64_t by,
                                                  int64_t bz) {
  RegridTile<ZOff<I>> r{table[tile], 0, 0, 0};
  if (r.blk < 0) return r;
  r.shift = shifts[r.blk];
  const int64_t* o = offsets + 3 * (int64_t)r.blk;
  const int64_t cx = clamp0(((int64_t)gx - o[0]) >> r.shift, bx - 1);
  const int64_t cy = clamp0(((int64_t)gy - o[1]) >> r.shift, by - 1);
  r.base = (((int64_t)r.blk * bx + cx) * by + cy) * bz;
  r.zoff = (ZOff<I>)((int64_t)gz - o[2]);
  return r;
}

// Coordinates are non-negative; I is uint32_t when every coordinate and the
// row count fit in 31 bits (64-bit integer division costs several times
// more instructions), and int64_t otherwise. Output and source offsets are
// always 64-bit.
template <typename I>
__global__ void __launch_bounds__(kRegridThreads)
regrid_kernel(RegridFields f, int nfields, const int* __restrict__ table,
              const int64_t* __restrict__ offsets, const int* __restrict__ shifts, I nx, I ny,
              I nz, I ox, I oy, I oz, I ncx, I ncy, I ncz, I ty, I tz, int64_t bx, int64_t by,
              int64_t bz) {
  const I tzs = blockDim.x;                    // threads along z
  const I rows = kRegridThreads / blockDim.x;  // output rows a block holds
  // 4-cell groups that cover a row: rows start aligned when 4 divides nz,
  // else at any of the 4 offsets.
  const I groups = nz % 4 == 0 ? nz / 4 : (nz + 6) / 4;
  const I nrows = nx * ny;
  for (I r0 = (I)blockIdx.x * rows; r0 < nrows; r0 += (I)gridDim.x * rows) {
    const I row = r0 + (I)threadIdx.y;
    if (row >= nrows) continue;
    const I gx = row / ny + ox;
    const I gy = row % ny + oy;
    const I tile_row = ((gx / ncx) * ty + gy / ncy) * tz;
    const int64_t flat = (int64_t)row * nz;  // the row's first output cell
    const int a = (int)(flat & 3);           // cells of the previous row in the first group
    for (I g = threadIdx.x; g < groups; g += tzs) {
      const int64_t z0 = 4 * (int64_t)g - a;  // first cell of the group
      if (z0 >= (int64_t)nz) break;
      const I zf = z0 < 0 ? 0 : (I)z0;  // its first cell in the row
      // Cells ilo .. ihi-1 of the group lie in the row.
      const int ilo = (int)(zf - z0), ihi = (int)min((int64_t)4, (int64_t)nz - z0);
      I gz = zf + oz;
      I t = gz / ncz;
      I rem = gz - t * ncz;
      RegridTile<ZOff<I>> tl = regrid_tile(table, offsets, shifts, tile_row + t, gx, gy, gz, bx, by, bz);
      const ZOff<I> czmax = (ZOff<I>)bz - 1;
      int64_t src[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        src[i] = -1;
        if (i < ilo || i >= ihi) continue;
        if (rem == ncz) {  // the next fine-block tile
          rem = 0;
          ++t;
          tl = regrid_tile(table, offsets, shifts, tile_row + t, gx, gy, gz, bx, by, bz);
        }
        if (tl.blk >= 0) src[i] = tl.base + clamp0(tl.zoff >> tl.shift, czmax);
        ++rem;
        ++gz;
        ++tl.zoff;
      }
      const bool whole = z0 >= 0 && z0 + 3 < (int64_t)nz;
      // Unrolled over the fields, so the pointers stay kernel parameters
      // (a loop with a run-time bound would copy them to local memory).
#pragma unroll
      for (int k = 0; k < kRegridMaxFields; ++k) {
        if (k >= nfields) break;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = src[i] >= 0 ? __ldg(f.src[k] + src[i]) : 0.0f;
        float* d = f.dst[k] + flat + z0;
        if (whole) {
          *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (z0 + i >= 0 && z0 + i < (int64_t)nz) d[i] = v[i];
        }
      }
    }
  }
}

template <typename I>
void launch_regrid(const RegridFields& f, int nfields, const void* table, const void* offsets,
                   const void* shifts, long long nx, long long ny, long long nz, long long ox,
                   long long oy, long long oz, long long ncx, long long ncy, long long ncz,
                   long long ty, long long tz, long long bx, long long by, long long bz,
                   int blocks, int threads, cudaStream_t stream) {
  const dim3 block(threads, kRegridThreads / threads);
  regrid_kernel<I><<<blocks, block, 0, stream>>>(
      f, nfields, (const int*)table, (const int64_t*)offsets, (const int*)shifts, (I)nx, (I)ny,
      (I)nz, (I)ox, (I)oy, (I)oz, (I)ncx, (I)ncy, (I)ncz, (I)ty, (I)tz, bx, by, bz);
}

}  // namespace

extern "C" {

int fava_block_row_moments(const void* d, const void* vx, const void* vy, const void* vz,
                           void* out, long long nrows, long long row_len, int vec, int blocks,
                           void* stream) {
  (void)cudaGetLastError();
  block_row_moments_kernel<<<blocks, kBlockRowThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)vx, (const float*)vy, (const float*)vz, (double*)out, nrows,
      row_len, vec);
  return launch_status();
}

int fava_block_centered_row_moments(const void* d, const void* vx, const void* vy, const void* vz,
                                    const void* means, void* out, long long nrows,
                                    long long row_len, int vec, int blocks, void* stream) {
  (void)cudaGetLastError();
  block_centered_row_moments_kernel<<<blocks, kBlockRowThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)vx, (const float*)vy, (const float*)vz,
      (const double*)means, (double*)out, nrows, row_len, vec);
  return launch_status();
}

// srcs/dsts: host arrays of nfields (1..8) device pointers; threads: the
// block's threads along z, a power of two up to kRegridThreads (the block
// holds kRegridThreads / threads output rows).
int fava_regrid_fields(const void* const* srcs, void* const* dsts, int nfields, const void* table,
                       const void* offsets, const void* shifts, long long nx, long long ny,
                       long long nz, long long ox, long long oy, long long oz, long long ncx,
                       long long ncy, long long ncz, long long ty, long long tz, long long bx,
                       long long by, long long bz, int blocks, int threads, void* stream) {
  (void)cudaGetLastError();
  if (nfields < 1 || nfields > kRegridMaxFields || threads < 1 || threads > kRegridThreads ||
      kRegridThreads % threads != 0)
    return (int)cudaErrorInvalidValue;
  RegridFields f{};
  for (int k = 0; k < nfields; ++k) {
    f.src[k] = (const float*)srcs[k];
    f.dst[k] = (float*)dsts[k];
  }
  const long long lim = 1LL << 31;
  const bool narrow = nx * ny < lim && ox + nx < lim && oy + ny < lim && oz + nz < lim &&
                      ty * tz * ((ox + nx) / ncx + 1) < lim && tz * ncz < lim;
  if (narrow) {
    launch_regrid<uint32_t>(f, nfields, table, offsets, shifts, nx, ny, nz, ox, oy, oz, ncx, ncy,
                            ncz, ty, tz, bx, by, bz, blocks, threads, (cudaStream_t)stream);
  } else {
    launch_regrid<int64_t>(f, nfields, table, offsets, shifts, nx, ny, nz, ox, oy, oz, ncx, ncy,
                           ncz, ty, tz, bx, by, bz, blocks, threads, (cudaStream_t)stream);
  }
  return launch_status();
}

// Blocks of the regrid kernel (narrow or wide indices) that fit one SM at
// once; a negative CUDA error code on failure.
int fava_regrid_blocks_per_sm(int wide) {
  (void)cudaGetLastError();
  int n = 0;
  const cudaError_t err =
      wide ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, regrid_kernel<int64_t>, kRegridThreads, 0)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, regrid_kernel<uint32_t>, kRegridThreads, 0);
  return err == cudaSuccess ? n : -(int)err;
}

}  // extern "C"
