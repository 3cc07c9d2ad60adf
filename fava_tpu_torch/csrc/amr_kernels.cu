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
// rules; here each thread finds its source cell by integer arithmetic. A
// thread block walks output rows (x, y) and its threads step along z, so the
// stores coalesce and the per-row work (x/y tile and the row's index) is done
// once per row; one launch copies up to kRegridMaxFields fields, so each
// cell's source index is worked out once for all of them. Any block shape
// and scale is taken.

struct RegridFields {
  const float* src[kRegridMaxFields];
  float* dst[kRegridMaxFields];
};

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// Coordinates are non-negative; I is uint32_t when every coordinate and the
// row count fit in 31 bits (64-bit integer division costs several times
// more instructions, and the division per cell bounds this kernel), and
// int64_t otherwise. Output and source offsets are always 64-bit.
template <typename I>
__global__ void regrid_kernel(RegridFields f, int nfields, const int* __restrict__ table,
                              const int64_t* __restrict__ offsets, const int* __restrict__ shifts,
                              I nx, I ny, I nz, I ox, I oy, I oz, I ncx, I ncy, I ncz, I ty, I tz,
                              int64_t bx, int64_t by, int64_t bz) {
  for (I row = blockIdx.x; row < nx * ny; row += gridDim.x) {
    const I gx = row / ny + ox;
    const I gy = row % ny + oy;
    const I tile_row = ((gx / ncx) * ty + gy / ncy) * tz;
    for (I z = threadIdx.x; z < nz; z += blockDim.x) {
      const I gz = z + oz;
      const int64_t out = (int64_t)row * nz + z;
      const int blk = table[tile_row + gz / ncz];
      if (blk < 0) {
        for (int k = 0; k < nfields; ++k) f.dst[k][out] = 0.0f;
        continue;
      }
      const int s = shifts[blk];
      const int64_t* o = offsets + 3 * (int64_t)blk;
      const int64_t cx = clamp64(((int64_t)gx - o[0]) >> s, bx - 1);
      const int64_t cy = clamp64(((int64_t)gy - o[1]) >> s, by - 1);
      const int64_t cz = clamp64(((int64_t)gz - o[2]) >> s, bz - 1);
      const int64_t src = (((int64_t)blk * bx + cx) * by + cy) * bz + cz;
      for (int k = 0; k < nfields; ++k) f.dst[k][out] = __ldg(f.src[k] + src);
    }
  }
}

template <typename I>
void launch_regrid(const RegridFields& f, int nfields, const void* table, const void* offsets,
                   const void* shifts, long long nx, long long ny, long long nz, long long ox,
                   long long oy, long long oz, long long ncx, long long ncy, long long ncz,
                   long long ty, long long tz, long long bx, long long by, long long bz,
                   int blocks, int threads, cudaStream_t stream) {
  regrid_kernel<I><<<blocks, threads, 0, stream>>>(
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

// srcs/dsts: host arrays of nfields (1..8) device pointers.
int fava_regrid_fields(const void* const* srcs, void* const* dsts, int nfields, const void* table,
                       const void* offsets, const void* shifts, long long nx, long long ny,
                       long long nz, long long ox, long long oy, long long oz, long long ncx,
                       long long ncy, long long ncz, long long ty, long long tz, long long bx,
                       long long by, long long bz, int blocks, int threads, void* stream) {
  (void)cudaGetLastError();
  if (nfields < 1 || nfields > kRegridMaxFields) return (int)cudaErrorInvalidValue;
  RegridFields f{};
  for (int k = 0; k < nfields; ++k) {
    f.src[k] = (const float*)srcs[k];
    f.dst[k] = (float*)dsts[k];
  }
  const long long lim = 1LL << 31;
  const bool narrow = nx * ny < lim && ox + nx < lim && oy + ny < lim && oz + nz < lim &&
                      ty * tz * ((ox + nx) / ncx + 1) < lim;
  if (narrow) {
    launch_regrid<uint32_t>(f, nfields, table, offsets, shifts, nx, ny, nz, ox, oy, oz, ncx, ncy,
                            ncz, ty, tz, bx, by, bz, blocks, threads, (cudaStream_t)stream);
  } else {
    launch_regrid<int64_t>(f, nfields, table, offsets, shifts, nx, ny, nz, ox, oy, oz, ncx, ncy,
                           ncz, ty, tz, bx, by, bz, blocks, threads, (cudaStream_t)stream);
  }
  return launch_status();
}

}  // extern "C"
