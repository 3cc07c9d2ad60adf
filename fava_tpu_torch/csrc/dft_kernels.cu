// Hopper (sm_90a) kernel of the fused z-rfft + y-DFT of a real volume (B12).
//
// Replaces _zy_rfft_kernel (fava_tpu/experiments/pallas_dft.py:53), entry
// zy_rfft_planar (:92). Plain C entry point, bound with ctypes by
// fava_tpu_torch/ops/_build.py; it launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() of its launch.
//
// Per x slab i: A = x[i], (ny, nz) real. Z = A . [Cr | Ci] with Cr[z, k] =
// cos(2 pi z k / nz) and Ci[z, k] = -sin(2 pi z k / nz), k < nzr = nz/2 + 1
// (the rfft along z); then Y = W . Z with W[a, b] = exp(-2 pi i a b / ny)
// (the complex DFT along y). Output: planar re, im, each (nx, ny, nzr) f32,
// unnormalized, as fava_tpu's kernel.
//
// What bounds it: 2 ny nz nzr + 8 ny^2 nzr flops per slab (808.5 MFLOP at
// 512^3, 414 GFLOP per volume, 6.2 ms at 67 TFLOP/s f32 outside the tensor
// cores) against 1.6 GB of reads and writes (0.48 ms): operations. A dense
// DFT does O(n) work per output where an FFT does O(log n), so cuFFT
// computes the same function (torch.fft.rfftn over the y and z axes) in a
// fraction of the time; this kernel is the port of the TPU's fused
// transform and is timed against that library call.
//
// Design. The TPU kept a slab's whole intermediate Z (ny x nzr complex, 1 MB
// at 512^3) in 100 MB of VMEM. A Hopper block has at most 227 KB of shared
// memory, so a block owns one slab and a tile of kTK = 16 kz columns: it
// computes Z[:, tile] (ny x 16 complex, 64 KB at ny = 512) into shared
// memory, then Y[:, tile] = W . Z[:, tile] straight to the output; nothing
// intermediate goes to device memory. Blocks of one slab run side by side
// (the tile is the fast grid index), so the slab's 1 MB is read from device
// memory about once and from L2 by its other tiles. Both products are
// register-blocked f32 FMA loops over shared-memory tiles: Z in 128-row
// tiles, z in chunks of 32, 4 x 4 outputs a thread; Y 8 rows x 4 complex
// columns a thread. No TF32: its ~1e-3 would miss the 1e-5 bound (the TPU
// used a bf16x3 split, close to f32). Twiddles: tables of cos and sin(2 pi
// m / n), m < n, for z and y in shared memory, computed in double
// (sincospi) and rounded once to float; every product reads table[(j k) mod
// n] with the index reduced in integers, so no angle loses digits (a float
// angle 2 pi j k / n at j k ~ 1.3e5 keeps about three). The accumulation is
// f32 in a fixed order: the result differs from the f64 dense DFT by f32
// rounding, ~1e-7 of the largest coefficient. Extents: ny, nz <= 1024 (the
// Z tile, the A chunk and the tables take ~165 KB there); nx <= 65535 (the
// grid's y extent). The wrapper raises beyond.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_moments.cuh"

namespace {

using fava::launch_status;

constexpr int kThreads = 256;
constexpr int kTK = 16;          // kz columns of a block
constexpr int kCols = 2 * kTK;   // real columns of the Z tile: (re, im) per kz
constexpr int kRB = 128;         // rows of a Z row tile
constexpr int kZC = 32;          // z values of an A chunk
constexpr int kYRows = 8;        // Y rows per thread in a pass
constexpr int kYCols = 4;        // Y complex columns per thread
constexpr int kYGroups = kTK / kYCols;                 // column groups: 4
constexpr int kYRowStride = kThreads / kYGroups;       // 64
constexpr int kYPass = kYRowStride * kYRows;           // rows per pass: 512
constexpr int kMaxExtent = 1024;

static_assert(kThreads == 32 * 8 && kRB == 32 * 4 && kCols == 8 * 4, "phase-1 thread layout");

size_t smem_bytes(int ny, int nz) {
  return sizeof(float) * ((size_t)kZC * (kRB + 1) + (size_t)kZC * kCols + (size_t)ny * kCols) +
         sizeof(float2) * ((size_t)ny + nz);
}

__global__ void __launch_bounds__(kThreads)
zy_rfft_kernel(const float* __restrict__ x, float* __restrict__ re, float* __restrict__ im, int ny,
               int nz, int nzr) {
  // Shared layout, 16-byte aligned float regions first: the transposed A
  // chunk as[zz][r], the twiddle chunk cs[zz][2kk (cos), 2kk+1 (-sin)], the
  // Z tile zs[b][2kk (re), 2kk+1 (im)], then the twiddle tables.
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);
  float* cs = as + kZC * (kRB + 1);
  float* zs = cs + kZC * kCols;
  float2* tw_y = reinterpret_cast<float2*>(zs + (size_t)ny * kCols);
  float2* tw_z = tw_y + ny;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kTK;
  const int64_t slab = blockIdx.y;
  const float* a_slab = x + slab * ny * nz;

  for (int m = tid; m < ny; m += kThreads) {
    double s, c;
    sincospi(2.0 * m / ny, &s, &c);
    tw_y[m] = make_float2((float)c, (float)s);
  }
  for (int m = tid; m < nz; m += kThreads) {
    double s, c;
    sincospi(2.0 * m / nz, &s, &c);
    tw_z[m] = make_float2((float)c, (float)s);
  }

  // Phase 1: zs = A . [Cr | Ci][:, tile], one row tile at a time.
  const int tr = tid >> 3;  // rows tr + 32 q, q < 4
  const int tc = tid & 7;   // real columns 4 tc .. 4 tc + 3
  for (int b0 = 0; b0 < ny; b0 += kRB) {
    float acc[4][4] = {};
    for (int z0 = 0; z0 < nz; z0 += kZC) {
      __syncthreads();  // the previous chunk's reads are done (and the tables written)
      for (int e = tid; e < kZC * kRB; e += kThreads) {
        const int zz = e % kZC, r = e / kZC;
        const int b = b0 + r, z = z0 + zz;
        as[zz * (kRB + 1) + r] = (b < ny && z < nz) ? __ldg(a_slab + (int64_t)b * nz + z) : 0.0f;
      }
      for (int e = tid; e < kZC * kCols; e += kThreads) {
        const int zz = e / kCols, col = e % kCols;
        const int z = z0 + zz, k = k0 + (col >> 1);
        float v = 0.0f;
        if (z < nz) {
          const float2 w = tw_z[(z * k) % nz];
          v = (col & 1) ? -w.y : w.x;
        }
        cs[zz * kCols + col] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int zz = 0; zz < kZC; ++zz) {
        const float* arow = as + zz * (kRB + 1) + tr;
        const float a[4] = {arow[0], arow[32], arow[64], arow[96]};
        const float4 c = *reinterpret_cast<const float4*>(cs + zz * kCols + 4 * tc);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[q][0] = fmaf(a[q], c.x, acc[q][0]);
          acc[q][1] = fmaf(a[q], c.y, acc[q][1]);
          acc[q][2] = fmaf(a[q], c.z, acc[q][2]);
          acc[q][3] = fmaf(a[q], c.w, acc[q][3]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int b = b0 + tr + 32 * q;
      if (b < ny)
        *reinterpret_cast<float4*>(zs + (size_t)b * kCols + 4 * tc) =
            make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
    }
  }
  __syncthreads();

  // Phase 2: Y[a, kk] = sum_b W[a, b] Z[b, kk], W = cos - i sin.
  const int kq = tid % kYGroups;  // complex columns kq * 4 .. kq * 4 + 3
  const int ar = tid / kYGroups;  // rows a0 + ar + 64 r, r < 8
  for (int a0 = 0; a0 < ny; a0 += kYPass) {
    float yr[kYRows][kYCols] = {}, yi[kYRows][kYCols] = {};
    int m[kYRows], step[kYRows];
#pragma unroll
    for (int r = 0; r < kYRows; ++r) {
      const int a = a0 + ar + kYRowStride * r;
      m[r] = 0;  // (a b) mod ny at b = 0
      step[r] = a < ny ? a : 0;
    }
    for (int b = 0; b < ny; ++b) {
      const float4 z01 = *reinterpret_cast<const float4*>(zs + (size_t)b * kCols + 8 * kq);
      const float4 z23 = *reinterpret_cast<const float4*>(zs + (size_t)b * kCols + 8 * kq + 4);
      const float zr[4] = {z01.x, z01.z, z23.x, z23.z};
      const float zi[4] = {z01.y, z01.w, z23.y, z23.w};
#pragma unroll
      for (int r = 0; r < kYRows; ++r) {
        const float2 w = tw_y[m[r]];
#pragma unroll
        for (int p = 0; p < kYCols; ++p) {
          yr[r][p] = fmaf(w.x, zr[p], fmaf(w.y, zi[p], yr[r][p]));
          yi[r][p] = fmaf(w.x, zi[p], fmaf(-w.y, zr[p], yi[r][p]));
        }
        m[r] += step[r];
        if (m[r] >= ny) m[r] -= ny;
      }
    }
#pragma unroll
    for (int r = 0; r < kYRows; ++r) {
      const int a = a0 + ar + kYRowStride * r;
      if (a >= ny) continue;
      const int64_t row = (slab * ny + a) * nzr;
#pragma unroll
      for (int p = 0; p < kYCols; ++p) {
        const int k = k0 + kYCols * kq + p;
        if (k < nzr) {
          re[row + k] = yr[r][p];
          im[row + k] = yi[r][p];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x: (nx, ny, nz) f32; re, im: (nx, ny, nz/2+1) f32.
int fava_zy_rfft(const void* x, void* re, void* im, int nx, int ny, int nz, void* stream) {
  (void)cudaGetLastError();
  if (nx < 1 || nx > 65535 || ny < 1 || ny > kMaxExtent || nz < 1 || nz > kMaxExtent)
    return (int)cudaErrorInvalidValue;
  const int nzr = nz / 2 + 1;
  const size_t smem = smem_bytes(ny, nz);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        zy_rfft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((nzr + kTK - 1) / kTK, nx);
  zy_rfft_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)re, (float*)im, ny, nz, nzr);
  return launch_status();
}

}  // extern "C"
