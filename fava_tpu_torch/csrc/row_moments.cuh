// Per-row moment building blocks shared by the uniform-volume kernels
// (K1, K2 in flagship_kernels.cu) and the AMR block-stack kernels (K5, K6
// in amr_kernels.cu): the per-cell functors that add one cell's terms to
// float64 partials, a strided sweep over one contiguous row of the four
// fields, and a warp reduction of the partials.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fava {

constexpr unsigned kFullMask = 0xffffffffu;

struct RawCell {  // [d, vx, vy, vz, dvx, dvy, dvz, dvxvx, dvxvy, dvxvz, dvyvy, dvyvz, dvzvz]
  __device__ __forceinline__ void operator()(double (&a)[13], float fd, float fx, float fy,
                                             float fz) const {
    const double d = fd, x = fx, y = fy, z = fz;
    const double dx = d * x, dy = d * y, dz = d * z;
    a[0] += d;
    a[1] += x;
    a[2] += y;
    a[3] += z;
    a[4] += dx;
    a[5] += dy;
    a[6] += dz;
    a[7] += dx * x;
    a[8] += dx * y;
    a[9] += dx * z;
    a[10] += dy * y;
    a[11] += dy * z;
    a[12] += dz * z;
  }
};

struct RawFirstCell {  // [d, vx, vy, vz, dvx, dvy, dvz]: the first 7 of RawCell
  __device__ __forceinline__ void operator()(double (&a)[7], float fd, float fx, float fy,
                                             float fz) const {
    const double d = fd, x = fx, y = fy, z = fz;
    a[0] += d;
    a[1] += x;
    a[2] += y;
    a[3] += z;
    a[4] += d * x;
    a[5] += d * y;
    a[6] += d * z;
  }
};

struct CenteredCell {  // [d*ci*cj for xx,xy,xz,yy,yz,zz, then d*ci for x,y,z]
  double mx, my, mz;
  __device__ __forceinline__ void operator()(double (&a)[9], float fd, float fx, float fy,
                                             float fz) const {
    const double d = fd;
    const double cx = fx - mx, cy = fy - my, cz = fz - mz;
    const double dcx = d * cx, dcy = d * cy, dcz = d * cz;
    a[0] += dcx * cx;
    a[1] += dcx * cy;
    a[2] += dcx * cz;
    a[3] += dcy * cy;
    a[4] += dcy * cz;
    a[5] += dcz * cz;
    a[6] += dcx;
    a[7] += dcy;
    a[8] += dcz;
  }
};

// Adds cell(...) of every cell of one row of length ``len`` into acc. The
// calling threads split the row: thread ``tid`` of ``nthreads`` takes every
// nthreads-th element (every nthreads-th float4 when ``vec``, which needs
// 16-byte aligned row starts).
template <int N, typename Cell>
__device__ __forceinline__ void row_sweep(const float* __restrict__ d, const float* __restrict__ vx,
                                          const float* __restrict__ vy, const float* __restrict__ vz,
                                          int64_t len, bool vec, int tid, int nthreads,
                                          double (&acc)[N], const Cell& cell) {
  int64_t start = 0;
  if (vec) {
    const float4* d4 = reinterpret_cast<const float4*>(d);
    const float4* x4 = reinterpret_cast<const float4*>(vx);
    const float4* y4 = reinterpret_cast<const float4*>(vy);
    const float4* z4 = reinterpret_cast<const float4*>(vz);
    const int64_t n4 = len >> 2;
    for (int64_t i = tid; i < n4; i += nthreads) {
      const float4 a = __ldg(d4 + i), b = __ldg(x4 + i), c = __ldg(y4 + i), e = __ldg(z4 + i);
      cell(acc, a.x, b.x, c.x, e.x);
      cell(acc, a.y, b.y, c.y, e.y);
      cell(acc, a.z, b.z, c.z, e.z);
      cell(acc, a.w, b.w, c.w, e.w);
    }
    start = n4 << 2;
  }
  for (int64_t i = start + tid; i < len; i += nthreads) {
    cell(acc, __ldg(d + i), __ldg(vx + i), __ldg(vy + i), __ldg(vz + i));
  }
}

// Sums each acc[m] over the warp; lane 0 ends with the totals.
template <int N>
__device__ __forceinline__ void warp_sum(double (&acc)[N]) {
#pragma unroll
  for (int m = 0; m < N; ++m) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[m] += __shfl_down_sync(kFullMask, acc[m], o);
  }
}

inline int launch_status() { return (int)cudaGetLastError(); }

}  // namespace fava
