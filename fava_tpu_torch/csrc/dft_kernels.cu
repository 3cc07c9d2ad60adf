// Hopper (sm_90a) kernels of the fused z-rfft + y-DFT of a real volume (B12).
//
// Both replace _zy_rfft_kernel (fava_tpu/experiments/pallas_dft.py:53),
// entry zy_rfft_planar (:92). Plain C entry points, bound with ctypes by
// fava_tpu_torch/ops/_build.py; each launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() of its launch.
//
// The function, per x slab i: Z = rfft_z(x[i]), (ny, nzr = nz/2 + 1)
// complex; then Y = DFT_y(Z). Output: planar re, im, each (nx, ny, nzr)
// f32, unnormalized, as fava_tpu's kernel.
//
// What bounds it: bytes. One read of the real slab and one write of the two
// planes: 0.54 GB in and 0.54 GB out at 512^3, 0.32 ms at 3.35 TB/s. Done as
// FFTs its arithmetic is 6 GFLOP (0.09 ms at 67 TFLOP/s f32).
//
// zy_fft_kernel, a cluster FFT, takes every ny and nz in 1..1024
// (zy_rfft_fits in ops/cuda_kernels.py). Extents whose prime factors are
// all <= 7 (FLASH's nxb x nblocks x 2^L for block counts of 3, 5 or 6:
// 384, 480, 640, 768, ..., and powers of two) take mixed-radix passes; an
// extent with a prime factor above 7 (block counts of 11 or 13, windows
// cut at any width: 502 = 2 x 251, 509, 511 = 7 x 73) is a chirp axis,
// transformed by Bluestein's algorithm in the same kernel (chirp_run);
// nz = 1 has no z transform. zy_rfft_kernel, a dense DFT, stays callable
// on no route, as the time the chirp route replaced.
//
// zy_fft_kernel. The TPU kept a slab's intermediate Z (1 MB at 512^2) in
// VMEM; here a thread-block cluster keeps it in its blocks' shared memory,
// so Z never goes to device memory and the kernel moves only the bound's
// bytes. The plan (cluster size C, passes P, row batch, slots a rank owns,
// strides, shared bytes, radices) comes from _zy_fft_plan in
// ops/cuda_kernels.py. The kz columns are column slots:
//   even nz: nz/2 slots from an nz/2-point complex transform of each row
//     (its nz reals as nz/2 complex values) and the post-twiddle X[k] =
//     E[k] + W_nz^k O[k]; slot 0 holds the real columns kz = 0 and nz/2
//     packed as one complex column, slot u > 0 holds kz = u;
//   odd nz: (nz+1)/2 slots, slot u holds kz = u. Rows a and b (a pair of a
//     batch; an odd batch's last row pairs with zeros) go through one
//     nz-point complex transform C of x[a] + i x[b], split by Hermitian
//     symmetry: X_a[k] = (C[k] + conj C[nz-k]) / 2, X_b[k] = (C[k] -
//     conj C[nz-k]) / 2i. No real column is packed.
// A cluster of C blocks does pass p of slab i (grid (C P, nx)):
//   phase 1: rank r transforms its rows [r ny / C, (r+1) ny / C) along z, a
//     batch at a time in a work buffer: the first of the in-place
//     decimation-in-frequency passes reads the rows from device memory;
//     then each X[k] of the slots of pass p, read from the digit-reversed
//     result, is stored through distributed shared memory
//     (cluster.map_shared_rank) straight into the rank that owns slot k,
//     which holds all ny rows of its slots;
//   cluster.sync(): every rank's slots are written and visible;
//   phase 2: rank r runs the y passes down its slots in place, the last
//     pass writing re and im; for even nz slot 0's transform is split by
//     Hermitian symmetry into kz = 0 and nz/2.
// Nothing reads another block's shared memory after the barrier, so a block
// leaves when its phase 2 is done; a split barrier at the start
// (barrier.cluster.arrive, then wait before the first store into another
// rank) makes sure every rank has started. A slab whose Z does not fit the
// cluster is done in P passes over slot ranges (1024^2: P = 2), each
// re-running phase 1 for its slots. Two blocks of 256 threads share an SM
// (~113 KB of shared memory each at 512^2), the one block shape that fits:
// their phases overlap.
//
// Mixed radix. A pass of radix R on sub-transforms of length L is an R-point
// DFT in registers on the values L/R apart, then twiddles W_L^(j t): radices
// 2, 4, 8, 16 (as 4 x 4), 3, 5, 7 (the direct odd formula, its cosines and
// sines folded to constants), and 6, 10, 12, 14, 15 by the prime-factor
// (Good-Thomas) map of two coprime radices, which needs no twiddle between
// them. The composites save a pass or beat the other factorings of their
// extents on an H100 (probe_zy_fft.py --designs: 15 saves 6-9% at 480 and
// 375, 12 2% at 384); 9 gained nothing and went. 14 gains nothing at 896
// either, but without its case ptxas spilled this build at 128 registers
// and 512 x 480 x 512 ran 1.268 against 1.125 ms (chip_smoke.py): it
// stays. The plan takes the
// fewest passes of these (240 = 15 x 16, 480 = 10 x 6 x 8, 375 = 15 x 5 x
// 5), odd parts first, so that the first pass's global loads run along
// rows. The output digit reversal is mixed radix (fft_pos). Where the
// passes, batches and slot ranges are powers of two (power-of-two ny and
// nz: zy_fft_kernel<kPow2>) work items are split by shifts; otherwise
// (zy_fft_kernel<kMixed>, <kChirp>) by multiplying with magic numbers (Dv<false>) that
// the tables carry, one per divisor of the plan: a pass gives each thread
// about one item, and integer division per item (~20 instructions each,
// two an item) cost 1.58 against 1.46 ms at 512 x 512 x 480 on an H100.
// The power-of-two plans keep the shift build: through the divisors they
// ran 1.154 against 1.043 ms at 512^3 and 0.173 against 0.154 ms at (8,
// 1024, 1024) (--designs, bit-equal). Rows and slots are shared out
// unevenly (floor(r ny / C), floor(u slots / (C P))) when C or C P does not
// divide them. Cluster sizes and pass counts stay powers of two.
//
// Chirp axes (zy_fft_kernel<kChirp>, an instantiation of its own, so that
// the other two compile as before: the mixed-radix build sits at 128
// registers, where ptxas spilled on small changes). An n-point axis
// becomes an m-point circular convolution with the chirp exp(i pi k^2 /
// n), m >= 2n - 1 and 7-smooth (_chirp_length: <= 2048, at least two
// passes): the premultiply as the first DIF pass reads the rows (zeros past
// n), the DIF passes, the filter (the convolution kernel's transform,
// digit-reversed) in one pass with the last DIF and the first inverse pass,
// the inverse passes on the conjugated data reading digit-reversed and
// leaving natural order, and the postmultiply as the last of them writes
// (chirp_run). Along z, phase 1's rows grow to m values (the post-process
// then reads natural order); along y, each slot column holds my rows, the
// rows past ny read as zeros. The chirp and filter tables (nt + mz, ny +
// my float2) are copied into shared memory with the others where the
// plan's budget holds them, and read from device memory (L2) otherwise
// (gtab: 1021 x 1019 needs 49 KB of them).
//
// Twiddles: for the post-process and for each pass (W_L^(j t) at t L/R + j,
// so lanes on consecutive j read consecutive entries), built once in device
// memory in double (sincospi), rounded once to float, and copied into
// shared memory by every block with the digit positions
// (zy_fft_tables_kernel). f32 arithmetic, no TF32: one rounding stage a
// pass, ~1e-7 of the largest coefficient. Strides are odd, and phase 1's
// rows carry one padding slot per 2^v values where 2^v (v >= 2) is the
// power of two in the first pass's span, so the post-process's
// digit-reversed reads hit distinct banks. The C entry checks the plan and
// that the cluster can be scheduled (cudaOccupancyMaxActiveClusters); it
// returns an error otherwise.
//
// zy_rfft_kernel, the dense kernel: Z = A . [Cr | Ci] with Cr[z, k] =
// cos(2 pi z k / nz), Ci[z, k] = -sin(2 pi z k / nz), then Y = W . Z with
// W[a, b] = exp(-2 pi i a b / ny). It does O(n) work per output where an FFT
// does O(log n): 414 GFLOP per 512^3 volume, 6.2 ms at the f32 peak, far
// over the bytes bound; the chirp route took its last shapes.
//
// Design of the dense kernel. A block owns one slab and a tile of kTK = 16
// kz columns: it computes Z[:, tile] (ny x 16 complex, 64 KB at ny = 512)
// into shared memory, then Y[:, tile] = W . Z[:, tile] straight to the
// output; nothing intermediate goes to device memory. Blocks of one slab run
// side by side (the tile is the fast grid index), so the slab's 1 MB is read
// from device memory about once and from L2 by its other tiles. Both
// products are register-blocked f32 FMA loops over shared-memory tiles: Z in
// 128-row tiles, z in chunks of 32, 4 x 4 outputs a thread; Y 8 rows x 4
// complex columns a thread. No TF32: its ~1e-3 would miss the 1e-5 bound.
// Twiddles: (cos, sin)(2 pi m / n) tables in shared memory, built in double
// and rounded once, read at (j k) mod n reduced in integers. The accumulation is
// f32 in a fixed order: ~1e-6 of the largest coefficient (sums of up to
// 1024 products of both signs). Extents: ny, nz <= 1024 (the Z tile, the A
// chunk and the tables take ~165 KB there); nx <= 65535 (the grid's y
// extent). The wrappers raise beyond.

#include <cooperative_groups.h>
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


// ---------------------------------------------------------------------------
// The cluster FFT kernel

constexpr int kFftThreads = 256;  // two blocks an SM: <= 128 registers a thread
constexpr int kMaxStages = 10;  // ZY_MAX_STAGES in ops/cuda_kernels.py
// Dynamic shared bytes a block may take: sm_90's 232,448 less room for the
// kernel's static arrays (ZY_SMEM_MAX in ops/cuda_kernels.py).
constexpr int kFftSmemMax = 232448 - 256;

constexpr int kMaxLength = 2048;  // longest transform: a chirp axis's convolution (16 x 16 x 8)

// The plan, as ZyFftPlan.as_ints() lays it out: rows is the most rows a
// rank holds, batch the rows of a batch (even for odd nz), tile the most
// slots a rank owns, rz and ry the radices of the z and y passes; mz and my
// the lengths of the z and y transforms (nt and ny, or a chirp axis's
// convolution), gtab 1 when the chirp axes' tables stay in global memory.
struct ZyFftPlan {
  int ny, nz, cluster, passes, rows, batch, tile, ws, es, work, smem, nrz, nry;
  int rz[kMaxStages], ry[kMaxStages];
  int mz, my, gtab;
};
constexpr int kPlanHead = 13;  // ints before the radices

// The kernel's builds: every divisor of the plan a power of two (shifts),
// 7-smooth extents (divisors from the tables), and a chirp axis.
enum ZyMode { kPow2, kMixed, kChirp };

// The z transform's length (nz/2 for even nz, nz for odd) and the column
// slots ((nz+1)/2 either way: nz/2 slots with kz 0 and nz/2 packed, or
// (nz+1)/2 plain ones).
__host__ __device__ __forceinline__ int zy_nt(const ZyFftPlan& p) { return (p.nz & 1) ? p.nz : p.nz >> 1; }
__host__ __device__ __forceinline__ int zy_nslot(const ZyFftPlan& p) { return (p.nz + 1) >> 1; }

__host__ __device__ __forceinline__ bool pow2(int n) { return n >= 1 && (n & (n - 1)) == 0; }

// The lengths of the z and y transforms: nt and ny but on a chirp axis.
template <int Mode>
__host__ __device__ __forceinline__ int zy_mz(const ZyFftPlan& p) { return Mode == kChirp ? p.mz : zy_nt(p); }
template <int Mode>
__host__ __device__ __forceinline__ int zy_my(const ZyFftPlan& p) { return Mode == kChirp ? p.my : p.ny; }

// The build of a plan: kPow2 where every divisor is a power of two (its
// tables hold no divisors; nz >= 2, whose rows the build never pairs),
// kChirp where an axis has a prime factor above 7.
__host__ __device__ __forceinline__ int zy_mode(const ZyFftPlan& p) {
  if (p.mz != zy_nt(p) || p.my != p.ny) return kChirp;
  return pow2(p.ny) && pow2(p.nz) && p.nz > 1 && pow2(p.batch) ? kPow2 : kMixed;
}

// Whether an axis is a chirp axis (kChirp plans only), which leaves natural
// order: no positions table, and along z no padding.
template <int Mode>
__host__ __device__ __forceinline__ bool chirp_z(const ZyFftPlan& p) { return Mode == kChirp && p.mz != zy_nt(p); }
template <int Mode>
__host__ __device__ __forceinline__ bool chirp_y(const ZyFftPlan& p) { return Mode == kChirp && p.my != p.ny; }

// Phase 1's rows carry one padding slot per 2^v values, 2^v the power of two
// in the first pass's span mz / R0 when v >= 2 (31: none), which spreads the
// post-process's digit-reversed reads over the banks.
template <int Mode>
__host__ __device__ __forceinline__ int zy_pad(const ZyFftPlan& p) {
  if (chirp_z<Mode>(p)) return 31;
  const int nt = zy_mz<Mode>(p), span = p.nrz ? nt / p.rz[0] : nt;
  int v = 0;
  while (v < 30 && !((span >> v) & 1)) ++v;
  return v >= 2 ? v : 31;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }  // -i a

// R-point forward DFT in registers, natural order in and out.
template <int R>
struct Dft;
template <>
struct Dft<2> {
  static __device__ __forceinline__ void run(float2* v) {
    const float2 a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
  }
};
template <>
struct Dft<4> {
  static __device__ __forceinline__ void run(float2* v) {
    const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    const float2 t2 = cadd(v[1], v[3]), t3 = mul_mi(csub(v[1], v[3]));
    v[0] = cadd(t0, t2);
    v[2] = csub(t0, t2);
    v[1] = cadd(t1, t3);
    v[3] = csub(t1, t3);
  }
};
template <>
struct Dft<8> {
  static __device__ __forceinline__ void run(float2* v) {
    const float h = 0.70710678118654752f;
    float2 a[4], b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[j] = cadd(v[j], v[j + 4]);
      b[j] = csub(v[j], v[j + 4]);
    }
    b[1] = make_float2(h * (b[1].x + b[1].y), h * (b[1].y - b[1].x));   // * W8^1
    b[2] = mul_mi(b[2]);                                                // * W8^2
    b[3] = make_float2(h * (b[3].y - b[3].x), -h * (b[3].x + b[3].y));  // * W8^3
    Dft<4>::run(a);
    Dft<4>::run(b);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = a[k];
      v[2 * k + 1] = b[k];
    }
  }
};

template <>
struct Dft<16> {  // 4 x 4: DFT4 down the columns, the twiddles W16^(j s), DFT4 across
  static __device__ __forceinline__ void run(float2* v) {
    const float c1 = 0.92387953251128676f, s1 = 0.38268343236508977f, h = 0.70710678118654752f;
    float2 a[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 t[4] = {v[j], v[j + 4], v[j + 8], v[j + 12]};
      Dft<4>::run(t);
#pragma unroll
      for (int s = 0; s < 4; ++s) a[j][s] = t[s];
    }
    a[1][1] = cmul(a[1][1], make_float2(c1, -s1));  // W16^1
    a[1][2] = cmul(a[1][2], make_float2(h, -h));    // W16^2
    a[1][3] = cmul(a[1][3], make_float2(s1, -c1));  // W16^3
    a[2][1] = cmul(a[2][1], make_float2(h, -h));    // W16^2
    a[2][2] = mul_mi(a[2][2]);                      // W16^4
    a[2][3] = cmul(a[2][3], make_float2(-h, -h));   // W16^6
    a[3][1] = cmul(a[3][1], make_float2(s1, -c1));  // W16^3
    a[3][2] = cmul(a[3][2], make_float2(-h, -h));   // W16^6
    a[3][3] = cmul(a[3][3], make_float2(-c1, s1));  // W16^9
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float2 t[4] = {a[0][s], a[1][s], a[2][s], a[3][s]};
      Dft<4>::run(t);
#pragma unroll
      for (int q = 0; q < 4; ++q) v[s + 4 * q] = t[q];
    }
  }
};

// cos and sin of 2 pi m / P, 1 <= m <= (P-1)/2, for the odd radices; m is
// a constant once the callers' loops are unrolled, so the switch folds.
template <int P>
struct UnitRoot;
template <>
struct UnitRoot<3> {
  static __device__ __forceinline__ float cos(int) { return -0.5f; }
  static __device__ __forceinline__ float sin(int) { return 0.86602540378443864676f; }
};
template <>
struct UnitRoot<5> {
  static __device__ __forceinline__ float cos(int m) {
    return m == 1 ? 0.3090169943749474241f : -0.8090169943749474241f;
  }
  static __device__ __forceinline__ float sin(int m) {
    return m == 1 ? 0.95105651629515357212f : 0.58778525229247312917f;
  }
};
template <>
struct UnitRoot<7> {
  static __device__ __forceinline__ float cos(int m) {
    return m == 1 ? 0.62348980185873353053f : m == 2 ? -0.22252093395631440429f : -0.90096886790241912624f;
  }
  static __device__ __forceinline__ float sin(int m) {
    return m == 1 ? 0.78183148246802980871f : m == 2 ? 0.97492791218182360702f : 0.43388373911755812048f;
  }
};
// An odd prime P-point DFT by the direct formula on symmetric sums: with a_n =
// v[n] + v[P-n], b_n = v[n] - v[P-n] (1 <= n <= H = (P-1)/2), X[k] = re_k -
// i im_k and X[P-k] = re_k + i im_k, re_k = v[0] + sum_n cos(2 pi n k / P)
// a_n, im_k = sum_n sin(2 pi n k / P) b_n.
template <int P>
struct OddDft {
  static __device__ __forceinline__ void run(float2* v) {
    constexpr int H = (P - 1) / 2;
    float2 a[H], b[H];
    float2 x0 = v[0];
#pragma unroll
    for (int n = 1; n <= H; ++n) {
      a[n - 1] = cadd(v[n], v[P - n]);
      b[n - 1] = csub(v[n], v[P - n]);
      x0 = cadd(x0, a[n - 1]);
    }
#pragma unroll
    for (int k = 1; k <= H; ++k) {
      float2 re = v[0], im = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int n = 1; n <= H; ++n) {
        const int m = (n * k) % P;  // 1 .. P-1 for prime P; m > H by symmetry
        const float c = UnitRoot<P>::cos(m <= H ? m : P - m);
        const float s = m <= H ? UnitRoot<P>::sin(m) : -UnitRoot<P>::sin(P - m);
        re = make_float2(fmaf(c, a[n - 1].x, re.x), fmaf(c, a[n - 1].y, re.y));
        im = make_float2(fmaf(s, b[n - 1].x, im.x), fmaf(s, b[n - 1].y, im.y));
      }
      v[k] = make_float2(re.x + im.y, re.y - im.x);
      v[P - k] = make_float2(re.x - im.y, re.y + im.x);
    }
    v[0] = x0;
  }
};
template <>
struct Dft<3> : OddDft<3> {};
template <>
struct Dft<5> : OddDft<5> {};
template <>
struct Dft<7> : OddDft<7> {};

__host__ __device__ constexpr int inverse_mod(int a, int m) {
  int x = 1;
  while ((a * x) % m != 1) ++x;
  return x;
}

// An N1 N2-point DFT for coprime N1, N2 by the prime-factor map: input n =
// (N2 n1 + N1 n2) mod N, DFT_N1 along n1, DFT_N2 along n2, output at the
// CRT index k = (e1 k1 + e2 k2) mod N. No twiddles between the two.
template <int N1, int N2>
struct Pfa {
  static __device__ __forceinline__ void run(float2* v) {
    constexpr int N = N1 * N2;
    constexpr int e1 = N2 * inverse_mod(N2 % N1, N1), e2 = N1 * inverse_mod(N1 % N2, N2);
    float2 a[N2][N1];
#pragma unroll
    for (int n2 = 0; n2 < N2; ++n2) {
#pragma unroll
      for (int n1 = 0; n1 < N1; ++n1) a[n2][n1] = v[(N2 * n1 + N1 * n2) % N];
      Dft<N1>::run(a[n2]);
    }
#pragma unroll
    for (int k1 = 0; k1 < N1; ++k1) {
      float2 t[N2];
#pragma unroll
      for (int n2 = 0; n2 < N2; ++n2) t[n2] = a[n2][k1];
      Dft<N2>::run(t);
#pragma unroll
      for (int k2 = 0; k2 < N2; ++k2) v[(e1 * k1 + e2 * k2) % N] = t[k2];
    }
  }
};
template <>
struct Dft<6> : Pfa<2, 3> {};
template <>
struct Dft<10> : Pfa<2, 5> {};
template <>
struct Dft<12> : Pfa<4, 3> {};
template <>
struct Dft<14> : Pfa<2, 7> {};
template <>
struct Dft<15> : Pfa<3, 5> {};

#ifdef __CUDA_ARCH__
__device__ __forceinline__ int log2_pow2(int d) { return __ffs(d) - 1; }
__device__ __forceinline__ unsigned mul_hi(unsigned a, unsigned b) { return __umulhi(a, b); }
#else
__device__ int log2_pow2(int d);  // device code only
__device__ unsigned mul_hi(unsigned a, unsigned b);
#endif

// Division by a divisor uniform across the block. P2 (every divisor of the
// plan a power of two): a shift, its log taken where it is needed. Else
// precomputed in the plan's tables (make_dv): a shift for a power of two,
// otherwise the high word of n * m with m = ceil(2^32 / d), exact for n
// and d up to 2^16 (every dividend of the kernel is an index into its
// shared memory, < 29,056, or a slot's owner, bounded by plan_ok).
template <bool P2>
struct Dv;
template <>
struct Dv<true> {
  int l, d;
  Dv() = default;
  __device__ __forceinline__ explicit Dv(int d_) : l(log2_pow2(d_)), d(d_) {}
  __device__ __forceinline__ int div(int n) const { return n >> l; }
  __device__ __forceinline__ int mul(int q) const { return q << l; }
};
template <>
struct Dv<false> {
  unsigned m;  // 0: d = 2^l
  unsigned short d, l;
  __device__ __forceinline__ int div(int n) const { return m ? (int)mul_hi((unsigned)n, m) : n >> l; }
  __device__ __forceinline__ int mul(int q) const { return q * d; }
};

__device__ __forceinline__ Dv<false> make_dv(int d) {
  Dv<false> v{0, (unsigned short)d, 0};
  if (d & (d - 1))
    v.m = 0xffffffffu / (unsigned)d + 1;
  else
    v.l = (unsigned short)log2_pow2(d);
  return v;
}

// The mixed-radix kernel's divisors in its tables (kDivs of them): the z
// and y passes' sub-lengths L/R, phase 1's sequences of a full batch, the
// slot count, the two widths of a pass's slot range and of a rank's.
constexpr int kDivs = 2 * kMaxStages + 6;
enum { kDvZ = 0, kDvY = kMaxStages, kDvSeqs = 2 * kMaxStages, kDvSlots, kDvPass, kDvPassHi, kDvRank,
       kDvRankHi };

// The divisor d: P2, its shift; else the entry lo of the tables, or hi
// when lo divides by another value (the two widths of a range).
template <bool P2>
__device__ __forceinline__ Dv<P2> divisor(int d, const Dv<false>* dvs, int lo, int hi) {
  if constexpr (P2)
    return Dv<true>(d);
  else
    return dvs[lo].d == d ? dvs[lo] : dvs[hi];
}

// Where a pass reads and writes element e of sequence s. The passes work in
// place in shared memory, but phase 1's first pass reads the slab's rows
// from device memory and phase 2's last pass writes the output.
struct SmemSeq {  // element e of sequence s at buf[s ss + (e + (e >> pad)) es]
  float2* buf;
  int ss, es, pad;  // pad: one padding slot per 2^pad elements (31: none)
  __device__ __forceinline__ int at(int s, int e) const { return s * ss + (e + (e >> pad)) * es; }
  __device__ __forceinline__ float2 load(int s, int e) const { return buf[at(s, e)]; }
  __device__ __forceinline__ void store(int s, int e, float2 v) const { buf[at(s, e)] = v; }
};

// Complex value e of sequence s of a batch. Even nz: the reals 2e, 2e+1 of
// row s. Odd nz: (x[2s][e], x[2s+1][e]), the second 0 past the batch's
// last row.
template <bool P2>
struct SlabRows {
  const float* src;
  int nz, vec, odd, nrows;  // vec: the slab is 8-byte aligned (float2 loads)
  __device__ __forceinline__ float2 load(int s, int e) const {
    if (!P2 && odd) {
      const float* q = src + 2 * s * nz + e;
      return make_float2(__ldg(q), 2 * s + 1 < nrows ? __ldg(q + nz) : 0.0f);
    }
    const float* q = src + s * nz + 2 * e;
    return vec ? __ldg(reinterpret_cast<const float2*>(q)) : make_float2(__ldg(q), __ldg(q + 1));
  }
};

template <bool Natural>
struct OutColumns {  // position e of column s holds output row ipos[e] (Natural: e) of slot col0 + s
  float* re;  // the slab's planes
  float* im;
  const uint16_t* ipos;
  SmemSeq stash;  // even nz: slot 0 (kz 0 and nz/2 packed) stays in shared memory for the split
  int nzr, col0, packed;
  __device__ __forceinline__ void store(int s, int e, float2 v) const {
    if (packed && col0 + s == 0) {
      stash.store(s, e, v);
      return;
    }
    const int o = (Natural ? e : ipos[e]) * nzr + col0 + s;
    re[o] = v.x;
    im[o] = v.y;
  }
};

// One in-place decimation-in-frequency pass of radix R over nseq (<= slots)
// sequences of length nt, on sub-transforms of length L: x[g L + j + t L/R],
// t < R, goes through an R-point DFT and output t, times W_L^(j t) =
// tw[t L/R + j] (the pass's own table, so lanes on consecutive j read
// consecutive twiddles), goes back to g L + t L/R + j. Work items run j
// fastest while L/R >= 16 (lanes on consecutive elements), s fastest below
// (lanes on sequences, whose strides are odd). Dit: the twiddles before the
// DFT, which undoes the DIF pass on conjugated data (chirp_run).
template <int R, bool P2, bool Dit = false, class Src, class Dst>
__device__ void fft_pass(const Src& src, const Dst& dst, int nt, int L, Dv<P2> subd, Dv<P2> slotd, int nseq,
                         const float2* tw) {
  const int sub = subd.d;
  const int items = nt / R * slotd.d;
  const bool jfast = sub >= 16;
  const Dv<P2> first = jfast ? subd : slotd, second = jfast ? slotd : subd;
  for (int w = threadIdx.x; w < items; w += kFftThreads) {
    const int q = first.div(w), a = w - first.mul(q);
    const int g = second.div(q), b = q - second.mul(g);
    const int j = jfast ? a : b, s = jfast ? b : a;
    if (s >= nseq) continue;
    const int e0 = (P2 ? subd.mul(g * R) : g * L) + j;  // offsets t L/R (P2: shifts)
    float2 v[R];
#pragma unroll
    for (int t = 0; t < R; ++t) v[t] = src.load(s, e0 + subd.mul(t));
    if (Dit && sub > 1) {
#pragma unroll
      for (int t = 1; t < R; ++t) v[t] = cmul(v[t], tw[subd.mul(t) + j]);
    }
    Dft<R>::run(v);
    if (!Dit && sub > 1) {
#pragma unroll
      for (int t = 1; t < R; ++t) v[t] = cmul(v[t], tw[subd.mul(t) + j]);
    }
#pragma unroll
    for (int t = 0; t < R; ++t) dst.store(s, e0 + subd.mul(t), v[t]);
  }
}

template <bool P2, bool Dit = false, class Src, class Dst>
__device__ void fft_pass_r(int r, const Src& src, const Dst& dst, int nt, int L, Dv<P2> subd, Dv<P2> slotd,
                           int nseq, const float2* tw) {
  if constexpr (P2) {
    switch (r) {
      case 2: fft_pass<2, P2, Dit>(src, dst, nt, L, subd, slotd, nseq, tw); break;
      case 4: fft_pass<4, P2, Dit>(src, dst, nt, L, subd, slotd, nseq, tw); break;
      case 8: fft_pass<8, P2, Dit>(src, dst, nt, L, subd, slotd, nseq, tw); break;
      default: fft_pass<16, P2, Dit>(src, dst, nt, L, subd, slotd, nseq, tw); break;
    }
  } else {
    switch (r) {
      case 2: fft_pass<2, P2, Dit>(src, dst, nt, L, subd, slotd, nseq, tw); break;
      case 3: fft_pass<3, P2, Dit>(src, dst, nt, L, subd, slotd, nseq, tw); break;
      case 4: fft_pass<4, P2, Dit>(src, dst, nt, L, subd, slotd, nseq, tw); break;
      case 5: fft_pass<5, P2, Dit>(src, dst, nt, L, subd, slotd, nseq, tw); break;
      case 6: fft_pass<6, P2, Dit>(src, dst, nt, L, subd, slotd, nseq, tw); break;
      case 7: fft_pass<7, P2, Dit>(src, dst, nt, L, subd, slotd, nseq, tw); break;
      case 8: fft_pass<8, P2, Dit>(src, dst, nt, L, subd, slotd, nseq, tw); break;
      case 10: fft_pass<10, P2, Dit>(src, dst, nt, L, subd, slotd, nseq, tw); break;
      case 12: fft_pass<12, P2, Dit>(src, dst, nt, L, subd, slotd, nseq, tw); break;
      case 14: fft_pass<14, P2, Dit>(src, dst, nt, L, subd, slotd, nseq, tw); break;
      case 15: fft_pass<15, P2, Dit>(src, dst, nt, L, subd, slotd, nseq, tw); break;
      default: fft_pass<16, P2, Dit>(src, dst, nt, L, subd, slotd, nseq, tw); break;
    }
  }
}

// An nt-point transform of nseq sequences: the first pass reads src, the
// last writes dst, the others work in place in mid; a block barrier after
// each pass. Inlined: called, it takes its accessors through a stack frame
// (the mixed-radix kernel 1.46 -> 1.17 ms at 512 x 512 x 480 on an H100). tw holds the passes' tables one after another (L entries for
// a pass on sub-transforms of length L); subs the passes' sub-lengths
// (P2: unread, shifts). With no pass (nt = 1) it copies src to dst.
template <bool P2, class Src, class Dst>
__device__ __forceinline__ void fft_run(const Src& src, const SmemSeq& mid, const Dst& dst, int nt, const int* radices,
                        int nst, const Dv<false>* subs, Dv<P2> slotd, int nseq, const float2* tw) {
  if (nst == 0) {
    for (int s = threadIdx.x; s < nseq; s += kFftThreads) dst.store(s, 0, src.load(s, 0));
    __syncthreads();
    return;
  }
  int L = nt;
  for (int i = 0; i < nst; ++i) {
    const bool first = i == 0, last = i == nst - 1;
    Dv<P2> subd;
    if constexpr (P2)
      subd = Dv<true>(L >> log2_pow2(radices[i]));
    else
      subd = subs[i];
    if (first && last) {
      fft_pass_r<P2>(radices[i], src, dst, nt, L, subd, slotd, nseq, tw);
    } else if (first) {
      fft_pass_r<P2>(radices[i], src, mid, nt, L, subd, slotd, nseq, tw);
    } else if (last) {
      fft_pass_r<P2>(radices[i], mid, dst, nt, L, subd, slotd, nseq, tw);
    } else {
      fft_pass_r<P2>(radices[i], mid, mid, nt, L, subd, slotd, nseq, tw);
    }
    tw += L;
    L = subd.d;
    __syncthreads();
  }
}

// Bluestein's algorithm: an n-point DFT X[k] = conj(b[k]) sum_j (x[j]
// conj(b[j])) b[k - j], b[j] = exp(i pi j^2 / n), as an m-point circular
// convolution (m >= 2n - 1, 7-smooth, so m > 16 and nst >= 2). With the
// table chirp[j] = conj(b[j]): ChirpIn premultiplies the n values and pads
// them with zeros to m as the first of the m-point DIF passes reads them.
// The filter pass runs the last DIF pass, multiplies by the filter F =
// FFT_m(b over +-j) / m, stored in the passes' digit-reversed order, and
// conjugates, then runs the first pass of the inverse. The inverse passes
// undo the DIF passes in reverse order on the conjugated data (fft_pass with
// Dit: the same twiddle tables, then the DFT), from digit-reversed to
// natural order, so no permutation runs between the two transforms; they
// leave the conjugate of the convolution, which ChirpOut conjugates back,
// multiplies by chirp[k] and stores for k < n only. Each of these steps is
// a loop of its own around Dft<R>, in the chirp build only.
template <class Src>
struct ChirpIn {  // value e of sequence s times chirp[e]; 0 for e >= n
  Src src;
  const float2* chirp;
  int n;
  __device__ __forceinline__ float2 load(int s, int e) const {
    return e < n ? cmul(src.load(s, e), chirp[e]) : make_float2(0.0f, 0.0f);
  }
};

template <class Dst>
struct ChirpOut {  // output e = chirp[e] conj(v), for e < n only
  Dst dst;
  const float2* chirp;
  int n;
  __device__ __forceinline__ void store(int s, int e, float2 v) const {
    if (e < n) dst.store(s, e, cmul(chirp[e], make_float2(v.x, -v.y)));
  }
};

// The last DIF pass (sub-transforms of length R, no twiddles), the filter
// and the conjugate, and the first inverse pass, on the same R values.
template <int R>
__device__ void filter_pass(const SmemSeq& buf, int m, Dv<false> slotd, int nseq, const float2* filt) {
  const int items = m / R * slotd.d;
  for (int w = threadIdx.x; w < items; w += kFftThreads) {
    const int g = slotd.div(w), s = w - slotd.mul(g);
    if (s >= nseq) continue;
    const int e0 = g * R;
    float2 v[R];
#pragma unroll
    for (int t = 0; t < R; ++t) v[t] = buf.load(s, e0 + t);
    Dft<R>::run(v);
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const float2 f = filt[e0 + t];
      v[t] = make_float2(fmaf(v[t].x, f.x, -v[t].y * f.y), -fmaf(v[t].x, f.y, v[t].y * f.x));
    }
    Dft<R>::run(v);
#pragma unroll
    for (int t = 0; t < R; ++t) buf.store(s, e0 + t, v[t]);
  }
}

__device__ void filter_pass_r(int r, const SmemSeq& buf, int m, Dv<false> slotd, int nseq, const float2* filt) {
  switch (r) {
    case 2: filter_pass<2>(buf, m, slotd, nseq, filt); break;
    case 3: filter_pass<3>(buf, m, slotd, nseq, filt); break;
    case 4: filter_pass<4>(buf, m, slotd, nseq, filt); break;
    case 5: filter_pass<5>(buf, m, slotd, nseq, filt); break;
    case 6: filter_pass<6>(buf, m, slotd, nseq, filt); break;
    case 7: filter_pass<7>(buf, m, slotd, nseq, filt); break;
    case 8: filter_pass<8>(buf, m, slotd, nseq, filt); break;
    case 10: filter_pass<10>(buf, m, slotd, nseq, filt); break;
    case 12: filter_pass<12>(buf, m, slotd, nseq, filt); break;
    case 14: filter_pass<14>(buf, m, slotd, nseq, filt); break;
    case 15: filter_pass<15>(buf, m, slotd, nseq, filt); break;
    default: filter_pass<16>(buf, m, slotd, nseq, filt); break;
  }
}

// The chirp transform of nseq sequences through mid (see ChirpIn): src is
// a ChirpIn, dst a ChirpOut; a block barrier after each pass.
template <class Src, class Dst>
__device__ __forceinline__ void chirp_run(const Src& src, const SmemSeq& mid, const Dst& dst, int m,
                                          const int* radices, int nst, const Dv<false>* subs, Dv<false> slotd,
                                          int nseq, const float2* tw, const float2* filt) {
  int L = m;
  for (int i = 0; i < nst - 1; ++i) {
    if (i == 0)
      fft_pass_r<false>(radices[i], src, mid, m, L, subs[i], slotd, nseq, tw);
    else
      fft_pass_r<false>(radices[i], mid, mid, m, L, subs[i], slotd, nseq, tw);
    tw += L;
    L = subs[i].d;
    __syncthreads();
  }
  filter_pass_r(radices[nst - 1], mid, m, slotd, nseq, filt);
  __syncthreads();
  for (int i = nst - 2; i >= 0; --i) {  // back through the tables: pass i's starts L_i before pass i+1's
    L *= radices[i];
    tw -= L;
    if (i == 0)
      fft_pass_r<false, true>(radices[i], mid, dst, m, L, subs[i], slotd, nseq, tw);
    else
      fft_pass_r<false, true>(radices[i], mid, mid, m, L, subs[i], slotd, nseq, tw);
    __syncthreads();
  }
}

// Where the passes leave X[k]: k's digits in the passes' radices, reversed
// (digit i of k, k mod R_i after the lower digits, at span n / (R_0..R_i)).
template <bool P2>
__device__ __forceinline__ int fft_pos(int k, int n, const int* radices, int nst) {
  int p = 0;
  for (int i = 0; i < nst; ++i) {
    const int r = radices[i];
    if constexpr (P2) {
      const int l = log2_pow2(r);
      n >>= l;
      p += (k & (r - 1)) * n;
      k >>= l;
    } else {
      n /= r;
      p += k % r * n;
      k /= r;
    }
  }
  return p;
}

// exp(-2 pi i m / len), built in double and rounded once to float.
__device__ __forceinline__ float2 twiddle(int m, int len) {
  double sn, cs;
  sincospi(2.0 * m / len, &sn, &cs);
  return make_float2((float)cs, (float)-sn);
}

// exp(-i pi k^2 / n), the angle from k^2 mod 2n in integers.
__device__ __forceinline__ float2 chirp_entry(int k, int n) {
  double sn, cs;
  sincospi((double)((k * k) % (2 * n)) / n, &sn, &cs);
  return make_float2((float)cs, (float)-sn);
}

// Entries of an n-point transform's pass tables: L for each pass, L the
// sub-transform's length before the pass.
__host__ __device__ __forceinline__ int pass_tables(int n, const int* radices, int nst) {
  int total = 0;
  for (int i = 0; i < nst; ++i) {
    total += n;
    n /= radices[i];
  }
  return total;
}

// The passes' tables: W_L^(j t) at t L/R + j, t < R, j < L/R, per pass.
__device__ void build_pass_tables(float2* tw, int L, const int* radices, int nst, int first, int step) {
  for (int i = 0; i < nst; ++i) {
    const int sub = L / radices[i];
    for (int m = first; m < L; m += step) tw[m] = twiddle((m / sub) * (m % sub), L);
    tw += L;
    L = sub;
  }
}

// Bytes of a plan's tables, rounded up to 16: W_nz^k (k < nz/2, even nz
// only), the z and y passes' tables (float2), the divisors (8 bytes each,
// not for kPow2 plans), then the z positions and the y rows (16-bit: both
// are < 2048; none on a chirp axis).
template <int Mode>
__host__ __device__ __forceinline__ int table_bytes(const ZyFftPlan& p) {
  const int nt = zy_nt(p), nw = (p.nz & 1) ? 0 : nt, ndv = Mode == kPow2 ? 0 : kDivs;
  const int b = 8 * (nw + pass_tables(zy_mz<Mode>(p), p.rz, p.nrz) + pass_tables(zy_my<Mode>(p), p.ry, p.nry) +
                     ndv) +
                2 * ((chirp_z<Mode>(p) ? 0 : nt) + (chirp_y<Mode>(p) ? 0 : p.ny));
  return (b + 15) & ~15;
}

// Bytes of the chirp axes' tables, after the others, rounded up to 16: on a
// chirp z axis the chirp (nt) and the filter (mz), then on a chirp y axis
// the chirp (ny) and the filter (my).
__host__ __device__ __forceinline__ int chirp_bytes(const ZyFftPlan& p) {
  const int nt = zy_nt(p);
  const int b = 8 * ((p.mz != nt ? nt + p.mz : 0) + (p.my != p.ny ? p.ny + p.my : 0));
  return (b + 15) & ~15;
}

// Bytes of a plan's tables before the chirp axes' ones, for its build
// (table_bytes<kChirp> is table_bytes<kMixed> on a plan with no chirp axis).
__host__ __device__ __forceinline__ int head_bytes(const ZyFftPlan& p) {
  return zy_mode(p) == kPow2 ? table_bytes<kPow2>(p) : table_bytes<kChirp>(p);
}

// Bytes every block copies into its shared memory.
__host__ __device__ __forceinline__ int shared_table_bytes(const ZyFftPlan& p) {
  return head_bytes(p) + (p.gtab ? 0 : chirp_bytes(p));
}

// The n-point chirp (exp(-i pi k^2 / n), k < n) and the m-point filter
// F[pos(k)] = (1/m) sum_j b[j] W_m^(j k), b[j] = exp(i pi j^2 / n) at j
// and m - j (0 <= j < n): (1 + 2 sum_{0<j<n} b[j] cos(2 pi j k / m)) / m,
// summed in double and rounded once.
__device__ void build_chirp_tables(float2* chirp, float2* filt, int n, int m, const int* radices, int nst,
                                   int first, int step) {
  for (int k = first; k < n; k += step) chirp[k] = chirp_entry(k, n);
  for (int k = first; k < m; k += step) {
    double fr = 1.0, fi = 0.0;
    for (int j = 1; j < n; ++j) {
      double sn, cs;
      sincospi((double)((j * j) % (2 * n)) / n, &sn, &cs);
      const double c = 2.0 * cospi(2.0 * ((j * k) % m) / m);
      fr += c * cs;
      fi += c * sn;
    }
    filt[fft_pos<false>(k, m, radices, nst)] = make_float2((float)(fr / m), (float)(fi / m));
  }
}

// The tables of a plan, built once in device memory (double sincospi,
// rounded once to float); every block of the FFT kernel copies them into
// its shared memory, but for the chirp axes' tables of a gtab plan, which
// it reads from device memory.
__global__ void zy_fft_tables_kernel(float2* out, const ZyFftPlan p) {
  const int nt = zy_nt(p), odd = p.nz & 1, pad = zy_pad<kChirp>(p);
  const bool cz = chirp_z<kChirp>(p), cy = chirp_y<kChirp>(p);
  const int first = blockIdx.x * blockDim.x + threadIdx.x, step = gridDim.x * blockDim.x;
  float2* twpz = out + (odd ? 0 : nt);
  float2* twpy = twpz + pass_tables(p.mz, p.rz, p.nrz);
  Dv<false>* dvs = reinterpret_cast<Dv<false>*>(twpy + pass_tables(p.my, p.ry, p.nry));
  const int ndv = zy_mode(p) == kPow2 ? 0 : kDivs;
  uint16_t* posz = reinterpret_cast<uint16_t*>(dvs + ndv);
  uint16_t* iposy = posz + (cz ? 0 : nt);
  float2* chz = out + head_bytes(p) / 8;
  float2* chy = chz + (cz ? nt + p.mz : 0);
  if (ndv && first == 0) {  // the mixed-radix kernel's divisors (kDvZ ...)
    for (int i = 0; i < kDivs; ++i) dvs[i] = make_dv(1);
    for (int i = 0, L = p.mz; i < p.nrz; ++i) dvs[kDvZ + i] = make_dv(L /= p.rz[i]);
    for (int i = 0, L = p.my; i < p.nry; ++i) dvs[kDvY + i] = make_dv(L /= p.ry[i]);
    const int nslot = zy_nslot(p), wide = nslot / p.passes;
    dvs[kDvSeqs] = make_dv(odd ? p.batch / 2 : p.batch);
    dvs[kDvSlots] = make_dv(nslot);
    dvs[kDvPass] = make_dv(wide);
    dvs[kDvPassHi] = make_dv(wide + 1);
    dvs[kDvRank] = make_dv(p.tile > 1 ? p.tile - 1 : 1);
    dvs[kDvRankHi] = make_dv(p.tile);
  }
  // posz holds padded positions (zy_pad), which spread the post-process's
  // digit-reversed reads over the banks; a chirp axis leaves natural order
  // and has no positions.
  for (int k = first; k < nt; k += step) {
    if (!odd) out[k] = twiddle(k, p.nz);
    if (!cz) {
      const int q = fft_pos<false>(k, nt, p.rz, p.nrz);
      posz[k] = q + (q >> pad);
    }
  }
  if (!cy)
    for (int a = first; a < p.ny; a += step) iposy[fft_pos<false>(a, p.ny, p.ry, p.nry)] = a;
  build_pass_tables(twpz, p.mz, p.rz, p.nrz, first, step);
  build_pass_tables(twpy, p.my, p.ry, p.nry, first, step);
  if (cz) build_chirp_tables(chz, chz + nt, nt, p.mz, p.rz, p.nrz, first, step);
  if (cy) build_chirp_tables(chy, chy + p.ny, p.ny, p.my, p.ry, p.nry, first, step);
}

template <int Mode>
__global__ void __launch_bounds__(kFftThreads, 2)
zy_fft_kernel(const float* __restrict__ x, float* __restrict__ re, float* __restrict__ im,
              const float4* __restrict__ tables, const ZyFftPlan p, int vec) {
  namespace cg = cooperative_groups;
  constexpr bool P2 = Mode == kPow2, Chirp = Mode == kChirp;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int rz[kMaxStages], ry[kMaxStages];
  extern __shared__ float4 smem4[];
  const int ny = p.ny, nz = p.nz, nzr = nz / 2 + 1;
  const int odd = P2 ? 0 : nz & 1, nt = zy_nt(p), nslot = zy_nslot(p);
  const int mz = zy_mz<Mode>(p), my = zy_my<Mode>(p);
  const int tid = threadIdx.x;
  const int hb = table_bytes<Mode>(p), tb = hb + (Chirp && !p.gtab ? chirp_bytes(p) : 0);
  float2* twk = reinterpret_cast<float2*>(smem4);        // W_nz^k, k < nz/2 (even nz: the post-process)
  float2* twpz = twk + (odd ? 0 : nt);                   // the z passes' tables
  float2* twpy = twpz + pass_tables(mz, p.rz, p.nrz);  // the y passes' tables
  const Dv<false>* dvs = reinterpret_cast<const Dv<false>*>(twpy + pass_tables(my, p.ry, p.nry));
  const bool cz = chirp_z<Mode>(p), cy = chirp_y<Mode>(p);
  const uint16_t* posz = reinterpret_cast<const uint16_t*>(dvs + (P2 ? 0 : kDivs));
  const uint16_t* iposy = posz + (cz ? 0 : nt);  // the y row the y passes leave at position m
  float2* cols = reinterpret_cast<float2*>(smem4 + tb / 16);  // my x es: all rows of my slots
  float2* work = cols + my * p.es;                             // phase 1's row batch
  // A chirp axis's chirp and filter (chirp_bytes), in shared memory or (gtab) in device memory.
  const float2* chz = nullptr;
  if constexpr (Chirp)
    chz = reinterpret_cast<const float2*>(p.gtab ? tables + hb / 16 : smem4 + hb / 16);
  const float2* chy = chz + (cz ? nt + mz : 0);

  const int c = p.cluster, rank = (int)cluster.block_rank(), pass = blockIdx.x / c;
  const int lc = __ffs(c) - 1, lparts = __ffs(p.passes * c) - 1;
  const int64_t slab = blockIdx.y;
  // Every block of the cluster has started once this barrier's wait
  // returns: only then may the others store into its shared memory.
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  if (tid < kMaxStages) {
    rz[tid] = p.rz[tid];
    ry[tid] = p.ry[tid];
  }
  for (int i = tid; i < tb / 16; i += kFftThreads) smem4[i] = __ldg(tables + i);
  // First column slot of range u of the C P ranges (ZyFftPlan.bound).
  auto bound = [&](int u) { return (u * nslot) >> lparts; };
  const int cp0 = bound(pass * c), wp = bound(pass * c + c) - cp0;
  const int row0 = (rank * ny) >> lc, nrows = (((rank + 1) * ny) >> lc) - row0;
  __syncthreads();
  const Dv<P2> wpd = divisor<P2>(wp, dvs, kDvPass, kDvPassHi);
  const Dv<P2> nslotd = divisor<P2>(nslot, dvs, kDvSlots, kDvSlots);

  // Phase 1: this rank's rows, a batch at a time; each X[k] goes straight
  // into the shared memory of the rank that owns slot k.
  const SmemSeq rows_mid{work, p.ws, 1, zy_pad<Mode>(p)};
  const Dv<P2> slotd = divisor<P2>(odd ? p.batch >> 1 : p.batch, dvs, kDvSeqs, kDvSeqs);  // a full batch
  for (int b0 = 0; b0 < nrows; b0 += p.batch) {
    const int nb = min(p.batch, nrows - b0);
    const SlabRows<P2> rows_in{x + (slab * ny + row0 + b0) * nz, nz, vec, odd, nb};
    if constexpr (Chirp) {
      const int nseq = odd ? (nb + 1) >> 1 : nb;
      if (cz)
        chirp_run(ChirpIn<SlabRows<P2>>{rows_in, chz, nt}, rows_mid, ChirpOut<SmemSeq>{rows_mid, chz, nt}, mz, rz,
                  p.nrz, dvs + kDvZ, slotd, nseq, twpz, chz + nt);
      else
        fft_run<P2>(rows_in, rows_mid, rows_mid, mz, rz, p.nrz, dvs + kDvZ, slotd, nseq, twpz);
    } else {
      fft_run<P2>(rows_in, rows_mid, rows_mid, nt, rz, p.nrz, dvs + kDvZ, slotd, odd ? (nb + 1) >> 1 : nb, twpz);
    }
    if (b0 == 0) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    // Even nz: X[k] = E + W_nz^k O, E = (A + conj B) / 2, O = (A - conj B)
    // / 2i, A = Zc[k], B = Zc[nt - k]; X[0] = Re A + Im A and X[nt] = Re A
    // - Im A are real and share slot 0 as X[0] + i X[nt]. Odd nz: rows 2s
    // and 2s+1 are E and O of pair s's C (A = C[k], B = C[nz - k]). Slot k
    // belongs to range u = ceil((k + 1) C P / nslot) - 1, rank u - p C,
    // column k - bound(u).
    for (int e = tid; e < nb * wp; e += kFftThreads) {
      const int row = wpd.div(e), k = cp0 + e - wpd.mul(row);
      const float2* w = work + (odd ? row >> 1 : row) * p.ws;
      const float2 a = w[cz ? k : posz[k]];
      float2 z;
      if (!odd && k == 0) {
        z = make_float2(a.x + a.y, a.x - a.y);
      } else {
        const float2 b = w[cz ? (k == 0 ? 0 : nt - k) : posz[k == 0 ? 0 : nt - k]];
        const float2 ev = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
        const float2 od = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
        z = odd ? (row & 1 ? od : ev) : cadd(ev, cmul(twk[k], od));
      }
      const int u = nslotd.div(((k + 1) << lparts) + nslot - 1) - 1;
      float2* dst = cluster.map_shared_rank(cols, u - pass * c);
      dst[(row0 + b0 + row) * p.es + k - bound(u)] = z;
    }
    __syncthreads();
  }
  // Every rank's stores into this block's slots are done and visible; no
  // block touches another's shared memory after this barrier, so a block
  // may leave as soon as its phase 2 is done.
  cluster.sync();

  // Phase 2: this rank's column slots, down the y axis in place; the last
  // pass writes re and im. Even nz: slot 0's transform C = Y0 + i Yn is
  // split after it: Y0[a] = (C[a] + conj C[-a]) / 2, Yn[a] = (C[a] - conj
  // C[-a]) / 2i.
  const int cr0 = bound(pass * c + rank), cr1 = bound(pass * c + rank + 1);
  if (cr1 > cr0) {
    const int tw = cr1 - cr0;  // p.tile or one less
    const SmemSeq cols_mid{cols, 1, p.es, 31};
    float* const re_slab = re + slab * ny * nzr;
    float* const im_slab = im + slab * ny * nzr;
    const OutColumns<false> cols_out{re_slab, im_slab, iposy, cols_mid, nzr, cr0, !odd};
    if constexpr (Chirp) {
      const Dv<false> rankd = divisor<false>(tw, dvs, kDvRank, kDvRankHi);
      if (cy)
        chirp_run(ChirpIn<SmemSeq>{cols_mid, chy, ny}, cols_mid,
                  ChirpOut<OutColumns<true>>{{re_slab, im_slab, nullptr, cols_mid, nzr, cr0, !odd}, chy, ny}, my,
                  ry, p.nry, dvs + kDvY, rankd, tw, twpy, chy + ny);
      else
        fft_run<false>(cols_mid, cols_mid, cols_out, ny, ry, p.nry, dvs + kDvY, rankd, tw, twpy);
    } else {
      fft_run<P2>(cols_mid, cols_mid, cols_out, ny, ry, p.nry, dvs + kDvY, divisor<P2>(tw, dvs, kDvRank, kDvRankHi),
                  tw, twpy);
    }
    if (cr0 == 0 && !odd) {
      const int n = nz >> 1;
      for (int a = tid; a < ny; a += kFftThreads) {  // a chirp y axis leaves natural order
        const float2 ca = cols[(cy ? a : fft_pos<P2>(a, ny, ry, p.nry)) * p.es];
        const float2 cb = cols[(cy ? (a == 0 ? 0 : ny - a) : fft_pos<P2>(a == 0 ? 0 : ny - a, ny, ry, p.nry)) * p.es];
        const int64_t o = (slab * ny + a) * nzr;
        re[o] = 0.5f * (ca.x + cb.x);
        im[o] = 0.5f * (ca.y - cb.y);
        re[o + n] = 0.5f * (ca.y + cb.y);
        im[o + n] = -0.5f * (ca.x - cb.x);
      }
    }
  }
}

bool smooth7(int n) {
  if (n < 1) return false;
  const int primes[4] = {2, 3, 5, 7};
  for (int f : primes)
    while (n % f == 0) n /= f;
  return n == 1;
}

bool radix_ok(int r) {  // a Dft<r> of fft_pass_r
  switch (r) {
    case 2: case 3: case 4: case 5: case 6: case 7: case 8: case 10: case 12: case 14: case 15: case 16:
      return true;
    default:
      return false;
  }
}

bool radices_ok(int n, const int* radices, int nst) {
  if (nst < 0 || nst > kMaxStages) return false;
  for (int i = 0; i < nst; ++i) {
    if (!radix_ok(radices[i]) || n % radices[i]) return false;
    n /= radices[i];
  }
  return n == 1;
}

// An n-point axis transformed at length m by the given passes: m = n for
// 7-smooth n, else a chirp axis's convolution (7-smooth m >= 2n - 1, at
// least two passes for chirp_run).
bool axis_ok(int n, int m, const int* radices, int nst) {
  if (m == n) return smooth7(n) && radices_ok(n, radices, nst);
  return !smooth7(n) && smooth7(m) && m >= 2 * n - 1 && m <= kMaxLength && nst >= 2 && radices_ok(m, radices, nst);
}

// Whether the plan is one _zy_fft_plan could make: every shared-memory
// index the kernel forms stays inside what the launch gives it.
bool plan_ok(const ZyFftPlan& p) {
  if (p.ny < 1 || p.ny > kMaxExtent || p.nz < 1 || p.nz > kMaxExtent) return false;
  if (!pow2(p.cluster) || p.cluster > 16 || p.cluster > p.ny || p.rows != (p.ny + p.cluster - 1) / p.cluster)
    return false;
  const int nt = zy_nt(p), nslot = zy_nslot(p), odd = p.nz & 1, parts = p.cluster * p.passes;
  if (!pow2(p.passes) || p.passes > nslot || p.batch < 1 || p.batch > p.rows + odd || (odd && p.batch % 2))
    return false;
  if (pow2(p.ny) && pow2(p.nz) && p.nz > 1 && !pow2(p.batch)) return false;  // shifts need a power-of-two batch
  if (p.tile != (nslot + parts - 1) / parts || p.es < p.tile || p.work < (odd ? p.batch / 2 : p.batch) * p.ws)
    return false;
  if (!axis_ok(nt, p.mz, p.rz, p.nrz) || !axis_ok(p.ny, p.my, p.ry, p.nry)) return false;
  if (p.gtab != 0 && (p.gtab != 1 || zy_mode(p) != kChirp)) return false;
  const int pad = zy_pad<kChirp>(p);
  if (p.ws < p.mz + ((p.mz - 1) >> pad)) return false;
  if ((long long)nslot * (parts + 1) > 65536) return false;  // the slot owners' dividend (Dv<false>)
  const long long smem = shared_table_bytes(p) + 8LL * ((long long)p.my * p.es + p.work);
  return smem == p.smem && smem <= kFftSmemMax;
}

using FftKernel = void (*)(const float*, float*, float*, const float4*, const ZyFftPlan, int);

FftKernel fft_kernel(const ZyFftPlan& p) {
  switch (zy_mode(p)) {
    case kPow2: return zy_fft_kernel<kPow2>;
    case kMixed: return zy_fft_kernel<kMixed>;
    default: return zy_fft_kernel<kChirp>;
  }
}

// The launch configuration of a plan over nx slabs: one cluster of C
// blocks for each (pass, slab); the attributes set on the kernel.
cudaError_t fft_config(const ZyFftPlan& p, int nx, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                       cudaLaunchAttribute* attr) {
  const FftKernel kernel = fft_kernel(p);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err == cudaSuccess && p.cluster > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(p.cluster * p.passes, nx, 1);
  cfg->blockDim = dim3(kFftThreads, 1, 1);
  cfg->dynamicSmemBytes = p.smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

ZyFftPlan read_plan(const int* v) {
  ZyFftPlan p;
  int* dst = &p.ny;
  for (int i = 0; i < kPlanHead; ++i) dst[i] = v[i];
  for (int i = 0; i < kMaxStages; ++i) {
    p.rz[i] = v[kPlanHead + i];
    p.ry[i] = v[kPlanHead + kMaxStages + i];
  }
  p.mz = v[kPlanHead + 2 * kMaxStages];
  p.my = v[kPlanHead + 2 * kMaxStages + 1];
  p.gtab = v[kPlanHead + 2 * kMaxStages + 2];
  return p;
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

// x: (nx, ny, nz) f32; re, im: (nx, ny, nz/2+1) f32; tables: the plan's
// tables from fava_zy_fft_tables (16-byte aligned); plan: ZyFftPlan.as_ints();
// vec: 1 when x is 8-byte aligned (float2 row loads).
// cudaErrorInvalidValue for a plan that does not hold, and
// cudaErrorLaunchOutOfResources when no cluster of it fits the card.
int fava_zy_fft(const void* x, void* re, void* im, const void* tables, int nx, const int* plan, int vec,
                void* stream) {
  (void)cudaGetLastError();
  const ZyFftPlan p = read_plan(plan);
  if (nx < 1 || nx > 65535 || !plan_ok(p)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = fft_config(p, nx, (cudaStream_t)stream, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  const FftKernel kernel = fft_kernel(p);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, (const float*)x, (float*)re, (float*)im, (const float4*)tables, p,
                           vec);
  if (err != cudaSuccess) return (int)err;
  return launch_status();
}

// Builds the plan's tables (fava_zy_fft_table_bytes of them) into out.
int fava_zy_fft_tables(const int* plan, void* out, void* stream) {
  (void)cudaGetLastError();
  const ZyFftPlan p = read_plan(plan);
  if (!plan_ok(p)) return (int)cudaErrorInvalidValue;
  zy_fft_tables_kernel<<<8, 256, 0, (cudaStream_t)stream>>>((float2*)out, p);
  return launch_status();
}

// Bytes of the plan's tables (the chirp axes' ones included), or -1 for a
// plan that does not hold.
int fava_zy_fft_table_bytes(const int* plan) {
  const ZyFftPlan p = read_plan(plan);
  return plan_ok(p) ? head_bytes(p) + chirp_bytes(p) : -1;
}

// Clusters of the plan that fit the card at once, or -(error code).
int fava_zy_fft_clusters(const int* plan) {
  (void)cudaGetLastError();
  const ZyFftPlan p = read_plan(plan);
  if (!plan_ok(p)) return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = fft_config(p, 1, nullptr, &cfg, &attr);
  int clusters = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, fft_kernel(p), &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

}  // extern "C"
