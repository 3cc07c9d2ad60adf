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
// (zy_rfft_fits in ops/cuda_kernels.py). Its body and plan are in
// zy_fft.cuh; its three builds (below) are instantiated one a translation
// unit (zy_fft_pow2.cu, zy_fft_mixed.cu, zy_fft_chirp.cu), so that they
// compile at once; this file holds its tables' kernel and its C entries. Extents whose prime factors are
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
#include "zy_fft.cuh"

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
// The cluster FFT kernel's tables (the kernel and its plan: zy_fft.cuh)

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

// The passes' tables: W_L^(j t) at t L/R + j, t < R, j < L/R, per pass.
__device__ void build_pass_tables(float2* tw, int L, const int* radices, int nst, int first, int step) {
  for (int i = 0; i < nst; ++i) {
    const int sub = L / radices[i];
    for (int m = first; m < L; m += step) tw[m] = twiddle((m / sub) * (m % sub), L);
    tw += L;
    L = sub;
  }
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
    case kPow2: return reinterpret_cast<FftKernel>(fava_zy::pow2_kernel());
    case kMixed: return reinterpret_cast<FftKernel>(fava_zy::mixed_kernel());
    default: return reinterpret_cast<FftKernel>(fava_zy::chirp_kernel());
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
