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
// zy_fft_kernel, the route for power-of-two ny (1..1024) and nz (2..1024).
// The TPU kept a slab's intermediate Z (1 MB at 512^2) in VMEM; here a
// thread-block cluster keeps it in its blocks' shared memory, so Z never
// goes to device memory and the kernel moves only the bound's bytes. The
// plan (cluster size C, passes P, row batch, slots a rank owns, strides,
// shared bytes, radices) comes from _zy_fft_plan in ops/cuda_kernels.py.
// The nz/2 + 1 kz columns are nz/2 slots: slot 0 holds the real columns
// kz = 0 and nz/2 packed as one complex column, slot u > 0 holds kz = u, so
// every rank owns a power-of-two range of slots. A cluster of C blocks does
// pass p of slab i (grid (C P, nx)):
//   phase 1: rank r transforms its ny/C rows along z, a batch of rows at a
//     time in a work buffer: each row's nz reals as nz/2 complex values, read
//     from device memory by the first of the in-place radix-16/8/4/2
//     decimation-in-frequency passes; then X[k] = E[k] + W_nz^k O[k] from the
//     digit-reversed result, stored through distributed shared memory
//     (cluster.map_shared_rank) straight into the rank that owns slot k,
//     which holds all ny rows of its slots;
//   cluster.sync(): every rank's slots are written and visible;
//   phase 2: rank r runs the y passes down its slots in place, the last pass
//     writing re and im, and splits slot 0 by Hermitian symmetry.
// Nothing reads another block's shared memory after the barrier, so a block
// leaves when its phase 2 is done; a split barrier at the start
// (barrier.cluster.arrive, then wait before the first store into another
// rank) makes sure every rank has started. A slab whose Z does not fit the
// cluster is done in P passes over slot ranges (1024^2: P = 2), each
// re-running phase 1 for its slots. Two blocks of 256 threads share an SM
// (~113 KB of shared memory each at 512^2), the one block shape that fits:
// their phases overlap. Twiddles: for the post-process and for each pass
// (W_L^(j t) at t L/R + j, so lanes on consecutive j read consecutive
// entries), built once in device memory in double (sincospi), rounded once
// to float, and copied into shared memory by every block with the digit
// positions (zy_fft_tables_kernel). f32 arithmetic, no TF32: log2 n
// rounding stages, ~1e-7 of the largest coefficient. Strides are odd and
// phase 1's rows carry one padding slot per span of the first pass's digit,
// so lanes hit distinct banks. The C entry checks the plan and that the
// cluster can be scheduled (cudaOccupancyMaxActiveClusters); it returns an
// error otherwise.
//
// zy_rfft_kernel, the dense route for every other shape up to 1024: Z = A .
// [Cr | Ci] with Cr[z, k] = cos(2 pi z k / nz), Ci[z, k] = -sin(2 pi z k /
// nz), then Y = W . Z with W[a, b] = exp(-2 pi i a b / ny). It does O(n)
// work per output where an FFT does O(log n): 414 GFLOP per 512^3 volume,
// 6.2 ms at the f32 peak, far over the bytes bound, so it serves only the
// shapes the FFT kernel does not take.
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

// The plan, as ZyFftPlan.as_ints() lays it out.
struct ZyFftPlan {
  int ny, nz, cluster, passes, rows, batch, tile, ws, es, work, smem, nlz, nly;
  int lz[kMaxStages], ly[kMaxStages];
};
constexpr int kPlanHead = 13;  // ints before the radix logs

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

struct SlabRows {  // complex value e of row s: the reals 2e, 2e+1 of the row
  const float* src;
  int nz, vec;  // vec: the slab is 8-byte aligned (float2 loads)
  __device__ __forceinline__ float2 load(int s, int e) const {
    const float* q = src + s * nz + 2 * e;
    return vec ? __ldg(reinterpret_cast<const float2*>(q)) : make_float2(__ldg(q), __ldg(q + 1));
  }
};

struct OutColumns {  // position e of column s holds output row ipos[e] of slot col0 + s
  float* re;  // the slab's planes
  float* im;
  const uint16_t* ipos;
  SmemSeq stash;  // slot 0 (kz 0 and nz/2 packed) stays in shared memory for the split
  int nzr, col0;
  __device__ __forceinline__ void store(int s, int e, float2 v) const {
    if (col0 + s == 0) {
      stash.store(s, e, v);
      return;
    }
    const int o = ipos[e] * nzr + col0 + s;
    re[o] = v.x;
    im[o] = v.y;
  }
};

// One in-place decimation-in-frequency pass of radix R = 2^LR over nseq
// (<= 2^lseq) sequences of length 2^ln, on sub-transforms of length
// L = 2^lL: x[g L + j + t L/R], t < R, goes through an R-point DFT and
// output t, times W_L^(j t) = tw[t L/R + j] (the pass's own table, so
// lanes on consecutive j read consecutive twiddles), goes back to
// g L + t L/R + j. Work items run j fastest while L/R >= 16 (lanes on
// consecutive elements), s fastest below (lanes on sequences, whose
// strides are odd).
template <int R, int LR, class Src, class Dst>
__device__ void fft_pass(const Src& src, const Dst& dst, int ln, int lL, int lseq, int nseq,
                         const float2* tw) {
  const int lsub = lL - LR;
  const int items = 1 << (lseq + ln - LR);
  const bool jfast = lsub >= 4;
  const int lfirst = jfast ? lsub : lseq, lsecond = jfast ? lseq : lsub;
  for (int w = threadIdx.x; w < items; w += kFftThreads) {
    const int a = w & ((1 << lfirst) - 1), b = (w >> lfirst) & ((1 << lsecond) - 1);
    const int g = w >> (lfirst + lsecond);
    const int j = jfast ? a : b, s = jfast ? b : a;
    if (s >= nseq) continue;
    const int e0 = (g << lL) + j;
    float2 v[R];
#pragma unroll
    for (int t = 0; t < R; ++t) v[t] = src.load(s, e0 + (t << lsub));
    Dft<R>::run(v);
    if (lsub > 0) {
#pragma unroll
      for (int t = 1; t < R; ++t) v[t] = cmul(v[t], tw[(t << lsub) + j]);
    }
#pragma unroll
    for (int t = 0; t < R; ++t) dst.store(s, e0 + (t << lsub), v[t]);
  }
}

template <class Src, class Dst>
__device__ void fft_pass_r(int lr, const Src& src, const Dst& dst, int ln, int lL, int lseq,
                           int nseq, const float2* tw) {
  switch (lr) {
    case 1: fft_pass<2, 1>(src, dst, ln, lL, lseq, nseq, tw); break;
    case 2: fft_pass<4, 2>(src, dst, ln, lL, lseq, nseq, tw); break;
    case 3: fft_pass<8, 3>(src, dst, ln, lL, lseq, nseq, tw); break;
    default: fft_pass<16, 4>(src, dst, ln, lL, lseq, nseq, tw); break;
  }
}

// A 2^ln-point transform of nseq sequences: the first pass reads src, the
// last writes dst, the others work in place in mid; a block barrier after
// each pass. tw holds the passes' tables one after another (2^lL entries
// for a pass on sub-transforms of length 2^lL). With no pass (ln = 0) it
// copies src to dst.
template <class Src, class Dst>
__device__ void fft_run(const Src& src, const SmemSeq& mid, const Dst& dst, int ln,
                        const int* logs, int nst, int lseq, int nseq, const float2* tw) {
  if (nst == 0) {
    for (int s = threadIdx.x; s < nseq; s += kFftThreads) dst.store(s, 0, src.load(s, 0));
    __syncthreads();
    return;
  }
  int lL = ln;
  for (int i = 0; i < nst; ++i) {
    const bool first = i == 0, last = i == nst - 1;
    if (first && last) {
      fft_pass_r(logs[i], src, dst, ln, lL, lseq, nseq, tw);
    } else if (first) {
      fft_pass_r(logs[i], src, mid, ln, lL, lseq, nseq, tw);
    } else if (last) {
      fft_pass_r(logs[i], mid, dst, ln, lL, lseq, nseq, tw);
    } else {
      fft_pass_r(logs[i], mid, mid, ln, lL, lseq, nseq, tw);
    }
    tw += 1 << lL;
    lL -= logs[i];
    __syncthreads();
  }
}

// Where the passes leave X[k]: k's digits in the passes' radices, reversed.
__device__ __forceinline__ int fft_pos(int k, int ln, const int* logs, int nst) {
  int p = 0;
  for (int i = 0; i < nst; ++i) {
    ln -= logs[i];
    p += (k & ((1 << logs[i]) - 1)) << ln;
    k >>= logs[i];
  }
  return p;
}

__host__ __device__ __forceinline__ int log2i(int n) {  // n a power of two
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// exp(-2 pi i m / len), built in double and rounded once to float.
__device__ __forceinline__ float2 twiddle(int m, int len) {
  double sn, cs;
  sincospi(2.0 * m / len, &sn, &cs);
  return make_float2((float)cs, (float)-sn);
}

// Entries of a transform's pass tables: 2^lL for each pass, lL the
// sub-transform's log length before the pass.
__host__ __device__ __forceinline__ int pass_tables(int ln, const int* logs, int nst) {
  int total = 0;
  for (int i = 0; i < nst; ++i) {
    total += 1 << ln;
    ln -= logs[i];
  }
  return total;
}

// The passes' tables: W_L^(j t) at t L/R + j, t < R, j < L/R, per pass.
__device__ void build_pass_tables(float2* tw, int ln, const int* logs, int nst, int first, int step) {
  for (int i = 0; i < nst; ++i) {
    const int lsub = ln - logs[i];
    for (int m = first; m < (1 << ln); m += step)
      tw[m] = twiddle((m >> lsub) * (m & ((1 << lsub) - 1)), 1 << ln);
    tw += 1 << ln;
    ln = lsub;
  }
}

// Bytes of a plan's tables, rounded up to 16: W_nz^k (k < n), the z and y
// passes' tables (float2), then the z positions and the y rows (16-bit:
// both are < 2048).
__host__ __device__ __forceinline__ int table_bytes(const ZyFftPlan& p) {
  const int n = p.nz / 2;
  const int b = 8 * (n + pass_tables(log2i(n), p.lz, p.nlz) + pass_tables(log2i(p.ny), p.ly, p.nly)) +
                2 * (n + p.ny);
  return (b + 15) & ~15;
}

// The tables of a plan, built once in device memory (double sincospi,
// rounded once to float); every block of the FFT kernel copies them into
// its shared memory.
__global__ void zy_fft_tables_kernel(float2* out, const ZyFftPlan p) {
  const int n = p.nz / 2, ln = log2i(n), lny = log2i(p.ny);
  const int first = blockIdx.x * blockDim.x + threadIdx.x, step = gridDim.x * blockDim.x;
  float2* twpz = out + n;
  float2* twpy = twpz + pass_tables(ln, p.lz, p.nlz);
  uint16_t* posz = reinterpret_cast<uint16_t*>(twpy + pass_tables(lny, p.ly, p.nly));
  uint16_t* iposy = posz + n;
  // Phase 1's rows carry one padding slot per 2^zpad values (the span of
  // the first pass's digit), which spreads the post-process's
  // digit-reversed reads over the banks; posz holds padded positions.
  const int zpad = ln - (p.nlz ? p.lz[0] : 0);
  for (int k = first; k < n; k += step) {
    out[k] = twiddle(k, p.nz);
    const int q = fft_pos(k, ln, p.lz, p.nlz);
    posz[k] = q + (q >> zpad);
  }
  for (int a = first; a < p.ny; a += step) iposy[fft_pos(a, lny, p.ly, p.nly)] = a;
  build_pass_tables(twpz, ln, p.lz, p.nlz, first, step);
  build_pass_tables(twpy, lny, p.ly, p.nly, first, step);
}

__global__ void __launch_bounds__(kFftThreads, 2)
zy_fft_kernel(const float* __restrict__ x, float* __restrict__ re, float* __restrict__ im,
              const float4* __restrict__ tables, const ZyFftPlan p, int vec) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int lz[kMaxStages], ly[kMaxStages];
  extern __shared__ float4 smem4[];
  const int ny = p.ny, nz = p.nz, n = nz >> 1, nzr = n + 1;
  const int tid = threadIdx.x;
  const int ln = log2i(n), lny = log2i(ny);
  const int tb = table_bytes(p);
  float2* twk = reinterpret_cast<float2*>(smem4);     // W_nz^k, k < n (the post-process)
  float2* twpz = twk + n;                             // the z passes' tables
  float2* twpy = twpz + pass_tables(ln, p.lz, p.nlz);  // the y passes' tables
  const uint16_t* posz = reinterpret_cast<const uint16_t*>(twpy + pass_tables(lny, p.ly, p.nly));
  const uint16_t* iposy = posz + n;  // the y row the y passes leave at position m; posz padded
  float2* cols = reinterpret_cast<float2*>(smem4 + tb / 16);  // ny x es: all rows of my slots
  float2* work = cols + ny * p.es;                             // phase 1's row batch

  const int c = p.cluster, rank = (int)cluster.block_rank(), pass = blockIdx.x / c;
  const int parts = p.passes * c;
  const int64_t slab = blockIdx.y;
  const int zpad = ln - (p.nlz ? p.lz[0] : 0);  // see zy_fft_tables_kernel
  // Every block of the cluster has started once this barrier's wait
  // returns: only then may the others store into its shared memory.
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  if (tid < kMaxStages) {
    lz[tid] = p.lz[tid];
    ly[tid] = p.ly[tid];
  }
  for (int i = tid; i < tb / 16; i += kFftThreads) smem4[i] = __ldg(tables + i);
  // First column slot of range u of the parts ranges (ZyFftPlan.bound):
  // slot 0 holds kz = 0 and kz = n packed, slot u > 0 holds kz = u.
  const int lparts = log2i(parts);
  auto bound = [&](int u) { return (u * n) >> lparts; };
  const int cp0 = bound(pass * c), wp = bound(pass * c + c) - cp0, lwp = log2i(wp);
  __syncthreads();

  // Phase 1: this rank's rows, a batch at a time; each X[k] goes straight
  // into the shared memory of the rank that owns slot k.
  const SmemSeq rows_mid{work, p.ws, 1, zpad};
  const int lbatch = log2i(p.batch);
  for (int b0 = 0; b0 < p.rows; b0 += p.batch) {
    const SlabRows rows_in{x + (slab * ny + rank * p.rows + b0) * nz, nz, vec};
    fft_run(rows_in, rows_mid, rows_mid, ln, lz, p.nlz, lbatch, p.batch, twpz);
    if (b0 == 0) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    // X[k] = E + W_nz^k O, E = (A + conj B) / 2, O = (A - conj B) / 2i,
    // A = Zc[k], B = Zc[n - k]; X[0] = Re A + Im A and X[n] = Re A - Im A
    // are real and share slot 0 as X[0] + i X[n]. Slot k belongs to range
    // u = ceil((k + 1) parts / n) - 1, rank u - p C, column k - bound(u).
    for (int e = tid; e < p.batch * wp; e += kFftThreads) {
      const int row = e >> lwp, k = cp0 + (e & (wp - 1));
      const float2* w = work + row * p.ws;
      const float2 a = w[posz[k]];
      float2 z;
      if (k == 0) {
        z = make_float2(a.x + a.y, a.x - a.y);
      } else {
        const float2 b = w[posz[n - k]];
        const float2 ev = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
        const float2 od = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
        z = cadd(ev, cmul(twk[k], od));
      }
      const int u = (((k + 1) * parts + n - 1) >> ln) - 1;
      float2* dst = cluster.map_shared_rank(cols, u - pass * c);
      dst[(rank * p.rows + b0 + row) * p.es + k - bound(u)] = z;
    }
    __syncthreads();
  }
  // Every rank's stores into this block's slots are done and visible; no
  // block touches another's shared memory after this barrier, so a block
  // may leave as soon as its phase 2 is done.
  cluster.sync();

  // Phase 2: this rank's column slots, down the y axis in place; the last
  // pass writes re and im. Slot 0's transform C = Y0 + i Yn is split after
  // it: Y0[a] = (C[a] + conj C[-a]) / 2, Yn[a] = (C[a] - conj C[-a]) / 2i.
  const int cr0 = bound(pass * c + rank), cr1 = bound(pass * c + rank + 1);
  if (cr1 > cr0) {
    const int tw = cr1 - cr0;  // p.tile, or 1 when n < parts
    const SmemSeq cols_mid{cols, 1, p.es, 31};
    const OutColumns cols_out{re + slab * ny * nzr, im + slab * ny * nzr, iposy, cols_mid, nzr, cr0};
    fft_run(cols_mid, cols_mid, cols_out, lny, ly, p.nly, log2i(tw), tw, twpy);
    if (cr0 == 0) {
      for (int a = tid; a < ny; a += kFftThreads) {
        const float2 ca = cols[fft_pos(a, lny, ly, p.nly) * p.es];
        const float2 cb = cols[fft_pos((ny - a) & (ny - 1), lny, ly, p.nly) * p.es];
        const int64_t o = (slab * ny + a) * nzr;
        re[o] = 0.5f * (ca.x + cb.x);
        im[o] = 0.5f * (ca.y - cb.y);
        re[o + n] = 0.5f * (ca.y + cb.y);
        im[o + n] = -0.5f * (ca.x - cb.x);
      }
    }
  }
}

bool pow2(int n) { return n >= 1 && (n & (n - 1)) == 0; }

// Whether the plan is one _zy_fft_plan could make: every shared-memory
// index the kernel forms stays inside what the launch gives it.
bool plan_ok(const ZyFftPlan& p) {
  if (!pow2(p.ny) || p.ny > kMaxExtent || !pow2(p.nz) || p.nz < 2 || p.nz > kMaxExtent) return false;
  if (!pow2(p.cluster) || p.cluster > 16 || p.cluster > p.ny || p.rows * p.cluster != p.ny) return false;
  const int n = p.nz / 2, parts = p.cluster * p.passes;
  if (!pow2(p.passes) || p.passes > n || !pow2(p.batch) || p.batch > p.rows) return false;
  if (!pow2(p.tile) || p.tile != (n >= parts ? n / parts : 1) || p.es < p.tile || p.ws < n ||
      p.work < p.batch * p.ws)
    return false;
  if (p.nlz < 0 || p.nlz > kMaxStages || p.nly < 0 || p.nly > kMaxStages) return false;
  int sz = 0, sy = 0;
  for (int i = 0; i < p.nlz; ++i) {
    if (p.lz[i] < 1 || p.lz[i] > 4) return false;
    sz += p.lz[i];
  }
  for (int i = 0; i < p.nly; ++i) {
    if (p.ly[i] < 1 || p.ly[i] > 4) return false;
    sy += p.ly[i];
  }
  if ((1 << sz) != n || (1 << sy) != p.ny) return false;
  if (p.ws < n + ((n - 1) >> (log2i(n) - (p.nlz ? p.lz[0] : 0)))) return false;
  const long long smem = table_bytes(p) + 8LL * ((long long)p.ny * p.es + p.work);
  return smem == p.smem && smem <= kFftSmemMax;
}

// The launch configuration of a plan over nx slabs: one cluster of C
// blocks for each (pass, slab); the attributes set on the kernel.
cudaError_t fft_config(const ZyFftPlan& p, int nx, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                       cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(zy_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.smem);
  if (err == cudaSuccess && p.cluster > 8)
    err = cudaFuncSetAttribute(zy_fft_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
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
    p.lz[i] = v[kPlanHead + i];
    p.ly[i] = v[kPlanHead + kMaxStages + i];
  }
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
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, zy_fft_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, zy_fft_kernel, (const float*)x, (float*)re, (float*)im,
                           (const float4*)tables, p, vec);
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

// Bytes of the plan's tables, or -1 for a plan that does not hold.
int fava_zy_fft_table_bytes(const int* plan) {
  const ZyFftPlan p = read_plan(plan);
  return plan_ok(p) ? table_bytes(p) : -1;
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
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, zy_fft_kernel, &cfg);
  return err == cudaSuccess ? clusters : -(int)err;
}

}  // extern "C"
