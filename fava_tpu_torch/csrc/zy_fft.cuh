// B12's cluster FFT kernel, zy_fft_kernel<Mode>, and what it shares with
// its host side in dft_kernels.cu (the plan, its builds, the layout of its
// tables); the design notes are dft_kernels.cu's. Each build is
// instantiated in a translation unit of its own (zy_fft_pow2.cu,
// zy_fft_mixed.cu, zy_fft_chirp.cu), so that ops/_build.py's one nvcc per
// source compiles the three at once; dft_kernels.cu launches them through
// the fava_zy accessors below.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

namespace fava_zy {
// The host stubs of zy_fft_kernel<kPow2>, <kMixed> and <kChirp>, each
// defined in its build's translation unit.
void* pow2_kernel();
void* mixed_kernel();
void* chirp_kernel();
}  // namespace fava_zy
