// The per-tile compute of K1 (edge.cu) and K3 (edge_stream.cu), whose walk
// and outputs K2 (edge_pipelined.cu) runs too.
//
// One CTA owns one bh x bw output tile. edge_tile() stages the tile's halo
// window in shared memory (the luma or the cast applied once per element,
// the boundary rule computed once per window row and, outside the image's
// interior only, once per element without a division), then walks it down
// the columns: each thread owns one column of the tile (the paper's §4.3.3
// register reuse). For every window row it reads the K values of its
// stencil row once and computes each row pass once -- F (K_x's row factor),
// S (K_y's), D (v2's 2-tap difference) and, on the compile-time instance,
// the distinct K_d+ row vectors -- into a register ring of the last K
// rows; the vertical sums of each output pixel come from the rings. A
// reused row pass has the same bits as a recomputed one, so every output
// is still exactly the f32 operations of repro_torch.core.sobel.
// spec_components, in the same order: zero taps skipped, +-1 taps without a
// multiply, left-to-right sums.
//
// Two tap policies drive the same walk. Sobel5Default holds the taps of the
// default sobel5 (SobelParams()) as compile-time constants, so the zero and
// +-1 tests and the pass plan fold away; kernels/edge.py selects it when an
// operator's packed taps equal the default sobel5's, for v2 at 2 and 4
// directions. RtTaps reads the packed taps at run time (every other
// operator, variant and size); the dense K_d/K_dt correlations of
// `separable` and `direct` and the symmetric row passes of v1/v2 are formed
// per pixel from shared memory there. On the integer lane (u8 gray input,
// integer taps, core/ladder.py) the window is staged as int32 and the
// ladder runs in int32, where sums are exact in any order: mirrored taps
// share one multiply (int_taps_sum). The components convert to f32 before
// the magnitude and NMS, exactly like the plain lane.
//
// What bounds it now (tools/profile_k1.py on an H100 80GB HBM3 at 700 W,
// 4x2048x2048 on the 64x256 tile): on the f32 lane staging the window
// (~0.11 ms with the walk left out) and the walk (~0.15 ms with the
// staging left out) add up to ~0.20 ms, so they barely overlap: the window
// is staged whole before the walk, and no CTA prefetches its next window
// (K2 does: a producer warp copies the next windows while the walk runs).
// The integer lane's walk takes twice
// the f32 lane's (~0.33 ms with the staging left out): its adds and
// multiplies issue on the integer pipe, at half the f32 rate.
//
// Without NMS the halo is the stencil radius R and each pixel's magnitude
// (or components) is stored. With NMS (core/nms.py) the halo grows to R + 1
// and the walk covers the (bh+2) x (bw+2) inner tile; each warp walks 32
// inner columns and thins the 30 between them in registers, its
// neighbours' magnitudes from warp shuffles (EmitNms), so no magnitude or
// sector buffer sits in shared memory. The ring of the inner tile is the
// magnitude of the boundary-extended image, as core/nms.thin_map computes
// it.
//
// A stencil plan (core/filters.StencilPlan) runs its pre-stages on the tile
// before the walk (run_pre_stages): the window is staged at the plan's
// composed reach (its radii summed, + 1 with NMS), and each pre-stage --
// a separable or dense linear stage, a window max or min, abs or the fenced
// square -- consumes its own radius off that margin into a second plane,
// the next stage back into the window's buffer, so the border of a blurred
// plane is the blur of the extended input (core/sobel.plan_components),
// never an extension of the blurred plane. A linear or window stage is a
// column walk with a register ring of its K rows, in the f32 operations and
// order of the plain lane (hpass, vsum, corr2d); abs and square run in
// place. The walk then reads the last plane as its window.
//
// Compiled with --fmad=false (every product and sum rounded on its own) and
// without --use_fast_math (sqrtf stays IEEE).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#define KMAX 9
#define MAX_THREADS 384  // K1's and K3's largest CTA (tile_threads)

enum { V_DIRECT = 0, V_SEPARABLE = 1, V_V1 = 2, V_V2 = 3 };
enum { PAD_REFLECT = 0, PAD_EDGE = 1, PAD_ZERO = 2 };

// Every tap the ladder reads, packed by repro_torch/kernels/edge.py::_pack_taps
// in this field order (all f32, so Taps is a flat float array). The ladder
// reads taps of its own accumulator type W: the packed f32 Taps, or on the
// integer lane TapsT<int32_t>, converted once on the host (int_taps).
template <typename W>
struct TapsT {
  W dense[4][KMAX * KMAX];  // row-major dense banks K_x, K_y, K_d, K_dt
  W col[2][KMAX];           // separable column factors of K_x, K_y
  W row[2][KMAX];           // separable row factors of K_x, K_y
  W col_f[KMAX];            // Eq. 18 split of K_d-
  W col_d[KMAX];
  W row_d[KMAX];
  W sym[2][KMAX][KMAX];     // distinct row vectors of K_d+ (0), K_d- (1)
  W sym_pass[2][KMAX];      // per dense row: index into sym, -1 = zero row
  W sym_neg[2][KMAX];       // per dense row: 1 = negation of its pass
};
using Taps = TapsT<float>;
static_assert(sizeof(TapsT<int32_t>) == sizeof(Taps), "int taps mirror the f32 layout");

// The integer lane's taps: each packed f32 tap converted to int32 (exact:
// core/ladder.int_lane_eligible admits integer taps only, and the pass
// indices and flags are small integers).
inline TapsT<int32_t> int_taps(const Taps& t) {
  TapsT<int32_t> out;
  const float* src = reinterpret_cast<const float*>(&t);
  int32_t* dst = reinterpret_cast<int32_t*>(&out);
  for (size_t i = 0; i < sizeof(Taps) / sizeof(float); ++i) dst[i] = (int32_t)src[i];
  return out;
}

// Geometry and options of one launch.
struct Geom {
  int rgb, h, w, bh, bw, gh, gw, variant, dirs, padding, nms;
  float tan_pi8;  // f32 rounding of tan(pi/8), from core/nms.TAN_PI8_F32
};

// A plan's pre-stages, packed by repro_torch/kernels/edge.py::_pack_pre in
// this field order, all of the accumulator type W like TapsT (codes and
// sizes are small integers, exact either way). Without a plan n = 0 and
// reach is the operator's radius.
#define MAX_PRE 4
enum { PRE_SEP = 0, PRE_DENSE = 1, PRE_MAX = 2, PRE_MIN = 3, PRE_ABS = 4, PRE_SQUARE = 5 };
template <typename W>
struct PreT {
  W n;                           // pre-stages, 0 .. MAX_PRE
  W reach;                       // composed linear reach: the window's radius without NMS
  W kind[MAX_PRE];               // PRE_* code of each stage
  W size[MAX_PRE];               // 2 r + 1 (1 for abs and square)
  W taps[MAX_PRE][KMAX * KMAX];  // PRE_SEP: row factor at [0, K), column at [KMAX, KMAX + K);
                                 // PRE_DENSE: K x K taps at row pitch KMAX
};
using Pre = PreT<float>;
static_assert(sizeof(PreT<int32_t>) == sizeof(Pre), "int pre-stages mirror the f32 layout");

inline PreT<int32_t> int_pre(const Pre& p) {
  PreT<int32_t> out;
  const float* src = reinterpret_cast<const float*>(&p);
  int32_t* dst = reinterpret_cast<int32_t*>(&out);
  for (size_t i = 0; i < sizeof(Pre) / sizeof(float); ++i) dst[i] = (int32_t)src[i];
  return out;
}

// 4-byte words of the plane beside the window: the output of the first
// pre-stage with a radius, the largest plane a stage writes there (later
// stages alternate with the window's buffer, each output smaller than the
// last). 0 without one. kernels/edge.py::pre_plane_words mirrors it.
template <typename W>
__host__ __device__ inline int pre_plane_words(const PreT<W>& p, int bh, int bw, int nms) {
  int rem = (int)p.reach;
  for (int s = 0; s < (int)p.n; ++s) {
    const int r = ((int)p.size[s] - 1) / 2;
    rem -= r;
    if (r > 0) return (bh + 2 * nms + 2 * rem) * (bw + 2 * nms + 2 * rem);
  }
  return 0;
}

// The ladder runs in an accumulator type A: float, or int32_t on the exact
// integer lane (u8 gray input x integer taps, core/ladder.py), with taps of
// the same type; +-1 taps never multiply.
template <typename A>
__device__ __forceinline__ A tap(A w, A v) {
  return w == A(1) ? v : (w == A(-1) ? -v : w * v);
}

// Exact halving of the operator transform's even sums: * 0.5 in f32, an
// arithmetic shift in integers.
__device__ __forceinline__ float halve(float x) { return x * 0.5f; }
__device__ __forceinline__ int32_t halve(int32_t x) { return x >> 1; }

// Components leave the ladder as f32 (exact: the integer lane's values lie
// below 2^24).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int32_t x) { return __int2float_rn(x); }

// NaN-propagating max, like the reference's jnp.max.
__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// NaN-propagating min, like torch.minimum; the integer lane's max and min.
__device__ __forceinline__ float minp(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float pre_max(float a, float b) { return maxp(a, b); }
__device__ __forceinline__ float pre_min(float a, float b) { return minp(a, b); }
__device__ __forceinline__ int32_t pre_max(int32_t a, int32_t b) { return a > b ? a : b; }
__device__ __forceinline__ int32_t pre_min(int32_t a, int32_t b) { return a < b ? a : b; }

// A stencil source: src(i, j) is the ladder input at row i, column j of the
// stencil whose top-left corner the source was made for, in a shared-memory
// window.
template <typename A>
struct PtrSrc {
  const A* p;
  int ws;
  __device__ __forceinline__ A operator()(int i, int j) const { return p[i * ws + j]; }
};

// The integer lane's sum_t taps[t] * v(t): integer sums are exact in any
// order, so mirrored taps (w, w) or (w, -w) share one multiply of the pair's
// sum or difference. Wrapping 32-bit arithmetic: the ladder's bound
// (core/ladder.py) keeps the result in range whatever the intermediates.
template <int K, typename A, typename W, typename V>
__device__ __forceinline__ A int_taps_sum(const W& taps, const V& v) {
  uint32_t acc = 0;
#pragma unroll
  for (int t = 0; t < K / 2; ++t) {
    const int32_t w = (int32_t)taps[t], u = (int32_t)taps[K - 1 - t];
    const uint32_t a = (uint32_t)v(t), b = (uint32_t)v(K - 1 - t);
    if (w == u) {
      acc += (uint32_t)w * (a + b);
    } else if (w == -u) {
      acc += (uint32_t)w * (a - b);
    } else {
      acc += (uint32_t)w * a + (uint32_t)u * b;
    }
  }
  if (K % 2) acc += (uint32_t)(int32_t)taps[K / 2] * (uint32_t)v(K / 2);
  return (A)acc;
}

// Horizontal pass over stencil row i: sum_t taps[t] * src(i, t). `taps` is
// an array of A (run-time taps) or a Taps5 (compile-time taps).
template <int K, typename A, typename W, typename Src>
__device__ __forceinline__ A hpass(const W& taps, const Src& src, int i) {
  if constexpr (std::is_integral<A>::value) {
    return int_taps_sum<K, A>(taps, [&](int t) { return src(i, t); });
  }
  A acc = 0;
  bool any = false;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const A w = A(taps[t]);
    if (w != A(0)) {
      const A term = tap(w, src(i, t));
      acc = any ? acc + term : term;
      any = true;
    }
  }
  return acc;
}

// Vertical pass over K row-pass values: sum_t taps[t] * v[t].
template <int K, typename A, typename W>
__device__ __forceinline__ A vsum(const W& taps, const A (&v)[K]) {
  if constexpr (std::is_integral<A>::value) {
    return int_taps_sum<K, A>(taps, [&](int t) { return v[t]; });
  }
  A acc = 0;
  bool any = false;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const A w = A(taps[t]);
    if (w != A(0)) {
      const A term = tap(w, v[t]);
      acc = any ? acc + term : term;
      any = true;
    }
  }
  return acc;
}

// Dense correlation, taps in row-major order.
template <int K, typename A, typename Src>
__device__ __forceinline__ A corr2d(const A* taps, const Src& src) {
  A acc = 0;
  bool any = false;
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const A w = taps[i * KMAX + j];
      if (w != A(0)) {
        const A term = tap(w, src(i, j));
        acc = any ? acc + term : term;
        any = true;
      }
    }
  }
  return acc;
}

// core/sobel._sym_rowpass: one pass per distinct row vector, negated rows
// subtracted. Recomputing a pass per row gives the same bits as reusing it.
template <int K, typename A, typename Src>
__device__ __forceinline__ A symrow(const TapsT<A>& T, int s, const Src& src) {
  A acc = 0;
  bool any = false;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int pid = (int)T.sym_pass[s][i];
    if (pid < 0) continue;
    const A v = hpass<K, A>(T.sym[s][pid], src, i);
    const bool neg = T.sym_neg[s][i] != A(0);
    if (!any) {
      acc = neg ? -v : v;
    } else {
      acc = neg ? acc - v : acc + v;
    }
    any = true;
  }
  return acc;
}

// core/sobel.magnitude: ((g0^2 + g1^2) + g2^2) + g3^2, IEEE sqrtf.
__device__ __forceinline__ float magnitude(const float g[4], int dirs) {
  float m = g[0] * g[0];
  m = m + g[1] * g[1];
  if (dirs == 4) {
    m = m + g[2] * g[2];
    m = m + g[3] * g[3];
  }
  return sqrtf(m);
}

// core/nms.nms_sector at one pixel.
__device__ __forceinline__ int sector_of(const float g[4], int dirs, float t) {
  if (dirs == 4) {
    const float a0 = fabsf(g[0]), a1 = fabsf(g[1]), a2 = fabsf(g[2]), a3 = fabsf(g[3]);
    const int s23 = a2 >= a3 ? 2 : 3;
    const int s123 = (a1 >= a2 && a1 >= a3) ? 1 : s23;
    return (a0 >= a1 && a0 >= a2 && a0 >= a3) ? 0 : s123;
  }
  const float ax = fabsf(g[0]), ay = fabsf(g[1]);
  const int diag = ((g[0] >= 0.0f) == (g[1] >= 0.0f)) ? 2 : 3;
  return ay <= t * ax ? 0 : (ax <= t * ay ? 1 : diag);
}

// repro_torch.kernels.tiling.boundary_index for one coordinate.
__device__ __forceinline__ int boundary(int g, int n, int padding) {
  if (padding == PAD_REFLECT) {
    if (n == 1) return 0;
    const int period = 2 * (n - 1);
    int m = g % period;
    if (m < 0) m += period;
    m = m < n ? m : period - m;
    return min(max(m, 0), n - 1);
  }
  return min(max(g, 0), n - 1);
}

template <typename T>
__device__ __forceinline__ float load_gray(const T* xi, size_t o, int rgb) {
  if (rgb) {
    const T* q = xi + o * 3;
    return (0.299f * (float)q[0] + 0.587f * (float)q[1]) + 0.114f * (float)q[2];
  }
  return (float)xi[o];
}

// The ladder input at element o: the f32 luma or cast, or on the integer
// lane (u8 gray only) the value itself.
template <typename T, typename A>
struct LoadVal {
  __device__ __forceinline__ static A at(const T* xi, size_t o, int rgb) {
    return load_gray<T>(xi, o, rgb);
  }
};

template <>
struct LoadVal<uint8_t, int32_t> {
  __device__ __forceinline__ static int32_t at(const uint8_t* xi, size_t o, int) {
    return (int32_t)xi[o];
  }
};

// Dynamic shared memory edge_tile() needs: the halo window, in 4-byte
// words. With NMS the halo is one wider; the inner tile's magnitude and
// sectors stay in registers. (kernels/edge.py's window_smem_bytes, the bound
// tile choices are checked against, still counts a magnitude and a sector
// buffer, so that the tiles legal for an NMS call did not change.)
__host__ __device__ inline size_t tile_smem_bytes(int bh, int bw, int radius, int nms) {
  const int halo = radius + (nms ? 1 : 0);
  return (size_t)(bh + 2 * halo) * (bw + 2 * halo) * sizeof(float);
}

// Without NMS: store in-image pixel (gy, gx)'s components and magnitude
// (each output may be null) and fold the magnitude into tmax.
__device__ __forceinline__ void emit_pixel(const Geom& g, long long img, int gy, int gx,
                                           const float c[4], float* __restrict__ out_primary,
                                           float* __restrict__ out_comps, bool need_mag,
                                           float& tmax) {
  const size_t plane = (size_t)g.h * g.w;
  const size_t o = (size_t)gy * g.w + gx;
  if (out_comps != nullptr) {
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      if (d < g.dirs) out_comps[((size_t)img * g.dirs + d) * plane + o] = c[d];
    }
  }
  if (need_mag) {
    const float m = magnitude(c, g.dirs);
    if (out_primary != nullptr) out_primary[(size_t)img * plane + o] = m;
    tmax = maxp(tmax, m);
  }
}

// The compile-time taps of one 5-tap vector (the default operator's taps
// are integers): operator[] folds to a constant once the loop is unrolled.
template <int W0, int W1, int W2, int W3, int W4>
struct Taps5 {
  __host__ __device__ constexpr float operator[](int t) const {
    return (float)(t == 0 ? W0 : t == 1 ? W1 : t == 2 ? W2 : t == 3 ? W3 : W4);
  }
};

// The default sobel5 (SobelParams(a=1, b=2, m=6, n=4)) with the v2 ladder,
// as repro_torch/kernels/edge.py::_pack_taps packs it; edge.py checks these
// against the packed taps when it loads the library (repro_default_taps).
// Its K_d+ plan: rows 0 and 4 use pass 0 (row 4 negated), rows 1 and 3
// pass 1 (row 3 negated), row 2 is zero.
template <int DIRS>
struct Sobel5Default {
  static constexpr int kPasses = 2;  // distinct K_d+ rows, shared in rings
  static constexpr bool kSmallInts = true;  // |components| < 2^22 on the integer lane
  template <typename A>
  __device__ static Sobel5Default make(const TapsT<A>&, const Geom&) { return {}; }
  __device__ constexpr int variant() const { return V_V2; }
  __device__ constexpr int dirs() const { return DIRS; }
  __host__ __device__ Taps5<-1, -2, 0, 2, 1> row_f() const { return {}; }    // K_x's row factor
  __host__ __device__ Taps5<1, 4, 6, 4, 1> row_s() const { return {}; }      // K_y's row factor
  __host__ __device__ Taps5<0, -1, 0, 1, 0> row_d() const { return {}; }     // v2's D
  __host__ __device__ Taps5<1, 4, 6, 4, 1> col_x() const { return {}; }      // K_x's column factor
  __host__ __device__ Taps5<-1, -2, 0, 2, 1> col_y() const { return {}; }    // K_y's column factor
  __host__ __device__ Taps5<6, 6, 2, 6, 6> col_f() const { return {}; }      // Eq. 18, K_d- on F
  __host__ __device__ Taps5<10, 0, -12, 0, 10> col_d() const { return {}; }  // Eq. 18, K_d- on D
  template <int P>
  __host__ __device__ auto sym() const {                                      // K_d+'s passes
    if constexpr (P == 0) return Taps5<-6, -6, -2, -6, -6>{};
    else return Taps5<-2, -12, -16, -12, -2>{};
  }
  __host__ __device__ Taps5<0, 1, -1, 1, 0> sym_pass() const { return {}; }
  __host__ __device__ Taps5<0, 0, 0, 1, 1> sym_neg() const { return {}; }
};

// Run-time taps: every operator, variant and size.
template <typename A>
struct RtTaps {
  static constexpr int kPasses = 0;  // symmetric passes per pixel, from shared memory
  static constexpr bool kSmallInts = false;
  const TapsT<A>& t;
  int var, nd;
  __device__ static RtTaps make(const TapsT<A>& t, const Geom& g) { return {t, g.variant, g.dirs}; }
  __device__ int variant() const { return var; }
  __device__ int dirs() const { return nd; }
  __device__ const A* row_f() const { return t.row[0]; }
  __device__ const A* row_s() const { return t.row[1]; }
  __device__ const A* row_d() const { return t.row_d; }
  __device__ const A* col_x() const { return t.col[0]; }
  __device__ const A* col_y() const { return t.col[1]; }
  __device__ const A* col_f() const { return t.col_f; }
  __device__ const A* col_d() const { return t.col_d; }
};

// A component to f32. On the integer lane, values below 2^22 (kSmall) take
// an exact add-and-subtract through the f32 bit pattern of 1.5 * 2^23
// instead of I2F, which issues at an eighth of the f32 rate.
template <bool kSmall>
__device__ __forceinline__ float comp_f32(float x) { return x; }
template <bool kSmall>
__device__ __forceinline__ float comp_f32(int32_t x) {
  if (kSmall) return __int_as_float(x + 0x4B400000) - 12582912.0f;
  return to_f32(x);
}

// One stencil row held in registers, as a stencil source for hpass.
template <typename A, int K>
struct RegRow {
  const A (&v)[K];
  __device__ __forceinline__ A operator()(int, int t) const { return v[t]; }
};

// K_d+ from the rings of its distinct passes (core/sobel._sym_rowpass):
// rows in order, each its pass's value at that row, negated rows subtracted.
template <int K, int NP, typename A, typename P>
__device__ __forceinline__ A sym_from_rings(const P& tp, const A (&pr)[NP][K]) {
  A acc = 0;
  bool any = false;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int pid = (int)tp.sym_pass()[i];
    if (pid < 0) continue;
    const A v = pr[pid][i];
    const bool neg = tp.sym_neg()[i] != 0.0f;
    acc = !any ? (neg ? -v : v) : (neg ? acc - v : acc + v);
    any = true;
  }
  return acc;
}

template <int K, int NP, typename A, typename P>
struct SymPasses {
  // Row passes of the distinct K_d+ rows of one window row.
  __device__ __forceinline__ static void push(const P& tp, A (&pr)[NP][K], const A (&v)[K]) {
    push_from<0>(tp, pr, v);
  }
  template <int Q>
  __device__ __forceinline__ static void push_from(const P& tp, A (&pr)[NP][K], const A (&v)[K]) {
    if constexpr (Q < NP) {
#pragma unroll
      for (int t = 0; t < K - 1; ++t) pr[Q][t] = pr[Q][t + 1];
      pr[Q][K - 1] = hpass<K, A>(tp.template sym<Q>(), RegRow<A, K>{v}, 0);
      push_from<Q + 1>(tp, pr, v);
    }
  }
};

// Walk window column ex (its stencil columns ex .. ex + K - 1) down output
// rows ya .. yb - 1 of the region the window covers, calling
// emit(y, g) with each pixel's components in A.
template <int K, typename A, typename P, typename Emit>
__device__ __forceinline__ void walk_column(const P& tp, const A* win, int ew, int ex, int ya,
                                            int yb, Emit& emit) {
  constexpr int NP = P::kPasses > 0 ? P::kPasses : 1;
  const int variant = tp.variant(), dirs = tp.dirs();
  const bool sep = variant != V_DIRECT;
  const bool need_d = variant == V_V2 && dirs == 4;
  A fr[K], sr[K], dr[K], pr[NP][K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    fr[t] = sr[t] = dr[t] = 0;
#pragma unroll
    for (int p = 0; p < NP; ++p) pr[p][t] = 0;
  }
  // One window row: its row passes into the rings, then the pixel K - 1
  // rows up. The integer lane unrolls the rows by K, so that the rings
  // need no moves; the f32 lane does not (unrolled, it spills registers).
  auto step = [&](int wr) {
    A v[K];
    const A* rowp = win + wr * ew + ex;
#pragma unroll
    for (int t = 0; t < K; ++t) v[t] = rowp[t];
    const RegRow<A, K> row{v};
#pragma unroll
    for (int t = 0; t < K - 1; ++t) {
      fr[t] = fr[t + 1];
      sr[t] = sr[t + 1];
      dr[t] = dr[t + 1];
    }
    if (sep) {
      fr[K - 1] = hpass<K, A>(tp.row_f(), row, 0);
      sr[K - 1] = hpass<K, A>(tp.row_s(), row, 0);
    }
    if (need_d) dr[K - 1] = hpass<K, A>(tp.row_d(), row, 0);
    if constexpr (P::kPasses > 0) {
      if (dirs == 4) SymPasses<K, NP, A, P>::push(tp, pr, v);
    }
    const int y = wr - (K - 1);
    if (y < ya) return;
    A g[4] = {0, 0, 0, 0};
    if constexpr (P::kPasses > 0) {
      // The compile-time instance: v2 only.
      g[0] = vsum<K, A>(tp.col_x(), fr);
      g[1] = vsum<K, A>(tp.col_y(), sr);
      if (dirs == 4) {
        const A gp = sym_from_rings<K, NP, A>(tp, pr);
        const A gm = vsum<K, A>(tp.col_f(), fr) - vsum<K, A>(tp.col_d(), dr);
        g[2] = halve(gp + gm);
        g[3] = halve(gp - gm);
      }
    } else {
      const PtrSrc<A> src{win + y * ew + ex, ew};
      const TapsT<A>& T = tp.t;
      if (!sep) {
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          if (d < dirs) g[d] = corr2d<K, A>(T.dense[d], src);
        }
      } else {
        g[0] = vsum<K, A>(T.col[0], fr);
        g[1] = vsum<K, A>(T.col[1], sr);
        if (dirs == 4) {
          if (variant == V_SEPARABLE) {
            g[2] = corr2d<K, A>(T.dense[2], src);
            g[3] = corr2d<K, A>(T.dense[3], src);
          } else {
            const A gp = symrow<K, A>(T, 0, src);
            const A gm = variant == V_V1 ? symrow<K, A>(T, 1, src)
                                         : vsum<K, A>(T.col_f, fr) - vsum<K, A>(T.col_d, dr);
            g[2] = halve(gp + gm);
            g[3] = halve(gp - gm);
          }
        }
      }
    }
    emit(y, g);
  };
  if constexpr (std::is_integral<A>::value) {
#pragma unroll K
    for (int wr = ya; wr < yb + K - 1; ++wr) step(wr);
  } else {
#pragma unroll 1
    for (int wr = ya; wr < yb + K - 1; ++wr) step(wr);
  }
}

// repro_torch.kernels.tiling.boundary_index for one coordinate, without a
// division where the overhang is at most n - 1 (every tile of an image
// larger than its halo).
__device__ __forceinline__ int boundary_fast(int g, int n, int padding) {
  if (g >= 0 && g < n) return g;
  if (padding != PAD_REFLECT) return g < 0 ? 0 : n - 1;
  if (g < 0 && -g < n) return -g;
  if (g >= n && g <= 2 * n - 2) return 2 * n - 2 - g;
  return boundary(g, n, padding);
}

// The ladder input at window element (gy, gx) of the image, under the
// boundary rule; `inside` skips the rule for a window inside the image.
template <typename T, typename A>
__device__ __forceinline__ A window_value(const Geom& g, const T* __restrict__ xi, int gy, int gx,
                                          bool inside) {
  if (inside) return LoadVal<T, A>::at(xi, (size_t)gy * g.w + gx, g.rgb);
  if (g.padding == PAD_ZERO && (gy < 0 || gy >= g.h || gx < 0 || gx >= g.w)) return A(0);
  const int sy = boundary_fast(gy, g.h, g.padding), sx = boundary_fast(gx, g.w, g.padding);
  return LoadVal<T, A>::at(xi, (size_t)sy * g.w + sx, g.rgb);
}

// Stage the eh x ew window whose top-left element is image (row0, col0) in
// row-major order, consecutive threads on consecutive elements (coalesced).
// Each thread keeps STAGE_LOADS loads in flight before it stores any: a
// window is a few round trips to memory, not one per element. A thread's
// (row, column) advances by the CTA's stride without a division.
#define STAGE_LOADS 8
template <typename T, typename A>
__device__ __forceinline__ void stage_window(const Geom& g, const T* __restrict__ xi, int row0,
                                             int col0, int eh, int ew, A* win) {
  const bool inside = row0 >= 0 && col0 >= 0 && row0 + eh <= g.h && col0 + ew <= g.w;
  const int n = eh * ew, step = blockDim.x;
  const int dy = step / ew, dx = step - dy * ew;
  int ly = threadIdx.x / ew, lx = threadIdx.x - ly * ew;
  for (int base = threadIdx.x; base < n; base += STAGE_LOADS * step) {
    A v[STAGE_LOADS];
#pragma unroll
    for (int u = 0; u < STAGE_LOADS; ++u) {
      v[u] = base + u * step < n ? window_value<T, A>(g, xi, row0 + ly, col0 + lx, inside) : A(0);
      lx += dx;
      ly += dy;
      if (lx >= ew) {
        lx -= ew;
        ++ly;
      }
    }
#pragma unroll
    for (int u = 0; u < STAGE_LOADS; ++u) {
      if (base + u * step < n) win[base + u * step] = v[u];
    }
  }
}

// Threads of a K1/K3 CTA, in whole warps, at most MAX_THREADS (wider tiles
// loop over their columns): one per column of the tile; with NMS one warp
// per 30 centre columns, each warp also walking the column on either side.
__host__ __device__ inline int tile_threads(int bw, int nms) {
  const int t = nms ? (bw + 29) / 30 * 32 : (bw + 31) / 32 * 32;
  return t < MAX_THREADS ? t : MAX_THREADS;
}

// Without NMS: the walk's emit, storing in-image pixels of one column.
template <typename P>
struct EmitPixel {
  const Geom& g;
  long long img;
  int gy0, gx;
  float* __restrict__ primary;
  float* __restrict__ comps;
  bool need_mag;
  float tmax;
  template <typename A>
  __device__ __forceinline__ void operator()(int y, const A (&a)[4]) {
    float c[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) c[d] = d < g.dirs ? comp_f32<P::kSmallInts>(a[d]) : 0.0f;
    emit_pixel(g, img, gy0 + y, gx, c, primary, comps, need_mag, tmax);
  }
};

// With NMS: the walk's emit over the inner tile, thinning in registers
// (core/nms.nms_sector and nms_thin). Lane l of a warp walks inner column
// ex = cb + l; lanes 1..30 own the centre columns cb .. cb + 29, whose left
// and right neighbours are lanes l - 1 and l + 1. Each lane keeps the
// magnitudes of the last three inner rows and their left and right
// neighbours' (one shuffle each way a row) and the sector of the middle
// row: once inner row y is in, centre row y - 2 is thinned. Every lane of
// the warp calls it for every row (the shuffles need all 32). kBand (K2)
// limits the stores to the centre rows c0 .. c1 - 1 of a band that walks
// inner rows c0 .. c1 + 1; K1 and K3 walk the whole inner tile.
template <typename P, bool kBand = false>
struct EmitNms {
  const Geom& g;
  long long img;
  int tr, tc, ex;
  bool centre;  // this lane owns a centre column of the tile
  float* __restrict__ primary;
  float* __restrict__ comps;
  float* __restrict__ mag_out;
  float m[3], ml[3], mr[3];  // inner rows y - 2, y - 1, y: own, left, right
  int sec_prev;
  float tmax;
  int c0 = 0, c1 = 0;  // kBand: the band's centre rows
  template <typename A>
  __device__ __forceinline__ void operator()(int y, const A (&a)[4]) {
    float c[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) c[d] = d < g.dirs ? comp_f32<P::kSmallInts>(a[d]) : 0.0f;
    const float mag = magnitude(c, g.dirs);
    m[0] = m[1], ml[0] = ml[1], mr[0] = mr[1];
    m[1] = m[2], ml[1] = ml[2], mr[1] = mr[2];
    m[2] = mag;
    ml[2] = __shfl_up_sync(0xffffffffu, mag, 1);
    mr[2] = __shfl_down_sync(0xffffffffu, mag, 1);
    const size_t plane = (size_t)g.h * g.w;
    const int gx = tc * g.bw + ex - 1;
    int sec = 0;
    if (centre && y >= 1 && y <= g.bh) {
      sec = sector_of(c, g.dirs, g.tan_pi8);
      const int gy = tr * g.bh + y - 1;
      const bool own = !kBand || (y - 1 >= c0 && y - 1 < c1);
      if (comps != nullptr && own && gy < g.h && gx < g.w) {
        const size_t o = (size_t)gy * g.w + gx;
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          if (d < g.dirs) comps[((size_t)img * g.dirs + d) * plane + o] = c[d];
        }
      }
    }
    if (centre && y >= 2 && (!kBand || y >= c0 + 2)) {
      const int gy = tr * g.bh + y - 2;
      if (gy < g.h && gx < g.w) {
        const float cv = m[1];
        float n1, n2;
        switch (sec_prev) {
          case 0: n1 = ml[1]; n2 = mr[1]; break;
          case 1: n1 = m[0]; n2 = m[2]; break;
          case 2: n1 = ml[0]; n2 = mr[2]; break;
          default: n1 = mr[0]; n2 = ml[2]; break;
        }
        const size_t o = (size_t)img * plane + (size_t)gy * g.w + gx;
        if (primary != nullptr) primary[o] = (cv >= n1 && cv >= n2) ? cv : 0.0f;
        if (mag_out != nullptr) mag_out[o] = cv;
        tmax = maxp(tmax, cv);
      }
    }
    sec_prev = sec;
  }
};

// max/min of v(0) .. v(K - 1), folded left to right (core/sobel._window_reduce).
template <int K, typename A, typename V>
__device__ __forceinline__ A fold_window(bool is_max, const V& v) {
  A acc = v(0);
#pragma unroll
  for (int t = 1; t < K; ++t) acc = is_max ? pre_max(acc, v(t)) : pre_min(acc, v(t));
  return acc;
}

// Pre-stage s of width KP (core/sobel._stage_apply): `in` is (oh + KP - 1) x
// (ow + KP - 1) at row pitch iw, `out` oh x ow at pitch ow. Each thread walks
// columns of the output: a linear stage's horizontal pass (or a window's
// row max/min) into a ring of KP rows, the vertical pass from the ring; a
// dense stage correlates per pixel. Not inlined: one copy per width and
// accumulator type serves every instance.
template <int KP, typename A>
__device__ __noinline__ void pre_stage(const PreT<A>& pre, int s, const A* in, int iw, A* out,
                                       int oh, int ow) {
  const int kind = (int)pre.kind[s];
  const A* taps = pre.taps[s];
  const bool is_max = kind == PRE_MAX;
  for (int j = threadIdx.x; j < ow; j += blockDim.x) {
    if (kind == PRE_DENSE) {
#pragma unroll 1
      for (int y = 0; y < oh; ++y) out[y * ow + j] = corr2d<KP, A>(taps, PtrSrc<A>{in + y * iw + j, iw});
      continue;
    }
    A ring[KP];
#pragma unroll
    for (int t = 0; t < KP; ++t) ring[t] = 0;
#pragma unroll 1
    for (int r = 0; r < oh + KP - 1; ++r) {
#pragma unroll
      for (int t = 0; t < KP - 1; ++t) ring[t] = ring[t + 1];
      const PtrSrc<A> src{in + r * iw + j, iw};
      ring[KP - 1] = kind == PRE_SEP
                         ? hpass<KP, A>(taps, src, 0)
                         : fold_window<KP, A>(is_max, [&](int t) { return src(0, t); });
      if (r >= KP - 1) {
        out[(r - KP + 1) * ow + j] =
            kind == PRE_SEP ? vsum<KP, A>(taps + KMAX, ring)
                            : fold_window<KP, A>(is_max, [&](int t) { return ring[t]; });
      }
    }
  }
}

// core/filters' pointwise fns: abs, and the fenced square max(x * x, 0).
__device__ __forceinline__ float pre_point(int kind, float v) {
  return kind == PRE_ABS ? fabsf(v) : maxp(v * v, 0.0f);
}
__device__ __forceinline__ int32_t pre_point(int kind, int32_t v) {
  return kind == PRE_ABS ? (v < 0 ? -v : v) : v * v;
}

// The plan's pre-stages on a tile whose window `win` is (mh + 2 reach) x
// (mw + 2 reach); `plane` holds pre_plane_words() more. Every thread of the
// CTA calls it once the window is in; returns whether the last plane,
// (mh + 2 R) x (mw + 2 R) for the gradient's radius R, is in `plane` (else
// in `win`). The caller offsets its own shared-memory pointer by that, so
// that the walk's loads stay shared-memory loads.
template <typename A>
__device__ bool run_pre_stages(const PreT<A>& pre, A* win, A* plane, int mh, int mw) {
  A* cur = win;
  int rem = (int)pre.reach;
  for (int s = 0; s < (int)pre.n; ++s) {
    const int kp = (int)pre.size[s];
    const int iw = mw + 2 * rem, ih = mh + 2 * rem;
    rem -= kp / 2;
    const int kind = (int)pre.kind[s];
    if (kind == PRE_ABS || kind == PRE_SQUARE) {
      for (int q = threadIdx.x; q < ih * iw; q += blockDim.x) cur[q] = pre_point(kind, cur[q]);
    } else {
      A* dst = cur == win ? plane : win;
      const int oh = mh + 2 * rem, ow = mw + 2 * rem;
      switch (kp) {
        case 3: pre_stage<3, A>(pre, s, cur, iw, dst, oh, ow); break;
        case 5: pre_stage<5, A>(pre, s, cur, iw, dst, oh, ow); break;
        case 7: pre_stage<7, A>(pre, s, cur, iw, dst, oh, ow); break;
        default: pre_stage<9, A>(pre, s, cur, iw, dst, oh, ow); break;
      }
      cur = dst;
    }
    __syncthreads();
  }
  return cur != win;
}

// The outputs of tile (img, tr, tc); every thread of the CTA (tile_threads
// of them) calls it. Without NMS: out_primary gets the magnitude and
// out_comps the components (either may be null). With NMS: out_primary gets
// the thin map, out_comps the centre components, out_mag the un-thinned
// magnitude (each may be null). Returns this thread's max of the un-thinned
// magnitude over its in-image pixels (0 where it has none); meaningful only
// when need_max. A is the ladder's accumulator: float, or int32_t for u8
// gray input on the integer lane (the window is then staged as int32); P is
// the tap policy (Sobel5Default or RtTaps). kPre (K1's and K2's plan
// instances) runs a plan's pre-stages `pre`: the window is then staged at
// the composed reach and the pre-stages run before the walk, their plane
// after the window in smem (pre_plane_words). Without kPre the tile is the
// operator alone and no pre-stage code is compiled in.
template <int K, typename T, typename A, typename P, bool kPre = false>
__device__ float edge_tile(const P& tp, const Geom& g, const T* __restrict__ x, long long img,
                           int tr, int tc, float* smem, float* __restrict__ out_primary,
                           float* __restrict__ out_comps, float* __restrict__ out_mag,
                           bool need_max, const PreT<A>* pre = nullptr) {
  static_assert(sizeof(A) == sizeof(float), "tile_smem_bytes sizes the window in 4-byte words");
  constexpr int R = K / 2;
  int reach = R;
  if constexpr (kPre) reach = (int)pre->reach;
  const int halo = reach + g.nms;
  const int mh = g.bh + 2 * g.nms, mw = g.bw + 2 * g.nms;
  const int eh = mh + 2 * reach, ew0 = mw + 2 * reach, ew = mw + 2 * R;
  const T* xi = x + (size_t)img * g.h * g.w * (g.rgb ? 3 : 1);
  A* win = reinterpret_cast<A*>(smem);
  stage_window<T, A>(g, xi, tr * g.bh - halo, tc * g.bw - halo, eh, ew0, win);
  __syncthreads();
  if constexpr (kPre) {
    if (run_pre_stages<A>(*pre, win, win + eh * ew0, mh, mw)) win += eh * ew0;
  }

  if (!g.nms) {
    float tmax = 0.0f;
    const bool need_mag = out_primary != nullptr || need_max;
    const int rows = min(g.bh, g.h - tr * g.bh);
    const int cols = min(g.bw, g.w - tc * g.bw);
    for (int ex = threadIdx.x; ex < cols; ex += blockDim.x) {
      EmitPixel<P> e{g, img, tr * g.bh, tc * g.bw + ex, out_primary, out_comps, need_mag, 0.0f};
      walk_column<K, A>(tp, win, ew, ex, 0, rows, e);
      tmax = maxp(tmax, e.tmax);
    }
    return tmax;
  }

  // NMS: each warp walks 32 inner columns and thins the 30 in between.
  float tmax = 0.0f;
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int cb = 30 * (threadIdx.x >> 5); cb < g.bw; cb += 30 * nwarps) {
    const int ex = cb + lane;
    EmitNms<P> e{g, img, tr, tc, ex, lane >= 1 && lane <= 30 && ex <= g.bw, out_primary,
                 out_comps, out_mag, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f},
                 0, 0.0f};
    // A lane past the inner tile walks its last column: its values are
    // never a centre's neighbour, but its shuffles must run.
    walk_column<K, A>(tp, win, ew, min(ex, mw - 1), 0, mh, e);
    tmax = maxp(tmax, e.tmax);
  }
  return tmax;
}

// The CTA's max of every thread's v (max is order-free, so exact); valid in
// thread 0. Every thread of the CTA calls it; warp_max holds a float per warp.
__device__ __forceinline__ float block_max(float v, float* warp_max) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = maxp(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = warp_max[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) m = maxp(m, warp_max[i]);
  return m;
}

// (img, tile row, tile col) of tile b; tiles are numbered like bmax's
// (n, gh, gw) layout, so b also indexes bmax and the stream mask.
__device__ __forceinline__ void tile_at(const Geom& g, long long b, long long* img, int* tr,
                                        int* tc) {
  *tc = (int)(b % g.gw);
  b /= g.gw;
  *tr = (int)(b % g.gh);
  *img = b / g.gh;
}

// The tile of this CTA (K1: one CTA per tile).
__device__ __forceinline__ void tile_of(const Geom& g, long long* img, int* tr, int* tc) {
  tile_at(g, blockIdx.x, img, tr, tc);
}

// The helpers every library exports beside its launch entry (one copy per
// library: each source compiles into its own shared object).
extern "C" int repro_taps_len(void) { return (int)(sizeof(Taps) / sizeof(float)); }

extern "C" int repro_max_size(void) { return KMAX; }

extern "C" int repro_pre_len(void) { return (int)(sizeof(Pre) / sizeof(float)); }

// The compile-time instance's taps in the packed Taps layout (the fields it
// reads; every other field 0), for edge.py to hold against _pack_taps.
extern "C" void repro_default_taps(float* out) {
  Taps t;
  memset(&t, 0, sizeof(t));
  const Sobel5Default<4> p;
  for (int i = 0; i < 5; ++i) {
    t.row[0][i] = p.row_f()[i];
    t.row[1][i] = p.row_s()[i];
    t.row_d[i] = p.row_d()[i];
    t.col[0][i] = p.col_x()[i];
    t.col[1][i] = p.col_y()[i];
    t.col_f[i] = p.col_f()[i];
    t.col_d[i] = p.col_d()[i];
    t.sym[0][0][i] = p.sym<0>()[i];
    t.sym[0][1][i] = p.sym<1>()[i];
    t.sym_pass[0][i] = p.sym_pass()[i];
    t.sym_neg[0][i] = p.sym_neg()[i];
  }
  memcpy(out, &t, sizeof(t));
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dispatch a templated launcher over the operator size.
#define REPRO_SWITCH_SIZE(size, CALL) \
  switch (size) {                     \
    case 3: { constexpr int KS = 3; return CALL; } \
    case 5: { constexpr int KS = 5; return CALL; } \
    case 7: { constexpr int KS = 7; return CALL; } \
    case 9: { constexpr int KS = 9; return CALL; } \
    default: return cudaErrorInvalidValue;         \
  }
