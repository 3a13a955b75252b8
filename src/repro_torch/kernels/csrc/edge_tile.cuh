// The per-tile compute shared by K1 (edge.cu) and K3 (edge_stream.cu), and
// the ladder, output and reduction helpers K2 (edge_pipelined.cu) shares.
//
// One CTA owns one bh x bw output tile. edge_tile() stages the tile's halo
// window in shared memory as f32, applying the BT.601 luma (RGB) or the cast
// (gray) and the boundary rule (reflect / edge / zero) as index arithmetic
// while it loads, then computes the tile's outputs from shared memory with
// exactly the f32 operations of repro_torch.core.sobel.spec_components, in
// the same order: zero taps skipped, +-1 taps without a multiply,
// left-to-right sums. Row passes are recomputed per pixel rather than
// shared; that costs arithmetic, not bits. On the integer lane (u8 gray
// input, integer taps, core/ladder.py) the window is staged as int32, the
// ladder runs in int32 (i16-licensed operators too: i32 holds every
// i16-bounded value exactly) and the components convert to f32 before the
// magnitude and NMS, exactly like the plain lane.
//
// Without NMS the halo is the stencil radius R and each pixel's magnitude
// (or components) is stored. With NMS (core/nms.py) the halo grows to R + 1,
// the ladder runs on the (bh+2) x (bw+2) inner tile and its magnitude stays
// in shared memory beside a 1-byte sector per centre pixel; a second pass
// compares each centre pixel with its two neighbours along its sector and
// stores the thin map. The ring of the inner tile is the magnitude of the
// boundary-extended image, as core/nms.thin_map computes it.
//
// Both kernels are compiled with --fmad=false (every product and sum
// rounded on its own) and without --use_fast_math (sqrtf stays IEEE).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define KMAX 9
#define THREADS 256

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

// A stencil source: src(i, j) is the ladder input at row i, column j of the
// stencil whose top-left corner the source was made for. K1 and K3 read a
// shared-memory window (PtrSrc); K2 reads its ring through index maps.
template <typename A>
struct PtrSrc {
  const A* p;
  int ws;
  __device__ __forceinline__ A operator()(int i, int j) const { return p[i * ws + j]; }
};

// Horizontal pass over stencil row i: sum_t taps[t] * src(i, t).
template <int K, typename A, typename Src>
__device__ __forceinline__ A hpass(const A* taps, const Src& src, int i) {
  A acc = 0;
  bool any = false;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const A w = taps[t];
    if (w != A(0)) {
      const A term = tap(w, src(i, t));
      acc = any ? acc + term : term;
      any = true;
    }
  }
  return acc;
}

// Vertical pass over K row-pass values: sum_t taps[t] * v[t].
template <int K, typename A>
__device__ __forceinline__ A vsum(const A* taps, const A (&v)[K]) {
  A acc = 0;
  bool any = false;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const A w = taps[t];
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

// The separable row passes F (K_x's row factor), S (K_y's) and D (v2's
// 2-tap difference) at stencil row i. PassRows computes them from the
// source (K1, K3); K2's SinkRows reads them from its shared-memory sink.
template <int K, typename A, typename Src>
struct PassRows {
  const TapsT<A>& T;
  const Src& src;
  __device__ __forceinline__ A f(int i) const { return hpass<K, A>(T.row[0], src, i); }
  __device__ __forceinline__ A s(int i) const { return hpass<K, A>(T.row[1], src, i); }
  __device__ __forceinline__ A d(int i) const { return hpass<K, A>(T.row_d, src, i); }
};

// core/sobel.spec_components at one pixel, in the accumulator type A.
template <int K, typename A, typename Src, typename Rows>
__device__ __forceinline__ void components(const TapsT<A>& T, const Src& src, const Rows& rows,
                                           int variant, int dirs, A g[4]) {
  if (variant == V_DIRECT) {
    g[0] = corr2d<K, A>(T.dense[0], src);
    g[1] = corr2d<K, A>(T.dense[1], src);
    if (dirs == 4) {
      g[2] = corr2d<K, A>(T.dense[2], src);
      g[3] = corr2d<K, A>(T.dense[3], src);
    }
    return;
  }
  A f[K], s[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    f[i] = rows.f(i);
    s[i] = rows.s(i);
  }
  g[0] = vsum<K, A>(T.col[0], f);
  g[1] = vsum<K, A>(T.col[1], s);
  if (dirs == 2) return;
  if (variant == V_SEPARABLE) {
    g[2] = corr2d<K, A>(T.dense[2], src);
    g[3] = corr2d<K, A>(T.dense[3], src);
    return;
  }
  const A gp = symrow<K, A>(T, 0, src);
  A gm;
  if (variant == V_V1) {
    gm = symrow<K, A>(T, 1, src);
  } else {
    A d[K];
#pragma unroll
    for (int i = 0; i < K; ++i) d[i] = rows.d(i);
    gm = vsum<K, A>(T.col_f, f) - vsum<K, A>(T.col_d, d);
  }
  g[2] = halve(gp + gm);
  g[3] = halve(gp - gm);
}

// The f32 components of one pixel: the ladder in A, then the cast.
template <int K, typename A, typename Src, typename Rows>
__device__ __forceinline__ void components_f32(const TapsT<A>& T, const Src& src, const Rows& rows,
                                               int variant, int dirs, float c[4]) {
  A a[4];
  components<K, A>(T, src, rows, variant, dirs, a);
  for (int d = 0; d < dirs; ++d) c[d] = to_f32(a[d]);
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

// Dynamic shared memory edge_tile() needs: the f32 halo window, and with NMS
// the inner tile's magnitude and a sector byte per centre pixel.
__host__ __device__ inline size_t tile_smem_bytes(int bh, int bw, int radius, int nms) {
  const int halo = radius + (nms ? 1 : 0);
  size_t bytes = (size_t)(bh + 2 * halo) * (bw + 2 * halo) * sizeof(float);
  if (nms) bytes += (size_t)(bh + 2) * (bw + 2) * sizeof(float) + (size_t)bh * bw;
  return bytes;
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
    for (int d = 0; d < g.dirs; ++d) out_comps[((size_t)img * g.dirs + d) * plane + o] = c[d];
  }
  if (need_mag) {
    const float m = magnitude(c, g.dirs);
    if (out_primary != nullptr) out_primary[(size_t)img * plane + o] = m;
    tmax = maxp(tmax, m);
  }
}

// With NMS: pixel (ey, ex) of tile (tr, tc)'s (bh+2) x (bw+2) inner tile.
// Its magnitude goes to mag_ext; a centre pixel also stores its sector and,
// when in the image, its components.
__device__ __forceinline__ void emit_inner(const Geom& g, long long img, int tr, int tc, int ey,
                                           int ex, const float c[4], float* mag_ext,
                                           unsigned char* sector, float* __restrict__ out_comps) {
  mag_ext[ey * (g.bw + 2) + ex] = magnitude(c, g.dirs);
  if (ey >= 1 && ey <= g.bh && ex >= 1 && ex <= g.bw) {
    const int oy = ey - 1, ox = ex - 1;
    sector[oy * g.bw + ox] = (unsigned char)sector_of(c, g.dirs, g.tan_pi8);
    const int gy = tr * g.bh + oy, gx = tc * g.bw + ox;
    if (out_comps != nullptr && gy < g.h && gx < g.w) {
      const size_t plane = (size_t)g.h * g.w;
      const size_t o = (size_t)gy * g.w + gx;
      for (int d = 0; d < g.dirs; ++d) out_comps[((size_t)img * g.dirs + d) * plane + o] = c[d];
    }
  }
}

// With NMS, once mag_ext and sector are complete: compare each in-image
// centre pixel with its two neighbours along its sector, store the thin map
// and the un-thinned magnitude (either may be null). Returns this thread's
// max of the un-thinned magnitude.
__device__ __forceinline__ float nms_suppress(const Geom& g, long long img, int tr, int tc,
                                              const float* mag_ext, const unsigned char* sector,
                                              float* __restrict__ out_primary,
                                              float* __restrict__ out_mag) {
  const int mw = g.bw + 2;
  const size_t plane = (size_t)g.h * g.w;
  float tmax = 0.0f;
  for (int q = threadIdx.x; q < g.bh * g.bw; q += THREADS) {
    const int oy = q / g.bw, ox = q - oy * g.bw;
    const int gy = tr * g.bh + oy, gx = tc * g.bw + ox;
    if (gy >= g.h || gx >= g.w) continue;
    const float* c = mag_ext + (oy + 1) * mw + (ox + 1);
    const float cv = c[0];
    float n1, n2;
    switch (sector[q]) {
      case 0: n1 = c[-1]; n2 = c[1]; break;
      case 1: n1 = c[-mw]; n2 = c[mw]; break;
      case 2: n1 = c[-mw - 1]; n2 = c[mw + 1]; break;
      default: n1 = c[-mw + 1]; n2 = c[mw - 1]; break;
    }
    const size_t o = (size_t)img * plane + (size_t)gy * g.w + gx;
    if (out_primary != nullptr) out_primary[o] = (cv >= n1 && cv >= n2) ? cv : 0.0f;
    if (out_mag != nullptr) out_mag[o] = cv;
    tmax = maxp(tmax, cv);
  }
  return tmax;
}

// The outputs of tile (img, tr, tc); every thread of the CTA calls it.
// Without NMS: out_primary gets the magnitude and out_comps the components
// (either may be null). With NMS: out_primary gets the thin map, out_comps
// the centre components, out_mag the un-thinned magnitude (each may be
// null). Returns this thread's max of the un-thinned magnitude over its
// in-image pixels (0 where it has none); meaningful only when need_max.
// A is the ladder's accumulator: float, or int32_t for u8 gray input on
// the integer lane (the window is then staged as int32).
template <int K, typename T, typename A>
__device__ float edge_tile(const TapsT<A>& taps, const Geom& g, const T* __restrict__ x,
                           long long img, int tr, int tc, float* smem,
                           float* __restrict__ out_primary, float* __restrict__ out_comps,
                           float* __restrict__ out_mag, bool need_max) {
  static_assert(sizeof(A) == sizeof(float), "tile_smem_bytes sizes the window in 4-byte words");
  constexpr int R = K / 2;
  const int halo = R + g.nms;
  const int eh = g.bh + 2 * halo, ew = g.bw + 2 * halo;
  const int row0 = tr * g.bh - halo, col0 = tc * g.bw - halo;
  const size_t plane = (size_t)g.h * g.w;
  const T* xi = x + (size_t)img * plane * (g.rgb ? 3 : 1);
  const int tid = threadIdx.x;
  A* win = reinterpret_cast<A*>(smem);

  for (int idx = tid; idx < eh * ew; idx += THREADS) {
    const int ly = idx / ew, lx = idx - ly * ew;
    const int gy = row0 + ly, gx = col0 + lx;
    A v;
    if (g.padding == PAD_ZERO && (gy < 0 || gy >= g.h || gx < 0 || gx >= g.w)) {
      v = 0;
    } else {
      const int sy = boundary(gy, g.h, g.padding), sx = boundary(gx, g.w, g.padding);
      v = LoadVal<T, A>::at(xi, (size_t)sy * g.w + sx, g.rgb);
    }
    win[idx] = v;
  }
  __syncthreads();

  if (!g.nms) {
    float tmax = 0.0f;
    const bool need_mag = out_primary != nullptr || need_max;
    for (int q = tid; q < g.bh * g.bw; q += THREADS) {
      const int oy = q / g.bw, ox = q - oy * g.bw;
      const int gy = tr * g.bh + oy, gx = tc * g.bw + ox;
      if (gy >= g.h || gx >= g.w) continue;
      const PtrSrc<A> src{win + oy * ew + ox, ew};
      const PassRows<K, A, PtrSrc<A>> rows{taps, src};
      float c[4];
      components_f32<K, A>(taps, src, rows, g.variant, g.dirs, c);
      emit_pixel(g, img, gy, gx, c, out_primary, out_comps, need_mag, tmax);
    }
    return tmax;
  }

  // NMS: magnitude of the (bh+2) x (bw+2) inner tile, sectors of its centre.
  const int mh = g.bh + 2, mw = g.bw + 2;
  float* mag_ext = reinterpret_cast<float*>(win + eh * ew);
  unsigned char* sector = reinterpret_cast<unsigned char*>(mag_ext + mh * mw);
  for (int q = tid; q < mh * mw; q += THREADS) {
    const int ey = q / mw, ex = q - ey * mw;
    const PtrSrc<A> src{win + ey * ew + ex, ew};
    const PassRows<K, A, PtrSrc<A>> rows{taps, src};
    float c[4];
    components_f32<K, A>(taps, src, rows, g.variant, g.dirs, c);
    emit_inner(g, img, tr, tc, ey, ex, c, mag_ext, sector, out_comps);
  }
  __syncthreads();
  return nms_suppress(g, img, tr, tc, mag_ext, sector, out_primary, out_mag);
}

// The CTA's max of every thread's v (max is order-free, so exact); valid in
// thread 0. Every thread of the CTA calls it.
__device__ __forceinline__ float block_max(float v, float* warp_max) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = maxp(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = warp_max[0];
  for (int i = 1; i < THREADS / 32; ++i) m = maxp(m, warp_max[i]);
  return m;
}

// (img, tile row, tile col) of this CTA; tiles are numbered like bmax's
// (n, gh, gw) layout, so blockIdx.x also indexes bmax and the stream mask.
__device__ __forceinline__ void tile_of(const Geom& g, long long* img, int* tr, int* tc) {
  long long b = blockIdx.x;
  *tc = (int)(b % g.gw);
  b /= g.gw;
  *tr = (int)(b % g.gh);
  *img = b / g.gh;
}

// The helpers every library exports beside its launch entry (one copy per
// library: each source compiles into its own shared object).
extern "C" int repro_taps_len(void) { return (int)(sizeof(Taps) / sizeof(float)); }

extern "C" int repro_max_size(void) { return KMAX; }

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
