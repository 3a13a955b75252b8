// The per-tile compute shared by K1 (edge.cu) and K3 (edge_stream.cu).
//
// One CTA owns one bh x bw output tile. edge_tile() stages the tile's halo
// window in shared memory as f32, applying the BT.601 luma (RGB) or the cast
// (gray) and the boundary rule (reflect / edge / zero) as index arithmetic
// while it loads, then computes the tile's outputs from shared memory with
// exactly the f32 operations of repro_torch.core.sobel.spec_components, in
// the same order: zero taps skipped, +-1 taps without a multiply,
// left-to-right sums. Row passes are recomputed per pixel rather than
// shared; that costs arithmetic, not bits.
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
// in this field order (all f32, so the struct is a flat float array).
struct Taps {
  float dense[4][KMAX * KMAX];  // row-major dense banks K_x, K_y, K_d, K_dt
  float col[2][KMAX];           // separable column factors of K_x, K_y
  float row[2][KMAX];           // separable row factors of K_x, K_y
  float col_f[KMAX];            // Eq. 18 split of K_d-
  float col_d[KMAX];
  float row_d[KMAX];
  float sym[2][KMAX][KMAX];     // distinct row vectors of K_d+ (0), K_d- (1)
  float sym_pass[2][KMAX];      // per dense row: index into sym, -1 = zero row
  float sym_neg[2][KMAX];       // per dense row: 1 = negation of its pass
};

// Geometry and options of one launch.
struct Geom {
  int rgb, h, w, bh, bw, gh, gw, variant, dirs, padding, nms;
  float tan_pi8;  // f32 rounding of tan(pi/8), from core/nms.TAN_PI8_F32
};

__device__ __forceinline__ float tap(float w, float v) {
  return w == 1.0f ? v : (w == -1.0f ? -v : w * v);
}

// NaN-propagating max, like the reference's jnp.max.
__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Horizontal pass at one pixel: sum_t taps[t] * p[t].
template <int K>
__device__ __forceinline__ float hpass(const float* taps, const float* p) {
  float acc = 0.0f;
  bool any = false;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const float w = taps[t];
    if (w != 0.0f) {
      const float term = tap(w, p[t]);
      acc = any ? acc + term : term;
      any = true;
    }
  }
  return acc;
}

// Vertical pass over K row-pass values: sum_t taps[t] * v[t].
template <int K>
__device__ __forceinline__ float vsum(const float* taps, const float (&v)[K]) {
  float acc = 0.0f;
  bool any = false;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const float w = taps[t];
    if (w != 0.0f) {
      const float term = tap(w, v[t]);
      acc = any ? acc + term : term;
      any = true;
    }
  }
  return acc;
}

// Dense correlation at one pixel, taps in row-major order.
template <int K>
__device__ __forceinline__ float corr2d(const float* taps, const float* p, int ws) {
  float acc = 0.0f;
  bool any = false;
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float w = taps[i * KMAX + j];
      if (w != 0.0f) {
        const float term = tap(w, p[i * ws + j]);
        acc = any ? acc + term : term;
        any = true;
      }
    }
  }
  return acc;
}

// core/sobel._sym_rowpass at one pixel: one pass per distinct row vector,
// negated rows subtracted. Recomputing a pass per row gives the same bits
// as reusing it.
template <int K>
__device__ __forceinline__ float symrow(const Taps& T, int s, const float* p, int ws) {
  float acc = 0.0f;
  bool any = false;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int pid = (int)T.sym_pass[s][i];
    if (pid < 0) continue;
    const float v = hpass<K>(T.sym[s][pid], p + i * ws);
    const bool neg = T.sym_neg[s][i] != 0.0f;
    if (!any) {
      acc = neg ? -v : v;
    } else {
      acc = neg ? acc - v : acc + v;
    }
    any = true;
  }
  return acc;
}

// core/sobel.spec_components at one pixel; p is the stencil's top-left corner.
template <int K>
__device__ __forceinline__ void components(const Taps& T, const float* p, int ws,
                                           int variant, int dirs, float g[4]) {
  if (variant == V_DIRECT) {
    g[0] = corr2d<K>(T.dense[0], p, ws);
    g[1] = corr2d<K>(T.dense[1], p, ws);
    if (dirs == 4) {
      g[2] = corr2d<K>(T.dense[2], p, ws);
      g[3] = corr2d<K>(T.dense[3], p, ws);
    }
    return;
  }
  float f[K], s[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    f[i] = hpass<K>(T.row[0], p + i * ws);
    s[i] = hpass<K>(T.row[1], p + i * ws);
  }
  g[0] = vsum<K>(T.col[0], f);
  g[1] = vsum<K>(T.col[1], s);
  if (dirs == 2) return;
  if (variant == V_SEPARABLE) {
    g[2] = corr2d<K>(T.dense[2], p, ws);
    g[3] = corr2d<K>(T.dense[3], p, ws);
    return;
  }
  const float gp = symrow<K>(T, 0, p, ws);
  float gm;
  if (variant == V_V1) {
    gm = symrow<K>(T, 1, p, ws);
  } else {
    float d[K];
#pragma unroll
    for (int i = 0; i < K; ++i) d[i] = hpass<K>(T.row_d, p + i * ws);
    gm = vsum<K>(T.col_f, f) - vsum<K>(T.col_d, d);
  }
  g[2] = (gp + gm) * 0.5f;
  g[3] = (gp - gm) * 0.5f;
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

// Dynamic shared memory edge_tile() needs: the f32 halo window, and with NMS
// the inner tile's magnitude and a sector byte per centre pixel.
__host__ __device__ inline size_t tile_smem_bytes(int bh, int bw, int radius, int nms) {
  const int halo = radius + (nms ? 1 : 0);
  size_t bytes = (size_t)(bh + 2 * halo) * (bw + 2 * halo) * sizeof(float);
  if (nms) bytes += (size_t)(bh + 2) * (bw + 2) * sizeof(float) + (size_t)bh * bw;
  return bytes;
}

// The outputs of tile (img, tr, tc); every thread of the CTA calls it.
// Without NMS: out_primary gets the magnitude and out_comps the components
// (either may be null). With NMS: out_primary gets the thin map, out_comps
// the centre components, out_mag the un-thinned magnitude (each may be
// null). Returns this thread's max of the un-thinned magnitude over its
// in-image pixels (0 where it has none); meaningful only when need_max.
template <int K, typename T>
__device__ float edge_tile(const Taps& taps, const Geom& g, const T* __restrict__ x,
                           long long img, int tr, int tc, float* smem,
                           float* __restrict__ out_primary, float* __restrict__ out_comps,
                           float* __restrict__ out_mag, bool need_max) {
  constexpr int R = K / 2;
  const int halo = R + g.nms;
  const int eh = g.bh + 2 * halo, ew = g.bw + 2 * halo;
  const int row0 = tr * g.bh - halo, col0 = tc * g.bw - halo;
  const size_t plane = (size_t)g.h * g.w;
  const T* xi = x + (size_t)img * plane * (g.rgb ? 3 : 1);
  const int tid = threadIdx.x;
  float* win = smem;

  for (int idx = tid; idx < eh * ew; idx += THREADS) {
    const int ly = idx / ew, lx = idx - ly * ew;
    const int gy = row0 + ly, gx = col0 + lx;
    float v;
    if (g.padding == PAD_ZERO && (gy < 0 || gy >= g.h || gx < 0 || gx >= g.w)) {
      v = 0.0f;
    } else {
      const int sy = boundary(gy, g.h, g.padding), sx = boundary(gx, g.w, g.padding);
      v = load_gray<T>(xi, (size_t)sy * g.w + sx, g.rgb);
    }
    win[idx] = v;
  }
  __syncthreads();

  float tmax = 0.0f;
  if (!g.nms) {
    const bool need_mag = out_primary != nullptr || need_max;
    for (int q = tid; q < g.bh * g.bw; q += THREADS) {
      const int oy = q / g.bw, ox = q - oy * g.bw;
      const int gy = tr * g.bh + oy, gx = tc * g.bw + ox;
      if (gy >= g.h || gx >= g.w) continue;
      float c[4];
      components<K>(taps, win + oy * ew + ox, ew, g.variant, g.dirs, c);
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
    return tmax;
  }

  // NMS: magnitude of the (bh+2) x (bw+2) inner tile, sectors of its centre.
  const int mh = g.bh + 2, mw = g.bw + 2;
  float* mag_ext = win + eh * ew;
  unsigned char* sector = reinterpret_cast<unsigned char*>(mag_ext + mh * mw);
  for (int q = tid; q < mh * mw; q += THREADS) {
    const int ey = q / mw, ex = q - ey * mw;
    float c[4];
    components<K>(taps, win + ey * ew + ex, ew, g.variant, g.dirs, c);
    mag_ext[q] = magnitude(c, g.dirs);
    if (ey >= 1 && ey <= g.bh && ex >= 1 && ex <= g.bw) {
      const int oy = ey - 1, ox = ex - 1;
      sector[oy * g.bw + ox] = (unsigned char)sector_of(c, g.dirs, g.tan_pi8);
      const int gy = tr * g.bh + oy, gx = tc * g.bw + ox;
      if (out_comps != nullptr && gy < g.h && gx < g.w) {
        const size_t o = (size_t)gy * g.w + gx;
        for (int d = 0; d < g.dirs; ++d) out_comps[((size_t)img * g.dirs + d) * plane + o] = c[d];
      }
    }
  }
  __syncthreads();

  for (int q = tid; q < g.bh * g.bw; q += THREADS) {
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
