// K1 on Hopper: the fused multi-directional edge kernel.
//
// Replaces repro/kernels/edge.py::_kernel (the Pallas K1 body, together with
// what it inlines: _emit_outputs, tiling.extend_tile, tiling.luma,
// core/sobel.spec_components and core/sobel.magnitude).
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 with FMA, about half that
// in separate multiplies and adds, which --fmad=false forces), as counted by
// chip_smoke.py (bound, kernel_ops_per_pixel): sobel5, v2, 4 directions
// needs 73 f32 operations per pixel, 78 with the RGB luma. A 4x2048x2048 f32
// request moves 8 B/px (134 MB, 40.1 us) against 36.6 us of operations, so
// it is bound by bytes; 4x1080x1920 RGB u8 moves 7 B/px (17.3 us) against
// 19.3 us of operations, so it is bound by operations.
//
// Design (simple and right first): one CTA per (image, tile row, tile col).
// The CTA stages its (bh+2r) x (bw+2r) halo window in shared memory as f32,
// applying the BT.601 luma (RGB) or the cast (gray) and the boundary rule
// (reflect / edge / zero) as index arithmetic while it loads. Each thread
// then computes its output pixels from shared memory, doing exactly the f32
// operations of spec_components for the chosen variant, in the same order:
// zero taps skipped, +-1 taps without a multiply, left-to-right sums. The
// row passes are recomputed per output pixel rather than shared; that costs
// arithmetic, not bits. The CTA's max over its in-image pixels is reduced
// with warp shuffles (max is order-free, so exact) and stored per block.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// --fmad=false keeps every product and sum separately rounded (the
// reference's max(., -FLT_MAX) fence); no --use_fast_math, so sqrtf is IEEE.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

template <int K, typename T>
__global__ void __launch_bounds__(THREADS)
edge_kernel(const T* __restrict__ x, int rgb, int h, int w, int bh, int bw,
            int gh, int gw, int variant, int dirs, int padding,
            float* __restrict__ out_mag, float* __restrict__ out_comps,
            float* __restrict__ out_bmax, const __grid_constant__ Taps taps) {
  constexpr int R = K / 2;
  extern __shared__ float win[];
  __shared__ float warp_max[THREADS / 32];

  const int eh = bh + 2 * R, ew = bw + 2 * R;
  long long b = blockIdx.x;
  const int tc = (int)(b % gw);
  b /= gw;
  const int tr = (int)(b % gh);
  const long long img = b / gh;
  const int row0 = tr * bh - R, col0 = tc * bw - R;
  const size_t plane = (size_t)h * w;
  const T* xi = x + (size_t)img * plane * (rgb ? 3 : 1);
  const int tid = threadIdx.x;

  for (int idx = tid; idx < eh * ew; idx += THREADS) {
    const int ly = idx / ew, lx = idx - ly * ew;
    const int gy = row0 + ly, gx = col0 + lx;
    float v;
    if (padding == PAD_ZERO && (gy < 0 || gy >= h || gx < 0 || gx >= w)) {
      v = 0.0f;
    } else {
      const int sy = boundary(gy, h, padding), sx = boundary(gx, w, padding);
      v = load_gray<T>(xi, (size_t)sy * w + sx, rgb);
    }
    win[idx] = v;
  }
  __syncthreads();

  const bool need_mag = out_mag != nullptr || out_bmax != nullptr;
  float tmax = 0.0f;
  for (int q = tid; q < bh * bw; q += THREADS) {
    const int oy = q / bw, ox = q - oy * bw;
    const int gy = tr * bh + oy, gx = tc * bw + ox;
    if (gy >= h || gx >= w) continue;
    float g[4];
    components<K>(taps, win + oy * ew + ox, ew, variant, dirs, g);
    const size_t o = (size_t)gy * w + gx;
    if (out_comps != nullptr) {
      for (int d = 0; d < dirs; ++d) out_comps[((size_t)img * dirs + d) * plane + o] = g[d];
    }
    if (need_mag) {
      float m = g[0] * g[0];
      m = m + g[1] * g[1];
      if (dirs == 4) {
        m = m + g[2] * g[2];
        m = m + g[3] * g[3];
      }
      m = sqrtf(m);
      if (out_mag != nullptr) out_mag[(size_t)img * plane + o] = m;
      tmax = maxp(tmax, m);
    }
  }

  if (out_bmax != nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      tmax = maxp(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    }
    if ((tid & 31) == 0) warp_max[tid >> 5] = tmax;
    __syncthreads();
    if (tid == 0) {
      float m = warp_max[0];
      for (int i = 1; i < THREADS / 32; ++i) m = maxp(m, warp_max[i]);
      out_bmax[blockIdx.x] = m;
    }
  }
}

template <int K, typename T>
static cudaError_t launch(const void* x, int rgb, int n, int h, int w, int bh, int bw,
                          int variant, int dirs, int padding, float* mag, float* comps,
                          float* bmax, const Taps& taps, cudaStream_t stream) {
  constexpr int R = K / 2;
  const int gh = (h + bh - 1) / bh, gw = (w + bw - 1) / bw;
  const size_t smem = (size_t)(bh + 2 * R) * (bw + 2 * R) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(edge_kernel<K, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)n * gh * gw;
  edge_kernel<K, T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const T*)x, rgb, h, w, bh, bw, gh, gw, variant, dirs, padding, mag, comps, bmax, taps);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_size(int size, const void* x, int rgb, int n, int h, int w, int bh,
                               int bw, int variant, int dirs, int padding, float* mag,
                               float* comps, float* bmax, const Taps& t, cudaStream_t s) {
  switch (size) {
    case 3: return launch<3, T>(x, rgb, n, h, w, bh, bw, variant, dirs, padding, mag, comps, bmax, t, s);
    case 5: return launch<5, T>(x, rgb, n, h, w, bh, bw, variant, dirs, padding, mag, comps, bmax, t, s);
    case 7: return launch<7, T>(x, rgb, n, h, w, bh, bw, variant, dirs, padding, mag, comps, bmax, t, s);
    case 9: return launch<9, T>(x, rgb, n, h, w, bh, bw, variant, dirs, padding, mag, comps, bmax, t, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int repro_edge_taps_len(void) { return (int)(sizeof(Taps) / sizeof(float)); }

extern "C" int repro_edge_max_size(void) { return KMAX; }

extern "C" const char* repro_edge_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches K1 on `stream`. x is (n, h, w) or (n, h, w, 3) u8 (in_u8 = 1) or
// f32; mag (n, h, w), comps (n, dirs, h, w) and bmax (n, gh, gw) are f32 and
// may each be null. Returns the launch's cudaError_t.
extern "C" int repro_edge_launch(const void* x, int in_u8, int rgb, int n, int h, int w,
                                 int bh, int bw, int size, int variant, int dirs, int padding,
                                 const float* taps_host, float* mag, float* comps, float* bmax,
                                 void* stream) {
  Taps t;
  memcpy(&t, taps_host, sizeof(Taps));
  cudaStream_t s = (cudaStream_t)stream;
  if (in_u8) {
    return (int)launch_size<uint8_t>(size, x, rgb, n, h, w, bh, bw, variant, dirs, padding,
                                     mag, comps, bmax, t, s);
  }
  return (int)launch_size<float>(size, x, rgb, n, h, w, bh, bw, variant, dirs, padding, mag,
                                 comps, bmax, t, s);
}
