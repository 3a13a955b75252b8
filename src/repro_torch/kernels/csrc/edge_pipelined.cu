// K2 on Hopper: the DMA-ring edge kernel.
//
// Replaces repro/kernels/edge.py::_pipelined_kernel, the Pallas body that
// edge_pallas(pipeline_depth=2..8) launches: K1's math, bit for bit, with the
// input left in device memory, a depth-N ring of raw input windows filled
// ahead of the compute, and the separable row passes F, S (and v2's D)
// spilled to scratch and read back by the column passes (_sink_slots).
//
// Design (simple and right first):
//   * Grid: one CTA per (image, tile row). It walks its tiles j = 0..gw-1 in
//     order, as the reference's sequential grid does. Before tile 0 it starts
//     the copies of windows 0..depth-2; at step j it starts window j+depth-1
//     into slot (j+depth-1) % depth, waits for window j, computes tile j from
//     slot j % depth, and ends the step with __syncthreads() so that the slot
//     is free before step j+1 refills it. Each step commits one cp.async
//     group (empty once the row has no more windows), so waiting for window j
//     is always "all but the depth-1 newest groups", also when gw < depth.
//   * The ring holds the raw window (u8 or f32, gray or RGB) at the clamped
//     origin tiling.window_origin gives for the window radius
//     R_in = R (+1 with NMS), at its unclamped size (bh + 2 R_in) x
//     (bw + 2 R_in). Copies are 4-byte cp.async. An f32 row starts on a
//     4-byte boundary and is copied word by word. A u8 row starts anywhere:
//     the ring row keeps the source's offset within its first word (the
//     "lead", 0..3), the whole words inside the row go by cp.async, and the
//     bytes of the row in the first and last partial words are loaded and
//     stored by plain instructions. No byte outside the image row is read.
//   * The luma (RGB), the cast and the boundary rule apply when the tile is
//     read out of the ring: per tile, a byte offset for each row and each
//     column of the boundary-extended tile (-1 for a zero-padded row or
//     column) maps an extended-tile coordinate to its ring byte.
//   * The tile is computed in strips of STRIP ladder rows (a whole-tile
//     sink of a 64 x 256 tile does not fit beside the ring). A strip reads
//     its STRIP + 2R rows of the extended tile out of the ring once, as the
//     ladder's input type (f32, or int32 on the integer lane), computes the
//     row passes from them once per pixel into a sink in the same type, and
//     the column passes read the sink back. Each value is the same sequence
//     of separately rounded operations as in K1, so the bits are K1's.
//     direct has no row passes; separable and v1 compute their diagonal
//     passes from the strip as K1 does from its window.
//   * Outputs, the NMS inner tile and suppression, and the per-tile max are
//     edge_tile.cuh's helpers, as in K1. The integer lane (acc_int) runs the
//     ladder, its taps and the sink in int32 for u8 gray input.
//
// Shared memory: pipelined_layout() below, mirrored by
// repro_torch/kernels/edge.py::pipelined_smem_bytes (chip_smoke.py and the
// gpu tests compare the two through repro_pipelined_smem_bytes); a
// footprint above 232,448 B is refused, never shrunk.
//
// Bound on an H100 SXM: the same bytes and operations as K1 (each input
// byte read once, each output written once; chip_smoke.py counts them), so
// a 4x2048x2048 f32 call is bound by bytes and the int lane by 32-bit
// integer operations (64 lanes per SM, half the f32 rate).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// (every product and sum separately rounded; no --use_fast_math).

#include <stdint.h>
#include <string.h>

#include "edge_tile.cuh"

#define STRIP 16            // ladder output rows per row-pass strip
#define SMEM_MAX 232448     // dynamic shared memory one CTA may opt into

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// Byte offsets of K2's dynamic shared memory, and the sizes they derive from.
struct Layout {
  int row_stride;  // bytes per ring row (a multiple of 4)
  int slot_bytes;  // bytes per ring slot (a multiple of 16)
  int eh, ew;      // the boundary-extended tile: (mh + 2R) x (mw + 2R)
  int mh, mw;      // the ladder's output: the tile, or with NMS its inner tile
  int n_sink, sink_rows;  // row-pass planes; rows of a strip with its halo
  size_t ring, rowoff, coloff, strip, sink, mag, sector, total;
};

__host__ __device__ inline Layout pipelined_layout(int bh, int bw, int radius, int depth,
                                                   int in_bytes, int channels, int nms,
                                                   int variant, int dirs) {
  Layout L;
  const int r_in = radius + nms;
  const int wh = bh + 2 * r_in, ww = bw + 2 * r_in;
  L.row_stride = (ww * channels * in_bytes + (in_bytes == 1 ? 3 : 0) + 3) & ~3;
  L.slot_bytes = (int)align16((size_t)wh * L.row_stride);
  L.mh = bh + 2 * nms;
  L.mw = bw + 2 * nms;
  L.eh = wh;
  L.ew = ww;
  L.n_sink = variant == V_DIRECT ? 0 : ((variant == V_V2 && dirs != 2) ? 3 : 2);
  L.sink_rows = (L.mh < STRIP ? L.mh : STRIP) + 2 * radius;
  size_t off = 0;
  L.ring = off;
  off += (size_t)depth * L.slot_bytes;
  L.rowoff = off;
  off = align16(off + sizeof(int) * (size_t)L.eh);
  L.coloff = off;
  off = align16(off + sizeof(int) * (size_t)L.ew);
  L.strip = off;
  off = align16(off + sizeof(float) * (size_t)L.sink_rows * L.ew);
  L.sink = off;
  off = align16(off + sizeof(float) * (size_t)L.n_sink * L.sink_rows * L.mw);
  L.mag = L.sector = off;
  if (nms) {
    off = align16(off + sizeof(float) * (size_t)L.mh * L.mw);
    L.sector = off;
    off = align16(off + (size_t)bh * bw);
  }
  L.total = off;
  return L;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most n of this thread's newest cp.async groups are pending.
__device__ __forceinline__ void cp_async_wait_prior(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// The first byte of window row y: image row row0 + y at column col0.
template <typename T>
__device__ __forceinline__ const unsigned char* window_row(const T* xi, int w, int ch, int row0,
                                                           int col0, int y) {
  return reinterpret_cast<const unsigned char*>(xi + ((size_t)(row0 + y) * w + col0) * ch);
}

// Start the copy of the th x tw window at (row0, col0) into a ring slot.
// Ring row y holds the window row from byte lead(y) = (its address & 3) on.
template <typename T>
__device__ void copy_window(const T* xi, const Geom& g, int row0, int col0, int th, int tw,
                            unsigned char* slot, int row_stride) {
  const int ch = g.rgb ? 3 : 1;
  const long long row_bytes = (long long)tw * ch * sizeof(T);
  const int words = row_stride / 4;
  for (int q = threadIdx.x; q < th * words; q += THREADS) {
    const int y = q / words, wi = q - y * words;
    const unsigned char* a0 = window_row(xi, g.w, ch, row0, col0, y);
    const long long lo = 4LL * wi - (long long)((uintptr_t)a0 & 3);  // word start, row-relative
    if (lo >= row_bytes) continue;
    const unsigned char* src = a0 + lo;
    unsigned char* dst = slot + (size_t)y * row_stride + 4 * wi;
    if (lo >= 0 && lo + 4 <= row_bytes) {
      cp_async4(dst, src);
    } else {
      for (int b = 0; b < 4; ++b) {
        if (lo + b >= 0 && lo + b < row_bytes) dst[b] = src[b];
      }
    }
  }
}

// The ladder's input at one extended-tile position, read out of a ring
// slot through its row and column byte offsets; 0 where either is a zero
// pad (-1).
template <typename T, typename A>
__device__ __forceinline__ A ring_value(const unsigned char* slot, int r, int c, int rgb) {
  if ((r | c) < 0) return 0;
  return LoadVal<T, A>::at(reinterpret_cast<const T*>(slot + r + c), 0, rgb);
}

// The row passes F, S, D of the current strip, read back from the sink:
// planes of sink_rows x mw values, base at the pixel's first stencil row.
template <typename A>
struct SinkRows {
  const A* base;
  int plane, stride;
  __device__ __forceinline__ A f(int i) const { return base[i * stride]; }
  __device__ __forceinline__ A s(int i) const { return base[plane + i * stride]; }
  __device__ __forceinline__ A d(int i) const { return base[2 * plane + i * stride]; }
};

template <int K, typename T, typename A>
__global__ void __launch_bounds__(THREADS)
pipelined_kernel(const T* __restrict__ x, const Geom g, const int depth,
                 float* __restrict__ out_primary, float* __restrict__ out_comps,
                 float* __restrict__ out_mag, float* __restrict__ out_bmax,
                 const __grid_constant__ TapsT<A> taps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float warp_max[THREADS / 32];
  constexpr int R = K / 2;
  const int ch = g.rgb ? 3 : 1;
  const Layout L = pipelined_layout(g.bh, g.bw, R, depth, (int)sizeof(T), ch, g.nms, g.variant,
                                    g.dirs);
  const int r_in = R + g.nms;
  const int th = min(L.eh, g.h), tw = min(L.ew, g.w);
  const int tr = (int)(blockIdx.x % g.gh);
  const long long img = blockIdx.x / g.gh;
  const T* xi = x + (size_t)img * g.h * g.w * ch;
  const int row0 = clampi(tr * g.bh - r_in, 0, g.h - th);
  int* rowoff = reinterpret_cast<int*>(smem + L.rowoff);
  int* coloff = reinterpret_cast<int*>(smem + L.coloff);
  A* strip = reinterpret_cast<A*>(smem + L.strip);
  A* sink = reinterpret_cast<A*>(smem + L.sink);
  float* mag_ext = reinterpret_cast<float*>(smem + L.mag);
  unsigned char* sector = smem + L.sector;
  const int sink_plane = L.sink_rows * L.mw;
  const int tid = threadIdx.x;

  // Window jw -> slot jw % depth; one commit group per call, empty past gw.
  auto start_window = [&](int jw) {
    if (jw < g.gw) {
      const int col0 = clampi(jw * g.bw - r_in, 0, g.w - tw);
      copy_window<T>(xi, g, row0, col0, th, tw, smem + L.ring + (size_t)(jw % depth) * L.slot_bytes,
                     L.row_stride);
    }
    cp_async_commit();
  };

  for (int a = 0; a < depth - 1; ++a) start_window(a);
  for (int j = 0; j < g.gw; ++j) {
    start_window(j + depth - 1);

    // Byte offsets of the extended tile's rows and columns in window j.
    const int col0 = clampi(j * g.bw - r_in, 0, g.w - tw);
    for (int q = tid; q < L.eh; q += THREADS) {
      const int gy = tr * g.bh - r_in + q;
      int v = -1;
      if (g.padding != PAD_ZERO || (gy >= 0 && gy < g.h)) {
        const int sy = clampi(boundary(gy, g.h, g.padding) - row0, 0, th - 1);
        v = sy * L.row_stride + (int)((uintptr_t)window_row(xi, g.w, ch, row0, col0, sy) & 3);
      }
      rowoff[q] = v;
    }
    for (int q = tid; q < L.ew; q += THREADS) {
      const int gx = j * g.bw - r_in + q;
      int v = -1;
      if (g.padding != PAD_ZERO || (gx >= 0 && gx < g.w)) {
        const int sx = clampi(boundary(gx, g.w, g.padding) - col0, 0, tw - 1);
        v = sx * ch * (int)sizeof(T);
      }
      coloff[q] = v;
    }
    cp_async_wait_prior(depth - 1);  // this thread's copies of window j have landed
    __syncthreads();                 // and everyone's, and the offsets are written

    const unsigned char* slot = smem + L.ring + (size_t)(j % depth) * L.slot_bytes;
    const bool need_mag = out_primary != nullptr || out_bmax != nullptr;
    float tmax = 0.0f;
    for (int s0 = 0; s0 < L.mh; s0 += STRIP) {
      const int sh = min(STRIP, L.mh - s0);
      // Extended-tile rows s0 .. s0 + sh + 2R - 1 out of the ring.
      for (int q = tid; q < (sh + 2 * R) * L.ew; q += THREADS) {
        const int rr = q / L.ew, ex = q - rr * L.ew;
        strip[q] = ring_value<T, A>(slot, rowoff[s0 + rr], coloff[ex], g.rgb);
      }
      __syncthreads();
      if (L.n_sink) {
        for (int q = tid; q < (sh + 2 * R) * L.mw; q += THREADS) {
          const int rr = q / L.mw, ox = q - rr * L.mw;
          const PtrSrc<A> src{strip + rr * L.ew + ox, L.ew};
          A* at = sink + rr * L.mw + ox;
          at[0] = hpass<K, A>(taps.row[0], src, 0);
          at[sink_plane] = hpass<K, A>(taps.row[1], src, 0);
          if (L.n_sink == 3) at[2 * sink_plane] = hpass<K, A>(taps.row_d, src, 0);
        }
        __syncthreads();
      }
      for (int q = tid; q < sh * L.mw; q += THREADS) {
        const int rr = q / L.mw, ox = q - rr * L.mw;
        const int ey = s0 + rr;
        const int gy = tr * g.bh + ey, gx = j * g.bw + ox;
        if (!g.nms && (gy >= g.h || gx >= g.w)) continue;
        const PtrSrc<A> src{strip + rr * L.ew + ox, L.ew};
        const SinkRows<A> rows{sink + rr * L.mw + ox, sink_plane, L.mw};
        float c[4];
        components_f32<K, A>(taps, src, rows, g.variant, g.dirs, c);
        if (g.nms) {
          emit_inner(g, img, tr, j, ey, ox, c, mag_ext, sector, out_comps);
        } else {
          emit_pixel(g, img, gy, gx, c, out_primary, out_comps, need_mag, tmax);
        }
      }
      __syncthreads();  // the next strip rewrites the strip and the sink
    }
    if (g.nms) tmax = nms_suppress(g, img, tr, j, mag_ext, sector, out_primary, out_mag);
    if (out_bmax != nullptr) {
      const float m = block_max(tmax, warp_max);
      if (tid == 0) out_bmax[((size_t)img * g.gh + tr) * g.gw + j] = m;
    }
    __syncthreads();  // slot j % depth, the offsets and mag_ext are free again
  }
  cp_async_wait<0>();
}

template <int K, typename T, typename A>
static cudaError_t launch(const void* x, int n, const Geom& g, int depth, float* primary,
                          float* comps, float* mag, float* bmax, const TapsT<A>& taps,
                          cudaStream_t stream) {
  const Layout L = pipelined_layout(g.bh, g.bw, K / 2, depth, (int)sizeof(T), g.rgb ? 3 : 1,
                                    g.nms, g.variant, g.dirs);
  if (L.total > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(pipelined_kernel<K, T, A>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)n * g.gh;
  pipelined_kernel<K, T, A><<<(unsigned)blocks, THREADS, L.total, stream>>>(
      (const T*)x, g, depth, primary, comps, mag, bmax, taps);
  return cudaGetLastError();
}

// K2's dynamic shared memory in bytes, as pipelined_layout computes it.
extern "C" long long repro_pipelined_smem_bytes(int bh, int bw, int radius, int depth,
                                                int in_bytes, int channels, int nms, int variant,
                                                int dirs) {
  return (long long)pipelined_layout(bh, bw, radius, depth, in_bytes, channels, nms, variant,
                                     dirs).total;
}

// Launches K2 on `stream`: arguments and outputs as repro_edge_launch
// (csrc/edge.cu), plus the ring depth (2..8). Returns the launch's
// cudaError_t.
extern "C" int repro_pipelined_launch(const void* x, int in_u8, int rgb, int n, int h, int w,
                                      int bh, int bw, int size, int variant, int dirs,
                                      int padding, int nms, float tan_pi8, const float* taps_host,
                                      int acc_int, int depth, float* primary, float* comps,
                                      float* mag, float* bmax, void* stream) {
  if (depth < 2 || depth > 8) return (int)cudaErrorInvalidValue;
  Taps t;
  memcpy(&t, taps_host, sizeof(Taps));
  cudaStream_t s = (cudaStream_t)stream;
  const Geom g = {rgb, h, w, bh, bw, (h + bh - 1) / bh, (w + bw - 1) / bw,
                  variant, dirs, padding, nms, tan_pi8};
  if (acc_int) {
    if (!in_u8 || rgb) return (int)cudaErrorInvalidValue;
    const TapsT<int32_t> ti = int_taps(t);
    REPRO_SWITCH_SIZE(size, ((int)launch<KS, uint8_t, int32_t>(x, n, g, depth, primary, comps,
                                                               mag, bmax, ti, s)))
  }
  if (in_u8) {
    REPRO_SWITCH_SIZE(size, ((int)launch<KS, uint8_t, float>(x, n, g, depth, primary, comps, mag,
                                                             bmax, t, s)))
  }
  REPRO_SWITCH_SIZE(size, ((int)launch<KS, float, float>(x, n, g, depth, primary, comps, mag,
                                                         bmax, t, s)))
}
