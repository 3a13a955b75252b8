// K2 on Hopper: the prefetching edge kernel (the paper's §4.3.4).
//
// Replaces repro/kernels/edge.py::_pipelined_kernel, the Pallas body that
// edge_pallas(pipeline_depth=2..8) launches: K1's math, bit for bit, with the
// input left in device memory and a depth-N ring of raw input windows filled
// ahead of the compute.
//
// What held the first version back (tools/profile_k2.py on an H100 80GB
// HBM3 at 700 W): one CTA per (image, tile row), 128 CTAs for 132 SMs at
// 4x2048x2048 on 64x256, each alone on its SM and walking its tiles in
// series; 4-byte cp.async copies; every row pass through a shared-memory
// sink in 16-row strips, its halo rows recomputed per strip; run-time taps
// only; NMS through shared buffers; and "wait for window j, then compute
// it" stalling the SM's one CTA at every tile: 1.43 ms, seven times K1 in
// the same call, of which the copies were ~0.05 ms and the strips, sink
// and ladder the rest.
//
// Design:
//   * Persistent grid: as many CTAs as fit on the SMs
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor), CTA b taking tiles
//     b, b + gridDim.x, ... of the whole batch in raster order, so that
//     neighbouring windows are copied close in time and share L2.
//   * A ring of `depth` slots holds the tiles' raw windows (u8 or f32, gray
//     or RGB), each slot with an mbarrier that completes when its window
//     has landed. Before its first tile a CTA starts the copies of its first
//     `depth` windows; as soon as a window has been read out of its slot,
//     the copy of the window `depth` tiles later starts into it, so the next
//     depth - 1 windows are in flight while a tile is walked. Where a gray
//     image's base and row pitch are 16-byte aligned, one elected thread
//     issues TMA box copies (cp.async.bulk.tensor.3d over (n, h, w), boxes
//     of at most 256 x 256 elements, each at a 128-byte boundary of the
//     slot; the tensor map is encoded on the host through
//     cudaGetDriverEntryPoint("cuTensorMapEncodeTiled")). A box must start
//     on 16 bytes (one that does not faults with an illegal instruction on
//     this card), so a window's boxes start up to 15 bytes left of it (its
//     "lead") and are that much wider; RGB rows would split pixels across
//     boxes that way and take the other route. Elsewhere each slot row holds
//     a window row from its source's offset within 16 bytes on, every
//     thread issues its share of 16-byte cp.async, the partial words at the
//     row's ends go by plain loads (no byte outside the image row is read),
//     and each thread arrives on the slot's mbarrier when its copies land.
//     The route is the caller's (kernels/edge.py decides it from the
//     shape); a failed encode returns an error. Bulk copies of each window
//     row (cp.async.bulk, no tensor map) were tried too: 68 requests a
//     window took as long as K1's whole staging and did not overlap the
//     walk. No warp is set
//     apart to copy: a CTA's 16 warps (at most) all walk, with 128
//     registers a thread (a 17th warp cuts them to 96, where K1's walk
//     spills).
//   * Each window lies inside the image at the clamped origin
//     tiling.window_origin gives for the window radius R_in = R (+1 with
//     NMS), at its unclamped size (bh + 2 R_in) x (bw + 2 R_in).
//   * The threads convert the slot into K1's window (the luma, the cast and
//     the boundary rule applied once per element, through per-tile row and
//     column byte offsets, -1 for a zero-padded row or column), refill the
//     slot, and walk the window with K1's walk (walk_column, its register
//     rings, compile-time taps where K1 has them, NMS in registers). Reading
//     the slot through the offsets inside the walk would repeat the cast,
//     the luma and the boundary test for every one of the K reads of an
//     element; a converted window costs a shared-to-shared pass and ring
//     depth, and keeps the walk K1's instruction for instruction.
//   * The threads are bands of tile_threads() threads, each band walking its
//     share of the tile's rows (the halo rows of a band boundary walked
//     twice), so that a CTA alone on its SM still has up to 16 warps.
//   * The per-tile maxima and every output keep K1's layout; the integer
//     lane (acc_int) stages an int32 window as K1 does.
//   * A stencil plan: the ring holds windows of the plan's composed reach,
//     and after the conversion all bands run the pre-stages on the window
//     (edge_tile.cuh, run_pre_stages) into one plane beside it and back
//     before they walk the last plane, in the same launch. At 64x256 with
//     NMS canny5's window and plane take 152 KB, so its ring fits u8 frames
//     at depths 2 and 3 and no f32 depth; a depth that does not fit is
//     refused, never lowered.
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
// Build: nvcc -gencode arch=compute_90a,code=[sm_90a,compute_90a] -O3 --fmad=false
// (every product and sum separately rounded; no --use_fast_math).

#include <cuda.h>  // CUtensorMap and the encoder's types only: nothing is linked
#include <stdint.h>
#include <string.h>

#include "edge_tile.cuh"

#define SMEM_MAX 232448        // dynamic shared memory one CTA may opt into
#define K2_CONSUMERS 512       // threads a CTA aims at (bands of tile_threads)
#define K2_CONSUMERS_WIDE 384  // the same for operators of size 7 and 9 (more registers)
#define K2_MAX_THREADS 512     // the largest CTA: K2_CONSUMERS, or one band of MAX_THREADS
#define K2_COPY 1              // 0 (a profiling variant) signals slots full without copying

// Threads a CTA aims at, and its launch bound, for operator size K: 128
// registers a thread for sizes 3 and 5, 170 for 7 and 9 (K1's
// run-time-taps walk of size 9 takes 135).
__host__ __device__ constexpr int k2_consumers(int k) {
  return k <= 5 ? K2_CONSUMERS : K2_CONSUMERS_WIDE;
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline size_t align_to(size_t b, size_t a) { return (b + a - 1) / a * a; }

// Byte offsets of K2's dynamic shared memory, and the sizes they derive from.
struct Layout {
  int eh, ew;        // the window, K1's: (bh + 2 R_in) x (bw + 2 R_in), R_in the reach (+1 NMS)
  int row_stride;    // cp.async route: bytes per slot row, a window row and its lead
  int box_w, box_h;  // TMA route (gray): box_w elements (16-byte units) x box_h
  int chunks;        //   rows, chunks x row_boxes boxes a window (up to 15
  int row_boxes;     //   bytes of lead included), chunk-major, each box_stride
  int box_stride;    //   bytes (128-aligned) after the last
  int slot_bytes;    // bytes per ring slot: the larger route, 128-aligned
  size_t rowoff, coloff, win, plane, warp_max, bars, layout, total;
};

// radius: the window's reach without NMS (the operator's radius, or a plan's
// composed reach); plane_words: the pre-stage plane (pre_plane_words).
__host__ __device__ inline Layout pipelined_layout(int bh, int bw, int radius, int depth,
                                                   int in_bytes, int channels, int nms,
                                                   int plane_words = 0) {
  Layout L;
  const int r_in = radius + nms;
  L.eh = bh + 2 * r_in;
  L.ew = bw + 2 * r_in;
  L.row_stride = (int)align_to((size_t)L.ew * channels * in_bytes + 15, 16);
  const int cp_slot = L.eh * L.row_stride;
  const int m = 16 / in_bytes;  // elements a 16-byte unit
  const int units = L.ew + m - 1;
  L.chunks = channels == 1 ? cdiv(units, 256 / m * m) : 0;  // RGB: no TMA route
  L.box_w = L.chunks ? cdiv(cdiv(units, L.chunks), m) * m : 0;
  L.row_boxes = cdiv(L.eh, 256);
  L.box_h = cdiv(L.eh, L.row_boxes);
  L.box_stride = (int)align_to((size_t)L.box_h * L.box_w * in_bytes, 128);
  const int tma_slot = L.chunks * L.row_boxes * L.box_stride;
  L.slot_bytes = (int)align_to((size_t)(tma_slot > cp_slot ? tma_slot : cp_slot), 128);
  L.rowoff = (size_t)depth * L.slot_bytes;
  L.coloff = align_to(L.rowoff + 4 * (size_t)L.eh, 16);
  L.win = align_to(L.coloff + 4 * (size_t)L.ew, 16);
  L.plane = align_to(L.win + 4 * (size_t)L.eh * L.ew, 16);
  L.warp_max = align_to(L.plane + 4 * (size_t)plane_words, 16);
  L.bars = L.warp_max + 2 * (K2_MAX_THREADS / 32) * sizeof(float);
  L.layout = align_to(L.bars + (size_t)depth * sizeof(uint64_t), 16);
  L.total = L.layout + 128;  // this struct, for the threads to read back
  return L;
}

// Bands of threads: k2_consumers(size) / tile_threads, at most one per 16
// rows of the tile, at least 1.
__host__ __device__ inline int pipelined_bands(int bh, int bw, int nms, int size) {
  int b = k2_consumers(size) / tile_threads(bw, nms);
  if (b > bh / 16) b = bh / 16;
  return b < 1 ? 1 : b;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Arrives on `bar` once this thread's earlier cp.async copies have landed
// (one of the init count's arrivals).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of `bar` with this parity has completed. The loop
// is the compiler's own, and the warp reconverges after it: its lanes may
// leave try_wait at different times, and the __syncthreads() that follows
// must not find the warp diverged.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
  __syncwarp();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Tile t of the batch (raster order, like bmax's (n, gh, gw) layout) and
// its window: image rows row0 .. row0 + th - 1, columns col0 .. col0 + tw - 1.
struct Window {
  long long img;
  int tr, tc, row0, col0, th, tw;
};

__device__ __forceinline__ Window window_of(const Geom& g, long long t, int r_in, int eh,
                                            int ew) {
  Window w;
  w.tc = (int)(t % g.gw);
  t /= g.gw;
  w.tr = (int)(t % g.gh);
  w.img = t / g.gh;
  w.th = min(eh, g.h);
  w.tw = min(ew, g.w);
  w.row0 = clampi(w.tr * g.bh - r_in, 0, g.h - w.th);
  w.col0 = clampi(w.tc * g.bw - r_in, 0, g.w - w.tw);
  return w;
}

// The cp.async route: window row y (image row row0 + y, elements u0 ..
// u0 + units - 1 of its pitch_units) into slot row y from its lead on; the
// CTA's threads split the rows' 16-byte words.
template <typename T>
__device__ __forceinline__ void copy_rows_async(const T* xi, int pitch_units, int row0, int u0,
                                                int th, int units, unsigned char* slot,
                                                int stride) {
  const int row_bytes = units * (int)sizeof(T);
  const int words = stride / 16;
  for (int q = threadIdx.x; q < th * words; q += blockDim.x) {
    const int y = q / words, wi = q - y * words;
    const unsigned char* a0 =
        reinterpret_cast<const unsigned char*>(xi + (size_t)(row0 + y) * pitch_units + u0);
    const int lo = 16 * wi - (int)((uintptr_t)a0 & 15);  // the word's first byte, row-relative
    if (lo >= row_bytes) continue;
    unsigned char* dst = slot + (size_t)y * stride + 16 * wi;
    if (lo >= 0 && lo + 16 <= row_bytes) {
      cp_async16(dst, a0 + lo);
    } else {
      for (int b = 0; b < 16; ++b) {
        if (lo + b >= 0 && lo + b < row_bytes) dst[b] = a0[lo + b];
      }
    }
  }
}

// Starts the copy of tile t's window into a slot: on the TMA route one
// thread's box copies (the slot's mbarrier expects their bytes); else every
// thread's share of cp.async words, each thread arriving when its copies
// land and once more to release its plain stores. Every thread of the CTA
// calls it.
template <typename T>
__device__ __forceinline__ void fill_slot(const T* __restrict__ x, const Geom& g,
                                          const Layout& L, int tma, const CUtensorMap* map,
                                          long long t, unsigned char* slot, uint64_t* full) {
  const int ch = g.rgb ? 3 : 1;
  const Window w = window_of(g, t, (L.eh - g.bh) / 2, L.eh, L.ew);
  if (tma) {
    if (threadIdx.x == 0) {
      // The CTA's reads of the slot (generic proxy) before TMA's writes.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const int c0 = w.col0 - w.col0 % (16 / (int)sizeof(T));  // 16-byte aligned
      mbar_arrive_tx(full, K2_COPY ? L.chunks * L.row_boxes * L.box_h * L.box_w *
                                         (int)sizeof(T)
                                   : 0);
      for (int c = 0; K2_COPY && c < L.chunks; ++c) {
        for (int rb = 0; rb < L.row_boxes; ++rb) {
          tma_load_3d(slot + (size_t)(c * L.row_boxes + rb) * L.box_stride, map, full,
                      c0 + c * L.box_w, w.row0 + rb * L.box_h, (int)w.img);
        }
      }
    }
    return;
  }
  if (K2_COPY) {
    copy_rows_async<T>(x + (size_t)w.img * g.h * g.w * ch, g.w * ch, w.row0, w.col0 * ch, w.th,
                       w.tw * ch, slot, L.row_stride);
  }
  mbar_arrive_cp_async(full);
  mbar_arrive(full);
}

// Row and column byte offsets of tile w's window in its slot (-1 for a
// zero-padded row or column): the boundary rule, mapped onto the clamped
// window, in the layout of the copy route.
template <typename T>
__device__ __forceinline__ void window_offsets(const Geom& g, const Layout& L, const Window& w,
                                               const T* xi, int tma, int* rowoff, int* coloff) {
  const int ch = g.rgb ? 3 : 1;
  const int es = (int)sizeof(T);
  const int r_in = (L.eh - g.bh) / 2;
  for (int q = threadIdx.x; q < L.eh; q += blockDim.x) {
    const int gy = w.tr * g.bh - r_in + q;
    int v = -1;
    if (g.padding != PAD_ZERO || (gy >= 0 && gy < g.h)) {
      const int sy = clampi(boundary(gy, g.h, g.padding) - w.row0, 0, w.th - 1);
      if (tma) {
        v = (sy / L.box_h) * L.box_stride + (sy % L.box_h) * L.box_w * es;
      } else {
        const T* a0 = xi + ((size_t)(w.row0 + sy) * g.w + w.col0) * ch;
        v = sy * L.row_stride + (int)((uintptr_t)a0 & 15);
      }
    }
    rowoff[q] = v;
  }
  for (int q = threadIdx.x; q < L.ew; q += blockDim.x) {
    const int gx = w.tc * g.bw - r_in + q;
    int v = -1;
    if (g.padding != PAD_ZERO || (gx >= 0 && gx < g.w)) {
      const int sx = clampi(boundary(gx, g.w, g.padding) - w.col0, 0, w.tw - 1);
      if (tma) {
        const int u = w.col0 % (16 / es) + sx;  // after the boxes' lead (gray)
        v = (u / L.box_w) * L.row_boxes * L.box_stride + (u % L.box_w) * es;
      } else {
        v = sx * ch * es;
      }
    }
    coloff[q] = v;
  }
}

// K1's window from a slot: element (r, c) is the ladder input at the slot
// byte rowoff[r] + coloff[c] (its luma or cast), 0 where either is -1.
template <typename T, typename A>
__device__ __forceinline__ void convert_window(const unsigned char* slot, const int* rowoff,
                                               const int* coloff, int eh, int ew, int rgb,
                                               A* win) {
  const int n = eh * ew, nt = blockDim.x;
  const int dy = nt / ew, dx = nt - dy * ew;
  int ly = threadIdx.x / ew, lx = threadIdx.x - ly * ew;
#pragma unroll 4
  for (int q = threadIdx.x; q < n; q += nt) {
    const int ro = rowoff[ly], co = coloff[lx];
    win[q] = (ro | co) < 0 ? A(0)
                           : LoadVal<T, A>::at(reinterpret_cast<const T*>(slot + ro + co), 0, rgb);
    lx += dx;
    ly += dy;
    if (lx >= ew) {
      lx -= ew;
      ++ly;
    }
  }
}

// This thread's walk of tile w: band `band` of the tile's rows, columns
// bt, bt + tt, ... (without NMS), or with NMS the warp's 30-column groups.
// Returns the thread's max of the un-thinned magnitude (0 where none).
template <int K, typename A, typename P>
__device__ __forceinline__ float walk_tile(const P& tp, const Geom& g, const Window& w,
                                           const A* win, int ew, int band, int bt, int tt,
                                           int rows_per_band, float* __restrict__ out_primary,
                                           float* __restrict__ out_comps,
                                           float* __restrict__ out_mag, bool need_max) {
  const int c0 = band * rows_per_band, c1 = min(g.bh, c0 + rows_per_band);
  float tmax = 0.0f;
  if (!g.nms) {
    const bool need_mag = out_primary != nullptr || need_max;
    const int yb = min(c1, g.h - w.tr * g.bh);
    const int cols = min(g.bw, g.w - w.tc * g.bw);
    for (int ex = bt; ex < cols && c0 < yb; ex += tt) {
      EmitPixel<P> e{g, w.img, w.tr * g.bh, w.tc * g.bw + ex, out_primary, out_comps, need_mag,
                     0.0f};
      walk_column<K, A>(tp, win, ew, ex, c0, yb, e);
      tmax = maxp(tmax, e.tmax);
    }
    return tmax;
  }
  const int lane = threadIdx.x & 31, nwarps = tt >> 5, mw = g.bw + 2;
  for (int cb = 30 * (bt >> 5); cb < g.bw && c0 < c1; cb += 30 * nwarps) {
    const int ex = cb + lane;
    EmitNms<P, true> e{g, w.img, w.tr, w.tc, ex, lane >= 1 && lane <= 30 && ex <= g.bw,
                       out_primary, out_comps, out_mag, {0.0f, 0.0f, 0.0f},
                       {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, 0, 0.0f, c0, c1};
    walk_column<K, A>(tp, win, ew, min(ex, mw - 1), c0, c1 + 2, e);
    tmax = maxp(tmax, e.tmax);
  }
  return tmax;
}

template <int K, typename T, typename A, typename P, bool kPre>
__global__ void __launch_bounds__(k2_consumers(K), 1)
pipelined_kernel(const T* __restrict__ x, const Geom g, const int depth, const int bands,
                 const int tma, const long long ntiles, float* __restrict__ out_primary,
                 float* __restrict__ out_comps, float* __restrict__ out_mag,
                 float* __restrict__ out_bmax, const __grid_constant__ TapsT<A> taps,
                 const __grid_constant__ CUtensorMap map, const __grid_constant__ PreT<A> pre) {
  extern __shared__ __align__(128) unsigned char smem[];
  static_assert(sizeof(Layout) <= 128, "pipelined_layout reserves 128 bytes for the layout");
  // The layout goes to shared memory and is read back where it is used,
  // so that its fields do not hold registers across the walk.
  Layout* sl;
  uint64_t* full;
  {
    const Layout L = pipelined_layout(g.bh, g.bw, kPre ? (int)pre.reach : K / 2, depth,
                                      (int)sizeof(T), g.rgb ? 3 : 1, g.nms,
                                      kPre ? pre_plane_words(pre, g.bh, g.bw, g.nms) : 0);
    sl = reinterpret_cast<Layout*>(smem + L.layout);
    full = reinterpret_cast<uint64_t*>(smem + L.bars);
    if (threadIdx.x == 0) {
      *sl = L;
      for (int s = 0; s < depth; ++s) mbar_init(&full[s], tma ? 1 : 2 * (int)blockDim.x);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();
  const Layout& L = *sl;
  const P tp = P::make(taps, g);
  const int ch = g.rgb ? 3 : 1;
  const int r_in = (kPre ? (int)pre.reach : K / 2) + g.nms;
  const int mh = g.bh + 2 * g.nms, mw = g.bw + 2 * g.nms;
  const int ew = mw + 2 * (K / 2);  // the walk's window: the last plane
  const int tt = tile_threads(g.bw, g.nms);
  const int band = threadIdx.x / tt, bt = threadIdx.x - band * tt;
  const int rows_per_band = cdiv(g.bh, bands);
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  int* rowoff = reinterpret_cast<int*>(smem + L.rowoff);
  int* coloff = reinterpret_cast<int*>(smem + L.coloff);
  A* win = reinterpret_cast<A*>(smem + L.win);
  A* plane = reinterpret_cast<A*>(smem + L.plane);
  float* warp_max = reinterpret_cast<float*>(smem + L.warp_max);
  constexpr int WM = K2_MAX_THREADS / 32;
  auto post_max = [&](long long tile, int i) {  // tile's max, from warp_max[i & 1]
    if (threadIdx.x == 0) {
      const float* wm = warp_max + (i & 1) * WM;
      float m = wm[0];
      for (int k = 1; k < nw; ++k) m = maxp(m, wm[k]);
      out_bmax[tile] = m;
    }
  };
  // The first `depth` windows of this CTA, slot by slot.
  for (int j = 0; j < depth; ++j) {
    const long long t = blockIdx.x + (long long)j * gridDim.x;
    if (t < ntiles)
      fill_slot<T>(x, g, L, tma, &map, t, smem + (size_t)j * L.slot_bytes, &full[j]);
  }
  int i = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
    const int s = i % depth;
    unsigned char* slot = smem + (size_t)s * L.slot_bytes;
    const Window w = window_of(g, t, r_in, L.eh, L.ew);
    window_offsets<T>(g, L, w, x + (size_t)w.img * g.h * g.w * ch, tma, rowoff, coloff);
    mbar_wait(&full[s], (i / depth) & 1);
    __syncthreads();  // offsets in; the last walk done; its warp maxima posted
    if (out_bmax != nullptr && i > 0) post_max(t - gridDim.x, i - 1);
    convert_window<T, A>(slot, rowoff, coloff, L.eh, L.ew, g.rgb, win);
    __syncthreads();  // the window is in, and nobody reads the slot again
    const long long next = t + (long long)depth * gridDim.x;
    if (next < ntiles) fill_slot<T>(x, g, L, tma, &map, next, slot, &full[s]);
    const A* src = win;
    if constexpr (kPre) {
      if (run_pre_stages<A>(pre, win, plane, mh, mw)) src = plane;
    }
    float tmax = walk_tile<K, A>(tp, g, w, src, ew, band, bt, tt, rows_per_band, out_primary,
                                 out_comps, out_mag, out_bmax != nullptr);
    if (out_bmax != nullptr) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        tmax = maxp(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      }
      if ((threadIdx.x & 31) == 0) warp_max[(i & 1) * WM + warp] = tmax;
    }
  }
  if (out_bmax != nullptr && i > 0) {
    __syncthreads();
    post_max(blockIdx.x + (long long)(i - 1) * gridDim.x, i - 1);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// The tensor map of a gray batch as (n, h, w) elements, boxes of box_h x
// box_w; elements of a box past the image read as 0 (never used: the
// offsets stay inside the image).
template <typename T>
static cudaError_t encode_map(CUtensorMap* map, const void* x, int n, const Geom& g,
                              const Layout& L) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)g.w, (cuuint64_t)g.h, (cuuint64_t)n};
  const cuuint64_t pitch = (cuuint64_t)g.w * sizeof(T);
  const cuuint64_t strides[2] = {pitch, pitch * g.h};
  const cuuint32_t box[3] = {(cuuint32_t)L.box_w, (cuuint32_t)L.box_h, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, sizeof(T) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        3, const_cast<void*>(x), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Kernel parameters stay within the 4 KB every CUDA 12 toolkit takes.
static_assert(sizeof(Taps) + sizeof(Pre) + sizeof(CUtensorMap) + sizeof(Geom) + 64 +
                      6 * sizeof(void*) <= 4096,
              "K2's parameters exceed 4 KB");

template <int K, typename T, typename A, typename P, bool kPre>
static cudaError_t launch_pre(const void* x, int n, const Geom& g, int depth, int tma,
                              float* primary, float* comps, float* mag, float* bmax,
                              const TapsT<A>& taps, const PreT<A>& pre, cudaStream_t stream) {
  const Layout L = pipelined_layout(g.bh, g.bw, (int)pre.reach, depth, (int)sizeof(T),
                                    g.rgb ? 3 : 1, g.nms, pre_plane_words(pre, g.bh, g.bw, g.nms));
  if (L.total > SMEM_MAX) return cudaErrorInvalidValue;
  const auto kernel = pipelined_kernel<K, T, A, P, kPre>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return e;
  const int bands = pipelined_bands(g.bh, g.bw, g.nms, K);
  const int threads = bands * tile_threads(g.bw, g.nms);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, L.total)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long ntiles = (long long)n * g.gh * g.gw;
  const long long ctas = (long long)sms * per_sm < ntiles ? (long long)sms * per_sm : ntiles;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (tma) {
    if (g.rgb || (uintptr_t)x % 16 != 0 || (g.w * sizeof(T)) % 16 != 0) return cudaErrorInvalidValue;
    if ((e = encode_map<T>(&map, x, n, g, L)) != cudaSuccess) return e;
  }
  kernel<<<(unsigned)ctas, threads, L.total, stream>>>((const T*)x, g, depth, bands, tma, ntiles,
                                                       primary, comps, mag, bmax, taps, map, pre);
  return cudaGetLastError();
}

// A plan with pre-stages runs the instance that has them compiled in, as K1.
template <int K, typename T, typename A, typename P>
static cudaError_t launch(const void* x, int n, const Geom& g, int depth, int tma,
                          float* primary, float* comps, float* mag, float* bmax,
                          const TapsT<A>& taps, const PreT<A>& pre, cudaStream_t stream) {
  if ((int)pre.n > 0)
    return launch_pre<K, T, A, P, true>(x, n, g, depth, tma, primary, comps, mag, bmax, taps,
                                        pre, stream);
  if ((int)pre.reach != K / 2) return cudaErrorInvalidValue;
  return launch_pre<K, T, A, P, false>(x, n, g, depth, tma, primary, comps, mag, bmax, taps, pre,
                                       stream);
}

// One accumulator type: the compile-time instance (sobel5, v2, 2 or 4
// directions) or the run-time-taps instance of the operator's size, as K1.
template <typename T, typename A>
static cudaError_t launch_lane(const void* x, int n, const Geom& g, int size, int const_taps,
                               int depth, int tma, float* primary, float* comps, float* mag,
                               float* bmax, const TapsT<A>& taps, const PreT<A>& pre,
                               cudaStream_t s) {
  if ((int)pre.n < 0 || (int)pre.n > MAX_PRE || (int)pre.reach < size / 2)
    return cudaErrorInvalidValue;
  if (const_taps) {
    if (size != 5 || g.variant != V_V2) return cudaErrorInvalidValue;
    if (g.dirs == 4)
      return launch<5, T, A, Sobel5Default<4>>(x, n, g, depth, tma, primary, comps, mag, bmax,
                                               taps, pre, s);
    if (g.dirs == 2)
      return launch<5, T, A, Sobel5Default<2>>(x, n, g, depth, tma, primary, comps, mag, bmax,
                                               taps, pre, s);
    return cudaErrorInvalidValue;
  }
  REPRO_SWITCH_SIZE(size, (launch<KS, T, A, RtTaps<A>>(x, n, g, depth, tma, primary, comps, mag,
                                                       bmax, taps, pre, s)))
}

// K2's dynamic shared memory in bytes, as pipelined_layout computes it.
extern "C" long long repro_pipelined_smem_bytes(int bh, int bw, int radius, int depth,
                                                int in_bytes, int channels, int nms) {
  return (long long)pipelined_layout(bh, bw, radius, depth, in_bytes, channels, nms).total;
}

// The same with a plan: radius is its composed reach, plane_words its
// pre-stage plane (pre_plane_words).
extern "C" long long repro_pipelined_plan_smem_bytes(int bh, int bw, int radius, int depth,
                                                     int in_bytes, int channels, int nms,
                                                     int plane_words) {
  return (long long)pipelined_layout(bh, bw, radius, depth, in_bytes, channels, nms, plane_words)
      .total;
}

// K2's bands of consumer threads for a tile, as pipelined_bands computes it.
extern "C" int repro_pipelined_bands(int bh, int bw, int nms, int size) {
  return pipelined_bands(bh, bw, nms, size);
}

// Launches K2 on `stream`: arguments and outputs as repro_edge_launch
// (csrc/edge.cu), plus the ring depth (2..8) and the copy route (tma = 1:
// TMA boxes, which needs gray input with a 16-byte aligned base and row
// pitch, else cudaErrorInvalidValue; 0: 16-byte cp.async). Returns the
// launch's cudaError_t, or the tensor map's encode failure as
// cudaErrorInvalidValue / cudaErrorNotSupported. pre_host as for
// repro_edge_launch: a plan's pre-stages, run on each converted window.
extern "C" int repro_pipelined_launch(const void* x, int in_u8, int rgb, int n, int h, int w,
                                      int bh, int bw, int size, int variant, int dirs,
                                      int padding, int nms, float tan_pi8, const float* taps_host,
                                      int const_taps, int acc_int, int depth, int tma,
                                      float* primary, float* comps, float* mag, float* bmax,
                                      void* stream, const float* pre_host) {
  if (depth < 2 || depth > 8) return (int)cudaErrorInvalidValue;
  Taps t;
  memcpy(&t, taps_host, sizeof(Taps));
  Pre pre;
  memcpy(&pre, pre_host, sizeof(Pre));
  cudaStream_t s = (cudaStream_t)stream;
  const Geom g = {rgb, h, w, bh, bw, (h + bh - 1) / bh, (w + bw - 1) / bw,
                  variant, dirs, padding, nms, tan_pi8};
  if (acc_int) {
    if (!in_u8 || rgb) return (int)cudaErrorInvalidValue;
    return (int)launch_lane<uint8_t, int32_t>(x, n, g, size, const_taps, depth, tma, primary,
                                              comps, mag, bmax, int_taps(t), int_pre(pre), s);
  }
  if (in_u8)
    return (int)launch_lane<uint8_t, float>(x, n, g, size, const_taps, depth, tma, primary, comps,
                                            mag, bmax, t, pre, s);
  return (int)launch_lane<float, float>(x, n, g, size, const_taps, depth, tma, primary, comps,
                                        mag, bmax, t, pre, s);
}
