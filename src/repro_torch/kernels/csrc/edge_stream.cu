// K3 on Hopper: the persistent delta-skip kernel (per-tile recompute or splice).
//
// Replaces repro/kernels/edge.py::_stream_kernel, reached from
// edge_stream_pallas. Inputs: the current frames x (n, h, w[, 3]) u8/f32, the
// previous frame's primary map prev_primary (n, h, w) f32 (the thin map with
// nms, else the magnitude), its per-tile maxima prev_bmax (n, gh, gw) f32, and
// the int32 mask (n, gh, gw) of tiles whose input window changed. Outputs:
// primary (n, h, w) and bmax (n, gh, gw), fresh tensors.
//
// What held the first version back (tools/profile_k3.py on an H100 80GB HBM3
// at 700 W, 4x2048x2048 u8, 64x256, NMS): one CTA per tile in raster order,
// so an unchanged tile's copy (scalar 4-byte loads, a division and a modulo
// per element) ran in a CTA sized and resident for K1's walk, and a motion
// region's changed tiles, clustered in a few tile rows, fell into a few
// waves of walks while the other waves only copied.
//
// Design:
//   * Persistent grid: as many CTAs as fit on the SMs at K1's tile CTA
//     (tile_threads, tile_smem_bytes), cut to the most items a mask can
//     make. The occupancy is queried, and the dynamic shared-memory limit
//     raised, once per instance, device and CTA shape, not on every launch.
//   * Work list compacted on the device: every CTA reads the mask in chunks
//     (stream_scan_chunk entries, each lane a run of consecutive flags held
//     as bits) and block-scans the chunk, so that the ordered list of
//     changed tiles, and then of unchanged tiles, is the same in every CTA
//     without a host sync or a second launch. A CTA's items only grow, so
//     it walks each list once, a chunk at a time.
//   * Items: first the changed tiles (the long ones), then the copies, each
//     unchanged tile cut into bands of stream_copy_rows rows so that the
//     copies balance against the walks. A CTA claims its next item with an
//     atomicAdd on a per-stream counter; the last CTA to finish resets it,
//     so no memset precedes a launch.
//   * A changed tile runs edge_tile() (edge_tile.cuh), the very code K1 runs
//     -- the column walk with shared row passes, and the compile-time
//     instance for the default sobel5 (const_taps) -- and block_max of the
//     un-thinned magnitude, so its bits are K1's. An unchanged input window
//     reproduces the same arithmetic, so the output equals a full recompute
//     bit for bit.
//   * A copy band moves its rows with 16-byte vectors where the caller says
//     the cache's and the output's rows are 16-byte aligned (vec: both
//     bases on 16 bytes, w and bw multiples of 4; kernels/edge.py's
//     stream_vector_copy), else a float at a time; COPY_LOADS loads in
//     flight a thread, streaming hints (the cache is not read again), the
//     thread's (row, column) stepped without a division. The band of row 0
//     also copies the tile's cached max.
//
// Bound on an H100 SXM, as chip_smoke.py counts it: a changed tile reads its
// input once and writes 4 B/px; a spliced tile reads and writes 4 B/px each;
// the operations are those of K1's NMS lane over the changed tiles only. The
// CTAs' mask reads come from L2 and are not counted.
//
// Build: nvcc -gencode arch=compute_90a,code=[sm_90a,compute_90a] -O3 --fmad=false

#include <string.h>

#include <mutex>

#include "edge_tile.cuh"

#define COPY_LOADS 4           // a copy thread's loads in flight
#define COPY_ITEM_FLOATS 8192  // the floats a copy item moves, at most (one row at least)

// Rows of one copy item: as many whole rows of a tile as make at most
// COPY_ITEM_FLOATS floats, at least one, at most the tile's bh.
__host__ __device__ inline int stream_copy_rows(int bh, int bw) {
  const int r = COPY_ITEM_FLOATS / bw;
  return r < 1 ? 1 : (r > bh ? bh : r);
}

// Copy items of one unchanged tile.
__host__ __device__ inline int stream_copy_bands(int bh, int bw) {
  const int rows = stream_copy_rows(bh, bw);
  return (bh + rows - 1) / rows;
}

// Mask entries one block scan compacts: each of the CTA's threads holds a
// run of `per` consecutive flags as bits, per = ceil(ntiles / threads)
// clamped to 1..32, so that a batch of up to 32 x threads tiles is one
// chunk and a larger one several.
__device__ inline int stream_scan_chunk(int ntiles, int threads) {
  int per = ntiles / threads + (ntiles % threads != 0);
  per = per < 1 ? 1 : (per > 32 ? 32 : per);
  return per * threads;
}

// One chunk of the mask, compacted: this thread's run of flags that equal
// `want` (changed: mask != 0) as bits from run position 0, and the count of
// such flags before its run (pos). Returns the chunk's count; every thread
// of the CTA calls it. wsum holds an int per warp.
__device__ __forceinline__ int scan_chunk(const int* __restrict__ mask, int ntiles, int t0,
                                          int per, bool want, unsigned* bits, int* pos,
                                          int* wsum) {
  const long long e0 = (long long)t0 + threadIdx.x * per;
  unsigned b = 0;
#pragma unroll 4
  for (int i = 0; i < per; ++i) {
    if (e0 + i < ntiles && ((__ldg(mask + e0 + i) != 0) == want)) b |= 1u << i;
  }
  const int cnt = __popc(b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
    const int s = wsum[i];
    before += i < warp ? s : 0;
    total += s;
  }
  *bits = b;
  *pos = before + incl - cnt;
  __syncthreads();  // wsum is read before the next chunk writes it
  return total;
}

// Copy `rows` rows of `cols` elements of V from src to dst (row pitch
// `pitch` elements), COPY_LOADS loads in flight a thread, streaming hints.
template <typename V>
__device__ __forceinline__ void copy_rect(const V* __restrict__ src, V* __restrict__ dst,
                                          size_t pitch, int rows, int cols) {
  const int n = rows * cols, step = blockDim.x;
  const int dy = step / cols, dx = step - dy * cols;
  int ly = threadIdx.x / cols, lx = threadIdx.x - ly * cols;
  for (int base = threadIdx.x; base < n; base += COPY_LOADS * step) {
    V v[COPY_LOADS];
    size_t o[COPY_LOADS];
#pragma unroll
    for (int u = 0; u < COPY_LOADS; ++u) {
      o[u] = (size_t)ly * pitch + lx;
      if (base + u * step < n) v[u] = __ldcs(src + o[u]);
      lx += dx;
      ly += dy;
      if (lx >= cols) {
        lx -= cols;
        ++ly;
      }
    }
#pragma unroll
    for (int u = 0; u < COPY_LOADS; ++u) {
      if (base + u * step < n) __stcs(dst + o[u], v[u]);
    }
  }
}

// Copy band `band` (rows band * band_rows ...) of unchanged tile `tile`
// from the caches; the band of row 0 also copies the tile's max.
__device__ __forceinline__ void copy_band(const Geom& g, long long tile, int band, int band_rows,
                                          bool vec, const float* __restrict__ prev_primary,
                                          const float* __restrict__ prev_bmax,
                                          float* __restrict__ out_primary,
                                          float* __restrict__ out_bmax) {
  long long img;
  int tr, tc;
  tile_at(g, tile, &img, &tr, &tc);
  const int r0 = tr * g.bh + band * band_rows;
  const int r1 = min(min(tr * g.bh + g.bh, r0 + band_rows), g.h);
  const int c0 = tc * g.bw, cols = min(g.bw, g.w - c0);
  if (r0 < r1) {
    const size_t off = ((size_t)img * g.h + r0) * g.w + c0;
    if (vec) {
      copy_rect<float4>(reinterpret_cast<const float4*>(prev_primary + off),
                        reinterpret_cast<float4*>(out_primary + off), (size_t)g.w / 4, r1 - r0,
                        cols / 4);
    } else {
      copy_rect<float>(prev_primary + off, out_primary + off, (size_t)g.w, r1 - r0, cols);
    }
  }
  if (band == 0 && threadIdx.x == 0) out_bmax[tile] = prev_bmax[tile];
}

// A CTA's place in one of its two work lists (the changed tiles, then the
// unchanged ones), compacted from the mask a chunk at a time. Every thread
// of the CTA holds the same cursor but its own run of flags (bits, pos);
// every thread calls each method.
struct Cursor {
  const int* __restrict__ mask;
  int ntiles, chunk;        // mask entries (below 2^31), and entries a chunk
  int per;                  // a thread's run of flags in a chunk
  bool want;                // the list: tiles whose (mask != 0) == want
  int t0, base;             // the chunk's first tile; list items before it
  int count;                // list items in the chunk
  unsigned bits;            // the list's tiles in this thread's run, as bits
  int pos;                  // list items in the chunk before this thread's run

  __device__ __forceinline__ void start(bool want_, int* wsum) {
    want = want_;
    t0 = base = 0;
    count = scan_chunk(mask, ntiles, 0, per, want, &bits, &pos, wsum);
  }
  // Whether the list has an item k, scanning forward to its chunk (k never
  // decreases). When it has none, base + count is the list's length.
  __device__ __forceinline__ bool seek(long long k, int* wsum) {
    while (k >= base + count && t0 < ntiles - chunk) {
      base += count;
      t0 += chunk;
      count = scan_chunk(mask, ntiles, t0, per, want, &bits, &pos, wsum);
    }
    return k < base + count;
  }
  // The tile of item k, after seek(k): the thread whose run holds it names it.
  __device__ __forceinline__ int tile(long long k, int* s_rel) {
    const int r = (int)(k - base) - pos;
    if (r >= 0 && r < __popc(bits)) {
      unsigned b = bits;
      for (int i = 0; i < r; ++i) b &= b - 1;
      *s_rel = threadIdx.x * per + __ffs(b) - 1;
    }
    __syncthreads();
    return t0 + *s_rel;
  }
};

// The changed tile `tile`: K1's tile body, then the tile's max.
template <int K, typename T, typename P>
__device__ __forceinline__ void walk_tile(const T* __restrict__ x, const Geom& g, const Taps& taps,
                                          int tile, float* smem, float* warp_max,
                                          float* __restrict__ out_primary,
                                          float* __restrict__ out_bmax) {
  long long img;
  int tr, tc;
  tile_at(g, tile, &img, &tr, &tc);
  const P tp = P::make(taps, g);
  const float tmax = edge_tile<K, T, float>(tp, g, x, img, tr, tc, smem, out_primary, nullptr,
                                            nullptr, true);
  const float m = block_max(tmax, warp_max);
  if (threadIdx.x == 0) out_bmax[tile] = m;
}

// Registers a thread, at most. 72 lets three CTAs of the stream server's
// tile (64x256 with NMS: 288 threads, 73,360 B of window) share an SM, as
// they did when each CTA walked one tile: with the persistent loop's state
// the compile-time instance otherwise takes 80 and two CTAs an SM, and K3
// runs slower where tiles changed (tools/profile_k3.py, no_register_cap).
// The run-time-taps instances keep K1's 80.
template <typename P>
constexpr int stream_max_regs() {
  return P::kPasses > 0 ? 72 : 80;
}

template <int K, typename T, typename P>
__global__ void __maxnreg__(stream_max_regs<P>())
stream_kernel(const T* __restrict__ x, const Geom g, const int* __restrict__ mask,
              const float* __restrict__ prev_primary, const float* __restrict__ prev_bmax,
              float* __restrict__ out_primary, float* __restrict__ out_bmax,
              const __grid_constant__ Taps taps, int ntiles, int vec,
              unsigned long long* __restrict__ claim) {
  extern __shared__ float smem[];
  __shared__ float warp_max[MAX_THREADS / 32];
  __shared__ int wsum[MAX_THREADS / 32];
  __shared__ unsigned long long s_item[2];  // this item and the next, by parity
  __shared__ int s_rel;
  Cursor cur;
  cur.mask = mask;
  cur.ntiles = ntiles;
  cur.chunk = stream_scan_chunk(ntiles, blockDim.x);
  cur.per = cur.chunk / blockDim.x;
  cur.start(true, wsum);
  // Items: the changed tiles, then the unchanged tiles' copy bands. Two
  // loops, not one, so that neither path's registers stay live across the
  // other.
  int parity = 0;
  unsigned long long item;
  if (threadIdx.x == 0) s_item[0] = atomicAdd(claim, 1ull);
  // The changed tiles: K1's tile body. A CTA claims its next tile only when
  // it has walked this one, so that the walks spread over all the CTAs.
  for (;;) {
    __syncthreads();  // the last item is done, its s_rel read, the next published
    item = s_item[parity];
    if (!cur.seek((long long)item, wsum)) break;  // a copy item: on to the copies
    const int tile = cur.tile((long long)item, &s_rel);
    walk_tile<K, T, P>(x, g, taps, tile, smem, warp_max, out_primary, out_bmax);
    if (threadIdx.x == 0) s_item[parity ^ 1] = atomicAdd(claim, 1ull);
    parity ^= 1;
  }
  // The unchanged tiles, in bands of stream_copy_rows rows, from the caches.
  const int n_changed = cur.base + cur.count;
  cur.start(false, wsum);
  const int band_rows = stream_copy_rows(g.bh, g.bw);
  const int bands = stream_copy_bands(g.bh, g.bw);
  // The copies are short and alike: thread 0 claims the item after this
  // one as this one starts and publishes it as it ends, so that the
  // atomic's round trip overlaps the copy.
  unsigned long long next = 0;
  if (threadIdx.x == 0) next = atomicAdd(claim, 1ull);
  for (;;) {
    const long long j = (long long)item - n_changed;
    if (!cur.seek(j / bands, wsum)) break;  // past the last band: done
    const int tile = cur.tile(j / bands, &s_rel);
    copy_band(g, tile, (int)(j % bands), band_rows, vec != 0, prev_primary, prev_bmax,
              out_primary, out_bmax);
    if (threadIdx.x == 0) s_item[parity ^ 1] = next;
    parity ^= 1;
    __syncthreads();  // the item's s_rel is read; the next item is published
    item = s_item[parity];
    if (threadIdx.x == 0) next = atomicAdd(claim, 1ull);
  }
  // The last CTA out resets the counter for the next launch on the stream.
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(claim + 1, 1ull) == gridDim.x - 1) {
      claim[0] = 0;
      claim[1] = 0;
    }
  }
}

// Everything one launch needs.
struct StreamArgs {
  const void* x;
  Geom g;
  const int* mask;
  const float *prev_primary, *prev_bmax;
  float *primary, *bmax;
  Taps taps;
  int ntiles;
  int vec;
  unsigned long long* claim;
  cudaStream_t stream;
};

// SMs x the CTAs of this instance that fit on an SM of device `dev` at
// `threads` and `smem`, after raising the instance's dynamic shared-memory
// limit to all the device allows beside its static shared memory. Asked
// once per device and CTA shape: the first 16 pairs are kept, a later one
// is asked on every launch.
template <int K, typename T, typename P>
static cudaError_t resident_ctas(int dev, int threads, size_t smem, int* ctas) {
  struct Seen {
    int dev, threads;
    size_t smem;
    int ctas;
  };
  static Seen seen[16];
  static int n_seen = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i) {
    if (seen[i].dev == dev && seen[i].threads == threads && seen[i].smem == smem) {
      *ctas = seen[i].ctas;
      return cudaSuccess;
    }
  }
  const auto kernel = stream_kernel<K, T, P>;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  int optin = 0, sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return e;
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                optin - (int)attr.sharedSizeBytes)) != cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *ctas = sms * per_sm;
  if (n_seen < 16) seen[n_seen++] = {dev, threads, smem, *ctas};
  return cudaSuccess;
}

template <int K, typename T, typename P>
static cudaError_t launch(const StreamArgs& a) {
  const Geom& g = a.g;
  const int threads = tile_threads(g.bw, g.nms);
  const size_t smem = tile_smem_bytes(g.bh, g.bw, K / 2, g.nms);
  int dev = 0, ctas = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if ((e = resident_ctas<K, T, P>(dev, threads, smem, &ctas)) != cudaSuccess) return e;
  // No more CTAs than the most items a mask can make: every tile unchanged.
  const long long items = (long long)a.ntiles * stream_copy_bands(g.bh, g.bw);
  if (items < ctas) ctas = (int)items;
  stream_kernel<K, T, P><<<(unsigned)ctas, threads, smem, a.stream>>>(
      (const T*)a.x, g, a.mask, a.prev_primary, a.prev_bmax, a.primary, a.bmax, a.taps, a.ntiles,
      a.vec, a.claim);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_input(const StreamArgs& a, int size, int const_taps) {
  if (const_taps) {
    if (size != 5 || a.g.variant != V_V2) return cudaErrorInvalidValue;
    if (a.g.dirs == 4) return launch<5, T, Sobel5Default<4>>(a);
    if (a.g.dirs == 2) return launch<5, T, Sobel5Default<2>>(a);
    return cudaErrorInvalidValue;
  }
  REPRO_SWITCH_SIZE(size, (launch<KS, T, RtTaps<float>>(a)))
}

// Launches K3 on `stream`; arguments as repro_edge_launch (const_taps
// included), plus the int32 mask, the caches and the outputs, the copy
// route (vec = 1: 16-byte copies, which needs both maps' bases on 16 bytes
// and w and bw multiples of 4, else cudaErrorInvalidValue) and the
// stream's claim counter (two zeroed u64 that no other launch uses
// concurrently; K3 leaves them zeroed). Returns the launch's cudaError_t.
extern "C" int repro_stream_launch(const void* x, int in_u8, int rgb, int n, int h, int w,
                                   int bh, int bw, int size, int variant, int dirs, int padding,
                                   int nms, float tan_pi8, const float* taps_host, int const_taps,
                                   const int* mask, const float* prev_primary,
                                   const float* prev_bmax, float* primary, float* bmax, int vec,
                                   unsigned long long* claim, void* stream) {
  if (vec && ((uintptr_t)prev_primary % 16 != 0 || (uintptr_t)primary % 16 != 0 || w % 4 != 0 ||
              bw % 4 != 0))
    return (int)cudaErrorInvalidValue;
  StreamArgs a = {x, {}, mask, prev_primary, prev_bmax, primary, bmax, {}, 0, vec, claim,
                  (cudaStream_t)stream};
  memcpy(&a.taps, taps_host, sizeof(Taps));
  a.g = {rgb, h, w, bh, bw, (h + bh - 1) / bh, (w + bw - 1) / bw,
         variant, dirs, padding, nms, tan_pi8};
  const long long ntiles = (long long)n * a.g.gh * a.g.gw;
  if (ntiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  a.ntiles = (int)ntiles;
  if (in_u8) return (int)launch_input<uint8_t>(a, size, const_taps);
  return (int)launch_input<float>(a, size, const_taps);
}
