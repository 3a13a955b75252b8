// K3 on Hopper: the masked-grid streaming kernel (per-tile recompute or splice).
//
// Replaces repro/kernels/edge.py::_stream_kernel, reached from
// edge_stream_pallas. Inputs: the current frames x (n, h, w[, 3]) u8/f32, the
// previous frame's primary map prev_primary (n, h, w) f32 (the thin map with
// nms, else the magnitude), its per-tile maxima prev_bmax (n, gh, gw) f32, and
// the int32 mask (n, gh, gw) of tiles whose input window changed. Outputs:
// primary (n, h, w) and bmax (n, gh, gw), fresh tensors.
//
// Design: one CTA per tile, which reads its mask flag first; the branch is
// uniform across the CTA. A changed tile runs edge_tile() (edge_tile.cuh),
// the very code K1 runs -- the column walk with shared row passes, and the
// compile-time instance for the default sobel5 (const_taps) -- and stores
// the tile's max of the un-thinned magnitude. An unchanged tile copies the
// cached tile and its cached max and reads no input at all (the TPU
// kernel's window DMA happens either way). An unchanged input window
// reproduces the same arithmetic, so the output equals a full recompute bit
// for bit.
//
// Bound on an H100 SXM, as chip_smoke.py counts it: a changed tile reads its
// input once and writes 4 B/px; a spliced tile reads and writes 4 B/px each;
// the operations are those of K1's NMS lane over the changed tiles only.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false

#include <string.h>

#include "edge_tile.cuh"

template <int K, typename T, typename P>
__global__ void __launch_bounds__(MAX_THREADS)
stream_kernel(const T* __restrict__ x, const Geom g, const int* __restrict__ mask,
              const float* __restrict__ prev_primary, const float* __restrict__ prev_bmax,
              float* __restrict__ out_primary, float* __restrict__ out_bmax,
              const __grid_constant__ Taps taps) {
  extern __shared__ float smem[];
  __shared__ float warp_max[MAX_THREADS / 32];
  long long img;
  int tr, tc;
  tile_of(g, &img, &tr, &tc);
  if (mask[blockIdx.x] != 0) {
    const P tp = P::make(taps, g);
    const float tmax = edge_tile<K, T, float>(tp, g, x, img, tr, tc, smem, out_primary, nullptr,
                                              nullptr, true);
    const float m = block_max(tmax, warp_max);
    if (threadIdx.x == 0) out_bmax[blockIdx.x] = m;
    return;
  }
  const size_t base = (size_t)img * g.h * g.w;
  for (int q = threadIdx.x; q < g.bh * g.bw; q += blockDim.x) {
    const int oy = q / g.bw, ox = q - oy * g.bw;
    const int gy = tr * g.bh + oy, gx = tc * g.bw + ox;
    if (gy >= g.h || gx >= g.w) continue;
    const size_t o = base + (size_t)gy * g.w + gx;
    out_primary[o] = prev_primary[o];
  }
  if (threadIdx.x == 0) out_bmax[blockIdx.x] = prev_bmax[blockIdx.x];
}

template <int K, typename T, typename P>
static cudaError_t launch(const void* x, int n, const Geom& g, const int* mask,
                          const float* prev_primary, const float* prev_bmax, float* primary,
                          float* bmax, const Taps& taps, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(g.bh, g.bw, K / 2, g.nms);
  cudaError_t e = cudaFuncSetAttribute(stream_kernel<K, T, P>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)n * g.gh * g.gw;
  stream_kernel<K, T, P><<<(unsigned)blocks, tile_threads(g.bw, g.nms), smem, stream>>>(
      (const T*)x, g, mask, prev_primary, prev_bmax, primary, bmax, taps);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_input(const void* x, int n, const Geom& g, int size, int const_taps,
                                const int* mask, const float* prev_primary,
                                const float* prev_bmax, float* primary, float* bmax,
                                const Taps& t, cudaStream_t s) {
  if (const_taps) {
    if (size != 5 || g.variant != V_V2) return cudaErrorInvalidValue;
    if (g.dirs == 4)
      return launch<5, T, Sobel5Default<4>>(x, n, g, mask, prev_primary, prev_bmax, primary,
                                            bmax, t, s);
    if (g.dirs == 2)
      return launch<5, T, Sobel5Default<2>>(x, n, g, mask, prev_primary, prev_bmax, primary,
                                            bmax, t, s);
    return cudaErrorInvalidValue;
  }
  REPRO_SWITCH_SIZE(size, (launch<KS, T, RtTaps<float>>(x, n, g, mask, prev_primary, prev_bmax,
                                                        primary, bmax, t, s)))
}

// Launches K3 on `stream`; arguments as repro_edge_launch (const_taps
// included), plus the int32 mask and the caches. Returns the launch's
// cudaError_t.
extern "C" int repro_stream_launch(const void* x, int in_u8, int rgb, int n, int h, int w,
                                   int bh, int bw, int size, int variant, int dirs, int padding,
                                   int nms, float tan_pi8, const float* taps_host, int const_taps,
                                   const int* mask, const float* prev_primary,
                                   const float* prev_bmax, float* primary, float* bmax,
                                   void* stream) {
  Taps t;
  memcpy(&t, taps_host, sizeof(Taps));
  cudaStream_t s = (cudaStream_t)stream;
  const Geom g = {rgb, h, w, bh, bw, (h + bh - 1) / bh, (w + bw - 1) / bw,
                  variant, dirs, padding, nms, tan_pi8};
  if (in_u8)
    return (int)launch_input<uint8_t>(x, n, g, size, const_taps, mask, prev_primary, prev_bmax,
                                      primary, bmax, t, s);
  return (int)launch_input<float>(x, n, g, size, const_taps, mask, prev_primary, prev_bmax,
                                  primary, bmax, t, s);
}
