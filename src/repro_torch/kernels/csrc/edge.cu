// K1 on Hopper: the fused multi-directional edge kernel.
//
// Replaces repro/kernels/edge.py::_kernel (the Pallas K1 body, together with
// what it inlines: _emit_outputs, tiling.extend_tile, tiling.luma,
// core/sobel.spec_components, core/sobel.magnitude and, with out_nms,
// core/nms.nms_sector and nms_thin).
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 with FMA, about half that
// in separate multiplies and adds, which --fmad=false forces), as counted by
// chip_smoke.py (bound, kernel_ops_per_pixel): sobel5, v2, 4 directions
// needs 73 f32 operations per pixel, 78 with the RGB luma. A 4x2048x2048 f32
// request moves 8 B/px (134 MB, 40.1 us) against 36.6 us of operations, so
// it is bound by bytes; 4x1080x1920 RGB u8 moves 7 B/px (17.3 us) against
// 19.3 us of operations, so it is bound by operations. With out_nms the
// ladder also runs on each tile's one-pixel ring and the sector and
// suppression add compares; a 4x2048x2048 u8 frame moves 5 B/px, so the
// NMS lane is bound by operations.
//
// Design (simple and right first): one CTA per (image, tile row, tile col)
// runs edge_tile() (edge_tile.cuh) and stores the CTA's max of the
// un-thinned magnitude over its in-image pixels per tile, reduced with warp
// shuffles (max is order-free, so exact). The integer lane (acc_int) is the
// same kernel with an int32 window, int32 taps and ladder (u8 gray input
// only).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// --fmad=false keeps every product and sum separately rounded (the
// reference's max(., -FLT_MAX) fence); no --use_fast_math, so sqrtf is IEEE.

#include <string.h>

#include "edge_tile.cuh"

template <int K, typename T, typename A>
__global__ void __launch_bounds__(THREADS)
edge_kernel(const T* __restrict__ x, const Geom g, float* __restrict__ out_primary,
            float* __restrict__ out_comps, float* __restrict__ out_mag,
            float* __restrict__ out_bmax, const __grid_constant__ TapsT<A> taps) {
  extern __shared__ float smem[];
  __shared__ float warp_max[THREADS / 32];
  long long img;
  int tr, tc;
  tile_of(g, &img, &tr, &tc);
  const float tmax = edge_tile<K, T, A>(taps, g, x, img, tr, tc, smem, out_primary, out_comps,
                                        out_mag, out_bmax != nullptr);
  if (out_bmax != nullptr) {
    const float m = block_max(tmax, warp_max);
    if (threadIdx.x == 0) out_bmax[blockIdx.x] = m;
  }
}

template <int K, typename T, typename A>
static cudaError_t launch(const void* x, int n, const Geom& g, float* primary, float* comps,
                          float* mag, float* bmax, const TapsT<A>& taps, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(g.bh, g.bw, K / 2, g.nms);
  cudaError_t e = cudaFuncSetAttribute(edge_kernel<K, T, A>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)n * g.gh * g.gw;
  edge_kernel<K, T, A><<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const T*)x, g, primary, comps, mag, bmax, taps);
  return cudaGetLastError();
}

// Launches K1 on `stream`. x is (n, h, w) or (n, h, w, 3) u8 (in_u8 = 1) or
// f32. Outputs are f32 and each may be null: primary (n, h, w) is the
// magnitude, or the thin map with nms; comps (n, dirs, h, w) the
// components (the centre ones with nms); mag (n, h, w) the un-thinned
// magnitude (nms only); bmax (n, gh, gw) the per-tile max of the
// un-thinned magnitude. acc_int = 1 runs the integer lane (u8 gray input
// only; the caller has checked core/ladder.int_lane_eligible). Returns the
// launch's cudaError_t.
extern "C" int repro_edge_launch(const void* x, int in_u8, int rgb, int n, int h, int w,
                                 int bh, int bw, int size, int variant, int dirs, int padding,
                                 int nms, float tan_pi8, const float* taps_host, int acc_int,
                                 float* primary, float* comps, float* mag, float* bmax,
                                 void* stream) {
  Taps t;
  memcpy(&t, taps_host, sizeof(Taps));
  cudaStream_t s = (cudaStream_t)stream;
  const Geom g = {rgb, h, w, bh, bw, (h + bh - 1) / bh, (w + bw - 1) / bw,
                  variant, dirs, padding, nms, tan_pi8};
  if (acc_int) {
    if (!in_u8 || rgb) return (int)cudaErrorInvalidValue;
    const TapsT<int32_t> ti = int_taps(t);
    REPRO_SWITCH_SIZE(size, ((int)launch<KS, uint8_t, int32_t>(x, n, g, primary, comps, mag, bmax,
                                                               ti, s)))
  }
  if (in_u8) {
    REPRO_SWITCH_SIZE(size, ((int)launch<KS, uint8_t, float>(x, n, g, primary, comps, mag, bmax,
                                                             t, s)))
  }
  REPRO_SWITCH_SIZE(size, ((int)launch<KS, float, float>(x, n, g, primary, comps, mag, bmax, t,
                                                         s)))
}
