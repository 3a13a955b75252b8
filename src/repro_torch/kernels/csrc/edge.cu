// K1 on Hopper: the fused multi-directional edge kernel.
//
// Replaces repro/kernels/edge.py::_kernel (the Pallas K1 body, together with
// what it inlines: _emit_outputs, tiling.extend_tile, tiling.luma,
// core/sobel.spec_components or, with a plan, core/sobel.plan_components,
// core/sobel.magnitude and, with out_nms, core/nms.nms_sector and
// nms_thin).
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
// What held the first version back (tools/profile_k1.py, SASS and timed
// scratch variants on an H100 80GB HBM3 at 700 W): every pixel recomputed
// about 20 row passes with the taps read and tested for 0 and +-1 at run
// time; of its 10,640 static instructions some 1,200 were the adds and
// multiplies, the rest tap tests (FSETP/FSEL/ISETP), branches and address
// arithmetic. Staging alone (an integer division and a modulo per element,
// one load in flight per thread) took a quarter of its 1.24 ms. The integer
// lane paid the same tap tests as ISETP/SEL/IMAD on the half-rate integer
// pipe, hence 24-38% slower than the f32 lane.
//
// Now about 0.20 ms at 4x2048x2048 f32 on the 64x256 tile (5x the bound,
// same card); the integer lane 0.33-0.42 ms on u8 frames, bound by the
// half-rate integer pipe (edge_tile.cuh says more).
//
// Design: one CTA per (image, tile row, tile col), tile_threads() threads
// (one per column of the tile; with NMS a warp per 30 columns), runs
// edge_tile() (edge_tile.cuh): the window staged once with cheap boundary
// handling, then each thread walks its column with the row passes shared
// through register rings (the paper's §4.3.3). The default operator (sobel5
// at SobelParams(), v2, 2 or 4 directions) runs a compile-time instance
// whose taps are constants (const_taps = 1, chosen by kernels/edge.py from
// the packed taps); everything else runs the run-time-taps instance. The
// CTA's max of the un-thinned magnitude over its in-image pixels is stored
// per tile, reduced with warp shuffles (max is order-free, so exact). The
// integer lane (acc_int) is the same kernel with an int32 window, taps and
// ladder (u8 gray input only). Several CTAs share an SM (70.7 KB of window
// at 64x256), so one tile's staging overlaps another's walk; an in-CTA
// prefetch of the next tile is not done.
//
// A stencil plan (canny5: gaussian5 -> sobel5 -> NMS) is the same launch:
// the window is staged at the composed reach and the plan's pre-stages run
// on it in shared memory before the walk (edge_tile.cuh, run_pre_stages),
// with one more plane beside the window, in instances of their own (kPre):
// the pre-stages' calls would cost the operator-only walk its registers.
// At 64x256 with NMS, canny5's window (74 x 266) and blurred plane
// (70 x 262) take 152 KB: one CTA an SM where the operator alone fits
// three.
//
// Build: nvcc -gencode arch=compute_90a,code=[sm_90a,compute_90a] -O3 --fmad=false
// --fmad=false keeps every product and sum separately rounded (the
// reference's max(., -FLT_MAX) fence); no --use_fast_math, so sqrtf is IEEE.

#include <string.h>

#include "edge_tile.cuh"

template <int K, typename T, typename A, typename P, bool kPre>
__global__ void __launch_bounds__(MAX_THREADS)
edge_kernel(const T* __restrict__ x, const Geom g, float* __restrict__ out_primary,
            float* __restrict__ out_comps, float* __restrict__ out_mag,
            float* __restrict__ out_bmax, const __grid_constant__ TapsT<A> taps,
            const __grid_constant__ PreT<A> pre) {
  extern __shared__ float smem[];
  __shared__ float warp_max[MAX_THREADS / 32];
  long long img;
  int tr, tc;
  tile_of(g, &img, &tr, &tc);
  const P tp = P::make(taps, g);
  const float tmax = edge_tile<K, T, A, P, kPre>(tp, g, x, img, tr, tc, smem, out_primary,
                                                 out_comps, out_mag, out_bmax != nullptr, &pre);
  if (out_bmax != nullptr) {
    const float m = block_max(tmax, warp_max);
    if (threadIdx.x == 0) out_bmax[blockIdx.x] = m;
  }
}

// Kernel parameters stay within the 4 KB every CUDA 12 toolkit takes.
static_assert(sizeof(Taps) + sizeof(Pre) + sizeof(Geom) + 6 * sizeof(void*) <= 4096,
              "K1's parameters exceed 4 KB");

template <int K, typename T, typename A, typename P, bool kPre>
static cudaError_t launch_pre(const void* x, int n, const Geom& g, float* primary, float* comps,
                              float* mag, float* bmax, const TapsT<A>& taps, const PreT<A>& pre,
                              cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(g.bh, g.bw, (int)pre.reach, g.nms) +
                      sizeof(float) * (size_t)pre_plane_words(pre, g.bh, g.bw, g.nms);
  cudaError_t e = cudaFuncSetAttribute(edge_kernel<K, T, A, P, kPre>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long blocks = (long long)n * g.gh * g.gw;
  edge_kernel<K, T, A, P, kPre><<<(unsigned)blocks, tile_threads(g.bw, g.nms), smem, stream>>>(
      (const T*)x, g, primary, comps, mag, bmax, taps, pre);
  return cudaGetLastError();
}

// A plan with pre-stages runs the instance that has them compiled in; the
// operator alone runs one without (the pre-stages' calls would cost its
// walk registers).
template <int K, typename T, typename A, typename P>
static cudaError_t launch(const void* x, int n, const Geom& g, float* primary, float* comps,
                          float* mag, float* bmax, const TapsT<A>& taps, const PreT<A>& pre,
                          cudaStream_t stream) {
  if ((int)pre.n > 0)
    return launch_pre<K, T, A, P, true>(x, n, g, primary, comps, mag, bmax, taps, pre, stream);
  if ((int)pre.reach != K / 2) return cudaErrorInvalidValue;
  return launch_pre<K, T, A, P, false>(x, n, g, primary, comps, mag, bmax, taps, pre, stream);
}

// One accumulator type: the compile-time instance (sobel5, v2, 2 or 4
// directions) or the run-time-taps instance of the operator's size.
template <typename T, typename A>
static cudaError_t launch_lane(const void* x, int n, const Geom& g, int size, int const_taps,
                               float* primary, float* comps, float* mag, float* bmax,
                               const TapsT<A>& taps, const PreT<A>& pre, cudaStream_t s) {
  if ((int)pre.n < 0 || (int)pre.n > MAX_PRE || (int)pre.reach < size / 2)
    return cudaErrorInvalidValue;
  if (const_taps) {
    if (size != 5 || g.variant != V_V2) return cudaErrorInvalidValue;
    if (g.dirs == 4)
      return launch<5, T, A, Sobel5Default<4>>(x, n, g, primary, comps, mag, bmax, taps, pre, s);
    if (g.dirs == 2)
      return launch<5, T, A, Sobel5Default<2>>(x, n, g, primary, comps, mag, bmax, taps, pre, s);
    return cudaErrorInvalidValue;
  }
  REPRO_SWITCH_SIZE(size, (launch<KS, T, A, RtTaps<A>>(x, n, g, primary, comps, mag, bmax, taps,
                                                       pre, s)))
}

// Launches K1 on `stream`. x is (n, h, w) or (n, h, w, 3) u8 (in_u8 = 1) or
// f32. Outputs are f32 and each may be null: primary (n, h, w) is the
// magnitude, or the thin map with nms; comps (n, dirs, h, w) the
// components (the centre ones with nms); mag (n, h, w) the un-thinned
// magnitude (nms only); bmax (n, gh, gw) the per-tile max of the
// un-thinned magnitude. acc_int = 1 runs the integer lane (u8 gray input
// only; the caller has checked core/ladder.int_lane_eligible). const_taps
// = 1 runs the compile-time instance of the default sobel5 (the caller has
// checked that the packed taps are its taps; size 5, v2, 2 or 4
// directions). pre_host is the packed Pre (kernels/edge.py::_pack_pre): a
// plan's pre-stages, run on each tile before the ladder (n = 0: none).
// Returns the launch's cudaError_t.
extern "C" int repro_edge_launch(const void* x, int in_u8, int rgb, int n, int h, int w,
                                 int bh, int bw, int size, int variant, int dirs, int padding,
                                 int nms, float tan_pi8, const float* taps_host, int const_taps,
                                 int acc_int, float* primary, float* comps, float* mag,
                                 float* bmax, void* stream, const float* pre_host) {
  Taps t;
  memcpy(&t, taps_host, sizeof(Taps));
  Pre pre;
  memcpy(&pre, pre_host, sizeof(Pre));
  cudaStream_t s = (cudaStream_t)stream;
  const Geom g = {rgb, h, w, bh, bw, (h + bh - 1) / bh, (w + bw - 1) / bw,
                  variant, dirs, padding, nms, tan_pi8};
  if (acc_int) {
    if (!in_u8 || rgb) return (int)cudaErrorInvalidValue;
    return (int)launch_lane<uint8_t, int32_t>(x, n, g, size, const_taps, primary, comps, mag,
                                              bmax, int_taps(t), int_pre(pre), s);
  }
  if (in_u8)
    return (int)launch_lane<uint8_t, float>(x, n, g, size, const_taps, primary, comps, mag, bmax,
                                            t, pre, s);
  return (int)launch_lane<float, float>(x, n, g, size, const_taps, primary, comps, mag, bmax, t,
                                        pre, s);
}
