// K5 on Hopper: the Mamba-1 selective scan (forward), with its final state.
//
// Replaces repro/kernels/selective_scan.py::_kernel (the Pallas K5 body,
// launched by selective_scan through pl.pallas_call). For each batch b and
// channel d, from h = 0 over t = 0 .. L-1:
//   h[n]      <- exp(dt[b,t,d] * A[d,n]) * h[n] + (dt[b,t,d] * x[b,t,d]) * B[b,t,n]
//   y[b,t,d]  =  sum_n C[b,t,n] * h[n]
// in f32 on f32 or bf16 x, dt, B, C (A in f32), with y written in x's dtype
// and the final h written to h_last[b, d, n] in f32: the decode cache's
// state, which the reference keeps only in its VMEM scratch.
//
// Bound on an H100 SXM, as chip_smoke.py counts it (scan_bound): x, dt and
// y move B*L*d_inner elements each, B and C B*L*N, A and h_last d_inner*N;
// each (t, d, n) costs about 6 f32 operations (33.5 T/s) and one exp on the
// special-function units (16 a clock per SM: 4.18 T/s at 132 SMs and
// 1,980 MHz). At falcon-mamba-7b's (1, 2048, 8192, 16) in f32 that is
// 0.060 ms of bytes, 0.048 ms of f32 operations and 0.064 ms of exp: the
// scan is bound by its exponentials, then by its bytes.
//
// Design (simple and right first). The Pallas grid walks the L-chunks of a
// (batch, channel block) in order and carries h in scratch; CUDA blocks run
// in no order, so here one CTA owns a (batch, channel range) and loops over
// all of L itself. The parallelism comes from d_inner x N: one thread per
// state element (d, n), NP lanes per channel (N rounded up to a power of two
// <= 32; lanes past N hold h = 0), THREADS / NP channels per CTA; at
// (1, L, 8192, 16) that is 512 CTAs and 131,072 threads. y_t is the sum of a
// channel's NP lanes by __shfl_xor_sync. Each chunk of TC time steps of x
// and dt (coalesced along the channels) and of B and C (shared by every
// channel) is staged in shared memory, and the next chunk's loads are
// issued into registers before the current chunk is stepped through, so a
// global load's latency is paid once a chunk, not once a step. A chunk's y
// is kept in shared memory over x's slots (only the channel's own lanes
// read them, and they have all read step s once the shuffles of step s are
// done) and written out coalesced. expf, not __expf; --fmad=false keeps
// h * da + bx two roundings, as the plain version rounds them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int THREADS = 256;              // threads per CTA
constexpr int NMAX = 32;                  // largest state size N instantiated
constexpr int SMEM_BUDGET = 40 * 1024;    // bytes of static shared memory per CTA

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Time steps per staged chunk: the largest power of two <= 64 whose x, dt,
// B and C tiles fit SMEM_BUDGET (64 at NP >= 4, 32 at NP 2, 16 at NP 1).
template <int NP>
__host__ __device__ constexpr int chunk_steps() {
  int tc = 64;
  while (tc > 1 && tc * (2 * (THREADS / NP) + 2 * NP) * 4 > SMEM_BUDGET) tc /= 2;
  return tc;
}

// Loads the chunk starting at time t0 into this thread's registers: XE
// elements of x and dt, BE of B and C (0 past L, d_inner or N).
template <int NP, int TC, int XE, int BE, typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ xb, const T* __restrict__ dtb,
                                           const T* __restrict__ bb, const T* __restrict__ cb,
                                           int t0, int d0, int len, int di, int n,
                                           float (&rx)[XE], float (&rdt)[XE], float (&rb)[BE],
                                           float (&rc)[BE]) {
  constexpr int CH = THREADS / NP;
#pragma unroll
  for (int e = 0; e < XE; ++e) {
    const int i = threadIdx.x + e * THREADS;
    const int t = t0 + i / CH, d = d0 + i % CH;
    const bool ok = t < len && d < di;
    const long long off = (long long)t * di + d;
    rx[e] = ok ? to_f32(xb[off]) : 0.f;
    rdt[e] = ok ? to_f32(dtb[off]) : 0.f;
  }
#pragma unroll
  for (int e = 0; e < BE; ++e) {
    const int i = threadIdx.x + e * THREADS;
    const int t = t0 + i / NP, k = i % NP;
    const bool ok = i < TC * NP && t < len && k < n;
    const long long off = (long long)t * n + k;
    rb[e] = ok ? to_f32(bb[off]) : 0.f;
    rc[e] = ok ? to_f32(cb[off]) : 0.f;
  }
}

// One CTA per (channel range of THREADS / NP channels, batch row).
template <int NP, typename T>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      const float* __restrict__ a, T* __restrict__ y,
                      float* __restrict__ h_last, int len, int di, int n) {
  constexpr int CH = THREADS / NP;                        // channels per CTA
  constexpr int TC = chunk_steps<NP>();                   // time steps per chunk
  constexpr int XE = TC * CH / THREADS;                   // x/dt elements a thread stages
  constexpr int BE = (TC * NP + THREADS - 1) / THREADS;   // B/C elements a thread stages
  static_assert(TC * CH % THREADS == 0, "a chunk of x must split evenly over the CTA");
  __shared__ float sx[TC][CH];    // x of the chunk, then its y
  __shared__ float sdt[TC][CH];
  __shared__ float sb[TC][NP];
  __shared__ float sc[TC][NP];

  const int tid = threadIdx.x;
  const int c = tid / NP;         // this thread's channel within the CTA
  const int k = tid % NP;         // and its state index
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const long long row = blockIdx.y;
  const T* xb = x + row * len * di;
  const T* dtb = dt + row * len * di;
  const T* bb = bm + row * len * n;
  const T* cb = cm + row * len * n;
  T* yb = y + row * len * di;

  const bool live = d < di && k < n;
  const float av = live ? a[(long long)d * n + k] : 0.f;
  float h = 0.f;

  float rx[XE], rdt[XE], rb[BE], rc[BE];
  load_chunk<NP, TC, XE, BE>(xb, dtb, bb, cb, 0, d0, len, di, n, rx, rdt, rb, rc);
  for (int t0 = 0; t0 < len; t0 += TC) {
    // The registers hold chunk t0: stage it.
#pragma unroll
    for (int e = 0; e < XE; ++e) {
      const int i = tid + e * THREADS;
      sx[i / CH][i % CH] = rx[e];
      sdt[i / CH][i % CH] = rdt[e];
    }
#pragma unroll
    for (int e = 0; e < BE; ++e) {
      const int i = tid + e * THREADS;
      if (i < TC * NP) {
        sb[i / NP][i % NP] = rb[e];
        sc[i / NP][i % NP] = rc[e];
      }
    }
    __syncthreads();
    // The next chunk's loads are in flight while this one is stepped through.
    if (t0 + TC < len)
      load_chunk<NP, TC, XE, BE>(xb, dtb, bb, cb, t0 + TC, d0, len, di, n, rx, rdt, rb, rc);
    const int steps = min(TC, len - t0);
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
      const float dtv = sdt[s][c];
      const float da = expf(dtv * av);
      h = h * da + (dtv * sx[s][c]) * sb[s][k];
      float p = h * sc[s][k];
#pragma unroll
      for (int off = NP / 2; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (k == 0) sx[s][c] = p;
    }
    __syncthreads();
    // The chunk's y, coalesced along the channels.
#pragma unroll
    for (int e = 0; e < XE; ++e) {
      const int i = tid + e * THREADS;
      const int t = t0 + i / CH, dd = d0 + i % CH;
      if (t < len && dd < di) store(&yb[(long long)t * di + dd], sx[i / CH][i % CH]);
    }
    __syncthreads();   // before the next chunk overwrites the tiles
  }
  if (live) h_last[(row * di + d) * n + k] = h;
}

template <int NP, typename T>
static cudaError_t launch_np(const void* x, const void* dt, const void* b, const void* c,
                             const void* a, void* y, void* h_last, int bsz, int len, int di,
                             int n, cudaStream_t st) {
  constexpr int CH = THREADS / NP;
  const dim3 grid((di + CH - 1) / CH, bsz);
  selective_scan_kernel<NP, T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(a), static_cast<T*>(y),
      static_cast<float*>(h_last), len, di, n);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_t(const void* x, const void* dt, const void* b, const void* c,
                            const void* a, void* y, void* h_last, int bsz, int len, int di,
                            int n, cudaStream_t st) {
  if (n <= 1) return launch_np<1, T>(x, dt, b, c, a, y, h_last, bsz, len, di, n, st);
  if (n <= 2) return launch_np<2, T>(x, dt, b, c, a, y, h_last, bsz, len, di, n, st);
  if (n <= 4) return launch_np<4, T>(x, dt, b, c, a, y, h_last, bsz, len, di, n, st);
  if (n <= 8) return launch_np<8, T>(x, dt, b, c, a, y, h_last, bsz, len, di, n, st);
  if (n <= 16) return launch_np<16, T>(x, dt, b, c, a, y, h_last, bsz, len, di, n, st);
  return launch_np<32, T>(x, dt, b, c, a, y, h_last, bsz, len, di, n, st);
}

// x, dt (B, L, d_inner), b, c (B, L, N): all f32 or all bf16 (bf16 != 0),
// contiguous; a (d_inner, N) f32; y like x; h_last (B, d_inner, N) f32.
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int repro_selective_scan_launch(const void* x, const void* dt, const void* b,
                                           const void* c, const void* a, void* y,
                                           void* h_last, int bsz, int len, int di, int n,
                                           int bf16, void* stream) {
  if (bsz <= 0 || len <= 0 || di <= 0 || n <= 0 || n > NMAX || bsz > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return (int)launch_t<__nv_bfloat16>(x, dt, b, c, a, y, h_last, bsz, len, di, n, st);
  return (int)launch_t<float>(x, dt, b, c, a, y, h_last, bsz, len, di, n, st);
}

extern "C" int repro_selective_scan_max_state(void) { return NMAX; }

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
