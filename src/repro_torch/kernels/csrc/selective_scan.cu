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
// 0.060 ms of bytes, 0.048 ms of f32 operations and 0.064 ms of exp. What
// bounds the kernel in practice is instruction issue: an accurate expf is
// about eight instructions, so a (t, d, n) costs some 15-20 of them.
//
// What held the first version back (tools/profile_k5.py on an H100 80GB
// HBM3 at 700 W): one thread per state element (d, n), so every (t, d, n)
// re-read dt, x, B and C from shared memory, recomputed dt * x (the same
// for all N lanes of a channel) and paid four __shfl_xor_sync and four adds
// to reduce y: tens of instructions for one exp and six flops, 0.59 ms at
// (1, 2048, 8192, 16) and 14.6 us of device time a launch at the ssm
// engine's prefills (L = 8-64), about ten times its bound.
//
// Design. The Pallas grid walks the L-chunks of a (batch, channel block) in
// order and carries h in scratch; CUDA blocks run in no order, so one CTA
// owns a (batch, channel range) and loops over all of L itself. A thread
// owns one channel and a group of G of its states, in registers: state n =
// j + i * TPC for i < G, where j is the thread's index among the TPC = NP / G
// threads of its channel (NP is N rounded up to a power of two; states past
// N hold h = 0). dt * x is formed once a step per thread, B_t and C_t are
// read from shared memory (the same words for every channel), and the G
// exponentials of a step do not depend on h, so they and those of later
// steps (the step loop is unrolled) overlap the G independent h chains. y_t
// is reduced in registers, then over the TPC threads by log2(TPC) shuffles,
// in the pairwise order of the first version's xor butterfly over NP lanes:
// the strided groups make the butterfly's large offsets local adds, so y
// keeps the first version's bits (and the plain version's, which matched
// them). Chunks of TC steps of x and dt (coalesced along the channels) and
// of B and C (contiguous in memory) are double-buffered in shared memory:
// chunk k + 1 is copied with 16-byte cp.async while chunk k is stepped
// through, wherever the rows are 16-byte aligned (any f32 or bf16 Mamba
// shape); elsewhere plain loads fill the next buffer before the steps. A
// chunk's y is collected in shared memory and written out coalesced. expf,
// not __expf; --fmad=false keeps h * da + bx two roundings, as the plain
// version rounds them.
//
// bf16 elements (BF16E, the model's ssm_scan_dtype="bfloat16"): the
// reference's chunked scan on bf16 elements with an f32 carry, taken step
// by step. At every t with t % q == 0 (q: the scan's chunk) a thread keeps
// hc = h and restarts the chunk's composed decay A and input Bc; then
//   da = bf16(exp(dt * A_dn)), bx = bf16((dt * x) * B),
//   A = bf16(A * da), Bc = bf16(da * Bc + bx) (the product rounded to f32
//   first), h = A * hc + Bc in f32, y = sum_n C * h,
// the chunk's first step taking A = da and Bc = bx. The elements live in
// registers only, so this changes the rounding, not the traffic. It is an
// instance of its own (a template flag): the f32 instance is unchanged.
//
// Build: nvcc -gencode arch=compute_90a,code=[sm_90a,compute_90a] -O3 --fmad=false

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define K5_GROUP 4    // states a thread holds (more where N > 32 * K5_GROUP)
#define K5_CHUNK 32   // time steps per staged chunk (fewer where N is large)

constexpr int THREADS = 128;              // threads per CTA
constexpr int NMAX = 1024;                // largest state size N instantiated
constexpr int SMEM_BUDGET = 40 * 1024;    // bytes of static shared memory per CTA

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
// x rounded to bf16 (to nearest even), held in f32.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// States a thread holds for a padded state size NP: K5_GROUP, or enough
// that a channel's threads fit one warp.
__host__ __device__ constexpr int group_of(int np) {
  return np < K5_GROUP ? np : (np / 32 > K5_GROUP ? np / 32 : K5_GROUP);
}

// Time steps per staged chunk: the largest power of two <= K5_CHUNK whose
// two buffers of x, dt, B and C and the chunk's y fit SMEM_BUDGET.
__host__ __device__ constexpr int chunk_steps(int np, int es) {
  const int ch = THREADS / (np / group_of(np));
  int tc = K5_CHUNK;
  while (tc > 1 && tc * (2 * (2 * ch + 2 * np) * es + 4 * ch) > SMEM_BUDGET) tc /= 2;
  return tc;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies the chunk of TC steps from t0 into one buffer: x and dt rows of
// the CTA's CH channels ([TC][CH]) and B and C ([TC][N], contiguous in
// memory and in the buffer). ASYNC: 16-byte cp.async pieces (the caller
// checked that every row and chunk starts on 16 bytes; a chunk's last piece
// of B and C may be short, and is zero-filled); else plain loads and stores.
template <bool ASYNC, int TC, int CH, typename T>
__device__ __forceinline__ void copy_chunk(const T* __restrict__ xb, const T* __restrict__ dtb,
                                           const T* __restrict__ bb, const T* __restrict__ cb,
                                           int t0, int d0, int len, int di, int n, T* sx, T* sdt,
                                           T* sb, T* sc) {
  const int steps = min(TC, len - t0);
  const int chs = min(CH, di - d0);
  if (ASYNC) {
    constexpr int PER = 16 / sizeof(T);                 // elements per piece
    const int row_pieces = chs / PER;                   // chs * sizeof(T) % 16 == 0
    for (int q = threadIdx.x; q < steps * row_pieces; q += THREADS) {
      const int s = q / row_pieces, e = (q - s * row_pieces) * PER;
      const long long off = (long long)(t0 + s) * di + d0 + e;
      cp_async16(sx + s * CH + e, xb + off, 16);
      cp_async16(sdt + s * CH + e, dtb + off, 16);
    }
    const int bytes = steps * n * (int)sizeof(T);
    const long long boff = (long long)t0 * n;
    for (int q = threadIdx.x; q * 16 < bytes; q += THREADS) {
      const int left = min(16, bytes - q * 16);
      cp_async16(sb + q * PER, bb + boff + q * PER, left);
      cp_async16(sc + q * PER, cb + boff + q * PER, left);
    }
  } else {
    for (int q = threadIdx.x; q < steps * CH; q += THREADS) {
      const int s = q / CH, c = q - s * CH;
      if (c < chs) {
        const long long off = (long long)(t0 + s) * di + d0 + c;
        sx[q] = xb[off];
        sdt[q] = dtb[off];
      }
    }
    for (int q = threadIdx.x; q < steps * n; q += THREADS) {
      sb[q] = bb[(long long)t0 * n + q];
      sc[q] = cb[(long long)t0 * n + q];
    }
  }
}

// One CTA per (channel range of CH = THREADS / TPC channels, batch row).
// BF16E: bf16 scan elements in chunks of q steps (see the header).
template <int NP, typename T, bool ASYNC, bool BF16E>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const T* __restrict__ bm, const T* __restrict__ cm,
                      const float* __restrict__ a, T* __restrict__ y,
                      float* __restrict__ h_last, int len, int di, int n, int q) {
  constexpr int G = group_of(NP);                   // states a thread holds
  constexpr int TPC = NP / G;                       // threads a channel
  constexpr int CH = THREADS / TPC;                 // channels a CTA
  constexpr int TC = chunk_steps(NP, sizeof(T));    // time steps a chunk
  static_assert(TPC <= 32 && TPC * G == NP, "a channel's threads share one warp");
  __shared__ __align__(16) T sx[2][TC * CH];
  __shared__ __align__(16) T sdt[2][TC * CH];
  __shared__ __align__(16) T sb[2][TC * NP];
  __shared__ __align__(16) T sc[2][TC * NP];
  __shared__ float sy[TC * CH];

  const int tid = threadIdx.x;
  const int c = tid / TPC;        // this thread's channel within the CTA
  const int j = tid % TPC;        // and its index among the channel's threads
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const long long row = blockIdx.y;
  const T* xb = x + row * len * di;
  const T* dtb = dt + row * len * di;
  const T* bb = bm + row * len * n;
  const T* cb = cm + row * len * n;
  T* yb = y + row * len * di;

  float h[G], av[G];
  float hc[G], acc_a[G], acc_b[G];   // BF16E: the chunk's carry, composed decay and input
  int left = 0;                      // BF16E: steps left in the scan's chunk
  bool live[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int k = j + i * TPC;
    live[i] = d < di && k < n;
    av[i] = live[i] ? a[(long long)d * n + k] : 0.f;
    h[i] = 0.f;
  }

  const int chunks = (len + TC - 1) / TC;
  copy_chunk<ASYNC, TC, CH>(xb, dtb, bb, cb, 0, d0, len, di, n, sx[0], sdt[0], sb[0], sc[0]);
  cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    const int buf = k & 1;
    const int t0 = k * TC;
    if (k + 1 < chunks) {
      copy_chunk<ASYNC, TC, CH>(xb, dtb, bb, cb, t0 + TC, d0, len, di, n, sx[buf ^ 1],
                                sdt[buf ^ 1], sb[buf ^ 1], sc[buf ^ 1]);
      cp_async_commit();
      cp_async_wait<1>();   // chunk k has landed; chunk k + 1 stays in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* px = sx[buf] + c;
    const T* pdt = sdt[buf] + c;
    const T* pb = sb[buf] + j;
    const T* pc = sc[buf] + j;
    const int steps = min(TC, len - t0);
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
      const float dtv = to_f32(pdt[s * CH]);
      const float dx = dtv * to_f32(px[s * CH]);
      float da[G], p[G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        da[i] = expf(dtv * av[i]);
      }
      if constexpr (BF16E) {
        const bool first = left == 0;
        left = (first ? q : left) - 1;
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const float bv = live[i] ? to_f32(pb[s * n + i * TPC]) : 0.f;
          const float cv = live[i] ? to_f32(pc[s * n + i * TPC]) : 0.f;
          const float dab = bf16_round(da[i]);
          const float bx = bf16_round(dx * bv);
          if (first) {
            hc[i] = h[i];
            acc_a[i] = dab;
            acc_b[i] = bx;
          } else {
            acc_a[i] = bf16_round(acc_a[i] * dab);
            acc_b[i] = bf16_round(dab * acc_b[i] + bx);
          }
          h[i] = acc_a[i] * hc[i] + acc_b[i];
          p[i] = h[i] * cv;
        }
      } else {
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const float bv = live[i] ? to_f32(pb[s * n + i * TPC]) : 0.f;
          const float cv = live[i] ? to_f32(pc[s * n + i * TPC]) : 0.f;
          h[i] = h[i] * da[i] + dx * bv;
          p[i] = h[i] * cv;
        }
      }
      // The xor butterfly over NP lanes: offsets of TPC and more are adds
      // of the thread's own states, the rest shuffles.
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < off; ++i) p[i] = p[i] + p[i + off];
      }
#pragma unroll
      for (int off = TPC / 2; off > 0; off >>= 1) p[0] += __shfl_xor_sync(0xffffffffu, p[0], off);
      if (j == 0) sy[s * CH + c] = p[0];
    }
    __syncthreads();   // every step's y is in sy, and buffer buf is free again
    // The chunk's y, coalesced along the channels.
    for (int q = tid; q < steps * CH; q += THREADS) {
      const int s = q / CH, cc = q - s * CH;
      if (d0 + cc < di) store(&yb[(long long)(t0 + s) * di + d0 + cc], sy[q]);
    }
  }
#pragma unroll
  for (int i = 0; i < G; ++i) {
    if (live[i]) h_last[(row * di + d) * n + j + i * TPC] = h[i];
  }
}

// Whether every copy of a launch can be a 16-byte cp.async: the tensors
// start on 16 bytes, and so does every row of x and dt, every channel range
// and every chunk of B and C.
template <int NP, typename T>
static bool async_ok(const void* x, const void* dt, const void* b, const void* c, int len,
                     int di, int n) {
  constexpr int G = group_of(NP), CH = THREADS / (NP / G), TC = chunk_steps(NP, sizeof(T));
  const size_t es = sizeof(T);
  for (const void* p : {x, dt, b, c}) {
    if ((uintptr_t)p % 16) return false;
  }
  return (di * es) % 16 == 0 && (CH * es) % 16 == 0 && ((size_t)TC * n * es) % 16 == 0 &&
         ((size_t)len * n * es) % 16 == 0;
}

template <int NP, typename T>
static cudaError_t launch_np(const void* x, const void* dt, const void* b, const void* c,
                             const void* a, void* y, void* h_last, int bsz, int len, int di,
                             int n, bool bf16e, int q, int* route, cudaStream_t st) {
  constexpr int CH = THREADS / (NP / group_of(NP));
  const dim3 grid((di + CH - 1) / CH, bsz);
  const bool async = async_ok<NP, T>(x, dt, b, c, len, di, n);
  *route = async ? 1 : 0;
  auto kernel = bf16e ? (async ? selective_scan_kernel<NP, T, true, true>
                               : selective_scan_kernel<NP, T, false, true>)
                      : (async ? selective_scan_kernel<NP, T, true, false>
                               : selective_scan_kernel<NP, T, false, false>);
  kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(a), static_cast<T*>(y),
      static_cast<float*>(h_last), len, di, n, q);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_t(const void* x, const void* dt, const void* b, const void* c,
                            const void* a, void* y, void* h_last, int bsz, int len, int di,
                            int n, bool bf16e, int q, int* route, cudaStream_t st) {
#define K5_NP(NPV)                                                                           \
  if (n <= NPV)                                                                              \
    return launch_np<NPV, T>(x, dt, b, c, a, y, h_last, bsz, len, di, n, bf16e, q, route, st);
  K5_NP(1) K5_NP(2) K5_NP(4) K5_NP(8) K5_NP(16) K5_NP(32) K5_NP(64) K5_NP(128) K5_NP(256)
  K5_NP(512) K5_NP(1024)
#undef K5_NP
  return cudaErrorInvalidValue;
}

// x, dt (B, L, d_inner), b, c (B, L, N): all f32 or all bf16 (bf16 != 0),
// contiguous; a (d_inner, N) f32; y like x; h_last (B, d_inner, N) f32.
// bf16_elements != 0: the scan on bf16 elements in chunks of q steps (q
// divides len). Launches on `stream` and returns the launch's cudaError_t;
// *route is set to the copy route taken (1: 16-byte cp.async, 0: plain
// loads).
extern "C" int repro_selective_scan_launch(const void* x, const void* dt, const void* b,
                                           const void* c, const void* a, void* y,
                                           void* h_last, int bsz, int len, int di, int n,
                                           int bf16, int bf16_elements, int q, int* route,
                                           void* stream) {
  if (bsz <= 0 || len <= 0 || di <= 0 || n <= 0 || n > NMAX || bsz > 65535 || q <= 0 ||
      len % q)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool e = bf16_elements != 0;
  if (bf16)
    return (int)launch_t<__nv_bfloat16>(x, dt, b, c, a, y, h_last, bsz, len, di, n, e, q, route,
                                        st);
  return (int)launch_t<float>(x, dt, b, c, a, y, h_last, bsz, len, di, n, e, q, route, st);
}

extern "C" int repro_selective_scan_max_state(void) { return NMAX; }

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
