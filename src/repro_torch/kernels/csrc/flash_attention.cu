// K4 on Hopper: attention with an online softmax (flash attention), on the
// tensor cores in f32 accuracy (3xTF32).
//
// Replaces repro/kernels/flash_attention.py::_kernel (the Pallas K4 body,
// launched by flash_attention through pl.pallas_call). Computes, for each
// (batch, head), softmax(q k^T / sqrt(D), masked to -1e30 above the diagonal
// when causal) v over (B, H, S, D) q and (B, H, T, D) k and v, f32
// arithmetic on f32 or bf16 inputs, and writes acc / max(l, 1e-30) in q's
// dtype. The mask is by index (row >= col), as the reference's.
//
// Bound on an H100 SXM, as chip_smoke.py counts it (flash_bound): each
// (query, key) pair the mask keeps costs 4D flops of products (q.k and p*v),
// three times over in the 3xTF32 split, at the dense TF32 rate (494.7
// TFLOP/s), and one exp on the special-function units (4.18 T/s). At
// (1, 32, 2048, 64) causal that is 67 M pairs, 51.6 GFLOP (0.104 ms) against
// 0.016 ms of exp and 67 MB of q, k, v and output (0.020 ms): attention at
// this length is bound by the tensor cores. The SIMT kernel this file held
// before (a pair of threads per query row, keys one at a time with scalar
// fmaf) was bound by f32 instructions, 0.26 ms at best and 1.12-1.16 ms
// measured, slower than PyTorch's own attention.
//
// Design (flash attention 2): one CTA of 4 warps per (64 query rows, head,
// batch), each warp owning 16 query rows. Tiles of 64 keys of k and v are
// copied into shared memory with cp.async, double-buffered, so the next
// tile's copy is in flight while this tile's products run. Both products,
// S = q k^T and O += P v, run on mma.sync.m16n8k8 TF32 tensor-core
// instructions with f32 accumulators in registers:
//   * 3xTF32. A TF32 operand keeps 10 bits of mantissa, about three decimal
//     digits, which misses the 2e-5 that K4 is held to. Each f32 operand x
//     is split into big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big),
//     and each product is formed as small*big + big*small + big*big (the
//     small*small term is below f32's rounding), the error-compensated
//     scheme of PyTorch's f32 memory-efficient attention. bf16 k and v are
//     exact in TF32 (their small part is 0), so those terms are dropped.
//     The rounding is done by its integer definition (two instructions; the
//     PTX cvt compiles to four), q is split once, and each of the three
//     products is issued over all 8 (or D/8) accumulators in turn, so the
//     mma on one accumulator are not back to back.
//   * The softmax works on the S fragments in registers: each thread holds
//     two rows' values for 16 keys of the tile; the row max is taken across
//     the quad of threads that share a row with __shfl_xor_sync, and the
//     running max, the sum (kept per thread, reduced once at the end) and
//     the accumulator are rescaled once per tile, not once per key. expf,
//     not __expf.
//   * P goes from the S accumulators straight into the A fragments of P v:
//     the key order inside each group of 8 keys is permuted identically in
//     P and in the rows of v read for it, so no shuffle is needed. The
//     head dims are permuted the same way in q and k, so each thread reads
//     its two k values of a k-step as one 8-byte word.
//   * Shared-memory rows are padded (k: D + 8, v: D + 4 f32 or D + 8 bf16
//     elements) so that the fragment reads are free of bank conflicts.
//   * Causal: tiles above the diagonal are skipped; in the diagonal tile the
//     groups of 8 keys a warp's rows cannot see are skipped and the rest is
//     masked by index. Keys past T are masked in the ragged last tile (whole
//     groups past T skipped), and their v rows are zero-filled by the copy;
//     a warp whose 16 rows all lie past S skips its products.
//   * D is zero-padded to DP, a power of two from 8 to 128 (DMAX), for the
//     k-steps of 8; head dims 1-128 are served.
//
// What bounds it now (tools/profile_k4.py, an H100 80GB HBM3 at 700 W):
// 0.57 ms at (1, 32, 2048, 64) causal f32 against 0.71-0.74 ms for
// F.scaled_dot_product_attention in the same run, 5.5x the bound. One TF32
// product instead of three runs in 0.32 ms, so the two correction products
// and their splits cost the rest: mma.sync reaches a fraction of the TF32
// rate that only wgmma gets to, and every warp splits the whole k and v
// tile itself. At the LM server's prefill shapes (S <= 64, 32 CTAs) the
// launch and the per-CTA setup dominate.
// Left for later work: wgmma and TMA, splitting k and v once per CTA, warp
// specialisation, a persistent grid.
//
// Build: nvcc -gencode arch=compute_90a,code=[sm_90a,compute_90a] -O3 --fmad=false
// (the repository's flags; the products here are tensor-core instructions,
// so --fmad=false only keeps the softmax's scalar arithmetic unfused).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int BQ = 64;            // query rows per CTA
constexpr int BK = 64;            // keys per shared-memory tile
constexpr int WARPS = BQ / 16;    // one warp per 16 query rows
constexpr int THREADS = 32 * WARPS;
constexpr int DMAX = 128;         // largest head dim instantiated

template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr bool kExact = false;  // a TF32 big part does not hold an f32
  __device__ static float f32(float x) { return x; }
  __device__ static float zero() { return 0.f; }
  // p[0] and p[1] (8-byte aligned) as one shared-memory read.
  __device__ static void pair(const float* p, float& a, float& b) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    a = t.x;
    b = t.y;
  }
  __device__ static void store(float* p, float x) { *p = x; }
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr bool kExact = true;   // a bf16 value is exact in TF32
  __device__ static float f32(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 zero() { return __float2bfloat16_rn(0.f); }
  __device__ static void pair(const __nv_bfloat16* p, float& a, float& b) {
    const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(p);
    a = __low2float(t);
    b = __high2float(t);
  }
  __device__ static void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
};

// Shared-memory row strides, in elements (16-byte multiples for cp.async).
template <int DP, typename T> __host__ __device__ constexpr int k_stride() { return DP + 8; }
template <int DP, typename T> __host__ __device__ constexpr int v_stride() {
  return sizeof(T) == 4 ? DP + 4 : DP + 8;
}
template <int DP, typename T> __host__ __device__ constexpr int smem_bytes() {
  return 2 * BK * (k_stride<DP, T>() + v_stride<DP, T>()) * (int)sizeof(T);
}

// cvt.rna.tf32.f32 for finite x, by its definition: round the 13 dropped
// mantissa bits to nearest, ties away from zero, on the magnitude. Two
// integer instructions; the PTX cvt also screens NaN and costs four.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split into its big and small TF32 parts.
struct Frag {
  uint32_t big[4], small[4];
  Frag() = default;
  __device__ __forceinline__ explicit Frag(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], big[i], small[i]);
  }
};

// c[i] += a * b[i] in 3xTF32 for N independent accumulators: the B
// fragments split first, then small*big, big*small and big*big each issued
// over all N, so that the mma on one accumulator are N apart rather than
// back to back. With kExactB (bf16 b) the b-small term is 0 and dropped.
template <int N, bool kExactB>
__device__ __forceinline__ void mma3(float (&c)[N][4], const Frag& a, const float (&b)[N][2],
                                     int active) {
  uint32_t bb[N][2], bs[N][2];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    split(b[i][0], bb[i][0], bs[i][0]);
    split(b[i][1], bb[i][1], bs[i][1]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < active) mma(c[i], a.small, bb[i][0], bb[i][1]);
  if (!kExactB) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < active) mma(c[i], a.big, bs[i][0], bs[i][1]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < active) mma(c[i], a.big, bb[i][0], bb[i][1]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Copy keys k0 .. k0+BK-1 of k and v (rows of d elements) into one buffer:
// with vec, 16-byte cp.async chunks (rows past t_len zero-filled); else
// plain loads and stores. Dims d .. DP-1 of the buffers are never written.
template <int DP, typename T>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* kb, const T* vb, int k0,
                                          int t_len, int d, bool vec) {
  constexpr int KS = k_stride<DP, T>(), VS = v_stride<DP, T>();
  if (vec) {
    const int cpr = d * (int)sizeof(T) / 16;  // chunks per row
    constexpr int EPC = 16 / sizeof(T);        // elements per chunk
    for (int c = threadIdx.x; c < BK * cpr; c += THREADS) {
      const int r = c / cpr, e = (c - r * cpr) * EPC;
      const bool in = k0 + r < t_len;
      const long long g = in ? (long long)(k0 + r) * d + e : 0;
      cp_async16(ks + r * KS + e, kb + g, in ? 16 : 0);
      cp_async16(vs + r * VS + e, vb + g, in ? 16 : 0);
    }
  } else {
    const T zero = Elem<T>::zero();
    for (int i = threadIdx.x; i < BK * d; i += THREADS) {
      const int r = i / d, e = i - r * d;
      const bool in = k0 + r < t_len;
      const long long g = (long long)(k0 + r) * d + e;
      ks[r * KS + e] = in ? kb[g] : zero;
      vs[r * VS + e] = in ? vb[g] : zero;
    }
  }
  cp_async_commit();
}

// DP: the head dim rounded up to a power of two from 8 to 128. Warp w owns
// query rows q0 + 16w .. q0 + 16w + 15; lane = 4 * gid + tig holds rows gid
// and gid + 8 of them. Inside each k-step of 8 dims (and each group of 8
// keys of P v), logical index tig maps to 2 tig and tig + 4 to 2 tig + 1.
template <int DP, typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int heads, int s_len, int t_len, int d, int causal,
             float scale, int vec) {
  constexpr int KS = k_stride<DP, T>(), VS = v_stride<DP, T>();
  constexpr int NK = DP / 8;   // k-steps of q k^T, n-tiles of P v
  constexpr bool kExact = Elem<T>::kExact;
  extern __shared__ float4 smem4[];
  T* kbuf = reinterpret_cast<T*>(smem4);   // [2][BK][KS]
  T* vbuf = kbuf + 2 * BK * KS;            // [2][BK][VS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int wrow = q0 + 16 * warp;         // the warp's first query row
  const long long bh = (long long)blockIdx.z * heads + blockIdx.y;
  const T* qb = q + bh * s_len * d;
  const T* kb = k + bh * t_len * d;
  const T* vb = v + bh * t_len * d;

  // Zero the padded dims of both buffers once; the copies never write them.
  for (int i = tid; i < 2 * BK * (DP - d); i += THREADS) {
    const int r = i / (DP - d), e = d + i % (DP - d);
    kbuf[r * KS + e] = Elem<T>::zero();
    vbuf[r * VS + e] = Elem<T>::zero();
  }

  const int row_last = min(q0 + BQ, s_len) - 1;
  int n_tiles = (t_len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, row_last / BK + 1);
  load_tile<DP, T>(kbuf, vbuf, kb, vb, 0, t_len, d, vec);

  // q, scaled in f32 as the reference scales it: the A fragments of every
  // k-step, [ks][0..3] = rows (gid, gid + 8) x dims (8 ks + 2 tig, + 1),
  // split once here up to D = 64 (kQSplit); at D = 128 the split parts
  // would not fit in registers, so each tile splits them again.
  constexpr bool kQSplit = DP <= 64;
  float qf[NK][4];
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = wrow + gid + ((i & 1) ? 8 : 0);
      const int dim = 8 * ks + 2 * tig + (i >> 1);
      qf[ks][i] = (row < s_len && dim < d) ? Elem<T>::f32(qb[(long long)row * d + dim]) * scale
                                           : 0.f;
    }
  }
  Frag qsplit[kQSplit ? NK : 1];
  if constexpr (kQSplit) {
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) qsplit[ks] = Frag(qf[ks]);
  }

  float o[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) {
      const int nb = (kt + 1) & 1;
      load_tile<DP, T>(kbuf + nb * BK * KS, vbuf + nb * BK * VS, kb, vb, (kt + 1) * BK, t_len,
                       d, vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt has landed for every thread
    const T* ks_ = kbuf + (kt & 1) * BK * KS;
    const T* vs_ = vbuf + (kt & 1) * BK * VS;
    const int k0 = kt * BK;
    // Groups of 8 keys this warp computes: in the diagonal tile those past
    // the warp's last row, in the last tile those past T, and all of them
    // for a warp whose rows lie past S (it stores nothing) are skipped.
    const int span = wrow + 15 - k0;
    int groups = !causal ? 8 : (span < 0 ? 0 : min(8, span / 8 + 1));
    groups = wrow >= s_len ? 0 : min(groups, (t_len - k0 + 7) / 8);

    // S = q k^T, [j][0..3] = rows (gid, gid + 8) x keys (8 j + 2 tig, + 1).
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      const Frag qa = kQSplit ? qsplit[kQSplit ? ks : 0] : Frag(qf[ks]);
      float kf[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kf[j][0] = kf[j][1] = 0.f;
        if (j < groups) Elem<T>::pair(ks_ + (8 * j + gid) * KS + 8 * ks + 2 * tig, kf[j][0], kf[j][1]);
      }
      mma3<8, kExact>(s, qa, kf, groups);
    }

    // Mask (only a tile that crosses the diagonal or T), then the online
    // softmax on the fragments.
    if ((causal && k0 + BK - 1 > wrow) || k0 + BK > t_len) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 8 * j + 2 * tig + (i & 1);
          const int row = wrow + gid + ((i & 2) ? 8 : 0);
          if (j >= groups || key >= t_len || (causal && key > row)) s[j][i] = -INFINITY;
        }
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
    }
    float corr[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // A row that has seen no key yet keeps m = -inf; exp(x - 0) keeps it at 0.
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      corr[r] = expf(m[r] - base[r]);  // 0 while m is -inf
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = expf(s[j][i] - base[i >> 1]);
        l[i >> 1] += s[j][i];
      }
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P v: the A fragment of key group j is (P[gid][2tig], P[gid+8][2tig],
    // P[gid][2tig+1], P[gid+8][2tig+1]) = s[j][0], s[j][2], s[j][1], s[j][3];
    // its B fragment is v rows 8 j + 2 tig and 8 j + 2 tig + 1.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < groups) {
        const float p[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        const Frag pa(p);
        const T* v0 = vs_ + (8 * j + 2 * tig) * VS + gid;
        float vf[NK][2];
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          vf[n][0] = Elem<T>::f32(v0[8 * n]);
          vf[n][1] = Elem<T>::f32(v0[VS + 8 * n]);
        }
        mma3<NK, kExact>(o, pa, vf, NK);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // The row sums over the quad, then out = acc / max(l, 1e-30).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  T* ob = out + bh * s_len * d;
#pragma unroll
  for (int n = 0; n < NK; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = wrow + gid + ((i & 2) ? 8 : 0);
      const int dim = 8 * n + 2 * tig + (i & 1);
      if (row < s_len && dim < d) Elem<T>::store(ob + (long long)row * d + dim, o[n][i] / l[i >> 1]);
    }
  }
}

template <int DP, typename T>
static cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int h,
                          int s, int t, int d, int causal, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP, T>();
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<DP, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  // 16-byte copies need rows of a multiple of 16 bytes and aligned bases.
  const int vec = (d * (int)sizeof(T)) % 16 == 0 && (uintptr_t)k % 16 == 0 &&
                  (uintptr_t)v % 16 == 0;
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  flash_kernel<DP, T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, h, s, t, d, causal, scale, vec);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_dim(const void* q, const void* k, const void* v, void* out, int b,
                              int h, int s, int t, int d, int causal, float scale,
                              cudaStream_t stream) {
  if (d <= 8) return launch<8, T>(q, k, v, out, b, h, s, t, d, causal, scale, stream);
  if (d <= 16) return launch<16, T>(q, k, v, out, b, h, s, t, d, causal, scale, stream);
  if (d <= 32) return launch<32, T>(q, k, v, out, b, h, s, t, d, causal, scale, stream);
  if (d <= 64) return launch<64, T>(q, k, v, out, b, h, s, t, d, causal, scale, stream);
  if (d <= DMAX) return launch<DMAX, T>(q, k, v, out, b, h, s, t, d, causal, scale, stream);
  return cudaErrorInvalidValue;
}

// Launches K4 on `stream` over contiguous (B, H, S, D) q and out and
// (B, H, T, D) k and v, all f32 (bf16 = 0) or all bf16 (bf16 = 1); `scale`
// is 1/sqrt(D) in f32. Returns the launch's cudaError_t.
extern "C" int repro_flash_attention_launch(const void* q, const void* k, const void* v,
                                            void* out, int b, int h, int s, int t, int d,
                                            int causal, int bf16, float scale, void* stream) {
  if (b <= 0 || h <= 0 || s <= 0 || t <= 0 || d <= 0 || d > DMAX) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return (int)launch_dim<__nv_bfloat16>(q, k, v, out, b, h, s, t, d, causal, scale, st);
  return (int)launch_dim<float>(q, k, v, out, b, h, s, t, d, causal, scale, st);
}

extern "C" int repro_flash_max_dim(void) { return DMAX; }

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
