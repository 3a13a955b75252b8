// K4 on Hopper: attention with an online softmax (flash attention).
//
// Replaces repro/kernels/flash_attention.py::_kernel (the Pallas K4 body,
// launched by flash_attention through pl.pallas_call). Computes, for each
// (batch, head), softmax(q k^T / sqrt(D), masked to -1e30 above the diagonal
// when causal) v over (B, H, S, D) q and (B, H, T, D) k and v, f32
// arithmetic on f32 or bf16 inputs, and writes acc / max(l, 1e-30) in q's
// dtype. The mask is by index (row >= col), as the reference's.
//
// Bound on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32, an FMA counted as two),
// as chip_smoke.py counts it (flash_bound): each (query, key) pair the mask
// keeps costs 2D FMAs (q.k and p*v) and 4 more operations (the running max,
// the subtraction, exp, the sum). At (1, 32, 2048, 64) causal f32 that is
// 67 M pairs, 8.9 G instructions, 0.27 ms at 33.5 T instructions/s, against
// 67 MB of q, k, v and output (0.02 ms): attention at this length is bound
// by operations, not by bytes.
//
// Design (simple and right first): one CTA of 128 threads per (query tile
// of 64 rows, head, batch); a pair of threads per query row, each holding
// the row's q (scaled in f32, as the reference scales it) and accumulator
// for half of the head dims in registers, interleaved by 4 dims so that the
// pair reads neighbouring 16-byte words of shared memory. Each 64-key tile
// of k and v is staged in dynamic shared memory as f32 (zero-padded to the
// instantiated width DP, so no dim is predicated); every thread of a warp
// reads the same key, so the reads broadcast. A score is the sum of the
// pair's two partial dots (one shuffle); the running max m, the sum l and
// the accumulator are updated key by key, rescaled only when the max
// grows. With causal, the tiles above the diagonal are skipped and the keys
// above it inside the diagonal tile are left out: in the reference they add
// exactly 0 once the first tile has set m. The products use explicit fmaf
// (K4 is held to a tolerance, not to bits, so the --fmad=false the edge
// kernels need costs it nothing here), and expf, not __expf. Left for the
// speed work: wgmma on bf16/tf32 tiles, TMA copies, warp specialisation,
// several rows per thread to reuse each shared-memory read.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int BQ = 64;            // query rows per CTA
constexpr int BK = 64;            // keys per shared-memory tile
constexpr int THREADS = 2 * BQ;   // a pair of threads per query row
constexpr int DMAX = 128;         // largest head dim instantiated
constexpr float NEG = -1e30f;     // the reference's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// DP: the head dim rounded up to a multiple of 8 (8, 16, 32, 64 or 128).
// Thread p of a row's pair owns dims 8c + 4p .. 8c + 4p + 3, c < DP / 8.
template <int DP, typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int heads, int s_len, int t_len, int d, int causal,
             float scale) {
  constexpr int HALF = DP / 2;
  constexpr int C4 = HALF / 4;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [BK][DP]
  float* vs = ks + BK * DP;                     // [BK][DP]

  const int tid = threadIdx.x;
  const int p = tid & 1;
  const int q0 = blockIdx.x * BQ;
  const int row = q0 + (tid >> 1);
  const long long bh = (long long)blockIdx.z * heads + blockIdx.y;
  const T* qb = q + bh * s_len * d;
  const T* kb = k + bh * t_len * d;
  const T* vb = v + bh * t_len * d;

  float qr[HALF], acc[HALF];
#pragma unroll
  for (int c = 0; c < C4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = 8 * c + 4 * p + e;
      qr[4 * c + e] = (row < s_len && dim < d) ? to_f32(qb[(long long)row * d + dim]) * scale
                                               : 0.f;
      acc[4 * c + e] = 0.f;
    }
  }
  float m = NEG, l = 0.f;

  const int row_last = min(q0 + BQ, s_len) - 1;
  int n_tiles = (t_len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, row_last / BK + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BK * DP; i += THREADS) {
      const int j = i / DP, dim = i - j * DP;
      const bool in = k0 + j < t_len && dim < d;
      const long long g = (long long)(k0 + j) * d + dim;
      ks[i] = in ? to_f32(kb[g]) : 0.f;
      vs[i] = in ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();
    const int n_keys = min(BK, t_len - k0);
    for (int j = 0; j < n_keys; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * DP) + p;
      float px = 0.f, py = 0.f, pz = 0.f, pw = 0.f;
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        const float4 kk = kr[2 * c];
        px = fmaf(qr[4 * c], kk.x, px);
        py = fmaf(qr[4 * c + 1], kk.y, py);
        pz = fmaf(qr[4 * c + 2], kk.z, pz);
        pw = fmaf(qr[4 * c + 3], kk.w, pw);
      }
      const float part = (px + py) + (pz + pw);
      // Every lane reaches the shuffle: the key loop is uniform over the CTA.
      const float s = part + __shfl_xor_sync(0xffffffffu, part, 1);
      if (causal && k0 + j > row) continue;  // above the diagonal: adds exactly 0
      if (s > m) {
        const float corr = expf(m - s);
        l *= corr;
#pragma unroll
        for (int i = 0; i < HALF; ++i) acc[i] *= corr;
        m = s;
      }
      const float pj = expf(s - m);
      l += pj;
      const float4* vr = reinterpret_cast<const float4*>(vs + j * DP) + p;
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        const float4 vv = vr[2 * c];
        acc[4 * c] = fmaf(pj, vv.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(pj, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(pj, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(pj, vv.w, acc[4 * c + 3]);
      }
    }
  }
  if (row >= s_len) return;
  const float denom = fmaxf(l, 1e-30f);
  T* ob = out + bh * s_len * d + (long long)row * d;
#pragma unroll
  for (int c = 0; c < C4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = 8 * c + 4 * p + e;
      if (dim < d) store(ob + dim, acc[4 * c + e] / denom);
    }
  }
}

template <int DP, typename T>
static cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int h,
                          int s, int t, int d, int causal, float scale, cudaStream_t stream) {
  const int smem = 2 * BK * DP * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<DP, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  flash_kernel<DP, T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, h, s, t, d, causal, scale);
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
