// Paged-attention decode for Hopper (sm_90a): one query token per sequence
// attends over its pages of the global KV pool.
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention (Pallas
// `_kernel`, grid (B, Hkv, NP) with the block table scalar-prefetched).
// Plain version: repro_torch/kernels/ref.py::paged_attention_ref.
//
// Bound on the H100: bytes. Per (sequence, KV head) the kernel reads each
// valid K/V slot once (2 * len * hd elements) and does 4 * G * len * hd
// flops on them — G = H/Hkv = 4 flops per byte in bf16, far below the
// ~295 flops/byte the card needs before compute binds. So the least time is
// (K/V bytes + q + out) / 3.35 TB/s.
//
// Design (right and simple first):
//  * grid (B, Hkv): one block per (sequence, KV head) holding its G query
//    heads. The block loads its own block-table row and length (the TPU's
//    scalar prefetch becomes a plain load) and loops over its pages inside
//    the block — the Pallas grid's sequential NP axis becomes that loop.
//  * Each iteration stages a chunk of PPI pages (about 64 keys) of K and V
//    into shared memory as fp32, so every thread has several loads in
//    flight before the barrier; K rows are padded to hd+1 floats so the
//    score loop (one thread per (head, key)) reads distinct banks.
//  * fp32 online softmax (m, l, acc) for the G rows lives in shared memory;
//    softcap, sliding window (pos > len-1-window) and length masks are
//    applied as the Pallas body does, with masked scores at -1e30. Pages
//    wholly before the window or past the length are skipped (their
//    contribution is exactly zero once a valid key is seen).
//  * denom = max(l, 1e-30), output in q's dtype.
//  * Known limit: at the main-path shape B*Hkv = 8*8 = 64 blocks under-fill
//    the H100's 132 SMs, and each block walks its pages serially. A split-K
//    (flash-decoding) design with a second combine pass is the later fix.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int NT = 128;          // threads per block
constexpr float NEG = -1e30f;    // masked score, as in the Pallas body

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int H, int Hkv, int hd, int P, int maxp, int ppi,
                       float scale, float softcap, int window) {
  const int b = blockIdx.x, kvh = blockIdx.y, t = threadIdx.x;
  const int G = H / Hkv;
  const int KC = ppi * P;                      // keys staged per iteration
  const int hdp = hd + 1;
  extern __shared__ float sm[];
  float* q_s = sm;                             // (G, hd)
  float* k_s = q_s + G * hd;                   // (KC, hd+1)
  float* v_s = k_s + KC * hdp;                 // (KC, hd)
  float* s_s = v_s + KC * hd;                  // (G, KC)
  float* acc_s = s_s + G * KC;                 // (G, hd)
  float* m_s = acc_s + G * hd;                 // (G,)
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const int len = lengths[b];
  const int* bt = block_tables + (long long)b * maxp;
  const long long q_off = ((long long)b * H + (long long)kvh * G) * hd;
  for (int e = t; e < G * hd; e += NT) {
    q_s[e] = to_f(q[q_off + e]);
    acc_s[e] = 0.f;
  }
  for (int g = t; g < G; g += NT) { m_s[g] = NEG; l_s[g] = 0.f; }

  // keys with pos > len-1-window, i.e. pos >= len-window (int32-safe: the
  // global sentinel window 2^30 only makes len-window more negative)
  const int key_lo = window > 0 ? max(0, len - window) : 0;
  const int pg_end = min((len + P - 1) / P, maxp);
  for (int pg0 = key_lo / P; pg0 < pg_end; pg0 += ppi) {
    const int npg = min(ppi, pg_end - pg0);
    const int kc = npg * P;
    __syncthreads();                           // previous chunk consumed
    for (int e = t; e < kc * hd; e += NT) {
      const int j = e / hd, d = e - j * hd;
      const long long page = bt[pg0 + j / P];
      const long long src = ((page * P + (j % P)) * Hkv + kvh) * hd + d;
      k_s[j * hdp + d] = to_f(k_pages[src]);
      v_s[j * hd + d] = to_f(v_pages[src]);
    }
    __syncthreads();
    for (int e = t; e < G * kc; e += NT) {
      const int g = e / kc, j = e - g * kc;
      const int pos = pg0 * P + j;
      const float* qr = q_s + g * hd;
      const float* kr = k_s + j * hdp;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      bool valid = pos < len;
      if (window > 0) valid = valid && (pos > len - 1 - window);
      s_s[g * KC + j] = valid ? s : NEG;
    }
    __syncthreads();
    for (int g = t; g < G; g += NT) {
      float* sr = s_s + g * KC;
      const float m_prev = m_s[g];
      float mx = m_prev;
      for (int j = 0; j < kc; ++j) mx = fmaxf(mx, sr[j]);
      float sum = 0.f;
      for (int j = 0; j < kc; ++j) {
        const float pr = expf(sr[j] - mx);
        sr[j] = pr;
        sum += pr;
      }
      const float corr = expf(m_prev - mx);
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = mx;
      c_s[g] = corr;
    }
    __syncthreads();
    for (int e = t; e < G * hd; e += NT) {
      const int g = e / hd, d = e - g * hd;
      const float* pr = s_s + g * KC;
      float a = acc_s[e] * c_s[g];
      for (int j = 0; j < kc; ++j) a = fmaf(pr[j], v_s[j * hd + d], a);
      acc_s[e] = a;
    }
  }
  __syncthreads();
  for (int e = t; e < G * hd; e += NT) {
    const int g = e / hd;
    out[q_off + e] = from_f<T>(acc_s[e] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bt,
           const void* lens, void* out, int B, int H, int Hkv, int hd, int P,
           int maxp, float softcap, int window, cudaStream_t stream) {
  const int G = H / Hkv;
  const int ppi = P >= 64 ? 1 : 64 / P;
  const int KC = ppi * P;
  const size_t smem = sizeof(float) *
      ((size_t)G * hd * 2 + (size_t)KC * (hd + 1) + (size_t)KC * hd +
       (size_t)G * KC + 3 * (size_t)G);
  auto kern = paged_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const float scale = 1.0f / sqrtf((float)hd);
  kern<<<dim3(B, Hkv), NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)bt,
      (const int*)lens, (T*)out, H, Hkv, hd, P, maxp, ppi, scale, softcap,
      window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. softcap <= 0 and window <= 0 mean none.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* out, int B, int H,
    int Hkv, int hd, int P, int maxp, int dtype, float softcap, int window,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, block_tables, lengths, out, B,
                         H, Hkv, hd, P, maxp, softcap, window, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, lengths,
                                 out, B, H, Hkv, hd, P, maxp, softcap, window,
                                 s);
  return (int)cudaErrorInvalidValue;
}
