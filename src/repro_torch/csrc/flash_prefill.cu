// Flash prefill for Hopper (sm_90a): causal (optionally sliding-window,
// softcapped) GQA attention of packed query tiles over paged K/V.
//
// Replaces: src/repro/kernels/flash_prefill.py::flash_prefill (Pallas
// `_kernel`, grid (B, H, NQ, NK) with causal/window key-block skipping).
// The JAX engine never launches that kernel: its ragged prefill gathers a
// whole page run per token and runs dense masked attention
// (repro/engine/runners/paged.py:307-313). This kernel reads the pages
// through the block table instead, so the (Tb, Pb*P, Hkv, hd) gather is
// never materialised.
// Plain versions: repro_torch/kernels/ref.py::paged_prefill_ref (paged
// varlen entry) and ::flash_prefill_ref (dense entry).
//
// Bound on the H100: the least time is the larger of bytes / 3.35 TB/s
// (q, out, and each entry's K/V up to its last position, read once) and
// flops / 989 TFLOP/s (4 * H * hd per query-key pair inside the causal
// band, bf16 tensor-core peak). At the main-path shape (512 packed tokens
// over cached prefixes up to ~1k) the two are of the same order
// (chip_smoke.py prints both); longer chunks make the flops dominate. This
// first kernel runs its products on the fp32 CUDA cores, not the tensor
// cores, so it sits far from that bound; wgmma tiles fed by TMA are the
// later work.
//
// Design (right and simple first):
//  * One block per (query tile, KV head). A tile is up to BQ consecutive
//    flat tokens of ONE packed entry (sequence chunk); the host-built tile
//    list holds (entry, first token, end token). The block's rows are the
//    tile's tokens times the G = H/Hkv query heads that share the KV head.
//  * The block walks its entry's block-table row from the first page any of
//    its rows can see (window) to the page of its last row's position, and
//    stages PPI pages of K and V into shared memory per iteration: each
//    page is loaded once per tile, not once per token.
//  * Per-row causal and window masks come from the token's position
//    (entry_start + offset in the entry); masked scores are -1e30 as in the
//    Pallas body. fp32 online softmax (m, l, acc) per row in shared memory.
//  * Tiles with entry -1 cover the bucket's padding tokens, which belong to
//    no entry: the block writes zeros for them. Unused tile slots
//    (end <= start) exit.
//  * The dense entry point (kernels/flash_prefill.py::flash_prefill, the
//    Pallas signature) views (B, S, Hkv, hd) K/V as B contiguous one-entry
//    page runs and launches this same body.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int NT = 128;          // threads per block
constexpr int BQ = 16;           // max tokens per query tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages,
                     const int* __restrict__ cu_tokens,
                     const int* __restrict__ entry_bt,
                     const int* __restrict__ entry_start,
                     const int* __restrict__ tiles, T* __restrict__ out,
                     int H, int Hkv, int hd, int P, int Pb, int ppi,
                     float scale, float softcap, int window) {
  const int kvh = blockIdx.y, t = threadIdx.x;
  const int* tl = tiles + 3 * blockIdx.x;
  const int entry = tl[0], t0 = tl[1];
  const int t1 = min(tl[2], t0 + BQ);
  if (t1 <= t0) return;                        // unused tile slot
  const int G = H / Hkv;
  const int n = t1 - t0;
  const int R = BQ * G;                        // rows: token-major (i*G + g)
  if (entry < 0) {                             // bucket padding: zeros
    for (int e = t; e < n * G * hd; e += NT) {
      const int r = e / hd, d = e - r * hd;
      const int i = r / G, g = r - i * G;
      out[((long long)(t0 + i) * H + kvh * G + g) * hd + d] = from_f<T>(0.f);
    }
    return;
  }
  const int KC = ppi * P;
  const int hdp = hd + 1;
  extern __shared__ float sm[];
  float* q_s = sm;                             // (R, hd+1)
  float* k_s = q_s + R * hdp;                  // (KC, hd+1)
  float* v_s = k_s + KC * hdp;                 // (KC, hd)
  float* s_s = v_s + KC * hd;                  // (R, KC)
  float* acc_s = s_s + R * KC;                 // (R, hd)
  float* m_s = acc_s + R * hd;                 // (R,)
  float* l_s = m_s + R;
  float* c_s = l_s + R;

  const int pos0 = entry_start[entry] + (t0 - cu_tokens[entry]);
  const int pos_last = pos0 + n - 1;
  const int* bt = entry_bt + (long long)entry * Pb;
  for (int e = t; e < n * G * hd; e += NT) {
    const int r = e / hd, d = e - r * hd;
    const int i = r / G, g = r - i * G;
    q_s[r * hdp + d] =
        to_f(q[((long long)(t0 + i) * H + kvh * G + g) * hd + d]);
  }
  for (int e = t; e < R * hd; e += NT) acc_s[e] = 0.f;
  for (int r = t; r < R; r += NT) { m_s[r] = NEG; l_s[r] = 0.f; }

  // first key any row sees: kp > pos0 - window  <=>  kp >= pos0 - window + 1
  // (window <= 0 means none; the 2^30 global sentinel cannot overflow int32)
  const int key_lo = window > 0 ? max(0, pos0 - window + 1) : 0;
  const int pg_end = min(pos_last / P + 1, Pb);
  for (int pg0 = key_lo / P; pg0 < pg_end; pg0 += ppi) {
    const int npg = min(ppi, pg_end - pg0);
    const int kc = npg * P;
    __syncthreads();
    for (int e = t; e < kc * hd; e += NT) {
      const int j = e / hd, d = e - j * hd;
      const long long page = bt[pg0 + j / P];
      const long long src = ((page * P + (j % P)) * Hkv + kvh) * hd + d;
      k_s[j * hdp + d] = to_f(k_pages[src]);
      v_s[j * hd + d] = to_f(v_pages[src]);
    }
    __syncthreads();
    for (int e = t; e < n * G * kc; e += NT) {
      const int r = e / kc, j = e - r * kc;
      const int qpos = pos0 + r / G;
      const int kp = pg0 * P + j;
      const float* qr = q_s + r * hdp;
      const float* kr = k_s + j * hdp;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      bool valid = kp <= qpos;
      if (window > 0) valid = valid && (kp > qpos - window);
      s_s[r * KC + j] = valid ? s : NEG;
    }
    __syncthreads();
    for (int r = t; r < n * G; r += NT) {
      float* sr = s_s + r * KC;
      const float m_prev = m_s[r];
      float mx = m_prev;
      for (int j = 0; j < kc; ++j) mx = fmaxf(mx, sr[j]);
      float sum = 0.f;
      for (int j = 0; j < kc; ++j) {
        const float pr = expf(sr[j] - mx);
        sr[j] = pr;
        sum += pr;
      }
      const float corr = expf(m_prev - mx);
      l_s[r] = l_s[r] * corr + sum;
      m_s[r] = mx;
      c_s[r] = corr;
    }
    __syncthreads();
    for (int e = t; e < n * G * hd; e += NT) {
      const int r = e / hd, d = e - r * hd;
      const float* pr = s_s + r * KC;
      float a = acc_s[e] * c_s[r];
      for (int j = 0; j < kc; ++j) a = fmaf(pr[j], v_s[j * hd + d], a);
      acc_s[e] = a;
    }
  }
  __syncthreads();
  for (int e = t; e < n * G * hd; e += NT) {
    const int r = e / hd, d = e - r * hd;
    const int i = r / G, g = r - i * G;
    out[((long long)(t0 + i) * H + kvh * G + g) * hd + d] =
        from_f<T>(acc_s[e] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* cu,
           const void* ebt, const void* est, const void* tiles, void* out,
           int n_tiles, int H, int Hkv, int hd, int P, int Pb, float softcap,
           int window, cudaStream_t stream) {
  const int G = H / Hkv;
  const int R = BQ * G;
  const int ppi = P >= 32 ? 1 : 32 / P;
  const int KC = ppi * P;
  const size_t smem = sizeof(float) *
      ((size_t)R * (hd + 1) + (size_t)KC * (hd + 1) + (size_t)KC * hd +
       (size_t)R * KC + (size_t)R * hd + 3 * (size_t)R);
  auto kern = flash_prefill_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_tiles <= 0) return 0;
  const float scale = 1.0f / sqrtf((float)hd);
  kern<<<dim3(n_tiles, Hkv), NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)cu, (const int*)ebt,
      (const int*)est, (const int*)tiles, (T*)out, H, Hkv, hd, P, Pb, ppi,
      scale, softcap, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_prefill_block_q() { return BQ; }

// Paged varlen entry (the engine's ragged prefill). q/out: (Tb, H, hd);
// k/v pages: (NP, P, Hkv, hd); cu_tokens (Sb+1), entry_bt (Sb, Pb),
// entry_start (Sb), tiles (n_tiles, 3) = (entry or -1, start, end).
// dtype: 0 = float32, 1 = bfloat16. softcap <= 0 and window <= 0 mean none.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_prefill_paged_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* cu_tokens, const void* entry_bt, const void* entry_start,
    const void* tiles, void* out, int n_tiles, int H, int Hkv, int hd, int P,
    int Pb, int dtype, float softcap, int window, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, cu_tokens, entry_bt,
                         entry_start, tiles, out, n_tiles, H, Hkv, hd, P, Pb,
                         softcap, window, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, cu_tokens, entry_bt,
                                 entry_start, tiles, out, n_tiles, H, Hkv, hd,
                                 P, Pb, softcap, window, s);
  return (int)cudaErrorInvalidValue;
}
