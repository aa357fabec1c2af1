// WKV6, the RWKV-6 "Finch" time-mix recurrence, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rwkv6_wkv.py::wkv6 (Pallas `_kernel`, grid
// (B, H, NC): the chunk-parallel form with an fp32 hd x hd state carried in
// VMEM across the chunk axis, starting from zero and returning only y).
// Plain version: repro_torch/kernels/ref.py::wkv6_ref.
//
// Per (batch b, head h), with the fp32 state S (hd_k x hd_v):
//     y_t = r_t . (S + (u * k_t) v_t^T)        y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i
//     S  <- diag(w_t) S + k_t v_t^T            S_ij = w_i S_ij + k_i v_j
// The engine needs both ends of the state (chunked prefill carries it from
// chunk to chunk, decode advances it one token at a time), so this kernel
// reads the state from `state` and writes the new one over it IN PLACE:
// each block reads its own (b, h) slice first and writes it last.
//
// Bound on the H100: bytes at decode (the state, 16 KB per head at hd 64,
// is read and written once per call while each token does 4 hd^2 flops),
// and about even between bytes and fp32 operations at a 256-token prefill.
//
// Design (right and simple first): the per-token recurrence the
// reference's decode uses. It equals the chunked form up to the -30
// log-decay clamp (repro/models/rwkv6.py:25-29), which is lossless here.
//  * one block per (b, h) with hd threads; thread j owns column S[:, j]
//    in registers (hd fp32 values) for the whole call;
//  * the block loops over t itself (the TPU's sequential chunk axis), so
//    any T >= 1 runs and decode (T = 1) goes through the same kernel;
//  * r_t, k_t, w_t are staged in shared memory (double-buffered, one
//    barrier per token) and token t+1 is loaded into registers while token
//    t is computed, so the global-load latency is off the serial chain;
//  * inputs fp32 or bf16, math fp32, y in the inputs' dtype.
//  * Known limit: B*H blocks (32 at a full-width rwkv6-1.6b prefill)
//    under-fill the 132 SMs, and the t loop is serial; a chunked form with
//    tensor-core products is the later fix.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename E> __device__ __forceinline__ E from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename E, int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const E* __restrict__ r, const E* __restrict__ k,
            const E* __restrict__ v, const E* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ state,
            E* __restrict__ y, int T, int H) {
  const int bh = blockIdx.x;                  // b * H + h
  const int b = bh / H, h = bh - b * H;
  const int j = threadIdx.x;                  // the v-channel this thread owns
  __shared__ float r_s[2][HD], k_s[2][HD], w_s[2][HD], u_s[HD];

  float s[HD];                                // column j of S
  float* st = state + (size_t)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = st[i * HD + j];
  u_s[j] = u[h * HD + j];

  const size_t stride_t = (size_t)H * HD;
  size_t idx = ((size_t)b * T * H + h) * HD + j;        // element (b, 0, h, j)
  float rn = to_f(r[idx]), kn = to_f(k[idx]), wn = to_f(w[idx]),
        vn = to_f(v[idx]);
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    r_s[buf][j] = rn;
    k_s[buf][j] = kn;
    w_s[buf][j] = wn;
    const float vj = vn;
    const size_t cur = idx;
    idx += stride_t;
    if (t + 1 < T) {                          // prefetch token t+1
      rn = to_f(r[idx]);
      kn = to_f(k[idx]);
      wn = to_f(w[idx]);
      vn = to_f(v[idx]);
    }
    __syncthreads();
    float acc = 0.f, bonus = 0.f;
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      const float ri = r_s[buf][i], ki = k_s[buf][i];
      acc = fmaf(ri, s[i], acc);
      bonus = fmaf(ri * u_s[i], ki, bonus);
      s[i] = fmaf(w_s[buf][i], s[i], ki * vj);
    }
    y[cur] = from_f<E>(fmaf(vj, bonus, acc));
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) st[i * HD + j] = s[i];
}

template <typename E>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* state, void* y, int B, int T, int H, int hd,
           cudaStream_t stream) {
  const dim3 grid(B * H);
#define WKV6_CASE(N)                                                        \
  case N:                                                                   \
    wkv6_kernel<E, N><<<grid, N, 0, stream>>>(                              \
        (const E*)r, (const E*)k, (const E*)v, (const E*)w, (const float*)u, \
        (float*)state, (E*)y, T, H);                                        \
    break;
  switch (hd) {
    WKV6_CASE(16)
    WKV6_CASE(32)
    WKV6_CASE(64)
    WKV6_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef WKV6_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w: (B, T, H, hd) in `dtype` (0 = float32, 1 = bfloat16);
// u: (H, hd) fp32; state: (B, H, hd, hd) fp32, read and overwritten with the
// state after token T-1; y: (B, T, H, hd) in `dtype`. hd in {16,32,64,128},
// T >= 1. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* state, void* y,
                           int B, int T, int H, int hd, int dtype,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(r, k, v, w, u, state, y, B, T, H, hd, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, state, y, B, T, H, hd, s);
  return (int)cudaErrorInvalidValue;
}
