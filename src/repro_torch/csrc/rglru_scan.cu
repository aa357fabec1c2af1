// RG-LRU linear recurrence (RecurrentGemma / Griffin) for Hopper (sm_90a):
//     h_t = a_t * h_{t-1} + b_t   per channel, from h0, fp32 carry.
//
// Replaces: src/repro/kernels/rglru_scan.py::rglru (Pallas `_kernel`,
// grid (B, W/128, T/chunk): width blocks on the vector lanes, the carried
// state in VMEM across the chunk axis, T % chunk == 0 and W % 128 == 0).
// Plain version: repro_torch/kernels/ref.py::rglru_ref.
//
// Bound on the H100: bytes. Each step reads a_t, b_t and writes h_t (12
// bytes in fp32) for one multiply-add.
//
// Design: one thread per (b, channel), neighbouring threads on
// neighbouring channels, so every load and store of a step is coalesced.
// Each thread loops over t with its fp32 carry in a register, loading the
// next UNR steps of a and b before it runs them so that several loads are
// in flight on the serial chain. Any T >= 1 and any W (the ragged edge is
// masked), so decode (T = 1) runs the same kernel. The multiply and the
// add are rounded separately (__fmul_rn, __fadd_rn), as the plain version
// rounds them, so the two agree bit for bit in fp32. Inputs fp32 or bf16,
// h in the inputs' dtype, h0 and h_last fp32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NT = 64;     // threads per block: W = 2560 gives 40 blocks per row
constexpr int UNR = 8;     // steps loaded ahead

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename E> __device__ __forceinline__ E from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename E>
__global__ void __launch_bounds__(NT)
rglru_kernel(const E* __restrict__ a, const E* __restrict__ b,
             const float* __restrict__ h0, E* __restrict__ h,
             float* __restrict__ h_last, int T, int W) {
  const int c = blockIdx.x * NT + threadIdx.x;
  const int bi = blockIdx.y;
  if (c >= W) return;
  size_t idx = (size_t)bi * T * W + c;
  float hc = h0[(size_t)bi * W + c];
  int t = 0;
  for (; t + UNR <= T; t += UNR) {
    float av[UNR], bv[UNR];
#pragma unroll
    for (int q = 0; q < UNR; ++q) {
      av[q] = to_f(a[idx + (size_t)q * W]);
      bv[q] = to_f(b[idx + (size_t)q * W]);
    }
#pragma unroll
    for (int q = 0; q < UNR; ++q) {
      hc = __fadd_rn(__fmul_rn(av[q], hc), bv[q]);
      h[idx + (size_t)q * W] = from_f<E>(hc);
    }
    idx += (size_t)UNR * W;
  }
  for (; t < T; ++t) {
    hc = __fadd_rn(__fmul_rn(to_f(a[idx]), hc), to_f(b[idx]));
    h[idx] = from_f<E>(hc);
    idx += W;
  }
  h_last[(size_t)bi * W + c] = hc;
}

template <typename E>
int launch(const void* a, const void* b, const void* h0, void* h,
           void* h_last, int B, int T, int W, cudaStream_t stream) {
  const dim3 grid((W + NT - 1) / NT, B);
  rglru_kernel<E><<<grid, NT, 0, stream>>>((const E*)a, (const E*)b,
                                           (const float*)h0, (E*)h,
                                           (float*)h_last, T, W);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b: (B, T, W) in `dtype` (0 = float32, 1 = bfloat16); h0: (B, W) fp32;
// h: (B, T, W) in `dtype`; h_last: (B, W) fp32 (the carry after step T-1).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rglru_launch(const void* a, const void* b, const void* h0,
                            void* h, void* h_last, int B, int T, int W,
                            int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(a, b, h0, h, h_last, B, T, W, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h0, h, h_last, B, T, W, s);
  return (int)cudaErrorInvalidValue;
}
