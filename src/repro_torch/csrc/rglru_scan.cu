// RG-LRU linear recurrence (RecurrentGemma / Griffin) for Hopper (sm_90a):
//     h_t = a_t * h_{t-1} + b_t   per channel, from h0, fp32 carry.
//
// Replaces: src/repro/kernels/rglru_scan.py::rglru (Pallas `_kernel`,
// grid (B, W/128, T/chunk): width blocks on the vector lanes, the carried
// state in VMEM across the chunk axis, T % chunk == 0 and W % 128 == 0).
// Plain version: repro_torch/kernels/ref.py::rglru_ref.
//
// Bound on the H100: bytes. Each step reads a_t, b_t and writes h_t (12
// bytes in fp32) for one multiply-add; a (1, 256, 2560) fp32 prefill chunk
// moves 7.9 MB, 2.35 us at 3.35 TB/s.
//
// What held the old kernel back was not the chain (256 dependent
// multiply-adds are about a microsecond) but bytes in flight: 40 blocks of
// 64 threads, each thread loading 8 steps ahead, kept a few hundred KB in
// flight where 3.35 TB/s at about a microsecond of latency needs megabytes.
//
// Two bodies; the launcher picks one from the shapes (kernels/rglru.py:plan):
//
// * the streamed body (T >= 16, rows 16-byte aligned): a block is one warp
//   of 16 threads owning 16 channels of one batch row (160 blocks at a
//   full-width prefill). It streams [64-step x 16-channel] tiles of a and
//   b into a ring of 4 stages in shared memory with TMA: one bulk tensor
//   copy per tile and array, through 3-D tensor maps (W, T, B) that the
//   launcher encodes (kernels/tma.py::seq_map, csrc/tma_map.cu),
//   completing on the stage's mbarrier. (One bulk copy per 64-byte tile
//   row was 2.5x slower than the per-thread body: the copy engine, not
//   the bytes, set the pace.) The ring is filled at once, one stage per
//   lane, so a 256-step chunk is wholly in flight from the start. Each
//   thread loads a tile into registers, runs its channel's chain there and
//   writes h into a shared tile that one TMA store writes back (a store
//   inside the chain held each step until it had read the carry); the map
//   clips the ragged ends of T and W on both sides.
// * the per-thread body (decode, T = 1, or rows that are not 16-byte
//   aligned): one thread per (b, channel), loading a few steps ahead.
//
// Both round the multiply and the add separately (__fmul_rn, __fadd_rn),
// step by step in order, as the plain version does, so they agree with it
// bit for bit in fp32. Inputs fp32 or bf16, h in the inputs' dtype, h0 and
// h_last fp32.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

// Phase clocks for launch/phase_probe.py, which builds this file with
// -DPROBE: thread 0 of block (0, 0) writes clock64() into slot `slot` of
// g_clk at each STAMP. Without PROBE a STAMP is nothing.
#ifdef PROBE
__device__ unsigned long long g_clk[4096];
extern "C" int probe_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
}
#define STAMP(slot)                                                     \
  do {                                                                  \
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0 &&       \
        (slot) < 4096)                                                  \
      g_clk[(slot)] = clock64();                                        \
  } while (0)
#else
#define STAMP(slot) do {} while (0)
#endif

namespace {

constexpr int NT = 64;     // per-thread body: threads per block
constexpr int UNR = 8;     // per-thread body: steps loaded ahead
constexpr int TCH = 64;    // streamed body: steps per stage
constexpr int NST = 4;     // streamed body: stages in the ring (256 steps)
constexpr int CB = 16;     // streamed body: channels per block, one thread each
constexpr unsigned LANES = (1u << CB) - 1;   // the block's lanes (one warp)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename E> __device__ __forceinline__ E from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// TMA: the (c, t, b) box of a 3-D tensor map into shared memory,
// completing `bar`'s expected bytes (out-of-range elements read as 0)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c, int t, int b,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(t), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}
// TMA: a shared-memory box out to the (c, t, b) box of a 3-D tensor map,
// in this thread's bulk group (out-of-range elements are not written)
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, int c,
                                             int t, int b, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%1, %2, %3}], [%4];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c), "r"(t), "r"(b), "r"(smem_u32(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory, made visible to the bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// the streamed body: one warp of CB threads, thread = channel c0 + lane
// ---------------------------------------------------------------------------
template <typename E>
__global__ void __launch_bounds__(CB)
rglru_stream_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap b_map,
                    const __grid_constant__ CUtensorMap h_map,
                    const float* __restrict__ h0, float* __restrict__ h_last,
                    int T, int W) {
  constexpr uint32_t TILE = TCH * CB * sizeof(E);
  __shared__ __align__(128) E a_s[NST][TCH][CB];
  __shared__ __align__(128) E b_s[NST][TCH][CB];
  __shared__ __align__(128) E h_s[2][TCH][CB];
  __shared__ __align__(8) uint64_t full[NST];
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * CB;
  const int bi = blockIdx.y;
  const bool live = c0 + lane < W;
  const int n_chunks = (T + TCH - 1) / TCH;

  if (lane == 0) {
    for (int s = 0; s < NST; ++s) mbar_init(&full[s], 1);
    fence_mbar_init();
  }
  __syncthreads();
  // chunk n (steps [64n, 64n + 64)) of a and b into stage n % NST, issued
  // by the calling lane
  auto issue = [&](int n) {
    const int s = n % NST;
    mbar_expect(&full[s], 2 * TILE);
    tma_load_3d(&a_s[s][0][0], &a_map, c0, n * TCH, bi, &full[s]);
    tma_load_3d(&b_s[s][0][0], &b_map, c0, n * TCH, bi, &full[s]);
  };
  // the ring's first fill, one stage per lane (issuing every stage from
  // one lane delayed the first tile)
  if (lane < min(NST, n_chunks)) issue(lane);

  float hc = live ? h0[(size_t)bi * W + c0 + lane] : 0.f;
  for (int n = 0; n < n_chunks; ++n) {
    const int s = n % NST, rows = min(TCH, T - n * TCH);
    const int hb = n & 1;
    STAMP(8 + 4 * n);            // tile n: slots 8+4n (wait), 9+4n, 10+4n
    mbar_wait(&full[s], (n / NST) & 1);
    STAMP(9 + 4 * n);
    // h tile hb last went out for chunk n - 2: its store must have read it
    if (lane == 0) bulk_wait_read<1>();
    __syncwarp(LANES);
    if (live) {
      // the tile into registers, the chain on registers, then h out: a
      // store inside the chain would hold each step until it has read hc
      float av[TCH], bv[TCH], hv[TCH];
#pragma unroll
      for (int t = 0; t < TCH; ++t) {
        av[t] = to_f(a_s[s][t][lane]);
        bv[t] = to_f(b_s[s][t][lane]);
      }
#pragma unroll
      for (int t = 0; t < TCH; ++t) {
        if (t < rows) hc = __fadd_rn(__fmul_rn(av[t], hc), bv[t]);
        hv[t] = hc;
      }
#pragma unroll
      for (int t = 0; t < TCH; ++t) h_s[hb][t][lane] = from_f<E>(hv[t]);
    }
    STAMP(10 + 4 * n);
    fence_proxy_async();
    __syncwarp(LANES);
    if (lane == 0 && n + NST < n_chunks) issue(n + NST);   // stage s is free
    if (lane == 0) {
      tma_store_3d(&h_map, c0, n * TCH, bi, &h_s[hb][0][0]);
      bulk_commit();
    }
  }
  if (lane == 0) bulk_wait<0>();
  if (live) h_last[(size_t)bi * W + c0 + lane] = hc;
}

// ---------------------------------------------------------------------------
// the per-thread body
// ---------------------------------------------------------------------------
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
int launch_stream(const void* a_map, const void* b_map, const void* h_map,
                  const void* h0, void* h_last, int B, int T, int W,
                  cudaStream_t stream) {
  if (!a_map || !b_map || !h_map) return (int)cudaErrorInvalidValue;
  CUtensorMap am, bm, hm;
  memcpy(&am, a_map, sizeof(am));
  memcpy(&bm, b_map, sizeof(bm));
  memcpy(&hm, h_map, sizeof(hm));
  rglru_stream_kernel<E><<<dim3((W + CB - 1) / CB, B), CB, 0, stream>>>(
      am, bm, hm, (const float*)h0, (float*)h_last, T, W);
  return (int)cudaGetLastError();
}

template <typename E>
int launch(const void* a, const void* b, const void* h0, void* h,
           void* h_last, int B, int T, int W, int channels, const void* a_map,
           const void* b_map, const void* h_map, cudaStream_t stream) {
  if (channels == CB)
    return launch_stream<E>(a_map, b_map, h_map, h0, h_last, B, T, W, stream);
  if (channels != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + NT - 1) / NT, B);
  rglru_kernel<E><<<grid, NT, 0, stream>>>((const E*)a, (const E*)b,
                                           (const float*)h0, (E*)h,
                                           (float*)h_last, T, W);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b: (B, T, W) in `dtype` (0 = float32, 1 = bfloat16); h0: (B, W) fp32;
// h: (B, T, W) in `dtype`; h_last: (B, W) fp32 (the carry after step T-1).
// `channels` selects the body: 0 = per thread (any shape; the maps are
// not read); 16 = the streamed body, blocks of 16 channels, which copies
// through a_map, b_map, h_map: 128-byte TMA maps (tma_map.cu) of a, b, h
// as (W, T, B) with boxes of 16 x 64 x 1 (W * element size a multiple of
// 16 and a, b, h 16-byte aligned). Returns 0 once launched, else a
// cudaError_t.
extern "C" int rglru_launch(const void* a, const void* b, const void* h0,
                            void* h, void* h_last, int B, int T, int W,
                            int dtype, int channels, const void* a_map,
                            const void* b_map, const void* h_map,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(a, b, h0, h, h_last, B, T, W, channels, a_map,
                         b_map, h_map, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h0, h, h_last, B, T, W, channels,
                                 a_map, b_map, h_map, s);
  return (int)cudaErrorInvalidValue;
}
