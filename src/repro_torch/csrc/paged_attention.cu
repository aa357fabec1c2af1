// Paged-attention decode for Hopper (sm_90a): one query token per sequence
// attends over its pages of the global KV pool, split-K (flash-decoding).
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention (Pallas
// `_kernel`, grid (B, Hkv, NP) with the block table scalar-prefetched).
// Plain version: repro_torch/kernels/ref.py::paged_attention_ref; the
// split-and-merge this kernel does is emulated in plain PyTorch by
// ref.py::paged_attention_split_ref (same partition, same combine).
//
// Bound on the H100: bytes. Per (sequence, KV head) the kernel reads each
// valid K/V slot once (2 * len * hd elements) and does 4 * G * len * hd
// flops on them — G = H/Hkv = 4 flops per byte in bf16, far below the
// ~295 flops/byte the card needs before compute binds, so no tensor
// cores. The least time is (K/V bytes + q + out) / 3.35 TB/s, and reaching
// it needs the whole card reading 16-byte vectors with many in flight.
//
// Design:
//  * grid (B, Hkv * head chunks, S): S splits per (sequence, KV head),
//    chosen on the host from shapes only (kernels/paged_attention.py::
//    n_splits: B, Hkv, the block-table width and the SM count), so that a
//    decode horizon stays free of host syncs and capturable in a CUDA
//    graph. Each block reads its own length and block-table row and cuts
//    its sequence's valid page range [key_lo / P, pg_end) into S equal
//    runs of pages on the device, so work is balanced per sequence; a
//    split past the valid range does no work and reports (m = -inf, l = 0).
//  * 128 threads, 4 warps. Thread 0 copies the split's pages by TMA into
//    a ring of NS = 4 stages in shared memory, NS - 1 ahead: one load per
//    page of one KV head (P rows x hd, row-major), through 2-D tensor maps
//    over the whole K and V pools (kernels/tma.py, built once per pool; a
//    layer is a row offset), each stage's arrival tracked by an mbarrier.
//    The split's page ids are read into shared memory once at the start.
//    TMA, because 16-byte `cp.async` copies issued by every thread spent
//    about 2,300 cycles per 16 KB step issuing on this card.
//  * A key row (hd elements) is read from shared memory by hd / 8 lanes
//    (bf16; hd / 4 for fp32), 16 bytes each; a warp covers 32 / that many
//    keys per warp step, U warp steps per compute step. K/V stay in their
//    storage type until they reach registers; no fp32 staging copy.
//  * The G query heads that share the KV head (up to GB = 4 or 8 per
//    block; more spread over head chunks) sit in registers, pre-scaled, so
//    each K/V byte is read once for all of them. Dot products are reduced
//    across a key's lanes by warp shuffles, all (head, key) chains side by
//    side; the online softmax (m, l, acc in fp32, exp2 with log2(e) folded
//    in, acc rescaled only when a head's maximum moves) runs per warp in
//    registers, masked keys at -inf with the all-masked case guarded. At
//    the end the warp's key groups are summed by shuffles and the 4 warps
//    merged through shared memory.
//  * S > 1: each split writes its fp32 partial (m, l, acc[G, hd]) to a
//    workspace the wrapper allocates (torch.empty); a second small kernel,
//    grid (B, H), merges them: m* = max m_s, out = sum e^{m_s - m*} acc_s /
//    max(sum e^{m_s - m*} l_s, 1e-30), where an empty split contributes
//    exactly 0. S = 1 writes the output directly and skips the merge.
//  * Semantics as the Pallas body: softcap c * tanh(s / c), sliding window
//    (pos > len-1-window), length mask, fp32 (m, l, acc), denom = max(l,
//    1e-30), output in q's dtype. fp32 and bf16 share the body.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int NT = 128;          // threads per block
constexpr int NW = NT / 32;
constexpr int NS = 4;            // K/V ring depth (stages), NS - 1 in flight
constexpr float LOG2E = 1.4426950408889634f;

// 16 bytes of T: a raw vector load, and its elements as fp32
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void cvt(float (&x)[4], uint4 v) {
    x[0] = __uint_as_float(v.x); x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z); x[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static float out(float x) { return x; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void cvt(float (&x)[8], uint4 v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bf16 -> fp32 is a 16-bit shift
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static __nv_bfloat16 out(float x) {
    return __float2bfloat16(x);
  }
};

// 2^x, flushing results below 2^-126 to zero (they are < 1e-38 of the
// row's largest weight)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
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
// TMA: the (col, row) box of a 2-D tensor map into shared memory,
// completing `bar`'s expected bytes
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

template <typename T, int HDP, int GB>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const T* __restrict__ q,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, int k_row0,
                    int v_row0, const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ ws, int H, int Hkv, int hd, int P,
                    int maxp, int S, int n_gc, int per_max, int pps,
                    float scale, float softcap, int window) {
  constexpr int VEC = Vec<T>::N;               // elements per 16-byte load
  constexpr int LPK = HDP / VEC < 32 ? HDP / VEC : 32;   // lanes per key
  constexpr int CPL = HDP / (VEC * LPK);       // loads per lane per row
  constexpr int KPW = 32 / LPK;                // keys per warp step
  constexpr int U = GB >= 8 ? 2 : 4;           // warp steps in flight
  constexpr int E = CPL * VEC;                 // elements per lane per row
  const int b = blockIdx.x, s = blockIdx.z;
  const int kvh = blockIdx.y / n_gc, gc = blockIdx.y - kvh * n_gc;
  const int G = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lik = lane % LPK, kiw = lane / LPK;  // lane in key, key in warp

  // this lane's columns of a row: chunk c covers [(c*LPK + lik) * VEC, +VEC)
  float qr[GB][E];
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    const int g = gc * GB + gi;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int d0 = (c * LPK + lik) * VEC;
      float x[VEC];
      Vec<T>::cvt(x, g < G && d0 < hd
                         ? ld16(q + ((long long)b * H + kvh * G + g) * hd + d0)
                         : make_uint4(0, 0, 0, 0));
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[gi][c * VEC + e] = x[e] * scale;
    }
  }

  // this split's keys [k0, k1)
  const int len = lengths[b];
  const int key_lo = window > 0 ? max(0, len - window) : 0;
  const int pg_lo = key_lo / P;
  const int pg_end = min((len + P - 1) / P, maxp);
  const int npg = max(pg_end - pg_lo, 0);
  const int per = (npg + S - 1) / S;
  const int sp0 = pg_lo + s * per, sp1 = min(pg_end, sp0 + per);
  const int k0 = max(sp0 * P, key_lo), k1 = min(sp1 * P, len);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);      // [NS]
  float* s_m = reinterpret_cast<float*>(smem + 128);      // [NW][GB]
  float* s_l = s_m + NW * GB;                  // [NW][GB]
  float* s_acc = s_l + NW * GB;                // [NW][GB][HDP]
  int* s_pg = reinterpret_cast<int*>(s_acc + NW * GB * HDP);  // [per_max]
  // K/V ring (128-byte aligned): [NS][2][pps * P keys][hd]
  T* ring = reinterpret_cast<T*>(
      smem + ((128 + 4 * (2 * NW * GB + NW * GB * HDP + per_max) + 127) /
              128) * 128);
  // the split's page ids, read once before any K/V load depends on them
  const int* bt = block_tables + (long long)b * maxp;
  for (int i = threadIdx.x; i < sp1 - sp0; i += NT) s_pg[i] = bt[sp0 + i];
  if (threadIdx.x == 0)
    for (int i = 0; i < NS; ++i) mbar_init(&full[i], 1);
  __syncthreads();

  float m[GB], l[GB], acc[GB][E];
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    m[gi] = -INFINITY;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[gi][e] = 0.f;
  }

  // A stage is pps whole pages of this split, each page's K and V rows of
  // this KV head copied by one TMA load (P rows x hd, row-major) issued by
  // thread 0; NS - 1 stages are in flight. A compute step is U warp
  // steps: stage row r = sub + (u*NW + warp)*KPW + kiw for lane (warp, kiw,
  // lik), which reads its 16-byte chunks of row r.
  constexpr int STEP = U * NW * KPW;
  const int sk = pps * P;                      // keys per stage
  const int n_pages = max(sp1 - sp0, 0);
  const int n_stages = (n_pages + pps - 1) / pps;
  auto issue = [&](int st) {
    const int slot = st % NS;
    const int j0 = st * pps, j1 = min(j0 + pps, n_pages);
    mbar_expect(&full[slot], (uint32_t)((j1 - j0) * 2 * P * hd * sizeof(T)));
    T* dk = ring + (long long)slot * 2 * sk * hd;
    for (int j = j0; j < j1; ++j) {
      const int row = s_pg[j] * P;
      tma_load_2d(dk + (j - j0) * P * hd, &k_map, kvh * hd, k_row0 + row,
                  &full[slot]);
      tma_load_2d(dk + (sk + (j - j0) * P) * hd, &v_map, kvh * hd,
                  v_row0 + row, &full[slot]);
    }
  };
  auto compute = [&](int st, int sub) {
    const T* sk_base = ring + (long long)(st % NS) * 2 * sk * hd;
    const int kfirst = (sp0 + st * pps) * P;   // key of stage row 0
    float kx[U][E], vx[U][E];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = sub + (u * NW + warp) * KPW + kiw;
      const int kp = kfirst + r;
      valid[u] = r < sk && kp >= k0 && kp < k1;
      const T* rk = sk_base + (long long)r * hd;
      const T* rv = rk + (long long)sk * hd;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int d0 = (c * LPK + lik) * VEC;
        const bool ok = valid[u] && d0 < hd;
        float x[VEC], y[VEC];
        Vec<T>::cvt(x, ok ? *reinterpret_cast<const uint4*>(rk + d0)
                          : make_uint4(0, 0, 0, 0));
        Vec<T>::cvt(y, ok ? *reinterpret_cast<const uint4*>(rv + d0)
                          : make_uint4(0, 0, 0, 0));
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          kx[u][c * VEC + e] = x[e];
          vx[u][c * VEC + e] = y[e];
        }
      }
    }
    // scores of all (head, key) pairs as independent chains: dot products,
    // then the reduction over a key's lanes level by level, no branch
    // inside (heads past G have q = 0 and are never written)
    float sc[GB][U];
#pragma unroll
    for (int gi = 0; gi < GB; ++gi)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) x = fmaf(qr[gi][e], kx[u][e], x);
        sc[gi][u] = x;
      }
#pragma unroll
    for (int o = LPK / 2; o > 0; o >>= 1)
#pragma unroll
      for (int gi = 0; gi < GB; ++gi)
#pragma unroll
        for (int u = 0; u < U; ++u)
          sc[gi][u] += __shfl_xor_sync(0xffffffffu, sc[gi][u], o);
    if (softcap > 0.f) {
#pragma unroll
      for (int gi = 0; gi < GB; ++gi)
#pragma unroll
        for (int u = 0; u < U; ++u)
          sc[gi][u] = softcap * tanhf(sc[gi][u] / softcap);
    }
    float mx[GB];
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      mx[gi] = -INFINITY;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[gi][u] = valid[u] ? sc[gi][u] * LOG2E : -INFINITY;
        mx[gi] = fmaxf(mx[gi], sc[gi][u]);
      }
    }
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1)
#pragma unroll
      for (int gi = 0; gi < GB; ++gi)
        mx[gi] = fmaxf(mx[gi], __shfl_xor_sync(0xffffffffu, mx[gi], o));
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      const float m_new = fmaxf(m[gi], mx[gi]);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float lg = l[gi];
      if (m_new != m[gi]) {                    // (warp-uniform) rescale
        const float corr = ex2(m[gi] - m_use);
        lg *= corr;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[gi][e] *= corr;
        m[gi] = m_new;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ex2(sc[gi][u] - m_use);
        lg += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[gi][e] = fmaf(p, vx[u][e], acc[gi][e]);
      }
      l[gi] = lg;
    }
  };

  if (threadIdx.x == 0)
    for (int i = 0; i < NS - 1 && i < n_stages; ++i) issue(i);
  for (int i = 0; i < n_stages; ++i) {
    // the slot of stage i - 1, freed by the barrier that ended it
    if (threadIdx.x == 0 && i + NS - 1 < n_stages) issue(i + NS - 1);
    mbar_wait(&full[i % NS], (i / NS) & 1);
    for (int sub = 0; sub < sk; sub += STEP) compute(i, sub);
    __syncthreads();                           // every thread is done with it
  }

  // sum the warp's key groups (m is warp-uniform), then merge the warps
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) {
      l[gi] += __shfl_xor_sync(0xffffffffu, l[gi], o);
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[gi][e] += __shfl_xor_sync(0xffffffffu, acc[gi][e], o);
    }
  }
  if (lane < LPK) {
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      if (lane == 0) {
        s_m[warp * GB + gi] = m[gi];
        s_l[warp * GB + gi] = l[gi];
      }
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          s_acc[(warp * GB + gi) * HDP + (c * LPK + lane) * VEC + e] =
              acc[gi][c * VEC + e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GB * HDP; i += NT) {
    const int gi = i / HDP, d = i - gi * HDP;
    const int g = gc * GB + gi;
    if (g >= G || d >= hd) continue;
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mb = fmaxf(mb, s_m[w * GB + gi]);
    float lb = 0.f, ab = 0.f;
    if (mb != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float wt = ex2(s_m[w * GB + gi] - mb);     // -inf -> 0
        lb = fmaf(wt, s_l[w * GB + gi], lb);
        ab = fmaf(wt, s_acc[(w * GB + gi) * HDP + d], ab);
      }
    }
    const long long row = (long long)b * H + kvh * G + g;
    if (S == 1) {
      out[row * hd + d] = Vec<T>::out(ab / fmaxf(lb, 1e-30f));
    } else {
      // workspace: acc (B*H, S, hd) then (m, l) (B*H, S, 2)
      ws[(row * S + s) * hd + d] = ab;
      if (d == 0) {
        float* ml = ws + (long long)gridDim.x * H * S * hd + (row * S + s) * 2;
        ml[0] = mb;
        ml[1] = lb;
      }
    }
  }
}

// grid (B, H): merge the S partials of each (sequence, query head)
template <typename T>
__global__ void __launch_bounds__(NT)
combine_kernel(const float* __restrict__ ws, T* __restrict__ out, int B,
               int H, int hd, int S) {
  const long long row = (long long)blockIdx.x * H + blockIdx.y;
  const float* acc = ws + row * S * hd;
  const float* ml = ws + (long long)B * H * S * hd + row * S * 2;
  float mx = -INFINITY;
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, ml[2 * s]);
  for (int d = threadIdx.x; d < hd; d += NT) {
    float lsum = 0.f, a = 0.f;
    if (mx != -INFINITY) {
      for (int s = 0; s < S; ++s) {
        const float ms = ml[2 * s];
        if (ms == -INFINITY) continue;         // empty split: exactly 0
        const float wt = ex2(ms - mx);
        lsum = fmaf(wt, ml[2 * s + 1], lsum);
        a = fmaf(wt, acc[(long long)s * hd + d], a);
      }
    }
    out[row * hd + d] = Vec<T>::out(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int HDP, int GB>
int launch_hd(const void* q, const CUtensorMap& km, const CUtensorMap& vm,
              int k_row0, int v_row0, const void* bt, const void* lens,
              void* out, void* ws, int B, int H, int Hkv, int hd, int P,
              int maxp, int S, float softcap, int window,
              cudaStream_t stream) {
  const int G = H / Hkv;
  const int n_gc = (G + GB - 1) / GB;
  const int per_max = ((maxp + S - 1) / S + 3) / 4 * 4;   // page ids, padded
  constexpr int VEC = Vec<T>::N;
  constexpr int LPK = HDP / VEC < 32 ? HDP / VEC : 32;
  constexpr int STEP = (GB >= 8 ? 2 : 4) * NW * (32 / LPK);
  const int pps = P >= STEP ? 1 : (STEP + P - 1) / P;   // pages per stage
  // barriers, merge arrays and page ids, then the K/V ring (128-aligned)
  const size_t head =
      (128 + 4 * ((size_t)2 * NW * GB + (size_t)NW * GB * HDP + per_max) +
       127) / 128 * 128;
  const size_t smem = head + sizeof(T) * (size_t)NS * 2 * pps * P * hd;
  static size_t configured = 0;                // max smem set so far
  if (smem > 48 * 1024 && smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, HDP, GB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  const float scale = 1.0f / sqrtf((float)hd);
  decode_split_kernel<T, HDP, GB>
      <<<dim3(B, Hkv * n_gc, S), NT, smem, stream>>>(
          (const T*)q, km, vm, k_row0, v_row0, (const int*)bt,
          (const int*)lens, (T*)out, (float*)ws, H, Hkv, hd, P, maxp, S, n_gc,
          per_max, pps, scale, softcap, window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  combine_kernel<T><<<dim3(B, H), NT, 0, stream>>>((const float*)ws, (T*)out,
                                                   B, H, hd, S);
  return (int)cudaGetLastError();
}

template <typename T, int GB>
int launch_gb(const void* q, const CUtensorMap& km, const CUtensorMap& vm,
              int k_row0, int v_row0, const void* bt, const void* lens,
              void* out, void* ws, int B, int H, int Hkv, int hd, int P,
              int maxp, int S, float softcap, int window,
              cudaStream_t stream) {
#define PA_LAUNCH(HDP)                                                       \
  return launch_hd<T, HDP, GB>(q, km, vm, k_row0, v_row0, bt, lens, out, ws, \
                               B, H, Hkv, hd, P, maxp, S, softcap, window,   \
                               stream)
  if (hd <= 16) PA_LAUNCH(16);
  if (hd <= 32) PA_LAUNCH(32);
  if (hd <= 64) PA_LAUNCH(64);
  if (hd <= 128) PA_LAUNCH(128);
  PA_LAUNCH(256);
#undef PA_LAUNCH
}

template <typename T>
int launch(const void* q, const CUtensorMap& km, const CUtensorMap& vm,
           int k_row0, int v_row0, const void* bt, const void* lens,
           void* out, void* ws, int B, int H, int Hkv, int hd, int P,
           int maxp, int S, float softcap, int window, cudaStream_t stream) {
  if (hd % Vec<T>::N != 0 || hd > 256 || S < 1 || P > 256 ||
      (P * hd * (int)sizeof(T)) % 128 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  if (H / Hkv <= 4)
    return launch_gb<T, 4>(q, km, vm, k_row0, v_row0, bt, lens, out, ws, B,
                           H, Hkv, hd, P, maxp, S, softcap, window, stream);
  return launch_gb<T, 8>(q, km, vm, k_row0, v_row0, bt, lens, out, ws, B, H,
                         Hkv, hd, P, maxp, S, softcap, window, stream);
}

}  // namespace

// q/out: (B, H, hd); k_map / v_map: 128-byte maps (tma_map.cu, box hd x
// P: one page of one KV head) over the K and V pools, this layer's pages from
// rows k_row0 / v_row0 on ((NP, P, Hkv, hd) pages = NP * P rows of Hkv * hd);
// block_tables (B, maxp) and lengths (B,) int32; ws: fp32 workspace of
// B*H*S*(hd+2) floats (unused when S == 1); S splits per (sequence, KV
// head). dtype: 0 = float32, 1 = bfloat16; hd a multiple of 4 (fp32) / 8
// (bf16) up to 256, P * hd * element size a multiple of 128 bytes.
// softcap <= 0 and window <= 0 mean none. Launches the split kernel and,
// for S > 1, the merge; returns cudaGetLastError() after them (0 =
// launched).
extern "C" int paged_attention_launch(
    const void* q, const void* k_map, const void* v_map, int k_row0,
    int v_row0, const void* block_tables, const void* lengths, void* out,
    void* ws, int B, int H, int Hkv, int hd, int P, int maxp, int S,
    int dtype, float softcap, int window, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  CUtensorMap km, vm;
  memcpy(&km, k_map, sizeof(km));
  memcpy(&vm, v_map, sizeof(vm));
  if (dtype == 0)
    return launch<float>(q, km, vm, k_row0, v_row0, block_tables, lengths,
                         out, ws, B, H, Hkv, hd, P, maxp, S, softcap, window,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, km, vm, k_row0, v_row0, block_tables,
                                 lengths, out, ws, B, H, Hkv, hd, P, maxp, S,
                                 softcap, window, s);
  return (int)cudaErrorInvalidValue;
}
