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
// chunk to chunk, decode advances it one token at a time), so the kernels
// read the state from `state` and write the new one over it IN PLACE: each
// block reads its own slice first and writes it last.
//
// Bound on the H100: fp32 operations at a prefill chunk, counted at the
// CUDA-core peak (about 5 hd^2 flops per token and head against 10 bytes
// of bf16 inputs: 2.5 us at 67 TFLOP/s for a (1, 256, 32, 64) chunk),
// bytes at decode (the 16 KB state of a head is read and written once per
// call for 4 hd^2 flops).
//
// Two bodies; the launcher picks one from the shapes (kernels/wkv6.py:plan):
//
// * T > 1: the chunked form the Pallas kernel computes. The old per-token
//   kernel had one block per (b, h) (32 blocks on 132 SMs at a full-width
//   prefill) and a serial chain of one barrier and a 64-long FMA chain per
//   token. Here a chunk of C = 16 tokens is one step of the chain: its
//   strictly lower-triangular scores A (C x C), the bonus u.(r*k) on A's
//   diagonal, the carried state's share, and one state update per chunk.
//   S[:, j] depends on v_j alone, so the v-columns of a head are split over
//   independent blocks of 16 (128 blocks at a full-width prefill);
//   each block recomputes its chunk's scores, which do not depend on v.
//   The decays never enter as exp(cum) * exp(-cum) (that overflows fp32
//   once a few log-decays sit at the -30 clamp): every decay factor is a
//   product of w's over a run of tokens, so no factor exceeds 1. Scores of
//   two tokens in different sub-chunks of 4 meet at the later sub-chunk's
//   first token:
//       A_ij = sum_k (r_ik prod_{l=s_I}^{i-1} w_lk) (k_jk prod_{l=j+1}^{s_I-1} w_lk)
//   and the 40 pairs inside the sub-chunks take their 0-2 middle factors
//   directly. A ragged tail is padded with r = k = v = 0, w = 1.
//   The products (scores between sub-chunks, the state's share of y, A v,
//   and the state update) run on the tensor cores as three TF32 products
//   each (hi*hi + hi*lo + lo*hi, fp32 accumulation: about fp32 precision).
//   Only the state update is a chain from chunk to chunk, so the block
//   takes its chunks in windows of 4 (2 at hd 128): each phase does all of
//   a window's chunk-local work at once, the chain runs alone over the
//   window with the state in registers, and the outputs follow.
//   (A first version with the products on CUDA cores, one output per
//   thread, was bound by shared-memory bandwidth; one chunk per phase left
//   every phase latency-bound behind its barrier. launch/phase_probe.py
//   times each phase of a block on the card, through the STAMPs.)
// * T = 1 (decode): the per-token recurrence, one block per (b, h) with hd
//   threads; thread j owns column S[:, j] in registers. It runs at about
//   80% of its bytes bound at the decode shape.
//
// Inputs fp32 or bf16, math fp32, y in the inputs' dtype.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// The chunked body (T > 1)
// ---------------------------------------------------------------------------

constexpr int WC = 16;            // tokens per chunk: one step of the chain
constexpr int WSC = 4;            // tokens per sub-chunk
constexpr int WNS = WC / WSC;     // sub-chunks per chunk
constexpr int WNT = 384;          // threads per block (12 warps)
constexpr int WV = 16;            // v-columns per block (two n-tiles of 8)
constexpr int WNDIAG = WSC * (WSC + 1) / 2;   // score entries j <= i in a sub-chunk
// rows of the "k side" table: sub-chunk I >= 1 keeps the tokens j < 4I
__host__ __device__ constexpr int kh_row(int sub) { return 2 * sub * (sub - 1); }
constexpr int WKH_ROWS = kh_row(WNS);         // 24: three n-tiles of 8

// Shared-memory layout of the chunked body, in floats: one slot per chunk
// of a window of NW chunks, then u. Row strides are chosen so that the 32
// lanes of an mma fragment load hit 32 different banks: 4 or 20 (mod 32)
// where a fragment is 8 rows x 4 columns, 8 or 24 where it is 4 rows x 8
// columns.
template <int HD>
struct ChunkSmem {
  static constexpr int NW = HD <= 64 ? 4 : 2;   // chunks per window
  static constexpr int LQ = HD + 4;             // QT, QH, KH rows (A/B by rows)
  static constexpr int LK = HD + 8;             // KT rows (read transposed)
  static constexpr int LS = 24;                 // S and v rows (B by columns)
  static constexpr int LA = 20;                 // A rows
  static constexpr int QT = 0;                  // r_i prod_{l<i} w_l      (C x hd)
  static constexpr int QH = QT + WC * LQ;       // r_i prod_{l=s_I}^{i-1} w_l
  static constexpr int KH = QH + WC * LQ;       // k_j prod_{l=j+1}^{s_I-1} w_l (24 rows)
  static constexpr int KT = KH + WKH_ROWS * LQ; // k_j prod_{l>j} w_l      (C x hd)
  static constexpr int VS = KT + WC * LK;       // v_j[c]                  (C x WV)
  static constexpr int A = VS + WC * LS;        // A_ij                    (C x C)
  static constexpr int A1 = A + WC * LA;        // second half-sum of the
                                                // scores between sub-chunks
  static constexpr int SN = A1 + WC * LA;       // S at the chunk's start  (hd x WV)
  static constexpr int TOT = SN + HD * LS;      // prod_l w_l over the chunk
  static constexpr int TQ = TOT + HD;           // each sub-chunk's total (4 x hd)
  static constexpr int DP = TQ + WNS * HD;      // in-sub-chunk scores, partial
                                                // sums over 4 channels (hd x 10)
  static constexpr int PC = DP + HD * WNDIAG;   // floats per chunk slot
  static constexpr int U = NW * PC;             // u
  static constexpr int TOTAL = U + HD;
};

// fp32 products on the tensor cores as three TF32 products: a = a_hi +
// a_lo with a_hi = a truncated to TF32 (10 mantissa bits) and a_lo = a -
// a_hi (exact) truncated again, b likewise; d += a_lo b_hi + a_hi b_lo +
// a_hi b_hi in fp32 (a_lo b_lo, ~2^-20 relative, is dropped). That keeps
// about fp32's precision where one TF32 product keeps ~3 digits. The
// split is two masks and a subtraction (cvt.rna.tf32 is not a single
// instruction on sm_90).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d (16 x 8) += a (16 x 8) b (8 x 8) for one m16n8k8 fragment; with g =
// lane / 4 and t = lane % 4: a = {A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}, d = {D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]}
__device__ __forceinline__ void mma3(float (&d)[4], const float (&a)[4],
                                     const float (&b)[2]) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(b[i], bh[i], bl[i]);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}
// A fragment of a row-major matrix at p (row stride ld), k-step ks
__device__ __forceinline__ void frag_a(float (&a)[4], const float* p, int ld,
                                       int g, int t, int ks) {
  a[0] = p[g * ld + 8 * ks + t];
  a[1] = p[(g + 8) * ld + 8 * ks + t];
  a[2] = p[g * ld + 8 * ks + t + 4];
  a[3] = p[(g + 8) * ld + 8 * ks + t + 4];
}

// One block per (b, h, group of WV = 16 v-columns); it walks the chunks in
// windows of NW (g = lane / 4, t = lane % 4). Only the state update is a
// chain from chunk to chunk; everything else of a window's chunks is
// independent, so each phase takes all of a window's chunks at once (more
// independent work per thread and one barrier per phase, not per chunk):
//   P1a thread (chunk c, sub-chunk q, channel kk) takes its 4 tokens' r, k,
//      w (loaded into registers during the previous window) and writes QH
//      and its sub-chunk's total, and sums, over 4 channels, the 10 scores
//      inside its sub-chunk (the bonus u.(r*k) on the diagonal); v goes to
//      shared memory and the next window's loads go out;
//   P1b the factors from the other sub-chunks: QT, KT, KH, the chunk total;
//   P2 the scores between sub-chunks on the tensor cores, QH (C x hd) KH^T
//      (hd x 24) in units of (chunk, n-tile of 8 columns, half of hd),
//      keeping each row's entries of its own sub-chunk's k side (half-sums
//      in A and A1); the 40 in-sub-chunk scores of each chunk, summed;
//   P3 the chain: each warp holds 16 x 8 tiles of S in registers and, chunk
//      after chunk, stores them as the chunk's starting state and advances
//      them, S <- diag(tot) S + KT^T (hd x C) V (C x WV); no barrier inside;
//   P4 y = QT (C x hd) S_start (hd x WV) + (A + A1) (C x C) V (C x WV) in
//      units of (chunk, n-tile), written out.
template <typename E, int HD>
__global__ void __launch_bounds__(WNT)
wkv6_chunk_kernel(const E* __restrict__ r, const E* __restrict__ k,
                  const E* __restrict__ v, const E* __restrict__ w,
                  const float* __restrict__ u, float* __restrict__ state,
                  E* __restrict__ y, int T, int H) {
  using L = ChunkSmem<HD>;
  constexpr int NW = L::NW, PC = L::PC;
  constexpr int LQ = L::LQ, LK = L::LK, LS = L::LS, LA = L::LA;
  constexpr int KS = HD / 8;                    // k-steps over hd
  constexpr int KH2 = KS / 2;                   // k-steps of a half of hd
  constexpr int NTN = WV / 8;                   // n-tiles over the columns
  constexpr int NTILE = (HD / 16) * NTN;        // 16 x 8 tiles of S
  constexpr int NWARP = WNT / 32;
  constexpr int SREP = (NTILE + NWARP - 1) / NWARP;   // tiles per warp
  constexpr int NTASK = HD * WNS;               // P1 tasks of a chunk
  constexpr int NTW = NW * NTASK;               // P1 tasks of a window
  constexpr int TPT = (NTW + WNT - 1) / WNT;    // P1 tasks per thread
  constexpr int NVE = WC * WV;                  // v elements of a chunk
  constexpr int VPT = (NW * NVE + WNT - 1) / WNT;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int c0 = blockIdx.y * WV;               // first v-column
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t stride_t = (size_t)H * HD;
  const size_t base = ((size_t)b * T * H + h) * HD;   // element (b, 0, h, 0)

  for (int i = tid; i < HD; i += WNT) sm[L::U + i] = u[h * HD + i];
  for (int c = 0; c < NW; ++c)                  // A's and A1's unwritten
    for (int i = tid; i < 2 * WC * LA; i += WNT)    // entries stay 0
      sm[c * PC + L::A + i] = 0.f;

  // this warp's tiles of S (rows 16 mt + g (+8), columns 8 nt + 2 t4 (+1))
  float sacc[SREP][4];
  float* st = state + (size_t)bh * HD * HD;
#pragma unroll
  for (int rep = 0; rep < SREP; ++rep) {
    const int ti = warp + NWARP * rep;
    if (ti < NTILE) {
      const int mt = ti / NTN, nt = ti % NTN;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mt + g + (e >> 1) * 8, col = 8 * nt + 2 * t4 + (e & 1);
        sacc[rep][e] = st[(size_t)row * HD + c0 + col];
      }
    }
  }

  // staging registers, in the inputs' dtype: r, k, w of this thread's P1
  // tasks (4 tokens x 1 channel each) and v elements of the window. Task =
  // (chunk c, sub-chunk q, channel kk), kk fastest, so a warp's stores of
  // one token row hit consecutive banks.
  E pr[TPT][WSC], pk[TPT][WSC], pw[TPT][WSC], pv[VPT];
  const E zero = from_f<E>(0.f), one = from_f<E>(1.f);
  auto fetch = [&](int w0) {
#pragma unroll
    for (int it = 0; it < TPT; ++it) {
      const int task = tid + it * WNT;
      const int c = task / NTASK, rem = task % NTASK;
      const int kk = rem % HD, q = rem / HD;
#pragma unroll
      for (int e = 0; e < WSC; ++e) {
        const int tt = w0 + c * WC + q * WSC + e;
        if (task < NTW && tt < T) {
          const size_t idx = base + (size_t)tt * stride_t + kk;
          pr[it][e] = r[idx];
          pk[it][e] = k[idx];
          pw[it][e] = w[idx];
        } else {                    // padding token: an exact identity
          pr[it][e] = zero;
          pk[it][e] = zero;
          pw[it][e] = one;
        }
      }
    }
#pragma unroll
    for (int vq = 0; vq < VPT; ++vq) {
      const int e = tid + vq * WNT;
      const int c = e / NVE, j = (e % NVE) / WV, col = e % WV;
      const int tt = w0 + c * WC + j;
      pv[vq] = (e < NW * NVE && tt < T)
                   ? v[base + (size_t)tt * stride_t + c0 + col] : zero;
    }
  };

  const int n_chunks = (T + WC - 1) / WC;
  fetch(0);
  __syncthreads();
  for (int n0 = 0; n0 < n_chunks; n0 += NW) {
    const int w0 = n0 * WC;                     // first token of the window
    const int nc = min(NW, n_chunks - n0);      // chunks in the window
    STAMP(8 * (n0 / NW));        // stamps of window n: slots 8n .. 8n+5
    // ---- P1a
    float kl[TPT][WSC];
#pragma unroll
    for (int it = 0; it < TPT; ++it) {
      const int task = tid + it * WNT;
      if ((task & ~31) >= NTW) break;           // a warp with no task
      const int c = task / NTASK, rem = task % NTASK;
      const int kk = rem % HD, q = rem / HD;
      float* slot = sm + c * PC;
      float rv[WSC], kv[WSC], wv[WSC];
#pragma unroll
      for (int e = 0; e < WSC; ++e) {
        rv[e] = to_f(pr[it][e]);
        kv[e] = to_f(pk[it][e]);
        wv[e] = to_f(pw[it][e]);
      }
      float qloc = 1.f;                          // prod_{l=i0}^{i-1} w_l
      float sfx = 1.f;                           // prod_{l=j+1}^{i0+3} w_l
#pragma unroll
      for (int e = WSC - 1; e >= 0; --e) {
        kl[it][e] = kv[e] * sfx;
        sfx *= wv[e];
      }
      float dp[WNDIAG];
      {
        const float uk = task < NTW ? sm[L::U + kk] : 0.f;
        int p = 0;
#pragma unroll
        for (int ei = 0; ei < WSC; ++ei) {
#pragma unroll
          for (int ej = 0; ej <= ei; ++ej, ++p) {
            float z = ei == ej ? uk : 1.f;
#pragma unroll
            for (int l = ej + 1; l < ei; ++l) z *= wv[l];
            dp[p] = rv[ei] * kv[ej] * z;
          }
        }
      }
      if (task < NTW) {
#pragma unroll
        for (int e = 0; e < WSC; ++e) {
          slot[L::QH + (q * WSC + e) * LQ + kk] = rv[e] * qloc;
          qloc *= wv[e];
        }
        slot[L::TQ + q * HD + kk] = qloc;
      }
      // sum the scores over 4 adjacent channels (one sub-chunk: HD >= 4)
#pragma unroll
      for (int p = 0; p < WNDIAG; ++p) {
        dp[p] += __shfl_xor_sync(0xffffffffu, dp[p], 1);
        dp[p] += __shfl_xor_sync(0xffffffffu, dp[p], 2);
      }
      if (task < NTW && (lane & 3) == 0) {
#pragma unroll
        for (int p = 0; p < WNDIAG; ++p)
          slot[L::DP + (rem / 4) * WNDIAG + p] = dp[p];
      }
    }
#pragma unroll
    for (int vq = 0; vq < VPT; ++vq) {
      const int e = tid + vq * WNT;
      if (e < NW * NVE) {
        const int c = e / NVE, j = (e % NVE) / WV, col = e % WV;
        sm[c * PC + L::VS + j * LS + col] = to_f(pv[vq]);
      }
    }
    if (n0 + NW < n_chunks) fetch(w0 + NW * WC);
    __syncthreads();
    STAMP(8 * (n0 / NW) + 1);

    // ---- P1b
#pragma unroll
    for (int it = 0; it < TPT; ++it) {
      const int task = tid + it * WNT;
      if (task < NTW) {
        const int c = task / NTASK, rem = task % NTASK;
        const int kk = rem % HD, q = rem / HD;
        float* slot = sm + c * PC;
        float tp[WNS];
#pragma unroll
        for (int p = 0; p < WNS; ++p) tp[p] = slot[L::TQ + p * HD + kk];
        float pre = 1.f, post = 1.f;
#pragma unroll
        for (int p = 0; p < WNS; ++p) {
          if (p < q) pre *= tp[p];
          if (p > q) post *= tp[p];
        }
#pragma unroll
        for (int e = 0; e < WSC; ++e) {
          const int i = q * WSC + e;
          slot[L::QT + i * LQ + kk] = slot[L::QH + i * LQ + kk] * pre;
          slot[L::KT + i * LK + kk] = kl[it][e] * post;
          float d = 1.f;                         // prod over sub-chunks q+1..I-1
#pragma unroll
          for (int sub = 1; sub < WNS; ++sub) {
            if (sub > q) {
              slot[L::KH + (kh_row(sub) + i) * LQ + kk] = kl[it][e] * d;
              d *= tp[sub];
            }
          }
        }
        if (q == 0) slot[L::TOT + kk] = tp[0] * tp[1] * tp[2] * tp[3];
      }
    }
    __syncthreads();
    STAMP(8 * (n0 / NW) + 2);

    // ---- P2: scores between sub-chunks (tensor cores), then inside them
    for (int unit = warp; unit < nc * 6; unit += NWARP) {
      const int c = unit / 6, nt = unit % 3, half = (unit % 6) / 3;
      const float* slot = sm + c * PC;
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, acc2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kq = 0; kq < KH2; ++kq) {
        const int ks = half * KH2 + kq;
        float a[4], bb[2];
        frag_a(a, slot + L::QH, LQ, g, t4, ks);
        const float* kh = slot + L::KH + (8 * nt + g) * LQ + 8 * ks;
        bb[0] = kh[t4];
        bb[1] = kh[t4 + 4];
        if (kq & 1) mma3(acc2, a, bb); else mma3(acc, a, bb);
      }
      float* dst = sm + c * PC + (half ? L::A1 : L::A);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = g + (e >> 1) * 8, col = 8 * nt + 2 * t4 + (e & 1);
        const int sub = col < kh_row(2) ? 1 : col < kh_row(3) ? 2 : 3;
        if (i / WSC == sub)                  // the k side of i's own sub-chunk
          dst[i * LA + col - kh_row(sub)] = acc[e] + acc2[e];
      }
    }
    for (int d = tid; d < nc * WNS * WNDIAG; d += WNT) {
      const int c = d / (WNS * WNDIAG), dd = d % (WNS * WNDIAG);
      const int q = dd / WNDIAG, p = dd - q * WNDIAG;
      float* slot = sm + c * PC;
      float sum = 0.f;
#pragma unroll
      for (int gp = 0; gp < HD / 4; ++gp)
        sum += slot[L::DP + (q * (HD / 4) + gp) * WNDIAG + p];
      int ei = 0;
      while ((ei + 1) * (ei + 2) / 2 <= p) ++ei;
      const int ej = p - ei * (ei + 1) / 2;
      slot[L::A + (q * WSC + ei) * LA + q * WSC + ej] = sum;
    }
    __syncthreads();
    STAMP(8 * (n0 / NW) + 3);

    // ---- P3: the chain of states through the window
#pragma unroll
    for (int rep = 0; rep < SREP; ++rep) {
      const int ti = warp + NWARP * rep;
      if (ti < NTILE) {
        const int mt = ti / NTN, nt = ti % NTN;
        const int r0 = 16 * mt + g, col = 8 * nt + 2 * t4;
        for (int c = 0; c < nc; ++c) {
          float* slot = sm + c * PC;
          slot[L::SN + r0 * LS + col] = sacc[rep][0];
          slot[L::SN + r0 * LS + col + 1] = sacc[rep][1];
          slot[L::SN + (r0 + 8) * LS + col] = sacc[rep][2];
          slot[L::SN + (r0 + 8) * LS + col + 1] = sacc[rep][3];
          const float tl = slot[L::TOT + r0], th = slot[L::TOT + r0 + 8];
          sacc[rep][0] *= tl;
          sacc[rep][1] *= tl;
          sacc[rep][2] *= th;
          sacc[rep][3] *= th;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            // A = KT^T: A[m][j] = KT[j][16 mt + m]
            const float* kt = slot + L::KT + (8 * ks + t4) * LK + 16 * mt + g;
            const float a[4] = {kt[0], kt[8], kt[4 * LK], kt[4 * LK + 8]};
            float bb[2];
            bb[0] = slot[L::VS + (8 * ks + t4) * LS + 8 * nt + g];
            bb[1] = slot[L::VS + (8 * ks + t4 + 4) * LS + 8 * nt + g];
            mma3(sacc[rep], a, bb);
          }
        }
      }
    }
    __syncthreads();
    STAMP(8 * (n0 / NW) + 4);

    // ---- P4: y = QT S_start + (A + A1) V
    for (int unit = warp; unit < nc * NTN; unit += NWARP) {
      const int c = unit / NTN, nt = unit % NTN;
      const float* slot = sm + c * PC;
      float ys[4] = {0.f, 0.f, 0.f, 0.f}, ys2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        float a[4], bb[2];
        frag_a(a, slot + L::QT, LQ, g, t4, ks);
        bb[0] = slot[L::SN + (8 * ks + t4) * LS + 8 * nt + g];
        bb[1] = slot[L::SN + (8 * ks + t4 + 4) * LS + 8 * nt + g];
        if (ks & 1) mma3(ys2, a, bb); else mma3(ys, a, bb);
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        float a[4], a1[4], bb[2];
        frag_a(a, slot + L::A, LA, g, t4, ks);
        frag_a(a1, slot + L::A1, LA, g, t4, ks);
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] += a1[e];
        bb[0] = slot[L::VS + (8 * ks + t4) * LS + 8 * nt + g];
        bb[1] = slot[L::VS + (8 * ks + t4 + 4) * LS + 8 * nt + g];
        mma3(ks ? ys2 : ys, a, bb);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int tt = w0 + c * WC + g + 8 * half;
        if (tt < T) {
          const size_t o = base + (size_t)tt * stride_t + c0 + 8 * nt + 2 * t4;
          y[o] = from_f<E>(ys[2 * half] + ys2[2 * half]);
          y[o + 1] = from_f<E>(ys[2 * half + 1] + ys2[2 * half + 1]);
        }
      }
    }
    __syncthreads();
    STAMP(8 * (n0 / NW) + 5);
  }

#pragma unroll
  for (int rep = 0; rep < SREP; ++rep) {
    const int ti = warp + NWARP * rep;
    if (ti < NTILE) {
      const int mt = ti / NTN, nt = ti % NTN;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mt + g + (e >> 1) * 8, col = 8 * nt + 2 * t4 + (e & 1);
        st[(size_t)row * HD + c0 + col] = sacc[rep][e];
      }
    }
  }
}

template <typename E, int HD>
int launch_chunked(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* state, void* y, int B, int T, int H,
                   cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * ChunkSmem<HD>::TOTAL;
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv6_chunk_kernel<E, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  wkv6_chunk_kernel<E, HD><<<dim3(B * H, HD / WV), WNT, smem, stream>>>(
      (const E*)r, (const E*)k, (const E*)v, (const E*)w, (const float*)u,
      (float*)state, (E*)y, T, H);
  return (int)cudaGetLastError();
}

// splits = 0: the per-token body; else the chunked body with the hd
// v-columns of a head over `splits` = hd/16 blocks of 16 columns
template <typename E, int HD>
int launch_hd(const void* r, const void* k, const void* v, const void* w,
              const void* u, void* state, void* y, int B, int T, int H,
              int splits, cudaStream_t stream) {
  if (splits == 0) {
    wkv6_kernel<E, HD><<<dim3(B * H), HD, 0, stream>>>(
        (const E*)r, (const E*)k, (const E*)v, (const E*)w, (const float*)u,
        (float*)state, (E*)y, T, H);
    return (int)cudaGetLastError();
  }
  if (splits * WV == HD)
    return launch_chunked<E, HD>(r, k, v, w, u, state, y, B, T, H, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename E>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* state, void* y, int B, int T, int H, int hd,
           int splits, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_hd<E, 16>(r, k, v, w, u, state, y, B, T, H, splits, stream);
    case 32: return launch_hd<E, 32>(r, k, v, w, u, state, y, B, T, H, splits, stream);
    case 64: return launch_hd<E, 64>(r, k, v, w, u, state, y, B, T, H, splits, stream);
    case 128: return launch_hd<E, 128>(r, k, v, w, u, state, y, B, T, H, splits, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, w: (B, T, H, hd) in `dtype` (0 = float32, 1 = bfloat16);
// u: (H, hd) fp32; state: (B, H, hd, hd) fp32, read and overwritten with the
// state after token T-1; y: (B, T, H, hd) in `dtype`. hd in {16,32,64,128},
// T >= 1; `splits` selects the body (0 = per token; else the chunked body
// on a grid (B*H, splits), splits = hd/16). Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* state, void* y,
                           int B, int T, int H, int hd, int dtype, int splits,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, state, y, B, T, H, hd, splits, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, state, y, B, T, H, hd,
                                 splits, s);
  return (int)cudaErrorInvalidValue;
}
