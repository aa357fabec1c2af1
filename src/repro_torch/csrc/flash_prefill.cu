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
// Bound on the H100: the larger of bytes / 3.35 TB/s (q, out, and each
// entry's K/V up to its last position, read once) and flops / 989 TFLOP/s
// (4 * H * hd per query-key pair inside the causal band, bf16 tensor-core
// peak). At the main-path shape (512 packed tokens over cached prefixes up
// to ~1k; chip_smoke.py prints both) the two are of the same order, about
// 5 us; longer chunks make the flops dominate. So the bf16 body runs both
// products on the tensor cores and keeps the next keys' copies in flight
// while it multiplies. Each query tile reads its entry's keys again (from
// L2, not HBM): 32-token tiles halve that traffic against 16-token ones.
//
// Design of the bf16 body (the serving path):
//  * One block per (query tile, KV head, head chunk, column half). A tile
//    is up to BQ = 32 consecutive flat tokens of ONE packed entry; the
//    host-built tile list holds (entry, first token, end token). Two
//    consumer warpgroups (4 warps each) take the tile's two 16-token
//    halves times 4 query heads of the KV head: 64 rows, the M of one
//    `wgmma`, warp w holding query head w's 16 rows. G = H / Hkv = 4
//    (qwen3) fills the 4 heads; G < 4 leaves zero queries in the missing
//    heads' rows (never written); G > 4 spreads over head chunks of 4
//    (grid.y). A tile of at most 16 tokens leaves the second warpgroup
//    idle. The two warpgroups share the block's K/V copies and run
//    independently (no block barrier in the loop), so one's softmax
//    overlaps the other's products.
//  * A producer warp copies K/V by TMA into a ring of 3 stages (2 at hd >
//    128) of KB = 64 keys, up to 2 key blocks ahead: one load per (page,
//    64-column box), P rows x 128 bytes, through 2-D tensor maps over the
//    whole K and V pools (kernels/tma.py, built once per pool; a layer is
//    a row offset). Full / empty mbarriers hand the stages between the
//    producer and the consumer warps. The producer reads each key
//    block's page ids from its entry's block-table row in global memory
//    as it issues the block's copies (a shared-memory copy of the row
//    grew with the entry: 128 KB at 524,288 tokens of 16-row pages,
//    past the card's 227 KB with hd 256's ring). A tile's key
//    blocks start on a page boundary; pages past the entry's last one
//    repeat it (finite values, masked out). TMA, because 16-byte
//    `cp.async` copies issued by threads capped the copy rate at about 8
//    bytes per cycle per SM on this card.
//  * Both products on the tensor cores with `wgmma` (bf16 in, fp32
//    accumulate), per key block: S = Q K^T as m64n64k16 with both operands
//    read from shared memory, then the online softmax in registers on the
//    fp32 accumulator (m, l per row, exp2 with log2(e) folded into the
//    scale, rows reduced across the 4 lanes that share them, O rescaled
//    only when a row maximum moves), then O += P V as m64nDVk16 with P from
//    registers (the S accumulator is laid out as the A fragments) and V
//    read from shared memory as an MN-major operand. `wgmma` and not
//    `mma.sync`: a warpgroup reads each K/V tile from shared memory once,
//    where per-warp `mma.sync` fragments read it once per warp, and that
//    shared-memory traffic bound the kernel on this card.
//  * K and V land with the 128-byte swizzle that TMA writes and the
//    descriptors name (8-row atoms of 128-byte rows; a 16-column step of
//    QK is 32 bytes into a row); Q is copied by the consumers with
//    `cp.async` in the unswizzled core-matrix layout.
//  * P keeps its fp32 precision: it enters PV as three bf16 parts (hi +
//    mid + lo hold all 24 bits; three products on one V tile). With P
//    rounded once to bf16, as FlashAttention does, a row over a few keys
//    comes out up to 2^-9 off, and its bf16 output flips by an ulp (1.6e-2
//    at |out| in [2, 4)) against the fp32 plain version.
//  * Head dims: the body is compiled for HDP in {16, 32, 64, 128, 256};
//    hd is padded to the next of them with zero query columns (danube's
//    120 runs as 128); a K/V box always spans 64 columns, and the columns
//    past hd (the next head's, or zeros past the pool) meet zero queries
//    and are never written. The PV accumulator covers at most DV = 128
//    columns, so hd 256 runs as two column halves (grid.z = 2), each
//    recomputing S. Pages of 8, 16, 32 or 64 rows.
//  * Masks and skips as before: causal and window masks from each row's
//    position (entry_start + offset), masked scores -1e30, softcap
//    c * tanh(s / c), denom = max(l, 1e-30); a key block wholly inside
//    every row's band skips the mask. The key loop starts at the page of
//    the first key the tile's first row can see (window) and stops after
//    its last row's position, so key blocks outside the band are never
//    read. Tiles with entry -1 cover the bucket's padding and write zeros;
//    unused tile slots (end <= start) exit.
//  * fp32 inputs (the sweeps, the fp32 parity runs) go through an exact
//    fp32 CUDA-core body: one block per (16-token half tile, KV head, head
//    chunk), pages staged in shared memory, one thread per (row, key)
//    score. A head chunk is the most of the KV head's G query heads (a
//    divisor of G) whose rows fit the card's shared memory: all G at
//    every shape but recurrentgemma's (G 10, hd 256: 416 KB for 160 rows,
//    so 5 chunks of 2). It is chosen by dtype (no TF32), not a fallback.
//  * The dense entry point (kernels/flash_prefill.py::flash_prefill, the
//    Pallas signature) views (B, S, Hkv, hd) K/V as B contiguous one-entry
//    page runs (padded to a multiple of 16 rows for bf16) and launches the
//    same bodies.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BQ = 32;           // max tokens per query tile
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// --------------------------------------------------------------------------
// fp32 body: exact products on the CUDA cores
// --------------------------------------------------------------------------

constexpr int NT_F32 = 128;
constexpr int SUB = 16;          // tokens per fp32 block (half a tile)

__global__ void __launch_bounds__(NT_F32)
prefill_f32_kernel(const float* __restrict__ q, const float* __restrict__ k_pages,
                   const float* __restrict__ v_pages,
                   const int* __restrict__ cu_tokens,
                   const int* __restrict__ entry_bt,
                   const int* __restrict__ entry_start,
                   const int* __restrict__ tiles, float* __restrict__ out,
                   int H, int Hkv, int GC, int hd, int P, int Pb, int ppi,
                   float scale, float softcap, int window) {
  // block y: (KV head, head chunk of GC of its H / Hkv query heads)
  const int n_hc = H / Hkv / GC;
  const int kvh = blockIdx.y / n_hc, t = threadIdx.x;
  const int h0 = kvh * (H / Hkv) + (blockIdx.y - kvh * n_hc) * GC;
  const int* tl = tiles + 3 * (blockIdx.x >> 1);   // block: half a tile
  const int entry = tl[0], t0 = tl[1] + (blockIdx.x & 1) * SUB;
  const int t1 = min(min(tl[2], tl[1] + BQ), t0 + SUB);
  if (t1 <= t0) return;                        // unused tile slot or half
  const int G = GC;                            // query heads of this block
  const int n = t1 - t0;
  const int R = SUB * G;                       // rows: token-major (i*G + g)
  if (entry < 0) {                             // bucket padding: zeros
    for (int e = t; e < n * G * hd; e += NT_F32) {
      const int r = e / hd, d = e - r * hd;
      const int i = r / G, g = r - i * G;
      out[((long long)(t0 + i) * H + h0 + g) * hd + d] = 0.f;
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
  for (int e = t; e < n * G * hd; e += NT_F32) {
    const int r = e / hd, d = e - r * hd;
    const int i = r / G, g = r - i * G;
    q_s[r * hdp + d] = q[((long long)(t0 + i) * H + h0 + g) * hd + d];
  }
  for (int e = t; e < R * hd; e += NT_F32) acc_s[e] = 0.f;
  for (int r = t; r < R; r += NT_F32) { m_s[r] = NEG; l_s[r] = 0.f; }

  // first key any row sees: kp > pos0 - window  <=>  kp >= pos0 - window + 1
  // (window <= 0 means none; the 2^30 global sentinel cannot overflow int32)
  const int key_lo = window > 0 ? max(0, pos0 - window + 1) : 0;
  const int pg_end = min(pos_last / P + 1, Pb);
  for (int pg0 = key_lo / P; pg0 < pg_end; pg0 += ppi) {
    const int npg = min(ppi, pg_end - pg0);
    const int kc = npg * P;
    __syncthreads();
    for (int e = t; e < kc * hd; e += NT_F32) {
      const int j = e / hd, d = e - j * hd;
      const long long page = bt[pg0 + j / P];
      const long long src = ((page * P + (j % P)) * Hkv + kvh) * hd + d;
      k_s[j * hdp + d] = k_pages[src];
      v_s[j * hd + d] = v_pages[src];
    }
    __syncthreads();
    for (int e = t; e < n * G * kc; e += NT_F32) {
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
    for (int r = t; r < n * G; r += NT_F32) {
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
    for (int e = t; e < n * G * hd; e += NT_F32) {
      const int r = e / hd, d = e - r * hd;
      const float* pr = s_s + r * KC;
      float a = acc_s[e] * c_s[r];
      for (int j = 0; j < kc; ++j) a = fmaf(pr[j], v_s[j * hd + d], a);
      acc_s[e] = a;
    }
  }
  __syncthreads();
  for (int e = t; e < n * G * hd; e += NT_F32) {
    const int r = e / hd, d = e - r * hd;
    const int i = r / G, g = r - i * G;
    out[((long long)(t0 + i) * H + h0 + g) * hd + d] =
        acc_s[e] / fmaxf(l_s[r], 1e-30f);
  }
}

int launch_f32(const void* q, const void* k, const void* v, const void* cu,
               const void* ebt, const void* est, const void* tiles, void* out,
               int n_tiles, int H, int Hkv, int hd, int P, int Pb,
               float softcap, int window, cudaStream_t stream) {
  const int G = H / Hkv;
  const int ppi = P >= 32 ? 1 : 32 / P;
  const int KC = ppi * P;
  int dev = 0, optin = 0;
  cudaError_t qe = cudaGetDevice(&dev);
  if (qe == cudaSuccess)
    qe = cudaDeviceGetAttribute(&optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (qe != cudaSuccess) return (int)qe;
  // the head chunk: the most query heads (a divisor of G) whose rows fit
  int GC = G;
  size_t smem = 0;
  for (; GC >= 1; --GC) {
    if (G % GC) continue;
    const size_t R = (size_t)SUB * GC;
    smem = sizeof(float) *
        (R * (hd + 1) + (size_t)KC * (hd + 1) + (size_t)KC * hd + R * KC +
         R * hd + 3 * R);
    if (smem <= (size_t)optin) break;
  }
  if (GC < 1) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        prefill_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_tiles <= 0) return 0;
  const float scale = 1.0f / sqrtf((float)hd);
  prefill_f32_kernel<<<dim3(2 * n_tiles, Hkv * (G / GC)), NT_F32, smem,
                       stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)cu,
      (const int*)ebt, (const int*)est, (const int*)tiles, (float*)out, H,
      Hkv, GC, hd, P, Pb, ppi, scale, softcap, window);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// bf16 body: wgmma tensor-core products fed by a cp.async ring
// --------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int KB = 64;           // keys per block step (the N of S = Q K^T)
constexpr int NWG = 2;           // warpgroups per block: the tile's two
                                 // 16-token halves x 4 query heads
constexpr int DV_MAX = 128;      // PV accumulator columns per block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 writes zeros (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// this thread's shared-memory writes, visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// 2^x, flushing results below 2^-126 to zero (they are < 1e-38 of the
// row's largest weight)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory matrix descriptor, no swizzle: the matrix is stored as
// core matrices of 8 rows x 16 bytes (128 contiguous bytes); lbo is the
// byte stride between core matrices along K, sbo along M/N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo,
                                              int sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
// The same with the 128-byte swizzle (layout type 1): rows of 128 bytes in
// 1024-byte atoms of 8 rows, as TMA writes them with that swizzle; sbo is
// the stride between 8-row atoms, lbo between 64-column atoms (MN-major).
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p, int lbo,
                                                    int sbo) {
  return smem_desc(p, lbo, sbo) | (1ull << 62);
}

// byte offset of 16-byte chunk c of row r in a blocked tile whose rows
// hold `chunks` chunks: core matrix (r / 8, c), row r % 8 inside it
__device__ __forceinline__ int blocked(int r, int c, int chunks) {
  return ((r >> 3) * chunks + c) * 128 + (r & 7) * 16;
}

// d (64 x 64) = A (64 x 16, K-major in shared memory) * B^T (64 x 16,
// K-major in shared memory); scale_d = 0 ignores the old d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 16) += a (64 x 16, registers) * B (16 x 16, MN-major in shared
// memory)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32) += a (64 x 16, registers) * B (16 x 32, MN-major in shared
// memory)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += a (64 x 16, registers) * B (16 x 64, MN-major in shared
// memory)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += a (64 x 16, registers) * B (16 x 128, MN-major in shared
// memory)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

// (x, y) = hi + mid + lo, three bf16 pairs holding all 24 bits of each
// fp32 value (each residual is exact in fp32)
__device__ __forceinline__ void split3(float x, float y, uint32_t& h,
                                       uint32_t& m, uint32_t& l) {
  const __nv_bfloat162 hb = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(hb);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 mb = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(mb);
  h = bits(hb);
  m = bits(mb);
  l = pack_bf16(rx - mf.x, ry - mf.y);
}

template <int HDP>
struct Geom {
  static constexpr int DV = HDP < DV_MAX ? HDP : DV_MAX;
  static constexpr int STAGES = HDP > 128 ? 2 : 3;   // K/V ring depth
  static constexpr int KH = HDP < 64 ? 1 : HDP / 64;  // 64-column K boxes
  static constexpr int VH = DV < 64 ? 1 : DV / 64;    // ... V boxes
  static constexpr int HALF = KB * 128;         // one 64-column box column
  static constexpr int QBYTES = 64 * HDP * 2;   // one warpgroup's Q rows
  static constexpr int KBYTES = KH * HALF;      // one K stage
  static constexpr int VBYTES = VH * HALF;      // one V stage
  // (1024-byte alignment slack) K/V ring, Q tiles, barriers
  static constexpr size_t smem() {
    return 1024 + (size_t)STAGES * (KBYTES + VBYTES) + (size_t)NWG * QBYTES +
           128;
  }
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}
// one arrival that also expects `bytes` of TMA copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// arrive on bar once this thread's earlier cp.async copies have landed
// (counted in the barrier's init count)
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
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

template <int HDP>
__global__ void __launch_bounds__(128 * NWG + 32)
prefill_bf16_kernel(const bf16* __restrict__ q,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, int k_row0,
                    int v_row0, const int* __restrict__ cu_tokens,
                    const int* __restrict__ entry_bt,
                    const int* __restrict__ entry_start,
                    const int* __restrict__ tiles, bf16* __restrict__ out,
                    int H, int Hkv, int hd, int P, int Pb, int n_hc,
                    float scale, float softcap, int window) {
  using Gm = Geom<HDP>;
  constexpr int DV = Gm::DV, ST = Gm::STAGES;
  constexpr int KCH = HDP / 8;                 // 16-byte chunks per Q row
  constexpr int HALF = Gm::HALF;
  const int kvh = blockIdx.y / n_hc, hc = blockIdx.y - kvh * n_hc;
  const int dbase = blockIdx.z * DV;
  const int G = H / Hkv;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = hc * 4 + warp;                 // this warp's query head
  const int* tl = tiles + 3 * blockIdx.x;
  const int entry = tl[0], t0 = tl[1];
  const int t1 = min(tl[2], t0 + BQ);
  if (t1 <= t0) return;                        // unused tile slot
  const int n = t1 - t0;
  if (entry < 0) {                             // bucket padding: zeros
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = threadIdx.x; e < n * 4 * DV; e += blockDim.x) {
      const int i = e / (4 * DV), r = e - i * 4 * DV;
      const int w = r / DV, d = dbase + (r - w * DV);
      const int gg = hc * 4 + w;
      if (gg < G && d < hd)
        out[((long long)(t0 + i) * H + kvh * G + gg) * hd + d] = zero;
    }
    return;
  }
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sK = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sV = sK + ST * Gm::KBYTES;                // [ST]
  unsigned char* sQ = sV + ST * Gm::VBYTES;                // [NWG] Q tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(sQ + NWG * Gm::QBYTES);
  uint64_t* empty = full + ST;                              // [ST] data used
  uint64_t* qbar = empty + ST;                              // Q in

  const int pos0 = entry_start[entry] + (t0 - cu_tokens[entry]);
  const int pos_last = pos0 + n - 1;
  // keys from the page holding the first key the first row sees (window;
  // the 2^30 global sentinel cannot overflow int32) to the last row's own
  // position, within the block table; key blocks of KB keys start on a
  // page boundary
  const int key_lo = window > 0 ? max(0, pos0 - window + 1) : 0;
  const int key_end = min(pos_last + 1, Pb * P);
  const int pg_lo = key_lo / P, kb0 = pg_lo * P;
  const int n_pg = key_end > kb0 ? (key_end - kb0 + P - 1) / P : 0;
  const int nblk = key_end > kb0 ? (key_end - kb0 + KB - 1) / KB : 0;
  const int n_wg = n > 16 ? 2 : 1;             // warpgroups with tokens
  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);                  // the producer's expect_tx
      mbar_init(&empty[i], 4 * n_wg);          // each consumer warp
    }
    mbar_init(qbar, 128 * NWG);                // each consumer thread
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer warp: the K/V ring by TMA, ST - 1 blocks ahead ----
    const int* bt_row = entry_bt + (long long)entry * Pb + pg_lo;
    const int pps = KB / P;                    // pages per key block
    constexpr int per_page = Gm::KH + Gm::VH;  // TMA loads per page
    for (int it = 0; it < nblk; ++it) {
      const int st = it % ST;
      if (it >= ST) mbar_wait(&empty[st], (it / ST - 1) & 1);
      if (lane == 0)
        mbar_expect(&full[st], (uint32_t)(pps * P * 128 * per_page));
      __syncwarp();
      // one load per (page, 64-column box): P rows x 128 bytes, swizzled,
      // into box column h at row (page within block) * P. Columns past
      // this head's hd hold the next head's values (or zeros past the
      // pool), which Q's zero columns cancel and the output never reads.
      // Pages past the entry's last one repeat it (finite, masked out).
      for (int t = lane; t < pps * per_page; t += 32) {
        const int jp = t / per_page, h = t - jp * per_page;
        const int page = __ldg(bt_row + min(it * pps + jp, n_pg - 1));
        if (h < Gm::KH)
          tma_load_2d(sK + st * Gm::KBYTES + h * HALF + jp * P * 128, &k_map,
                      kvh * hd + h * 64, k_row0 + page * P, &full[st]);
        else
          tma_load_2d(sV + st * Gm::VBYTES + (h - Gm::KH) * HALF +
                          jp * P * 128,
                      &v_map, kvh * hd + dbase + (h - Gm::KH) * 64,
                      v_row0 + page * P, &full[st]);
      }
    }
    return;
  }

  // ---- consumer warpgroups: one token half x 4 query heads each ----
  // Q rows: warpgroup wq (token half), row r = 16 * warp + token, blocked
  // K-major; every consumer thread copies its share, then arrives on qbar
  for (int e = threadIdx.x; e < NWG * 64 * KCH; e += 128 * NWG) {
    const int row = e / KCH, c = e - row * KCH;
    const int wq = row >> 6, r = row & 63;
    const int i = wq * 16 + (r & 15), gg = hc * 4 + (r >> 4);
    const bool ok = i < n && gg < G && c * 8 < hd;
    const bf16* src =
        ok ? q + ((long long)(t0 + i) * H + kvh * G + gg) * hd + c * 8 : q;
    cp_async16(sQ + wq * Gm::QBYTES + blocked(r, c, KCH), src, ok);
  }
  mbar_arrive_cp_async(qbar);
  if (wg >= n_wg) return;
  const int gid = lane >> 2, tq = lane & 3;    // accumulator row / col pair
  const int qfirst = pos0 + wg * 16;           // the half's first position
  const int qpos0 = qfirst + gid, qpos1 = qpos0 + 8;
  const int win = window > 0 ? window : 1 << 30;
  float o[DV / 2];                             // 64 x DV over the warpgroup
#pragma unroll
  for (int j = 0; j < DV / 2; ++j) o[j] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  const uint64_t dq = smem_desc(sQ + wg * Gm::QBYTES, 128, KCH * 128);
  mbar_wait(qbar, 0);
  fence_async_smem();                          // Q copies, to the tensor cores

  for (int it = 0; it < nblk; ++it) {
    const int st = it % ST;
    mbar_wait(&full[st], (it / ST) & 1);       // keys of block `it` landed
    // S = Q K^T (64 x 64): K-major Q (no swizzle) and K (128-byte swizzle,
    // 64-column boxes; a 16-column step is 32 bytes into a box row)
    const unsigned char* kst = sK + st * Gm::KBYTES;
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HDP / 16; ++ks)
      wgmma_ss_n64(s, dq + ks * 16,
                   smem_desc_sw128(kst + (ks / 4) * HALF + (ks % 4) * 32, 16,
                                   1024),
                   ks);
    wgmma_commit_wait();
    // s[4j + c]: row gid (c < 2) or gid + 8, key 8j + 2tq + (c & 1).
    // Scale (log2 domain) and softcap, then masks and block row maxima;
    // the softcap branch sits outside the element loops
    if (softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        s[j] = softcap * tanhf(s[j] * scale / softcap) * LOG2E;
    } else {
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] *= scale * LOG2E;
    }
    // masks only where the block crosses the causal diagonal, the end of
    // the keys or the window's start for some row of this half
    const int kbase = kb0 + it * KB;
    if (kbase + KB - 1 > qfirst || kbase + KB > key_end ||
        kbase <= qfirst + 15 - win) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int kp = kbase + (j >> 2) * 8 + 2 * tq + (j & 1);
        const int qp = (j & 2) ? qpos1 : qpos0;
        const bool ok = kp <= qp && kp < key_end && kp > qp - win;
        s[j] = ok ? s[j] : NEG;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j & 2) mx1 = fmaxf(mx1, s[j]); else mx0 = fmaxf(mx0, s[j]);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    if (mx0 != m0 || mx1 != m1) {              // rescale only on a new max
      const float corr0 = ex2(m0 - mx0), corr1 = ex2(m1 - mx1);
      l0 *= corr0;
      l1 *= corr1;
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) o[j] *= (j & 2) ? corr1 : corr0;
      m0 = mx0;
      m1 = mx1;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      s[j] = ex2(s[j] - ((j & 2) ? m1 : m0));
      if (j & 2) l1 += s[j]; else l0 += s[j];
    }
    // O += P V: the S accumulator of key columns 16kk..16kk+15 is the A
    // fragment of key step kk, entered as hi + mid + lo bf16 parts so the
    // product keeps P's fp32 precision; V is an MN-major B operand
    // V: MN-major with the 128-byte swizzle, 64-column atoms HALF apart
    const uint64_t dv = smem_desc_sw128(sV + st * Gm::VBYTES, HALF, 1024);
    uint32_t ah[KB / 16][4], am[KB / 16][4], al[KB / 16][4];
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        split3(s[8 * kk + 2 * c], s[8 * kk + 2 * c + 1], ah[kk][c], am[kk][c],
               al[kk][c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      const uint64_t dvk = dv + kk * 128;       // keys 16kk: two 8-row atoms
      wgmma_rs<DV>(o, al[kk], dvk);
      wgmma_rs<DV>(o, am[kk], dvk);
      wgmma_rs<DV>(o, ah[kk], dvk);
    }
    wgmma_commit_wait();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);    // this warp is done with it
  }
  if (g >= G) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int i0 = wg * 16 + gid;                // tile token of row gid
  bf16* o0 = out + ((long long)(t0 + i0) * H + kvh * G + g) * hd;
  bf16* o1 = o0 + 8LL * H * hd;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const int d = dbase + j * 8 + 2 * tq;
    if (d < hd) {
      if (i0 < n)
        *reinterpret_cast<uint32_t*>(o0 + d) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (i0 + 8 < n)
        *reinterpret_cast<uint32_t*>(o1 + d) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

template <int HDP>
int launch_bf16_hd(const void* q, const CUtensorMap& km,
                   const CUtensorMap& vm, int k_row0, int v_row0,
                   const void* cu, const void* ebt, const void* est,
                   const void* tiles, void* out, int n_tiles, int H, int Hkv,
                   int hd, int P, int Pb, float softcap, int window,
                   cudaStream_t stream) {
  const int G = H / Hkv;
  const int n_hc = (G + 3) / 4;                // 4 query heads per block
  const size_t smem = Geom<HDP>::smem();
  static size_t configured = 0;                // max smem set so far
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        prefill_bf16_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  if (n_tiles <= 0) return 0;
  const float scale = 1.0f / sqrtf((float)hd);
  const int dv = Geom<HDP>::DV;
  prefill_bf16_kernel<HDP><<<dim3(n_tiles, Hkv * n_hc, (hd + dv - 1) / dv),
                             128 * NWG + 32, smem, stream>>>(
      (const bf16*)q, km, vm, k_row0, v_row0, (const int*)cu,
      (const int*)ebt, (const int*)est, (const int*)tiles, (bf16*)out, H, Hkv,
      hd, P, Pb, n_hc, scale, softcap, window);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const CUtensorMap& km, const CUtensorMap& vm,
                int k_row0, int v_row0, const void* cu, const void* ebt,
                const void* est, const void* tiles, void* out, int n_tiles,
                int H, int Hkv, int hd, int P, int Pb, float softcap,
                int window, cudaStream_t stream) {
  if (hd % 8 != 0 || hd > 256 || P < 8 || KB % P != 0)
    return (int)cudaErrorInvalidValue;
#define FP_LAUNCH(HDP)                                                      \
  return launch_bf16_hd<HDP>(q, km, vm, k_row0, v_row0, cu, ebt, est, tiles, \
                             out, n_tiles, H, Hkv, hd, P, Pb, softcap,       \
                             window, stream)
  if (hd <= 16) FP_LAUNCH(16);
  if (hd <= 32) FP_LAUNCH(32);
  if (hd <= 64) FP_LAUNCH(64);
  if (hd <= 128) FP_LAUNCH(128);
  FP_LAUNCH(256);
#undef FP_LAUNCH
}

}  // namespace

extern "C" int flash_prefill_block_q() { return BQ; }

// Paged varlen entry (the engine's ragged prefill). q/out: (Tb, H, hd);
// k/v pages: (NP, P, Hkv, hd); cu_tokens (Sb+1), entry_bt (Sb, Pb),
// entry_start (Sb), tiles (n_tiles, 3) = (entry or -1, start, end).
// dtype 0 = float32: the CUDA-core body reads k_pages / v_pages (any hd).
// dtype 1 = bfloat16: the tensor-core body reads the pages through k_map /
// v_map (128-byte TMA maps from tma_map.cu with boxes of 8 columns x P
// rows over the K and V pools; this layer's pages from rows k_row0 /
// v_row0); hd a multiple of 8 up to 256, P in {8, 16, 32, 64}.
// softcap <= 0 and window <= 0 mean none. Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int flash_prefill_paged_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_map, const void* v_map, int k_row0, int v_row0,
    const void* cu_tokens, const void* entry_bt, const void* entry_start,
    const void* tiles, void* out, int n_tiles, int H, int Hkv, int hd, int P,
    int Pb, int dtype, float softcap, int window, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_f32(q, k_pages, v_pages, cu_tokens, entry_bt, entry_start,
                      tiles, out, n_tiles, H, Hkv, hd, P, Pb, softcap, window,
                      s);
  if (dtype == 1) {
    CUtensorMap km, vm;
    memcpy(&km, k_map, sizeof(km));
    memcpy(&vm, v_map, sizeof(vm));
    return launch_bf16(q, km, vm, k_row0, v_row0, cu_tokens, entry_bt,
                       entry_start, tiles, out, n_tiles, H, Hkv, hd, P, Pb,
                       softcap, window, s);
  }
  return (int)cudaErrorInvalidValue;
}
