// Flash attention (B6, the LM substrate's attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention
//
//   q [B, H, Sq, D], k/v [B, KVH, Sk, D] (GQA: query head h reads KV head
//   h / (H / KVH)), o [B, H, Sq, D] in q's type (float32 or bfloat16):
//   s = (q . k) * sm_scale in fp32, soft-capped to softcap * tanh(s /
//   softcap) when softcap > 0; masked to NEG_INF = -1e30 where
//   kpos >= kv_len, when causal where qpos < kpos, and with a window > 0
//   where qpos - kpos >= window, both positions counted from 0 (top-left
//   alignment, the Pallas kernel's; it differs from the bottom-right
//   oracle `kernels/ref.py::attention_ref` when Sq != Sk); an online
//   softmax over key tiles; o = acc / max(l, 1e-30). NEG_INF is finite,
//   so a masked tile gives no NaN. The window and the softcap are the
//   reference LM's local attention and logit_softcap
//   (src/repro/models/attention.py::_blocked_attn, _sdpa), plain einsums
//   there; the decode takes the softcap only (a top-left window masks
//   nothing for its one query).
//
// What bounds it on an H100. Prefill (Sq = Sk = S, causal): operations,
// 2 * 2 * B * H * S * S * D / 2 flops (43 GFLOP at [1, 40, 2048, 128]: 43 us
// at the 989 TFLOP/s bf16 tensor-core rate, 641 us at the 67 TFLOP/s fp32
// CUDA-core rate). Decode (Sq = 1 against a KV cache): bytes, the kv_len
// rows of K and V of each (batch, KV head), 2 * B * KVH * kv_len * D *
// sizeof(T) (34 MB at [4, 8, 2049, 128] bf16: 10 us at 3.35 TB/s).
//
// Four kernels, routed by the wrapper (kernels/flash_attention.py):
//  * Decode, Sq = 1, either type: split-KV (flash-decoding) in two
//    kernels. flash_decode_split_kernel runs on a (splits, KVH x head
//    chunks, B) grid; each CTA takes one contiguous key range of the cache
//    and serves up to 8 query heads of its KV head, so each K/V row is read
//    once. K/V tiles come in as 16-byte cp.async copies into a double
//    buffer; one warp per key row computes the row's scores for every head
//    (a shuffle reduction); the online softmax and P.V run in fp32. Each
//    CTA writes fp32 partials (m, l, o); a range wholly past kv_len writes
//    (NEG_INF, 0, 0). flash_decode_combine_kernel merges them by
//    log-sum-exp (the reference's cross-shard merge,
//    src/repro/parallel/decode_attention.py): M = max m_i,
//    L = sum l_i e^(m_i - M), O = sum o_i e^(m_i - M) / max(L, 1e-30).
//    The split plan comes from Sk, not kv_len, so the grid is the same on
//    every decode tick; range 0 always holds key 0, so M is finite. At
//    [4, 40, 1, 128] against a [4, 8, 2084, 128] cache: 11 ranges of 192
//    keys, 352 CTAs on 132 SMs.
//  * Prefill, Sq > 1, bfloat16: flash_mma_kernel, FlashAttention-2's
//    layout on mma.sync.m16n8k16 (bf16 in, fp32 accumulate): one CTA of 4
//    warps per 64 query rows of a head, each warp 16 rows; Q and
//    double-buffered 64-key K/V tiles in bf16 shared memory (cp.async, rows
//    padded by 16 bytes so ldmatrix is conflict-free); ldmatrix for Q and
//    K, ldmatrix.trans for V; the scores stay fp32 in the accumulator
//    fragments, where the online softmax runs; only P is rounded to bf16
//    for P.V. Query blocks are issued longest (causal) first.
//  * Prefill, Sq > 1, float32: flash_tile_kernel, fp32 FMAs on CUDA cores
//    (TF32 would round the inputs): one CTA of 256 threads per (query
//    block of 64 rows, head, batch); thread (ty, tx) of the 16 x 16 grid
//    owns rows ty + 16 i (i < 4) and, per 32-row key tile, score columns
//    tx + 16 j (j < 2), then output columns tx + 16 c (c < D / 16).
// Both prefill kernels skip key tiles past kv_len, past the block's last
// query row when causal, and, with a window, below the tile that holds the
// block's first query row's first key (qpos - window + 1): their scores
// would all be masked. Skipping them is exact because every query row
// keeps a key in the tiles visited (the wrapper refuses a window that
// leaves a row none), and a row's scores from tiles before its first
// unmasked key are wiped by alpha = e^(NEG_INF - m) = 0 when it comes.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit (PERF.md section 6, PR 17), device time per call:
//  * decode, q [4, 40, 1, 128] against a [4, 8, 2084, 128] cache, kv_len
//    2049, bf16: 32.5-32.7 us for split + combine (28 us + 4.3 us), bound
//    10.0 us (bytes), SDPA 14.3-14.5 us; float32 41.9-42.2 us, bound
//    20.1 us.
//  * prefill, [1, 40, 2048, 128] causal, bf16 (flash_mma_kernel): 276 us,
//    bound 43.4 us (operations), SDPA 95.5 us; float32 (flash_tile_kernel)
//    2.32-2.33 ms, bound 641 us.
//  * windowed prefill, [1, 40, 10240, 128] causal, window 8192,
//    bf16: 5.46-5.50 ms, bound 1.04 ms (operations), SDPA with a boolean
//    band mask 6.41-6.46 ms. The window and softcap tests are compiled
//    into a second instance of each kernel (kBand, kCap in the decode):
//    as run-time tests they took the plain causal bf16 prefill from 276
//    to 298 us.
// Later work (ROADMAP.md): wgmma with a TMA ring for the prefill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous (L2 only)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// the scaled score, soft-capped when softcap > 0
__device__ __forceinline__ float capped(float s, float softcap) {
  return softcap > 0.0f ? softcap * tanhf(s / softcap) : s;
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// E (2 or 4) consecutive elements of T -> floats, one vector load
template <int E, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (E == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p);
      out[0] = x.x;
      out[1] = x.y;
      out[2] = x.z;
      out[3] = x.w;
    } else {
      const float2 x = *reinterpret_cast<const float2*>(p);
      out[0] = x.x;
      out[1] = x.y;
    }
  } else {
    if constexpr (E == 4) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
      const float2 a = __bfloat1622float2(h[0]);
      const float2 b = __bfloat1622float2(h[1]);
      out[0] = a.x;
      out[1] = a.y;
      out[2] = b.x;
      out[3] = b.y;
    } else {
      const float2 a =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
      out[0] = a.x;
      out[1] = a.y;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 tile kernel (prefill, float32)
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 32;        // key rows per tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid

// rows [row0, row0 + rows) of a [n, D] float matrix into shared memory (row
// stride `stride` floats); rows at or past n are zero
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, int stride,
                                           const float* __restrict__ src,
                                           int row0, int rows, int n) {
  constexpr int kChunks = D / 4;  // 16-byte loads per row
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < n)
      x = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * D + c);
    float* d = dst + r * stride + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// kBand: as in flash_mma_kernel, the window and softcap tests are compiled
// in only where a call has either
template <int D, bool kBand>
__global__ void __launch_bounds__(kThreads)
    flash_tile_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int H, int KVH, int Sq, int Sk, int kv_len, int causal,
                      int window, float sm_scale, float softcap) {
  constexpr int kNR = kBQ / 16;  // rows per thread
  constexpr int kNC = kBK / 16;  // score columns per thread
  constexpr int kND = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                   // [kBQ][D + 1]
  float* ks = qs + kBQ * (D + 1);     // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);     // [kBK][D]
  float* ps = vs + kBK * D;           // [kBQ][kBK + 1]
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const float* qb = q + static_cast<size_t>(b * H + h) * Sq * D;
  const float* kb = k + static_cast<size_t>(b * KVH + kvh) * Sk * D;
  const float* vb = v + static_cast<size_t>(b * KVH + kvh) * Sk * D;
  float* ob = o + static_cast<size_t>(b * H + h) * Sq * D;

  stage_rows<D>(qs, D + 1, qb, q0, kBQ, Sq);

  float m[kNR], l[kNR], acc[kNR][kND];
#pragma unroll
  for (int i = 0; i < kNR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kND; ++c) acc[i][c] = 0.0f;
  }
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + kBQ, Sq));
  const int kv_begin =
      kBand && window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<D>(ks, D + 1, kb, k0, kBK, Sk);
    stage_rows<D>(vs, D, vb, k0, kBK, Sk);
    __syncthreads();

    float s[kNR][kNC];
#pragma unroll
    for (int i = 0; i < kNR; ++i)
#pragma unroll
      for (int j = 0; j < kNC; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kNR], kv[kNC];
#pragma unroll
      for (int i = 0; i < kNR; ++i) qv[i] = qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kNC; ++j) kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kNR; ++i)
#pragma unroll
        for (int j = 0; j < kNC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kNR; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kNC; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < kv_len && (!causal || qpos >= kpos);
        float x = s[i][j] * sm_scale;
        if constexpr (kBand) {
          ok = ok && (window <= 0 || qpos - kpos < window);
          x = capped(x, softcap);
        }
        s[i][j] = ok ? x : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < kNC; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = alpha * l[i] + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kND; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // the tile's probabilities are in ps

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[kND];
#pragma unroll
      for (int c = 0; c < kND; ++c) vv[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kNR; ++i) {
        const float p = ps[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
        for (int c = 0; c < kND; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kNR; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kND; ++c)
      ob[static_cast<size_t>(r) * D + tx + 16 * c] = acc[i][c] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel (prefill, bfloat16)
// ---------------------------------------------------------------------------

constexpr int kMmaBQ = 64;       // query rows per CTA: 4 warps x 16
constexpr int kMmaBK = 64;       // keys per tile
constexpr int kMmaThreads = 128;

template <int D>
struct MmaGeom {
  // bf16 per shared row: 16 bytes of padding, so the 8 rows an ldmatrix
  // phase reads fall in 8 different 16-byte bank groups
  static constexpr int kStride = D + 8;
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * kStride * (kMmaBQ + 4 * kMmaBK);
};

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16x8] += a[16x16] . b[16x8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [row0, row0 + kRows) of a [n, D] bf16 matrix into shared rows of
// MmaGeom<D>::kStride, by cp.async; rows at or past n are zeroed (a zero V
// row times a zero probability stays 0, where garbage could be NaN)
template <int D, int kRows>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int row0, int n) {
  constexpr int kChunks = D / 8;
  constexpr int kS = MmaGeom<D>::kStride;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    __nv_bfloat16* d = dst + r * kS + c;
    if (row0 + r < n)
      cp_async16(d, src + static_cast<size_t>(row0 + r) * D + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// kBand: the window and softcap tests are compiled in only where a call
// has either (they cost the plain causal prefill ~7% as run-time tests)
template <int D, bool kBand>
__global__ void __launch_bounds__(kMmaThreads)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int H, int KVH, int Sq,
                     int Sk, int kv_len, int causal, int window,
                     float sm_scale, float softcap) {
  constexpr int kS = MmaGeom<D>::kStride;
  constexpr int kND = D / 8;        // n8 blocks of the output row
  constexpr int kKD = D / 16;       // k16 steps of q . k
  constexpr int kNK = kMmaBK / 8;   // n8 blocks of a score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kMmaBQ * kS;        // [2][kMmaBK][kS]
  __nv_bfloat16* vs = ks + 2 * kMmaBK * kS;    // [2][kMmaBK][kS]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;  // the fragment row (and row + 8)
  const int tig = lane & 3;   // the fragment column pair
  const int mi = lane >> 3;   // the 8x8 matrix this lane addresses
  const int mr = lane & 7;    // and its row there
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaBQ;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const __nv_bfloat16* qb = q + static_cast<size_t>(b * H + h) * Sq * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b * KVH + kvh) * Sk * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b * KVH + kvh) * Sk * D;
  __nv_bfloat16* ob = o + static_cast<size_t>(b * H + h) * Sq * D;

  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + kMmaBQ, Sq));
  const int ntiles = (kv_end + kMmaBK - 1) / kMmaBK;
  const int t0 = kBand && window > 0 ? max(0, q0 - window + 1) / kMmaBK : 0;

  stage_bf16<D, kMmaBQ>(qs, qb, q0, Sq);
  stage_bf16<D, kMmaBK>(ks + (t0 & 1) * kMmaBK * kS, kb, t0 * kMmaBK, Sk);
  stage_bf16<D, kMmaBK>(vs + (t0 & 1) * kMmaBK * kS, vb, t0 * kMmaBK, Sk);
  cp_async_commit();

  float oacc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.0f, 0.0f};  // this thread's columns only, until the end
  const int row_a = q0 + warp * 16 + gid;  // rows row_a and row_a + 8

  for (int it = t0; it < ntiles; ++it) {
    const int k0 = it * kMmaBK;
    if (it + 1 < ntiles) {
      const int nb = (it + 1) & 1;
      stage_bf16<D, kMmaBK>(ks + nb * kMmaBK * kS, kb, k0 + kMmaBK, Sk);
      stage_bf16<D, kMmaBK>(vs + nb * kMmaBK * kS, vb, k0 + kMmaBK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` (and Q) are in shared memory
    const __nv_bfloat16* kt = ks + (it & 1) * kMmaBK * kS;
    const __nv_bfloat16* vt = vs + (it & 1) * kMmaBK * kS;

    // S = Q K^T: this warp's 16 rows against the tile's 64 keys, fp32
    float sacc[kNK][4];
#pragma unroll
    for (int n = 0; n < kNK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      uint32_t a[4];
      ldsm_x4(smem_u32(qs + (warp * 16 + (mi & 1) * 8 + mr) * kS + kk * 16 +
                       (mi >> 1) * 8),
              a);
#pragma unroll
      for (int nb = 0; nb < kNK / 2; ++nb) {
        uint32_t bb[4];
        ldsm_x4(smem_u32(kt + (nb * 16 + (mi >> 1) * 8 + mr) * kS +
                         kk * 16 + (mi & 1) * 8),
                bb);
        mma_bf16(sacc[2 * nb], a, bb[0], bb[1]);
        mma_bf16(sacc[2 * nb + 1], a, bb[2], bb[3]);
      }
    }

    // mask, scale and the online softmax on the fragments: element e of
    // block n is row row_a + (e >> 1) * 8, key k0 + n * 8 + tig * 2 + (e & 1)
    float rmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kNK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row_a + (e >> 1) * 8;
        const int c = k0 + n * 8 + tig * 2 + (e & 1);
        bool ok = c < kv_len && (!causal || r >= c);
        float x = sacc[n][e] * sm_scale;
        if constexpr (kBand) {
          ok = ok && (window <= 0 || r - c < window);
          x = capped(x, softcap);
        }
        sacc[n][e] = ok ? x : kNegInf;
        rmax[e >> 1] = fmaxf(rmax[e >> 1], sacc[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // a row lives in the 4 threads of a quad
      rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], 1));
      rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(0xffffffffu, rmax[i], 2));
      const float m_new = fmaxf(m_r[i], rmax[i]);
      alpha[i] = expf(m_r[i] - m_new);
      m_r[i] = m_new;
    }
    float rsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < kNK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sacc[n][e] - m_r[e >> 1]);
        sacc[n][e] = p;
        rsum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = alpha[i] * l_r[i] + rsum[i];
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // O += P V: P's accumulator fragments are the A operand (bf16)
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
      a[1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
      a[2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
      a[3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < kND / 2; ++nd) {
        uint32_t bb[4];
        ldsm_x4_trans(smem_u32(vt + (kk * 16 + (mi & 1) * 8 + mr) * kS +
                               nd * 16 + (mi >> 1) * 8),
                      bb);
        mma_bf16(oacc[2 * nd], a, bb[0], bb[1]);
        mma_bf16(oacc[2 * nd + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row_a + i * 8;
    if (r >= Sq) continue;
    const float denom = fmaxf(l_r[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(
          ob + static_cast<size_t>(r) * D + n * 8 + tig * 2) =
          __floats2bfloat162_rn(oacc[n][2 * i] / denom,
                                oacc[n][2 * i + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// split-KV decode (Sq = 1): partials, then the log-sum-exp merge
// ---------------------------------------------------------------------------

constexpr int kGMax = 8;  // query heads one decode CTA serves
static_assert(kGMax == 8, "the score reduction halves 8 values 3 times");

template <typename T, int D>
struct DecodeGeom {
  // keys per tile: 16 KB of K (and of V) per buffer at D = 128
  static constexpr int kBK = (sizeof(T) == 4 && D == 128) ? 32 : 64;
  static constexpr int kWarps = D / 32;  // D threads
  static constexpr int kE = D / 32;      // elements of a key row per lane
  static constexpr int kChunks = D * sizeof(T) / 16;  // 16-byte copies/row
  static constexpr size_t kSmem =
      4 * kBK * D * sizeof(T) + kGMax * kBK * sizeof(float);
};

// kCap: the softcap is compiled in only where a call has one
template <typename T, int D, bool kCap>
__global__ void __launch_bounds__(D) flash_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, float* __restrict__ m_part,
    float* __restrict__ l_part, float* __restrict__ o_part, int H, int KVH,
    int Sk, int kv_len, int split_len, float sm_scale, float softcap) {
  using Geom = DecodeGeom<T, D>;
  constexpr int kBKd = Geom::kBK;
  constexpr int kE = Geom::kE;
  constexpr int kW = Geom::kWarps;
  constexpr int kCh = Geom::kChunks;
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [2][kBKd][D]
  T* vs = ks + 2 * kBKd * D;               // [2][kBKd][D]
  float* ps = reinterpret_cast<float*>(vs + 2 * kBKd * D);  // [kGMax][kBKd]
  __shared__ float ms[kGMax], ls[kGMax], as[kGMax];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int G = H / KVH;
  const int chunks = (G + kGMax - 1) / kGMax;
  const int kvh = blockIdx.y / chunks;
  const int g0 = (blockIdx.y % chunks) * kGMax;
  const int ng = min(kGMax, G - g0);
  const int h0 = kvh * G + g0;  // the first query head this CTA serves
  const int b = blockIdx.z;
  // partial of head h0 + g: index part0 + g * splits of [B, H, splits]
  const size_t part0 = static_cast<size_t>(b * H + h0) * splits + split;
  const int start = split * split_len;
  const int end = min(start + split_len, kv_len);

  if (start >= end) {  // a range wholly past kv_len: an empty partial
    for (int g = 0; g < ng; ++g) {
      o_part[(part0 + g * splits) * D + t] = 0.0f;
      if (t == 0) {
        m_part[part0 + g * splits] = kNegInf;
        l_part[part0 + g * splits] = 0.0f;
      }
    }
    return;
  }
  const T* kb = k + static_cast<size_t>(b * KVH + kvh) * Sk * D;
  const T* vb = v + static_cast<size_t>(b * KVH + kvh) * Sk * D;

  auto stage = [&](int buf, int k0) {
    const int rows = min(kBKd, end - k0);
    T* kd = ks + buf * kBKd * D;
    T* vd = vs + buf * kBKd * D;
    for (int i = t; i < rows * kCh; i += D) {
      const int r = i / kCh;
      const int c = (i % kCh) * kPer;
      const size_t off = static_cast<size_t>(k0 + r) * D + c;
      cp_async16(kd + r * D + c, kb + off);
      cp_async16(vd + r * D + c, vb + off);
    }
    cp_async_commit();
  };

  stage(0, start);
  // this lane's slice of each query row
  float qr[kGMax][kE];
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    if (g < ng) {
      load_vec<kE>(q + static_cast<size_t>(b * H + h0 + g) * D + lane * kE,
                   qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) qr[g][e] = 0.0f;
    }
  }
  if (t < kGMax) {
    ms[t] = kNegInf;
    ls[t] = 0.0f;
    as[t] = 0.0f;
  }
  // the probability rows of absent heads stay 0, so P.V runs over all
  // kGMax heads without a branch
  for (int i = ng * kBKd + t; i < kGMax * kBKd; i += D) ps[i] = 0.0f;
  float acc[kGMax];
#pragma unroll
  for (int g = 0; g < kGMax; ++g) acc[g] = 0.0f;

  const int ntiles = (end - start + kBKd - 1) / kBKd;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = start + it * kBKd;
    const int rows = min(kBKd, end - k0);
    if (it + 1 < ntiles) {
      stage((it + 1) & 1, k0 + kBKd);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` is in shared memory
    const T* kt = ks + (it & 1) * kBKd * D;
    const T* vt = vs + (it & 1) * kBKd * D;

    // scores: warp w takes key rows w, w + kW, ...; a transposing
    // reduction sums the kGMax heads' dot products over the warp in 9
    // shuffles (each of offsets 16, 8, 4 halves the values a lane carries),
    // leaving head g's sum in lanes 4g..4g+3
    for (int j = warp; j < rows; j += kW) {
      float kr[kE];
      load_vec<kE>(kt + j * D + lane * kE, kr);
      float s[kGMax];
#pragma unroll
      for (int g = 0; g < kGMax; ++g) {
        s[g] = 0.0f;
#pragma unroll
        for (int e = 0; e < kE; ++e) s[g] = fmaf(qr[g][e], kr[e], s[g]);
      }
#pragma unroll
      for (int off = 16, n = kGMax / 2; off >= 4; off >>= 1, n >>= 1) {
        const bool hi = lane & off;  // keep the upper half of the values
#pragma unroll
        for (int i = 0; i < n; ++i) {
          const float send = hi ? s[i] : s[i + n];
          const float keep = hi ? s[i + n] : s[i];
          s[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
      s[0] += __shfl_xor_sync(0xffffffffu, s[0], 2);
      s[0] += __shfl_xor_sync(0xffffffffu, s[0], 1);
      const int g = lane >> 2;
      if ((lane & 3) == 0 && g < ng)
        ps[g * kBKd + j] =
            kCap ? capped(s[0] * sm_scale, softcap) : s[0] * sm_scale;
    }
    __syncthreads();
    // online softmax: one warp per head
    for (int g = warp; g < ng; g += kW) {
      float* pr = ps + g * kBKd;
      float rmax = kNegInf;
      for (int j = lane; j < rows; j += 32) rmax = fmaxf(rmax, pr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, rmax);
      float rsum = 0.0f;
      for (int j = lane; j < rows; j += 32) {
        const float p = expf(pr[j] - m_new);
        pr[j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      __syncwarp();  // every lane has read ms[g] before lane 0 writes it
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        as[g] = alpha;
        ls[g] = alpha * ls[g] + rsum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    // P V: thread t owns output column t of every head; each V element
    // is read once for all heads, 4 probabilities of a head per load
#pragma unroll
    for (int g = 0; g < kGMax; ++g) acc[g] *= as[g];
    int j = 0;
    for (; j + 4 <= rows; j += 4) {
      float vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) vv[u] = to_float(vt[(j + u) * D + t]);
#pragma unroll
      for (int g = 0; g < kGMax; ++g) {
        const float4 p = *reinterpret_cast<const float4*>(ps + g * kBKd + j);
        acc[g] = fmaf(p.x, vv[0], acc[g]);
        acc[g] = fmaf(p.y, vv[1], acc[g]);
        acc[g] = fmaf(p.z, vv[2], acc[g]);
        acc[g] = fmaf(p.w, vv[3], acc[g]);
      }
    }
    for (; j < rows; ++j) {
      const float vj = to_float(vt[j * D + t]);
#pragma unroll
      for (int g = 0; g < kGMax; ++g)
        acc[g] = fmaf(ps[g * kBKd + j], vj, acc[g]);
    }
    __syncthreads();  // every thread is done with this buffer and ps
  }
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    if (g < ng) {
      o_part[(part0 + g * splits) * D + t] = acc[g];
      if (t == 0) {
        m_part[part0 + g * splits] = ms[g];
        l_part[part0 + g * splits] = ls[g];
      }
    }
  }
}

// one CTA of D threads per (head, batch): the log-sum-exp merge
template <typename T>
__global__ void flash_decode_combine_kernel(
    const float* __restrict__ m_part, const float* __restrict__ l_part,
    const float* __restrict__ o_part, T* __restrict__ o, int splits) {
  const int H = gridDim.x;
  const int D = blockDim.x;
  const int t = threadIdx.x;
  const size_t p0 = static_cast<size_t>(blockIdx.y * H + blockIdx.x) * splits;
  float M = kNegInf;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, m_part[p0 + s]);
  float L = 0.0f, O = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(m_part[p0 + s] - M);
    L = fmaf(l_part[p0 + s], w, L);
    O = fmaf(o_part[(p0 + s) * D + t], w, O);
  }
  store(o + static_cast<size_t>(blockIdx.y * H + blockIdx.x) * D + t,
        O / fmaxf(L, 1e-30f));
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool bad_shape(int B, int H, int KVH, int Sq, int Sk, int D, int kv_len) {
  return B <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Sk <= 0 ||
         kv_len < 1 || kv_len > Sk || (D != 64 && D != 128) || B > 65535 ||
         H > 65535;
}

// a window must leave every query row a key: Sq - kv_len < window
bool bad_window(int Sq, int kv_len, int window, float softcap) {
  return window < 0 || !(softcap >= 0.0f) ||
         (window > 0 && Sq - kv_len >= window);
}

template <int D, bool kBand>
int launch_tile(const void* q, const void* k, const void* v, void* o, int B,
                int H, int KVH, int Sq, int Sk, int kv_len, int causal,
                int window, float sm_scale, float softcap, cudaStream_t st) {
  const size_t smem = sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) +
                                       kBK * D + kBQ * (kBK + 1));
  const cudaError_t err = allow_smem(flash_tile_kernel<D, kBand>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_tile_kernel<D, kBand><<<dim3((Sq + kBQ - 1) / kBQ, H, B), kThreads,
                                smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KVH, Sq, Sk,
      kv_len, causal, window, sm_scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kBand>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KVH, int Sq, int Sk, int kv_len, int causal,
               int window, float sm_scale, float softcap, cudaStream_t st) {
  const size_t smem = MmaGeom<D>::kSmem;
  const cudaError_t err = allow_smem(flash_mma_kernel<D, kBand>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_mma_kernel<D, kBand><<<dim3((Sq + kMmaBQ - 1) / kMmaBQ, H, B),
                               kMmaThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, KVH, Sq, Sk, kv_len, causal, window, sm_scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kCap>
int launch_split(const void* q, const void* k, const void* v, void* m,
                 void* l, void* op, int B, int H, int KVH, int Sk, int kv_len,
                 int splits, int split_len, float sm_scale, float softcap,
                 cudaStream_t st) {
  const size_t smem = DecodeGeom<T, D>::kSmem;
  const cudaError_t err =
      allow_smem(flash_decode_split_kernel<T, D, kCap>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (H / KVH + kGMax - 1) / kGMax;
  flash_decode_split_kernel<T, D, kCap><<<dim3(splits, KVH * chunks, B), D,
                                          smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(op), H, KVH, Sk, kv_len,
      split_len, sm_scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

// calls launch(std::integral_constant<int, D>, std::integral_constant<bool,
// band>): one instance per head_dim and per band (a window or a softcap)
template <typename F>
int dispatch(int D, bool band, F&& launch) {
  using I64 = std::integral_constant<int, 64>;
  using I128 = std::integral_constant<int, 128>;
  if (band)
    return D == 64 ? launch(I64{}, std::true_type{})
                   : launch(I128{}, std::true_type{});
  return D == 64 ? launch(I64{}, std::false_type{})
                 : launch(I128{}, std::false_type{});
}

template <typename T>
int decode_split(const void* q, const void* k, const void* v, void* m,
                 void* l, void* op, int B, int H, int KVH, int Sk, int D,
                 int kv_len, int splits, int split_len, float sm_scale,
                 float softcap, void* stream) {
  // the ranges [s * split_len, (s + 1) * split_len) must cover [0, Sk)
  if (bad_shape(B, H, KVH, 1, Sk, D, kv_len) ||
      bad_window(1, kv_len, 0, softcap) || splits < 1 ||
      split_len < 1 ||
      static_cast<long long>(splits) * split_len < static_cast<long long>(Sk) ||
      KVH * ((H / KVH + kGMax - 1) / kGMax) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(D, softcap > 0.0f, [&](auto d, auto cap) {
    return launch_split<T, decltype(d)::value, decltype(cap)::value>(
        q, k, v, m, l, op, B, H, KVH, Sk, kv_len, splits, split_len,
        sm_scale, softcap, st);
  });
}

template <typename T>
int decode_combine(const void* m, const void* l, const void* op, void* o,
                   int B, int H, int D, int splits, void* stream) {
  if (B <= 0 || H <= 0 || B > 65535 || (D != 64 && D != 128) || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_decode_combine_kernel<T><<<dim3(H, B), D, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(op), static_cast<T*>(o), splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue without launching for a shape it does not take
// (head_dim D other than 64 and 128 among them; a window that leaves a
// query no key; a negative window or softcap). window 0 is no window,
// softcap 0 no cap. Pointers are to
// contiguous, 16-byte aligned [B, H, Sq, D] / [B, KVH, Sk, D] tensors; the
// decode partials are float32 m, l [B, H, splits] and o [B, H, splits, D].

// prefill (any Sq), float32: the CUDA-core tile kernel
extern "C" int flash_prefill_f32(const void* q, const void* k, const void* v,
                                 void* o, int B, int H, int KVH, int Sq,
                                 int Sk, int D, int kv_len, int causal,
                                 int window, float sm_scale, float softcap,
                                 void* stream) {
  if (bad_shape(B, H, KVH, Sq, Sk, D, kv_len) ||
      bad_window(Sq, kv_len, window, softcap))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(D, window > 0 || softcap > 0.0f, [&](auto d, auto band) {
    return launch_tile<decltype(d)::value, decltype(band)::value>(
        q, k, v, o, B, H, KVH, Sq, Sk, kv_len, causal, window, sm_scale,
        softcap, st);
  });
}

// prefill (any Sq), bfloat16: the mma.sync kernel
extern "C" int flash_prefill_bf16(const void* q, const void* k,
                                  const void* v, void* o, int B, int H,
                                  int KVH, int Sq, int Sk, int D, int kv_len,
                                  int causal, int window, float sm_scale,
                                  float softcap, void* stream) {
  if (bad_shape(B, H, KVH, Sq, Sk, D, kv_len) ||
      bad_window(Sq, kv_len, window, softcap))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(D, window > 0 || softcap > 0.0f, [&](auto d, auto band) {
    return launch_mma<decltype(d)::value, decltype(band)::value>(
        q, k, v, o, B, H, KVH, Sq, Sk, kv_len, causal, window, sm_scale,
        softcap, st);
  });
}

// decode (Sq = 1, keys < kv_len valid): the split-KV partials
extern "C" int flash_decode_split_f32(const void* q, const void* k,
                                      const void* v, void* m, void* l,
                                      void* op, int B, int H, int KVH, int Sk,
                                      int D, int kv_len, int splits,
                                      int split_len, float sm_scale,
                                      float softcap, void* stream) {
  return decode_split<float>(q, k, v, m, l, op, B, H, KVH, Sk, D, kv_len,
                             splits, split_len, sm_scale, softcap, stream);
}

extern "C" int flash_decode_split_bf16(const void* q, const void* k,
                                       const void* v, void* m, void* l,
                                       void* op, int B, int H, int KVH,
                                       int Sk, int D, int kv_len, int splits,
                                       int split_len, float sm_scale,
                                       float softcap, void* stream) {
  return decode_split<__nv_bfloat16>(q, k, v, m, l, op, B, H, KVH, Sk, D,
                                     kv_len, splits, split_len, sm_scale,
                                     softcap, stream);
}

// decode: the log-sum-exp merge of the partials into o [B, H, 1, D]
extern "C" int flash_decode_combine_f32(const void* m, const void* l,
                                        const void* op, void* o, int B, int H,
                                        int D, int splits, void* stream) {
  return decode_combine<float>(m, l, op, o, B, H, D, splits, stream);
}

extern "C" int flash_decode_combine_bf16(const void* m, const void* l,
                                         const void* op, void* o, int B,
                                         int H, int D, int splits,
                                         void* stream) {
  return decode_combine<__nv_bfloat16>(m, l, op, o, B, H, D, splits, stream);
}
