// Flash attention (B6, the LM substrate's attention) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention
//
//   q [B, H, Sq, D], k/v [B, KVH, Sk, D] (GQA: query head h reads KV head
//   h / (H / KVH)), o [B, H, Sq, D] in q's type (float32 or bfloat16):
//   s = (q . k) * sm_scale in fp32; masked to NEG_INF = -1e30 where
//   kpos >= kv_len, and, when causal, where qpos < kpos with both counted
//   from 0 (top-left alignment, the Pallas kernel's; it differs from the
//   bottom-right oracle `kernels/ref.py::attention_ref` when Sq != Sk);
//   an online softmax over key tiles; o = acc / max(l, 1e-30). NEG_INF is
//   finite, so a masked tile gives no NaN.
//
// What bounds it on an H100. Prefill (Sq = Sk = S, causal): operations,
// 2 * 2 * B * H * S * S * D / 2 flops (43 GFLOP at [1, 40, 2048, 128]: 43 us
// at the 989 TFLOP/s bf16 tensor-core rate) against 2 * (B H + 2 B KVH) S D
// bytes. Decode (Sq = 1 against a KV cache): bytes, the kv_len rows of K
// and V of each (batch, KV head), 2 * B * KVH * kv_len * D * sizeof(T)
// (34 MB at [4, 8, 2049, 128] bf16: 10 us at 3.35 TB/s).
//
// Design (first version: simple and right; fp32 CUDA-core FMAs, no wgmma,
// no TMA). Tiles are converted to fp32 in shared memory as they are loaded
// (16-byte vector loads); every sum is fp32.
//  * Tile kernel (any Sq): one CTA of 256 threads per (query block of 64
//    rows, head, batch). Thread (ty, tx) of the 16 x 16 grid owns rows
//    ty + 16 i (i < 4) and, per 32-row key tile, score columns tx + 16 j
//    (j < 2), then output columns tx + 16 c (c < D / 16): the running max,
//    denominator and output rows stay in registers; a row's max and sum are
//    reduced across the 16 threads of a half warp with shuffles. Key tiles
//    past kv_len, and past the block's last query row when causal, are not
//    read at all: their scores would all be masked, and skipping them is
//    exact because the first tile (key 0) is never fully masked
//    (kv_len >= 1).
//  * Decode kernel (Sq = 1, group H / KVH <= 8): one CTA of D threads per
//    (KV head, batch) serves the group's query heads, so each K/V row is
//    read from device memory once, not once per query head. Thread t owns
//    output column t for every head of the group. It is a second path
//    only because it is faster there: 366 us against the tile kernel's
//    804 us at q [4, 40, 1, 128], cache [4, 8, 2084, 128], kv_len 2049,
//    bf16, on an H100 SXM at 700 W (chip_smoke.py times both).
// Later work (ROADMAP.md): wgmma on bf16 tiles, TMA with a ring of tiles,
// split-K decode so that more than B * KVH CTAs share the cache read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNegInf = -1e30f;

// tile kernel geometry
constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 32;        // key rows per tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid
// decode kernel geometry
constexpr int kDecBK = 64;  // key rows per tile
constexpr int kGMax = 8;    // query heads per KV head it takes

// 16 bytes of T (4 floats or 8 bfloat16s) -> floats
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [row0, row0 + rows) of a [n, D] matrix of T into shared memory
// (row stride `stride` floats); rows at or past n are zero
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, int stride,
                                           const T* __restrict__ src,
                                           int row0, int rows, int n) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kChunks = D / kPer;     // 16-byte loads per row
  float buf[kPer];
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kPer;
    if (row0 + r < n) {
      load16(src + static_cast<size_t>(row0 + r) * D + c, buf);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) buf[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) dst[r * stride + c + e] = buf[e];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int H,
                      int KVH, int Sq, int Sk, int kv_len, int causal,
                      float sm_scale) {
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
  const T* qb = q + static_cast<size_t>(b * H + h) * Sq * D;
  const T* kb = k + static_cast<size_t>(b * KVH + kvh) * Sk * D;
  const T* vb = v + static_cast<size_t>(b * KVH + kvh) * Sk * D;
  T* ob = o + static_cast<size_t>(b * H + h) * Sq * D;

  stage_rows<T, D>(qs, D + 1, qb, q0, kBQ, Sq);

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

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<T, D>(ks, D + 1, kb, k0, kBK, Sk);
    stage_rows<T, D>(vs, D, vb, k0, kBK, Sk);
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
        const bool ok = kpos < kv_len && (!causal || qpos >= kpos);
        s[i][j] = ok ? s[i][j] * sm_scale : kNegInf;
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
      store(ob + static_cast<size_t>(r) * D + tx + 16 * c, acc[i][c] / denom);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, int H,
                        int KVH, int Sk, int kv_len, int causal,
                        float sm_scale) {
  constexpr int kWarps = D / 32;
  extern __shared__ float smem[];
  float* qs = smem;                    // [kGMax][D]
  float* ks = qs + kGMax * D;          // [kDecBK][D + 1]
  float* vs = ks + kDecBK * (D + 1);   // [kDecBK][D]
  float* ps = vs + kDecBK * D;         // [kGMax][kDecBK]
  __shared__ float ms[kGMax], ls[kGMax], as[kGMax];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KVH;
  const int h0 = kvh * G;  // the group's first query head
  const T* qb = q + static_cast<size_t>(b * H + h0) * D;  // Sq = 1
  const T* kb = k + static_cast<size_t>(b * KVH + kvh) * Sk * D;
  const T* vb = v + static_cast<size_t>(b * KVH + kvh) * Sk * D;

  stage_rows<T, D>(qs, D, qb, 0, G, G);
  if (t < kGMax) {
    ms[t] = kNegInf;
    ls[t] = 0.0f;
  }
  float acc[kGMax];
#pragma unroll
  for (int g = 0; g < kGMax; ++g) acc[g] = 0.0f;
  const int kv_end = causal ? min(kv_len, 1) : kv_len;  // qpos is 0

  for (int k0 = 0; k0 < kv_end; k0 += kDecBK) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<T, D>(ks, D + 1, kb, k0, kDecBK, Sk);
    stage_rows<T, D>(vs, D, vb, k0, kDecBK, Sk);
    __syncthreads();
    // scores: one (head, key row) pair per thread and step
    for (int idx = t; idx < G * kDecBK; idx += D) {
      const int g = idx / kDecBK;
      const int j = idx % kDecBK;
      const float* qr = qs + g * D;
      const float* kr = ks + j * (D + 1);
      float s = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      const int kpos = k0 + j;
      const bool ok = kpos < kv_len && (!causal || kpos == 0);
      ps[g * kDecBK + j] = ok ? s * sm_scale : kNegInf;
    }
    __syncthreads();
    // online softmax: one warp per head of the group
    for (int g = warp; g < G; g += kWarps) {
      float* pr = ps + g * kDecBK;
      float rmax = kNegInf;
      for (int j = lane; j < kDecBK; j += 32) rmax = fmaxf(rmax, pr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, rmax);
      float rsum = 0.0f;
      for (int j = lane; j < kDecBK; j += 32) {
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
    // output column t of every head of the group
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      if (g < G) {
        const float* pr = ps + g * kDecBK;
        float a = acc[g] * as[g];
#pragma unroll 8
        for (int j = 0; j < kDecBK; ++j) a = fmaf(pr[j], vs[j * D + t], a);
        acc[g] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kGMax; ++g) {
    if (g < G) {
      store(o + static_cast<size_t>(b * H + h0 + g) * D + t,
            acc[g] / fmaxf(ls[g], 1e-30f));
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KVH, int Sq, int Sk, int kv_len, int causal, float sm_scale,
           void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 || Sk <= 0 ||
      kv_len < 1 || kv_len > Sk)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  cudaError_t err;
  if (Sq == 1 && H / KVH <= kGMax) {
    const size_t smem =
        sizeof(float) * (kGMax * D + kDecBK * (D + 1) + kDecBK * D +
                         kGMax * kDecBK);
    err = allow_smem(flash_decode_kernel<T, D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_decode_kernel<T, D><<<dim3(KVH, B), D, smem, st>>>(
        qt, kt, vt, ot, H, KVH, Sk, kv_len, causal, sm_scale);
  } else {
    const size_t smem = sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) +
                                         kBK * D + kBQ * (kBK + 1));
    err = allow_smem(flash_tile_kernel<T, D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_tile_kernel<T, D><<<dim3((Sq + kBQ - 1) / kBQ, H, B), kThreads,
                              smem, st>>>(qt, kt, vt, ot, H, KVH, Sq, Sk,
                                          kv_len, causal, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KVH, int Sq, int Sk, int D, int kv_len, int causal,
             float sm_scale, void* stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KVH, Sq, Sk, kv_len, causal,
                           sm_scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KVH, Sq, Sk, kv_len, causal,
                            sm_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// head_dim D: 64 or 128; any other D, or a shape the kernel does not take,
// returns cudaErrorInvalidValue without launching. Pointers are to
// contiguous, 16-byte aligned [B, H, Sq, D] / [B, KVH, Sk, D] tensors.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int KVH, int Sq, int Sk, int D, int kv_len,
                                   int causal, float sm_scale, void* stream) {
  return dispatch<float>(q, k, v, o, B, H, KVH, Sq, Sk, D, kv_len, causal,
                         sm_scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int KVH, int Sq, int Sk, int D,
                                    int kv_len, int causal, float sm_scale,
                                    void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KVH, Sq, Sk, D, kv_len,
                                 causal, sm_scale, stream);
}
