// The fused radiance MLP (paper's Feature Computation, the NPU workload)
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused_nerf_mlp.py::fused_nerf_mlp
//
//   h     = relu(x W1 + b1)            x [S, C]
//   h     = relu(h W2 + b2)
//   sigma = softplus(h Ws)
//   rgb   = sigmoid([h, d] Wr + br)    d [S, DD] (the 9-wide direction code)
//   out   = [sigma, rgb]               [S, 4]
//
// What bounds it on an H100: operations. 2 (C H + H H + H + 3 (H + DD))
// flops per sample (~9.8 kflop at C = 8, H = 64) against (C + DD + 4) * 4
// bytes of traffic: ~1.3 GFLOP for a 131,072-sample chunk. On the fp32
// CUDA cores (67 TFLOP/s) that is ~19 us; in the tensor cores with the
// 3xTF32 split below, three TF32 products per product, ~7.8 us at 495
// TFLOP/s, while its ~11 MB take ~3.3 us.
//
// Design: every product runs on the tensor cores, mma.sync.m16n8k8 with
// TF32 operands and fp32 accumulators, in fp32 accuracy through the 3xTF32
// split: a_hi = tf32_rna(a), a_lo = tf32_rna(a - a_hi) (a - a_hi is exact),
// the same for b, and a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi (lo.lo
// dropped): ~22 mantissa bits a product where one TF32 pass keeps ~11.
//  * One warp owns 16 samples at a time (the m16 of the product); CTAs of
//    8 warps walk 16-sample tiles grid-stride, with no more CTAs than fit
//    on the card at once, so each CTA stages the weights once. At H <= 64
//    the registers are capped at 128 a thread (a few bytes spill) so that
//    two CTAs, 16 warps, share an SM. A tile's x and direction-code
//    fragments are loaded first, together.
//  * Each CTA stages the weights into shared memory once, already split,
//    in B-fragment order: entry (k tile, n tile, lane) is the float4
//    {b0_hi, b1_hi, b0_lo, b1_lo}, one conflict-free 16-byte load per lane
//    per 3 mma (41 KB at C = 8, H = 64). A thread builds whole entries
//    (one 16-byte store each) and issues all its weight loads before its
//    first store. C (layer 1's K) and the direction code (at most 16 wide)
//    are zero-padded to multiples of 8.
//  * The heads are one n8 tile over K = H + 16: column 0 holds w_sigma
//    above zeros, columns 1-3 w_rgb (the 9-wide direction code padded to
//    16 rows of zeros), columns 4-7 zeros (kernels/fused_nerf_mlp.py
//    fold_heads); sigma = softplus(col 0), rgb = sigmoid(col 1..3 + b_rgb).
//  * No bounce between layers: the fp32 accumulator fragment of n tile j
//    holds rows (g, g+8) at columns (2t, 2t+1), and the TF32 A fragment of
//    k tile j holds columns t and t+4. Taking A's column t to be unit 2t
//    and column t+4 to be unit 2t+1 (the K order inside each 8-wide k
//    tile is free, as long as B's rows follow it) makes the accumulator
//    the next layer's A fragment in place: c0 -> a0, c2 -> a1, c1 -> a2,
//    c3 -> a3. The staged W2 and head rows are permuted to match. Bias,
//    ReLU and the hi/lo split run in registers.
//  * Layer 2 runs four n tiles at a time (four independent accumulator
//    chains); each finished n tile is at once the heads' k tile, so the
//    second hidden layer is never held whole.
// softplus is fmaxf(x, 0) + log1pf(expf(-|x|)), i.e. logaddexp(x, 0).
//
// The templates take H = 32, 64 or 128, a direction code of at most 16 and
// weights that stage in one block's shared memory; the wrapper pads a
// narrower H up to the next template with zero units (exact: a padded unit
// is relu(0) = 0 and its outgoing weights are 0). Everything else (H over
// 128, staged fragments over 232,448 B, from C = 89 at H = 128) runs the
// run-time-H mode below, fp32 on the CUDA cores, bound there by its
// operations (67 TFLOP/s): a CTA of 256 threads takes 64 samples; each
// layer is a register-tiled product (every thread 4 samples x 4 units,
// 16 FMAs per two 16-byte shared loads) over k chunks of 16 staged in
// shared memory, the weights read once per CTA and chunk; the first
// hidden layer of the 64 samples stays in shared memory (k-major), or in
// global scratch where it does not fit (H over 816); each finished block
// of 64 second-layer units goes straight into per-thread head sums,
// reduced across the 16 threads of a row group by shuffles. The wrapper's
// routing rule (kernels/fused_nerf_mlp.py mlp_plan) chooses; each entry
// point checks the plan's bytes against its own.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// 3xTF32 operand: x ~ hi + lo, each a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b in 3xTF32, the small terms first; b = {b0_hi, b1_hi, b0_lo,
// b1_lo}
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float4 b) {
  mma_tf32(d, alo, __float_as_uint(b.x), __float_as_uint(b.y));
  mma_tf32(d, ahi, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, ahi, __float_as_uint(b.x), __float_as_uint(b.y));
}

__device__ __forceinline__ float load_or_zero(const float* __restrict__ base,
                                              int row, int col, int n,
                                              int width) {
  return (row < n && col < width)
             ? __ldg(base + static_cast<size_t>(row) * width + col)
             : 0.0f;
}

// A fragment of x [n, width] (natural column order) for the k tile at
// column k0: a0 (g, k0 + t), a1 (g + 8, k0 + t), a2 (g, k0 + t + 4),
// a3 (g + 8, k0 + t + 4); zero past n rows or width columns
__device__ __forceinline__ void load_a(const float* __restrict__ x, int r0,
                                       int k0, int t, int n, int width,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(load_or_zero(x, r0, k0 + t, n, width), hi[0], lo[0]);
  split(load_or_zero(x, r0 + 8, k0 + t, n, width), hi[1], lo[1]);
  split(load_or_zero(x, r0, k0 + t + 4, n, width), hi[2], lo[2]);
  split(load_or_zero(x, r0 + 8, k0 + t + 4, n, width), hi[3], lo[3]);
}

// relu(acc + bias) of n tile nt (units 8 nt + 2t and 8 nt + 2t + 1), split,
// as the A fragment of the next product's k tile nt (permuted order)
__device__ __forceinline__ void to_a(const float (&acc)[4],
                                     const float* __restrict__ bias, int nt,
                                     int t, uint32_t (&hi)[4],
                                     uint32_t (&lo)[4]) {
  const float2 b = *reinterpret_cast<const float2*>(bias + nt * 8 + 2 * t);
  split(fmaxf(acc[0] + b.x, 0.0f), hi[0], lo[0]);
  split(fmaxf(acc[2] + b.x, 0.0f), hi[1], lo[1]);
  split(fmaxf(acc[1] + b.y, 0.0f), hi[2], lo[2]);
  split(fmaxf(acc[3] + b.y, 0.0f), hi[3], lo[3]);
}

constexpr int kChunk = 4;  // layer-2 n tiles in flight
constexpr int kBatch = 12;  // fragment entries a thread stages per pass
constexpr int kMaxDt = 2;  // direction-code k tiles (its width <= 16)
constexpr int kThreadsPerCta = 256;

template <int H>
__global__ void __launch_bounds__(kThreadsPerCta, H <= 64 ? 2 : 1)
    fused_nerf_mlp_kernel(
    const float* __restrict__ feats, const float* __restrict__ direnc,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ ws, const float* __restrict__ wr,
    const float* __restrict__ br, float* __restrict__ out, int n, int c,
    int dd) {
  constexpr int NT = H / 8;  // n tiles of a hidden layer
  constexpr int CH = NT < kChunk ? NT : kChunk;
  const int kt1 = (c + 7) / 8;
  const int dt = (dd + 7) / 8;
  extern __shared__ float4 smem[];
  float4* f_w1 = smem;                   // [kt1, NT, 32]
  float4* f_w2 = f_w1 + kt1 * NT * 32;   // [NT, NT, 32], rows permuted
  float4* f_hd = f_w2 + NT * NT * 32;    // [NT + dt, 1, 32]
  float* s_b1 = reinterpret_cast<float*>(f_hd + (NT + dt) * 32);  // [H]
  float* s_b2 = s_b1 + H;                                          // [H]
  float* s_br = s_b2 + H;                                          // [3]

  // the split B fragments of W1, W2 and the folded heads, entry by entry:
  // entry (tile, lane) takes its b0 and b1 weights (rows k0 and k1 of the
  // tile's k range, column 8 nt + g; permuted rows after a hidden layer)
  // and stores {b0_hi, b1_hi, b0_lo, b1_lo} as one conflict-free 16-byte
  // write. Every thread issues its loads before it stores (kBatch entries
  // cover all of them at 256 threads and H <= 64): the staging is bound
  // by L2 latency.
  const int e_w2 = kt1 * NT * 32;
  const int e_hd = e_w2 + NT * NT * 32;
  const int e_dd = e_hd + NT * 32;
  const int entries = e_dd + dt * 32;
  auto pair = [&](int e) -> float2 {
    const int lane = e & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    if (e < e_w2) {  // W1 [c, H], natural rows, zero past c
      const int tile = e >> 5;
      const int k0 = (tile / NT) * 8 + t;
      const int col = (tile % NT) * 8 + g;
      return make_float2(k0 < c ? __ldg(w1 + k0 * H + col) : 0.0f,
                         k0 + 4 < c ? __ldg(w1 + (k0 + 4) * H + col) : 0.0f);
    }
    if (e < e_hd) {  // W2 [H, H], permuted rows
      const int tile = (e - e_w2) >> 5;
      const int k0 = (tile / NT) * 8 + 2 * t;
      const int col = (tile % NT) * 8 + g;
      return make_float2(__ldg(w2 + k0 * H + col),
                         __ldg(w2 + (k0 + 1) * H + col));
    }
    if (e < e_dd) {  // heads over the hidden units, permuted rows
      const int k0 = ((e - e_hd) >> 5) * 8 + 2 * t;
      if (g == 0) return make_float2(__ldg(ws + k0), __ldg(ws + k0 + 1));
      if (g < 4) {
        return make_float2(__ldg(wr + k0 * 3 + g - 1),
                           __ldg(wr + (k0 + 1) * 3 + g - 1));
      }
      return make_float2(0.0f, 0.0f);
    }
    // heads over the direction code, natural rows, zero past dd
    const int k0 = ((e - e_dd) >> 5) * 8 + t;
    if (g == 0 || g >= 4) return make_float2(0.0f, 0.0f);
    return make_float2(
        k0 < dd ? __ldg(wr + (H + k0) * 3 + g - 1) : 0.0f,
        k0 + 4 < dd ? __ldg(wr + (H + k0 + 4) * 3 + g - 1) : 0.0f);
  };
  for (int base = threadIdx.x; base < entries; base += kBatch * blockDim.x) {
    float2 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * blockDim.x;
      v[u] = e < entries ? pair(e) : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = base + u * blockDim.x;
      if (e < entries) {
        uint32_t h0, l0, h1, l1;
        split(v[u].x, h0, l0);
        split(v[u].y, h1, l1);
        smem[e] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                              __uint_as_float(l0), __uint_as_float(l1));
      }
    }
  }
  for (int k = threadIdx.x; k < H; k += blockDim.x) {
    s_b1[k] = __ldg(b1 + k);
    s_b2[k] = __ldg(b2 + k);
  }
  if (threadIdx.x < 3) s_br[threadIdx.x] = __ldg(br + threadIdx.x);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int warps = blockDim.x >> 5;
  const int tiles = (n + 15) / 16;
  for (int tile = blockIdx.x * warps + (threadIdx.x >> 5); tile < tiles;
       tile += gridDim.x * warps) {
    const int r0 = tile * 16 + g;  // this lane's rows: r0 and r0 + 8

    // the direction code's A fragments, issued first: they are read last
    uint32_t dhi[kMaxDt][4], dlo[kMaxDt][4];
#pragma unroll
    for (int kt = 0; kt < kMaxDt; ++kt) {
      load_a(direnc, r0, kt * 8, t, n, dd, dhi[kt], dlo[kt]);
    }
    // layer 1: acc1 = x W1 over kt1 k tiles
    float acc1[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc1[j][0] = acc1[j][1] = acc1[j][2] =
        acc1[j][3] = 0.0f;
    for (int kt = 0; kt < kt1; ++kt) {
      uint32_t ahi[4], alo[4];
      load_a(feats, r0, kt * 8, t, n, c, ahi, alo);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma3(acc1[j], ahi, alo,
                                        f_w1[(kt * NT + j) * 32 + lane]);
    }
    uint32_t hhi[NT][4], hlo[NT][4];  // relu(acc1 + b1): layer 2's A
#pragma unroll
    for (int j = 0; j < NT; ++j) to_a(acc1[j], s_b1, j, t, hhi[j], hlo[j]);

    // layer 2, CH n tiles at a time; each finished n tile is the
    // heads' k tile of the same index
    float hd[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += CH) {
      float acc2[CH][4];
#pragma unroll
      for (int j = 0; j < CH; ++j) acc2[j][0] = acc2[j][1] =
          acc2[j][2] = acc2[j][3] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < NT; ++kt) {
#pragma unroll
        for (int j = 0; j < CH; ++j) mma3(
            acc2[j], hhi[kt], hlo[kt], f_w2[(kt * NT + n0 + j) * 32 + lane]);
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        uint32_t ahi[4], alo[4];
        to_a(acc2[j], s_b2, n0 + j, t, ahi, alo);
        mma3(hd, ahi, alo, f_hd[(n0 + j) * 32 + lane]);
      }
    }
    // the direction code's k tiles (natural order), loaded with x
#pragma unroll
    for (int kt = 0; kt < kMaxDt; ++kt) {
      if (kt < dt) mma3(hd, dhi[kt], dlo[kt], f_hd[(NT + kt) * 32 + lane]);
    }
    // hd holds columns (2t, 2t + 1) of rows r0 and r0 + 8: lane t = 0 has
    // (sigma, r), t = 1 has (g, b)
    if (t < 2) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        if (row < n) {
          const float x = hd[2 * half];
          const float y = hd[2 * half + 1];
          const float2 o =
              t == 0 ? make_float2(softplus(x), sigmoid(y + s_br[0]))
                     : make_float2(sigmoid(x + s_br[1]), sigmoid(y + s_br[2]));
          *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * 4 +
                                     2 * t) = o;
        }
      }
    }
  }
}

// shared-memory bytes: the split B fragments of W1, W2 and the folded
// heads, then b1, b2 and b_rgb
size_t smem_bytes(int c, int h, int dd) {
  const int nt = h / 8;
  const int frags = ((c + 7) / 8) * nt + nt * nt + nt + (dd + 7) / 8;
  return static_cast<size_t>(frags) * 32 * sizeof(float4) +
         sizeof(float) * (2 * h + 3);
}

template <int H>
int launch(const void* feats, const void* direnc, const void* w1,
           const void* b1, const void* w2, const void* b2, const void* ws,
           const void* wr, const void* br, void* out, int n, int c, int dd,
           void* stream) {
  const size_t smem = smem_bytes(c, H, dd);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_nerf_mlp_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = kThreadsPerCta;
  // no more CTAs than are resident at once, so each stages once (cached
  // per hidden width: each launch<H> has its own statics)
  static int sms = 0;
  static size_t occ_smem = 0;
  static int occ_ctas = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (occ_smem != smem) {
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_nerf_mlp_kernel<H>, threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    occ_smem = smem;
    occ_ctas = per_sm > 0 ? per_sm : 1;
  }
  const int tiles = (n + 15) / 16;
  const int warps = threads / 32;
  int blocks = (tiles + warps - 1) / warps;
  if (blocks > occ_ctas * sms) blocks = occ_ctas * sms;
  fused_nerf_mlp_kernel<H><<<blocks, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feats), static_cast<const float*>(direnc),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(ws), static_cast<const float*>(wr),
      static_cast<const float*>(br), static_cast<float*>(out), n, c, dd);
  return static_cast<int>(cudaGetLastError());
}

// run-time-H mode: a CTA of kRtThreads threads computes kRtRows samples;
// thread (ty, tx) = (tid / 16, tid % 16) owns rows 4 ty .. 4 ty + 3 and,
// in each kRtCols-wide column block, columns 4 tx .. 4 tx + 3
constexpr int kRtRows = 64;
constexpr int kRtCols = 64;
constexpr int kRtK = 16;            // k rows staged per chunk
constexpr int kRtLd = kRtRows + 4;  // row stride of the k-major A tiles
constexpr int kRtThreads = 256;
constexpr int kRtStage = kRtK * kRtLd + kRtK * kRtCols;  // floats

__host__ __device__ constexpr int rt_hidden_rows(int h) {
  return (h + kRtK - 1) / kRtK * kRtK;
}

// acc[i][j] = sum_k A(k, 4 ty + i) B(k, n0 + 4 tx + j), k in order from
// zero. A is k-major with row stride kRtLd: chunk by chunk from `x`
// (row-major [n, kn], rows from row0, zero past n and kn) into sa when x
// is not null, else the hidden tile `a` (kn rows, zero-padded to a
// multiple of kRtK). B(k, c) = w[k * ldw + c], zero past kn rows and
// ncols columns, staged into sb; the last chunk reads A's rows up to the
// next multiple of kRtK. Every chunk ends at a barrier, so the caller may
// overwrite sa and sb once it returns.
__device__ __forceinline__ void rt_gemm(
    const float* __restrict__ x, int row0, int n, const float* a, int kn,
    const float* __restrict__ w, int ldw, int n0, int ncols, float* sa,
    float* sb, float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < kn; k0 += kRtK) {
#pragma unroll
    for (int u = 0; u < kRtK * kRtCols / kRtThreads; ++u) {
      const int e = tid + u * kRtThreads;
      const int kk = e / kRtCols;
      const int cc = e % kRtCols;
      sb[kk * kRtCols + cc] =
          (k0 + kk < kn && n0 + cc < ncols)
              ? __ldg(w + static_cast<size_t>(k0 + kk) * ldw + n0 + cc)
              : 0.0f;
    }
    if (x != nullptr) {
#pragma unroll
      for (int u = 0; u < kRtK * kRtRows / kRtThreads; ++u) {
        const int e = tid + u * kRtThreads;
        const int r = e / kRtK;
        const int kk = e % kRtK;
        sa[kk * kRtLd + r] =
            (row0 + r < n && k0 + kk < kn)
                ? __ldg(x + static_cast<size_t>(row0 + r) * kn + k0 + kk)
                : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kRtK; ++kk) {
      const float4 av = x != nullptr
          ? *reinterpret_cast<const float4*>(sa + kk * kRtLd + 4 * ty)
          : *reinterpret_cast<const float4*>(
                a + static_cast<size_t>(k0 + kk) * kRtLd + 4 * ty);
      const float4 bv =
          *reinterpret_cast<const float4*>(sb + kk * kRtCols + 4 * tx);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

// kScratch: the hidden tile [rt_hidden_rows(h)][kRtLd] lives in global
// scratch (one per CTA) instead of shared memory
template <bool kScratch>
__global__ void __launch_bounds__(kRtThreads) fused_nerf_mlp_rt_kernel(
    const float* __restrict__ feats, const float* __restrict__ direnc,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ ws, const float* __restrict__ wr,
    const float* __restrict__ br, float* __restrict__ out,
    float* __restrict__ scratch, int n, int c, int h, int dd) {
  extern __shared__ float4 rt_smem4[];
  float* rt_smem = reinterpret_cast<float*>(rt_smem4);
  float* sa = rt_smem;                   // [kRtK][kRtLd]
  float* sb = sa + kRtK * kRtLd;         // [kRtK][kRtCols]
  const int hp = rt_hidden_rows(h);
  float* hid = kScratch
                   ? scratch + static_cast<size_t>(blockIdx.x) * hp * kRtLd
                   : sb + kRtK * kRtCols;  // [hp][kRtLd], k-major
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // the padding rows h .. hp are zero for good (never written below)
  for (int e = tid; e < (hp - h) * kRtLd; e += kRtThreads) {
    hid[h * kRtLd + e] = 0.0f;
  }
  float acc[4][4];
  for (int row0 = blockIdx.x * kRtRows; row0 < n;
       row0 += gridDim.x * kRtRows) {
    // layer 1: hid = relu(x W1 + b1), one column block at a time, each
    // column's four rows stored as one float4
    for (int n0 = 0; n0 < h; n0 += kRtCols) {
      rt_gemm(feats, row0, n, nullptr, c, w1, h, n0, h, sa, sb, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + 4 * tx + j;
        if (col < h) {
          const float b = __ldg(b1 + col);
          *reinterpret_cast<float4*>(hid + static_cast<size_t>(col) * kRtLd +
                                     4 * ty) =
              make_float4(fmaxf(acc[0][j] + b, 0.0f),
                          fmaxf(acc[1][j] + b, 0.0f),
                          fmaxf(acc[2][j] + b, 0.0f),
                          fmaxf(acc[3][j] + b, 0.0f));
        }
      }
    }
    __syncthreads();  // the hidden tile is whole
    // layer 2 and the heads: each finished column block goes straight
    // into this thread's partial sigma / rgb sums of its four rows
    float hs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float hr[4][3] = {};
    for (int n0 = 0; n0 < h; n0 += kRtCols) {
      rt_gemm(nullptr, row0, n, hid, h, w2, h, n0, h, sa, sb, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + 4 * tx + j;
        if (col < h) {
          const float b = __ldg(b2 + col);
          const float wsj = __ldg(ws + col);
          const float r0 = __ldg(wr + col * 3);
          const float r1 = __ldg(wr + col * 3 + 1);
          const float r2 = __ldg(wr + col * 3 + 2);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float v = fmaxf(acc[i][j] + b, 0.0f);
            hs[i] = fmaf(v, wsj, hs[i]);
            hr[i][0] = fmaf(v, r0, hr[i][0]);
            hr[i][1] = fmaf(v, r1, hr[i][1]);
            hr[i][2] = fmaf(v, r2, hr[i][2]);
          }
        }
      }
    }
    // the 16 lanes of a row group (tx) hold partial sums of the same rows
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hs[i] += __shfl_xor_sync(0xffffffffu, hs[i], off);
        hr[i][0] += __shfl_xor_sync(0xffffffffu, hr[i][0], off);
        hr[i][1] += __shfl_xor_sync(0xffffffffu, hr[i][1], off);
        hr[i][2] += __shfl_xor_sync(0xffffffffu, hr[i][2], off);
      }
    }
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + 4 * ty + i;
        if (row < n) {
          const float* d = direnc + static_cast<size_t>(row) * dd;
          float q0 = hr[i][0], q1 = hr[i][1], q2 = hr[i][2];
          for (int k = 0; k < dd; ++k) {
            const float dk = __ldg(d + k);
            const float* wk = wr + static_cast<size_t>(h + k) * 3;
            q0 = fmaf(dk, __ldg(wk), q0);
            q1 = fmaf(dk, __ldg(wk + 1), q1);
            q2 = fmaf(dk, __ldg(wk + 2), q2);
          }
          *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * 4) =
              make_float4(softplus(hs[i]), sigmoid(q0 + __ldg(br)),
                          sigmoid(q1 + __ldg(br + 1)),
                          sigmoid(q2 + __ldg(br + 2)));
        }
      }
    }
    __syncthreads();  // the next tile overwrites the hidden tile
  }
}

int smem_optin_limit(int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return static_cast<int>(err);
}

}  // namespace

// the tensor-core templates: hidden width 32, 64 or 128, direction code
// at most kMaxDt * 8 wide, and `smem` (the wrapper's plan) equal to this
// layout's bytes and within the card's per-block limit; any other plan
// returns cudaErrorInvalidValue without launching
extern "C" int fused_nerf_mlp_f32(const void* feats, const void* direnc,
                                  const void* w1, const void* b1,
                                  const void* w2, const void* b2,
                                  const void* ws, const void* wr,
                                  const void* br, void* out, int n, int c,
                                  int h, int dd, int smem, void* stream) {
  int limit = 0;
  const int err = smem_optin_limit(&limit);
  if (err != 0) return err;
  if (dd > kMaxDt * 8 || static_cast<size_t>(smem) != smem_bytes(c, h, dd) ||
      smem > limit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (h) {
    case 32:
      return launch<32>(feats, direnc, w1, b1, w2, b2, ws, wr, br, out, n, c,
                        dd, stream);
    case 64:
      return launch<64>(feats, direnc, w1, b1, w2, b2, ws, wr, br, out, n, c,
                        dd, stream);
    case 128:
      return launch<128>(feats, direnc, w1, b1, w2, b2, ws, wr, br, out, n, c,
                         dd, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the run-time-H mode: `grid` CTAs of kRtThreads threads, kRtRows samples
// a tile; `smem` is the k-chunk staging plus, without `scratch`, the
// [rt_hidden_rows(h)][kRtLd] hidden tile; with `scratch` (grid times that
// many floats of global memory) the staging only. A plan that does not add
// up returns cudaErrorInvalidValue.
extern "C" int fused_nerf_mlp_rt_f32(const void* feats, const void* direnc,
                                     const void* w1, const void* b1,
                                     const void* w2, const void* b2,
                                     const void* ws, const void* wr,
                                     const void* br, void* out,
                                     void* scratch, int n, int c, int h,
                                     int dd, int smem, int grid,
                                     void* stream) {
  int limit = 0;
  const int err = smem_optin_limit(&limit);
  if (err != 0) return err;
  if (h < 1 || c < 1 || dd < 0 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t stage = sizeof(float) * kRtStage;
  const size_t hidden =
      sizeof(float) * static_cast<size_t>(rt_hidden_rows(h)) * kRtLd;
  const size_t want = scratch != nullptr ? stage : stage + hidden;
  if (static_cast<size_t>(smem) != want || smem > limit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = scratch != nullptr ? fused_nerf_mlp_rt_kernel<true>
                                         : fused_nerf_mlp_rt_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kRtThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feats), static_cast<const float*>(direnc),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(ws), static_cast<const float*>(wr),
      static_cast<const float*>(br), static_cast<float*>(out),
      static_cast<float*>(scratch), n, c, h, dd);
  return static_cast<int>(cudaGetLastError());
}
