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

}  // namespace

// hidden width: 32, 64 or 128 (the reference's tested range); any other
// width returns cudaErrorInvalidValue without launching
extern "C" int fused_nerf_mlp_f32(const void* feats, const void* direnc,
                                  const void* w1, const void* b1,
                                  const void* w2, const void* b2,
                                  const void* ws, const void* wr,
                                  const void* br, void* out, int n, int c,
                                  int h, int dd, void* stream) {
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
