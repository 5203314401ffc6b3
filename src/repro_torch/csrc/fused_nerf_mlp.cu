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
// bytes of traffic: ~1.3 GFLOP for a 131,072-sample chunk, ~19 us at the
// 67 TFLOP/s fp32 non-tensor rate, while its ~11 MB take ~3.3 us.
//
// Design: one thread per sample, weights resident in shared memory
// (~20 KB at C = 8, H = 64; every thread of a warp reads the same weight,
// a broadcast). The first hidden layer lives in registers (H is a template
// parameter, so the arrays are fully unrolled); the second layer is
// produced one unit at a time and folded straight into the sigma and rgb
// sums, so it never needs storage. No activation touches device memory.
// Plain fp32 FMAs on the CUDA cores; a wgmma version is later work.
// softplus is fmaxf(x, 0) + log1pf(expf(-|x|)), i.e. logaddexp(x, 0).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// block-cooperative copy of one weight tensor into shared memory
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int count) {
  for (int k = threadIdx.x; k < count; k += blockDim.x) dst[k] = src[k];
}

template <int H>
__global__ void fused_nerf_mlp_kernel(
    const float* __restrict__ feats, const float* __restrict__ direnc,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ ws, const float* __restrict__ wr,
    const float* __restrict__ br, float* __restrict__ out, int n, int c,
    int dd) {
  extern __shared__ float sm[];
  float* s_w1 = sm;                 // [c, H]
  float* s_b1 = s_w1 + c * H;       // [H]
  float* s_w2 = s_b1 + H;           // [H, H]
  float* s_b2 = s_w2 + H * H;       // [H]
  float* s_ws = s_b2 + H;           // [H]
  float* s_wr = s_ws + H;           // [H + dd, 3]
  float* s_br = s_wr + (H + dd) * 3;  // [3]
  stage(s_w1, w1, c * H);
  stage(s_b1, b1, H);
  stage(s_w2, w2, H * H);
  stage(s_b2, b2, H);
  stage(s_ws, ws, H);
  stage(s_wr, wr, (H + dd) * 3);
  stage(s_br, br, 3);
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;

  float h1[H];
#pragma unroll
  for (int j = 0; j < H; ++j) h1[j] = 0.0f;
  const float* x = feats + static_cast<size_t>(s) * c;
  for (int k = 0; k < c; ++k) {
    const float xk = __ldg(x + k);
#pragma unroll
    for (int j = 0; j < H; ++j) h1[j] = fmaf(xk, s_w1[k * H + j], h1[j]);
  }
#pragma unroll
  for (int j = 0; j < H; ++j) h1[j] = fmaxf(h1[j] + s_b1[j], 0.0f);

  float sig = 0.0f, r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
  for (int j = 0; j < H; ++j) {
    float a = 0.0f;
#pragma unroll
    for (int k = 0; k < H; ++k) a = fmaf(h1[k], s_w2[k * H + j], a);
    a = fmaxf(a + s_b2[j], 0.0f);
    sig = fmaf(a, s_ws[j], sig);
    r0 = fmaf(a, s_wr[j * 3 + 0], r0);
    r1 = fmaf(a, s_wr[j * 3 + 1], r1);
    r2 = fmaf(a, s_wr[j * 3 + 2], r2);
  }
  const float* d = direnc + static_cast<size_t>(s) * dd;
  for (int k = 0; k < dd; ++k) {
    const float dk = __ldg(d + k);
    const float* wrow = s_wr + (H + k) * 3;
    r0 = fmaf(dk, wrow[0], r0);
    r1 = fmaf(dk, wrow[1], r1);
    r2 = fmaf(dk, wrow[2], r2);
  }
  float4 o;
  o.x = softplus(sig);
  o.y = sigmoid(r0 + s_br[0]);
  o.z = sigmoid(r1 + s_br[1]);
  o.w = sigmoid(r2 + s_br[2]);
  reinterpret_cast<float4*>(out)[s] = o;
}

template <int H>
int launch(const void* feats, const void* direnc, const void* w1,
           const void* b1, const void* w2, const void* b2, const void* ws,
           const void* wr, const void* br, void* out, int n, int c, int dd,
           void* stream) {
  const size_t smem =
      sizeof(float) * (c * H + H + H * H + H + H + (H + dd) * 3 + 3);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_nerf_mlp_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
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
