// The fused tick's one-sweep gather (B3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/streaming_pipeline.py::fused_gather_dual
// (body _fused_kernel): two Gathering-Unit gathers served from ONE staged
// halo block per MVoxel -- this tick's pooled hole samples and the next
// tick's reference samples:
//
//   out_h[s, m, i, :] = sum_v w_h[s, m, i, v] * table[m][ids_h[s, m, i, v], :]
//   out_r[s, m, j, :] = sum_v w_r[s, m, j, v] * table[m][ids_r[s, m, j, v], :]
//
// for every MVoxel m, segment s, hole RIT row i < cap_h and reference RIT
// row j < cap_r, v = 0..7 in order, fp32 accumulation. Pad rows carry id 0
// and weight 0.
//
// What bounds it on an H100: bytes. Per RIT row of either set it reads 8
// ids and 8 weights (64 B) and writes C outputs, doing 8 multiply-adds per
// output; the halo table is read once for both sets. At the fused tick's
// shapes (216-512 MVoxels x (512 + 1024) rows x 1-4 segments, C = 4-8)
// that is 29-314 MB, i.e. 9-94 us at 3.35 TB/s, against well under a
// GFLOP of arithmetic.
//
// Design: the Gathering Unit's (csrc/gather_trilerp.cu), with a second
// id/weight/output set. One CTA per MVoxel stages the halo block [P, C]
// into shared memory once (converted to fp32) and loops over the
// segments; for each it gathers the cap_h hole rows, then the cap_r
// reference rows, from the resident block -- the TPU grid's
// (MVoxel outer, segment inner) residency, which is what makes the tick a
// single table sweep. Each thread owns one (row, channel) output, so
// consecutive threads write consecutive addresses. The per-output
// arithmetic is B1's exactly: 8 indexed shared-memory loads, each step a
// separately rounded multiply and add (no FMA contraction) in v order, so
// B3 is bit-equal to B1 run on each set alone and to the plain PyTorch
// version. An id outside [0, P) yields NaN instead of an out-of-bounds
// read. The file is self-contained (no header shared with B1), so a
// library rebuilds exactly when its own source changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One RIT block of `rows` rows against the resident halo block `blk`.
template <typename T>
__device__ __forceinline__ void gather_rows(const float* blk,
                                            const int* __restrict__ ids,
                                            const float* __restrict__ w,
                                            T* __restrict__ out, int rows,
                                            int p, int c) {
  const int outputs = rows * c;
  for (int t = threadIdx.x; t < outputs; t += blockDim.x) {
    const int i = t / c;
    const int ch = t - i * c;
    float acc = 0.0f;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int id = __ldg(ids + i * 8 + v);
      const float x = (static_cast<unsigned>(id) < static_cast<unsigned>(p))
                          ? blk[id * c + ch]
                          : NAN;
      acc = __fadd_rn(acc, __fmul_rn(__ldg(w + i * 8 + v), x));
    }
    store(out + t, acc);
  }
}

template <typename T>
__global__ void fused_gather_dual_kernel(
    const T* __restrict__ table, const int* __restrict__ ids_h,
    const float* __restrict__ w_h, const int* __restrict__ ids_r,
    const float* __restrict__ w_r, T* __restrict__ out_h,
    T* __restrict__ out_r, int num_mv, int num_seg, int p, int c, int cap_h,
    int cap_r) {
  extern __shared__ float blk[];  // [p, c] fp32, the resident halo block
  const int m = blockIdx.x;
  const T* src = table + static_cast<size_t>(m) * p * c;
  for (int k = threadIdx.x; k < p * c; k += blockDim.x) {
    blk[k] = load_f32(src + k);
  }
  __syncthreads();
  for (int s = 0; s < num_seg; ++s) {
    const size_t slot = static_cast<size_t>(s) * num_mv + m;
    const size_t row_h = slot * cap_h;
    const size_t row_r = slot * cap_r;
    gather_rows(blk, ids_h + row_h * 8, w_h + row_h * 8, out_h + row_h * c,
                cap_h, p, c);
    gather_rows(blk, ids_r + row_r * 8, w_r + row_r * 8, out_r + row_r * c,
                cap_r, p, c);
  }
}

template <typename T>
int launch(const void* table, const void* ids_h, const void* w_h,
           const void* ids_r, const void* w_r, void* out_h, void* out_r,
           int num_mv, int num_seg, int p, int c, int cap_h, int cap_r,
           void* stream) {
  const size_t smem = static_cast<size_t>(p) * c * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_gather_dual_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_gather_dual_kernel<T><<<num_mv, 256, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int*>(ids_h),
      static_cast<const float*>(w_h), static_cast<const int*>(ids_r),
      static_cast<const float*>(w_r), static_cast<T*>(out_h),
      static_cast<T*>(out_r), num_mv, num_seg, p, c, cap_h, cap_r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_gather_dual_f32(const void* table, const void* ids_h,
                                     const void* w_h, const void* ids_r,
                                     const void* w_r, void* out_h,
                                     void* out_r, int num_mv, int num_seg,
                                     int p, int c, int cap_h, int cap_r,
                                     void* stream) {
  return launch<float>(table, ids_h, w_h, ids_r, w_r, out_h, out_r, num_mv,
                       num_seg, p, c, cap_h, cap_r, stream);
}

extern "C" int fused_gather_dual_bf16(const void* table, const void* ids_h,
                                      const void* w_h, const void* ids_r,
                                      const void* w_r, void* out_h,
                                      void* out_r, int num_mv, int num_seg,
                                      int p, int c, int cap_h, int cap_r,
                                      void* stream) {
  return launch<__nv_bfloat16>(table, ids_h, w_h, ids_r, w_r, out_h, out_r,
                               num_mv, num_seg, p, c, cap_h, cap_r, stream);
}
