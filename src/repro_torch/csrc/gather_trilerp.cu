// The Gathering Unit (paper section IV-B/C) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gather_trilerp.py::gather_trilerp_mvoxels_segmented
// (body gather_block; gather_trilerp_mvoxels is its num_seg = 1 case):
//
//   out[s, m, i, :] = sum_v w[s, m, i, v] * table[m][ids[s, m, i, v], :]
//
// for every MVoxel m, segment s and RIT row i, v = 0..7 in order, fp32
// accumulation. Pad rows carry id 0 and weight 0.
//
// What bounds it on an H100: bytes. Per (s, m, i) row it reads 8 ids and
// 8 weights (64 B) and writes C outputs, doing 8 multiply-adds per output;
// the halo table itself is read once. At the main-path shapes (216-512
// MVoxels x 512 rows, C = 4-8) that is 11-37 MB, i.e. 3-11 us at
// 3.35 TB/s, against well under a GFLOP of arithmetic.
//
// Design: one CTA per MVoxel loops over the segments, so the halo block
// [P, C] is staged into shared memory once (converted to fp32) and serves
// every segment -- the property the Pallas grid order (num_mv, num_seg)
// encodes. The TPU's one-hot x MXU matmul is a TPU device and is not
// carried over: here each thread owns one (row, channel) output, so
// consecutive threads write consecutive addresses, and does 8 indexed
// shared-memory loads. Each step is a separately rounded multiply and add
// (no FMA contraction), the same arithmetic as the plain PyTorch version.
// An id outside [0, P) yields NaN instead of an out-of-bounds read.

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

template <typename T>
__global__ void gather_trilerp_kernel(const T* __restrict__ table,
                                      const int* __restrict__ ids,
                                      const float* __restrict__ w,
                                      T* __restrict__ out, int num_mv,
                                      int num_seg, int p, int c, int cap) {
  extern __shared__ float blk[];  // [p, c] fp32, the resident halo block
  const int m = blockIdx.x;
  const T* src = table + static_cast<size_t>(m) * p * c;
  for (int k = threadIdx.x; k < p * c; k += blockDim.x) {
    blk[k] = load_f32(src + k);
  }
  __syncthreads();
  const int outputs = cap * c;
  for (int s = 0; s < num_seg; ++s) {
    const size_t row0 = (static_cast<size_t>(s) * num_mv + m) * cap;
    const int* id_s = ids + row0 * 8;
    const float* w_s = w + row0 * 8;
    T* out_s = out + row0 * c;
    for (int t = threadIdx.x; t < outputs; t += blockDim.x) {
      const int i = t / c;
      const int ch = t - i * c;
      float acc = 0.0f;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int id = __ldg(id_s + i * 8 + v);
        const float x = (static_cast<unsigned>(id) < static_cast<unsigned>(p))
                            ? blk[id * c + ch]
                            : NAN;
        acc = __fadd_rn(acc, __fmul_rn(__ldg(w_s + i * 8 + v), x));
      }
      store(out_s + t, acc);
    }
  }
}

template <typename T>
int launch(const void* table, const void* ids, const void* w, void* out,
           int num_mv, int num_seg, int p, int c, int cap, void* stream) {
  const size_t smem = static_cast<size_t>(p) * c * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gather_trilerp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gather_trilerp_kernel<T><<<num_mv, 256, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int*>(ids),
      static_cast<const float*>(w), static_cast<T*>(out), num_mv, num_seg, p,
      c, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gather_trilerp_f32(const void* table, const void* ids,
                                  const void* w, void* out, int num_mv,
                                  int num_seg, int p, int c, int cap,
                                  void* stream) {
  return launch<float>(table, ids, w, out, num_mv, num_seg, p, c, cap,
                       stream);
}

extern "C" int gather_trilerp_bf16(const void* table, const void* ids,
                                   const void* w, void* out, int num_mv,
                                   int num_seg, int p, int c, int cap,
                                   void* stream) {
  return launch<__nv_bfloat16>(table, ids, w, out, num_mv, num_seg, p, c, cap,
                               stream);
}
