// The mixed-scene Gathering Unit (B4) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/gather_trilerp.py::gather_trilerp_mvoxels_per_seg
// (body _kernel_per_seg): B1, except that segment s reads the halo tables
// of its own scene's page, pages[scene_of_seg[s]]:
//
//   out[s, m, i, :] = sum_v w[s, m, i, v]
//                           * pages[scene_of_seg[s]][m][ids[s, m, i, v], :]
//
// for every MVoxel m, segment s and RIT row i, v = 0..7 in order, fp32
// accumulation. Pad rows carry id 0 and weight 0. The reference's caller
// first copies mv_tables[scene_of_seg] into a [num_seg, num_mv, P, C]
// array; here the kernel takes the K resident pages [K, num_mv, P, C] and
// the segment->page map scene_of_seg [num_seg] (int32, on the device) and
// indexes the pages itself, so no per-call copy is made and the host never
// reads the map.
//
// What bounds it on an H100: bytes. Per (s, m, i) row it reads 8 ids and
// 8 weights (64 B) and writes C outputs, doing 8 multiply-adds per output;
// each distinct page's halo block is read once per MVoxel. At the serving
// path's shapes (216 MVoxels x 512-1024 rows x 4 segments, C = 4) that is
// 30-60 MB, i.e. 9-18 us at 3.35 TB/s, against well under a GFLOP.
//
// Design: B1's (csrc/gather_trilerp.cu). One CTA per MVoxel loops over the
// segments; for each it reads the segment's page and stages that page's
// halo block [P, C] into shared memory (converted to fp32) only when it
// differs from the block already staged, so segments that share a scene
// -- adjacent or not, as long as no other page comes between -- reuse one
// staged block: one pass over the distinct resident tables per MVoxel.
// The map entry is the same for every thread of the CTA, so the restage
// branch (with its two barriers) is uniform. Each thread owns one (row,
// channel) output, so consecutive threads write consecutive addresses. The
// per-output arithmetic is B1's exactly: 8 indexed shared-memory loads,
// each step a separately rounded multiply and add (no FMA contraction) in
// v order, so B4 on segment s is bit-equal to B1 run on page
// scene_of_seg[s], and to the plain PyTorch version. An id outside [0, P)
// or a page outside [0, K) yields NaN instead of an out-of-bounds read.
// The file is self-contained (no header shared with B1), so a library
// rebuilds exactly when its own source changes.

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
__global__ void gather_trilerp_per_seg_kernel(
    const T* __restrict__ pages, const int* __restrict__ scene_of_seg,
    const int* __restrict__ ids, const float* __restrict__ w,
    T* __restrict__ out, int num_pages, int num_mv, int num_seg, int p, int c,
    int cap) {
  extern __shared__ float blk[];  // [p, c] fp32, the staged halo block
  const int m = blockIdx.x;
  const size_t block_elems = static_cast<size_t>(p) * c;
  const size_t page_elems = static_cast<size_t>(num_mv) * block_elems;
  const int outputs = cap * c;
  int staged = -1;  // page whose block m is in shared memory (-1: none)
  for (int s = 0; s < num_seg; ++s) {
    const int page = __ldg(scene_of_seg + s);
    const bool valid =
        static_cast<unsigned>(page) < static_cast<unsigned>(num_pages);
    if (valid && page != staged) {
      __syncthreads();  // every thread is done with the previous block
      const T* src = pages + page * page_elems + m * block_elems;
      for (int k = threadIdx.x; k < p * c; k += blockDim.x) {
        blk[k] = load_f32(src + k);
      }
      __syncthreads();
      staged = page;
    }
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
        const float x =
            (valid && static_cast<unsigned>(id) < static_cast<unsigned>(p))
                ? blk[id * c + ch]
                : NAN;
        acc = __fadd_rn(acc, __fmul_rn(__ldg(w_s + i * 8 + v), x));
      }
      store(out_s + t, acc);
    }
  }
}

template <typename T>
int launch(const void* pages, const void* scene_of_seg, const void* ids,
           const void* w, void* out, int num_pages, int num_mv, int num_seg,
           int p, int c, int cap, void* stream) {
  const size_t smem = static_cast<size_t>(p) * c * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gather_trilerp_per_seg_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gather_trilerp_per_seg_kernel<T><<<num_mv, 256, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pages), static_cast<const int*>(scene_of_seg),
      static_cast<const int*>(ids), static_cast<const float*>(w),
      static_cast<T*>(out), num_pages, num_mv, num_seg, p, c, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gather_trilerp_per_seg_f32(const void* pages,
                                          const void* scene_of_seg,
                                          const void* ids, const void* w,
                                          void* out, int num_pages,
                                          int num_mv, int num_seg, int p,
                                          int c, int cap, void* stream) {
  return launch<float>(pages, scene_of_seg, ids, w, out, num_pages, num_mv,
                       num_seg, p, c, cap, stream);
}

extern "C" int gather_trilerp_per_seg_bf16(const void* pages,
                                           const void* scene_of_seg,
                                           const void* ids, const void* w,
                                           void* out, int num_pages,
                                           int num_mv, int num_seg, int p,
                                           int c, int cap, void* stream) {
  return launch<__nv_bfloat16>(pages, scene_of_seg, ids, w, out, num_pages,
                               num_mv, num_seg, p, c, cap, stream);
}
