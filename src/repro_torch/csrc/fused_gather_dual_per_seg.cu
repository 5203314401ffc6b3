// The mixed-scene fused tick's one-sweep gather (B5) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/streaming_pipeline.py::fused_gather_dual_per_seg
// (body _fused_kernel_per_seg): B3, except that segment s reads the halo
// tables of its own scene's page, pages[scene_of_seg[s]]:
//
//   out_h[s, m, i, :] = sum_v w_h[s, m, i, v] * tbl_s[m][ids_h[s, m, i, v], :]
//   out_r[s, m, j, :] = sum_v w_r[s, m, j, v] * tbl_s[m][ids_r[s, m, j, v], :]
//   with tbl_s = pages[scene_of_seg[s]]
//
// for every MVoxel m, segment s, hole RIT row i < cap_h and reference RIT
// row j < cap_r, v = 0..7 in order, fp32 accumulation. Pad rows carry id 0
// and weight 0. The reference's caller first copies
// mv_tables[scene_of_seg] into a [num_seg, num_mv, P, C] array; here the
// kernel takes the K resident pages [K, num_mv, P, C] and the
// segment->page map scene_of_seg [num_seg] (int32, on the device) and
// indexes the pages itself: no per-tick copy, no host read of the map.
//
// What bounds it on an H100: bytes. Per RIT row of either set it reads 8
// ids and 8 weights (64 B) and writes C outputs, doing 8 multiply-adds per
// output; each distinct page's halo block is read once per MVoxel for
// both sets. At the mixed-scene serving tick's shape (216 MVoxels x
// (512 + 1024) rows x 4 segments, C = 4, up to 4 pages) that is about
// 116 MB, i.e. about 35 us at 3.35 TB/s, against well under a GFLOP.
//
// Design: B3's (csrc/fused_gather_dual.cu) with B4's page steering
// (csrc/gather_trilerp_per_seg.cu). One CTA per MVoxel loops over the
// segments; for each it reads the segment's page and restages the halo
// block [P, C] into shared memory (fp32) only when that page differs from
// the one already staged, so segments that share a scene reuse one block:
// one pass over the distinct resident tables per tick. From the staged
// block it gathers the cap_h hole rows, then the cap_r reference rows.
// The map entry is uniform across the CTA, so the restage branch and its
// barriers are uniform. Each thread owns one (row, channel) output. The
// per-output arithmetic is B1's exactly: 8 indexed shared-memory loads,
// each step a separately rounded multiply and add (no FMA contraction) in
// v order, so B5 on segment s is bit-equal to B3 run on page
// scene_of_seg[s], and to the plain PyTorch version. An id outside [0, P)
// or a page outside [0, K) yields NaN instead of an out-of-bounds read.
// Self-contained (no header shared with B1/B3/B4), so the library rebuilds
// exactly when this source changes.

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

// One RIT block of `rows` rows against the staged halo block `blk`;
// `valid` is false when the segment's page is out of range (NaN rows).
template <typename T>
__device__ __forceinline__ void gather_rows(const float* blk, bool valid,
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
      const float x =
          (valid && static_cast<unsigned>(id) < static_cast<unsigned>(p))
              ? blk[id * c + ch]
              : NAN;
      acc = __fadd_rn(acc, __fmul_rn(__ldg(w + i * 8 + v), x));
    }
    store(out + t, acc);
  }
}

template <typename T>
__global__ void fused_gather_dual_per_seg_kernel(
    const T* __restrict__ pages, const int* __restrict__ scene_of_seg,
    const int* __restrict__ ids_h, const float* __restrict__ w_h,
    const int* __restrict__ ids_r, const float* __restrict__ w_r,
    T* __restrict__ out_h, T* __restrict__ out_r, int num_pages, int num_mv,
    int num_seg, int p, int c, int cap_h, int cap_r) {
  extern __shared__ float blk[];  // [p, c] fp32, the staged halo block
  const int m = blockIdx.x;
  const size_t block_elems = static_cast<size_t>(p) * c;
  const size_t page_elems = static_cast<size_t>(num_mv) * block_elems;
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
    const size_t slot = static_cast<size_t>(s) * num_mv + m;
    const size_t row_h = slot * cap_h;
    const size_t row_r = slot * cap_r;
    gather_rows(blk, valid, ids_h + row_h * 8, w_h + row_h * 8,
                out_h + row_h * c, cap_h, p, c);
    gather_rows(blk, valid, ids_r + row_r * 8, w_r + row_r * 8,
                out_r + row_r * c, cap_r, p, c);
  }
}

template <typename T>
int launch(const void* pages, const void* scene_of_seg, const void* ids_h,
           const void* w_h, const void* ids_r, const void* w_r, void* out_h,
           void* out_r, int num_pages, int num_mv, int num_seg, int p, int c,
           int cap_h, int cap_r, void* stream) {
  const size_t smem = static_cast<size_t>(p) * c * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_gather_dual_per_seg_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_gather_dual_per_seg_kernel<T><<<num_mv, 256, smem,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pages), static_cast<const int*>(scene_of_seg),
      static_cast<const int*>(ids_h), static_cast<const float*>(w_h),
      static_cast<const int*>(ids_r), static_cast<const float*>(w_r),
      static_cast<T*>(out_h), static_cast<T*>(out_r), num_pages, num_mv,
      num_seg, p, c, cap_h, cap_r);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_gather_dual_per_seg_f32(
    const void* pages, const void* scene_of_seg, const void* ids_h,
    const void* w_h, const void* ids_r, const void* w_r, void* out_h,
    void* out_r, int num_pages, int num_mv, int num_seg, int p, int c,
    int cap_h, int cap_r, void* stream) {
  return launch<float>(pages, scene_of_seg, ids_h, w_h, ids_r, w_r, out_h,
                       out_r, num_pages, num_mv, num_seg, p, c, cap_h, cap_r,
                       stream);
}

extern "C" int fused_gather_dual_per_seg_bf16(
    const void* pages, const void* scene_of_seg, const void* ids_h,
    const void* w_h, const void* ids_r, const void* w_r, void* out_h,
    void* out_r, int num_pages, int num_mv, int num_seg, int p, int c,
    int cap_h, int cap_r, void* stream) {
  return launch<__nv_bfloat16>(pages, scene_of_seg, ids_h, w_h, ids_r, w_r,
                               out_h, out_r, num_pages, num_mv, num_seg, p, c,
                               cap_h, cap_r, stream);
}
