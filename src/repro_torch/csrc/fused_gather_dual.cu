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
// Design (B1's, csrc/gather_trilerp.cu, over B5's two-set grid without the
// page map):
//  * Grid (tiles_h + tiles_r, num_mv), tiles_x = ceil(cap_x / R): a CTA
//    of R threads owns R rows of one set of one MVoxel; columns below
//    tiles_h own hole rows, the others reference rows, so a CTA's set is
//    uniform and nothing in the segment loop branches on it (R = 256 from
//    a cap of 256 up, else the larger cap rounded up to a warp; the
//    wrapper's dual_grid plans it: 6 CTAs per MVoxel at the main path's
//    caps, 1,296 at arm C's 216 MVoxels, 3,072 at arm D's 512). A thread
//    owns one row and computes all C channels of it; its 8 ids and 8
//    weights come in as two int4 and two float4 loads.
//  * The CTA stages its MVoxel's halo block [P, C] once, in the table's
//    own dtype (bf16 -> fp32 at the read is exact, so the arithmetic does
//    not change), with cp.async in the largest unit (16, 8 or 4 bytes)
//    that divides the block's address and size; the first segment's ids
//    and weights are issued before the cp.async wait and the one barrier,
//    so they are in flight through it, and the CTA then walks every
//    segment against the resident block with no further barrier: the TPU
//    grid's (MVoxel outer, segment inner) residency.
//  * C = 4 and C = 8 are template values: a corner's halo row is one or
//    two 16-byte shared-memory reads (8 bytes for bf16 C = 4) and the
//    row's outputs 16-byte stores (8-byte for bf16 C = 4). Any other C
//    runs the same kernel with C read at run time, channel by channel. A
//    block larger than a CTA's shared memory (fp32 from C = 80 at
//    P = 729, the reference's edge-16, C = 12 block in fp32) is not
//    staged; the CTA reads it in place, through L1 and L2, with the
//    run-time-C code.
//  * The per-output arithmetic is B1's exactly: for v = 0..7 in order,
//    acc = __fadd_rn(acc, __fmul_rn(w_v, x_v)) from 0.0f (no FMA
//    contraction), so B3 is bit-equal to B1 run on each set alone and to
//    the plain PyTorch version. An id outside [0, P) yields NaN instead of
//    an out-of-bounds read.
// The file is self-contained (B1's device helpers are copied, not
// included), so a library rebuilds exactly when its own source changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;  // RIT rows a CTA owns, at most

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(N));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_units(char* dst, const char* src,
                                           size_t bytes) {
  for (size_t k = threadIdx.x * static_cast<size_t>(N); k < bytes;
       k += static_cast<size_t>(blockDim.x) * N) {
    cp_async<N>(dst + k, src + k);
  }
}

// issue the copy of one halo block into shared memory (asynchronous where
// the alignment allows; the caller waits and syncs before reading)
__device__ __forceinline__ void stage_block(char* dst, const char* src,
                                            size_t bytes) {
  const size_t align = reinterpret_cast<uintptr_t>(src) | bytes;
  if ((align & 15) == 0) {
    copy_units<16>(dst, src, bytes);
  } else if ((align & 7) == 0) {
    copy_units<8>(dst, src, bytes);
  } else if ((align & 3) == 0) {
    copy_units<4>(dst, src, bytes);
  } else {
    for (size_t k = threadIdx.x * 2; k < bytes; k += blockDim.x * 2) {
      *reinterpret_cast<uint16_t*>(dst + k) =
          *reinterpret_cast<const uint16_t*>(src + k);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the C channels of halo row id of a staged block, in fp32
template <typename T, int C>
__device__ __forceinline__ void read_row(const T* blk, int id, float* x) {
  const T* src = blk + static_cast<size_t>(id) * C;
  if constexpr (sizeof(T) * C == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) x[ch] = to_f32(e[ch]);
  } else if constexpr (sizeof(T) * C == 32) {
    const uint4 u0 = *reinterpret_cast<const uint4*>(src);
    const uint4 u1 = *reinterpret_cast<const uint4*>(src + C / 2);
    const T* e0 = reinterpret_cast<const T*>(&u0);
    const T* e1 = reinterpret_cast<const T*>(&u1);
#pragma unroll
    for (int ch = 0; ch < C / 2; ++ch) {
      x[ch] = to_f32(e0[ch]);
      x[C / 2 + ch] = to_f32(e1[ch]);
    }
  } else if constexpr (sizeof(T) * C == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) x[ch] = to_f32(e[ch]);
  } else {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) x[ch] = to_f32(src[ch]);
  }
}

template <typename T, int C>
__device__ __forceinline__ void store_row(T* dst, const float* acc) {
  if constexpr (sizeof(T) == 4 && C % 4 == 0) {
#pragma unroll
    for (int ch = 0; ch < C; ch += 4) {
      *reinterpret_cast<float4*>(dst + ch) =
          make_float4(acc[ch], acc[ch + 1], acc[ch + 2], acc[ch + 3]);
    }
  } else if constexpr (sizeof(T) == 2 && C % 4 == 0) {
#pragma unroll
    for (int ch = 0; ch < C; ch += 4) {
      T e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) store(e + k, acc[ch + k]);
      *reinterpret_cast<uint2*>(dst + ch) = *reinterpret_cast<uint2*>(e);
    }
  } else {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) store(dst + ch, acc[ch]);
  }
}

struct Row {
  int id[8];
  float w[8];
};

__device__ __forceinline__ void load_row(const int* __restrict__ ids,
                                         const float* __restrict__ w,
                                         size_t r, Row& row) {
  const int4* ip = reinterpret_cast<const int4*>(ids + r * 8);
  const float4* wp = reinterpret_cast<const float4*>(w + r * 8);
  const int4 i0 = __ldg(ip), i1 = __ldg(ip + 1);
  const float4 w0 = __ldg(wp), w1 = __ldg(wp + 1);
  row.id[0] = i0.x; row.id[1] = i0.y; row.id[2] = i0.z; row.id[3] = i0.w;
  row.id[4] = i1.x; row.id[5] = i1.y; row.id[6] = i1.z; row.id[7] = i1.w;
  row.w[0] = w0.x; row.w[1] = w0.y; row.w[2] = w0.z; row.w[3] = w0.w;
  row.w[4] = w1.x; row.w[5] = w1.y; row.w[6] = w1.z; row.w[7] = w1.w;
}

// one RIT row's C outputs from the block blk (shared memory, or device
// memory for a block read in place); CC = 0 reads c at run time
template <typename T, int CC>
__device__ __forceinline__ void gather_row(const T* blk, const Row& row,
                                           int p, int c, T* dst) {
  if constexpr (CC != 0) {
    float acc[CC];
#pragma unroll
    for (int ch = 0; ch < CC; ++ch) acc[ch] = 0.0f;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      float x[CC];
      if (static_cast<unsigned>(row.id[v]) < static_cast<unsigned>(p)) {
        read_row<T, CC>(blk, row.id[v], x);
      } else {
#pragma unroll
        for (int ch = 0; ch < CC; ++ch) x[ch] = NAN;
      }
#pragma unroll
      for (int ch = 0; ch < CC; ++ch) {
        acc[ch] = __fadd_rn(acc[ch], __fmul_rn(row.w[v], x[ch]));
      }
    }
    store_row<T, CC>(dst, acc);
  } else {
    for (int ch = 0; ch < c; ++ch) {
      float acc = 0.0f;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const float x =
            static_cast<unsigned>(row.id[v]) < static_cast<unsigned>(p)
                ? to_f32(blk[static_cast<size_t>(row.id[v]) * c + ch])
                : NAN;
        acc = __fadd_rn(acc, __fmul_rn(row.w[v], x));
      }
      store(dst + ch, acc);
    }
  }
}

// CC: the channel count as a template value (4 or 8), 0 for any other,
// read from c_rt at run time; staged: whether the block fits in shared
// memory (uniform over the grid; always true for CC != 0)
template <typename T, int CC>
__global__ void __launch_bounds__(kMaxThreads) fused_gather_dual_kernel(
    const T* __restrict__ table, const int* __restrict__ ids_h,
    const float* __restrict__ w_h, const int* __restrict__ ids_r,
    const float* __restrict__ w_r, T* __restrict__ out_h,
    T* __restrict__ out_r, int num_mv, int num_seg, int p, int c_rt,
    int cap_h, int cap_r, int tiles_h, bool staged_rt) {
  extern __shared__ __align__(16) char smem[];
  const int c = CC ? CC : c_rt;
  const bool staged = CC != 0 || staged_rt;
  const int m = blockIdx.y;
  // this CTA's set: columns [0, tiles_h) hold hole rows, the rest
  // reference rows
  const bool holes = static_cast<int>(blockIdx.x) < tiles_h;
  const int* ids = holes ? ids_h : ids_r;
  const float* w = holes ? w_h : w_r;
  T* out = holes ? out_h : out_r;
  const int cap = holes ? cap_h : cap_r;
  const int i = (static_cast<int>(blockIdx.x) - (holes ? 0 : tiles_h)) *
                    static_cast<int>(blockDim.x) +
                static_cast<int>(threadIdx.x);  // this thread's row
  const bool live = i < cap;
  const size_t block_elems = static_cast<size_t>(p) * c;
  const T* src = table + static_cast<size_t>(m) * block_elems;
  if (staged) {
    stage_block(smem, reinterpret_cast<const char*>(src),
                block_elems * sizeof(T));
  }
  // segment 0's ids and weights, in flight through the staging wait
  Row row;
  if (live) load_row(ids, w, static_cast<size_t>(m) * cap + i, row);
  if (staged) {
    cp_async_wait_all();
    __syncthreads();
  }
  if (!live) return;
  const T* blk = staged ? reinterpret_cast<const T*>(smem) : src;
  for (int s = 0; s < num_seg; ++s) {
    const size_t r = (static_cast<size_t>(s) * num_mv + m) * cap + i;
    if (s > 0) load_row(ids, w, r, row);
    gather_row<T, CC>(blk, row, p, c, out + r * c);
  }
}

template <typename T, int CC>
int launch_c(const void* table, const void* ids_h, const void* w_h,
             const void* ids_r, const void* w_r, void* out_h, void* out_r,
             int num_mv, int num_seg, int p, int c, int cap_h, int cap_r,
             int grid_x, int tiles_h, int threads, bool staged,
             void* stream) {
  const size_t smem = staged ? static_cast<size_t>(p) * c * sizeof(T) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_gather_dual_kernel<T, CC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_gather_dual_kernel<T, CC><<<dim3(grid_x, num_mv), threads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int*>(ids_h),
      static_cast<const float*>(w_h), static_cast<const int*>(ids_r),
      static_cast<const float*>(w_r), static_cast<T*>(out_h),
      static_cast<T*>(out_r), num_mv, num_seg, p, c, cap_h, cap_r, tiles_h,
      staged);
  return static_cast<int>(cudaGetLastError());
}

// grid_x = tiles_h + tiles_r CTAs of `threads` rows per MVoxel (the
// wrapper's dual_grid) must cover cap_h and cap_r; smem_bytes is the
// block's size when it is staged, 0 when it is read in place (the
// wrapper's gather_smem_bytes); ids and weights must be 16-byte aligned
// (two int4 / float4 loads a row)
template <typename T>
int launch(const void* table, const void* ids_h, const void* w_h,
           const void* ids_r, const void* w_r, void* out_h, void* out_r,
           int num_mv, int num_seg, int p, int c, int cap_h, int cap_r,
           int grid_x, int tiles_h, int threads, int smem_bytes,
           void* stream) {
  const bool staged = smem_bytes > 0;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(ids_h) | reinterpret_cast<uintptr_t>(w_h) |
      reinterpret_cast<uintptr_t>(ids_r) | reinterpret_cast<uintptr_t>(w_r);
  if (c < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      tiles_h < 0 || grid_x < tiles_h ||
      static_cast<long long>(tiles_h) * threads < cap_h ||
      static_cast<long long>(grid_x - tiles_h) * threads < cap_r ||
      (staged &&
       static_cast<size_t>(smem_bytes) != static_cast<size_t>(p) * c *
                                              sizeof(T)) ||
      (align & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (staged && c == 4) {
    return launch_c<T, 4>(table, ids_h, w_h, ids_r, w_r, out_h, out_r,
                          num_mv, num_seg, p, c, cap_h, cap_r, grid_x,
                          tiles_h, threads, true, stream);
  }
  if (staged && c == 8) {
    return launch_c<T, 8>(table, ids_h, w_h, ids_r, w_r, out_h, out_r,
                          num_mv, num_seg, p, c, cap_h, cap_r, grid_x,
                          tiles_h, threads, true, stream);
  }
  return launch_c<T, 0>(table, ids_h, w_h, ids_r, w_r, out_h, out_r, num_mv,
                        num_seg, p, c, cap_h, cap_r, grid_x, tiles_h,
                        threads, staged, stream);
}

}  // namespace

extern "C" int fused_gather_dual_f32(const void* table, const void* ids_h,
                                     const void* w_h, const void* ids_r,
                                     const void* w_r, void* out_h,
                                     void* out_r, int num_mv, int num_seg,
                                     int p, int c, int cap_h, int cap_r,
                                     int grid_x, int tiles_h, int threads,
                                     int smem_bytes, void* stream) {
  return launch<float>(table, ids_h, w_h, ids_r, w_r, out_h, out_r, num_mv,
                       num_seg, p, c, cap_h, cap_r, grid_x, tiles_h, threads,
                       smem_bytes, stream);
}

extern "C" int fused_gather_dual_bf16(const void* table, const void* ids_h,
                                      const void* w_h, const void* ids_r,
                                      const void* w_r, void* out_h,
                                      void* out_r, int num_mv, int num_seg,
                                      int p, int c, int cap_h, int cap_r,
                                      int grid_x, int tiles_h, int threads,
                                      int smem_bytes, void* stream) {
  return launch<__nv_bfloat16>(table, ids_h, w_h, ids_r, w_r, out_h, out_r,
                               num_mv, num_seg, p, c, cap_h, cap_r, grid_x,
                               tiles_h, threads, smem_bytes, stream);
}
