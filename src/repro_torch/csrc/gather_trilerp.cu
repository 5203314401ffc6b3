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
// the halo table itself is read once. At the main path's shapes (216-512
// MVoxels x 512 rows, one segment, C = 4-8) that is 11.4-37.1 MB, i.e.
// 3.4-11.1 us at 3.35 TB/s, against well under a GFLOP of arithmetic.
//
// Design (B4's, csrc/gather_trilerp_per_seg.cu, without the steering):
//  * Grid (ceil(cap / R), num_mv): a CTA of R threads owns R RIT rows of
//    one MVoxel, R = 256 from cap 256 up and cap rounded up to a warp
//    below it (the wrapper's gather_grid plans it: 432 CTAs at cap 512 and
//    216 MVoxels, all resident in one wave). A thread owns one row and
//    computes all C channels of it; its 8 ids and 8 weights come in as two
//    int4 and two float4 loads.
//  * The CTA stages its MVoxel's halo block [P, C] once, in the table's
//    own dtype (bf16 -> fp32 at the read is exact, so the arithmetic does
//    not change), with cp.async in the largest unit (16, 8 or 4 bytes)
//    that divides the block's address and size, and walks the segments in
//    order against it: the property the Pallas grid order (num_mv,
//    num_seg) encodes. The first segment's ids and weights are issued
//    before the cp.async wait and the one barrier, so they are in flight
//    through it; with one segment (most launches) the block is about as
//    many bytes as the CTA's rows, and this overlap is what hides it.
//  * C = 4 and C = 8 are template values: a corner's halo row is one or
//    two 16-byte shared-memory reads (8 bytes for bf16 C = 4) and the
//    row's outputs 16-byte stores (8-byte for bf16). Any other C runs the
//    same kernel with C read at run time, channel by channel. A block
//    larger than a CTA's shared memory (the reference's edge-16, C = 12
//    shape in fp32: 235,824 B) is not staged; the CTA reads it in place,
//    through L1 and L2, with the run-time-C code.
//  * The per-output arithmetic is unchanged: for v = 0..7 in order,
//    acc = __fadd_rn(acc, __fmul_rn(w_v, x_v)) from 0.0f (no FMA
//    contraction), the plain PyTorch version's, so B1 is bit-equal to it,
//    B3 to two B1 launches and B4 to B1 on each page. An id outside
//    [0, P) yields NaN instead of an out-of-bounds read.
// The file is self-contained (B4's device helpers are copied, not
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
// memory (uniform over the grid)
template <typename T, int CC>
__global__ void __launch_bounds__(kMaxThreads) gather_trilerp_kernel(
    const T* __restrict__ table, const int* __restrict__ ids,
    const float* __restrict__ w, T* __restrict__ out, int num_mv,
    int num_seg, int p, int c_rt, int cap, bool staged) {
  extern __shared__ __align__(16) char smem[];
  const int c = CC ? CC : c_rt;
  const int m = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // this thread's row
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
  const T* blk = reinterpret_cast<const T*>(smem);
  if constexpr (CC == 0) {
    if (!staged) blk = src;
  }
  for (int s = 0; s < num_seg; ++s) {
    const size_t r = (static_cast<size_t>(s) * num_mv + m) * cap + i;
    if (s > 0) load_row(ids, w, r, row);
    gather_row<T, CC>(blk, row, p, c, out + r * c);
  }
}

template <typename T, int CC>
int launch_c(const void* table, const void* ids, const void* w, void* out,
             int num_mv, int num_seg, int p, int c, int cap, int grid_x,
             int threads, bool staged, void* stream) {
  const size_t smem = staged ? static_cast<size_t>(p) * c * sizeof(T) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gather_trilerp_kernel<T, CC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gather_trilerp_kernel<T, CC><<<dim3(grid_x, num_mv), threads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int*>(ids),
      static_cast<const float*>(w), static_cast<T*>(out), num_mv, num_seg, p,
      c, cap, staged);
  return static_cast<int>(cudaGetLastError());
}

// grid_x CTAs of `threads` rows per MVoxel (the wrapper's gather_grid)
// must cover cap; smem_bytes is the block's size when it is staged, 0
// when it is read in place (the wrapper's gather_smem_bytes); ids and
// weights must be 16-byte aligned (two int4 / float4 loads a row)
template <typename T>
int launch(const void* table, const void* ids, const void* w, void* out,
           int num_mv, int num_seg, int p, int c, int cap, int grid_x,
           int threads, int smem_bytes, void* stream) {
  const bool staged = smem_bytes > 0;
  if (c < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      static_cast<long long>(grid_x) * threads < cap ||
      (staged &&
       static_cast<size_t>(smem_bytes) != static_cast<size_t>(p) * c *
                                              sizeof(T)) ||
      ((reinterpret_cast<uintptr_t>(ids) | reinterpret_cast<uintptr_t>(w)) &
       15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (staged && c == 4) {
    return launch_c<T, 4>(table, ids, w, out, num_mv, num_seg, p, c, cap,
                          grid_x, threads, true, stream);
  }
  if (staged && c == 8) {
    return launch_c<T, 8>(table, ids, w, out, num_mv, num_seg, p, c, cap,
                          grid_x, threads, true, stream);
  }
  return launch_c<T, 0>(table, ids, w, out, num_mv, num_seg, p, c, cap,
                        grid_x, threads, staged, stream);
}

}  // namespace

extern "C" int gather_trilerp_f32(const void* table, const void* ids,
                                  const void* w, void* out, int num_mv,
                                  int num_seg, int p, int c, int cap,
                                  int grid_x, int threads, int smem_bytes,
                                  void* stream) {
  return launch<float>(table, ids, w, out, num_mv, num_seg, p, c, cap,
                       grid_x, threads, smem_bytes, stream);
}

extern "C" int gather_trilerp_bf16(const void* table, const void* ids,
                                   const void* w, void* out, int num_mv,
                                   int num_seg, int p, int c, int cap,
                                   int grid_x, int threads, int smem_bytes,
                                   void* stream) {
  return launch<__nv_bfloat16>(table, ids, w, out, num_mv, num_seg, p, c,
                               cap, grid_x, threads, smem_bytes, stream);
}
