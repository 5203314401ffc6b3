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
// (512 + 1024) rows x 4 segments, C = 4, 3 distinct pages) that is about
// 114 MB, i.e. about 34 us at 3.35 TB/s, against well under a GFLOP.
//
// Design: B4's (csrc/gather_trilerp_per_seg.cu) over two RIT sets.
//  * Grid (tiles_h + tiles_r, num_mv), tiles_x = ceil(cap_x / R): a CTA
//    of R threads owns R rows of one set of one MVoxel; columns below
//    tiles_h own hole rows, the others reference rows, so no CTA mixes
//    the two sets (R = 256 from a cap of 256 up, else the larger cap
//    rounded up to a warp; the wrapper's dual_grid plans it: 6 CTAs per
//    MVoxel, 1,296 in all at arm E's shape). A thread owns one row and
//    computes all C channels of it; its 8 ids and 8 weights come in as
//    two int4 and two float4 loads, issued before a page switch's wait,
//    so they are in flight through it.
//  * Each CTA walks the segments in order with two shared-memory buffers
//    holding halo blocks [P, C] in the pages' own dtype (bf16 -> fp32 at
//    the read is exact). When segment s switches to a new page, the block
//    of the next valid page that differs from it is issued with cp.async
//    into the other buffer, unless that buffer already holds it, and
//    overlaps segment s's gathers. A page switch costs one
//    cp.async.wait_group and one barrier (which also frees the buffer the
//    next prefetch overwrites); segments that share the staged page, and
//    invalid segments, take no barrier. Copies are 16, 8 or 4 bytes, the
//    largest that divides the block's address and size.
//  * The map entry is the same for every thread of the CTA, so every
//    branch on it is uniform. Invalid pages are never prefetched; an
//    invalid segment's rows are NaN.
//  * C = 4 and C = 8 are template values (16-byte shared-memory reads and
//    stores, 8-byte for bf16 C = 4); any other C is read at run time and
//    gathered channel by channel. Where two blocks do not fit in one
//    CTA's shared memory (fp32 from C = 40 at P = 729, the reference's
//    edge-16, C = 12 block in either dtype; the wrapper's
//    per_seg_staging passes 0), the CTA stages nothing and reads each
//    segment's page block in place, through L1 and L2, with the
//    run-time-C code and no barrier.
//  * The per-output arithmetic is B1's exactly: for v = 0..7 in order,
//    acc = __fadd_rn(acc, __fmul_rn(w_v, x_v)) from 0.0f (no FMA
//    contraction), so B5 on segment s is bit-equal to B3 run on page
//    scene_of_seg[s], and to the plain PyTorch version. An id outside
//    [0, P) or a page outside [0, K) yields NaN instead of an
//    out-of-bounds read.
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

// issue the copy of one halo block into a shared buffer (asynchronous
// where the alignment allows; the caller waits and syncs before reading)
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

// one RIT row's C outputs from the staged block blk; CC = 0 reads c at
// run time
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

__device__ __forceinline__ bool valid_page(int page, int num_pages) {
  return static_cast<unsigned>(page) < static_cast<unsigned>(num_pages);
}

// the first segment at or after s whose page is valid and differs from
// `other`; -1 if none
__device__ __forceinline__ int next_page(const int* __restrict__ map, int s,
                                         int num_seg, int num_pages,
                                         int other) {
  for (; s < num_seg; ++s) {
    const int page = __ldg(map + s);
    if (valid_page(page, num_pages) && page != other) return page;
  }
  return -1;
}

// CC: the channel count as a template value (4 or 8), 0 for any other,
// read from c_rt at run time; staged: whether two blocks fit in shared
// memory (uniform over the grid; always true for CC != 0)
template <typename T, int CC>
__global__ void __launch_bounds__(kMaxThreads)
    fused_gather_dual_per_seg_kernel(
        const T* __restrict__ pages, const int* __restrict__ map,
        const int* __restrict__ ids_h, const float* __restrict__ w_h,
        const int* __restrict__ ids_r, const float* __restrict__ w_r,
        T* __restrict__ out_h, T* __restrict__ out_r, int num_pages,
        int num_mv, int num_seg, int p, int c_rt, int cap_h, int cap_r,
        int tiles_h, size_t buf_stride, bool staged_rt) {
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
  const size_t block_bytes = block_elems * sizeof(T);
  const size_t page_elems = static_cast<size_t>(num_mv) * block_elems;
  const T* blk_src = pages + static_cast<size_t>(m) * block_elems;
  char* buf[2] = {smem, smem + buf_stride};
  int held[2] = {-1, -1};  // the page each buffer holds (or is loading)
  int cur = 1;             // the buffer segments read; none staged yet

  // prologue: the first valid page into buffer 0
  const int first = staged ? next_page(map, 0, num_seg, num_pages, -1) : -1;
  if (first >= 0) {
    stage_block(buf[0],
                reinterpret_cast<const char*>(blk_src + first * page_elems),
                block_bytes);
    held[0] = first;
  }
  for (int s = 0; s < num_seg; ++s) {
    const int page = __ldg(map + s);
    const bool valid = valid_page(page, num_pages);
    const size_t r = (static_cast<size_t>(s) * num_mv + m) * cap + i;
    // the row's ids and weights, in flight through a page switch's wait;
    // an invalid page's rows gather NaN (id -1) with weight 0
    Row row;
    if (live && valid) {
      load_row(ids, w, r, row);
    } else {
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        row.id[v] = -1;
        row.w[v] = 0.0f;
      }
    }
    if (staged && valid && page != held[cur]) {
      // the page was prefetched into the other buffer: wait for it; the
      // barrier also frees this buffer for the next prefetch
      cp_async_wait_all();
      __syncthreads();
      cur ^= 1;
      const int np = next_page(map, s + 1, num_seg, num_pages, page);
      if (np >= 0 && np != held[cur ^ 1]) {
        stage_block(buf[cur ^ 1],
                    reinterpret_cast<const char*>(blk_src + np * page_elems),
                    block_bytes);
        held[cur ^ 1] = np;
      }
    }
    if (live) {
      // in place, an invalid page's rows read nothing (their ids are -1)
      const T* blk = staged ? reinterpret_cast<const T*>(buf[cur])
                            : blk_src + (valid ? page : 0) * page_elems;
      gather_row<T, CC>(blk, row, p, c, out + r * c);
    }
  }
}

template <typename T, int CC>
int launch_c(const void* pages, const void* scene_of_seg, const void* ids_h,
             const void* w_h, const void* ids_r, const void* w_r, void* out_h,
             void* out_r, int num_pages, int num_mv, int num_seg, int p,
             int c, int cap_h, int cap_r, int grid_x, int tiles_h,
             int threads, bool staged, void* stream) {
  const size_t block_bytes = static_cast<size_t>(p) * c * sizeof(T);
  const size_t buf_stride = (block_bytes + 15) / 16 * 16;
  const size_t smem = staged ? 2 * buf_stride : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_gather_dual_per_seg_kernel<T, CC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_gather_dual_per_seg_kernel<T, CC>
      <<<dim3(grid_x, num_mv), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(pages), static_cast<const int*>(scene_of_seg),
          static_cast<const int*>(ids_h), static_cast<const float*>(w_h),
          static_cast<const int*>(ids_r), static_cast<const float*>(w_r),
          static_cast<T*>(out_h), static_cast<T*>(out_r), num_pages, num_mv,
          num_seg, p, c, cap_h, cap_r, tiles_h, buf_stride, staged);
  return static_cast<int>(cudaGetLastError());
}

// grid_x = tiles_h + tiles_r CTAs of `threads` rows per MVoxel (the
// wrapper's dual_grid) must cover cap_h and cap_r; staging is the two
// buffers' bytes when they fit in shared memory, 0 when each page's block
// is read in place (the wrapper's per_seg_staging); ids and weights must
// be 16-byte aligned (two int4 / float4 loads a row)
template <typename T>
int launch(const void* pages, const void* scene_of_seg, const void* ids_h,
           const void* w_h, const void* ids_r, const void* w_r, void* out_h,
           void* out_r, int num_pages, int num_mv, int num_seg, int p, int c,
           int cap_h, int cap_r, int grid_x, int tiles_h, int threads,
           int staging, void* stream) {
  const bool staged = staging > 0;
  const size_t buf_stride =
      (static_cast<size_t>(p) * c * sizeof(T) + 15) / 16 * 16;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(ids_h) | reinterpret_cast<uintptr_t>(w_h) |
      reinterpret_cast<uintptr_t>(ids_r) | reinterpret_cast<uintptr_t>(w_r);
  if (c < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      tiles_h < 0 || grid_x < tiles_h ||
      static_cast<long long>(tiles_h) * threads < cap_h ||
      static_cast<long long>(grid_x - tiles_h) * threads < cap_r ||
      (staged && static_cast<size_t>(staging) != 2 * buf_stride) ||
      (align & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (staged && c == 4) {
    return launch_c<T, 4>(pages, scene_of_seg, ids_h, w_h, ids_r, w_r, out_h,
                          out_r, num_pages, num_mv, num_seg, p, c, cap_h,
                          cap_r, grid_x, tiles_h, threads, true, stream);
  }
  if (staged && c == 8) {
    return launch_c<T, 8>(pages, scene_of_seg, ids_h, w_h, ids_r, w_r, out_h,
                          out_r, num_pages, num_mv, num_seg, p, c, cap_h,
                          cap_r, grid_x, tiles_h, threads, true, stream);
  }
  return launch_c<T, 0>(pages, scene_of_seg, ids_h, w_h, ids_r, w_r, out_h,
                        out_r, num_pages, num_mv, num_seg, p, c, cap_h, cap_r,
                        grid_x, tiles_h, threads, staged, stream);
}

}  // namespace

extern "C" int fused_gather_dual_per_seg_f32(
    const void* pages, const void* scene_of_seg, const void* ids_h,
    const void* w_h, const void* ids_r, const void* w_r, void* out_h,
    void* out_r, int num_pages, int num_mv, int num_seg, int p, int c,
    int cap_h, int cap_r, int grid_x, int tiles_h, int threads, int staging,
    void* stream) {
  return launch<float>(pages, scene_of_seg, ids_h, w_h, ids_r, w_r, out_h,
                       out_r, num_pages, num_mv, num_seg, p, c, cap_h, cap_r,
                       grid_x, tiles_h, threads, staging, stream);
}

extern "C" int fused_gather_dual_per_seg_bf16(
    const void* pages, const void* scene_of_seg, const void* ids_h,
    const void* w_h, const void* ids_r, const void* w_r, void* out_h,
    void* out_r, int num_pages, int num_mv, int num_seg, int p, int c,
    int cap_h, int cap_r, int grid_x, int tiles_h, int threads, int staging,
    void* stream) {
  return launch<__nv_bfloat16>(pages, scene_of_seg, ids_h, w_h, ids_r, w_r,
                               out_h, out_r, num_pages, num_mv, num_seg, p, c,
                               cap_h, cap_r, grid_x, tiles_h, threads, staging,
                               stream);
}
