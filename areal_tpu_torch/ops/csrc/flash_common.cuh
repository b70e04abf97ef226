// Shared pieces of the packed flash-attention kernels (forward K1 in
// flash_attention.cu, backward K2/K3 in flash_attention_bwd.cu): tile sizes,
// dtype conversions, the tensor-core building blocks (inline PTX for
// cp.async, ldmatrix and mma.sync), the swizzled bf16/fp16 tile layout, the
// segment-range tile test and the plain-C error-string export. Each source
// builds into a shared library of its own, so each carries its own copy of
// the export.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace areal_flash {

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kThreads = 256;     // the scalar f32-FMA kernels
constexpr int kMmaThreads = 128;  // the tensor-core kernels: 4 warps of 16 rows
constexpr int kPad = 4;  // floats of padding per shared row: conflict-free float4 loads
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// ---------------- tensor-core building blocks (sm_80+ PTX) ----------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy in flight; with valid = false it writes 16
// zero bytes and reads nothing (src must still be a mapped address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4-byte form, for per-row vectors (segment ids, lse, di) of any alignment.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register i receives (row lane / 4, columns 2 (lane % 4) + {0,1})
// of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The transposed form: register i receives (rows 2 (lane % 4) + {0,1},
// column lane / 4) of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row-major) * b (16x8, column-major), f32 accumulate. With
// g = lane / 4 and c = 2 (lane % 4): a = {(g, c), (g + 8, c), (g, c + 8),
// (g + 8, c + 8)} as pairs of columns, b = {(k = c, n = g), (k = c + 8, n = g)}
// as pairs of k, d = {(g, c), (g, c + 1), (g + 8, c), (g + 8, c + 1)}.
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1);

template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma_16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to the 16-bit type, the first in the low half.
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A-operand fragment of the 16 x 16 block k of a 16-row accumulator
// (acc[n] = columns 8n .. 8n + 7): the rounding of P or dS that feeds the
// next product straight from registers.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack2<T>(lo[0], lo[1]);
  a[1] = pack2<T>(lo[2], lo[3]);
  a[2] = pack2<T>(hi[0], hi[1]);
  a[3] = pack2<T>(hi[2], hi[3]);
}

// ---------------- swizzled 16-bit tiles ----------------
//
// A [rows][D] tile of 2-byte elements, stored as rows of D / 8 16-byte
// chunks with chunk c of row r at position c ^ (r % 8): the eight rows an
// ldmatrix reads at one chunk index land in eight different bank groups.

template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// Rows [r0, r0 + ROWS) of one head of a [B, L, H, D] tensor (`base` points
// at row 0 of that head, `stride` elements between rows) into a swizzled
// tile with 16-byte cp.async; rows at or past `len` are zeros.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_tile_async(T* tile, const T* base, size_t stride, int r0,
                                                int len) {
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % kMmaThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kMmaThreads; ++it) {
    const int i = it * kMmaThreads + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks, t = r0 + r;
    const bool ok = t < len;
    cp_async_16(tile + swz<D>(r, c), base + (size_t)(ok ? t : 0) * stride + c * 8, ok);
  }
}

// ldmatrix address of lane `lane` for the A fragment (16 rows from `row0`,
// columns 16 k .. 16 k + 15) of a swizzled tile.
template <int D>
__device__ __forceinline__ uint32_t a_frag_addr(const void* tile, int row0, int k, int lane) {
  return smem_u32(static_cast<const uint16_t*>(tile) +
                  swz<D>(row0 + (lane & 15), 2 * k + (lane >> 4)));
}

// ldmatrix address for the B fragments of two 8-column n-blocks (tile rows
// n0 .. n0 + 15 are the columns of B, tile columns 16 k .. 16 k + 15 its
// depth): registers {0, 1} feed n-block n0, {2, 3} n-block n0 + 8.
template <int D>
__device__ __forceinline__ uint32_t b_frag_addr(const void* tile, int n0, int k, int lane) {
  return smem_u32(static_cast<const uint16_t*>(tile) +
                  swz<D>(n0 + ((lane >> 4) << 3) + (lane & 7), 2 * k + ((lane >> 3) & 1)));
}

// ldmatrix.trans address for the B fragments of a product whose depth runs
// along the tile's rows (k0 .. k0 + 15) and whose columns are tile columns
// 16 n .. 16 n + 15: registers {0, 1} feed n-block 2n, {2, 3} n-block 2n + 1.
template <int D>
__device__ __forceinline__ uint32_t bt_frag_addr(const void* tile, int k0, int n, int lane) {
  return smem_u32(static_cast<const uint16_t*>(tile) +
                  swz<D>(k0 + (((lane >> 3) & 1) << 3) + (lane & 7), 2 * n + (lane >> 4)));
}

// ---------------- the segment-range tile test ----------------
//
// A (row, column) pair is kept only when both carry the same nonzero
// segment id. A pair of tiles whose ranges [min, max] of nonzero ids do not
// overlap holds no kept pair, whatever the ids: the kernels skip it.

struct SegRange {
  int lo, hi;  // of the nonzero ids; lo > hi when there is none
};

// The range of seg[start .. start + n) (entries at or past `len` count as
// 0), reduced across the calling warp; every lane gets it.
__device__ __forceinline__ SegRange warp_seg_range(const int* seg, int start, int n, int len) {
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = threadIdx.x & 31; i < n; i += 32) {
    const int t = start + i;
    const int s = t < len ? seg[t] : 0;
    if (s != 0) {
      lo = min(lo, s);
      hi = max(hi, s);
    }
  }
  return {__reduce_min_sync(0xffffffffu, lo), __reduce_max_sync(0xffffffffu, hi)};
}

__device__ __forceinline__ bool ranges_overlap(SegRange a, SegRange b) {
  return a.lo <= a.hi && b.lo <= b.hi && a.lo <= b.hi && b.lo <= a.hi;
}

// The tiles t in [first, last) for which keep(t) holds, in order, into
// list[0 .. n); returns n to every thread. keep is called by whole warps
// (it may reduce across the warp). `list` has room for last - first ints;
// `count` is one shared int. Ends with a block barrier, which also
// publishes the shared-memory writes made before the call.
template <typename Keep>
__device__ __forceinline__ int build_tile_list(int* list, int* count, int first, int last,
                                               Keep keep) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_cand = last - first;
  for (int i = warp; i < n_cand; i += kMmaThreads / 32) {
    const bool k = keep(first + i);
    if (lane == 0) list[i] = k;
  }
  __syncthreads();
  if (warp == 0) {
    // In-place compaction, 32 flags at a time: every write lands at or
    // before the flag its lane has already read.
    int n = 0;
    for (int base = 0; base < n_cand; base += 32) {
      const int i = base + lane;
      const bool k = i < n_cand && list[i] != 0;
      const unsigned ball = __ballot_sync(0xffffffffu, k);
      if (k) list[n + __popc(ball & ((1u << lane) - 1u))] = first + i;
      n += __popc(ball);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

}  // namespace areal_flash

extern "C" const char* areal_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
