// Packed segment-causal flash attention, backward, for Hopper (sm_90a).
//
// Replaces the TPU library kernels behind the backward of
// areal_tpu/ops/pallas/flash_attention.py:200 `flash_attention` (the Pallas
// TPU flash-attention library file, experimental/pallas/ops/tpu/
// flash_attention.py, release 0.9.0):
//   K2 `_flash_attention_bwd_dkv` -> flash_bwd_dkv_mma_kernel and
//      flash_bwd_dkv_reduce_kernel (dk, dv; flash_bwd_dkv_kernel for f32)
//   K3 `_flash_attention_bwd_dq`  -> flash_bwd_dq_mma_kernel (dq;
//      flash_bwd_dq_kernel for f32)
// under K1's mask (flash_attention.cu): a (row i, column j) pair is kept when
// both segment ids are equal and nonzero and, when causal, j <= i.
//
// Both recompute the probabilities from K1's logsumexp, P = exp(s*scale - lse),
// and take di = rowsum(dO * O) (f32, computed by the wrapper, as the library
// computes it outside its kernels):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - di),
//   dQ = scale * dS K,  dK = scale * dS^T Q.
// Rows whose lse is -inf (pad queries, rows without a valid key) keep no
// pair, so they give dq = 0 and add nothing to dk or dv; exp2f never sees
// -inf - -inf. Pad columns (segment 0) come out as exact zeros.
//
// Differences from the TPU kernels: GQA without repeating K/V (K2 sums the
// G = Hq / Hkv query heads of each kv head, K3 reads kv head h / G); head_dim
// 64 and 128 are template cases (no padding to 128 lanes); any T and S
// (ragged tails are masked); no block-size knobs; both kernels skip
// causal-future tiles and, for bf16 / fp16, tile pairs that share no segment
// id.
//
// What bounds them on this card: the work is 4 (K2) or 3 (K3) products of
// 2*D flops per kept pair against ~2 bytes per element of q, k, v, dO and
// the gradients. At the train shape (B = 2, T = S = 1792, 14 / 2 heads of
// 64, packed documents) K2 is bound by operations (0.0076 ms); K3's bytes
// (21.5 MB, 0.0064 ms at 3.35 TB/s) and operations (0.0057 ms at 989
// TFLOP/s) are about even.
//
// K2, bf16 / fp16 (`flash_bwd_dkv_mma_kernel`, the main path):
// FlashAttention-2's dk/dv recipe on tensor cores (mma.sync.m16n8k16, f32
// accumulate). One block per (64-key kv tile, q head, batch row), 4 warps of
// 16 keys; B * Hq * S / 64 blocks (784 at the train shape), where one block
// per kv head left 20 of 132 SMs idle and put 7 heads on the first tile's
// critical path. Per q tile of BQ rows (64 at D = 64, 32 at D = 128, which
// keeps the accumulators in registers): S^T = K Q^T and dP^T = V dO^T in
// accumulator fragments, P^T = exp2(S^T scale log2e - lse log2e) and
// dS^T = P^T (dP^T - di) in place, then dV += P^T dO and dK += dS^T Q with P
// and dS rounded to the input type in registers as A operands (the TPU
// kernel rounds them the same way, lib :900 and :918) and dO, Q read through
// ldmatrix.trans; dk and dv stay in f32 registers for the whole loop. K and
// V are loaded once; the q, dO, lse, di and segment tiles are
// double-buffered with cp.async (16-bit tiles XOR-swizzled), so the next
// kept q tile is in flight while this one computes. The block lists its q
// tiles first: causally before the kv tile, or with a range of nonzero
// segment ids that does not overlap the kv tile's, are skipped. With G > 1
// each block writes f32 partial dk, dv for its q head into scratch
// [B, S, Hq, D] (allocated by the wrapper); `flash_bwd_dkv_reduce_kernel`
// then sums the G partials of each kv head in a fixed order, scales dk and
// rounds once: deterministic, no atomics. With G = 1 the block writes dk,
// dv directly. The low kv tiles, which do the most work under causal
// masking, start first. A thread-block cluster over the G heads reducing in
// distributed shared memory would skip the scratch, at the price of blocks
// that must be co-scheduled in groups of G; the scratch keeps every block
// independent and costs ~26 MB of traffic (~8 us at 3.35 TB/s) at the train
// shape.
//
// K3, bf16 / fp16 (`flash_bwd_dq_mma_kernel`, the main path):
// FlashAttention-2's dq pass on mma.sync.m16n8k16 (f32 accumulate), built
// on K1's skeleton. What held the scalar kernel (1.68 ms at the train shape,
// 261x its bound) back, and what this design does about it:
//  - no tensor cores: S = Q K^T, dP = dO V^T and dQ += dS K now run on
//    them, with K and V as B operands through ldmatrix (and K through
//    ldmatrix.trans for dS K, the depth running along K's rows as V's does
//    in K1's P V);
//  - every kv tile up to the diagonal was visited: the block lists its kv
//    tiles first and drops the causal-future ones and those whose range of
//    nonzero segment ids does not overlap the q tile's (disjoint ranges
//    share no id, so the skip is exact);
//  - synchronous converting loads with a barrier per tile: 16-bit tiles
//    (XOR-swizzled) arrive by cp.async and K, V and their segment ids are
//    double-buffered, so the next kept tile is in flight while this one
//    computes;
//  - ~87 KB of f32 shared tiles allowed 2 blocks per SM: the 16-bit tiles
//    take 48 KB at D = 64 (64 KB at D = 128).
// One block per (64-row q tile, q head, batch row), 4 warps of 16 query
// rows; 784 blocks at the train shape, the late q tiles (the most causal
// work) first; GQA reads kv head h / G. Each warp holds its Q and dO A
// fragments in registers, each lane its two rows' lse log2e and di, and dq in
// f32 registers for the whole loop. Per kept kv tile: S and dP into
// accumulator fragments, P = exp2(S scale log2e - lse log2e) and
// dS = P (dP - di) in place under the mask, dS rounded to the input type in
// registers (as the TPU kernel rounds it, lib :1257-1258) as the A operand
// of dQ += dS K. dq is written once per block: no scratch, no atomics,
// deterministic. kv tiles of 64 columns at D = 64 and 32 at D = 128 keep the
// fragments in registers (as K2 halves its q tile).
//
// K3 for float32 (`flash_bwd_dq_kernel`) and K2 for float32
// (`flash_bwd_dkv_kernel`), dtype code 0, are the exact-f32
// specialisations (TF32 tensor cores would not hold float32's tolerances):
// f32 FMAs out of shared memory, 256 threads, four per row, 16-byte shared
// loads, rows padded by 4 floats, P / dS passed through shared memory
// within a warp. Scalar K3: one block per (64-row q tile, q head, batch
// row), looping over the KV tiles up to the diagonal. Scalar K2: one block
// per (64-key kv tile, kv head, batch row), looping over the G query heads
// and every q tile at or after the diagonal; dk and dv accumulate in
// registers and are rounded once.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace areal_flash;

constexpr int kRows = kThreads / 4;  // rows of a tile a block works on at once
static_assert(kRows == kBlockQ && kRows == kBlockKV, "one row per thread quad");

template <int D>
constexpr size_t dq_smem_bytes() {
  // q, dO, k, v tiles [64][D + 4] f32, dS tile [64][64 + 4] f32, two seg vectors.
  return sizeof(float) * (4 * kRows * (D + kPad) + kRows * (kRows + kPad)) +
         sizeof(int) * 2 * kRows;
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // k, v, q, dO tiles [64][D + 4] f32, P/dS tile [64][64 + 4] f32, lse and di
  // of the q tile, two seg vectors.
  return sizeof(float) * (4 * kRows * (D + kPad) + kRows * (kRows + kPad) + 2 * kRows) +
         sizeof(int) * 2 * kRows;
}

// Loads rows [r0, r0 + 64) of one head of a [B, L, H, D] tensor into a
// [64][D + 4] f32 tile; rows at or past `len` are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base, size_t row_stride, int r0,
                                          int len) {
  constexpr int LD = D + kPad;
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, t = r0 + r;
    dst[r * LD + c] = t < len ? to_f32(base[(size_t)t * row_stride + c]) : 0.f;
  }
}

// acc[4c + e] += sum_j w[j] * tile[j][4*quarter + 16c + e], with the 64
// weights w of this thread's row read from shared memory as float4s.
template <int D>
__device__ __forceinline__ void accumulate_rows(float* acc, const float* w_row, const float* tile,
                                                int quarter) {
  constexpr int LD = D + kPad;
  const float4* w4 = reinterpret_cast<const float4*>(w_row);
  for (int j4 = 0; j4 < kRows / 4; ++j4) {
    const float4 wv = w4[j4];
    const float wj[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float4* t_row = reinterpret_cast<const float4*>(tile + (4 * j4 + jj) * LD);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const float4 tv = t_row[quarter + 4 * c];
        acc[4 * c + 0] = fmaf(wj[jj], tv.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(wj[jj], tv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(wj[jj], tv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(wj[jj], tv.w, acc[4 * c + 3]);
      }
    }
  }
}

// a[m] = own_a . others_a[quarter + 4m], b[m] = own_b . others_b[quarter + 4m]:
// the two dot products of this thread's row against 16 rows of the other
// side (scores and dP share the loop).
template <int D>
__device__ __forceinline__ void dot_rows(float* a, float* b, const float* own_a, const float* own_b,
                                         const float* others_a, const float* others_b,
                                         int quarter) {
  constexpr int LD = D + kPad;
  constexpr int M = kRows / 4;
#pragma unroll
  for (int m = 0; m < M; ++m) a[m] = b[m] = 0.f;
  const float4* oa = reinterpret_cast<const float4*>(own_a);
  const float4* ob = reinterpret_cast<const float4*>(own_b);
#pragma unroll 2
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 x = oa[d4];
    const float4 y = ob[d4];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float4 u = reinterpret_cast<const float4*>(others_a + (quarter + 4 * m) * LD)[d4];
      const float4 w = reinterpret_cast<const float4*>(others_b + (quarter + 4 * m) * LD)[d4];
      a[m] = fmaf(x.x, u.x, fmaf(x.y, u.y, fmaf(x.z, u.z, fmaf(x.w, u.w, a[m]))));
      b[m] = fmaf(y.x, w.x, fmaf(y.y, w.y, fmaf(y.z, w.z, fmaf(y.w, w.w, b[m]))));
    }
  }
}

// ---------------- K3: dq ----------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, int T_len, int S_len, int Hq,
                    int Hkv, int causal, float scale) {
  constexpr int LD = D + kPad;
  constexpr int LDP = kRows + kPad;
  constexpr int M = kRows / 4;  // keys per thread per tile
  constexpr int DPT = D / 4;    // gradient dims per thread

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kRows * LD;
  float* k_s = do_s + kRows * LD;
  float* v_s = k_s + kRows * LD;
  float* ds_s = v_s + kRows * LD;
  int* qseg_s = reinterpret_cast<int*>(ds_s + kRows * LDP);
  int* kseg_s = qseg_s + kRows;

  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int quarter = tid & 3;
  // Causal tiles near the end of the row do the most work: start them first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);

  const size_t q_stride = (size_t)Hq * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const T* k_base = k + (size_t)b * S_len * kv_stride + (size_t)hk * D;
  const T* v_base = v + (size_t)b * S_len * kv_stride + (size_t)hk * D;
  load_tile<T, D>(q_s, q + (size_t)b * T_len * q_stride + (size_t)h * D, q_stride, q0, T_len);
  load_tile<T, D>(do_s, dout + (size_t)b * T_len * q_stride + (size_t)h * D, q_stride, q0, T_len);
  if (tid < kRows) {
    const int t = q0 + tid;
    qseg_s[tid] = t < T_len ? q_seg[(size_t)b * T_len + t] : 0;
  }
  __syncthreads();

  const int i_glob = q0 + row;
  const int my_seg = qseg_s[row];
  const float scale_log2 = scale * kLog2e;
  float lse2 = -INFINITY, my_di = 0.f;
  if (i_glob < T_len) {
    const size_t at = ((size_t)b * Hq + h) * T_len + i_glob;
    lse2 = lse[at] * kLog2e;  // stays -inf for rows without a valid key
    my_di = di[at];
  }
  const bool live = my_seg != 0 && lse2 > -INFINITY;
  float acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.f;

  int kv_end = S_len;
  if (causal) kv_end = min(S_len, min(q0 + kBlockQ, T_len));

  for (int k0 = 0; k0 < kv_end; k0 += kBlockKV) {
    load_tile<T, D>(k_s, k_base, kv_stride, k0, S_len);
    load_tile<T, D>(v_s, v_base, kv_stride, k0, S_len);
    if (tid < kRows) {
      const int s = k0 + tid;
      kseg_s[tid] = s < S_len ? kv_seg[(size_t)b * S_len + s] : 0;
    }
    __syncthreads();

    float sc[M], dp[M];
    dot_rows<D>(sc, dp, q_s + row * LD, do_s + row * LD, k_s, v_s, quarter);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int j = quarter + 4 * m;
      const int s = k0 + j;
      const bool ok = live && s < S_len && kseg_s[j] == my_seg && (!causal || s <= i_glob);
      const float p = ok ? exp2f(sc[m] * scale_log2 - lse2) : 0.f;
      ds_s[row * LDP + j] = p * (dp[m] - my_di);
    }
    // Row `row`'s dS was written by the four threads of its quad, all in
    // this warp: a warp barrier is enough before reading it back.
    __syncwarp();
    accumulate_rows<D>(acc, ds_s + row * LDP, k_s, quarter);
    __syncthreads();  // the next tile overwrites k_s, v_s, kseg_s
  }

  if (i_glob < T_len) {
    T* o_row = dq + ((size_t)b * T_len + i_glob) * q_stride + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o_row[4 * quarter + 16 * c + e] = from_f32<T>(acc[4 * c + e] * scale);
      }
    }
  }
}

// ---------------- K3, bf16 / fp16: tensor cores ----------------

template <int D>
__host__ __device__ constexpr int dq_block_kv() {
  return 4096 / D;  // kv columns per step: 64 at D = 64, 32 at D = 128
}

template <int D>
size_t dq_mma_smem_bytes(int n_kv_tiles) {
  constexpr int BKV = dq_block_kv<D>();
  // Q, dO tiles; K, V tiles x2 (16-bit); q segment ids, kv segment ids x2,
  // the tile count and the list of kept kv tiles.
  return 2 * (2 * kBlockQ * D + 4 * BKV * D) +
         sizeof(int) * (kBlockQ + 2 * BKV + 1 + n_kv_tiles);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ q_seg,
                        const int* __restrict__ kv_seg, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        T* __restrict__ dq, int T_len, int S_len, int Hq, int Hkv, int causal,
                        float scale) {
  constexpr int BKV = dq_block_kv<D>();
  constexpr int NB = BKV / 8;  // key n-blocks of a kv tile
  constexpr int KD = D / 16;   // 16-wide steps over the head dim

  extern __shared__ float4 smem4[];
  T* q_s = reinterpret_cast<T*>(smem4);
  T* do_s = q_s + kBlockQ * D;
  T* k_s = do_s + kBlockQ * D;  // [2][BKV][D]
  T* v_s = k_s + 2 * BKV * D;   // [2][BKV][D]
  int* qseg_s = reinterpret_cast<int*>(v_s + 2 * BKV * D);
  int* kseg_s = qseg_s + kBlockQ;  // [2][BKV]
  int* count_s = kseg_s + 2 * BKV;
  int* list_s = count_s + 1;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_qt = (T_len + kBlockQ - 1) / kBlockQ;
  const int per_tile = gridDim.x / n_qt;  // Hq * B blocks share a q tile index
  // Causal tiles near the end of the row do the most work: start them first.
  const int q0 = (n_qt - 1 - (int)blockIdx.x / per_tile) * kBlockQ;
  const int h = blockIdx.x % per_tile % Hq;
  const int b = blockIdx.x % per_tile / Hq;
  const int hk = h / (Hq / Hkv);

  const size_t q_stride = (size_t)Hq * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const size_t q_off = (size_t)b * T_len * q_stride + (size_t)h * D;
  const T* k_base = k + (size_t)b * S_len * kv_stride + (size_t)hk * D;
  const T* v_base = v + (size_t)b * S_len * kv_stride + (size_t)hk * D;
  const int* qseg_row = q_seg + (size_t)b * T_len;
  const int* kseg_row = kv_seg + (size_t)b * S_len;

  load_tile_async<T, kBlockQ, D>(q_s, q + q_off, q_stride, q0, T_len);
  load_tile_async<T, kBlockQ, D>(do_s, dout + q_off, q_stride, q0, T_len);
  cp_async_commit();
  if (tid < kBlockQ) qseg_s[tid] = q0 + tid < T_len ? qseg_row[q0 + tid] : 0;

  // The kv tiles this q tile needs: not wholly in the causal future, and
  // sharing a range of nonzero segment ids.
  const SegRange q_range = warp_seg_range(qseg_row, q0, kBlockQ, T_len);
  const int n_kv = (S_len + BKV - 1) / BKV;
  const int q_last = min(q0 + kBlockQ, T_len) - 1;
  const int kv_end = causal ? min(n_kv, q_last / BKV + 1) : n_kv;
  const int n = build_tile_list(list_s, count_s, 0, kv_end, [&](int t) {
    return ranges_overlap(q_range, warp_seg_range(kseg_row, t * BKV, BKV, S_len));
  });

  auto load_kv = [&](int i, int buf) {
    const int k0 = list_s[i] * BKV;
    load_tile_async<T, BKV, D>(k_s + buf * BKV * D, k_base, kv_stride, k0, S_len);
    load_tile_async<T, BKV, D>(v_s + buf * BKV * D, v_base, kv_stride, k0, S_len);
    if (tid < BKV) {
      const int s = k0 + tid;
      cp_async_4(kseg_s + buf * BKV + tid, kseg_row + (s < S_len ? s : 0), s < S_len);
    }
  };
  if (n > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's part of the Q and dO tiles has landed
  __syncthreads();

  // This warp's 16 query rows of Q and dO: the A operands of S = Q K^T and
  // dP = dO V^T.
  uint32_t qf[KD][4], of[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    ldmatrix_x4(qf[kk], a_frag_addr<D>(q_s, warp * 16, kk, lane));
    ldmatrix_x4(of[kk], a_frag_addr<D>(do_s, warp * 16, kk, lane));
  }

  // This lane's two rows (r = 0, 1) and its columns 2 (lane % 4) + {0, 1} of
  // every 8-wide n-block. A row keeps no pair unless its lse is finite, so
  // exp2f never sees -inf - -inf.
  const int row_l = warp * 16 + (lane >> 2);
  const int rows[2] = {q0 + row_l, q0 + row_l + 8};
  const int segs[2] = {qseg_s[row_l], qseg_s[row_l + 8]};
  const int col_l = 2 * (lane & 3);
  const float* lse_row = lse + ((size_t)b * Hq + h) * T_len;
  const float* di_row = di + ((size_t)b * Hq + h) * T_len;
  float lse2[2], dis[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < T_len;
    lse2[r] = in ? lse_row[rows[r]] * kLog2e : -INFINITY;
    dis[r] = in ? di_row[rows[r]] : 0.f;
    live[r] = segs[r] != 0 && lse2[r] > -INFINITY;
  }
  const float scale_log2 = scale * kLog2e;
  float acc[D / 8][4];
#pragma unroll
  for (int db = 0; db < D / 8; ++db) acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int buf = it & 1;
    if (it + 1 < n) load_kv(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile `it` has landed
    __syncthreads();
    const T* kt = k_s + buf * BKV * D;
    const T* vt = v_s + buf * BKV * D;
    const int* ks = kseg_s + buf * BKV;
    const int k0 = list_s[it] * BKV;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows.
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, b_frag_addr<D>(kt, nb2 * 16, kk, lane));
        mma_16816<T>(s[2 * nb2], qf[kk], bk[0], bk[1]);
        mma_16816<T>(s[2 * nb2 + 1], qf[kk], bk[2], bk[3]);
        ldmatrix_x4(bv, b_frag_addr<D>(vt, nb2 * 16, kk, lane));
        mma_16816<T>(dp[2 * nb2], of[kk], bv[0], bv[1]);
        mma_16816<T>(dp[2 * nb2 + 1], of[kk], bv[2], bv[3]);
      }
    }

    // dS = P (dP - di) in place of dP, P = 0 off the mask.
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int jl = nb * 8 + col_l + (e & 1);
        const bool ok = live[r] && ks[jl] == segs[r] && (!causal || k0 + jl <= rows[r]);
        const float p = ok ? exp2f(s[nb][e] * scale_log2 - lse2[r]) : 0.f;
        dp[nb][e] = p * (dp[nb][e] - dis[r]);
      }
    }

    // dQ += dS K, dS from registers, K through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t sa[4];
      acc_to_a<T>(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int db2 = 0; db2 < D / 16; ++db2) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, bt_frag_addr<D>(kt, kk * 16, db2, lane));
        mma_16816<T>(acc[2 * db2], sa, bk[0], bk[1]);
        mma_16816<T>(acc[2 * db2 + 1], sa, bk[2], bk[3]);
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this buffer
  }
  cp_async_wait<0>();  // nothing left in flight (a block with no kept tile)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= T_len) continue;
    T* o_row = dq + q_off + (size_t)rows[r] * q_stride + col_l;
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      *reinterpret_cast<uint32_t*>(o_row + db * 8) =
          pack2<T>(acc[db][2 * r] * scale, acc[db][2 * r + 1] * scale);
    }
  }
}

// ---------------- K2: dk, dv ----------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
                     int T_len, int S_len, int Hq, int Hkv, int causal, float scale) {
  constexpr int LD = D + kPad;
  constexpr int LDP = kRows + kPad;
  constexpr int M = kRows / 4;  // queries per thread per tile
  constexpr int DPT = D / 4;

  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kRows * LD;
  float* q_s = v_s + kRows * LD;
  float* do_s = q_s + kRows * LD;
  float* p_s = do_s + kRows * LD;
  float* lse2_s = p_s + kRows * LDP;
  float* di_s = lse2_s + kRows;
  int* qseg_s = reinterpret_cast<int*>(di_s + kRows);
  int* kseg_s = qseg_s + kRows;

  const int tid = threadIdx.x;
  const int krow = tid >> 2;
  const int quarter = tid & 3;
  const int k0 = blockIdx.x * kBlockKV;  // the first kv tiles do the most work
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;

  const size_t q_stride = (size_t)Hq * D;
  const size_t kv_stride = (size_t)Hkv * D;
  load_tile<T, D>(k_s, k + (size_t)b * S_len * kv_stride + (size_t)hk * D, kv_stride, k0, S_len);
  load_tile<T, D>(v_s, v + (size_t)b * S_len * kv_stride + (size_t)hk * D, kv_stride, k0, S_len);
  if (tid < kRows) {
    const int s = k0 + tid;
    kseg_s[tid] = s < S_len ? kv_seg[(size_t)b * S_len + s] : 0;
  }
  // (the first loop iteration's barrier publishes these tiles)

  const int j_glob = k0 + krow;
  const float scale_log2 = scale * kLog2e;
  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  // Causal: rows before this kv tile's first q tile keep none of its columns.
  const int q_begin = causal ? (k0 / kBlockQ) * kBlockQ : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* q_base = q + (size_t)b * T_len * q_stride + (size_t)h * D;
    const T* do_base = dout + (size_t)b * T_len * q_stride + (size_t)h * D;
    const size_t lse_row = ((size_t)b * Hq + h) * T_len;
    for (int q0 = q_begin; q0 < T_len; q0 += kBlockQ) {
      __syncthreads();  // the previous tile's reads of q_s, do_s, p_s are done
      load_tile<T, D>(q_s, q_base, q_stride, q0, T_len);
      load_tile<T, D>(do_s, do_base, q_stride, q0, T_len);
      if (tid < kRows) {
        const int t = q0 + tid;
        const bool in = t < T_len;
        qseg_s[tid] = in ? q_seg[(size_t)b * T_len + t] : 0;
        lse2_s[tid] = in ? lse[lse_row + t] * kLog2e : -INFINITY;
        di_s[tid] = in ? di[lse_row + t] : 0.f;
      }
      __syncthreads();

      const int my_seg = kseg_s[krow];
      float p[M], dp[M];
      dot_rows<D>(p, dp, k_s + krow * LD, v_s + krow * LD, q_s, do_s, quarter);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = quarter + 4 * m;
        const int t = q0 + i;
        const bool ok = my_seg != 0 && j_glob < S_len && qseg_s[i] == my_seg &&
                        lse2_s[i] > -INFINITY && (!causal || j_glob <= t);
        p[m] = ok ? exp2f(p[m] * scale_log2 - lse2_s[i]) : 0.f;
        p_s[krow * LDP + i] = p[m];
      }
      // Row `krow` of P is written and read by its own quad, within a warp.
      __syncwarp();
      accumulate_rows<D>(dv_acc, p_s + krow * LDP, do_s, quarter);
      __syncwarp();  // every lane has read P before dS overwrites it
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i = quarter + 4 * m;
        p_s[krow * LDP + i] = p[m] * (dp[m] - di_s[i]);
      }
      __syncwarp();
      accumulate_rows<D>(dk_acc, p_s + krow * LDP, q_s, quarter);
    }
  }

  if (j_glob < S_len) {
    const size_t at = ((size_t)b * S_len + j_glob) * kv_stride + (size_t)hk * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * quarter + 16 * c + e;
        dk[at + d] = from_f32<T>(dk_acc[4 * c + e] * scale);
        dv[at + d] = from_f32<T>(dv_acc[4 * c + e]);
      }
    }
  }
}

// ---------------- K2, bf16 / fp16: tensor cores ----------------

template <int D>
__host__ __device__ constexpr int dkv_block_q() {
  return 4096 / D;  // q rows per step: 64 at D = 64, 32 at D = 128
}

template <int D>
size_t dkv_mma_smem_bytes(int n_q_tiles) {
  constexpr int BQ = dkv_block_q<D>();
  // K, V tiles; Q, dO tiles x2 (16-bit); lse, di, q segment ids x2; kv
  // segment ids; the tile count and the list of kept q tiles.
  return 2 * (2 * kBlockKV * D + 4 * BQ * D) +
         sizeof(int) * (6 * BQ + kBlockKV + 1 + n_q_tiles);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ q_seg,
                         const int* __restrict__ kv_seg, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dk_part,
                         float* __restrict__ dv_part, int T_len, int S_len, int Hq, int Hkv,
                         int causal, float scale) {
  constexpr int BQ = dkv_block_q<D>();
  constexpr int NQ = BQ / 8;  // query n-blocks of a q tile
  constexpr int KD = D / 16;  // 16-wide steps over the head dim

  extern __shared__ float4 smem4[];
  T* k_s = reinterpret_cast<T*>(smem4);
  T* v_s = k_s + kBlockKV * D;
  T* q_s = v_s + kBlockKV * D;  // [2][BQ][D]
  T* do_s = q_s + 2 * BQ * D;   // [2][BQ][D]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BQ * D);  // [2][BQ]
  float* di_s = lse_s + 2 * BQ;                                 // [2][BQ]
  int* qseg_s = reinterpret_cast<int*>(di_s + 2 * BQ);          // [2][BQ]
  int* kseg_s = qseg_s + 2 * BQ;
  int* count_s = kseg_s + kBlockKV;
  int* list_s = count_s + 1;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per_tile = gridDim.x / ((S_len + kBlockKV - 1) / kBlockKV);  // Hq * B
  // The low kv tiles do the most work under causal masking: start them first.
  const int k0 = (int)blockIdx.x / per_tile * kBlockKV;
  const int h = blockIdx.x % per_tile % Hq;
  const int b = blockIdx.x % per_tile / Hq;
  const int G = Hq / Hkv;
  const int hk = h / G;

  const size_t q_stride = (size_t)Hq * D;
  const size_t kv_stride = (size_t)Hkv * D;
  const T* q_base = q + (size_t)b * T_len * q_stride + (size_t)h * D;
  const T* do_base = dout + (size_t)b * T_len * q_stride + (size_t)h * D;
  const float* lse_row = lse + ((size_t)b * Hq + h) * T_len;
  const float* di_row = di + ((size_t)b * Hq + h) * T_len;
  const int* qseg_row = q_seg + (size_t)b * T_len;
  const int* kseg_row = kv_seg + (size_t)b * S_len;

  load_tile_async<T, kBlockKV, D>(k_s, k + (size_t)b * S_len * kv_stride + (size_t)hk * D,
                                  kv_stride, k0, S_len);
  load_tile_async<T, kBlockKV, D>(v_s, v + (size_t)b * S_len * kv_stride + (size_t)hk * D,
                                  kv_stride, k0, S_len);
  cp_async_commit();
  if (tid < kBlockKV) kseg_s[tid] = k0 + tid < S_len ? kseg_row[k0 + tid] : 0;

  // The q tiles this kv tile needs: not wholly before it (causal), and
  // sharing a range of nonzero segment ids.
  const SegRange kv_range = warp_seg_range(kseg_row, k0, kBlockKV, S_len);
  const int n_qt = (T_len + BQ - 1) / BQ;
  const int n = build_tile_list(list_s, count_s, causal ? min(k0 / BQ, n_qt) : 0, n_qt,
                                [&](int t) {
    return (!causal || min(t * BQ + BQ, T_len) - 1 >= k0) &&
           ranges_overlap(kv_range, warp_seg_range(qseg_row, t * BQ, BQ, T_len));
  });

  auto load_q = [&](int i, int buf) {
    const int q0 = list_s[i] * BQ;
    load_tile_async<T, BQ, D>(q_s + buf * BQ * D, q_base, q_stride, q0, T_len);
    load_tile_async<T, BQ, D>(do_s + buf * BQ * D, do_base, q_stride, q0, T_len);
    if (tid < BQ) {
      const int t = q0 + tid;
      const bool ok = t < T_len;
      cp_async_4(lse_s + buf * BQ + tid, lse_row + (ok ? t : 0), ok);
      cp_async_4(di_s + buf * BQ + tid, di_row + (ok ? t : 0), ok);
      cp_async_4(qseg_s + buf * BQ + tid, qseg_row + (ok ? t : 0), ok);
    }
  };
  if (n > 0) load_q(0, 0);
  cp_async_commit();

  // This lane's two keys (r = 0, 1) and its query columns 2 (lane % 4) +
  // {0, 1} of every 8-wide n-block.
  const int key_l = warp * 16 + (lane >> 2);
  const int keys[2] = {k0 + key_l, k0 + key_l + 8};
  const int ksegs[2] = {kseg_s[key_l], kseg_s[key_l + 8]};
  const int col_l = 2 * (lane & 3);
  const float scale_log2 = scale * kLog2e;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int db = 0; db < D / 8; ++db) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[db][e] = dv_acc[db][e] = 0.f;
  }

  for (int it = 0; it < n; ++it) {
    const int buf = it & 1;
    if (it + 1 < n) load_q(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and q tile `it` have landed
    __syncthreads();
    const T* qt = q_s + buf * BQ * D;
    const T* dot = do_s + buf * BQ * D;
    const float* lse_t = lse_s + buf * BQ;
    const float* di_t = di_s + buf * BQ;
    const int* qseg_t = qseg_s + buf * BQ;
    const int q0 = list_s[it] * BQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys.
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int nb = 0; nb < NQ; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nb][e] = dpt[nb][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, a_frag_addr<D>(k_s, warp * 16, kk, lane));
      ldmatrix_x4(va, a_frag_addr<D>(v_s, warp * 16, kk, lane));
#pragma unroll
      for (int nb2 = 0; nb2 < NQ / 2; ++nb2) {
        uint32_t bq[4], bo[4];
        ldmatrix_x4(bq, b_frag_addr<D>(qt, nb2 * 16, kk, lane));
        mma_16816<T>(st[2 * nb2], ka, bq[0], bq[1]);
        mma_16816<T>(st[2 * nb2 + 1], ka, bq[2], bq[3]);
        ldmatrix_x4(bo, b_frag_addr<D>(dot, nb2 * 16, kk, lane));
        mma_16816<T>(dpt[2 * nb2], va, bo[0], bo[1]);
        mma_16816<T>(dpt[2 * nb2 + 1], va, bo[2], bo[3]);
      }
    }

    // P^T in place of S^T, dS^T in place of dP^T. A kept pair needs a
    // finite row lse, so exp2f never sees -inf - -inf.
#pragma unroll
    for (int nb = 0; nb < NQ; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int ql = nb * 8 + col_l + (e & 1);
        const float lse2 = lse_t[ql] * kLog2e;
        const bool ok = ksegs[r] != 0 && qseg_t[ql] == ksegs[r] && lse2 > -INFINITY &&
                        (!causal || keys[r] <= q0 + ql);
        const float p = ok ? exp2f(st[nb][e] * scale_log2 - lse2) : 0.f;
        st[nb][e] = p;
        dpt[nb][e] = p * (dpt[nb][e] - di_t[ql]);
      }
    }

    // dV += P^T dO and dK += dS^T Q, the A operands from registers.
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      uint32_t pa[4], sa[4];
      acc_to_a<T>(pa, st[2 * kq], st[2 * kq + 1]);
      acc_to_a<T>(sa, dpt[2 * kq], dpt[2 * kq + 1]);
#pragma unroll
      for (int db2 = 0; db2 < D / 16; ++db2) {
        uint32_t bo[4], bq[4];
        ldmatrix_x4_trans(bo, bt_frag_addr<D>(dot, kq * 16, db2, lane));
        mma_16816<T>(dv_acc[2 * db2], pa, bo[0], bo[1]);
        mma_16816<T>(dv_acc[2 * db2 + 1], pa, bo[2], bo[3]);
        ldmatrix_x4_trans(bq, bt_frag_addr<D>(qt, kq * 16, db2, lane));
        mma_16816<T>(dk_acc[2 * db2], sa, bq[0], bq[1]);
        mma_16816<T>(dk_acc[2 * db2 + 1], sa, bq[2], bq[3]);
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this buffer
  }
  cp_async_wait<0>();  // nothing left in flight (a block with no kept tile)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= S_len) continue;
    if (G == 1) {
      const size_t at = ((size_t)b * S_len + keys[r]) * kv_stride + (size_t)hk * D + col_l;
#pragma unroll
      for (int db = 0; db < D / 8; ++db) {
        *reinterpret_cast<uint32_t*>(dk + at + db * 8) =
            pack2<T>(dk_acc[db][2 * r] * scale, dk_acc[db][2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + at + db * 8) =
            pack2<T>(dv_acc[db][2 * r], dv_acc[db][2 * r + 1]);
      }
    } else {
      const size_t at = ((size_t)b * S_len + keys[r]) * q_stride + (size_t)h * D + col_l;
#pragma unroll
      for (int db = 0; db < D / 8; ++db) {
        *reinterpret_cast<float2*>(dk_part + at + db * 8) =
            make_float2(dk_acc[db][2 * r], dk_acc[db][2 * r + 1]);
        *reinterpret_cast<float2*>(dv_part + at + db * 8) =
            make_float2(dv_acc[db][2 * r], dv_acc[db][2 * r + 1]);
      }
    }
  }
}

// dk[b, s, hk] = scale * sum_g dk_part[b, s, hk * G + g] and dv likewise, g
// in order, rounded once. One thread per 4 head dims of a (row, kv head).
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_dkv_reduce_kernel(const float* __restrict__ dk_part, const float* __restrict__ dv_part,
                            T* __restrict__ dk, T* __restrict__ dv, long long rows, int Hkv, int G,
                            int D, float scale) {
  const int quads = D / 4;
  const long long n = rows * Hkv * quads;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long rh = i / quads;  // row * Hkv + hk
    const int c = (int)(i % quads) * 4;
    const float* pk = dk_part + (size_t)rh * G * D + c;  // q head hk * G of this row
    const float* pv = dv_part + (size_t)rh * G * D + c;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), w = a;
    for (int g = 0; g < G; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(pk + (size_t)g * D);
      const float4 y = *reinterpret_cast<const float4*>(pv + (size_t)g * D);
      a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
      w.x += y.x, w.y += y.y, w.z += y.z, w.w += y.w;
    }
    const size_t at = (size_t)rh * D + c;
    *reinterpret_cast<uint2*>(dk + at) =
        make_uint2(pack2<T>(a.x * scale, a.y * scale), pack2<T>(a.z * scale, a.w * scale));
    *reinterpret_cast<uint2*>(dv + at) = make_uint2(pack2<T>(w.x, w.y), pack2<T>(w.z, w.w));
  }
}

struct BwdArgs {
  const void *q, *k, *v;
  const int *q_seg, *kv_seg;
  const void* dout;
  const float *lse, *di;
  void *dq, *dk, *dv;
  float *dk_part, *dv_part;  // K2's f32 scratch [B, S, Hq, D] (bf16/fp16, G > 1)
  int B, T_len, S_len, Hq, Hkv, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a) {
  if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = dq_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.T_len + kBlockQ - 1) / kBlockQ, a.Hq, a.B);
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        a.q_seg, a.kv_seg, static_cast<const T*>(a.dout), a.lse, a.di, static_cast<T*>(a.dq),
        a.T_len, a.S_len, a.Hq, a.Hkv, a.causal, a.scale);
  } else {
    const int n_kv = (a.S_len + dq_block_kv<D>() - 1) / dq_block_kv<D>();
    const size_t smem = dq_mma_smem_bytes<D>(n_kv);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int grid = (a.T_len + kBlockQ - 1) / kBlockQ * a.Hq * a.B;
    flash_bwd_dq_mma_kernel<T, D><<<grid, kMmaThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        a.q_seg, a.kv_seg, static_cast<const T*>(a.dout), a.lse, a.di, static_cast<T*>(a.dq),
        a.T_len, a.S_len, a.Hq, a.Hkv, a.causal, a.scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a) {
  if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = dkv_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S_len + kBlockKV - 1) / kBlockKV, a.Hkv, a.B);
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        a.q_seg, a.kv_seg, static_cast<const T*>(a.dout), a.lse, a.di, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.T_len, a.S_len, a.Hq, a.Hkv, a.causal, a.scale);
    return cudaGetLastError();
  } else {
    const int G = a.Hq / a.Hkv;
    if (G > 1 && (a.dk_part == nullptr || a.dv_part == nullptr)) return cudaErrorInvalidValue;
    const int n_qt = (a.T_len + dkv_block_q<D>() - 1) / dkv_block_q<D>();
    const size_t smem = dkv_mma_smem_bytes<D>(n_qt);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int grid = (a.S_len + kBlockKV - 1) / kBlockKV * a.Hq * a.B;
    flash_bwd_dkv_mma_kernel<T, D><<<grid, kMmaThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        a.q_seg, a.kv_seg, static_cast<const T*>(a.dout), a.lse, a.di, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.dk_part, a.dv_part, a.T_len, a.S_len, a.Hq, a.Hkv, a.causal,
        a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess || G == 1) return err;
    const long long rows = (long long)a.B * a.S_len;
    const long long quads = rows * a.Hkv * (D / 4);
    const long long want = (quads + 255) / 256;
    const int blocks = want < 65536 ? (int)want : 65536;  // grid-stride beyond
    flash_bwd_dkv_reduce_kernel<T><<<blocks, 256, 0, a.stream>>>(
        a.dk_part, a.dv_part, static_cast<T*>(a.dk), static_cast<T*>(a.dv), rows, a.Hkv, G, D,
        a.scale);
    return cudaGetLastError();
  }
}

// Picks the (dtype, head_dim) instance of `Launch`: dtype 0 = float32,
// 1 = bfloat16, 2 = float16; head_dim 64 or 128.
template <template <typename, int> class Launch>
cudaError_t dispatch(int D, int dtype, const BwdArgs& a) {
  if (D != 64 && D != 128) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return D == 64 ? Launch<float, 64>::run(a) : Launch<float, 128>::run(a);
    case 1:
      return D == 64 ? Launch<__nv_bfloat16, 64>::run(a) : Launch<__nv_bfloat16, 128>::run(a);
    case 2: return D == 64 ? Launch<__half, 64>::run(a) : Launch<__half, 128>::run(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
struct DqLaunch {
  static cudaError_t run(const BwdArgs& a) { return launch_dq<T, D>(a); }
};

template <typename T, int D>
struct DkvLaunch {
  static cudaError_t run(const BwdArgs& a) { return launch_dkv<T, D>(a); }
};

BwdArgs make_args(const void* q, const void* k, const void* v, const void* q_seg,
                  const void* kv_seg, const void* dout, const void* lse, const void* di, void* dq,
                  void* dk, void* dv, void* dk_part, void* dv_part, int B, int T_len, int S_len,
                  int Hq, int Hkv, int causal, float scale, void* stream) {
  return BwdArgs{q, k, v, static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), dout,
                 static_cast<const float*>(lse), static_cast<const float*>(di), dq, dk, dv,
                 static_cast<float*>(dk_part), static_cast<float*>(dv_part), B, T_len, S_len, Hq,
                 Hkv, causal, scale, static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. q, dout, dq [B,T,Hq,D];
// k, v, dk, dv [B,S,Hkv,D]; segment ids int32 [B,T] / [B,S]; lse and di f32
// [B,Hq,T]; all contiguous. Each returns the cudaError_t of its launches.
int areal_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* q_seg,
                                 const void* kv_seg, const void* dout, const void* lse,
                                 const void* di, void* dq, int B, int T_len, int S_len, int Hq,
                                 int Hkv, int D, int dtype, int causal, float scale,
                                 void* stream) {
  if (B <= 0 || T_len <= 0 || Hq <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || S_len < 0) return cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, q_seg, kv_seg, dout, lse, di, dq, nullptr, nullptr,
                              nullptr, nullptr, B, T_len, S_len, Hq, Hkv, causal, scale, stream);
  return dispatch<DqLaunch>(D, dtype, a);
}

// K2 launches its partial kernel and, for bf16 / fp16 with G = Hq / Hkv > 1,
// the G reduction; dk_part and dv_part are f32 scratch [B,S,Hq,D] then (null
// otherwise).
int areal_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* q_seg,
                                  const void* kv_seg, const void* dout, const void* lse,
                                  const void* di, void* dk, void* dv, void* dk_part,
                                  void* dv_part, int B, int T_len, int S_len, int Hq, int Hkv,
                                  int D, int dtype, int causal, float scale, void* stream) {
  if (B <= 0 || S_len <= 0 || Hkv <= 0) return cudaSuccess;
  if (Hq <= 0 || Hq % Hkv != 0 || T_len < 0) return cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, q_seg, kv_seg, dout, lse, di, nullptr, dk, dv, dk_part,
                              dv_part, B, T_len, S_len, Hq, Hkv, causal, scale, stream);
  return dispatch<DkvLaunch>(D, dtype, a);
}

}  // extern "C"
